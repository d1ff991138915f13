"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. build   every CUDA kernel of the slice from presto_tpu_torch/csrc,
             one nvcc per source, and the native IO library (g++), all
             started together; registers and
             spills per kernel from -Xptxas -v, and each stage_reduce
             instantiation's shared memory and CTAs an SM (an
             instantiation of either kernel that spills fails the phase);
  2. kernels each kernel against its plain PyTorch version on the card,
             at the main path's shapes (the plane builder also at the
             zmax-400 geometry, n = 16384; the stage reducer also at
             numharm 16 on the same plane) and at a ragged shape, with
             kernel / plain / library times, the card's bound, the
             reducer's own byte count, and the time of the collect step
             that follows the reducer;
  3. polish  the beam: a 128-channel 8-bit filterbank of 2^22 samples
             (2^21-bin spectra) with three pulsars (the strongest
             accelerated, 40.3 Hz at DM 22), RFI (a channel with a
             persistent offset, a channel with a 60 Hz sinusoid, a burst
             over 80 channels for one rfifind interval) and three
             dispersed single pulses at DM 21.6; its DM-22 trial
             dedispersed, searched (zmax 200, numharm 8) and its
             deduplicated candidate list polished on the card (CUDA-event
             time, pairs, window taps, quadrature points) and on the CPU,
             every candidate held by polish.agreement: each candidate
             that breaks its curvature bound is printed with its
             numbers, and each must be a tie path (the open near-tie
             fault of ROADMAP queue 3), none unexplained;
  4. main    the beam through survey.run_survey with the JAX package's
             defaults (rfifind -time 2 as stage 1, its mask applied by
             prepsubband; single pulse on; fold_top=3) over DM 20-24
             (24 trials, nsub 32, zmax 200, numharm 8): launch counters
             read around it,
             the mask holding the RFI and equal to a CPU rfifind's (or
             each flipped cell printed with its margin), the DM-22 .dat
             byte-equal to a CPU prepsubband's with that mask, an ACCEL
             file and .cand per DM, stage times (rfifind, head, FFT +
             search, polish, ACCEL writes, sift, prepfold), the pulsar on
             top of the sifted list, the DM curve at its polished (r, z)
             peaking at the injected DM, three fold_candN.pfd/.bestprof
             with the first at the injected pulsar, each fold's drizzle
             and search device ms, and each fold's .pfd byte-equal to a
             refold on the CPU; a .singlepulse per DM (stage 9a on the
             seam), the beam's three injected single pulses found at
             their bins and DM, single_pulse_search on the CPU over four
             trials beside DM 21.6 agreeing with the card's files, and
             the stage's steps timed one by one on the survey's series;
  4b. ingest the survey head's host ingest: per-block read, decode,
             scrub, mask, clip, transpose and host->device times, on the
             first INGEST_BLOCKS blocks, before (seek-and-read, NumPy
             decode, clip into a copy, host transpose, pageable copy)
             and after this design; the feeder's overlap counts; the
             whole head (24 DMs, with its seam handoff, without and with
             the survey's mask); medians of 3 repeats; the device times
             of the uploads, the transpose and one rfifind interval's
             statistics;
  5. fold    prepfold of the filterbank at the top sifted candidate with
             the default (DM, p, pd) search on the card: the best DM
             within two grid steps of the injected, and the same cube
             searched on the CPU (chi2 surfaces and best trial);
  6. toas    get_TOAs (-n 8 -d <best DM>) on that fold, on the card and
             on the CPU: 8 TOAs whose phases under the injected (f0,
             fdot) agree within their errors, and the two agree;
  6b. sharded  torch.cuda.device_count() printed; the beam through
             run_survey on a DM mesh over every card, or 4 logical shards
             of cuda:0 on one card (said so: they share its memory and
             stream, no speed-up is shown), with the main phase's
             configuration: plane_build and stage_reduce launches per
             shard and per device (each launch on its shard's device);
             every .dat, .singlepulse and cands_sifted.txt byte-equal to
             the unsharded run's; each shard's candidate lists equal to
             the one-device search_many's on the same spectra; the two
             runs' stage times side by side, no claim;
  6c. cluster  two processes on the card run the survey's prepsubband
             method: through -coordinator (gloo; each writes its own
             rows), then through -elastic with one killed at a shard's
             commit point, the survivor finishing; every .dat of both
             byte-equal to the unsharded run's;
  6d. serve  survey jobs on the port's SearchService, four services on
             one plan store: two POST /submit specs of the beam with the
             main phase's configuration run as one stacked batch (one
             schedule event of occupancy 2, no degrade), each job's .dat,
             .singlepulse, ACCEL files, cands_sifted.txt and .pfd equal
             to the main run's; then, each prewarmed from the store
             (warm fraction 1.0, plan hits, no plan build), two jobs one
             after the other (stacked=False), two jobs as one stacked
             batch again (the pair timed against the pair alone, both
             warm), and one job over a mesh of two logical shards of the
             card (each shard's plane_build and stage_reduce launches);
             metrics() with the kernel cost book; the card's roofline
             peaks measured beside the nominal ones; a smoke-shape
             tuning sweep into a DB, read back through tune.best;
  7. small   spectra of 2^15 and 3000 bins searched on the card and on
             the CPU (the second on the non-aligned plane geometry);
  8. singlepulse  the JAX package's single-pulse bench shape (bench.py's
             128 series x 2^20 samples, seed 7): search_many_resident on
             the card, the warm call and the best of 2, its steps timed
             one by one (detrend, convolve + top-k, compaction, host
             prune), and 8 of the series by the plain versions on the CPU
             held to the card's events by singlepulse.agreement;
  9. jerk    the jerk search (wmax): the JAX package's jerk bench shape
             (bench.py's 2^20 bins, zmax 100, wmax 300, numharm 4, seed
             11, a tone at bin 123456) on the card, with the host bank
             build timed on its own, the warm call and the best of 2,
             cells/s, launches a search and the tone found; its polish
             on the card and the CPU by polish.agreement, and the jerk
             evaluators' difference held to JERK_EVAL_RTOL; plane_build
             at its geometry on the w = 300 bank and stage_reduce_planes
             on the four distinct planes of a w = 300 scan, against their
             plain versions (the z-only stage_reduce stays timed in
             phase 2); a jerk pulsar (2^21 samples) through accelsearch
             -wmax on the card and on the CPU, recovered on top, the two
             _JERK_ tables held by accel_agreement.jerk_file_agreement,
             and both kernels again at that path's geometry (numz 61,
             the 2-stage multi-plane reducer) on its spectrum;
 10. stream  one live beam of the beam's geometry (2^18 8-bit spectra,
             33.6 s) over a loopback socket, paced at 4x real time, into
             RingBlockSource -> StreamService on the port's SearchService
             (DM 0-255 in steps of 1, nsub 32, 8192-spectrum blocks, the
             rest StreamConfig's defaults): four dispersed pulses (DM 21.6,
             57, 143, 231) and a broadband DM-0 burst each triggered exactly
             once (time within 0.2 s, DM within 5 trials); four trials'
             rolling series byte-equal to the port's prepsubband .dat of
             the file on the card; deadline-lane batches and one latency
             sample a trigger; the blocks, triggers, latency p50/p99, the
             dedispersion step's device ms, the per-trial single-pulse
             loop's host ms a block and the real-time factor;
 11. beams   13 beams of that geometry (4 blocks each) through
             BeamMultiplexer, fed as fast as the rings take them, with the
             veto off (each beam's triggers equal to an independent
             StreamSearch's, its stacked series bit-equal to that one-beam
             carry's on every tick, stacked steps <= ticks) and with
             coincidence_k=3 (the burst in every beam vetoed, beam 0's
             pulse kept); the kernels of one tick (torch.profiler) equal
             at 1 and 13 beams; the stacked step's device ms at 13 beams
             beside 13 one-beam steps; the real-time factor;
 12. summary the kernels line (launches of the main path, the sharded
             main path, by shard too, the serve path, the jerk paths and
             the live paths; each kernel's bound also at the measured
             peaks),
             the card, and the final ok line.

Prints the full results as one JSON line (``results: {...}``).  Imports
no JAX and nothing of the JAX package.  ``--live-only`` runs phases 10 and
11 alone (no build, no kernels line, no final ok line).
"""

import argparse
import copy
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): device memory rate and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps=3):
    """Mean device time of fn() over reps launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes, flops):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_F32_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def reducer_geometry(nstages, multi=False):
    """(threads, rows a chunk, chunk buffers, dynamic shared memory bytes,
    CTAs an SM) of one stage_reduce instantiation (multi: the multi-plane
    kernel), from the library."""
    import ctypes
    from presto_tpu_torch import cuda_build
    out = (ctypes.c_int * 5)()
    fn = cuda_build.load("stage_reduce").stage_reduce_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    cuda_build.check(fn(nstages, int(multi), out), "stage_reduce_info")
    return list(out)


def phase_build():
    """Build both kernels; register and spill counts per instantiation
    from nvcc's -Xptxas -v (any spill fails), and each stage_reduce
    instantiation's shared memory and CTAs an SM."""
    from presto_tpu_torch import cuda_build
    t0 = time.time()
    logs = cuda_build.build_all(["plane_build", "stage_reduce",
                                 "native_io"])
    secs = time.time() - t0
    log("build: %.1f s (parallel nvcc, sm_90a; g++ for the native IO "
        "library)" % secs)
    usage = {}
    for name, text in logs.items():
        for fn, u in cuda_build.ptxas_usage(text).items():
            m = re.search(r"(plane_build|stage_reduce)_kernelILi(\d+)E"
                          r"(?:Lb([01])E)?", fn)
            multi = bool(m and m.group(3) == "1")
            key = ("%s<%s=%s%s>" % (m.group(1), "log2n" if m.group(1)
                                    == "plane_build" else "nst", m.group(2),
                                    ",multi" if multi else "")
                   if m else fn)
            if m and m.group(1) == "stage_reduce":
                threads, zc, stages, smem, ctas = reducer_geometry(
                    int(m.group(2)), multi)
                u.update(threads=threads, chunk_rows=zc, buffers=stages,
                         dynamic_smem=smem, ctas_per_sm=ctas)
            usage[key] = u
            log("  %s: %s: %s" % (name, key, json.dumps(u)))
    ok = True
    for kernel in ("plane_build", "stage_reduce"):
        inst = {k: u for k, u in usage.items() if k.startswith(kernel + "<")}
        spills = sorted(k for k, u in inst.items()
                        if u.get("spill_stores", 1) or u.get("spill_loads", 1))
        # plane_build: log2 n 8..14; stage_reduce: nstages 1..5 single-
        # plane and 2..5 multi-plane
        want = 7 if kernel == "plane_build" else 9
        kok = len(inst) == want and not spills
        ok = ok and kok
        log("build: %s instantiations %s, spilling %s %s"
            % (kernel, sorted(inst), spills, "ok" if kok else "FAIL"))
    return dict(ok=ok, seconds=secs, ptxas=usage)


def bench_searcher():
    from presto_tpu_torch.search import accel
    nbins = 1 << 21
    T = (1 << 22) * 1.28e-4
    return accel.AccelSearch(accel.AccelConfig(zmax=200, numharm=8),
                             T=T, numbins=nbins, device="cuda"), nbins


def plane_case(s, nbins, gen, label, Kc=None, pairs=None):
    """The plane builder at one searcher's geometry (forward spectra of a
    random spectrum, or of ``pairs``, through the searcher's own windows,
    normalization and FFT, and its kernel bank, or the bank Kc): kernel
    against plain,
    pads, times (kernel: 10 launches after a warm-up; plain and library:
    3), bound, and the library call (torch.fft.ifft + abs^2 over the
    same product) where device memory allows it."""
    from presto_tpu_torch.search import build_cuda
    if pairs is None:
        pairs = torch.randn((nbins, 2), generator=gen, device="cuda")
    S = s.forward_spectra(pairs)
    del pairs
    Kc = s._kbank if Kc is None else Kc
    nblocks, nb_pad, numr = s.plane_geom()
    off = s.hw_eff * 2
    numz, n = Kc.shape
    args = (S, Kc, s.numz_pad, nb_pad, s.cfg.uselen, off)
    got = build_cuda.build_plane(*args)
    want = build_cuda.build_plane_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    pads_zero = bool((got[numz:] == 0).all()
                     and (got[:, nblocks * s.cfg.uselen:] == 0).all())
    ok = err <= 1e-4 * scale and pads_zero and bool(torch.isfinite(got).all())
    del got, want
    torch.cuda.empty_cache()
    log("plane_build %s: S %s, Kc %s -> plane (%d, %d); max_abs_err %.3g "
        "(plane max %.3g), pads zero %s %s"
        % (label, tuple(S.shape), tuple(Kc.shape), s.numz_pad, numr, err,
           scale, pads_zero, "ok" if ok else "FAIL"))
    from presto_tpu_torch.obs import costmodel
    nbytes, flops = costmodel.plane_build_work(nblocks, numz, n,
                                               s.cfg.uselen, s.numz_pad, numr)
    bms, by = bound_ms(nbytes, flops)
    ms = cuda_time_ms(lambda: build_cuda.build_plane(*args), 10)
    plain_ms = cuda_time_ms(lambda: build_cuda.build_plane_plain(*args), 3)
    torch.cuda.empty_cache()
    lib_ms = None
    elems = nblocks * numz * n
    free, _total = torch.cuda.mem_get_info()
    if free > 32 * elems:      # product, ifft, abs, square + FFT workspace
        prod = torch.cat([S, S], dim=-1)[:, None, :] * Kc[None]
        lib_ms = cuda_time_ms(
            lambda: torch.fft.ifft(prod, dim=-1).abs().square(), 3)
        del prod
        torch.cuda.empty_cache()
    log("plane_build %s: kernel %.3f ms, plain %.3f ms, library (ifft+abs^2) "
        "%s ms, bound %.3f ms (%s)"
        % (label, ms, plain_ms, "%.3f" % lib_ms if lib_ms else
           "not measured (memory)", bms, by))
    return dict(ok=ok, n=n, plane=[s.numz_pad, numr], max_abs_err=err,
                rel_err=err / scale, pads_zero=pads_zero, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, bytes=nbytes, flops=flops), S


def check_plane_build(s, nbins, gen):
    """Kernel 1 at the main path's shape (zmax 200: n = 8192), at the
    zmax-400 geometry (n = 16384) and at a ragged shape."""
    from presto_tpu_torch.search import accel, build_cuda
    out, S = plane_case(s, nbins, gen, "main (zmax 200)")
    s400 = accel.AccelSearch(accel.AccelConfig(zmax=400, numharm=8),
                             T=s.T, numbins=nbins, device="cuda")
    out["zmax400"], _ = plane_case(s400, nbins, gen, "zmax 400")
    del s400, _
    torch.cuda.empty_cache()
    # ragged: non-power-of-8 rows and blocks, unaligned window
    Sr = torch.randn((13, 2048), dtype=torch.complex64, generator=gen,
                     device="cuda")
    Kr = torch.randn((51, 4096), dtype=torch.complex64, generator=gen,
                     device="cuda")
    rg = build_cuda.build_plane(Sr, Kr, 56, 16, 3000, 300)
    rw = build_cuda.build_plane_plain(Sr, Kr, 56, 16, 3000, 300)
    rerr = float((rg - rw).abs().max())
    rok = (rerr <= 1e-4 * float(rw.abs().max())
           and bool((rg[51:] == 0).all() and (rg[:, 13 * 3000:] == 0).all()))
    log("plane_build ragged (13 blocks of 4096, 51 rows, uselen 3000, "
        "off 300): max_abs_err %.3g %s" % (rerr, "ok" if rok else "FAIL"))
    # the short-spectrum templates, n = 256 and 512 (zmax 0 and 20 on a
    # few hundred bins), at ragged shapes
    for n, nb, nz, use, off in ((256, 5, 3, 97, 63), (512, 6, 21, 201, 55)):
        Ss = torch.randn((nb, n // 2), dtype=torch.complex64, generator=gen,
                         device="cuda")
        Ks = torch.randn((nz, n), dtype=torch.complex64, generator=gen,
                         device="cuda")
        sg = build_cuda.build_plane(Ss, Ks, -(-nz // 8) * 8, nb + 1, use, off)
        sw = build_cuda.build_plane_plain(Ss, Ks, -(-nz // 8) * 8, nb + 1,
                                          use, off)
        serr = float((sg - sw).abs().max())
        sok = (serr <= 1e-4 * float(sw.abs().max())
               and bool((sg[nz:] == 0).all())
               and bool((sg[:, nb * use:] == 0).all()))
        rok = rok and sok
        log("plane_build n = %d (%d blocks, %d rows, uselen %d, off %d): "
            "max_abs_err %.3g %s" % (n, nb, nz, use, off, serr,
                                     "ok" if sok else "FAIL"))
    out.update(ok=out["ok"] and out["zmax400"]["ok"] and rok,
               ragged_err=rerr,
               tolerance="max|kernel-plain| <= 1e-4 * max|plain|")
    return out, S


def reducer_design_bytes(zinds, nrows, slab, nslabs, nstages):
    """Bytes the stage reducer reads from device memory for these inputs
    (obs/costmodel.reducer_design_bytes at this instantiation's threads
    and chunk rows, from the library)."""
    from presto_tpu_torch.obs import costmodel
    threads, zc, _stages, _smem, _ctas = reducer_geometry(nstages)
    return costmodel.reducer_design_bytes(zinds.cpu().numpy(), nrows, slab,
                                          nslabs, nstages, threads, zc)


def reducer_bound(plane, scols, zinds, slab, nst):
    """The stage reducer's bound on these inputs: the plane, start
    columns and z maps read once, colmax and colz written once; one add
    a term and one compare a stage per plane element of the slabs
    (obs/costmodel.stage_reduce_work).  Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    from presto_tpu_torch.obs import costmodel
    nbytes, flops = costmodel.stage_reduce_work(
        plane.shape[0], plane.shape[1], scols.numel(), slab, nst,
        zinds.numel())
    ms, by = bound_ms(nbytes, flops)
    return ms, by, nbytes, flops


def check_stage_reduce(s, S, gen):
    """Kernel 2 on a real bench plane (numharm 8, and numharm 16 on the same
    plane), and at a ragged 5-stage shape; then the collect step that
    follows it on the main path."""
    from presto_tpu_torch.search import accel, accel_cuda, build_cuda
    nblocks, nb_pad, numr = s.plane_geom()
    plane = build_cuda.build_plane(S, s._kbank, s.numz_pad, nb_pad,
                                   s.cfg.uselen, s.hw_eff * 2)
    slab, k, start_cols = s.slab_plan(numr)
    scols = torch.tensor(start_cols, dtype=torch.int32, device="cuda")
    nst = s.cfg.numharmstages
    args = (plane, scols, s._zinds, slab, nst)
    gm, gz = accel_cuda.reduce_stages(*args)
    wm, wz = accel_cuda.reduce_stages_plain(*args)
    torch.cuda.synchronize()
    err = float((gm - wm).abs().max())
    zeq = bool((gz == wz).all())
    del wm, wz
    log("stage_reduce bench: plane %s, %d slabs of %d, %d stages; "
        "max_abs_err %.3g, colz equal %s" % (tuple(plane.shape),
                                             len(start_cols), slab, nst,
                                             err, zeq))
    ok = err == 0.0 and zeq
    # the collect step on the main path's reducer outputs: threshold,
    # segment max, top-k, compaction (search/accel.py)
    collect_ms = cuda_time_ms(lambda: accel.compact_scan_packed(
        accel.collect_from_reduced(gm, gz, s._powcut_dev, k)), 10)
    log("collect (collect_from_reduced + compact_scan_packed) on the "
        "reducer's outputs: %.3f ms" % collect_ms)
    del gm, gz
    # numharm 16 on the same plane: 5 stages, 15 terms, the largest
    # shared-memory footprint
    c16 = accel.AccelConfig(zmax=s.cfg.zmax, numharm=16)
    z16 = torch.tensor(np.stack([
        np.concatenate([z, np.arange(c16.numz, s.numz_pad)])
        for st in accel._harm_fracs_and_zinds(c16, c16.numz)
        for (_h, _t, z) in st]), dtype=torch.int32, device="cuda")
    args16 = (plane, scols, z16, slab, 5)
    hm, hz = accel_cuda.reduce_stages(*args16)
    pm, pz = accel_cuda.reduce_stages_plain(*args16)
    torch.cuda.synchronize()
    err16 = float((hm - pm).abs().max())
    ok16 = err16 == 0.0 and bool((hz == pz).all())
    del hm, hz, pm, pz
    ms16 = cuda_time_ms(lambda: accel_cuda.reduce_stages(*args16), 10)
    bytes16 = reducer_design_bytes(z16, plane.shape[0], slab,
                                   len(start_cols), 5)
    bms16, by16, _, _ = reducer_bound(plane, scols, z16, slab, 5)
    log("stage_reduce numharm 16 (5 stages) on the bench plane: "
        "max_abs_err %.3g, colz equal %s; kernel %.3f ms, bound %.3f ms "
        "(%s), design bytes %.3f GB (%.1f%% of 3.35 TB/s) %s"
        % (err16, ok16, ms16, bms16, by16, bytes16 / 1e9,
           100 * bytes16 / (ms16 * 1e-3) / PEAK_BYTES_PER_S,
           "ok" if ok16 else "FAIL"))
    # ragged: 16 harmonics (5 stages), 29 rows, unaligned slabs
    cfg = accel.AccelConfig(zmax=28, numharm=16)
    fz = accel._harm_fracs_and_zinds(cfg, cfg.numz)
    zi = torch.tensor(np.stack([np.concatenate([z, np.arange(cfg.numz, 32)])
                                for st in fz for (_h, _t, z) in st]),
                      dtype=torch.int32, device="cuda")
    P = torch.rand((32, 5000), generator=gen, device="cuda")
    sc = torch.tensor([0, 1234, 3999], dtype=torch.int32, device="cuda")
    rm, rz = accel_cuda.reduce_stages(P, sc, zi, 1000, 5)
    pm, pz = accel_cuda.reduce_stages_plain(P, sc, zi, 1000, 5)
    rerr = float((rm - pm).abs().max())
    rok = rerr == 0.0 and bool((rz == pz).all())
    log("stage_reduce ragged (5 stages, 32 rows, slabs of 1000): "
        "max_abs_err %.3g %s" % (rerr, "ok" if rok else "FAIL"))
    bms, by, nbytes, flops = reducer_bound(plane, scols, s._zinds, slab,
                                           nst)
    design = reducer_design_bytes(s._zinds, plane.shape[0], slab,
                                  len(start_cols), nst)
    ms = cuda_time_ms(lambda: accel_cuda.reduce_stages(*args), 10)
    plain_ms = cuda_time_ms(lambda: accel_cuda.reduce_stages_plain(*args),
                            1)
    del plane
    torch.cuda.empty_cache()
    share = design / (ms * 1e-3) / PEAK_BYTES_PER_S
    log("stage_reduce: kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s); "
        "design bytes %.3f GB (%.2fx the bound's), %.1f%% of 3.35 TB/s"
        % (ms, plain_ms, bms, by, design / 1e9, design / nbytes,
           100 * share))
    return dict(ok=ok and ok16 and rok, max_abs_err=err, ragged_err=rerr,
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                bound_by=by, bytes=nbytes, flops=flops,
                design_bytes=design, design_share=share,
                numharm16=dict(ok=ok16, max_abs_err=err16, ms=ms16,
                               bound_ms=bms16, bound_by=by16,
                               design_bytes=bytes16),
                collect_ms=collect_ms,
                tolerance="exact (same float32 add order)")


def synth_filterbank(path, gen, N, nchan, dt, lofreq, cw, pulsars,
                     rfi=None, bursts=(), device="cuda"):
    """Seeded 8-bit filterbank made on the card: for each pulsar (f0 Hz,
    fdot Hz/s, DM, fwhm in turns, amplitude), gaussian pulses dispersed
    by the cold-plasma delay; baseline 32, noise sigma 6, quantized x4
    like models/synth.fake_filterbank_file.  ``rfi`` (a dict like
    BEAM_RFI) adds a channel with a persistent offset, a channel with a
    sinusoid and a broadband burst over a span of spectra.  Each of
    ``bursts`` (arrival time at the top of the band s, DM, width s,
    amplitude) adds one dispersed boxcar pulse (burst_spans)."""
    from presto_tpu_torch.io.sigproc import FilterbankHeader, write_filterbank
    from presto_tpu_torch.ops.dedispersion import delay_from_dm
    freqs = lofreq + np.arange(nchan) * cw
    delays = []
    for (_f0, _fdot, dm, _width, _amp) in pulsars:
        d = delay_from_dm(dm, freqs)
        delays.append(torch.tensor(d - d.min(), dtype=torch.float64,
                                   device=device))
    spans = [(burst_spans(b, freqs, dt), b[3]) for b in bursts]
    out = torch.empty((N, nchan), dtype=torch.uint8, device=device)
    step = 1 << 20
    for t0 in range(0, N, step):
        t = (torch.arange(t0, min(N, t0 + step), device=device,
                          dtype=torch.float64) + 0.5) * dt
        x = None
        for (f0, fdot, _dm, width, amp), dl in zip(pulsars, delays):
            tc = t[:, None] - dl[None, :]
            ph = torch.remainder(f0 * tc + 0.5 * fdot * tc * tc, 1.0)
            pulse = amp * torch.exp(
                -0.5 * ((ph - 0.5) / (width / 2.35482)) ** 2).float()
            x = pulse if x is None else x + pulse
        if x is None:                       # no pulsar: noise alone
            x = torch.zeros((t.shape[0], nchan), device=device)
        x = 32.0 + x + 6.0 * torch.randn(x.shape, generator=gen,
                                         device=device)
        if rfi is not None:
            x[:, rfi["narrow_chan"]] += rfi["narrow_amp"]
            x[:, rfi["periodic_chan"]] += (rfi["periodic_amp"] * torch.sin(
                2 * np.pi * rfi["periodic_hz"] * t)).float()
            b0, b1 = rfi["burst"]
            c0, c1 = rfi["burst_chans"]
            lo, hi = max(b0 - t0, 0), min(b1 - t0, x.shape[0])
            if lo < hi:
                x[lo:hi, c0:c1] += rfi["burst_amp"]
        for span, amp in spans:
            for c, (s0, s1) in enumerate(span):
                lo, hi = max(s0 - t0, 0), min(s1 - t0, x.shape[0])
                if lo < hi:
                    x[lo:hi, c] += amp
        out[t0:t0 + t.shape[0]] = torch.clamp(torch.round(x * 4.0),
                                              0, 255).to(torch.uint8)
    hdr = FilterbankHeader(source_name="FAKEPSR", machine_id=10,
                           telescope_id=6, fch1=lofreq + (nchan - 1) * cw,
                           foff=-cw, nchans=nchan, nbits=8,
                           tstart=59000.0, tsamp=dt, nifs=1,
                           rawdatafile=os.path.basename(path))
    write_filterbank(path, hdr, out.cpu().numpy())


def burst_spans(burst, freqs, dt):
    """Per channel, the [start, end) spectra of a dispersed boxcar pulse
    (arrival time at the top of the band s, DM, width s, amplitude)."""
    from presto_tpu_torch.ops.dedispersion import delay_from_dm
    t0, dm, width, _amp = burst
    d = delay_from_dm(dm, freqs)
    w = int(round(width / dt))
    starts = np.round((t0 + d - d.min()) / dt).astype(np.int64)
    return [(int(a), int(a) + w) for a in starts]


# the beam of the main, fold and toas phases: 537 s of 128 channels x 3 MHz
# at 1214-1595 MHz; 0.5 ms pulses of a 40.3 Hz pulsar at DM 22 with
# fdot 1.4e-4 Hz/s.  One DM step (0.2) smears 0.24 ms across the band, so
# the sigma curve is flat to noise within ~0.4 of the true DM and the
# best single trial may sit two steps off; the DM is read from the
# curve's parabola peak, within one step.  Two weaker pulsars (7.13 Hz
# at DM 21, 113.7 Hz at DM 23.3, no fdot, frequencies in no simple ratio
# with each other or 40.3) give the sift three candidates to fold, as
# the JAX package's default fold_top=3 asks.  The polish phase takes the
# 40.3 Hz pulsar alone, on the same noise.
BEAM = dict(N=1 << 22, nchan=128, dt=1.28e-4, lofreq=1214.0, cw=3.0,
            f0=40.3, fdot=1.4e-4, dm=22.0, width=0.02,
            others=((7.13, 0.0, 21.0, 0.03, 0.3),
                    (113.7, 0.0, 23.3, 0.05, 0.2)))
BEAM_SEED = 22
# RFI in the beam, so that the survey's rfifind stage (-time 2: intervals
# of 15625 spectra, 268 of them) has something to mask: channel 40 with a
# persistent +7.5 (1.25 noise sigma), channel 90 with a 60 Hz sinusoid of
# amplitude 2.5, and rfifind interval 96 with a +2 burst over channels
# 32-111 (160 on the band sum, 2.4 of its sigma: under the clipper's 6).
# The burst covers 80 of 128 channels, under rfifind's -chanfrac 0.7, so
# the interval's cells are masked channel by channel and the interval is
# not zapped whole.
BEAM_RFI = dict(narrow_chan=40, narrow_amp=7.5, periodic_chan=90,
                periodic_amp=2.5, periodic_hz=60.0,
                burst=(96 * 15625, 97 * 15625), burst_chans=(32, 112),
                burst_amp=2.0)
# three dispersed single pulses at DM 21.6 for the survey's single-pulse
# stages: (arrival at the top of the band s, DM, width s, amplitude per
# channel), 4, 12 and 27 samples wide (under MAX_DOWNFACT 30).  A boxcar
# of w samples and amplitude A over 128 channels of noise sigma 6 has a
# matched S/N of A sqrt(128 w) / 6: 22.6, 22.9 and 34.3.  None lies in
# the prepsubband block (184.5-201.3 s) that rfifind interval 96's mask
# blanks in 80 channels.  The two wider ones are centred on a boundary of
# the search's 1000-sample detrend blocks in the DM-21.6 series
# (prepsubband puts that trial's output 20 samples before the top
# channel's arrival): a block that holds a whole 27-sample pulse of 6.6
# sigma a sample has a robust std some 6% high, and the search's
# bad-block cut (the reference's rule) zaps it.
BEAM_PULSES = ((60.3, 21.6, 0.5e-3, 6.0),
               ((1959000 - 6 + 20) * 1.28e-4, 21.6, 1.5e-3, 3.5),
               ((3126000 - 13 + 20) * 1.28e-4, 21.6, 3.5e-3, 3.5))


def make_beam(workdir, name="psr.fil"):
    """The seeded beam with its three pulsars, RFI and single pulses, made
    on the card from its own seed, so the data do not depend on what the
    kernel phases drew."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(BEAM_SEED)
    raw = os.path.join(workdir, name)
    b = BEAM
    pulsars = ((b["f0"], b["fdot"], b["dm"], b["width"], 1.0),) \
        + b["others"]
    synth_filterbank(raw, gen, b["N"], b["nchan"], b["dt"], b["lofreq"],
                     b["cw"], pulsars, rfi=BEAM_RFI, bursts=BEAM_PULSES)
    return raw


def phase_polish(raw, workdir):
    """One DM's deduplicated candidate list (the injected DM's trial of
    the main beam, dedispersed, FFT'd and searched on the card) polished
    on the card, timed with CUDA events after a warm-up call, and on the
    CPU with the plain PyTorch path, every candidate held by
    polish.agreement (the same grid point, or a near-tie move of at most
    AGREE_STEPS final-stage steps whose two points' powers, evaluated
    on the CPU, differ by no more than the grid's curvature bound).  The
    phase fails on any candidate that breaks the rule unexplained; one
    that the descent replay names a tie path (an earlier stage's
    near-tie: ROADMAP queue 3's open fault) is printed with its numbers
    and counted."""
    from presto_tpu_torch.apps import prepsubband
    from presto_tpu_torch.pipeline import fusion, survey
    from presto_tpu_torch.search import accel, polish
    os.makedirs(workdir)
    seam = fusion.StageSeam(workdir, durable=False)
    prepsubband.run(prepsubband.build_parser().parse_args(
        ["-lodm", str(BEAM["dm"]), "-dmstep", "0.2", "-numdms", "1",
         "-nsub", "32", "-nobary", "-o", os.path.join(workdir, "probe"),
         raw]), device="cuda", seam=seam)
    block = seam.blocks[0]
    n = block.numout & ~1
    T = block.numout * fusion.inf_float(block.dt)
    pairs = fusion.fused_rfft_batch(block.series_dev[:, :n])[0]
    del seam, block
    cfg = survey.SurveyConfig(zmax=200, numharm=8)
    searcher = survey.searcher_for(cfg, T, n // 2, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    raw_c = searcher.search(pairs)
    search_s = time.time() - t0
    cands = accel.remove_duplicates(accel.eliminate_harmonics(raw_c))
    nh = np.array([c.numharm for c in cands])
    zh = max(abs(c.z) * c.numharm for c in cands)
    W, npts = polish._geometry(zh + polish.STEP0_Z * polish.GRID_G + 1.0)

    def run(spec, dev):
        return polish.optimize_accelcands(spec, cands, T, searcher.numindep,
                                          with_props=False, device=dev)
    run(pairs, "cuda")                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.time()
    e0.record()
    card = run(pairs, "cuda")
    e1.record()
    torch.cuda.synchronize()
    card_s = time.time() - t0
    card_ms = e0.elapsed_time(e1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.time()
    cpu = run(pairs.cpu(), "cpu")
    cpu_s = time.time() - t0
    rep = polish.agreement(pairs.cpu(), cpu, card, seeds=cands)
    ok, moved, worst = rep["unexplained"] == 0, rep["moved"], rep["worst"]
    for f in rep["flags"]:
        log("polish: candidate %d breaks the agreement rule (%s): %s"
            % (f["i"], "tie path, open fault" if f.get("tie_path")
               else "unexplained", json.dumps(f, default=float)))
    # evaluations of A per pair: 2 re-centre + 4 shrinking stages of a
    # 7x7 grid, and two 23-point measures (seed locpow, final)
    evals = (2 + polish.N_STAGES - 1) * (2 * polish.GRID_G + 1) ** 2 + 2 * 23
    res = dict(ok=ok, dm=BEAM["dm"], raw_cands=len(raw_c),
               cands=len(cands), pairs=int(nh.sum()),
               numharm_counts={int(h): int((nh == h).sum())
                               for h in np.unique(nh)},
               W=W, npts=npts, evals_per_pair=evals,
               cexp_per_pair=evals * npts, search_s=search_s,
               card_ms=card_ms, card_host_s=card_s, cpu_s=cpu_s,
               peak_gb=peak_gb, moved=moved, tie_paths=rep["tie_paths"],
               unexplained=rep["unexplained"], worst=worst,
               flags=rep["flags"],
               tolerance="same grid point: power rtol %g, sigma %g; moved: "
                         "<= %d final-stage steps, |P(a) - P(b)| and the "
                         "reported powers within (curvature loss + %g P), "
                         "sigma %g; a move past that is a tie path when "
                         "the descent with stage ties within %g reaches "
                         "both points, the reported powers are its final "
                         "measurements within %g, the move and sigma "
                         "within the limits above, else unexplained "
                         "(fails)" % (
                             polish.SAME_POWER_RTOL, polish.SAME_SIGMA,
                             polish.AGREE_STEPS, 2 * polish.EVAL_RTOL,
                             polish.MOVED_SIGMA, polish.TIE_RTOL,
                             2 * polish.EVAL_RTOL))
    log("polish (DM %.1f): %d raw -> %d candidates, %d pairs %s, W %d, "
        "npts %d, %d complex exponentials a pair; card %.3f ms (CUDA "
        "events; host %.3f s, peak %.2f GB), CPU %.2f s; %d candidates "
        "moved by a near-tie, %d of them past the curvature bound on a "
        "tie path (open fault), %d unexplained; worst (power and sigma on "
        "the same point, steps and gap / bound of the moved) %s %s"
        % (BEAM["dm"], len(raw_c), len(cands), res["pairs"],
           res["numharm_counts"], W, npts, res["cexp_per_pair"], card_ms,
           card_s, peak_gb, cpu_s, moved, rep["tie_paths"],
           rep["unexplained"],
           json.dumps(worst, default=float),
           "ok" if ok else "FAIL"))
    return res


def dm_of(path):
    return float(os.path.basename(path).rsplit("_DM", 1)[1].split("_")[0])


def parabola_peak(curve):
    """Peak of the least-squares parabola through (DM, value) points."""
    pa, pb, _pc = np.polyfit([c[0] for c in curve], [c[1] for c in curve],
                             2)
    return float(-pb / (2 * pa)) if pa < 0 else float("nan")


def dm_curve(top, accs):
    """The DM curve at one candidate: on each DM trial's .fft, the power
    summed over the candidate's harmonics at its polished (r, z)
    (optimize.power_at_rz), in units of that spectrum's median power /
    ln 2 (the noise level, estimated over every bin)."""
    from presto_tpu_torch.io import datfft
    from presto_tpu_torch.search.optimize import power_at_rz
    out = []
    for a in accs:
        amps = datfft.read_fft(a.rsplit("_ACCEL_", 1)[0] + ".fft")
        noise = float(np.median(np.abs(amps[1:]) ** 2)) / np.log(2.0)
        tot = sum(power_at_rz(amps, top.r * h, top.z * h)
                  for h in range(1, top.numharm + 1))
        out.append((dm_of(a), round(float(tot / noise), 1)))
    return out


def phase_main(raw, workdir):
    """The main path: survey.run_survey on the beam, launch counters
    read around it; stage times from its StageTimer (host seconds; every
    stage ends in a device-to-host copy)."""
    from presto_tpu_torch.apps.accelsearch import read_cand_file
    from presto_tpu_torch.io.infodata import read_inf
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.search import accel_cuda, build_cuda
    from presto_tpu_torch.utils.timing import StageTimer
    b = BEAM
    cfg = main_cfg()
    timer = StageTimer()
    build_cuda.launches = 0
    accel_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with FoldClock("cuda") as clock:
        res = survey.run_survey([raw], cfg, workdir, timer=timer,
                                device="cuda")
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = {"plane_build": build_cuda.launches,
                "stage_reduce": accel_cuda.launches}
    ndms = len(res.datfiles)
    st = timer.stages
    fused = st["realfft+accelsearch (fused)"]
    stages = dict(run_survey_s=total_s, rfifind_s=st["rfifind"],
                  survey_head_s=st["prepsubband"],
                  single_pulse_s=st["single_pulse"],
                  fused_s=fused, polish_s=st["polish"],
                  polish_per_dm_s=timer.samples["polish"],
                  accel_writes_s=st["accel writes"], sift_s=st["sift"],
                  prepfold_s=st["prepfold"],
                  fft_search_s=fused - st["polish"] - st["accel writes"])
    stages["fft_search_per_dm_s"] = stages["fft_search_s"] / max(ndms, 1)
    info = read_inf(res.datfiles[0][:-4])
    T = info.N * info.dt
    nbins = int(info.N) // 2
    accs = sorted(glob.glob(os.path.join(workdir, "psr_DM*_ACCEL_%d"
                                         % cfg.zmax)))
    files_ok = (len(accs) == ndms > 0
                and all(os.path.exists(a + ".cand") for a in accs))
    # per DM: the polished candidates (count; best sigma above flo)
    counts, sig_curve = [], []
    for a in accs:
        cs = read_cand_file(a + ".cand")
        counts.append(len(cs))
        sig_curve.append((dm_of(a), round(float(max(
            (c.sigma for c in cs if c.r / T > cfg.flo), default=0.0)), 2)))
    stages["polished_per_dm"] = counts
    top = res.sifted[0] if len(res.sifted) else None
    curve = dm_curve(top, accs) if top is not None else []
    # the device share of the survey head: one streamed dedispersion
    # step at the main path's block shape and delay plan, times blocks
    from presto_tpu_torch.apps import common, prepsubband
    from presto_tpu_torch.ops import dedispersion as dd
    fb = common.open_raw(raw)
    args = prepsubband.build_parser().parse_args(
        ["-lodm", "20", "-dmstep", "0.2", "-numdms", str(ndms), "-nsub",
         "32", "-nobary", raw])
    _dms, chan_bins, dm_bins = prepsubband.plan_delays(fb.header, args)
    blocklen = common.stream_blocklen(
        b["nchan"], int(max(chan_bins.max(), dm_bins.max())), b["N"])
    fb.close()
    step = dd.make_block_step(chan_bins, dm_bins, 32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(BEAM_SEED)
    blk = [torch.rand((b["nchan"], blocklen), generator=gen, device="cuda")
           for _ in range(2)]
    sub0 = dd.dedisp_subbands_block(blk[0], blk[1], chan_bins, 32)
    stages["dedisp_step_ms"] = cuda_time_ms(
        lambda: step(blk[0], blk[1], sub0))
    stages["dedisp_blocks"] = -(-b["N"] // blocklen) + 2
    log("main: %d DMs (DDplan %g-%g, nsub %d), numout %d (%d bins), "
        "zmax %d, numharm %d" % (ndms, cfg.lodm, cfg.hidm, cfg.nsub,
                                 int(info.N), nbins, cfg.zmax, cfg.numharm))
    log("main: stage times %s" % json.dumps(
        {k: ([round(x, 4) for x in v] if isinstance(v, list)
             else round(v, 4)) for k, v in stages.items()}))
    log("main: launches %s; ACCEL + .cand for %d of %d DMs"
        % (json.dumps(launches), len(accs), ndms))
    log("main: per DM best polished sigma %s; its parabola peak %.3f "
        "(the 20-bin local power of each polished harmonic carries the "
        "noise of its DM trial, so this curve is not held to the DM)"
        % (sig_curve, parabola_peak(sig_curve)))
    peak_dm = parabola_peak(curve)
    log("main: DM curve at the top candidate's (r, z): %s; parabola peak "
        "%.3f (injected %.2f)" % (curve, peak_dm, b["dm"]))
    f = top.f if top is not None else 0.0
    h = max(1, round(f / b["f0"]))
    top_ok = (top is not None and f > cfg.flo
              and abs(f / h - b["f0"]) < 0.1
              and len(top.hits) >= cfg.min_dm_hits)
    log("main: %d sifted; top %s: DM %.2f, f %.6f Hz (harmonic %d of %.2f),"
        " z %.2f, sigma %.2f, numharm %d, %d DM hits %s"
        % (len(res.sifted), top.filename if top else None,
           top.DM if top else 0, f, h, b["f0"], top.z if top else 0,
           top.sigma if top else 0, top.numharm if top else 0,
           len(top.hits) if top else 0, "ok" if top_ok else "FAIL"))
    folds = check_main_folds(res, workdir, clock, T)
    masks = check_main_mask(raw, res, workdir, cfg)
    sp = check_main_singlepulse(raw, res, workdir, timer)
    ok = (abs(peak_dm - b["dm"]) <= 0.21 and top_ok and files_ok
          and nbins == 1 << 21 and folds["ok"] and masks["ok"] and sp["ok"]
          and all(v == ndms > 0 for v in launches.values()))
    return dict(ok=ok, ndms=ndms, nbins=nbins, stages=stages, masks=masks,
                singlepulse=sp,
                maskfile=res.maskfile,
                launches=launches, dm_curve=curve, dm_curve_peak=peak_dm,
                polished_sigma_curve=sig_curve,
                sifted=len(res.sifted), top_freq=f,
                top_sigma=top.sigma if top else None,
                top_dm=top.DM if top else None,
                top_hits=len(top.hits) if top else 0, folds=folds,
                top=top)


# a bytemask cell may flip between the card and the CPU only this close
# to its threshold (relative): the statistics differ by ~1e-6
FLIP_MARGIN = 1e-4


def check_main_mask(raw, res, workdir, cfg):
    """The survey's stage 1 against the CPU: rfifind of the same file on
    the CPU (plain versions) writes the same .mask bytes, or each cell
    whose bytemask flipped is printed with its margin to its threshold,
    which must be under FLIP_MARGIN; the smallest margin of any cell is
    printed either way (cuFFT and the CPU's FFT differ in the last
    bits).  The mask holds the injected
    RFI.  Then prepsubband of the survey's DDplan method with that mask
    on the CPU: the injected DM's .dat equal to the survey's bytes."""
    from presto_tpu_torch.apps import prepsubband, rfifind
    from presto_tpu_torch.io.maskfile import read_mask, read_statsfile
    from presto_tpu_torch.search import rfifind as srfi
    b = BEAM
    cpu = os.path.join(workdir, "cpu")
    os.makedirs(cpu)
    t0 = time.time()
    rfifind.main(["-time", str(cfg.rfi_time), "-noplot", "-o",
                  os.path.join(cpu, "psr"), raw], device="cpu")
    rfi_cpu_s = time.time() - t0
    card_base = res.maskfile[:-len(".mask")]
    cpu_base = os.path.join(cpu, "psr_rfifind")
    same = (open(res.maskfile, "rb").read()
            == open(cpu_base + ".mask", "rb").read())
    stc, stu = (read_statsfile(p + ".stats") for p in (card_base, cpu_base))
    geo = dict(dt=b["dt"], lofreq=b["lofreq"], chanwidth=b["cw"])
    bmc = srfi.rfifind_from_stats(stc, **geo).bytemask
    bmu = srfi.rfifind_from_stats(stu, **geo).bytemask
    margins = srfi.cell_margins(stu["dataavg"], stu["datastd"],
                                stu["datapow"], stu["ptsperint"])
    flips = [dict(interval=int(i), chan=int(c), card=int(bmc[i, c]),
                  cpu=int(bmu[i, c]), margin=float(margins[i, c]))
             for i, c in zip(*np.nonzero(bmc != bmu))]
    stat_err = {k: float(np.max(np.abs(stc[k] - stu[k])
                                / np.maximum(np.abs(stu[k]), 1e-30)))
                for k in ("dataavg", "datastd", "datapow")}
    m = read_mask(res.maskfile)
    rfi = BEAM_RFI
    burst_int = rfi["burst"][0] // stc["ptsperint"]
    burst_chans = set(m.chans_per_int[burst_int].tolist())
    rfi_ok = ({rfi["narrow_chan"], rfi["periodic_chan"]}
              <= set(m.zap_chans.tolist())
              and set(range(*rfi["burst_chans"])) <= burst_chans)
    log("main: rfifind %d ints x %d chans, zapped channels %s, intervals "
        "%s, %d channels masked in interval %d; mask holds the injected "
        "RFI %s" % (m.numint, m.numchan, m.zap_chans.tolist(),
                    m.zap_ints.tolist(), len(burst_chans), burst_int,
                    "ok" if rfi_ok else "FAIL"))
    log("main: .mask bytes equal to a CPU rfifind (%.2f s) %s; stats card "
        "vs CPU max relative diff %s; smallest cell margin to a threshold "
        "%.3g at %s; flipped cells %s"
        % (rfi_cpu_s, same, json.dumps(stat_err), float(margins.min()),
           list(np.unravel_index(int(np.argmin(margins)), margins.shape)),
           json.dumps(flips)))
    # prepsubband with the mask on the CPU, the survey's method
    t0 = time.time()
    prepsubband.main(method_argv(raw, cfg, os.path.join(cpu, "psr"))
                     + ["-mask", res.maskfile, raw], device="cpu")
    prep_cpu_s = time.time() - t0
    name = "psr_DM%.2f.dat" % b["dm"]
    dat_same = (open(os.path.join(workdir, name), "rb").read()
                == open(os.path.join(cpu, name), "rb").read())
    log("main: %s with the mask equal to a CPU prepsubband's (%.1f s) %s"
        % (name, prep_cpu_s, "ok" if dat_same else "FAIL"))
    for f in glob.glob(os.path.join(cpu, "psr_DM*")):
        os.remove(f)
    flips_ok = all(f["margin"] <= FLIP_MARGIN for f in flips)
    return dict(ok=rfi_ok and (same or (flips and flips_ok)) and dat_same,
                mask_equal_cpu=same, flips=flips,
                min_margin=float(margins.min()), stats_rel_err=stat_err,
                zap_chans=m.zap_chans.tolist(),
                zap_ints=m.zap_ints.tolist(), dat_equal_cpu=dat_same,
                rfifind_cpu_s=rfi_cpu_s, prepsubband_cpu_s=prep_cpu_s)


def main_cfg():
    """The main path's survey configuration: the JAX package's defaults
    (rfifind on, -time 2; single pulse on; fold_top 3) over DM 20-24,
    zmax 200."""
    from presto_tpu_torch.pipeline import survey
    return survey.SurveyConfig(lodm=20.0, hidm=24.0, nsub=32, zmax=200,
                               numharm=8, fold_top=3, durable_stages=True)


def cuda_event():
    return torch.cuda.Event(enable_timing=True)


def sp_split(sp, series, dt, dms, offregions_list=None, G=2048):
    """search_many_resident's steps on [nf, N] device series, one by one:
    CUDA-event ms of the detrend, the convolve + top-k (with the
    normalization and framing before it) and the compaction (summed over
    the sub-batches), host ms of the block scales, of the decode and
    prune, and of the files with more than G hits, which go through
    search_many (the overflow path, as in search_many_resident); each
    step's calls and the bytes it must move (each input read once, each
    output written once) and float32 operations (the FFTs at 2.5 n log2 n
    each way, 6 a complex product), for its bound.  Returns (split,
    per-file results as search_many_resident's)."""
    from presto_tpu_torch.search import singlepulse as spm
    nf, N = series.shape
    dlen = sp.detrendlen
    nblk = N // dlen
    roundN = nblk * dlen
    widths, chunklen, fftlen, overlap, kern_f = sp._chunk_geometry(
        [1] + list(sp.downfacts_for(dt)))
    W, k = len(widths), min(sp.topk, chunklen)
    thr = float(np.float32(sp.threshold))
    e = [cuda_event() for _ in range(2)]
    e[0].record()
    resid, stds = spm._detrend_blocks(
        series[:, :roundN].reshape(nf * nblk, dlen), dlen, sp.fast_detrend)
    e[1].record()
    stds = stds.cpu().numpy().reshape(nf, nblk)
    ms = dict(detrend=e[0].elapsed_time(e[1]), convolve_topk=0.0,
              compaction=0.0)
    h0 = time.perf_counter()
    scales, masks, bads = sp.block_scales(stds)
    ms["scales_host"] = (time.perf_counter() - h0) * 1e3
    e = [cuda_event() for _ in range(2)]
    e[0].record()
    frames = spm.resident_frames(
        resid, torch.as_tensor(scales, device=resid.device),
        torch.as_tensor(masks, device=resid.device), dlen, nblk, chunklen,
        fftlen, overlap)
    e[1].record()
    torch.cuda.synchronize()
    ms["convolve_topk"] += e[0].elapsed_time(e[1])
    F = frames.shape[1]
    per = max(1, spm.SMOOTH_BYTES // (F * W * fftlen * 4))
    host = []
    for f0 in range(0, nf, per):
        fr = frames[f0:f0 + per]
        nb = fr.shape[0]
        e = [cuda_event() for _ in range(3)]
        e[0].record()
        vals, idx, counts = spm._convolve_topk(
            fr.reshape(nb * F, fftlen), kern_f, thr, fftlen, overlap, k)
        e[1].record()
        tv, ti, tb = spm.compact_hits(vals.reshape(nb, F, W, k),
                                      idx.reshape(nb, F, W, k), thr, G)
        e[2].record()
        host.append([a.cpu().numpy() for a in
                     (tv, ti, tb, counts.reshape(nb, F, W))])
        ms["convolve_topk"] += e[0].elapsed_time(e[1])
        ms["compaction"] += e[1].elapsed_time(e[2])
    del resid, frames
    tv, ti, tb, counts = (np.concatenate([h[i] for h in host])
                          for i in range(4))
    out, overflow = [], []
    ms["prune_host"] = ms["overflow_host"] = 0.0
    for fi in range(nf):
        offs = offregions_list[fi] if offregions_list else ()
        h0 = time.perf_counter()
        if np.minimum(counts[fi], k).sum() > G:
            # more than G hits: the file goes through search_many (the
            # reference's own path, on the same device)
            overflow.append(fi)
            out.append(sp.search_many([series[fi].cpu().numpy()], dt,
                                      [dms[fi]], [offs])[0])
            ms["overflow_host"] += (time.perf_counter() - h0) * 1e3
            continue
        cands = sp.decode_hits(tv[fi], ti[fi], tb[fi], widths, chunklen, k,
                               roundN, dt, dms[fi])
        out.append((sp._post_filter(cands, bads[fi], offs),
                    1.0 / scales[fi], bads[fi]))
        ms["prune_host"] += (time.perf_counter() - h0) * 1e3
    nsub = -(-nf // per)
    fft_ops = 2.5 * fftlen * np.log2(fftlen) * (1 + W) * nf * F \
        + 6.0 * (fftlen // 2 + 1) * W * nf * F
    work = dict(
        detrend=dict(calls=1, bytes=nf * roundN * 8 + nf * nblk * 4,
                     ops=0.0),
        convolve_topk=dict(calls=nsub, ops=fft_ops,
                           bytes=nf * roundN * 4 + nf * nblk * 8
                           + nf * F * W * (k * 12 + 8)),
        compaction=dict(calls=nsub, ops=0.0,
                        bytes=nf * F * W * k * 12 + nf * G * 20))
    for name, wk in work.items():
        wk["bound_ms"], wk["bound_by"] = bound_ms(wk["bytes"], wk["ops"])
    split = dict(ms=ms, work=work, overflow_files=len(overflow),
                 hits_capped=[int(np.minimum(c, k).sum()) for c in counts],
                 subbatch_files=per, frames=F, widths=W, k=k, G=G)
    return split, out


# the injected single pulses' DM, and the trials searched again on the
# CPU (the two on each side of it)
SP_DM = 21.6
SP_CPU_DMS = ("21.20", "21.40", "21.80", "22.00")


def band_sweep_bins(ddm):
    """Samples of the cold-plasma sweep across the beam's band for a DM
    error of ddm (the smearing of a trial ddm away)."""
    from presto_tpu_torch.ops.dedispersion import delay_from_dm
    b = BEAM
    f = b["lofreq"] + np.array([0.0, (b["nchan"] - 1) * b["cw"]])
    d = delay_from_dm(abs(ddm), f)
    return int(np.ceil((d[0] - d[1]) / b["dt"]))


def pulse_centres(raw, cfg, burst):
    """{trial DM: the centre bin of an injected pulse (burst_spans) in
    that trial's series}, through prepsubband's own delay plan: channel c
    of output sample k reads raw sample k + chan_bins[c] + dm_bins[trial,
    subband of c]."""
    from presto_tpu_torch.apps import prepsubband
    from presto_tpu_torch.apps.common import open_raw
    b = BEAM
    fb = open_raw(raw)
    args = prepsubband.build_parser().parse_args(
        method_argv(raw, cfg, "unused") + [raw])
    dms, chan_bins, dm_bins = prepsubband.plan_delays(fb.header, args)
    fb.close()
    freqs = b["lofreq"] + np.arange(b["nchan"]) * b["cw"]
    spans = burst_spans(burst, freqs, b["dt"])
    starts = np.array([a for a, _e in spans])
    sub = np.arange(b["nchan"]) // (b["nchan"] // cfg.nsub)
    w = spans[0][1] - spans[0][0]
    return {round(float(d), 2): int(np.median(starts - chan_bins
                                             - dm_bins[i, sub])) + w // 2
            for i, d in enumerate(dms)}


def check_injected_pulses(events, injected, centres, dt=BEAM["dt"]):
    """For each injected pulse (t0, DM, width, amplitude), its centres
    {trial DM: bin} (pulse_centres) and the events {trial DM:
    [SPCandidate]}: in the trial nearest its DM and the trials on each
    side, the strongest event within +-(width/2 + the trial's DM
    smearing + 2) bins of its centre, which must be the strongest within
    +-0.5 s and at least 8 sigma; and the trial where it peaks, within
    0.4 of its DM.  Each is printed."""
    dms = sorted(events)
    out = []
    for (t0, pdm, width, _amp), cen in zip(injected, centres):
        w = int(round(width / dt))
        best = {}
        for d in dms:
            win = w // 2 + band_sweep_bins(d - pdm) + 2
            inwin = [c for c in events[d]
                     if abs(c.bin - cen[round(d, 2)]) <= win]
            best[d] = max(inwin, key=lambda c: c.sigma, default=None)
        found = [d for d in dms if best[d] is not None]
        peak = max(found, key=lambda d: best[d].sigma, default=None)
        inear = min(range(len(dms)), key=lambda i: abs(dms[i] - pdm))
        near = []
        for d in dms[max(inear - 1, 0):inear + 2]:
            c = best[d]
            around = [x for x in events[d]
                      if abs(x.bin - cen[round(d, 2)]) <= 0.5 / dt]
            top = max(around, key=lambda x: x.sigma, default=None)
            near.append(dict(
                dm=d, centre=cen[round(d, 2)],
                sigma=c.sigma if c else None,
                downfact=c.downfact if c else None,
                bin=c.bin if c else None,
                strongest=c is not None and top is c and c.sigma >= 8.0))
        pok = (all(n["strongest"] for n in near) and peak is not None
               and abs(peak - pdm) <= 0.4)
        out.append(dict(t=t0, width_bins=w, trials=near, peak_dm=peak,
                        peak_sigma=best[peak].sigma if peak else None,
                        ok=pok))
        log("single pulse at %.3f s (%d bins, DM %.1f): %s; peak over %d "
            "trials at DM %s (sigma %s) %s"
            % (t0, w, pdm, "; ".join(
                "DM %.2f sigma %s downfact %s bin %s (centre %d)%s"
                % (n["dm"], n["sigma"], n["downfact"], n["bin"],
                   n["centre"], "" if n["strongest"] else " FAIL")
                for n in near),
               len(dms), peak, out[-1]["peak_sigma"],
               "ok" if pok else "FAIL"))
    return out


def check_main_singlepulse(raw, res, workdir, timer):
    """Stages 9a (the seam) and 9 (verify) of the main phase: a
    .singlepulse per DM with res.sp_events events in all; each injected
    pulse (BEAM_PULSES) is the strongest event within +-0.5 s, and at
    least 8 sigma, within +-(width/2 + the trial's DM smearing + 1) bins
    of its centre in the trial nearest its DM and in the trials on each
    side, and the trial where it peaks lies within 0.4 of its DM.  Then
    single_pulse_search on the CPU over the durable .dat of SP_CPU_DMS:
    each .singlepulse agrees with the card's by singlepulse.agreement
    (byte-equal files counted, every boundary line printed).  Then the
    stage's steps timed one by one on the survey's 24 series
    (sp_split), whose events must agree with the card's files."""
    from presto_tpu_torch.apps import single_pulse_search as sps
    from presto_tpu_torch.io.infodata import read_inf
    from presto_tpu_torch.io.datfft import read_dat
    from presto_tpu_torch.search import singlepulse as spm
    cfg = main_cfg()
    thr = cfg.sp_threshold
    spf = {dm_of(p[:-len(".singlepulse")]): p for p in glob.glob(
        os.path.join(workdir, "psr_DM*.singlepulse"))}
    events = {d: spm.read_singlepulse(p) for d, p in spf.items()}
    dms = sorted(events)
    counts = {"%.2f" % d: len(events[d]) for d in dms}
    ok = (len(dms) == len(res.datfiles) > 0
          and res.sp_events == sum(counts.values()))
    log("single pulse: events per DM %s (%d in all, res.sp_events %d); "
        "stage 9a %.3f s, stage 9 %.3f s"
        % (json.dumps(counts), sum(counts.values()), res.sp_events,
           *timer.samples["single_pulse"]))
    pulses = check_injected_pulses(
        events, BEAM_PULSES,
        [pulse_centres(raw, cfg, p) for p in BEAM_PULSES])
    ok = ok and all(p["ok"] for p in pulses)
    # the card's files against single_pulse_search on the CPU
    cpu = os.path.join(workdir, "cpu_sp")
    os.makedirs(cpu)
    for d in SP_CPU_DMS:
        for ext in (".dat", ".inf"):
            shutil.copy(os.path.join(workdir, "psr_DM%s%s" % (d, ext)), cpu)
    t0 = time.time()
    args = sps.build_parser().parse_args(
        ["-t", str(thr), "-p"] + [os.path.join(cpu, "psr_DM%s.dat" % d)
                                  for d in SP_CPU_DMS])
    sps.run(args, device="cpu")
    cpu_s = time.time() - t0
    agree = {}
    for d in SP_CPU_DMS:
        name = "psr_DM%s.singlepulse" % d
        agree[d] = spm.file_agreement(os.path.join(workdir, name),
                                      os.path.join(cpu, name), thr)
    same = sum(a["same_bytes"] for a in agree.values())
    cpu_ok = all(a["ok"] for a in agree.values())
    ok = ok and cpu_ok
    log("single pulse: card .singlepulse against single_pulse_search on the "
        "CPU (%.1f s) for DM %s: %d of %d byte-equal, agree %s; boundary "
        "lines %s; one-sided lines %s; bad %s"
        % (cpu_s, list(SP_CPU_DMS), same, len(agree), cpu_ok,
           json.dumps({d: a["boundary"] for d, a in agree.items()
                       if a["boundary"]}),
           json.dumps({d: a["one_sided"] for d, a in agree.items()
                       if a["one_sided"]}),
           json.dumps({d: a["bad"] for d, a in agree.items() if a["bad"]})))
    # the stage's steps at the main path's shape, on the card
    dat = [os.path.join(workdir, "psr_DM%.2f.dat" % d) for d in dms]
    infos = [read_inf(f[:-4]) for f in dat]
    nuse, offs = sps.sp_input_plan(infos[0], os.path.getsize(dat[0]) // 4)
    batch = torch.as_tensor(np.stack([read_dat(f)[:nuse] for f in dat]),
                            device="cuda")
    sp = spm.SinglePulseSearch(threshold=thr, device="cuda")
    split, out = sp_split(sp, batch, infos[0].dt, [i.dm for i in infos],
                          [offs] * len(dat))
    del batch
    split_ok = all(spm.agreement(events[d], r[0], thr,
                                 want_printed=True)["ok"]
                   for d, r in zip(dms, out))
    ok = ok and split_ok
    log("single pulse at the main path's shape (%d x %d, CUDA events): %s; "
        "agrees with the survey's files %s"
        % (len(dms), nuse, json.dumps(split, default=float), split_ok))
    return dict(ok=ok, events_per_dm=counts, pulses=pulses,
                stage_9a_s=timer.samples["single_pulse"][0],
                stage_9_s=timer.samples["single_pulse"][1],
                cpu_files_byte_equal=same, cpu_agree=cpu_ok, cpu_s=cpu_s,
                cpu_detail={d: {k: v for k, v in a.items()}
                            for d, a in agree.items()},
                split=split, split_agrees=split_ok)


# bench.py's single-pulse workload (make_sp_series, shared by the JAX
# package's device and CPU benches): 128 series of 2^20 samples at
# 81.92 us, rng seed 7, +4.0 over 30 samples at 12345 and 500000 in every
# 8th series; threshold 5
SP_BENCH = dict(nseries=128, nsamples=1 << 20, dt=8.192e-5, seed=7,
                threshold=5.0)
# the series also searched by the plain versions on the CPU: every 8th
# (pulsed) and its neighbour
SP_BENCH_CPU_ROWS = (0, 1, 32, 33, 64, 65, 96, 97)


def sp_bench_series():
    """bench.py's make_sp_series, copied (bench.py imports JAX)."""
    b = SP_BENCH
    rng = np.random.default_rng(b["seed"])
    series = [rng.normal(size=b["nsamples"]).astype(np.float32)
              for _ in range(b["nseries"])]
    for x in series[::8]:
        for pos in (12345, 500000):
            x[pos:pos + 30] += 4.0
    return np.stack(series)


def phase_singlepulse():
    """The JAX package's single-pulse bench shape on the card:
    search_many_resident over the 128 device-resident series (one
    upload), the warm call and the best of 2 (host clock and CUDA
    events), the best of 2 of its steps (sp_split), and the plain
    versions on the CPU over SP_BENCH_CPU_ROWS, held to the card's
    events by singlepulse.agreement."""
    from presto_tpu_torch.search import singlepulse as spm
    b = SP_BENCH
    t0 = time.time()
    series = sp_bench_series()
    gen_s = time.time() - t0
    batch = torch.as_tensor(series, device="cuda")
    dms = [float(i) for i in range(b["nseries"])]
    sp = spm.SinglePulseSearch(threshold=b["threshold"], device="cuda")
    runs = []
    for _ in range(3):
        e = [cuda_event() for _ in range(2)]
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        e[0].record()
        res = sp.search_many_resident(batch, b["dt"], dms)
        e[1].record()
        torch.cuda.synchronize()
        runs.append(dict(host_s=time.perf_counter() - h0,
                         event_ms=e[0].elapsed_time(e[1])))
    splits = [sp_split(sp, batch, b["dt"], dms)[0] for _ in range(2)]
    split = min(splits, key=lambda x: sum(x["ms"].values()))
    del batch
    nev = sum(len(c) for (c, _s, _b) in res)
    t0 = time.time()
    rows = list(SP_BENCH_CPU_ROWS)
    cpu = spm.SinglePulseSearch(threshold=b["threshold"], device="cpu") \
        .search_many_resident(series[rows], b["dt"], [dms[r] for r in rows])
    cpu_s = time.time() - t0
    agree = [spm.agreement(c[0], res[r][0], b["threshold"])
             for r, c in zip(rows, cpu)]
    cpu_ok = all(a["ok"] for a in agree)
    pulsed = [len(res[r][0]) for r in rows]
    found = all(any(abs(c.bin - (p + 15)) <= 16 for c in res[r][0])
                for r in rows[::2] for p in (12345, 500000))
    best = min(runs[1:], key=lambda r: r["event_ms"])
    log("singlepulse bench shape (%d x %d, threshold %g): warm %.3f s "
        "(%.3f event ms), best of 2 %.3f s (%.3f event ms); split (ms, "
        "best of 2) %s; %d events; generate %.1f s"
        % (b["nseries"], b["nsamples"], b["threshold"], runs[0]["host_s"],
           runs[0]["event_ms"], best["host_s"], best["event_ms"],
           json.dumps(split, default=float), nev, gen_s))
    # a block that holds a whole 30-sample pulse of 4 sigma a sample has a
    # robust std some 8% high, and the bad-block cut (the reference's
    # rule, the JAX package's too) zaps it: the bench's events are noise
    log("singlepulse bench shape on the CPU (rows %s, %.1f s): events %s; "
        "agree with the card %s; boundary %s; one-sided %s; the injected "
        "pulses found (zapped with their blocks) %s"
        % (rows, cpu_s, pulsed, cpu_ok,
           json.dumps([a["boundary"] for a in agree if a["boundary"]]),
           json.dumps([a["one_sided"] for a in agree if a["one_sided"]]),
           found))
    return dict(ok=cpu_ok and nev > 0 and split["overflow_files"] == 0,
                warm=runs[0], best=best, runs=runs, split=split,
                events=nev, cpu_rows=rows, cpu_events=pulsed,
                cpu_agree=cpu_ok, cpu_s=cpu_s, pulses_found=found,
                generate_s=gen_s)


def method_argv(raw, cfg, outbase):
    """prepsubband's argv for the survey's (single) DDplan method."""
    from presto_tpu_torch.apps.common import open_raw
    from presto_tpu_torch.pipeline.ddplan import (Observation,
                                                  plan_dedispersion)
    fb = open_raw([raw])
    hdr = fb.header
    fb.close()
    plan = plan_dedispersion(Observation(
        dt=hdr.tsamp, f_ctr=hdr.lofreq + 0.5 * (hdr.nchans - 1)
        * abs(hdr.foff), bw=hdr.nchans * abs(hdr.foff),
        numchan=hdr.nchans), cfg.lodm, cfg.hidm, numsub=cfg.nsub)
    if len(plan.methods) != 1:
        raise RuntimeError("the main path's DDplan has %d methods"
                           % len(plan.methods))
    m = plan.methods[0]
    return ["-lodm", str(m.lodm), "-dmstep", str(m.ddm), "-numdms",
            str(m.numdms), "-nsub", str(cfg.nsub), "-downsamp",
            str(m.downsamp), "-o", outbase, "-nobary"]


class Steps:
    """Host seconds per ingest step, one sample a block."""

    def __init__(self):
        self.samples = {}
        self._t = time.perf_counter()

    def lap(self, name, sync=False):
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.samples.setdefault(name, []).append(t - self._t)
        self._t = t

    def summary(self):
        return {k: dict(mean_ms=1e3 * float(np.mean(v)),
                        max_ms=1e3 * float(np.max(v)),
                        sum_s=float(np.sum(v))) for k, v in
                self.samples.items()}


def split_before(raw, blocklen, nblocks):
    """The ingest as it was before this design, one block at a time with
    every step timed: a plain read, the NumPy decode, the clip into a
    copy, the host transpose and a pageable copy to the card."""
    from presto_tpu_torch.io import sigproc
    from presto_tpu_torch.ops.clipping import clip_times
    fb = sigproc.FilterbankFile(raw)
    hdr = fb.header
    bps = hdr.bytes_per_spectrum
    state = None
    st = Steps()
    for k in range(nblocks):
        nread = k * blocklen
        if nread < hdr.N:
            n = min(blocklen, hdr.N - nread)
            fb.f.seek(hdr.headerlen + nread * bps)
            rawb = np.frombuffer(fb.f.read(n * bps), np.uint8)
            st.lap("read")
            block = sigproc.decode_spectra_numpy(hdr, rawb, n)
            if n < blocklen:
                block = np.concatenate([block, np.zeros(
                    (blocklen - n, hdr.nchans), np.float32)])
            st.lap("decode")
            block, _, state = clip_times(block, 6.0, state)
            st.lap("clip")
        else:
            block = np.zeros((blocklen, hdr.nchans), np.float32)
            st._t = time.perf_counter()
        blockT = np.ascontiguousarray(block.T)
        st.lap("transpose")
        torch.from_numpy(blockT).to("cuda")
        st.lap("h2d", sync=True)
    fb.close()
    return st.summary()


def split_after(raw, blocklen, nblocks, prep):
    """This design's ingest, one block at a time with every step timed:
    the prefetching feeder's read, the native decode into a pinned
    buffer, the quality scrub, the mask substitution and the clip in
    place, the asynchronous upload, the transpose on the card."""
    from presto_tpu_torch.io import native, sigproc
    from presto_tpu_torch.ops.clipping import clip_times, mask_block
    fb = sigproc.FilterbankFile(raw)
    hdr = fb.header
    bps = hdr.bytes_per_spectrum
    pin = torch.empty((blocklen, hdr.nchans), dtype=torch.float32,
                      pin_memory=True)
    buf = pin.numpy()
    state = None
    st = Steps()
    with native.BlockFeeder(raw, hdr.headerlen, blocklen * bps) as feeder:
        it = iter(feeder)
        st._t = time.perf_counter()
        for k in range(nblocks):
            nread = k * blocklen
            if nread < hdr.N:
                rawb = next(it)
                st.lap("read")
                n = min(len(rawb) // bps, hdr.N - nread)
                sigproc.decode_spectra_block(hdr, rawb[:n * bps], n, out=buf)
                buf[n:] = 0.0
                st.lap("decode")
                fb._scrub(buf[:n], nread, n)
                st.lap("scrub")
                nm, chans = prep.mask.check_mask(nread * prep.dt,
                                                 blocklen * prep.dt)
                if nm == -1:
                    buf[:] = prep.padvals[None, :]
                elif nm > 0:
                    mask_block(buf, chans, prep.padvals, out=buf)
                st.lap("mask")
                _b, _n, state = clip_times(buf, 6.0, state, out=buf)
                st.lap("clip")
            else:
                buf[:] = 0.0
                st._t = time.perf_counter()
            tm = pin.to("cuda", non_blocking=True)
            st.lap("h2d", sync=True)
            tm.t().contiguous()
            st.lap("transpose", sync=True)
        stats = feeder.stats()
    fb.close()
    return st.summary(), stats


def head_after(raw, argv):
    """prepsubband.run into a non-durable seam, as the survey runs it:
    the seconds of the whole head, its seam handoff, pad_to_good_N
    inside it, and the feeder's overlap counts."""
    from presto_tpu_torch.apps import prepsubband
    from presto_tpu_torch.io import sigproc
    from presto_tpu_torch.pipeline import fusion
    times = {}
    saved = (prepsubband._seam_handoff, prepsubband.pad_to_good_N,
             sigproc.FilterbankFile.close)
    feeder = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def close(fb):
        feeder.update(fb.feeder_stats or {})
        return saved[2](fb)
    prepsubband._seam_handoff = timed("handoff_s", saved[0])
    prepsubband.pad_to_good_N = timed("pad_to_good_N_s", saved[1])
    sigproc.FilterbankFile.close = close
    try:
        seam = fusion.StageSeam(os.path.dirname(argv[argv.index("-o") + 1]),
                                durable=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepsubband.run(prepsubband.build_parser().parse_args(argv + [raw]),
                        device="cuda", seam=seam)
        torch.cuda.synchronize()
        times["head_s"] = time.perf_counter() - t0
    finally:
        (prepsubband._seam_handoff, prepsubband.pad_to_good_N,
         sigproc.FilterbankFile.close) = saved
    block = seam.blocks[0]
    n = block.series_host.shape
    dl = torch.empty(n, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dl.cpu()
    times["download_s"] = time.perf_counter() - t0
    times["loop_s"] = times["head_s"] - times["handoff_s"]
    times["feeder"] = feeder
    return times


def _median_of(runs):
    """Per key, the median over repeats (nested dicts key by key)."""
    out = {}
    for k, v in runs[0].items():
        if isinstance(v, dict):
            out[k] = _median_of([r[k] for r in runs])
        elif isinstance(v, (int, float)):
            out[k] = float(np.median([r[k] for r in runs]))
    return out


INGEST_REPEATS = 3
# the per-block splits read the first INGEST_BLOCKS blocks of the beam's
# 34 (32 of data, 2 flush): the design before this one spends ~0.6 s a
# block on the card's host, and the whole head's seconds come from
# head_after over every block
INGEST_BLOCKS = 8


def phase_ingest(raw, workdir, maskfile):
    """The survey head's host ingest on the card's host, in one process:
    per block (mean and max over the first INGEST_BLOCKS blocks) the
    read, decode, scrub, mask, clip, transpose and host->device steps,
    taken one block at a time, before and after this design; then the
    whole head (prepsubband.run's loop of 24 DMs and its seam handoff:
    the download, pad_to_good_N and the pad upload) with the worker
    thread's overlap, without and with the survey's mask, in turns.
    Medians of INGEST_REPEATS."""
    from presto_tpu_torch.apps import common
    os.makedirs(workdir)
    cfg = main_cfg()
    argv = method_argv(raw, cfg, os.path.join(workdir, "ing"))
    b = BEAM
    blocklen = 1 << 17
    nblocks = INGEST_BLOCKS
    ns = argparse.Namespace(mask=maskfile)
    split_b, split_a, heads = [], [], {"after": [], "after_mask": []}
    feeder = None
    for rep in range(INGEST_REPEATS):
        split_b.append(split_before(raw, blocklen, nblocks))
        sa, feeder = split_after(raw, blocklen, nblocks,
                                 common.block_prep(ns, b["nchan"], b["dt"]))
        split_a.append(sa)
        order = (("after", []), ("after_mask", ["-mask", maskfile]))
        for name, extra in (order if rep % 2 == 0 else order[::-1]):
            heads[name].append(head_after(raw, argv + extra))
            torch.cuda.empty_cache()
    # device times (CUDA events, 20 launches after a warm-up) of the
    # ingest's device steps: the pinned and a pageable upload of one
    # block, the transpose on the card, and one rfifind interval's
    # statistics (128 channels x 15625 samples)
    from presto_tpu_torch.search import rfifind as srfi
    pin = torch.empty((blocklen, b["nchan"]), dtype=torch.float32,
                      pin_memory=True)
    pageable = np.zeros((blocklen, b["nchan"]), np.float32)
    tm = torch.randn((blocklen, b["nchan"]), device="cuda")
    cells = torch.randn((b["nchan"], 15625), device="cuda")
    device_ms = dict(
        h2d_pinned=cuda_time_ms(lambda: pin.to("cuda", non_blocking=True),
                                20),
        h2d_pageable=cuda_time_ms(
            lambda: torch.from_numpy(pageable).to("cuda"), 20),
        transpose=cuda_time_ms(lambda: tm.t().contiguous(), 20),
        rfifind_interval_stats=cuda_time_ms(
            lambda: srfi._interval_stats(cells), 20))
    del pin, tm, cells
    log("ingest device ms (CUDA events): %s" % json.dumps(device_ms))
    res = dict(blocks=nblocks, blocklen=blocklen, device_ms=device_ms,
               repeats=INGEST_REPEATS,
               split_before=_median_of(split_b),
               split_after=_median_of(split_a),
               split_after_feeder=feeder,
               heads={k: _median_of(v) for k, v in heads.items()},
               head_samples={k: [round(r["head_s"], 4) for r in v]
                             for k, v in heads.items()})
    for name in ("split_before", "split_after"):
        log("ingest %s (per block, ms, median of %d): %s"
            % (name, INGEST_REPEATS, json.dumps(
                {k: [round(v["mean_ms"], 3), round(v["max_ms"], 3)]
                 for k, v in res[name].items()})))
    log("ingest feeder (after): %s" % json.dumps(feeder))
    log("ingest heads (s, median of %d): %s; samples %s"
        % (INGEST_REPEATS, json.dumps({k: {kk: vv for kk, vv in v.items()
                                            if not isinstance(vv, dict)}
                                       for k, v in res["heads"].items()},
                                      default=float),
           json.dumps(res["head_samples"])))
    return res


class FoldClock:
    """Device spans of the fold's torch work while installed, grouped per
    prepfold run: the drizzles (ops/fold.fold_data, fold_data_batch),
    the trial searches (search/prepfold._trial_chi2, with their trial
    counts) and the subband realignments (combine_subbands).  CUDA
    events on the card (each call ends in a copy to the host, so a span
    is its device work and the gaps between its launches), the host
    clock on the CPU."""

    def __init__(self, device):
        self.device = device
        self.folds = []
        self._saved = []

    def _group(self):
        if not self.folds:
            self.folds.append({})
        return self.folds[-1]

    def _timed(self, name, fn, trials=None):
        def wrapper(*a, **k):
            if self.device == "cuda":
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = fn(*a, **k)
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1)
            else:
                t0 = time.perf_counter()
                out = fn(*a, **k)
                ms = (time.perf_counter() - t0) * 1e3
            g = self._group()
            g[name + "_ms"] = g.get(name + "_ms", 0.0) + ms
            if trials is not None:
                g["trials"] = g.get("trials", 0) + trials(*a)
            return out
        return wrapper

    def __enter__(self):
        from presto_tpu_torch.apps import prepfold as app
        from presto_tpu_torch.ops import fold as fo
        from presto_tpu_torch.search import prepfold as spf
        from presto_tpu_torch.timing import toas

        def run(*a, **k):
            self.folds.append({})
            return orig_run(*a, **k)
        orig_run = app.run
        for mod, name, fn in (
                (app, "run", run),
                (fo, "fold_data", self._timed("drizzle", fo.fold_data)),
                (fo, "fold_data_batch",
                 self._timed("drizzle", fo.fold_data_batch)),
                (spf, "_trial_chi2",
                 self._timed("search", spf._trial_chi2,
                             lambda p, t, *r: len(t))),
                (fo, "combine_subbands",
                 self._timed("combine_subbands", fo.combine_subbands)),
                (toas, "combine_subbands",
                 self._timed("combine_subbands", toas.combine_subbands))):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


# the first fold's reduced chi2 must exceed this (a pulsar at sigma ~ 30
# folds to thousands; noise to ~1)
FOLD_REDCHI_MIN = 100.0


def check_main_folds(res, workdir, clock, T):
    """The main path's folds: three fold_candN.pfd + .bestprof; the first
    at the injected pulsar (f0 within 0.01 Hz and fdot within 1e-5 Hz/s
    of a harmonic's, reduced chi2 above FOLD_REDCHI_MIN); each fold's
    drizzle and search device ms; and each candidate refolded from its
    .dat and .cand on the CPU (plain versions), whose .pfd bytes must
    equal the card's: the drizzle adds in the JAX package's order."""
    from presto_tpu_torch.apps import prepfold as app
    from presto_tpu_torch.io.bestprof import read_bestprof
    from presto_tpu_torch.io.pfd import read_pfd
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.pipeline.sifting import select_fold_candidates
    b = BEAM
    per_fold = [{k: round(v, 3) if isinstance(v, float) else v
                 for k, v in g.items()} for g in clock.folds]
    log("main: per fold on the card (CUDA-event ms): %s" % json.dumps(
        per_fold))
    files_ok = len(res.folded) == 3 and all(
        os.path.exists(q) and os.path.exists(q + ".bestprof")
        for q in res.folded)
    if not files_ok:
        log("main: folds %s FAIL" % res.folded)
        return dict(ok=False, folded=len(res.folded), per_fold=per_fold)
    p1 = read_pfd(res.folded[0])
    bp = read_bestprof(res.folded[0] + ".bestprof")
    h = max(1, round(p1.fold_p1 / b["f0"]))
    pulsar_ok = (abs(p1.fold_p1 / h - b["f0"]) < 0.01
                 and abs(p1.fold_p2 / h - b["fdot"]) < 1e-5
                 and bp.chi_sqr > FOLD_REDCHI_MIN)
    top = select_fold_candidates(res.sifted, fold_top=3)
    same, cpu_s = [], []
    for i, c in enumerate(top):
        argv, _dat, outbase = survey.fold_argv(c, i + 1, workdir)
        card = open(outbase + ".pfd", "rb").read()
        for ext in (".pfd", ".pfd.bestprof"):
            os.replace(outbase + ext, outbase + ".card" + ext)
        t0 = time.time()
        app.main(argv, device="cpu")
        cpu_s.append(time.time() - t0)
        same.append(open(outbase + ".pfd", "rb").read() == card)
    ok = pulsar_ok and all(same) and len(per_fold) == 3
    log("main: folds %s; fold_cand1 f %.9f Hz fdot %.4g Hz/s (harmonic %d "
        "of %.2f Hz, %.2g Hz/s), reduced chi2 %.1f (threshold %.0f) %s"
        % ([os.path.basename(q) for q in res.folded], p1.fold_p1,
           p1.fold_p2, h, b["f0"], b["fdot"], bp.chi_sqr, FOLD_REDCHI_MIN,
           "ok" if pulsar_ok else "FAIL"))
    log("main: CPU refolds %s s; .pfd bytes equal to the card's %s %s"
        % ([round(x, 2) for x in cpu_s], same, "ok" if all(same)
           else "FAIL"))
    return dict(ok=ok, folded=len(res.folded), fold1_f=p1.fold_p1,
                fold1_fdot=p1.fold_p2, fold1_redchi=bp.chi_sqr,
                redchi_threshold=FOLD_REDCHI_MIN, per_fold=per_fold,
                cpu_refold_s=cpu_s, pfd_equal_cpu=same)


# chi2 surfaces, card against CPU: within this share of the surface's
# maximum (float32 sums of ~5e8 per profile bin in two orders)
CHI2_ATOL = 1e-3


def _argmax_agree(card, cpu, what, atol):
    """The card's and the CPU's best index are equal, or the CPU surface
    at the card's best is within atol of its own best (a near-tie,
    logged).  Returns (ok, note)."""
    ic, iu = int(np.argmax(card)), int(np.argmax(cpu))
    if ic == iu:
        return True, "equal"
    gap = float(cpu.flat[iu] - cpu.flat[ic])
    note = ("near-tie: card %d, CPU %d, CPU chi2 gap %.4g <= %.4g"
            % (ic, iu, gap, atol))
    log("fold: %s best index %s" % (what, note))
    return gap <= atol, note


def phase_fold(raw, workdir, top, device="cuda"):
    """prepfold on the filterbank at the top sifted candidate
    (-accelfile -accelcand -dm, the default DM, p and pd search) on
    ``device``: the best DM within two grid steps of the injected; the
    same pre-search cube searched again on the CPU, chi2 surfaces within
    CHI2_ATOL of their maximum and the same best (DM, f, fd) indices
    unless a near-tie is logged."""
    from presto_tpu_torch.apps import prepfold as app
    from presto_tpu_torch.search import prepfold as spf
    acc = os.path.join(top.path or workdir, top.filename)
    out = os.path.join(workdir, "fold_fil")
    argv = ["-accelfile", acc + ".cand", "-accelcand", str(top.candnum),
            "-dm", "%.2f" % top.DM, "-noplot", "-o", out, raw]
    captured = {}
    orig = app.search_fold

    def capture(res, cfg, dev):
        captured.update(res=copy.deepcopy(res), cfg=cfg)
        return orig(res, cfg, dev)
    app.search_fold = capture
    try:
        with FoldClock(device) as clock:
            t0 = time.time()
            res = app.run(app.build_parser().parse_args(argv),
                          device=device)
            card_s = time.time() - t0
    finally:
        app.search_fold = orig
    pre, cfg = captured["res"], captured["cfg"]
    step = cfg.dmstep * spf.dm_per_bin(pre.fold_f, pre.proflen,
                                       pre.subfreqs.min(),
                                       pre.subfreqs.max())
    dm_ok = abs(res.best_dm - BEAM["dm"]) <= 2 * step
    t0 = time.time()
    cpu = spf.search_fold(copy.deepcopy(pre), cfg, device="cpu")
    cpu_s = time.time() - t0
    ok = dm_ok
    errs, notes = {}, {}
    for what in ("dm_chi2", "ppd_chi2"):
        a, c = np.asarray(getattr(res, what)), np.asarray(getattr(cpu,
                                                                  what))
        atol = CHI2_ATOL * float(np.abs(c).max())
        errs[what] = float(np.abs(a - c).max()) / float(np.abs(c).max())
        agree, notes[what] = _argmax_agree(a, c, what, atol)
        ok = ok and a.shape == c.shape and errs[what] <= CHI2_ATOL \
            and agree
    g = clock.folds[-1]
    log("fold: %s at DM %.2f (cand %d, f %.6f Hz): %d subbands x %d "
        "samples, %d parts x %d bins; search %d DMs x %d x %d (f, fd) = "
        "%d trials" % (os.path.basename(raw), top.DM, top.candnum,
                       pre.fold_f, pre.nsub, int(pre.T / pre.dt + 0.5),
                       pre.npart, pre.proflen, len(res.dms),
                       res.ppd_chi2.shape[0], res.ppd_chi2.shape[1],
                       g.get("trials", 0)))
    log("fold: best DM %.4f (injected %.2f, grid step %.4f, within 2 "
        "steps: %s); best f %.9f Hz, fd %.4g Hz/s, reduced chi2 %.1f"
        % (res.best_dm, BEAM["dm"], step, dm_ok, res.best_f, res.best_fd,
           res.best_redchi))
    log("fold: card %.2f s (host clock, with the .fil read and "
        "dedispersion); device ms: drizzle %.3f, trial search %.3f, "
        "combine_subbands %.3f; CPU search of the same cube %.2f s; "
        "chi2 surfaces card vs CPU max |diff| / max %s (tolerance %g), "
        "best indices %s %s"
        % (card_s, g.get("drizzle_ms", 0.0), g.get("search_ms", 0.0),
           g.get("combine_subbands_ms", 0.0), cpu_s,
           json.dumps({k: float("%.3g" % v) for k, v in errs.items()}),
           CHI2_ATOL, json.dumps(notes), "ok" if ok else "FAIL"))
    return dict(ok=ok, pfd=out + ".pfd", best_dm=res.best_dm, dm_step=step,
                best_f=res.best_f, best_fd=res.best_fd,
                redchi=res.best_redchi, trials=g.get("trials", 0),
                numdms=len(res.dms), card_s=card_s, cpu_search_s=cpu_s,
                drizzle_ms=g.get("drizzle_ms"), search_ms=g.get("search_ms"),
                combine_subbands_ms=g.get("combine_subbands_ms"),
                chi2_rel_err=errs, best_index=notes,
                tolerance="chi2 within %g of the surface max" % CHI2_ATOL)


# TOA residuals against the injected model must lie within this many
# of their own error bars
TOA_SIGMAS = 5.0


def phase_toas(pfd, best_dm, workdir, device="cuda"):
    """get_TOAs -n 8 -d <best DM> on the fold of phase_fold, on
    ``device`` (combine_subbands there) and on the CPU: 8 TOAs with
    finite positive errors; their phases under the injected (f0, fdot),
    less their error-weighted circular mean, within TOA_SIGMAS of their
    errors; the CPU's .tim lines equal the card's, or each TOA within
    0.01 of its error bar and each error within rtol 1e-3."""
    from presto_tpu_torch.apps import get_toas
    b = BEAM
    argv = ["-n", "8", "-d", "%.6f" % best_dm, pfd]
    lines = {}
    with FoldClock(device) as clock:
        t0 = time.time()
        rc = get_toas.main(argv + ["-o", os.path.join(workdir, "card.tim")],
                           device=device)
        card_s = time.time() - t0
    rc = rc or get_toas.main(argv + ["-o", os.path.join(workdir,
                                                         "cpu.tim")],
                             device="cpu")
    if rc:
        raise RuntimeError("get_TOAs exited %d" % rc)
    for side in ("card", "cpu"):
        with open(os.path.join(workdir, side + ".tim")) as f:
            lines[side] = f.read().splitlines()

    def parse(line):
        mjd = line[24:44]
        day, frac = mjd.split(".")
        return int(day), float("0." + frac), float(line.split()[-1])
    toas = [parse(x) for x in lines["card"]]
    cpu = [parse(x) for x in lines["cpu"]]
    t = np.array([((d - 59000) + fr) * 86400.0 for d, fr, _e in toas])
    err = np.array([e for _d, _f, e in toas]) * 1e-6
    ph = b["f0"] * t + 0.5 * b["fdot"] * t * t
    w = 1.0 / np.maximum(err, 1e-12) ** 2
    c = np.angle(np.sum(w * np.exp(2j * np.pi * ph))) / (2 * np.pi)
    resid = ((ph - c + 0.5) % 1.0 - 0.5) / b["f0"]
    ok = (len(toas) == 8 and bool(np.all(np.isfinite(err)))
          and bool(np.all(err > 0))
          and bool(np.all(np.abs(resid) <= TOA_SIGMAS * err)))
    same = lines["card"] == lines["cpu"]
    dt_sig = [abs(a[1] - b_[1]) * 86400.0 / max(a[2] * 1e-6, 1e-12)
              for a, b_ in zip(toas, cpu)]
    close = len(cpu) == len(toas) and all(
        a[0] == b_[0] and d <= 0.01 and abs(a[2] - b_[2]) <= 1e-3 * a[2]
        for a, b_, d in zip(toas, cpu, dt_sig))
    ok = ok and (same or close)
    g = clock.folds[-1] if clock.folds else {}
    log("toas: %d TOAs at %.3f MHz, errors %s us; residuals against the "
        "injected (f0, fdot) %s us (limit %g sigma) %s"
        % (len(toas), float(lines["card"][0][16:24]) if toas else 0.0,
           [round(float(e) * 1e6, 3) for e in err],
           [round(float(r) * 1e6, 3) for r in resid], TOA_SIGMAS,
           "ok" if ok else "FAIL"))
    log("toas: mean (residual / error)^2 %.4g" % float(np.mean(
        (resid / err) ** 2)))
    log("toas: card %.2f s (host clock), combine_subbands %.3f device ms; "
        ".tim lines equal to the CPU's: %s (worst TOA difference %.3g "
        "sigma)" % (card_s, g.get("combine_subbands_ms", 0.0), same,
                    max(dt_sig) if dt_sig else 0.0))
    return dict(ok=ok, ntoa=len(toas), err_us=[float(e) * 1e6 for e in err],
                resid_us=[float(r) * 1e6 for r in resid],
                resid_chi2=float(np.mean((resid / err) ** 2)), cpu_equal=same,
                worst_cpu_diff_sigma=max(dt_sig) if dt_sig else None,
                combine_subbands_ms=g.get("combine_subbands_ms"),
                card_s=card_s,
                tolerance="residuals within %g sigma; CPU equal or within "
                          "0.01 sigma" % TOA_SIGMAS)


def phase_small_reference(gen):
    """Small spectra searched on the card and by the plain versions on
    the CPU: 2^15 bins (zmax 20, the aligned plane geometry) and 3000
    bins (zmax 200, numharm 8, sigma 2: the non-aligned geometry of a
    short spectrum).  The strong candidates' keys agree, powers within
    1e-4."""
    from presto_tpu_torch.search import accel
    cases = (("2^15 bins", 1 << 16, 1e-3, 37.3, 0.002, 0.1,
              accel.AccelConfig(zmax=20, numharm=8, sigma=3.0)),
             ("3000 bins", 6000, 1e-3, 37.3, 0.4, 0.3,
              accel.AccelConfig(zmax=200, numharm=8, sigma=2.0)))
    out = {}
    for label, n, dt, f0, fd2, amp, cfg in cases:
        t = np.arange(n) * dt
        rng = np.random.default_rng(5)
        x = rng.normal(size=n) + amp * np.cos(2 * np.pi * (f0 * t
                                                           + fd2 * t * t))
        full = np.fft.rfft(x)
        packed = full[:-1].copy()
        packed[0] = full[0].real + 1j * full[-1].real
        pairs = np.stack([packed.real, packed.imag], -1).astype(np.float32)
        res = {}
        for dev in ("cuda", "cpu"):
            s = accel.AccelSearch(cfg, T=n * dt, numbins=n // 2, device=dev)
            res[dev] = s.search(pairs)
        key = lambda c: (c.numharm, round(2 * c.r), round(2 * c.z))  # noqa
        strong = {key(c): c.power for c in res["cpu"]
                  if c.power > 1.01 * s.powcut[int(np.log2(c.numharm))]}
        got = {key(c): c.power for c in res["cuda"]}
        ok = bool(strong) and all(
            k in got and abs(got[k] - p) <= 1e-4 * p
            for k, p in strong.items())
        geom = dict(uselen=s.cfg.uselen, fftlen=s.kern.fftlen,
                    halfwidth=s.kern.halfwidth, hw_eff=s.hw_eff,
                    aligned=s.aligned, plane=list(s.plane_geom()))
        log("small reference %s: geometry %s; %d strong CPU candidates, "
            "card list %d, agree %s" % (label, json.dumps(geom),
                                        len(strong), len(got), ok))
        out[label] = dict(ok=ok, geometry=geom, strong=len(strong),
                          card=len(got))
    return out


# The JAX package's jerk bench shape (bench.py:548-576, bench_jerk):
# 2^20 bins of seeded noise with a tone at bin 123456, zmax 100, wmax 300
# (31 w planes), numharm 4, sigma 6, T = 1000 s (bench.py's ACCEL_T).
JERK_BENCH = dict(numbins=1 << 20, zmax=100, wmax=300, numharm=4, sigma=6.0,
                  T=1000.0, seed=11, tone_bin=123456, tone=200.0)
# A jerk pulsar: tests/test_e2e_accel.py:162-196's shape (f0 7.37 Hz, z 10
# and w 60 bins at the start, a Gaussian pulse of width 0.1, unit noise,
# seed 17) at 2^21 samples of 1 ms; searched at that test's zmax 60, wmax
# 80, numharm 2 on the card and on the CPU.
JERK_PSR = dict(N=1 << 21, dt=1e-3, f0=7.37, z=10.0, w=60.0, amp=0.15,
                width=0.1, seed=17,
                argv=["-zmax", "60", "-wmax", "80", "-numharm", "2",
                      "-sigma", "5.0"])


def reducer_planes_bound(planes, scols, zinds, slab, nst):
    """The multi-plane reducer's bound on these inputs: each distinct
    plane read once over the cells the sums name (planes[0]: every row
    of the slabs' columns; term i's plane: the rows of its z map at
    the columns round_half_up(j h / htot)), the start columns and z maps
    once, colmax and colz written once; one add a term and one compare
    a stage per plane element of the slabs.  Returns (ms, "bytes" or
    "operations", bytes)."""
    from presto_tpu_torch.search import accel_cuda
    nrows, numr = planes[0].shape
    sc = scols.cpu().numpy().astype(np.int64)
    cols = np.unique((sc[:, None] + np.arange(slab)[None]).ravel())
    z = zinds.cpu().numpy()
    # per distinct plane: [(rows named, columns named)] of its reads
    reads = {planes[0].data_ptr(): [(np.ones(nrows, bool), cols)]}
    for i, (h, t) in enumerate(accel_cuda.stage_terms(nst)):
        rows = np.zeros(nrows, bool)
        rows[z[i]] = True
        reads.setdefault(planes[i + 1].data_ptr(), []).append(
            (rows, (cols // t) * h + ((cols % t) * h + (t >> 1)) // t))
    cells = 0
    for rl in reads.values():
        # rows grouped by which reads name them: the union of those
        # reads' columns, once a group
        sig = sum(r.astype(np.int64) << k for k, (r, _c) in enumerate(rl))
        for g in np.unique(sig[sig > 0]):
            named = np.zeros(numr, bool)
            for k, (_r, c) in enumerate(rl):
                if g >> k & 1:
                    named[c] = True
            cells += int(named.sum()) * int((sig == g).sum())
    nbytes = (cells + scols.numel() + zinds.numel()) * 4 \
        + 2 * scols.numel() * nst * slab * 4
    nterms = (1 << (nst - 1)) - 1
    ms, by = bound_ms(nbytes, sc.size * slab * nrows * (nterms + nst))
    return ms, by, nbytes


def jerk_kernels(s, nbins, gen, w, label, pairs=None):
    """The two kernels at one jerk searcher's geometry against their
    plain versions: plane_build on the bank of grid plane ``w`` (from a
    random spectrum, or from ``pairs``), and stage_reduce_planes,
    bit-equal, on the distinct planes the scan at ``w`` reads (w and its
    subharmonic w), built from the same spectrum on the card."""
    from presto_tpu_torch.search import accel, accel_cuda
    pb, S = plane_case(s, nbins, gen, "%s (w = %g bank)" % (label, w),
                       Kc=s._w_bank_dev(w), pairs=pairs)
    fracs = [h / t for st in s.fracs_zinds for (h, t, _z) in st]
    ws = [float(w)] + [float(accel.calc_required_w(f, w)) for f in fracs]
    built = {x: s.build_plane(None, s._w_bank_dev(x), spectra=S)
             for x in dict.fromkeys(ws)}
    planes = [built[x] for x in ws]
    del S, built
    geom = s.plane_geom()
    slab, _k, start_cols = s.slab_plan(geom[2])
    scols = torch.tensor(start_cols, dtype=torch.int32, device="cuda")
    nst = s.cfg.numharmstages
    args = (planes, scols, s._zinds, slab, nst)
    gm, gz = accel_cuda.reduce_stages_planes(*args)
    wm, wz = accel_cuda.reduce_stages_planes_plain(*args)
    torch.cuda.synchronize()
    err = float((gm - wm).abs().max())
    ok = (err == 0.0 and bool(torch.equal(gm.view(torch.int32),
                                          wm.view(torch.int32)))
          and bool(torch.equal(gz, wz)))
    del gm, gz, wm, wz
    ms = cuda_time_ms(lambda: accel_cuda.reduce_stages_planes(*args), 10)
    plain_ms = cuda_time_ms(
        lambda: accel_cuda.reduce_stages_planes_plain(*args), 1)
    bms, by, nbytes = reducer_planes_bound(planes, scols, s._zinds, slab, nst)
    design = reducer_design_bytes(s._zinds, planes[0].shape[0], slab,
                                  len(start_cols), nst)
    share = design / (ms * 1e-3) / PEAK_BYTES_PER_S
    log("stage_reduce_planes %s (w %s; planes %s, %d slabs of %d, %d "
        "stages): max_abs_err %.3g, bit-equal %s; kernel %.3f ms, plain "
        "%.3f ms, bound %.3f ms (%s, %.3f GB), design bytes %.3f GB (%.1f%% "
        "of 3.35 TB/s) %s"
        % (label, ws, tuple(planes[0].shape), len(start_cols), slab, nst,
           err, ok, ms, plain_ms, bms, by, nbytes / 1e9, design / 1e9,
           100 * share, "ok" if ok else "FAIL"))
    del planes
    torch.cuda.empty_cache()
    return pb, dict(ok=ok, ws=ws, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=bms, bound_by=by,
                    bound_bytes=nbytes, design_bytes=design,
                    design_share=share,
                    tolerance="exact (same float32 add order)")


def jerk_pulsar(workdir):
    """JERK_PSR's time series (the port's models/synth), its packed .fft,
    and accelsearch -wmax on it on the card and on the CPU: the injected
    (f, z, w) on top of the card's list (at the mean frequency and fdot
    of the observation, w within one ACCEL_DW step), and the two _JERK_
    tables held by accel_agreement.jerk_file_agreement.  Then the two
    kernels at this path's geometry (numz 61, numharm 2: the reducer's
    2-stage multi-plane instantiation) on this spectrum, against their
    plain versions (jerk_kernels, the scan at w = wmax)."""
    from presto_tpu_torch.apps import accel_agreement, accelsearch
    from presto_tpu_torch.io import datfft
    from presto_tpu_torch.io.infodata import InfoData
    from presto_tpu_torch.models import synth
    from presto_tpu_torch.ops import fftpack
    from presto_tpu_torch.search import accel, accel_cuda, build_cuda
    p = JERK_PSR
    T = p["N"] * p["dt"]
    sig = synth.FakeSignal(f=p["f0"], fdot=p["z"] / T ** 2,
                           fdotdot=p["w"] / T ** 3, amp=p["amp"],
                           shape="gauss", width=p["width"])
    data = synth.fake_timeseries(p["N"], p["dt"], sig, noise_sigma=1.0,
                                 seed=p["seed"])
    packed = fftpack.realfft_packed(torch.from_numpy(data - data.mean())
                                    ).numpy()
    runs = []
    for k, dev in enumerate(("cuda", "cpu")):
        d = os.path.join(workdir, "%d_%s" % (k, dev))
        os.makedirs(d)
        datfft.write_fft(os.path.join(d, "jerk.fft"), packed,
                         InfoData(N=float(p["N"]), dt=p["dt"], object="jerk"))
        args = accelsearch.build_parser().parse_args(
            p["argv"] + [os.path.join(d, "jerk.fft")])
        build_cuda.launches = accel_cuda.launches = 0
        accel_cuda.planes_launches = 0
        t0 = time.time()
        trace = accelsearch.run(args, device=dev)
        runs.append(dict(
            trace=trace, s=time.time() - t0,
            base=os.path.join(d, "jerk_ACCEL_%d_JERK_%d"
                              % (args.zmax, args.wmax)),
            launches=dict(plane_build=build_cuda.launches,
                          stage_reduce=accel_cuda.launches,
                          stage_reduce_planes=accel_cuda.planes_launches)))
    card, ref = runs
    pairs = fftpack.np_complex64_to_pairs(packed)
    rep = accel_agreement.jerk_file_agreement(
        pairs, ref["base"], card["base"], ref["trace"], card["trace"])
    jreps = rep.get("jerk", {}).get("reports", [])
    for f in rep.get("z", {}).get("flags", []) + [
            f for r in jreps for f in r["flags"]]:
        log("jerk pulsar: a polish move past the rule (%s): %s"
            % ("tie path" if f.get("tie_path") else "unexplained",
               json.dumps(f, default=float)))
    r_mean = p["f0"] * T + p["z"] / 2 + p["w"] / 6
    z_mean = p["z"] + p["w"] / 2
    final = card["trace"].final
    top = final[0] if final else None
    h = max(1, round(top.r / r_mean)) if top else 0
    found = bool(top and abs(top.r - h * r_mean) < 0.5 * h
                 and abs(top.z - h * z_mean) < 2.0 * h
                 and abs(top.w - h * p["w"]) <= accel.ACCEL_DW * h)
    ok = (found and rep["ok"]
          and card["launches"]["stage_reduce_planes"] > 0)
    res = dict(ok=ok, T=T, injected=dict(r=r_mean, z=z_mean, w=p["w"]),
               top=dict(r=top.r, z=top.z, w=top.w, sigma=top.sigma,
                        numharm=top.numharm, harmonic=h) if top else None,
               found=found, cands=len(final),
               seeds=len(card["trace"].cands),
               jerk_taken=sum(card["trace"].jerk_taken),
               same=rep["same"], boundary=rep["boundary"],
               explained=rep["explained"], unexplained=rep["unexplained"],
               z_moved=rep.get("z", {}).get("moved"),
               jerk_moved=[r["moved"] for r in jreps],
               jerk_repolished=rep.get("jerk", {}).get("repolished"),
               jerk_worst=[r["worst"] for r in jreps],
               tie_paths=(rep.get("z", {}).get("tie_paths", 0)
                          + sum(r["tie_paths"] for r in jreps)),
               card_s=card["s"], cpu_s=ref["s"],
               launches=dict(cuda=card["launches"], cpu=ref["launches"]))
    log("jerk pulsar (%s; T %.1f s): injected r %.3f z %.2f w %.1f; card "
        "top %s (harmonic %d) found %s; %d candidates, %d took the jerk "
        "polish; card vs CPU: %d same-point lines (%d on a rounding "
        "boundary), %d moved and explained, unexplained %s; card %.2f s, "
        "CPU %.2f s; launches %s %s"
        % (" ".join(p["argv"]), T, r_mean, z_mean, p["w"],
           json.dumps(res["top"], default=float), h, found, res["cands"],
           res["jerk_taken"], rep["same"], rep["boundary"],
           rep["explained"], rep["unexplained"], card["s"], ref["s"],
           json.dumps(res["launches"]), "ok" if ok else "FAIL"))
    args = accelsearch.build_parser().parse_args(p["argv"] + ["x.fft"])
    s = accel.AccelSearch(accel.AccelConfig(
        zmax=args.zmax, wmax=args.wmax, numharm=args.numharm,
        sigma=args.sigma, flo=args.flo), T=T, numbins=len(pairs),
        device="cuda")
    res["plane_build"], res["stage_reduce_planes"] = jerk_kernels(
        s, len(pairs), None, float(args.wmax), "jerk pulsar (zmax 60, "
        "wmax 80, numharm 2)", pairs=torch.as_tensor(pairs, device="cuda"))
    res["ok"] = (ok and res["plane_build"]["ok"]
                 and res["stage_reduce_planes"]["ok"])
    del s
    torch.cuda.empty_cache()
    return res


def jerk_polish(pairs, raw, s):
    """The bench search's deduplicated candidates polished on the card and
    on the CPU from the same seeds: the (r, z) polish, then the jerk
    polish from the CPU's (r, z) results with each candidate's search w,
    each pair of lists held by polish.agreement (jerk=True for the
    second); and the jerk evaluators, card against CPU, at each CPU
    point and its 3 x 3 x 3 final-step stencil.  Fails on an unexplained
    move, or when the evaluators differ by more than
    polish.JERK_EVAL_RTOL, the rule's premise."""
    from presto_tpu_torch.search import accel, polish
    cands = accel.remove_duplicates(accel.eliminate_harmonics(raw))
    host = pairs.cpu()
    out = dict(cands=len(cands))
    z = {d: polish.optimize_accelcands(p, cands, s.T, s.numindep,
                                       with_props=False, device=d)
         for d, p in (("cuda", pairs), ("cpu", host))}
    zrep = polish.agreement(host, z["cpu"], z["cuda"], seeds=cands)
    seeds = [accel.AccelCand(power=o.power, sigma=o.sigma, numharm=o.numharm,
                             r=o.r, z=o.z, w=c.w)
             for c, o in zip(cands, z["cpu"])]
    t = {}
    j = {}
    for d, p in (("cuda", pairs), ("cpu", host)):
        polish.optimize_jerk_cands(p, seeds[:1], s.T, s.numindep, device=d)
        if d == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        j[d] = polish.optimize_jerk_cands(p, seeds, s.T, s.numindep,
                                          device=d)
        t[d] = time.time() - t0
    jrep = polish.agreement(host, j["cpu"], j["cuda"], seeds=seeds,
                            jerk=True, numindep=s.numindep)
    W, npts = polish.batch_geometry(seeds, True)
    rel = {"objective": 0.0, "final": 0.0}
    for sd, c in zip(seeds, j["cpu"]):
        h = [x[0] for x in polish.final_steps([c.numharm])] + [
            polish.final_step_w([c.numharm])[0]]
        pts = np.array([(c.r + u * h[0], c.z + v * h[1], c.w + x * h[2])
                        for u in (-1, 0, 1) for v in (-1, 0, 1)
                        for x in (-1, 0, 1)])
        card_m, cpu_m = (polish.SeedWindows(p, sd, W, npts, True)
                         .measures(pts) for p in (pairs, host))
        for k, name in enumerate(rel):
            rel[name] = max(rel[name], float(np.max(
                np.abs(card_m[k] - cpu_m[k]) / np.abs(cpu_m[k]))))
    rel_ok = max(rel.values()) <= polish.JERK_EVAL_RTOL
    out["evaluator_rel"] = rel
    for name, rep in (("(r, z)", zrep), ("jerk", jrep)):
        for f in rep["flags"]:
            log("jerk bench polish: %s candidate %d breaks the agreement "
                "rule (%s): %s" % (name, f["i"], "tie path, open fault"
                                   if f.get("tie_path") else "unexplained",
                                   json.dumps(f, default=float)))
        out[name] = dict(moved=rep["moved"], tie_paths=rep["tie_paths"],
                         unexplained=rep["unexplained"], worst=rep["worst"])
    out.update(ok=(zrep["unexplained"] == 0 and jrep["unexplained"] == 0
                   and rel_ok),
               jerk_card_s=t["cuda"], jerk_cpu_s=t["cpu"],
               pairs=int(sum(c.numharm for c in cands)))
    log("jerk bench polish: %d candidates (%d pairs); (r, z) polish card "
        "vs CPU: %d moved, %d tie paths, %d unexplained; jerk polish "
        "(%.3f s card, %.2f s CPU): %d moved, %d tie paths, %d "
        "unexplained; worst %s; jerk evaluators card vs CPU at 27 points "
        "a candidate, largest relative difference %s (JERK_EVAL_RTOL "
        "%g: %s) %s"
        % (len(cands), out["pairs"], zrep["moved"], zrep["tie_paths"],
           zrep["unexplained"], t["cuda"], t["cpu"], jrep["moved"],
           jrep["tie_paths"], jrep["unexplained"],
           json.dumps(jrep["worst"], default=float), json.dumps(rel),
           polish.JERK_EVAL_RTOL, "within" if rel_ok else "EXCEEDED",
           "ok" if out["ok"] else "FAIL"))
    return out


def phase_jerk(gen, workdir):
    """The jerk search on the card: the bench shape (JERK_BENCH) with its
    host bank build timed on its own, the warm call and the best of 2,
    cells/s as bench_jerk counts them, the launches of one search, the
    tone found; its polish (jerk_polish); the kernels at its geometry
    (jerk_kernels, the scan at w = 300); the jerk pulsar through
    accelsearch -wmax on the card and the CPU, and the kernels at that
    path's geometry (jerk_pulsar)."""
    from presto_tpu_torch.search import accel, accel_cuda, build_cuda
    b = JERK_BENCH
    n = b["numbins"]
    rng = np.random.default_rng(b["seed"])
    pairs = np.stack([rng.normal(size=n), rng.normal(size=n)],
                     -1).astype(np.float32)
    pairs[b["tone_bin"]] = (b["tone"], 0.0)
    cfg = accel.AccelConfig(zmax=b["zmax"], wmax=b["wmax"],
                            numharm=b["numharm"], sigma=b["sigma"])
    s = accel.AccelSearch(cfg, T=b["T"], numbins=n, device="cuda")
    t0 = time.time()
    for w in cfg.ws:
        s.bank(w)
    bank_s = time.time() - t0
    dev_pairs = torch.as_tensor(pairs, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build_cuda.launches = accel_cuda.launches = 0
    accel_cuda.planes_launches = 0
    t0 = time.time()
    cands = s.search(dev_pairs)
    torch.cuda.synchronize()
    warm = time.time() - t0
    launches = dict(plane_build=build_cuda.launches,
                    stage_reduce=accel_cuda.launches,
                    stage_reduce_planes=accel_cuda.planes_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        again = s.search(dev_pairs)
        torch.cuda.synchronize()
        best = min(best, time.time() - t0)
    same = ([(c.numharm, c.r, c.z, c.w, c.power) for c in again]
            == [(c.numharm, c.r, c.z, c.w, c.power) for c in cands])
    numr = int(s.rhi - s.rlo) * 2
    cells = cfg.numz * numr * len(cfg.ws)
    top = cands[0] if cands else None
    tone = bool(top and abs(top.r - b["tone_bin"]) < 1.0)
    geom = dict(uselen=s.cfg.uselen, fftlen=s.kern.fftlen,
                halfwidth=s.kern.halfwidth, numz_pad=s.numz_pad,
                plane=list(s.plane_geom()), aligned=s.aligned)
    nws = len(cfg.ws)
    ok = (tone and same and launches["plane_build"] == nws
          and launches["stage_reduce_planes"] == nws)
    log("jerk bench (2^20 bins, zmax 100, wmax 300: %d w planes, numharm 4, "
        "sigma 6): geometry %s; host bank build %.2f s (%d banks); warm "
        "call %.3f s, best of 2 %.3f s, %.4g cells/s (%d cells); launches "
        "a search %s; peak %.2f GB; %d candidates, top r %.2f sigma %.2f, "
        "tone found %s, repeat identical %s %s"
        % (nws, json.dumps(geom), bank_s, nws, warm, best, cells / best,
           cells, json.dumps(launches), peak_gb, len(cands),
           top.r if top else -1, top.sigma if top else -1, tone, same,
           "ok" if ok else "FAIL"))
    pol = jerk_polish(dev_pairs, cands, s)
    del dev_pairs
    torch.cuda.empty_cache()
    pb, red = jerk_kernels(s, n, torch.Generator(device="cuda").manual_seed(9),
                           300.0, "jerk bench (zmax 100, wmax 300, numharm "
                           "4)")
    del s
    torch.cuda.empty_cache()
    psr = jerk_pulsar(workdir)
    return dict(ok=ok and pol["ok"] and pb["ok"] and red["ok"] and psr["ok"],
                polish=pol,
                bench=dict(ok=ok, geometry=geom, bank_s=bank_s, banks=nws,
                           warm_s=warm, best_s=best, cells=cells,
                           cells_per_s=cells / best, launches=launches,
                           peak_gb=peak_gb, cands=len(cands), tone=tone,
                           repeat_identical=same),
                plane_build=pb, stage_reduce_planes=red, pulsar=psr)


SHARDS_ON_ONE_CARD = 4


def _same_files(a_dir, b_dir, pattern):
    """{basename: bytes equal} of each file of pattern in a_dir to its
    namesake in b_dir."""
    out = {}
    for p in sorted(glob.glob(os.path.join(a_dir, pattern))):
        q = os.path.join(b_dir, os.path.basename(p))
        out[os.path.basename(p)] = (os.path.exists(q) and open(
            p, "rb").read() == open(q, "rb").read())
    return out


def phase_sharded(raw, workdir, mwork, main_res):
    """The main beam through survey.run_survey on a DM mesh with the main
    phase's configuration: every card, or SHARDS_ON_ONE_CARD logical
    shards of cuda:0 on a one-card machine (they share its memory and
    stream: the per-shard programs and the placement are shown, not a
    speed-up).  Launch counters read around it, per shard
    (parallel/sharded.shard_launches) and per device (each wrapper
    counts its launches by the device it made current); every .dat,
    .singlepulse and cands_sifted.txt byte-equal to the unsharded main
    run's (mwork), its .fft compared too (the per-shard FFT batches are
    not the unsharded run's); then on the sharded run's own spectra each
    shard's candidate lists from search_many(mesh=) equal to the
    one-device search_many's, field for field.  The two runs' stage
    times are printed side by side, with no claim."""
    import contextlib
    import dataclasses
    from presto_tpu_torch.io import datfft
    from presto_tpu_torch.io.infodata import read_inf
    from presto_tpu_torch.ops import fftpack
    from presto_tpu_torch.parallel import mesh as pmesh
    from presto_tpu_torch.parallel import sharded
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.search import accel_cuda, build_cuda
    from presto_tpu_torch.utils.timing import StageTimer
    ncards = torch.cuda.device_count()

    def visible():
        return (pmesh.set_logical_devices(SHARDS_ON_ONE_CARD, "cuda:0")
                if ncards == 1 else contextlib.nullcontext())
    cfg = main_cfg()
    timer = StageTimer()
    with visible():
        mesh = pmesh.make_mesh()
        log("sharded: torch.cuda.device_count() = %d; the mesh: %s"
            % (ncards, "%d logical shards of cuda:0 (one card)"
               % mesh.size if ncards == 1 else "%d cards" % mesh.size))
        build_cuda.launches = accel_cuda.launches = 0
        accel_cuda.planes_launches = 0
        build_cuda.launches_by_device.clear()
        accel_cuda.launches_by_device.clear()
        sharded.shard_launches.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        res = survey.run_survey([raw], cfg, workdir, timer=timer,
                                device="cuda")
        torch.cuda.synchronize()
        total_s = time.time() - t0
    launches = {"plane_build": build_cuda.launches,
                "stage_reduce": accel_cuda.launches}
    by_device = {"plane_build": dict(build_cuda.launches_by_device),
                 "stage_reduce": dict(accel_cuda.launches_by_device)}
    by_shard = {k: dict(v) for k, v in sorted(sharded.shard_launches.items())}
    ndms = len(res.datfiles)
    per = ndms // mesh.size
    shards_ok = (sorted(by_shard) == list(range(mesh.size)) and all(
        r["device"] == str(mesh.devices[k]) and r["trials"] == per
        and r["plane_build"] == r["stage_reduce"] == per
        for k, r in by_shard.items()))
    # each launch on its shard's device: the wrappers' per-device counts
    # are the shards' launches on that device, and nothing else
    want_dev = {}
    for k, r in by_shard.items():
        idx = mesh.devices[k].index
        want_dev[idx] = want_dev.get(idx, 0) + r["plane_build"]
    device_ok = all(by_device[name] == want_dev for name in by_device)
    if ncards == 1:
        # every shard is cuda:0: the per-device counts cannot show a
        # launch landing on another card
        device_note = "devices: not testable on one card (all shards cuda:0)"
    else:
        device_note = "devices ok" if device_ok else "devices FAIL"
    launches_ok = (ndms == main_res["ndms"] and accel_cuda.planes_launches
                   == 0 and all(v == ndms for v in launches.values()))
    log("sharded: run_survey %.3f s; launches %s, by device %s, by shard "
        "%s; %s; %s" % (total_s, json.dumps(launches), json.dumps(by_device),
                        json.dumps(by_shard), "shards ok" if shards_ok
                        else "shards FAIL", device_note))
    dats = _same_files(workdir, mwork, "psr_DM*.dat")
    sps = _same_files(workdir, mwork, "psr_DM*.singlepulse")
    sifted = _same_files(workdir, mwork, "cands_sifted.txt")
    ffts = _same_files(workdir, mwork, "psr_DM*.fft")
    name22 = "psr_DM%.2f.dat" % BEAM["dm"]
    files_ok = (len(dats) == len(sps) == ndms and all(dats.values())
                and all(sps.values()) and sifted.get("cands_sifted.txt")
                and dats.get(name22))
    log("sharded: byte-equal to the unsharded run: %d/%d .dat (%s %s), "
        "%d/%d .singlepulse, cands_sifted.txt %s; .fft %d/%d equal %s"
        % (sum(dats.values()), len(dats), name22, dats.get(name22),
           sum(sps.values()), len(sps), sifted.get("cands_sifted.txt"),
           sum(ffts.values()), len(ffts), "ok" if files_ok else "FAIL"))
    # the candidate lists, shard by shard, on the same spectra
    info = read_inf(res.datfiles[0][:-4])
    T = info.N * info.dt
    fftfiles = sorted(glob.glob(os.path.join(workdir, "psr_DM*.fft")))
    batch = torch.stack([torch.from_numpy(fftpack.np_complex64_to_pairs(
        datfft.read_fft(f))) for f in fftfiles]).to("cuda")
    searcher = survey.searcher_for(cfg, T, batch.shape[1], device="cuda")
    got = searcher.search_many(batch, mesh=mesh)
    want = searcher.search_many(batch)
    del batch
    rows = pmesh.shard_row_ranges(mesh, len(fftfiles))
    lists_equal = [all([dataclasses.astuple(c) for c in got[d]]
                       == [dataclasses.astuple(c) for c in want[d]]
                       for d in range(lo, hi)) for lo, hi in rows]
    ncands = [sum(len(want[d]) for d in range(lo, hi)) for lo, hi in rows]
    lists_ok = len(got) == len(want) == ndms and all(lists_equal)
    log("sharded: candidate lists equal to the one-device search_many's, "
        "by shard %s (%s candidates) %s"
        % (lists_equal, ncands, "ok" if lists_ok else "FAIL"))
    st = timer.stages
    fused = st["realfft+accelsearch (fused)"]
    stages = dict(run_survey_s=total_s, rfifind_s=st["rfifind"],
                  survey_head_s=st["prepsubband"],
                  single_pulse_s=st["single_pulse"], fused_s=fused,
                  polish_s=st["polish"], accel_writes_s=st["accel writes"],
                  sift_s=st["sift"], prepfold_s=st["prepfold"],
                  fft_search_s=fused - st["polish"] - st["accel writes"])
    log("sharded: stage times, sharded %s; unsharded %s (host seconds, "
        "one call, no claim)" % (
            json.dumps({k: round(v, 4) for k, v in stages.items()}),
            json.dumps({k: round(main_res["stages"][k], 4) for k in stages
                        if k in main_res["stages"]})))
    ok = launches_ok and shards_ok and device_ok and files_ok and lists_ok
    return dict(ok=ok, shards=mesh.size, cards=ncards,
                logical=ncards == 1, devices_tested=ncards > 1,
                ndms=ndms, launches=launches,
                launches_by_device=by_device, launches_by_shard=by_shard,
                dat_equal=sum(dats.values()), sp_equal=sum(sps.values()),
                sifted_equal=bool(sifted.get("cands_sifted.txt")),
                fft_equal=sum(ffts.values()), lists_equal=lists_equal,
                stages=stages)


def _http(method, url, payload=None, timeout=30):
    """(status, JSON body) of one request to the service's front end."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _pfd_rebased(path, src_dir, dst_dir):
    """A .pfd's bytes with the job's workdir in its four embedded names
    rewritten to the main phase's (the folds embed their file paths)."""
    from presto_tpu_torch.io import pfd as pfdio
    p = pfdio.read_pfd(path)
    for f in ("filenm", "candnm", "telescope", "pgdev"):
        setattr(p, f, getattr(p, f).replace(src_dir, dst_dir))
    tmp = path + ".rebased"
    pfdio.write_pfd(tmp, p)
    with open(tmp, "rb") as f:
        out = f.read()
    os.remove(tmp)
    return out


def _job_files_equal(jobdir, mwork):
    """{kind: (equal, count)} of a job's artifacts against the main
    phase's: .dat, .singlepulse, ACCEL tables and .cand, cands_sifted.txt
    byte for byte; fold_candN.pfd byte for byte after rebasing."""
    out = {}
    for kind, pat in (("dat", "psr_DM*.dat"), ("singlepulse",
                      "psr_DM*.singlepulse"), ("accel", "psr_DM*_ACCEL_*"),
                      ("sifted", "cands_sifted.txt")):
        same = _same_files(mwork, jobdir, pat)
        out[kind] = (bool(same) and all(same.values()), len(same))
    # the survey's folds only (the main phase keeps its card folds
    # beside their CPU refolds as fold_candN.card.pfd)
    pfds = sorted(p for p in glob.glob(os.path.join(mwork, "fold_cand*.pfd"))
                  if re.fullmatch(r"fold_cand\d+\.pfd", os.path.basename(p)))
    eq = []
    for p in pfds:
        q = os.path.join(jobdir, os.path.basename(p))
        eq.append(os.path.exists(q) and open(p, "rb").read()
                  == _pfd_rebased(q, os.path.abspath(jobdir),
                                  os.path.abspath(mwork)))
    out["pfd"] = (bool(eq) and all(eq), len(eq))
    return out


SERVE_COST_KINDS = ("plane_build", "stage_reduce", "rfft_batch",
                    "accel_search")


def phase_serve(raw, workdir, mwork, device="cuda"):
    """Survey jobs on the port's SearchService on the card, four services
    on one plan store, each with its jobs admitted before its scheduler
    starts: (1) stacked=True with its HTTP front end takes two POST
    /submit specs of the beam with the main phase's configuration (two
    workdirs, one bucket): one schedule event of occupancy 2, no
    degrade, each job's files equal to the main run's; (2) stacked=False
    prewarms from the store (>= 1 plan, warm fraction 1.0) and runs two
    jobs one after the other, each a plan hit and no plan build; (3)
    stacked=True prewarmed runs two jobs as one stacked batch again, so
    the stacked pair and the pair alone are timed on equally warm
    services; (4) a service with a mesh of two logical shards of the
    card runs one job with its rows placed over the mesh: each shard's
    plane_build and stage_reduce launches on its device.  metrics(): the
    plan cache and the kernel cost book (non-zero flops and bytes for
    plane_build, stage_reduce, rfft_batch, accel_search); the card's
    roofline peaks measured (obs/roofline) beside the nominal ones.
    Then a smoke-shape TuneRunner sweep of serve_batch_geometry and
    pipeline_inflight_depth into a DB, read back through tune.best, and
    its provenance written.  (``device`` "cpu" rehearses the phase's
    control flow at a small size.)"""
    import dataclasses
    from presto_tpu_torch import tune
    from presto_tpu_torch.obs import roofline
    from presto_tpu_torch.parallel import sharded
    from presto_tpu_torch.parallel.mesh import Mesh
    from presto_tpu_torch.search.accel import resolve_device
    from presto_tpu_torch.serve.server import SearchService, start_http
    from presto_tpu_torch.tune import space
    from presto_tpu_torch.tune.db import TuneDB
    from presto_tpu_torch.tune.runner import TuneRunner
    cfg = main_cfg()
    config = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)
              if f.name in ("lodm", "hidm", "nsub", "zmax", "numharm",
                            "fold_top", "durable_stages")}
    store = os.path.join(workdir, "store")

    def run(svc, name, njobs, base=None):
        """njobs specs of the beam admitted (POSTed when ``base``), then
        the scheduler started: {ok, seconds, schedule occupancies,
        degrades, stacked per job, files equal, plan stats before and
        after}."""
        spec = [{"rawfiles": [raw], "config": config,
                 "job_id": "%s-%d" % (name, i)} for i in range(njobs)]
        if base is not None:
            posted = [_http("POST", base + "/submit", s) for s in spec]
            admitted = all(code == 202 for code, _b in posted)
            ids = [body.get("job_id") for _code, body in posted]
        else:
            ids = [svc.submit(s)["job_id"] for s in spec]
            admitted = True
        before = svc.plans.stats()
        t0 = time.time()
        svc.start()
        done = svc.wait(ids, timeout=600.0)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.time() - t0
        evs = svc.events.tail(100000)
        jobs = [svc.get_job(j) for j in ids]
        files = {j.job_id: _job_files_equal(j.workdir, mwork) for j in jobs}
        out = dict(seconds=seconds, before=before, after=svc.plans.stats(),
                   occupancy=[e["occupancy"] for e in evs
                              if e["kind"] == "schedule"],
                   degrades=sum(e["kind"] == "degrade" for e in evs),
                   stacked=[(j.result or {}).get("stacked") for j in jobs],
                   files=files,
                   files_ok=all(ok and n > 0 for f in files.values()
                                for ok, n in f.values()))
        out["ok"] = (admitted and done and out["files_ok"]
                     and all(j.status == "done" for j in jobs))
        log("serve: %s: %d job(s) %.3f s; schedule occupancy %s, degrades "
            "%d, stacked %s; plan hits %d -> %d, builds %d -> %d; files "
            "equal to the main run's %s %s"
            % (name, njobs, seconds, out["occupancy"], out["degrades"],
               out["stacked"], before["hits"], out["after"]["hits"],
               before["misses"], out["after"]["misses"], json.dumps(files),
               "ok" if out["ok"] else "FAIL"))
        return out

    # (1) a cold service, the pair POSTed over HTTP, one stacked batch
    svc = SearchService(os.path.join(workdir, "svc1"), plan_store_dir=store,
                        stacked=True, device=device)
    httpd = start_http(svc)
    try:
        cold = run(svc, "stacked-cold", 2,
                   base="http://%s:%d" % httpd.server_address[:2])
        m1 = svc.metrics()
        readyz1 = svc.readyz()
    finally:
        httpd.shutdown()
        svc.stop()
    stack_ok = (cold["ok"] and cold["occupancy"] == [2]
                and not cold["degrades"] and cold["stacked"] == [2, 2])
    warm = {}
    for name, stacked, mesh, njobs in (
            ("alone", False, None, 2), ("stacked", True, None, 2),
            ("mesh", True, 2, 1)):
        dev = resolve_device(device)
        svc = SearchService(os.path.join(workdir, name),
                            plan_store_dir=store, stacked=stacked,
                            device=device,
                            mesh=Mesh((dev,) * mesh) if mesh else None)
        try:
            prewarmed = svc.prewarm()
            fraction = svc.warm_fraction()
            sharded.shard_launches.clear()
            warm[name] = run(svc, name, njobs)
            warm[name].update(
                prewarmed=prewarmed, warm_fraction=fraction,
                shards={k: dict(v) for k, v
                        in sorted(sharded.shard_launches.items())},
                plan_store=svc.readyz()["plan_store"],
                plans=svc.metrics()["plans"])
        finally:
            svc.stop()
        r = warm[name]
        r["ok"] = (r["ok"] and prewarmed >= 1 and fraction == 1.0
                   and r["after"]["hits"] > r["before"]["hits"]
                   and r["after"]["misses"] == r["before"]["misses"]
                   and r["occupancy"] == [njobs] and not r["degrades"])
        log("serve: %s: prewarmed %d plan(s) (warm fraction %.3f, store "
            "%s); shards %s"
            % (name, prewarmed, fraction, json.dumps(r["plan_store"]),
               json.dumps(r["shards"])))
    warm["stacked"]["ok"] &= warm["stacked"]["stacked"] == [2, 2]
    per = {k: v for k, v in warm["mesh"]["shards"].items()}
    counted = device != "cuda" or all(
        v["plane_build"] > 0 and v["stage_reduce"] > 0 for v in per.values())
    warm["mesh"]["ok"] &= (sorted(per) == [0, 1] and counted and all(
        v["device"] == str(resolve_device(device)) and v["trials"] > 0
        for v in per.values()))
    warm_ok = all(r["ok"] for r in warm.values())
    costs = m1["kernel_costs"].get("kinds", {})
    cost_rows = {k: {x: costs.get(k, {}).get(x) for x in (
        "dispatches", "flops_per_dispatch", "hbm_bytes_per_dispatch",
        "flops_total", "hbm_bytes_total", "intensity")}
        for k in sorted(costs)}
    costs_ok = all((costs.get(k, {}).get("flops_total") or 0) > 0
                   and (costs.get(k, {}).get("hbm_bytes_total") or 0) > 0
                   for k in SERVE_COST_KINDS)
    log("serve: metrics() plans %s; kernel_costs %s %s"
        % (json.dumps(m1["plans"]), json.dumps(cost_rows),
           "ok" if costs_ok else "FAIL"))
    db_path = os.path.join(workdir, "tune.json")
    peaks = roofline.device_peaks(db_path=db_path, measure=True)
    rows = roofline.roofline_rows(m1["kernel_costs"], peaks)
    log("serve: measured peaks %.4g FLOP/s (float32 matmul, TF32 off; "
        "nominal %.4g) and %.4g B/s (triad; nominal %.4g), ridge %.3f "
        "FLOP/B; roofline %s"
        % (peaks["flops_per_s"], PEAK_F32_FLOPS, peaks["bytes_per_s"],
           PEAK_BYTES_PER_S, peaks["ridge_intensity"],
           json.dumps({r["kind"]: r["verdict"] for r in rows})))
    # the tuning DB: two families swept at their smoke shapes
    runner = TuneRunner(k=3, warmup=1, device=device)
    db = TuneDB()
    tuned = {}
    for name in ("serve_batch_geometry", "pipeline_inflight_depth"):
        tuned[name] = space.tune_family(space.FAMILIES[name], runner,
                                        smoke=True, db=db)
    db.save(db_path)
    tune.configure(enabled=True, db_path=db_path)
    try:
        best = {name: tune.best(name, tune.GLOBAL_KEY) for name in tuned}
        prov = tune.write_provenance(workdir)
    finally:
        tune.reset()
    tune_ok = (all(best[n] == tuned[n][0][1] for n in tuned)
               and prov is not None and os.path.exists(prov))
    log("serve: tuned %s; tune.best %s; provenance %s %s"
        % (json.dumps({n: [[k, c, m] for k, c, m in v]
                       for n, v in tuned.items()}), json.dumps(best),
           prov, "ok" if tune_ok else "FAIL"))
    stacked_s, alone_s = warm["stacked"]["seconds"], warm["alone"]["seconds"]
    log("serve: on prewarmed services, a stacked batch of 2 %.3f s beside "
        "the same 2 jobs run one after the other %.3f s (%.3fx; cold "
        "stacked batch %.3f s; host clock, one call, no claim)"
        % (stacked_s, alone_s, stacked_s / alone_s, cold["seconds"]))
    ok = stack_ok and warm_ok and costs_ok and tune_ok
    return dict(ok=ok, stacked_s=stacked_s, two_alone_s=alone_s,
                stacked_cold_s=cold["seconds"], files=cold["files"],
                occupancy=cold["occupancy"], degrades=cold["degrades"],
                warm={k: {x: v[x] for x in (
                    "ok", "seconds", "occupancy", "degrades", "stacked",
                    "files", "prewarmed", "warm_fraction", "shards",
                    "plans")} for k, v in warm.items()},
                plans=m1["plans"], plan_store=readyz1["plan_store"],
                kernel_costs=cost_rows, peaks=peaks, roofline=rows,
                tuned=tuned, tune_best=best)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two_processes(argv, kill_rank=None, timeout=300):
    """Two processes of `prepsubband.main(argv + ["-procid", rank])` on
    the card, joined through -coordinator (a free localhost port); with
    kill_rank, that rank's elastic loop exits at its first
    pre-shard-commit point.  Returns (return codes, output tails,
    seconds); every process is stopped before it returns."""
    from presto_tpu_torch.parallel import elastic
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; from presto_tpu_torch.apps import prepsubband; "
            "prepsubband.main(sys.argv[1:])")
    argv = argv + ["-coordinator", "localhost:%d" % _free_port(),
                   "-nproc", "2"]
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    t0 = time.time()
    try:
        for rank in range(2):
            e = dict(env)
            if rank == kill_rank:
                e[elastic.KILL_ENV] = "pre-shard-commit:1:exit"
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code] + argv
                + ["-procid", str(rank)], cwd=here, env=e,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outs = [p.communicate(timeout=timeout)[0].decode(
            errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], [o[-1500:] for o in outs], \
        time.time() - t0


def phase_cluster(raw, workdir, mwork, maskfile):
    """Two processes on the card run the survey's prepsubband method with
    its mask: through -coordinator (a gloo process group; each process
    dedisperses and writes its own 12 DMs), then through -elastic
    -coordinator with rank 0 killed (os._exit) after computing its first
    shard, before the commit: the survivor reaps it, takes its shard and
    finishes.  Every .dat of both runs byte-equal to the unsharded main
    run's (mwork)."""
    cfg = main_cfg()
    out = {}
    for name, extra, kill in (
            ("coordinator", [], None),
            ("elastic", ["-elastic", "-heartbeat-interval", "0.5",
                         "-lease-ttl", "60", "-barrier-timeout", "60"], 0)):
        d = os.path.join(workdir, name)
        os.makedirs(d)
        argv = (method_argv(raw, cfg, os.path.join(d, "psr"))
                + ["-mask", maskfile] + extra + [raw])
        rcs, tails, secs = run_two_processes(argv, kill_rank=kill)
        dats = _same_files(d, mwork, "psr_DM*.dat")
        want_rcs = [0, 0] if kill is None else [43, 0]
        ok = (rcs == want_rcs and all(dats.values()) and len(dats) == len(
            glob.glob(os.path.join(mwork, "psr_DM*.dat"))))
        rec = dict(ok=ok, rcs=rcs, seconds=secs, dat_equal=sum(
            dats.values()), dats=len(dats))
        if name == "elastic":
            led = json.load(open(os.path.join(d, "shards.json")))
            rec.update(epoch=led["epoch"],
                       rank0_alive=led["hosts"]["proc0"]["alive"],
                       shards={k: v["owner"] for k, v in
                               sorted(led["shards"].items())})
            ok = rec["ok"] = ok and led["epoch"] >= 1 and \
                not led["hosts"]["proc0"]["alive"]
        log("cluster: %s: return codes %s (want %s), %.1f s, %d/%d .dat "
            "byte-equal to the unsharded run's%s %s"
            % (name, rcs, want_rcs, secs, rec["dat_equal"], rec["dats"],
               "; ledger epoch %d, shards by %s" % (rec["epoch"],
                                                   rec["shards"])
               if name == "elastic" else "", "ok" if ok else "FAIL"))
        if not ok:
            for r, t in enumerate(tails):
                log("cluster: %s rank %d output tail:\n%s" % (name, r, t))
        out[name] = rec
    return dict(ok=all(v["ok"] for v in out.values()), **out)


# ---------------------------------------------------------------------------
# The live stream (stream/, serve/): the stream and beams phases
# ---------------------------------------------------------------------------

# the live feed's geometry is the beam's (128 x 3 MHz at 1214-1595 MHz, dt
# 128 us, 8-bit), a Parkes Multibeam L-band feed (13 beams of 96 x 3 MHz,
# Manchester et al. 2001) with 128 channels; the stream configuration is
# DM 0-255 in steps of 1 over 32 subbands, 1.05 s blocks, the other
# StreamConfig fields at their defaults
LIVE = dict(nchan=128, dt=1.28e-4, lofreq=1214.0, cw=3.0)
LIVE_CFG = dict(lodm=0.0, dmstep=1.0, numdms=256, nsub=32, blocklen=8192)
# one live beam through the service: 2^18 spectra (33.6 s), paced at 4x
# real time over loopback; four dispersed pulses and a broadband DM-0 burst
# (arrival at the top of the band s, DM, width s, amplitude per channel:
# matched S/N A sqrt(128 w) / 6 of 23-36 before the subband smearing)
STREAM = dict(N=1 << 18, seed=31, speed=4.0)
STREAM_PULSES = ((4.1, 21.6, 0.5e-3, 6.0), (10.3, 57.0, 1.0e-3, 5.0),
                 (16.7, 143.0, 2.0e-3, 4.0), (23.2, 231.0, 3.0e-3, 4.0),
                 (28.9, 0.0, 1.0e-3, 4.0))
# the trials held byte-equal to prepsubband's .dat: DM 0 keeps the
# 256-trial plan's delay normalization, -subdm its subband centre DM
STREAM_DAT_DMS = (0, 57, 114, 171)
# a trigger matches an injected pulse within this time and DM
TRIGGER_DT_S, TRIGGER_DDM = 0.2, 5.0
# 13 beams of 4 blocks (32768 spectra, 4.2 s) each, fed as fast as the
# rings take them; one dispersed pulse in beam 0 alone and a broadband
# burst in all.  Cut from 2^17 spectra (16.8 s), which took 198 s for the
# phase on an H100 (the per-trial single-pulse loop: 13 x 256 host round
# trips a tick, three passes), then from 6 blocks (80-131 s), to keep
# both live phases near 90 s
BEAMS = dict(N=4 * 8192, nbeams=13, seed=41, coincidence_k=3)
BEAMS_PULSE = (1.5, 57.0, 1.0e-3, 5.0)
BEAMS_BURST = (3.0, 0.0, 1.0e-3, 4.0)


def live_filterbank(path, seed, n, bursts, device="cuda"):
    """A seeded live-geometry 8-bit filterbank with `bursts` (no pulsar)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = LIVE
    synth_filterbank(path, gen, n, g["nchan"], g["dt"], g["lofreq"],
                     g["cw"], (), bursts=bursts, device=device)


def _span_ms(obs, name):
    """(count, mean ms, total s) of the finished spans of `name`."""
    ds = [s.duration for s in obs.tracer.finished() if s.name == name]
    return len(ds), (1e3 * sum(ds) / len(ds) if ds else 0.0), sum(ds)


def _match_triggers(trigs, injected):
    """Per injected (t0, dm, ...): the triggers within TRIGGER_DT_S of its
    time; ok when each has exactly one, within TRIGGER_DDM of its DM."""
    rows, used = [], set()
    for t0, dm, *_ in injected:
        hits = [i for i, e in enumerate(trigs)
                if abs(e["time"] - t0) <= TRIGGER_DT_S]
        used.update(hits)
        rows.append(dict(t0=t0, dm=dm, hits=[
            dict(time=trigs[i]["time"], dm=trigs[i]["dm"],
                 sigma=trigs[i]["sigma"]) for i in hits],
            ok=len(hits) == 1 and abs(trigs[hits[0]]["dm"] - dm)
            <= TRIGGER_DDM))
    extra = [trigs[i] for i in range(len(trigs)) if i not in used]
    return rows, extra


def _send_paced(address, wire, hdrlen, bps, dt, speed, chunk=1024):
    """Send a filterbank's bytes over a socket: the header at once, then
    `chunk` spectra at a time at `speed` x real time."""
    import socket
    s = socket.create_connection(address)
    try:
        s.sendall(wire[:hdrlen])
        t0, pos, sent = time.time(), hdrlen, 0
        while pos < len(wire):
            s.sendall(wire[pos:pos + chunk * bps])
            pos += chunk * bps
            sent += chunk
            lag = t0 + sent * dt / speed - time.time()
            if lag > 0:
                time.sleep(lag)
    finally:
        s.close()


def profile_ticks(ticks, active):
    """Run the callables of `ticks` in turn in one torch.profiler window,
    each inside its own record_function span, and read the device work
    of the last `active`: every kernel and copy launched from within
    their spans (by the profiler's launch correlation, so none of the
    earlier ticks' work and no clock alignment is involved; the earlier
    ticks also give the device tracing time to start).  Returns
    (kernels, copies, host ms of those ticks), kernels and copies as the
    profiler's per-launch records (name, duration in us)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    names = ["chip_smoke_tick_%d" % k for k in range(len(ticks))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, tick in zip(names, ticks):
            with record_function(name):
                tick()
                torch.cuda.synchronize()
    want = set(names[len(ticks) - active:])
    kern, copies, host = [], [], 0.0
    for e in prof.events():
        if e.name not in want:
            continue
        host += e.time_range.elapsed_us() / 1e3
        todo = [e]
        while todo:
            x = todo.pop()
            for k in x.kernels:
                (copies if k.name.lower().startswith(("memcpy", "memset"))
                 else kern).append(k)
            todo.extend(x.cpu_children)
    return kern, copies, host


def tick_profile(hdr, cfg, raw, device="cuda"):
    """The blocks of `raw` (whole blocks, at least 4) through a fresh
    StreamSearch on the card: the third from last timed on the host
    clock alone, the last two in a torch.profiler window (the first of
    them its warm-up).  The kernels and copies the last tick launches,
    the device's busy ms (the sum of their durations), the host ms of a
    tick with and without the profiler, and the device's idle share
    (busy ms over the tick without the profiler)."""
    from presto_tpu_torch.stream import StreamSearch
    eng = StreamSearch(hdr, cfg, device=device)
    bl = cfg.blocklen
    nblocks = len(raw) // bl

    def tick(k):
        eng.feed_block(raw[k * bl:(k + 1) * bl], bl)
    for k in range(nblocks - 3):
        tick(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick(nblocks - 3)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3
    kern, copies, profiled_ms = profile_ticks(
        [lambda k=k: tick(k) for k in (nblocks - 2, nblocks - 1)],
        active=1)
    busy_ms = sum(k.duration for k in kern + copies) / 1e3
    return dict(kernels=len(kern), copies=len(copies),
                device_busy_ms=busy_ms, tick_host_ms=tick_ms,
                profiled_tick_host_ms=profiled_ms,
                idle_share=1.0 - busy_ms / tick_ms)


def phase_stream(workdir, device="cuda"):
    """One live beam through the port's service path: SocketProducer on
    loopback (paced at STREAM speed x real time) -> RingBlockSource ->
    StreamService on the port's SearchService, the device work on the
    card.  Every injected pulse triggered exactly once (time within
    TRIGGER_DT_S, DM within TRIGGER_DDM); the rolling series of
    STREAM_DAT_DMS byte-equal over the valid span to the port's
    prepsubband .dat of the same file on the card; deadline-lane batches
    >= 1 and one stream_latency_seconds sample a trigger.  Prints the
    blocks, triggers, latency p50/p99 (block arrival -> trigger emitted),
    the dedispersion step's device ms a block (CUDA events at the run's
    shapes), the host ms a block of the per-trial single-pulse loop (the
    stream:search spans), the real-time factor (data seconds over the
    seconds the deadline-lane ticks took), and one steady-state tick
    under torch.profiler (tick_profile: its kernels and copies, the
    device's busy ms and idle share)."""
    import threading
    from presto_tpu_torch.apps import prepsubband
    from presto_tpu_torch.io.datfft import read_dat
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import (RingBlockSource, SocketProducer,
                                         StreamConfig, StreamSearch,
                                         StreamService)
    from presto_tpu_torch.stream import service as stream_service
    os.makedirs(workdir)
    raw = os.path.join(workdir, "live.fil")
    t0 = time.time()
    live_filterbank(raw, STREAM["seed"], STREAM["N"], STREAM_PULSES, device)
    synth_s = time.time() - t0
    wire = open(raw, "rb").read()
    bps = LIVE["nchan"]
    hdrlen = len(wire) - STREAM["N"] * bps
    cfg = StreamConfig(**LIVE_CFG)
    rows = list(STREAM_DAT_DMS)
    kept = []

    class Recording(StreamSearch):
        """The service's engine, keeping the rolling series of `rows`."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            feed = self.rolling.feed

            def capture(block):
                out = feed(block)
                if out is not None:
                    kept.append(out[rows].copy())
                return out
            self.rolling.feed = capture

    svc = SearchService(os.path.join(workdir, "serve"), heartbeat_s=1.0)
    svc.start()
    stream_service.StreamSearch = Recording
    try:
        src = RingBlockSource(capacity=cfg.ring_capacity,
                              policy=cfg.ring_policy)
        prod = SocketProducer(src).start()
        sender = threading.Thread(target=_send_paced, args=(
            prod.address, wire, hdrlen, bps, LIVE["dt"], STREAM["speed"]),
            daemon=True)
        t0 = time.time()
        sender.start()
        stream = StreamService(svc, src, cfg, device=device).start()
        done = stream.wait(600.0)
        wall_s = time.time() - t0
        sender.join(10.0)
        prod.close()
    finally:
        stream_service.StreamSearch = StreamSearch
        svc.stop()
    if not done or stream.failed is not None:
        log("stream: the service did not finish: %r" % stream.failed)
        return dict(ok=False, error=repr(stream.failed))
    eng = stream.engine
    evs = svc.events.tail(100000)
    trigs = [e for e in evs if e["kind"] == "trigger"]
    matched, extra = _match_triggers(trigs, STREAM_PULSES)
    reg = svc.obs.metrics
    lanes = reg.get("serve_lane_batches_total").labels(
        lane="deadline").value
    hist = reg.get("stream_latency_seconds").labels(stream="stream-0",
                                                     beam="-")
    lat = hist.percentiles((50, 99))
    blocks = int(reg.get("stream_blocks_total").value)
    # the series against prepsubband's .dat on the card
    t0 = time.time()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        prepsubband.main(["-lodm", "0", "-dmstep", str(rows[1] - rows[0]),
                          "-numdms", str(len(rows)), "-subdm",
                          str(cfg.lodm + 0.5 * (cfg.numdms - 1)
                              * cfg.dmstep),
                          "-nsub", str(cfg.nsub), "-nobary", "-clip", "0",
                          "-o", "live", raw], device=device)
    finally:
        os.chdir(cwd)
    prep_s = time.time() - t0
    series = np.concatenate(kept, axis=1)
    valid = STREAM["N"] - eng.maxd
    dats = sorted(glob.glob(os.path.join(workdir, "live_DM*.dat")),
                  key=lambda p: float(os.path.basename(p)[7:-4]))
    dat_equal = [bool(np.array_equal(read_dat(p)[:valid], series[i][:valid]))
                 for i, p in enumerate(dats)]
    # the dedispersion step's device time at the run's shapes
    g = torch.Generator(device=device)
    g.manual_seed(5)
    blk = [torch.randn((LIVE["nchan"], cfg.blocklen), generator=g,
                       device=device) for _ in range(2)]
    sub = torch.randn((cfg.nsub, cfg.blocklen), generator=g, device=device)
    step_ms = cuda_time_ms(lambda: eng.rolling.step(blk[0], blk[1], sub),
                           reps=20)
    from presto_tpu_torch.io.sigproc import FilterbankFile
    with FilterbankFile(raw) as fb:
        prof = tick_profile(fb.header, cfg, fb.read_spectra(
            0, 6 * cfg.blocklen), device=device)
    _, block_ms, block_s = _span_ms(svc.obs, "stream:block")
    _, dedisp_ms, _ = _span_ms(svc.obs, "stream:dedisp")
    _, search_ms, search_s = _span_ms(svc.obs, "stream:search")
    data_s = STREAM["N"] * LIVE["dt"]
    ok = (all(m["ok"] for m in matched) and len(dats) == len(rows)
          and all(dat_equal) and lanes >= 1 and hist.count == len(trigs)
          and blocks == -(-STREAM["N"] // cfg.blocklen))
    res = dict(ok=ok, spectra=STREAM["N"], blocks=blocks,
               triggers=len(trigs), matched=matched, extra_triggers=extra,
               latency_p50_s=lat["p50"], latency_p99_s=lat["p99"],
               latency_samples=hist.count, deadline_batches=lanes,
               dat_equal=dat_equal, valid=valid, maxd=eng.maxd,
               dedisp_step_ms=step_ms, dedisp_block_host_ms=dedisp_ms,
               sp_loop_host_ms=search_ms, tick_host_ms=block_ms,
               sp_loop_share=search_s / block_s if block_s else 0.0,
               realtime_factor=data_s / block_s if block_s else 0.0,
               tick_profile=prof,
               wall_s=wall_s, paced_s=data_s / STREAM["speed"],
               synth_s=synth_s, prepsubband_s=prep_s,
               summary=stream.summary())
    log("stream: %d spectra (%.1f s of data) paced at %gx over loopback: "
        "%d blocks, %d triggers (%d beside the injected), injected %s; "
        "latency p50 %.3f s, p99 %.3f s (%d samples); deadline-lane "
        "batches %d; dedispersion step %.3f device ms a block (%.3f host "
        "ms with the upload and copy back); per-trial single-pulse loop "
        "%.3f host ms a block, %.1f%% of the tick (%.3f ms); real-time "
        "factor %.2f (data s over tick s); one tick under the profiler: "
        "%d kernels, %d copies, device busy %.3f ms of a %.3f ms tick "
        "(%.3f ms profiled; idle share %.3f); wall %.1f s; %d/%d .dat "
        "byte-equal to prepsubband's on the card (DMs %s, %d valid "
        "samples) %s"
        % (STREAM["N"], data_s, STREAM["speed"], blocks, len(trigs),
           len(extra), json.dumps([(m["t0"], m["dm"], len(m["hits"]),
                                    m["hits"][0]["dm"] if m["hits"]
                                    else None) for m in matched]),
           lat["p50"], lat["p99"], hist.count, lanes, step_ms, dedisp_ms,
           search_ms, 100 * res["sp_loop_share"], block_ms,
           res["realtime_factor"], prof["kernels"], prof["copies"],
           prof["device_busy_ms"], prof["tick_host_ms"],
           prof["profiled_tick_host_ms"], prof["idle_share"], wall_s,
           sum(dat_equal), len(dats),
           list(rows), valid, "ok" if ok else "FAIL"))
    return res


def _tick_kernels(stacked, blocks):
    """Kernel launches and copies on the card of one steady-state tick of
    a StackedRollingDedisp (primed with blocks[0:2]), from
    torch.profiler's device events over two identical ticks: (kernels,
    copies) a tick."""
    stacked.feed(blocks[0])
    stacked.feed(blocks[1])
    kern, copies, _ = profile_ticks(
        [lambda b=b: stacked.feed(b) for b in (blocks[0], blocks[1],
                                               blocks[0])], active=2)
    return len(kern) / 2, len(copies) / 2


def phase_beams(workdir, device="cuda"):
    """BEAMS["nbeams"] beams of the live geometry through BeamMultiplexer
    on the port's SearchService, fed as fast as the rings take them:
    first with the veto off (every beam's triggers equal an independent
    StreamSearch's on the same blocks; beam b's stacked series bit-equal,
    on every tick, to that one-beam RollingDedisp's, by SHA-256 of each
    block's bytes; stacked steps <= ticks; every spectrum consumed), then
    with coincidence_k (the burst in every beam vetoed, the beam-0 pulse
    kept).  The kernels one tick launches (torch.profiler) equal at 1 beam
    and at all of them; the stacked step's device ms at all beams beside
    that many times a one-beam RollingDedisp.step's (timed side by side
    at the run's shapes); the steady-state real-time factor (a tick's
    seconds of data over the mean stream:beam-tick span past the two
    priming ticks), and the whole run's (seconds of data over the
    multiplexer's wall seconds, set-up, priming and flush included)."""
    import hashlib
    import threading
    from presto_tpu_torch.io.sigproc import FilterbankFile
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import (BeamMultiplexer, RingBlockSource,
                                         StackedRollingDedisp, StreamConfig,
                                         StreamSearch, make_beam_block_step)
    os.makedirs(workdir)
    nb, n = BEAMS["nbeams"], BEAMS["N"]
    t0 = time.time()
    datas = []
    for b in range(nb):
        path = os.path.join(workdir, "beam%02d.fil" % b)
        live_filterbank(path, BEAMS["seed"] + b, n,
                        ((BEAMS_PULSE,) if b == 0 else ()) + (BEAMS_BURST,),
                        device)
        with FilterbankFile(path) as fb:
            hdr = fb.header
            datas.append(fb.read_spectra(0, n))
        os.remove(path)
    synth_s = time.time() - t0
    cfg = StreamConfig(**LIVE_CFG)
    digest = lambda a: hashlib.sha256(  # noqa: E731
        np.ascontiguousarray(a).tobytes()).hexdigest()
    strip = lambda d: json.dumps(  # noqa: E731
        {k: v for k, v in d.items() if k not in (
            "seq", "ts", "kind", "stream", "beam", "latency_s")},
        sort_keys=True)

    # the reference: an independent one-beam StreamSearch a beam
    t0 = time.time()
    ref_hashes, ref_trigs = [], []
    for data in datas:
        eng = StreamSearch(hdr, cfg, device=device)
        hashes, feed = [], eng.rolling.feed

        def capture(block, feed=feed, hashes=hashes):
            out = feed(block)
            if out is not None:
                hashes.append(digest(out))
            return out
        eng.rolling.feed = capture
        trigs = []
        for lo in range(0, n, cfg.blocklen):
            trigs += eng.feed_block(data[lo:lo + cfg.blocklen], cfg.blocklen)
        trigs += eng.finish()
        ref_hashes.append(hashes)
        ref_trigs.append(sorted(strip(t.to_json()) for t in trigs))
    ref_s = time.time() - t0

    class Hashing(BeamMultiplexer):
        """The multiplexer, hashing each beam's stacked series a tick."""

        def _setup(self):
            super()._setup()
            self.hashes = [[] for _ in self.lanes]
            for rolling, idxs in self.groups:
                feed = rolling.feed

                def hashed(stack, feed=feed, idxs=idxs):
                    out, k = feed(stack)
                    if out is not None:
                        for j, i in enumerate(idxs):
                            self.hashes[i].append(digest(out[j]))
                    return out, k
                rolling.feed = hashed

    def steady_ticks(obs):
        """Durations (s) of the stream:beam-tick spans past priming."""
        return [sp.duration for sp in obs.tracer.finished()
                if sp.name == "stream:beam-tick" and sp.attrs["tick"] >= 2]

    def push(src, data):
        src.set_header(hdr)
        for lo in range(0, n, 1024):
            src.push_spectra(data[lo:lo + 1024])
        src.eof()

    runs = {}
    for name, k in (("veto_off", 0), ("veto_on", BEAMS["coincidence_k"])):
        svc = SearchService(os.path.join(workdir, name), heartbeat_s=1.0)
        svc.start()
        try:
            srcs = [RingBlockSource(capacity=cfg.ring_capacity,
                                    policy=cfg.ring_policy)
                    for _ in datas]
            t0 = time.time()
            for s, d in zip(srcs, datas):
                threading.Thread(target=push, args=(s, d),
                                 daemon=True).start()
            mux = Hashing(svc, srcs, cfg, coincidence_k=k,
                          device=device).start()
            done = mux.wait(600.0)
            wall = time.time() - t0
        finally:
            svc.stop()
        if not done or mux.failed is not None:
            log("beams: %s did not finish: %r" % (name, mux.failed))
            return dict(ok=False, error=repr(mux.failed))
        evs = svc.events.tail(1000000)
        per_beam = {lane.beam_id: [] for lane in mux.lanes}
        for e in evs:
            if e["kind"] == "trigger":
                per_beam[e["beam"]].append(e)
        totals = mux.summary_totals()
        runs[name] = dict(
            wall_s=wall, ticks=max(lane.ticks for lane in mux.lanes),
            dispatches=totals["dispatches"], totals=totals,
            per_beam=per_beam, hashes=mux.hashes,
            steady_tick_s=steady_ticks(svc.obs),
            vetoes=[e for e in evs if e["kind"] == "beam-veto"],
            spectra=[row["spectra"] for row in
                     mux.summary()["per_beam"]],
            lost=sum(row["dropped_spectra"] + row["stalled_spectra"]
                     + row["source"]["dropped_spectra"]
                     for row in mux.summary()["per_beam"]))
    off, on = runs["veto_off"], runs["veto_on"]
    trig_equal = [sorted(strip(e) for e in off["per_beam"]["beam-%d" % b])
                  == ref_trigs[b] for b in range(nb)]
    series_equal = [off["hashes"][b] == ref_hashes[b]
                    and len(ref_hashes[b]) == -(-n // cfg.blocklen)
                    for b in range(nb)]
    burst_vetoed = any(abs(v["time"] - BEAMS_BURST[0]) <= TRIGGER_DT_S
                       and v["nbeams"] >= BEAMS["coincidence_k"]
                       for v in on["vetoes"])
    kept = [e for e in on["per_beam"]["beam-0"]
            if abs(e["time"] - BEAMS_PULSE[0]) <= TRIGGER_DT_S
            and abs(e["dm"] - BEAMS_PULSE[1]) <= TRIGGER_DDM]
    burst_left = [e for b in on["per_beam"].values() for e in b
                  if abs(e["time"] - BEAMS_BURST[0]) <= TRIGGER_DT_S]
    # the launches of one tick and the stacked step's device time, at 1
    # beam and at all of them, beside the one-beam carry's own step
    g = torch.Generator(device="cpu")
    g.manual_seed(9)
    first = StreamSearch(hdr, cfg, device=device)
    counts, step_ms, x = {}, {}, {}
    for B in (1, nb):
        blocks = [torch.randn((B, cfg.blocklen, LIVE["nchan"]),
                              generator=g).numpy() for _ in range(2)]
        counts[B] = _tick_kernels(StackedRollingDedisp(
            first._chan_bins, first._dm_bins, cfg.nsub, cfg.downsamp,
            device=device), blocks)
        x[B] = [torch.as_tensor(b, device=device).transpose(1, 2)
                .contiguous() for b in blocks]
    prime, step = make_beam_block_step(first._chan_bins, first._dm_bins,
                                       cfg.nsub, cfg.downsamp)
    subs = {B: prime(x[B][0], x[B][1]) for B in x}
    one, one_sub = [b[0] for b in x[1]], subs[1][0]
    step_ms["one_beam_carry"] = cuda_time_ms(
        lambda: first.rolling.step(one[0], one[1], one_sub), reps=30)
    for B in x:
        step_ms[B] = cuda_time_ms(
            lambda: step(x[B][0], x[B][1], subs[B]), reps=30)
    del x, one, one_sub, subs
    launches_equal = counts[1] == counts[nb]
    data_s = n * LIVE["dt"]
    tick_data_s = cfg.blocklen * LIVE["dt"]
    ok = (all(trig_equal) and all(series_equal)
          and off["dispatches"] <= off["ticks"]
          and all(s == n for r in runs.values() for s in r["spectra"])
          and off["lost"] == on["lost"] == 0 and launches_equal
          and counts[1][0] > 0 and burst_vetoed and len(kept) == 1
          and not burst_left)
    res = dict(ok=ok, beams=nb, spectra=n, synth_s=synth_s,
               reference_s=ref_s, trig_equal=trig_equal,
               series_equal=series_equal,
               triggers={name: {b: len(v) for b, v in
                                r["per_beam"].items()}
                         for name, r in runs.items()},
               ticks=off["ticks"], dispatches=off["dispatches"],
               wall_s={k: r["wall_s"] for k, r in runs.items()},
               realtime_factor_steady={
                   k: tick_data_s * len(r["steady_tick_s"])
                   / sum(r["steady_tick_s"]) for k, r in runs.items()},
               steady_ticks={k: len(r["steady_tick_s"])
                             for k, r in runs.items()},
               realtime_factor_whole_run={k: data_s / r["wall_s"]
                                          for k, r in runs.items()},
               beam0_triggers={name: [{k: e[k] for k in ("time", "dm",
                                                          "sigma")}
                                      for e in r["per_beam"]["beam-0"]]
                               for name, r in runs.items()},
               burst_vetoed=burst_vetoed, pulse_kept=len(kept),
               burst_triggers_left=len(burst_left),
               vetoes=[{k: v[k] for k in ("time", "nbeams")}
                       for v in on["vetoes"]],
               tick_kernels={B: dict(kernels=c[0], copies=c[1])
                             for B, c in counts.items()},
               step_ms={B: v for B, v in step_ms.items()},
               step_ms_one_beam_times_beams=nb
               * step_ms["one_beam_carry"])
    log("beams: %d beams x %d spectra (%.1f s of data each): veto off "
        "%d ticks, %d stacked steps, triggers a beam %s, equal to "
        "independent StreamSearches %d/%d, stacked series bit-equal to the "
        "one-beam carries on every tick %d/%d; veto on (k=%d): vetoes %s, "
        "burst vetoed %s, beam-0 pulse kept %d, burst triggers left %d; "
        "one tick's kernels (copies) at 1 beam %d (%d), at %d beams %d "
        "(%d); stacked step %.3f device ms at %d beams (%.3f at 1) "
        "against %d x %.3f = %.3f ms of one-beam RollingDedisp steps; "
        "real-time factor over the steady ticks %s, over the whole run "
        "(set-up, priming and flush included) %s; wall %s s; reference "
        "%.1f s %s"
        % (nb, n, data_s, off["ticks"], off["dispatches"],
           json.dumps(res["triggers"]["veto_off"]), sum(trig_equal), nb,
           sum(series_equal), nb, BEAMS["coincidence_k"],
           json.dumps(res["vetoes"]), burst_vetoed, len(kept),
           len(burst_left), counts[1][0], counts[1][1], nb,
           counts[nb][0], counts[nb][1], step_ms[nb], nb, step_ms[1], nb,
           step_ms["one_beam_carry"], nb * step_ms["one_beam_carry"],
           json.dumps(res["realtime_factor_steady"]),
           json.dumps(res["realtime_factor_whole_run"]),
           json.dumps(res["wall_s"]), ref_s, "ok" if ok else "FAIL"))
    return res


def launch_counts():
    """Both kernel wrappers' launch counters, set to zero (read them again
    after the path to count its launches)."""
    from presto_tpu_torch.search import accel_cuda, build_cuda
    build_cuda.launches = accel_cuda.launches = 0
    accel_cuda.planes_launches = 0
    return lambda: dict(plane_build=build_cuda.launches,
                        stage_reduce=accel_cuda.launches,
                        stage_reduce_planes=accel_cuda.planes_launches)


def live_phases():
    """The stream and beams phases, each in its own directory, with the
    kernel launches each path made (read from zero around it)."""
    out = {}
    for name, phase in (("stream", phase_stream), ("beams", phase_beams)):
        d = tempfile.mkdtemp(prefix="chip_smoke_%s_" % name)
        try:
            read = launch_counts()
            t0 = time.time()
            out[name] = phase(os.path.join(d, "w"))
            out[name].update(launches=read(), phase_s=time.time() - t0)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--live-only", action="store_true",
                    help="run the stream and beams phases alone (no build, "
                         "no kernels line, no final ok line)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import presto_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card: %s" % card)
    if opts.live_only:
        live = live_phases()
        log("results: %s" % json.dumps(live, default=float))
        return 0 if all(v["ok"] for v in live.values()) else 1
    t_start = time.time()
    results = {"card": card}
    build = phase_build()
    results["build"] = build
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    s, nbins = bench_searcher()
    k1, S = check_plane_build(s, nbins, gen)
    k2 = check_stage_reduce(s, S, gen)
    del S, s
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.time()
        raw = make_beam(work)
        results["synth_s"] = time.time() - t0
        pol = phase_polish(raw, os.path.join(work, "polish"))
        torch.cuda.empty_cache()
        mwork = os.path.join(work, "main")
        main_res = phase_main(raw, mwork)
        top = main_res.pop("top")
        torch.cuda.empty_cache()
        ingest = phase_ingest(raw, os.path.join(work, "ingest"),
                              main_res["maskfile"])
        torch.cuda.empty_cache()
        fold = (phase_fold(raw, mwork, top) if top is not None
                else dict(ok=False))
        toas = (phase_toas(fold["pfd"], fold["best_dm"], mwork)
                if "pfd" in fold else dict(ok=False))
        torch.cuda.empty_cache()
        shard = phase_sharded(raw, os.path.join(work, "sharded"), mwork,
                              main_res)
        torch.cuda.empty_cache()
        cluster = phase_cluster(raw, os.path.join(work, "cluster"), mwork,
                                main_res["maskfile"])
        torch.cuda.empty_cache()
        read = launch_counts()
        serve = phase_serve(raw, os.path.join(work, "serve"), mwork)
        serve["launches"] = read()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    small = phase_small_reference(gen)
    small_ok = all(v["ok"] for v in small.values())
    torch.cuda.empty_cache()
    spb = phase_singlepulse()
    torch.cuda.empty_cache()
    jwork = tempfile.mkdtemp(prefix="chip_smoke_jerk_")
    try:
        jerk = phase_jerk(gen, jwork)
    finally:
        shutil.rmtree(jwork, ignore_errors=True)
    torch.cuda.empty_cache()
    live = live_phases()
    results.update(plane_build=k1, stage_reduce=k2, polish=pol,
                   main=main_res, ingest=ingest, fold=fold,
                   toas=toas, singlepulse=spb, jerk=jerk, sharded=shard,
                   cluster=cluster, serve=serve, small_reference=small,
                   **live,
                   total_s=time.time() - t_start)
    # launches: the main path's (run_survey, and run_survey on the DM
    # mesh), plus the jerk paths' (the bench search, and accelsearch
    # -wmax on the card), each counted from zero around its run
    jl = [jerk["bench"]["launches"], jerk["pulsar"]["launches"]["cuda"]]
    kernels = []
    for name, src, rep, k, jk, pk in (
            ("plane_build", "presto_tpu_torch/csrc/plane_build.cu",
             "presto_tpu/search/build_pallas.py:136", k1,
             jerk["plane_build"], jerk["pulsar"]["plane_build"]),
            ("stage_reduce", "presto_tpu_torch/csrc/stage_reduce.cu",
             "presto_tpu/search/accel_pallas.py:245", k2,
             jerk["stage_reduce_planes"],
             jerk["pulsar"]["stage_reduce_planes"])):
        by_path = {"run_survey": main_res["launches"][name],
                   "run_survey_sharded": shard["launches"][name],
                   "serve": serve["launches"][name]}
        for path, counts in zip(("jerk_bench", "accelsearch_wmax",
                                 "stream", "beams"),
                                jl + [live["stream"]["launches"],
                                      live["beams"]["launches"]]):
            by_path[path] = counts[name] + counts.get(
                "stage_reduce_planes", 0) * (name == "stage_reduce")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": sum(by_path.values()),
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"], "ok": k["ok"],
                        "bound_ms_measured_peaks": 1e3 * max(
                            k["bytes"] / serve["peaks"]["bytes_per_s"],
                            k["flops"] / serve["peaks"]["flops_per_s"]),
                        "tolerance": k["tolerance"],
                        "launches_by_path": by_path,
                        "launches_by_shard": {
                            k: r[name] for k, r in
                            shard["launches_by_shard"].items()},
                        "jerk_bench": {x: jk[x] for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        "accelsearch_wmax": {x: pk[x] for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}})
    log("results: %s" % json.dumps(results, default=float))
    failed = [n for n, ok in (("build", build["ok"]),
                              ("plane_build", k1["ok"]),
                              ("stage_reduce", k2["ok"]),
                              ("polish", pol["ok"]),
                              ("main", main_res["ok"]),
                              ("fold", fold["ok"]), ("toas", toas["ok"]),
                              ("small_reference", small_ok),
                              ("singlepulse", spb["ok"]),
                              ("jerk", jerk["ok"]),
                              ("sharded", shard["ok"]),
                              ("cluster", cluster["ok"]),
                              ("serve", serve["ok"]),
                              ("stream", live["stream"]["ok"]),
                              ("beams", live["beams"]["ok"])) if not ok]
    if failed:
        print("chip_smoke: FAILED phases: %s" % failed, file=sys.stderr)
        return 1
    log("total %.1f s" % results["total_s"])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
