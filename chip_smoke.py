"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. build   every CUDA kernel of the slice from presto_tpu_torch/csrc,
             one nvcc per source, all started together; registers and
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
  3. polish  a 128-channel 8-bit filterbank of 2^22 samples (2^21-bin
             spectra) with a strong accelerated pulsar; its DM-22 trial
             dedispersed, searched (zmax 200, numharm 8) and its
             deduplicated candidate list polished on the card (CUDA-event
             time, pairs, window taps, quadrature points) and on the CPU:
             r, z, power and sigma agree within the stated tolerances;
  4. main    the same filterbank through survey.run_survey (DDplan over
             DM 20-24: 24 trials, nsub 32, zmax 200, numharm 8): launch
             counters read around it, an ACCEL file and .cand per DM,
             stage times (head, FFT + search, polish, ACCEL writes,
             sift), the pulsar on top of the sifted list, and the DM
             curve at its polished (r, z) peaking at the injected DM;
             and a small spectrum searched on the card and on the CPU;
  5. summary the kernels line, the card, and the final ok line.

Prints the full results as one JSON line (``results: {...}``).  Imports
no JAX and nothing of the JAX package.
"""

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


def reducer_geometry(nstages):
    """(threads, rows a chunk, chunk buffers, dynamic shared memory bytes,
    CTAs an SM) of one stage_reduce instantiation, from the library."""
    import ctypes
    from presto_tpu_torch import cuda_build
    out = (ctypes.c_int * 5)()
    fn = cuda_build.load("stage_reduce").stage_reduce_info
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cuda_build.check(fn(nstages, out), "stage_reduce_info")
    return list(out)


def phase_build():
    """Build both kernels; register and spill counts per instantiation
    from nvcc's -Xptxas -v (any spill fails), and each stage_reduce
    instantiation's shared memory and CTAs an SM."""
    from presto_tpu_torch import cuda_build
    t0 = time.time()
    logs = cuda_build.build_all(["plane_build", "stage_reduce"])
    secs = time.time() - t0
    log("build: %.1f s (parallel nvcc, sm_90a)" % secs)
    usage = {}
    for name, text in logs.items():
        for fn, u in cuda_build.ptxas_usage(text).items():
            m = re.search(r"(plane_build|stage_reduce)_kernelILi(\d+)E", fn)
            key = ("%s<%s=%s>" % (m.group(1), "log2n" if m.group(1)
                                  == "plane_build" else "nst", m.group(2))
                   if m else fn)
            if m and m.group(1) == "stage_reduce":
                threads, zc, stages, smem, ctas = reducer_geometry(
                    int(m.group(2)))
                u.update(threads=threads, chunk_rows=zc, buffers=stages,
                         dynamic_smem=smem, ctas_per_sm=ctas)
            usage[key] = u
            log("  %s: %s: %s" % (name, key, json.dumps(u)))
    ok = True
    for kernel in ("plane_build", "stage_reduce"):
        inst = {k: u for k, u in usage.items() if k.startswith(kernel + "<")}
        spills = sorted(k for k, u in inst.items()
                        if u.get("spill_stores", 1) or u.get("spill_loads", 1))
        kok = len(inst) == 5 and not spills
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


def plane_case(s, nbins, gen, label):
    """The plane builder at one searcher's geometry (forward spectra of a
    random spectrum through the searcher's own windows, normalization
    and FFT, and its kernel bank): kernel against plain, pads, times
    (kernel: 10 launches after a warm-up; plain and library: 3), bound,
    and the library call (torch.fft.ifft + abs^2 over the same product)
    where device memory allows it."""
    from presto_tpu_torch.search import build_cuda
    pairs = torch.randn((nbins, 2), generator=gen, device="cuda")
    S = s.forward_spectra(pairs)
    del pairs
    Kc = s._kbank
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
    nbytes = (S.numel() * 8 + Kc.numel() * 8
              + build_cuda._twiddle_table(n, "cuda").numel() * 8
              + s.numz_pad * numr * 4)
    flops = nblocks * numz * (6 * n + 5 * n * np.log2(n)
                              + 3 * s.cfg.uselen)
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
                bound_by=by), S


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
    out.update(ok=out["ok"] and out["zmax400"]["ok"] and rok,
               ragged_err=rerr,
               tolerance="max|kernel-plain| <= 1e-4 * max|plain|")
    return out, S


def reducer_design_bytes(zinds, nrows, slab, nslabs, nstages):
    """Bytes the stage reducer reads from device memory for these inputs,
    from its geometry (stage_reduce.cu: Geo<NST>, term_cap, term_width):
    each column's own rows, and per tile and chunk each term's staged
    window rows in 16-byte units, or, in a chunk over a window's row
    capacity, the 32-byte sectors of its direct reads; plus the z maps
    and the outputs."""
    threads, zc, _stages, _smem, _ctas = reducer_geometry(nstages)
    z = zinds.cpu().numpy()
    terms = [(h, 1 << st) for st in range(1, nstages)
             for h in range(1, 1 << st, 2)]
    caps = [-(-(zc - 1) * h // t) + 2 for h, t in terms]
    wide = [-(-(threads - 1) * h // t) + 1 for h, t in terms]
    per_tile = nrows * threads * 4
    for z0 in range(0, nrows, zc):
        rows = min(zc, nrows - z0)
        n = [int(zi[z0 + rows - 1] - zi[z0]) + 1 for zi in z]
        if any(ni > c for ni, c in zip(n, caps)):
            per_tile += sum(rows * (w // 8 + 2) * 32 for w in wide)
        else:
            per_tile += sum(ni * 16 * -(-(w + 3) // 4)
                            for ni, w in zip(n, wide))
    tiles = nslabs * -(-slab // threads)
    return tiles * per_tile + z.nbytes + 2 * nslabs * nstages * slab * 4


def reducer_bound(plane, scols, zinds, slab, nst):
    """The stage reducer's bound on these inputs: the plane, start
    columns and z maps read once, colmax and colz written once; one add
    a term and one compare a stage per plane element of the slabs.
    Returns (ms, "bytes" or "operations", bytes)."""
    nterms = (1 << (nst - 1)) - 1
    ncols = scols.numel() * slab
    nbytes = (plane.numel() + scols.numel() + zinds.numel()) * 4 \
        + 2 * scols.numel() * nst * slab * 4
    ms, by = bound_ms(nbytes, ncols * plane.shape[0] * (nterms + nst))
    return ms, by, nbytes


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
    bms16, by16, _ = reducer_bound(plane, scols, z16, slab, 5)
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
    bms, by, nbytes = reducer_bound(plane, scols, s._zinds, slab, nst)
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
                bound_by=by, design_bytes=design, design_share=share,
                numharm16=dict(ok=ok16, max_abs_err=err16, ms=ms16,
                               bound_ms=bms16, bound_by=by16,
                               design_bytes=bytes16),
                collect_ms=collect_ms,
                tolerance="exact (same float32 add order)")


def synth_filterbank(path, gen, N, nchan, dt, lofreq, cw, f0, fdot, dm,
                     width):
    """Seeded 8-bit filterbank made on the card: gaussian pulses (fwhm
    ``width`` turns) dispersed by the cold-plasma delay, baseline 32, noise
    sigma 6, quantized x4 like models/synth.fake_filterbank_file."""
    from presto_tpu_torch.io.sigproc import FilterbankHeader, write_filterbank
    from presto_tpu_torch.ops.dedispersion import delay_from_dm
    freqs = lofreq + np.arange(nchan) * cw
    delays = delay_from_dm(dm, freqs)
    delays = torch.tensor(delays - delays.min(), dtype=torch.float64,
                          device="cuda")
    out = torch.empty((N, nchan), dtype=torch.uint8, device="cuda")
    sig = width / 2.35482
    step = 1 << 20
    for t0 in range(0, N, step):
        t = (torch.arange(t0, min(N, t0 + step), device="cuda",
                          dtype=torch.float64) + 0.5) * dt
        tc = t[:, None] - delays[None, :]
        ph = torch.remainder(f0 * tc + 0.5 * fdot * tc * tc, 1.0)
        pulse = torch.exp(-0.5 * ((ph - 0.5) / sig) ** 2).float()
        x = 32.0 + 1.0 * pulse + 6.0 * torch.randn(
            pulse.shape, generator=gen, device="cuda")
        out[t0:t0 + t.shape[0]] = torch.clamp(torch.round(x * 4.0),
                                              0, 255).to(torch.uint8)
    hdr = FilterbankHeader(source_name="FAKEPSR", machine_id=10,
                           telescope_id=6, fch1=lofreq + (nchan - 1) * cw,
                           foff=-cw, nchans=nchan, nbits=8,
                           tstart=59000.0, tsamp=dt, nifs=1,
                           rawdatafile=os.path.basename(path))
    write_filterbank(path, hdr, out.cpu().numpy())


# the beam of the polish and main phases: 537 s of 128 channels x 3 MHz
# at 1214-1595 MHz; 0.5 ms pulses of a 40.3 Hz pulsar at DM 22 with
# fdot 1.4e-4 Hz/s.  One DM step (0.2) smears 0.24 ms across the band, so
# the sigma curve is flat to noise within ~0.4 of the true DM and the
# best single trial may sit two steps off; the DM is read from the
# curve's parabola peak, within one step
BEAM = dict(N=1 << 22, nchan=128, dt=1.28e-4, lofreq=1214.0, cw=3.0,
            f0=40.3, fdot=1.4e-4, dm=22.0, width=0.02)
BEAM_SEED = 22


def make_beam(workdir):
    """The seeded beam, made on the card from its own seed, so the data
    do not depend on what the kernel phases drew."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(BEAM_SEED)
    raw = os.path.join(workdir, "psr.fil")
    b = BEAM
    synth_filterbank(raw, gen, b["N"], b["nchan"], b["dt"], b["lofreq"],
                     b["cw"], b["f0"], b["fdot"], b["dm"], b["width"])
    return raw


def polish_agreement(card, cpu):
    """Card against CPU, per candidate: r within 2e-3 bins, z within
    1e-2; power rtol 1e-4 and sigma within 1e-3 where both picked the
    same grid point, rtol 1e-3 and 1e-2 where an argmax near-tie moved
    one of them by a final-stage step.  Returns (ok, moved, worst)."""
    ok, moved = len(card) == len(cpu), 0
    worst = dict(r=0.0, z=0.0, power_rel=0.0, sigma=0.0)
    for a, b in zip(cpu, card):
        dr, dz = abs(a.r - b.r), abs(a.z - b.z)
        same = dr < 1e-9 and dz < 1e-9
        moved += not same
        dp = abs(a.power - b.power) / abs(a.power)
        ds = abs(a.sigma - b.sigma)
        ok = (ok and a.numharm == b.numharm and dr <= 2e-3 and dz <= 1e-2
              and dp <= (1e-4 if same else 1e-3)
              and ds <= (1e-3 if same else 1e-2))
        for k, v in (("r", dr), ("z", dz), ("power_rel", dp), ("sigma", ds)):
            worst[k] = max(worst[k], v)
    return ok, moved, worst


def phase_polish(raw, workdir):
    """One DM's deduplicated candidate list (the injected DM's trial,
    dedispersed, FFT'd and searched on the card) polished on the card,
    timed with CUDA events after a warm-up call, and on the CPU with the
    plain PyTorch path; the two agree within polish_agreement's
    tolerances."""
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
    ok, moved, worst = polish_agreement(card, cpu)
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
               peak_gb=peak_gb, moved=moved, worst=worst,
               tolerance="r 2e-3 bins, z 1e-2; power rtol 1e-4, sigma "
                         "1e-3 (same grid point), 1e-3 / 1e-2 (moved)")
    log("polish (DM %.1f): %d raw -> %d candidates, %d pairs %s, W %d, "
        "npts %d, %d complex exponentials a pair; card %.3f ms (CUDA "
        "events; host %.3f s, peak %.2f GB), CPU %.2f s; %d candidates "
        "moved by a near-tie, worst %s %s"
        % (BEAM["dm"], len(raw_c), len(cands), res["pairs"],
           res["numharm_counts"], W, npts, res["cexp_per_pair"], card_ms,
           card_s, peak_gb, cpu_s, moved, json.dumps(worst),
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
    cfg = survey.SurveyConfig(lodm=20.0, hidm=24.0, nsub=32, zmax=200,
                              numharm=8, skip_rfifind=True,
                              singlepulse=False, fold_top=0,
                              durable_stages=True)
    timer = StageTimer()
    build_cuda.launches = 0
    accel_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res = survey.run_survey([raw], cfg, workdir, timer=timer, device="cuda")
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = {"plane_build": build_cuda.launches,
                "stage_reduce": accel_cuda.launches}
    ndms = len(res.datfiles)
    st = timer.stages
    fused = st["realfft+accelsearch (fused)"]
    stages = dict(run_survey_s=total_s, survey_head_s=st["prepsubband"],
                  fused_s=fused, polish_s=st["polish"],
                  polish_per_dm_s=timer.samples["polish"],
                  accel_writes_s=st["accel writes"], sift_s=st["sift"],
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
    ok = (abs(peak_dm - b["dm"]) <= 0.21 and top_ok and files_ok
          and nbins == 1 << 21
          and all(v == ndms > 0 for v in launches.values()))
    return dict(ok=ok, ndms=ndms, nbins=nbins, stages=stages,
                launches=launches, dm_curve=curve, dm_curve_peak=peak_dm,
                polished_sigma_curve=sig_curve,
                sifted=len(res.sifted), top_freq=f,
                top_sigma=top.sigma if top else None,
                top_dm=top.DM if top else None,
                top_hits=len(top.hits) if top else 0)


def phase_small_reference(gen):
    """A small spectrum searched on the card and by the plain versions
    on the CPU: the strong candidates' keys agree, powers within 1e-4."""
    from presto_tpu_torch.search import accel
    n = 1 << 16
    t = np.arange(n) * 1e-3
    rng = np.random.default_rng(5)
    x = rng.normal(size=n) + 0.1 * np.cos(2 * np.pi * (37.3 * t
                                                       + 0.002 * t * t))
    full = np.fft.rfft(x)
    packed = full[:-1].copy()
    packed[0] = full[0].real + 1j * full[-1].real
    pairs = np.stack([packed.real, packed.imag], -1).astype(np.float32)
    cfg = accel.AccelConfig(zmax=20, numharm=8, sigma=3.0)
    res = {}
    for dev in ("cuda", "cpu"):
        s = accel.AccelSearch(cfg, T=n * 1e-3, numbins=n // 2, device=dev)
        res[dev] = s.search(pairs)
    key = lambda c: (c.numharm, round(2 * c.r), round(2 * c.z))  # noqa
    strong = {key(c): c.power for c in res["cpu"]
              if c.power > 1.01 * s.powcut[int(np.log2(c.numharm))]}
    got = {key(c): c.power for c in res["cuda"]}
    ok = bool(strong) and all(
        k in got and abs(got[k] - p) <= 1e-4 * p for k, p in strong.items())
    log("small reference: %d strong CPU candidates, card list %d, agree %s"
        % (len(strong), len(got), ok))
    return ok


def main():
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
        main_res = phase_main(raw, os.path.join(work, "main"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    small_ok = phase_small_reference(gen)
    results.update(plane_build=k1, stage_reduce=k2, polish=pol,
                   main=main_res, small_reference_ok=small_ok,
                   total_s=time.time() - t_start)
    kernels = []
    for name, src, rep, k in (
            ("plane_build", "presto_tpu_torch/csrc/plane_build.cu",
             "presto_tpu/search/build_pallas.py:136", k1),
            ("stage_reduce", "presto_tpu_torch/csrc/stage_reduce.cu",
             "presto_tpu/search/accel_pallas.py:245", k2)):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": main_res["launches"][name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"], "ok": k["ok"],
                        "tolerance": k["tolerance"]})
    log("results: %s" % json.dumps(results, default=float))
    failed = [n for n, ok in (("build", build["ok"]),
                              ("plane_build", k1["ok"]),
                              ("stage_reduce", k2["ok"]),
                              ("polish", pol["ok"]),
                              ("main", main_res["ok"]),
                              ("small_reference", small_ok)) if not ok]
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
