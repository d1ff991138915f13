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
             the (DM, p, pd) search at -npfact 1 on the card (a 257 x
             257 (p, pd) plane; the default npfact 2's 513 x 513 is cut
             for the script's time, the CPU's search of it taking ~4x
             longer): the best DM
             within two grid steps of the injected, and the same cube
             searched on the CPU (chi2 surfaces and best trial);
  6. toas    get_TOAs (-n 8 -d <best DM>) on that fold, on the card and
             on the CPU: 8 TOAs whose phases under the injected (f0,
             fdot) agree within their errors, and the two agree;
  6a. short  the short beam, the beam's first 2^19 spectra
             (SHORT_SPECTRA), through run_survey with the main
             configuration: the reference run of phases 6b-6f and 6h,
             which take the short beam and hold their files to it (on
             the whole beam they took ~400 s of the script); phase 6l
             injects its pulsar into it;
  6b. sharded  torch.cuda.device_count() printed; the short beam through
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
             method on the short beam: through -coordinator (gloo; each
             writes its own
             rows), then through -elastic with one killed at a shard's
             commit point, the survivor finishing; every .dat of both
             byte-equal to the unsharded run's;
  6d. serve  survey jobs on the port's SearchService, four services on
             one plan store, on the short beam with the main phase's
             configuration, each job's .dat, .singlepulse, ACCEL files,
             cands_sifted.txt and .pfd equal to phase 6a's: two POST
             /submit specs run as one stacked batch (one schedule event
             of occupancy 2, no degrade); then, each prewarmed from the
             store
             (warm fraction 1.0, plan hits, no plan build), two jobs one
             after the other (stacked=False), two jobs as one stacked
             batch again (the pair timed against the pair alone, both
             warm), and one job over a mesh of two logical shards of the
             card (each shard's plane_build and stage_reduce launches);
             metrics() with the kernel cost book; the card's roofline
             peaks measured beside the nominal ones; a smoke-shape
             tuning sweep into a DB, read back through tune.best;
  6e. fleet  a discovery DAG of the short beam (search -> sift ->
             triage -> 2 folds -> toa, the main configuration; "the main
             run" below is phase 6a's) POSTed to the
             port's router (in this process, loopback HTTP) with
             weights from presto-triage train --synthetic on the card;
             two replica processes (python3 -m
             presto_tpu_torch.apps.serve -fleet), the one that leases
             the search node SIGKILLed, the other finishing: every node
             done once (one usage row, one result.json, redos 1 on the
             search node), the search node's files and both
             cands_sifted.txt byte-equal to the main run's, the triage
             selection equal to TriagePolicy.select over the main run,
             each .pfd byte-equal to a CPU refold and to the main run's
             fold of the same candidate, one TOA a fold, the committed
             counter over the snapshots equal to the survivor's commits,
             both kernels launched by it; times from usage.jsonl, /scale
             and /fleet/metrics printed;
  6f. federation  two supervised fleets behind the port's federation
             router (in this process, loopback HTTP): each fleet the
             port's router and presto-supervise (1-2 replica processes
             on the card) as processes of their own; survey job J1 of
             the short beam (the main configuration) placed on fleet A
             (it holds the beam), A's router, supervisor and replica
             SIGKILLed once A's replica leases J1, J1 re-admitted on B,
             J2 after it so that B's /scale wants 2 and B's supervisor
             spawns a second replica, then drains it by SIGTERM when
             idle: each job committed once by the federation, its files
             equal to the short phase's run, the committed counter over B's
             snapshots 2, the supervisor events carrying the advisory
             inputs, /fed, /fleet/metrics, /slo, /usage and /scale
             answering, presto-report -fleet rendering B's supervisor
             timeline, the phase's times as one perf-ledger episode read
             back by the federation's pricing by the card's fingerprint;
             presto-tune --families accel_column_slab into a temporary
             DB keyed by the card's fingerprint, --device-report listing
             it; kill to re-admit, spawn to up and admit to done timed;
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
             phase 2); a jerk pulsar (2^20 samples) through accelsearch
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
 11. beams   13 beams of that geometry (3 blocks each) through
             BeamMultiplexer, fed as fast as the rings take them, with the
             veto off (each beam's triggers equal to an independent
             StreamSearch's, its stacked series bit-equal to that one-beam
             carry's on every tick, stacked steps <= ticks) and with
             coincidence_k=3 (the burst in every beam vetoed, beam 0's
             pulse kept); the kernels of one tick (torch.profiler) equal
             at 1 and 13 beams; the stacked step's device ms at 13 beams
             beside 13 one-beam steps; the real-time factor;
  6g. recipe  the survey as users run it: the beam's samples under a
             header with the Crab's position (GBT, MJD 59000), GBNCC's
             recipe (the default zaplist, the lo pass zmax 0 / numharm 16
             / flo 2 and the hi pass zmax 50 / numharm 8 / flo 1, its sift
             policy; its 20 + 10 fold caps cut to 6 + 3) through
             run_survey with bary=True
             and durable stages over DM 20-24: launches read around it
             (2 passes x 24 trials); every .inf barycentred at the plan's
             epoch; every .dat/.inf byte-equal to a staged prepsubband on
             the card (no -nobary, the survey's mask); for two DMs the
             spilled .fft equal to the card's rFFT of the .dat batch,
             downloaded and zapped by zap_pairs_batch; an injected
             pulsar first in cands_sifted.txt, the 40.3 Hz pulsar's
             strongest sifted candidate within one trial of DM 22, and
             its DM-22 hi-pass candidate within RECIPE_FREQ_TOL_BINS of
             f (1 + avgvoverc); the folds
             within the caps; both kernels against their plain versions
             at the two passes' geometries on the DM-22 spectrum (each
             bound counts the plane's numz real rows, not its zero pad
             rows); the stage times, with the host resample and zap as
             run_survey's StageTimer booked them;
  6h. psrfits  the short beam's samples as two PSRFITS files (the
             port's write_psrfits: 2^18 spectra each, rows of 2048, the
             .fil's descending band, unit scales): the reader's stitched
             length (2^19) and clean quality ledger; run_survey on the
             pair with the main configuration, launches read around it
             (24 + 24), its 24 .dat, .mask arrays, ACCEL tables and .cand
             files, sifted list and three folds' profile cubes equal to
             phase 6a's .fil run, its rfifind and head beside 6a's; the
             PSRFITS ingest's host ms a 2^17-spectrum block
             (read_spectra, the copy into a pinned buffer); prepsubband
             -sub -subdm 22 on the pair and on the .fil, the .sub####
             files byte-equal; prepfold -psrfits -mask -ignorechan 90
             -nosearch of a.fits at the top candidate, its .pfd equal to
             the CPU's; psrfits2fil of the pair, its samples the .fil's;
  6i. classic  the reference's documented command flow through the
             port's CLIs on the card (phase_classic): prepdata -dm 22 of
             the beam barycentred, its .dat/.inf byte-equal to the CPU's,
             with its ingest wait and dedispersion device ms a block;
             realfft in core (card) and -disk (host, out of core, many
             slabs a pass), the spectra within CLASSIC_RTOL of the RMS
             and, of the mean-free series, bin by bin of max(|X_k|,
             RMS),
             realfft -inv back to the .dat within it; accelsearch on the
             .fft (launches read around it) with the 40.3 Hz pulsar at f
             (1 + avgvoverc), both kernels held to their plain versions
             at its geometry; prepfold -par -nosearch (peak within a bin
             of the -f/-fd fold, reduced chi2 >= FOLD_REDCHI_MIN),
             -timing (accepted by pfd_for_timing) and -absphase;
             prepfold -psr J0737-3039A on a barycentred series of the
             binary made on the card (its (p, pd) search at -npfact 1,
             as the fold phase's), card against CPU by the fold
             phase's chi2 rule, reduced chi2 >= FOLD_REDCHI_MIN with the
             catalog's orbit and under it without (the same search at
             the catalog's f and fd);
  6j. binary  the binary searches through the port's CLIs
             (phase_binary): a 2^22-sample series of a 200 Hz pulsar in a
             400 s orbit (modulation index 25 rad), realfft on the card;
             search_bin at its defaults over the whole spectrum (the
             miniFFT programs' device ms a window size, the host share),
             its top candidate within 10% of Pb and 5% of 1/f; search_bin
             over 2^18 bins on the card and the CPU, the lists held by
             bincands_agreement (ties logged); bincand from a perturbed
             trial on the card and the CPU (the same grid orbit each
             round, Pb within 5%, x within 25%) and -candfile on the top
             candidate; monte_binresp at the JAX package's campaign test,
             launches read around it, both kernels held to their plain
             versions at its geometry; quicklook's top peak within the
             signal's bandwidth;
  6k. plots   the .pfd plots' numbers on the card (phase_plots): every
             .pfd of the main survey's directory (its three folds and the
             fold phase's, with its DM curve and 257 x 257 P-Pdot
             plane) through plotting/pfdplot.pfd_panels on the card and
             on the CPU, the plane and DM curve within PLOTS_RTOL of their
             maximum, the growth curve within PLOTS_GROWTH_RTOL; the
             plane's call timed by CUDA events; launches read around it
             (no kernel of the port runs there: 0 and 0); prepfold
             without -noplot raising ImportError naming matplotlib before
             any work (the card's machine has none); within
             PLOTS_BUDGET_S;
  6l. tools   the last host tools (phase_tools): tests/test_referee.py's
             spectrum (2^19 bins, four chirped tones) searched by
             AccelSearch on the card and held by search/accel_ref
             .agreement to the float64 referee on the host; injectpsr of
             a 17.3 Hz pulsar at DM 23 into the short beam at full width,
             then
             prepdata, realfft and accelsearch -zmax 0 on the card and
             triage/calibrate's labels on the sifted candidates (the
             injected pulsar labelled; the short beam alone, the control,
             labelled by nothing at the search's resolution); launches
             read around the referee's two searches and the two
             accelsearch runs; both kernels against their plain versions
             at the referee's geometry (zmax 100, numharm 8) and at
             accelsearch -zmax 0 -numharm 8's on the injected .fft; the
             host CLIs on the main survey's files (readfile,
             rfifind_stats, ddplan, dat2tim -> tim2dat byte-equal,
             downsample, quick_prune_cands, powerstats, dftfold,
             rednoise) exiting 0, and quickffdots raising
             ImportError naming matplotlib within 1 s; within
             TOOLS_BUDGET_S;
  6m. devtools the port's developer tools (phase_devtools):
             apps/profile_accel at the headline (bench.py's spectrum,
             2^21 bins, zmax 200, numharm 8, T 1000 s; 5 reps): the
             stage split (build, scan, collect, d2h, host collect, e2e,
             cells/s) beside each stage's bound, its candidate list equal
             to AccelSearch.search's and the three tones found;
             apps/perf_gate --measure three times into a ledger of the
             phase's directory (the first seeds and passes, the others
             are gated and their verdicts reported, not required; on the
             card its samples are device time, CUDA events around calls
             queued behind a spin kernel) and --inject-slowdown 2.0
             exiting 1, each episode's MAD as a share of its median
             printed (and the host clock's beside it) with the
             injection's delta and threshold; launches read around those
             two tools; both kernels against their plain versions at the
             headline's geometry and at perf_gate's smoke geometry (2^15
             bins, zmax 20, numharm 2); `python -m
             presto_tpu_torch.apps.presto_lint --json` over the checkout
             exiting 0 (no JAX on the card's machine); within
             DEVTOOLS_BUDGET_S;
  6n. target  one card's share of the target-scale plan (phase_target);
  6o. loadgen the load generators (phase_loadgen): apps/serve_loadgen's
             run_loadgen against a SearchService on the card (-selfhost)
             with 4 beams of make_beams at 128 channels x 2^20 spectra
             at 2 jobs/s, every job done, jobs/s and job_total p50/p99;
             both kernels against their plain versions at its jobs'
             geometry (zmax 0, numharm 4) on the first beam's spectrum
             at DM 55 (prepdata -nobary on the card); -replicas 2
             -subprocess at the tool's defaults (both replica processes
             up on the card, every job done, the
             replicas' launches from their snapshots); -stacked -Ns 1,4
             (PASS: byte-equal digests, fewer dispatches stacked,
             compiles no greater); apps/stream_loadgen paced at 8x real
             time at 128 channels in the live beam's 8192-spectrum
             blocks (LOADGEN_STREAM; every pulse triggered once, none
             unmatched, no drop, latency p50/p99) and --beams 4
             (byte_equal, o1_dispatch, the veto); launches read around
             the serve modes; within LOADGEN_BUDGET_S.  The verdict
             modes -dag, -obs, -slo, -supervisor and -campaign, the
             in-process fleet, -stacked at -Ns 1,4,8 and the paced
             stream at the CLI's defaults (64 channels) run with
             --loadgen-only;
  6p. chaos  the chaos drivers (phase_chaos), each with its checks:
             apps/chaos_survey's first trial of seed 0 (its kill
             schedule, kills that fired and corruptions printed; every
             comparable artifact byte-equal to the uninterrupted run) at
             the beam's 128 channels over 2^15 spectra (CHAOS_SURVEY;
             the tool's 2^13 x 16 otherwise); apps/multihost_chaos's
             seed-4 trial, the stall mode (two prepsubband processes on
             the card at 128 channels, every .dat byte-equal to the
             one-process reference, the ledger's epoch >= 1 and redos
             printed); apps/stream_chaos's stall, truncation, ring-drop
             and beam-handoff trials, each PASS; apps/fleet_chaos's
             classic seed-1 trial, killed at job-enqueued (every job done
             once, digests byte-equal, the zombie's late commit fenced);
             apps/fed_chaos's partition-zombie trial (every item once on
             the survivor, the zombie fenced, the epoch bumped, digests
             byte-equal), in a thread beside the other four; launches
             read around the five (the fed replicas' from their
             snapshots); both kernels against their
             plain versions at chaos_survey's geometry (zmax 0, numharm
             2) on its beam's spectrum at DM 10; within CHAOS_BUDGET_S.
             Every driver at the JAX tools' defaults (chaos_survey
             --trials 5, the six stream trials, multihost_chaos --trials
             3, fleet_chaos -trials 3 -supervisor, -dag and -campaign,
             the last also at -observations 16, fed_chaos -trials 2
             -verdict) runs with --chaos-only;
 12. summary the kernels line (launches of the main path, the sharded
             main path, by shard too, the serve path, the fleet path, the
             federation path (A's last snapshot and B's replicas'), the
             tune sweep, the recipe path, the psrfits path, the classic
             path, the monte path, the plots path (0), the tools path, the
             devtools, target, loadgen and chaos paths, the jerk paths and
             the live paths; each
             kernel's bound also at the measured peaks, and its numbers at
             the recipe's two pass geometries, at the classic
             accelsearch's, at monte's, at the tools phase's two and at
             the devtools phase's two, at the target share's, at the
             loadgen's and at the chaos phase's), the card, and the final
             ok line.

Prints the full results as one JSON line (``results: {...}``).  Imports
no JAX and nothing of the JAX package.  ``--live-only`` runs phases 10 and
11 alone (no build, no kernels line, no final ok line); ``--target-only``
and ``--loadgen-only`` build the kernels and run phase 6n, or phase 6o
with every mode of both load generators to its verdict, alone
(``--loadgen-records DIR`` writes the verdict reports under DIR).
``--chaos-only`` builds the kernels and runs phase 6p, then every chaos
driver at the JAX tools' defaults, alone (``--chaos-records DIR`` writes
their reports under DIR).
``--keep-recipe-cands DIR`` writes the recipe phase's sift input (ACCEL
tables, .cand and .inf files) and cands_sifted.txt to
DIR/recipe_cands.tar.xz.
"""

import argparse
import copy
import glob
import hashlib
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
    # the bound writes only the numz rows the search reads; the kernel
    # also writes the zero pad rows up to numz_pad (7 of 8 at zmax 0)
    nbytes, flops = costmodel.plane_build_work(nblocks, numz, n,
                                               s.cfg.uselen, numz, numr)
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


def reducer_bound(plane, scols, zinds, slab, nst, numz):
    """The stage reducer's bound on these inputs: the plane's numz real
    rows (not its zero pad rows), the start columns and those rows' z
    maps read once, colmax and colz written once; one add a term and one
    compare a stage per real plane element of the slabs
    (obs/costmodel.stage_reduce_work).  Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    from presto_tpu_torch.obs import costmodel
    nbytes, flops = costmodel.stage_reduce_work(
        numz, plane.shape[1], scols.numel(), slab, nst,
        zinds.shape[0] * numz)
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
    plain16 = cuda_time_ms(
        lambda: accel_cuda.reduce_stages_plain(*args16), 1)
    bytes16 = reducer_design_bytes(z16, plane.shape[0], slab,
                                   len(start_cols), 5)
    bms16, by16, _, _ = reducer_bound(plane, scols, z16, slab, 5,
                                      c16.numz)
    log("stage_reduce numharm 16 (5 stages) on the bench plane: "
        "max_abs_err %.3g, colz equal %s; kernel %.3f ms, plain %.3f ms, "
        "bound %.3f ms (%s), design bytes %.3f GB (%.1f%% of 3.35 TB/s) %s"
        % (err16, ok16, ms16, plain16, bms16, by16, bytes16 / 1e9,
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
                                           nst, s.cfg.numz)
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
                               plain_ms=plain16, library_ms=None,
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
    with FoldClock("cuda") as clock, IngestWait() as wait:
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
    log("main: ingest consumer wait per app (host s, IngestWait): %s"
        % json.dumps(wait.by_app))
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
                singlepulse=sp, ingest_wait=wait.by_app,
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


class IngestWait:
    """While installed, the host seconds the consumer of each streamed
    pass (pipeline/fusion.DoubleBufferedIngest) waits for its next
    block, and the blocks it pulls, summed per app that drives the pass
    (the first frame outside fusion and contextlib: rfifind, the survey
    head's prepsubband, prepfold's raw fold).  A wait near zero means
    the ingest worker keeps ahead of the device loop; the worker's own
    decode time is then hidden behind it.  A pass pulls its blocks and
    one end marker."""

    def __init__(self):
        self.by_app = {}

    def __enter__(self):
        from presto_tpu_torch.pipeline import fusion
        cls = fusion.DoubleBufferedIngest
        self._saved = (cls, cls.__init__, cls.__next__)
        orig_init, orig_next = cls.__init__, cls.__next__
        by_app = self.by_app

        def init(ing, *a, **k):
            f = sys._getframe(1)
            while f is not None and f.f_globals.get("__name__") in (
                    fusion.__name__, "contextlib"):
                f = f.f_back
            name = (f.f_globals.get("__name__", "?") if f is not None
                    else "?").rsplit(".", 1)[-1]
            ing._wait = by_app.setdefault(name, dict(wait_s=0.0, pulls=0,
                                                     passes=0))
            ing._wait["passes"] += 1
            orig_init(ing, *a, **k)

        def next_(ing):
            t0 = time.perf_counter()
            try:
                return orig_next(ing)
            finally:
                ing._wait["wait_s"] += time.perf_counter() - t0
                ing._wait["pulls"] += 1
        cls.__init__, cls.__next__ = init, next_
        return self

    def __exit__(self, *exc):
        cls, cls.__init__, cls.__next__ = self._saved


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


# the (p, pd) search half-width of the fold phase's and the classic
# -psr folds, in units of proflen / 2 steps: 1 gives a 257 x 257 plane at
# 128 bins, where prepfold's default 2 gives 513 x 513 (the CPU's search
# of it, the plots phase's CPU panels of it and the CPU's -psr fold took
# 29-38 s, 30-48 s and 28 s of the script)
FOLD_NPFACT = 1


def phase_fold(raw, workdir, top, device="cuda"):
    """prepfold on the filterbank at the top sifted candidate
    (-accelfile -accelcand -dm, the DM, p and pd search at -npfact
    FOLD_NPFACT) on ``device``: the best DM within two grid steps of the
    injected; the same pre-search cube searched again on the CPU, chi2
    surfaces within CHI2_ATOL of their maximum and the same best (DM, f,
    fd) indices unless a near-tie is logged."""
    from presto_tpu_torch.apps import prepfold as app
    from presto_tpu_torch.search import prepfold as spf
    acc = os.path.join(top.path or workdir, top.filename)
    out = os.path.join(workdir, "fold_fil")
    argv = ["-accelfile", acc + ".cand", "-accelcand", str(top.candnum),
            "-dm", "%.2f" % top.DM, "-npfact", str(FOLD_NPFACT), "-noplot",
            "-o", out, raw]
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
# seed 17) at 2^20 samples of 1 ms (cut from 2^21 for the script's time:
# its S/N, amp x sqrt(N), stays 1.4x the test's at 2^15 samples and amp
# 0.6); searched at that test's zmax 60, wmax 80, numharm 2 on the card
# and on the CPU.
JERK_PSR = dict(N=1 << 20, dt=1e-3, f0=7.37, z=10.0, w=60.0, amp=0.15,
                width=0.1, seed=17,
                argv=["-zmax", "60", "-wmax", "80", "-numharm", "2",
                      "-sigma", "5.0"])


def reducer_planes_bound(planes, scols, zinds, slab, nst, numz):
    """The multi-plane reducer's bound on these inputs: each distinct
    plane read once over the cells the sums of its numz real rows name
    (planes[0]: those rows at the slabs' columns; term i's plane: the
    rows of their z map at the columns round_half_up(j h / htot)), the
    start columns and those rows' z maps once, colmax and colz written
    once; one add a term and one compare a stage per real plane element
    of the slabs.  Returns (ms, "bytes" or "operations", bytes)."""
    from presto_tpu_torch.search import accel_cuda
    nrows, numr = planes[0].shape
    sc = scols.cpu().numpy().astype(np.int64)
    cols = np.unique((sc[:, None] + np.arange(slab)[None]).ravel())
    z = zinds.cpu().numpy()
    # per distinct plane: [(rows named, columns named)] of its reads
    reads = {planes[0].data_ptr(): [(np.arange(nrows) < numz, cols)]}
    for i, (h, t) in enumerate(accel_cuda.stage_terms(nst)):
        rows = np.zeros(nrows, bool)
        rows[z[i][:numz]] = True
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
    nbytes = (cells + scols.numel() + zinds.shape[0] * numz) * 4 \
        + 2 * scols.numel() * nst * slab * 4
    nterms = (1 << (nst - 1)) - 1
    ms, by = bound_ms(nbytes, sc.size * slab * numz * (nterms + nst))
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
    bms, by, nbytes = reducer_planes_bound(planes, scols, s._zinds, slab,
                                           nst, s.cfg.numz)
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


# the short beam: the main beam's first 2^19 spectra (67 s), through
# run_survey with the main configuration in phase_short; the sharded,
# cluster, serve, fleet, federation and psrfits phases run it and hold
# their files to that run (on the whole beam they took ~400 of the
# script's 917-1047 s; the federation ~84 s; the beam's first 2^20
# spectra until the chaos phase came), and the tools phase injects its
# pulsar into it
SHORT_SPECTRA = 1 << 19


def short_beam(raw, path, nspectra):
    """The first ``nspectra`` spectra of a filterbank, its header kept."""
    from presto_tpu_torch.io.sigproc import FilterbankFile
    with FilterbankFile(raw) as fb:
        start = fb.header.headerlen
        nbytes = nspectra * fb.header.nchans * fb.header.nbits // 8
    with open(path, "wb") as out, open(raw, "rb") as src:
        out.write(src.read(start))
        out.write(src.read(nbytes))
    return path


def phase_short(raw, workdir, device="cuda"):
    """The short beam (``psr.fil`` in ``workdir``) through run_survey with
    the main configuration into ``workdir``/reference: the reference run
    of the later phases that take the short beam (its stage times as
    phase_main's, its mask, its 24 DMs and three folds)."""
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.utils.timing import StageTimer
    os.makedirs(workdir, exist_ok=True)
    beam = short_beam(raw, os.path.join(workdir, "psr.fil"), SHORT_SPECTRA)
    ref = os.path.join(workdir, "reference")
    timer = StageTimer()
    t0 = time.time()
    with IngestWait() as wait:
        res = survey.run_survey([beam], main_cfg(), ref, timer=timer,
                                device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    total_s = time.time() - t0
    st = timer.stages
    fused = st["realfft+accelsearch (fused)"]
    stages = dict(run_survey_s=total_s, rfifind_s=st["rfifind"],
                  survey_head_s=st["prepsubband"],
                  single_pulse_s=st["single_pulse"], fused_s=fused,
                  polish_s=st["polish"], accel_writes_s=st["accel writes"],
                  sift_s=st["sift"], prepfold_s=st["prepfold"],
                  fft_search_s=fused - st["polish"] - st["accel writes"])
    ndms = len(res.datfiles)
    ok = ndms == 24 and len(res.folded) == 3 and len(res.sifted) >= 3
    log("short: the beam's first %d spectra through run_survey %.1f s "
        "(%d DMs, %d sifted, %d folds), the reference of the sharded, "
        "cluster, serve, fleet, federation and psrfits phases %s"
        % (SHORT_SPECTRA, total_s, ndms, len(res.sifted), len(res.folded),
           "ok" if ok else "FAIL"))
    return dict(ok=ok, beam=beam, reference=ref, maskfile=res.maskfile,
                ndms=ndms, stages=stages, ingest_wait=wait.by_app,
                spectra=SHORT_SPECTRA)


def phase_sharded(raw, workdir, mwork, main_res):
    """The beam ``raw`` through survey.run_survey on a DM mesh with the
    main phase's configuration: every card, or SHARDS_ON_ONE_CARD logical
    shards of cuda:0 on a one-card machine (they share its memory and
    stream: the per-shard programs and the placement are shown, not a
    speed-up).  Launch counters read around it, per shard
    (parallel/sharded.shard_launches) and per device (each wrapper
    counts its launches by the device it made current); every .dat,
    .singlepulse and cands_sifted.txt byte-equal to its unsharded run's
    (``mwork``, ``main_res``), its .fft compared too (the per-shard FFT
    batches are not the unsharded run's); then on the sharded run's own
    spectra each
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


def phase_serve(short, workdir, device="cuda"):
    """Survey jobs on the port's SearchService on the card, four services
    on one plan store, each with its jobs admitted before its scheduler
    starts, on the short beam (phase_short's ``short``), each job's files
    held to phase_short's run_survey: (1) stacked=True with its HTTP front
    end takes two POST /submit specs of the short beam (two workdirs, one
    bucket): one schedule event of occupancy 2, no degrade, each job's
    files equal to run_survey's; (2) stacked=False
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
    raw, mwork = short["beam"], short["reference"]
    read = launch_counts()

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
            "equal to run_survey's %s %s"
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
    launches = read()
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
                stacked_cold_s=cold["seconds"], launches=launches,
                spectra=short["spectra"], files=cold["files"],
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
# 13 beams of 3 blocks (24576 spectra, 3.1 s) each, fed as fast as the
# rings take them; one dispersed pulse in beam 0 alone and a broadband
# burst in all, both in the middle block (the stream triggers nothing in
# its last block: the burst at 2.6 s there went unseen in every beam and
# in each one-beam reference).  Cut from 2^17 spectra (16.8 s), which
# took 198 s for the phase on an H100 (the per-trial single-pulse loop:
# 13 x 256 host round trips a tick, three passes), then from 6 blocks
# (80-131 s), to keep both live phases near 90 s, then from 4 blocks
# (the burst at 3.0 s, in the third) for the script's time limit
BEAMS = dict(N=3 * 8192, nbeams=13, seed=41, coincidence_k=3)
BEAMS_PULSE = (1.5, 57.0, 1.0e-3, 5.0)
BEAMS_BURST = (1.9, 0.0, 1.0e-3, 4.0)


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


# the fleet phase: the triage budget cuts the heuristic's 3 folds to 2;
# short heartbeats so the reaper re-admits the killed replica's lease
# within seconds; the lease TTL outlasts the search node
FLEET_TRIAGE_BUDGET = 2
FLEET_REPLICA_ARGS = ("-hb-interval", "0.5", "-hb-timeout", "4",
                      "-lease-ttl", "900", "-snapshot-interval", "1",
                      "-inflight", "2")
ROOT = os.path.dirname(os.path.abspath(__file__))


def _start_replica(fleetdir, name, workdir, device):
    """``python3 -m presto_tpu_torch.apps.serve -fleet`` as its own process
    (output to <workdir>/<name>.log): (Popen, log path)."""
    logp = os.path.join(workdir, name + ".log")
    with open(logp, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "presto_tpu_torch.apps.serve",
             "-fleet", fleetdir, "-replica", name, "-port", "0",
             "-workdir", os.path.join(workdir, "w-" + name),
             "-device", str(device)] + list(FLEET_REPLICA_ARGS),
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=out, stderr=subprocess.STDOUT)
    return proc, logp


def _until(cond, timeout, poll=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


def _snapshot_launches(fleetdir, name):
    """cuda_kernel_launches_total{kernel} of one replica's last published
    snapshot (<fleet>/obs/<name>.json), 0 for a kernel it never
    launched."""
    from presto_tpu_torch.obs import fleetagg
    out = {"plane_build": 0, "stage_reduce": 0}
    snap = fleetagg.load_snapshots(fleetdir).get(name)
    if snap is not None:
        merged = fleetagg.merge_states({name: snap["metrics"]})
        out.update({k: int(v) for k, v in fleetagg.counter_rollup(
            merged, "cuda_kernel_launches_total", "kernel").items()})
    return out


def _pfd_named_as(src, like):
    """src's .pfd bytes with its embedded names (file, candidate, device)
    taken from the .pfd ``like`` (the fleet folds embed basenames, the
    main phase's folds the paths it was given)."""
    from presto_tpu_torch.io import pfd as pfdio
    p, q = pfdio.read_pfd(src), pfdio.read_pfd(like)
    for f in ("filenm", "candnm", "pgdev"):
        setattr(p, f, getattr(q, f))
    tmp = like + ".renamed"
    pfdio.write_pfd(tmp, p)
    with open(tmp, "rb") as f:
        out = f.read()
    os.remove(tmp)
    return out


def phase_fleet(raw, workdir, mwork, device="cuda", config=None,
                fold_top=3, zmax=200):
    """A discovery DAG on a fleet of two replica processes on the card.
    Weights from ``presto-triage train --synthetic`` (timed); the port's
    router in this process (loopback HTTP, a ready replica required);
    replica r1 started, the DAG POSTed (search -> sift -> triage ->
    folds -> toa over ``raw`` with the main phase's configuration),
    r1 SIGKILLed right after it leases the search node, r2 started; the
    reaper re-admits the node and r2 runs the whole DAG, then SIGTERM
    drains it.  Checks: every node done once (one usage row and one
    result.json a node, r2's; redos 1 on the search node, 0 elsewhere);
    the search node's .dat, .singlepulse, ACCEL and .cand files and both
    cands_sifted.txt byte-equal to the reference run's in ``mwork``
    (run_survey of ``raw``, the main configuration); the triage
    selection equal to TriagePolicy.select on the card over its
    sifted list with the same weights; each fold's .pfd
    byte-equal to a CPU refold of its candidate and, where the
    reference run folded that candidate, to that .pfd (names aside); one TOA a
    fold in the .tim; fleet_jobs_committed_total summed over the
    snapshots by obs/fleetagg equal to r2's commits; both kernels
    launched by r2.  ``device`` "cpu" (replicas run with -device cpu)
    rehearses the phase at a small size, with ``config`` the survey
    fields, ``fold_top`` and ``zmax`` of its main run."""
    from presto_tpu_torch.apps import triage as triage_cli
    from presto_tpu_torch.apps.prepfold import DatFoldSpec, fold_dat_cands
    from presto_tpu_torch.obs import fleetagg
    from presto_tpu_torch.pipeline.sifting import (select_fold_candidates,
                                                   sift_candidates)
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http)
    from presto_tpu_torch.triage import TriagePolicy
    if config is None:
        cfg = main_cfg()
        config = dict(lodm=cfg.lodm, hidm=cfg.hidm, nsub=cfg.nsub,
                      zmax=cfg.zmax, numharm=cfg.numharm)
    os.makedirs(workdir, exist_ok=True)
    fleetdir = os.path.join(workdir, "fleet")
    weights = os.path.join(workdir, "triage_weights.json")
    t0 = time.time()
    train_rc = triage_cli.main(["train", "--synthetic", "-o", weights],
                               device=device)
    train_s = time.time() - t0
    log("fleet: presto-triage train --synthetic on %s: rc %d, %.3f s"
        % (device, train_rc, train_s))
    router = FleetRouter(RouterConfig(fleetdir=fleetdir, poll_s=0.25,
                                      heartbeat_timeout=4.0)).start()
    httpd = start_http(router)
    base = "http://%s:%d" % httpd.server_address[:2]
    led = JobLedger(fleetdir)
    procs = {}
    res = dict(train_s=train_s)
    try:
        procs["r1"] = _start_replica(fleetdir, "r1", workdir, device)
        p1 = procs["r1"][0]
        ready = _until(lambda: "r1" in router.ready_replicas()
                       or p1.poll() is not None, 300)
        res["r1_ready_s"] = time.time() - t0 - train_s
        spec = {"rawfiles": [raw], "config": config,
                "fold": {"fold_top": fold_top}, "toa": {"ntoa": 1},
                "triage": {"weights": weights,
                           "budget": FLEET_TRIAGE_BUDGET}}
        t_admit = time.time()
        code, out = _http("POST", base + "/dag", spec)
        if code != 202:
            raise RuntimeError("POST /dag answered %d: %s" % (code, out))
        dag_id, nodes = out["dag_id"], out["nodes"]
        sid = nodes["search"]

        def leased_by_r1():
            v = led.view(sid)
            return v["state"] == "leased" and v["owner"] == "r1"
        leased = _until(lambda: leased_by_r1() or p1.poll() is not None,
                        300, poll=0.01)
        res["r1_launches_last_snapshot"] = _snapshot_launches(fleetdir,
                                                              "r1")
        t_kill = time.time()
        p1.kill()
        res["r1_rc"] = p1.wait(60)
        log("fleet: r1 leased the search node %.3f s after the admit; "
            "SIGKILL -> rc %d" % (t_kill - t_admit, res["r1_rc"]))
        procs["r2"] = _start_replica(fleetdir, "r2", workdir, device)
        p2 = procs["r2"][0]
        finished = _until(lambda: led.all_terminal()
                          or p2.poll() is not None, 1200, poll=0.1)
        t_done = time.time()
        p2.terminate()
        res["r2_rc"] = p2.wait(300)
        _c, res["scale"] = _http("GET", base + "/scale")
        _c, fm = _http("GET", base + "/fleet/metrics")
    finally:
        for proc, _logp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(60)
        httpd.shutdown()
        router.stop()
    for name, (_p, logp) in sorted(procs.items()):
        with open(logp) as f:
            tail = f.read()[-1500:]
        log("fleet: %s log tail: %s" % (name, tail.replace("\n", " | ")))
    state = led.read()
    rows = {jid: r for jid, r in state["jobs"].items()
            if r.get("dag") == dag_id}
    dv = led.dag_view(dag_id)
    res.update(admit_to_done_s=t_done - t_admit,
               relet_after_kill_s=float(rows[sid].get("leased_at") or 0.0)
               - t_kill, dag_state=dv["state"], nodes=sorted(rows))
    # exactly once: one usage row, one result.json (r2's) a node
    usage = led.usage.raw_rows()
    per = {jid: [u for u in usage if u["job_id"] == jid] for jid in rows}
    details = {}
    for jid in rows:
        p = os.path.join(fleetdir, "jobs", jid, "result.json")
        details[jid] = json.load(open(p)) if os.path.exists(p) else None
    results_json = glob.glob(os.path.join(fleetdir, "jobs", "*", "*.json"))
    once = (dv["state"] == "done"
            and all(r["state"] == "done" for r in rows.values())
            and all(len(v) == 1 for v in per.values())
            and all(d is not None and d["replica"] == "r2"
                    for d in details.values())
            and len(results_json) == len(rows)
            and rows[sid]["redos"] == 1
            and all(r["redos"] == 0 for j, r in rows.items() if j != sid))
    res["usage_phases"] = {jid[len(dag_id) + 1:]: (
        per[jid][-1]["phases"] if per[jid] else {}) for jid in sorted(rows)}
    for jid in sorted(rows):
        u = per[jid][-1]["phases"] if per[jid] else {}
        log("fleet: %-28s %-7s redos %d; admit->lease %.3f s, execute "
            "%.3f s, commit %.3f s, total %.3f s"
            % (jid, rows[jid]["state"], rows[jid]["redos"],
               u.get("lease_wait", -1), u.get("execute", -1),
               u.get("commit", -1), u.get("total", -1)))

    def cdir(jid):
        return os.path.join(fleetdir, "jobs", jid,
                            details[jid]["attempt_dir"])
    # the search node's files against the main phase's
    sdir = cdir(sid)
    same = {}
    for pat in ("*.dat", "*.singlepulse", "*_ACCEL_*", "cands_sifted.txt"):
        same.update(_same_files(mwork, sdir, pat))
    same["sift:cands_sifted.txt"] = open(os.path.join(
        cdir(nodes["sift"]), "cands_sifted.txt"), "rb").read() == open(
        os.path.join(mwork, "cands_sifted.txt"), "rb").read()
    search_ok = (len(same) > 3 and all(same.values())
                 and any(k.endswith(".dat") for k in same))
    # the triage node against TriagePolicy.select over the main run
    cl = sift_candidates(sorted(glob.glob(os.path.join(
        mwork, "*_ACCEL_%d" % zmax))), numdms_min=2, low_DM_cutoff=2.0)
    heur = select_fold_candidates(cl, fold_top=fold_top, pass_zmaxes=[zmax])
    want, acct = TriagePolicy(weights_path=weights,
                              budget=FLEET_TRIAGE_BUDGET, datdir=mwork,
                              device=device).select(heur)
    scores = json.load(open(os.path.join(cdir(nodes["triage"]),
                                         "triage_scores.json")))
    got = [(c["filename"], c["candnum"]) for c in scores["candidates"]
           if c["selected"]]
    tres = details[nodes["triage"]]
    tsum = json.load(open(os.path.join(fleetdir, "jobs", nodes["triage"],
                                       "result.json")))["result"]
    triage_ok = (scores["mode"] == acct["mode"] == "triage"
                 and got == [(c.filename, c.candnum) for c in want])
    log("fleet: triage %s: scored %d, folded %d, avoided %d; selection %s, "
        "TriagePolicy.select on the main run %s %s"
        % (tsum["mode"], tsum["scored"], tsum["folds"],
           tsum["folds_avoided"], got,
           [(c.filename, c.candnum) for c in want],
           "ok" if triage_ok else "FAIL"))
    # each fold against a CPU refold and the main phase's fold
    folds = sorted(j for j in rows if "-fold-" in j)
    heur_keys = [(c.filename, c.candnum) for c in heur]
    fold_eq = {}
    for fid in folds:
        f = rows[fid]["spec"]["fold"]
        pfd = os.path.join(cdir(fid), f["outname"] + ".pfd")
        ref = os.path.join(workdir, "refold", f["outname"])
        os.makedirs(os.path.dirname(ref), exist_ok=True)
        fold_dat_cands([DatFoldSpec(
            datfile=os.path.join(sdir, f["datfile"]),
            accelfile=os.path.join(sdir, f["accelfile"]),
            candnum=int(f["candnum"]), outbase=ref, dm=float(f["dm"]))],
            device="cpu")
        cpu_eq = open(pfd, "rb").read() == open(ref + ".pfd", "rb").read()
        key = (f["accelfile"][:-len(".cand")], int(f["candnum"]))
        main_eq = None
        if key in heur_keys:
            mp = os.path.join(mwork, "fold_cand%d.pfd"
                              % (heur_keys.index(key) + 1))
            if os.path.exists(mp):
                main_eq = _pfd_named_as(mp, pfd) == open(pfd, "rb").read()
        fold_eq[fid] = dict(cpu=cpu_eq, main=main_eq)
    folds_ok = (len(folds) == min(FLEET_TRIAGE_BUDGET, len(heur))
                and all(v["cpu"] and v["main"] is not False
                        for v in fold_eq.values()))
    tim = [ln for ln in open(os.path.join(cdir(nodes["toa"]), "toas.tim"))
           if ln.strip() and not ln.startswith("FORMAT")]
    toa_ok = len(tim) == len(folds)
    # the committed counter over the snapshots
    agg = fleetagg.aggregate(fleetdir)
    committed = sum(fleetagg.counter_rollup(
        agg["merged"], "fleet_jobs_committed_total", "").values())
    by_r2 = sum(1 for d in details.values() if d and d["replica"] == "r2")
    counter_ok = committed == by_r2 == len(rows)
    res["r2_launches"] = _snapshot_launches(fleetdir, "r2")
    launched = device != "cuda" or (
        res["r2_launches"].get("plane_build", 0) > 0
        and res["r2_launches"].get("stage_reduce", 0) > 0)
    log("fleet: %d nodes done once %s; search files equal to the main "
        "run's %s (%d files); folds %s; toas %d for %d folds; committed "
        "counter over the snapshots %d, r2 committed %d; launches r1 (last "
        "snapshot before the kill) %s, r2 %s; replica rc r1 %d r2 %d"
        % (len(rows), once, search_ok, len(same), json.dumps(fold_eq),
           len(tim), len(folds), committed, by_r2,
           json.dumps(res["r1_launches_last_snapshot"]),
           json.dumps(res["r2_launches"]), res["r1_rc"], res["r2_rc"]))
    log("fleet: admit -> done %.3f s; kill -> search node re-leased "
        "%.3f s; r1 ready %.3f s after the start" % (
            res["admit_to_done_s"], res["relet_after_kill_s"],
            res["r1_ready_s"]))
    log("fleet: GET /scale %s" % json.dumps(res["scale"]))
    log("fleet: GET /fleet/metrics replicas %s, job_e2e %s, jobs %s"
        % (json.dumps(fm.get("replicas")), json.dumps(fm.get("job_e2e")),
           json.dumps(fm.get("jobs"))))
    res.update(once=once, search_files=same, triage=dict(
        selected=got, scored=tsum["scored"], folded=tsum["folds"],
        avoided=tsum["folds_avoided"]), folds=fold_eq, toas=len(tim),
        committed_counter=committed, r2_committed=by_r2,
        fleet_metrics_jobs=fm.get("jobs"), job_e2e=fm.get("job_e2e"))
    res["phase_s"] = time.time() - t0
    res["ok"] = bool(train_rc == 0 and ready and leased and finished
                     and res["r1_rc"] == -9 and res["r2_rc"] == 0 and once
                     and search_ok and triage_ok and folds_ok and toa_ok
                     and counter_ok and launched)
    log("fleet: %s" % ("ok" if res["ok"] else "FAIL"))
    return res


#: the federation phase's control plane: the routers' /scale advisory
#: prices a job of a bucket never run at obs/slo.ScaleConfig's
#: default_job_s (5 s) and wants the backlog drained in FED_DRAIN_S, so
#: one beam job wants one replica and two want two; each supervisor keeps
#: 1-2 replicas, acts after 2 polls that want more (4 that want fewer)
#: at FED_POLL_S, with FED_COOLDOWN_S between actions; the federation
#: reaps a fleet whose router has not answered for FED_HB_TTL_S
FED_DRAIN_S = 6.0
FED_POLL_S = 0.25
FED_COOLDOWN_S = 2.0
FED_HB_TTL_S = 3.0
#: the federation's wire timeout: a member router's first POST /submit
#: imports the survey's modules (~3.4 s on the CPU); a dead router
#: refuses at once, so the reap does not wait on it
FED_HTTP_TIMEOUT_S = 15.0
FED_REPLICA_ARGS = ("-lease-ttl", "900", "-snapshot-interval", "1",
                    "-inflight", "1")
#: presto-tune's sweep in the phase: the column slab at the main path's
#: shape (zmax 200, numharm 8, 2^21 bins), 3 steady reps a slab
FED_TUNE_BUDGET_S = 60


def _start_proc(argv, logp):
    """One control-plane process from the repository root (output to
    logp): its Popen."""
    with open(logp, "w") as out:
        return subprocess.Popen([sys.executable, "-m"] + list(argv),
                                cwd=ROOT, env=dict(os.environ,
                                                   PYTHONPATH=ROOT),
                                stdout=out, stderr=subprocess.STDOUT)


def _pid_alive(pid):
    """A pid that still runs (a zombie is not running)."""
    try:
        with open("/proc/%d/stat" % int(pid)) as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except (OSError, ValueError):
        return False


def _supervisor_events(fleetdir):
    from presto_tpu_torch.serve import supervisor as suplib
    p = suplib.events_path(fleetdir)
    if not os.path.exists(p):
        return []
    return [json.loads(ln) for ln in open(p) if ln.strip()]


def _fleet_launches(fleetdir):
    """{replica: {kernel: launches}} from every replica snapshot of a
    fleet (cuda_kernel_launches_total at its last publication)."""
    from presto_tpu_torch.obs import fleetagg
    return {name: _snapshot_launches(fleetdir, name)
            for name in sorted(fleetagg.load_snapshots(fleetdir))}


def phase_federation(raw, workdir, mwork, device="cuda", config=None):
    """Two supervised fleets behind the federation, fleet A SIGKILLed
    whole.  Each fleet: the port's router (python -m
    presto_tpu_torch.serve.router) and presto-supervise (python -m
    presto_tpu_torch.apps.supervise, 1-2 replicas of -device ``device``)
    as processes of their own; each supervisor spawns its first replica.
    The federation router runs in this process (start_fed_http,
    loopback).  Survey job J1 (``raw``, the short beam in the script,
    the main configuration) goes to the federation, which places it on
    A (A holds the beam); once A's
    replica has leased J1 in A's ledger, A's router, supervisor and
    replica are SIGKILLed; the federation reaps A and re-admits J1 on
    B.  J2 follows, B's /scale wants 2 replicas and B's supervisor spawns
    a second; idle again, B drains back to 1 by SIGTERM.  Checks: one
    federated commit each (fleets.json), each job's .dat, .singlepulse,
    ACCEL, .cand, cands_sifted.txt and (rebased) .pfd equal to the run
    in ``mwork``; fleet_jobs_committed_total over B's snapshots 2; B's
    supervisor-spawn events carry the advisory inputs, its drain ends in
    supervisor-drained without a timeout; /fed, /fleet/metrics, /slo,
    /usage and /scale answer; apps/report -fleet renders B's supervisor
    timeline; the phase's times go as one episode into a perf ledger in
    the phase's directory, which the federation's pricing reads back by
    the card's fingerprint; presto-tune sweeps accel_column_slab into a
    temporary DB keyed by the card's fingerprint (launches counted) and
    --device-report lists it.  ``device`` "cpu" (with ``config``)
    rehearses the phase at a small size."""
    import contextlib
    import io
    import signal
    from presto_tpu_torch.apps import report as report_cli
    from presto_tpu_torch.apps import tune as tune_cli
    from presto_tpu_torch.obs import fleetagg, perfledger, slo
    from presto_tpu_torch.serve import supervisor as suplib
    from presto_tpu_torch.serve.federation import (FederationConfig,
                                                   FederationRouter,
                                                   FleetMember,
                                                   start_fed_http)
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.tune.db import fingerprint_key
    if config is None:
        cfg = main_cfg()
        config = dict(lodm=cfg.lodm, hidm=cfg.hidm, nsub=cfg.nsub,
                      zmax=cfg.zmax, numharm=cfg.numharm,
                      fold_top=cfg.fold_top,
                      durable_stages=cfg.durable_stages)
    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    res = dict(scale=dict(target_drain_s=FED_DRAIN_S,
                          default_job_s=slo.ScaleConfig().default_job_s,
                          max_replicas=2),
               supervisor=dict(poll_s=FED_POLL_S, scale_up_after=2,
                               scale_down_after=4,
                               cooldown_s=FED_COOLDOWN_S),
               heartbeat_ttl_s=FED_HB_TTL_S)
    fleets, procs = {}, {}
    for name in ("A", "B"):
        fdir = os.path.join(workdir, "fleet" + name)
        port = _free_port()
        url = "http://127.0.0.1:%d" % port
        procs["router" + name] = _start_proc(
            ["presto_tpu_torch.serve.router", "-fleetdir", fdir, "-port",
             str(port), "-poll", str(FED_POLL_S), "-hb-timeout", "4",
             "-scale-drain", str(FED_DRAIN_S), "-scale-max", "2"],
            os.path.join(workdir, "router%s.log" % name))
        procs["supervisor" + name] = _start_proc(
            ["presto_tpu_torch.apps.supervise", "-fleet", fdir, "-router",
             url, "-poll", str(FED_POLL_S), "-scale-up-after", "2",
             "-scale-down-after", "4", "-cooldown", str(FED_COOLDOWN_S),
             "-min", "1", "-max", "2", "-drain-timeout", "120",
             "-spawn-timeout", "300", "-hb-timeout", "60",
             "-replica-prefix", name.lower(), "-device", str(device),
             "-teardown"] + ["-replica-arg=%s" % a
                             for a in FED_REPLICA_ARGS],
            os.path.join(workdir, "supervisor%s.log" % name))
        fleets[name] = dict(dir=fdir, url=url)
    fp = fingerprint_key()
    ledger_path = os.path.join(workdir, "perf_ledger.json")
    members = [FleetMember(name=n, fleetdir=fleets[n]["dir"],
                           url=fleets[n]["url"], fingerprint=fp,
                           data_roots=((os.path.dirname(os.path.abspath(
                               raw)),) if n == "A" else ()))
               for n in ("A", "B")]
    fed = httpd = None
    ok_http, jobs = {}, {}

    def ready(n):
        try:
            code, sc = _http("GET", fleets[n]["url"] + "/scale", timeout=5)
        except OSError:
            return False
        return code == 200 and sc["inputs"]["ready_replicas"] >= 1

    def fed_row(jid):
        return fed.fedledger.placements().get(jid) or {}
    try:
        started = _until(lambda: ready("A") and ready("B"), 300, poll=0.2)
        res["fleets_ready_s"] = time.time() - t0
        if not started:
            raise RuntimeError("federation: a fleet has no ready replica "
                               "after 300 s")
        up = {n: [e for e in _supervisor_events(fleets[n]["dir"])
                  if e["kind"] == "supervisor-up"] for n in fleets}
        res["spawn_to_up_s"] = {n: [e["warmup_s"] for e in v]
                                for n, v in up.items()}
        log("federation: both fleets ready %.3f s after the start (%s)"
            % (res["fleets_ready_s"], started))
        fed = FederationRouter(FederationConfig(
            feddir=os.path.join(workdir, "fed"), fleets=members,
            poll_s=FED_POLL_S, heartbeat_ttl=FED_HB_TTL_S,
            http_timeout=FED_HTTP_TIMEOUT_S, perf_workload="federation",
            perf_ledger_path=ledger_path)).start()
        httpd = start_fed_http(fed)
        base = "http://%s:%d" % httpd.server_address[:2]
        spec = {"rawfiles": [raw], "config": config}
        t_admit = {"J1": time.time()}
        code, out = _http("POST", base + "/submit",
                          dict(spec, job_id="fed-j1"))
        jobs["J1"] = dict(code=code, placed=out.get("placement", {}))
        if code != 202:
            raise RuntimeError("federation: POST /submit answered %d: %s "
                               "(push errors %s)" % (code, out, [
                                   e for e in fed.events.tail(50)
                                   if e["kind"] == "fed-push-error"]))
        aled = JobLedger(fleets["A"]["dir"])
        leased = _until(lambda: (aled.view("fed-j1") or {}).get("state")
                        == "leased", 300, poll=0.01)
        reg = suplib.load_registry(fleets["A"]["dir"])["replicas"]
        pids = [int(r["pid"]) for r in reg.values() if r.get("pid")]
        t_kill = time.time()
        for key in ("routerA", "supervisorA"):
            procs[key].kill()
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        rcs = {k: procs[k].wait(30) for k in ("routerA", "supervisorA")}
        dead = _until(lambda: not any(_pid_alive(p) for p in pids), 30)
        res["kill"] = dict(rcs=rcs, replica_pids=pids, replicas_dead=dead,
                           leased_before_kill_s=t_kill - t_admit["J1"])
        log("federation: J1 placed on %s (%s), leased in A's ledger %.3f s "
            "after the admit; SIGKILL A's router, supervisor and replica "
            "%s -> %s, replicas gone %s"
            % (jobs["J1"]["placed"].get("fleet"),
               jobs["J1"]["placed"].get("source"),
               t_kill - t_admit["J1"], pids, rcs, dead))
        readmitted = _until(lambda: fed_row("fed-j1").get("owner") == "B"
                            and fed_row("fed-j1").get("state")
                            in ("leased", "done"), 120, poll=0.02)
        res["kill_to_readmit_s"] = (float(fed_row("fed-j1").get(
            "leased_at") or 0.0) - t_kill)
        t_admit["J2"] = time.time()
        code, out = _http("POST", base + "/submit",
                          dict(spec, job_id="fed-j2"))
        jobs["J2"] = dict(code=code, placed=out.get("placement", {}))
        done = _until(lambda: all(fed_row(j).get("state") == "done"
                                  for j in ("fed-j1", "fed-j2")),
                      900, poll=0.2)
        for name, jid in (("J1", "fed-j1"), ("J2", "fed-j2")):
            jobs[name]["admit_to_done_s"] = (float(fed_row(jid).get(
                "completed_at") or 0.0) - t_admit[name])
        # the federation's own errors (seconds after the kill), A's
        # refused probes counted apart: what a slow re-admission waited on
        errs = [e for e in fed.events.tail(4096)
                if e["kind"] in ("fed-push-error", "fed-probe-error")]
        res["fed_errors"] = [
            (e["kind"], e.get("fleet"), e.get("item"),
             round(e["ts"] - t_kill, 3), e.get("detail") or e.get("error"))
            for e in errs if not (e["kind"] == "fed-probe-error"
                                  and e.get("fleet") == "A")]
        res["a_probe_errors"] = len(errs) - len(res["fed_errors"])
        drained = _until(lambda: any(
            e["kind"] == "supervisor-drained"
            for e in _supervisor_events(fleets["B"]["dir"])), 180, poll=0.2)
        for path in ("/fed", "/fleet/metrics", "/slo", "/usage", "/scale"):
            c, body = _http("GET", base + path)
            ok_http[path] = c == 200 and isinstance(body, dict)
        res["fed_view"] = _http("GET", base + "/fed")[1]
    finally:
        if httpd is not None:
            httpd.shutdown()
        if fed is not None:
            fed.stop()
        for key in ("supervisorB", "routerB", "supervisorA", "routerA"):
            p = procs.get(key)
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(150)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(30)
        for n in fleets:
            for r in suplib.load_registry(fleets[n]["dir"])[
                    "replicas"].values():
                if r.get("pid") and _pid_alive(r["pid"]):
                    os.kill(int(r["pid"]), signal.SIGKILL)
    for key in sorted(procs):
        with open(os.path.join(workdir, key + ".log")) as f:
            log("federation: %s log tail: %s" % (
                key, f.read()[-800:].replace("\n", " | ")))
    res["jobs"] = jobs
    # one federated commit each, both on B
    state = fed.fedledger.read()
    rows = {j: state["placements"].get(j, {}) for j in ("fed-j1",
                                                        "fed-j2")}
    once = (all(r.get("state") == "done" and r.get("owner") == "B"
                for r in rows.values())
            and rows["fed-j1"].get("redos") == 1
            and rows["fed-j2"].get("redos") == 0
            and fed.obs.metrics.get("fed_commits_total").value == 2
            and fed.obs.metrics.get("fed_stale_commits_total").value == 0
            and sorted(os.listdir(os.path.join(
                workdir, "fed", "results"))) == ["fed-j1.json",
                                                 "fed-j2.json"]
            and jobs["J1"]["placed"].get("fleet") == "A"
            and jobs["J2"]["placed"].get("fleet") == "B")
    # the files against the main phase's
    bdir = fleets["B"]["dir"]
    bled = JobLedger(bdir)
    files = {}
    for jid in ("fed-j1", "fed-j2"):
        p = os.path.join(bdir, "jobs", jid, "result.json")
        if os.path.exists(p):
            d = json.load(open(p))
            files[jid] = _job_files_equal(os.path.join(
                bdir, "jobs", jid, d["attempt_dir"]), mwork)
            files[jid]["replica"] = d.get("replica")
    want = ["dat", "accel", "sifted"] + (
        ["singlepulse"] if config.get("singlepulse", True) else []) + (
        ["pfd"] if config.get("fold_top", 3) > 0 else [])
    files_ok = len(files) == 2 and all(
        all(f[k][0] for k in want) for f in files.values())
    bview = {j: (bled.view(j) or {}).get("state") for j in rows}
    usage = bled.usage.raw_rows()
    usage_ids = sorted(u["job_id"] for u in usage)
    res["usage_phases"] = {u["job_id"]: u.get("phases") for u in usage}
    # the committed counter over B's snapshots
    agg = fleetagg.aggregate(bdir)
    committed = sum(fleetagg.counter_rollup(
        agg["merged"], "fleet_jobs_committed_total", "").values())
    # B's supervisor: spawn (with the advisory inputs), up, drain, drained
    bev = _supervisor_events(bdir)
    kinds = [e["kind"] for e in bev]
    spawns = [e for e in bev if e["kind"] == "supervisor-spawn"]
    scale_up = [e for e in spawns if e.get("why") == "scale-up"
                and e.get("wanted") == 2]
    res["b_supervisor"] = dict(
        kinds={k: kinds.count(k) for k in sorted(set(kinds))},
        spawns=[{k: e.get(k) for k in ("replica", "why", "wanted",
                                       "advice_reason", "inputs")}
                for e in spawns],
        warmup_s=[e["warmup_s"] for e in bev
                  if e["kind"] == "supervisor-up"])
    scaled = (len(scale_up) >= 1
              and scale_up[0]["inputs"].get("backlog_jobs", 0) >= 2
              and kinds.count("supervisor-up") >= 2
              and "supervisor-drain" in kinds and drained
              and "supervisor-drain-timeout" not in kinds
              and "supervisor-replace" not in kinds)
    # the report's supervisor timeline
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report_rc = report_cli.main(["-fleet", bdir])
    text = out.getvalue()
    report_ok = (report_rc == 0 and "Supervisor (supervisor.json" in text
                 and "timeline" in text and " drained " in text
                 and (device != "cuda" or "CUDA kernel launches" in text))
    # launches: A's last snapshot and B's replicas'
    launches = {"A": _fleet_launches(fleets["A"]["dir"]),
                "B": _fleet_launches(bdir)}
    res["launches_by_replica"] = launches
    res["launches"] = {k: sum(r.get(k, 0) for f in launches.values()
                              for r in f.values())
                       for k in ("plane_build", "stage_reduce")}
    b_sum = {k: sum(r.get(k, 0) for r in launches["B"].values())
             for k in ("plane_build", "stage_reduce")}
    launched = device != "cuda" or all(v > 0 for v in b_sum.values())
    # the phase's numbers as one episode; the federation's pricing reads
    # it back for a fleet with no usage of its own (A) by the fingerprint
    eps = {"kill_to_readmit_s": ([res["kill_to_readmit_s"]], "s", "lower"),
           "j1_admit_to_done_s": ([jobs["J1"].get("admit_to_done_s", 0.0)],
                                  "s", "lower"),
           "j2_admit_to_done_s": ([jobs["J2"].get("admit_to_done_s", 0.0)],
                                  "s", "lower"),
           "spawn_to_up_s": (res["b_supervisor"]["warmup_s"] or [0.0], "s",
                             "lower"),
           "jobs_per_hour": ([2 * 3600.0 / max(max(
               jobs[j].get("admit_to_done_s", 0.0) for j in jobs), 1e-9)],
               "jobs/h", "higher")}
    led = perfledger.PerfLedger()
    led.append(perfledger.make_episode(
        {k: perfledger.metric_from_samples(v, u, d)
         for k, (v, u, d) in eps.items()}, fingerprint=fp,
        workload="federation", source="chip_smoke.py",
        meta={"card": torch.cuda.get_device_name(0)
              if device == "cuda" else "cpu"}))
    led.save(ledger_path)
    back = perfledger.PerfLedger.load(ledger_path).select(
        fingerprint=fp, workload="federation")
    price = fed.price_fleet(members[0], None)
    res["pricing"] = dict(episodes=len(back), price_s=price[0],
                          source=price[1])
    priced = len(back) == 1 and price[1] == "perf-ledger"
    # presto-tune: accel_column_slab at the main path's shape
    tdb = os.path.join(workdir, "tune.json")
    read = launch_counts()
    t_tune = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tune_rc = tune_cli.main(
            ["--families", "accel_column_slab", "--budget",
             str(FED_TUNE_BUDGET_S), "--k", "3", "--db", tdb, "-device",
             str(device)] + (["--smoke"] if device != "cuda" else []))
    res["tune_s"] = time.time() - t_tune
    res["tune_launches"] = read()
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tune_cli.main(["--device-report", "--db", tdb])
    rep = json.loads(out.getvalue())
    res["tune"] = dict(rc=tune_rc, summary=summary.get("families"),
                       fingerprint=rep["fingerprint"],
                       this_device=rep["this_device"])
    tuned = (tune_rc == 0 and "accel_column_slab" in rep["this_device"]
             and rep["fingerprint_key"] == fp
             and summary["fingerprint"] == fp
             and (device != "cuda" or (
                 rep["fingerprint"]["platform"] == "cuda"
                 and "H100" in rep["fingerprint"]["device_kind"]
                 and res["tune_launches"]["plane_build"] > 0
                 and res["tune_launches"]["stage_reduce"] > 0)))
    log("federation: J1 %s, J2 %s; kill -> re-admit on B %.3f s; B "
        "replicas up %s s after their spawns; one federated commit each %s "
        "(B ledger %s, usage %s); files equal %s; committed counter over "
        "B's snapshots %d; B supervisor %s; report timeline %s"
        % (json.dumps(jobs["J1"], default=str),
           json.dumps(jobs["J2"], default=str), res["kill_to_readmit_s"],
           res["b_supervisor"]["warmup_s"], once, bview, usage_ids,
           json.dumps(files), committed,
           json.dumps(res["b_supervisor"]["kinds"]), report_ok))
    log("federation: B scale-up spawn %s; usage phases on B %s; the "
        "federation's errors after the kill (kind, fleet, item, s, "
        "detail) %s, and %d probes of A refused"
        % (json.dumps(scale_up[:1]), json.dumps(res["usage_phases"]),
           json.dumps(res["fed_errors"]), res["a_probe_errors"]))
    log("federation: GET %s all answered %s; launches %s; pricing from "
        "the perf ledger %s; tune %.1f s rc %d, launches %s, DB %s"
        % (sorted(ok_http), all(ok_http.values()) and len(ok_http) == 5,
           json.dumps(launches), json.dumps(res["pricing"]), res["tune_s"],
           tune_rc, json.dumps(res["tune_launches"]),
           json.dumps(rep["this_device"].get("accel_column_slab"))))
    res.update(once=once, files=files, committed_counter=committed,
               http=ok_http, report_ok=report_ok)
    res["phase_s"] = time.time() - t0
    res["ok"] = bool(started and leased and readmitted and done and once
                     and files_ok and committed == 2
                     and bview == {"fed-j1": "done", "fed-j2": "done"}
                     and usage_ids == ["fed-j1", "fed-j2"] and scaled
                     and len(ok_http) == 5 and all(ok_http.values())
                     and report_ok and launched and priced and tuned
                     and res["kill"]["replicas_dead"])
    log("federation: %s (%.1f s)" % ("ok" if res["ok"] else "FAIL",
                                     res["phase_s"]))
    return res


# the recipe phase's beam: the main beam's samples under a header with
# the JAX package's synth position (the Crab, presto_tpu/models/synth.py),
# GBT and MJD 59000, so prepsubband barycentres it
RECIPE_POSITION = dict(src_raj=53431.97, src_dej=220052.1, telescope_id=6,
                       tstart=59000.0)
# the fold caps of the recipe run, lo pass and hi pass: GBNCC's 20 + 10
# folds took 18.3 s of its 40.5 s run_survey (PERF.md §5); the phase
# folds the 6 + 3 strongest so that the script keeps within its time
RECIPE_FOLD_CAPS = (6, 3)
# the pulsar's barycentric frequency, predicted f (1 + avgvoverc), and
# the topocentric one lie 0.57 Fourier bins apart on the beam; the
# measured one must sit within this many bins of the prediction
RECIPE_FREQ_TOL_BINS = 0.3


def positioned_beam(raw, path):
    """The beam's samples under RECIPE_POSITION's header."""
    from presto_tpu_torch.io.sigproc import (FilterbankFile,
                                             write_filterbank_header)
    with FilterbankFile(raw) as fb:
        hdr = copy.copy(fb.header)
        start = fb.header.headerlen
    for k, v in RECIPE_POSITION.items():
        setattr(hdr, k, v)
    with open(path, "wb") as out, open(raw, "rb") as src:
        write_filterbank_header(hdr, out)
        src.seek(start)
        shutil.copyfileobj(src, out, 1 << 24)
    return path


def _inf_bytes(path):
    """A .inf's text with its data-file-name line dropped (the names of
    two runs differ by directory)."""
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith(" Data file name")]


def recipe_kernels(pcfg, T, nbins, pairs, gen, label, device="cuda",
                   uselen=None):
    """Both kernels at one recipe pass's geometry (zmax, numharm; the
    searcher's uselen unless given) on the recipe run's spectrum: the
    plane builder against its plain version (plane_case), then the stage
    reducer on that plane, bit-equal to its plain version, kernel and
    plain times and the bound."""
    from presto_tpu_torch.search import accel, accel_cuda, build_cuda
    s = accel.AccelSearch(accel.AccelConfig(
        zmax=pcfg.zmax, numharm=pcfg.numharm, sigma=pcfg.sigma,
        flo=pcfg.flo, uselen=uselen or accel.ACCEL_USELEN),
        T=T, numbins=nbins, device=device)
    pb, S = plane_case(s, nbins, gen, label, pairs=pairs)
    nblocks, nb_pad, numr = s.plane_geom()
    plane = build_cuda.build_plane(S, s._kbank, s.numz_pad, nb_pad,
                                   s.cfg.uselen, s.hw_eff * 2)
    del S
    slab, _k, start_cols = s.slab_plan(numr)
    scols = torch.tensor(start_cols, dtype=torch.int32, device=device)
    nst = s.cfg.numharmstages
    args = (plane, scols, s._zinds, slab, nst)
    gm, gz = accel_cuda.reduce_stages(*args)
    wm, wz = accel_cuda.reduce_stages_plain(*args)
    torch.cuda.synchronize()
    err = float((gm - wm).abs().max())
    ok = err == 0.0 and bool((gz == wz).all())
    del gm, gz, wm, wz
    bms, by, nbytes, flops = reducer_bound(plane, scols, s._zinds, slab,
                                           nst, s.cfg.numz)
    ms = cuda_time_ms(lambda: accel_cuda.reduce_stages(*args), 10)
    plain_ms = cuda_time_ms(lambda: accel_cuda.reduce_stages_plain(*args),
                            1)
    log("stage_reduce %s: plane %s, %d slabs of %d, %d stages; max_abs_err "
        "%.3g; kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s) %s"
        % (label, tuple(plane.shape), len(start_cols), slab, nst, err, ms,
           plain_ms, bms, by, "ok" if ok else "FAIL"))
    del plane, s
    torch.cuda.empty_cache()
    sr = dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
              library_ms=None, bound_ms=bms, bound_by=by, bytes=nbytes,
              flops=flops, stages=nst, tolerance="exact")
    return pb, sr


def phase_recipe(raw, workdir, main_res=None, device="cuda", keep=None):
    """The survey as users run it: the beam barycentred (its samples
    under RECIPE_POSITION's header), GBNCC's recipe (the default
    zaplist, the lo and hi accel passes, its sift policy; its 20 + 10
    fold caps cut to RECIPE_FOLD_CAPS) through run_survey with bary=True
    and durable stages:
    the launches read around it; every .inf barycentred at the plan's
    epoch; every .dat/.inf byte-equal to a staged prepsubband on the card
    (no -nobary, the survey's mask); for two DMs the spilled .fft equal
    to the card's rFFT of the .dat batch, downloaded and zapped by
    zap_pairs_batch; an injected pulsar first in cands_sifted.txt (the
    7.13 Hz one, summed over 16 harmonics in the lo pass, outranks the
    40.3 Hz one), the 40.3 Hz pulsar's strongest sifted candidate within
    one trial of DM 22, and its DM-22 hi-pass candidate at f (1 +
    avgvoverc); the folds within the caps; both kernels against their
    plain versions at the two passes' geometries on the DM-22 spectrum;
    the stage times, with the host resample and zap as run_survey timed
    them.  ``keep``: a directory that receives recipe_cands.tar.xz, the
    run's ACCEL tables, .cand files, .inf files and cands_sifted.txt
    (tests/test_torch_recipes.py holds the JAX package's sift and sigma
    of those candidates to the port's list)."""
    from presto_tpu_torch.apps import common, prepsubband, zapbirds
    from presto_tpu_torch.io import datfft
    from presto_tpu_torch.io.infodata import read_inf
    from presto_tpu_torch.ops import fftpack
    from presto_tpu_torch.pipeline import fusion, survey
    from presto_tpu_torch.pipeline.recipes import get_recipe
    from presto_tpu_torch.pipeline.sifting import select_fold_candidates
    from presto_tpu_torch.utils.timing import StageTimer
    b = BEAM
    t_phase = time.time()
    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    braw = positioned_beam(raw, os.path.join(workdir, "psrb.fil"))
    copy_s = time.time() - t0
    cfg = get_recipe("gbncc").to_config(20.0, 24.0, nsub=32)
    cfg.bary = True
    cfg.durable_stages = True
    cfg.max_folds = sum(RECIPE_FOLD_CAPS)
    cfg.max_folds_per_pass = RECIPE_FOLD_CAPS
    work = os.path.join(workdir, "survey")
    timer = StageTimer()
    read = launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = survey.run_survey([braw], cfg, work, timer=timer, device=device)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = read()
    ndms = len(res.datfiles)
    npass = len(cfg.all_passes)
    stages = {k: round(v, 4) for k, v in timer.stages.items()}
    # the host resample (prepsubband's seam handoff) and the host zap
    # (each FFT chunk in seam_fft_search), timed where they ran
    resample_s = timer.stages.get("bary resample (host)", 0.0)
    zap_s = timer.stages.get("zap (host)", 0.0)
    zap_chunks = len(timer.samples.get("zap (host)", []))
    log("recipe: gbncc over DM 20-24, bary, zaplist %s: run_survey %.1f s; "
        "stages %s; launches %s" % (os.path.basename(cfg.zaplist), run_s,
                                   json.dumps(stages), json.dumps(launches)))
    launches_ok = (ndms == 24 and launches["plane_build"] == npass * ndms
                   and launches["stage_reduce"] == npass * ndms)
    # the barycentring plan of the beam, as prepsubband made it
    fb = common.open_raw(braw)
    plan = common.make_bary_plan(fb, b["dt"], "DE405")
    fb.close()
    infos = [read_inf(f[:-4]) for f in res.datfiles]
    bary_ok = plan is not None and all(
        i.bary == 1 and i.mjd_i == int(plan.blotoa)
        and abs(i.mjd_f - plan.blotoa % 1.0) < 1e-12 for i in infos)
    log("recipe: avgvoverc %.6e, %d diffbins (%d dropped), blotoa %.12f; "
        "every .inf barycentred at it %s"
        % (plan.avgvoverc, plan.diffbins.size,
           int((plan.diffbins < 0).sum()), plan.blotoa,
           "ok" if bary_ok else "FAIL"))
    # the staged prepsubband on the card, no -nobary, the survey's mask
    staged = os.path.join(workdir, "staged")
    os.makedirs(staged)
    argv = [a for a in method_argv(braw, cfg, os.path.join(staged, "psrb"))
            if a != "-nobary"] + ["-mask", res.maskfile]
    t0 = time.time()
    prepsubband.main(argv + [braw], device=device)
    staged_s = time.time() - t0
    same = []
    for f in res.datfiles:
        g = os.path.join(staged, os.path.basename(f))
        same.append(open(f, "rb").read() == open(g, "rb").read()
                    and _inf_bytes(f[:-4] + ".inf")
                    == _inf_bytes(g[:-4] + ".inf"))
    dat_ok = len(same) == 24 and all(same)
    log("recipe: staged prepsubband on the card %.1f s; .dat/.inf of %d "
        "DMs byte-equal to the survey's: %d %s"
        % (staged_s, len(same), sum(same), "ok" if dat_ok else "FAIL"))
    # the card's rFFT of the .dat batch, zapped on the host
    rows = np.stack([datfft.read_dat(f) for f in res.datfiles])
    numout = rows.shape[1]
    n = numout & ~1
    dev_rows = torch.from_numpy(rows[:, :n]).to(device)
    del rows
    host = fusion.fused_rfft_batch(dev_rows).cpu().numpy()
    del dev_rows
    T = numout * fusion.inf_float(infos[0].dt)
    zapped = zapbirds.zap_pairs_batch(host, cfg.zaplist, T, numout)
    i22 = [k for k, f in enumerate(res.datfiles) if "_DM22.00" in f][0]
    fft_same = {}
    for k in (0, i22):
        f = res.datfiles[k][:-4] + ".fft"
        fft_same[os.path.basename(f)] = (
            open(f, "rb").read()
            == fftpack.np_pairs_to_complex64(zapped[k]).tobytes())
    fft_ok = len(fft_same) == 2 and all(fft_same.values())
    log("recipe: spilled .fft equal to the card's rFFT zapped on the host "
        "%s %s; in run_survey: host resample %.3f s (24 rows, in the "
        "prepsubband stage), host zap %.3f s (%d FFT chunks, 24 spectra, "
        "%.2f GB each way, in the fused stage)"
        % (json.dumps(fft_same), "ok" if fft_ok else "FAIL", resample_s,
           zap_s, zap_chunks, zapped.nbytes / 1e9))
    # the pulsars: an injected one first; the 40.3 Hz pulsar's strongest
    # sifted candidate within one trial of DM 22; its frequency from the
    # DM-22 trial's hi pass (its fdot is inside zmax 50, and a zmax-0
    # candidate's r of a chirping signal is no frequency estimate) at
    # f (1 + avgvoverc)
    from presto_tpu_torch.apps.accelsearch import read_cand_file
    injected = [b["f0"]] + [o[0] for o in b["others"]]

    def harmonic_of(f, f0):
        h = max(1, round(f / f0))
        return h if abs(f / h - f0) < 0.1 else 0

    ranked = list(res.sifted)
    first = ranked[0] if ranked else None
    first_ok = first is not None and any(harmonic_of(first.f, f0)
                                         for f0 in injected)
    psr = [(k, c) for k, c in enumerate(ranked)
           if harmonic_of(c.f, b["f0"])]
    rank, top = psr[0] if psr else (None, None)
    hi = [c for c in read_cand_file(res.datfiles[i22][:-4] + "_ACCEL_%d.cand"
                                    % cfg.all_passes[-1][0])
          if harmonic_of(c.r / T, b["f0"])]
    hc = max(hi, key=lambda c: c.sigma) if hi else None
    f = hc.r / T if hc is not None else 0.0
    h = harmonic_of(f, b["f0"]) if hc is not None else 1
    f_topo = b["f0"] + b["fdot"] * b["N"] * b["dt"] / 2.0
    f_bary = f_topo * (1.0 + plan.avgvoverc)
    off_bins = (f / h - f_bary) * T
    pulsar_ok = (first_ok and top is not None and hc is not None
                 and abs(top.DM - b["dm"]) <= 0.21
                 and abs(off_bins) < RECIPE_FREQ_TOL_BINS)
    main_f = (main_res or {}).get("top_freq")
    sifted_sha = hashlib.sha256(open(res.candfile, "rb").read()).hexdigest()
    log("recipe: %d sifted (cands_sifted.txt sha256 %s); the first 8: %s"
        % (len(ranked), sifted_sha, json.dumps(
            [[c.filename, c.DM, round(c.f, 6), c.sigma, c.numharm]
             for c in ranked[:8]])))
    if keep is not None:
        keep_cands(res, keep)
    log("recipe: first %s (an injected pulsar: %s); the 40.3 Hz pulsar's "
        "strongest sifted candidate at rank %s: %s, DM %.2f, sigma %.2f; "
        "the DM-22 hi pass's: f %.9f Hz (harmonic %d), z %.2f, sigma %.2f; "
        "predicted f (1 + avgvoverc) %.9f Hz, off by %.3f bins "
        "(topocentric %.9f Hz: %.3f bins; the main run's top %s Hz) %s"
        % (first.filename if first else None, first_ok, rank,
           top.filename if top else None, top.DM if top else 0,
           top.sigma if top else 0, f, h, hc.z if hc else 0,
           hc.sigma if hc else 0, f_bary, off_bins, f_topo,
           (f / h - f_topo) * T, "%.9f" % main_f if main_f else "n/a",
           "ok" if pulsar_ok else "FAIL"))
    # the folds, within the recipe's caps
    zmaxes = [z for (z, _nh, _sg, _flo) in cfg.all_passes]
    picked = select_fold_candidates(
        res.sifted, fold_top=cfg.fold_top, fold_sigma=cfg.fold_sigma,
        max_folds=cfg.max_folds, max_folds_per_pass=cfg.max_folds_per_pass,
        pass_zmaxes=zmaxes)
    per_pass = [sum(1 for c in picked
                    if c.filename.split(":")[0].endswith("_ACCEL_%d" % z))
                for z in zmaxes]
    folds_ok = (0 < len(res.folded) == len(picked) <= sum(RECIPE_FOLD_CAPS)
                and all(p <= c for p, c in zip(per_pass, RECIPE_FOLD_CAPS))
                and all(os.path.exists(q + ".bestprof") for q in res.folded))
    log("recipe: %d folds (per pass %s, caps %s) %s"
        % (len(res.folded), per_pass, list(RECIPE_FOLD_CAPS),
           "ok" if folds_ok else "FAIL"))
    # both kernels at the two passes' geometries on the DM-22 spectrum
    gen = torch.Generator(device=device)
    gen.manual_seed(BEAM_SEED)
    pairs = torch.from_numpy(np.ascontiguousarray(
        zapped[i22])).to(device)
    del host, zapped
    kern = {}
    for label, pcfg in zip(("lo", "hi"), survey._pass_configs(cfg)):
        kern[label] = recipe_kernels(
            pcfg, T, n // 2, pairs, gen,
            "recipe %s pass (zmax %d, numharm %d)"
            % (label, pcfg.zmax, pcfg.numharm), device)
    del pairs
    torch.cuda.empty_cache()
    kern_ok = all(pb["ok"] and sr["ok"] for pb, sr in kern.values())
    ok = (launches_ok and bary_ok and dat_ok and fft_ok and pulsar_ok
          and folds_ok and kern_ok)
    phase_s = time.time() - t_phase
    log("recipe: %s (%.1f s: beam copy %.1f, run_survey %.1f, staged %.1f)"
        % ("ok" if ok else "FAIL", phase_s, copy_s, run_s, staged_s))
    return dict(ok=ok, launches=launches, ndms=ndms, stages=stages,
                run_survey_s=run_s, staged_prepsubband_s=staged_s,
                resample_host_s=resample_s, zap_host_s=zap_s,
                zap_chunks=zap_chunks, sifted_sha256=sifted_sha,
                zap_bytes_each_way=int(n // 2 * 8 * ndms),
                avgvoverc=plan.avgvoverc, diffbins=int(plan.diffbins.size),
                dat_inf_equal=sum(same), fft_equal=fft_same,
                first=first.filename if first else None,
                first_freq=first.f if first else None,
                first_sigma=first.sigma if first else None,
                pulsar_rank=rank, pulsar_dm=top.DM if top else None,
                pulsar_sigma=top.sigma if top else None, pulsar_freq=f,
                predicted_freq=f_bary, off_bins=off_bins,
                sifted=len(res.sifted), folds=len(res.folded),
                folds_per_pass=per_pass,
                plane_build={k: v[0] for k, v in kern.items()},
                stage_reduce={k: v[1] for k, v in kern.items()},
                phase_s=phase_s)


# the beam's PSRFITS copy: rows of this many spectra, the first half of
# the samples in a.fits and the second half in b.fits
PSRFITS_NSBLK = 2048
# the channel the psrfits phase's raw fold ignores (the 60 Hz one)
PSRFITS_IGNORECHAN = BEAM_RFI["periodic_chan"]


def beam_as_psrfits(raw, workdir):
    """The beam's 8-bit samples, read back from the .fil, as two PSRFITS
    files written by the port's write_psrfits: the .fil's descending
    band, rows of PSRFITS_NSBLK spectra, scales 1, offsets 0, weights 1;
    the first half of the spectra in a.fits, the rest in b.fits, whose
    start MJD is a.fits' plus that many dt."""
    from presto_tpu_torch.io.psrfits import write_psrfits
    from presto_tpu_torch.io.sigproc import FilterbankFile
    with FilterbankFile(raw) as fb:
        hdr = fb.header
    samples = np.fromfile(raw, np.uint8, offset=hdr.headerlen).reshape(
        hdr.N, hdr.nchans)
    freqs = hdr.fch1 + np.arange(hdr.nchans) * hdr.foff
    half = hdr.N // 2
    pair = [os.path.join(workdir, "a.fits"), os.path.join(workdir, "b.fits")]
    for path, lo, hi in ((pair[0], 0, half), (pair[1], half, hdr.N)):
        write_psrfits(path, samples[lo:hi], hdr.tsamp, freqs,
                      nsblk=PSRFITS_NSBLK,
                      start_mjd=hdr.tstart + lo * hdr.tsamp / 86400.0,
                      src_name=hdr.source_name)
    return pair


def split_psrfits(pair, blocklen, nblocks, pin=True):
    """The PSRFITS ingest of the survey head, one block at a time: the
    reader's read_spectra (the FITS rows read, decoded by the native
    subint decoder, scrubbed and assembled, PSRFITS_NSBLK spectra a row)
    and the copy of its block into a pinned upload buffer, which a
    reader with a prefetching feeder (SIGPROC) decodes into directly."""
    from presto_tpu_torch.io.psrfits import PsrfitsFile
    buf = torch.empty((blocklen, BEAM["nchan"]), dtype=torch.float32,
                      pin_memory=pin).numpy()
    st = Steps()
    with PsrfitsFile(pair) as pf:
        st._t = time.perf_counter()
        for k in range(nblocks):
            blk = pf.read_spectra(k * blocklen, blocklen)
            st.lap("read_decode")
            np.copyto(buf, blk)
            st.lap("copy_to_pinned")
    return st.summary()


def _sifted_rows(path, prefix):
    """cands_sifted.txt as whitespace-split rows, ``prefix`` (the raw
    file's base name) replaced by "psr" in the candidate names."""
    return [[t.replace(prefix + "_DM", "psr_DM") for t in line.split()]
            for line in open(path)]


def phase_psrfits(raw, workdir, mwork, main_res=None, device="cuda"):
    """The beam ``raw`` as a PSRFITS pair (beam_as_psrfits) through the
    port's PSRFITS and multi-file path on the card: the reader's stitched
    length and quality ledger; run_survey on the pair with the main
    phase's configuration, launches read around it, held against the run
    of ``raw`` in ``mwork`` (24/24 .dat bytes, the .mask
    arrays, every ACCEL table and .cand, the sifted list with the names
    aside, the three folds' profile cubes); its rfifind and survey head,
    and the host seconds each streamed pass waited on its ingest worker
    (IngestWait), beside that run's (``main_res``); the PSRFITS
    ingest's host ms a block (split_psrfits, median of INGEST_REPEATS);
    prepsubband -sub -subdm 22 on the pair and on the .fil, the .sub####
    files byte-equal; prepfold -psrfits -mask <the run's mask>
    -ignorechan PSRFITS_IGNORECHAN -nosearch of the top sifted candidate
    on a.fits, its .pfd byte-equal to the same fold on the CPU;
    psrfits2fil of the pair, its samples equal to the .fil's.  The card
    work runs on ``device`` (a CPU rehearsal at a small beam passes
    "cpu", its counts and timings then meaningless)."""
    from presto_tpu_torch.apps import prepfold, prepsubband, psrfits2fil
    from presto_tpu_torch.apps.common import stream_blocklen
    from presto_tpu_torch.io.infodata import read_inf
    from presto_tpu_torch.io.maskfile import read_mask
    from presto_tpu_torch.io.pfd import read_pfd
    from presto_tpu_torch.io.psrfits import PsrfitsFile
    from presto_tpu_torch.io.sigproc import FilterbankFile
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.utils.timing import StageTimer
    b = BEAM
    t_phase = time.time()
    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    pair = beam_as_psrfits(raw, workdir)
    write_s = time.time() - t0
    with PsrfitsFile(pair) as pf:
        stitched = dict(N=int(pf.nspectra), nsblk=pf.nsblk,
                        rows=[m.nsubint for m in pf.meta],
                        start_spec=[m.start_spec for m in pf.meta],
                        ledger=pf.quality.to_json()["counts"])
    with FilterbankFile(raw) as fb:
        nspec = int(fb.header.N)
    reader_ok = (stitched["N"] == nspec and not stitched["ledger"]
                 and stitched["start_spec"] == [0, nspec // 2])
    log("psrfits: wrote %s (%.1f s, %d MB each); stitched N %d (rows %s, "
        "file starts %s), quality ledger %s %s"
        % ([os.path.basename(p) for p in pair], write_s,
           os.path.getsize(pair[0]) >> 20, stitched["N"], stitched["rows"],
           stitched["start_spec"], stitched["ledger"] or "clean",
           "ok" if reader_ok else "FAIL"))
    # the survey on the pair, counted and timed like the main phase's
    cfg = main_cfg()
    swork = os.path.join(workdir, "survey")
    timer = StageTimer()
    read = launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with IngestWait() as wait:
        res = survey.run_survey(pair, cfg, swork, timer=timer,
                                device=device)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = read()
    launches.pop("stage_reduce_planes")
    ndms = len(res.datfiles)
    st = timer.stages
    stages = dict(run_survey_s=run_s, rfifind_s=st["rfifind"],
                  survey_head_s=st["prepsubband"],
                  fused_s=st["realfft+accelsearch (fused)"],
                  prepfold_s=st["prepfold"])
    mine = lambda pat: sorted(glob.glob(os.path.join(swork, pat)))
    theirs = lambda p: os.path.join(mwork, "psr" + os.path.basename(p)[1:])
    same_bytes = lambda a, c: open(a, "rb").read() == open(c, "rb").read()
    dats = mine("a_DM*.dat")
    dat_same = [same_bytes(p, theirs(p)) for p in dats]
    accs = mine("a_DM*_ACCEL_%d" % cfg.zmax)
    acc_same = [same_bytes(p, theirs(p)) and same_bytes(p + ".cand",
                                                        theirs(p) + ".cand")
                for p in accs]
    ma, mb = (read_mask(p) for p in (res.maskfile,
                                     os.path.join(mwork, "psr_rfifind.mask")))
    mask_same = (ma.numint == mb.numint and ma.numchan == mb.numchan
                 and np.array_equal(ma.zap_chans, mb.zap_chans)
                 and np.array_equal(ma.zap_ints, mb.zap_ints)
                 and all(np.array_equal(x, y) for x, y in
                         zip(ma.chans_per_int, mb.chans_per_int)))
    sift_same = (_sifted_rows(res.candfile, "a")
                 == _sifted_rows(os.path.join(mwork, "cands_sifted.txt"),
                                 "psr"))
    folds_same = []
    for q in res.folded:
        pa, pb = read_pfd(q), read_pfd(os.path.join(mwork,
                                                    os.path.basename(q)))
        folds_same.append(bool(np.array_equal(pa.profs, pb.profs)
                               and np.array_equal(pa.stats, pb.stats)))
    quality_clean = res.quality is not None and res.quality.clean
    survey_ok = (ndms == 24 and all(dat_same) and len(dat_same) == 24
                 and len(accs) == 24 and all(acc_same) and mask_same
                 and sift_same and len(folds_same) == 3 and all(folds_same)
                 and quality_clean
                 and all(v == ndms for v in launches.values()))
    log("psrfits: run_survey on the pair %.1f s (stages %s); launches %s"
        % (run_s, json.dumps({k: round(v, 3) for k, v in stages.items()}),
           json.dumps(launches)))
    if main_res is not None:
        ms = main_res["stages"]
        log("psrfits: the pair against the .fil (its reference run): "
            "rfifind %.3f "
            "against %.3f s, survey head %.3f against %.3f s, run_survey "
            "%.1f against %.1f s"
            % (stages["rfifind_s"], ms["rfifind_s"], stages["survey_head_s"],
               ms["survey_head_s"], run_s, ms["run_survey_s"]))
    log("psrfits: ingest consumer wait per app (host s, IngestWait) on the "
        "pair %s; on the .fil (its reference run) %s"
        % (json.dumps(wait.by_app),
           json.dumps((main_res or {}).get("ingest_wait"))))
    log("psrfits: against the .fil run: .dat equal %d/%d, ACCEL + .cand "
        "equal %d/%d, .mask arrays equal %s, sifted list equal %s, fold "
        "profile cubes equal %s, rfifind quality clean %s %s"
        % (sum(dat_same), len(dat_same), sum(acc_same), len(acc_same),
           mask_same, sift_same, folds_same, quality_clean,
           "ok" if survey_ok else "FAIL"))
    # the PSRFITS ingest's host ms a block at the head's block length
    blocklen = stream_blocklen(b["nchan"], 0, nspec)
    nblocks = min(INGEST_BLOCKS, nspec // blocklen)
    ingest = _median_of([split_psrfits(pair, blocklen, nblocks,
                                       pin=device != "cpu")
                         for _ in range(INGEST_REPEATS)])
    log("psrfits: ingest host ms a %d-spectrum block (per block, ms, "
        "mean and max over %d blocks, median of %d, as ingest split_after): "
        "%s" % (blocklen, nblocks, INGEST_REPEATS, json.dumps(
            {k: [round(v["mean_ms"], 3), round(v["max_ms"], 3)]
             for k, v in ingest.items()})))
    # prepsubband -sub on the pair and on the .fil
    sub_argv = ["-lodm", "20", "-dmstep", "0.2", "-numdms", "24", "-nsub",
                "32", "-nobary", "-sub", "-subdm", "22"]
    sub_s = {}
    for name, files in (("pair", ["-psrfits"] + pair), ("fil", [raw])):
        d = os.path.join(workdir, "sub_" + name)
        os.makedirs(d)
        torch.cuda.synchronize()
        t0 = time.time()
        prepsubband.main(sub_argv + ["-o", os.path.join(d, "s")] + files,
                         device=device)
        sub_s[name] = time.time() - t0
    subs = sorted(os.listdir(os.path.join(workdir, "sub_pair")))
    sub_same = (len(subs) == 33 and sorted(os.listdir(os.path.join(
        workdir, "sub_fil"))) == subs and all(
        same_bytes(os.path.join(workdir, "sub_pair", f),
                   os.path.join(workdir, "sub_fil", f))
        for f in subs if ".sub0" in f))
    log("psrfits: prepsubband -sub -subdm 22 on the pair %.1f s, on the "
        ".fil %.1f s; %d .sub#### files byte-equal %s"
        % (sub_s["pair"], sub_s["fil"], len(subs) - 1, sub_same))
    for name in ("sub_pair", "sub_fil"):
        shutil.rmtree(os.path.join(workdir, name))
    # the masked raw fold of a.fits, on the card and on the CPU
    top = res.sifted[0]
    info = read_inf(res.datfiles[0][:-4])
    T = info.N * info.dt
    out = os.path.join(workdir, "fold_fits")
    fold_argv = ["-psrfits", "-mask", res.maskfile, "-ignorechan",
                 str(PSRFITS_IGNORECHAN), "-nosearch", "-noplot",
                 "-f", "%.12g" % (top.r / T), "-fd", "%.12g" % (top.z / T ** 2),
                 "-dm", "%.2f" % top.DM, "-o", out, pair[0]]
    fold_s = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        t0 = time.time()
        prepfold.main(fold_argv, device=dev)
        fold_s[where] = time.time() - t0
        if where == "card":
            card = open(out + ".pfd", "rb").read()
            os.replace(out + ".pfd", out + ".card.pfd")
    fold_same = open(out + ".pfd", "rb").read() == card
    log("psrfits: prepfold -psrfits -mask -ignorechan %d -nosearch of %s "
        "(f %.6f Hz, DM %.2f) on the card %.1f s, on the CPU %.1f s; .pfd "
        "bytes equal %s" % (PSRFITS_IGNORECHAN, os.path.basename(pair[0]),
                            top.r / T, top.DM, fold_s["card"],
                            fold_s["cpu"], fold_same))
    # psrfits2fil: the pair's samples back as a .fil, in ascending band
    # order (the PSRFITS header's), so each spectrum is the .fil's reversed
    t0 = time.time()
    fil2 = os.path.join(workdir, "p2f.fil")
    psrfits2fil.main(["-o", fil2] + pair)
    p2f_s = time.time() - t0
    with FilterbankFile(raw) as fa, FilterbankFile(fil2) as fb2:
        ha, hb = fa.header, fb2.header
    da = np.fromfile(raw, np.uint8, offset=ha.headerlen)
    db = np.fromfile(fil2, np.uint8, offset=hb.headerlen)
    p2f_same = (hb.N == ha.N and hb.foff == -ha.foff and np.array_equal(
        db.reshape(hb.N, hb.nchans)[:, ::-1], da.reshape(ha.N, ha.nchans)))
    del da, db
    log("psrfits: psrfits2fil of the pair %.1f s; its samples equal to the "
        ".fil's (band reversed) %s" % (p2f_s, p2f_same))
    phase_s = time.time() - t_phase
    ok = (reader_ok and survey_ok and sub_same and fold_same and p2f_same)
    log("psrfits: phase %.1f s %s" % (phase_s, "ok" if ok else "FAIL"))
    return dict(ok=ok, write_s=write_s, stitched=stitched, stages=stages,
                launches=launches, dat_equal=sum(dat_same),
                accel_equal=sum(acc_same), mask_equal=mask_same,
                sifted_equal=sift_same, folds_equal=folds_same,
                ingest=ingest, ingest_wait=wait.by_app,
                blocklen=blocklen, sub_s=sub_s,
                sub_equal=sub_same, fold_s=fold_s, fold_equal=fold_same,
                psrfits2fil_s=p2f_s, psrfits2fil_equal=p2f_same,
                phase_s=phase_s)


# the classic command flow (prepdata -> realfft -> accelsearch ->
# prepfold -par / -psr) at DM 22 on the barycentred beam
CLASSIC_DM = 22.0
# block buffer of the out-of-core FFT (bytes): the beam's ~2^21-point
# complex transform then runs in many slabs a pass (the default buffer,
# 256 MB, would hold it in one)
CLASSIC_OOC_MEM = 1 << 22
# the in-core spectrum against the out-of-core one: the RMS of their
# difference within this share of the spectrum's RMS (the norm-wise
# fftpack bound), on the .dat as it is and on the mean-free series; bin
# by bin, |diff_k| within this share of max(|X_k|, RMS) on the
# mean-free series (a bin's own float32 spacing, |X_k| x 1.19e-7, passes
# 1e-5 of the RMS once |X_k| passes ~84 RMS).  The .dat as it is is not
# held bin by bin: the float32 FFT rounds the large partial sums of the
# series' mean, and those errors land on the bins at multiples of
# n/2^j (the phase prints its largest bins); realfft
# -inv of the card's .fft against the .dat: the largest difference
# within this share of the series' RMS
CLASSIC_RTOL = 1e-5
# a barycentred series of J0737-3039A made on the card: 2^22 samples of
# 1.28e-4 s (537 s, 16 MB), a gaussian pulse of `width` turns (FWHM)
# and `amp` in unit noise, arriving late by the catalog orbit's Roemer
# delay for the epoch (at MJD 59000 the orbit of 0.1023 d moves it by
# 0.33 s, 14.5 turns, over the series; the phase prints it)
CLASSIC_PSR = dict(name="J0737-3039A", N=1 << 22, dt=1.28e-4, mjd=59000.0,
                   width=0.05, amp=0.5, seed=37)


def classic_psr_dat(path, device="cuda"):
    """CLASSIC_PSR's .dat/.inf: psrepoch's spin and orbit at the epoch;
    the orbit's Roemer delays (ops/orbit.orbit_delays, host float64)
    subtracted from each sample time, the phase and pulse on ``device``
    (float64 phase), unit gaussian noise from the pulsar's own seed; the
    .inf barycentred, so no Doppler enters the fold."""
    from presto_tpu_torch.io.datfft import write_dat
    from presto_tpu_torch.io.infodata import InfoData
    from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays
    from presto_tpu_torch.utils.catalog import psrepoch
    c = CLASSIC_PSR
    pp = psrepoch(c["name"], c["mjd"])
    orb = OrbitParams(p=pp.orb.p, e=pp.orb.e, x=pp.orb.x, w=pp.orb.w,
                      t=pp.orb.t)
    t = np.arange(c["N"]) * c["dt"]
    delays = orbit_delays(t, orb)
    te = torch.from_numpy(t - delays).to(device)
    ph = torch.remainder(pp.f * te + 0.5 * pp.fd * te * te, 1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(c["seed"])
    x = (c["amp"] * torch.exp(-0.5 * ((ph - 0.5) / (c["width"] / 2.35482))
                              ** 2)).float()
    x = x + torch.randn(x.shape, generator=gen, device=device)
    write_dat(path, x.cpu().numpy(), InfoData(
        name=path[:-4], telescope="GBT", object=c["name"],
        ra_str="07:37:51.25", dec_str="-30:39:40.71", N=float(c["N"]),
        dt=c["dt"], mjd_i=int(c["mjd"]), mjd_f=c["mjd"] % 1.0, bary=1,
        dm=pp.dm))
    return dict(f=pp.f, fd=pp.fd, pb_s=pp.orb.p, x=pp.orb.x, e=pp.orb.e,
                delay_span_s=float(delays.max() - delays.min()),
                turns=float((delays.max() - delays.min()) * pp.f))


def _spectra_diff(card, disk):
    """Card against disk packed spectrum: the RMS of |card - disk| over
    the spectrum's RMS (`rms`), the largest |diff_k| / max(|X_k|, RMS)
    (`bin`), and the four largest |diff_k| / RMS by bin (`top`)."""
    mag = np.abs(disk.astype(np.complex128))
    rms = float(np.sqrt(np.mean(mag ** 2)))
    diff = np.abs(card.astype(np.complex128) - disk)
    top = np.argsort(diff)[-4:][::-1]
    return dict(rms=float(np.sqrt(np.mean(diff ** 2))) / rms,
                bin=float((diff / np.maximum(mag, rms)).max()),
                top=[(int(k), float(diff[k]) / rms) for k in top])


def _peak_bin(prof):
    return int(np.argmax(np.asarray(prof)))


def _bin_distance(a, b, n):
    d = abs(a - b) % n
    return min(d, n - d)


def phase_classic(raw, workdir, device="cuda"):
    """The reference's documented command flow on the card, each step
    through the port's CLI: prepdata -dm 22 of the beam barycentred (its
    samples under RECIPE_POSITION's header), its .dat/.inf byte-equal to
    the same command on the CPU, its ingest wait and dedispersion device
    ms a block; realfft in core on the card and realfft -disk (host, out
    of core, its oocfft.realfft_ooc with CLASSIC_OOC_MEM blocks), the
    RMS of the two spectra's difference within CLASSIC_RTOL of the
    spectrum's RMS, and on the mean-free series each bin's within
    CLASSIC_RTOL of max(|X_k|, RMS) too, with the packed layout exact, realfft -inv of the card's .fft back
    to the .dat within CLASSIC_RTOL of its RMS; accelsearch
    (zmax 200, numharm 8) on the card's .fft, launches read around it,
    the 40.3 Hz pulsar among its candidates within RECIPE_FREQ_TOL_BINS
    of f (1 + avgvoverc), and both kernels against their plain versions
    at its geometry on its spectrum; prepfold -par -nosearch on the .dat
    with a .par of the injection in the .dat's frame, its profile peak
    within one bin of the -f/-fd fold's and its reduced chi2 at least
    FOLD_REDCHI_MIN, then -timing (the .pfd accepted by pfd_for_timing)
    and -absphase; prepfold -psr J0737-3039A (the search at -npfact
    FOLD_NPFACT, the orbit from the catalog) of CLASSIC_PSR's series on the card and on
    the CPU, the chi2 surfaces within CHI2_ATOL of their maximum and the
    best trial equal unless a near-tie, its reduced chi2 at least
    FOLD_REDCHI_MIN while the fold at the catalog's f and fd for the
    epoch, with the same search and without the orbit, stays under it.
    The card work runs on ``device`` (a CPU rehearsal at a small beam
    passes "cpu", its counts and timings then meaningless)."""
    from presto_tpu_torch.apps import (accelsearch, common, pfd_for_timing,
                                       prepdata, prepfold, realfft)
    from presto_tpu_torch.io import datfft
    from presto_tpu_torch.io.infodata import read_inf
    from presto_tpu_torch.ops import dedispersion as dd
    from presto_tpu_torch.ops import fftpack, oocfft
    from presto_tpu_torch.search.accel import AccelConfig
    b = BEAM
    t_phase = time.time()
    os.makedirs(workdir, exist_ok=True)
    braw = positioned_beam(raw, os.path.join(workdir, "psrc.fil"))
    fb = common.open_raw(braw)
    plan = common.make_bary_plan(fb, b["dt"], "DE405")
    fb.close()
    v = plan.avgvoverc
    same_bytes = lambda a, c: open(a, "rb").read() == open(c, "rb").read()

    # 1. prepdata on the card and on the CPU
    out = {}
    prep_s = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        d = os.path.join(workdir, "prep_" + where)
        os.makedirs(d)
        out[where] = os.path.join(d, "psrc_DM%.2f" % CLASSIC_DM)
        with IngestWait() as wait:
            torch.cuda.synchronize()
            t0 = time.time()
            prepdata.main(["-dm", "%.1f" % CLASSIC_DM, "-o", out[where],
                           braw], device=dev)
            torch.cuda.synchronize()
            prep_s[where] = time.time() - t0
        if where == "card":
            prep_wait = wait.by_app.get("prepdata", {})
    dat = out["card"] + ".dat"
    prep_same = (same_bytes(dat, out["cpu"] + ".dat")
                 and _inf_bytes(out["card"] + ".inf")
                 == _inf_bytes(out["cpu"] + ".inf"))
    info = read_inf(out["card"])
    bary_ok = info.bary == 1 and info.mjd_i == int(plan.blotoa)
    # the dedispersion of one block on the card, at prepdata's geometry
    delays = dd.dedisp_delays(b["nchan"], CLASSIC_DM, b["lofreq"], b["cw"],
                              voverc=v)
    bins = dd.delays_to_bins(delays - delays.min(), b["dt"])
    blocklen = common.stream_blocklen(b["nchan"], int(bins.max()), b["N"])
    nblocks = -(-b["N"] // blocklen) + 1
    g = torch.Generator(device=device)
    g.manual_seed(BEAM_SEED)
    prev, cur = (torch.randn((b["nchan"], blocklen), generator=g,
                             device=device) for _ in range(2))
    bins_d = torch.as_tensor(bins.astype(np.int64)[None], device=device)
    dedisp_ms = cuda_time_ms(
        lambda: dd.float_dedisp_many_block(prev, cur, bins_d), 10)
    del prev, cur
    log("classic: prepdata -dm %.1f of %s (barycentred, avgvoverc %.6e) "
        "on the card %.2f s (ingest wait %.3f s over %d pulls; "
        "dedispersion %.3f device ms a %d-spectrum block x %d blocks), on "
        "the CPU %.2f s; %d samples, .dat/.inf equal to the CPU's %s, "
        "barycentred %s"
        % (CLASSIC_DM, os.path.basename(braw), v, prep_s["card"],
           prep_wait.get("wait_s", 0.0), prep_wait.get("pulls", 0),
           dedisp_ms, blocklen, nblocks - 1, prep_s["cpu"], int(info.N),
           prep_same, bary_ok))
    os.remove(out["cpu"] + ".dat")

    # 2. realfft in core on the card, out of core on the host, inverse
    base = out["card"]
    t0 = time.time()
    realfft.main(["-mem", dat], device=device)
    incore_s = time.time() - t0
    os.replace(base + ".fft", base + ".card.fft")
    # realfft -disk's transform, given the small block buffer
    t0 = time.time()
    ran = oocfft.realfft_ooc(dat, base + ".fft", forward=True,
                             max_mem=CLASSIC_OOC_MEM)
    ooc_s = time.time() - t0
    (R, C), passes = ran["split"], ran["slabs"]
    series = datfft.read_dat(dat)
    n = series.size & ~1
    nc = n // 2
    card_fft = datfft.read_fft(base + ".card.fft")
    disk_fft = datfft.read_fft(base + ".fft")
    layout_ok = card_fft.shape == disk_fft.shape == (nc,)
    asis = _spectra_diff(card_fft, disk_fft)
    del card_fft, disk_fft
    # the same two transforms of the mean-free series, held bin by bin
    zdir = os.path.join(workdir, "meanfree")
    os.makedirs(zdir)
    zbase = os.path.join(zdir, os.path.basename(base))
    (series[:n] - series[:n].mean(dtype=np.float64)).astype(
        np.float32).tofile(zbase + ".dat")
    shutil.copy(base + ".inf", zbase + ".inf")
    realfft.main(["-mem", zbase + ".dat"], device=device)
    oocfft.realfft_ooc(zbase + ".dat", zbase + ".disk.fft", forward=True,
                       max_mem=CLASSIC_OOC_MEM)
    free = _spectra_diff(datfft.read_fft(zbase + ".fft"),
                         datfft.read_fft(zbase + ".disk.fft"))
    shutil.rmtree(zdir)
    x_d = torch.from_numpy(series[:n]).to(device)
    fft_ms = cuda_time_ms(lambda: fftpack.realfft_packed_pairs(x_d), 10)
    del x_d
    inv_dir = os.path.join(workdir, "inv")
    os.makedirs(inv_dir)
    ibase = os.path.join(inv_dir, os.path.basename(base))
    shutil.copy(base + ".card.fft", ibase + ".fft")
    shutil.copy(base + ".inf", ibase + ".inf")
    realfft.main(["-inv", ibase + ".fft"], device=device)
    back = datfft.read_dat(ibase + ".dat")
    srms = float(np.sqrt(np.mean(series[:n].astype(np.float64) ** 2)))
    inv_err = float(np.abs(back.astype(np.float64)
                           - series[:n]).max()) / srms
    fft_ok = (layout_ok and asis["rms"] <= CLASSIC_RTOL
              and free["rms"] <= CLASSIC_RTOL
              and free["bin"] <= CLASSIC_RTOL
              and back.shape == (n,) and inv_err <= CLASSIC_RTOL)
    top = lambda d: ", ".join("%d (%.3f n/64) %.3g" % (k, 64.0 * k / n, e)
                              for k, e in d["top"])
    log("classic: realfft of %d samples in core on the card %.2f s "
        "(torch.fft %.3f device ms), -disk out of core %.2f s (host; "
        "%d x %d two-pass split, %d + %d slabs of a %d-byte buffer, as "
        "run); in core - out of core: the .dat RMS / RMS %.3g (bound %g), "
        "bin by bin max |diff| / max(|X_k|, RMS) %.3g, its largest |diff| "
        "/ RMS at bins %s; the mean-free series RMS / RMS %.3g (bound %g), "
        "bin by bin %.3g (bound %g), largest at bins %s; realfft -inv of "
        "the card's .fft max |x' - x| / RMS %.3g (bound %g); layout %s %s"
        % (n, incore_s, fft_ms, ooc_s, R, C, passes[0], passes[1],
           ran["max_mem"], asis["rms"], CLASSIC_RTOL, asis["bin"],
           top(asis), free["rms"], CLASSIC_RTOL, free["bin"], CLASSIC_RTOL,
           top(free), inv_err, CLASSIC_RTOL, layout_ok,
           "ok" if fft_ok else "FAIL"))
    os.replace(base + ".card.fft", base + ".fft")
    shutil.rmtree(inv_dir)

    # 3. accelsearch on the card's .fft
    from presto_tpu_torch.apps.accelsearch import read_cand_file
    read = launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    accelsearch.main(["-zmax", "200", "-numharm", "8", base + ".fft"],
                     device=device)
    torch.cuda.synchronize()
    accel_s = time.time() - t0
    launches = read()
    launches.pop("stage_reduce_planes")
    T = info.N * info.dt
    f_bary = (b["f0"] + b["fdot"] * b["N"] * b["dt"] / 2.0) * (1.0 + v)
    cands = read_cand_file(base + "_ACCEL_200.cand")
    hits = []
    for c in cands:
        h = max(1, round((c.r / T) / b["f0"]))
        off = (c.r / T / h - f_bary) * T
        if abs(off) < RECIPE_FREQ_TOL_BINS:
            hits.append((c.sigma, h, off))
    accel_ok = bool(hits) and all(k >= 1 for k in launches.values())
    best = max(hits) if hits else (0.0, 0, 0.0)
    log("classic: accelsearch -zmax 200 -numharm 8 on the card %.2f s, "
        "launches %s; %d candidates, the 40.3 Hz pulsar among them: %d "
        "within %.1f bins of f (1 + avgvoverc) = %.9f Hz (strongest sigma "
        "%.2f, harmonic %d, %.3f bins off) %s"
        % (accel_s, json.dumps(launches), len(cands), len(hits),
           RECIPE_FREQ_TOL_BINS, f_bary, best[0], best[1], best[2],
           "ok" if accel_ok else "FAIL"))
    amps = datfft.read_fft(base + ".fft")
    pairs = torch.from_numpy(fftpack.np_complex64_to_pairs(amps)).to(device)
    del amps
    kgen = torch.Generator(device=device)
    kgen.manual_seed(BEAM_SEED)
    kern = recipe_kernels(AccelConfig(zmax=200, numharm=8, sigma=2.0,
                                      flo=1.0), T, nc, pairs, kgen,
                          "classic accelsearch (zmax 200, numharm 8)",
                          device)
    del pairs
    torch.cuda.empty_cache()
    kern_ok = kern[0]["ok"] and kern[1]["ok"]

    # 4. prepfold -par (the injection in the .dat's barycentric frame:
    # F0 the injected 40.3 Hz times 1 + avgvoverc, the plan's mean
    # Doppler; F1 the injected fdot; PEPOCH the .inf epoch, the
    # barycentric MJD of the first sample; the Crab's position, as the
    # header's), -f/-fd, -timing and -absphase, all -nosearch
    f0 = b["f0"] * (1.0 + v)
    par = os.path.join(workdir, "psrc.par")
    with open(par, "w") as fh:
        fh.write("PSRJ J0534+2200\nRAJ 05:34:31.97\nDECJ +22:00:52.1\n"
                 "F0 %.15g\nF1 %.6g\nPEPOCH %.15g\nDM %.1f\n"
                 % (f0, b["fdot"], info.mjd, CLASSIC_DM))
    folds, fold_s = {}, {}
    for name, flags in (
            ("par", ["-par", par, "-nosearch"]),
            ("f", ["-f", "%.15g" % f0, "-fd", "%.6g" % b["fdot"],
                   "-nosearch"]),
            ("timing", ["-timing", par]),
            ("absphase", ["-par", par, "-absphase", "-nosearch"])):
        t0 = time.time()
        folds[name] = prepfold.run(prepfold.build_parser().parse_args(
            flags + ["-noplot", "-o", base + "_" + name, dat]),
            device=device)
        fold_s[name] = time.time() - t0
    nbin = folds["par"].proflen
    peaks = {k: _peak_bin(r.best_prof) for k, r in folds.items()}
    timing_ok = pfd_for_timing.main([base + "_timing.pfd"]) == 0
    par_ok = (_bin_distance(peaks["par"], peaks["f"], nbin) <= 1
              and _bin_distance(peaks["absphase"], peaks["par"], nbin) <= 1
              and folds["par"].best_redchi >= FOLD_REDCHI_MIN
              and timing_ok)
    log("classic: prepfold -nosearch on the .dat (%d bins): -par f %.9f "
        "Hz fd %.4g, peak bin %d, reduced chi2 %.1f (threshold %.0f); "
        "-f/-fd peak %d, chi2 %.1f; -timing chi2 %.1f, pfd_for_timing "
        "accepts it %s; -absphase peak %d; seconds %s %s"
        % (nbin, folds["par"].fold_f, folds["par"].fold_fd, peaks["par"],
           folds["par"].best_redchi, FOLD_REDCHI_MIN, peaks["f"],
           folds["f"].best_redchi, folds["timing"].best_redchi, timing_ok,
           peaks["absphase"], json.dumps({k: round(s, 2)
                                          for k, s in fold_s.items()}),
           "ok" if par_ok else "FAIL"))

    # 5. prepfold -psr J0737-3039A, with and without its orbit, the
    # (p, pd) search at FOLD_NPFACT (the default's 513 x 513 took the CPU
    # 28 s of the script)
    pdat = os.path.join(workdir, "j0737.dat")
    t0 = time.time()
    made = classic_psr_dat(pdat, device)
    psr_make_s = time.time() - t0
    psr, psr_s = {}, {}
    for name, flags, dev in (
            ("card", ["-psr", CLASSIC_PSR["name"]], device),
            ("cpu", ["-psr", CLASSIC_PSR["name"]], "cpu"),
            ("flat", ["-f", "%.15g" % made["f"],
                      "-fd=%.15g" % made["fd"]], device)):
        t0 = time.time()
        psr[name] = prepfold.run(prepfold.build_parser().parse_args(
            flags + ["-npfact", str(FOLD_NPFACT), "-noplot", "-o",
                     pdat[:-4] + "_" + name, pdat]), device=dev)
        psr_s[name] = time.time() - t0
    errs, notes = {}, {}
    agree_ok = True
    for what in ("dm_chi2", "ppd_chi2"):
        a = np.asarray(getattr(psr["card"], what))
        c = np.asarray(getattr(psr["cpu"], what))
        # a .dat fold searches no DM: its DM curve is one zero
        scale = max(float(np.abs(c).max()), 1e-30)
        atol = CHI2_ATOL * scale
        errs[what] = float(np.abs(a - c).max()) / scale
        agree, notes[what] = _argmax_agree(a, c, what, atol)
        agree_ok = (agree_ok and a.shape == c.shape
                    and errs[what] <= CHI2_ATOL and agree)
    psr_ok = (agree_ok and psr["card"].best_redchi >= FOLD_REDCHI_MIN
              and psr["flat"].best_redchi < FOLD_REDCHI_MIN)
    log("classic: %s series made on the card %.2f s (f %.9f Hz, Pb %.1f "
        "s, x %.4f lt-s, e %.4f; Roemer delay spans %.3f s, %.1f turns); "
        "prepfold -psr on the card %.2f s: reduced chi2 %.1f, best p "
        "%.12f s; on the CPU %.2f s; chi2 surfaces card vs CPU max |diff| "
        "/ max %s (tolerance %g), best indices %s; -f/-fd at the epoch, the "
        "same search, without the orbit: reduced chi2 %.2f (under %.0f) %s"
        % (CLASSIC_PSR["name"], psr_make_s, made["f"], made["pb_s"],
           made["x"], made["e"], made["delay_span_s"], made["turns"],
           psr_s["card"], psr["card"].best_redchi, psr["card"].best_p,
           psr_s["cpu"],
           json.dumps({k: float("%.3g" % e) for k, e in errs.items()}),
           CHI2_ATOL, json.dumps(notes), psr["flat"].best_redchi,
           FOLD_REDCHI_MIN,
           "ok" if psr_ok else "FAIL"))
    phase_s = time.time() - t_phase
    ok = (prep_same and bary_ok and fft_ok and accel_ok and kern_ok
          and par_ok and psr_ok)
    log("classic: phase %.1f s %s" % (phase_s, "ok" if ok else "FAIL"))
    return dict(ok=ok, avgvoverc=v, prepdata_s=prep_s,
                prepdata_equal_cpu=prep_same, ingest_wait=prep_wait,
                dedisp_ms_a_block=dedisp_ms, blocklen=blocklen,
                nblocks=nblocks - 1, realfft_incore_s=incore_s,
                fft_ms=fft_ms, realfft_ooc_s=ooc_s, ooc_split=[R, C],
                ooc_slabs=list(passes), fft_err=asis,
                fft_err_mean_free=free,
                inverse_rel_err=inv_err, accelsearch_s=accel_s,
                launches=launches, pulsar_hits=len(hits),
                pulsar_off_bins=best[2], plane_build=kern[0],
                stage_reduce=kern[1],
                par=dict(peak=peaks, redchi={k: r.best_redchi
                                             for k, r in folds.items()},
                         seconds=fold_s, timing_accepted=timing_ok),
                psr=dict(made=made, made_s=psr_make_s, seconds=psr_s,
                         redchi={k: r.best_redchi for k, r in psr.items()},
                         chi2_rel_err=errs, best_index=notes),
                phase_s=phase_s)


# the binary searches: a phase-modulated pulsar through search_bin,
# bincand and quicklook, and the Monte-Carlo campaign (phase_binary).
# The series: 2^22 samples of 2.5e-4 s (T = 1048.6 s, the JAX phasemod
# test's T), a 200 Hz sinusoid in a circular 400 s orbit of x = 0.0199
# lt-s (modulation index 2 pi f x = 25 rad: ~51 sidebands 2.62 bins
# apart), unit noise from its own seed.  amp 0.02 is the JAX test's
# signal to noise scaled to this N (0.05 at 2^20 samples is 0.025 here)
# and lowered until the sidebands pruned by prune_powers cost the least
# (0.025 prunes more and loses sigma).  Every sideband under the 25x
# cutoff needs amp <= ~0.012, where the binary (sigma ~4.8) sits under
# noise candidates of the full-width search (5.0-5.6): the phase prints
# the bins over the cutoff
BINARY_PSR = dict(N=1 << 22, dt=2.5e-4, f=200.0, pb=400.0, x=0.0199,
                  amp=0.02, seed=18)
# search_bin on the card against the CPU: -rlo/-rhi span this many bins
# around the spin bin; mini_power within BINARY_POWER_RTOL; a candidate
# whose sigma lies within BINARY_TIE_SIGMA of a neighbour's or of the
# list's cut may move or trade places (a stage-sum tie), and is logged
BINARY_CPU_BINS = 1 << 18
BINARY_POWER_RTOL = 1e-4
BINARY_TIE_SIGMA = 1e-3
# bincand's trial: the JAX test's perturbation (Pb 1.05x, x 0.8x)
BINARY_TRIAL = dict(porb=1.05, x=0.8)
# the JAX package's campaign test (tests/test_explore_monte.py)
BINARY_MONTE = ["--N", "524288", "--dt", "0.01", "--fpsr", "20", "--amp",
                "0.2", "--asini", "0.2", "--ratios", "0.1", "20",
                "--ntrials", "2", "--sigma", "4", "--seed", "7",
                "--methods", "ffdot", "long"]


def binary_psr_dat(path):
    """BINARY_PSR's .dat/.inf: the orbit's Roemer delays
    (ops/orbit.orbit_delays, host float64) subtracted from each sample
    time, the sinusoid and the unit noise (np.random.default_rng(seed))
    on the host.  Returns the sidebands' peak power over the noise mean,
    noise-free, for the log."""
    from presto_tpu_torch.io.datfft import write_dat
    from presto_tpu_torch.io.infodata import InfoData
    from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays
    c = BINARY_PSR
    t = np.arange(c["N"]) * c["dt"]
    delays = orbit_delays(t, OrbitParams(p=c["pb"], x=c["x"]))
    sig = c["amp"] * np.cos(2.0 * np.pi * c["f"] * (t - delays))
    noise = np.random.default_rng(c["seed"]).standard_normal(c["N"])
    write_dat(path, (sig + noise).astype(np.float32), InfoData(
        name=path[:-4], telescope="None", object="binary", N=float(c["N"]),
        dt=c["dt"], mjd_i=59000, mjd_f=0.0))
    return float((np.abs(np.fft.rfft(sig)) ** 2).max() / c["N"])


class MiniFFTClock:
    """While installed, each call of search/phasemod._minifft_topk with
    its window size, window count and CUDA events around it (the span of
    one window batch's device program, the host's launches of its ops
    included); read after a synchronize."""

    def __enter__(self):
        from presto_tpu_torch.search import phasemod
        self.calls = []
        self._mod, self._orig = phasemod, phasemod._minifft_topk

        def timed(windows, numsumpow, fftlen, *a, **k):
            e0, e1 = cuda_event(), cuda_event()
            e0.record()
            out = self._orig(windows, numsumpow, fftlen, *a, **k)
            e1.record()
            self.calls.append((fftlen, int(windows.shape[0]), e0, e1))
            return out
        phasemod._minifft_topk = timed
        return self

    def __exit__(self, *exc):
        self._mod._minifft_topk = self._orig

    def by_size(self):
        """{fftlen: [calls, windows, device ms]} and the total ms."""
        torch.cuda.synchronize()
        out = {}
        for fftlen, nwin, e0, e1 in self.calls:
            row = out.setdefault(fftlen, [0, 0, 0.0])
            row[0] += 1
            row[1] += nwin
            row[2] += e0.elapsed_time(e1)
        return out, sum(r[2] for r in out.values())


class CorrRecorder:
    """While installed, each call of search/bincand._corr_max (one a
    refinement round): the best template's index, its power, the
    template count and the call's CUDA-event span; and the host seconds
    of each round's template build (bincand._make_templates)."""

    def __enter__(self):
        from presto_tpu_torch.search import bincand
        self.rounds, self.build_s = [], []
        self._mod = bincand
        self._orig = bincand._corr_max, bincand._make_templates
        corr, make = self._orig

        def rec(seg, tmpl, fftlen):
            e0, e1 = cuda_event(), cuda_event()
            e0.record()
            pows, args = corr(seg, tmpl, fftlen)
            e1.record()
            p = pows.cpu().numpy()
            self.rounds.append((int(np.argmax(p)), float(p.max()),
                                int(tmpl.shape[0]), e0.elapsed_time(e1)))
            return pows, args

        def timed_make(*a, **k):
            t0 = time.time()
            out = make(*a, **k)
            self.build_s.append(time.time() - t0)
            return out
        bincand._corr_max, bincand._make_templates = rec, timed_make
        return self

    def __exit__(self, *exc):
        self._mod._corr_max, self._mod._make_templates = self._orig


def _cli_out(fn, *a, **k):
    """Run a CLI, return (its result, its standard output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **k)
    return res, buf.getvalue()


def bincands_agreement(card, cpu, rtol=BINARY_POWER_RTOL,
                       tie=BINARY_TIE_SIGMA):
    """search_bin's card list against the CPU's: the same (mini_N,
    full_lo_r, mini_r, mini_numsum) keys in the same order, mini_power
    within rtol.  A candidate in one list only, or out of order, passes as
    a tie when its sigma lies within ``tie`` of an unmatched one's in the
    other list or of a neighbour's, or of the list's cut.  Returns (ok,
    ties, largest power rel err, keys matched)."""
    key = lambda c: (c.mini_N, c.full_lo_r, c.mini_r, c.mini_numsum)
    ck, pk = {key(c): c for c in card}, {key(c): c for c in cpu}
    cut = min([c.mini_sigma for c in cpu + card] or [0.0])
    only_card = [c for k, c in ck.items() if k not in pk]
    only_cpu = [c for k, c in pk.items() if k not in ck]
    ok, ties, err = True, [], 0.0
    for c, others in ([(c, only_cpu) for c in only_card]
                      + [(c, only_card) for c in only_cpu]):
        near = [o for o in others if abs(o.mini_sigma - c.mini_sigma) <= tie]
        if near or abs(c.mini_sigma - cut) <= tie:
            ties.append(("only_card" if c in only_card else "only_cpu",
                         key(c), c.mini_sigma))
        else:
            ok = False
            log("binary: search_bin candidate %s sigma %.4f in one list "
                "only, no tie" % (key(c), c.mini_sigma))
    for k in ck.keys() & pk.keys():
        err = max(err, abs(ck[k].mini_power - pk[k].mini_power)
                  / pk[k].mini_power)
    order_c = [key(c) for c in card if key(c) in pk]
    order_p = [key(c) for c in cpu if key(c) in ck]
    for i, (a, b) in enumerate(zip(order_c, order_p)):
        if a != b:
            if abs(pk[a].mini_sigma - pk[b].mini_sigma) <= tie:
                ties.append(("order", i, pk[a].mini_sigma, pk[b].mini_sigma))
            else:
                ok = False
                log("binary: search_bin order differs at %d: %s against %s"
                    % (i, a, b))
    return ok and err <= rtol, ties, err, len(order_c)


def _bincand_orbit(out):
    """(P_orb s, x lt-s, power) from bincand's printed result."""
    val = lambda tag: float(re.search(tag + r"\s*=\s*(\S+)", out).group(1))
    return (val("P_orb"), val("x"),
            float(re.search(r"power (\S+)", out).group(1)))


def phase_binary(workdir, device="cuda"):
    """The binary searches on the card, each through the port's CLI:
    BINARY_PSR's series made on the host (binary_psr_dat) and realfft on
    the card; search_bin at its defaults over the whole spectrum, its
    miniFFT programs timed per window size (MiniFFTClock), the top
    candidate within 10% of Pb and 5% of 1/f; search_bin -rlo/-rhi over
    BINARY_CPU_BINS around the spin bin on the card and on the CPU, held
    by bincands_agreement; bincand from BINARY_TRIAL on the card and the
    CPU (the same grid orbit each round, powers within
    BINARY_POWER_RTOL, the refined Pb within 5% and x within 25%) and
    bincand -candfile on the top candidate (logged); monte_binresp at
    BINARY_MONTE with launches read around it (the JAX test's detection
    checks), both kernels held to their plain versions at its geometry
    on its first trial's spectrum; quicklook on the .dat, its top peak
    within the signal's Carson bandwidth, f +- (2 pi f x + 1) / Pb (the
    carrier keeps J0(25)^2 = 0.3% of the power: the peak is a sideband).
    The card work runs on ``device`` (a CPU rehearsal passes "cpu")."""
    from presto_tpu_torch.apps import (bincand, monte_binresp, quicklook,
                                       realfft, search_bin)
    from presto_tpu_torch.io import datfft
    from presto_tpu_torch.ops import fftpack
    from presto_tpu_torch.pipeline import monte
    c = BINARY_PSR
    t_phase = time.time()
    os.makedirs(workdir, exist_ok=True)
    T = c["N"] * c["dt"]
    r0 = c["f"] * T

    # 1. the series, realfft on the card
    dat = os.path.join(workdir, "binary.dat")
    base = dat[:-4]
    t0 = time.time()
    peak_pow = binary_psr_dat(dat)
    make_s = time.time() - t0
    realfft.main([dat], device=device)
    amps = datfft.read_fft(base + ".fft")
    pows = np.abs(amps) ** 2
    lo = int(r0) - 196608
    med = float(np.median(pows[lo:lo + 393216]))
    carson = (2.0 * np.pi * c["f"] * c["x"] + 1.0) * T / c["pb"]
    band = pows[int(r0 - carson):int(r0 + carson) + 1]
    over = int((band > 25.0 * med).sum())
    log("binary: %d x %g s series (f %g Hz, Pb %g s, x %g lt-s, amp %g, "
        "seed %d) made in %.2f s; sideband peak power %.1f x the noise "
        "mean noise-free, the spectrum's %d bins within f +- %.1f bins: %d "
        "over prune_powers' 25x median (max %.1f x)"
        % (c["N"], c["dt"], c["f"], c["pb"], c["x"], c["amp"], c["seed"],
           make_s, peak_pow, band.size, carson, over, band.max() / med))
    del pows, band

    # 2. search_bin at its defaults over the whole spectrum
    with MiniFFTClock() as clock:
        torch.cuda.synchronize()
        t0 = time.time()
        cands, out = _cli_out(search_bin.run, search_bin.build_parser()
                              .parse_args([base + ".fft"]), device=device)
        torch.cuda.synchronize()
        full_s = time.time() - t0
    sizes, dev_ms = clock.by_size()
    nwin = sum(r[1] for r in sizes.values())
    top = cands[0] if cands else None
    full_ok = (top is not None
               and abs(top.orb_p - c["pb"]) / c["pb"] < 0.10
               and abs(top.psr_p * c["f"] - 1.0) < 0.05)
    log("binary: search_bin (minfft 32, maxfft 65536, harmsum 3) on the "
        "card over %d bins %.2f s host: %d windows, miniFFT programs %.1f "
        "ms of CUDA-event spans (each program's launches included; host "
        "share %.3f); per size {fftlen: [calls, windows, ms]} %s; %d "
        "candidates, top sigma %.2f orb_p %.1f s psr_p %.7f s "
        "(Pb %g, 1/f %g) %s"
        % (amps.size, full_s, nwin, dev_ms, 1.0 - dev_ms / 1e3 / full_s,
           json.dumps({k: [v[0], v[1], round(v[2], 3)]
                       for k, v in sorted(sizes.items())}),
           len(cands), top.mini_sigma if top else 0.0,
           top.orb_p if top else 0.0, top.psr_p if top else 0.0, c["pb"],
           1.0 / c["f"], "ok" if full_ok else "FAIL"))
    top_cand = base + "_bin3.cand"

    # 3. the same CLI over BINARY_CPU_BINS, on the card and on the CPU
    rlo, rhi = int(r0) - BINARY_CPU_BINS // 2, int(r0) + BINARY_CPU_BINS // 2
    band_lists, band_s = {}, {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        d = os.path.join(workdir, "band_" + where)
        os.makedirs(d)
        for ext in (".fft", ".inf"):
            os.symlink(base + ext, os.path.join(d, "binary" + ext))
        torch.cuda.synchronize()
        t0 = time.time()
        band_lists[where], _ = _cli_out(
            search_bin.run, search_bin.build_parser().parse_args(
                ["-rlo", str(rlo), "-rhi", str(rhi),
                 os.path.join(d, "binary.fft")]), device=dev)
        torch.cuda.synchronize()
        band_s[where] = time.time() - t0
    band_ok, ties, perr, matched = bincands_agreement(band_lists["card"],
                                                      band_lists["cpu"])
    for t in ties:
        log("binary: search_bin card/CPU tie %s" % (t,))
    log("binary: search_bin -rlo %d -rhi %d on the card %.2f s, on the CPU "
        "%.2f s; %d / %d candidates, %d keys in the same order, mini_power "
        "max rel err %.3g (bound %g), %d ties (sigma within %g) %s"
        % (rlo, rhi, band_s["card"], band_s["cpu"], len(band_lists["card"]),
           len(band_lists["cpu"]), matched, perr, BINARY_POWER_RTOL,
           len(ties), BINARY_TIE_SIGMA, "ok" if band_ok else "FAIL"))

    # 4. bincand from the perturbed trial, card and CPU; -candfile
    trial = ["-ppsr", "%.12g" % (1.0 / c["f"]), "-porb",
             "%.12g" % (c["pb"] * BINARY_TRIAL["porb"]), "-x",
             "%.12g" % (c["x"] * BINARY_TRIAL["x"]), base + ".fft"]
    bc, bc_s = {}, {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        with CorrRecorder() as rec:
            t0 = time.time()
            _, out = _cli_out(bincand.main, trial, device=dev)
            bc_s[where] = time.time() - t0
        bc[where] = (_bincand_orbit(out), rec.rounds)
        if where == "card":
            corr_ms = [r[3] for r in rec.rounds]
            build_s = list(rec.build_s)
    (pb_c, x_c, pw_c), rounds_c = bc["card"]
    (pb_u, x_u, pw_u), rounds_u = bc["cpu"]
    same_grid = [a[0] == b[0] for a, b in zip(rounds_c, rounds_u)]
    rerr = max(abs(a[1] - b[1]) / b[1] for a, b in zip(rounds_c, rounds_u))
    bc_ok = (len(rounds_c) == len(rounds_u) == 2 and all(same_grid)
             and rerr <= BINARY_POWER_RTOL and pb_c == pb_u and x_c == x_u
             and abs(pb_c - c["pb"]) / c["pb"] < 0.05
             and abs(x_c - c["x"]) / c["x"] < 0.25)
    t0 = time.time()
    _, out = _cli_out(bincand.main, ["-candfile", top_cand, base + ".fft"],
                      device=device)
    cf_s = time.time() - t0
    cf = _bincand_orbit(out)
    log("binary: bincand -porb %g -x %g (%d templates a round) on the card "
        "%.2f s, on the CPU %.2f s: P_orb %.8g s (%.2f%% off Pb), x %.6g "
        "lt-s (%.1f%% off), power %.3f / %.3f; grid orbit equal each round "
        "%s, round powers max rel err %.3g (bound %g); on the card the "
        "rounds' template builds %s s host, correlations %s device ms; "
        "-candfile on the top candidate %.2f s: P_orb %.8g s, x %.6g lt-s, "
        "power %.3f %s"
        % (c["pb"] * BINARY_TRIAL["porb"], c["x"] * BINARY_TRIAL["x"],
           rounds_c[0][2] if rounds_c else 0, bc_s["card"], bc_s["cpu"],
           pb_c, 100.0 * abs(pb_c - c["pb"]) / c["pb"], x_c,
           100.0 * abs(x_c - c["x"]) / c["x"], pw_c, pw_u, same_grid, rerr,
           BINARY_POWER_RTOL, [round(b, 3) for b in build_s],
           [round(m, 3) for m in corr_ms], cf_s, cf[0], cf[1], cf[2],
           "ok" if bc_ok else "FAIL"))

    # 5. monte_binresp at the JAX test's campaign, launches around it
    mjson = os.path.join(workdir, "monte.json")
    read = launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    _, out = _cli_out(monte_binresp.main, BINARY_MONTE + ["-q", "-o", mjson],
                      device=device)
    torch.cuda.synchronize()
    monte_s = time.time() - t0
    launches = read()
    launches.pop("stage_reduce_planes")
    frac = json.load(open(mjson))["results"]
    monte_ok = (frac["0.1"]["long"] >= 0.5 and frac["20.0"]["ffdot"] >= 0.5
                and frac["0.1"]["ffdot"] < frac["0.1"]["long"]
                and all(v >= 1 for v in launches.values()))
    margs = monte_binresp.build_parser().parse_args(BINARY_MONTE)
    ntrials = len(margs.ratios) * margs.ntrials
    log("binary: monte_binresp %s on the card %.2f s (%.2f s a trial), "
        "launches %s; detection %s %s"
        % (" ".join(BINARY_MONTE), monte_s, monte_s / ntrials,
           json.dumps(launches), json.dumps(frac),
           "ok" if monte_ok else "FAIL"))
    # the campaign's first trial (the generator's first draws)
    mcfg = monte.MonteConfig(N=margs.N, dt=margs.dt, f_psr=margs.fpsr,
                             amp=margs.amp, asini_lts=margs.asini,
                             sigma_cut=margs.sigma)
    x = monte._make_trial(mcfg, margs.ratios[0] * mcfg.tobs,
                          np.random.default_rng(margs.seed))
    pairs = fftpack.realfft_packed_pairs(
        torch.from_numpy(x - x.mean()).to(device))
    kgen = torch.Generator(device=device)
    kgen.manual_seed(BINARY_PSR["seed"])
    acfg = monte._make_accel(mcfg, mcfg.N // 2, device).cfg
    kern = recipe_kernels(acfg, mcfg.tobs, mcfg.N // 2, pairs, kgen,
                          "monte ffdot (zmax %d, numharm %d, uselen %d)"
                          % (acfg.zmax, acfg.numharm, acfg.uselen),
                          device, uselen=acfg.uselen)
    del pairs
    torch.cuda.empty_cache()
    kern_ok = kern[0]["ok"] and kern[1]["ok"]

    # 6. quicklook on the .dat
    t0 = time.time()
    _, out = _cli_out(quicklook.main, [dat], device=device)
    ql_s = time.time() - t0
    rows = [ln.split() for ln in out.splitlines()[2:] if ln.strip()]
    f_top = float(rows[0][1])
    off = (f_top - c["f"]) * T
    ql_ok = abs(off) <= carson
    log("binary: quicklook on the .dat %.2f s: top peak %.6f Hz (bin %s, "
        "power/med %s), %.1f bins from f, within the Carson bandwidth +-%.1f "
        "bins %s" % (ql_s, f_top, rows[0][0], rows[0][2], off, carson,
                     "ok" if ql_ok else "FAIL"))
    phase_s = time.time() - t_phase
    ok = full_ok and band_ok and bc_ok and monte_ok and kern_ok and ql_ok
    log("binary: phase %.1f s %s" % (phase_s, "ok" if ok else "FAIL"))
    return dict(ok=ok, make_s=make_s, sideband_peak_power=peak_pow,
                bins_over_prune_cutoff=over,
                search_bin=dict(seconds=full_s, windows=nwin,
                                device_ms=dev_ms,
                                host_share=1.0 - dev_ms / 1e3 / full_s,
                                by_size={str(k): v for k, v in sizes.items()},
                                top=dict(sigma=top.mini_sigma if top else 0,
                                         orb_p=top.orb_p if top else 0,
                                         psr_p=top.psr_p if top else 0)),
                band=dict(seconds=band_s, ties=len(ties),
                          power_rel_err=perr, matched=matched),
                bincand=dict(seconds=bc_s, card=bc["card"][0],
                             cpu=bc["cpu"][0], candfile=cf,
                             candfile_s=cf_s, template_build_s=build_s,
                             corr_ms=corr_ms),
                monte=dict(seconds=monte_s, detection=frac),
                launches=launches, plane_build=kern[0], stage_reduce=kern[1],
                quicklook=dict(seconds=ql_s, f_top=f_top, off_bins=off),
                phase_s=phase_s)


# the plots phase: the .pfd plot's panels (plotting/pfdplot.pfd_panels)
# on the card against the same function on the CPU.  The plane and the
# DM curve are float32 rotate-and-sums that the card and the CPU reduce
# in their own order (the fold phase's surfaces differ by ~1e-5 of their
# maximum): PLOTS_RTOL of the array's maximum.  The growth curve is
# float64 cumulative sums: PLOTS_GROWTH_RTOL.
PLOTS_RTOL = 1e-4
PLOTS_GROWTH_RTOL = 1e-12
PLOTS_BUDGET_S = 60.0


def phase_plots(pfddir, card, device="cuda"):
    """The .pfd plots' numbers on the card (phase_plots): every .pfd in
    ``pfddir`` (the main survey's three folds, fold_cand1-3, and the fold
    phase's fold_fil, the one with a DM curve and a P-Pdot plane) through
    pfd_panels on ``device`` and on the CPU, the plane, the DM curve and
    the growth curve held within PLOTS_RTOL / PLOTS_GROWTH_RTOL of their
    maximum; the plane's call timed by CUDA events around it (warm, a mean
    of 3: the host's trial offsets, the upload, the trials, the download);
    then prepfold without -noplot on a .dat of the survey, which must
    raise ImportError naming matplotlib before any work where matplotlib
    is missing (as on the card's machine), or draw its .pfd.png where it
    is installed.  The phase must end within PLOTS_BUDGET_S."""
    import importlib.util
    from presto_tpu_torch.apps import prepfold
    from presto_tpu_torch.io.pfd import read_pfd
    from presto_tpu_torch.plotting import pfdplot
    t_phase = time.time()
    paths = sorted(glob.glob(os.path.join(pfddir, "*.pfd")))
    ok = bool(paths)
    files = {}
    for path in paths:
        p = read_pfd(path)
        torch.cuda.synchronize()
        t0 = time.time()
        got = pfdplot.pfd_panels(p, device=device)
        card_s = time.time() - t0
        t0 = time.time()
        want = pfdplot.pfd_panels(p, device="cpu")
        cpu_s = time.time() - t0
        errs, good = {}, True
        for key, rtol in (("plane", PLOTS_RTOL), ("dm_chi2", PLOTS_RTOL),
                          ("growth", PLOTS_GROWTH_RTOL)):
            a, c = got[key], want[key]
            if a is None or c is None:
                good = good and a is None and c is None
                errs[key] = None
                continue
            scale = float(np.abs(c).max()) or 1.0
            errs[key] = float(np.abs(a - c).max()) / scale
            good = (good and a.shape == c.shape
                    and bool(np.isfinite(a).all())
                    and errs[key] <= rtol)
        plane_ms = None
        if got["plane"] is not None:
            profs = np.asarray(p.profs, float)
            tvph = profs.sum(axis=1)
            plane_ms = cuda_time_ms(lambda: pfdplot._ppd_chi2_plane(
                p, tvph, device), 3)
        shape = None if got["plane"] is None else list(got["plane"].shape)
        ndm = 0 if got["dm_chi2"] is None else len(got["dm_chi2"])
        log("plots: %s (%d parts x %d subbands x %d bins): panels on the "
            "card %.3f s, on the CPU %.3f s; plane %s in %s ms (CUDA "
            "events around the call, warm; %s); "
            "DM curve %d DMs; card vs CPU max |diff| / max %s (tolerance "
            "%g, growth %g) %s"
            % (os.path.basename(path), p.npart, p.nsub, p.proflen, card_s,
               cpu_s, shape, "%.3f" % plane_ms if plane_ms else "-", card,
               ndm, json.dumps({k: (None if v is None else
                                    float("%.3g" % v))
                                for k, v in errs.items()}),
               PLOTS_RTOL, PLOTS_GROWTH_RTOL, "ok" if good else "FAIL"))
        files[os.path.basename(path)] = dict(
            ok=good, card_s=card_s, cpu_s=cpu_s, plane_shape=shape,
            plane_ms=plane_ms, numdms=ndm, rel_err=errs)
        ok = ok and good
    planes = [f for f in files.values() if f["plane_shape"]]
    ok = ok and bool(planes)
    # a prepfold run that would draw, on the card
    dats = sorted(glob.glob(os.path.join(pfddir, "*.dat")))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    out = os.path.join(pfddir, "plots_refusal")
    argv = ["-f", "40.3", "-nosearch", "-n", "64", "-npart", "16", "-o",
            out, dats[0]] if dats else []
    t0 = time.time()
    try:
        prepfold.main(argv, device=device)
        raised = None
    except ImportError as e:
        raised = str(e)
    refusal_s = time.time() - t0
    if have_mpl:
        refusal_ok = raised is None and os.path.exists(out + ".pfd.png")
    else:
        refusal_ok = (raised is not None and "matplotlib" in raised
                      and not os.path.exists(out + ".pfd"))
    refusal_ok = refusal_ok and bool(dats)
    log("plots: prepfold without -noplot on %s (matplotlib %s): %s in "
        "%.3f s %s" % (os.path.basename(dats[0]) if dats else "no .dat",
                       "installed" if have_mpl else "missing",
                       "drew %s.pfd.png" % os.path.basename(out)
                       if raised is None else "ImportError: %s" % raised,
                       refusal_s, "ok" if refusal_ok else "FAIL"))
    phase_s = time.time() - t_phase
    in_budget = phase_s <= PLOTS_BUDGET_S
    log("plots: phase %.1f s of its %.0f s budget (%s) %s"
        % (phase_s, PLOTS_BUDGET_S, card, "ok" if in_budget else "FAIL"))
    return dict(ok=ok and refusal_ok and in_budget, files=files,
                matplotlib=have_mpl, refusal=raised, refusal_ok=refusal_ok,
                phase_s=phase_s, budget_s=PLOTS_BUDGET_S,
                tolerance="plane and DM curve within %g of their maximum, "
                "growth within %g" % (PLOTS_RTOL, PLOTS_GROWTH_RTOL))


# the tools phase.  The referee's spectrum is tests/test_referee.py's: 2^19
# bins of T = 600 s, noise and four chirped tones (r0, z, amp), seed 99,
# searched at zmax 100, numharm 8, sigma 4.  The injected pulsar goes into
# the beam at f 17.3 Hz and DM 23 (beside the beam's 40.3, 7.13 and
# 113.7 Hz pulsars), at a matched S/N of 1000 against the beam's
# per-channel noise, above the beam's own pulsars by the same measure
# (amp_for_snr).  calibrate's rule (a candidate within 2% of a harmonic or
# subharmonic k <= 16 of f, DM within 3) also meets harmonics of the
# beam's pulsars in a search of the beam alone (40.3 x 3 = 120.9 Hz against
# 17.3 x 7 = 121.1 Hz), so the control is labelled twice: by that rule,
# whose matches are counted and named, and at the search's own frequency
# resolution (f_tol = R_ERR / (T f), 1.1 Fourier bins at f), which must
# label nothing.
TOOLS_REFEREE = dict(numbins=1 << 19, T=600.0, zmax=100, numharm=8,
                     sigma=4.0, seed=99,
                     tones=((9000.5, 0.0, 0.035), (50000.25, 40.0, 0.05),
                            (200000.0, -80.0, 0.06),
                            (401234.6, 12.0, 0.045)))
TOOLS_INJECT = dict(f=17.3, dm=23.0, snr=1000.0)
TOOLS_BUDGET_S = 90.0


def chirp_pairs(numbins, tones, seed):
    """tests/test_referee.py's _chirp_pairs: the packed spectrum of unit
    noise plus tones (r0, z, amp) that start at bin r0 and drift z bins
    over the observation."""
    N = 2 * numbins
    rng = np.random.default_rng(seed)
    t = np.arange(N) / N
    x = rng.normal(size=N)
    for (r0, z, amp) in tones:
        x += amp * np.cos(2 * np.pi * (r0 * t + 0.5 * z * t * t))
    X = np.fft.rfft(x)[:numbins]
    return np.stack([X.real, X.imag], -1).astype(np.float32)


def _run_cli(main_fn, argv, **kw):
    """(exit code, seconds, stdout lines) of one CLI run in-process: the
    code main returned (None is 0) or its SystemExit's; an exception is
    its text."""
    t0 = time.time()
    try:
        rc, out = _cli_out(main_fn, argv, **kw)
        rc = 0 if rc is None else rc
    except SystemExit as e:
        rc, out = e.code, ""
    except Exception as e:                  # noqa: BLE001 (reported)
        rc, out = "%s: %s" % (type(e).__name__, e), ""
    return rc, time.time() - t0, len(out.splitlines())


def tools_search(fil, workdir, device):
    """prepdata -dm TOOLS_INJECT's DM -nobary, realfft, accelsearch -zmax 0
    -numharm 8 on ``device`` (the port's CLIs), the ACCEL file sifted
    (sifting.sift_candidates: one DM, so no DM check); (candidates,
    host seconds, the kernel launches read from zero around
    accelsearch)."""
    from presto_tpu_torch.apps import accelsearch, prepdata, realfft
    from presto_tpu_torch.pipeline import sifting
    os.makedirs(workdir)
    base = os.path.join(workdir, "beam")
    torch.cuda.synchronize()
    t0 = time.time()
    _cli_out(prepdata.main, ["-dm", "%.1f" % TOOLS_INJECT["dm"], "-nobary",
                             "-o", base, fil], device=device)
    _cli_out(realfft.main, [base + ".dat"], device=device)
    read = launch_counts()
    _cli_out(accelsearch.main, ["-zmax", "0", "-numharm", "8",
                                base + ".fft"], device=device)
    torch.cuda.synchronize()
    secs = time.time() - t0
    return (list(sifting.sift_candidates([base + "_ACCEL_0"])), secs,
            read())


def phase_tools(raw, workdir, mwork, short, device="cuda"):
    """The last host tools (phase_tools), in three parts.
    1. The float64 referee against the card: TOOLS_REFEREE's spectrum
       searched by the port's AccelSearch on ``device`` (CUDA events, the
       first call and a warm one), remove_duplicates, held by
       search/accel_ref.agreement (tests/test_referee.py's rule) to
       accel_ref.search_ref in float64 on the host over the same search's
       geometry, and each tone found on both sides at its mid-observation
       r; both kernels against their plain versions at this search's
       geometry on this spectrum (recipe_kernels).
    2. An injected pulsar through the card's search, labelled by triage:
       injectpsr (-snr TOOLS_INJECT's, -noise the beam's median channel
       std) into ``short`` (the short beam) at full width, its host
       seconds; prepdata,
       realfft and accelsearch -zmax 0 on the card (tools_search); the
       sifted candidates labelled by triage/calibrate against the
       injection's sidecar, by calibrate's rule and at the search's
       resolution: the injected pulsar (or a harmonic) labelled by both;
       the same search of the short beam alone labels nothing at the search's
       resolution (its matches by calibrate's 2% rule are reported);
       both kernels against their plain versions at accelsearch -zmax 0
       -numharm 8's geometry (numz 1, 4 stages) on the injected .fft.
    3. The host CLIs on the main survey's files (copies in the phase's
       directory where a CLI writes beside its input): readfile on the
       .fil, a .dat, a .fft, a .pfd, the .mask (-int: its numchan,
       numint and ptsperint) and an ACCEL
       .cand (-rzwcand); rfifind_stats; ddplan without -o; dat2tim then
       tim2dat, byte-equal to the .dat; downsample; quick_prune_cands;
       powerstats; dftfold at the injected f; rednoise: each exits 0.
       quickffdots must raise ImportError naming matplotlib within 1 s
       where matplotlib is missing (the card's machine), or draw.
    The kernel launches are read from zero around the referee's card
    searches and the two accelsearch runs, not around the kernels'
    checks.  The phase must end within TOOLS_BUDGET_S."""
    import importlib.util
    from presto_tpu_torch.apps import (dat2tim, ddplan, dftfold, downsample,
                                       injectpsr, powerstats,
                                       quick_prune_cands, quickffdots,
                                       readfile, rednoise, rfifind_stats,
                                       tim2dat)
    from presto_tpu_torch.apps.common import load_spectrum
    from presto_tpu_torch.io.sigproc import FilterbankFile
    from presto_tpu_torch.models.inject import truth_sidecar_path
    from presto_tpu_torch.pipeline import sifting
    from presto_tpu_torch.search import accel_ref
    from presto_tpu_torch.search.accel import (AccelConfig, AccelSearch,
                                               remove_duplicates)
    from presto_tpu_torch.triage.calibrate import label_candidates, load_truth
    t_phase = time.time()
    os.makedirs(workdir)

    # 1. the referee
    r = TOOLS_REFEREE
    pairs = chirp_pairs(r["numbins"], r["tones"], r["seed"])
    cfg = AccelConfig(zmax=r["zmax"], numharm=r["numharm"], sigma=r["sigma"])
    s = AccelSearch(cfg, T=r["T"], numbins=r["numbins"], device=device)
    dpairs = torch.as_tensor(pairs, device=device)
    card_ms = []
    read = launch_counts()
    for _ in range(2):
        e0, e1 = cuda_event(), cuda_event()
        e0.record()
        raw_dev = s.search(dpairs)
        e1.record()
        torch.cuda.synchronize()
        card_ms.append(e0.elapsed_time(e1))
    launches = read()
    dev = remove_duplicates(raw_dev)
    t0 = time.time()
    ref = remove_duplicates(accel_ref.search_ref(pairs, s, dtype=np.float64))
    ref_s = time.time() - t0
    agr = accel_ref.agreement(dev, ref, cfg.sigma)
    tones_ok = all(any(abs(c.r - (r0 + 0.5 * z)) < 7.5 for c in lst)
                   for (r0, z, _a) in r["tones"] for lst in (dev, ref))
    kern = {"referee": recipe_kernels(
        cfg, r["T"], r["numbins"], dpairs, None,
        "tools referee (zmax %d, numharm %d)" % (r["zmax"], r["numharm"]),
        device)}
    ref_ok = agr["ok"] and tones_ok and all(k["ok"]
                                            for k in kern["referee"])
    log("tools: referee: %d bins, zmax %d, numharm %d, sigma %g; the "
        "card's search %.3f ms first, %.3f ms warm (CUDA events), %d "
        "candidates after remove_duplicates (%d strong); the float64 "
        "referee on the host %.3f s, %d candidates (%d strong); %d isolated "
        "strong candidates equal, largest sigma difference %.3g, power "
        "%.3g relative; tones found %s; %s%s"
        % (r["numbins"], r["zmax"], r["numharm"], r["sigma"], card_ms[0],
           card_ms[1], agr["n_dev"], agr["n_dev_strong"], ref_s,
           agr["n_ref"], agr["n_ref_strong"], agr["exact"],
           agr["max_sigma_diff"], agr["max_power_rdiff"], tones_ok,
           "ok" if ref_ok else "FAIL", "".join(
               "\n  " + f for f in agr["failures"][:20])))
    del s, dpairs
    torch.cuda.empty_cache()

    # 2. an injected pulsar through the card's search, labelled by triage
    inj = os.path.join(workdir, "inj.fil")
    with FilterbankFile(short) as fb:
        nspec, tsamp = fb.header.N, fb.header.tsamp
        noise = float(np.median(fb.read_spectra(0, 1 << 16).std(axis=0)))
    i = TOOLS_INJECT
    t0 = time.time()
    rc, out = _cli_out(injectpsr.main, [
        "-f", str(i["f"]), "-dm", str(i["dm"]), "-snr", str(i["snr"]),
        "-noise", "%.4f" % noise, "-o", inj, short])
    inject_s = time.time() - t0
    truth = load_truth(truth_sidecar_path(inj))
    T = nspec * tsamp
    tight = sifting.R_ERR / (T * i["f"])
    runs = {}
    for name, fil in (("injected", inj), ("control", short)):
        cands, secs, n = tools_search(fil, os.path.join(workdir, name),
                                      device)
        launches = {k: v + n[k] for k, v in launches.items()}
        rule = label_candidates(cands, truth)
        res = label_candidates(cands, truth, f_tol=tight)
        runs[name] = dict(
            search_s=secs, ncands=len(cands),
            labelled=[(c.f, c.sigma, c.numharm) for c, x in zip(cands, rule)
                      if x],
            labelled_at_resolution=[(c.f, c.sigma, c.numharm) for c, x in
                                    zip(cands, res) if x],
            top=[(c.f, c.sigma) for c in cands[:5]])
    ipairs, info = load_spectrum(os.path.join(workdir, "injected", "beam"))
    kern["injected"] = recipe_kernels(
        AccelConfig(zmax=0, numharm=8, sigma=2.0, flo=1.0), info.N * info.dt,
        ipairs.shape[0], torch.as_tensor(ipairs, device=device), None,
        "tools injected (zmax 0, numharm 8)", device)
    del ipairs
    torch.cuda.empty_cache()
    hit = runs["injected"]["labelled_at_resolution"]
    inj_ok = (rc == 0 and len(truth) == 1 and bool(runs["injected"][
        "labelled"]) and bool(hit)
              and not runs["control"]["labelled_at_resolution"]
              and all(k["ok"] for k in kern["injected"]))
    log("tools: injectpsr -f %g -dm %g -snr %g -noise %.4f into the short "
        "beam (%d x %d spectra, full width) on the host %.2f s: %s; sidecar "
        "%d record(s)"
        % (i["f"], i["dm"], i["snr"], noise, nspec,
           BEAM["nchan"], inject_s, out.strip(), len(truth)))
    for name, v in runs.items():
        log("tools: %s: prepdata + realfft + accelsearch on the card %.2f s, "
            "%d sifted candidates (top 5 f Hz, sigma: %s); calibrate's rule "
            "labels %d %s; at the search's resolution (f_tol %.3g) %d %s"
            % (name, v["search_s"], v["ncands"],
               ", ".join("%.4f %.1f" % c for c in v["top"]),
               len(v["labelled"]),
               ["%.4f (%.1f, %d harm)" % c for c in v["labelled"]], tight,
               len(v["labelled_at_resolution"]),
               ["%.4f (%.1f, %d harm)" % c
                for c in v["labelled_at_resolution"]]))
    log("tools: injected pulsar labelled (%s), control labels nothing at "
        "the search's resolution: %s"
        % ("%.4f Hz, sigma %.1f" % hit[0][:2] if hit else "none",
           "ok" if inj_ok else "FAIL"))

    # 3. the host CLIs on the main survey's files
    cli = os.path.join(workdir, "cli")
    os.makedirs(cli)
    d22 = "psr_DM%.2f" % BEAM["dm"]
    for f in (d22 + ".dat", d22 + ".inf", d22 + ".fft",
              d22 + "_ACCEL_%d" % main_cfg().zmax,
              d22 + "_ACCEL_%d.cand" % main_cfg().zmax,
              "psr_rfifind.mask", "psr_rfifind.stats", "psr_rfifind.inf"):
        shutil.copy(os.path.join(mwork, f), cli)

    def c(f):
        return os.path.join(cli, f)

    pfd = sorted(glob.glob(os.path.join(mwork, "fold_cand*.pfd")))[0]
    accel = c(d22 + "_ACCEL_%d" % main_cfg().zmax)
    injdat = os.path.join(workdir, "injected", "beam.dat")
    runs_cli = [
        ("readfile", readfile.main, ["-n", "4", raw, c(d22 + ".dat"),
                                     c(d22 + ".fft"), pfd]),
        ("readfile -int (mask)", readfile.main,
         ["-int", "-index", "12", "15", c("psr_rfifind.mask")]),
        ("readfile -rzwcand (ACCEL)", readfile.main,
         ["-rzwcand", accel + ".cand"]),
        ("rfifind_stats", rfifind_stats.main, [c("psr_rfifind.mask")]),
        ("ddplan", ddplan.main, ["-l", "20", "-d", "24", raw]),
        ("dat2tim", dat2tim.main, [c(d22 + ".dat")]),
        ("tim2dat", tim2dat.main, ["-o", c("back"), c(d22 + ".tim")]),
        ("downsample", downsample.main, ["-factor", "4", c(d22 + ".dat")]),
        ("quick_prune_cands", quick_prune_cands.main, [accel]),
        ("powerstats", powerstats.main, ["-power", "40", "-numsum", "8",
                                         "-numtrials", "1e7", "-sigma",
                                         "6"]),
        ("dftfold", dftfold.main, ["-n", "32", "-f", str(i["f"]), injdat]),
        ("rednoise", rednoise.main, [c(d22 + ".fft")]),
    ]
    clis = {}
    for name, fn, argv in runs_cli:
        rc, secs, nlines = _run_cli(fn, argv)
        clis[name] = dict(rc=rc, s=secs, lines=nlines)
    same = (os.path.exists(c("back.dat")) and open(c("back.dat"), "rb").read()
            == open(c(d22 + ".dat"), "rb").read())
    clis_ok = all(v["rc"] == 0 for v in clis.values()) and same
    log("tools: host CLIs: %s; tim2dat(dat2tim(.dat)) equals the .dat: %s %s"
        % ("; ".join("%s rc %s %.2f s (%d lines)" % (k, v["rc"], v["s"],
                                                      v["lines"])
                     for k, v in clis.items()), same,
           "ok" if clis_ok else "FAIL"))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    png = c("ffdots.png")
    t0 = time.time()
    try:
        _cli_out(quickffdots.main, ["-nr", "11", "-nz", "5", "-o", png,
                                    c(d22 + ".fft"), "40.3"])
        raised = None
    except ImportError as e:
        raised = str(e)
    refusal_s = time.time() - t0
    if have_mpl:
        refusal_ok = raised is None and os.path.exists(png)
    else:
        refusal_ok = (raised is not None and "matplotlib" in raised
                      and refusal_s <= 1.0 and not os.path.exists(png))
    log("tools: quickffdots (matplotlib %s): %s in %.3f s %s"
        % ("installed" if have_mpl else "missing",
           "drew ffdots.png" if raised is None else "ImportError: %s"
           % raised, refusal_s, "ok" if refusal_ok else "FAIL"))
    phase_s = time.time() - t_phase
    in_budget = phase_s <= TOOLS_BUDGET_S
    launched = launches["plane_build"] >= 1 and launches["stage_reduce"] >= 1
    log("tools: kernel launches around the searches %s %s; phase %.1f s of "
        "its %.0f s budget %s"
        % (json.dumps(launches), "ok" if launched else "FAIL", phase_s,
           TOOLS_BUDGET_S, "ok" if in_budget else "FAIL"))
    return dict(ok=ref_ok and inj_ok and clis_ok and refusal_ok
                and launched and in_budget, launches=launches,
                plane_build={k: v[0] for k, v in kern.items()},
                stage_reduce={k: v[1] for k, v in kern.items()},
                referee=dict(ok=ref_ok, card_ms=card_ms, host_s=ref_s,
                             tones_ok=tones_ok,
                             **{k: v for k, v in agr.items() if k != "ok"}),
                inject=dict(ok=inj_ok, host_s=inject_s, noise=noise,
                            f_tol_resolution=tight, **runs),
                clis=clis, dat2tim_tim2dat_equal=same,
                matplotlib=have_mpl, refusal=raised, refusal_s=refusal_s,
                refusal_ok=refusal_ok, phase_s=phase_s,
                budget_s=TOOLS_BUDGET_S)


DEVTOOLS_BUDGET_S = 60.0


def phase_devtools(workdir, device="cuda"):
    """The port's developer tools on the card (see the module docstring,
    phase 6m): profile_accel's stage split at the headline, perf_gate's
    measured episodes and its deliberate slowdown, both kernels at the
    two tools' geometries, and the port's lint in a process of its own.
    The phase must end within DEVTOOLS_BUDGET_S."""
    from presto_tpu_torch.apps import perf_gate, profile_accel
    from presto_tpu_torch.obs import perfledger
    from presto_tpu_torch.search.accel import AccelConfig
    os.makedirs(workdir, exist_ok=True)
    t_phase = time.time()
    read = launch_counts()
    pj = os.path.join(workdir, "profile_accel.json")
    prof_rc = profile_accel.main(["--reps", "5", "--json", pj,
                                  "--device", device])
    with open(pj) as f:
        prof = json.load(f)
    prof_ok = (prof_rc == 0 and prof["same_as_search"]
               and all(prof["tones_found"].values())
               and len(prof["tones_found"]) == len(profile_accel.ACCEL_TONES))
    log("devtools: profile_accel rc %d, %d candidates equal to search(): "
        "%s, tones %s %s"
        % (prof_rc, len(prof["candidates"]), prof["same_as_search"],
           json.dumps(prof["tones_found"]), "ok" if prof_ok else "FAIL"))
    ledger = os.path.join(workdir, "perf_ledger.json")
    gate_rcs = [perf_gate.main(["--measure", "--ledger", ledger,
                                "--device", device]) for _ in range(3)]
    inject_rc = perf_gate.main(["--inject-slowdown", "2.0", "--ledger",
                                ledger])
    launches = read()
    episodes = perfledger.PerfLedger.load(ledger).episodes
    # the first episode seeds; the later two are gated and their
    # verdicts logged, not required (PR 21's host-clock episodes drifted
    # by about the gate's 15% on the card's shared host; the device-time
    # statistic is new, PERF.md §6); this checks that it measures, gates
    # and trips on the injected 2x slowdown
    gate_ok = (gate_rcs[0] == 0 and set(gate_rcs) <= {0, 1}
               and inject_rc == 1 and len(episodes) == 3
               and all(np.isfinite(m["median"]) and m["median"] > 0
                       for ep in episodes for m in ep["metrics"].values()))
    log("devtools: perf_gate --measure x3 rc %s (%d flagged), "
        "--inject-slowdown 2.0 rc %d, %d episodes: %s %s"
        % (gate_rcs, sum(gate_rcs[1:]), inject_rc, len(episodes),
           json.dumps([{k: v["median"] for k, v in ep["metrics"].items()}
                       for ep in episodes]), "ok" if gate_ok else "FAIL"))
    # each episode's MAD as a share of its median (device samples, and
    # the host clock's samples of the whole calls beside them), and the
    # injected 2x episode's rows against the gate's threshold
    shares = [{k: m["mad"] / m["median"] for k, m in ep["metrics"].items()}
              for ep in episodes]
    host_shares = [{k: float(np.median(np.abs(np.asarray(v)
                                               - np.median(v))))
                    / float(np.median(v))
                    for k, v in ep["meta"].get("host_samples_s", {}).items()}
                   for ep in episodes]
    inj = perfledger.gate(perfledger.inject_slowdown(episodes[-1], 2.0),
                          episodes)
    log("devtools: perf_gate statistic %s; MAD / median by episode %s "
        "(host clock's samples %s); the 2x injection: %s"
        % (episodes[-1]["meta"].get("statistic"), json.dumps(shares),
           json.dumps(host_shares),
           json.dumps([{k: r[k] for k in ("metric", "value", "baseline",
                                          "delta_worse", "threshold",
                                          "noise_band", "status")}
                       for r in inj["rows"]])))
    launched = launches["plane_build"] >= 1 and launches["stage_reduce"] >= 1
    gen = torch.Generator(device=device)
    gen.manual_seed(2121)
    kern = {}
    for label, acfg, T, pairs in (
            ("headline", AccelConfig(zmax=profile_accel.ACCEL_ZMAX,
                                     numharm=profile_accel.ACCEL_NUMHARM,
                                     sigma=profile_accel.ACCEL_SIGMA),
             profile_accel.ACCEL_T, profile_accel.make_accel_input()),
            ("smoke", AccelConfig(zmax=perf_gate.SMOKE["accel_zmax"],
                                  numharm=perf_gate.SMOKE["accel_numharm"],
                                  sigma=perf_gate.SMOKE_SIGMA),
             perf_gate.SMOKE_T, perf_gate.smoke_pairs())):
        kern[label] = recipe_kernels(
            acfg, T, pairs.shape[0], torch.as_tensor(pairs, device=device),
            gen, "devtools " + label, device=device)
        torch.cuda.empty_cache()
    kern_ok = all(v["ok"] for pair in kern.values() for v in pair)
    t0 = time.time()
    lint = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.apps.presto_lint", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    lint_s = time.time() - t0
    try:
        report = json.loads(lint.stdout)
    except ValueError:
        report = {"ok": False, "findings": [], "stderr": lint.stderr[-2000:]}
    lint_ok = lint.returncode == 0 and report.get("ok") is True
    log("devtools: presto_lint --json rc %d in %.1f s: %d families, %d "
        "findings, %d suppressed %s"
        % (lint.returncode, lint_s, len(report.get("checks", ())),
           len(report.get("findings", ())), report.get("suppressed", 0),
           "ok" if lint_ok else "FAIL: %s" % json.dumps(report)[:2000]))
    phase_s = time.time() - t_phase
    in_budget = phase_s <= DEVTOOLS_BUDGET_S
    log("devtools: kernel launches around profile_accel and perf_gate %s "
        "%s; phase %.1f s of its %.0f s budget %s"
        % (json.dumps(launches), "ok" if launched else "FAIL", phase_s,
           DEVTOOLS_BUDGET_S, "ok" if in_budget else "FAIL"))
    return dict(ok=prof_ok and gate_ok and kern_ok and lint_ok and launched
                and in_budget, launches=launches,
                plane_build={k: v[0] for k, v in kern.items()},
                stage_reduce={k: v[1] for k, v in kern.items()},
                profile={k: prof[k] for k in (
                    "card", "workload", "reps", "ms", "host_collect_ms",
                    "bounds", "cells", "cells_per_s", "same_as_search",
                    "tones_found")},
                perf_gate=dict(rcs=gate_rcs, inject_rc=inject_rc,
                               mad_shares=shares,
                               host_mad_shares=host_shares,
                               injection=inj["rows"],
                               episodes=[dict(ep["metrics"],
                                              samples_s=ep["meta"][
                                                  "samples_s"],
                                              host_samples_s=ep["meta"].get(
                                                  "host_samples_s"))
                                         for ep in episodes]),
                lint=dict(rc=lint.returncode, seconds=lint_s,
                          checks=report.get("checks"),
                          suppressed=report.get("suppressed")),
                phase_s=phase_s, budget_s=DEVTOOLS_BUDGET_S)


TARGET_BUDGET_S = 150.0
# the referee's spectrum in this phase: the probe series' first 2^18
# samples (the float64 referee's host time grows with the bins: over the
# whole 2^22-bin probe it takes longer than the phase's budget;
# apps/target_scale_e2e runs it in full)
TARGET_REFEREE_BINS = 1 << 17


def phase_target(workdir, device="cuda"):
    """One card's share of the target-scale plan (phase_target; see the
    module docstring, phase 6n): apps/target_scale, target_scale_chip and
    target_scale_e2e at the plan's full width (512 of 4096 DMs, 256
    channels, 2^23 samples, zmax 200, numharm 8), fed by one pass of host
    blocks, launches read around the three apps; both kernels against
    their plain versions at the share's geometry on the probe spectrum.
    The phase must end within TARGET_BUDGET_S."""
    from presto_tpu_torch.apps import target_scale as ts
    from presto_tpu_torch.apps import target_scale_chip as tsc
    from presto_tpu_torch.apps import target_scale_e2e as tse
    from types import SimpleNamespace
    os.makedirs(workdir, exist_ok=True)
    t_phase = time.time()
    share = ts.Share()
    chan_d, dm_full, dms = ts.delays(share)
    lo, hi = ts.dm_slice(share, dms)
    eq = tsc.Equality(share, chan_d, np.ascontiguousarray(dm_full[lo:hi]),
                      device)
    read = launch_counts()
    t0 = time.time()
    plan, series = ts.run(share, device=device, consumers=[eq])
    plan_s = time.time() - t0
    log("target: plan %d DMs x %d samples over %d logical shards; %d host "
        "blocks in %.1f s (%s threads, %.1f s waiting; consumers %s); "
        "full width %s: "
        "%d blocks bit-equal to one device %s, %.1f ms a block (CUDA events "
        "on the step's own stream, the other consumers beside it); probe rows "
        "%s equal to the full width %s, pulsar row equal to the host's %s; "
        "8 rows' lists sharded == one device %s; pulsar %s %s, DM 0 clean "
        "%s; residency %s"
        % (share.numdms, share.nsamp, share.ndev, plan["stream"]["blocks"],
           plan["stream"]["pass_sec"], plan["stream"]["workers"],
           plan["stream"]["block_wait_sec"],
           json.dumps(plan["stream"]["consumer_sec"]),
           plan["full_width_shape"],
           plan["full_width_blocks"], plan["full_width_bit_equal"],
           plan["full_width_ms_per_block"], plan["probe_rows"],
           plan["probe_stream_matches_full_width"],
           plan["probe_row_equals_host"],
           plan["lists_equal_sharded_vs_one_device"],
           json.dumps(plan["pulsar_recovered"]), plan["pulsar_ok"],
           plan["wrong_dm_clean"], plan["hbm_plan"]["note"]))
    t0 = time.time()
    chip = tsc.run(share, device=device, equality=eq, series=series)
    chip_s = time.time() - t0
    thr = chip["throughput"]
    log("target: share DMs %s: %d streamed blocks bit-equal to NumPy %s "
        "(max diff %g); %d card-made blocks %.1f ms a block (%.1f DM "
        "trials/s, peak %.2f GB); one host block uploaded and dedispersed "
        "%.3f s; probe search %.3f s: %s %s"
        % (chip["dm_slice"], chip["equality_blocks"],
           chip["bit_equal_vs_numpy"], chip["equality_max_diff"],
           thr["stream_blocks"], 1e3 * thr["sec_per_block"],
           thr["dm_trials_per_sec"], (thr["peak_bytes"] or 0) / 1e9,
           chip["sec_per_block_incl_upload"],
           chip["search"]["accelsearch_sec"],
           json.dumps(chip["search"]["pulsar_recovered"]),
           "ok" if chip["ok"] else "FAIL"))
    t0 = time.time()
    e2e = tse.run(share, device=device, workdir=os.path.join(workdir, "e2e"),
                  series=series, referee_bins=TARGET_REFEREE_BINS,
                  replay_workers=(8,))
    e2e_s = time.time() - t0
    launches = read()
    ref = e2e["referee"]
    ref_ok = (ref["feature_match_above_floor"] == [1.0, 1.0]
              and min(ref["n_above_floor"]) > 0 and not ref["violations"])
    log("target: e2e %d DMs: subband pass %.2f s, warm-up %.2f s, device "
        "floor %.2f s, e2e share %.2f s (host collect %.2f s inside: "
        "decode %.2f s, %d threads writing %.2f s, %.2f s waited on them; "
        "sift %.2f s), %d raw / %d sifted candidates, overflow trials %s; "
        "single pulse %.2f s (%d events, %d files overflowed G); polish "
        "%.2f s of %d; replay %s; peak %.2f GB; pulsar at the probe DM %s"
        % (e2e["dms_per_device"], e2e["subband_pass_sec"],
           e2e["search_warmup_sec"], e2e["device_floor_sec"],
           e2e["e2e_share_sec"], e2e["host_collect_sec_inside"],
           e2e["host_decode_sec"], e2e["write_threads"],
           e2e["host_write_sec"], e2e["write_wait_sec"],
           e2e["final_sift_sec"], e2e["ncands_raw"], e2e["ncands_sifted"],
           e2e["compact_overflow_trials"],
           e2e["singlepulse"]["sp_share_sec"],
           e2e["singlepulse"]["sp_nevents"],
           e2e["singlepulse"]["sp_overflow_files"], e2e["polish_top_sec"],
           e2e["polish_top_n"],
           json.dumps({k: v["wall_sec"] for k, v
                       in e2e["host_concurrency"].items()}),
           (e2e["peak_bytes"] or 0) / 1e9,
           json.dumps(e2e["pulsar_recovered"])))
    log("target: referee (%d bins): card %d / referee %d candidates, top %d "
        "identical (first divergence sigma %s), containment above sigma %.0f "
        "%s (%s above it), cluster %s, %d mismatches explained, card %.3f s, "
        "float64 referee %.1f s %s"
        % (ref["numbins"], ref["card_n"], ref["ref_n"],
           ref["top_identical_n"], ref["first_divergence_sigma"],
           ref["sigma_floor"], ref["feature_match_above_floor"],
           ref["n_above_floor"], ref["cluster_match_all"],
           len(ref["mismatch_explanations"]), ref["card_search_sec"],
           ref["referee_sec"], "ok" if ref_ok else
           "FAIL: %s" % ref["violations"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(2222)
    pairs = torch.as_tensor(ts.probe_pairs(series), device=device)
    pb, sr = recipe_kernels(
        SimpleNamespace(zmax=share.zmax, numharm=share.numharm,
                        sigma=share.sigma, flo=1.0),
        share.T, share.numbins, pairs, gen, "target", device=device)
    del pairs
    torch.cuda.empty_cache()
    launched = launches["plane_build"] >= 1 and launches["stage_reduce"] >= 1
    phase_s = time.time() - t_phase
    in_budget = phase_s <= TARGET_BUDGET_S
    log("target: launches around the three apps %s %s; apps %.1f + %.1f + "
        "%.1f s; phase %.1f s of its %.0f s budget %s"
        % (json.dumps(launches), "ok" if launched else "FAIL", plan_s,
           chip_s, e2e_s, phase_s, TARGET_BUDGET_S,
           "ok" if in_budget else "FAIL"))
    ok = (plan["ok"] and chip["ok"] and e2e["ok"] and ref_ok and pb["ok"]
          and sr["ok"] and launched and in_budget)
    return dict(ok=ok, launches=launches, plane_build=pb, stage_reduce=sr,
                plan=plan, chip=chip, e2e=e2e, plan_s=plan_s,
                chip_s=chip_s, e2e_s=e2e_s, phase_s=phase_s,
                budget_s=TARGET_BUDGET_S)


LOADGEN_BUDGET_S = 120.0
# the loadgen phase's full-width beams: the beam's 128 channels and 2^20
# spectra (make_beams' own geometry otherwise: 0.5 ms samples,
# 400-528 MHz, a 23 Hz pulsar at DM 55), at the tool's -rate 2
LOADGEN_BEAMS = dict(n=4, nsamp=1 << 20, nchan=128, rate=2.0)
# the paced stream's width, the live beam's 128 channels, and its block:
# at 128 channels the tool's band (1 MHz channels down from 400 MHz)
# reaches 273 MHz, where its DM 25-65 grid sweeps up to 5785 samples a
# stage, past the tool's 4096-spectrum block (the two-block carry
# refuses it), so the phase takes the live beam's 8192
LOADGEN_STREAM = dict(nchan=LIVE["nchan"], blocklen=LIVE_CFG["blocklen"])


def beam_kernels(beam, cfg, dm, label, gen, device="cuda"):
    """Both kernels at a path's geometry: the search configuration of its
    jobs (``cfg``'s zmax, numharm, sigma, flo) on the spectrum of
    ``beam`` at DM ``dm`` (prepdata -nobary on the card), through
    recipe_kernels."""
    from presto_tpu_torch.apps import prepdata
    from presto_tpu_torch.io.datfft import read_dat_with_inf
    from presto_tpu_torch.ops import fftpack
    base = os.path.join(os.path.dirname(beam), "dm%g" % dm)
    _cli_out(prepdata.main, ["-dm", "%g" % dm, "-nobary", "-o", base, beam],
             device=device)
    series, inf = read_dat_with_inf(base + ".dat")
    x = torch.as_tensor(series - series.mean(), device=device)
    pairs = fftpack.realfft_packed_pairs(x)
    del x
    pb, sr = recipe_kernels(cfg, float(inf.N) * inf.dt,
                            pairs.shape[0], pairs, gen, label,
                            device=device)
    del pairs
    torch.cuda.empty_cache()
    return pb, sr


def _loadgen_serve(workdir, device, gen):
    """serve_loadgen -selfhost at full width (LOADGEN_BEAMS), launches
    read around it, and both kernels at its geometry."""
    from presto_tpu_torch.apps import serve_loadgen as slg
    from presto_tpu_torch.pipeline.survey import SurveyConfig
    from presto_tpu_torch.serve.server import SearchService, start_http
    t0 = time.time()
    beams = slg.make_beams(workdir, LOADGEN_BEAMS["n"],
                           nsamp=LOADGEN_BEAMS["nsamp"],
                           nchan=LOADGEN_BEAMS["nchan"])
    beams_s = time.time() - t0
    read = launch_counts()
    t0 = time.time()
    servedir = os.path.join(workdir, "serve")
    svc = SearchService(servedir, device=device).start()
    httpd = start_http(svc)
    try:
        rep = slg.run_loadgen("http://%s:%d" % httpd.server_address[:2],
                              beams, rate=LOADGEN_BEAMS["rate"])
    finally:
        httpd.shutdown()
        svc.stop()
    launches = read()
    serve_s = time.time() - t0
    ok = (rep["done"] == LOADGEN_BEAMS["n"] and rep["failed"] == 0
          and rep["unfinished"] == 0)
    log("loadgen: -selfhost %d beams of %d x %d (made in %.1f s, %d "
        "threads) at %.0f jobs/s submitted: done %d, failed %d, unfinished "
        "%d; %.3f jobs/s over %.2f s, job_total p50 %.3f s, p99 %.3f s; "
        "batch occupancy %s, plan hit rate %s; launches %s %s"
        % (LOADGEN_BEAMS["n"], LOADGEN_BEAMS["nsamp"], LOADGEN_BEAMS["nchan"],
           beams_s, LOADGEN_BEAMS["n"], LOADGEN_BEAMS["rate"], rep["done"],
           rep["failed"], rep["unfinished"], rep["throughput_jobs_per_s"],
           rep["wall_s"], rep["p50_s"], rep["p99_s"], rep["batch_occupancy"],
           rep["plan_hit_rate"], json.dumps(launches),
           "ok" if ok else "FAIL"))
    # the jobs' geometry on the first full-width beam at DM 55, its
    # pulsar's (the jobs keep no .dat)
    pb, sr = beam_kernels(beams[0], SurveyConfig(
        lodm=45.0, hidm=65.0, nsub=16, zmax=0, numharm=4, fold_top=0,
        singlepulse=False, skip_rfifind=True), 55.0, "loadgen (DM 55)", gen,
        device)
    return dict(ok=ok and pb["ok"] and sr["ok"], report=rep,
                launches=launches, beams_s=beams_s, serve_s=serve_s,
                plane_build=pb, stage_reduce=sr)


def _loadgen_fleet(workdir, device, subprocess_mode=True):
    """serve_loadgen -replicas 2 [-subprocess] at the tool's defaults (4
    beams of 2^14 x 16, -rate 2); the replica processes' launches from
    their last snapshots."""
    from presto_tpu_torch.apps import serve_loadgen as slg
    read = launch_counts()
    t0 = time.time()
    beams = slg.make_beams(workdir, 4)
    rep = slg.run_fleet_loadgen(workdir, beams, replicas=2, rate=2.0,
                                subprocess_mode=subprocess_mode,
                                device=device)
    seconds = time.time() - t0
    launches = read()
    procs = _fleet_launches(os.path.join(workdir, "fleet"))
    for name in launches:
        launches[name] += sum(r.get(name, 0) for r in procs.values())
    ok = (rep["done"] == len(beams) and rep["failed"] == 0
          and rep["unfinished"] == 0
          and rep["fleet"]["ready_replicas"] == 2
          and all(e is None for e in rep["replica_exits"]))
    log("loadgen: -replicas 2%s: %d ready, done %d, failed %d, unfinished "
        "%d, %.3f jobs/s over %.2f s, per replica %s; launches %s (replica "
        "snapshots %s); %.1f s %s"
        % (" -subprocess" if subprocess_mode else "",
           rep["fleet"]["ready_replicas"], rep["done"], rep["failed"],
           rep["unfinished"], rep["throughput_jobs_per_s"], rep["wall_s"],
           json.dumps({k: {x: v[x] for x in ("jobs_committed", "p50_s",
                                              "p99_s")}
                       for k, v in rep["per_replica"].items()}),
           json.dumps(launches), json.dumps(procs), seconds,
           "ok" if ok else "FAIL"))
    return dict(ok=ok, report=rep, launches=launches, seconds=seconds)


def _loadgen_verdict(name, fn, *a, **k):
    """One verdict mode: its report, seconds and verdict logged."""
    t0 = time.time()
    rep = fn(*a, **k)
    seconds = time.time() - t0
    ok = rep.get("verdict", "PASS" if rep.get("ok") else "FAIL") == "PASS"
    checks = rep.get("checks")
    if rep.get("mode") == "dag":
        checks = {"pipeline_equivalence": rep["pipeline_equivalence"],
                  "stacked_folds": rep["stacked_folds"],
                  "executor_coalescing": rep["executor_coalescing"]}
    log("loadgen: %s %s in %.1f s; checks %s"
        % (name, "PASS" if ok else "FAIL", seconds,
           json.dumps(checks if checks is not None else {
               k: rep[k] for k in ("byte_equal", "o1_dispatch")
               if k in rep}, default=float)))
    return dict(ok=ok, report=rep, seconds=seconds)


def _loadgen_stream(workdir, device, nchan, blocklen):
    """stream_loadgen --mode paced --speed 8 at ``nchan`` channels and
    ``blocklen``-spectrum blocks (the tool's other defaults)."""
    from presto_tpu_torch.apps import stream_loadgen as stl
    t0 = time.time()
    v = stl.run_trial(workdir, mode="paced", speed=8.0, nchan=nchan,
                      blocklen=blocklen, device=device)
    seconds = time.time() - t0
    ok = (v["ok"] and not v["missed"] and not v["duplicated"]
          and not v["unmatched"] and v["source"]["dropped_spectra"] == 0)
    log("loadgen: stream_loadgen --mode paced --speed 8 --nchan %d "
        "(blocks of %d): %d pulses at %s, %d triggers, missed %s, "
        "duplicated %s, unmatched %s, DM ok %s; source %s; latency %s s (%d "
        "samples); wall %.2f s; %.1f s %s"
        % (nchan, blocklen, v["pulses_injected"], v["pulse_times"],
           v["triggers"], v["missed"], v["duplicated"], v["unmatched"],
           v["dm_ok"], json.dumps(v["source"]), json.dumps(v["latency_s"]),
           v["latency_samples"], v["wall_s"], seconds,
           "ok" if ok else "FAIL: %s" % v.get("error")))
    return dict(ok=ok, report=v, seconds=seconds)


def _loadgen_beams(workdir, device):
    """stream_loadgen --beams 4 (the tool's defaults)."""
    from presto_tpu_torch.apps import stream_loadgen as stl
    t0 = time.time()
    v = stl.run_beam_trial(workdir, nbeams=4, beam_counts=[2, 4],
                           device=device)
    seconds = time.time() - t0
    ok = v["ok"] and v["byte_equal"] and v["o1_dispatch"] and \
        v["veto"]["ok"]
    log("loadgen: stream_loadgen --beams 4: byte_equal %s, o1_dispatch %s, "
        "axis %s, veto %s, slo %s; %.1f s %s"
        % (v["byte_equal"], v["o1_dispatch"],
           json.dumps([{k: r[k] for k in ("beams", "ticks", "dispatches",
                                          "latency_p99_s")}
                       for r in v["beams_axis"]]),
           json.dumps(v["veto"]), json.dumps(v["slo"]), seconds,
           "ok" if ok else "FAIL"))
    return dict(ok=ok, report=v, seconds=seconds)


def phase_loadgen(workdir, device="cuda", everything=False, records=None):
    """The load generators on the card (phase_loadgen; see the module
    docstring, phase 6o).  By default: serve_loadgen -selfhost at full
    width with both kernels at its geometry, -replicas 2 -subprocess,
    -stacked -Ns 1,4, stream_loadgen paced at 128 channels and --beams 4,
    within LOADGEN_BUDGET_S; the launches of the serve modes read around
    each.  ``everything`` (--loadgen-only) runs all eight serve modes
    (the in-process fleet too, -stacked at the tool's -Ns 1,4,8, -dag,
    -obs, -slo, -supervisor, -campaign) and both stream modes, each to
    its verdict, with no budget; ``records`` is a directory the verdict
    modes' reports go to (records/torch/<name>.json under it, each
    naming the card)."""
    from presto_tpu_torch.apps import serve_loadgen as slg
    os.makedirs(workdir, exist_ok=True)
    t_phase = time.time()
    gen = torch.Generator(device=device)
    gen.manual_seed(2323)
    d = lambda name: os.path.join(workdir, name)  # noqa: E731
    out = {"serve": _loadgen_serve(d("serve"), device, gen)}
    torch.cuda.empty_cache()
    out["fleet_subprocess"] = _loadgen_fleet(d("fleet_proc"), device)
    if everything:
        out["fleet"] = _loadgen_fleet(d("fleet"), device,
                                      subprocess_mode=False)
    read = launch_counts()
    out["stacked"] = _loadgen_verdict(
        "-stacked -Ns %s" % ("1,4,8" if everything else "1,4"),
        slg.run_stacked_loadgen, d("stacked"),
        Ns=(1, 4, 8) if everything else (1, 4), device=device)
    out["stacked"]["launches"] = read()
    torch.cuda.empty_cache()
    if everything:
        for name, fn in (("dag", slg.run_dag_loadgen),
                         ("obs", slg.run_obs_loadgen),
                         ("slo", slg.run_slo_loadgen),
                         ("supervisor", slg.run_supervisor_loadgen),
                         ("campaign", slg.run_campaign_loadgen)):
            out[name] = _loadgen_verdict("-" + name, fn, d(name),
                                         device=device)
            torch.cuda.empty_cache()
    out["stream"] = _loadgen_stream(d("stream"), device, **LOADGEN_STREAM)
    torch.cuda.empty_cache()
    if everything:      # the CLI's defaults: 64 channels, 4096 spectra
        out["stream_cli_defaults"] = _loadgen_stream(
            d("stream_cli"), device, nchan=64, blocklen=4096)
    out["beams"] = _loadgen_beams(d("beams"), device)
    torch.cuda.empty_cache()
    if records:
        card = slg.card_line()
        for mode, name in slg.VERDICT_MODES:
            if mode in out:
                rep = dict(out[mode]["report"], card=card)
                log("loadgen: %s -> %s"
                    % (mode, slg.commit_report(rep, name, root=records)))
    launches = {k: sum(r["launches"][k] for r in out.values()
                       if "launches" in r)
                for k in ("plane_build", "stage_reduce")}
    launched = launches["plane_build"] >= 1 and launches["stage_reduce"] >= 1
    phase_s = time.time() - t_phase
    in_budget = everything or phase_s <= LOADGEN_BUDGET_S
    log("loadgen: launches of the serve modes %s %s; seconds %s; phase "
        "%.1f s%s %s"
        % (json.dumps(launches), "ok" if launched else "FAIL",
           json.dumps({k: round(r.get("seconds", r.get("serve_s", 0.0)), 1)
                       for k, r in out.items()}), phase_s,
           "" if everything else " of its %.0f s budget"
           % LOADGEN_BUDGET_S, "ok" if in_budget else "FAIL"))
    ok = all(r["ok"] for r in out.values()) and launched and in_budget
    return dict(ok=ok, launches=launches,
                plane_build=out["serve"]["plane_build"],
                stage_reduce=out["serve"]["stage_reduce"],
                modes={k: {x: v for x, v in r.items()
                           if x not in ("plane_build", "stage_reduce")}
                       for k, r in out.items()},
                phase_s=phase_s, budget_s=LOADGEN_BUDGET_S)


CHAOS_BUDGET_S = 120.0
# chaos_survey in the default phase: the tool's survey (DM 5-12, nsub 16,
# zmax 0, numharm 2, single pulse on, rfifind -time 0.4) of its synthetic
# 17 Hz pulsar at the beam's 128 channels over 2^15 spectra of 0.2 ms
# (the tool's 2^13 x 16 otherwise); seed 0's first trial
CHAOS_SURVEY = dict(nspec=1 << 15, nchan=LIVE["nchan"], seed=0)
# multihost_chaos: the tool's 8 DMs over 2^13 spectra at 128 channels;
# seed 4 draws the stall mode first (proc0 wedged at its first
# pre-shard-commit), which phase_cluster's one exit kill does not cover
CHAOS_MULTIHOST = dict(nspec=1 << 13, nchan=LIVE["nchan"], numdms=8,
                       seed=4)
CHAOS_STREAM_TRIALS = ("stall", "truncation", "ring-drop", "beam-handoff")
# fleet_chaos: one classic trial at the tool's defaults (2 replicas, 3
# jobs of 4096 x 8, lease batch 2); seed 1 draws job-enqueued first, so
# the victim leaves a zombie survey whose late commit the fence rejects
CHAOS_FLEET_SEED = 1
# fed_chaos at the tool's defaults (3 jobs of 4096 x 8, seed 19); its
# trial index 1 is the partition-zombie mode
CHAOS_FED_SEED = 19


def _chaos_run(name, fn, *a, **k):
    """One driver of the chaos phase: its record with its seconds; an
    exception fails it (its traceback logged), the phase goes on."""
    import traceback
    t0 = time.time()
    try:
        rec = fn(*a, **k)
    except Exception:
        tb = traceback.format_exc()
        log("chaos: %s raised:\n%s" % (name, tb))
        rec = dict(ok=False, error=tb[-2000:])
    rec["seconds"] = time.time() - t0
    return rec


def _chaos_survey(workdir, device):
    """chaos_survey's first trial of CHAOS_SURVEY's seed: the kill
    schedule, the kills that fired, every comparable artifact against the
    uninterrupted run."""
    import random
    from presto_tpu_torch.apps import chaos_survey as cs
    c = CHAOS_SURVEY
    raw, provider, ref = cs.reference(workdir, c["nspec"], c["nchan"],
                                      device)
    trial = cs.run_trial(0, random.Random(c["seed"]), raw, provider, ref,
                         workdir, device)
    ok = trial["ok"] and bool(ref)
    log("chaos: chaos_survey at %d channels x %d spectra, seed %d: "
        "schedule %s, kills that fired %s; %d comparable artifacts "
        "byte-equal to the uninterrupted run %s%s"
        % (c["nchan"], c["nspec"], c["seed"], " -> ".join(trial["schedule"]),
           trial["hits"], len(ref), trial["ok"], trial["detail"]))
    return dict(ok=ok, trial=trial, artifacts=len(ref), raw=raw)


def _chaos_multihost(workdir, device):
    """multihost_chaos's first trial of CHAOS_MULTIHOST's seed (the stall
    mode): two prepsubband processes on the card, every .dat against the
    one-process reference, the shard ledger's epoch and redos."""
    import random
    from presto_tpu_torch.apps import multihost_chaos as mh
    c = CHAOS_MULTIHOST
    raw, nsub = mh.prepare(workdir, c["nspec"], c["nchan"], c["numdms"],
                           device)
    res = mh.run_trial(0, random.Random(c["seed"]), raw, workdir,
                       c["numdms"], nsub, max(1, c["numdms"] // 4),
                       mh.LEASE_TTL_S, mh.BARRIER_TIMEOUT_S, mh.DEADLINE_S,
                       device=device)
    ok = (res["ok"] and res["mode"] == "stall"
          and (res.get("epoch") or 0) >= 1)
    log("chaos: multihost_chaos seed %d: victim proc%d %s at %s#%d; "
        "survivor %s s (rc of the victim %s); %s/%s .dat byte-equal %s; "
        "ledger epoch %s, redos %s %s%s"
        % (c["seed"], res["victim"], res["mode"], res["point"], res["nth"],
           res.get("survivor_seconds"), res.get("victim_rc"),
           res.get("mh_files"), res.get("ref_files"),
           res.get("byte_identical"), res.get("epoch"), res.get("redos"),
           "ok" if ok else "FAIL",
           "" if ok else ": %s" % (res.get("stage"), res.get("stderr"))))
    return dict(ok=ok, report=res)


def _chaos_stream(workdir, device, names):
    """stream_chaos's named trials, each to its verdict."""
    from presto_tpu_torch.apps import stream_chaos as sc
    v = sc.run_trials(names, device=device, root=workdir)
    for r in v["trials"]:
        log("chaos: stream_chaos %s %s in %.1f s: %s"
            % (r["trial"], "PASS" if r["ok"] else "FAIL", r["wall_s"],
               json.dumps({k: x for k, x in r.items()
                           if k not in ("trial", "ok", "wall_s")},
                          default=str)))
    return dict(ok=v["ok"], report=v)


def _chaos_fleet(workdir, device):
    """fleet_chaos's classic trial of CHAOS_FLEET_SEED (job-enqueued):
    every job ledger-done once, the digests against the reference, the
    zombie's late commit fenced."""
    import random
    from presto_tpu_torch.apps import fleet_chaos as fc
    beam, ref = fc.classic_reference(workdir, 4096, 8, device)
    rec = fc.run_trial(0, random.Random(CHAOS_FLEET_SEED), beam, ref,
                       workdir, 2, 3, 300.0, device=device)
    ok = (rec["ok"] and rec["kill_point"] == "job-enqueued"
          and bool(rec["zombie_jobs"]) and rec["stale_rejected"] >= 1)
    log("chaos: fleet_chaos seed %d: kill %s on %s, zombie jobs %s, "
        "stale commits rejected %d, epoch %d, redos %s; checks %s %s"
        % (CHAOS_FLEET_SEED, rec["kill_point"], rec["victim"],
           rec["zombie_jobs"], rec["stale_rejected"], rec["epoch"],
           rec["redos"], json.dumps(rec["checks"]), "ok" if ok else "FAIL"))
    return dict(ok=ok, report=rec)


def _chaos_fed(workdir, device):
    """fed_chaos's partition-zombie trial: every item committed once on
    the survivor, the zombie's late commits fenced, the epoch bumped, the
    digests against the reference; the replicas' launches from their
    snapshots."""
    import random
    from presto_tpu_torch.apps import fed_chaos as fd
    beam, ref = fd.reference(workdir, 4096, 8, device)
    rec = fd.run_fed_trial(1, random.Random(CHAOS_FED_SEED), beam, ref,
                           workdir, 3, 300.0, device=device)
    ok = rec["ok"] and rec["mode"] == "partition-zombie"
    procs = {}
    for name in ("A", "B"):
        procs.update(_fleet_launches(os.path.join(workdir, "trial01", name,
                                                  "fleet")))
    log("chaos: fed_chaos %s: %d placed on A, %d open at the kill, %d "
        "re-admitted, stale commits rejected %s, epoch %d, kill points %s; "
        "checks %s; replica launches %s %s"
        % (rec["mode"], rec.get("placed_on_victim", 0),
           rec.get("open_at_kill", 0), rec.get("readmitted", 0),
           rec.get("stale_rejected"), rec.get("epoch", 0),
           rec.get("points_seen"), json.dumps(rec["checks"]),
           json.dumps(procs), "ok" if ok else "FAIL"))
    return dict(ok=ok, report=rec, launches_by_replica=procs)


def _chaos_everything(workdir, device, records):
    """Every driver at the JAX tools' defaults to its verdict (the
    --chaos-only run): chaos_survey --trials 5, the six stream trials,
    multihost_chaos --trials 3, fleet_chaos -trials 3 -supervisor, -dag
    and -campaign (and -campaign -observations 16), fed_chaos -trials 2
    -verdict; with ``records`` each report goes to records/torch/<the JAX
    tool's name> under it."""
    from presto_tpu_torch.apps import chaos_survey as cs
    from presto_tpu_torch.apps import fed_chaos as fd
    from presto_tpu_torch.apps import fleet_chaos as fc
    from presto_tpu_torch.apps import multihost_chaos as mh
    from presto_tpu_torch.apps import serve_loadgen as slg
    from presto_tpu_torch.apps import stream_chaos as sc
    d = lambda name: os.path.join(workdir, name)  # noqa: E731
    out = {}

    def survey():
        trials = cs.run(cs.build_parser().parse_args(
            ["--trials", "5", "--workdir", d("survey")]), device)
        return dict(ok=all(t["ok"] for t in trials), report=dict(
            trials=trials, passed=sum(t["ok"] for t in trials)))
    out["chaos_survey"] = _chaos_run("chaos_survey --trials 5", survey)

    def stream():
        v = sc.run_trials(list(sc.TRIALS), device=device, root=d("stream"))
        return dict(ok=v["ok"], report=v)
    out["stream"] = _chaos_run("stream_chaos, six trials", stream)

    def multihost():
        art = mh.run(mh.build_parser().parse_args(
            ["--trials", "3", "--workdir", d("multihost")]), device)
        return dict(ok=art["ok"], report=art)
    out["multihost"] = _chaos_run("multihost_chaos --trials 3", multihost)
    # the campaign also at 16 observations: at the tool's 4 a card may
    # finish the campaign before the trial's drawn kill delay (0.5-3 s)
    for key, flags in (("fleet", ["-supervisor"]), ("dag", ["-dag"]),
                       ("campaign", ["-campaign"]),
                       ("campaign16", ["-campaign", "-observations", "16"])):
        def fleet(flags=flags, key=key):
            args = fc.build_parser().parse_args(
                ["-trials", "3", "-workdir", d(key)] + flags)
            _mode, rep = fc.run_mode(args, d(key), device)
            return dict(ok=rep["failed"] == 0, report=rep)
        out[key] = _chaos_run("fleet_chaos -trials 3 " + " ".join(flags),
                              fleet)

    def fed():
        rep, verdict = fd.run(fd.build_parser().parse_args(
            ["-trials", "2", "-verdict"]), d("fed"), device)
        return dict(ok=rep["failed"] == 0 and verdict["ok"], report=rep,
                    verdict=verdict)
    out["fed"] = _chaos_run("fed_chaos -trials 2 -verdict", fed)
    for key, r in out.items():
        rep = r.get("report") or {}
        trials = rep.get("results") or rep.get("trials") or []
        log("chaos: --chaos-only %s %s in %.1f s: %s"
            % (key, "PASS" if r["ok"] else "FAIL", r["seconds"],
               json.dumps([{k: t.get(k) for k in (
                   "trial", "kill_point", "crash_point", "mode", "victim",
                   "point", "nth", "schedule", "ok", "wall_s",
                   "survivor_seconds", "epoch", "checks") if k in t}
                   for t in trials], default=str)))
    if "verdict" in out["fed"]:
        log("chaos: --chaos-only fed verdict %s: checks %s"
            % ("PASS" if out["fed"]["verdict"]["ok"] else "FAIL",
               json.dumps(out["fed"]["verdict"]["checks"])))
    if records:
        card = slg.card_line()
        for key, name in (("fleet", "FLEET_CHAOS.json"),
                          ("dag", "DAG_CHAOS.json"),
                          ("campaign", "CAMPAIGN_CHAOS.json"),
                          ("campaign16", "CAMPAIGN_CHAOS_observations16.json"),
                          ("fed", "FED_CHAOS.json"),
                          ("multihost", "MULTIHOST_CHAOS.json"),
                          ("stream", "STREAM_CHAOS.json")):
            if "report" in out[key]:
                log("chaos: %s -> %s" % (key, slg.commit_report(
                    dict(out[key]["report"], card=card), name,
                    root=records)))
        if "verdict" in out["fed"]:
            log("chaos: fed verdict -> %s" % slg.commit_report(
                dict(out["fed"]["verdict"], card=card), "FED_r19.json",
                root=records))
    return out


def phase_chaos(workdir, device="cuda", everything=False, records=None):
    """The chaos drivers on the card (phase_chaos; see the module
    docstring, phase 6p).  By default, each with its checks and within
    CHAOS_BUDGET_S: chaos_survey's first trial of seed 0 at 128 channels
    (CHAOS_SURVEY), multihost_chaos's stall trial (CHAOS_MULTIHOST),
    stream_chaos's stall, truncation, ring-drop and beam-handoff,
    fleet_chaos's classic job-enqueued trial and fed_chaos's
    partition-zombie trial (in a thread beside the other four: its
    fleets are processes of their own); the launches read around the
    five; both
    kernels against their plain versions at chaos_survey's geometry
    (zmax 0, numharm 2) on its beam's spectrum at DM 10, its pulsar's.
    ``everything`` (--chaos-only) then runs every driver at the JAX
    tools' defaults to its verdict (_chaos_everything), outside the
    budget; ``records`` is a directory their reports go to."""
    import threading
    from presto_tpu_torch.apps import chaos_survey as cs
    os.makedirs(workdir, exist_ok=True)
    t_phase = time.time()
    d = lambda name: os.path.join(workdir, name)  # noqa: E731
    read = launch_counts()
    # fed_chaos's fleets are processes of their own and its trial mostly
    # waits on them: it runs in a lane beside the other four
    fed = {}
    lane = threading.Thread(target=lambda: fed.update(_chaos_run(
        "fed_chaos", _chaos_fed, d("fed"), device)), name="chaos-fed")
    lane.start()
    out = {"chaos_survey": _chaos_run("chaos_survey", _chaos_survey,
                                      d("survey"), device)}
    out["multihost"] = _chaos_run("multihost_chaos", _chaos_multihost,
                                  d("multihost"), device)
    out["stream"] = _chaos_run("stream_chaos", _chaos_stream, d("stream"),
                               device, CHAOS_STREAM_TRIALS)
    out["fleet"] = _chaos_run("fleet_chaos", _chaos_fleet, d("fleet"),
                              device)
    lane.join()
    out["fed"] = fed
    torch.cuda.empty_cache()
    launches = read()
    for name in launches:
        launches[name] += sum(r.get(name, 0) for r in out["fed"].get(
            "launches_by_replica", {}).values())
    gen = torch.Generator(device=device)
    gen.manual_seed(2424)
    raw = out["chaos_survey"].get("raw") or cs._make_obs(
        d("survey"), CHAOS_SURVEY["nspec"], CHAOS_SURVEY["nchan"])
    pb, sr = beam_kernels(raw, cs._cfg(None), 10.0, "chaos (DM 10)", gen,
                          device)
    launched = launches["plane_build"] >= 1 and launches["stage_reduce"] >= 1
    phase_s = time.time() - t_phase
    in_budget = phase_s <= CHAOS_BUDGET_S
    log("chaos: launches around the drivers %s %s; seconds %s; phase %.1f "
        "s of its %.0f s budget %s"
        % (json.dumps(launches), "ok" if launched else "FAIL",
           json.dumps({k: round(r["seconds"], 1) for k, r in out.items()}),
           phase_s, CHAOS_BUDGET_S, "ok" if in_budget else "FAIL"))
    ok = (all(r["ok"] for r in out.values()) and pb["ok"] and sr["ok"]
          and launched and in_budget)
    res = dict(ok=ok, launches=launches, plane_build=pb, stage_reduce=sr,
               drivers={k: {x: v for x, v in r.items() if x != "raw"}
                        for k, r in out.items()},
               phase_s=phase_s, budget_s=CHAOS_BUDGET_S)
    if everything:
        t0 = time.time()
        allrun = _chaos_everything(d("all"), device, records)
        res["everything"] = allrun
        res["everything_s"] = time.time() - t0
        res["ok"] = ok and all(r["ok"] for r in allrun.values())
    return res


def keep_cands(res, keep):
    """recipe_cands.tar.xz in ``keep``: the survey's ACCEL tables, .cand
    files and .inf files by base name, and its cands_sifted.txt."""
    import tarfile
    os.makedirs(keep, exist_ok=True)
    work = res.workdir
    names = sorted(f for f in os.listdir(work)
                   if re.search(r"_ACCEL_\d+(\.cand)?$", f)
                   or f.endswith(".inf"))
    path = os.path.join(keep, "recipe_cands.tar.xz")
    with tarfile.open(path, "w:xz") as tar:
        for f in names + ["cands_sifted.txt"]:
            tar.add(os.path.join(work, f), arcname=f)
    log("recipe: %d files of the sift's input kept in %s (%d bytes)"
        % (len(names) + 1, path, os.path.getsize(path)))


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
    ap.add_argument("--target-only", action="store_true",
                    help="build the kernels and run the target phase alone "
                         "(no kernels line, no final ok line)")
    ap.add_argument("--loadgen-only", action="store_true",
                    help="build the kernels and run the loadgen phase alone "
                         "with every serve and stream mode to its verdict "
                         "(no kernels line, no final ok line)")
    ap.add_argument("--loadgen-records", metavar="DIR",
                    help="with --loadgen-only: write the verdict modes' "
                         "reports to DIR/records/torch/<name>.json")
    ap.add_argument("--chaos-only", action="store_true",
                    help="build the kernels and run the chaos phase alone, "
                         "then every chaos driver at the JAX tools' "
                         "defaults to its verdict (no kernels line, no "
                         "final ok line)")
    ap.add_argument("--chaos-records", metavar="DIR",
                    help="with --chaos-only: write the drivers' reports "
                         "to DIR/records/torch/<name>.json")
    ap.add_argument("--keep-recipe-cands", metavar="DIR",
                    help="write the recipe phase's sift input and output "
                         "to DIR/recipe_cands.tar.xz")
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
    if opts.loadgen_only:
        build = phase_build()
        d = tempfile.mkdtemp(prefix="chip_smoke_loadgen_")
        try:
            loadgen = phase_loadgen(os.path.join(d, "loadgen"),
                                    everything=True,
                                    records=opts.loadgen_records)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        log("results: %s" % json.dumps(dict(build=build, loadgen=loadgen),
                                       default=float))
        return 0 if build["ok"] and loadgen["ok"] else 1
    if opts.chaos_only:
        build = phase_build()
        d = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
        try:
            chaos = phase_chaos(os.path.join(d, "chaos"), everything=True,
                                records=opts.chaos_records)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        log("results: %s" % json.dumps(dict(build=build, chaos=chaos),
                                       default=str))
        return 0 if build["ok"] and chaos["ok"] else 1
    if opts.target_only:
        build = phase_build()
        d = tempfile.mkdtemp(prefix="chip_smoke_target_")
        try:
            target = phase_target(os.path.join(d, "target"))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        log("results: %s" % json.dumps(dict(build=build, target=target),
                                       default=float))
        return 0 if build["ok"] and target["ok"] else 1
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
        short = phase_short(raw, os.path.join(work, "short"))
        torch.cuda.empty_cache()
        shard = phase_sharded(short["beam"], os.path.join(work, "sharded"),
                              short["reference"], short)
        torch.cuda.empty_cache()
        cluster = phase_cluster(short["beam"], os.path.join(work, "cluster"),
                                short["reference"], short["maskfile"])
        torch.cuda.empty_cache()
        serve = phase_serve(short, os.path.join(work, "serve"))
        torch.cuda.empty_cache()
        fleet = phase_fleet(short["beam"], os.path.join(work, "fleet"),
                            short["reference"])
        torch.cuda.empty_cache()
        feder = phase_federation(short["beam"],
                                 os.path.join(work, "federation"),
                                 short["reference"])
        torch.cuda.empty_cache()
        recipe = phase_recipe(raw, os.path.join(work, "recipe"), main_res,
                              keep=opts.keep_recipe_cands)
        torch.cuda.empty_cache()
        psrfits = phase_psrfits(short["beam"],
                                os.path.join(work, "psrfits"),
                                short["reference"], short)
        torch.cuda.empty_cache()
        classic = phase_classic(raw, os.path.join(work, "classic"))
        torch.cuda.empty_cache()
        binary = phase_binary(os.path.join(work, "binary"))
        torch.cuda.empty_cache()
        read = launch_counts()
        plots = phase_plots(mwork, card)
        plots["launches"] = read()
        torch.cuda.empty_cache()
        tools = phase_tools(raw, os.path.join(work, "tools"), mwork,
                            short["beam"])
        torch.cuda.empty_cache()
        devtools = phase_devtools(os.path.join(work, "devtools"))
        torch.cuda.empty_cache()
        target = phase_target(os.path.join(work, "target"))
        torch.cuda.empty_cache()
        loadgen = phase_loadgen(os.path.join(work, "loadgen"))
        torch.cuda.empty_cache()
        chaos = phase_chaos(os.path.join(work, "chaos"))
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
                   toas=toas, singlepulse=spb, jerk=jerk, short=short,
                   sharded=shard,
                   cluster=cluster, serve=serve, fleet=fleet,
                   federation=feder, recipe=recipe, psrfits=psrfits,
                   classic=classic, binary=binary, plots=plots,
                   tools=tools, devtools=devtools, target=target,
                   loadgen=loadgen, chaos=chaos, small_reference=small,
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
                   "serve": serve["launches"][name],
                   "fleet": sum(fleet[r].get(name, 0) for r in (
                       "r1_launches_last_snapshot", "r2_launches")),
                   "federation": feder["launches"][name],
                   "tune": feder["tune_launches"][name],
                   "recipe": recipe["launches"][name],
                   "psrfits": psrfits["launches"][name],
                   "classic": classic["launches"][name],
                   "monte": binary["launches"][name],
                   "plots": plots["launches"][name],
                   "tools": tools["launches"][name],
                   "devtools": devtools["launches"][name],
                   "target_scale": target["launches"][name],
                   "loadgen": loadgen["launches"][name],
                   "chaos": chaos["launches"][name]}
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
                            "bound_by", "library_ms")},
                        **{"recipe_" + ps: {x: recipe[name][ps][x] for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}
                           for ps in ("lo", "hi")},
                        **{ph: {x: res[name][x] for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}
                           for ph, res in (("classic", classic),
                                           ("monte", binary))},
                        **{"tools_" + c: {x: tools[name][c][x] for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}
                           for c in ("referee", "injected")},
                        **{"devtools_" + c: {x: devtools[name][c][x]
                                             for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}
                           for c in ("headline", "smoke")},
                        "target_scale": {x: target[name][x] for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        **{ph: {x: res[name][x] for x in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}
                           for ph, res in (("loadgen", loadgen),
                                           ("chaos", chaos))}})
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
                              ("short", short["ok"]),
                              ("sharded", shard["ok"]),
                              ("cluster", cluster["ok"]),
                              ("serve", serve["ok"]),
                              ("fleet", fleet["ok"]),
                              ("federation", feder["ok"]),
                              ("recipe", recipe["ok"]),
                              ("psrfits", psrfits["ok"]),
                              ("classic", classic["ok"]),
                              ("binary", binary["ok"]),
                              ("plots", plots["ok"]),
                              ("tools", tools["ok"]),
                              ("devtools", devtools["ok"]),
                              ("target", target["ok"]),
                              ("loadgen", loadgen["ok"]),
                              ("chaos", chaos["ok"]),
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
