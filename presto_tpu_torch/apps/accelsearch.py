"""accelsearch: F-Fdot acceleration search over a .fft or .dat file.

PyTorch counterpart of ``presto_tpu/apps/accelsearch.py`` (CLI parity
with the reference accelsearch, clig/accelsearch_cmd.cli): -zmax,
-numharm, -sigma, -flo/-fhi/-rlo/-rhi, -lobin, -zaplist, -baryv and the
normalization flags, and -wmax (the jerk search).  Outputs
<base>_ACCEL_<zmax> (text candidate table, column structure of
output_fundamentals accel_utils.c:565-718; with -wmax
<base>_ACCEL_<zmax>_JERK_<wmax> and an FFT 'w' column) and its .cand
(binary candidate dump), byte-equal to the JAX package's writers for the
same candidates.

The polish is the JAX package's default path, the batched polish
(search/polish.py), on the search's device, and with -wmax the batched
(r, z, w) jerk polish seeded from it.  It has no per-candidate fallback:
a failure raises.
"""

from __future__ import annotations

import argparse
import os
import struct
from contextlib import nullcontext
from dataclasses import dataclass, replace
from typing import List

import numpy as np
import torch

from presto_tpu_torch.apps.common import load_spectrum, load_timeseries
from presto_tpu_torch.io.atomic import atomic_open
from presto_tpu_torch.io.errors import PrestoIOError
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.ops.rednoise import (birds_to_bin_ranges, deredden,
                                           read_birds_bary, zap_bins)
from presto_tpu_torch.search.accel import (AccelCand, AccelConfig,
                                           AccelSearch, eliminate_harmonics,
                                           remove_duplicates, resolve_device)
from presto_tpu_torch.search.polish import (optimize_accelcands,
                                           optimize_jerk_cands)


def build_parser():
    p = argparse.ArgumentParser(prog="accelsearch")
    p.add_argument("-zmax", type=int, default=200)
    p.add_argument("-numharm", type=int, default=8)
    p.add_argument("-sigma", type=float, default=2.0)
    p.add_argument("-flo", type=float, default=1.0)
    p.add_argument("-fhi", type=float, default=0.0,
                   help="Highest frequency (Hz) to search")
    p.add_argument("-rlo", type=float, default=0.0)
    p.add_argument("-rhi", type=float, default=0.0)
    p.add_argument("-lobin", type=int, default=0,
                   help="The first Fourier frequency in the data file "
                        "(for spectra chopped out of a longer FFT)")
    p.add_argument("-wmax", type=int, default=0,
                   help="Max jerk (w, bins) searched (0 = no jerk "
                        "search)")
    p.add_argument("-zaplist", type=str, default=None)
    p.add_argument("-baryv", type=float, default=0.0)
    p.add_argument("-inmem", action="store_true",
                   help="Accepted for parity (search is in-memory)")
    norm = p.add_mutually_exclusive_group()
    norm.add_argument("-median", action="store_true",
                      help="Block-median power normalization (default)")
    norm.add_argument("-photon", action="store_true",
                      help="Poissonian data: normalize by the freq-0 "
                           "power (photon count)")
    norm.add_argument("-locpow", action="store_true",
                      help="Running local-power normalization")
    p.add_argument("-otheropt", action="store_true",
                   help="Use the alternative (fundamental-only) "
                        "optimization, for testing/debugging")
    p.add_argument("-noharmpolish", action="store_true",
                   help="Do not jointly optimize the harmonics")
    p.add_argument("-noharmremove", action="store_true",
                   help="Do not remove harmonically related candidates")
    p.add_argument("-ncpus", type=int, default=1)
    p.add_argument("infile")
    return p


def write_cand_file(path: str, cands) -> None:
    """Binary .cand dump: one record per candidate of
    (power f4, sigma f4, numharm i4, r f8, z f8, w f8); atomic."""
    with atomic_open(path, "wb") as f:
        for c in cands:
            f.write(struct.pack("<ffiddd", c.power, c.sigma, c.numharm,
                                c.r, c.z, c.w))


def read_cand_file(path: str):
    """Parse a binary ACCEL .cand companion (the 36-byte records, or the
    28-byte records of the format before the jerk search).  Missing /
    truncated / malformed files raise the typed PrestoIOError."""
    rec = struct.calcsize("<ffiddd")          # 36: current format
    legacy = struct.calcsize("<ffidd")        # 28: pre-jerk format
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise PrestoIOError("cannot read .cand: %s" % e.strerror,
                            path=path, kind="missing") from None

    def parse(fmt, rlen, has_w):
        cands = []
        with open(path, "rb") as f:
            while True:
                b = f.read(rlen)
                if len(b) < rlen:
                    break
                vals = struct.unpack(fmt, b)
                power, sigma, numharm, r, z = vals[:5]
                w = vals[5] if has_w else 0.0
                cands.append(AccelCand(power=power, sigma=sigma,
                                       numharm=numharm, r=r, z=z, w=w))
        return cands

    def sane(cands):
        return cands and all(
            1 <= c.numharm <= 32 and c.r >= 0.0
            and np.isfinite(c.power) and np.isfinite(c.r)
            for c in cands)

    # a size divisible by lcm(36, 28) fits both formats: pick the one
    # whose records are plausible (new format first)
    candidates = []
    if size % rec == 0:
        candidates.append(("<ffiddd", rec, True))
    if size % legacy == 0:
        candidates.append(("<ffidd", legacy, False))
    if not candidates:
        raise PrestoIOError(
            "not a .cand file (size fits neither the %d- nor the "
            "%d-byte record format)" % (rec, legacy), path=path,
            offset=size - size % rec,
            expected_bytes=(size // rec + 1) * rec,
            actual_bytes=size, kind="truncated-data")
    for fmt, rlen, has_w in candidates:
        out = parse(fmt, rlen, has_w)
        if sane(out):
            return out
    return parse(*candidates[-1])


def write_accel_file(path: str, cands, T: float,
                     with_w: bool = False) -> None:
    """Text table with the reference's column structure
    (output_fundamentals, accel_utils.c:565-718); jerk runs append an
    FFT 'w' column.  Atomic on disk: a killed search never leaves a
    half-written ACCEL table for a resume to trust."""
    with atomic_open(path, "w") as f:
        f.write("             Summed  Coherent  Num        Period      "
                "    Frequency         FFT 'r'        Freq Deriv      "
                "FFT 'z'      Accel    "
                + ("  FFT 'w'   " if with_w else "") + "\n")
        f.write("Cand  Sigma   Power    Power   Harm       (ms)        "
                "      (Hz)            (bin)           (Hz/s)         "
                "(bins)      (m/s^2)  "
                + ("  (bins)    " if with_w else "") + "\n")
        f.write("-" * (142 if with_w else 130) + "\n")
        for i, c in enumerate(cands, 1):
            freq = c.r / T
            period_ms = 1000.0 / freq if freq > 0 else 0.0
            fdot = c.z / (T * T)
            accel = c.z * 299792458.0 / (T * T * max(freq, 1e-12))
            f.write("%-4d  %-5.2f  %-7.2f  %-7.2f  %-3d  %-15.8g  "
                    "%-15.8g  %-14.4f  %-15.6g  %-10.2f  %-10.4g"
                    % (i, c.sigma, c.power, c.power / c.numharm,
                       c.numharm, period_ms, freq, c.r, fdot, c.z,
                       accel))
            if with_w:
                f.write("  %-10.2f" % c.w)
            f.write("\n")


@dataclass
class RefineTrace:
    """What refine did to a raw list, step by step: the seeds of the
    polish (after harmonic elimination and dedup), the polished
    candidates, with wmax the jerk polish's seeds and results, and the
    final list (before any lobin shift) with, per final candidate, the
    index of its seed and whether it took the jerk polish's point.
    nraw counts the raw list after harmonic elimination; numindep is the
    searcher's, per stage (the sigmas')."""
    nraw: int
    numindep: list
    cands: List[AccelCand]
    ocs: list
    jseeds: List[AccelCand]
    jocs: list
    final: List[AccelCand]
    seed_of: List[int]
    jerk_taken: List[bool]


def refine(raw_cands, amps, T, searcher, wmax=0, harmremove=True,
           harmpolish=True, timer=None, device=None) -> RefineTrace:
    """The candidate post-processing shared by the CLI and the survey,
    before write_results writes its files: harmonic elimination (unless
    -noharmremove), dedup, the batched polish on the searcher's device
    (with wmax then the jerk polish, seeded from it with each candidate's
    search w: its (r, z, w) is kept where |w| <= wmax and its power beats
    the (r, z) polish's, else w is 0), dedup again.  amps: the spectrum
    (a tensor of [n, 2] float32 pairs, or numpy).  ``device``: where the
    polish runs (default: the searcher's; a shard's spectrum is polished
    on its own device).  With a ``timer``
    (utils/timing.StageTimer) the polish is timed as stage "polish".  The
    raw candidates are not changed."""
    def stage(name):
        return timer.stage(name) if timer is not None else nullcontext()

    if harmremove:
        raw_cands = eliminate_harmonics(raw_cands)
    cands = remove_duplicates(raw_cands)
    jseeds, jocs = [], [None] * len(cands)
    if device is None:
        device = searcher.device
    with stage("polish"):
        ocs = optimize_accelcands(amps, cands, T, searcher.numindep,
                                  harmpolish=harmpolish, with_props=False,
                                  device=device)
        if wmax and cands:
            jseeds = [AccelCand(power=o.power, sigma=o.sigma,
                                numharm=o.numharm, r=o.r, z=o.z, w=c.w)
                      for c, o in zip(cands, ocs)]
            jocs = optimize_jerk_cands(amps, jseeds, T, searcher.numindep,
                                       harmpolish=harmpolish,
                                       device=device)
    refined, taken = [], []
    for c, oc, joc in zip(cands, ocs, jocs):
        c = replace(c, r=oc.r, z=oc.z, power=oc.power, sigma=oc.sigma)
        took = bool(wmax) and abs(joc.w) <= wmax and joc.power > c.power
        if took:
            c = replace(c, r=joc.r, z=joc.z, w=joc.w, power=joc.power,
                        sigma=joc.sigma)
        elif wmax:
            c.w = 0.0
        refined.append(c)
        taken.append(took)
    final = remove_duplicates(refined)
    index = {id(c): k for k, c in enumerate(refined)}
    seed_of = [index[id(c)] for c in final]
    return RefineTrace(nraw=len(raw_cands), numindep=list(searcher.numindep),
                       cands=cands, ocs=ocs, jseeds=jseeds, jocs=jocs,
                       final=final, seed_of=seed_of,
                       jerk_taken=[taken[k] for k in seed_of])


def write_results(trace: RefineTrace, T, base, zmax, wmax=0, quiet=False,
                  lobin=0, timer=None) -> str:
    """The ACCEL table and .cand of a refined list (<base>_ACCEL_<zmax>,
    with wmax <base>_ACCEL_<zmax>_JERK_<wmax> with its w column).  lobin
    shifts reported frequencies for spectra chopped out of a longer FFT.
    With a ``timer`` the writes are timed as stage "accel writes".
    Returns the ACCEL path."""
    cands = trace.final
    if lobin:
        # candidate r is in fundamental units; the chopped spectrum's
        # bin 0 is absolute bin `lobin`, so every reported frequency
        # shifts by lobin whole bins
        for c in cands:
            c.r += lobin
    accelnm = "%s_ACCEL_%d" % (base, zmax)
    if wmax:
        accelnm += "_JERK_%d" % wmax
    with (timer.stage("accel writes") if timer is not None
          else nullcontext()):
        write_accel_file(accelnm, cands, T, with_w=bool(wmax))
        write_cand_file(accelnm + ".cand", cands)
    if not quiet:
        print("accelsearch: %d raw -> %d final candidates -> %s"
              % (trace.nraw, len(cands), accelnm))
    return accelnm


def run(args, device="cuda") -> RefineTrace:
    """The CLI on ``device``: search, refine, write; returns the
    refinement's trace (its final list is what the files hold)."""
    dev = resolve_device(device)
    base, ext = os.path.splitext(args.infile)
    if ext == ".dat" or (not os.path.exists(base + ".fft")
                         and os.path.exists(base + ".dat")):
        data, info = load_timeseries(base)
        n = data.size & ~1
        pairs = fftpack.realfft_packed_pairs(torch.as_tensor(
            data[:n] - data[:n].mean(), device=dev)).cpu().numpy()
        amps = deredden(fftpack.np_pairs_to_complex64(pairs))
        pairs = fftpack.np_complex64_to_pairs(amps)
    else:
        pairs, info = load_spectrum(base)
    T = info.N * info.dt
    numbins = pairs.shape[0]

    if args.zaplist:
        birds = read_birds_bary(args.zaplist)
        amps = fftpack.np_pairs_to_complex64(pairs)
        amps = zap_bins(amps, birds_to_bin_ranges(birds, T, args.baryv))
        pairs = fftpack.np_complex64_to_pairs(amps)

    norm = "median"
    if args.photon:
        # Poissonian normalization: freq-0 power = photon count nph;
        # scale amplitudes by 1/sqrt(nph) (accel_utils.c:941-950)
        nph = max(float(pairs[0, 0]), 1.0)
        pairs = (pairs / np.float32(np.sqrt(nph))).astype(np.float32)
        norm = "prenorm"
    elif args.locpow:
        from presto_tpu_torch.search.optimize import spectrum_local_powers
        amps = fftpack.np_pairs_to_complex64(pairs)
        amps = (amps / np.sqrt(spectrum_local_powers(amps))
                ).astype(np.complex64)
        pairs = fftpack.np_complex64_to_pairs(amps)
        norm = "prenorm"

    rlo = args.rlo
    rhi = args.rhi or (args.fhi * T if args.fhi else 0.0)
    if args.lobin:       # searched bins are relative to the chop point
        rlo = max(rlo - args.lobin, 0.0)
        rhi = max(rhi - args.lobin, 0.0) if rhi else 0.0
    cfg = AccelConfig(zmax=args.zmax, wmax=args.wmax, numharm=args.numharm,
                      sigma=args.sigma, flo=args.flo, rlo=rlo, rhi=rhi,
                      norm=norm)
    searcher = AccelSearch(cfg, T=T, numbins=numbins, device=dev)
    pairs_dev = torch.as_tensor(pairs, device=dev)
    raw = searcher.search(pairs_dev)
    trace = refine(raw, pairs_dev, T, searcher, wmax=args.wmax,
                   harmremove=not args.noharmremove,
                   harmpolish=not (args.noharmpolish or args.otheropt))
    write_results(trace, T, base, args.zmax, args.wmax, lobin=args.lobin)
    return trace


def main(argv=None, device="cuda") -> int:
    from presto_tpu_torch.utils.timing import app_timer
    args = build_parser().parse_args(argv)
    with app_timer("accelsearch"):
        run(args, device=device)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

