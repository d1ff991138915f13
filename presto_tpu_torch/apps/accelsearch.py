"""accelsearch: F-Fdot acceleration search over a .fft or .dat file.

PyTorch counterpart of ``presto_tpu/apps/accelsearch.py`` (CLI parity
with the reference accelsearch, clig/accelsearch_cmd.cli): -zmax,
-numharm, -sigma, -flo/-fhi/-rlo/-rhi, -lobin, -zaplist, -baryv and the
normalization flags.  Outputs <base>_ACCEL_<zmax> (text candidate table,
column structure of output_fundamentals accel_utils.c:565-718) and
<base>_ACCEL_<zmax>.cand (binary candidate dump), byte-equal to the JAX
package's writers for the same candidates.

The polish is the JAX package's default path, the batched polish
(search/polish.py), on the search's device.  It has no per-candidate
fallback: a failure raises.  The jerk refinement (-wmax) waits for the
jerk search and raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import struct
from contextlib import nullcontext

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
from presto_tpu_torch.search.polish import optimize_accelcands


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
                   help="Jerk refinement (not in the port yet)")
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


def write_accel_file(path: str, cands, T: float) -> None:
    """Text table with the reference's column structure
    (output_fundamentals, accel_utils.c:565-718).  Atomic on disk: a
    killed search never leaves a half-written ACCEL table for a resume
    to trust."""
    with atomic_open(path, "w") as f:
        f.write("             Summed  Coherent  Num        Period      "
                "    Frequency         FFT 'r'        Freq Deriv      "
                "FFT 'z'      Accel    \n")
        f.write("Cand  Sigma   Power    Power   Harm       (ms)        "
                "      (Hz)            (bin)           (Hz/s)         "
                "(bins)      (m/s^2)  \n")
        f.write("-" * 130 + "\n")
        for i, c in enumerate(cands, 1):
            freq = c.r / T
            period_ms = 1000.0 / freq if freq > 0 else 0.0
            fdot = c.z / (T * T)
            accel = c.z * 299792458.0 / (T * T * max(freq, 1e-12))
            f.write("%-4d  %-5.2f  %-7.2f  %-7.2f  %-3d  %-15.8g  "
                    "%-15.8g  %-14.4f  %-15.6g  %-10.2f  %-10.4g\n"
                    % (i, c.sigma, c.power, c.power / c.numharm,
                       c.numharm, period_ms, freq, c.r, fdot, c.z,
                       accel))


def refine_and_write(raw_cands, amps, T, searcher, base, zmax, wmax=0,
                     quiet=False, harmremove=True, harmpolish=True,
                     lobin=0, timer=None):
    """Candidate post-processing shared by the CLI and the survey:
    harmonic elimination (unless -noharmremove), dedup, the batched
    polish on the searcher's device, dedup again, ACCEL/.cand artifacts.
    amps: the spectrum (a tensor of [n, 2] float32 pairs, or numpy).
    lobin shifts reported frequencies for spectra chopped out of a
    longer FFT.  With a ``timer`` (utils/timing.StageTimer) the polish
    and the writes are timed as stages "polish" and "accel writes".
    Returns (final candidates, ACCEL path)."""
    if wmax:
        raise NotImplementedError("accelsearch: the jerk refinement "
                                  "(wmax) is not in the port yet")

    def stage(name):
        return timer.stage(name) if timer is not None else nullcontext()

    if harmremove:
        raw_cands = eliminate_harmonics(raw_cands)
    cands = remove_duplicates(raw_cands)
    with stage("polish"):
        ocs = optimize_accelcands(amps, cands, T, searcher.numindep,
                                  harmpolish=harmpolish, with_props=False,
                                  device=searcher.device)
    for c, oc in zip(cands, ocs):
        c.r, c.z = oc.r, oc.z
        c.power, c.sigma = oc.power, oc.sigma
    cands = remove_duplicates(cands)
    if lobin:
        # candidate r is in fundamental units; the chopped spectrum's
        # bin 0 is absolute bin `lobin`, so every reported frequency
        # shifts by lobin whole bins
        for c in cands:
            c.r += lobin
    accelnm = "%s_ACCEL_%d" % (base, zmax)
    with stage("accel writes"):
        write_accel_file(accelnm, cands, T)
        write_cand_file(accelnm + ".cand", cands)
    if not quiet:
        print("accelsearch: %d raw -> %d final candidates -> %s"
              % (len(raw_cands), len(cands), accelnm))
    return cands, accelnm


def run(args, device="cuda"):
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
    cands, _ = refine_and_write(
        raw, pairs_dev, T, searcher, base, args.zmax, args.wmax,
        harmremove=not args.noharmremove,
        harmpolish=not (args.noharmpolish or args.otheropt),
        lobin=args.lobin)
    return cands


def main(argv=None, device="cuda") -> int:
    from presto_tpu_torch.utils.timing import app_timer
    args = build_parser().parse_args(argv)
    with app_timer("accelsearch"):
        run(args, device=device)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
