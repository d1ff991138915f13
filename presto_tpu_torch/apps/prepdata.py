"""prepdata: raw data -> single-DM dedispersed time series (.dat+.inf).

PyTorch counterpart of ``presto_tpu/apps/prepdata.py``, with its flags
(clig/prepdata_cmd.cli; src/prepdata.c:34-): -o, -dm, -downsamp,
-nobary, -ephem, -mask, -clip, -zerodm, -numout, -ignorechan, -shorts,
-resume and the raw-input flags (SIGPROC, PSRFITS or several files as
one observation, apps/common.open_raw_args).  Barycentring is on by
default (apps/common.make_bary_plan, the port's astro/baryshift):
dispersion delays are taken at the Doppler-shifted frequencies and the
series is resampled on the diffbins schedule (prepdata.c:469-505), with
the epoch the barycentric MJD of the first sample.

Pipeline (reference read_psrdata, backend_common.c:505-604): the
streamed pass of pipeline/fusion.stream_series (native decode, -mask
with the padding values of the .stats beside it, clip, -zerodm and
-ignorechan on the host; upload; the channel-ordered shift-and-sum at
-dm on ``device``), then on the host the -downsamp mean, the bary
resample and the pad to a good length.  The .dat/.inf bytes equal the
JAX package's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.apps.common import (CLIResume, add_common_flags,
                                          add_raw_flags, block_prep,
                                          fil_to_inf, make_bary_plan,
                                          open_raw_args, pad_to_good_N,
                                          set_bary_epoch, set_onoff,
                                          start_skip_spectra,
                                          stream_blocklen)
from presto_tpu_torch.io.datfft import write_dat, write_sdat
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.search.accel import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prepdata",
        description="Prepare (dedisperse) raw data into a .dat series")
    add_common_flags(p)
    p.add_argument("-dm", type=float, default=0.0,
                   help="Dispersion measure (cm-3 pc)")
    p.add_argument("-downsamp", type=int, default=1)
    p.add_argument("-nobary", action="store_true",
                   help="Do not barycenter the output (default is to "
                        "barycenter)")
    p.add_argument("-ephem", type=str, default="DE405",
                   help="Ephemeris: a DE name, a .npz table or a JPL "
                        ".bsp SPK kernel")
    p.add_argument("-mask", type=str, default=None,
                   help="rfifind .mask file to apply")
    p.add_argument("-clip", type=float, default=6.0,
                   help="Time-domain clip sigma (0=no clipping)")
    p.add_argument("-zerodm", action="store_true")
    p.add_argument("-numout", type=int, default=0,
                   help="Output exactly this many samples (pad/truncate)")
    p.add_argument("-ignorechan", type=str, default=None,
                   help="Channels to zero out, e.g. '0:5,34'")
    p.add_argument("-shorts", action="store_true",
                   help="Write short ints (.sdat) instead of floats")
    p.add_argument("-resume", action="store_true",
                   help="Skip the run when the outputs exist AND match "
                        "the manifest.json journal next to them; journal "
                        "them on completion")
    add_raw_flags(p)
    p.add_argument("rawfiles", nargs="+")
    return p


def run(args, device="cuda") -> str:
    """Dedisperse ``args.rawfiles`` at ``args.dm`` on ``device`` and write
    <outbase>.dat (or .sdat) + .inf; returns the outbase."""
    device = resolve_device(device)
    outbase = args.outfile or "prepdata_out"
    suffix = ".sdat" if args.shorts else ".dat"
    resume = None
    if args.resume:
        resume = CLIResume(outbase, "prepdata-cli")
        expected = [outbase + suffix, outbase + ".inf"]
        if resume.complete(expected):
            print("prepdata: -resume verified %s%s + .inf against the "
                  "journal — skipping" % (outbase, suffix))
            return outbase
        resume.invalidate_stale(expected)
    fb = open_raw_args(args.rawfiles, args)
    try:
        hdr = fb.header
        nchan, dt = hdr.nchans, hdr.tsamp
        skip = start_skip_spectra(args, int(hdr.N))
        Ntot = int(hdr.N) - skip
        plan = (make_bary_plan(fb, dt * args.downsamp, args.ephem,
                               skip_spectra=skip)
                if not args.nobary else None)
        avgvoverc = plan.avgvoverc if plan is not None else 0.0
        delays = dd.dedisp_delays(nchan, args.dm, hdr.lofreq,
                                  abs(hdr.foff), voverc=avgvoverc)
        bins = dd.delays_to_bins(delays - delays.min(), dt)
        blocklen = stream_blocklen(nchan, int(bins.max()), nspec=Ntot)
        result = fusion.stream_series(fb, block_prep(args, nchan, dt),
                                      bins, blocklen, device, skip=skip)
        if args.downsamp > 1:
            n = result.size // args.downsamp * args.downsamp
            result = result[:n].reshape(-1, args.downsamp).mean(axis=1)
        if plan is not None:
            result = plan.apply(result)
        result, valid, numout = pad_to_good_N(result, args.numout)

        info = fil_to_inf(fb, outbase, result.size, dm=args.dm)
        if plan is not None:
            set_bary_epoch(info, plan)
        elif skip:
            info.mjd_f += skip * dt / 86400.0
            info.mjd_i += int(info.mjd_f)
            info.mjd_f %= 1.0
        info.dt = dt * args.downsamp
        set_onoff(info, valid, numout)
        result = result.astype(np.float32)
        suffix = ".dat"
        if args.shorts:
            off = write_sdat(outbase + ".sdat", result, info)
            if off is None:
                print("Error: way too much dynamic range for shorts; "
                      "writing floats instead.")
                write_dat(outbase + ".dat", result, info)
            else:
                suffix = ".sdat"
                if off:
                    print("          Offset applied to data:  %d"
                          % -int(off))
        else:
            write_dat(outbase + ".dat", result, info)
    finally:
        fb.close()
    if resume is not None:
        resume.record([outbase + suffix, outbase + ".inf"])
    print("Wrote %d samples to %s%s (DM=%g, downsamp=%d)"
          % (result.size, outbase, suffix, args.dm, args.downsamp))
    return outbase


def main(argv=None, device="cuda") -> int:
    from presto_tpu_torch.utils.timing import app_timer
    args = build_parser().parse_args(argv)
    with app_timer("prepdata"):
        run(args, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
