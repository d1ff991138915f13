"""prepsubband: raw data -> numdms dedispersed series in one pass.

PyTorch counterpart of ``presto_tpu/apps/prepsubband.py``: the same
flags and two-level subband delay scheme (src/prepsubband.c,
dispersion.c:103-162), the single-device streamed block loop, and the
hand-off of the DM fan-out to an in-memory stage seam.  Output bytes
equal the JAX package's.

The filterbank streams through the native prefetching feeder and
decoder into pinned staging buffers (pipeline/fusion.feed_blocks): the
mask substitution, clip and -ignorechan run there on the host, in NumPy
(the clip's reduction order fixes the .dat bytes), the upload is
asynchronous and the time-major -> channel-major transpose runs on the
device.  -mask takes its padding values from the .stats beside the
mask, as the JAX package does.

Not in this slice (they raise NotImplementedError): -sub, barycentring
(run with -nobary), multi-host and elastic runs, and PSRFITS input.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from presto_tpu_torch.apps.common import (add_common_flags, add_raw_flags,
                                          block_prep, fil_to_inf,
                                          good_numout, open_raw,
                                          pad_to_good_N, set_onoff,
                                          start_skip_spectra,
                                          stream_blocklen)
from presto_tpu_torch.io.datfft import write_dat
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.search.accel import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prepsubband",
        description="De-disperse raw data into many DM trials")
    add_common_flags(p)
    p.add_argument("-lodm", type=float, default=0.0)
    p.add_argument("-dmstep", type=float, default=1.0)
    p.add_argument("-numdms", type=int, default=10)
    p.add_argument("-nsub", type=int, default=32)
    p.add_argument("-downsamp", type=int, default=1)
    p.add_argument("-mask", type=str, default=None)
    p.add_argument("-clip", type=float, default=6.0)
    p.add_argument("-zerodm", action="store_true")
    p.add_argument("-nobary", action="store_true")
    p.add_argument("-numout", type=int, default=0)
    p.add_argument("-runavg", action="store_true")
    p.add_argument("-sub", action="store_true")
    p.add_argument("-subdm", type=float, default=None)
    p.add_argument("-dmprec", type=int, default=2)
    p.add_argument("-ignorechan", type=str, default=None)
    add_raw_flags(p)
    p.add_argument("rawfiles", nargs="+")
    return p


def plan_delays(hdr, args):
    """Two-level delays: channel->subband at the center DM (or -subdm),
    then per-DM subband offsets (prepsubband.c:353-372)."""
    nchan, dt = hdr.nchans, hdr.tsamp
    dms = args.lodm + np.arange(args.numdms) * args.dmstep
    center_dm = args.lodm + 0.5 * (args.numdms - 1) * args.dmstep
    if getattr(args, "subdm", None) is not None:
        center_dm = args.subdm
    chan_del = dd.subband_search_delays(nchan, args.nsub, center_dm,
                                        hdr.lofreq, abs(hdr.foff))
    chan_bins = dd.delays_to_bins(chan_del, dt)
    sub_del = np.stack([dd.subband_delays(nchan, args.nsub, dm,
                                          hdr.lofreq, abs(hdr.foff))
                        for dm in dms])
    sub_del -= sub_del.min()
    dm_bins = dd.delays_to_bins(sub_del, dt)
    return dms, chan_bins, dm_bins


def _refuse_unported(args) -> None:
    for flag, on in (("-sub", args.sub),
                     ("barycentring (pass -nobary)", not args.nobary),
                     ("-psrfits", args.psrfits)):
        if on:
            raise NotImplementedError(
                "prepsubband: %s comes in a later slice of the port"
                % flag)
    if args.downsamp < 1:
        raise SystemExit("prepsubband: -downsamp must be >= 1")


def run(args, device="cuda", seam: fusion.StageSeam = None):
    """Dedisperse ``args.rawfiles`` on ``device``.  With a ``seam`` the
    fan-out is deposited there (see _seam_handoff); otherwise the .dat
    and .inf files are written.  Returns (outbase, dms)."""
    _refuse_unported(args)
    dev = resolve_device(device)
    fb = open_raw(args.rawfiles)
    hdr = fb.header
    nchan, dt = hdr.nchans, hdr.tsamp
    skip = start_skip_spectra(args, int(hdr.N))
    Neff = int(hdr.N) - skip
    dms, chan_bins, dm_bins = plan_delays(hdr, args)
    maxd = int(chan_bins.max()) + int(dm_bins.max())
    prep = block_prep(args, nchan, dt)
    blocklen = stream_blocklen(nchan, max(int(chan_bins.max()),
                                          int(dm_bins.max())), nspec=Neff)
    if blocklen % args.downsamp:
        blocklen += args.downsamp - blocklen % args.downsamp
    block_step = dd.make_block_step(chan_bins, dm_bins, args.nsub,
                                    args.downsamp)
    # each block's series goes straight into its columns of one output
    # tensor, [numdms, valid] plus room for the seam's pad: no list of
    # blocks and no concatenation held beside it
    valid = max((Neff - maxd) // args.downsamp, 0)
    width = max(valid, good_numout(valid, args.numout)) if seam is not None \
        else valid
    out = torch.empty((len(dms), width), dtype=torch.float32, device=dev)
    pos = 0
    prev_raw = prev_sub = None
    # the data blocks, then two zero flush blocks
    nblocks = -(-Neff // blocklen) + 2
    with contextlib.closing(fusion.feed_blocks(
            fb, prep, blocklen, nblocks, dev, skip=skip)) as feed:
        for _nread, cur in feed:
            if prev_raw is not None:
                if prev_sub is None:
                    sub = dd.dedisp_subbands_block(prev_raw, cur, chan_bins,
                                                   args.nsub)
                else:
                    sub, series = block_step(prev_raw, cur, prev_sub)
                    take = min(series.shape[1], valid - pos)
                    if take > 0:
                        out[:, pos:pos + take] = series[:, :take]
                        pos += take
                prev_sub = sub
            prev_raw = cur
    del prev_raw, prev_sub
    outbase = args.outfile or "prepsubband_out"
    if seam is not None:
        return _seam_handoff(args, fb, seam, out, dms, dt, valid, skip,
                             outbase)
    result, valid, numout = pad_to_good_N(out.cpu().numpy(), args.numout)
    for i, dmval in enumerate(dms):
        name = "%s_DM%.*f" % (outbase, args.dmprec, dmval)
        write_dat(name + ".dat", result[i],
                  _trial_inf(args, fb, name, numout, valid, dmval, dt,
                             skip))
    fb.close()
    return outbase, dms


def _trial_inf(args, fb, name, numout, valid, dmval, dt, skip):
    info = fil_to_inf(fb, name, numout, dm=float(dmval))
    if skip:
        info.mjd_f += skip * dt / 86400.0
        info.mjd_i += int(info.mjd_f)
        info.mjd_f %= 1.0
    info.dt = dt * args.downsamp
    set_onoff(info, valid, numout)
    info.name = name
    info.N = numout
    return info


def _seam_handoff(args, fb, seam, out, dms, dt, valid, skip, outbase):
    """Deposit the DM fan-out at the seam: ONE download gives the host
    copy; the pad tail is computed on the host with pad_to_good_N's
    NumPy semantics and written into ``out``'s spare columns, so the
    device series equal the .dat bytes bit for bit.  ``out`` is
    [numdms, >= max(valid, numout)] with the data in [:, :valid]."""
    nvalid = valid
    host, valid, numout = pad_to_good_N(out[:, :nvalid].cpu().numpy(),
                                        args.numout)
    if numout > nvalid:
        out[:, nvalid:numout] = torch.from_numpy(
            np.ascontiguousarray(host[:, nvalid:]))
    dev = out if out.shape[1] == numout else out[:, :numout].contiguous()
    names, infos = [], []
    for dmval in dms:
        name = "%s_DM%.*f" % (outbase, args.dmprec, dmval)
        names.append(name)
        infos.append(_trial_inf(args, fb, name, numout, valid, dmval, dt,
                                skip))
    seam.add_block(fusion.SeamBlock(
        names=names, infos=infos, dms=[float(d) for d in dms],
        series_dev=dev, series_host=host, valid=valid, numout=numout,
        dt=dt * args.downsamp))
    fb.close()
    return outbase, dms


def main(argv=None, device="cuda"):
    run(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
