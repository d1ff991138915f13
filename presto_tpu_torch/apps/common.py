"""Shared app plumbing (host copy, trimmed).

Copy of the parts of ``presto_tpu/apps/common.py`` that the
prepsubband streaming loop, rfifind, accelsearch and prepfold use: the
raw-data flags, open_raw and open_raw_args (SIGPROC filterbanks and
PSRFITS, one file or several as one observation: -psrfits/-filterbank
beat the suffix and content sniffing of identify_datatype),
obs_metadata, BlockPrep (mask substitution, clipping on by default,
zero-DM, running average, ignorechan) and block_prep, stream_blocklen,
pad_to_good_N, set_onoff, fil_to_inf, make_bary_plan and set_bary_epoch
(barycentring), load_timeseries, load_spectrum and CLIResume (the app
CLIs' -resume).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import InfoData, read_inf
from presto_tpu_torch.io.maskfile import determine_padvals, read_mask
from presto_tpu_torch.io.psrfits import PsrfitsFile
from presto_tpu_torch.io.sigproc import FilterbankFile, FilterbankSet
from presto_tpu_torch.ops.clipping import (clip_times, mask_block,
                                           remove_zerodm)
from presto_tpu_torch.utils.psr import choose_N, good_fft_size
from presto_tpu_torch.utils.ranges import parse_ranges


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-o", dest="outfile", type=str, required=False,
                   help="Root of the output file names")
    p.add_argument("-ncpus", type=int, default=1,
                   help="Accepted for parity")


def add_raw_flags(p: argparse.ArgumentParser,
                  start_flags: bool = True) -> None:
    """The raw-data input flags of the prep family (prepfold has its own
    -start and -offset: start_flags=False)."""
    p.add_argument("-filterbank", action="store_true",
                   help="Raw data in SIGPROC filterbank format")
    p.add_argument("-psrfits", action="store_true",
                   help="Raw data in PSRFITS format")
    p.add_argument("-noweights", action="store_true",
                   help="Do not apply PSRFITS weights")
    p.add_argument("-noscales", action="store_true",
                   help="Do not apply PSRFITS scales")
    p.add_argument("-nooffsets", action="store_true",
                   help="Do not apply PSRFITS offsets")
    p.add_argument("-invert", action="store_true",
                   help="For rawdata, flip (or invert) the band")
    p.add_argument("-noclip", action="store_true",
                   help="Do not clip the data (default is to clip)")
    if start_flags:
        p.add_argument("-offset", type=int, default=0,
                       help="Number of spectra to offset into as starting "
                            "data point")
        p.add_argument("-start", type=float, default=0.0,
                       help="Starting point of the processing as a "
                            "fraction of the full obs")


def identify_datatype(path: str) -> str:
    """Sniff the raw-data format (identify_psrdatatype,
    backend_common.c:102-143: suffix first, then content)."""
    if path.endswith((".fits", ".sf", ".fit")):
        return "psrfits"
    if path.endswith(".fil"):
        return "sigproc"
    with open(path, "rb") as f:
        magic = f.read(80)
    if magic.startswith(b"SIMPLE  ="):
        return "psrfits"
    return "sigproc"


def _sniff_kind(paths) -> str:
    kinds = {identify_datatype(p) for p in paths}
    if len(kinds) > 1:
        raise SystemExit("cannot mix raw data formats: %s" % kinds)
    return kinds.pop()


def open_raw_args(paths, args):
    """Open one path or a list of paths as a single observation, honoring
    the shared raw flags: explicit format selection (-psrfits/-filterbank
    beat suffix sniffing, backend_common.c identify via cmd flags) and the
    PSRFITS -noweights/-noscales/-nooffsets decode toggles.  Several
    SIGPROC files are a FilterbankSet, PSRFITS files one PsrfitsFile."""
    if isinstance(paths, str):
        paths = [paths]
    force = None
    if getattr(args, "psrfits", False):
        force = "psrfits"
    elif getattr(args, "filterbank", False):
        force = "sigproc"
    kind = force or _sniff_kind(paths)
    if kind == "psrfits":
        kw = {}
        if getattr(args, "noweights", False):
            kw["apply_weight"] = False
        if getattr(args, "noscales", False):
            kw["apply_scale"] = False
        if getattr(args, "nooffsets", False):
            kw["apply_offset"] = False
        return PsrfitsFile(paths, **kw)
    if len(paths) == 1:
        return FilterbankFile(paths[0])
    return FilterbankSet(paths)


def open_raw(paths):
    """Open one path or a list of paths as a single observation.
    Dispatches on format like read_rawdata_files
    (backend_common.c:77-92)."""
    return open_raw_args(paths, argparse.Namespace())


def obs_metadata(fb) -> Tuple[str, str, str]:
    """(telescope name, ra 'hh:mm:ss', dec 'dd:mm:ss') for any reader."""
    if hasattr(fb, "ra_str"):  # PsrfitsFile carries strings natively
        return (fb.telescope or "Unknown",
                fb.ra_str or "00:00:00.0000",
                fb.dec_str or "00:00:00.0000")
    hdr = fb.header
    tel = SIGPROC_TELESCOPES.get(getattr(hdr, "telescope_id", -1),
                                 "Unknown")
    return (tel,
            sigproc_coord_to_str(getattr(hdr, "src_raj", 0.0)),
            sigproc_coord_to_str(getattr(hdr, "src_dej", 0.0)))


def clip_sigma_from(args) -> float:
    """-noclip beats -clip (the reference's noclipP sets clip=0)."""
    if getattr(args, "noclip", False):
        return 0.0
    return getattr(args, "clip", 6.0)


def start_skip_spectra(args, N: int) -> int:
    """First spectrum to process from -offset/-start."""
    skip = int(getattr(args, "offset", 0) or 0)
    frac = float(getattr(args, "start", 0.0) or 0.0)
    if frac > 0.0:
        skip = max(skip, int(frac * N))
    return min(skip, N)


class CLIResume:
    """Journal-backed ``-resume`` for an app CLI: the tool journals its
    outputs (size + CRC-32) in the ``manifest.json`` beside them, the
    survey's journal (pipeline/manifest.py), so a relaunched run skips
    outputs only when they exist, verify and were journaled by the same
    stage, and redoes anything missing, truncated or stale."""

    def __init__(self, outbase: str, stage: str):
        from presto_tpu_torch.pipeline.manifest import SurveyManifest
        self.workdir = os.path.dirname(os.path.abspath(outbase)) or "."
        self.manifest = SurveyManifest.load(self.workdir)
        self.stage = stage

    def complete(self, paths) -> bool:
        """Every expected output exists, verifies and was journaled by
        this tool's stage."""
        paths = list(paths)
        return bool(paths) and all(
            self.manifest.valid(p) and self.manifest.stage_of(p) == self.stage
            for p in paths)

    def invalidate_stale(self, paths) -> list:
        """Delete and forget outputs that fail verification; returns them."""
        return self.manifest.invalidate_stale(list(paths))

    def record(self, paths) -> None:
        self.manifest.record_many([p for p in paths if os.path.exists(p)],
                                  self.stage)


def load_timeseries(path: str) -> Tuple[np.ndarray, InfoData]:
    """Load a .dat (+ .inf sidecar) time series."""
    base = path[:-4] if path.endswith(".dat") else path
    data = datfft.read_dat(base + ".dat")
    info = read_inf(base)
    return data, info


def load_spectrum(path: str) -> Tuple[np.ndarray, InfoData]:
    """Load a packed .fft (+ .inf) as float32 [n,2] pairs."""
    base = path[:-4] if path.endswith(".fft") else path
    amps = datfft.read_fft(base + ".fft")
    info = read_inf(base)
    pairs = np.stack([amps.real, amps.imag], -1).astype(np.float32)
    return pairs, info


class BlockPrep:
    """Per-block preprocessing shared by the prep family: band invert,
    mask substitution, clipping (with carry state), zero-DM removal,
    running-average subtraction, and ignorechan zeroing — the
    read->transform stack of read_psrdata/prep_subbands
    (backend_common.c:505-738).  The JAX package's BlockPrep, except
    that the mask substitution and the clip write into the block they
    are given (the same values as the JAX package's copies): the
    caller hands it a block it owns, such as a pinned upload buffer."""

    def __init__(self, nchan, dt, args, mask=None, padvals=None,
                 ignore=None):
        self.nchan = nchan
        self.dt = dt
        self.invert = bool(getattr(args, "invert", False))
        self.clip = clip_sigma_from(args)
        self.zerodm = bool(getattr(args, "zerodm", False))
        self.runavg = bool(getattr(args, "runavg", False))
        self.mask = mask
        self.have_mask = mask is not None
        self.padvals = (padvals if padvals is not None
                        else np.zeros(nchan, np.float32))
        self.ignore = ignore
        self._clip_state = None

    def __call__(self, block, start_spectra):
        """block: [T, C] float32 (ascending freq), the first spectrum
        at ``start_spectra`` (the mask is looked up in seconds from
        there); returns the same shape."""
        if self.invert:
            block = block[:, ::-1]
        if self.have_mask:
            n, chans = self.mask.check_mask(start_spectra * self.dt,
                                            block.shape[0] * self.dt)
            if n == -1:
                block[:] = self.padvals[None, :]
            elif n > 0:
                block = mask_block(block, chans, self.padvals, out=block)
        if self.clip > 0:
            block, _, self._clip_state = clip_times(
                block, self.clip, self._clip_state, out=block)
        if self.zerodm:
            block = remove_zerodm(
                block, self.padvals if self.have_mask else None)
        if self.runavg:
            # per-channel block-mean subtraction (the reference's
            # run_avg in read_PRESTO_subbands, prepsubband.c:838-846)
            block = block - block.mean(axis=0, keepdims=True)
        if self.ignore is not None:
            block[:, self.ignore] = 0.0
        return block


def block_prep(args, nchan: int, dt: float) -> BlockPrep:
    """A fresh BlockPrep (the clipper carries state across blocks, so
    each pass over the file needs its own) from the shared flags: the
    -mask file with its padding values from the .stats beside it (zeros
    when there is none), and -ignorechan."""
    mask = read_mask(args.mask) if getattr(args, "mask", None) else None
    padvals = None
    if mask is not None:
        try:
            padvals = determine_padvals(args.mask.replace(".mask",
                                                          ".stats"))
        except OSError:
            padvals = np.zeros(nchan, np.float32)
    ignore = (np.asarray(parse_ranges(args.ignorechan), np.int64)
              if getattr(args, "ignorechan", None) else None)
    return BlockPrep(nchan, dt, args, mask=mask, padvals=padvals,
                     ignore=ignore)


def good_numout(valid: int, numout: int = 0) -> int:
    """The output length pad_to_good_N gives ``valid`` samples: numout
    when set, else choose_N(valid) (a highly factorable length)."""
    return numout or choose_N(valid) or good_fft_size(valid, multiple_of=2)


def pad_to_good_N(series: np.ndarray, numout: int = 0
                  ) -> Tuple[np.ndarray, int, int]:
    """Pad (with the per-series mean) or truncate the LAST axis to a
    highly factorable length (choose_N(valid) when numout is 0).
    Returns (padded, valid, numout)."""
    valid = series.shape[-1]
    numout = good_numout(valid, numout)
    if numout > valid:
        pad_shape = series.shape[:-1] + (numout - valid,)
        mean = series.mean(axis=-1, keepdims=True)
        series = np.concatenate(
            [series, np.broadcast_to(mean.astype(series.dtype),
                                     pad_shape)], axis=-1)
    else:
        series = series[..., :numout]
        valid = numout
    return series, valid, numout


def set_onoff(info: InfoData, valid: int, numout: int) -> None:
    """Record the data/padding boundary in the .inf when padding was
    added (makeinf.h onoff semantics)."""
    if numout > valid:
        info.numonoff = 2
        info.onoff = [(0.0, float(valid - 1)),
                      (float(numout - 1), float(numout - 1))]


# sigproc telescope_id -> name (get_telescope_name, sigproc_fb.c:70-140)
SIGPROC_TELESCOPES = {
    0: "Fake", 1: "Arecibo", 2: "Ooty", 3: "Nancay", 4: "Parkes",
    5: "Jodrell", 6: "GBT", 7: "GMRT", 8: "Effelsberg", 9: "ATA",
    10: "SRT", 11: "LOFAR", 12: "VLA", 64: "MeerKAT", 65: "KAT-7",
}


def sigproc_coord_to_str(coord: float) -> str:
    """sigproc packed coordinate (hhmmss.s / ddmmss.s) -> 'hh:mm:ss.ssss'."""
    sign = "-" if coord < 0 else ""
    c = abs(float(coord))
    hh = int(c / 10000.0)
    mm = int((c - hh * 10000.0) / 100.0)
    ss = c - hh * 10000.0 - mm * 100.0
    return "%s%.2d:%.2d:%07.4f" % (sign, hh, mm, ss)


def make_bary_plan(fb, dsdt: float, ephem: str = "DE405",
                   skip_spectra: int = 0):
    """Build the barycentering plan for an open observation, or return
    None (with a warning) when the file carries no usable position —
    silently barycentering RA=DEC=0 junk would corrupt the output while
    claiming bary=1.  Shared by prepsubband and its survey callers
    (the TEMPO-call setup of prepsubband.c:420-505)."""
    from presto_tpu_torch.astro.bary import parse_dec, parse_ra
    from presto_tpu_torch.astro.baryshift import BaryPlan
    from presto_tpu_torch.astro.observatory import telescope_to_tempocode
    hdr = fb.header
    tel, ra_str, dec_str = obs_metadata(fb)
    obscode, _ = telescope_to_tempocode(tel)
    if parse_ra(ra_str) == 0.0 and parse_dec(dec_str) == 0.0:
        print("WARNING: no source position in the raw data header -- "
              "writing topocentric output (bary=0). Use real "
              "coordinates or -nobary to silence this.")
        return None
    if obscode == "EC" and tel.strip().lower() != "geocenter":
        print("WARNING: unrecognized telescope %r -- barycentering "
              "from the geocenter (up to ~21 ms Roemer error)." % tel)
    tstart = hdr.tstart + skip_spectra * hdr.tsamp / 86400.0
    plan = BaryPlan(tstart,
                    (float(hdr.N) - skip_spectra) * hdr.tsamp, dsdt,
                    ra_str, dec_str, obscode, ephem)
    print("Average topocentric velocity (c) = %.7g" % plan.avgvoverc)
    return plan


def set_bary_epoch(info: InfoData, plan) -> None:
    """Stamp the barycentric epoch of the first sample into the .inf."""
    info.bary = 1
    info.mjd_i = int(plan.blotoa)
    info.mjd_f = plan.blotoa % 1.0


def fil_to_inf(fb, outbase: str, N: int,
               dm: float = 0.0, bary: int = 0) -> InfoData:
    hdr = fb.header
    tel, ra_str, dec_str = obs_metadata(fb)
    return InfoData(
        name=outbase, telescope=tel, instrument="Unknown",
        ra_str=ra_str, dec_str=dec_str,
        object=hdr.source_name or "Unknown",
        mjd_i=int(hdr.tstart), mjd_f=hdr.tstart % 1.0, bary=bary,
        N=float(N), dt=hdr.tsamp, band="Radio", dm=dm,
        freq=hdr.lofreq, freqband=abs(hdr.foff) * hdr.nchans,
        num_chan=hdr.nchans, chan_wid=abs(hdr.foff),
        analyzer="presto_tpu")


def stream_blocklen(nchan: int, maxd: int,
                    nspec: Optional[int] = None) -> int:
    """Streaming block length for the two-block dedispersion window:
    at most a ~128 MB [nchan, blocklen] float32 block, longer than the
    largest delay, clamped to the observation (a mostly-zero block
    would poison the clipper's running statistics)."""
    budget = (1 << 25) // max(nchan, 1)
    base = max(1 << 12, min(1 << 17, budget))
    blocklen = max(base, 1 << (maxd + 1).bit_length())
    if nspec is not None and 0 < nspec < blocklen:
        blocklen = max(int(nspec), 1 << (maxd + 1).bit_length())
    return blocklen
