"""Drift-scan preparation: carve a drifting observation into
overlapping per-pointing files.

Host copy of ``presto_tpu/pipeline/driftprep.py`` for the PyTorch port,
which imports nothing from the JAX package.

The reference pairs its drift survey driver with prep scripts that
split a continuous drift scan into "beams"/pointings before the
per-pointing search flow runs (bin/GBT350_drift_prep.py:25-33,
bin/GUPPI_drift_prep.py): each pointing is ``orig_N`` samples,
successive pointings step by ``orig_N * overlap_factor`` (0.5 — 50%
overlap so no pulsar transit straddles a boundary unseen), and each
output file is renamed after the sky coordinates at its start
(GBT350_drift_prep.py:85-100: "GBT350drift_<MJDi>_<coords>.fil").

TPU-first differences from the reference scripts:

* format-agnostic input — anything ``open_raw`` can read (SIGPROC
  filterbank or PSRFITS, single file or a multi-file scan), not the
  Spigot-FITS-only path of the original; output is standard SIGPROC
  filterbank, the drift-survey interchange format.
* the per-pointing coordinates are computed, not read from
  per-subfile headers: in a drift scan the telescope is parked, so
  the touched RA advances at the sidereal rate while Dec is fixed.
  We advance the scan-start RA by ``360 deg * t_mid / 86164.0905 s``
  (one sidereal day) to the pointing'd midpoint.  The reference gets
  the same answer by trusting the backend's per-file headers
  (GBT350_drift_prep.py:88-91).
* one pass writes every pointing (or a selected one), so the
  pipeline app can run prep + per-pointing surveys as one command
  (``--recipe gbt350drift --driftprep``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from presto_tpu_torch.apps.common import open_raw
from presto_tpu_torch.io.atomic import atomic_open
from presto_tpu_torch.io.sigproc import (FilterbankFile, FilterbankHeader,
                                         pack_bits, write_filterbank_header)

SIDEREAL_DAY_S = 86164.0905

# GBT350 drift defaults (GBT350_drift_prep.py:25-27): ~141 s of the
# 81.92 us data per pointing, 50% overlap.
ORIG_N = 1728000
OVERLAP_FACTOR = 0.5


def _sigproc_to_deg_ra(src_raj: float) -> float:
    """SIGPROC hhmmss.s -> RA degrees."""
    sign = -1.0 if src_raj < 0 else 1.0
    v = abs(src_raj)
    hh = int(v // 10000)
    mm = int((v - hh * 10000) // 100)
    ss = v - hh * 10000 - mm * 100
    return sign * (hh + mm / 60.0 + ss / 3600.0) * 15.0


def _deg_ra_to_sigproc(deg: float) -> float:
    """RA degrees -> SIGPROC hhmmss.s."""
    hours = (deg % 360.0) / 15.0
    hh = int(hours)
    mm = int((hours - hh) * 60.0)
    ss = ((hours - hh) * 60.0 - mm) * 60.0
    if ss > 59.9999995:          # carry rounding
        ss = 0.0
        mm += 1
    if mm == 60:
        mm = 0
        hh = (hh + 1) % 24
    return hh * 10000 + mm * 100 + ss


def _coord_tag(src_raj: float, src_dej: float) -> str:
    """"hhmm[+-]ddmm" filename tag (GBT350_drift_prep.py:92-98)."""
    ra = abs(src_raj)
    ra_tag = "%02d%02d" % (int(ra // 10000), int((ra % 10000) // 100))
    de = abs(src_dej)
    sign = "-" if src_dej < 0 else "+"
    de_tag = "%s%02d%02d" % (sign, int(de // 10000),
                             int((de % 10000) // 100))
    return ra_tag + de_tag


@dataclass
class DriftPointing:
    num: int
    start_sample: int
    nsamp: int
    src_raj: float       # SIGPROC hhmmss.s at the pointing midpoint
    src_dej: float
    tstart: float        # MJD of first sample
    path: str = ""


def plan_pointings(total_samples: int, tsamp: float, tstart: float,
                   src_raj: float, src_dej: float,
                   orig_N: int = ORIG_N,
                   overlap_factor: float = OVERLAP_FACTOR,
                   ) -> List[DriftPointing]:
    """Pointing layout for a drift scan: starts step by
    ``orig_N * overlap_factor``; NMAX = total/overlap_samples - 1
    (GBT350_drift_prep.py:44-46).  Short scans yield one pointing."""
    overlap_samples = max(1, int(orig_N * overlap_factor))
    n = max(1, total_samples // overlap_samples - 1)
    out = []
    for num in range(n):
        start = num * overlap_samples
        nsamp = min(orig_N, total_samples - start)
        if nsamp <= 0:
            break
        t_mid_s = (start + 0.5 * nsamp) * tsamp
        ra_deg = (_sigproc_to_deg_ra(src_raj)
                  + 360.0 * t_mid_s / SIDEREAL_DAY_S)
        out.append(DriftPointing(
            num=num, start_sample=start, nsamp=nsamp,
            src_raj=_deg_ra_to_sigproc(ra_deg), src_dej=src_dej,
            tstart=tstart + start * tsamp / 86400.0))
    return out


def split_drift_scan(rawfiles: Sequence[str], outdir: str = ".",
                     orig_N: int = ORIG_N,
                     overlap_factor: float = OVERLAP_FACTOR,
                     pointing: Optional[int] = None,
                     prefix: str = "drift",
                     max_block: int = 1 << 22) -> List[str]:
    """Split a raw drift scan into per-pointing SIGPROC files.

    Returns the written paths, sorted by pointing number.  With
    ``pointing`` set only that one pointing is cut (the reference
    scripts' per-NUM mode for cluster fan-out,
    GBT350_drift_prep.py:44-50).  Existing outputs are kept (the
    artifact-per-stage checkpoint contract).
    """
    os.makedirs(outdir, exist_ok=True)
    fb = open_raw(list(rawfiles))
    try:
        hdr = fb.header
        total = int(fb.nspectra)
        plan = plan_pointings(
            total, hdr.tsamp, hdr.tstart, hdr.src_raj, hdr.src_dej,
            orig_N=orig_N, overlap_factor=overlap_factor)
        todo = [p for p in plan
                if pointing is None or p.num == pointing]
        if pointing is not None and not todo:
            raise ValueError(
                "pointing %d > NMAX (%d)" % (pointing, len(plan) - 1))
        written = []
        for p in todo:
            tag = _coord_tag(p.src_raj, p.src_dej)
            name = "%s_%d_%s_p%04d.fil" % (prefix, int(p.tstart),
                                           tag, p.num)
            path = os.path.join(outdir, name)
            p.path = path
            written.append(path)
            if os.path.exists(path):
                # reuse only when the existing cut matches THIS plan's
                # geometry (a rerun with different orig_N/overlap
                # collides on the name but must not keep stale cuts)
                try:
                    with FilterbankFile(path) as old:
                        # same sample count AND same start time: a
                        # rerun with a different overlap_factor keeps
                        # nsamp but shifts start_sample — names can
                        # still collide at tag resolution.  Band
                        # geometry and sample format must also match:
                        # a rerun against a different input file (or
                        # requantization) keeps nsamp/tstart but must
                        # not keep the stale cut (ADVICE r4).
                        oh = old.header
                        reuse = (int(old.nspectra) == p.nsamp
                                 and abs(oh.tstart - p.tstart)
                                 < 0.5 * hdr.tsamp / 86400.0
                                 and oh.nchans == hdr.nchans
                                 and oh.nbits == (
                                     8 if getattr(hdr, "nbits", 8)
                                     not in (8, 16, 32) else hdr.nbits)
                                 and abs(oh.fch1 - hdr.fch1) < 1e-9
                                 and abs(oh.foff - hdr.foff) < 1e-12
                                 and abs(oh.tsamp - hdr.tsamp) < 1e-12)
                except Exception:
                    reuse = False     # unreadable: rewrite it
                if reuse:
                    continue
                # no unlink: atomic_open overwrites atomically, so a
                # crash mid-rewrite leaves the old artifact
            out_hdr = FilterbankHeader(
                source_name="%s_%s" % (prefix, tag),
                machine_id=getattr(hdr, "machine_id", 10),
                telescope_id=getattr(hdr, "telescope_id", 0),
                fch1=hdr.fch1, foff=hdr.foff, nchans=hdr.nchans,
                nbits=8 if getattr(hdr, "nbits", 8) not in (8, 16, 32)
                else hdr.nbits,
                tstart=p.tstart, tsamp=hdr.tsamp,
                src_raj=p.src_raj, src_dej=p.src_dej)
            with atomic_open(path, "wb") as f:
                write_filterbank_header(out_hdr, f)
                # stream in bounded blocks: a full pointing at GBT350
                # scale is ~3.4 GB of float work otherwise
                for s0 in range(p.start_sample,
                                p.start_sample + p.nsamp, max_block):
                    cnt = min(max_block,
                              p.start_sample + p.nsamp - s0)
                    block = fb.read_spectra(s0, cnt)
                    if out_hdr.foff < 0:
                        block = block[:, ::-1]
                    if out_hdr.nbits == 32:
                        # 32-bit SIGPROC is float32: write samples
                        # verbatim (rounding/clipping would zero every
                        # negative sample of bandpass-subtracted data)
                        arr = block
                    else:
                        arr = np.clip(np.rint(block), 0,
                                      (1 << out_hdr.nbits) - 1)
                    f.write(pack_bits(
                        np.ascontiguousarray(arr).ravel(),
                        out_hdr.nbits).tobytes())
        return written
    finally:
        fb.close()
