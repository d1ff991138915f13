"""Barycentric resampling for the prep tools.

Host copy of ``presto_tpu/astro/baryshift.py`` for the PyTorch port, which
imports nothing from the JAX package.

The reference barycenters a time series by keeping topocentric samples
and occasionally adding/removing single bins wherever the accumulated
(bary - topo) drift crosses a half-bin boundary (prepdata.c:469-505,
prepsubband.c:506-539: the `diffbins` schedule).  The output is then
uniformly sampled in barycentric time to within half a bin, with the
.inf epoch set to the barycentric MJD of the first sample.

This module reproduces that schedule exactly (same TDT=20 s sampling of
the TEMPO/ephemeris curve, same rounding and linear interpolation) but
applies it as a vectorized insert/delete pass over the finished series
instead of interleaving it with the write loop.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.astro.bary import barycenter

SECPERDAY = 86400.0
TDT = 20.0  # seconds between barycentric-motion samples (prepdata.c:14)


def bary_grid(tlotoa_mjd, total_sec, ra, dec, obs="GB", ephem="DE405"):
    """Barycenter a TDT-spaced grid covering the observation.

    Mirrors prepdata.c:214 (numbarypts = T*1.1/TDT + 5.5 + 1) and
    :415 (ttoa[i] = tlotoa + TDT*i).  Returns (ttoa, btoa, voverc).
    """
    numbarypts = int(total_sec * 1.1 / TDT + 5.5) + 1
    ttoa = tlotoa_mjd + TDT * np.arange(numbarypts) / SECPERDAY
    btoa, voverc = barycenter(ttoa, ra, dec, obs, ephem)
    return ttoa, btoa, voverc


def diffbin_schedule(ttoa, btoa, dsdt):
    """Output-bin indices where one sample must be added (+) or
    removed (-) to stay aligned with barycentric time.

    Direct port of the drift-crossing scan in prepdata.c:469-505:
    express (btoa-ttoa) relative to the first point in units of the
    (downsampled) bin length, then linearly interpolate the time at
    which each successive half-integer level is crossed.
    """
    drift = ((btoa - ttoa) - (btoa[0] - ttoa[0])) * SECPERDAY / dsdt
    diffbins = []
    oldbin = 0
    for ii in range(1, len(drift)):
        currentbin = int(round(drift[ii]))
        if currentbin != oldbin:
            if currentbin > 0:
                calcpt = oldbin + 0.5
                lobin = (ii - 1) * TDT / dsdt
                hibin = ii * TDT / dsdt
            else:
                calcpt = oldbin - 0.5
                lobin = -((ii - 1) * TDT / dsdt)
                hibin = -(ii * TDT / dsdt)
            while abs(calcpt) < abs(drift[ii]):
                # linear interp of the crossing time between samples
                frac = (calcpt - drift[ii - 1]) / (drift[ii] - drift[ii - 1])
                diffbins.append(int(round(lobin + frac * (hibin - lobin))))
                calcpt += 1.0 if currentbin > 0 else -1.0
            oldbin = currentbin
    return np.asarray(diffbins, dtype=np.int64)


def apply_diffbins(series, diffbins, fill_mode="local_avg"):
    """Insert/remove single bins at the scheduled output positions.

    Positive entry b: insert one bin *at* output index |b| (the
    reference writes an extra padding bin there, value = local block
    average, prepdata.c:556-575).  Negative: drop the bin at |b|.
    Returns a new 1-D float32 array.
    """
    if diffbins.size == 0:
        return series
    # Single pass building output pieces: positions are output-bin
    # counters exactly as in the reference write loop (it compares
    # totwrote against *diffbinptr, prepdata.c:556-575), so walk them
    # in increasing |position| while advancing an input cursor.
    entries = sorted((int(b) for b in diffbins), key=abs)
    pieces = []
    in_pos = 0
    out_count = 0
    n = series.size
    for b in entries:
        target = abs(b)
        ncopy = min(target - out_count, n - in_pos)
        if ncopy > 0:
            pieces.append(series[in_pos:in_pos + ncopy])
            in_pos += ncopy
            out_count += ncopy
        if in_pos >= n:
            break
        if b >= 0:
            lo = max(in_pos - 500, 0)
            fill = (np.float32(np.mean(series[lo:in_pos + 500]))
                    if fill_mode == "local_avg" else np.float32(0))
            pieces.append(np.array([fill], dtype=np.float32))
            out_count += 1
        else:
            in_pos += 1  # drop one topocentric sample
    pieces.append(series[in_pos:])
    return np.concatenate(pieces).astype(np.float32, copy=False)


class BaryPlan:
    """Everything the prep tools need to barycenter one observation."""

    def __init__(self, tlotoa_mjd, total_sec, dsdt, ra, dec,
                 obs="GB", ephem="DE405"):
        self.ttoa, self.btoa, voverc = bary_grid(
            tlotoa_mjd, total_sec, ra, dec, obs, ephem)
        self.avgvoverc = float(np.mean(voverc))
        self.maxvoverc = float(np.max(voverc))
        self.minvoverc = float(np.min(voverc))
        self.blotoa = float(self.btoa[0])   # bary epoch of first sample
        self.diffbins = diffbin_schedule(self.ttoa, self.btoa, dsdt)

    def apply(self, series):
        return apply_diffbins(series, self.diffbins)
