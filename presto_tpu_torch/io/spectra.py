"""2-D dynamic-spectra container (lib/python/spectra.py analog).

Holds [nchan, nspec] data + (freqs, dt, starttime) and offers the same
operations the reference class does: dedisperse (sample-shift, in
place), subband, downsample, trim, per-channel scaling, and masking —
NumPy/JAX-backed instead of loops.

Host copy of ``presto_tpu/io/spectra.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from presto_tpu_torch.ops.dedispersion import delay_from_dm


class Spectra:
    """data: [nchan, nspec] float32; freqs ascending or descending MHz
    (kept as given, like the reference)."""

    def __init__(self, freqs, dt: float, data, starttime: float = 0.0,
                 dm: float = 0.0):
        self.freqs = np.asarray(freqs, np.float64)
        self.dt = float(dt)
        self.data = np.asarray(data, np.float32)
        if self.data.shape[0] != self.freqs.size:
            raise ValueError("data rows != len(freqs)")
        self.starttime = float(starttime)
        self.dm = float(dm)

    @property
    def numchans(self) -> int:
        return self.data.shape[0]

    @property
    def numspectra(self) -> int:
        return self.data.shape[1]

    def get_chan(self, channum: int) -> np.ndarray:
        return self.data[channum]

    def shift_channels(self, bins, padval: float = 0.0) -> None:
        """Shift each channel left by bins[i] samples, pad the tail
        (spectra.py shift_channels semantics)."""
        bins = np.asarray(bins)
        n = self.numspectra
        for i in range(self.numchans):
            b = int(np.clip(bins[i], -n, n))   # |shift| >= n: all pad
            if b == 0:
                continue
            if b > 0:
                self.data[i, :n - b] = self.data[i, b:]
                self.data[i, n - b:] = padval
            else:
                self.data[i, -b:] = self.data[i, :n + b]
                self.data[i, :-b] = padval

    def dedisperse(self, dm: float, padval: float = 0.0,
                   ref_freq: Optional[float] = None) -> "Spectra":
        """In-place incoherent dedispersion to `dm` (relative to the
        current self.dm), referenced to ref_freq (default: highest)."""
        if ref_freq is None:
            ref_freq = self.freqs.max()
        ddm = dm - self.dm
        delays = (delay_from_dm(ddm, self.freqs)
                  - delay_from_dm(ddm, ref_freq))
        bins = np.round(np.asarray(delays) / self.dt).astype(int)
        self.shift_channels(bins, padval)
        self.dm = dm
        return self

    def subband(self, nsub: int, subdm: Optional[float] = None,
                padval: float = 0.0) -> "Spectra":
        """Average groups of channels into nsub subbands, optionally
        first aligning channels WITHIN each subband at subdm."""
        if self.numchans % nsub:
            raise ValueError("numchans must be divisible by nsub")
        if subdm is not None and subdm != self.dm:
            # align within subbands only: relative delay to each
            # subband's center frequency
            cps = self.numchans // nsub
            ddm = subdm - self.dm
            sub_ctr = self.freqs.reshape(nsub, cps).mean(axis=1)
            delays = delay_from_dm(ddm, self.freqs) \
                - np.repeat(np.asarray(delay_from_dm(ddm, sub_ctr)), cps)
            bins = np.round(np.asarray(delays) / self.dt).astype(int)
            self.shift_channels(bins, padval)
        cps = self.numchans // nsub
        newdata = self.data.reshape(nsub, cps, -1).mean(axis=1)
        newfreqs = self.freqs.reshape(nsub, cps).mean(axis=1)
        return Spectra(newfreqs, self.dt, newdata, self.starttime,
                       self.dm)

    def downsample(self, factor: int) -> "Spectra":
        keep = (self.numspectra // factor) * factor
        nd = self.data[:, :keep].reshape(
            self.numchans, -1, factor).mean(axis=2)
        return Spectra(self.freqs, self.dt * factor, nd,
                       self.starttime, self.dm)

    def trim(self, start: int, stop: int) -> "Spectra":
        return Spectra(self.freqs, self.dt, self.data[:, start:stop],
                       self.starttime + start * self.dt, self.dm)

    def scaled(self, indep: bool = False) -> "Spectra":
        """Mean-0 channels; indep=True also scales each channel to
        unit std (spectra.py scaled/scaled2)."""
        d = self.data - self.data.mean(axis=1, keepdims=True)
        if indep:
            std = d.std(axis=1, keepdims=True)
            d = d / np.where(std == 0, 1.0, std)
        return Spectra(self.freqs, self.dt, d, self.starttime, self.dm)

    def mask_channels(self, channums: Sequence[int],
                      maskval: float = 0.0) -> None:
        self.data[list(channums), :] = maskval

    def scrub(self, padval: float = 0.0) -> int:
        """Ingest quarantine for in-memory spectra: replace NaN/Inf
        samples (corrupt blocks that slipped past the readers, or
        downstream math on masked data) with `padval` in place.
        Returns the number of samples scrubbed so callers can log or
        add the count to a DataQualityReport."""
        bad = ~np.isfinite(self.data)
        nbad = int(bad.sum())
        if nbad:
            self.data[bad] = padval
        return nbad

    def mean_spectrum(self) -> np.ndarray:
        return self.data.mean(axis=1)

    def timeseries(self) -> np.ndarray:
        """Band-summed series at the current DM."""
        return self.data.sum(axis=0)
