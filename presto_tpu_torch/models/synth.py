"""Synthetic pulsar data generation — the makedata/injectpsr analog.

Host copy of ``presto_tpu/models/synth.py`` for the PyTorch port, which imports
nothing from the JAX package.

The reference's makedata (src/makedata.c + src/com.c) generates .dat
time series from closed-form signal parameters (pulse shape, f/fdot/
fdotdot, amplitude, phase, binary orbit, noise) described by .mak files;
its test suite builds on exact knowledge of the injected signal
(SURVEY.md §4.2).  This module provides the same ground-truth role:
every search stage is validated against data whose answer is known in
closed form.

All generation is float64 numpy on the host (it is setup/test code, not
a hot path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from presto_tpu_torch.io.infodata import InfoData, ARTIFICIAL_TELESCOPE
from presto_tpu_torch.io.sigproc import FilterbankHeader, write_filterbank
from presto_tpu_torch.ops.dedispersion import delay_from_dm


def pulse_shape(phases: np.ndarray, shape: str = "sine",
                width: float = 0.1) -> np.ndarray:
    """Pulse amplitude at fractional phases in [0,1).

    Shapes follow makedata's menu (src/com.c): 'sine', 'gauss' (fwhm =
    `width` in phase units), 'crab' (fast-rise exponential-decay-ish).
    All normalized to peak 1.
    """
    ph = np.mod(phases, 1.0)
    if shape == "sine":
        return 0.5 * (1.0 + np.sin(2 * np.pi * ph))
    if shape == "gauss":
        sigma = width / 2.35482
        return np.exp(-0.5 * ((ph - 0.5) / sigma) ** 2)
    if shape == "crab":
        return np.exp(-np.minimum(ph, 1 - ph) / width)
    raise ValueError("unknown pulse shape %r" % shape)


@dataclass
class FakeSignal:
    """Closed-form signal description (the .mak analog)."""
    f: float = 1.0               # Hz at t=0
    fdot: float = 0.0            # Hz/s
    fdotdot: float = 0.0         # Hz/s^2
    amp: float = 1.0
    phase0: float = 0.0          # turns
    shape: str = "gauss"
    width: float = 0.1           # fractional pulse width (gauss fwhm)
    dm: float = 0.0

    def phase(self, t: np.ndarray) -> np.ndarray:
        """Integrated phase in turns at times t (s): f t + fd t²/2 + fdd t³/6."""
        return (self.phase0 + self.f * t + 0.5 * self.fdot * t * t
                + self.fdotdot * t ** 3 / 6.0)


def fake_timeseries(N: int, dt: float, signal: FakeSignal,
                    noise_sigma: float = 0.0,
                    seed: Optional[int] = 42) -> np.ndarray:
    """Noise + pulsed signal sampled at bin centers."""
    t = (np.arange(N) + 0.5) * dt
    data = signal.amp * pulse_shape(signal.phase(t), signal.shape,
                                    signal.width)
    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        data = data + rng.normal(0.0, noise_sigma, N)
    return data.astype(np.float32)


def fake_filterbank_data(N: int, dt: float, nchan: int, lofreq: float,
                         chanwidth: float, signal: FakeSignal,
                         noise_sigma: float = 0.0,
                         baseline: float = 10.0,
                         seed: Optional[int] = 42) -> np.ndarray:
    """[N, nchan] float32, ascending frequency, with the pulsar's pulses
    arriving later in lower-frequency channels per the cold-plasma delay
    (delay_from_dm).  The highest channel has zero extra delay offset —
    matching how dedispersion references delays to the band."""
    freqs = lofreq + np.arange(nchan) * chanwidth
    delays = delay_from_dm(signal.dm, freqs)
    delays = delays - delays.min()       # highest channel ~ zero delay
    t = (np.arange(N) + 0.5) * dt
    out = np.empty((N, nchan), dtype=np.float32)
    for c in range(nchan):
        ph = signal.phase(t - delays[c])
        out[:, c] = signal.amp * pulse_shape(ph, signal.shape, signal.width)
    out += baseline
    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        out += rng.normal(0.0, noise_sigma, out.shape).astype(np.float32)
    return out


def fake_filterbank_file(path: str, N: int, dt: float, nchan: int,
                         lofreq: float, chanwidth: float,
                         signal: FakeSignal, noise_sigma: float = 0.0,
                         nbits: int = 8, tstart_mjd: float = 59000.0,
                         seed: Optional[int] = 42) -> FilterbankHeader:
    """Write a synthetic 8-bit .fil with an injected pulsar."""
    data = fake_filterbank_data(N, dt, nchan, lofreq, chanwidth, signal,
                                noise_sigma, baseline=32.0, seed=seed)
    if nbits == 8:
        q = np.clip(np.round(data * 4.0), 0, 255).astype(np.uint8)
    elif nbits == 32:
        q = data
    else:
        maxv = (1 << nbits) - 1
        q = np.clip(np.round(data * maxv / data.max()), 0, maxv).astype(
            np.uint16 if nbits == 16 else np.uint8)
    hdr = FilterbankHeader(
        # GBT + a real sky position (the Crab) so the default
        # barycentering path in the prep tools is exercised end-to-end
        source_name="FAKEPSR", machine_id=10, telescope_id=6,
        src_raj=53431.97, src_dej=220052.1,
        fch1=lofreq + (nchan - 1) * chanwidth, foff=-chanwidth,
        nchans=nchan, nbits=nbits, tstart=tstart_mjd, tsamp=dt, nifs=1,
        rawdatafile=path.split("/")[-1])
    write_filterbank(path, hdr, q)
    return hdr


def artificial_inf(name: str, N: int, dt: float, dm: float = 0.0,
                   **kw) -> InfoData:
    return InfoData(name=name, telescope=ARTIFICIAL_TELESCOPE,
                    N=float(N), dt=dt, dm=dm, **kw)
