"""Candidate cutout waterfalls (bin/waterfaller.py analog).

Host copy of ``presto_tpu/singlepulse/waterfaller.py`` for the PyTorch
port.

Extracts a [nsub, nsamp] dynamic-spectrum cutout around a single-pulse
candidate from a filterbank/PSRFITS reader, with optional subbanding,
time downsampling, and dedispersion at the candidate DM — the array
behind the reference's waterfall plots (plotting lives in
the JAX package's plotting/spplot.py, not in the port).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from presto_tpu_torch.ops.dedispersion import (dedisp_delays,
                                               delays_to_bins)


@dataclass
class Waterfall:
    data: np.ndarray        # [nsub, nsamp] float32 (freq ascending)
    start_time: float       # seconds from obs start
    dt: float
    freqs: np.ndarray       # [nsub] center MHz, ascending
    dm: float


def waterfall(reader, start_sec: float, duration_sec: float,
              dm: float = 0.0, nsub: int = 0, downsamp: int = 1
              ) -> Waterfall:
    """Cut a waterfall out of `reader` (FilterbankFile/PsrfitsFile:
    needs .header-like metadata via hdr fields and read_spectra).

    Dedispersion shifts each channel EARLIER by its DM delay relative
    to the highest frequency, so a dispersed pulse lines up vertically;
    the read is extended by the full dispersion sweep so the cutout
    stays filled.
    """
    hdr = reader.header
    dt = hdr.tsamp
    nchan = hdr.nchans
    lof = hdr.lofreq             # center of lowest channel, MHz
    cw = abs(hdr.foff)
    delays = dedisp_delays(nchan, dm, lof, cw)
    delays = delays - delays.min()          # highest freq: zero delay
    dbins = np.asarray(delays_to_bins(delays, dt))
    sweep = int(dbins.max())

    start = max(int(start_sec / dt), 0)
    nsamp = int(np.ceil(duration_sec / dt))
    block = np.asarray(reader.read_spectra(start, nsamp + sweep)).T
    # block: [nchan, nsamp+sweep], ascending frequency; low channels
    # have the LARGEST delays
    out = np.empty((nchan, nsamp), np.float32)
    for c in range(nchan):
        out[c] = block[c, dbins[c]:dbins[c] + nsamp]

    if nsub and nsub < nchan:
        chans_per = nchan // nsub
        out = out[:nsub * chans_per].reshape(nsub, chans_per,
                                             nsamp).mean(axis=1)
        freqs = (lof + (np.arange(nsub) + 0.5) * chans_per * cw
                 - 0.5 * cw)
    else:
        freqs = lof + np.arange(nchan) * cw
    if downsamp > 1:
        keep = (out.shape[1] // downsamp) * downsamp
        out = out[:, :keep].reshape(out.shape[0], -1,
                                    downsamp).mean(axis=2)
        dt = dt * downsamp
    return Waterfall(data=out.astype(np.float32),
                     start_time=start * hdr.tsamp, dt=dt,
                     freqs=np.asarray(freqs, np.float64), dm=dm)
