""".spd single-pulse diagnostic bundles (make_spd.py / spio analog).

Host copy of ``presto_tpu/singlepulse/spd.py`` for the PyTorch port.

The reference's make_spd.py saves a npz of everything the plot_spd
diagnostic needs: the dispersed and dedispersed waterfalls around the
candidate, the dedispersed time series, DM-vs-time context events, and
candidate metadata.  Same here — the .spd file IS a npz archive.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from presto_tpu_torch.search.singlepulse import SPCandidate
from presto_tpu_torch.singlepulse.waterfaller import waterfall


@dataclass
class SpdData:
    # candidate
    dm: float = 0.0
    sigma: float = 0.0
    time: float = 0.0
    downfact: int = 1
    dt: float = 0.0
    # cutouts (freq ascending)
    wf_raw: np.ndarray = field(default_factory=lambda: np.zeros((1, 1)))
    wf_dedisp: np.ndarray = field(
        default_factory=lambda: np.zeros((1, 1)))
    freqs: np.ndarray = field(default_factory=lambda: np.zeros(1))
    start_time: float = 0.0
    # dedispersed series around the pulse
    series: np.ndarray = field(default_factory=lambda: np.zeros(1))
    # DM-vs-time context (all events near the pulse)
    context_dm: np.ndarray = field(default_factory=lambda: np.zeros(0))
    context_time: np.ndarray = field(
        default_factory=lambda: np.zeros(0))
    context_sigma: np.ndarray = field(
        default_factory=lambda: np.zeros(0))
    source: str = ""


def make_spd(path: str, cand: SPCandidate, reader,
             context: Optional[Sequence[SPCandidate]] = None,
             window_sec: float = 0.2, nsub: int = 32,
             downsamp: int = 1) -> SpdData:
    """Build and save the .spd bundle for one candidate."""
    start = max(cand.time - window_sec / 2.0, 0.0)
    raw = waterfall(reader, start, window_sec, dm=0.0, nsub=nsub,
                    downsamp=downsamp)
    ded = waterfall(reader, start, window_sec, dm=cand.dm, nsub=nsub,
                    downsamp=downsamp)
    series = ded.data.sum(axis=0)
    context = list(context or [])
    spd = SpdData(
        dm=cand.dm, sigma=cand.sigma, time=cand.time,
        downfact=cand.downfact, dt=ded.dt,
        wf_raw=raw.data, wf_dedisp=ded.data, freqs=ded.freqs,
        start_time=ded.start_time, series=series,
        context_dm=np.array([c.dm for c in context]),
        context_time=np.array([c.time for c in context]),
        context_sigma=np.array([c.sigma for c in context]),
        source=getattr(reader.header, "source_name", ""))
    # write via a handle: np.savez would append ".npz" to a ".spd" path
    with open(path, "wb") as fh:
        _savez(fh, spd)
    return spd


def _savez(fh, spd: SpdData) -> None:
    np.savez_compressed(
        fh, dm=spd.dm, sigma=spd.sigma, time=spd.time,
        downfact=spd.downfact, dt=spd.dt, wf_raw=spd.wf_raw,
        wf_dedisp=spd.wf_dedisp, freqs=spd.freqs,
        start_time=spd.start_time, series=spd.series,
        context_dm=spd.context_dm, context_time=spd.context_time,
        context_sigma=spd.context_sigma, source=spd.source)


def read_spd(path: str) -> SpdData:
    with np.load(path, allow_pickle=False) as z:
        return SpdData(
            dm=float(z["dm"]), sigma=float(z["sigma"]),
            time=float(z["time"]), downfact=int(z["downfact"]),
            dt=float(z["dt"]), wf_raw=z["wf_raw"],
            wf_dedisp=z["wf_dedisp"], freqs=z["freqs"],
            start_time=float(z["start_time"]), series=z["series"],
            context_dm=z["context_dm"], context_time=z["context_time"],
            context_sigma=z["context_sigma"], source=str(z["source"]))
