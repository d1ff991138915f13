"""Single-pulse plots: search summary + .spd candidate diagnostics.

plot_singlepulse mirrors the classic single_pulse_search.py summary
page (bin/single_pulse_search.py plotting section): S/N histogram,
S/N vs DM, and the events scatter (time vs DM, point size ~ S/N).
plot_spd mirrors plot_spd.py: raw + dedispersed waterfalls, the
dedispersed time series, and the DM-vs-time context panel.

Host copy of ``presto_tpu/plotting/spplot.py`` for the PyTorch port,
which imports nothing from the JAX package; drawing needs matplotlib
(``plotting.pyplot``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from presto_tpu_torch.singlepulse.spd import SpdData


def plot_singlepulse(cands: Sequence, outfile: str,
                     title: str = "") -> str:
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("the single-pulse summary plot")

    dms = np.array([c.dm for c in cands])
    sig = np.array([c.sigma for c in cands])
    times = np.array([c.time for c in cands])

    fig, axes = plt.subplots(1, 3, figsize=(12, 4),
                             gridspec_kw={"width_ratios": [1, 1, 2]})
    ax = axes[0]
    if sig.size:
        ax.hist(sig, bins=max(10, int(np.sqrt(sig.size))),
                histtype="step", color="k", log=True)
    ax.set_xlabel("Signal-to-Noise")
    ax.set_ylabel("Number of pulses")

    ax = axes[1]
    ax.plot(dms, sig, "k.", ms=2)
    ax.set_xlabel("DM (pc cm$^{-3}$)")
    ax.set_ylabel("Signal-to-Noise")

    ax = axes[2]
    if sig.size:
        ax.scatter(times, dms, s=np.clip((sig - 4.0), 0.5, None) ** 2,
                   facecolors="none", edgecolors="k", lw=0.5)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("DM (pc cm$^{-3}$)")

    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(outfile, dpi=100)
    plt.close(fig)
    return outfile


def plot_spd(spd: SpdData, outfile: str,
             title: Optional[str] = None) -> str:
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("the .spd plot")

    fig = plt.figure(figsize=(11, 7))
    gs = fig.add_gridspec(2, 3, hspace=0.4, wspace=0.35)

    nsamp = spd.wf_dedisp.shape[1]
    t0, t1 = spd.start_time, spd.start_time + nsamp * spd.dt
    flo, fhi = spd.freqs.min(), spd.freqs.max()

    ax = fig.add_subplot(gs[0, 0])
    ax.imshow(spd.wf_raw, aspect="auto", origin="lower",
              cmap="viridis",
              extent=[t0, t0 + spd.wf_raw.shape[1] * spd.dt, flo, fhi])
    ax.set_title("Raw (DM=0)")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Freq (MHz)")

    ax = fig.add_subplot(gs[0, 1])
    ax.imshow(spd.wf_dedisp, aspect="auto", origin="lower",
              cmap="viridis", extent=[t0, t1, flo, fhi])
    ax.set_title("Dedispersed (DM=%.2f)" % spd.dm)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Freq (MHz)")

    ax = fig.add_subplot(gs[0, 2])
    tt = t0 + np.arange(len(spd.series)) * spd.dt
    ax.plot(tt, spd.series, "k-", lw=0.8)
    ax.axvline(spd.time, color="r", ls=":", lw=1)
    ax.set_title("Dedispersed series")
    ax.set_xlabel("Time (s)")

    ax = fig.add_subplot(gs[1, :])
    if spd.context_dm.size:
        s = np.clip((spd.context_sigma - 4.0), 0.5, None) ** 2
        ax.scatter(spd.context_time, spd.context_dm, s=s,
                   facecolors="none", edgecolors="k", lw=0.5)
    ax.axvline(spd.time, color="r", ls=":", lw=1)
    ax.axhline(spd.dm, color="r", ls=":", lw=1)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("DM (pc cm$^{-3}$)")
    ax.set_title("Context events")

    fig.suptitle(title or
                 "%s  DM=%.2f  sigma=%.1f  t=%.4fs"
                 % (spd.source or "cand", spd.dm, spd.sigma, spd.time))
    fig.savefig(outfile, dpi=100)
    plt.close(fig)
    return outfile
