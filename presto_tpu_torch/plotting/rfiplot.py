"""rfifind mask summary plot — full panel parity with the reference's
src/rfifind_plot.c:1-1078.

Layout (one composite page, like the reference's):
  * three stat groups — Max Power, Data Sigma (std), Data Mean — each
    with the (channel x time) image clipped at its rejection bounds,
    a per-CHANNEL median curve above (global median solid, rejection
    threshold dotted, in red), a per-INTERVAL median curve to the
    right (same threshold lines), and a frequency (MHz) axis mirrored
    on top;
  * the mask image with the RECOMMENDED-ZAP overlays (whole zapped
    channels in blue, whole zapped intervals in green);
  * per-channel and per-interval zap-fraction curves with the
    chan/int trigger fractions drawn;
  * the observation info block (file, telescope, pointing, epoch,
    sampling, geometry, sigmas, masked fraction) —
    rfifind_plot.c:744-821's text page.

Thresholds are recomputed from the stats + the mask's recorded
sigmas the way the analysis computed them (rfifind.c:150-170):
  pow_reject = power_for_sigma(freqsigma, 1, ptsperint/2)
  avg/std_reject = timesigma * robust-sigma of the distribution.

Host copy of ``presto_tpu/plotting/rfiplot.py`` for the PyTorch port,
which imports nothing from the JAX package: the statistics come to it as
NumPy arrays (search/rfifind.RfifindResult), and drawing needs
matplotlib (``plotting.pyplot``).
"""

from __future__ import annotations

import numpy as np


def _robust_std(x):
    med = np.median(x)
    mad = 1.4826 * np.median(np.abs(x - med))
    return float(mad) or float(np.std(x)) or 1.0


def _stat_group(fig, gs_slot, img, med, reject_lo, reject_hi,
                reject_line, title, times, freqs, cmap="viridis"):
    """One reference stat block: image + channel/interval median
    marginals with threshold lines (rfifind_plot.c:381-742)."""
    from matplotlib.gridspec import GridSpecFromSubplotSpec
    nint, nchan = img.shape
    chan_med = np.median(img, axis=0)
    int_med = np.median(img, axis=1)
    g = GridSpecFromSubplotSpec(2, 2, gs_slot,
                                width_ratios=[3.2, 1],
                                height_ratios=[1, 3.2],
                                hspace=0.06, wspace=0.06)
    ax_im = fig.add_subplot(g[1, 0])
    ax_ch = fig.add_subplot(g[0, 0], sharex=ax_im)
    ax_in = fig.add_subplot(g[1, 1], sharey=ax_im)

    T = times[-1] + times[0] if len(times) else float(nint)
    ax_im.imshow(np.clip(img, reject_lo, reject_hi), aspect="auto",
                 origin="lower", cmap=cmap,
                 extent=[0, nchan, 0, T], interpolation="nearest")
    ax_im.set_xlabel("Channel", fontsize=8)
    ax_im.set_ylabel("Time (s)", fontsize=8)
    ax_im.tick_params(labelsize=7)

    lo = min(reject_lo, float(np.min(chan_med)),
             float(np.min(int_med)))
    hi = reject_hi * 1.05
    ax_ch.plot(np.arange(nchan) + 0.5, chan_med, "k-", lw=0.8)
    ax_ch.axhline(med, color="r", lw=0.8)
    ax_ch.axhline(reject_line, color="r", lw=0.8, ls=":")
    ax_ch.set_title(title, fontsize=10)
    ax_ch.tick_params(labelbottom=False, labelsize=6)
    ax_ch.set_ylim(lo, hi)
    fspan = (freqs[-1] - freqs[0]) or 1.0
    axf = ax_ch.secondary_xaxis(
        "top", functions=(
            lambda c: freqs[0] + c * fspan / nchan,
            lambda f: (f - freqs[0]) * nchan / fspan))
    axf.set_xlabel("Frequency (MHz)", fontsize=7)
    axf.tick_params(labelsize=6)

    ax_in.plot(int_med, times, "k-", lw=0.8)
    ax_in.axvline(med, color="r", lw=0.8)
    ax_in.axvline(reject_line, color="r", lw=0.8, ls=":")
    ax_in.tick_params(labelleft=False, labelsize=6)
    ax_in.set_xlim(lo, hi)


def plot_rfifind(result, outfile: str) -> str:
    """result: search.rfifind.RfifindResult (datapow/dataavg/datastd
    [nint, nchan] + mask + bytemask; optional .info dict with
    filenm/telescope/ra/dec for the info block)."""
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("the rfifind mask plot")
    from matplotlib.gridspec import GridSpec
    from presto_tpu_torch.ops.stats import power_for_sigma

    avg = np.asarray(result.dataavg, float)
    std = np.asarray(result.datastd, float)
    pow_ = np.asarray(result.datapow, float)
    nint, nchan = avg.shape
    m = result.mask
    times = (np.arange(nint) + 0.5) * m.dtint
    freqs = m.lofreq + np.arange(nchan + 1) * m.dfreq

    # rejection bounds, as the analysis computed them (rfifind.c)
    pow_reject = float(power_for_sigma(m.freqsigma, 1,
                                       max(m.ptsperint // 2, 1)))
    avg_med, avg_rej = float(np.median(avg)), \
        m.timesigma * _robust_std(avg)
    std_med, std_rej = float(np.median(std)), \
        m.timesigma * _robust_std(std)
    pow_med = float(np.median(pow_))

    if getattr(result, "bytemask", None) is not None:
        zap = np.asarray(result.bytemask) != 0
    else:
        zap = np.zeros((nint, nchan), bool)
        for i, chans in enumerate(m.chans_per_int[:nint]):
            zap[i, np.asarray(chans, int)] = True
        zap[:, np.asarray(m.zap_chans, int)] = True
        zap[np.asarray(m.zap_ints, int), :] = True

    fig = plt.figure(figsize=(15, 10))
    gs = GridSpec(2, 3, figure=fig, hspace=0.32, wspace=0.28,
                  height_ratios=[1.4, 1])

    _stat_group(fig, gs[0, 0], pow_, pow_med, 0.0, 1.5 * pow_reject,
                pow_reject, "Max Power", times, freqs, cmap="inferno")
    _stat_group(fig, gs[0, 1], std, std_med,
                max(std_med - 1.5 * std_rej, 0.0),
                std_med + 1.5 * std_rej, std_med + std_rej,
                "Data Sigma", times, freqs)
    _stat_group(fig, gs[0, 2], avg, avg_med,
                max(avg_med - 1.5 * avg_rej, 0.0),
                avg_med + 1.5 * avg_rej, avg_med + avg_rej,
                "Data Mean", times, freqs)

    # ---- mask + recommended-zap overlays ----------------------------
    ax = fig.add_subplot(gs[1, 0])
    Ttot = times[-1] + times[0] if len(times) else float(nint)
    ax.imshow(zap, aspect="auto", origin="lower", cmap="Reds",
              extent=[0, nchan, 0, Ttot], vmin=0, vmax=1,
              interpolation="nearest")
    for c in np.asarray(m.zap_chans, int):
        ax.axvline(c + 0.5, color="b", lw=0.6, alpha=0.6)
    for i in np.asarray(m.zap_ints, int):
        ax.axhline(times[min(int(i), nint - 1)], color="g", lw=0.6,
                   alpha=0.6)
    ax.set_xlabel("Channel")
    ax.set_ylabel("Time (s)")
    ax.set_title("Mask: %.2f%% zapped; recommended: %d chans (blue), "
                 "%d ints (green)"
                 % (100 * zap.mean(), len(m.zap_chans),
                    len(m.zap_ints)), fontsize=9)

    # ---- zap fraction curves with trigger lines ---------------------
    ax = fig.add_subplot(gs[1, 1])
    info = getattr(result, "info", None) or {}
    chanfrac = float(info.get("chanfrac", 0.7))
    intfrac = float(info.get("intfrac", 0.3))
    ax.plot(np.arange(nchan) + 0.5, zap.mean(axis=0), "k-", lw=0.9,
            drawstyle="steps-mid", label="per channel")
    ax.axhline(chanfrac, color="k", ls=":", lw=0.8)
    ax.set_xlabel("Channel")
    ax.set_ylabel("Zapped fraction (black: per chan)")
    ax.set_ylim(-0.02, 1.05)
    axb = ax.twiny()
    axb.plot(times, zap.mean(axis=1), "b-", lw=0.8, alpha=0.7)
    axb.axhline(intfrac, color="b", ls=":", lw=0.8)
    axb.set_xlabel("Time (s)  (blue: per interval)", fontsize=8,
                   color="b")
    axb.tick_params(labelsize=7, colors="b")

    # ---- observation info block ------------------------------------
    ax = fig.add_subplot(gs[1, 2])
    ax.axis("off")
    rows = [
        ("Data file", info.get("filenm", "-")),
        ("Telescope", info.get("telescope", "-")),
        ("RA (J2000)", info.get("ra", "-")),
        ("DEC (J2000)", info.get("dec", "-")),
        ("Epoch (MJD)", "%.12g" % m.mjd),
        ("T sample (s)", "%.6g" % (m.dtint / max(m.ptsperint, 1))),
        ("T total (s)", "%.6g" % (m.dtint * nint)),
        ("Chans x Ints", "%d x %d" % (nchan, nint)),
        ("Pts per interval", "%d" % m.ptsperint),
        ("Freqs (MHz)", "%.3f - %.3f" % (freqs[0], freqs[-1])),
        ("Freq sigma / pow cut", "%.1f / %.2f"
         % (m.freqsigma, pow_reject)),
        ("Time sigma", "%.1f" % m.timesigma),
        ("Cells masked", "%.2f %%" % (100 * zap.mean())),
        ("Zap chans / ints", "%d / %d"
         % (len(m.zap_chans), len(m.zap_ints))),
    ]
    y = 0.98
    for k, v in rows:
        ax.text(0.0, y, k + ":", fontsize=9, va="top",
                family="monospace")
        ax.text(0.52, y, str(v), fontsize=9, va="top",
                family="monospace")
        y -= 0.072
    fig.suptitle("rfifind mask summary", fontsize=12)
    fig.savefig(outfile, dpi=100)
    plt.close(fig)
    return outfile
