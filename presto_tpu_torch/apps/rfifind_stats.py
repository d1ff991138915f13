"""rfifind_stats: bandpass + channel weights from rfifind products.

Twin of bin/rfifind_stats.py (which drives the reference's
rfifind.py helper class): loads the _rfifind.{mask,stats,inf} set,
writes the mean/std bandpass, derives recommended channel zaps from
the per-channel statistics, and writes a .weights file (chan weight
per line, weight 0 = zap — the input weights_to_ignorechan consumes).

Zap criteria (the reference's set_zap_chans defaults): band edges,
channels whose median power exceeds `power`, and channels whose
mean/std across unmasked intervals deviates by more than
asigma/ssigma robust sigmas from the channel-median trend.

Host copy of ``presto_tpu/apps/rfifind_stats.py`` for the PyTorch port,
which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from presto_tpu_torch.io.maskfile import read_mask, read_statsfile


def build_parser():
    p = argparse.ArgumentParser(
        prog="rfifind_stats",
        description="bandpass/weights from _rfifind.stats+mask")
    p.add_argument("-power", type=float, default=200.0,
                   help="zap channels with median power above this")
    p.add_argument("-edges", type=float, default=0.01,
                   help="fraction of band edges to zap (each side)")
    p.add_argument("-asigma", type=float, default=2.0,
                   help="channel-avg deviation threshold (sigmas)")
    p.add_argument("-ssigma", type=float, default=2.0,
                   help="channel-std deviation threshold (sigmas)")
    p.add_argument("-invertband", action="store_true",
                   help="write weights in descending-frequency order")
    p.add_argument("maskbase",
                   help="basename or any _rfifind.* product path")
    return p


def _robust_sigmas(x):
    med = np.median(x)
    mad = np.median(np.abs(x - med)) * 1.4826 or 1.0
    return (x - med) / mad


def channel_zaps(stats, mask, power=200.0, edges=0.01, asigma=2.0,
                 ssigma=2.0):
    nch = stats["numchan"]
    pw = np.median(stats["datapow"], axis=0)
    av = np.median(stats["dataavg"], axis=0)
    sd = np.median(stats["datastd"], axis=0)
    zap = np.zeros(nch, bool)
    ne = int(edges * nch)
    if ne:
        zap[:ne] = zap[-ne:] = True
    zap |= pw > power
    zap |= np.abs(_robust_sigmas(av)) > asigma
    zap |= np.abs(_robust_sigmas(sd)) > ssigma
    zap[np.asarray(mask.zap_chans, int)] = True
    return zap


def main(argv=None):
    args = build_parser().parse_args(argv)
    base = args.maskbase
    for suf in ("_rfifind.mask", "_rfifind.stats", "_rfifind.inf",
                ".mask", ".stats", ".inf"):
        if base.endswith(suf):
            base = base[:-len(suf)]
            break
    pre = base + "_rfifind" if os.path.exists(
        base + "_rfifind.stats") else base
    stats = read_statsfile(pre + ".stats")
    mask = read_mask(pre + ".mask")
    nch = stats["numchan"]

    bp_mean = stats["dataavg"].mean(axis=0)
    bp_std = stats["datastd"].mean(axis=0)
    with open(base + ".bandpass", "w") as f:
        f.write("# Chan       Mean       StDev\n")
        for i in range(nch):
            f.write("%6d  %9.3f  %9.3f\n"
                    % (i, bp_mean[i], bp_std[i]))

    zap = channel_zaps(stats, mask, args.power, args.edges,
                       args.asigma, args.ssigma)
    order = range(nch - 1, -1, -1) if args.invertband else range(nch)
    with open(base + ".weights", "w") as f:
        f.write("# Chan  Weight\n")
        for j, i in enumerate(order):
            f.write("%6d  %d\n" % (j, 0 if zap[i] else 1))
    print("rfifind_stats: %d/%d channels zapped -> %s.weights, "
          "bandpass -> %s.bandpass"
          % (int(zap.sum()), nch, base, base))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
