"""subband_smearing: smearing-vs-DM curves for a subbanding plan.

Twin of bin/subband_smearing.py: plots, against trial DM, the
per-channel smearing, the subband smearing (finite subband bandwidth
at its assumed DM), the sample-time floor, and the total — the
diagnostic used to choose subband counts/DM steps before a
prepsubband run (same physics as pipeline/ddplan, shown for ONE
explicit plan instead of optimized over plans).

Host copy of ``presto_tpu/apps/subband_smearing.py`` for the PyTorch
port, which imports nothing from the JAX package. The plot needs
matplotlib, which the card machine does not have: there a run raises
ImportError naming it before it computes.
"""

from __future__ import annotations

import argparse

import numpy as np

from presto_tpu_torch.pipeline.ddplan import dm_smear


def build_parser():
    p = argparse.ArgumentParser(
        prog="subband_smearing",
        description="smearing curves for one subbanding plan")
    p.add_argument("-lodm", type=float, default=0.0)
    p.add_argument("-hidm", type=float, default=500.0)
    p.add_argument("-subdm", type=float, default=None,
                   help="DM the subbands are dedispersed at "
                        "(default mid-range)")
    p.add_argument("-fctr", type=float, default=1400.0,
                   help="center frequency (MHz)")
    p.add_argument("-bw", type=float, default=300.0,
                   help="total bandwidth (MHz)")
    p.add_argument("-numchan", type=int, default=1024)
    p.add_argument("-numsub", type=int, default=32)
    p.add_argument("-dt", type=float, default=64e-6,
                   help="sample time (s)")
    p.add_argument("-downsamp", type=int, default=1)
    p.add_argument("-o", "--output", default="subband_smearing.png")
    return p


def smear_curves(dms, subdm, fctr, bw, numchan, numsub, dt,
                 downsamp=1):
    chan_bw = bw / numchan
    sub_bw = bw / numsub
    chan = 1e3 * dm_smear(dms, chan_bw, fctr)         # ms, at own DM
    sub = 1e3 * dm_smear(np.abs(dms - subdm), sub_bw, fctr)
    samp = np.full_like(dms, 1e3 * dt * downsamp)
    total = np.sqrt(chan ** 2 + sub ** 2 + samp ** 2)
    return chan, sub, samp, total


def main(argv=None):
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("subband_smearing")
    subdm = args.subdm if args.subdm is not None else \
        0.5 * (args.lodm + args.hidm)
    dms = np.linspace(args.lodm, args.hidm, 512)
    chan, sub, samp, total = smear_curves(
        dms, subdm, args.fctr, args.bw, args.numchan, args.numsub,
        args.dt, args.downsamp)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.semilogy(dms, chan, label="channel smearing")
    ax.semilogy(dms, sub, label="subband smearing (subDM=%.1f)" % subdm)
    ax.semilogy(dms, samp, label="sample time x%d" % args.downsamp)
    ax.semilogy(dms, total, "k", lw=2, label="total")
    ax.set_xlabel("trial DM (pc cm$^{-3}$)")
    ax.set_ylabel("smearing (ms)")
    ax.set_title("%d chan / %d subbands, %.0f MHz @ %.0f MHz"
                 % (args.numchan, args.numsub, args.bw, args.fctr))
    ax.legend()
    fig.savefig(args.output, dpi=100)
    plt.close(fig)
    imax = int(np.argmax(total))
    print("subband_smearing: worst total %.3f ms at DM %.1f -> %s"
          % (total[imax], dms[imax], args.output))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
