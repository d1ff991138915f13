"""DDplan: print the optimal dedispersion plan for an observation.

Parity: bin/DDplan.py CLI (-l/-d lo/hi DM, -f/-b/-n obs params,
-t dt, -s numsub, -r ok_smearing, or read them from a .fil/.inf).

Host copy of ``presto_tpu/apps/ddplan.py`` for the PyTorch port, which
imports nothing from the JAX package. The -o plot needs matplotlib,
which the card machine does not have: there a run with -o raises
ImportError naming it before it plans.
"""

from __future__ import annotations

import argparse
import sys

from presto_tpu_torch.pipeline.ddplan import (Observation, plan_dedispersion)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="DDplan", description="Dedispersion planning")
    p.add_argument("-l", "--lodm", type=float, default=0.0)
    p.add_argument("-d", "--hidm", type=float, default=1000.0)
    p.add_argument("-f", "--fctr", type=float, default=1400.0,
                   help="Center frequency (MHz)")
    p.add_argument("-b", "--bw", type=float, default=300.0,
                   help="Bandwidth (MHz)")
    p.add_argument("-n", "--numchan", type=int, default=1024)
    p.add_argument("-t", "--dt", type=float, default=64e-6,
                   help="Sample time (s)")
    p.add_argument("-c", "--cdm", type=float, default=0.0,
                   help="Coherently-removed DM")
    p.add_argument("-s", "--numsub", type=int, default=0)
    p.add_argument("-r", "--res", type=float, default=0.0,
                   help="Acceptable smearing (ms)")
    p.add_argument("-o", "--plot", type=str, default=None,
                   help="Write the smearing-vs-DM plot to this PNG")
    p.add_argument("rawfile", nargs="?", default=None,
                   help="Optional .fil to take obs params from")
    return p


def run(args):
    plt = None
    if args.plot:
        from presto_tpu_torch.plotting import pyplot
        plt = pyplot("DDplan -o")
    if args.rawfile:
        from presto_tpu_torch.io.sigproc import FilterbankFile
        with FilterbankFile(args.rawfile) as fb:
            h = fb.header
            args.dt = h.tsamp
            args.numchan = h.nchans
            bw = abs(h.foff) * h.nchans
            args.bw = bw
            args.fctr = h.fch1 + (h.foff * (h.nchans - 1)) / 2.0
    obs = Observation(dt=args.dt, f_ctr=args.fctr, bw=args.bw,
                      numchan=args.numchan, cdm=args.cdm)
    plan = plan_dedispersion(obs, args.lodm, args.hidm,
                             numsub=args.numsub, ok_smearing=args.res)
    print(plan)
    print("Total number of DM trials: %d" % plan.total_numdms)
    if args.plot:
        _plot_plan(plt, plan, obs, args.plot)
        print("DDplan: smearing plot -> %s" % args.plot)
    return plan


def _plot_plan(plt, plan, obs, outfile):
    """Smearing-vs-DM curves per method (the DDplan.py plot panel)."""
    import numpy as np
    fig, ax = plt.subplots(figsize=(8, 5))
    for m in plan.methods:
        dms = np.linspace(m.lodm, m.hidm, 200)
        ax.plot(dms, m.total_smear(dms), lw=1.5,
                label="dDM=%.3g ds=%d" % (m.ddm, m.downsamp))
        ax.plot(dms, m.chan_smear(dms), "k:", lw=0.7)
    ax.set_yscale("log")
    ax.set_xlabel(r"DM (pc cm$^{-3}$)")
    ax.set_ylabel("Smearing (ms)")
    ax.set_title("DDplan: %.0f MHz, BW %.0f MHz, %d chan, dt %.3g us"
                 % (obs.f_ctr, obs.bw, obs.numchan, obs.dt * 1e6))
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(outfile, dpi=100)
    plt.close(fig)


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
