"""exploredat: browse a .dat time series (src/exploredat.c parity).

Interactive (zoom/pan, chunked min/avg/max envelopes) when a GUI
matplotlib backend is available; otherwise renders to a PNG.

Host copy of ``presto_tpu/apps/exploredat.py`` for the PyTorch port,
which imports nothing from the JAX package. The viewer needs matplotlib,
which the card machine does not have: there a run raises ImportError
naming it before it reads the series.
"""

from __future__ import annotations

import argparse

from presto_tpu_torch.io.datfft import read_dat_with_inf
from presto_tpu_torch.plotting.explore import (TimeseriesView,
                                               render_timeseries,
                                               run_explorer)


def build_parser():
    p = argparse.ArgumentParser(prog="exploredat")
    p.add_argument("datfile")
    p.add_argument("-start", type=float, default=0.0,
                   help="Start time (s) of the initial window")
    p.add_argument("-dur", type=float, default=0.0,
                   help="Duration (s) of the initial window")
    p.add_argument("-png", default=None,
                   help="Render to this PNG instead of interacting")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.plotting import pyplot
    pyplot("exploredat")
    data, info = read_dat_with_inf(args.datfile)
    lobin = int(args.start / info.dt) if args.start else 0
    numbins = int(args.dur / info.dt) if args.dur else 0
    view = TimeseriesView(data=data, dt=info.dt, lobin=lobin,
                          numbins=numbins)
    mode = run_explorer(view, render_timeseries, out_png=args.png)
    if mode != "interactive":
        print("exploredat: wrote %s" % mode)
    return 0


if __name__ == "__main__":
    main()
