"""single_pulse_search: matched-filter burst search over .dat series.

PyTorch counterpart of ``presto_tpu/apps/single_pulse_search.py`` (CLI
parity with bin/single_pulse_search.py, options -m/-t/-s/-e/-b/-f/-d/
-p): reads one or more .dat (+ .inf) files — typically the prepsubband
DM fan-out — and writes a .singlepulse event list per file; .singlepulse
inputs are read back and aggregated, as the reference's read-only mode
does.  The search runs on ``device`` (CUDA unless the caller passes
"cpu").

Unless -p is given, a run that finds events draws the summary plot to
<first input>_singlepulse.png (plotting/spplot.plot_singlepulse) after
its .singlepulse files are written; without matplotlib that raises
ImportError.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.apps.common import load_timeseries
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.search.singlepulse import (SinglePulseSearch,
                                                 read_singlepulse,
                                                 write_singlepulse)

GROUP_BYTES = 1 << 30    # series bytes per batched search call


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="single_pulse_search",
        description="Search dedispersed time series for single pulses")
    p.add_argument("-m", "--maxwidth", type=float, default=0.0,
                   help="Max boxcar width in seconds (default: 30 bins)")
    p.add_argument("-t", "--threshold", type=float, default=5.0)
    p.add_argument("-s", "--start", type=float, default=0.0,
                   help="Ignore events before this time (s)")
    p.add_argument("-e", "--end", type=float, default=1e9,
                   help="Ignore events after this time (s)")
    p.add_argument("-b", "--nobadblocks", action="store_true",
                   help="Disable bad-block detection")
    p.add_argument("-f", "--fast", action="store_true",
                   help="Median removal instead of linear detrend")
    p.add_argument("-d", "--detrendfact", type=int, default=1,
                   choices=[1, 2, 4, 8, 16, 32],
                   help="Detrend chunk size in 1000s of samples")
    p.add_argument("-p", "--noplot", action="store_true",
                   help="Skip the summary plot (reference -noplot)")
    p.add_argument("datfiles", nargs="+")
    return p


def sp_input_plan(info, nraw):
    """(nuse, offregions) for one series: the searchable sample count
    (padding excluded via the .inf onoff pairs) and the off regions
    the detrender must not normalize across.  Shared by this CLI and
    the survey's seam path (pipeline/survey.seam_singlepulse) so both
    search bit-identical inputs."""
    offregions = []
    nuse = nraw
    if info.numonoff > 1:
        ons = [int(a) for a, b in info.onoff]
        offs = [int(b) for a, b in info.onoff]
        offregions = list(zip(offs[:-1], ons[1:]))
        if offregions and offregions[-1][1] >= info.N - 1:
            nuse = min(nraw, offregions[-1][0] + 1)
    return nuse, offregions


def sp_block_plan(infos, nraw):
    """One shared (nuse, offregions) for a whole prepsubband fan-out,
    or None when the trials disagree (mixed resumes, hand-edited
    .inf): every DM series of one method has the same N/dt/onoff, so a
    block can be searched as ONE batch without per-row re-planning."""
    plans = {(nuse, tuple(off))
             for nuse, off in (sp_input_plan(info, nraw)
                               for info in infos)}
    if len(plans) != 1:
        return None
    nuse, off = next(iter(plans))
    return nuse, list(off)


def run(args, device="cuda") -> list:
    """Search every .dat input (grouped by (length, dt), at most
    GROUP_BYTES of series a call, each group uploaded once) and write
    its .singlepulse; read every .singlepulse input.  Returns all
    events (from .singlepulse inputs: those within -s/-e at or above
    the threshold)."""
    allcands = []
    sp = SinglePulseSearch(threshold=args.threshold,
                           maxwidth=args.maxwidth,
                           detrendlen=1000 * args.detrendfact,
                           fast_detrend=args.fast,
                           badblocks=not args.nobadblocks, device=device)
    planned = []               # (fn, base, nuse, info, offregions)
    for fn in args.datfiles:
        if fn.endswith(".singlepulse"):
            allcands.extend([c for c in read_singlepulse(fn)
                             if args.start <= c.time <= args.end
                             and c.sigma >= args.threshold])
            continue
        base = fn[:-4] if fn.endswith(".dat") else fn
        info = read_inf(base)
        nraw = os.path.getsize(base + ".dat") // 4
        nuse, offregions = sp_input_plan(info, nraw)
        planned.append((fn, base, nuse, info, offregions))

    groups = {}
    for item in planned:
        groups.setdefault((item[2], item[3].dt), []).append(item)
    for (n, dt), items in groups.items():
        per = max(1, int(GROUP_BYTES // max(n * 4, 1)))
        for g0 in range(0, len(items), per):
            chunk = items[g0:g0 + per]
            batch = np.empty((len(chunk), n), np.float32)
            for ri, (_, base, nuse, _, _) in enumerate(chunk):
                ts, _ = load_timeseries(base + ".dat")
                batch[ri] = np.asarray(ts[:nuse], np.float32)
            results = sp.search_many_resident(
                batch, dt,
                dms=[it[3].dm for it in chunk],
                offregions_list=[it[4] for it in chunk])
            del batch
            for (fn, base, _, info, _), (cands, stds, bad) in \
                    zip(chunk, results):
                cands = [c for c in cands
                         if args.start <= c.time <= args.end]
                write_singlepulse(base + ".singlepulse", cands)
                print("%s: %d pulse candidates (%d bad blocks)" %
                      (fn, len(cands), len(bad)))
                allcands.extend(cands)
    return allcands


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    allcands = run(args, device=device)
    if not args.noplot and allcands:
        from presto_tpu_torch.plotting import plot_singlepulse
        base = args.datfiles[0]
        for suf in (".dat", ".singlepulse"):
            if base.endswith(suf):
                base = base[:-len(suf)]
        out = base + "_singlepulse.png"
        plot_singlepulse(allcands, out,
                         title="%s (%d events)" % (base,
                                                   len(allcands)))
        print("single_pulse_search: summary plot -> %s" % out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
