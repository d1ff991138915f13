"""get_TOAs: extract pulse times-of-arrival from .pfd files.

PyTorch counterpart of ``presto_tpu/apps/get_toas.py`` (CLI parity with
bin/get_TOAs.py): -n TOAs per file, -g Gaussian template FWHM
(rotations), -t template .bestprof/profile file, -d DM override for
subband realignment (on ``device``), -2 for tempo2 format, -o output
.tim path (default stdout).  FFTFIT is the NumPy Taylor-1992 copy in
timing/fftfit.py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.io.errors import PrestoIOError
from presto_tpu_torch.io.pfd import read_pfd
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.timing import toas_from_pfd


def build_parser():
    p = argparse.ArgumentParser(prog="get_TOAs")
    p.add_argument("-n", type=int, default=1,
                   help="Number of TOAs per .pfd file")
    p.add_argument("-g", type=float, default=0.1,
                   help="Gaussian template FWHM in rotations")
    p.add_argument("-t", type=str, default=None,
                   help="Template profile file (.bestprof or one value "
                        "per line)")
    p.add_argument("-d", type=float, default=None,
                   help="Realign subbands at this DM before summing")
    p.add_argument("-2", dest="tempo2", action="store_true",
                   help="tempo2 .tim output format")
    p.add_argument("-o", type=str, default=None,
                   help="Write TOAs to this file instead of stdout")
    p.add_argument("pfdfiles", nargs="+")
    return p


def _load_template(path: str) -> np.ndarray:
    if path.endswith(".bestprof"):
        from presto_tpu_torch.io.bestprof import read_bestprof
        return read_bestprof(path).profile
    try:
        return np.loadtxt(path, usecols=(-1,))
    except OSError as e:
        raise PrestoIOError("cannot read template: %s" % e,
                            path=path, kind="missing") from None


def toa_lines(pfdfiles, ntoa: int = 1, gauss_fwhm: float = 0.1,
              template: np.ndarray = None, dm: float = None,
              fmt: str = "princeton", device="cuda"):
    """The CLI's per-.pfd TOA loop: read each fold, extract `ntoa` TOAs
    (realigning subbands at `dm` on ``device`` when given), format the
    .tim lines.  Corrupt or missing .pfd inputs raise PrestoIOError."""
    from presto_tpu_torch.astro.observatory import tempo1_site_code
    from presto_tpu_torch.timing.toas import format_tim_lines
    device = resolve_device(device)
    all_toas, names = [], []
    for path in pfdfiles:
        p = read_pfd(path)
        fold_dm = p.bestdm if dm is not None else None
        toas = toas_from_pfd(
            p, template=template, ntoa=ntoa, dm=dm,
            fold_dm=fold_dm, gauss_fwhm=gauss_fwhm,
            obs=tempo1_site_code(p.telescope), device=device)
        all_toas.extend(toas)
        names.extend([p.candnm or "unk"] * len(toas))
    return format_tim_lines(all_toas, names, fmt)


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    try:
        template = _load_template(args.t) if args.t else None
        lines = toa_lines(args.pfdfiles, ntoa=args.n,
                          gauss_fwhm=args.g, template=template,
                          dm=args.d,
                          fmt="tempo2" if args.tempo2
                          else "princeton", device=device)
    except PrestoIOError as e:
        # one-line diagnosis, not a traceback
        print("get_TOAs: %s" % e)
        return 1
    if args.o:
        with open(args.o, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    else:
        for line in lines:
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
