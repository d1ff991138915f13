"""Small .dat surgeries: shiftdata, patchdata, dat2sdat, sdat2dat,
toas2dat (src/shiftdata.c, patchdata.c, dat2sdat.c, sdat2dat.c,
toas2dat.c).  Each is exposed as its own console entry:
`python -m presto_tpu_torch.apps.datutils <tool> args...`.

Host copy of ``presto_tpu/apps/datutils.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import datfft


def shiftdata(datfile: str, shift: float, outfile: str = "") -> str:
    """Shift a time series by a FRACTIONAL number of bins via linear
    interpolation (src/shiftdata.c semantics)."""
    data = datfft.read_dat(datfile)
    frac = shift - np.floor(shift)
    whole = int(np.floor(shift))
    out = (1.0 - frac) * data + frac * np.roll(data, 1)
    out = np.roll(out, whole)
    outfile = outfile or (os.path.splitext(datfile)[0] + "_shift.dat")
    datfft.write_dat(outfile, out.astype(np.float32))
    return outfile


def patchdata(datfile: str, lobin: int, hibin: int,
              outfile: str = "") -> str:
    """Replace [lobin, hibin) with the running median level
    (src/patchdata.c: patches dropouts so FFTs aren't ringing)."""
    data = datfft.read_dat(datfile).copy()
    lobin = max(0, lobin)
    hibin = min(len(data), hibin)
    ctx = np.concatenate([data[max(0, lobin - 1000):lobin],
                          data[hibin:hibin + 1000]])
    level = np.median(ctx) if ctx.size else data.mean()
    data[lobin:hibin] = level
    outfile = outfile or (os.path.splitext(datfile)[0] + "_patched.dat")
    datfft.write_dat(outfile, data)
    return outfile


def dat2sdat(datfile: str, outfile: str = "") -> str:
    """float32 .dat -> int16 .sdat with a leading float32 scale pair
    (src/dat2sdat.c stores min + scale so sdat2dat can invert)."""
    data = datfft.read_dat(datfile)
    lo = float(data.min())
    span = float(data.max() - lo) or 1.0
    scale = span / 65535.0
    q = np.round((data - lo) / scale - 32768.0).astype(np.int16)
    outfile = outfile or (os.path.splitext(datfile)[0] + ".sdat")
    with open(outfile, "wb") as f:
        np.array([lo, scale], np.float32).tofile(f)
        q.tofile(f)
    return outfile


def sdat2dat(sdatfile: str, outfile: str = "") -> str:
    with open(sdatfile, "rb") as f:
        lo, scale = np.fromfile(f, np.float32, 2)
        q = np.fromfile(f, np.int16)
    data = (q.astype(np.float32) + 32768.0) * scale + lo
    outfile = outfile or (os.path.splitext(sdatfile)[0] + ".dat")
    datfft.write_dat(outfile, data)
    return outfile


def toas2dat(toafile: str, dt: float, numout: int,
             outfile: str = "", t0: float = None, text: bool = True,
             floats: bool = False, sec: bool = True) -> str:
    """Event arrival times -> binned .dat (src/toas2dat.c: histogram
    events onto the sample grid).  text=True reads ASCII (one TOA per
    line); otherwise binary doubles (floats=True: binary float32).
    sec=False means TOAs are in days.  t0 = time of bin 0 (default:
    the first TOA)."""
    if text:
        toas = np.loadtxt(toafile, usecols=(0,), ndmin=1)
    else:
        toas = np.fromfile(toafile,
                           np.float32 if floats else np.float64)
    toas = np.asarray(toas, np.float64)
    if not sec:
        toas = toas * 86400.0
    if t0 is None:
        t0 = float(toas.min()) if toas.size else 0.0
    elif not sec:
        t0 = t0 * 86400.0
    bins = np.floor((toas - t0) / dt).astype(np.int64)
    bins = bins[(bins >= 0) & (bins < numout)]
    data = np.bincount(bins, minlength=numout).astype(np.float32)
    outfile = outfile or (os.path.splitext(toafile)[0] + ".dat")
    datfft.write_dat(outfile, data)
    return outfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="datutils")
    sub = p.add_subparsers(dest="tool", required=True)
    s = sub.add_parser("shiftdata")
    s.add_argument("-shift", type=float, required=True)
    s.add_argument("datfile")
    s.add_argument("-o", type=str, default="")
    s = sub.add_parser("patchdata")
    s.add_argument("lobin", type=int)
    s.add_argument("hibin", type=int)
    s.add_argument("datfile")
    s.add_argument("-o", type=str, default="")
    s = sub.add_parser("dat2sdat")
    s.add_argument("datfile")
    s.add_argument("-o", type=str, default="")
    s = sub.add_parser("sdat2dat")
    s.add_argument("sdatfile")
    s.add_argument("-o", type=str, default="")
    s = sub.add_parser("toas2dat")
    s.add_argument("-dt", type=float, required=True,
                   help="Time interval (s) for output bins")
    s.add_argument("-n", type=int, required=True,
                   help="Number of bins in the output series")
    s.add_argument("-t0", type=float, default=None,
                   help="Time of the start of bin 0 (TOA units)")
    s.add_argument("-text", action="store_true", default=True,
                   help="TOAs are ASCII text (default)")
    s.add_argument("-float", dest="floats", action="store_true",
                   help="TOAs are binary float32 (implies binary)")
    s.add_argument("-double", dest="doubles", action="store_true",
                   help="TOAs are binary float64")
    s.add_argument("-sec", action="store_true", default=True,
                   help="TOA unit is seconds (default; clear with "
                        "-days)")
    s.add_argument("-days", action="store_true",
                   help="TOA unit is days")
    s.add_argument("toafile")
    s.add_argument("-o", type=str, default="")
    args = p.parse_args(argv)
    if args.tool == "shiftdata":
        out = shiftdata(args.datfile, args.shift, args.o)
    elif args.tool == "patchdata":
        out = patchdata(args.datfile, args.lobin, args.hibin, args.o)
    elif args.tool == "dat2sdat":
        out = dat2sdat(args.datfile, args.o)
    elif args.tool == "sdat2dat":
        out = sdat2dat(args.sdatfile, args.o)
    else:
        binary = args.floats or args.doubles
        out = toas2dat(args.toafile, args.dt, args.n, args.o,
                       t0=args.t0, text=not binary,
                       floats=args.floats, sec=not args.days)
    print("%s -> %s" % (args.tool, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
