"""readfile: print header + first samples of any supported artifact
(src/readfile.c parity for the supported formats: .fil/.fits raw data,
.dat/.fft/.inf/.pfd/.bestprof/.singlepulse sidecars).

Host copy of ``presto_tpu/apps/readfile.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def describe(path: str, nsamp: int = 8) -> str:
    ext = os.path.splitext(path)[1].lower()
    out = ["--- %s ---" % path]
    if ext in (".fil", ".tim"):
        from presto_tpu_torch.io.sigproc import FilterbankFile
        with FilterbankFile(path) as fb:
            h = fb.header
            for k in ("source_name", "telescope_id", "machine_id",
                      "nchans", "nifs", "nbits", "tsamp", "tstart",
                      "fch1", "foff", "N"):
                out.append("  %-12s = %s" % (k, getattr(h, k)))
            out.append("  first spectra:\n%s"
                       % fb.read_spectra(0, min(nsamp, h.N)))
    elif ext in (".fits", ".sf"):
        from presto_tpu_torch.io.psrfits import PsrfitsFile
        with PsrfitsFile([path]) as pf:
            h = pf.header
            for k in ("source_name", "nchans", "nbits", "tsamp",
                      "tstart", "fch1", "foff", "N"):
                out.append("  %-12s = %s" % (k, getattr(h, k)))
    elif ext == ".dat":
        from presto_tpu_torch.io.datfft import read_dat
        d = read_dat(path)
        out.append("  N=%d  mean=%.6g  std=%.6g" %
                   (len(d), d.mean(), d.std()))
        out.append("  first: %s" % d[:nsamp])
    elif ext == ".fft":
        from presto_tpu_torch.io.datfft import read_fft
        d = read_fft(path)                    # complex64 packed bins
        out.append("  N=%d complex bins (NR-packed)" % len(d))
        out.append("  DC=%.6g  Nyquist=%.6g" % (d[0].real, d[0].imag))
    elif ext == ".inf":
        out.append(open(path).read())
    elif ext == ".pfd":
        from presto_tpu_torch.io.pfd import read_pfd
        p = read_pfd(path)
        out.append("  cand=%s  npart=%d nsub=%d proflen=%d  f=%.9g  "
                   "DM=%.3f" % (p.candnm, p.npart, p.nsub, p.proflen,
                                p.fold_p1, p.bestdm))
    elif ext in (".bestprof", ".singlepulse", ".par", ".txtcand"):
        out.append(open(path).read())
    else:
        raise SystemExit("readfile: unknown file type %r" % ext)
    return "\n".join(out)


# explicit raw-binary display formats (readfile_cmd.cli): flag name(s)
# -> numpy dtype
_RAW_FMTS = [
    (("byte", "b"), np.uint8),
    (("float", "f"), np.float32),
    (("double", "d"), np.float64),
    (("fcomplex", "fc"), np.complex64),
    (("dcomplex", "dc"), np.complex128),
    (("short", "s"), np.int16),
    (("int", "i"), np.int32),
    (("long", "l"), np.int64),
]


def _dump_raw(path, dtype, index, fortran, pagesize=None):
    """Hex-free element dump of a raw binary file at an explicit dtype
    (readfile.c's typed display modes).  -fortran strips the 4-byte
    record-length markers Fortran unformatted I/O writes."""
    raw = open(path, "rb").read()
    if fortran:
        out = bytearray()
        i = 0
        while i + 4 <= len(raw):
            n = int.from_bytes(raw[i:i + 4], "little")
            if n <= 0 or i + 8 + n > len(raw):
                break
            out += raw[i + 4:i + 4 + n]
            i += 8 + n
        raw = bytes(out)
    d = np.frombuffer(raw, dtype=dtype)
    lo, hi = index if index else (0, min(len(d), 100))
    hi = min(hi, len(d))
    lines = ["--- %s (%s, %d elements) ---"
             % (path, np.dtype(dtype).name, len(d))]
    for j in range(lo, hi):
        lines.append("%8d:  %s" % (j, d[j]))
    return "\n".join(lines)


def _dump_cands(path, kind, index, nph):
    from presto_tpu_torch.apps.accelsearch import read_cand_file
    from presto_tpu_torch.search.phasemod import read_bincands
    lines = ["--- %s (%s candidates) ---" % (path, kind)]
    cands = (read_cand_file(path) if kind == "rzw"
             else read_bincands(path))
    lo, hi = index if index else (0, len(cands))
    for j, c in enumerate(cands[lo:min(hi, len(cands))], start=lo):
        lines.append("%4d:  %s" % (j + 1, c))
    if nph:
        lines.append("  (nph = %g)" % nph)
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="readfile")
    p.add_argument("-n", type=int, default=8,
                   help="Samples/spectra to show")
    p.add_argument("-page", action="store_true",
                   help="Paginate the output (accepted; output is "
                        "printed whole here)")
    for names, _dt in _RAW_FMTS:
        grp = ["-" + nm for nm in names]
        p.add_argument(*grp, dest="fmt_" + names[0],
                       action="store_true",
                       help="Raw data in %s format" % names[0])
    p.add_argument("-rzwcand", "-rzw", dest="rzwcand",
                   action="store_true",
                   help="File holds rzw/accel search candidates")
    p.add_argument("-bincand", "-bin", dest="bincand",
                   action="store_true",
                   help="File holds bin search candidates")
    p.add_argument("-position", "-pos", dest="position",
                   action="store_true",
                   help="File holds position structs (legacy; shown "
                        "as float64 triples)")
    p.add_argument("-filterbank", action="store_true",
                   help="Raw data in SIGPROC filterbank format")
    p.add_argument("-psrfits", action="store_true",
                   help="Raw data in PSRFITS format")
    p.add_argument("-fortran", action="store_true",
                   help="Raw data was written by a Fortran program")
    p.add_argument("-index", type=int, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="The range of objects to display")
    p.add_argument("-nph", type=float, default=0.0,
                   help="0th FFT bin amplitude (for RZW data)")
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)
    idx = tuple(args.index) if args.index else None
    from presto_tpu_torch.io.errors import PrestoIOError
    rc = 0
    for f in args.files:
        fmt = next((dt for names, dt in _RAW_FMTS
                    if getattr(args, "fmt_" + names[0])), None)
        try:
            if args.rzwcand:
                print(_dump_cands(f, "rzw", idx, args.nph))
            elif args.bincand:
                print(_dump_cands(f, "bin", idx, args.nph))
            elif args.position:
                print(_dump_raw(f, np.float64, idx, args.fortran))
            elif fmt is not None:
                print(_dump_raw(f, fmt, idx, args.fortran))
            elif args.filterbank or args.psrfits:
                from presto_tpu_torch.apps.common import open_raw_args
                fb = open_raw_args([f], args)
                h = fb.header
                lines = ["--- %s (forced format) ---" % f]
                for k in ("source_name", "nchans", "nbits", "tsamp",
                          "tstart", "N"):
                    lines.append("  %-12s = %s"
                                 % (k, getattr(h, k, "?")))
                fb.close()
                print("\n".join(lines))
            else:
                print(describe(f, args.n))
        except PrestoIOError as e:
            # truncated/corrupt input: one-line typed diagnosis and a
            # nonzero exit, never a struct.error traceback
            print("readfile: %s" % e, file=sys.stderr)
            rc = 1
        except (ValueError, EOFError, OSError) as e:
            print("readfile: %s: %s" % (f, e), file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
