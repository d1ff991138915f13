"""psrfits2fil: SEARCH-mode PSRFITS -> SIGPROC filterbank
(bin/psrfits2fil.py parity: applies scales/offsets/weights, requantizes
to -n bits, streams block-wise).

Host copy of ``presto_tpu/apps/psrfits2fil.py`` for the PyTorch port:

    python -m presto_tpu_torch.apps.psrfits2fil -o out.fil a.fits b.fits
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import sigproc
from presto_tpu_torch.io.psrfits import PsrfitsFile


def psrfits_to_fil(paths, outfile: str, nbits: int = 8,
                   block: int = 1 << 12, apply_weights=None) -> str:
    with PsrfitsFile(paths, apply_weight=apply_weights) as pf:
        hdr = pf.header
        hdr = sigproc.FilterbankHeader(
            source_name=hdr.source_name, nchans=hdr.nchans, nifs=1,
            nbits=nbits, tsamp=hdr.tsamp, tstart=hdr.tstart,
            fch1=hdr.fch1, foff=hdr.foff, src_raj=hdr.src_raj,
            src_dej=hdr.src_dej,
            rawdatafile=os.path.basename(outfile))
        N = pf.nspectra
        # requantization scale from the global min/max (streamed
        # pre-pass so later bright transients are never clipped)
        lo, hi = np.inf, -np.inf
        for start in range(0, N, block):
            blk = pf.read_spectra(start, min(block, N - start))
            lo = min(lo, float(blk.min()))
            hi = max(hi, float(blk.max()))
        span = (hi - lo) or 1.0
        maxq = (1 << nbits) - 1 if nbits < 32 else 0
        with open(outfile, "wb") as f:
            sigproc.write_filterbank_header(hdr, f)
            for start in range(0, N, block):
                blk = pf.read_spectra(start, min(block, N - start))
                if nbits == 32:
                    q = blk.astype(np.float32)
                else:
                    q = np.clip(np.round((blk - lo) * maxq / span),
                                0, maxq)
                arr = q[:, ::-1] if hdr.foff < 0 else q
                sigproc.pack_bits(arr.reshape(-1), nbits).tofile(f)
    return outfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="psrfits2fil")
    p.add_argument("-n", "--nbits", type=int, default=8,
                   choices=[1, 2, 4, 8, 16, 32])
    p.add_argument("-o", type=str, default=None)
    p.add_argument("--noweights", action="store_true")
    p.add_argument("fitsfiles", nargs="+")
    args = p.parse_args(argv)
    out = args.o or (os.path.splitext(args.fitsfiles[0])[0] + ".fil")
    psrfits_to_fil(args.fitsfiles, out, nbits=args.nbits,
                   apply_weights=False if args.noweights else None)
    print("psrfits2fil: %s -> %s" % (args.fitsfiles, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
