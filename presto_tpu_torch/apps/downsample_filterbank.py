"""downsample_filterbank: time-average a SIGPROC .fil by a factor.

Twin of bin/downsample_filterbank.py: streams the filterbank in
blocks, averages every DS_fact consecutive spectra per channel, and
writes <base>_DS<f>.fil with tsamp scaled accordingly (header
otherwise preserved; output sample depth matches the input's 8/32
bits, with 8-bit data rounded like the reference's byte output).

Host copy of ``presto_tpu/apps/downsample_filterbank.py`` for the
PyTorch port, which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

import numpy as np

from presto_tpu_torch.io.sigproc import (FilterbankFile, pack_bits,
                                         write_filterbank_header)


def build_parser():
    p = argparse.ArgumentParser(
        prog="downsample_filterbank",
        description="time-downsample a .fil by an integer factor")
    p.add_argument("dsfact", type=int)
    p.add_argument("infile")
    p.add_argument("-o", "--output", default="")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.dsfact < 1:
        raise SystemExit("DS_fact must be >= 1")
    base = os.path.splitext(args.infile)[0]
    out = args.output or "%s_DS%d.fil" % (base, args.dsfact)
    with FilterbankFile(args.infile) as fb:
        hdr = fb.header
        nout = hdr.N // args.dsfact
        new_hdr = replace(hdr, tsamp=hdr.tsamp * args.dsfact, N=nout)
        # stream input AND output block-by-block: survey-scale .fil
        # files do not fit in RAM
        nblk = max(1, (1 << 22) // max(hdr.nchans * args.dsfact, 1))
        with open(out, "wb") as f:
            write_filterbank_header(new_hdr, f)
            done = 0
            while done < nout:
                n = min(nblk, nout - done)
                raw = fb.read_spectra(done * args.dsfact,
                                      n * args.dsfact)
                d = raw.reshape(n, args.dsfact,
                                hdr.nchans).mean(axis=1)
                if hdr.foff < 0:     # disk order is descending freq
                    d = d[:, ::-1]
                d = np.ascontiguousarray(d)
                if hdr.nbits == 8:
                    d = np.clip(np.round(d), 0, 255)
                if hdr.nbits in (1, 2, 4, 8):
                    pack_bits(d.ravel().astype(np.uint8),
                              hdr.nbits).tofile(f)
                else:
                    d.ravel().astype(np.float32).tofile(f)
                done += n
    print("downsample_filterbank: %d -> %d spectra (x%d) -> %s"
          % (hdr.N, nout, args.dsfact, out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
