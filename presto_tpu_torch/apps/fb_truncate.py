"""fb_truncate: cut a filterbank file in time and/or frequency
(bin/fb_truncate.py parity: -L/-R time bounds in seconds, -B/-T
frequency bounds in MHz).

Host copy of ``presto_tpu/apps/fb_truncate.py`` for the PyTorch port,
which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import sigproc


def truncate(inpath: str, outpath: str, tlo: float = 0.0,
             thi: float = 1e30, flo: float = -1e30,
             fhi: float = 1e30, block: int = 1 << 14) -> str:
    with sigproc.FilterbankFile(inpath) as fb:
        h = fb.header
        if h.nifs != 1:
            raise SystemExit("fb_truncate: multi-IF input would be "
                             "summed and clipped; split pols first")
        freqs = h.lofreq + np.arange(h.nchans) * abs(h.foff)
        keep = (freqs >= flo) & (freqs <= fhi)
        if not keep.any():
            raise SystemExit("fb_truncate: no channels in band")
        clo, chi = int(np.argmax(keep)), int(len(keep) -
                                             np.argmax(keep[::-1]))
        s0 = max(0, int(tlo / h.tsamp))
        s1 = min(h.N, int(np.ceil(thi / h.tsamp)))
        nchan_out = chi - clo
        out_hdr = sigproc.FilterbankHeader(
            source_name=h.source_name, machine_id=h.machine_id,
            telescope_id=h.telescope_id, nchans=nchan_out, nifs=1,
            nbits=h.nbits, tsamp=h.tsamp,
            tstart=h.tstart + s0 * h.tsamp / 86400.0,
            fch1=freqs[chi - 1] if h.foff < 0 else freqs[clo],
            foff=h.foff, src_raj=h.src_raj, src_dej=h.src_dej,
            rawdatafile=os.path.basename(outpath))
        with open(outpath, "wb") as f:
            sigproc.write_filterbank_header(out_hdr, f)
            for start in range(s0, s1, block):
                blk = fb.read_spectra(start, min(block, s1 - start))
                blk = blk[:, clo:chi]
                arr = blk[:, ::-1] if h.foff < 0 else blk
                sigproc.pack_bits(
                    np.clip(np.round(arr), 0,
                            (1 << min(h.nbits, 16)) - 1
                            ).reshape(-1) if h.nbits < 32
                    else arr.reshape(-1), h.nbits).tofile(f)
    return outpath


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fb_truncate")
    p.add_argument("-L", type=float, default=0.0, help="Start time, s")
    p.add_argument("-R", type=float, default=1e30, help="End time, s")
    p.add_argument("-B", type=float, default=-1e30,
                   help="Bottom frequency, MHz")
    p.add_argument("-T", type=float, default=1e30,
                   help="Top frequency, MHz")
    p.add_argument("-o", type=str, required=True)
    p.add_argument("infile")
    args = p.parse_args(argv)
    truncate(args.infile, args.o, args.L, args.R, args.B, args.T)
    print("fb_truncate: %s -> %s" % (args.infile, args.o))
    return 0


if __name__ == "__main__":
    sys.exit(main())
