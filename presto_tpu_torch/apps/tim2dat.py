"""tim2dat: SIGPROC time-series .tim -> PRESTO .dat + .inf
(bin/tim2dat.py parity).

Host copy of ``presto_tpu/apps/tim2dat.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import InfoData, write_inf
from presto_tpu_torch.io.sigproc import read_filterbank_header


def tim_to_dat(timfile: str, outbase: str = "") -> str:
    outbase = outbase or os.path.splitext(timfile)[0]
    with open(timfile, "rb") as f:
        hdr = read_filterbank_header(f)
        f.seek(hdr.headerlen)
        data = np.fromfile(f, dtype=np.float32)
    datfft.write_dat(outbase + ".dat", data)
    from presto_tpu_torch.apps.common import SIGPROC_TELESCOPES
    tel = SIGPROC_TELESCOPES.get(hdr.telescope_id, "Unknown")
    info = InfoData(name=outbase, object=hdr.source_name,
                    N=len(data), dt=hdr.tsamp, mjd_i=int(hdr.tstart),
                    mjd_f=hdr.tstart - int(hdr.tstart),
                    freq=hdr.lofreq, chan_wid=abs(hdr.foff),
                    num_chan=1, freqband=abs(hdr.foff),
                    telescope=tel)
    write_inf(info, outbase + ".inf")
    return outbase + ".dat"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tim2dat")
    p.add_argument("-o", type=str, default="",
                   help="Output basename (single input only)")
    p.add_argument("timfiles", nargs="+")
    args = p.parse_args(argv)
    for f in args.timfiles:
        out = tim_to_dat(f, args.o if len(args.timfiles) == 1 else "")
        print("tim2dat: %s -> %s" % (f, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
