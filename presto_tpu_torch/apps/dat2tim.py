"""dat2tim: PRESTO .dat (+.inf) -> SIGPROC time-series .tim
(bin/dat2tim.py parity: a .tim is a SIGPROC file with nchans=1,
data_type=2, 32-bit samples).

Host copy of ``presto_tpu/apps/dat2tim.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.io.sigproc import FilterbankHeader, \
    write_filterbank_header


def dat_to_tim(datfile: str, outfile: str = "") -> str:
    base = os.path.splitext(datfile)[0]
    outfile = outfile or base + ".tim"
    data = datfft.read_dat(datfile)
    info = read_inf(base + ".inf")
    from presto_tpu_torch.apps.common import SIGPROC_TELESCOPES
    name_to_id = {v.lower(): k for k, v in SIGPROC_TELESCOPES.items()}
    hdr = FilterbankHeader(
        source_name=info.object or "unknown", data_type=2,
        telescope_id=name_to_id.get(
            (info.telescope or "").strip().lower(), 0),
        fch1=info.freq + (info.num_chan - 1) * info.chan_wid,
        foff=-abs(info.chan_wid) if info.chan_wid else -1.0,
        nchans=1, nbits=32, tstart=info.mjd, tsamp=info.dt, nifs=1)
    with open(outfile, "wb") as f:
        write_filterbank_header(hdr, f)
        data.astype(np.float32).tofile(f)
    return outfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dat2tim")
    p.add_argument("-o", type=str, default="")
    p.add_argument("datfiles", nargs="+")
    args = p.parse_args(argv)
    for f in args.datfiles:
        out = dat_to_tim(f, args.o if len(args.datfiles) == 1 else "")
        print("dat2tim: %s -> %s" % (f, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
