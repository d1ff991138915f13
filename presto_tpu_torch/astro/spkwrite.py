"""Minimal NAIF DAF/SPK (.bsp) writer — type-2 Chebyshev segments.

Host copy of ``presto_tpu/astro/spkwrite.py`` for the PyTorch port, which
imports nothing from the JAX package.

The reference reaches JPL ephemerides through TEMPO's installed DE
files (src/barycenter.c:87-156); this framework reads real JPL .bsp
kernels natively (astro/spk.py).  This module is the WRITE side: it
fits Chebyshev position records to any of the framework's ephemeris
models and emits a spec-conformant single-summary-record DAF/SPK
file.  Uses:

  * astro/kernels.py generates the zero-setup builtin kernel (the
    EPV2000 series packaged as a .bsp so every kernel-route feature —
    prepfold -ephem, bary tools, polycos — runs with no user file);
  * tests synthesize small DE-grade kernels to validate the reader's
    DAF walk, segment chaining and Chebyshev evaluation
    (tests/spk_synth.py re-exports these helpers).

Record layout per SPK type 2: [mid, radius, X coefs, Y coefs, Z
coefs], evaluated at tau = (et - mid) / radius.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np

NCOEF = 12      # historical default for the test-sized kernels


def cheby_fit(fn, t0: float, t1: float, ncoef: int) -> np.ndarray:
    """Chebyshev coefficients of fn over [t0, t1] (3 components) —
    one window.  Returns [3, ncoef]."""
    k = np.arange(ncoef)
    x = np.cos(np.pi * (k + 0.5) / ncoef)          # Chebyshev nodes
    t = 0.5 * (t0 + t1) + 0.5 * (t1 - t0) * x
    y = fn(t)                                      # [ncoef, 3]
    T = np.cos(np.outer(np.arccos(x), k))          # [ncoef, ncoef]
    c = 2.0 / ncoef * T.T @ y                      # [ncoef, 3]
    c[0] *= 0.5
    return c.T                                     # [3, ncoef]


def type2_records(fn_km, et0: float, intlen: float, nrec: int,
                  ncoef: int = NCOEF) -> np.ndarray:
    """Type-2 (Chebyshev position) records fitting fn_km(et) -> km,
    one window at a time (small kernels; see type2_records_batched
    for the builtin-kernel scale)."""
    out = []
    for i in range(nrec):
        t0 = et0 + i * intlen
        mid, radius = t0 + 0.5 * intlen, 0.5 * intlen
        c = cheby_fit(lambda tau: fn_km(mid + tau * radius),
                      -1.0, 1.0, ncoef)
        out.append(np.concatenate([[mid, radius], c.ravel()]))
    return np.asarray(out)


def type2_records_batched(fn_km, et0: float, intlen: float, nrec: int,
                          ncoef: int,
                          chunk: int = 512) -> np.ndarray:
    """type2_records with the ephemeris evaluated on the whole
    (record, node) grid in vectorized chunks — the builtin kernel
    fits ~10^4 windows over a ~2000-term Poisson series, where a
    per-window Python loop costs minutes and chunked evaluation
    seconds (chunk bounds the [nterms, chunk*ncoef] broadcast)."""
    k = np.arange(ncoef)
    x = np.cos(np.pi * (k + 0.5) / ncoef)
    T = np.cos(np.outer(np.arccos(x), k))          # [node, term]
    mids = et0 + (np.arange(nrec) + 0.5) * intlen
    radius = 0.5 * intlen
    recs = np.empty((nrec, 2 + 3 * ncoef))
    recs[:, 0] = mids
    recs[:, 1] = radius
    for r0 in range(0, nrec, chunk):
        r1 = min(r0 + chunk, nrec)
        ts = mids[r0:r1, None] + radius * x[None, :]
        y = np.asarray(fn_km(ts.ravel())).reshape(r1 - r0, ncoef, 3)
        c = 2.0 / ncoef * np.einsum("kn,rkc->rnc", T, y)
        c[:, 0, :] *= 0.5
        # record layout: X block, then Y, then Z
        recs[r0:r1, 2:] = c.transpose(0, 2, 1).reshape(r1 - r0, -1)
    return recs


def write_spk(path: str,
              segments: Sequence[Tuple[int, int, int, float, float,
                                       np.ndarray]]) -> None:
    """Single-summary-record DAF/SPK writer.

    segments: list of (target, center, data_type, init, intlen,
    records[n, rsize]).  Enough structure for the reader's address
    arithmetic, summary walk, and both Chebyshev data types; the
    builtin kernel needs exactly this much (direct SSB->Earth and
    SSB->Sun segments)."""
    nd, ni = 2, 6
    # element data begins at record 4 (1:file, 2:summary, 3:names)
    arrays = []
    addr = (4 - 1) * 128 + 1                       # 1-indexed doubles
    summaries = []
    for (tgt, ctr, dtype, init, intlen, recs) in segments:
        n, rsize = recs.shape
        flat = np.concatenate([recs.ravel(),
                               [init, intlen, float(rsize), float(n)]])
        a0, a1 = addr, addr + len(flat) - 1
        et0 = init
        et1 = init + intlen * n
        summaries.append((et0, et1, tgt, ctr, 1, dtype, a0, a1))
        arrays.append(flat)
        addr = a1 + 1

    file_rec = bytearray(1024)
    file_rec[0:8] = b"DAF/SPK "
    file_rec[8:16] = struct.pack("<ii", nd, ni)
    file_rec[16:76] = b"presto_tpu kernel".ljust(60)
    file_rec[76:88] = struct.pack("<iii", 2, 2, addr)  # FWARD BWARD FREE
    file_rec[88:96] = b"LTL-IEEE"

    sum_rec = bytearray(1024)
    sum_rec[0:24] = struct.pack("<ddd", 0.0, 0.0, float(len(summaries)))
    for i, (et0, et1, tgt, ctr, frame, dtype, a0, a1) in \
            enumerate(summaries):
        off = 24 + i * 40
        sum_rec[off:off + 40] = struct.pack("<dd6i", et0, et1, tgt, ctr,
                                            frame, dtype, a0, a1)
    name_rec = b" " * 1024

    data = np.concatenate(arrays)
    with open(path, "wb") as f:
        f.write(bytes(file_rec))
        f.write(bytes(sum_rec))
        f.write(name_rec)
        f.write(data.astype("<f8").tobytes())
        f.write(b"\0" * ((-f.tell()) % 1024))
