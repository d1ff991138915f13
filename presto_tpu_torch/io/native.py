"""ctypes bindings for the port's native IO runtime (csrc/native_io.cpp).

Copy of ``presto_tpu/io/native.py`` for the PyTorch port, which imports
nothing from the JAX package.  The reference keeps its raw-data path in
C (INSTRUMENTOBJS: bit-unpack psrfits.c:828-866, scale/offset/weight
psrfits.c:805-814, the get_rawblock readers behind
backend_common.h:86-87); this module loads the fused decoders and the
pthread prefetching block feeder.

The library is built from the package's own source by
``presto_tpu_torch.cuda_build`` (g++) at first use.  There is no
fallback: a failure to build or load raises.  The NumPy decoders of
``io/sigproc`` and ``io/psrfits`` are the plain versions the tests hold
these against (and the decoders of the widths these do not take: 16 and
32 bits, or spectra that are not byte-aligned).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional

import numpy as np

from presto_tpu_torch import cuda_build

NBITS = (1, 2, 4, 8)


def _load() -> ctypes.CDLL:
    lib = cuda_build.load("native_io")
    if not getattr(lib, "_presto_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        i32 = ctypes.c_int
        lib.pt_unpack_bits.argtypes = [u8p, i64, i32, u8p]
        lib.pt_unpack_bits.restype = None
        lib.pt_decode_spectra.argtypes = [u8p, i64, i32, i32, i32, i32,
                                          f32p]
        lib.pt_decode_spectra.restype = None
        lib.pt_decode_subint.argtypes = [u8p, i64, i32, i32, i32,
                                         ctypes.c_float, f32p, f32p, f32p,
                                         i32, i32, f32p]
        lib.pt_decode_subint.restype = None
        lib.pt_feeder_open.argtypes = [ctypes.c_char_p, i64, i64, i32]
        lib.pt_feeder_open.restype = ctypes.c_void_p
        lib.pt_feeder_next.argtypes = [ctypes.c_void_p, u8p]
        lib.pt_feeder_next.restype = i64
        lib.pt_feeder_stats.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(i64)]
        lib.pt_feeder_stats.restype = None
        lib.pt_feeder_close.argtypes = [ctypes.c_void_p]
        lib.pt_feeder_close.restype = None
        lib._presto_typed = True
    return lib


def supports(nbits: int, nifs: int, nchan: int) -> bool:
    """The native decoder takes this geometry: 1/2/4/8-bit samples and
    byte-aligned spectra."""
    return nbits in NBITS and (nifs * nchan * nbits) % 8 == 0


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32ptr(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def unpack_bits(raw: np.ndarray, nbits: int) -> np.ndarray:
    """1/2/4/8-bit -> uint8, MSB-first."""
    if nbits not in NBITS:
        raise ValueError("native unpack_bits takes nbits 1, 2, 4, 8")
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(raw.size * 8 // nbits, np.uint8)
    _load().pt_unpack_bits(_u8ptr(raw), raw.size, nbits, _u8ptr(out))
    return out


def decode_spectra(raw: np.ndarray, nspec: int, nifs: int, nchan: int,
                   nbits: int, flip: bool,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused filterbank block decode -> float32 [nspec, nchan] (IFs
    summed, channels flipped when ``flip``), written into ``out`` (a
    C-contiguous float32 [>= nspec, nchan] array, e.g. the NumPy view of
    a pinned host tensor) when given.  Returns the [nspec, nchan]
    result."""
    if not supports(nbits, nifs, nchan):
        raise ValueError("native decode takes nbits 1, 2, 4, 8 and "
                         "byte-aligned spectra (nbits %d, nifs %d, nchan %d)"
                         % (nbits, nifs, nchan))
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size * 8 != nspec * nifs * nchan * nbits:
        raise ValueError("native decode: %d bytes do not hold %d spectra"
                         % (raw.size, nspec))
    if out is None:
        out = np.empty((nspec, nchan), np.float32)
    elif (out.dtype != np.float32 or not out.flags.c_contiguous
          or not out.flags.writeable or out.ndim != 2
          or out.shape[1] != nchan or out.shape[0] < nspec):
        raise ValueError("native decode: out must be a writable "
                         "C-contiguous float32 [>= %d, %d] array"
                         % (nspec, nchan))
    _load().pt_decode_spectra(_u8ptr(raw), nspec, nifs, nchan, nbits,
                              int(flip), _f32ptr(out))
    return out[:nspec]


def decode_subint(raw: np.ndarray, nspec: int, npol: int, nchan: int,
                  nbits: int, zero_off: float,
                  scl: Optional[np.ndarray], offs: Optional[np.ndarray],
                  wts: Optional[np.ndarray], pol_mode: int,
                  flip: bool) -> np.ndarray:
    """Fused PSRFITS subint decode (psrfits.c:789-920 analog): the
    decoder of io/psrfits.PsrfitsFile for 1/2/4/8-bit rows, held against
    io/psrfits.decode_row_numpy.

    pol_mode: >=0 select that pol, -2 sum the first two pols.
    scl/offs are [npol*nchan]; wts is [nchan]; any may be None.
    """
    if not supports(nbits, npol, nchan):
        raise ValueError("native decode takes nbits 1, 2, 4, 8 and "
                         "byte-aligned spectra")
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size * 8 != nspec * npol * nchan * nbits:
        raise ValueError("native decode: %d bytes do not hold %d spectra"
                         % (raw.size, nspec))
    scl = None if scl is None else np.ascontiguousarray(scl, np.float32)
    offs = None if offs is None else np.ascontiguousarray(offs, np.float32)
    wts = None if wts is None else np.ascontiguousarray(wts, np.float32)
    # the C code reads scl/offs[0:npol*nchan] and wts[0:nchan]
    if any(a is not None and a.size < npol * nchan for a in (scl, offs)) \
            or (wts is not None and wts.size < nchan):
        raise ValueError("native decode_subint: short scale, offset or "
                         "weight column")
    out = np.empty((nspec, nchan), np.float32)
    _load().pt_decode_subint(_u8ptr(raw), nspec, npol, nchan, nbits,
                             float(zero_off), _f32ptr(scl), _f32ptr(offs),
                             _f32ptr(wts), pol_mode, int(flip),
                             _f32ptr(out))
    return out


class BlockFeeder:
    """Background-prefetching sequential block reader over one file.

    Wraps the pthread ring-buffer feeder: the read of block k+1..k+nbuf
    overlaps the consumer's processing of block k, hiding disk latency
    from the device-feed loop (the role the reference's streaming
    double-buffer plays, prepsubband.c:930-942).
    """

    def __init__(self, path: str, start_offset: int, block_bytes: int,
                 nbuf: int = 4):
        self._h = None
        self._lib = _load()
        self.block_bytes = int(block_bytes)
        self._h = self._lib.pt_feeder_open(path.encode(),
                                           int(start_offset),
                                           self.block_bytes, int(nbuf))
        if not self._h:
            raise OSError("pt_feeder_open failed for %s" % path)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            buf = np.empty(self.block_bytes, np.uint8)
            n = self._lib.pt_feeder_next(self._h, _u8ptr(buf))
            if n < 0:
                raise IOError("I/O error while prefetching blocks")
            if n == 0:
                return
            yield buf[:n]

    def stats(self) -> Optional[dict]:
        """Ingest-overlap attribution: blocks delivered plus how often
        each side of the ring waited on the other (consumer_waits ->
        disk-bound, producer_waits -> compute-bound).  None once
        closed."""
        if not self._h:
            return None
        out = (ctypes.c_int64 * 3)()
        self._lib.pt_feeder_stats(self._h, out)
        return {"blocks": int(out[0]),
                "consumer_waits": int(out[1]),
                "producer_waits": int(out[2])}

    def close(self) -> None:
        if self._h:
            self._lib.pt_feeder_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
