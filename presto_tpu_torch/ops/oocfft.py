"""Out-of-core two-pass FFT over disk scratch (twopass*.c parity).

Host copy of ``presto_tpu/ops/oocfft.py`` for the PyTorch port, which
imports nothing from the JAX package.

The reference diverts real FFTs longer than MAXREALFFT = 1e9 floats
(include/meminfo.h:4, src/realfft.c:179) to a two-pass disk FFT
(src/twopass_real_fwd.c:10, src/twopass.c:22): pass 1 runs blocked
column FFTs with a transpose into scratch, pass 2 applies twiddles and
row FFTs.  This module rebuilds that capability for series that fit
neither host RAM nor the card's memory (apps/realfft takes it past
MAXREALFFT floats, or with -disk).

Decomposition (four-step, N = R*C, input viewed as a row-major [R][C]
matrix M[r][c] = x[r*C + c]; output index split k = k1 + R*k2):

    X[k1 + R*k2] = sum_c e^{-2 pi i c k2 / C}
        [ e^{-2 pi i c k1 / N} sum_r M[r][c] e^{-2 pi i r k1 / R} ]

  pass 1: slabs of input columns (strided page-sized reads) - FFT of
          length R down each column, multiply by the twiddle
          e^{-2 pi i c k1 / N}, write the slab TRANSPOSED to scratch
          T[c][k1] (contiguous writes);
  pass 2: slabs of scratch columns k1 (strided reads) - FFT of length
          C down each (the c axis), write to the output viewed as
          O[k2][k1]: element (k2, k1) sits at offset k2*R + k1 = k,
          so the result lands in natural order with no final pass.

Every strided slab access moves >= slab-width contiguous elements per
row, so with slabs of a few hundred columns all disk traffic stays
page-sized (the role of the reference's find_blocksize, twopass.c:8).

The real FFT rides on the half-length complex FFT exactly like the
reference's packed format (src/fastffts.c:198-270): the float32 .dat
bytes ARE the interleaved complex64 input (even samples = Re, odd =
Im), so step 1 is a free reinterpret-cast of the memmap; a final
blocked separation pass converts Z[k] into the packed spectrum
out[k] = rfft(x)[k] with out[0] = (DC, Nyquist).

Everything streams through numpy memmaps in `max_mem`-byte blocks; no
array of size N is ever resident.  This path is host-side by design:
it is disk-bound, and its output bytes equal the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

# In-core -> out-of-core crossover (floats), the MAXREALFFT analog
# (include/meminfo.h:4).  A module constant: there is no environment
# override (tests set it on the module).
MAXREALFFT = 10 ** 9

_DEF_MAX_MEM = 1 << 28          # 256 MB of block buffer by default


def _resolve_max_mem(max_mem):
    """The block-buffer byte budget: an explicit caller value wins;
    None consults the tuning DB's `oocfft_block` entry when tuning is
    active (presto_tpu_torch/tune), else the built-in default.  The block
    size only partitions the streamed passes — every element's
    arithmetic is identical in any partition, so tuned and untuned
    spectra are byte-equal."""
    if max_mem is not None:
        return int(max_mem)
    from presto_tpu_torch import tune
    if tune.enabled():
        cfg = tune.best("oocfft_block", tune.GLOBAL_KEY)
        if cfg:
            try:
                m = int(cfg.get("max_mem", 0))
                if m >= 1 << 16:      # refuse degenerate tiny blocks
                    return m
            except (TypeError, ValueError):
                pass
    return _DEF_MAX_MEM


def _split_n(n: int) -> tuple[int, int]:
    """Factor n = R * C with R the largest divisor <= sqrt(n)
    (pocketfft handles any factor lengths).  For prime n this
    degenerates to R = 1: pass 2 then performs one full-length FFT —
    correct, though no longer memory-bounded (the reference sidesteps
    this by only FFT'ing good_factor lengths; choose_N-padded data
    never hits it)."""
    if n < 2:
        raise ValueError("out-of-core FFT needs n >= 2 (got %d)" % n)
    r = int(np.sqrt(n))
    while r > 1 and n % r:
        r -= 1
    if r == 1 and n > (1 << 22):
        import warnings
        warnings.warn(
            "out-of-core FFT of prime length %d degenerates to one "
            "full-length in-memory FFT (~%d MB resident) — pad to a "
            "factorable length (choose_N) to keep it streaming" %
            (n, 16 * n >> 20), RuntimeWarning, stacklevel=3)
    return r, n // r


def ooc_complex_fft(src_path: str, dst_path: str, n: int,
                    forward: bool = True,
                    max_mem: int | None = None,
                    scratch_path: str | None = None) -> dict:
    """Out-of-core complex64 FFT of an n-point file.

    forward=True: unnormalized e^{-2 pi i} transform (numpy fft).
    forward=False: normalized inverse (numpy ifft).
    src and dst may be the same path (scratch holds the intermediate).
    Returns the geometry that ran: the split (R, C), the slabs of each
    pass and the block buffer's bytes.
    """
    max_mem = _resolve_max_mem(max_mem)
    R, C = _split_n(n)
    scratch = scratch_path or (dst_path + ".scratch")
    sgn = -1.0 if forward else 1.0
    xform = np.fft.fft if forward else np.fft.ifft

    # pass 1: column FFTs (length R) + twiddle -> scratch T[c][k1]
    src = np.memmap(src_path, dtype=np.complex64, mode="r", shape=(R, C))
    mid = np.memmap(scratch, dtype=np.complex64, mode="w+", shape=(C, R))
    cb = max(1, int(max_mem // (R * 16 * 2)))
    k1 = np.arange(R)[:, None]
    for c0 in range(0, C, cb):
        c1 = min(c0 + cb, C)
        block = xform(np.asarray(src[:, c0:c1]).astype(np.complex128),
                      axis=0)                              # [R, cb]
        cs = np.arange(c0, c1)[None, :]
        block *= np.exp((sgn * 2j * np.pi / n) * k1 * cs)
        mid[c0:c1, :] = block.T.astype(np.complex64)
    mid.flush()
    del src, mid
    slabs1 = -(-C // cb)

    # pass 2: FFTs of length C down the c axis; output element
    # (k2, k1) of O[C][R] sits at offset k2*R + k1 = k: natural order
    mid = np.memmap(scratch, dtype=np.complex64, mode="r", shape=(C, R))
    dst = np.memmap(dst_path, dtype=np.complex64,
                    mode="r+" if (os.path.exists(dst_path) and
                                  os.path.getsize(dst_path) == 8 * n)
                    else "w+",
                    shape=(C, R))
    kb = max(1, int(max_mem // (C * 16 * 2)))
    for j0 in range(0, R, kb):
        j1 = min(j0 + kb, R)
        cols = xform(np.asarray(mid[:, j0:j1]).astype(np.complex128),
                     axis=0)                               # [C, kb]
        dst[:, j0:j1] = cols.astype(np.complex64)
    dst.flush()
    del mid, dst
    os.remove(scratch)
    return dict(split=(R, C), slabs=(slabs1, -(-R // kb)), max_mem=max_mem)


def _real_fixup_forward(path: str, nc: int, max_mem: int) -> None:
    """Blocked separation pass: Z[k] (half-length complex FFT of the
    interleaved series) -> packed real spectrum in place.

    F[k] = E[k] + W^k O[k], E = (Z[k]+conj(Z[nc-k]))/2,
    O = (Z[k]-conj(Z[nc-k]))/(2i), W = e^{-2 pi i / (2 nc)};
    F[nc-k] = conj(E[k] - W^k O[k]).  Element 0 -> (DC, Nyquist).
    """
    zf = np.memmap(path, dtype=np.complex64, mode="r+", shape=(nc,))
    z0 = complex(zf[0])
    zf[0] = np.complex64(complex(z0.real + z0.imag, z0.real - z0.imag))
    bs = max(1, int(max_mem // (8 * 6)))
    half = nc // 2
    for a in range(1, half + 1, bs):
        b = min(a + bs, half + 1)
        front = np.asarray(zf[a:b]).astype(np.complex128)       # k in [a,b)
        back = np.asarray(zf[nc - b + 1:nc - a + 1]).astype(np.complex128)
        backr = np.conj(back[::-1])                              # Z*[nc-k]
        k = np.arange(a, b)
        e = 0.5 * (front + backr)
        o = -0.5j * (front - backr)
        w = np.exp(-1j * np.pi * k / nc)                         # W^k
        fk = e + w * o
        fmk = np.conj(e - w * o)                                 # F[nc-k]
        zf[a:b] = fk.astype(np.complex64)
        # mirror write; k = nc-k overlap (k = half when nc even) is
        # written twice with identical values
        zf[nc - b + 1:nc - a + 1] = fmk[::-1].astype(np.complex64)
    zf.flush()
    del zf


def _real_fixup_inverse(path: str, nc: int, max_mem: int) -> None:
    """Inverse separation: packed spectrum -> Z[k] in place, so a
    normalized inverse complex FFT yields the interleaved series."""
    pf = np.memmap(path, dtype=np.complex64, mode="r+", shape=(nc,))
    p0 = complex(pf[0])
    f0, fnyq = p0.real, p0.imag
    pf[0] = np.complex64(complex(0.5 * (f0 + fnyq), 0.5 * (f0 - fnyq)))
    bs = max(1, int(max_mem // (8 * 6)))
    half = nc // 2
    for a in range(1, half + 1, bs):
        b = min(a + bs, half + 1)
        front = np.asarray(pf[a:b]).astype(np.complex128)        # F[k]
        back = np.asarray(pf[nc - b + 1:nc - a + 1]).astype(np.complex128)
        backr = np.conj(back[::-1])                              # F*[nc-k]
        k = np.arange(a, b)
        e = 0.5 * (front + backr)
        wo = 0.5 * (front - backr)                               # W^k O[k]
        o = np.exp(1j * np.pi * k / nc) * wo
        zk = e + 1j * o
        zmk = np.conj(e) + 1j * np.conj(o)                       # Z[nc-k]
        pf[a:b] = zk.astype(np.complex64)
        pf[nc - b + 1:nc - a + 1] = zmk[::-1].astype(np.complex64)
    pf.flush()
    del pf


def realfft_ooc(src_path: str, dst_path: str, forward: bool = True,
                max_mem: int | None = None,
                tmpdir: str | None = None) -> dict:
    """Out-of-core packed real FFT: .dat (float32[n]) <-> .fft
    (packed complex64[n/2]), matching fftpack.realfft_packed /
    irealfft_packed to float32 tolerance.

    forward: reinterpret the float32 file as complex64 (free), run the
    two-pass complex FFT into dst, then the blocked separation pass.
    inverse: copy src -> dst, inverse-separate in place, inverse
    two-pass FFT in place; dst bytes are then the float32 series.
    Returns the two-pass geometry that ran (ooc_complex_fft's).
    """
    max_mem = _resolve_max_mem(max_mem)
    scratch = None
    if tmpdir:
        scratch = os.path.join(
            tmpdir, os.path.basename(dst_path) + ".scratch")
    if forward:
        nbytes = os.path.getsize(src_path)
        n = (nbytes // 4) & ~1
        nc = n // 2
        ran = ooc_complex_fft(src_path, dst_path, nc, forward=True,
                              max_mem=max_mem, scratch_path=scratch)
        _real_fixup_forward(dst_path, nc, max_mem)
    else:
        nbytes = os.path.getsize(src_path)
        nc = nbytes // 8
        tmp = (os.path.join(tmpdir, os.path.basename(dst_path) + ".zfile")
               if tmpdir else dst_path + ".zfile")
        # copy packed spectrum (blocked) then work in place
        with open(src_path, "rb") as fi, open(tmp, "wb") as fo:
            while True:
                chunk = fi.read(max_mem)
                if not chunk:
                    break
                fo.write(chunk)
        _real_fixup_inverse(tmp, nc, max_mem)
        ran = ooc_complex_fft(tmp, dst_path, nc, forward=False,
                              max_mem=max_mem, scratch_path=scratch)
        os.remove(tmp)
    return ran
