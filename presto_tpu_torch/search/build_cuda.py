"""F-Fdot plane build: the CUDA kernel and its plain PyTorch version.

Counterpart of ``presto_tpu/search/build_pallas.py`` (the Pallas kernel
``make_plane_builder`` -> ``build``).  The kernel source is
``presto_tpu_torch/csrc/plane_build.cu``.

Inputs are in natural order (the port's forward FFT produces them so),
not the TPU's stage layout:

    S   complex64 [nblocks, n/2]   forward spectra of the normalized
                                   block windows (the FFT of the x2-spread
                                   window is this tiled twice)
    Kc  complex64 [numz, n]        conjugated FFT'd z-response bank

and the output is the plane layout of the JAX package's direct-plane
builder: float32 [numz_pad, nb_pad * uselen], block b's good window
[off, off + uselen) of |IFFT(S_b * Kc_z)|^2 (1/n inside the IFFT) in
columns [b*uselen, (b+1)*uselen).  Pad rows and pad blocks are 0.

The kernel is instantiated for n = 2^8 .. 2^14 (a register-resident
radix-16 Stockham FFT, one template per log2 n); any other n raises.
It takes the twiddle bases of its passes from ``_twiddle_table``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from presto_tpu_torch import cuda_build

#: kernel launches made by build_plane (reset by callers that count)
launches = 0

#: the FFT lengths the kernel is instantiated for: 2^8 .. 2^14
LOG2N_MIN, LOG2N_MAX = 8, 14

_twiddles: dict = {}


def _radices(log2n: int) -> list:
    """The kernel's passes: radix 16, then the remaining 2, 4 or 8."""
    return [16] * (log2n // 4) + ([1 << (log2n % 4)] if log2n % 4 else [])


def _twiddle_table(n: int, device) -> torch.Tensor:
    """The kernel's twiddle bases, from float64, as complex64: for each
    pass p >= 1 (radix R_p, Ns = 16^p), exp(+2 pi i m / (Ns R_p)) for
    m < Ns, the passes one after another."""
    key = (n, str(device))
    tw = _twiddles.get(key)
    if tw is None:
        rad = _radices(n.bit_length() - 1)
        parts = []
        for p in range(1, len(rad)):
            ns = 16 ** p
            m = torch.arange(ns, dtype=torch.float64)
            parts.append(torch.polar(torch.ones_like(m),
                                     2.0 * math.pi * m / (ns * rad[p])))
        tw = torch.cat(parts).to(torch.complex64).to(device)
        _twiddles[key] = tw
    return tw


def build_plane_plain(S: torch.Tensor, Kc: torch.Tensor, numz_pad: int,
                      nb_pad: int, uselen: int, off: int,
                      budget_bytes: int = 1 << 30) -> torch.Tensor:
    """The plain version: torch.fft.ifft of the product, |.|^2, the good
    window, the plane layout.  Blocks go in chunks whose complex product
    stays under ``budget_bytes``."""
    nblocks = S.shape[0]
    numz, n = Kc.shape
    plane = torch.zeros((numz_pad, nb_pad, uselen), dtype=torch.float32,
                        device=S.device)
    step = max(1, budget_bytes // (numz * n * 8))
    for b0 in range(0, nblocks, step):
        Sb = S[b0:b0 + step]
        prod = torch.cat([Sb, Sb], dim=-1)[:, None, :] * Kc[None]
        corr = torch.fft.ifft(prod, dim=-1)[..., off:off + uselen]
        pw = corr.real ** 2 + corr.imag ** 2            # [b, numz, use]
        plane[:numz, b0:b0 + Sb.shape[0]] = pw.transpose(0, 1)
    return plane.reshape(numz_pad, nb_pad * uselen)


def build_plane(S: torch.Tensor, Kc: torch.Tensor, numz_pad: int,
                nb_pad: int, uselen: int, off: int) -> torch.Tensor:
    """The plane (see the module docstring).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if S.device.type == "cpu" and Kc.device.type == "cpu":
        return build_plane_plain(S, Kc, numz_pad, nb_pad, uselen, off)
    nblocks, half_n = S.shape
    numz, n = Kc.shape
    if S.device.type != "cuda" or Kc.device != S.device:
        raise ValueError("build_plane: S and Kc must be on one CUDA "
                         "device (got %s, %s)" % (S.device, Kc.device))
    if S.dtype != torch.complex64 or Kc.dtype != torch.complex64:
        raise TypeError("build_plane: S and Kc must be complex64")
    if not (S.is_contiguous() and Kc.is_contiguous()) or (
            S.is_conj() or Kc.is_conj()):
        raise ValueError("build_plane: inputs must be contiguous, with "
                         "no lazy conjugate bit")
    log2n = n.bit_length() - 1
    if (n != 1 << log2n or half_n * 2 != n
            or not LOG2N_MIN <= log2n <= LOG2N_MAX
            or numz > numz_pad or nblocks > nb_pad
            or off < 0 or off + uselen > n):
        raise ValueError("build_plane: unsupported geometry (n=%d, "
                         "S=%s, numz=%d/%d, nblocks=%d/%d, off=%d, "
                         "uselen=%d)" % (n, tuple(S.shape), numz, numz_pad,
                                         nblocks, nb_pad, off, uselen))
    lib = cuda_build.load("plane_build")
    fn = lib.plane_build
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    tw = _twiddle_table(n, S.device)
    plane = torch.empty((numz_pad, nb_pad * uselen), dtype=torch.float32,
                        device=S.device)
    global launches
    launches += 1
    rc = fn(S.data_ptr(), Kc.data_ptr(), tw.data_ptr(), plane.data_ptr(),
            nblocks, nb_pad, numz, numz_pad, log2n, uselen, off,
            torch.cuda.current_stream(S.device).cuda_stream)
    cuda_build.check(rc, "plane_build")
    return plane
