"""Packed real FFT with PRESTO's layout, through ``torch.fft``.

PyTorch counterpart of ``presto_tpu/ops/fftpack.py``.  The reference's
realfft (src/fastffts.c:198-270) is unnormalized with the e^{-2πi}
convention and stores n/2 complex values with bin 0 holding (DC,
Nyquist); its inverse (isign=+1) returns the series itself.  Spectra
travel as float32 [..., n//2, 2] pairs, the JAX package's boundary
format.  Every transform runs through ``torch.fft`` on the tensor's
device, at any length (cuFFT takes any n; the JAX package's realfft CLI
sends lengths that are not 7-smooth to the host instead).
"""

from __future__ import annotations

import numpy as np
import torch


def realfft_packed(x: torch.Tensor) -> torch.Tensor:
    """Forward packed real FFT of float32 series [..., n] (n even) ->
    complex64 [..., n//2]: out[0] = DC + 1j*Nyquist, out[k] = rfft[k]."""
    full = torch.fft.rfft(x)                        # [..., n//2 + 1]
    packed0 = torch.complex(full[..., 0].real, full[..., -1].real)
    return torch.cat([packed0[..., None], full[..., 1:-1]],
                     dim=-1).to(torch.complex64)


def irealfft_packed(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of realfft_packed: complex [..., n//2] -> float32 [..., n],
    the series itself (the reference's isign=+1 path)."""
    n2 = packed.shape[-1]
    dc = torch.complex(packed[..., 0].real,
                       torch.zeros_like(packed[..., 0].real))
    nyq = torch.complex(packed[..., 0].imag,
                        torch.zeros_like(packed[..., 0].imag))
    full = torch.cat([dc[..., None], packed[..., 1:], nyq[..., None]],
                     dim=-1)
    return torch.fft.irfft(full, n=2 * n2).to(torch.float32)


def complex_to_pairs(z: torch.Tensor) -> torch.Tensor:
    """[...] complex -> [..., 2] float32."""
    return torch.view_as_real(z.to(torch.complex64)).contiguous()


def pairs_to_complex(p: torch.Tensor) -> torch.Tensor:
    """[..., 2] float32 -> [...] complex64."""
    return torch.view_as_complex(p.to(torch.float32).contiguous())


def realfft_packed_pairs(x: torch.Tensor) -> torch.Tensor:
    """realfft_packed as float32 pairs [..., n//2, 2]."""
    return complex_to_pairs(realfft_packed(x))


def irealfft_packed_pairs(p: torch.Tensor) -> torch.Tensor:
    """Inverse of realfft_packed_pairs ([..., n//2, 2] float32 -> x)."""
    return irealfft_packed(pairs_to_complex(p))


def np_pairs_to_complex64(p: np.ndarray) -> np.ndarray:
    """Host-side: [..., n, 2] float32 -> complex64 (for .fft files)."""
    return np.ascontiguousarray(p[..., 0] + 1j * p[..., 1]).astype(
        np.complex64)


def np_complex64_to_pairs(z: np.ndarray) -> np.ndarray:
    """Host-side inverse of np_pairs_to_complex64."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
