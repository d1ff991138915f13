"""Packed real FFT with PRESTO's layout, through ``torch.fft``.

PyTorch counterpart of ``presto_tpu/ops/fftpack.py`` (realfft_packed,
realfft_packed_pairs).  The reference's realfft (src/fastffts.c:198-270)
is unnormalized with the e^{-2πi} convention and stores n/2 complex
values with bin 0 holding (DC, Nyquist).  Spectra travel as float32
[..., n//2, 2] pairs, the JAX package's boundary format.
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


def realfft_packed_pairs(x: torch.Tensor) -> torch.Tensor:
    """realfft_packed as float32 pairs [..., n//2, 2]."""
    return torch.view_as_real(realfft_packed(x)).contiguous()


def np_pairs_to_complex64(p: np.ndarray) -> np.ndarray:
    """Host-side: [..., n, 2] float32 -> complex64 (for .fft files)."""
    return np.ascontiguousarray(p[..., 0] + 1j * p[..., 1]).astype(
        np.complex64)


def np_complex64_to_pairs(z: np.ndarray) -> np.ndarray:
    """Host-side inverse of np_pairs_to_complex64."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
