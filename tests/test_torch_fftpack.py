"""The port's packed real FFT against the JAX package's.

The packed layout (DC in the real part of bin 0, Nyquist in its
imaginary part) must match exactly; values agree within rtol 1e-5 of
the spectrum's RMS amplitude, since pocketfft (torch) and XLA's FFT
round differently.
"""

import numpy as np
import pytest
import torch

from presto_tpu.ops import fftpack as jfft
from presto_tpu_torch.ops import fftpack as tfft


@pytest.mark.parametrize("n", [1 << 12, 6000])
def test_realfft_packed_pairs_matches(n):
    rng = np.random.default_rng(n)
    x = rng.normal(5.0, 2.0, (3, n)).astype(np.float32)
    want = np.asarray(jfft.realfft_packed_pairs(x))
    got = tfft.realfft_packed_pairs(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, n // 2, 2)
    assert got.dtype == np.float32
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * rms)


def test_packed_layout_round_trips():
    """Bin 0 is (DC, Nyquist); the port's spectrum goes back to the
    series through the JAX package's inverse."""
    rng = np.random.default_rng(7)
    n = 1 << 10
    x = rng.normal(size=n).astype(np.float32)
    got = tfft.realfft_packed(torch.from_numpy(x)).numpy()
    full = np.fft.rfft(x.astype(np.float64))
    assert abs(got[0].real - full[0].real) < 1e-3
    assert abs(got[0].imag - full[-1].real) < 1e-3
    back = np.asarray(jfft.irealfft_packed(got, scale=False)) / n
    np.testing.assert_allclose(back, x, atol=1e-5)
