"""The port's plane builder against the Pallas plane builder.

The same block windows go through presto_tpu.search.build_pallas (in
interpret mode, fed the JAX package's stage-layout spectra) and through
presto_tpu_torch.search.build_cuda (its plain version on the CPU, fed
natural-order spectra from torch.fft).  Tolerance rtol/atol 2e-4: the
two forward transforms and inverse transforms round differently (the
Pallas kernel's factored DFT vs an FFT).  Pad rows and pad blocks are
exactly zero.
"""

import numpy as np
import pytest
import torch

from presto_tpu.search import accel as jaccel
from presto_tpu.search import build_pallas as bp
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import build_cuda


def _setup(B):
    import jax.numpy as jnp
    cfg = jaccel.AccelConfig(zmax=20, numharm=2, uselen=1024)
    kern = jaccel.AccelKernels.build(cfg)
    fftlen, numz = kern.fftlen, cfg.numz
    hw_eff = -(-kern.halfwidth // 64) * 64
    off = 2 * hw_eff
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(B, fftlen // 2))
            + 1j * rng.normal(size=(B, fftlen // 2))).astype(np.complex64)
    kc = jaccel._fft_kernel_bank_c(jnp.asarray(kern.kern_pairs), fftlen)
    return cfg, kern, data, kc, off


@pytest.mark.parametrize("B", [8, 9])
def test_plane_builder_matches_pallas(B):
    import jax.numpy as jnp
    cfg, kern, data, kc, off = _setup(B)
    fftlen, numz, uselen = kern.fftlen, cfg.numz, cfg.uselen
    kz = jaccel._kern_bank_z(kc, fftlen)
    consts = tuple(map(jnp.asarray, jaccel._dft_consts_np(fftlen)))
    Sr, Si = jaccel._fwd_stage_mxu(jnp.asarray(data), consts, fftlen)
    nb_pad = -(-B // bp.BB) * bp.BB
    numz_pad = -(-numz // bp.ZT) * bp.ZT
    bpad = ((0, nb_pad - B), (0, 0), (0, 0))
    zpad = ((0, numz_pad - numz), (0, 0), (0, 0))
    build = bp.make_plane_builder(numz, B, fftlen, uselen, off,
                                  interpret=True)
    want = np.asarray(build(
        jnp.pad(Sr, bpad), jnp.pad(Si, bpad),
        jnp.pad(kz.real.astype(jnp.float32), zpad),
        jnp.pad(kz.imag.astype(jnp.float32), zpad))).reshape(
            numz_pad, nb_pad * uselen)

    S = torch.fft.fft(torch.from_numpy(data), dim=-1)
    Kc = taccel.fft_kernel_bank(kern.kern_pairs, fftlen, "cpu")
    assert taccel.ROW_PAD == bp.ZT and taccel.BLOCK_PAD == bp.BB
    before = build_cuda.launches
    got = build_cuda.build_plane(S, Kc, numz_pad, nb_pad, uselen,
                                 off).numpy()
    assert build_cuda.launches == before      # CPU: the plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert not got[:, B * uselen:].any()
    assert not got[numz:].any()


def test_kernel_bank_matches_jax():
    """The port's conjugated bank equals conj of the JAX device bank
    (both complex64 FFTs of the same placed kernels)."""
    cfg, kern, _data, kc, _off = _setup(1)
    got = taccel.fft_kernel_bank(kern.kern_pairs, kern.fftlen,
                                 "cpu").numpy()
    want = np.conj(np.asarray(kc))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
