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


def _kernel_passes(x, log2n):
    """The CUDA kernel's Stockham passes, in numpy: pass p (radix R,
    Ns = 16^p) takes butterfly j's inputs x[j + r n/R], multiplies input
    r by w^r (w from the kernel's twiddle table at j mod Ns, powers by
    repeated complex64 products), takes the inverse DFT-R and writes
    output s at (j // Ns) Ns R + j mod Ns + s Ns."""
    n = 1 << log2n
    rad = build_cuda._radices(log2n)
    tw = build_cuda._twiddle_table(n, "cpu").numpy()
    toff, ns = 0, 1
    for p, R in enumerate(rad):
        j = np.arange(n // R)
        v = x[j[:, None] + np.arange(R)[None, :] * (n // R)]
        if p:
            w = tw[toff + j % ns]
            wr = w.copy()
            for r in range(1, R):
                v[:, r] *= wr
                wr = (wr * w).astype(np.complex64)
            toff += ns
        dftm = np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        y = (v @ dftm.astype(np.complex64)).astype(np.complex64)
        out = np.empty(n, np.complex64)
        base = (j // ns) * ns * R + j % ns
        out[base[:, None] + np.arange(R)[None, :] * ns] = y
        x, ns = out, ns * R
    return x / n


@pytest.mark.parametrize("log2n", range(build_cuda.LOG2N_MIN,
                                        build_cuda.LOG2N_MAX + 1))
def test_kernel_fft_decomposition_matches_ifft(log2n):
    """The radices and twiddle table the kernel is built on give the
    inverse FFT (1/n inside) to float32 rounding."""
    rng = np.random.default_rng(log2n)
    n = 1 << log2n
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    assert np.prod(build_cuda._radices(log2n)) == n
    got = _kernel_passes(x, log2n)
    want = np.fft.ifft(x.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
