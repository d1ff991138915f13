"""The port's realfft (apps/realfft.py, ops/fftpack's inverse half,
ops/oocfft) against the JAX package's, on the CPU.

Tolerances.  In core the two packages' FFTs round differently: the
packed layout is exact (n/2 complex bins, bin 0 = DC + i Nyquist, the
same .inf) and every value agrees within rtol 1e-5 of the spectrum's
RMS (forward) or of the series' RMS (inverse).  A length that is not
7-smooth (the JAX CLI sends it through host pocketfft, the port through
torch.fft like any other) is held to the same bound.  Out of core both
packages run the same host two-pass code: the -disk files are
byte-equal.  The round trip returns the series within rtol 1e-5 of its
RMS.
"""

import os

import numpy as np
import pytest
import torch

from presto_tpu.apps import realfft as japp
from presto_tpu.io.infodata import InfoData, write_inf
from presto_tpu.ops import fftpack as jfft
from presto_tpu.ops import oocfft as jooc
from presto_tpu.utils.psr import _is_smooth
from presto_tpu_torch.apps import realfft as tapp
from presto_tpu_torch.io import datfft
from presto_tpu_torch.ops import fftpack as tfft
from presto_tpu_torch.ops import oocfft as tooc

RTOL = 1e-5


def _series(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (rng.normal(size=n) + 3.0 + 2.0 * np.sin(0.0123 * t)
            ).astype(np.float32)


def _write(d, name, x):
    base = os.path.join(d, name)
    x.tofile(base + ".dat")
    write_inf(InfoData(name=name, N=float(x.size), dt=1e-4,
                       telescope="GBT", object="X", mjd_i=59000,
                       mjd_f=0.5), base + ".inf")
    return base


def _both(tmp_path, name, x, argv_extra=(), ext=".dat"):
    """Run the JAX CLI and the port's on copies of one file; returns
    ({file: bytes} JAX, {file: bytes} port)."""
    out = {}
    for side, main in (("j", japp.main),
                       ("t", lambda a: tapp.main(a, device="cpu"))):
        d = str(tmp_path / side)
        os.makedirs(d, exist_ok=True)
        base = _write(d, name, x)
        if ext == ".fft":
            main(["-fwd", "-disk", base + ".dat"])
            os.remove(base + ".dat")
        main(list(argv_extra) + [base + ext])
        out[side] = {f: open(os.path.join(d, f), "rb").read()
                     for f in sorted(os.listdir(d))}
    return out["j"], out["t"]


def _close(got, want):
    scale = float(np.sqrt(np.mean(np.abs(want.astype(np.complex128)) ** 2)))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.max(np.abs(got.astype(np.complex128) - want)) <= RTOL * scale


@pytest.mark.parametrize("n", [1 << 14, 3 * 5 * 7 * 64, 20014],
                         ids=["pow2", "smooth", "prime_half"])
def test_in_core_forward_equals_jax(tmp_path, n):
    """n = 20014 = 2 x 10007: the JAX CLI takes its host branch."""
    assert _is_smooth(n) == (n != 20014)
    want, got = _both(tmp_path, "x", _series(n, n))
    assert sorted(got) == sorted(want) == ["x.dat", "x.fft", "x.inf"]
    assert got["x.inf"] == want["x.inf"]
    a = np.frombuffer(got["x.fft"], np.complex64)
    b = np.frombuffer(want["x.fft"], np.complex64)
    _close(a, b)
    x = _series(n, n).astype(np.float64)
    # the packed layout: bin 0 holds (DC, Nyquist)
    assert a[0].real == pytest.approx(x.sum(), rel=1e-5)
    assert a[0].imag == pytest.approx((x * (-1.0) ** np.arange(n)).sum(),
                                      abs=1e-5 * abs(a).max())


@pytest.mark.parametrize("n", [1 << 14, 20014], ids=["pow2", "prime_half"])
def test_in_core_inverse_equals_jax(tmp_path, n):
    x = _series(n, 7 + n)
    want, got = _both(tmp_path, "y", x, ["-inv", "-mem"], ext=".fft")
    a = np.frombuffer(got["y.dat"], np.float32)
    b = np.frombuffer(want["y.dat"], np.float32)
    _close(a, b)
    _close(a, x)


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_disk_equals_jax_bytes(tmp_path, direction):
    x = _series(1 << 13, 5)
    if direction == "fwd":
        want, got = _both(tmp_path, "z", x, ["-disk"])
    else:
        want, got = _both(tmp_path, "z", x, ["-inv", "-disk"], ext=".fft")
    assert got == want


@pytest.mark.parametrize("max_mem", [1 << 12, 1 << 16])
def test_ooc_equals_jax_in_small_blocks(tmp_path, max_mem):
    """Many passes (a 4 kB block buffer) or few: the bytes of the JAX
    package's oocfft either way, and the in-core spectrum within the
    bound.  The port reports the geometry that ran: 6144 complex points
    split 64 x 96, and the slabs of each pass."""
    x = _series(3 * (1 << 12), 9)
    src = str(tmp_path / "s.dat")
    x.tofile(src)
    for mod, out in ((jooc, "j.fft"), (tooc, "t.fft")):
        ran = mod.realfft_ooc(src, str(tmp_path / out), forward=True,
                              max_mem=max_mem, tmpdir=str(tmp_path))
    assert ran == dict(split=(64, 96), max_mem=max_mem,
                       slabs={1 << 12: (48, 64), 1 << 16: (3, 4)}[max_mem])
    got = np.fromfile(str(tmp_path / "t.fft"), np.complex64)
    assert got.tobytes() == open(str(tmp_path / "j.fft"), "rb").read()
    _close(got, tfft.realfft_packed(torch.as_tensor(x)).numpy())


def test_crossover_sends_long_series_to_disk(tmp_path, monkeypatch):
    """Past MAXREALFFT floats the CLI takes the out-of-core path (the
    JAX package's bytes); -mem keeps it in core."""
    x = _series(1 << 12, 3)
    monkeypatch.setattr(jooc, "MAXREALFFT", 1000)
    monkeypatch.setattr(tooc, "MAXREALFFT", 1000)
    want, got = _both(tmp_path, "c", x)
    assert got == want
    base = _write(str(tmp_path), "m", x)
    tapp.main(["-mem", base + ".dat"], device="cpu")
    _close(datfft.read_fft(base + ".fft"), datfft.read_fft(
        str(tmp_path / "t" / "c.fft")))


def test_round_trip_outdir_and_delete(tmp_path):
    x = _series(6000, 11)
    base = _write(str(tmp_path), "r", x)
    out = str(tmp_path / "out")
    os.makedirs(out)
    assert tapp.main(["-outdir", out, "-del", base + ".dat"],
                     device="cpu") == 0
    assert not os.path.exists(base + ".dat")
    tapp.main(["-inv", os.path.join(out, "r.fft")], device="cpu")
    back = datfft.read_dat(os.path.join(out, "r.dat"))
    _close(back, x)
    assert open(os.path.join(out, "r.inf")).read() == \
        open(base + ".inf").read()


@pytest.mark.parametrize("n", [1 << 10, 998])
def test_fftpack_inverse_half_equals_jax(n):
    """irealfft_packed(_pairs) and the complex/pairs helpers against the
    JAX package's."""
    x = _series(n, n)
    packed = tfft.realfft_packed(torch.as_tensor(x))
    jpacked = np.asarray(jfft.realfft_packed(x))
    _close(packed.numpy(), jpacked)
    _close(tfft.irealfft_packed(packed).numpy(),
           np.asarray(jfft.irealfft_packed(jpacked)))
    pairs = tfft.complex_to_pairs(packed)
    assert torch.equal(tfft.pairs_to_complex(pairs), packed)
    _close(tfft.irealfft_packed_pairs(pairs).numpy(), x)


def test_realfft_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = _write(str(tmp_path), "d", _series(64, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.main([base + ".dat"])
    assert not os.path.exists(base + ".fft")
