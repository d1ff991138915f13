"""The port's binary responses (ops/responses), orbital matched filter
(search/bincand), .mak files (io/makfile) and bincand CLI against the JAX
package's, on the CPU.

Tolerances.  The binary responses are host float64 NumPy in both
packages, the same operations: byte-equal (the port's batched templates
run their chunks on host threads).  The
correlation runs in complex64 through two FFT libraries: its powers
agree within rtol 1e-4 of the largest and the argmax lags are equal.
optimize_bincand picks the same grid orbit in every round (the grid
points are host float64, so the orbit is equal) with its power within
rtol 1e-4.  Each bincand trial source gives the JAX CLI's (ppsr,
OrbitParams) exactly.
"""

import os

import numpy as np
import pytest
import torch

from presto_tpu.apps import bincand as japp
from presto_tpu.io import makfile as jmak
from presto_tpu.ops import responses as jresp
from presto_tpu.ops.orbit import OrbitParams as JOrbit
from presto_tpu.search import bincand as jb
from presto_tpu_torch.apps import bincand as tapp
from presto_tpu_torch.io import datfft, makfile as tmak
from presto_tpu_torch.io.infodata import InfoData, write_inf
from presto_tpu_torch.ops import responses as tresp
from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays
from presto_tpu_torch.search import bincand as tb
from presto_tpu_torch.search.phasemod import RawBinCand, write_bincands

CORR_RTOL = 1e-4

ORBITS = {
    "circular_long": dict(p=60000.0, e=0.0, x=1.0, w=0.0, t=0.0),
    "circular_short": dict(p=900.0, e=0.0, x=0.35, w=0.0, t=123.0),
    "eccentric": dict(p=5000.0, e=0.4, x=0.8, w=70.0, t=1500.0),
}


def _orbits(name):
    return OrbitParams(**ORBITS[name]), JOrbit(**ORBITS[name])


@pytest.mark.parametrize("name", sorted(ORBITS))
def test_binary_responses_equal_jax(name):
    to, jo = _orbits(name)
    ppsr = 0.005
    for T in (2000.0, 100000.0):      # both binary_velocity branches
        assert tresp.binary_velocity(T, to) == jresp.binary_velocity(T, jo)
        assert tresp.bin_resp_halfwidth(ppsr, T, to) == \
            jresp.bin_resp_halfwidth(ppsr, T, jo)
    assert tresp.MIN_NUMDATA == jresp.MIN_NUMDATA
    T = 20000.0
    for numbetween, numkern, roff in ((1, 512, 0.0), (2, 1024, 0.3)):
        want = jresp.gen_bin_response(roff, numbetween, ppsr, T, jo, numkern)
        got = tresp.gen_bin_response(roff, numbetween, ppsr, T, to, numkern)
        assert got.dtype == want.dtype == np.complex128
        assert got.tobytes() == want.tobytes()
    grid_t = [OrbitParams(**dict(ORBITS[name], p=ORBITS[name]["p"] * f))
              for f in (0.99, 1.0, 1.01)]
    grid_j = [JOrbit(**o.__dict__) for o in grid_t]
    want = jresp.gen_bin_responses(grid_j, ppsr, T, 256, chunk=2)
    got = tresp.gen_bin_responses(grid_t, ppsr, T, 256, chunk=2)
    assert got.tobytes() == want.tobytes()


def test_gen_bin_response_zero_orbit_is_r_response():
    """x -> 0: the binary response degenerates to the sinc kernel
    (tests/test_orbit.py)."""
    orb = OrbitParams(p=10000.0, e=0.0, x=1e-9, w=0.0, t=0.0)
    resp = tresp.gen_bin_response(0.0, 2, 0.005, 100000.0, orb, 64)
    rresp = tresp.gen_r_response(0.0, 2, 64)
    np.testing.assert_allclose(np.abs(resp), np.abs(rresp), atol=2e-3)


def test_orbit_step_equals_jax():
    to, jo = _orbits("circular_short")
    for param in "pPxXewtT":
        assert tb.orbit_step(to, 0.02, param) == jb.orbit_step(jo, 0.02,
                                                               param)


@pytest.mark.parametrize("numkern,nseg", [(64, 256), (512, 2048)])
def test_corr_max_equals_jax(numkern, nseg):
    """The batched correlation on a noisy segment holding one template:
    every template's max power within CORR_RTOL of the largest, the lags
    equal, the planted template on top at its lag."""
    rng = np.random.default_rng(numkern)
    grid = [OrbitParams(p=900.0 * (1 + 0.01 * k), x=0.35, e=0.0, w=0.0,
                        t=50.0 * k) for k in range(-4, 5)]
    tmpl = tb._make_templates(grid, 0.02, 2000.0, numkern)
    assert tmpl.dtype == np.float32 and tmpl.shape == (9, numkern, 2)
    seg = rng.normal(size=(nseg, 2)).astype(np.float32)
    at = nseg // 3
    seg[at:at + numkern] += 6.0 * tmpl[4]
    fftlen = tresp.next_pow2(nseg + numkern)
    jp, ja = jb._corr_max(seg, tmpl, fftlen)
    tp, ta = tb._corr_max(torch.from_numpy(seg), torch.from_numpy(tmpl),
                          fftlen)
    jp, ja = np.asarray(jp), np.asarray(ja)
    assert np.abs(tp.numpy() - jp).max() <= CORR_RTOL * jp.max()
    assert (ta.numpy() == ja).all()
    assert int(np.argmax(tp.numpy())) == 4 and int(ta[4]) == at


def _binary_pairs(N, dt, ppsr, orb, amp, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N) * dt
    sig = amp * np.cos(2 * np.pi * (t - orbit_delays(t, orb)) / ppsr)
    spec = np.fft.rfft((sig + rng.normal(size=N)).astype(np.float32))[:-1]
    return np.stack([spec.real, spec.imag], -1).astype(np.float32)


@pytest.mark.parametrize("search_t", [False, True])
def test_optimize_bincand_equals_jax(search_t):
    """The JAX test's perturbed trial (tests/test_orbit.py): the same
    grid orbit, the power within CORR_RTOL, and the orbit recovered."""
    N, dt = (1 << 20, 2e-3) if not search_t else (1 << 18, 4e-3)
    ppsr, porb, x = 0.02, 900.0, 0.35
    pairs = _binary_pairs(N, dt, ppsr, OrbitParams(p=porb, x=x), 0.1, 0)
    kw = dict(nsteps=3 if not search_t else 1, rounds=2, search_t=search_t)
    want = jb.optimize_bincand(pairs, N, dt,
                               JOrbit(p=porb * 1.05, x=x * 0.8), ppsr, **kw)
    got = tb.optimize_bincand(pairs, N, dt,
                              OrbitParams(p=porb * 1.05, x=x * 0.8), ppsr,
                              device="cpu", **kw)
    assert got.orb.__dict__ == want.orb.__dict__
    assert got.r == want.r and got.ppsr == want.ppsr
    assert abs(got.power - want.power) <= CORR_RTOL * want.power
    assert abs(got.sigma - want.sigma) <= 1e-3 * max(want.sigma, 1.0)
    if not search_t:
        assert got.power > 10.0
        assert abs(got.orb.p - porb) / porb < 0.05
        assert abs(got.orb.x - x) / x < 0.25
        assert abs(got.r - N * dt / ppsr) < 150.0


def test_mak_files_equal_jax(tmp_path):
    """.mak files: the port writes the JAX package's bytes and reads its
    files (tests/test_makedata_fitsutils.py's round trip)."""
    mk = tmak.MakParams(N=4096, dt=1e-3, f=31.25, fdot=1e-6, amp=2.0,
                        orb_p=900.0, orb_x=0.35, orb_e=0.1, orb_w=30.0,
                        orb_t=12.5, onoff=[(0.0, 0.4), (0.6, 1.0)])
    pt, pj = str(tmp_path / "t.mak"), str(tmp_path / "j.mak")
    tmak.write_mak(pt, mk)
    jmak.write_mak(pj, jmak.MakParams(**mk.__dict__))
    assert open(pt, "rb").read() == open(pj, "rb").read()
    assert tmak.read_mak(pj).__dict__ == jmak.read_mak(pt).__dict__
    assert tmak.read_mak(pt) == mk
    with open(pj, "w") as f:
        f.write("Test fdot\nNum data pts      = 1000\n"
                "Pulse freq (hz)   = 12.5\n")
    assert tmak.read_mak(pj).__dict__ == jmak.read_mak(pj).__dict__


def _fft_files(d, N=1 << 16, dt=5e-3, mjd=55000.5):
    base = os.path.join(d, "b")
    pairs = _binary_pairs(N, dt, 0.02, OrbitParams(p=900.0, x=0.35), 0.2, 1)
    datfft.write_fft(base + ".fft", pairs[..., 0] + 1j * pairs[..., 1])
    write_inf(InfoData(name="b", N=float(N), dt=dt, mjd_i=int(mjd),
                       mjd_f=mjd % 1.0), base + ".inf")
    return base


SOURCES = {
    "explicit": ["-ppsr", "0.02", "-porb", "900", "-x", "0.3"],
    "plo_phi": ["-plo", "0.0199", "-phi", "0.0201", "-pb", "880", "-x",
                "0.3", "-e", "0.1", "-w", "40"],
    "rlo_rhi": ["-rlo", "16380", "-rhi", "16390", "-porb", "880", "-x",
                "0.3"],
    "To_wdot": ["-ppsr", "0.02", "-porb", "900", "-x", "0.3", "-To",
                "54999.9", "-w", "10", "-wdot", "4.2"],
    "candfile": ["-candfile", "CAND", "-candnum", "2"],
    "candfile_x": ["-candfile", "CAND", "-x", "0.25", "-ppsr", "0.0201"],
    "psr": ["-psr", "J0737-3039A"],
    "mak": ["-mak"],
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_trial_sources_equal_jax(tmp_path, source):
    """Each trial source gives the JAX CLI's (ppsr, OrbitParams), in its
    precedence (-candfile, -psr, -mak, then the explicit orbit)."""
    from presto_tpu.io.infodata import read_inf as jread_inf
    from presto_tpu_torch.io.infodata import read_inf
    base = _fft_files(str(tmp_path))
    cand = base + "_bin3.cand"
    write_bincands(cand, [RawBinCand(psr_p=0.02001, orb_p=905.0),
                          RawBinCand(psr_p=0.01999, orb_p=450.0)])
    tmak.write_mak(base + ".mak", tmak.MakParams(
        N=1 << 16, dt=5e-3, f=50.0, orb_p=900.0, orb_x=0.33, orb_e=0.05,
        orb_w=12.0, orb_t=40.0))
    argv = [cand if a == "CAND" else a for a in SOURCES[source]]
    argv = argv + [base + ".fft"]
    ja = japp.build_parser().parse_args(argv)
    ta = tapp.build_parser().parse_args(argv)
    jp, jorb = japp._trial_from_args(ja, base, jread_inf(base + ".inf"))
    tp, torb = tapp._trial_from_args(ta, base, read_inf(base + ".inf"))
    assert tp == jp and torb.__dict__ == jorb.__dict__
    assert tp > 0 and torb.p > 0 and torb.x > 0


def test_bincand_cli_equals_jax(tmp_path, capsys):
    """The CLI end to end on a .fft (the explicit orbit, one round): the
    same printed orbit and a power within CORR_RTOL."""
    base = _fft_files(str(tmp_path))
    argv = ["-ppsr", "0.02", "-porb", "920", "-x", "0.3", "-rounds", "1",
            "-nsteps", "1", base + ".fft"]
    assert japp.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert tapp.main(argv, device="cpu") == 0
    got = capsys.readouterr().out.splitlines()
    assert got[1:] == want[1:]
    pw, pt = float(want[0].split()[-1]), float(got[0].split()[-1])
    assert abs(pt - pw) <= CORR_RTOL * pw


def test_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    pairs = np.ones((4096, 2), np.float32)
    orb = OrbitParams(p=900.0, x=0.3)
    for call in (lambda: tb.optimize_bincand(pairs, 8192, 1e-2, orb, 0.02),
                 lambda: tapp.main(["-ppsr", "0.02", "-porb", "900", "-x",
                                    "0.3", str(tmp_path / "x.fft")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
