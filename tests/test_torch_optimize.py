"""The port's host refinement (search/optimize.py, numpy and scipy)
against the JAX package's, and the port's batched polish against it.

optimize.py is a host copy, so each function returns the JAX package's
values to rtol 1e-12 on the same chirp spectrum.  The per-candidate
simplex (optimize_accelcand) is the reference the batched polish is
held to, with the JAX package's own tolerances (tests/test_polish.py):
|dr| < 0.02 bins, |dz| < 0.25, sigma within 0.25, power within 5%.
"""

import numpy as np
import pytest

from presto_tpu.search import accel as jaccel
from presto_tpu.search import optimize as jop
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import optimize as top
from presto_tpu_torch.search import polish as tpolish
from test_torch_polish import T_OBS, as_torch, corpus  # noqa: F401

N, T = 1 << 16, 100.0


def chirp_spectrum(r_mid, z, amp=1.0, noise=1.0, seed=4):
    """A chirp whose mid-observation bin is r_mid, plus its second
    harmonic at half the amplitude, in seeded white noise."""
    t = np.arange(N) * (T / N)
    x = np.random.default_rng(seed).normal(0, noise, N)
    for h, a in ((1, amp), (2, amp / 2)):
        r0 = h * (r_mid - z / 2.0)
        x = x + a * np.cos(2 * np.pi * (r0 / T * t + 0.5 * h * z / T ** 2
                                        * t * t))
    return np.fft.rfft(x)


R0, Z0 = 1600.37, 7.3
SEED_R, SEED_Z = round(R0 * 2) / 2, round(Z0 / 2) * 2


def _props(mod, X):
    lp = mod.get_localpower(X, R0, Z0)
    p = mod.calc_props(mod.get_derivs(X, R0, Z0, lp), R0, Z0)
    return [lp, p.r, p.z, p.pow, p.rerr, p.zerr, p.pur, p.cen, p.phs]


def _cand(acc):
    return acc.AccelCand(power=0.0, sigma=0.0, numharm=2, r=SEED_R,
                         z=SEED_Z)


CASES = {
    "rz_interp": lambda op, acc, X: [op.rz_interp(X, R0, Z0)],
    "power_at_rz": lambda op, acc, X: [op.power_at_rz(X, R0 + 0.3, -Z0)],
    "max_rz_arr": lambda op, acc, X: list(op.max_rz_arr(X, SEED_R,
                                                        SEED_Z)),
    "max_rz_arr_harmonics": lambda op, acc, X: (
        lambda r, z, p: [r, z] + p)(*op.max_rz_arr_harmonics(
            X, SEED_R, SEED_Z, 2, [2.0, 1.0])),
    "local power, derivatives, props": lambda op, acc, X: _props(op, X),
    "spectrum_local_powers": lambda op, acc, X: list(
        op.spectrum_local_powers(X)[::97]),
    "optimize_accelcand": lambda op, acc, X: (
        lambda o: [o.r, o.z, o.power, o.sigma] + list(o.hpows))(
        op.optimize_accelcand(X, _cand(acc), T, [1e5, 1e5])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_refinement_matches_jax(name):
    X = chirp_spectrum(R0, Z0)
    want = np.asarray(CASES[name](jop, jaccel, X), np.complex128)
    got = np.asarray(CASES[name](top, taccel, X), np.complex128)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_optimize_accelcand_recovers_the_chirp():
    X = chirp_spectrum(R0, Z0)
    oc = top.optimize_accelcand(X, _cand(taccel), T, [1e5, 1e5])
    assert abs(oc.r - R0) < 0.05 and abs(oc.z - Z0) < 0.3
    assert oc.sigma > 20.0 and len(oc.props) == 2


def test_batched_polish_near_the_simplex(corpus):  # noqa: F811
    amps, cands, numindep = corpus
    tc = as_torch(cands)
    ref = [top.optimize_accelcand(amps, c, T_OBS, numindep) for c in tc]
    bat = tpolish.optimize_accelcands(amps, tc, T_OBS, numindep,
                                      device="cpu")
    strong = [(a, b) for a, b in zip(ref, bat) if a.sigma > 5.0]
    assert strong
    for a, b in strong:
        assert a.numharm == b.numharm
        assert abs(a.r - b.r) < 0.02 and abs(a.z - b.z) < 0.25
        assert abs(a.sigma - b.sigma) < 0.25
        assert abs(a.power - b.power) / a.power < 0.05
