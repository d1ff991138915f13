"""The port's folding ops (presto_tpu_torch/ops/fold.py) against the JAX
package's, on the CPU.

The phase plan is host float64 code: equal arrays.  The drizzle has two
routes, the plain ``index_add_`` a CPU tensor takes and the ordered
gather table a CUDA tensor takes (run here on CPU tensors); both are
bit-equal to the JAX package's XLA scatter, for 1-D and multi-channel
data and for the stacked per-row fold.  Profile rotations are host
float64 (shift_prof: equal); the device rotate-and-sum (combine_profs,
combine_subbands) reduces in its own order: rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from presto_tpu.ops import fold as jfold
from presto_tpu_torch.ops import fold as tfold

# (f, fd, proflen, npart, N, dt): subdiv 1 to 58
CASES = [(40.3, 1.4e-4, 128, 64, 40000, 1.28e-4),
         (40.3, 1e-3, 64, 8, 20000, 1e-3),
         (333.3, 0.0, 32, 4, 5000, 5e-4),
         (7.1, -2e-4, 128, 16, 30000, 2e-3),
         (900.0, 0.1, 64, 8, 8000, 1e-3)]
IDS = ["f%g-L%d" % (c[0], c[2]) for c in CASES]


def _plans(case):
    f, fd, L, npart, N, dt = case
    return (jfold.plan_fold(N, dt, f, fd, proflen=L, npart=npart),
            tfold.plan_fold(N, dt, f, fd, proflen=L, npart=npart))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_fold_equal(case):
    jp, tp = _plans(case)
    for a in ("b0", "b1", "w0", "w1", "parts_numdata"):
        np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
    assert (tp.subdiv, tp.npart, tp.proflen) == (jp.subdiv, jp.npart,
                                                 jp.proflen)


@pytest.mark.parametrize("route", ["plain", "ordered"])
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_drizzle_bit_equal_to_jax(case, channels, route):
    """fold_data (the plain route) and the ordered route on the same
    update stream give the JAX package's fold_data bits."""
    jp, tp = _plans(case)
    N = case[4]
    rng = np.random.default_rng(int(case[0]))
    x = rng.normal(size=(channels, N) if channels else N).astype(np.float32)
    want = jfold.fold_data(x, jp)
    if route == "plain":
        got = tfold.fold_data(x, tp, "cpu")
    else:
        arr = torch.as_tensor(np.atleast_2d(x))
        upd, bins = tfold._updates(arr, tp.b0, tp.b1, tp.w0, tp.w1,
                                   tp.subdiv)
        out = tfold.drizzle_ordered(upd, bins, tp.npart * tp.proflen)
        got = out.numpy().astype(np.float64).reshape(
            arr.shape[0], tp.npart, tp.proflen).transpose(1, 0, 2)
        if not channels:
            got = got[:, 0, :]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_bin_table_lists_updates_in_order():
    """Each bin's column holds its updates in ascending update order,
    padded with the zero slot M."""
    bins = torch.tensor([2, 0, 2, 1, 0, 2, 3, 2])
    table = tfold.bin_table(bins, 5)
    M = bins.numel()
    assert table.shape == (4, 5)
    assert table[:, 2].tolist() == [0, 2, 5, 7]
    assert table[:, 0].tolist() == [1, 4, M, M]
    assert table[:, 4].tolist() == [M] * 4


@pytest.mark.parametrize("case", CASES[1:4], ids=IDS[1:4])
def test_fold_data_batch_bit_equal_to_jax(case):
    """Three rows, each under its own plan of one geometry: JAX
    fold_data_batch's bits, and each row fold_data's."""
    f, fd, L, npart, N, dt = case
    fs = [f, f * 1.0001, f * 0.9999]
    jps = [jfold.plan_fold(N, dt, fi, fd, proflen=L, npart=npart)
           for fi in fs]
    assert len({p.subdiv for p in jps}) == 1
    tps = [tfold.plan_fold(N, dt, fi, fd, proflen=L, npart=npart)
           for fi in fs]
    rng = np.random.default_rng(3)
    rows = [rng.normal(size=N).astype(np.float32) for _ in fs]
    want = jfold.fold_data_batch(rows, jps)
    got = tfold.fold_data_batch(rows, tps, "cpu")
    np.testing.assert_array_equal(got, want)
    for j in range(len(fs)):
        np.testing.assert_array_equal(
            got[j], tfold.fold_data(rows[j], tps[j], "cpu"))
    with pytest.raises(ValueError, match="geometry"):
        tfold.fold_data_batch(rows[:2], [tps[0], tfold.plan_fold(
            N, dt, f, fd, proflen=L * 2, npart=npart)], "cpu")


def test_simplefold_and_stats_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=12345).astype(np.float32)
    want = jfold.simplefold(x, 1e-3, 12.3, 1e-4, proflen=32)
    got = tfold.simplefold(x, 1e-3, 12.3, 1e-4, proflen=32, device="cpu")
    np.testing.assert_array_equal(got, want)
    js = jfold.fold_stats(want, 12345.0, float(x.mean()), float(x.var()))
    ts = tfold.fold_stats(got, 12345.0, float(x.mean()), float(x.var()))
    np.testing.assert_array_equal(ts.to_array(), js.to_array())


def test_shift_prof_equal():
    rng = np.random.default_rng(4)
    prof = rng.normal(size=64)
    for sh in (0.0, 3.25, -7.8, 130.4):
        np.testing.assert_array_equal(tfold.shift_prof(prof, sh),
                                      jfold.shift_prof(prof, sh))


def test_combine_profs_and_subbands_match_jax():
    """rtol 1e-6 of the profile scale: float32 sums in another order."""
    rng = np.random.default_rng(6)
    profs = rng.normal(size=(16, 64)) * 50 + 300
    shifts = rng.uniform(-70, 70, 16)
    want = jfold.combine_profs(profs, shifts)
    got = tfold.combine_profs(profs, shifts, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    cube = rng.normal(size=(8, 16, 64)) * 50 + 300
    subfreqs = 1200.0 + 25.0 * np.arange(16)
    dsh = tfold.subband_fold_shifts(subfreqs, 52.0, 50.0, 30.0, 64)
    np.testing.assert_array_equal(
        dsh, jfold.subband_fold_shifts(subfreqs, 52.0, 50.0, 30.0, 64))
    want = jfold.combine_subbands(cube, dsh)
    got = tfold.combine_subbands(cube, dsh, device="cpu")
    assert got.shape == (8, 64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
