"""The port's stage reducer against the Pallas stage reducer.

Same random plane through presto_tpu.search.accel_pallas (interpret
mode) and presto_tpu_torch.search.accel_cuda (its plain version on the
CPU).  Both add the harmonic terms in the same order, so colmax agrees
to rtol 1e-6 (in practice bit for bit) and colz exactly.
"""

import numpy as np
import pytest
import torch

from presto_tpu.search.accel import AccelConfig, _harm_fracs_and_zinds
from presto_tpu.search.accel_pallas import (PLANE_PAD, make_stage_reducer,
                                            pad_rows)
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import accel_cuda

TILE = 128


@pytest.mark.parametrize("numharm", [4, 8, 16])
def test_reducer_matches_pallas(numharm):
    import jax.numpy as jnp
    rng = np.random.default_rng(numharm)
    cfg = AccelConfig(zmax=20, numharm=numharm)
    numz, nstages = cfg.numz, cfg.numharmstages
    slab = 2 * TILE
    R = 12 * TILE
    P = np.zeros((pad_rows(numz), R + PLANE_PAD), np.float32)
    P[:numz, :R] = rng.random((numz, R)).astype(np.float32)
    P[:numz, 5] = P[:numz, 5].max()           # a tie: lowest z wins
    start_cols = np.asarray([0, 3 * TILE, 10 * TILE], np.int32)
    fz = _harm_fracs_and_zinds(cfg, numz)
    reducer = make_stage_reducer(nstages, fz, slab, numz, R + PLANE_PAD,
                                 interpret=True, tile=TILE)
    want_max, want_z = (np.asarray(a) for a in reducer(
        jnp.asarray(P), jnp.asarray(start_cols)))

    tcfg = taccel.AccelConfig(zmax=20, numharm=numharm)
    tfz = taccel._harm_fracs_and_zinds(tcfg, numz)
    zi = np.stack([np.concatenate([z, np.arange(numz, P.shape[0])])
                   for stage in tfz for (_h, _t, z) in stage]
                  ).astype(np.int32)
    for stage, tstage in zip(fz, tfz):
        for (h, t, z), (th, tt, tz) in zip(stage, tstage):
            assert (h, t) == (th, tt)
            np.testing.assert_array_equal(z, tz)
    before = accel_cuda.launches
    got_max, got_z = accel_cuda.reduce_stages(
        torch.from_numpy(P[:, :R].copy()), torch.from_numpy(start_cols),
        torch.from_numpy(zi), slab, nstages)
    assert accel_cuda.launches == before      # CPU: the plain version
    np.testing.assert_allclose(got_max.numpy(), want_max, rtol=1e-6)
    np.testing.assert_array_equal(got_z.numpy(), want_z)
    assert (got_z.numpy()[0, 0, 5] == 0)
