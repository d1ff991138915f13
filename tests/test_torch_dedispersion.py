"""The port's dedispersion against the JAX package's, bit for bit.

Same numpy-seeded inputs through presto_tpu.ops.dedispersion and
presto_tpu_torch.ops.dedispersion on the CPU; float32 outputs must be
identical (both accumulate row-ascending).
"""

import numpy as np
import pytest
import torch

from presto_tpu.ops import dedispersion as jdd
from presto_tpu_torch.ops import dedispersion as tdd

NCHAN, NSUB, NPTS, NDMS = 32, 8, 1 << 13, 8


def _blocks(seed, nblocks=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(10.0, 3.0, (NCHAN, NPTS)).astype(np.float32)
            for _ in range(nblocks)]


def _plan():
    chan = jdd.delays_to_bins(jdd.subband_search_delays(
        NCHAN, NSUB, 60.0, 400.0, 1.5), 5e-4)
    sub = np.stack([jdd.subband_delays(NCHAN, NSUB, dm, 400.0, 1.5)
                    for dm in 40.0 + 5.0 * np.arange(NDMS)])
    return chan, jdd.delays_to_bins(sub - sub.min(), 5e-4)


def test_delay_plans_equal():
    chan, dmb = _plan()
    np.testing.assert_array_equal(
        chan, tdd.delays_to_bins(tdd.subband_search_delays(
            NCHAN, NSUB, 60.0, 400.0, 1.5), 5e-4))
    sub = np.stack([tdd.subband_delays(NCHAN, NSUB, dm, 400.0, 1.5)
                    for dm in 40.0 + 5.0 * np.arange(NDMS)])
    np.testing.assert_array_equal(
        dmb, tdd.delays_to_bins(sub - sub.min(), 5e-4))


@pytest.mark.parametrize("downsamp", [1, 2])
def test_make_block_step_bit_equal(downsamp):
    chan, dmb = _plan()
    blocks = _blocks(1)
    jstep = jdd.make_block_step(chan, dmb, NSUB, downsamp)
    tstep = tdd.make_block_step(chan, dmb, NSUB, downsamp)
    jsub = jdd.dedisp_subbands_block(blocks[0], blocks[1], chan, NSUB)
    tsub = tdd.dedisp_subbands_block(torch.from_numpy(blocks[0]),
                                     torch.from_numpy(blocks[1]), chan,
                                     NSUB)
    np.testing.assert_array_equal(np.asarray(jsub), tsub.numpy())
    for prev, cur in zip(blocks[1:], blocks[2:]):
        jsub, jser = jstep(prev, cur, jsub)
        tsub, tser = tstep(torch.from_numpy(prev), torch.from_numpy(cur),
                           tsub)
        np.testing.assert_array_equal(np.asarray(jsub), tsub.numpy())
        np.testing.assert_array_equal(np.asarray(jser), tser.numpy())


def test_dedisperse_series_bit_equal():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(NCHAN, 1 << 16)).astype(np.float32)
    chan, _ = _plan()
    want = np.asarray(jdd.dedisperse_series(data, chan))
    got = tdd.dedisperse_series(torch.from_numpy(data), chan).numpy()
    np.testing.assert_array_equal(want, got)


def test_bench_delay_ladder_bit_equal():
    """The bench's config-1 ladder (bench.make_prep_delays: the nu^-2
    shape of a real DM) through float_dedisp_many_block."""
    import bench
    numchan = bench.WORKLOAD["prep_numchan"]
    ladder = bench.make_prep_delays()
    rng = np.random.default_rng(3)
    npts = 1 << 13
    assert ladder.max() < npts
    last = rng.normal(size=(numchan, npts)).astype(np.float32)
    cur = rng.normal(size=(numchan, npts)).astype(np.float32)
    delays = np.stack([ladder, ladder // 2, ladder // 3])
    want = np.asarray(jdd.float_dedisp_many_block(last, cur, delays))
    got = tdd.float_dedisp_many_block(torch.from_numpy(last),
                                      torch.from_numpy(cur),
                                      delays).numpy()
    np.testing.assert_array_equal(want, got)
