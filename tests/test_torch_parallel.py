"""The port's DM sharding (parallel/mesh, parallel/sharded) against the
JAX package's, on 8 logical CPU shards.

The JAX side runs on the 8-device CPU mesh tests/conftest.py forces, so
it takes its own sharded paths; the port's mesh is 8 logical shards of
the CPU (parallel/mesh.set_logical_devices).  The static per-shard
dedispersion plans are bit-equal to the JAX package's and to the port's
unsharded loop; the traced stream holds rtol/atol 1e-5 as
tests/test_parallel.py does; the sharded search gives the single-device
search's lists field for field, and the JAX package's sharded lists by
tests/test_torch_accel.py's rule (its TPU engine in interpret mode; the
Pallas kernels inside its shard_map need the map's varying-axes check
off, which this test sets on the JAX module's own shard_map handle).

The last test holds the kernel wrappers' device repair: each ctypes
launch runs with the tensor's CUDA device current.  A CPU build cannot
make a device current, so the test runs the wrappers on fake cuda:1
tensors (torch's FakeTensorMode) with torch.cuda.device / current_device
/ current_stream replaced by a recorder of the current index, and the
library entry points replaced by functions that read it.
"""

import contextlib
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.ops import dedispersion as jdd
from presto_tpu.parallel import mesh as jmesh
from presto_tpu.parallel import sharded as jsharded
from presto_tpu.search import accel as jaccel
from presto_tpu.search import accel_pallas, build_pallas
from presto_tpu_torch import cuda_build
from presto_tpu_torch.ops import dedispersion as tdd
from presto_tpu_torch.parallel import mesh as tmesh
from presto_tpu_torch.parallel import sharded as tsharded
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import accel_cuda, build_cuda
from test_torch_accel import N, DT, spectra

NSHARD = 8


@pytest.fixture
def tmesh8():
    with tmesh.set_logical_devices(NSHARD, "cpu"):
        yield tmesh.make_mesh(device="cpu")


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) == NSHARD, "conftest forces 8 CPU devices"
    return jmesh.make_mesh(NSHARD, ("dm",))


def _stream_inputs(seed, numchan=16, nsub=8, numpts=64, nblocks=5,
                   numdms=24):
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(nblocks, numchan, numpts)).astype(np.float32)
    chan = rng.integers(0, 20, size=numchan).astype(np.int32)
    dm = rng.integers(0, 30, size=(numdms, nsub)).astype(np.int32)
    return blocks, chan, dm


def test_mesh_row_ranges_and_placement(tmesh8):
    assert tmesh8.size == NSHARD and tmesh8.shape == (NSHARD,)
    assert tmesh8.distinct_devices() == [torch.device("cpu")]
    assert tmesh.replicated(tmesh8) == [torch.device("cpu")]
    assert tmesh.shard_row_ranges(tmesh8, 24) == \
        jmesh.shard_row_ranges(jmesh.make_mesh(NSHARD), 24)
    assert [r for _d, r in tmesh.dm_sharding(tmesh8, 16)] == \
        [(2 * k, 2 * k + 2) for k in range(NSHARD)]
    with pytest.raises(ValueError):
        tmesh.shard_row_ranges(tmesh8, 12)
    assert tmesh.visible_devices("cpu") == [torch.device("cpu")] * NSHARD
    assert tmesh.make_mesh(2, device="cpu").size == 2
    with pytest.raises(ValueError):
        tmesh.make_mesh(9, device="cpu")
    with pytest.raises(ValueError):
        tmesh.init_distributed("localhost:1", 2, None)


def test_mesh_outside_the_logical_context_is_one_cpu():
    assert tmesh.visible_devices("cpu") == [torch.device("cpu")]
    assert tmesh.make_mesh(device="cpu").size == 1


@pytest.mark.parametrize("downsamp", [1, 2])
def test_sharded_dedisperse_stream_matches_jax_and_unsharded(
        tmesh8, jmesh8, downsamp):
    """The traced stream against the JAX package's (rtol/atol 1e-5, as
    tests/test_parallel.py) and bit-equal to the port's own unsharded
    dedisperse_scan."""
    blocks, chan, dm = _stream_inputs(0)
    got = tsharded.sharded_dedisperse_stream(blocks, chan, dm, tmesh8, 8,
                                             downsamp).numpy()
    want = np.asarray(jsharded.sharded_dedisperse_stream(
        blocks, chan, dm, jmesh8, 8, downsamp))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    single = tdd.dedisperse_scan(torch.from_numpy(blocks),
                                 {"chan": chan, "dm": dm}, 8,
                                 downsamp=downsamp).numpy()
    np.testing.assert_array_equal(got, single)
    jsingle = np.asarray(jdd.dedisperse_scan(
        jnp.asarray(blocks), {"chan": chan, "dm": dm}, 8,
        downsamp=downsamp))
    np.testing.assert_array_equal(single, jsingle)


def _stream_plan(plan, blocks):
    prev_raw = prev_sub = None
    outs = []
    for b in blocks:
        cur = plan.put_block(b)
        if prev_raw is not None:
            if prev_sub is None:
                prev_sub = plan.prime(prev_raw, cur)
            else:
                prev_sub, series = plan.step(prev_raw, cur, prev_sub)
                outs.append(series)
        prev_raw = cur
    return plan.concat(outs)


def test_sharded_plan_bit_equal_to_jax_and_unsharded(tmesh8, jmesh8):
    """ShardedDedispPlan: per-shard [rows_k, T] parts in their row ranges,
    bit-equal to the JAX package's plan and to one make_block_step over
    every row."""
    blocks, chan, dm = _stream_inputs(5, numchan=32, numpts=256, numdms=16)
    plan = tsharded.ShardedDedispPlan(tmesh8, 8, 1, chan, dm)
    parts = _stream_plan(plan, blocks)
    assert [tuple(p.shape) for p in parts] == [(2, 3 * 256)] * NSHARD
    assert plan.row_ranges == [(2 * k, 2 * k + 2) for k in range(NSHARD)]
    got = torch.cat(parts).numpy()
    jplan = jsharded.ShardedDedispPlan(jmesh8, 8, 1, chan, dm)
    np.testing.assert_array_equal(got, np.asarray(_stream_plan(jplan,
                                                               blocks)))
    whole = tsharded.ShardedDedispPlan(tmesh.Mesh((torch.device("cpu"),)),
                                       8, 1, chan, dm)
    np.testing.assert_array_equal(got, _stream_plan(whole, blocks)[0])


def test_sixstep_fft_matches_fft():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=1024) + 1j * rng.normal(size=1024)).astype(
        np.complex64)
    got = tsharded.sixstep_fft(torch.from_numpy(x), rows=16).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-3, atol=1e-2)


def test_sharded_sixstep_fft(tmesh8):
    rng = np.random.default_rng(2)
    n, rows = 4096, 16
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    pairs = np.stack([x.real, x.imag], -1).astype(np.float32)
    fft_fn = tsharded.make_sharded_sixstep_fft(tmesh8, rows)
    parts = fft_fn(pairs)
    assert [tuple(p.shape) for p in parts] == [(n // NSHARD, 2)] * NSHARD
    got = torch.cat(parts).numpy()
    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], np.fft.fft(x),
                               rtol=1e-3, atol=3e-2)
    # the per-shard pieces as input give the same output
    again = torch.cat(fft_fn([torch.from_numpy(pairs[lo:hi]) for lo, hi in
                              tmesh.shard_row_ranges(tmesh8, n)]))
    np.testing.assert_array_equal(again.numpy(), got)


def _chirp_batch(nd, nbins=1 << 14, seed=2):
    """tests/test_parallel.py's batch: noise plus one chirp a trial."""
    rng = np.random.default_rng(seed)
    t = np.arange(2 * nbins) / (2 * nbins)
    out = []
    for d in range(nd):
        x = rng.normal(size=2 * nbins)
        r0 = 2000.5 + 70.0 * d
        x += 0.12 * np.cos(2 * np.pi * (r0 * t + 4.0 * t * t))
        X = np.fft.rfft(x)[:nbins]
        out.append(np.stack([X.real, X.imag], -1).astype(np.float32))
    return np.stack(out)


def _fields(cl):
    return [dataclasses.astuple(c) for c in cl]


@pytest.mark.parametrize("nd", [12, 16])
def test_sharded_search_equals_single_device(tmesh8, nd):
    """Lists equal searcher.search_many's field for field, trial by
    trial (12 trials pad the DM axis to 16); the per-shard tensors in
    place give the same lists; the chirp tops each trial."""
    batch = _chirp_batch(nd)
    s = taccel.AccelSearch(taccel.AccelConfig(zmax=20, numharm=4,
                                              sigma=3.0),
                           T=800.0, numbins=batch.shape[1], device="cpu")
    got = s.search_many(batch, mesh=tmesh8)
    want = s.search_many(batch)
    assert len(got) == len(want) == nd
    assert [_fields(a) for a in got] == [_fields(b) for b in want]
    if nd % NSHARD == 0:
        parts = [torch.from_numpy(batch[lo:hi]) for lo, hi in
                 tmesh.shard_row_ranges(tmesh8, nd)]
        inplace = tsharded.sharded_accel_search_many(s, parts, tmesh8)
        assert [_fields(a) for a in inplace] == [_fields(b) for b in want]
    for d, cl in enumerate(got):
        assert cl and abs(cl[0].r - (2004.5 + 70.0 * d)) < 1.0


def test_sharded_search_compact_overflow_falls_back_dense(tmesh8):
    """A trial that overflows a tiny compaction budget takes the dense
    fallback: the same lists as the default budget's."""
    rng = np.random.default_rng(21)
    numbins, T, nd = 1 << 13, 90.0, 8
    batch = rng.normal(size=(nd, numbins, 2)).astype(np.float32)
    for d in range(nd):
        batch[d, 2000 + 300 * d] = (50.0, 0.0)
    cfg = taccel.AccelConfig(zmax=4, numharm=2, sigma=2.0)
    s = taccel.AccelSearch(cfg, T=T, numbins=numbins, device="cpu")
    ref = tsharded.sharded_accel_search_many(s, batch, tmesh8)
    tiny = tsharded.sharded_accel_search_many(s, batch, tmesh8,
                                              compact_m=2)
    assert [_fields(a) for a in ref] == [_fields(b) for b in tiny]
    assert sum(len(a) for a in ref) > nd * 2


def _strongest(cands, powcut=None):
    """(numharm, round(2r), round(2z)) -> the largest power of the
    candidates with that key (of those more than 1% above their stage's
    powcut, when ``powcut`` is given)."""
    out = {}
    for c in cands:
        if powcut is None or c.power > 1.01 * powcut[int(np.log2(
                c.numharm))]:
            k = (c.numharm, round(2 * c.r), round(2 * c.z))
            out[k] = max(out.get(k, 0.0), c.power)
    return out


def assert_lists_agree(want, got, powcut):
    """test_torch_accel.assert_lists_agree's rule (strong keys found in
    the other list, powers within rtol 1e-4), with a key that two
    candidates share taken at its largest power in both lists: over 8
    trials such keys occur, and the rule's last-one-wins dict would
    compare a strong candidate's power with a weak one's."""
    kw, kg = _strongest(want, powcut), _strongest(got, powcut)
    assert kw, "no strong candidates to compare"
    pw, pg = _strongest(want), _strongest(got)
    assert set(kw) <= set(pg) and set(kg) <= set(pw)
    for k, p in kw.items():
        np.testing.assert_allclose(pg[k], p, rtol=1e-4)


def test_sharded_search_matches_jax_sharded(tmesh8, jmesh8, monkeypatch):
    """The port's sharded lists against the JAX package's
    sharded_accel_search_many on its 8-device mesh (its TPU engine in
    interpret mode), by test_torch_accel's rule, from the JAX package's
    own banks."""
    monkeypatch.setattr(accel_pallas, "pallas_available", lambda: True)
    monkeypatch.setattr(jaccel, "_use_mxu_engine",
                        lambda fftlen: fftlen % 256 == 0)
    monkeypatch.setattr(build_pallas, "make_plane_builder",
                        functools.partial(build_pallas.make_plane_builder,
                                          interpret=True))
    monkeypatch.setattr(accel_pallas, "make_stage_reducer",
                        functools.partial(accel_pallas.make_stage_reducer,
                                          interpret=True))
    monkeypatch.setattr(jsharded, "_shard_map",
                        functools.partial(jax.shard_map, check_vma=False))
    batch = spectra(NSHARD)
    cfg = jaccel.AccelConfig(zmax=20, numharm=8, sigma=3.0)
    js = jaccel.AccelSearch(cfg, T=N * DT, numbins=N // 2)
    assert js._plb_hw_eff, "the JAX side must be on the TPU geometry"
    want = jsharded.sharded_accel_search_many(js, batch, jmesh8)
    ts = taccel.from_reference_arrays(
        taccel.AccelConfig(**dataclasses.asdict(js.cfg)), N * DT, N // 2,
        js.kern.kern_pairs, jaccel._harm_fracs_and_zinds(js.cfg,
                                                          js.cfg.numz),
        js.numindep, js.powcut, device="cpu")
    got = ts.search_many(torch.from_numpy(batch), mesh=tmesh8)
    assert len(got) == len(want) == NSHARD
    for w, g in zip(want, got):
        assert_lists_agree(w, g, js.powcut)


def test_jerk_config_searches_on_the_searchers_device(tmesh8):
    """A jerk search (cfg.wmax) takes search_many, as the JAX package's
    sharded search does."""
    batch = _chirp_batch(2, nbins=1 << 12)
    s = taccel.AccelSearch(taccel.AccelConfig(zmax=4, wmax=20, numharm=2,
                                              sigma=3.0),
                           T=200.0, numbins=batch.shape[1], device="cpu")
    got = tsharded.sharded_accel_search_many(s, batch, tmesh8)
    assert [_fields(a) for a in got] == \
        [_fields(b) for b in s.search_many(batch)]


# ----------------------------------------------------------------------
# the device-context repair of the kernel wrappers
# ----------------------------------------------------------------------

class _FakeEntry:
    """A C entry point: records the current device at each call."""

    def __init__(self, current):
        self.current = current
        self.seen = []
        self.__name__ = "entry"

    def __call__(self, *args):
        self.seen.append(self.current[0])
        return 0


class _FakeLib:
    def __init__(self, entry):
        self.entry = entry

    def __getattr__(self, name):
        return self.entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """cuda:0 current; torch.cuda.device switches a recorded index."""
    current = [0]

    @contextlib.contextmanager
    def device(d):
        prev = current[0]
        current[0] = torch.device(d).index
        try:
            yield
        finally:
            current[0] = prev

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: Stream())
    monkeypatch.setattr(build_cuda, "_twiddles", {})
    monkeypatch.setattr(accel_cuda, "_check_once", lambda *a: None)
    entry = _FakeEntry(current)
    monkeypatch.setattr(cuda_build, "load", lambda name: _FakeLib(entry))
    pins = []

    def pin(self):
        pins.append(current[0])
        return self
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    return current, entry, pins


@pytest.mark.parametrize("which", ["plane_build", "stage_reduce",
                                   "stage_reduce_planes"])
def test_kernel_launch_makes_the_tensor_device_current(fake_cuda, which):
    """On a tensor on cuda:1 with cuda:0 current, the wrapper's ctypes
    call (and the multi-plane pointer table's upload) run with cuda:1
    current, and cuda:0 is current again after."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    current, entry, pins = fake_cuda
    dev = torch.device("cuda", 1)
    before = (build_cuda.launches_by_device[1],
              accel_cuda.launches_by_device[1])
    with warnings.catch_warnings(), FakeTensorMode(
            allow_non_fake_inputs=True):
        warnings.simplefilter("ignore")
        if which == "plane_build":
            S = torch.empty((4, 128), dtype=torch.complex64, device=dev)
            Kc = torch.empty((11, 256), dtype=torch.complex64, device=dev)
            out = build_cuda.build_plane(S, Kc, 16, 8, 128, 64)
        else:
            P = torch.empty((16, 4096), dtype=torch.float32, device=dev)
            sc = torch.empty((2,), dtype=torch.int32, device=dev)
            zi = torch.empty((3, 16), dtype=torch.int32, device=dev)
            if which == "stage_reduce":
                out = accel_cuda.reduce_stages(P, sc, zi, 1024, 3)[0]
            else:
                out = accel_cuda.reduce_stages_planes([P] * 4, sc, zi,
                                                      1024, 3)[0]
    assert entry.seen == [1]
    assert current[0] == 0
    assert out.device == dev
    assert pins == ([1] if which == "stage_reduce_planes" else [])
    after = (build_cuda.launches_by_device[1],
             accel_cuda.launches_by_device[1])
    assert after[0] - before[0] == (which == "plane_build")
    assert after[1] - before[1] == (which != "plane_build")
