"""The port's elastic DM-shard layer and multi-process runs, after
tests/test_elastic.py.

The shard ledger's semantics (partition, leases, expiry, reap, the
zombie-write fence, corrupt-shard readmission, restart) are one
parametrised test; the elastic loop runs in-process with a compute that
writes one staged file a row; prepsubband -elastic and -resume run on a
tiny filterbank and are held byte-equal to a one-process run of the
port and of the JAX package; the survey's elastic stage is killed by a
FaultInjector and resumed; and two torch.multiprocessing ranks join
over gloo through -coordinator, each writing its own rows, byte-equal
to a one-process run; with ElasticConfig.global_mesh, two spawned ranks
join one gloo group and the survivor of a kill re-forms it.  The kill of one of two real processes is slow
(it waits out a heartbeat timeout in subprocesses) and slow-marked, as
tests/test_multihost_chaos.py is.
"""

import glob
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from presto_tpu_torch.apps import prepsubband as tprep
from presto_tpu_torch.parallel import elastic
from presto_tpu_torch.pipeline.shardledger import (LEASED, PENDING,
                                                   ShardLedger,
                                                   StaleEpochError,
                                                   make_dm_shards)
from presto_tpu_torch.testing import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, data=b"shard-bytes"):
    with open(path, "wb") as f:
        f.write(data)
    return path


# ----------------------------------------------------------------------
# the shard ledger
# ----------------------------------------------------------------------

def _partition(tmp_path):
    assert make_dm_shards(10, 4) == [("dm0000", 0, 4), ("dm0001", 4, 8),
                                     ("dm0002", 8, 10)]
    assert make_dm_shards(0, 4) == []
    rows = [i for _sid, lo, hi in make_dm_shards(17, 3)
            for i in range(lo, hi)]
    assert rows == list(range(17))


def _roundtrip(tmp_path):
    led = ShardLedger(str(tmp_path))
    led.join("a")
    assert led.ensure_shards(make_dm_shards(4, 2)) == 2
    lease = led.lease("a", ttl=60.0)
    assert lease is not None and lease.rows == (0, 2)
    assert led.counts() == {PENDING: 1, LEASED: 1, "done": 0}
    final = str(tmp_path / "out0.dat")
    staged = _write(str(tmp_path / "stage0"))
    arts = led.complete(lease, "a", {final: staged})
    assert os.path.exists(final) and not os.path.exists(staged)
    assert arts["out0.dat"]["size"] == len(b"shard-bytes")
    led.complete(led.lease("a", ttl=60.0), "a", {})
    assert led.all_done()
    led.ensure_shards(make_dm_shards(4, 2))      # idempotent
    assert led.all_done()


def _expiry(tmp_path):
    led = ShardLedger(str(tmp_path))
    led.join("a", now=1000.0)
    led.heartbeat("a", 0, now=1000.0)
    led.ensure_shards(make_dm_shards(2, 1))
    lease = led.lease("a", ttl=5.0, now=1000.0)
    assert led.redo_set(heartbeat_ttl=60.0, now=1002.0) == []
    assert led.redo_set(heartbeat_ttl=60.0, now=1010.0) == [lease.shard_id]
    report = led.reap(heartbeat_ttl=60.0, now=1010.0)
    assert report.redone == [lease.shard_id] and report.bumped
    assert led.epoch == 1
    with pytest.raises(StaleEpochError):
        led.complete(lease, "a", {str(tmp_path / "x.dat"):
                                  _write(str(tmp_path / "s"))}, now=1011.0)
    assert not os.path.exists(str(tmp_path / "x.dat"))


def _dead_host(tmp_path):
    led = ShardLedger(str(tmp_path))
    for h in ("a", "b"):
        led.join(h, now=0.0)
        led.heartbeat(h, 0, now=100.0)
    led.ensure_shards(make_dm_shards(4, 1))
    la = led.lease("a", ttl=1000.0, now=100.0)
    led.lease("b", ttl=1000.0, now=100.0)
    led.heartbeat("b", 0, now=120.0)
    report = led.reap(heartbeat_ttl=10.0, now=121.0)
    assert report.dead_hosts == ["a"] and report.redone == [la.shard_id]
    assert report.epoch == 1
    assert led.alive_hosts(now=121.0, ttl=10.0) == ["b"]
    held = [s for s in led.read()["shards"].values() if s["state"] == LEASED]
    assert len(held) == 1 and held[0]["owner"] == "b"


def _zombie(tmp_path):
    led = ShardLedger(str(tmp_path))
    for h in ("a", "b"):
        led.join(h, now=0.0)
        led.heartbeat(h, 0, now=0.0)
    led.ensure_shards(make_dm_shards(1, 1))
    za = led.lease("a", ttl=1000.0, now=0.0)
    led.heartbeat("b", 0, now=50.0)
    report = led.reap(heartbeat_ttl=10.0, now=51.0)
    assert report.bumped and report.redone == [za.shard_id]
    lb = led.lease("b", ttl=1000.0, now=51.0)
    final = str(tmp_path / "row.dat")
    led.complete(lb, "b", {final: _write(str(tmp_path / "sb"),
                                         b"good-bytes")}, now=52.0)
    stale = _write(str(tmp_path / "sa"), b"zombie-bytes")
    with pytest.raises(StaleEpochError) as ei:
        led.complete(za, "a", {final: stale}, now=53.0)
    assert ei.value.epoch == 0 and ei.value.current_epoch == 1
    assert not os.path.exists(stale)
    with open(final, "rb") as f:
        assert f.read() == b"good-bytes"
    entry = led.read()["shards"]["dm0000"]["artifacts"]["row.dat"]
    assert entry["size"] == len(b"good-bytes")


def _corrupt(tmp_path):
    led = ShardLedger(str(tmp_path))
    led.join("a")
    led.ensure_shards(make_dm_shards(1, 1))
    final = str(tmp_path / "v.dat")
    led.complete(led.lease("a", ttl=60.0), "a",
                 {final: _write(str(tmp_path / "s"))})
    assert led.verify_done() == []
    with open(final, "ab") as f:
        f.write(b"XX")
    assert led.verify_done() == ["dm0000"]
    assert not os.path.exists(final)
    assert led.counts()[PENDING] == 1


def _restart(tmp_path):
    led = ShardLedger(str(tmp_path))
    led.join("a", now=0.0)
    led.ensure_shards(make_dm_shards(2, 1))
    stale = led.lease("a", ttl=3600.0, now=0.0)
    assert led.readmit_owned("a") == [stale.shard_id]
    assert led.epoch == 1
    with pytest.raises(StaleEpochError):
        led.complete(stale, "a", {str(tmp_path / "y.dat"):
                                  _write(str(tmp_path / "sy"))})


def _tombstone(tmp_path):
    led = ShardLedger(str(tmp_path))
    led.join("a", now=0.0)
    led.ensure_shards(make_dm_shards(1, 1))
    led.lease("a", ttl=3600.0, now=0.0)
    led.tombstone("a", now=1.0)
    assert led.alive_hosts(now=1.0, ttl=60.0) == []
    assert led.reap(heartbeat_ttl=60.0, now=1.0).redone == ["dm0000"]
    assert led.join("a", now=2.0) == 1           # rejoin clears it
    assert led.alive_hosts(now=2.0, ttl=60.0) == ["a"]


@pytest.mark.parametrize("case", [_partition, _roundtrip, _expiry,
                                  _dead_host, _zombie, _corrupt, _restart,
                                  _tombstone],
                         ids=lambda f: f.__name__.strip("_"))
def test_shard_ledger(tmp_path, case):
    case(tmp_path)


# ----------------------------------------------------------------------
# the elastic loop (in-process, files only)
# ----------------------------------------------------------------------

def _loop_cfg(**kw):
    base = dict(barrier_timeout=2.0, lease_ttl=5.0, heartbeat_interval=0.1,
                idle_poll=0.02)
    base.update(kw)
    return elastic.ElasticConfig(**base)


def _touch_compute(workdir, host):
    def compute(lease):
        staged = {}
        for i in range(*lease.rows):
            final = os.path.join(workdir, "row%03d.dat" % i)
            tmp = elastic.stage_path(final, host, lease.epoch)
            _write(tmp, b"row %03d" % i)
            staged[final] = tmp
        return staged
    return compute


def _rows(work):
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(work, "row*.dat")))


def test_elastic_loop_completes_all_shards(tmp_path):
    work = str(tmp_path)
    c = elastic.ElasticCluster(work, "h0", _loop_cfg())
    c.join()
    try:
        n = c.run(make_dm_shards(5, 2), _touch_compute(work, "h0"))
    finally:
        c.close()
    assert n == 3 and c.ledger.all_done() and c.stats["shards_done"] == 3
    assert _rows(work) == ["row%03d.dat" % i for i in range(5)]


def test_elastic_loop_kill_and_resume(tmp_path):
    """A SimulatedCrash at a shard point, then a new incarnation of the
    same process: its dead lease is re-admitted at join and every shard
    completes, with no staged file left."""
    work = str(tmp_path)
    fi = chaos.FaultInjector(kill_at="shard-computed", kill_after=2)
    c = elastic.ElasticCluster(work, "h0", _loop_cfg(), fault_injector=fi)
    c.join()
    with pytest.raises(chaos.SimulatedCrash):
        c.run(make_dm_shards(6, 2), _touch_compute(work, "h0"))
    c.close()
    assert not c.ledger.all_done()
    c2 = elastic.ElasticCluster(work, "h0", _loop_cfg())
    c2.join()
    try:
        c2.run(make_dm_shards(6, 2), _touch_compute(work, "h0"))
    finally:
        c2.close()
    assert c2.ledger.all_done() and c2.stats["redos"] == 1
    assert len(_rows(work)) == 6
    assert not glob.glob(os.path.join(work, ".shard-stage.*"))


def test_elastic_loop_takes_over_a_silent_peers_lease(tmp_path):
    work = str(tmp_path)
    led = ShardLedger(work)
    led.join("ghost", now=0.0)
    led.ensure_shards(make_dm_shards(4, 2))
    led.lease("ghost", ttl=3600.0, now=0.0)
    c = elastic.ElasticCluster(work, "h1", _loop_cfg(heartbeat_timeout=0.2))
    c.join()
    try:
        n = c.run(make_dm_shards(4, 2), _touch_compute(work, "h1"))
    finally:
        c.close()
    assert n == 2 and c.ledger.all_done() and c.ledger.epoch >= 1
    assert c.ledger.read()["hosts"]["ghost"]["alive"] is False


def test_run_to_completion_drives_elastic_kills(tmp_path):
    work = str(tmp_path)
    fi = chaos.FaultInjector(kill_at="pre-shard-commit", kill_after=1)

    def attempt():
        c = elastic.ElasticCluster(work, "h0", _loop_cfg(),
                                   fault_injector=fi)
        c.join()
        try:
            return c.run(make_dm_shards(3, 1), _touch_compute(work, "h0"))
        finally:
            c.close()

    chaos.run_to_completion(attempt)
    assert ShardLedger(work).all_done()


def test_fault_injector_modes_and_env(monkeypatch):
    fi = chaos.FaultInjector(kill_at="b", kill_after_n=3)
    fi.point("b1")
    fi.point("b2")
    with pytest.raises(chaos.SimulatedCrash):
        fi.point("b3")
    assert fi.fired == "b3"
    st = chaos.FaultInjector(kill_at="x", mode="stall", stall_seconds=0.01)
    st.point("x-pt")
    assert st.fired == "x-pt"
    fi = chaos.FaultInjector(kill_at="spot", kill_after=1)

    def always_dies():
        fi.fired = None
        fi.point("spot-7")
    with pytest.raises(RuntimeError, match=r"spot-7"):
        chaos.run_to_completion(always_dies, max_crashes=3)
    monkeypatch.setenv(elastic.KILL_ENV, "shard-computed:2:raise")
    fi = elastic.process_injector()
    assert (fi.kill_at, fi.kill_after, fi.mode) == ("shard-computed", 2,
                                                    "raise")
    monkeypatch.setenv(elastic.KILL_ENV, "shard-leased")
    fi = elastic.process_injector()
    assert (fi.kill_at, fi.kill_after, fi.mode) == ("shard-leased", 1,
                                                    "exit")
    monkeypatch.delenv(elastic.KILL_ENV)
    assert elastic.process_injector() is None


def test_timed_call_bounds_a_stalled_collective():
    with pytest.raises(elastic.BarrierTimeout):
        elastic.timed_call(lambda: time.sleep(5), 0.1, "stalled")
    assert elastic.timed_call(lambda: 7, 1.0) == 7


# ----------------------------------------------------------------------
# prepsubband -elastic, -resume and -coordinator (a tiny filterbank)
# ----------------------------------------------------------------------

NSPEC, NCHAN, DT = 1 << 12, 8, 5e-4


@pytest.fixture(scope="module")
def tiny_fil(tmp_path_factory):
    from presto_tpu_torch.models.synth import FakeSignal, fake_filterbank_file
    raw = str(tmp_path_factory.mktemp("elobs") / "m.fil")
    fake_filterbank_file(raw, NSPEC, DT, NCHAN, 400.0, 1.5,
                         FakeSignal(f=5.0, dm=30.0, shape="gauss",
                                    width=0.1, amp=1.0), noise_sigma=2.0)
    return raw


def _argv(outbase, raw, *extra):
    return (["-o", outbase, "-lodm", "10", "-dmstep", "2", "-numdms", "4",
             "-nsub", "8", "-nobary"] + list(extra) + [raw])


def _psb(outbase, raw, *extra):
    return tprep.run(tprep.build_parser().parse_args(
        _argv(outbase, raw, *extra)), device="cpu")


def _dat_bytes(d):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "*_DM*.dat")))}


@pytest.fixture(scope="module")
def psb_reference(tiny_fil, tmp_path_factory):
    """The one-process run's .dat bytes, equal to the JAX package's."""
    from presto_tpu.apps import prepsubband as jprep
    ref = str(tmp_path_factory.mktemp("psbref"))
    _psb(os.path.join(ref, "x"), tiny_fil)
    arts = _dat_bytes(ref)
    assert len(arts) == 4
    jref = str(tmp_path_factory.mktemp("psbjax"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRESTO_TPU_DISABLE_MESH", "1")
        jprep.run(jprep.build_parser().parse_args(
            _argv(os.path.join(jref, "x"), tiny_fil)))
    assert _dat_bytes(jref) == arts
    return arts


def test_elastic_prepsubband_byte_equal(tiny_fil, psb_reference, tmp_path):
    work = str(tmp_path)
    _psb(os.path.join(work, "x"), tiny_fil, "-elastic", "-shard-rows", "2",
         "-heartbeat-interval", "0.2")
    assert _dat_bytes(work) == psb_reference
    led = json.load(open(os.path.join(work, "shards.json")))
    assert all(s["state"] == "done" for s in led["shards"].values())


def test_elastic_prepsubband_kill_resume_byte_equal(tiny_fil, psb_reference,
                                                    tmp_path):
    work = str(tmp_path)
    fi = chaos.FaultInjector(kill_at="shard-computed", kill_after=1)
    elastic.set_process_injector(fi)
    try:
        with pytest.raises(chaos.SimulatedCrash):
            _psb(os.path.join(work, "x"), tiny_fil, "-elastic",
                 "-shard-rows", "1", "-heartbeat-interval", "0.2")
    finally:
        elastic.set_process_injector(None)
    assert fi.fired == "shard-computed"
    assert len(_dat_bytes(work)) < 4
    _psb(os.path.join(work, "x"), tiny_fil, "-elastic", "-shard-rows", "1",
         "-heartbeat-interval", "0.2")
    assert _dat_bytes(work) == psb_reference
    assert json.load(open(os.path.join(work, "shards.json")))["epoch"] >= 1


def test_prepsubband_cli_resume_verifies_not_trusts(tiny_fil, psb_reference,
                                                    tmp_path):
    work = str(tmp_path)
    out = os.path.join(work, "x")
    _psb(out, tiny_fil, "-resume")
    dats = sorted(glob.glob(os.path.join(work, "*_DM*.dat")))
    assert len(dats) == 4
    assert os.path.exists(os.path.join(work, "manifest.json"))
    mtimes = {p: os.path.getmtime(p) for p in dats}
    _psb(out, tiny_fil, "-resume")
    assert {p: os.path.getmtime(p) for p in dats} == mtimes
    with open(dats[1], "r+b") as f:
        f.truncate(os.path.getsize(dats[1]) // 2)
    _psb(out, tiny_fil, "-resume")
    assert _dat_bytes(work) == psb_reference


@pytest.mark.chaos
@pytest.mark.parametrize("hidm", [12.0, 30.0], ids=["one_method",
                                                   "two_methods"])
def test_survey_elastic_stage_kill_resume(tiny_fil, tmp_path, hidm):
    """SurveyConfig.elastic runs prepsubband's fan-out from the shard
    ledger: a kill mid-shard (the FaultInjector through the elastic
    process seam) resumes to artifacts byte-equal to a plain survey's.
    Up to DM 30 the DDplan has two methods, which share the workdir's
    ledger: each method's shards carry its own names (the JAX package's
    "dm0000" ids would find the second method's shards done)."""
    from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey

    def cfg(**kw):
        return SurveyConfig(lodm=8.0, hidm=hidm, nsub=8, zmax=0, numharm=2,
                            sigma=3.0, fold_top=0, rfi_time=0.4,
                            singlepulse=False, **kw)

    def arts(d):
        keep = (".dat", ".fft", ".cand", ".txt")
        return {os.path.basename(p): open(p, "rb").read()
                for p in sorted(glob.glob(os.path.join(d, "*")))
                if p.endswith(keep) or "_ACCEL_" in p}

    ref = str(tmp_path / "ref")
    run_survey([tiny_fil], cfg(), workdir=ref, device="cpu")
    el = elastic.ElasticConfig(shard_rows=1, heartbeat_interval=0.2,
                               lease_ttl=30.0)
    work = str(tmp_path / "el")
    fi = chaos.FaultInjector(kill_at="shard-computed", kill_after=2)
    with pytest.raises(chaos.SimulatedCrash):
        run_survey([tiny_fil], cfg(elastic=el, fault_injector=fi),
                   workdir=work, device="cpu")
    assert fi.fired == "shard-computed"
    assert "pre-rfifind" in fi.points_seen
    run_survey([tiny_fil], cfg(elastic=el), workdir=work, device="cpu")
    want = arts(ref)
    assert len([n for n in want if n.endswith(".dat")]) == \
        (6 if hidm == 12.0 else 16)
    assert arts(work) == want
    assert os.path.exists(os.path.join(work, "shards.json"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, argv):
    """One rank of the two-process run (spawned)."""
    from presto_tpu_torch.apps import prepsubband
    prepsubband.main(argv + ["-procid", str(rank)], device="cpu")


def test_two_process_gloo_run_writes_each_ranks_rows(tiny_fil, psb_reference,
                                                     tmp_path):
    """Two torch.multiprocessing ranks join over gloo through
    -coordinator (one CPU each, so a 2-device run: 2 DMs a rank), each
    writing only its own rows: together byte-equal to a one-process run.
    Its own 120 s limit."""
    work = str(tmp_path)
    argv = _argv(os.path.join(work, "x"), tiny_fil,
                 "-coordinator", "localhost:%d" % _free_port(), "-nproc", "2")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(argv,), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.time() + 120.0
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.time())):
            if time.time() > deadline:
                raise AssertionError("the two-process run passed 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert _dat_bytes(work) == psb_reference


def test_cluster_run_refuses_an_uneven_split(tiny_fil, tmp_path):
    """A multi-process run whose numdms does not divide its devices
    raises before it dedisperses (the JAX package's rule): 3 DMs over a
    2-process run, with the join replaced by one that answers 2 (no
    process group is made)."""
    import torch.distributed as dist
    argv = _argv(os.path.join(str(tmp_path), "x"), tiny_fil)
    argv[argv.index("-numdms") + 1] = "3"
    args = tprep.build_parser().parse_args(argv)
    real_init = tprep.pmesh.init_distributed
    try:
        tprep.pmesh.init_distributed = lambda *a: 2
        args.coordinator, args.nproc, args.procid = "localhost:1", 2, 0
        with pytest.raises(SystemExit, match="multi-process run needs"):
            tprep.run(args, device="cpu")
    finally:
        tprep.pmesh.init_distributed = real_init
    assert not dist.is_initialized()
    assert not glob.glob(os.path.join(str(tmp_path), "*.dat"))


def _global_mesh_rank(rank, work, coordinator):
    """One rank of the global_mesh run (spawned): rank 1 exits (os._exit)
    at its first pre-shard-commit point; rank 0 writes what its cluster
    saw to rank0.json."""
    import torch.distributed as dist
    host = "h%d" % rank
    fi = (chaos.FaultInjector(kill_at="pre-shard-commit", mode="exit")
          if rank == 1 else None)
    c = elastic.ElasticCluster(
        work, host, _loop_cfg(global_mesh=True, barrier_timeout=30.0,
                              lease_ttl=60.0, heartbeat_interval=0.5),
        fault_injector=fi)
    c.join(coordinator, 2, rank)
    joined = [c.distributed, dist.get_world_size()]
    compute = _touch_compute(work, host)

    def slow_compute(lease):
        time.sleep(0.3)            # both ranks lease before rank 0 is done
        return compute(lease)
    try:
        n = c.run(make_dm_shards(6, 1), slow_compute)
    finally:
        c.close()
    with open(os.path.join(work, "rank0.json"), "w") as f:
        json.dump(dict(joined=joined, committed=n,
                       distributed=c.distributed,
                       world=dist.get_world_size(), rank=dist.get_rank(),
                       epoch_bumps=c.stats["epoch_bumps"],
                       barrier_ok=c.barrier("after")), f)


def test_global_mesh_reforms_the_group_after_a_kill(tmp_path):
    """ElasticConfig.global_mesh: two spawned ranks join one gloo process
    group of 2 through the coordinator; rank 1 dies before its first
    commit; rank 0 reaps it, re-forms the group over itself (world size
    1, a working barrier), takes the dead rank's shard and commits all
    six.  Its own 120 s limit."""
    import multiprocessing
    work = str(tmp_path)
    coordinator = "localhost:%d" % _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_global_mesh_rank,
                         args=(rank, work, coordinator))
             for rank in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=120.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, chaos.FaultInjector.EXIT_CODE]
    got = json.load(open(os.path.join(work, "rank0.json")))
    assert got["joined"] == [True, 2]
    assert got["distributed"] and got["world"] == 1 and got["rank"] == 0
    assert got["barrier_ok"] and got["epoch_bumps"] >= 1
    assert got["committed"] == 6
    assert _rows(work) == ["row%03d.dat" % i for i in range(6)]


@pytest.mark.slow
@pytest.mark.chaos
def test_kill_one_of_two_real_processes(tiny_fil, psb_reference, tmp_path):
    """Two real processes run prepsubband -elastic -coordinator; one is
    hard-killed (os._exit) after its first shard is computed, before the
    commit; the survivor reaps it after the heartbeat timeout, re-admits
    its shard and finishes: every .dat byte-equal to a one-process run."""
    work = str(tmp_path)
    argv = _argv(os.path.join(work, "x"), tiny_fil, "-elastic",
                 "-shard-rows", "1", "-heartbeat-interval", "0.3",
                 "-lease-ttl", "30", "-barrier-timeout", "20",
                 "-coordinator", "localhost:%d" % _free_port(), "-nproc",
                 "2")
    code = ("import sys; from presto_tpu_torch.apps import prepsubband; "
            "prepsubband.main(sys.argv[1:], device='cpu')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    for rank in range(2):
        e = dict(env)
        if rank == 0:
            e[elastic.KILL_ENV] = "pre-shard-commit:1:exit"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code] + argv + ["-procid", str(rank)],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode == chaos.FaultInjector.EXIT_CODE, outs[0]
    assert procs[1].returncode == 0, outs[1]
    assert _dat_bytes(work) == psb_reference
    led = json.load(open(os.path.join(work, "shards.json")))
    assert led["epoch"] >= 1
    assert led["hosts"]["proc0"]["alive"] is False
