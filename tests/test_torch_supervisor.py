"""The port's fleet supervisor (serve/supervisor, apps/supervise) against
the JAX package's.

The JAX tests' fake process table (tests/test_supervisor.py) drives both
supervisors through the same scenarios (the same advice sequence, the
same heartbeats, kills and `now`): every decision, every emitted event
(kinds and fields, the wall-clock `ts` aside), every signal sent and the
bytes of `supervisor.json` must be equal.  The port spawns
``presto_tpu_torch.apps.serve`` with the replicas' ``-device`` and never
the JAX module, and its process-table sweep never adopts a JAX replica.
One real run: a router, a supervisor and port replica processes with
``-device cpu`` on a tiny survey scale 1 -> 2 -> 1 (spawn, then a SIGTERM
drain) and lose no job."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from presto_tpu.serve import supervisor as jsup

from presto_tpu_torch.serve import supervisor as psup


def _fake(mod):
    """The fake-process-table subclass of one package's supervisor
    (tests/test_supervisor.py's FakeSup): ``table[name] = pid`` is a
    live process, SIGKILL removes it, SIGTERM only records."""

    class FakeSup(mod.FleetSupervisor):
        def __init__(self, cfg, table=None):
            super().__init__(cfg)
            self.table = {} if table is None else table
            self.signals = []
            self._next_pid = 1000

        def _popen(self, name, argv):
            if getattr(self, "popen_fails", False):
                raise OSError("no such binary")
            self._next_pid += 1
            self.table[name] = self._next_pid
            return self._next_pid

        def _alive(self, name, pid):
            return pid is not None and self.table.get(name) == pid

        def _signal(self, name, pid, sig):
            self.signals.append((name, int(sig)))
            if sig == signal.SIGKILL:
                self.table.pop(name, None)

        def _reap(self, name):
            pass
    return FakeSup


def _mksup(mod, fleetdir, table=None, **kw):
    kw.setdefault("scale_up_after", 2)
    kw.setdefault("scale_down_after", 2)
    kw.setdefault("cooldown_s", 5.0)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("heartbeat_timeout", 10.0)
    sup = _fake(mod)(mod.SupervisorConfig(
        fleetdir=str(fleetdir), router_url="http://x", **kw), table=table)
    sup.advice = {"wanted_replicas": 1, "reason": "test",
                  "inputs": {"backlog_jobs": 0}}
    sup._fetch_advice = lambda: sup.advice
    return sup


def _advice(wanted, reason="t", **inputs):
    return {"wanted_replicas": wanted, "reason": reason, "inputs": inputs}


#: scenarios over the fake table: (config overrides, ops).  Ops:
#: ("advice", dict or None), ("step", now), ("hb", now[, state])
#: heartbeats every registered replica (in that state), ("exit",
#: "draining") ends every draining process,
#: ("kill", i) kills the i-th replica (sorted names), ("owners", {i: n})
#: campaign lease counts, ("popen_fails",), ("set", attr, value) on cfg,
#: ("restart", now) drops the supervisor and adopts on a new one over the
#: same table.
SCENARIOS = {
    "hysteresis-then-up": ({}, [
        ("step", 0.0), ("step", 1.0), ("hb", 1.5), ("step", 2.0)]),
    "cooldown-holds": ({}, [
        ("step", 0.0), ("step", 1.0), ("hb", 1.5),
        ("advice", _advice(3, "backlog")), ("step", 2.0), ("step", 3.0),
        ("step", 7.0)]),
    "advisory-inputs": ({}, [
        ("advice", _advice(2, "backlog-drain", backlog_jobs=7)),
        ("step", 0.0), ("step", 1.0)]),
    "drain-youngest": ({"cooldown_s": 0.0}, [
        ("advice", _advice(3)), ("step", 0.0), ("step", 1.0), ("hb", 1.5),
        ("step", 2.0), ("advice", _advice(1, "idle")), ("step", 3.0),
        ("step", 4.0), ("exit", "draining"), ("step", 5.0)]),
    "drain-timeout": ({"cooldown_s": 0.0, "drain_timeout_s": 10.0}, [
        ("advice", _advice(2)), ("step", 0.0), ("step", 1.0), ("hb", 1.5),
        ("step", 2.0), ("advice", _advice(1, "idle")), ("step", 3.0),
        ("step", 4.0), ("step", 20.0), ("step", 21.0)]),
    "dead-replaced": ({"cooldown_s": 100.0}, [
        ("step", 0.0), ("step", 1.0), ("hb", 1.5), ("step", 2.0),
        ("kill", 0), ("step", 3.0)]),
    "wedged-replaced": ({"heartbeat_timeout": 5.0}, [
        ("step", 0.0), ("step", 1.0), ("hb", 2.0), ("step", 3.0),
        ("step", 10.0)]),
    "spawn-fails": ({}, [
        ("popen_fails",), ("step", 0.0), ("step", 1.0)]),
    "spawn-deadline": ({"spawn_timeout_s": 30.0}, [
        ("step", 0.0), ("step", 1.0), ("step", 40.0)]),
    "unreachable": ({}, [
        ("advice", None), ("step", 0.0), ("step", 1.0), ("step", 2.0)]),
    "restart-adopts": ({}, [
        ("advice", _advice(2)), ("step", 0.0), ("step", 1.0), ("kill", 0),
        ("restart", 10.0)]),
    "preempt": ({"preempt_fraction": 0.5, "preempt_interval_s": 10.0,
                 "max_replicas": 8, "cooldown_s": 0.0,
                 "heartbeat_timeout": 100.0}, [
        ("advice", _advice(4)), ("step", 0.0), ("step", 1.0), ("hb", 1.5),
        ("step", 2.0), ("owners", {0: 1, 1: 3}), ("step", 3.0),
        ("step", 5.0), ("owners", {0: 1}), ("step", 14.0)]),
    # the real run's order under load: the backlog empties while the
    # second replica still starts, and the drain takes the only UP one
    "drain-while-spawning": ({"cooldown_s": 0.0}, [
        ("step", 0.0), ("step", 1.0), ("hb", 1.5), ("step", 2.0),
        ("advice", _advice(2, "backlog-drain", backlog_jobs=2)),
        ("step", 3.0), ("step", 4.0), ("hb", 4.5, "up"),
        ("advice", _advice(1, "idle")), ("step", 5.0), ("step", 6.0),
        ("exit", "draining"), ("step", 7.0), ("hb", 7.5), ("step", 8.0)]),
    "preempt-floor": ({"cooldown_s": 0.0}, [
        ("advice", _advice(2)), ("step", 0.0), ("step", 1.0), ("hb", 1.5),
        ("owners", {0: 1, 1: 1}), ("step", 2.0),
        ("set", "preempt_fraction", 0.1), ("step", 3.0)]),
}


def _run(mod, fleetdir, cfg, ops):
    """Play one scenario on one package's fake supervisor: (decisions,
    events without ts, signals, supervisor.json bytes)."""
    table = {}
    sup = _mksup(mod, fleetdir, table=table, **cfg)
    decisions, names = [], []
    for op in ops:
        if op[0] == "advice":
            if op[1] is None:
                sup._fetch_advice = lambda: None
            else:
                sup.advice = op[1]
        elif op[0] == "step":
            d = dict(sup.step(now=op[1]))
            decisions.append(d)
            names = sorted(set(names) | set(sup.replicas()))
        elif op[0] == "hb":
            for name, row in sup.replicas().items():
                if op[2:] in ((), (row["state"],)):
                    sup.ledger.heartbeat(name, 0, now=op[1])
        elif op[0] == "exit":
            for name, row in sup.replicas().items():
                if row["state"] == mod.DRAINING:
                    table.pop(name, None)
        elif op[0] == "kill":
            table.pop(sorted(sup.replicas())[op[1]], None)
        elif op[0] == "owners":
            own = {names[i]: n for i, n in op[1].items()}
            sup.ledger.lease_owners = lambda tenant=None, own=own: own
        elif op[0] == "popen_fails":
            sup.popen_fails = True
        elif op[0] == "set":
            setattr(sup.cfg, op[1], op[2])
        elif op[0] == "restart":
            signals = sup.signals
            sup = _mksup(mod, fleetdir, table=table, **cfg)
            sup.signals = signals
            decisions.append({"adopted": sup.adopt(now=op[1])})
    sup.events.close()
    events = []
    with open(mod.events_path(str(fleetdir))) as f:
        for ln in f:
            if ln.strip():
                ev = json.loads(ln)
                ev.pop("ts", None)
                events.append(ev)
    registry = None
    if os.path.exists(mod.registry_path(str(fleetdir))):
        with open(mod.registry_path(str(fleetdir)), "rb") as f:
            registry = f.read()
    return decisions, events, sup.signals, registry


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_events_and_registry_equal_jax(tmp_path, name):
    """The decision machine of both supervisors on the same scenario:
    the same decisions, events (kinds and fields), signals and
    supervisor.json bytes."""
    cfg, ops = SCENARIOS[name]
    port = _run(psup, tmp_path / "port", cfg, ops)
    ref = _run(jsup, tmp_path / "jax", cfg, ops)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert port[0], "no decision made"


def test_drain_while_spawning_drains_the_up_replica(tmp_path):
    """The sequence behind test_real_replicas_scale_one_two_one's race,
    on the fake table: a scale-up spawns a second replica, the backlog
    empties before it reports up, and the drain takes the youngest UP
    replica, which is the first, while the second still starts; the
    second reports up afterwards.  Both packages decide alike, so the
    real run waits for both ups as well as the drain."""
    cfg, ops = SCENARIOS["drain-while-spawning"]
    for mod in (psup, jsup):
        events = _run(mod, tmp_path / mod.__name__, cfg, ops)[1]
        assert [(e["kind"], e["replica"]) for e in events
                if e["kind"] in ("supervisor-spawn", "supervisor-up",
                                 "supervisor-drain",
                                 "supervisor-drained")] == [
            ("supervisor-spawn", "sup-0001"),
            ("supervisor-up", "sup-0001"),
            ("supervisor-spawn", "sup-0002"),
            ("supervisor-drain", "sup-0001"),
            ("supervisor-drained", "sup-0001"),
            ("supervisor-up", "sup-0002")]


def test_scenarios_cover_every_actuation(tmp_path):
    """The scenarios above reach every supervisor event kind the JAX
    tests reach on the fake table (start/stop/step-error need the loop)."""
    kinds = set()
    for i, (cfg, ops) in enumerate(SCENARIOS.values()):
        kinds |= {e["kind"] for e in _run(psup, tmp_path / str(i), cfg,
                                          ops)[1]}
    assert kinds >= {"supervisor-spawn", "supervisor-up",
                     "supervisor-hold", "supervisor-drain",
                     "supervisor-drained", "supervisor-drain-timeout",
                     "supervisor-replace", "supervisor-spawn-failed",
                     "supervisor-adopt", "campaign-preempt"}


def test_spawn_argv_names_the_port_module(tmp_path):
    """The port spawns `-m presto_tpu_torch.apps.serve` with the
    replicas' -device (cuda by default) and never the JAX module."""
    sup = psup.FleetSupervisor(psup.SupervisorConfig(
        fleetdir=str(tmp_path), router_url="http://x"))
    argv = sup._spawn_argv("sup-0001")
    assert argv[1:3] == ["-m", "presto_tpu_torch.apps.serve"]
    assert "presto_tpu.apps.serve" not in argv
    i = argv.index("-device")
    assert argv[i + 1] == "cuda"
    sup.cfg.device = "cpu"
    assert sup._spawn_argv("x")[sup._spawn_argv("x").index("-device")
                                + 1] == "cpu"
    # the JAX supervisor's argv is the JAX module's: the two never mix
    jargv = jsup.FleetSupervisor(jsup.SupervisorConfig(
        fleetdir=str(tmp_path / "j"), router_url="http://x"))._spawn_argv(
        "sup-0001")
    assert "presto_tpu.apps.serve" in jargv and "-device" not in jargv
    sup.events.close()


def test_find_pid_ignores_a_jax_replica(tmp_path):
    """`find_pid_by_replica` matches the port's replica module as its own
    argv token, so a JAX replica's cmdline (`presto_tpu.apps.serve`) is
    never adopted; the JAX sweep finds it, and the port's finds a port
    replica of the same name."""
    code = "import time; time.sleep(60)"
    procs = []
    try:
        for module, name in (("presto_tpu.apps.serve", "sup-jax"),
                             ("presto_tpu_torch.apps.serve", "sup-port")):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, module, "-replica", name]))
        deadline = time.time() + 20
        while time.time() < deadline and (
                jsup.FleetSupervisor.find_pid_by_replica("sup-jax") is None
                or psup.FleetSupervisor.find_pid_by_replica("sup-port")
                is None):
            time.sleep(0.05)
        assert jsup.FleetSupervisor.find_pid_by_replica("sup-jax") \
            == procs[0].pid
        assert psup.FleetSupervisor.find_pid_by_replica("sup-jax") is None
        assert psup.FleetSupervisor.find_pid_by_replica("sup-port") \
            == procs[1].pid
        assert b"presto_tpu.apps.serve" not in \
            psup.SERVE_MODULE.encode().split(b"\0")
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


def test_supervise_cli_needs_a_card_unless_cpu(tmp_path):
    """presto-supervise refuses a cuda fleet without a card before
    spawning anything; the supervisor process itself never needs one."""
    from presto_tpu_torch.apps import supervise
    with pytest.raises(RuntimeError, match="CUDA"):
        supervise.main(["-fleet", str(tmp_path / "f"), "-router",
                        "http://127.0.0.1:1"])
    assert not os.path.exists(str(tmp_path / "f"))


# ----------------------------------------------------------------------
# one real run: port replica processes on the CPU, 1 -> 2 -> 1
# ----------------------------------------------------------------------

REAL_CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
            "numharm": 2, "fold_top": 0, "singlepulse": False,
            "skip_rfifind": True}


def _until(cond, timeout, poll=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST",
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def test_real_replicas_scale_one_two_one(tmp_path):
    """A router and a supervisor over one fleet directory with port
    replicas (`-device cpu`): the first replica spawns at min 1; two
    tiny survey jobs make the /scale advisory (5 s a job of unknown
    bucket over a 6 s drain target) want 2, so a second replica spawns;
    both jobs are done once each; idle, the supervisor drains back to 1
    by SIGTERM (no SIGKILL).  Bounded: every wait has its own deadline
    (generous: a loaded machine took 60 s for the whole test, an idle
    one 20 s), 240 s in all."""
    from tools.serve_loadgen import make_beams
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http)
    t0 = time.time()
    beam = make_beams(str(tmp_path / "beams"), 1, nsamp=4096, nchan=8)[0]
    fleetdir = str(tmp_path / "fleet")
    router = FleetRouter(RouterConfig(
        fleetdir=fleetdir, poll_s=0.2, heartbeat_timeout=15.0,
        scale_target_drain_s=6.0, scale_max_replicas=2)).start()
    httpd = start_http(router)
    base = "http://%s:%d" % httpd.server_address[:2]
    sup = psup.FleetSupervisor(psup.SupervisorConfig(
        fleetdir=fleetdir, router_url=base, poll_s=0.2,
        scale_up_after=2, scale_down_after=3, cooldown_s=1.0,
        min_replicas=1, max_replicas=2, drain_timeout_s=30.0,
        spawn_timeout_s=120.0, heartbeat_timeout=60.0, hb_interval=0.2,
        hb_timeout=15.0, device="cpu",
        replica_args=["-inflight", "1", "-no-prewarm"])).start()
    led = JobLedger(fleetdir)
    try:
        assert _until(lambda: len(router.ready_replicas()) == 1, 90)
        ids = []
        for _ in range(2):
            code, out = _post(base + "/submit",
                              {"rawfiles": [beam],
                               "config": dict(REAL_CFG)})
            assert code == 202, out
            ids.append(out["job_id"])
        assert _until(lambda: all(
            (led.view(j) or {}).get("state") == "done" for j in ids), 120)
        events = lambda: [json.loads(ln) for ln in open(
            psup.events_path(fleetdir)) if ln.strip()]
        # the drain may take the first replica while the second still
        # starts (test_drain_while_spawning_drains_the_up_replica): the
        # run ends on both ups and the drain, whichever comes last
        assert _until(lambda: (lambda k: k.count("supervisor-up") >= 2
                               and "supervisor-drained" in k)(
            [e["kind"] for e in events()]), 90)
    finally:
        sup.stop()
        sup.drain_all(timeout=20.0)
        httpd.shutdown()
        router.stop()
    evs = events()
    kinds = [e["kind"] for e in evs]
    spawns = [e for e in evs if e["kind"] == "supervisor-spawn"]
    assert len(spawns) == 2
    assert spawns[1]["wanted"] == 2 and \
        spawns[1]["inputs"]["backlog_jobs"] >= 1
    assert kinds.count("supervisor-up") == 2
    assert kinds.count("supervisor-drain") == 1
    assert "supervisor-drain-timeout" not in kinds
    state = led.read()
    assert all(state["jobs"][j]["state"] == "done"
               and state["jobs"][j]["redos"] == 0 for j in ids)
    usage = led.usage.raw_rows()
    assert sorted(u["job_id"] for u in usage) == sorted(ids)
    assert time.time() - t0 < 240.0
