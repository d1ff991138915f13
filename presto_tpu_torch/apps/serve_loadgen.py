"""serve_loadgen: replay synthetic beams against the port's presto-serve
(or a whole fleet) and report throughput + latency percentiles from
/metrics.

Counterpart of ``tools/serve_loadgen.py``, with every mode and flag of
it.  It generates N same-shaped synthetic beams (so they coalesce into
one plan bucket), submits them at a fixed rate over the HTTP protocol,
polls until every job is terminal, then prints a JSON report:
submitted/done/failed counts, wall time, jobs/s, and the service's own
job_total p50/p99 from /metrics.

  # against a running server
  python -m presto_tpu_torch.apps.serve_loadgen -url http://127.0.0.1:8787

  # self-contained: spin up an in-process service on the card first
  python -m presto_tpu_torch.apps.serve_loadgen -selfhost -beams 4 -rate 2

  # multi-replica sustained load: router + N fleet replicas leasing
  # from one shared job ledger (real `presto_tpu_torch.apps.serve
  # -fleet` processes with -subprocess)
  python -m presto_tpu_torch.apps.serve_loadgen -replicas 2 -subprocess

  # the verdict modes: stacked-vs-per-job batches (-stacked), the
  # discovery DAG against the hand-driven CLI sequence (-dag), one
  # cross-process trace (-obs), the SLO observatory's two-tenant spike
  # (-slo), the supervisor's 1 -> N -> 1 episode (-supervisor) and the
  # campaign engine (-campaign)
  python -m presto_tpu_torch.apps.serve_loadgen -stacked -Ns 1,4

Every service, replica and CLI subprocess the tool starts runs on
``-device`` (default ``cuda``; without a card it raises, nothing falls
back): the in-process services get it as ``SearchService(device=)``,
each replica process as its ``-device`` flag, the supervisor as
``SupervisorConfig.device``, and the CLI reference of -dag runs its
prepfold and get_TOAs in subprocesses through their ``main(argv,
device=)``.  Subprocesses import the port from this checkout
(``PYTHONPATH``).

What the port counts where the JAX tool read jaxtel: obs/devtel's
``transfer_snapshot``.  Its ``dispatches`` are the device chains the
survey and fold paths note (a stacked chain is one), and its
``compiles`` are the kernel-library builds (nvcc, once a source per
build directory) and the search plans a service constructs; the
stacked verdict's ``compiles_no_greater`` and ``fewer_dispatches``
compare those.  Usage metering is always on in the port (serve/usage),
so the -slo verdict's reference arm is a fleet without SLO specs, and
its check ``reference_arm_had_no_slo`` (no burn alert, no slo.json)
stands where the JAX record has ``unmetered_arm_wrote_no_usage``; its
latency objective is the JAX tool's 2 s or, where shorter, the reference
arm's fastest job end to end (``slo_objective``: the card runs the
spike's jobs in a fraction of 2 s, and a spike in which no job is late
tests no alert).

``-commit`` writes the verdict to ``records/torch/<name>.json`` of this
checkout (the JAX tool's file names: SERVE_BATCH_r10, DAG_r11, OBS_r12,
SLO_r14, SUPERVISOR_r16, CAMPAIGN_r17), never the JAX tool's records at
the repository's root; on a card the report names it and its power
limit.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

#: the checkout this module was imported from (subprocesses import the
#: port from it)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: where -commit writes, under REPO
RECORDS_DIR = os.path.join("records", "torch")


def _http_json(url: str, payload=None) -> dict:
    data = (json.dumps(payload).encode() if payload is not None
            else None)
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _device(device) -> str:
    """The device's name after resolving it (a cuda device without a
    card raises here, before anything starts)."""
    from presto_tpu_torch.search.accel import resolve_device
    return str(resolve_device(device))


def _subprocess_env() -> dict:
    """The environment of the tool's subprocesses: this checkout first
    on PYTHONPATH, so they import the port the tool runs."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path
                                                if path else ""))


def _write_beam(path: str, nsamp: int, nchan: int, dt: float, f0: float,
                dm: float, seed: int) -> None:
    from presto_tpu_torch.models.synth import FakeSignal, fake_filterbank_file
    sig = FakeSignal(f=f0, dm=dm, shape="gauss", width=0.08, amp=0.8)
    fake_filterbank_file(path, nsamp, dt, nchan, 400.0, 1.0, sig,
                         noise_sigma=2.0, nbits=8, seed=seed)


def make_beams(outdir: str, n: int, nsamp: int = 1 << 14,
               nchan: int = 16, dt: float = 5e-4, f0: float = 23.0,
               dm: float = 55.0):
    """n same-shaped synthetic beams (identical geometry -> one plan
    bucket), each with its own noise realization: the JAX tool's bytes.
    The beams are written by one thread each (NumPy releases the GIL in
    the noise and the pulse profiles, so a full-width set takes about
    one beam's time)."""
    paths = []
    for i in range(n):
        path = os.path.join(outdir, "beam%03d" % i, "beam.fil")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        paths.append(path)
    with ThreadPoolExecutor(max_workers=max(1, n)) as pool:
        for f in [pool.submit(_write_beam, path, nsamp, nchan, dt, f0, dm,
                              100 + i) for i, path in enumerate(paths)]:
            f.result()
    return paths


def run_loadgen(url: str, beams, rate: float = 2.0,
                config: dict = None, timeout: float = 600.0) -> dict:
    """Submit `beams` (paths) at `rate` jobs/s; block until terminal;
    return the report dict."""
    config = config or {"lodm": 45.0, "hidm": 65.0, "nsub": 16,
                        "zmax": 0, "numharm": 4, "fold_top": 0,
                        "singlepulse": False, "skip_rfifind": True}
    t0 = time.time()
    job_ids = []
    for i, beam in enumerate(beams):
        target = t0 + i / max(rate, 1e-6)
        if target > time.time():
            time.sleep(target - time.time())
        view = _http_json(url + "/submit",
                          {"rawfiles": [beam], "config": config})
        job_ids.append(view["job_id"])
    deadline = time.time() + timeout
    done = {}
    while time.time() < deadline and len(done) < len(job_ids):
        for jid in job_ids:
            if jid in done:
                continue
            view = _http_json(url + "/jobs/" + jid)
            if view["status"] in ("done", "failed", "timeout"):
                done[jid] = view["status"]
        time.sleep(0.25)
    wall = time.time() - t0
    metrics = _http_json(url + "/metrics")
    lat = metrics.get("latency", {}).get("job_total", {})
    n_done = sum(1 for s in done.values() if s == "done")
    return {
        "submitted": len(job_ids),
        "done": n_done,
        "failed": len(done) - n_done,
        "unfinished": len(job_ids) - len(done),
        "wall_s": round(wall, 3),
        "throughput_jobs_per_s": round(n_done / wall, 4) if wall else 0,
        "p50_s": lat.get("p50_s", 0.0),
        "p99_s": lat.get("p99_s", 0.0),
        "batch_occupancy": metrics["scheduler"]["batch_occupancy"],
        "plan_hit_rate": metrics["plans"]["hit_rate"],
    }


# ----------------------------------------------------------------------
# multi-replica (fleet) mode
# ----------------------------------------------------------------------

DEFAULT_FLEET_CONFIG = {"lodm": 45.0, "hidm": 65.0, "nsub": 16,
                        "zmax": 0, "numharm": 4, "fold_top": 0,
                        "singlepulse": False, "skip_rfifind": True,
                        "durable_stages": True}


def _wait_ready(router, replicas: int, timeout: float, poll: float):
    deadline = time.time() + timeout
    while time.time() < deadline:
        router.poll_replicas()
        if len(router.ready_replicas()) >= replicas:
            break
        time.sleep(poll)


def start_fleet(workdir: str, replicas: int, high_water: int = 256,
                plan_store: bool = True, max_inflight: int = 2,
                heartbeat_timeout: float = 3.0, device="cuda"):
    """Spin up an in-process fleet: router + N replicas leasing from
    one shared job ledger, each service on ``device``.  Returns
    (router, router_url, members, teardown) where members is
    [(service, replica, httpd)] and teardown() drains everything."""
    from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http as router_http)
    from presto_tpu_torch.serve.server import SearchService, start_http
    fleetdir = os.path.join(workdir, "fleet")
    store_dir = (os.path.join(fleetdir, "planstore")
                 if plan_store else None)
    router = FleetRouter(RouterConfig(
        fleetdir=fleetdir, high_water=high_water, poll_s=0.3,
        heartbeat_timeout=heartbeat_timeout)).start()
    rhttpd = router_http(router)
    url = "http://%s:%d" % rhttpd.server_address[:2]
    members = []
    for i in range(replicas):
        svc = SearchService(os.path.join(workdir, "rep%d" % i),
                            queue_depth=max(8, high_water),
                            plan_store_dir=store_dir,
                            device=device).start()
        httpd = start_http(svc)
        addr = "http://%s:%d" % httpd.server_address[:2]
        cfg = FleetConfig(fleetdir=fleetdir, replica="rep%d" % i,
                          lease_ttl=60.0, heartbeat_s=0.25,
                          heartbeat_timeout=heartbeat_timeout,
                          poll_s=0.05, max_inflight=max_inflight)
        rep = FleetReplica(svc, cfg, addr=addr).start()
        members.append((svc, rep, httpd))
    _wait_ready(router, replicas, 60.0, 0.2)

    def teardown():
        for svc, rep, httpd in members:
            httpd.shutdown()
            svc.shutdown(drain=True, timeout=30.0)
        rhttpd.shutdown()
        router.stop()

    return router, url, members, teardown


def start_fleet_procs(workdir: str, replicas: int,
                      high_water: int = 256,
                      timeout: float = 120.0, device="cuda"):
    """The process-isolated twin of start_fleet: each replica is a
    real `python -m presto_tpu_torch.apps.serve -fleet` process on
    ``device`` (its own interpreter and CUDA context — the production
    topology), torn down via SIGTERM so every run also exercises the
    graceful drain + tombstone path."""
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http as router_http)
    fleetdir = os.path.join(workdir, "fleet")
    router = FleetRouter(RouterConfig(
        fleetdir=fleetdir, high_water=high_water, poll_s=0.3,
        heartbeat_timeout=5.0)).start()
    rhttpd = router_http(router)
    url = "http://%s:%d" % rhttpd.server_address[:2]
    env = _subprocess_env()
    procs = []
    for i in range(replicas):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "presto_tpu_torch.apps.serve",
             "-fleet", fleetdir, "-replica", "rep%d" % i,
             "-workdir", os.path.join(workdir, "rep%d" % i),
             "-port", "0", "-hb-interval", "0.25",
             "-hb-timeout", "5", "-inflight", "2",
             "-depth", str(max(8, high_water)), "-device", str(device)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
    _wait_ready(router, replicas, timeout, 0.5)

    def teardown():
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        rhttpd.shutdown()
        router.stop()

    return router, url, procs, teardown


def _scrape_replica(addr: str) -> dict:
    """One replica process's report row over HTTP (subprocess mode), or
    None when it does not answer."""
    try:
        m = _http_json(addr.rstrip("/") + "/metrics")
    except Exception:
        return None
    fleet_counters = {}
    try:
        with urllib.request.urlopen(
                addr.rstrip("/") + "/metrics?format=prometheus",
                timeout=10) as r:
            for line in r.read().decode().splitlines():
                if line.startswith("fleet_jobs_"):
                    name, _, v = line.partition(" ")
                    fleet_counters[name] = float(v)
    except Exception:
        pass
    lat = m.get("latency", {}).get("job_exec", {})
    return {
        "jobs_committed": int(fleet_counters.get(
            "fleet_jobs_committed_total", 0)),
        "jobs_leased": int(fleet_counters.get(
            "fleet_jobs_leased_total", 0)),
        "p50_s": lat.get("p50_s", 0.0),
        "p99_s": lat.get("p99_s", 0.0),
        "plan_misses": m["plans"]["misses"],
        "plan_hits": m["plans"]["hits"],
    }


def run_fleet_loadgen(workdir: str, beams, replicas: int = 2,
                      rate: float = 4.0, config: dict = None,
                      timeout: float = 900.0,
                      subprocess_mode: bool = False,
                      device="cuda") -> dict:
    """Sustained load against a fleet of `replicas` members on
    ``device`` (in-process threads by default; real replica processes
    with subprocess_mode); returns throughput + per-replica p50/p99
    (from the obs latency histograms) + fleet/ledger accounting."""
    config = config or dict(DEFAULT_FLEET_CONFIG)
    if subprocess_mode:
        router, url, procs, teardown = start_fleet_procs(
            workdir, replicas, high_water=max(64, 4 * len(beams)),
            device=device)
        members = []
    else:
        router, url, members, teardown = start_fleet(
            workdir, replicas, high_water=max(64, 4 * len(beams)),
            device=device)
        procs = []
    try:
        t0 = time.time()
        job_ids = []
        for i, beam in enumerate(beams):
            target = t0 + i / max(rate, 1e-6)
            if target > time.time():
                time.sleep(target - time.time())
            view = _http_json(url + "/submit",
                              {"rawfiles": [beam], "config": config})
            job_ids.append(view["job_id"])
        ok = router.wait(job_ids, timeout=timeout)
        wall = time.time() - t0
        states = [router.status(j)["state"] for j in job_ids]
        n_done = states.count("done")
        per_replica = {}
        for svc, rep, _h in members:
            lat = svc.latency.snapshot().get("job_exec", {})
            reg = svc.obs.metrics
            per_replica[rep.replica] = {
                "jobs_committed": int(reg.get(
                    "fleet_jobs_committed_total").value),
                "jobs_leased": int(reg.get(
                    "fleet_jobs_leased_total").value),
                "p50_s": lat.get("p50_s", 0.0),
                "p99_s": lat.get("p99_s", 0.0),
                "plan_misses": svc.plans.stats()["misses"],
                "plan_hits": svc.plans.stats()["hits"],
            }
        if not members:       # subprocess mode: scrape over HTTP
            for host, addr in sorted(router._replica_addrs().items()):
                row = _scrape_replica(addr) if addr else None
                if row is not None:
                    per_replica[host] = row
        return {
            "replicas": replicas,
            "device": str(device),
            "submitted": len(job_ids),
            "done": n_done,
            "failed": states.count("failed"),
            "unfinished": 0 if ok else len(job_ids) - n_done
            - states.count("failed"),
            "wall_s": round(wall, 3),
            "throughput_jobs_per_s": round(n_done / wall, 4)
            if wall else 0,
            "fleet": router.metrics(),
            "per_replica": per_replica,
            # a replica process that died before the teardown
            "replica_exits": [p.poll() for p in procs],
        }
    finally:
        teardown()


# ----------------------------------------------------------------------
# stacked-vs-per-job verdict mode
# ----------------------------------------------------------------------

STACKED_CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
               "numharm": 2, "fold_top": 0, "singlepulse": True,
               "skip_rfifind": True, "durable_stages": True}


def _stacked_arm(workdir, beam, n_jobs, stacked, config,
                 timeout=900.0, device="cuda"):
    """One fresh service arm on ``device``: N same-bucket jobs submitted
    BEFORE the scheduler starts (provable coalescing), executed per-job
    or stacked.  Returns counters + per-job artifact digests."""
    from presto_tpu_torch.obs import devtel
    from presto_tpu_torch.serve.fleet import artifact_digests
    from presto_tpu_torch.serve.server import SearchService
    svc = SearchService(workdir, queue_depth=max(16, 2 * n_jobs),
                        stacked=stacked, device=device)
    t0 = time.time()
    jids = [svc.submit({"rawfiles": [beam], "config": config})
            ["job_id"] for _ in range(n_jobs)]
    svc.start()
    ok = svc.wait(jids, timeout=timeout)
    wall = time.time() - t0
    jobs = [svc.get_job(j) for j in jids]
    snap = devtel.transfer_snapshot(svc.obs)
    stats = svc.scheduler.stats()
    out = {
        "stacked": bool(stacked),
        "jobs": n_jobs,
        "done": sum(1 for j in jobs if j.status == "done"),
        "ok": bool(ok),
        "wall_s": round(wall, 3),
        "jobs_per_s": round(n_jobs / wall, 4) if wall else 0.0,
        "compiles": snap["compiles"],
        "dispatches": snap["dispatches"],
        "stacked_batches": stats["stacked_batches"],
        "stacked_jobs": stats["stacked_jobs"],
        "degrades": stats["degrades"],
        "plan_misses": svc.plans.stats()["misses"],
        "digests": [artifact_digests(j.workdir) for j in jobs],
    }
    svc.stop()
    return out


def run_stacked_loadgen(workdir: str, Ns=(1, 4, 8),
                        nsamp: int = 4096, nchan: int = 8,
                        config: dict = None,
                        timeout: float = 900.0, device="cuda") -> dict:
    """Stacked-vs-per-job A/B at each batch size in Ns on ``device``:
    fresh service per arm, byte-equality pinned across arms and against
    the batch driver's reference run, compile + dispatch counts
    recorded.  The verdict requires, at every N > 1: identical
    artifacts, strictly fewer device-chain dispatches stacked, and
    compiles no greater (the plan cache already holds compiles flat
    across a per-job same-bucket batch — the dispatch collapse is the
    stacking win)."""
    os.environ.setdefault("PRESTO_TORCH_DISABLE_MESH", "1")
    config = dict(config or STACKED_CFG)
    beam = make_beams(workdir, 1, nsamp=nsamp, nchan=nchan)[0]
    from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey
    from presto_tpu_torch.serve.fleet import artifact_digests
    refdir = os.path.join(workdir, "reference")
    run_survey([beam], SurveyConfig(**config), refdir, device=device)
    ref = artifact_digests(refdir)
    runs = []
    checks = []
    for n in Ns:
        per_job = _stacked_arm(
            os.path.join(workdir, "n%d-perjob" % n), beam, n,
            False, config, timeout=timeout, device=device)
        stacked = _stacked_arm(
            os.path.join(workdir, "n%d-stacked" % n), beam, n,
            True, config, timeout=timeout, device=device)
        byte_equal = all(d == ref for d in
                         per_job.pop("digests")
                         + stacked.pop("digests"))
        check = {
            "n": n,
            "byte_equal_reference": byte_equal,
            "fewer_dispatches": (
                stacked["dispatches"] < per_job["dispatches"]
                if n > 1 else
                stacked["dispatches"] <= per_job["dispatches"]),
            "compiles_no_greater": (stacked["compiles"]
                                    <= per_job["compiles"]),
            "stacked_ran": (stacked["stacked_jobs"] >= n
                            if n > 1 else True),
            "all_done": (per_job["done"] == n
                         and stacked["done"] == n),
        }
        checks.append(check)
        runs.append({"n": n, "per_job": per_job,
                     "stacked": stacked})
        print("# N=%d  per-job: %d dispatches / %d compiles   "
              "stacked: %d dispatches / %d compiles  byte_equal=%s"
              % (n, per_job["dispatches"], per_job["compiles"],
                 stacked["dispatches"], stacked["compiles"],
                 byte_equal), file=sys.stderr)
    return {
        "mode": "stacked",
        "device": str(device),
        "config": config,
        "beam": {"nsamp": nsamp, "nchan": nchan},
        "reference_artifacts": len(ref),
        "runs": runs,
        "checks": checks,
        "verdict": ("PASS" if all(all(c[k] for k in c if k != "n")
                                  for c in checks) else "FAIL"),
        "caveat": (
            "The pinned wins are the dispatch count (one stacked chain "
            "replaces N per-job chains) and the compile count staying "
            "flat while occupancy grows; the beam is tiny, so jobs/s "
            "measures the host's per-job overhead, not the card."),
    }


# ----------------------------------------------------------------------
# discovery-DAG verdict mode
# ----------------------------------------------------------------------

DAG_CFG = {"lodm": 50.0, "hidm": 60.0, "nsub": 8, "zmax": 0,
           "numharm": 4, "singlepulse": False, "skip_rfifind": True}


def _make_dag_beam(workdir: str) -> str:
    from presto_tpu_torch.models.synth import FakeSignal, fake_filterbank_file
    path = os.path.join(workdir, "dagbeam", "beam.fil")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sig = FakeSignal(f=23.0, dm=55.0, shape="gauss", width=0.08,
                     amp=2.0)
    fake_filterbank_file(path, 16384, 5e-4, 8, 400.0, 1.0, sig,
                         noise_sigma=2.0, nbits=8, seed=101)
    return path


def _cli_argv(module: str, argv, device=None):
    """A CLI as a subprocess: ``python -m module argv``, or, for the
    CLIs that run on a device, ``module.main(argv, device=device)`` in a
    process of its own (their command lines take no device)."""
    if device is None:
        return [sys.executable, "-m", module] + list(argv)
    code = ("import sys; from %s import main; "
            "sys.exit(main(sys.argv[1:], device=%r))" % (module, device))
    return [sys.executable, "-c", code] + list(argv)


def _cli_reference(beam: str, workdir: str, device="cuda") -> dict:
    """The hand-driven CLI sequence as REAL subprocesses with relative
    paths (a human's cwd-run): search stages on ``device``, ACCEL_sift,
    prepfold per surviving candidate, get_TOAs (the last two on
    ``device``).  Returns the reference dir, candidate list, and
    artifact bytes."""
    from presto_tpu_torch.pipeline.sifting import (select_fold_candidates,
                                                   sift_candidates)
    from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey
    refdir = os.path.join(workdir, "cli-reference")
    run_survey([beam], SurveyConfig(**dict(DAG_CFG, fold_top=0,
                                           durable_stages=True)),
               refdir, device=device)
    env = _subprocess_env()
    subprocess.run(_cli_argv("presto_tpu_torch.apps.accel_sift",
                             ["-o", "cands_sifted.txt"]),
                   cwd=refdir, check=True, capture_output=True, env=env)
    accs = sorted(glob.glob(os.path.join(refdir, "*_ACCEL_0")))
    cl = sift_candidates(accs, numdms_min=2, low_DM_cutoff=2.0)
    top = select_fold_candidates(cl, fold_top=3)
    pfds = []
    for i, c in enumerate(top):
        acc = os.path.basename(os.path.join(c.path or refdir,
                                            c.filename))
        subprocess.run(
            _cli_argv("presto_tpu_torch.apps.prepfold",
                      ["-accelfile", acc + ".cand", "-accelcand",
                       str(c.candnum), "-dm", "%.2f" % c.DM, "-nosearch",
                       "-noplot", "-o", "fold_cand%d" % (i + 1),
                       acc.split("_ACCEL_")[0] + ".dat"], str(device)),
            cwd=refdir, check=True, capture_output=True, env=env)
        pfds.append("fold_cand%d.pfd" % (i + 1))
    subprocess.run(_cli_argv("presto_tpu_torch.apps.get_toas",
                             ["-n", "1", "-o", "toas.tim"] + pfds,
                             str(device)),
                   cwd=refdir, check=True, capture_output=True, env=env)
    art = {}
    for name in (["cands_sifted.txt", "toas.tim"] + pfds
                 + [p + ".bestprof" for p in pfds]):
        with open(os.path.join(refdir, name), "rb") as f:
            art[name] = f.read()
    return {"dir": refdir, "top": top, "pfds": pfds,
            "artifacts": art}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _committed(fleetdir: str, jid: str, name: str) -> bytes:
    """An artifact of job ``jid``'s committed attempt dir."""
    with open(os.path.join(fleetdir, "jobs", jid, "result.json")) as f:
        detail = json.load(f)
    return _read(os.path.join(fleetdir, "jobs", jid,
                              detail["attempt_dir"], name))


def _run_one_replica(fleetdir: str, workdir: str, led, timeout: float,
                     heartbeat_timeout: float, device):
    """One in-process replica on ``device`` leasing from ``fleetdir``
    until the ledger is all terminal (or ``timeout``)."""
    from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
    from presto_tpu_torch.serve.server import SearchService
    svc = SearchService(workdir, queue_depth=8, device=device).start()
    rep = FleetReplica(svc, FleetConfig(
        fleetdir=fleetdir, replica="rep0",
        lease_ttl=30.0 if heartbeat_timeout < 2.0 else 60.0,
        heartbeat_s=0.1, heartbeat_timeout=heartbeat_timeout, poll_s=0.05,
        max_inflight=2, prewarm=False)).start()
    deadline = time.time() + timeout
    while time.time() < deadline and not led.all_terminal():
        time.sleep(0.1)
    rep.stop()
    svc.stop()


DAG_SPEC_POLICIES = {"sift": {"min_dm_hits": 2, "low_dm_cutoff": 2.0},
                     "fold": {"fold_top": 3}, "toa": {"ntoa": 1}}


def run_dag_loadgen(workdir: str, Ns=(1, 4, 8),
                    timeout: float = 600.0, device="cuda") -> dict:
    """The DAG_r11 verdict on ``device``: (1) a DAG submitted to a
    1-replica fleet produces final artifacts (sifted list, .pfd,
    .bestprof, toas.tim) byte-equal to the hand-driven CLI sequence;
    (2) same-geometry fold jobs provably coalesce — at every N > 1 the
    stacked drizzle pays strictly fewer device dispatches than N
    per-job folds, byte-equal throughout; (3) the stacked executor
    path itself coalesces N queued fold jobs into one batch."""
    from presto_tpu_torch.apps.prepfold import DatFoldSpec, fold_dat_cands
    from presto_tpu_torch.obs import Observability, ObsConfig, devtel
    from presto_tpu_torch.serve.dag import plan_dag
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.server import SearchService

    beam = _make_dag_beam(workdir)
    ref = _cli_reference(beam, workdir, device=device)

    # ---- 1. DAG-vs-CLI pipeline equivalence ---------------------------
    fleetdir = os.path.join(workdir, "fleet")
    led = JobLedger(fleetdir)
    out = led.admit_dag(plan_dag(dict(DAG_SPEC_POLICIES, rawfiles=[beam],
                                      config=dict(DAG_CFG))))
    t0 = time.time()
    _run_one_replica(fleetdir, os.path.join(workdir, "rep0"), led,
                     timeout, 1.0, device)
    dv = led.dag_view(out["dag_id"])
    fold_ids = sorted(j for j in dv["nodes"] if "-fold-" in j)
    equal = {"cands_sifted": _committed(fleetdir, out["nodes"]["sift"],
                                        "cands_sifted.txt")
             == ref["artifacts"]["cands_sifted.txt"],
             "toas_tim": _committed(fleetdir, out["nodes"]["toa"],
                                    "toas.tim")
             == ref["artifacts"]["toas.tim"]}
    for i, fid in enumerate(fold_ids):
        for suffix in (".pfd", ".pfd.bestprof"):
            name = "fold_cand%d%s" % (i + 1, suffix)
            equal[name] = (_committed(fleetdir, fid, name)
                           == ref["artifacts"].get(name))
    pipeline_check = {
        "dag_done": dv["state"] == "done",
        "folds": len(fold_ids),
        "folds_match_reference": len(fold_ids) == len(ref["pfds"]),
        "wall_s": round(time.time() - t0, 3),
        "byte_equal": equal,
        "ok": dv["state"] == "done" and all(equal.values())
        and len(fold_ids) == len(ref["pfds"]),
    }

    # ---- 2. stacked-vs-per-job fold dispatch counts -------------------
    c = ref["top"][0]
    accpath = os.path.join(c.path or ref["dir"], c.filename)
    want_pfd = ref["artifacts"]["fold_cand1.pfd"]
    want_bp = ref["artifacts"]["fold_cand1.pfd.bestprof"]

    def spec(outdir):
        os.makedirs(outdir, exist_ok=True)
        return DatFoldSpec(
            datfile=accpath.split("_ACCEL_")[0] + ".dat",
            accelfile=accpath + ".cand", candnum=c.candnum,
            outbase=os.path.join(outdir, "fold_cand1"), dm=c.DM)

    stacked_runs = []
    for n in Ns:
        obs = Observability(ObsConfig(enabled=True))
        d0 = devtel.transfer_snapshot(obs)["dispatches"]
        singles = [spec(os.path.join(workdir, "n%d-perjob-%d"
                                     % (n, i))) for i in range(n)]
        for s in singles:
            fold_dat_cands([s], device=device, obs=obs)
        d1 = devtel.transfer_snapshot(obs)["dispatches"]
        stacked = [spec(os.path.join(workdir, "n%d-stacked-%d"
                                     % (n, i))) for i in range(n)]
        res = fold_dat_cands(stacked, device=device, obs=obs)
        d2 = devtel.transfer_snapshot(obs)["dispatches"]
        byte_equal = all(
            _read(s.outbase + ".pfd") == want_pfd
            and _read(s.outbase + ".pfd.bestprof") == want_bp
            for s in singles + stacked)
        run = {"n": n, "per_job_dispatches": d1 - d0,
               "stacked_dispatches": d2 - d1,
               "stack_sizes": sorted({r["stacked"] for r in res}),
               "byte_equal_reference": byte_equal,
               "fewer_dispatches": (d2 - d1 < d1 - d0 if n > 1
                                    else d2 - d1 <= d1 - d0)}
        run["ok"] = run["byte_equal_reference"] \
            and run["fewer_dispatches"]
        stacked_runs.append(run)
        print("# fold N=%d  per-job: %d dispatches   stacked: %d  "
              "byte_equal=%s" % (n, d1 - d0, d2 - d1, byte_equal),
              file=sys.stderr)

    # ---- 3. executor-level coalescing ---------------------------------
    n = max(Ns)
    svc = SearchService(os.path.join(workdir, "exec"),
                        queue_depth=max(16, 2 * n), device=device)
    jids = []
    for i in range(n):
        nspec = {"kind": "fold", "bucket": "fold:verdict",
                 "parent_dirs": {"search": ref["dir"]},
                 "parents": {"search": "ref"},
                 "fold": {"accelfile":
                          os.path.basename(accpath) + ".cand",
                          "candnum": c.candnum, "dm": c.DM,
                          "datfile": os.path.basename(
                              accpath.split("_ACCEL_")[0]) + ".dat",
                          "outname": "fold_cand1"}}
        job = svc.build_job(nspec, job_id="fv%d" % i,
                            workdir=os.path.join(workdir,
                                                 "exec-f%d" % i))
        jids.append(svc.enqueue_job(job)["job_id"])
    svc.start()
    ok_wait = svc.wait(jids, timeout=timeout)
    stacked_total = svc.obs.metrics.get("dag_folds_stacked_total")
    coalesce = {
        "n": n,
        "all_done": ok_wait and all(
            svc.get_job(j).status == "done" for j in jids),
        "stacked_fold_jobs": int(stacked_total.value
                                 if stacked_total else 0),
        "byte_equal_reference": all(
            _read(os.path.join(workdir, "exec-f%d" % i,
                               "fold_cand1.pfd")) == want_pfd
            for i in range(n)),
    }
    coalesce["ok"] = (coalesce["all_done"]
                      and coalesce["stacked_fold_jobs"] >= n
                      and coalesce["byte_equal_reference"])
    svc.stop()

    ok = (pipeline_check["ok"] and coalesce["ok"]
          and all(r["ok"] for r in stacked_runs))
    return {
        "mode": "dag",
        "device": str(device),
        "config": DAG_CFG,
        "beam": {"nsamp": 16384, "nchan": 8, "f": 23.0, "dm": 55.0},
        "pipeline_equivalence": pipeline_check,
        "stacked_folds": stacked_runs,
        "executor_coalescing": coalesce,
        "verdict": "PASS" if ok else "FAIL",
        "caveat": (
            "The pinned wins are byte-equality of every DAG artifact "
            "against the hand-driven CLI sequence and the fold dispatch "
            "collapse (one stacked drizzle replacing N per-job folds); "
            "the beam is tiny, so wall times are the host's."),
    }


# ----------------------------------------------------------------------
# fleet-observability verdict mode
# ----------------------------------------------------------------------

def _run_untraced_dag(workdir: str, spec: dict, timeout: float,
                      device="cuda") -> dict:
    """The UNTRACED reference arm: the same DAG admitted directly to
    a private ledger (no router, so no trace field on any row) and
    executed by one in-process replica on ``device``.  Returns the
    per-node artifact digests the traced arm must match."""
    from presto_tpu_torch.serve.dag import plan_dag
    from presto_tpu_torch.serve.jobledger import JobLedger
    fleetdir = os.path.join(workdir, "fleet-untraced")
    led = JobLedger(fleetdir)
    out = led.admit_dag(plan_dag(spec))
    _run_one_replica(fleetdir, os.path.join(workdir, "untraced-rep0"),
                     led, timeout, 2.0, device)
    dv = led.dag_view(out["dag_id"])
    rows = led.read()["jobs"]
    # the ADMITTED nodes carry no trace without a router (expanded
    # fold children still inherit their sift's local span — that is
    # in-process parenting, not the cross-process stamp under test)
    if any(rows[jid].get("trace") for jid in out["nodes"].values()):
        raise AssertionError("untraced arm admitted rows must carry no "
                             "trace field")
    return {"fleetdir": fleetdir, "dag_id": out["dag_id"],
            "state": dv["state"] if dv else "missing",
            "artifacts": _dag_artifact_bytes(fleetdir,
                                             out["dag_id"], led)}


def _dag_artifact_bytes(fleetdir: str, dag_id: str, led) -> dict:
    """{relative node name: {artifact name: sha256}} for one DAG's
    committed attempt dirs (the byte-equality surface)."""
    out = {}
    for jid, row in sorted(led.read()["jobs"].items()):
        if row.get("dag") != dag_id or row["state"] != "done":
            continue
        rel = jid[len(dag_id) + 1:] if jid.startswith(dag_id) \
            else jid
        with open(os.path.join(fleetdir, "jobs", jid,
                               "result.json")) as f:
            detail = json.load(f)
        adir = os.path.join(fleetdir, "jobs", jid,
                            detail["attempt_dir"])
        arts = {}
        for pat in ("cands_sifted.txt", "*.pfd", "*.pfd.bestprof",
                    "toas.tim", "*_ACCEL_*", "*.dat"):
            for path in sorted(glob.glob(os.path.join(adir, pat))):
                arts[os.path.basename(path)] = hashlib.sha256(
                    _read(path)).hexdigest()
        out[rel] = arts
    return out


def _ledger_p99(totals):
    """The JAX tool's nearest-rank p99 of sorted totals."""
    if not totals:
        return None
    return totals[min(len(totals) - 1,
                      max(0, (len(totals) * 99 + 99) // 100 - 1))]


def run_obs_loadgen(workdir: str, timeout: float = 900.0,
                    device="cuda") -> dict:
    """The OBS_r12 verdict (fleet-wide observability) on ``device``:

    1. a DAG submitted through the router to TWO real replica
       processes completes with every artifact byte-equal to an
       untraced reference run (trace stamping never touches the data
       path);
    2. every span of that DAG — router admission root, search, sift,
       folds, toa, across processes — shares ONE trace id with zero
       orphan spans, and the merged Perfetto trace is written (by the
       port's apps/trace_merge);
    3. `GET /fleet/metrics` reports a fleet-wide `job_e2e_seconds`
       p99 that exactly equals an independent merge of the replicas'
       snapshot files, and tracks the ledger-derived per-job totals.
    """
    from presto_tpu_torch.apps import trace_merge
    from presto_tpu_torch.obs import fleetagg

    beam = _make_dag_beam(workdir)
    spec = dict(DAG_SPEC_POLICIES, rawfiles=[beam], config=dict(DAG_CFG))
    untraced = _run_untraced_dag(workdir, spec, timeout, device=device)

    # ---- traced arm: router + 2 subprocess replicas -------------------
    tdir = os.path.join(workdir, "traced")
    fleetdir = os.path.join(tdir, "fleet")
    router, url, _procs, teardown = start_fleet_procs(
        tdir, replicas=2, high_water=64, device=device)
    try:
        out = _http_json(url + "/dag", spec)
        dag_id = out["dag_id"]
        deadline = time.time() + timeout
        dv = None
        while time.time() < deadline:
            dv = router.dag_status(dag_id)
            if dv and dv["state"] in ("done", "failed"):
                break
            time.sleep(0.25)
        n_done = (dv or {}).get("counts", {}).get("done", 0)
        # the e2e histogram reaches the aggregate via the replicas'
        # paced snapshots: poll /fleet/metrics until every commit is
        # visible fleet-wide
        fm = {}
        while time.time() < deadline:
            fm = _http_json(url + "/fleet/metrics")
            if fm.get("job_e2e", {}).get("total",
                                         {}).get("count", 0) >= n_done:
                break
            time.sleep(0.5)
        with urllib.request.urlopen(
                url + "/fleet/metrics?format=prometheus",
                timeout=30) as r:
            prom = r.read().decode()
        ledger_rows = {jid: row for jid, row in
                       router.ledger.read()["jobs"].items()
                       if row.get("dag") == dag_id}
        led_totals = sorted(
            float(r["completed_at"]) - float(r["submitted"])
            for r in ledger_rows.values()
            if r["state"] == "done" and r.get("completed_at"))
        traced_arts = _dag_artifact_bytes(fleetdir, dag_id,
                                          router.ledger)
        critical = fleetagg.dag_critical_path(
            router.ledger.read()["jobs"], dag_id)
        # independent merge of the very snapshot files the router read
        indep = fleetagg.rollup(
            fleetagg.aggregate(fleetdir)["merged"],
            "job_e2e_seconds", "phase")
    finally:
        teardown()

    # ---- trace joining (after teardown: streams are flushed) ----------
    spans = fleetagg.load_fleet_spans(fleetdir)
    root = next((s for s in spans
                 if s.get("name") == "fleet:dag-submit"
                 and (s.get("attrs") or {}).get("dag") == dag_id),
                None)
    trace_id = (root or {}).get("trace_id")
    dag_spans = [s for s in spans if s.get("trace_id") == trace_id] \
        if trace_id else []
    node_ids = set(ledger_rows)
    jobs_in_trace = {(s.get("attrs") or {}).get("job")
                     for s in dag_spans}
    stray = [s for s in spans
             if (s.get("attrs") or {}).get("job") in node_ids
             and s.get("trace_id") != trace_id]
    orphans = fleetagg.orphan_spans(dag_spans)
    merged_path = os.path.join(workdir, "trace.merged.perfetto.json")
    with contextlib.redirect_stdout(sys.stderr):
        merge_rc = trace_merge.main(["-fleet", fleetdir, "-o",
                                     merged_path])

    reported = fm.get("job_e2e", {})
    rep_p99 = reported.get("total", {}).get("p99")
    ind_p99 = indep.get("total", {}).get("p99")
    led_p99 = _ledger_p99(led_totals)
    checks = {
        "dag_done": (dv or {}).get("state") == "done"
        and untraced["state"] == "done",
        "byte_equal_untraced":
            traced_arts == untraced["artifacts"]
            and bool(traced_arts),
        "one_trace_id": bool(trace_id) and not stray
        and node_ids <= jobs_in_trace,
        "cross_process": len({s.get("pid")
                              for s in dag_spans}) >= 2,
        "zero_orphans": bool(dag_spans) and not orphans,
        "fleet_p99_present": bool(rep_p99),
        "fleet_p99_matches_snapshots": rep_p99 == ind_p99
        and rep_p99 is not None,
        "fleet_p99_tracks_ledger": (
            rep_p99 is not None and led_p99 is not None
            and abs(rep_p99 - led_p99)
            <= max(0.25, 0.2 * led_p99)),
    }
    print("# obs verdict: trace=%s spans=%d procs=%d orphans=%d "
          "p99(fleet)=%s p99(ledger)=%s"
          % ((trace_id or "?")[:16], len(dag_spans),
             len({s.get("pid") for s in dag_spans}), len(orphans),
             rep_p99, led_p99), file=sys.stderr)
    return {
        "mode": "obs",
        "device": str(device),
        "config": DAG_CFG,
        "dag_id": dag_id,
        "nodes": {jid: ledger_rows[jid]["state"]
                  for jid in sorted(ledger_rows)},
        "trace": {
            "trace_id": trace_id,
            "dag_spans": len(dag_spans),
            "processes": sorted({int(s.get("pid") or 0)
                                 for s in dag_spans}),
            "orphan_spans": len(orphans),
            "merged_perfetto": os.path.basename(merged_path),
            "trace_merge_rc": merge_rc,
        },
        "job_e2e": reported,
        "job_e2e_independent_merge": indep,
        "ledger_p99_s": led_p99,
        "prometheus_has_e2e":
            "job_e2e_seconds_bucket" in prom,
        "critical_path": critical,
        "checks": checks,
        "verdict": "PASS" if all(checks.values()) else "FAIL",
        "caveat": (
            "The pinned wins are the single cross-process trace id with "
            "zero orphans, byte-equality against the untraced arm, and "
            "the fleet-aggregated p99 equaling an independent snapshot "
            "merge; phase times are the shared host's."),
    }


# ----------------------------------------------------------------------
# SLO-observatory verdict mode
# ----------------------------------------------------------------------

SLO_CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
           "numharm": 2, "fold_top": 0, "singlepulse": False,
           "skip_rfifind": True, "durable_stages": True}

#: per-job end-to-end latency objective: with a spike of same-bucket
#: jobs on a small fleet, queue wait pushes most jobs past it, so
#: both tenants accrue bad events — and the strict tenant's budget
#: burns proportionally faster
SLO_LATENCY_S = 2.0

#: gold 99.9% (budget 0.1% — any bad event burns hundreds of times
#: the budgeted rate), bronze 50% (budget 50% — burn can never
#: exceed 2): at threshold 8 gold must alert and bronze must not,
#: which is exactly the SLO-priority ordering the verdict pins
SLO_SPECS = ("gold:0.999:%g" % SLO_LATENCY_S,
             "bronze:0.5:%g" % SLO_LATENCY_S)
SLO_WINDOWS = "15:60:8"


def _start_members(workdir, fleetdir, n, device, max_inflight=1):
    """n in-process replicas on ``device`` with HTTP fronts, leasing
    from ``fleetdir`` (the -slo and -campaign fleets)."""
    from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
    from presto_tpu_torch.serve.server import SearchService, start_http
    members = []
    for i in range(n):
        svc = SearchService(os.path.join(workdir, "rep%d" % i),
                            queue_depth=64, device=device).start()
        httpd = start_http(svc)
        addr = "http://%s:%d" % httpd.server_address[:2]
        rep = FleetReplica(svc, FleetConfig(
            fleetdir=fleetdir, replica="rep%d" % i, lease_ttl=60.0,
            heartbeat_s=0.2, heartbeat_timeout=3.0, poll_s=0.05,
            max_inflight=max_inflight, snapshot_s=0.2),
            addr=addr).start()
        members.append((svc, rep, httpd))
    return members


def _stop_members(members, rhttpd, router):
    for svc, rep, httpd in members:
        httpd.shutdown()
        svc.shutdown(drain=True, timeout=30.0)
    rhttpd.shutdown()
    router.stop()


def slo_specs(latency_s: float = SLO_LATENCY_S):
    """The two tenants' SLO specs at a per-job latency objective."""
    return ("gold:0.999:%g" % latency_s, "bronze:0.5:%g" % latency_s)


def slo_objective(reference: dict) -> float:
    """The SLO arm's per-job latency objective: SLO_LATENCY_S, or the
    reference arm's fastest job end to end when that is shorter.  The
    JAX tool's 2 s suits its one-core host; the port runs the spike's
    tiny jobs in a fraction of it, and a spike in which no job is late
    tests no alert.  The fastest reference job is about one job with no
    queue wait, so the spike's queued jobs pass it."""
    e2e = [v for v in reference["job_e2e_s"].values() if v is not None]
    return round(min([SLO_LATENCY_S] + e2e), 3)


def _slo_arm(workdir: str, beam: str, jobs_per_tenant: int,
             metered: bool, timeout: float, device="cuda",
             specs=SLO_SPECS) -> dict:
    """One fleet arm (router + 2 in-process replicas on ``device``):
    submit a two-tenant spike, sample /scale through it, drain, and
    collect per-job artifact digests + telemetry.  ``metered=False`` is
    the byte-equality reference: a fleet without SLO specs (the port
    meters usage always) whose artifacts the SLO arm must reproduce
    byte-for-byte."""
    from presto_tpu_torch.obs import fleetagg
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http as router_http)
    from presto_tpu_torch.serve.usage import UsageLedger
    fleetdir = os.path.join(workdir, "fleet")
    router = FleetRouter(RouterConfig(
        fleetdir=fleetdir, high_water=256, poll_s=0.2,
        heartbeat_timeout=3.0,
        slo=list(specs) if metered else [],
        slo_windows=SLO_WINDOWS if metered else "",
        scale_target_drain_s=5.0, scale_max_replicas=8)).start()
    rhttpd = router_http(router)
    url = "http://%s:%d" % rhttpd.server_address[:2]
    members = _start_members(workdir, fleetdir, 2, device)
    _wait_ready(router, 2, 60.0, 0.2)

    scale_series = []
    t0 = time.time()

    def sample_scale(label):
        s = _http_json(url + "/scale")
        scale_series.append({"t": round(time.time() - t0, 3),
                             "label": label,
                             "wanted": s["wanted_replicas"],
                             "backlog_jobs":
                                 s["inputs"]["backlog_jobs"]})
        return s

    try:
        t0 = time.time()
        initial = sample_scale("pre-spike")
        job_ids = []
        for i in range(jobs_per_tenant):
            for tenant in ("gold", "bronze"):
                view = _http_json(url + "/submit",
                                  {"rawfiles": [beam],
                                   "config": dict(SLO_CFG),
                                   "tenant": tenant})
                job_ids.append(view["job_id"])
        deadline = time.time() + timeout
        while time.time() < deadline:
            sample_scale("spike")
            views = [router.status(j) for j in job_ids]
            if all(v and v["state"] in ("done", "failed")
                   for v in views):
                break
            time.sleep(0.5)
        final = sample_scale("drained")
        states = {j: router.status(j)["state"] for j in job_ids}
        alert_ts = {}
        for ev in _http_json(url + "/events?n=2000")["events"]:
            if ev["kind"] == "slo-burn-alert":
                alert_ts.setdefault(ev["tenant"], ev["ts"] - t0)
        rows = router.ledger.read()["jobs"]
        job_e2e_s = {
            jid: (float(rows[jid]["completed_at"])
                  - float(rows[jid]["submitted"])
                  if rows.get(jid, {}).get("completed_at") else None)
            for jid in job_ids}
        digests = {}
        for jid in job_ids:
            try:
                with open(os.path.join(fleetdir, "jobs", jid,
                                       "result.json")) as f:
                    digests[jid] = json.load(f)["artifacts"]
            except (OSError, ValueError):
                digests[jid] = None
    finally:
        _stop_members(members, rhttpd, router)
    usage = UsageLedger(fleetdir)
    # drain published tombstone snapshots: counters + histograms of
    # every commit survive the teardown for the conservation check
    agg = fleetagg.aggregate(fleetdir)
    e2e = fleetagg.rollup(agg["merged"], "job_e2e_seconds", "phase")
    from presto_tpu_torch.obs import slo as slolib
    return {
        "metered": metered,
        "fleetdir": fleetdir,
        "states": states,
        "job_e2e_s": job_e2e_s,
        "digests": digests,
        "scale_series": scale_series,
        "initial_wanted": initial["wanted_replicas"],
        "peak_wanted": max(s["wanted"] for s in scale_series),
        "final_wanted": final["wanted_replicas"],
        "alert_ts": alert_ts,
        "usage_raw": usage.raw_rows(),
        "usage_rows": usage.rows(),
        "slo_file_exists": os.path.exists(slolib.spec_path(fleetdir)),
        "job_e2e_execute": e2e.get("execute", {}),
    }


def run_slo_loadgen(workdir: str, jobs_per_tenant: int = 4,
                    timeout: float = 900.0, device="cuda") -> dict:
    """The SLO_r14 verdict (SLO observatory) on ``device``:

    1. a two-tenant traffic spike through a real router + 2 replicas
       drives both tenants past the per-job latency objective (the JAX
       tool's 2 s, or the reference arm's fastest job where that is
       shorter: slo_objective); the
       high-SLO tenant (gold, 99.9%) fires its multi-window burn
       alert while the low-SLO tenant (bronze, 50%) never can —
       burn-rate alerts fire in SLO-priority order;
    2. the advisory /scale signal rises above its pre-spike value
       while the backlog is queued and decays once drained;
    3. per-tenant device-seconds in the durable usage ledger sum
       EXACTLY to the fleet-aggregated execute-phase total (one row
       per committed job, fence-checked);
    4. every artifact is byte-identical to a reference fleet without
       SLO specs: SLO evaluation is bookkeeping, never part of the
       data path.
    """
    from presto_tpu_torch.obs import slo as slolib
    beam = make_beams(workdir, 1, nsamp=4096, nchan=8)[0]
    reference = _slo_arm(os.path.join(workdir, "unmetered"),
                         beam, jobs_per_tenant, metered=False,
                         timeout=timeout, device=device)
    latency_s = slo_objective(reference)
    specs = slo_specs(latency_s)
    metered = _slo_arm(os.path.join(workdir, "metered"),
                       beam, jobs_per_tenant, metered=True,
                       timeout=timeout, device=device, specs=specs)

    n_jobs = 2 * jobs_per_tenant
    done_rows = [r for r in metered["usage_raw"]
                 if r.get("state") == "done"]
    per_job = {}
    for r in done_rows:
        per_job[r["job_id"]] = per_job.get(r["job_id"], 0) + 1
    by_tenant = {}
    for r in done_rows:
        by_tenant.setdefault(r["tenant"], []).append(
            float(r["phases"].get("execute") or 0.0))
    usage_total = sum(x for xs in by_tenant.values() for x in xs)
    fleet_total = float(metered["job_e2e_execute"].get("sum") or 0.0)
    rollup = slolib.usage_rollup(metered["usage_rows"])

    gold_ts = metered["alert_ts"].get("gold")
    bronze_ts = metered["alert_ts"].get("bronze")
    checks = {
        "all_done": (
            all(s == "done" for s in metered["states"].values())
            and all(s == "done"
                    for s in reference["states"].values())),
        "byte_equal_unmetered": (
            list(metered["digests"].values())
            == list(reference["digests"].values())
            and all(metered["digests"].values())),
        "reference_arm_had_no_slo": (
            not reference["alert_ts"]
            and not reference["slo_file_exists"]),
        "gold_alert_fired": gold_ts is not None,
        "alerts_in_slo_priority_order": (
            gold_ts is not None
            and (bronze_ts is None or gold_ts < bronze_ts)),
        "scale_rises_during_spike":
            metered["peak_wanted"] > metered["initial_wanted"],
        "scale_decays_after_drain":
            metered["final_wanted"] < metered["peak_wanted"],
        "usage_exactly_once_per_job": (
            len(per_job) == n_jobs
            and all(n == 1 for n in per_job.values())),
        "device_seconds_sum_to_fleet_execute_total": (
            int(metered["job_e2e_execute"].get("count") or 0)
            == len(done_rows)
            and abs(usage_total - fleet_total)
            <= 1e-6 * max(fleet_total, 1.0)),
    }
    print("# slo verdict: gold alert @%ss bronze %s  scale %d->%d->"
          "%d  usage %.3fs vs fleet %.3fs"
          % ("%.2f" % gold_ts if gold_ts is not None else "?",
             "@%.2fs" % bronze_ts if bronze_ts is not None
             else "never",
             metered["initial_wanted"], metered["peak_wanted"],
             metered["final_wanted"], usage_total, fleet_total),
          file=sys.stderr)
    return {
        "mode": "slo",
        "device": str(device),
        "config": SLO_CFG,
        "slo_specs": list(specs),
        "slo_latency_s": latency_s,
        "slo_windows": SLO_WINDOWS,
        "jobs_per_tenant": jobs_per_tenant,
        "alert_ts_s": {t: round(v, 3)
                       for t, v in metered["alert_ts"].items()},
        "scale": {
            "initial": metered["initial_wanted"],
            "peak": metered["peak_wanted"],
            "final": metered["final_wanted"],
            "series": metered["scale_series"],
        },
        "usage": rollup,
        "device_seconds": {
            "per_tenant": {t: round(sum(xs), 6)
                           for t, xs in sorted(by_tenant.items())},
            "usage_total": round(usage_total, 6),
            "fleet_execute_total": round(fleet_total, 6),
            "fleet_execute_count":
                int(metered["job_e2e_execute"].get("count") or 0),
        },
        "checks": checks,
        "verdict": "PASS" if all(checks.values()) else "FAIL",
        "caveat": (
            "The pinned wins are the SLO-priority alert ordering, the "
            "rise-and-decay of the advisory /scale signal, exact "
            "device-seconds conservation between the usage ledger and "
            "the fleet aggregation, and byte-equality against the arm "
            "without SLO specs; alert times are the shared host's."),
    }


# ----------------------------------------------------------------------
# fleet-supervisor verdict mode
# ----------------------------------------------------------------------

def _p99(xs):
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))]


def run_supervisor_loadgen(workdir: str, jobs_per_tenant: int = 5,
                           timeout: float = 900.0,
                           device="cuda") -> dict:
    """The SUPERVISOR_r16 verdict (fleet supervisor): a two-tenant spike
    against a router + a REAL supervisor that spawns and drains replica
    processes on ``device`` from the /scale advisory.

    1. the supervised fleet scales 1 -> N (>1) under the spike and
       back down to 1 after the drain — the control loop actually
       actuates, with hysteresis, instead of just advising;
    2. the high-SLO tenant's p99 end-to-end latency is never worse
       than the low-SLO tenant's (SLO-class lease weights hold the
       priority ordering through the scaling episode);
    3. zero lost jobs: every submitted job commits exactly once in
       the durable usage ledger, through spawns and drains alike;
    4. the whole scaling episode is reconstructable from
       supervisor_events.jsonl alone: every spawn/drain event carries
       the advisory inputs that drove it.
    """
    from presto_tpu_torch.serve import supervisor as suplib
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http as router_http)
    from presto_tpu_torch.serve.supervisor import (FleetSupervisor,
                                                   SupervisorConfig)
    from presto_tpu_torch.serve.usage import UsageLedger
    suplib.check_replica_device(str(device))
    beam = make_beams(workdir, 1, nsamp=4096, nchan=8)[0]
    fleetdir = os.path.join(workdir, "fleet")
    router = FleetRouter(RouterConfig(
        fleetdir=fleetdir, high_water=256, poll_s=0.2,
        heartbeat_timeout=5.0, slo=list(SLO_SPECS),
        slo_windows=SLO_WINDOWS, scale_target_drain_s=2.0,
        scale_max_replicas=3)).start()
    rhttpd = router_http(router)
    url = "http://%s:%d" % rhttpd.server_address[:2]
    sup = FleetSupervisor(SupervisorConfig(
        fleetdir=fleetdir, router_url=url, poll_s=0.25,
        scale_up_after=2, scale_down_after=4, cooldown_s=1.5,
        min_replicas=1, max_replicas=3, drain_timeout_s=90.0,
        spawn_timeout_s=180.0, heartbeat_timeout=15.0,
        hb_interval=0.25, hb_timeout=5.0,
        replica_args=["-inflight", "1", "-depth", "64"],
        device=str(device)))

    series = []
    t0 = time.time()

    def n_supervised():
        return len([r for r in sup.replicas().values()
                    if r["state"] in (suplib.SPAWNING, suplib.UP)])

    def sample(label):
        s = _http_json(url + "/scale")
        series.append({"t": round(time.time() - t0, 3),
                       "label": label,
                       "wanted": s["wanted_replicas"],
                       "supervised": n_supervised(),
                       "ready": s["inputs"]["ready_replicas"]})
        return s

    submitted = {}
    finished = {}
    tenant_of = {}
    try:
        sup.start()
        # the min_replicas floor brings up the first replica; wait
        # for it to lease-ready before the spike
        deadline = time.time() + min(240.0, timeout)
        while time.time() < deadline:
            router.poll_replicas()
            if len(router.serving_replicas()) >= 1:
                break
            time.sleep(0.5)
        sample("pre-spike")
        for i in range(jobs_per_tenant):
            for tenant in ("gold", "bronze"):
                view = _http_json(url + "/submit",
                                  {"rawfiles": [beam],
                                   "config": dict(SLO_CFG),
                                   "tenant": tenant})
                submitted[view["job_id"]] = time.time()
                tenant_of[view["job_id"]] = tenant
        deadline = time.time() + timeout
        while time.time() < deadline:
            sample("spike")
            for jid in submitted:
                if jid in finished:
                    continue
                v = router.status(jid)
                if v and v["state"] in ("done", "failed"):
                    finished[jid] = (time.time(), v["state"])
            if len(finished) == len(submitted):
                break
            time.sleep(0.4)
        # spike drained: the advisory decays and the supervisor must
        # scale the fleet back down to the min_replicas floor.  Wait
        # on the registry, not the serving count: a DRAINING row
        # leaves the count immediately but only becomes the episode's
        # supervisor-drained event once the reconcile pass observes
        # the process exit
        deadline = time.time() + min(180.0, timeout)
        while time.time() < deadline:
            sample("drain-down")
            if len(sup.replicas()) <= 1:
                break
            time.sleep(0.4)
        sample("final")
    finally:
        sup.stop()
        sup.drain_all(timeout=90.0)
        rhttpd.shutdown()
        router.stop()

    states = {j: st for j, (_, st) in finished.items()}
    e2e = {}
    for jid, (t_end, _) in finished.items():
        e2e.setdefault(tenant_of[jid], []).append(
            t_end - submitted[jid])
    gold_p99 = _p99(e2e.get("gold", []))
    bronze_p99 = _p99(e2e.get("bronze", []))

    usage = UsageLedger(fleetdir)
    per_job = {}
    for r in usage.raw_rows():
        if r.get("state") == "done":
            per_job[r["job_id"]] = per_job.get(r["job_id"], 0) + 1

    sup_events = []
    try:
        with open(suplib.events_path(fleetdir)) as f:
            sup_events = [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        pass
    kinds = {}
    for ev in sup_events:
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    actuations = [ev for ev in sup_events
                  if ev["kind"] in ("supervisor-spawn",
                                    "supervisor-drain")]
    warmups = [round(ev["warmup_s"], 3) for ev in sup_events
               if ev["kind"] == "supervisor-up"
               and ev.get("warmup_s") is not None]

    n_jobs = 2 * jobs_per_tenant
    peak = max(s["supervised"] for s in series)
    final = series[-1]["supervised"] if series else 0
    checks = {
        "all_done": (len(states) == n_jobs
                     and all(s == "done" for s in states.values())),
        "zero_lost_jobs": (len(per_job) == n_jobs
                           and all(n == 1
                                   for n in per_job.values())),
        "fleet_scaled_up": peak > 1,
        "fleet_scaled_back_down": final == 1,
        "high_slo_p99_held": (gold_p99 is not None
                              and bronze_p99 is not None
                              and gold_p99 <= bronze_p99),
        "episode_reconstructable": (
            {"supervisor-start", "supervisor-spawn",
             "supervisor-up", "supervisor-drain",
             "supervisor-drained"} <= set(kinds)
            and all("wanted" in ev and "advice_reason" in ev
                    for ev in actuations)),
        "registry_converged_to_min": (
            len(suplib.load_registry(fleetdir)["replicas"]) == 0),
    }
    print("# supervisor verdict: fleet 1->%d->%d  gold p99 %.2fs "
          "bronze p99 %.2fs  %d/%d done  events %s"
          % (peak, final,
             gold_p99 or -1.0, bronze_p99 or -1.0,
             sum(1 for s in states.values() if s == "done"), n_jobs,
             " ".join("%s=%d" % kv for kv in sorted(kinds.items()))),
          file=sys.stderr)
    return {
        "mode": "supervisor",
        "device": str(device),
        "config": SLO_CFG,
        "slo_specs": list(SLO_SPECS),
        "jobs_per_tenant": jobs_per_tenant,
        "fleet": {"peak_supervised": peak,
                  "final_supervised": final,
                  "series": series},
        "latency_s": {
            t: {"n": len(xs), "p99": round(_p99(xs), 3),
                "mean": round(sum(xs) / len(xs), 3)}
            for t, xs in sorted(e2e.items())},
        "replica_warmup_s": warmups,
        "events_by_kind": kinds,
        "checks": checks,
        "verdict": "PASS" if all(checks.values()) else "FAIL",
        "caveat": (
            "The pinned wins are the 1->N->1 scaling episode under a "
            "real subprocess fleet, the SLO-class p99 ordering through "
            "it, exactly-once commits across spawn/drain churn, and the "
            "event stream carrying every actuation's advisory inputs; "
            "warm-up times include each replica process reaching the "
            "card."),
    }


# ----------------------------------------------------------------------
# campaign-engine verdict mode
# ----------------------------------------------------------------------

#: interactive-tenant p99 objective for the campaign verdict: a
#: bounded-latency pin (gold work is never starved behind the archive
#: lane), not a production target — the burn-driven SLO machinery that
#: shrinks the backfill lane still uses SLO_SPECS' 2 s objective
CAMPAIGN_GOLD_OBJECTIVE_S = 30.0

#: per-observation DAG policies: one fold pass + a timing node, so a
#: campaign observation exercises the whole discovery DAG shape
CAMPAIGN_OBS_SPEC = {"sift": {"min_dm_hits": 2, "low_dm_cutoff": 2.0},
                     "fold": {"fold_top": 1}, "toa": {"ntoa": 1}}


def run_campaign_loadgen(workdir: str, observations: int = 4,
                         gold_jobs: int = 6, wave_size: int = 2,
                         timeout: float = 900.0, device="cuda") -> dict:
    """The CAMPAIGN_r17 verdict (campaign engine): an archive campaign
    backfills through a real router + 2 replicas on ``device`` while a
    gold-SLO interactive tenant keeps submitting.

    1. the campaign drains to done with never more than `wave_size`
       observations outstanding (jobs.json stays bounded at any
       archive size) and admitted == done + failed conserves;
    2. every terminal job — campaign DAG nodes and interactive gold
       jobs alike — commits exactly once in the durable usage ledger
       (zero lost, zero double-counted);
    3. the gold tenant's p99 end-to-end latency stays within the
       objective, and the backfill lane visibly yields (live WRR
       weight < configured) whenever gold latency actually burns
       its SLO budget;
    4. the live ETA/cost projection converges onto the measured
       total device-seconds as the archive drains;
    5. the whole episode is reconstructable from
       campaign_events.jsonl alone: one create, one wave-admit per
       wave, one obs-done per observation, one complete.
    """
    from presto_tpu_torch.apps.report import collect_campaign
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http as router_http)
    from presto_tpu_torch.serve.usage import UsageLedger
    beams = make_beams(workdir, observations + 1, nsamp=4096,
                       nchan=8)
    gold_beam = beams[observations]
    fleetdir = os.path.join(workdir, "fleet")
    router = FleetRouter(RouterConfig(
        fleetdir=fleetdir, high_water=256, poll_s=0.2,
        heartbeat_timeout=3.0, slo=list(SLO_SPECS),
        slo_windows=SLO_WINDOWS, scale_target_drain_s=5.0,
        scale_max_replicas=4)).start()
    rhttpd = router_http(router)
    url = "http://%s:%d" % rhttpd.server_address[:2]
    members = _start_members(workdir, fleetdir, 2, device)
    _wait_ready(router, 2, 60.0, 0.2)

    cid = "loadgen-r17"
    manifest = [dict(CAMPAIGN_OBS_SPEC, id="obs-%03d" % i,
                     rawfiles=[beams[i]], config=dict(SLO_CFG))
                for i in range(observations)]
    series = []
    submitted = {}
    finished = {}
    try:
        t0 = time.time()
        first = _http_json(url + "/campaign",
                           {"id": cid, "manifest": manifest,
                            "wave_size": wave_size, "weight": 0.1,
                            "priority": 50})
        next_gold = t0
        n_gold = 0
        deadline = time.time() + timeout
        while time.time() < deadline:
            now = time.time()
            if n_gold < gold_jobs and now >= next_gold:
                view = _http_json(url + "/submit",
                                  {"rawfiles": [gold_beam],
                                   "config": dict(SLO_CFG),
                                   "tenant": "gold"})
                submitted[view["job_id"]] = time.time()
                n_gold += 1
                next_gold = now + 2.5
            st = _http_json(url + "/campaign/" + cid)
            series.append({
                "t": round(now - t0, 3),
                "state": st["state"],
                "outstanding": st["outstanding"],
                "yield": st["yield"],
                "done": st["counts"]["done"],
                "failed": st["counts"]["failed"],
                "eta_s": (st.get("projection") or {}).get("eta_s"),
            })
            for jid in submitted:
                if jid in finished:
                    continue
                v = router.status(jid)
                if v and v["state"] in ("done", "failed"):
                    finished[jid] = (time.time(), v["state"])
            if (st["state"] != "running" and n_gold == gold_jobs
                    and len(finished) == len(submitted)):
                break
            time.sleep(0.4)
        final_status = _http_json(url + "/campaign/" + cid)
        terminal_rows = {jid: row["state"] for jid, row in
                         router.ledger.read()["jobs"].items()
                         if row["state"] in ("done", "failed")}
    finally:
        _stop_members(members, rhttpd, router)

    usage = UsageLedger(fleetdir)
    per_done = {}
    for r in usage.raw_rows():
        if r.get("state") == "done":
            per_done[r["job_id"]] = per_done.get(r["job_id"], 0) + 1
    done_jobs = {j for j, s in terminal_rows.items() if s == "done"}
    info = collect_campaign(fleetdir, cid)
    conv = info["convergence"]
    by_kind = info["by_kind"]
    final_total = conv[-1]["device_seconds"] if conv else 0.0
    errs = [abs(e["projected_total_device_seconds"] - final_total)
            / max(final_total, 1e-9) for e in conv]
    half = max(1, len(errs) // 2)
    err_early = sum(errs[:half]) / half
    err_late = sum(errs[half:]) / max(1, len(errs) - half)
    gold_e2e = [t_end - submitted[j]
                for j, (t_end, st) in finished.items()
                if st == "done"]
    gold_p99 = _p99(gold_e2e)
    counts = final_status["counts"]
    yields = [s["yield"] for s in series]
    checks = {
        "first_wave_admitted_before_202":
            first["outstanding"] >= min(wave_size, observations),
        "campaign_done": (final_status["state"] == "done"
                          and counts["done"] == observations
                          and counts["failed"] == 0),
        "conservation": (counts["done"] + counts["failed"]
                         == observations
                         and final_status["outstanding"] == 0),
        "wave_bound_held": max(s["outstanding"]
                               for s in series) <= wave_size,
        "gold_all_done": (len(finished) == gold_jobs
                          and all(st == "done" for _, st
                                  in finished.values())),
        "gold_p99_within_objective": (
            gold_p99 is not None
            and gold_p99 <= CAMPAIGN_GOLD_OBJECTIVE_S),
        "exactly_once_commits": (
            set(per_done) == done_jobs and bool(done_jobs)
            and all(n == 1 for n in per_done.values())),
        "backfill_lane_yields": (
            min(yields) < 1.0
            or (gold_p99 is not None
                and gold_p99 <= SLO_LATENCY_S)),
        "eta_converges": (bool(conv) and errs[-1] <= 1e-6
                          and err_late <= err_early + 0.05),
        "episode_reconstructable": (
            by_kind.get("campaign-create", 0) >= 1
            and by_kind.get("campaign-wave-admit", 0)
            == final_status["waves"]
            and by_kind.get("campaign-obs-done", 0)
            == counts["done"]
            and by_kind.get("campaign-complete", 0) >= 1),
    }
    print("# campaign verdict: %d obs in %d wave(s)  gold p99 %.2fs "
          "(objective %.0fs)  yield min %.2f  proj err %.1f%%->%.1f%%"
          % (counts["done"], final_status["waves"],
             gold_p99 if gold_p99 is not None else -1.0,
             CAMPAIGN_GOLD_OBJECTIVE_S, min(yields),
             100 * err_early, 100 * err_late), file=sys.stderr)
    return {
        "mode": "campaign",
        "device": str(device),
        "config": SLO_CFG,
        "observations": observations,
        "wave_size": wave_size,
        "gold_jobs": gold_jobs,
        "campaign": {"state": final_status["state"],
                     "waves": final_status["waves"],
                     "counts": counts,
                     "projection": final_status.get("projection")},
        "series": series,
        "convergence": conv,
        "events_by_kind": by_kind,
        # injection-recall roll-up over the campaign's triage nodes
        # (None when no observation opted into triage — the
        # byte-stable heuristic default)
        "triage": info.get("triage"),
        "gold_latency_s": {
            "n": len(gold_e2e),
            "p99": round(gold_p99, 3) if gold_p99 is not None
            else None,
            "mean": round(sum(gold_e2e) / len(gold_e2e), 3)
            if gold_e2e else None,
        },
        "yield": {"min": min(yields), "max": max(yields)},
        "checks": checks,
        "verdict": "PASS" if all(checks.values()) else "FAIL",
        "caveat": (
            "The objective is a bounded-latency pin, not a production "
            "target; the byte-equality of a churned + preempted "
            "campaign against the sequential CLI belongs to the chaos "
            "driver (tools/fleet_chaos.py -campaign in the JAX "
            "package)."),
    }


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

#: each verdict mode: (flag, the report's file name under RECORDS_DIR)
VERDICT_MODES = (("campaign", "CAMPAIGN_r17.json"),
                 ("supervisor", "SUPERVISOR_r16.json"),
                 ("slo", "SLO_r14.json"),
                 ("obs", "OBS_r12.json"),
                 ("dag", "DAG_r11.json"),
                 ("stacked", "SERVE_BATCH_r10.json"))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def commit_report(report: dict, name: str, root: str = None) -> str:
    """Write ``report`` to ``root`` (default: this checkout)
    /records/torch/``name`` (atomic); returns the path."""
    from presto_tpu_torch.io.atomic import atomic_write_text
    out = os.path.join(root or REPO, RECORDS_DIR, name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    atomic_write_text(out, json.dumps(report, indent=1, sort_keys=True)
                      + "\n")
    return out


def build_parser():
    p = argparse.ArgumentParser(prog="serve_loadgen")
    p.add_argument("-url", type=str, default=None,
                   help="Base URL of a running presto-serve")
    p.add_argument("-selfhost", action="store_true",
                   help="Spin up an in-process service instead")
    p.add_argument("-replicas", type=int, default=0,
                   help="Fleet mode: run this many in-process "
                        "replicas behind a router sharing one job "
                        "ledger (implies -selfhost)")
    p.add_argument("-subprocess", action="store_true",
                   help="Fleet mode: replicas as real presto-serve "
                        "processes (own interpreter and CUDA context) "
                        "instead of in-process threads")
    p.add_argument("-stacked", action="store_true",
                   help="Stacked-vs-per-job verdict mode: same-"
                        "bucket batches at -Ns through the stacked "
                        "executor ON vs OFF (byte-equality + "
                        "compile/dispatch counts)")
    p.add_argument("-dag", action="store_true",
                   help="Discovery-DAG verdict mode: DAG-vs-CLI "
                        "byte-equality + stacked-fold dispatch "
                        "collapse at -Ns")
    p.add_argument("-obs", action="store_true",
                   help="Fleet-observability verdict mode: one DAG "
                        "through a router + 2 subprocess replicas "
                        "must yield ONE cross-process trace (zero "
                        "orphans), artifacts byte-equal to an "
                        "untraced run, and a /fleet/metrics "
                        "job_e2e_seconds p99 matching an "
                        "independent snapshot merge")
    p.add_argument("-slo", action="store_true",
                   help="SLO-observatory verdict mode: a two-tenant "
                        "spike against a real router + replicas — "
                        "burn alerts in SLO-priority order, /scale "
                        "rise + decay, exact device-seconds "
                        "conservation, byte-equality vs an arm "
                        "without SLO specs")
    p.add_argument("-supervisor", action="store_true",
                   help="Fleet-supervisor verdict mode: a two-tenant "
                        "spike while a real supervisor spawns/drains "
                        "presto-serve processes from /scale — "
                        "fleet 1->N->1, high-SLO p99 held, zero "
                        "lost jobs, episode reconstructable from "
                        "supervisor_events.jsonl")
    p.add_argument("-campaign", action="store_true",
                   help="Campaign-engine verdict mode: an archive "
                        "campaign backfills in bounded waves while "
                        "a gold-SLO tenant keeps submitting — "
                        "campaign drains with exactly-once commits, "
                        "gold p99 within objective, backfill lane "
                        "yields under burn, ETA/cost projection "
                        "converges, episode reconstructable from "
                        "campaign_events.jsonl")
    p.add_argument("-Ns", type=str, default="1,4,8",
                   help="Stacked/dag mode: comma list of batch sizes")
    p.add_argument("-commit", action="store_true",
                   help="Verdict modes: write the report to "
                        "records/torch/ of this checkout: "
                        "SERVE_BATCH_r10.json (stacked), DAG_r11.json "
                        "(dag), OBS_r12.json (obs), SLO_r14.json (slo), "
                        "SUPERVISOR_r16.json (supervisor) or "
                        "CAMPAIGN_r17.json (campaign)")
    p.add_argument("-beams", type=int, default=4)
    p.add_argument("-rate", type=float, default=2.0,
                   help="Submission rate, jobs/s")
    p.add_argument("-nsamp", type=int, default=1 << 14)
    p.add_argument("-nchan", type=int, default=16)
    p.add_argument("-workdir", type=str, default=None,
                   help="Scratch root (default: a temp dir)")
    p.add_argument("-timeout", type=float, default=600.0)
    p.add_argument("-device", "--device", type=str, default="cuda",
                   help="Device of every service, replica and CLI the "
                        "tool starts (default cuda; without a card it "
                        "raises)")
    return p


def _run_verdict(args, mode: str, workdir: str, device: str) -> dict:
    Ns = tuple(int(n) for n in args.Ns.split(",") if n.strip())
    if mode == "campaign":
        return run_campaign_loadgen(workdir, timeout=args.timeout,
                                    device=device)
    if mode == "supervisor":
        return run_supervisor_loadgen(workdir, timeout=args.timeout,
                                      device=device)
    if mode == "slo":
        return run_slo_loadgen(workdir, timeout=args.timeout,
                               device=device)
    if mode == "obs":
        return run_obs_loadgen(workdir, timeout=args.timeout,
                               device=device)
    if mode == "dag":
        return run_dag_loadgen(workdir, Ns=Ns, timeout=args.timeout,
                               device=device)
    return run_stacked_loadgen(
        workdir, Ns=Ns,
        nsamp=args.nsamp if args.nsamp != 1 << 14 else 4096,
        nchan=min(args.nchan, 8), timeout=args.timeout, device=device)


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    modes = [m for m, _ in VERDICT_MODES if getattr(args, m)]
    if not (args.url or args.selfhost or args.replicas or modes):
        p.error("need -url, -selfhost, -replicas, -stacked, -dag, "
                "-obs, -slo, -supervisor, or -campaign")
    workdir = args.workdir or tempfile.mkdtemp(prefix="loadgen_")

    if modes:
        mode = modes[0]
        device = _device(args.device)
        report = _run_verdict(args, mode, workdir, device)
        if args.commit:
            if device.startswith("cuda"):
                report["card"] = card_line()
            out = commit_report(report, dict(VERDICT_MODES)[mode])
            print("serve_loadgen: report -> %s" % out)
        else:
            print(json.dumps(report, indent=1, sort_keys=True))
        return 0 if report["verdict"] == "PASS" else 1

    if args.replicas:
        device = _device(args.device)
        beams = make_beams(workdir, args.beams, nsamp=args.nsamp,
                           nchan=args.nchan)
        report = run_fleet_loadgen(workdir, beams,
                                   replicas=args.replicas,
                                   rate=args.rate,
                                   timeout=args.timeout,
                                   subprocess_mode=args.subprocess,
                                   device=device)
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0 if report["failed"] == 0 \
            and report["unfinished"] == 0 else 1

    service = httpd = None
    url = args.url
    if args.selfhost:
        from presto_tpu_torch.serve.server import SearchService, start_http
        service = SearchService(os.path.join(workdir, "serve"),
                                device=_device(args.device)).start()
        httpd = start_http(service)
        host, port = httpd.server_address[:2]
        url = "http://%s:%d" % (host, port)
    beams = make_beams(workdir, args.beams, nsamp=args.nsamp,
                       nchan=args.nchan)
    try:
        report = run_loadgen(url, beams, rate=args.rate,
                             timeout=args.timeout)
    finally:
        if httpd is not None:
            httpd.shutdown()
        if service is not None:
            service.stop()
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0 if report["failed"] == 0 and report["unfinished"] == 0 \
        else 1


if __name__ == "__main__":
    sys.exit(main())
