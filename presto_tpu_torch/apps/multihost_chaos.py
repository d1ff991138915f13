"""multihost_chaos: randomized worker-kill/stall schedules over a real
2-process elastic ``prepsubband -coordinator`` cluster of the port.

Counterpart of ``tools/multihost_chaos.py``, with its flags, its
report's keys and ``--device``.  Each trial draws (seeded, reproducible)
a victim process, an elastic kill point (obs/taxonomy
.CLUSTER_KILL_POINTS), a hit count, and a failure mode — ``exit``
(preemption: os._exit mid-run) or ``stall`` (a member wedged at a point,
the stuck-collective case).  Two real processes run the port's elastic
DM fan-out (apps/prepsubband ``-coordinator -nproc -procid -elastic``: a
gloo process group, one shard ledger) on ``--device`` (default cuda,
both ranks on the one card; without a card it raises, nothing falls
back).  The victim's kill comes from ``PRESTO_TORCH_ELASTIC_KILL``
(parallel/elastic.KILL_ENV); the survivor reaps it (missed heartbeat /
expired lease), bumps the epoch, re-admits the lost DM shards, and must
finish **all** DM rows with bytes equal to an unsharded, never-failed
single-process reference — within a wall-time deadline, so a stalled
collective can never exceed the configured barrier timeout unnoticed
(the survivor's collectives go through elastic.timed_call).

Each trial's coordinator is a free localhost port (the JAX tool's fixed
``12820 + 7 trial`` ports can collide on a shared host).  Subprocesses
import the port from this checkout (``PYTHONPATH``).

    python -m presto_tpu_torch.apps.multihost_chaos [--trials 3]
        [--seed 0] [--fast] [--nspec 8192] [--numdms 8] [--keep]
        [--workdir DIR] [--json-out PATH] [--device cuda]

``--json-out`` defaults to records/torch/MULTIHOST_CHAOS.json of this
checkout (never the JAX tool's record at the repository's root); exit
status 0 iff every trial converged.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

from presto_tpu_torch.apps.serve_loadgen import (RECORDS_DIR, REPO,
                                                 _subprocess_env)

NPROC = 2
#: the members' shard lease TTL and barrier timeout, and the survivor's
#: wall-time deadline (s)
LEASE_TTL_S, BARRIER_TIMEOUT_S, DEADLINE_S = 10.0, 8.0, 420.0
#: points a victim can be scheduled at (post-epoch-bump excluded: the
#: victim may never observe a bump, so the schedule could no-op)
VICTIM_POINTS = ["shard-leased", "shard-computed", "pre-shard-commit",
                 "post-shard-commit"]

REF = r"""
import os
os.environ["PRESTO_TORCH_DISABLE_MESH"] = "1"
from presto_tpu_torch.apps import prepsubband as app
app.run(app.build_parser().parse_args(
    ["-o", %(out)r, "-lodm", "10", "-dmstep", "2",
     "-numdms", "%(numdms)d", "-nsub", "%(nsub)d", "-nobary",
     %(raw)r]), device=%(device)r)
"""

CHILD = r"""
import sys
pid = int(sys.argv[1])
from presto_tpu_torch.apps import prepsubband as app
app.run(app.build_parser().parse_args(
    ["-coordinator", %(coord)r, "-nproc", "%(nproc)d",
     "-procid", str(pid), "-elastic",
     "-shard-rows", "%(shard_rows)d", "-lease-ttl", "%(ttl)g",
     "-heartbeat-interval", "0.2", "-barrier-timeout", "%(bto)g",
     "-o", %(out)r, "-lodm", "10", "-dmstep", "2",
     "-numdms", "%(numdms)d", "-nsub", "%(nsub)d", "-nobary",
     %(raw)r]), device=%(device)r)
"""


def _env():
    from presto_tpu_torch.parallel.elastic import KILL_ENV
    env = _subprocess_env()
    env.pop(KILL_ENV, None)
    return env


def _run_py(code, env, timeout):
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def draw_schedule(rng):
    """(victim, point, nth, mode): one trial's draw, in the JAX tool's
    order of rng calls."""
    victim = rng.randrange(NPROC)
    point = rng.choice(VICTIM_POINTS)
    nth = rng.randrange(1, 3)
    mode = rng.choice(["exit", "exit", "stall"])   # exit-heavy mix
    return victim, point, nth, mode


def child_code(coord, out, numdms, nsub, raw, shard_rows, ttl, bto,
               device) -> str:
    """The program each cluster member runs (its process id is argv[1])."""
    return CHILD % dict(coord=coord, nproc=NPROC, shard_rows=shard_rows,
                        ttl=ttl, bto=bto, out=out, numdms=numdms,
                        nsub=nsub, raw=raw, device=device)


def run_trial(trial, rng, raw, root, numdms, nsub, shard_rows, ttl,
              bto, deadline, device="cuda"):
    """One randomized worker-loss trial; returns a result dict with
    ok/byte_identical/epoch/mode/point."""
    from presto_tpu_torch.parallel.elastic import KILL_ENV
    work = os.path.join(root, "trial%02d" % trial)
    os.makedirs(work, exist_ok=True)
    victim, point, nth, mode = draw_schedule(rng)
    coord = "localhost:%d" % _free_port()
    out = {"victim": victim, "point": point, "nth": nth, "mode": mode,
           "ok": False}
    code = child_code(coord, os.path.join(work, "mh"), numdms, nsub, raw,
                      shard_rows, ttl, bto, device)
    procs = []
    t0 = time.time()
    for pid in range(NPROC):
        env = _env()
        if pid == victim:
            env[KILL_ENV] = "%s:%d:%s" % (point, nth, mode)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=REPO))
    survivor = procs[1 - victim]
    try:
        s_out, s_err = survivor.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        out["stage"] = "survivor-deadline (stalled collective?)"
        return out
    out["survivor_seconds"] = round(time.time() - t0, 1)
    # the victim is either dead (exit) or wedged in its stall: never
    # wait on it past the survivor
    try:
        procs[victim].communicate(timeout=1.0 if mode == "exit"
                                  else 0.1)
    except subprocess.TimeoutExpired:
        procs[victim].kill()
        procs[victim].communicate()
    out["victim_rc"] = procs[victim].returncode
    if survivor.returncode != 0:
        out["stage"] = "survivor-failed"
        out["stderr"] = s_err[-1200:]
        return out
    refs = sorted(glob.glob(os.path.join(root, "ref", "ref_DM*.dat")))
    mhs = sorted(glob.glob(os.path.join(work, "mh_DM*.dat")))
    out["ref_files"], out["mh_files"] = len(refs), len(mhs)
    same = len(refs) == len(mhs) == numdms
    for a, b in zip(refs, mhs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            same = same and fa.read() == fb.read()
    out["byte_identical"] = bool(same)
    try:
        with open(os.path.join(work, "shards.json")) as f:
            led = json.load(f)
        out["epoch"] = led.get("epoch")
        out["redos"] = sum(int(sh.get("redos", 0))
                           for sh in led.get("shards", {}).values())
    except (OSError, ValueError):
        pass
    out["ok"] = bool(same)
    return out


def prepare(root, nspec, nchan, numdms, device="cuda"):
    """Synthesize the observation (the JAX tool's bytes) and the
    unsharded single-process reference (in a subprocess with one
    device); returns (raw, nsub), or raises with the reference's error
    tail."""
    from presto_tpu_torch.models.synth import FakeSignal, \
        fake_filterbank_file
    os.makedirs(root, exist_ok=True)
    raw = os.path.join(root, "m.fil")
    nsub = min(16, nchan)
    fake_filterbank_file(raw, nspec, 5e-4, nchan, 400.0, 1.5,
                         FakeSignal(f=5.0, dm=30.0, shape="gauss",
                                    width=0.1, amp=1.0),
                         noise_sigma=2.0, nbits=8)
    env = _env()
    refdir = os.path.join(root, "ref")
    os.makedirs(refdir, exist_ok=True)
    r = _run_py(REF % dict(out=os.path.join(refdir, "ref"),
                           numdms=numdms, nsub=nsub, raw=raw,
                           device=device), env, 600)
    if r.returncode != 0:
        raise RuntimeError("reference failed:\n" + r.stderr[-1200:])
    return raw, nsub


def build_parser():
    p = argparse.ArgumentParser(
        prog="multihost_chaos",
        description="randomized worker-kill schedules over a real "
                    "2-process elastic prepsubband cluster")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fast", action="store_true",
                   help="1 trial, small N")
    p.add_argument("--nspec", type=int, default=1 << 13)
    p.add_argument("--nchan", type=int, default=16)
    p.add_argument("--numdms", type=int, default=8)
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--keep", action="store_true")
    p.add_argument("--json-out", type=str,
                   default=os.path.join(REPO, RECORDS_DIR,
                                        "MULTIHOST_CHAOS.json"))
    p.add_argument("-device", "--device", type=str, default="cuda",
                   help="Device of both cluster members and the "
                        "reference (default cuda; without a card it "
                        "raises)")
    return p


def run(args, device="cuda") -> dict:
    """Every trial of ``args`` (build_parser's, after --fast) on
    ``device``: the report (MULTIHOST_CHAOS.json's keys)."""
    root = args.workdir or tempfile.mkdtemp(prefix="mh_chaos_")
    os.makedirs(root, exist_ok=True)
    rng = random.Random(args.seed)
    shard_rows = max(1, args.numdms // 4)
    print("multihost_chaos: scratch=%s seed=%d trials=%d numdms=%d "
          "device=%s" % (root, args.seed, args.trials, args.numdms,
                         device))
    raw, nsub = prepare(root, args.nspec, args.nchan, args.numdms, device)
    print("reference: %d unsharded .dat files"
          % len(glob.glob(os.path.join(root, "ref", "ref_DM*.dat"))))
    results = []
    for trial in range(args.trials):
        res = run_trial(trial, rng, raw, root, args.numdms, nsub,
                        shard_rows, LEASE_TTL_S, BARRIER_TIMEOUT_S,
                        DEADLINE_S, device=device)
        results.append(res)
        print("trial %02d [victim=proc%d %s@%s#%d]: %s%s"
              % (trial, res["victim"], res["mode"], res["point"],
                 res["nth"], "PASS" if res["ok"] else "FAIL",
                 "" if res["ok"] else " " + str(res.get("stage",
                                                res.get("stderr",
                                                        "")))[:300]),
              flush=True)
    if not args.keep and args.workdir is None:
        shutil.rmtree(root, ignore_errors=True)
    return {"nproc": NPROC, "trials": args.trials, "seed": args.seed,
            "numdms": args.numdms, "nspec": args.nspec,
            "lease_ttl": LEASE_TTL_S, "barrier_timeout": BARRIER_TIMEOUT_S,
            "results": results,
            "ok": all(r["ok"] for r in results)}


def main(argv=None) -> int:
    from presto_tpu_torch.io.atomic import atomic_write_text
    from presto_tpu_torch.search.accel import resolve_device
    args = build_parser().parse_args(argv)
    device = str(resolve_device(args.device))
    if args.fast:
        args.trials = min(args.trials, 1)
        args.nspec = min(args.nspec, 1 << 12)
        args.nchan = min(args.nchan, 8)
    try:
        art = run(args, device)
    except RuntimeError as e:
        print(e)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                exist_ok=True)
    atomic_write_text(args.json_out, json.dumps(art, indent=1))
    passed = sum(1 for r in art["results"] if r["ok"])
    print("multihost_chaos: %d/%d trials passed -> %s"
          % (passed, args.trials, args.json_out))
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
