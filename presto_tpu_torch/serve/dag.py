"""Discovery DAGs: the full science loop as one submitted job graph.

Host copy of ``presto_tpu/serve/dag.py`` for the PyTorch port, over
the port's survey entry points: node executors run on the service's
device (``SearchService.device``: the search node's two CUDA kernels,
the fold drizzles, the triage score).  A `DagSpec`
(search -> sift -> fold-per-surviving-candidate -> timing) is
submitted to the router as ONE durable unit, and replicas lease *any
ready node*, so cheap fan-out work (folds) from one survey
interleaves with heavy searches from another across the fleet.

The graph machinery rides the exactly-once lease core
(serve/jobledger.py):

  * **Dependencies** — a node admitted ``blocked_on`` its parents
    becomes leasable only once every parent's *fence-checked* commit
    lands; a zombie replica's late result never unblocks a child
    (the parent's state only becomes ``done`` through the epoch
    fence).
  * **Dynamic fan-out** — the sift node's surviving-candidate list
    decides the fold set at runtime.  The replica commits the sift
    result AND creates the fold jobs (plus the timing node's fold
    fan-in retarget) in ONE ledger transaction
    (`JobLedger.complete_and_expand`): a crash between "result
    landed" and "children exist" is impossible, re-expansion is
    idempotent, and a fenced zombie expands nothing.
  * **Fold stacking** — same-geometry fold jobs share a ledger/queue
    bucket (`apps/prepfold.fold_stack_key`), so `lease_batch` claims
    a whole fold batch, the micro-batching queue coalesces it, and
    `StackedBatchExecutor` runs the folds as ONE batched drizzle
    dispatch (`apps/prepfold.fold_dat_cands`) where N per-job folds
    pay N — the same continuous-batching shape search jobs ride.

Node executors run inside the replica's `SearchService`
(`execute_node`), reading parent artifacts from the parents'
*committed* epoch-stamped attempt dirs (resolved by the replica at
lease time, so a zombie's tree is never read).  Artifact labels
embedded in fold/timing outputs are basenames, making every DAG
artifact byte-equal to the hand-driven CLI sequence
(`accelsearch -> ACCEL_sift -> prepfold -> get_TOAs`).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

from presto_tpu_torch.serve.queue import Job, JobStatus

#: DAG node kinds (``survey`` is the ordinary search job; ``triage``
#: is the opt-in learned scorer between sift and fold, triage/)
NODE_KINDS = ("survey", "sift", "triage", "fold", "toa")


def _bucket_hint(rawfiles, config) -> Optional[str]:
    """Best-effort plan-bucket hint for the search node (the router's
    admission-time computation; failure degrades to None — single
    leasing, never a rejected admission)."""
    try:
        from presto_tpu_torch.pipeline.survey import SurveyConfig
        from presto_tpu_torch.serve.plancache import bucket_key
        return repr(bucket_key(list(rawfiles),
                               SurveyConfig(**dict(config or {}))))
    except Exception:
        return None


def _pass_zmaxes(config: dict) -> List[int]:
    """The accel-pass zmax list the search node will write ACCEL
    tables for — the sift node's glob set."""
    try:
        from presto_tpu_torch.pipeline.survey import SurveyConfig
        cfg = SurveyConfig(**dict(config or {}))
        return [int(z) for (z, _nh, _sg, _flo) in cfg.all_passes]
    except Exception:
        return [int((config or {}).get("zmax", 0))]


def plan_dag(spec: dict):
    """Turn one wire-level DAG submission into the node list
    `JobLedger.admit_dag` takes: ``[(rel_id, node_spec, bucket,
    parent_rel_ids)]``.

    Wire schema (POST /dag)::

        {"rawfiles": [...],          # required
         "config":   {...},          # SurveyConfig fields (search)
         "sift":     {"min_dm_hits", "low_dm_cutoff"},
         "fold":     {"fold_top", "fold_sigma", "max_folds"},
         "triage":   true | {"budget", "budget_frac",
                             "weights", "borderline_frac"},
         "toa":      {"ntoa", "gauss_fwhm", "fmt"},
         "tenant":   "...", "priority": int}

    With ``triage`` set, a fifth node kind slots between sift and
    fold: search -> sift -> triage -> folds -> toa.  The sift node
    keeps writing the sifted list but hands its fan-out to the
    triage node, which scores the heuristic fold selection with the
    learned ranker (triage/) and fans out only the
    surviving budget — the SAME `complete_and_expand` transaction,
    cascade-fail, and chaos seams the sift fan-out rides.  Truth
    sidecars (``<rawfile>_injected.json``, the port's models/inject
    naming) found beside the rawfiles at submission are stamped into
    the node spec so injection recall rides real traffic.

    The search node is an ordinary survey job (it stacks with plain
    search traffic) with folding disabled — folds are DAG nodes —
    and durable stages forced on: fold nodes read the committed .dat
    trials from the search attempt dir."""
    rawfiles = spec.get("rawfiles")
    if not rawfiles or not isinstance(rawfiles, (list, tuple)):
        raise ValueError("dag spec.rawfiles must be a non-empty list")
    config = dict(spec.get("config") or {})
    config["fold_top"] = 0
    config.pop("fold_sigma", None)
    config["durable_stages"] = True
    search_spec = {"rawfiles": list(rawfiles), "config": config}
    sift_spec = {
        "kind": "sift",
        "parents": {"search": "search"},
        "retarget": "toa",
        "zmaxes": _pass_zmaxes(config),
        "sift": dict(spec.get("sift") or {}),
        "fold": dict(spec.get("fold") or {}),
    }
    toa_spec = {
        "kind": "toa",
        "parents": {"fold": []},
        "toa": dict(spec.get("toa") or {}),
    }
    tpol = spec.get("triage")
    if not tpol:
        return [
            ("search", search_spec, _bucket_hint(rawfiles, config),
             []),
            ("sift", sift_spec, None, ["search"]),
            ("toa", toa_spec, None, ["sift"]),
        ]
    tpol = dict(tpol) if isinstance(tpol, dict) else {}
    if "truth" not in tpol:
        from presto_tpu_torch.triage.calibrate import find_truth_sidecars
        tpol["truth"] = find_truth_sidecars(list(rawfiles))
    # the sift node keeps its durable artifact but hands fan-out (and
    # the toa retarget) to the triage node
    sift_spec.pop("retarget", None)
    sift_spec["fanout"] = False
    triage_spec = {
        "kind": "triage",
        "parents": {"search": "search", "sift": "sift"},
        "retarget": "toa",
        "zmaxes": _pass_zmaxes(config),
        "sift": dict(spec.get("sift") or {}),
        "fold": dict(spec.get("fold") or {}),
        "triage": tpol,
    }
    return [
        ("search", search_spec, _bucket_hint(rawfiles, config), []),
        ("sift", sift_spec, None, ["search"]),
        ("triage", triage_spec, None, ["sift"]),
        ("toa", toa_spec, None, ["triage"]),
    ]


# ----------------------------------------------------------------------
# Node jobs in the local service
# ----------------------------------------------------------------------

def build_node_job(service, spec: dict, job_id: Optional[str] = None,
                   workdir: Optional[str] = None) -> Job:
    """Validate one DAG node spec into a local queue Job (the
    node-kind arm of SearchService.build_job).  The bucket is the
    ledger row's (injected by the replica at lease time) — fold jobs
    carry their stack signature so same-geometry folds coalesce;
    sift/toa nodes get a unique bucket so they never falsely
    coalesce."""
    from presto_tpu_torch.serve.server import BadRequest
    kind = str(spec.get("kind") or "")
    if kind not in NODE_KINDS or kind == "survey":
        raise BadRequest("unknown dag node kind %r" % kind)
    job_id = str(job_id or spec.get("job_id")
                 or "%s-%06d" % (kind, next(service._ids)))
    with service._jobs_lock:
        old = service._jobs.get(job_id)
        if old is not None and old.status not in JobStatus.SETTLED:
            raise BadRequest("duplicate job_id %r" % job_id)
    bucket = spec.get("bucket") or "dag-node:%s" % job_id
    return Job(job_id=job_id, rawfiles=[], cfg=None,
               workdir=workdir or os.path.join(service.workroot,
                                               job_id),
               priority=int(spec.get("priority", 10)),
               bucket=bucket, spec=dict(spec), kind=kind)


def _parent_dirs(job: Job, role: str):
    dirs = (job.spec.get("parent_dirs") or {}).get(role)
    if dirs is None:
        raise ValueError(
            "dag node %s has no resolved %r parent dir (submitted "
            "outside a fleet replica without spec.parent_dirs?)"
            % (job.job_id, role))
    return dirs


def _nodes_done(service, kind: str, n: int = 1) -> None:
    service.obs.metrics.counter(
        "dag_nodes_done_total",
        "DAG nodes executed to completion, by kind",
        ("kind",)).labels(kind=kind).inc(n)


def execute_node(service, job: Job) -> dict:
    """Execute one leased DAG node on the scheduler thread (the
    node-kind arm of SearchService._execute_job)."""
    span = service.obs.span("serve:dag-node", job=job.job_id,
                            kind=job.kind, dag=job.spec.get("dag"))
    try:
        if job.kind == "sift":
            result = _execute_sift(service, job)
        elif job.kind == "triage":
            result = _execute_triage(service, job)
        elif job.kind == "fold":
            result = _execute_fold(service, job)
        elif job.kind == "toa":
            result = _execute_toa(service, job)
        else:
            raise ValueError("unknown dag node kind %r" % job.kind)
    except Exception as e:
        span.finish("error: %s" % type(e).__name__)
        raise
    span.finish()
    _nodes_done(service, job.kind)
    return result


# ---- sift: candidates in, fold fan-out + timing fan-in out -----------

def _sift_parent_candlist(job: Job, pdir: str):
    """(Candlist, zmaxes): the sifted survivors of the search
    parent's ACCEL tables — deterministic (sorted glob, sorted
    reads), so the sift node and a downstream triage node derive the
    IDENTICAL list from the same committed parent dir."""
    from presto_tpu_torch.pipeline.sifting import sift_candidates
    spec = job.spec
    zmaxes = [int(z) for z in (spec.get("zmaxes") or [0])]
    accfiles = []
    for z in zmaxes:
        accfiles += glob.glob(os.path.join(pdir, "*_ACCEL_%d" % z))
    accfiles = sorted(set(accfiles))
    pol = spec.get("sift") or {}
    cl = sift_candidates(
        accfiles, numdms_min=int(pol.get("min_dm_hits", 2)),
        low_DM_cutoff=float(pol.get("low_dm_cutoff", 2.0)))
    return cl, zmaxes


def _heuristic_selection(job: Job, cl, zmaxes) -> tuple:
    """(selected, accounting): the shared fold-selection policy the
    batch survey uses, heuristic arm only — the safe superset a
    triage policy may truncate."""
    from presto_tpu_torch.pipeline.sifting import select_fold_candidates
    fpol = job.spec.get("fold") or {}
    per_pass = fpol.get("max_folds_per_pass")
    accounting: dict = {}
    top = select_fold_candidates(
        cl, fold_top=int(fpol.get("fold_top", 3)),
        fold_sigma=fpol.get("fold_sigma"),
        max_folds=int(fpol.get("max_folds", 150)),
        max_folds_per_pass=tuple(per_pass) if per_pass else None,
        pass_zmaxes=zmaxes, accounting=accounting)
    return top, accounting


def _fold_fanout(job: Job, top, pdir: str) -> tuple:
    """(children, retarget): one fold child per selected candidate,
    bucketed by the exact stack signature fold_dat_cands will group
    by, plus the timing node's fan-in retarget.  Shared verbatim by
    the sift node (heuristic path) and the triage node (scored
    path), which is what keeps triage policy-not-data-path: a
    candidate selected by either node fans out the identical fold
    spec, so the fold artifacts are byte-equal."""
    from presto_tpu_torch.apps.prepfold import (accel_cand_fold_params,
                                                fold_geometry,
                                                fold_stack_key)
    from presto_tpu_torch.io.infodata import read_inf
    spec = job.spec
    dag_id = spec.get("dag") or job.job_id
    search_id = (spec.get("parents") or {}).get("search")
    children, fold_ids = [], []
    for i, c in enumerate(top):
        accpath = os.path.join(c.path or pdir, c.filename)
        datbase = accpath.split("_ACCEL_")[0]
        info = read_inf(datbase)
        f0, fd0, _fdd = accel_cand_fold_params(
            accpath + ".cand", c.candnum, info.N * info.dt)
        N, dt, proflen, subdiv = fold_geometry(datbase + ".dat",
                                               f0, fd0)
        fid = "%s-fold-%03d" % (dag_id, i + 1)
        fold_ids.append(fid)
        children.append([fid, {
            "spec": {
                "kind": "fold",
                "dag": dag_id,
                "parents": {"search": search_id},
                "fold": {
                    "accelfile": os.path.basename(accpath) + ".cand",
                    "candnum": int(c.candnum),
                    "dm": float(c.DM),
                    "datfile": os.path.basename(datbase) + ".dat",
                    "outname": "fold_cand%d" % (i + 1),
                },
            },
            "bucket": fold_stack_key(N, dt, proflen, 64, subdiv),
            "blocked_on": [job.job_id],
            "dag": dag_id,
        }])
    retarget = {}
    toa_id = spec.get("retarget")
    if toa_id:
        retarget[toa_id] = {"blocked_on": list(fold_ids),
                            "parents": {"fold": list(fold_ids)}}
    return children, retarget


def _execute_sift(service, job: Job) -> dict:
    """Sift the search node's ACCEL tables, write the sifted list,
    and COMPUTE the dynamic fan-out: one fold child per surviving
    candidate (under the shared fold-selection policy) plus the
    timing node's retarget.  The fan-out is *returned*, not applied —
    the replica hands it to `JobLedger.complete_and_expand`, so
    children exist exactly when the sift result's fenced commit
    lands.  With ``spec.fanout`` false (a triage DAG), the node
    stops at the durable sifted list — the triage node downstream
    owns the fan-out."""
    spec = job.spec
    pdir = _parent_dirs(job, "search")
    cl, zmaxes = _sift_parent_candlist(job, pdir)
    os.makedirs(job.workdir, exist_ok=True)
    candfile = os.path.join(job.workdir, "cands_sifted.txt")
    cl.to_file(candfile)
    nbad = sum(len(v) for v in cl.badcands.values())
    result = {
        "candfile": os.path.basename(candfile),
        "n_cands": len(cl),
        "n_rejected": nbad,
        "n_duplicates": len(cl.duplicates),
    }
    if spec.get("fanout", True) is False:
        result["folds"] = 0
        result["deferred_to_triage"] = True
        return result
    top, accounting = _heuristic_selection(job, cl, zmaxes)
    children, retarget = _fold_fanout(job, top, pdir)
    result.update({
        "folds": len(children),
        "n_untagged_dropped": accounting.get("untagged_dropped", 0),
        "dag_children": children,
        "dag_retarget": retarget,
    })
    return result


# ---- triage: score the heuristic selection, fold only the budget -----

def _execute_triage(service, job: Job) -> dict:
    """Score the heuristic fold selection with the learned ranker (on
    the service's device) and fan out only the surviving budget
    (triage/).

    Semantics are the sift node's, inherited wholesale: the fan-out
    is returned for `complete_and_expand` (atomic, idempotent,
    zombie-fenced), a failure cascades to the toa node, and the
    replica's fold-fanout / post-sift-commit chaos seams fire around
    the commit because they key on the result's children, not the
    node kind.  On ANY weights problem the selection degrades to the
    heuristic list unchanged — the byte-stable default — and says so
    (``triage-fallback`` event, ``mode`` in the result)."""
    from presto_tpu_torch.triage.calibrate import load_truth, truth_matches
    from presto_tpu_torch.triage.model import TriagePolicy
    spec = job.spec
    pdir = _parent_dirs(job, "search")
    span = service.obs.span("serve:triage-node", job=job.job_id,
                            dag=spec.get("dag"))
    try:
        cl, zmaxes = _sift_parent_candlist(job, pdir)
        heuristic, accounting = _heuristic_selection(job, cl, zmaxes)
        tpol = spec.get("triage") or {}
        policy = TriagePolicy(
            weights_path=tpol.get("weights") or None,
            budget=tpol.get("budget"),
            budget_frac=tpol.get("budget_frac"),
            borderline_frac=float(tpol.get("borderline_frac", 0.25)),
            datdir=pdir, device=service.device)
        selected, acct = policy.select(heuristic, obs=service.obs)
        scores = acct.pop("scores", None)

        truth = []
        for side in tpol.get("truth") or ():
            truth += load_truth(side)
        recall = None
        recovered = 0
        if truth:
            matched = {m for m in truth_matches(selected, truth)
                       if m is not None}
            recovered = len(matched)
            recall = len(matched) / len(truth)
            service.obs.metrics.gauge(
                "triage_recall",
                "Injected-pulsar recall of the triage fold "
                "selection, from truth sidecars riding the "
                "traffic").set(recall)
        service.obs.metrics.counter(
            "triage_candidates_scored_total",
            "Sift survivors scored by the triage "
            "ranker").inc(acct["scored"])
        service.obs.metrics.counter(
            "triage_folds_avoided_total",
            "Folds the triage budget cut from the heuristic "
            "selection").inc(acct["folds_avoided"])

        os.makedirs(job.workdir, exist_ok=True)
        _write_scores(job, heuristic, selected, scores, acct,
                      recall)
        children, retarget = _fold_fanout(job, selected, pdir)
        if acct["mode"] == "triage":
            service.events.emit(
                "triage-score", job=job.job_id, dag=spec.get("dag"),
                scored=acct["scored"], selected=acct["selected"],
                folds_avoided=acct["folds_avoided"],
                recall=recall)
        else:
            service.events.emit(
                "triage-fallback", job=job.job_id,
                dag=spec.get("dag"),
                load_error=acct.get("load_error"))
    except Exception as e:
        span.finish("error: %s" % type(e).__name__)
        raise
    span.finish()
    return {
        "mode": acct["mode"],
        "scored": acct["scored"],
        "heuristic_folds": len(heuristic),
        "folds": len(children),
        "folds_avoided": acct["folds_avoided"],
        "load_error": acct.get("load_error"),
        "recall": recall,
        "recovered": recovered,
        "injected": len(truth),
        "n_untagged_dropped": accounting.get("untagged_dropped", 0),
        "scorefile": "triage_scores.json",
        "dag_children": children,
        "dag_retarget": retarget,
    }


def _write_scores(job: Job, heuristic, selected, scores, acct,
                  recall) -> None:
    """The node's durable artifact: every scored candidate with its
    score and the selection verdict (atomic write; read by
    presto-report and the calibration loop)."""
    import json

    from presto_tpu_torch.io.atomic import atomic_write_text
    chosen = {(c.filename, c.candnum) for c in selected}
    rows = []
    for i, c in enumerate(heuristic):
        rows.append({
            "filename": c.filename, "candnum": int(c.candnum),
            "sigma": float(c.sigma), "dm": float(c.DM),
            "f": float(c.f),
            "score": (float(scores[i]) if scores is not None
                      else None),
            "selected": (c.filename, c.candnum) in chosen,
        })
    atomic_write_text(
        os.path.join(job.workdir, "triage_scores.json"),
        json.dumps({"schema": 1, "mode": acct["mode"],
                    "budget": acct.get("budget"),
                    "recall": recall, "candidates": rows},
                   indent=1, sort_keys=True))


# ---- fold: one candidate, CLI-parity artifacts -----------------------

def _fold_spec(job: Job):
    from presto_tpu_torch.apps.prepfold import DatFoldSpec
    pdir = _parent_dirs(job, "search")
    f = job.spec.get("fold") or {}
    os.makedirs(job.workdir, exist_ok=True)
    return DatFoldSpec(
        datfile=os.path.join(pdir, f["datfile"]),
        accelfile=os.path.join(pdir, f["accelfile"]),
        candnum=int(f.get("candnum", 1)),
        outbase=os.path.join(job.workdir,
                             f.get("outname", "fold_cand1")),
        dm=float(f.get("dm", 0.0)))


def _fold_result(res: dict) -> dict:
    return {
        "pfd": os.path.basename(res["pfd"]),
        "bestprof": os.path.basename(res["bestprof"]),
        "best_p": res["best_p"],
        "best_pd": res["best_pd"],
        "best_redchi": res["best_redchi"],
        "stacked": res["stacked"],
    }


def _execute_fold(service, job: Job) -> dict:
    from presto_tpu_torch.apps.prepfold import fold_dat_cands
    res = fold_dat_cands([_fold_spec(job)], device=service.device,
                         obs=service.obs)[0]
    return _fold_result(res)


def run_folds_stacked(service, jobs: List[Job]) -> List[dict]:
    """The StackedBatchExecutor's fold arm: a coalesced same-bucket
    fold batch runs as ONE batched drizzle set on the service's device
    (apps/prepfold.fold_dat_cands groups by the stack signature the
    bucket already pinned), byte-identical to per-job folds."""
    from presto_tpu_torch.apps.prepfold import fold_dat_cands
    specs = [_fold_spec(job) for job in jobs]
    results = fold_dat_cands(specs, device=service.device, obs=service.obs)
    service.obs.metrics.counter(
        "dag_folds_stacked_total",
        "Fold jobs executed through the stacked drizzle "
        "dispatch").inc(len(jobs))
    _nodes_done(service, "fold", len(jobs))
    return [_fold_result(r) for r in results]


# ---- toa: fold fan-in, one .tim ---------------------------------------

def _execute_toa(service, job: Job) -> dict:
    """Extract TOAs from every committed fold parent (on the service's
    device), in candidate order, through the CLI's own line formatter
    (get_toas.toa_lines) — the .tim is byte-equal to the hand-driven
    `get_TOAs -o`."""
    from presto_tpu_torch.apps.get_toas import toa_lines
    from presto_tpu_torch.io.atomic import atomic_open
    from presto_tpu_torch.io.errors import PrestoIOError
    dirs = _parent_dirs(job, "fold")
    pfds = []
    for d in dirs:
        found = sorted(glob.glob(os.path.join(d, "*.pfd")))
        if not found:
            raise PrestoIOError("no .pfd in committed fold dir",
                                path=d, kind="missing")
        pfds.extend(found)
    pol = job.spec.get("toa") or {}
    lines = toa_lines(pfds, ntoa=int(pol.get("ntoa", 1)),
                      gauss_fwhm=float(pol.get("gauss_fwhm", 0.1)),
                      fmt=str(pol.get("fmt", "princeton")),
                      device=service.device)
    os.makedirs(job.workdir, exist_ok=True)
    timf = os.path.join(job.workdir, "toas.tim")
    with atomic_open(timf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {"tim": os.path.basename(timf), "n_pfds": len(pfds),
            "n_toas": sum(1 for ln in lines
                          if ln and not ln.startswith("FORMAT"))}
