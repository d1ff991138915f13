"""obs-coverage: the instrumentation-coverage contract (20 checks).

Host copy of ``presto_tpu/lint/obscoverage.py`` for the PyTorch port.
The contract lives in presto_tpu_torch/obs/taxonomy.py (the JAX
package's catalog up to its ``PORT_CHANGES``); these checks
cross-check the port's *source tree* against it so an uninstrumented
code path cannot ship silently.  The paths below are the port's, under
``presto_tpu_torch/``; check 5 reads the whole port and
``chip_smoke.py``, and check 15 reads the port's cost modules only
(``bench.py`` is the JAX package's):

  1. every `timer.mark("<stage>")` in pipeline/survey.py is a
     registered SURVEY_STAGE (=> it emits a
     survey_stage_seconds{stage=...} sample and a span);
  2. every `_chaos(cfg, "<point>", ...)` kill point is a registered
     KILL_POINT (=> it is flight-recorded before it can fire) — and
     conversely every registered point still exists in the source;
  2b. every elastic-cluster kill point (`self._point("...")` in
     parallel/elastic.py) and event (`.event("...")`/`._event("...")`
     in parallel/elastic.py + pipeline/shardledger.py) is registered
     in CLUSTER_KILL_POINTS / CLUSTER_EVENTS — and conversely;
  3. every `events.emit("<kind>", ...)` in serve/ is a
     registered SERVE_EVENT;
  4. every job lifecycle state (JobStatus constants in serve/queue.py)
     maps via JOB_STATE_EVENTS to an event kind that the serve layer
     actually emits — a new scheduler state transition without
     telemetry fails here;
  5. every metric registered anywhere in the port or chip_smoke.py
     (`.counter("..." / .gauge("..." / .histogram("...`) is listed in
     METRICS (the documented catalog);
  6. the tune layer (tune/ + apps/tune.py): every
     `obs.span("...")` name it opens is registered in TUNE_SPANS —
     and conversely; and every `tune_*` metric listed in METRICS is
     actually registered by the tune layer (the forward direction is
     check 5), so a tuning code path cannot ship unobservable and the
     catalog cannot list dead tuning telemetry;
  7. the streaming layer (stream/): spans vs STREAM_SPANS
     and event kinds vs STREAM_EVENTS, BOTH directions, plus every
     `stream_*` metric listed in METRICS registered by the stream
     layer — the live trigger path is the one place an unobservable
     code path costs real pulses, so its whole telemetry vocabulary
     is pinned;
  8. the fused pipeline (pipeline/fusion.py): every
     `obs.span("pipeline:...")` it opens is registered in
     FUSION_SPANS — and conversely — and every `survey_fused_*`
     metric listed in METRICS is actually registered by the fusion
     layer, so the in-memory data path (which deliberately SKIPS the
     durable artifacts a post-mortem would otherwise read) cannot
     ship with its telemetry dark;
  9. the DM-SHARDED seam (the multi-device arm of the fused
     pipeline): SHARDED_FUSION_SPANS / SHARDED_KILL_POINTS /
     SHARDED_FUSION_METRICS are pinned BOTH directions against the
     source (and as subsets of their parent catalogs);
  10. the FLEET serving layer (serve/jobledger.py + serve/fleet.py +
     serve/router.py): FLEET_EVENTS and the `fleet_*` metrics are
     pinned BOTH directions (event kinds count whether emitted
     literally or bound as LeaseLedger EV_* class attributes);
  11. serve-layer spans (serve/): every `obs.span("...")`
     name the serve layer opens is registered in SERVE_SPANS — and
     conversely;
  12. discovery DAGs (serve/dag.py + jobledger.py + router.py +
     fleet.py): DAG_EVENTS / DAG_SPANS / DAG_METRICS pinned BOTH
     directions (and as subsets of their parent catalogs);
  13. fleet-wide observability (serve/fleet.py + serve/router.py +
     obs/fleetagg.py): FLEET_SPANS / FLEET_OBS_EVENTS /
     FLEET_OBS_METRICS pinned BOTH directions and as subsets of
     their parent catalogs;
  14. the SLO observatory (obs/slo.py + serve/jobledger.py +
     serve/router.py): SLO_METRICS / SLO_EVENTS / SLO_SPANS pinned
     BOTH directions (and as subsets of their parent catalogs) — the
     usage metering at the fence-checked commit and the burn/scale
     decision signals are the contract future control-plane PRs
     (autoscaler, device-seconds admission) inherit, so they may
     neither go dark nor go stale;
  15. the kernel observatory (obs/costmodel.py + obs/roofline.py): COST_SPANS (`obs:roofline-probe`) / COST_METRICS
     (kernel_flops_total, kernel_hbm_bytes_total,
     cost_model_unavailable) pinned BOTH directions (and as a subset
     of METRICS) — the per-kind FLOP/byte dispatch join is the
     measurement rig every remaining perf item (Pallas dedisp, GPU
     backend, learned tuner) is judged by;
  16. the fleet supervisor (serve/supervisor.py + serve/router.py +
     serve/jobledger.py): SUPERVISOR_EVENTS / SUPERVISOR_SPANS /
     SUPERVISOR_METRICS pinned BOTH directions (and as subsets of
     their parent catalogs) — the control loop that actuates /scale
     must leave a reconstructable trail (every spawn/drain/hold with
     its inputs), so its telemetry vocabulary is pinned the moment it
     ships;
  17. the campaign engine (serve/campaign.py + serve/router.py +
     serve/supervisor.py): CAMPAIGN_EVENTS / CAMPAIGN_SPANS /
     CAMPAIGN_METRICS pinned BOTH directions (and as subsets of their
     parent catalogs) — archive-scale reprocessing is driven entirely
     from a durable ledger, so every admission wave, yield decision,
     and paced preemption must land on telemetry a post-mortem can
     replay; a campaign code path without its vocabulary (or a stale
     vocabulary entry) fails here;
  18. the beam multiplexer (stream/beams.py): BEAM_EVENTS /
     BEAM_SPANS / BEAM_METRICS pinned BOTH directions (and as
     subsets of their parent catalogs), plus the three-way
     kill-point pin (taxonomy == beams.BEAM_KILL_POINTS ==
     testing/chaos re-export);
  19. the federation front door (serve/federation.py): FED_EVENTS /
     FED_SPANS / FED_METRICS pinned BOTH directions (and as subsets
     of their parent catalogs), plus the three-way kill-point pin
     (taxonomy == federation.FED_KILL_POINTS == testing/chaos
     re-export) — whole-fleet failover runs exactly while a site is
     dying, so every placement, spill, re-admission, and fenced
     zombie commit must land on telemetry a post-mortem can replay;
  20. learned candidate triage (triage/ + the serve/dag.py
     triage node + apps/triage.py): TRIAGE_EVENTS / TRIAGE_SPANS /
     TRIAGE_METRICS pinned BOTH directions (and as subsets of their
     parent catalogs) — triage decides which candidates are never
     folded, so every learned selection, heuristic degrade
     (missing/corrupt weights), and calibration run must land on
     telemetry a post-mortem can replay.

Run via ``python -m presto_tpu_torch.apps.presto_lint`` (exit-1 CLI
over every family) or the ``apps/obs_lint`` shim.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys
from typing import Dict, List, Optional, Set

from presto_tpu_torch.lint.core import Finding, Tree, register

#: the repo root this package is installed in (three levels up)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STAGE_RE = re.compile(r'timer\.mark\(\s*"([^"]+)"\s*\)')
CHAOS_RE = re.compile(r'_chaos\(\s*cfg\s*,\s*"([^"]+)"')
EMIT_RE = re.compile(r'events\.emit\(\s*"([^"]+)"')
POINT_RE = re.compile(r'\._point\(\s*\n?\s*"([^"]+)"')
CLUSTER_EVENT_RE = re.compile(r'\._?event\(\s*\n?\s*"([^"]+)"')
STATUS_RE = re.compile(r'^\s+([A-Z_]+)\s*=\s*"([a-z-]+)"\s*$',
                       re.MULTILINE)
#: event kinds bound as ledger class attributes (the generic
#: LeaseLedger emits via EV_* names; subclasses declare the literal
#: vocabulary — see pipeline/leaseledger.py)
EVENT_ATTR_RE = re.compile(r'^\s*EV_[A-Z_]+\s*=\s*"([^"]+)"',
                           re.MULTILINE)
METRIC_RE = re.compile(
    r'\.(?:counter|gauge|histogram)\(\s*\n?\s*"([a-z0-9_]+)"')
SPAN_RE = re.compile(r'\.span\(\s*\n?\s*"([^"]+)"')


def _read(relpath: str, root: str) -> str:
    with open(os.path.join(root, relpath)) as f:
        return f.read()


def _tree_sources(root: str, *roots: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for sub in roots:
        if sub.endswith(".py"):
            try:
                out[sub] = _read(sub, root)
            except OSError:
                pass
            continue
        for dirpath, _dirs, files in os.walk(os.path.join(root, sub)):
            for name in files:
                if name.endswith(".py"):
                    p = os.path.join(dirpath, name)
                    rel = os.path.relpath(p, root)
                    with open(p) as f:
                        out[rel] = f.read()
    return out


def _load_taxonomy(root: str):
    """The catalog of the tree at `root` (read from its file, so a tree
    other than the installed package is held to its own catalog)."""
    spec = importlib.util.spec_from_file_location(
        "_presto_lint_taxonomy",
        os.path.join(root, "presto_tpu_torch", "obs", "taxonomy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lint(root: Optional[str] = None) -> List[str]:
    """Run every coverage check; returns a list of violation strings
    (the historical obs_lint API, kept for the shim and tests)."""
    root = root or REPO
    taxonomy = _load_taxonomy(root)

    problems: List[str] = []
    survey_src = _read("presto_tpu_torch/pipeline/survey.py", root)

    # 1. survey stages
    stages = set(STAGE_RE.findall(survey_src))
    for s in sorted(stages - taxonomy.SURVEY_STAGES):
        problems.append(
            "pipeline/survey.py: stage %r is not registered in "
            "obs/taxonomy.SURVEY_STAGES (uninstrumented stage)" % s)
    for s in sorted(taxonomy.SURVEY_STAGES - stages):
        problems.append(
            "obs/taxonomy.py: SURVEY_STAGES lists %r but "
            "pipeline/survey.py never marks it" % s)

    # 2. chaos kill points (both directions: the taxonomy IS the
    # documented flight-recorder vocabulary)
    points = set(CHAOS_RE.findall(survey_src))
    for p in sorted(points - taxonomy.KILL_POINTS):
        problems.append(
            "pipeline/survey.py: kill point %r is not registered in "
            "obs/taxonomy.KILL_POINTS" % p)
    for p in sorted(taxonomy.KILL_POINTS - points):
        problems.append(
            "obs/taxonomy.py: KILL_POINTS lists %r but "
            "pipeline/survey.py never fires it" % p)

    # 2b. elastic-cluster kill points and events (parallel/elastic.py
    # + pipeline/shardledger.py are the worker-loss recovery layer;
    # its kill points and flight-recorder events are a registered
    # vocabulary exactly like the survey's — since the ledger core
    # moved to pipeline/leaseledger.py, shardledger declares its
    # event kinds as EV_* class attributes, which count as emitted)
    elastic_files = ("presto_tpu_torch/parallel/elastic.py",
                     "presto_tpu_torch/pipeline/shardledger.py")
    cpoints: Set[str] = set()
    cevents: Set[str] = set()
    for rel in elastic_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        cpoints |= set(POINT_RE.findall(src))
        cevents |= set(CLUSTER_EVENT_RE.findall(src))
        cevents |= set(EVENT_ATTR_RE.findall(src))
    for p in sorted(cpoints - taxonomy.CLUSTER_KILL_POINTS):
        problems.append(
            "parallel/elastic.py: kill point %r is not registered in "
            "obs/taxonomy.CLUSTER_KILL_POINTS" % p)
    for p in sorted(taxonomy.CLUSTER_KILL_POINTS - cpoints):
        problems.append(
            "obs/taxonomy.py: CLUSTER_KILL_POINTS lists %r but the "
            "elastic layer never fires it" % p)
    for k in sorted(cevents - taxonomy.CLUSTER_EVENTS):
        problems.append(
            "elastic layer: event kind %r is not registered in "
            "obs/taxonomy.CLUSTER_EVENTS" % k)
    for k in sorted(taxonomy.CLUSTER_EVENTS - cevents):
        problems.append(
            "obs/taxonomy.py: CLUSTER_EVENTS lists %r but the "
            "elastic layer never emits it" % k)

    # 3. serve event kinds (the fleet and DAG modules share the serve
    # event log, so their registered vocabularies — FLEET_EVENTS /
    # DAG_EVENTS, pinned both directions by checks 10/12 — are
    # admissible here too)
    serve_srcs = _tree_sources(root, "presto_tpu_torch/serve")
    serve_ok = (taxonomy.SERVE_EVENTS | taxonomy.FLEET_EVENTS
                | taxonomy.DAG_EVENTS | taxonomy.SLO_EVENTS
                | taxonomy.SUPERVISOR_EVENTS
                | taxonomy.CAMPAIGN_EVENTS | taxonomy.FED_EVENTS
                | taxonomy.TRIAGE_EVENTS)
    emitted: Set[str] = set()
    for rel, src in sorted(serve_srcs.items()):
        kinds = set(EMIT_RE.findall(src))
        emitted |= kinds
        for k in sorted(kinds - serve_ok):
            problems.append(
                "%s: event kind %r is not registered in "
                "obs/taxonomy.SERVE_EVENTS, FLEET_EVENTS, "
                "DAG_EVENTS, SLO_EVENTS, SUPERVISOR_EVENTS, "
                "CAMPAIGN_EVENTS, FED_EVENTS, or TRIAGE_EVENTS"
                % (rel, k))

    # 4. every job lifecycle state announces itself (scoped to the
    # JobStatus class body: queue.py also defines the Lanes constants,
    # which are scheduling classes, not lifecycle states)
    queue_src = serve_srcs.get("presto_tpu_torch/serve/queue.py", "")
    m = re.search(r'class JobStatus.*?(?=\nclass |\Z)', queue_src,
                  re.DOTALL)
    states = {v for _name, v in STATUS_RE.findall(m.group(0) if m
                                                  else queue_src)}
    for state in sorted(states):
        kind = taxonomy.JOB_STATE_EVENTS.get(state)
        if kind is None:
            problems.append(
                "serve/queue.py: JobStatus %r has no event mapping "
                "in obs/taxonomy.JOB_STATE_EVENTS (silent scheduler "
                "state transition)" % state)
        elif kind not in emitted:
            problems.append(
                "serve layer: state %r maps to event %r which no "
                "serve module emits" % (state, kind))

    # 5. metric names vs the documented catalog
    for rel, src in sorted(_tree_sources(root, "presto_tpu_torch",
                                         "chip_smoke.py").items()):
        for name in sorted(set(METRIC_RE.findall(src))):
            if name not in taxonomy.METRICS:
                problems.append(
                    "%s: metric %r is not listed in "
                    "obs/taxonomy.METRICS (undocumented metric)"
                    % (rel, name))

    # 6. tune layer: spans both ways + tune_* metric reverse direction
    tune_srcs = _tree_sources(root, "presto_tpu_torch/tune")
    try:
        tune_srcs["presto_tpu_torch/apps/tune.py"] = \
            _read("presto_tpu_torch/apps/tune.py", root)
    except OSError:
        pass
    tspans: Set[str] = set()
    tmetrics: Set[str] = set()
    for rel, src in sorted(tune_srcs.items()):
        spans = set(SPAN_RE.findall(src))
        tspans |= spans
        tmetrics |= set(METRIC_RE.findall(src))
        for s in sorted(spans - taxonomy.TUNE_SPANS):
            problems.append(
                "%s: span %r is not registered in "
                "obs/taxonomy.TUNE_SPANS (uninstrumented tuning "
                "path)" % (rel, s))
    for s in sorted(taxonomy.TUNE_SPANS - tspans):
        problems.append(
            "obs/taxonomy.py: TUNE_SPANS lists %r but the tune layer "
            "never opens it" % s)
    cataloged_tune = {m for m in taxonomy.METRICS
                      if m.startswith("tune_")}
    for name in sorted(cataloged_tune - tmetrics):
        problems.append(
            "obs/taxonomy.py: METRICS lists %r but the tune layer "
            "never registers it" % name)

    # 7. streaming layer: spans + events both ways, stream_* metric
    # reverse direction (forward is check 5)
    stream_srcs = _tree_sources(root, "presto_tpu_torch/stream")
    sspans: Set[str] = set()
    sevents: Set[str] = set()
    smetrics: Set[str] = set()
    for rel, src in sorted(stream_srcs.items()):
        spans = set(SPAN_RE.findall(src))
        sspans |= spans
        sevents |= set(EMIT_RE.findall(src))
        smetrics |= set(METRIC_RE.findall(src))
        for s in sorted(spans - taxonomy.STREAM_SPANS):
            problems.append(
                "%s: span %r is not registered in "
                "obs/taxonomy.STREAM_SPANS (uninstrumented streaming "
                "path)" % (rel, s))
    for s in sorted(taxonomy.STREAM_SPANS - sspans):
        problems.append(
            "obs/taxonomy.py: STREAM_SPANS lists %r but the stream "
            "layer never opens it" % s)
    for k in sorted(sevents - taxonomy.STREAM_EVENTS):
        problems.append(
            "stream layer: event kind %r is not registered in "
            "obs/taxonomy.STREAM_EVENTS" % k)
    for k in sorted(taxonomy.STREAM_EVENTS - sevents):
        problems.append(
            "obs/taxonomy.py: STREAM_EVENTS lists %r but the stream "
            "layer never emits it" % k)
    cataloged_stream = {m for m in taxonomy.METRICS
                        if m.startswith("stream_")}
    for name in sorted(cataloged_stream - smetrics):
        problems.append(
            "obs/taxonomy.py: METRICS lists %r but the stream layer "
            "never registers it" % name)

    # 8. fused pipeline: seam spans both ways, survey_fused_* metric
    # reverse direction (forward is check 5)
    try:
        fusion_src = _read("presto_tpu_torch/pipeline/fusion.py", root)
    except OSError:
        fusion_src = ""
    fspans = {s for s in SPAN_RE.findall(fusion_src)
              if s.startswith("pipeline:")}
    fmetrics = set(METRIC_RE.findall(fusion_src))
    for s in sorted(fspans - taxonomy.FUSION_SPANS):
        problems.append(
            "pipeline/fusion.py: span %r is not registered in "
            "obs/taxonomy.FUSION_SPANS (uninstrumented fused path)"
            % s)
    for s in sorted(taxonomy.FUSION_SPANS - fspans):
        problems.append(
            "obs/taxonomy.py: FUSION_SPANS lists %r but the fusion "
            "layer never opens it" % s)
    cataloged_fused = {m for m in taxonomy.METRICS
                       if m.startswith("survey_fused_")}
    for name in sorted(cataloged_fused - fmetrics):
        problems.append(
            "obs/taxonomy.py: METRICS lists %r but the fusion layer "
            "never registers it" % name)

    # 9. DM-sharded seam: spans/kill points/metrics both directions
    # (the sharded sets must also be subsets of their parent catalogs,
    # so a rename cannot leave a dangling sharded entry)
    for s in sorted(taxonomy.SHARDED_FUSION_SPANS
                    - taxonomy.FUSION_SPANS):
        problems.append(
            "obs/taxonomy.py: SHARDED_FUSION_SPANS lists %r which is "
            "not in FUSION_SPANS" % s)
    for p in sorted(taxonomy.SHARDED_KILL_POINTS
                    - taxonomy.KILL_POINTS):
        problems.append(
            "obs/taxonomy.py: SHARDED_KILL_POINTS lists %r which is "
            "not in KILL_POINTS" % p)
    for name in sorted(taxonomy.SHARDED_FUSION_METRICS
                       - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: SHARDED_FUSION_METRICS lists %r which "
            "is not in METRICS" % name)
    for s in sorted(taxonomy.SHARDED_FUSION_SPANS - fspans):
        problems.append(
            "obs/taxonomy.py: SHARDED_FUSION_SPANS lists %r but the "
            "fusion layer never opens it" % s)
    for s in sorted({x for x in fspans if "shard" in x}
                    - taxonomy.SHARDED_FUSION_SPANS):
        problems.append(
            "pipeline/fusion.py: sharded span %r is not registered "
            "in obs/taxonomy.SHARDED_FUSION_SPANS" % s)
    for p in sorted(taxonomy.SHARDED_KILL_POINTS - points):
        problems.append(
            "obs/taxonomy.py: SHARDED_KILL_POINTS lists %r but "
            "pipeline/survey.py never fires it" % p)
    for p in sorted({x for x in points if "shard" in x}
                    - taxonomy.SHARDED_KILL_POINTS):
        problems.append(
            "pipeline/survey.py: sharded kill point %r is not "
            "registered in obs/taxonomy.SHARDED_KILL_POINTS" % p)
    for name in sorted(taxonomy.SHARDED_FUSION_METRICS - fmetrics):
        problems.append(
            "obs/taxonomy.py: SHARDED_FUSION_METRICS lists %r but "
            "the fusion layer never registers it" % name)
    for name in sorted({x for x in fmetrics
                        if x.startswith("survey_fused_shard_")}
                       - taxonomy.SHARDED_FUSION_METRICS):
        problems.append(
            "pipeline/fusion.py: sharded metric %r is not registered "
            "in obs/taxonomy.SHARDED_FUSION_METRICS" % name)

    # 10. fleet serving (serve/jobledger.py + fleet.py + router.py):
    # FLEET_EVENTS and the fleet_* metrics are pinned BOTH directions
    # — the fleet recovery path (lease, fence, reap, shed, quota) is
    # exactly the code that runs while a replica is dying, so its
    # telemetry may neither go dark nor go stale.  Event kinds count
    # whether emitted literally (events.emit / obs.event) or bound as
    # LeaseLedger EV_* class attributes.
    fleet_files = ("presto_tpu_torch/serve/jobledger.py",
                   "presto_tpu_torch/serve/fleet.py",
                   "presto_tpu_torch/serve/router.py")
    fl_events: Set[str] = set()
    fl_metrics: Set[str] = set()
    for rel in fleet_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        fl_events |= set(EMIT_RE.findall(src))
        fl_events |= set(CLUSTER_EVENT_RE.findall(src))
        fl_events |= set(EVENT_ATTR_RE.findall(src))
        fl_metrics |= set(METRIC_RE.findall(src))
    for k in sorted(taxonomy.FLEET_EVENTS - fl_events):
        problems.append(
            "obs/taxonomy.py: FLEET_EVENTS lists %r but the fleet "
            "layer never emits it" % k)
    for k in sorted(fl_events - taxonomy.FLEET_EVENTS
                    - taxonomy.SERVE_EVENTS - taxonomy.DAG_EVENTS
                    - taxonomy.SLO_EVENTS):
        problems.append(
            "fleet layer: event kind %r is not registered in "
            "obs/taxonomy.FLEET_EVENTS" % k)
    for name in sorted(taxonomy.FLEET_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: FLEET_METRICS lists %r which is not "
            "in METRICS" % name)
    for name in sorted(taxonomy.FLEET_METRICS - fl_metrics):
        problems.append(
            "obs/taxonomy.py: FLEET_METRICS lists %r but the fleet "
            "layer never registers it" % name)
    for name in sorted({x for x in fl_metrics
                        if x.startswith("fleet_")}
                       - taxonomy.FLEET_METRICS):
        problems.append(
            "fleet layer: metric %r is not registered in "
            "obs/taxonomy.FLEET_METRICS" % name)

    # 11. serve-layer spans both directions (the stacked batch
    # executor's cross-job span is the one covering the serving
    # tier's biggest device calls — it may neither go dark nor stay
    # in the catalog after a rename)
    svspans: Set[str] = set()
    for rel, src in sorted(serve_srcs.items()):
        spans = set(SPAN_RE.findall(src))
        svspans |= spans
        for s in sorted(spans - taxonomy.SERVE_SPANS):
            problems.append(
                "%s: span %r is not registered in "
                "obs/taxonomy.SERVE_SPANS (uninstrumented serve "
                "path)" % (rel, s))
    for s in sorted(taxonomy.SERVE_SPANS - svspans):
        problems.append(
            "obs/taxonomy.py: SERVE_SPANS lists %r but the serve "
            "layer never opens it" % s)

    # 12. discovery DAGs (serve/dag.py + jobledger.py + router.py +
    # fleet.py): DAG_EVENTS / DAG_SPANS / DAG_METRICS pinned BOTH
    # directions — the dependency-aware job graph is exactly the code
    # that runs while a mid-graph replica is dying (fenced fan-out,
    # cascade failure), so its telemetry may neither go dark nor go
    # stale; the dag sets must also be subsets of their parent
    # catalogs so a rename cannot leave a dangling entry.
    dag_files = ("presto_tpu_torch/serve/dag.py",
                 "presto_tpu_torch/serve/jobledger.py",
                 "presto_tpu_torch/serve/router.py",
                 "presto_tpu_torch/serve/fleet.py")
    dg_events: Set[str] = set()
    dg_spans: Set[str] = set()
    dg_metrics: Set[str] = set()
    for rel in dag_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        dg_events |= set(EMIT_RE.findall(src))
        dg_events |= set(CLUSTER_EVENT_RE.findall(src))
        dg_spans |= set(SPAN_RE.findall(src))
        dg_metrics |= set(METRIC_RE.findall(src))
    for s in sorted(taxonomy.DAG_SPANS - taxonomy.SERVE_SPANS):
        problems.append(
            "obs/taxonomy.py: DAG_SPANS lists %r which is not in "
            "SERVE_SPANS" % s)
    for name in sorted(taxonomy.DAG_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: DAG_METRICS lists %r which is not in "
            "METRICS" % name)
    for k in sorted(taxonomy.DAG_EVENTS - dg_events):
        problems.append(
            "obs/taxonomy.py: DAG_EVENTS lists %r but the dag layer "
            "never emits it" % k)
    for k in sorted({x for x in dg_events if x.startswith("dag-")}
                    - taxonomy.DAG_EVENTS):
        problems.append(
            "dag layer: event kind %r is not registered in "
            "obs/taxonomy.DAG_EVENTS" % k)
    for s in sorted(taxonomy.DAG_SPANS - dg_spans):
        problems.append(
            "obs/taxonomy.py: DAG_SPANS lists %r but the dag layer "
            "never opens it" % s)
    for s in sorted({x for x in dg_spans
                     if x.startswith("serve:dag")}
                    - taxonomy.DAG_SPANS):
        problems.append(
            "dag layer: span %r is not registered in "
            "obs/taxonomy.DAG_SPANS" % s)
    for name in sorted(taxonomy.DAG_METRICS - dg_metrics):
        problems.append(
            "obs/taxonomy.py: DAG_METRICS lists %r but the dag "
            "layer never registers it" % name)
    for name in sorted({x for x in dg_metrics
                        if x.startswith("dag_")}
                       - taxonomy.DAG_METRICS):
        problems.append(
            "dag layer: metric %r is not registered in "
            "obs/taxonomy.DAG_METRICS" % name)

    # 13. fleet-wide observability (serve/fleet.py + serve/router.py
    # + obs/fleetagg.py): the `fleet:` span prefix, the snapshot/
    # chaos event kinds, and the fleet_obs_*/job_e2e_seconds metrics
    # pinned BOTH directions + subset-of-parent — cross-process trace
    # propagation and the snapshot protocol are the post-mortem's
    # input, so they may neither go dark nor go stale.
    fo_files = ("presto_tpu_torch/serve/fleet.py",
                "presto_tpu_torch/serve/router.py",
                "presto_tpu_torch/obs/fleetagg.py")
    fo_events: Set[str] = set()
    fo_spans: Set[str] = set()
    fo_metrics: Set[str] = set()
    for rel in fo_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        fo_events |= set(EMIT_RE.findall(src))
        fo_events |= set(CLUSTER_EVENT_RE.findall(src))
        fo_spans |= set(SPAN_RE.findall(src))
        fo_metrics |= set(METRIC_RE.findall(src))
    for s in sorted(taxonomy.FLEET_SPANS - taxonomy.SERVE_SPANS):
        problems.append(
            "obs/taxonomy.py: FLEET_SPANS lists %r which is not in "
            "SERVE_SPANS" % s)
    for s in sorted(taxonomy.FLEET_SPANS - fo_spans):
        problems.append(
            "obs/taxonomy.py: FLEET_SPANS lists %r but the fleet "
            "obs layer never opens it" % s)
    for s in sorted({x for x in fo_spans if x.startswith("fleet:")}
                    - taxonomy.FLEET_SPANS):
        problems.append(
            "fleet obs layer: span %r is not registered in "
            "obs/taxonomy.FLEET_SPANS" % s)
    for k in sorted(taxonomy.FLEET_OBS_EVENTS
                    - taxonomy.FLEET_EVENTS):
        problems.append(
            "obs/taxonomy.py: FLEET_OBS_EVENTS lists %r which is "
            "not in FLEET_EVENTS" % k)
    for k in sorted(taxonomy.FLEET_OBS_EVENTS - fo_events):
        problems.append(
            "obs/taxonomy.py: FLEET_OBS_EVENTS lists %r but the "
            "fleet obs layer never emits it" % k)
    for k in sorted({x for x in fo_events
                     if x.startswith("fleet-obs-")
                     or x == "fleet-chaos-point"}
                    - taxonomy.FLEET_OBS_EVENTS):
        problems.append(
            "fleet obs layer: event kind %r is not registered in "
            "obs/taxonomy.FLEET_OBS_EVENTS" % k)
    for name in sorted(taxonomy.FLEET_OBS_METRICS
                       - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: FLEET_OBS_METRICS lists %r which is "
            "not in METRICS" % name)
    for name in sorted(taxonomy.FLEET_OBS_METRICS - fo_metrics):
        problems.append(
            "obs/taxonomy.py: FLEET_OBS_METRICS lists %r but the "
            "fleet obs layer never registers it" % name)
    for name in sorted({x for x in fo_metrics
                        if x.startswith("fleet_obs_")
                        or x == "job_e2e_seconds"}
                       - taxonomy.FLEET_OBS_METRICS):
        problems.append(
            "fleet obs layer: metric %r is not registered in "
            "obs/taxonomy.FLEET_OBS_METRICS" % name)

    # 14. the SLO observatory (obs/slo.py + serve/jobledger.py +
    # serve/router.py): SLO_METRICS / SLO_EVENTS / SLO_SPANS pinned
    # BOTH directions + subset-of-parent — the usage metering at the
    # fence-checked commit and the burn/scale decision signals are
    # the contract future control-plane PRs inherit.
    slo_files = ("presto_tpu_torch/obs/slo.py",
                 "presto_tpu_torch/serve/jobledger.py",
                 "presto_tpu_torch/serve/router.py")
    sl_events: Set[str] = set()
    sl_spans: Set[str] = set()
    sl_metrics: Set[str] = set()
    for rel in slo_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        sl_events |= set(EMIT_RE.findall(src))
        sl_events |= set(CLUSTER_EVENT_RE.findall(src))
        sl_spans |= set(SPAN_RE.findall(src))
        sl_metrics |= set(METRIC_RE.findall(src))
    for s in sorted(taxonomy.SLO_SPANS - taxonomy.SERVE_SPANS):
        problems.append(
            "obs/taxonomy.py: SLO_SPANS lists %r which is not in "
            "SERVE_SPANS" % s)
    for s in sorted(taxonomy.SLO_SPANS - sl_spans):
        problems.append(
            "obs/taxonomy.py: SLO_SPANS lists %r but the slo layer "
            "never opens it" % s)
    for s in sorted({x for x in sl_spans if x.startswith("slo:")}
                    - taxonomy.SLO_SPANS):
        problems.append(
            "slo layer: span %r is not registered in "
            "obs/taxonomy.SLO_SPANS" % s)
    for k in sorted(taxonomy.SLO_EVENTS - sl_events):
        problems.append(
            "obs/taxonomy.py: SLO_EVENTS lists %r but the slo layer "
            "never emits it" % k)
    for k in sorted({x for x in sl_events if x.startswith("slo-")}
                    - taxonomy.SLO_EVENTS):
        problems.append(
            "slo layer: event kind %r is not registered in "
            "obs/taxonomy.SLO_EVENTS" % k)
    for name in sorted(taxonomy.SLO_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: SLO_METRICS lists %r which is not in "
            "METRICS" % name)
    for name in sorted(taxonomy.SLO_METRICS - sl_metrics):
        problems.append(
            "obs/taxonomy.py: SLO_METRICS lists %r but the slo "
            "layer never registers it" % name)
    for name in sorted({x for x in sl_metrics
                        if x.startswith("slo_")}
                       - taxonomy.SLO_METRICS):
        problems.append(
            "slo layer: metric %r is not registered in "
            "obs/taxonomy.SLO_METRICS" % name)

    # 15. the kernel observatory (obs/costmodel.py + obs/roofline.py
    # ): COST_SPANS / COST_METRICS pinned BOTH directions
    # (and as a subset of METRICS) — the per-kind FLOP/byte dispatch
    # join is the measurement rig every remaining perf item is judged
    # by, so it may neither go dark nor go stale.  The `obs:` span
    # prefix scopes the check.
    cost_files = ("presto_tpu_torch/obs/costmodel.py",
                  "presto_tpu_torch/obs/roofline.py")
    co_spans: Set[str] = set()
    co_metrics: Set[str] = set()
    for rel in cost_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        co_spans |= set(SPAN_RE.findall(src))
        co_metrics |= set(METRIC_RE.findall(src))
    for name in sorted(taxonomy.COST_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: COST_METRICS lists %r which is not in "
            "METRICS" % name)
    for s in sorted(taxonomy.COST_SPANS
                    - {x for x in co_spans if x.startswith("obs:")}):
        problems.append(
            "obs/taxonomy.py: COST_SPANS lists %r but the cost layer "
            "never opens it" % s)
    for s in sorted({x for x in co_spans if x.startswith("obs:")}
                    - taxonomy.COST_SPANS):
        problems.append(
            "cost layer: span %r is not registered in "
            "obs/taxonomy.COST_SPANS" % s)
    for name in sorted(taxonomy.COST_METRICS - co_metrics):
        problems.append(
            "obs/taxonomy.py: COST_METRICS lists %r but the cost "
            "layer never registers it" % name)
    for name in sorted({x for x in co_metrics
                        if x.startswith("kernel_")
                        or x.startswith("cost_model_")}
                       - taxonomy.COST_METRICS):
        problems.append(
            "cost layer: metric %r is not registered in "
            "obs/taxonomy.COST_METRICS" % name)

    # 16. the fleet supervisor (serve/supervisor.py + serve/router.py
    # + serve/jobledger.py): SUPERVISOR_EVENTS / SUPERVISOR_SPANS /
    # SUPERVISOR_METRICS pinned BOTH directions (and as subsets of
    # their parent catalogs) — every spawn/drain/hold decision must be
    # reconstructable from telemetry alone, so the actuation loop's
    # vocabulary may neither go dark nor go stale.
    sup_files = ("presto_tpu_torch/serve/supervisor.py",
                 "presto_tpu_torch/serve/router.py",
                 "presto_tpu_torch/serve/jobledger.py")
    su_events: Set[str] = set()
    su_spans: Set[str] = set()
    su_metrics: Set[str] = set()
    for rel in sup_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        su_events |= set(EMIT_RE.findall(src))
        su_events |= set(CLUSTER_EVENT_RE.findall(src))
        su_spans |= set(SPAN_RE.findall(src))
        su_metrics |= set(METRIC_RE.findall(src))
    for s in sorted(taxonomy.SUPERVISOR_SPANS - taxonomy.SERVE_SPANS):
        problems.append(
            "obs/taxonomy.py: SUPERVISOR_SPANS lists %r which is not "
            "in SERVE_SPANS" % s)
    for s in sorted(taxonomy.SUPERVISOR_SPANS - su_spans):
        problems.append(
            "obs/taxonomy.py: SUPERVISOR_SPANS lists %r but the "
            "supervisor layer never opens it" % s)
    for s in sorted({x for x in su_spans
                     if x.startswith("supervisor:")}
                    - taxonomy.SUPERVISOR_SPANS):
        problems.append(
            "supervisor layer: span %r is not registered in "
            "obs/taxonomy.SUPERVISOR_SPANS" % s)
    for k in sorted(taxonomy.SUPERVISOR_EVENTS - su_events):
        problems.append(
            "obs/taxonomy.py: SUPERVISOR_EVENTS lists %r but the "
            "supervisor layer never emits it" % k)
    for k in sorted({x for x in su_events
                     if x.startswith("supervisor-")}
                    - taxonomy.SUPERVISOR_EVENTS):
        problems.append(
            "supervisor layer: event kind %r is not registered in "
            "obs/taxonomy.SUPERVISOR_EVENTS" % k)
    for name in sorted(taxonomy.SUPERVISOR_METRICS
                       - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: SUPERVISOR_METRICS lists %r which is "
            "not in METRICS" % name)
    for name in sorted(taxonomy.SUPERVISOR_METRICS - su_metrics):
        problems.append(
            "obs/taxonomy.py: SUPERVISOR_METRICS lists %r but the "
            "supervisor layer never registers it" % name)
    for name in sorted({x for x in su_metrics
                        if x.startswith("supervisor_")}
                       - taxonomy.SUPERVISOR_METRICS):
        problems.append(
            "supervisor layer: metric %r is not registered in "
            "obs/taxonomy.SUPERVISOR_METRICS" % name)

    # 17. the campaign engine (serve/campaign.py + serve/router.py +
    # serve/supervisor.py): CAMPAIGN_EVENTS / CAMPAIGN_SPANS /
    # CAMPAIGN_METRICS pinned BOTH directions (and as subsets of
    # their parent catalogs) — a whole archive campaign (every wave,
    # settle, yield change, and preemption) must be reconstructable
    # from campaign_events.jsonl + spans + metrics alone, so the
    # vocabulary may neither go dark nor go stale.  The supervisor's
    # preempt pacer deliberately speaks campaign-prefixed telemetry
    # (it actuates the campaign's preemption mode), hence the
    # cross-file gather.
    camp_files = ("presto_tpu_torch/serve/campaign.py",
                  "presto_tpu_torch/serve/router.py",
                  "presto_tpu_torch/serve/supervisor.py")
    ca_events: Set[str] = set()
    ca_spans: Set[str] = set()
    ca_metrics: Set[str] = set()
    for rel in camp_files:
        try:
            src = _read(rel, root)
        except OSError:
            continue
        ca_events |= set(EMIT_RE.findall(src))
        ca_events |= set(CLUSTER_EVENT_RE.findall(src))
        ca_spans |= set(SPAN_RE.findall(src))
        ca_metrics |= set(METRIC_RE.findall(src))
    for s in sorted(taxonomy.CAMPAIGN_SPANS - taxonomy.SERVE_SPANS):
        problems.append(
            "obs/taxonomy.py: CAMPAIGN_SPANS lists %r which is not "
            "in SERVE_SPANS" % s)
    for s in sorted(taxonomy.CAMPAIGN_SPANS - ca_spans):
        problems.append(
            "obs/taxonomy.py: CAMPAIGN_SPANS lists %r but the "
            "campaign layer never opens it" % s)
    for s in sorted({x for x in ca_spans
                     if x.startswith("campaign:")}
                    - taxonomy.CAMPAIGN_SPANS):
        problems.append(
            "campaign layer: span %r is not registered in "
            "obs/taxonomy.CAMPAIGN_SPANS" % s)
    for k in sorted(taxonomy.CAMPAIGN_EVENTS - ca_events):
        problems.append(
            "obs/taxonomy.py: CAMPAIGN_EVENTS lists %r but the "
            "campaign layer never emits it" % k)
    for k in sorted({x for x in ca_events
                     if x.startswith("campaign-")}
                    - taxonomy.CAMPAIGN_EVENTS):
        problems.append(
            "campaign layer: event kind %r is not registered in "
            "obs/taxonomy.CAMPAIGN_EVENTS" % k)
    for name in sorted(taxonomy.CAMPAIGN_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: CAMPAIGN_METRICS lists %r which is "
            "not in METRICS" % name)
    for name in sorted(taxonomy.CAMPAIGN_METRICS - ca_metrics):
        problems.append(
            "obs/taxonomy.py: CAMPAIGN_METRICS lists %r but the "
            "campaign layer never registers it" % name)
    for name in sorted({x for x in ca_metrics
                        if x.startswith("campaign_")}
                       - taxonomy.CAMPAIGN_METRICS):
        problems.append(
            "campaign layer: metric %r is not registered in "
            "obs/taxonomy.CAMPAIGN_METRICS" % name)

    # 18. the beam multiplexer (stream/beams.py): BEAM_EVENTS /
    # BEAM_SPANS / BEAM_METRICS pinned BOTH directions (and as subsets
    # of their parent catalogs), plus the three-way kill-point pin
    # (taxonomy == beams.BEAM_KILL_POINTS == testing/chaos re-export).
    # The hand-off audit trail — which replica leased which beam, what
    # it committed, why a write was fenced — must be reconstructable
    # from events + metrics alone, so the vocabulary may neither go
    # dark nor go stale.  The beam ledger declares its event kinds as
    # EV_* class attributes (the leaseledger idiom, cf. check 2b),
    # which count as emitted.
    try:
        beams_src = _read("presto_tpu_torch/stream/beams.py", root)
    except OSError:
        beams_src = ""
    b_events = set(EMIT_RE.findall(beams_src))
    b_events |= set(EVENT_ATTR_RE.findall(beams_src))
    b_events = {k for k in b_events if k.startswith("beam-")}
    b_spans = set(SPAN_RE.findall(beams_src))
    b_metrics = {m for m in METRIC_RE.findall(beams_src)
                 if m.startswith("stream_beam")}
    b_points = set(POINT_RE.findall(beams_src))
    for k in sorted(taxonomy.BEAM_EVENTS - b_events):
        problems.append(
            "obs/taxonomy.py: BEAM_EVENTS lists %r but stream/beams.py "
            "never emits it" % k)
    for k in sorted(b_events - taxonomy.BEAM_EVENTS):
        problems.append(
            "stream/beams.py: event kind %r is not registered in "
            "obs/taxonomy.BEAM_EVENTS" % k)
    for s in sorted(taxonomy.BEAM_SPANS - taxonomy.STREAM_SPANS):
        problems.append(
            "obs/taxonomy.py: BEAM_SPANS lists %r which is not in "
            "STREAM_SPANS" % s)
    for s in sorted(taxonomy.BEAM_SPANS - b_spans):
        problems.append(
            "obs/taxonomy.py: BEAM_SPANS lists %r but stream/beams.py "
            "never opens it" % s)
    for s in sorted({x for x in b_spans if "beam" in x}
                    - taxonomy.BEAM_SPANS):
        problems.append(
            "stream/beams.py: span %r is not registered in "
            "obs/taxonomy.BEAM_SPANS" % s)
    for name in sorted(taxonomy.BEAM_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: BEAM_METRICS lists %r which is not in "
            "METRICS" % name)
    for name in sorted(taxonomy.BEAM_METRICS - b_metrics):
        problems.append(
            "obs/taxonomy.py: BEAM_METRICS lists %r but "
            "stream/beams.py never registers it" % name)
    for name in sorted(b_metrics - taxonomy.BEAM_METRICS):
        problems.append(
            "stream/beams.py: metric %r is not registered in "
            "obs/taxonomy.BEAM_METRICS" % name)
    for p in sorted(b_points - taxonomy.BEAM_KILL_POINTS):
        problems.append(
            "stream/beams.py: kill point %r is not registered in "
            "obs/taxonomy.BEAM_KILL_POINTS" % p)
    for p in sorted(taxonomy.BEAM_KILL_POINTS - b_points):
        problems.append(
            "obs/taxonomy.py: BEAM_KILL_POINTS lists %r but "
            "stream/beams.py never fires it" % p)
    try:
        from presto_tpu_torch.stream import beams as _beams_mod
        from presto_tpu_torch.testing import chaos as _chaos_mod
        if set(_beams_mod.BEAM_KILL_POINTS) != taxonomy.BEAM_KILL_POINTS:
            problems.append(
                "stream/beams.py: BEAM_KILL_POINTS disagrees with "
                "obs/taxonomy.BEAM_KILL_POINTS")
        if set(_chaos_mod.BEAM_KILL_POINTS) != taxonomy.BEAM_KILL_POINTS:
            problems.append(
                "testing/chaos.py: BEAM_KILL_POINTS disagrees with "
                "obs/taxonomy.BEAM_KILL_POINTS")
    except Exception as e:  # pragma: no cover - import failure is a lint
        problems.append(
            "beam kill-point pin: could not import the runtime copies "
            "(%s)" % e)

    # 19. the federation front door (serve/federation.py):
    # FED_EVENTS / FED_SPANS / FED_METRICS pinned BOTH directions (and
    # as subsets of their parent catalogs), plus the three-way
    # kill-point pin (taxonomy == federation.FED_KILL_POINTS ==
    # testing/chaos re-export).  Whole-fleet failover runs exactly
    # while a site is dying: which fleet held which placement, why a
    # job spilled, when the epoch fenced a zombie commit — all of it
    # must be reconstructable from fed_events.jsonl + spans + metrics
    # alone.  The federation ledger declares its event kinds as EV_*
    # class attributes (the leaseledger idiom, cf. checks 2b/10/18),
    # which count as emitted.
    try:
        fed_src = _read("presto_tpu_torch/serve/federation.py", root)
    except OSError:
        fed_src = ""
    fd_events = set(EMIT_RE.findall(fed_src))
    fd_events |= set(EVENT_ATTR_RE.findall(fed_src))
    fd_events = {k for k in fd_events if k.startswith("fed-")}
    fd_spans = {s for s in SPAN_RE.findall(fed_src)
                if s.startswith("fed:")}
    fd_metrics = {m for m in METRIC_RE.findall(fed_src)
                  if m.startswith("fed_")}
    fd_points = set(POINT_RE.findall(fed_src))
    for k in sorted(taxonomy.FED_EVENTS - fd_events):
        problems.append(
            "obs/taxonomy.py: FED_EVENTS lists %r but "
            "serve/federation.py never emits it" % k)
    for k in sorted(fd_events - taxonomy.FED_EVENTS):
        problems.append(
            "serve/federation.py: event kind %r is not registered "
            "in obs/taxonomy.FED_EVENTS" % k)
    for s in sorted(taxonomy.FED_SPANS - taxonomy.SERVE_SPANS):
        problems.append(
            "obs/taxonomy.py: FED_SPANS lists %r which is not in "
            "SERVE_SPANS" % s)
    for s in sorted(taxonomy.FED_SPANS - fd_spans):
        problems.append(
            "obs/taxonomy.py: FED_SPANS lists %r but "
            "serve/federation.py never opens it" % s)
    for s in sorted(fd_spans - taxonomy.FED_SPANS):
        problems.append(
            "serve/federation.py: span %r is not registered in "
            "obs/taxonomy.FED_SPANS" % s)
    for name in sorted(taxonomy.FED_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: FED_METRICS lists %r which is not in "
            "METRICS" % name)
    for name in sorted(taxonomy.FED_METRICS - fd_metrics):
        problems.append(
            "obs/taxonomy.py: FED_METRICS lists %r but "
            "serve/federation.py never registers it" % name)
    for name in sorted(fd_metrics - taxonomy.FED_METRICS):
        problems.append(
            "serve/federation.py: metric %r is not registered in "
            "obs/taxonomy.FED_METRICS" % name)
    for p in sorted(fd_points - taxonomy.FED_KILL_POINTS):
        problems.append(
            "serve/federation.py: kill point %r is not registered "
            "in obs/taxonomy.FED_KILL_POINTS" % p)
    for p in sorted(taxonomy.FED_KILL_POINTS - fd_points):
        problems.append(
            "obs/taxonomy.py: FED_KILL_POINTS lists %r but "
            "serve/federation.py never fires it" % p)
    try:
        from presto_tpu_torch.serve import federation as _fed_mod
        from presto_tpu_torch.testing import chaos as _fchaos_mod
        if set(_fed_mod.FED_KILL_POINTS) != taxonomy.FED_KILL_POINTS:
            problems.append(
                "serve/federation.py: FED_KILL_POINTS disagrees "
                "with obs/taxonomy.FED_KILL_POINTS")
        if set(_fchaos_mod.FED_KILL_POINTS) \
                != taxonomy.FED_KILL_POINTS:
            problems.append(
                "testing/chaos.py: FED_KILL_POINTS disagrees with "
                "obs/taxonomy.FED_KILL_POINTS")
    except Exception as e:  # pragma: no cover - import failure is a lint
        problems.append(
            "fed kill-point pin: could not import the runtime copies "
            "(%s)" % e)

    # 20. learned candidate triage (triage/ + the
    # serve/dag.py triage node + apps/triage.py): TRIAGE_EVENTS /
    # TRIAGE_SPANS / TRIAGE_METRICS pinned BOTH directions (and as
    # subsets of their parent catalogs).  Triage decides which
    # candidates are NEVER folded — a silent selection path would be
    # indistinguishable from a lost pulsar, so the learned selection
    # ("triage-score"), the heuristic degrade ("triage-fallback",
    # the poisoned-model row of ROBUSTNESS.md), and each calibration
    # run ("triage-calibrate") may neither go dark nor go stale.
    tr_srcs = dict(_tree_sources(root, "presto_tpu_torch/triage"))
    for rel in ("presto_tpu_torch/serve/dag.py",
                "presto_tpu_torch/apps/triage.py"):
        try:
            tr_srcs[rel] = _read(rel, root)
        except OSError:
            pass
    tr_events: Set[str] = set()
    tr_spans: Set[str] = set()
    tr_metrics: Set[str] = set()
    for src in tr_srcs.values():
        tr_events |= {k for k in EMIT_RE.findall(src)
                      if k.startswith("triage-")}
        tr_spans |= {s for s in SPAN_RE.findall(src)
                     if s.startswith("serve:triage")}
        tr_metrics |= {m for m in METRIC_RE.findall(src)
                       if m.startswith("triage_")}
    for k in sorted(taxonomy.TRIAGE_EVENTS - tr_events):
        problems.append(
            "obs/taxonomy.py: TRIAGE_EVENTS lists %r but the triage "
            "layer never emits it" % k)
    for k in sorted(tr_events - taxonomy.TRIAGE_EVENTS):
        problems.append(
            "triage layer: event kind %r is not registered in "
            "obs/taxonomy.TRIAGE_EVENTS" % k)
    for s in sorted(taxonomy.TRIAGE_SPANS - taxonomy.SERVE_SPANS):
        problems.append(
            "obs/taxonomy.py: TRIAGE_SPANS lists %r which is not in "
            "SERVE_SPANS" % s)
    for s in sorted(taxonomy.TRIAGE_SPANS - tr_spans):
        problems.append(
            "obs/taxonomy.py: TRIAGE_SPANS lists %r but the triage "
            "layer never opens it" % s)
    for s in sorted(tr_spans - taxonomy.TRIAGE_SPANS):
        problems.append(
            "triage layer: span %r is not registered in "
            "obs/taxonomy.TRIAGE_SPANS" % s)
    for name in sorted(taxonomy.TRIAGE_METRICS - taxonomy.METRICS):
        problems.append(
            "obs/taxonomy.py: TRIAGE_METRICS lists %r which is not "
            "in METRICS" % name)
    for name in sorted(taxonomy.TRIAGE_METRICS - tr_metrics):
        problems.append(
            "obs/taxonomy.py: TRIAGE_METRICS lists %r but the triage "
            "layer never registers it" % name)
    for name in sorted(tr_metrics - taxonomy.TRIAGE_METRICS):
        problems.append(
            "triage layer: metric %r is not registered in "
            "obs/taxonomy.TRIAGE_METRICS" % name)
    return problems


_PATH_RE = re.compile(r"^((?:[\w./-]+)\.py): ")


@register("obs-coverage")
def check(tree: Tree) -> List[Finding]:
    """The coverage checks as a presto-lint family.  Runs only over a
    real on-disk repo (the contract needs obs/taxonomy.py importable);
    in-memory fixture trees skip it."""
    taxpath = os.path.join(tree.root, "presto_tpu_torch", "obs",
                           "taxonomy.py")
    if not os.path.exists(taxpath):
        return []
    out: List[Finding] = []
    for problem in lint(tree.root):
        m = _PATH_RE.match(problem)
        path = "presto_tpu_torch/obs/taxonomy.py"
        if m:
            cand = m.group(1)
            if cand in tree.files:
                path = cand
            elif "presto_tpu_torch/" + cand in tree.files:
                path = "presto_tpu_torch/" + cand
        out.append(Finding("obs-coverage", path, 0, problem))
    return out


def main(argv=None) -> int:
    """The coverage checks alone: exit 1 on any problem that the
    presto-lint baseline (lint/baseline.json) does not grandfather."""
    from presto_tpu_torch.lint import BASELINE
    from presto_tpu_torch.lint.core import load_baseline
    known = {e.get("context") for e in load_baseline(BASELINE)
             if e.get("check") == "obs-coverage"}
    problems = lint()
    live = [p for p in problems if p not in known]
    if live:
        print("obs_lint: %d instrumentation-coverage violation(s):"
              % len(live))
        for p in live:
            print("  - %s" % p)
        return 1
    print("obs_lint: instrumentation coverage OK "
          "(stages, kill points, serve events, job states, metrics); "
          "%d grandfathered" % (len(problems) - len(live)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
