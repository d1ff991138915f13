"""The observability name catalog of the PyTorch port.

Host copy of ``presto_tpu_torch/obs/taxonomy.py``: every survey stage, chaos
kill point, serve/fleet/SLO/supervisor/campaign/federation/triage/
stream/beam event kind, span name and metric name the port emits is
listed here.  The port's presto-lint family ``obs-coverage``
(presto_tpu_torch/lint/obscoverage.py, the checks the comments below
name) holds the port's source to this catalog in both directions; the
tier-1 test ``tests/test_torch_taxonomy.py`` holds the literal names in
serve/, stream/, obs/ and pipeline/survey.py and the kill-point tuples
of testing/chaos, stream/beams and serve/federation to it, and the
catalog to the JAX package's up to :data:`PORT_CHANGES`.

The catalog starts as a copy of the JAX package's.  Where the port's
names differ, the sets below carry the port's names and
:data:`PORT_CHANGES` lists every difference in one place.  The port's
device telemetry (obs/devtel.py) keeps the JAX package's ``jax_*``
metric names; :data:`DEVICE_METRICS` lists them with the CUDA kernel
launch counter a fleet replica books at each snapshot.
"""

from __future__ import annotations

#: survey stages — every `timer.mark("<stage>")` in pipeline/survey.py
#: (each becomes a `survey_stage_seconds{stage=...}` sample and a span)
SURVEY_STAGES = frozenset({
    "rfifind",
    "ddplan",
    "prepsubband",
    "realfft",
    "zapbirds",
    "accelsearch",
    "realfft+accelsearch (fused)",
    "sift",
    "prepfold",
    "single_pulse",
})

#: chaos kill points — every `_chaos(cfg, "<point>")` in
#: pipeline/survey.py (each is recorded in the flight recorder before
#: the injector may fire, so a dump's last record names the kill)
KILL_POINTS = frozenset({
    "pre-rfifind",
    "post-rfifind",
    "pre-prepsubband",
    "prepsubband-method",
    "elastic-method",
    "post-prepsubband",
    "seam-handoff",
    "shard-seam-handoff",
    "sp-seam-chunk",
    "zapbirds-file",
    "fft-chunk",
    "fused-chunk",
    "sharded-fused-chunk",
    "accel-chunk",
    "pre-sift",
    "post-sift",
    "fold-cand",
    "pre-singlepulse",
    "post-survey",
})

#: elastic-cluster kill points — every `self._point("<point>")` in
#: parallel/elastic.py (the multi-host analog of KILL_POINTS: each is
#: flight-recorded before the injector may fire, and
#: a chaos harness kills/stalls real cluster members at them)
CLUSTER_KILL_POINTS = frozenset({
    "shard-leased",
    "shard-computed",
    "pre-shard-commit",
    "post-shard-commit",
    "post-epoch-bump",
})

#: elastic-cluster event kinds — every `obs.event(...)` /
#: `self._event(...)` in parallel/elastic.py and
#: pipeline/shardledger.py (the flight-recorder vocabulary of a
#: worker-loss recovery: lease grants, redo admissions, epoch bumps,
#: fenced zombie writes, membership changes)
CLUSTER_EVENTS = frozenset({
    "chaos-point",
    "cluster-join",
    "host-dead",
    "epoch-bump",
    "mesh-reform",
    "barrier-timeout",
    "shard-lease",
    "shard-done",
    "shard-redo",
    "stale-write-rejected",
})

#: serve event kinds — every `events.emit("<kind>", ...)` in
#: presto_tpu_torch/serve/*.py ("heartbeat" is emitted by the EventLog's own
#: heartbeat thread so /events subscribers can tell a quiet service
#: from a dead one)
SERVE_EVENTS = frozenset({
    "enqueue",
    "schedule",
    "execute",
    "retry",
    "degrade",
    "complete",
    "fail",
    "park",
    "compile",
    "evict",
    "plan-evict",
    "scheduler-error",
    "http",
    "heartbeat",
})

#: fleet-serving event kinds — the multi-replica vocabulary of
#: serve/jobledger.py (ledger lease/commit/fence flight-recorder
#: events, via the generic LeaseLedger EV_* bindings), serve/fleet.py
#: (replica lifecycle on the service event log), and serve/router.py
#: (admission-control rejections).  Enforced BOTH directions by
#: obs_lint check 10: the fleet recovery path may not emit
#: unregistered kinds, and the catalog may not list dead ones.
FLEET_EVENTS = frozenset({
    "job-lease",
    "job-done",
    "job-redo",
    "job-failed",
    "stale-result-rejected",
    "replica-dead",
    "fleet-epoch-bump",
    "quota-exceeded",
    "shed",
    "fleet-join",
    "fleet-drain",
    "fleet-tombstone",
    "fleet-pump-error",
    "router-poll-error",
    "fleet-idle-tune",
    "fleet-obs-snapshot",
    "fleet-chaos-point",
})

#: fleet-observability event kinds (subset of FLEET_EVENTS; obs_lint
#: check 13 pins them BOTH directions against serve/fleet.py +
#: serve/router.py + obs/fleetagg.py): the snapshot publication that
#: feeds `GET /fleet/metrics`, and the recorded-BEFORE-fire chaos
#: stamp that guarantees a killed replica's flight-recorder dump
#: names its kill point (batch-leased / fold-fanout included)
FLEET_OBS_EVENTS = frozenset({
    "fleet-obs-snapshot",
    "fleet-chaos-point",
})

#: fleet-observability span names — the router's admission-time root
#: spans whose SpanContext is stamped into the ledger row so the
#: leasing replica resumes the SAME trace (subset of SERVE_SPANS;
#: obs_lint check 13, both directions, `fleet:` prefix pinned)
FLEET_SPANS = frozenset({
    "fleet:submit",
    "fleet:dag-submit",
})

#: fleet-observability metrics (obs_lint check 13, both directions):
#: every `fleet_obs_*` name plus the end-to-end job decomposition
#: histogram the control-plane item consumes
FLEET_OBS_METRICS = frozenset({
    "fleet_obs_snapshots_total",
    "fleet_obs_aggregations_total",
    "job_e2e_seconds",
})

#: SLO-observatory event kinds — the decision-signal vocabulary of
#: the serving-economics layer (obs/slo.py evaluation surfaced by
#: serve/router.py): a multi-window burn-rate alert's rising edge,
#: and every change of the advisory wanted-replica count — the event
#: stream a supervisor (or a chaos harness in reverse) replays
#: decisions from.  Enforced BOTH directions by obs_lint check 14.
SLO_EVENTS = frozenset({
    "slo-burn-alert",
    "slo-scale-advice",
})

#: SLO-observatory span names (subset of SERVE_SPANS; check 14 both
#: directions): the router's per-pass evaluation over the durable
#: usage ledger
SLO_SPANS = frozenset({
    "slo:evaluate",
})

#: SLO-observatory metrics (obs_lint check 14, both directions,
#: subset of METRICS): device-seconds metering at the fence-checked
#: commit (serve/jobledger.py) and the router's budget/burn/scale
#: gauges — the signals the remaining control-plane actuation
#: (autoscaler, device-seconds admission) will consume
SLO_METRICS = frozenset({
    "slo_device_seconds_total",
    "slo_error_budget_remaining",
    "slo_burn_rate",
    "slo_burn_alerts_total",
    "slo_wanted_replicas",
})

#: fleet-supervisor event kinds — the actuation vocabulary of
#: serve/supervisor.py (the control loop that closes the /scale
#: advisory: spawn/drain/hold decisions with the advisory inputs
#: that drove them, replica lifecycle transitions, dead-replica
#: replacement, and crash-recovery adoption).  Every decision lands
#: on the durable `<fleet>/supervisor_events.jsonl` stream so a
#: whole scaling episode replays from telemetry alone.  Enforced
#: BOTH directions by obs-coverage check 16 across supervisor.py +
#: router.py + jobledger.py.
SUPERVISOR_EVENTS = frozenset({
    "supervisor-start",
    "supervisor-stop",
    "supervisor-adopt",
    "supervisor-spawn",
    "supervisor-spawn-failed",
    "supervisor-up",
    "supervisor-drain",
    "supervisor-drained",
    "supervisor-drain-timeout",
    "supervisor-replace",
    "supervisor-hold",
    "supervisor-step-error",
})

#: fleet-supervisor span names (check 16, both directions): one span
#: per gated decision plus one per actuation, so a scaling episode's
#: trace mirrors its event stream
SUPERVISOR_SPANS = frozenset({
    "supervisor:decide",
    "supervisor:spawn",
    "supervisor:drain",
    "supervisor:replace",
})

#: fleet-supervisor metrics (check 16, both directions, subset of
#: METRICS): the supervised-fleet gauge and the actuation counters —
#: holds included, because withheld actuations are the hysteresis
#: doing its job and must be observable
SUPERVISOR_METRICS = frozenset({
    "supervisor_replicas",
    "supervisor_spawns_total",
    "supervisor_drains_total",
    "supervisor_replacements_total",
    "supervisor_holds_total",
})

#: campaign-engine event kinds — the archive-reprocessing vocabulary
#: of serve/campaign.py (bounded-wave admission, fence-checked
#: settling, backfill-yield throttle decisions) plus the
#: supervisor's paced preemption of campaign-leased replicas
#: (serve/supervisor.py).  Every decision lands on the durable
#: per-campaign `campaign_events.jsonl` stream so a whole campaign —
#: including every preemption and every yield change — replays from
#: telemetry alone.  Enforced BOTH directions by obs-coverage check
#: 17 across campaign.py + router.py + supervisor.py.
CAMPAIGN_EVENTS = frozenset({
    "campaign-create",
    "campaign-resume",
    "campaign-wave-admit",
    "campaign-obs-done",
    "campaign-obs-failed",
    "campaign-yield",
    "campaign-preempt",
    "campaign-complete",
})

#: campaign-engine span names (check 17, both directions, subset of
#: SERVE_SPANS): creation, the driver pulse, each idempotent DAG
#: admission, and each supervisor preemption
CAMPAIGN_SPANS = frozenset({
    "campaign:create",
    "campaign:pulse",
    "campaign:admit",
    "campaign:preempt",
})

#: campaign-engine metrics (check 17, both directions, subset of
#: METRICS): wave/admission/settle counters, the outstanding-DAG
#: bound, the live backfill-yield factor, and the supervisor's
#: preemption pacer
CAMPAIGN_METRICS = frozenset({
    "campaign_waves_total",
    "campaign_admitted_total",
    "campaign_settled_total",
    "campaign_outstanding",
    "campaign_yield_factor",
    "campaign_preemptions_total",
})

#: federation event kinds — the many-fleets-behind-one-front-door
#: vocabulary of serve/federation.py: fleet membership and liveness
#: (the `LeaseLedger` core re-bound a third time, after DM shards and
#: beams — now the *hosts* are whole fleets), priced placement,
#: saturation spill-over, and the whole-fleet failover protocol
#: (dead-fleet detection, re-admission of its uncommitted work on
#: survivors, and the epoch fence that rejects a zombie fleet's late
#: commit).  Enforced BOTH directions by obs-coverage check 19
#: against serve/federation.py — the cross-site recovery path may
#: neither go dark nor go stale.
FED_EVENTS = frozenset({
    "fed-fleet-join",
    "fed-admit",
    "fed-place",
    "fed-commit",
    "fed-readmit",
    "fed-stale-commit",
    "fed-fleet-dead",
    "fed-epoch-bump",
    "fed-spill",
    "fed-push-error",
    "fed-probe-error",
    "fed-chaos-point",
})

#: federation span names (check 19, both directions, subset of
#: SERVE_SPANS): the front door's admission spans, each priced
#: placement decision, and each whole-fleet failover pass
FED_SPANS = frozenset({
    "fed:submit",
    "fed:dag-submit",
    "fed:place",
    "fed:failover",
})

#: federation metrics (check 19, both directions, subset of METRICS):
#: the liveness gauge pair plus admission/spill/failover counters —
#: the one-level-up mirror of the fleet_* recovery counters
FED_METRICS = frozenset({
    "fed_fleets_alive",
    "fed_epoch",
    "fed_submissions_total",
    "fed_spills_total",
    "fed_readmits_total",
    "fed_stale_commits_total",
    "fed_commits_total",
})

#: federation chaos kill points — the seams serve/federation.py fires
#: through its FaultInjector hook (`self._point(...)`); the runtime
#: copy is serve/federation.FED_KILL_POINTS (re-exported by
#: testing/chaos.py) and check 19 pins all three copies to each other
FED_KILL_POINTS = frozenset({
    "fleet-dead",
    "pre-readmit",
    "post-readmit",
    "zombie-fleet-commit",
})

#: learned-triage event kinds — the score-then-fold vocabulary of
#: presto_tpu_torch/triage + the serve/dag.py triage node: a learned
#: selection ("triage-score"), the heuristic degrade when the weights
#: file is missing/corrupt/stale ("triage-fallback" — the poisoned-
#: model row), and each calibration run
#: ("triage-calibrate").  Enforced BOTH directions by obs-coverage
#: check 20 across presto_tpu_torch/triage/ + serve/dag.py: the selection
#: path that decides which candidates are never folded may neither go
#: dark nor go stale.
TRIAGE_EVENTS = frozenset({
    "triage-score",
    "triage-fallback",
    "triage-calibrate",
})

#: learned-triage span names (check 20, both directions, subset of
#: SERVE_SPANS): the DAG triage node's score+fan-out transaction
TRIAGE_SPANS = frozenset({
    "serve:triage-node",
})

#: learned-triage metrics (check 20, both directions, subset of
#: METRICS): scored/avoided counters plus the recall gauge fed by
#: injection ground-truth sidecars when traffic carries them
TRIAGE_METRICS = frozenset({
    "triage_candidates_scored_total",
    "triage_folds_avoided_total",
    "triage_recall",
})

#: streaming-layer event kinds — every `events.emit("<kind>", ...)`
#: in presto_tpu_torch/stream/ (enforced both directions by obs_lint check
#: 7: the live trigger path may not emit unregistered kinds, and the
#: catalog may not list dead ones)
STREAM_EVENTS = frozenset({
    "stream-start",
    "stream-eof",
    "stream-drop",
    "stream-quarantine",
    "trigger",
    "stream-fail",
    "beam-start",
    "beam-stall",
    "beam-drop",
    "beam-veto",
    "beam-eof",
    "beam-handoff",
})

#: beam-multiplexer event kinds (stream/beams.py): the assembler's
#: per-beam lifecycle plus the beam ledger's EV_* flight-recorder
#: kinds (lease/fence transitions for beam hand-off across replicas).
#: The emit-style kinds are a subset of STREAM_EVENTS (check 7 covers
#: the stream tree); check 18 pins the full set — including the EV_*
#: attributes check 7's EMIT_RE cannot see — both directions against
#: stream/beams.py, so the hand-off audit trail may neither go dark
#: nor go stale.
BEAM_EVENTS = frozenset({
    "beam-start",
    "beam-stall",
    "beam-drop",
    "beam-veto",
    "beam-eof",
    "beam-handoff",
    "beam-lease",
    "beam-done",
    "beam-redo",
    "beam-stale-write",
    "beam-replica-dead",
    "beam-epoch-bump",
})

#: streaming-layer span names — every `obs.span("stream:...")` in
#: presto_tpu_torch/stream/ (both directions, like TUNE_SPANS)
STREAM_SPANS = frozenset({
    "stream:block",
    "stream:dedisp",
    "stream:search",
    "stream:beam-tick",
})

#: beam-multiplexer span names (subset of STREAM_SPANS; check 18 pins
#: the subset relation and both directions against stream/beams.py)
BEAM_SPANS = frozenset({
    "stream:beam-tick",
})

#: beam-multiplexer metric names (subset of METRICS; check 18 pins
#: both directions against stream/beams.py): the live-beam gauge and
#: the per-beam QoS/veto/hand-off counters
BEAM_METRICS = frozenset({
    "stream_beams",
    "stream_beam_stalled_total",
    "stream_beam_dropped_total",
    "stream_beam_vetoed_total",
    "stream_beam_handoffs_total",
})

#: beam-multiplexer chaos kill points — the seams stream/beams.py
#: fires through its FaultInjector hook (`self._point(...)`); the
#: runtime copy is stream/beams.BEAM_KILL_POINTS (re-exported by
#: testing/chaos.py) and check 18 pins all three copies to each other
BEAM_KILL_POINTS = frozenset({
    "beam-tick",
    "beam-commit",
    "beam-handoff",
})

#: serve-layer span names — every `obs.span("...")` in
#: presto_tpu_torch/serve/ (enforced both directions by obs_lint check 11:
#: the scheduler's per-job execution span and the stacked batch
#: executor's cross-job span may neither go dark nor go stale)
SERVE_SPANS = frozenset({
    "serve-job",
    "serve:stacked-batch",
    "serve:dag-node",
    "fleet:submit",
    "fleet:dag-submit",
    "slo:evaluate",
    "supervisor:decide",
    "supervisor:spawn",
    "supervisor:drain",
    "supervisor:replace",
    "campaign:create",
    "campaign:pulse",
    "campaign:admit",
    "campaign:preempt",
    "fed:submit",
    "fed:dag-submit",
    "fed:place",
    "fed:failover",
    "serve:triage-node",
})

#: discovery-DAG event kinds — the dependency-aware job-graph
#: vocabulary of serve/dag.py + serve/jobledger.py (graph admission,
#: the sift node's fenced fan-out transaction, cascade failure of a
#: failed parent's subtree).  Enforced BOTH directions by obs_lint
#: check 12: the DAG recovery path (the code that runs while a
#: mid-graph replica dies) may neither go dark nor go stale.
DAG_EVENTS = frozenset({
    "dag-submit",
    "dag-expand",
    "dag-cascade-fail",
})

#: discovery-DAG span names (subset of SERVE_SPANS; check 12 pins the
#: subset relation and both directions against serve/dag.py)
DAG_SPANS = frozenset({
    "serve:dag-node",
})

#: discovery-DAG metrics — every `dag_*` name must be registered by
#: the DAG layer (serve/dag.py, serve/jobledger.py, serve/router.py)
#: and vice versa (obs_lint check 12, both directions)
DAG_METRICS = frozenset({
    "dag_submitted_total",
    "dag_fanout_jobs_total",
    "dag_cascade_failures_total",
    "dag_nodes_done_total",
    "dag_folds_stacked_total",
})

#: kernel-observatory span names — the cost-probe / roofline
#: microbench span opened by obs/costmodel.py + obs/roofline.py
#: (enforced both directions by obs-coverage check 15: every
#: `obs:`-prefixed span in the cost layer is registered, and the
#: catalog may not list dead ones)
COST_SPANS = frozenset({
    "obs:roofline-probe",
})

#: kernel-observatory metrics (obs-coverage check 15, both
#: directions, subset of METRICS): the per-kind FLOP/byte dispatch
#: join and the degradation counter — the measurement rig every
#: remaining perf item is judged by, so it may neither go dark nor go stale
COST_METRICS = frozenset({
    "kernel_flops_total",
    "kernel_hbm_bytes_total",
    "cost_model_unavailable",
})

#: job lifecycle states -> the event kind that announces the
#: transition into that state.  The linter checks each mapped kind is
#: actually emitted somewhere in the serve layer.
JOB_STATE_EVENTS = {
    "queued": "enqueue",
    "scheduled": "schedule",
    "running": "execute",
    "retry-wait": "retry",
    "parked": "park",
    "done": "complete",
    "failed": "fail",
    "timeout": "fail",
}

#: tuning-layer span names — every `obs.span("tune:...")` in
#: presto_tpu_torch/tune/ + apps/tune.py (the linter enforces both
#: directions, like the kill points)
TUNE_SPANS = frozenset({
    "tune:family",
    "tune:sweep",
    "tune:candidate",
})

#: fused-pipeline span names — every `obs.span("pipeline:...")` in
#: pipeline/fusion.py (enforced both directions by obs_lint check 8:
#: the in-memory data path may not open unregistered spans, and the
#: catalog may not list dead ones)
FUSION_SPANS = frozenset({
    "pipeline:seam",
    "pipeline:shard-seam",
})

#: the DM-sharded subset of the fused-pipeline vocabulary (obs_lint
#: check 9 pins all three sets BOTH directions: the sharded seam is
#: the one data path that holds an entire survey's fan-out across
#: devices with nothing durable on disk until spill, so its spans,
#: kill points, and metrics may neither go dark nor go stale)
SHARDED_FUSION_SPANS = frozenset({
    "pipeline:shard-seam",
})

SHARDED_KILL_POINTS = frozenset({
    "shard-seam-handoff",
    "sharded-fused-chunk",
})

SHARDED_FUSION_METRICS = frozenset({
    "survey_fused_shard_trials_total",
    "survey_fused_shard_gather_bytes_total",
})

#: fleet-serving metrics — every `fleet_*` name must be registered by
#: the fleet modules (serve/jobledger.py, serve/fleet.py,
#: serve/router.py) and vice versa (obs_lint check 10, both
#: directions, the same pinning discipline as the sharded seam: a
#: replica-loss recovery path may neither go dark nor go stale)
FLEET_METRICS = frozenset({
    "fleet_jobs_leased_total",
    "fleet_jobs_committed_total",
    "fleet_jobs_redone_total",
    "fleet_jobs_failed_total",
    "fleet_stale_results_total",
    "fleet_inflight",
    "fleet_epoch",
    "fleet_submissions_total",
    "fleet_shed_total",
    "fleet_quota_rejections_total",
    "fleet_depth",
    "fleet_replicas_ready",
    "fleet_batch_leases_total",
    "fleet_idle_tune_total",
    "fleet_obs_snapshots_total",
    "fleet_obs_aggregations_total",
})

#: the port's device metrics: obs/devtel.py's dispatch, build,
#: transfer and live-buffer telemetry under the JAX package's jax_*
#: names (a build is an nvcc run or a searcher plan's construction), and
#: the hand-written kernels' launches a fleet replica books at each
#: snapshot (serve/fleet.py, cuda_kernel_launches_total{kernel})
DEVICE_METRICS = frozenset({
    "cuda_kernel_launches_total",
    "jax_compiles_total",
    "jax_compile_seconds",
    "jax_dispatches_total",
    "jax_device_put_bytes_total",
    "jax_device_get_bytes_total",
    "jax_donated_bytes_total",
    "jax_live_buffer_bytes",
    "jax_live_buffer_hwm_bytes",
})

#: the survey's root span (pipeline/survey.py opens it around a run; the
#: JAX package opens it too and does not list it)
SURVEY_SPANS = frozenset({
    "survey",
})

#: fleet replica kill points (serve/fleet.FleetReplica fires them when
#: its ``kill_on`` names one; the runtime copy is
#: testing/chaos.FLEET_KILL_POINTS)
FLEET_KILL_POINTS = frozenset({
    "job-leased",
    "batch-leased",
    "job-enqueued",
    "mid-fold",
    "mid-triage",
    "fold-fanout",
    "post-sift-commit",
})

#: registered metric names (Prometheus side of the contract); the
#: linter checks every registry.counter/gauge/histogram call in the
#: tree registers a name listed here.
METRICS = frozenset({
    # serve scheduler / queue
    "serve_jobs_done_total",
    "serve_jobs_failed_total",
    "serve_job_retries_total",
    "serve_batches_total",
    "serve_batched_jobs_total",
    "serve_batch_degrades_total",
    "serve_device_errors_total",
    "serve_retry_waiting",
    "serve_queue_depth",
    "serve_queue_capacity",
    "serve_uptime_seconds",
    "serve_jobs",
    "serve_jobs_parked_total",
    # stacked cross-job batch executor (serve/batchexec.py)
    "serve_stacked_batches_total",
    "serve_stacked_jobs_total",
    "serve_batch_occupancy",
    # plan cache (incl. the persistent tier, serve/plancache.PlanStore)
    "plancache_hits_total",
    "plancache_misses_total",
    "plancache_evictions_total",
    "plancache_size",
    "plancache_warm_fraction",
    "plancache_prewarmed_total",
    "plancache_store_plans",
    # latency / stage timing
    "latency_seconds",
    "survey_stage_seconds",
    # ingest quality
    "ingest_scrubbed_samples_total",
    "ingest_quarantined_spectra_total",
    "ingest_reports_total",
    # device telemetry (obs/devtel.py keeps the jax_* names) and the
    # replica's CUDA kernel launch counter; DEVICE_METRICS lists them
    "cuda_kernel_launches_total",
    "jax_compiles_total",
    "jax_compile_seconds",
    "jax_dispatches_total",
    "jax_device_put_bytes_total",
    "jax_device_get_bytes_total",
    "jax_donated_bytes_total",
    "jax_live_buffer_bytes",
    "jax_live_buffer_hwm_bytes",
    # kernel observatory (obs/costmodel.py + obs/roofline.py +
    # bench.py); pinned both directions by obs-coverage check 15 via
    # COST_METRICS
    "kernel_flops_total",
    "kernel_hbm_bytes_total",
    "cost_model_unavailable",
    # flight recorder
    "flightrec_dumps_total",
    # elastic cluster (parallel/elastic.py)
    "cluster_epoch",
    "cluster_alive_hosts",
    "cluster_shards_done_total",
    "cluster_shard_redos_total",
    "cluster_epoch_bumps_total",
    "cluster_barrier_timeouts_total",
    "cluster_stale_writes_total",
    "cluster_heartbeats_total",
    # kernel autotuning (presto_tpu_torch/tune); every tune_* name here must
    # be registered by the tune layer (obs_lint check 6)
    "tune_db_hits_total",
    "tune_db_misses_total",
    "tune_db_load_errors_total",
    "tune_db_entries",
    "tune_candidates_total",
    "tune_candidates_pruned_total",
    "tune_candidates_quarantined_total",
    "tune_sweep_seconds",
    # scheduler lanes (serve/scheduler.py)
    "serve_lane_batches_total",
    # device-resident pipeline fusion (pipeline/fusion.py); every
    # survey_fused_* name here must be registered by the fusion layer
    # (obs_lint check 8)
    "survey_fused_trials_total",
    "survey_fused_bytes_spilled_total",
    # DM-sharded seam (pipeline/fusion.ShardedSeamBlock); pinned both
    # directions by obs_lint check 9 via SHARDED_FUSION_METRICS
    "survey_fused_shard_trials_total",
    "survey_fused_shard_gather_bytes_total",
    # fleet serving (serve/fleet.py + jobledger.py + router.py);
    # pinned both directions by obs_lint check 10 via FLEET_METRICS
    "fleet_jobs_leased_total",
    "fleet_jobs_committed_total",
    "fleet_jobs_redone_total",
    "fleet_jobs_failed_total",
    "fleet_stale_results_total",
    "fleet_inflight",
    "fleet_epoch",
    "fleet_submissions_total",
    "fleet_shed_total",
    "fleet_quota_rejections_total",
    "fleet_depth",
    "fleet_replicas_ready",
    "fleet_batch_leases_total",
    "fleet_idle_tune_total",
    # fleet-wide observability (serve/fleet.py snapshot publisher,
    # serve/router.py aggregation endpoint, the admit->lease-wait->
    # execute->commit decomposition); pinned both directions by
    # obs_lint check 13 via FLEET_OBS_METRICS
    "fleet_obs_snapshots_total",
    "fleet_obs_aggregations_total",
    "job_e2e_seconds",
    # SLO observatory (serve/jobledger.py usage metering +
    # serve/router.py budget/burn/scale signals); pinned both
    # directions by obs_lint check 14 via SLO_METRICS
    "slo_device_seconds_total",
    "slo_error_budget_remaining",
    "slo_burn_rate",
    "slo_burn_alerts_total",
    "slo_wanted_replicas",
    # fleet supervisor (serve/supervisor.py actuation loop); pinned
    # both directions by obs-coverage check 16 via SUPERVISOR_METRICS
    "supervisor_replicas",
    "supervisor_spawns_total",
    "supervisor_drains_total",
    "supervisor_replacements_total",
    "supervisor_holds_total",
    # campaign engine (serve/campaign.py driver + the supervisor's
    # preempt-fraction pacer); pinned both directions by obs-coverage
    # check 17 via CAMPAIGN_METRICS
    "campaign_waves_total",
    "campaign_admitted_total",
    "campaign_settled_total",
    "campaign_outstanding",
    "campaign_yield_factor",
    "campaign_preemptions_total",
    # federation front door (serve/federation.py); pinned both
    # directions by obs-coverage check 19 via FED_METRICS
    "fed_fleets_alive",
    "fed_epoch",
    "fed_submissions_total",
    "fed_spills_total",
    "fed_readmits_total",
    "fed_stale_commits_total",
    "fed_commits_total",
    # streaming search (presto_tpu_torch/stream); every stream_* name here
    # must be registered by the stream layer (obs_lint check 7)
    "stream_blocks_total",
    "stream_candidates_total",
    "stream_triggers_total",
    "stream_drops_total",
    "stream_gap_spectra_total",
    "stream_backlog_blocks",
    "stream_latency_seconds",
    # beam multiplexer (stream/beams.py); pinned both directions by
    # obs_lint check 18 via BEAM_METRICS
    "stream_beams",
    "stream_beam_stalled_total",
    "stream_beam_dropped_total",
    "stream_beam_vetoed_total",
    "stream_beam_handoffs_total",
    # discovery DAGs (serve/dag.py + jobledger.py + router.py);
    # pinned both directions by obs_lint check 12 via DAG_METRICS
    "dag_submitted_total",
    "dag_fanout_jobs_total",
    "dag_cascade_failures_total",
    "dag_nodes_done_total",
    "dag_folds_stacked_total",
    # learned candidate triage (presto_tpu_torch/triage + the serve/dag.py
    # triage node); pinned both directions by obs-coverage check 20
    # via TRIAGE_METRICS
    "triage_candidates_scored_total",
    "triage_folds_avoided_total",
    "triage_recall",
})

#: every difference from the JAX package's catalog, in one place:
#: {set name: {"added": names, "removed": names}}; a set the JAX
#: catalog lacks is all "added"
PORT_CHANGES = {
    "STREAM_EVENTS": {
        "added": ("stream-fail",),  # a tick that raised ends the stream
        "removed": ()},
    "METRICS": {
        "added": ("cuda_kernel_launches_total",),
        "removed": ()},
    "DEVICE_METRICS": {
        "added": tuple(sorted(DEVICE_METRICS)),
        "removed": ()},
    "SURVEY_SPANS": {
        "added": ("survey",),
        "removed": ()},
    "FLEET_KILL_POINTS": {
        "added": tuple(sorted(FLEET_KILL_POINTS)),
        "removed": ()},
}
