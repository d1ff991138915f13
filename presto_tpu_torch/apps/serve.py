"""presto-serve: the always-on, continuously-batching search service.

PyTorch counterpart of ``presto_tpu/apps/serve.py``: the port's
SearchService (serve/server.py) as a long-lived HTTP process on
``-device`` (default "cuda"; without a card it raises).  Submit search
jobs (observation + SurveyConfig spec), poll status/results, scrape
/metrics; with ``-fleet DIR`` the process is a fleet replica
(serve/fleet.py) leasing survey and discovery-DAG node jobs from the
fleet's job ledger, with the plan store under ``DIR/planstore``.

  python3 -m presto_tpu_torch.apps.serve -port 8787 -workdir serve_work
  python3 -m presto_tpu_torch.apps.serve -fleet fleetdir -replica r1
  curl -XPOST :8787/submit -d '{"rawfiles": ["beam.fil"],
                                "config": {"lodm": 0, "hidm": 100}}'
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="presto-serve")
    p.add_argument("-host", type=str, default="127.0.0.1")
    p.add_argument("-port", type=int, default=8787)
    p.add_argument("-device", type=str, default="cuda",
                   help="Device the jobs run on (cuda, cuda:N, or cpu)")
    p.add_argument("-workdir", type=str, default="serve_work",
                   help="Root directory; each job runs in "
                        "<workdir>/<job_id>")
    p.add_argument("-depth", type=int, default=64,
                   help="Queue depth bound (backpressure above this)")
    p.add_argument("-maxbatch", type=int, default=8,
                   help="Max same-bucket jobs coalesced per batch")
    p.add_argument("-no-stacked", action="store_true",
                   help="Disable the stacked cross-job batch "
                        "executor (coalesced batches then run the "
                        "per-job loop)")
    p.add_argument("-timeout", type=float, default=0.0,
                   help="Per-job wall-clock budget in seconds "
                        "(0 = unlimited)")
    p.add_argument("-retries", type=int, default=2,
                   help="Retries per job after the first attempt")
    p.add_argument("-backoff", type=float, default=2.0,
                   help="Retry backoff base in seconds (doubles per "
                        "attempt)")
    p.add_argument("-plans", type=int, default=32,
                   help="Plan cache capacity (LRU)")
    p.add_argument("-events", type=str, default=None,
                   help="Append structured JSON events to this file")
    p.add_argument("-heartbeat", type=float, default=0.0,
                   help="Emit a heartbeat event on /events every this "
                        "many seconds (0 = off) so subscribers can "
                        "tell a quiet service from a dead one")
    p.add_argument("-tracedir", type=str, default=None,
                   help="Export spans here (spans.jsonl + Perfetto "
                        "trace.perfetto.json); metrics/flight "
                        "recorder are always on for the service")
    # fleet membership
    p.add_argument("-fleet", type=str, default=None,
                   help="Join the fleet whose job ledger lives in "
                        "this shared directory: lease jobs from it "
                        "instead of only serving local /submit")
    p.add_argument("-replica", type=str, default=None,
                   help="Fleet replica name (default <host>-<pid>)")
    p.add_argument("-lease-ttl", type=float, default=30.0,
                   help="Job lease TTL in seconds")
    p.add_argument("-hb-interval", type=float, default=1.0,
                   help="Fleet heartbeat interval in seconds")
    p.add_argument("-hb-timeout", type=float, default=10.0,
                   help="Heartbeat TTL before a replica is reaped")
    p.add_argument("-inflight", type=int, default=2,
                   help="Leased jobs held concurrently")
    p.add_argument("-lease-batch", type=int, default=4,
                   help="Same-bucket jobs leased per ledger "
                        "transaction (stacked into one device call; "
                        "1 = classic single leasing)")
    p.add_argument("-snapshot-interval", type=float, default=2.0,
                   help="Fleet-observability snapshot cadence in "
                        "seconds: publish this replica's metrics "
                        "state into <fleet>/obs/ for the router's "
                        "GET /fleet/metrics aggregation (0 = off)")
    p.add_argument("-tune-in-idle", action="store_true",
                   help="Run bounded tuning slices when the fleet "
                        "ledger is empty (merge-saved into "
                        "<fleet>/tune.json)")
    p.add_argument("-idle-tune-budget", type=float, default=20.0,
                   help="Wall-clock budget per idle tuning slice, "
                        "seconds")
    p.add_argument("-planstore", type=str, default=None,
                   help="Persistent plan store root (default "
                        "<fleet>/planstore when -fleet is set)")
    p.add_argument("-no-prewarm", action="store_true",
                   help="Skip the plan-cache warm-up before leasing")
    return p


def main(argv=None) -> int:
    import os
    import signal
    import threading
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.obs import ObsConfig
    from presto_tpu_torch.search.accel import resolve_device
    from presto_tpu_torch.serve.scheduler import SchedulerConfig
    from presto_tpu_torch.serve.server import SearchService, start_http
    device = resolve_device(args.device)
    scfg = SchedulerConfig(
        max_batch=args.maxbatch,
        job_timeout_s=args.timeout or None,
        max_retries=args.retries,
        backoff_base_s=args.backoff)
    plan_store_dir = args.planstore
    if plan_store_dir is None and args.fleet:
        plan_store_dir = os.path.join(args.fleet, "planstore")
    service = SearchService(args.workdir, queue_depth=args.depth,
                            plan_capacity=args.plans,
                            scheduler_cfg=scfg,
                            events_path=args.events,
                            heartbeat_s=args.heartbeat,
                            plan_store_dir=plan_store_dir,
                            stacked=(False if args.no_stacked
                                     else None),
                            obs_config=ObsConfig(
                                enabled=True,
                                trace_dir=args.tracedir,
                                service="presto-serve"),
                            device=device)
    service.start()
    httpd = start_http(service, args.host, args.port)
    host, port = httpd.server_address[:2]
    if args.fleet:
        from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
        fcfg = FleetConfig(fleetdir=args.fleet,
                           replica=args.replica or "",
                           lease_ttl=args.lease_ttl,
                           heartbeat_s=args.hb_interval,
                           heartbeat_timeout=args.hb_timeout,
                           max_inflight=args.inflight,
                           prewarm=not args.no_prewarm,
                           lease_batch=args.lease_batch,
                           tune_in_idle=args.tune_in_idle,
                           idle_tune_budget_s=args.idle_tune_budget,
                           snapshot_s=args.snapshot_interval)
        replica = FleetReplica(
            service, fcfg,
            addr="http://%s:%d" % (host, port)).start()
        print("presto-serve: fleet replica %r leasing from %s on %s"
              % (replica.replica, args.fleet, device), flush=True)
    print("presto-serve: listening on http://%s:%d "
          "(POST /submit, GET /jobs/<id>, /healthz, /readyz, "
          "/metrics)" % (host, port), flush=True)

    # graceful shutdown: SIGTERM drains in-flight jobs, releases the
    # fleet leases, and writes a heartbeat tombstone so the reaper
    # re-admits immediately instead of waiting out the TTL
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(1.0):
            pass
        print("presto-serve: SIGTERM — draining", flush=True)
    except KeyboardInterrupt:
        print("presto-serve: shutting down", flush=True)
    finally:
        httpd.shutdown()
        report = service.shutdown(drain=True)
        print("presto-serve: shutdown %s" % report, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
