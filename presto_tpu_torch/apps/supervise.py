"""presto-supervise: the fleet's scaling actuator.

Host copy of ``presto_tpu/apps/supervise.py`` for the PyTorch port.
Closes the control loop the SLO observatory opened: polls the router's
advisory `GET /scale` and spawns / drains the port's replica processes
(``python -m presto_tpu_torch.apps.serve -device DEVICE``) against one
shared fleet directory, with hysteresis and a cooldown so advisory
flapping never thrashes the fleet.

  python -m presto_tpu_torch.serve.router -fleetdir /scratch/fleet \
      -port 8786 &
  python -m presto_tpu_torch.apps.supervise -fleet /scratch/fleet \
      -router http://127.0.0.1:8786 -max 8

``-device`` (default cuda) is the replicas' device; the supervisor
itself runs no device work, and refuses a cuda fleet on a machine
without a card (pass ``-device cpu`` to supervise CPU replicas).

SIGTERM stops *supervising* but leaves the replicas running: the
fleet degrades to the advisory-only behavior, and a restarted
supervisor adopts every registered replica from the persisted
`<fleet>/supervisor.json` instead of leaking or duplicating it.
Pass `-teardown` to drain the whole supervised fleet on exit
instead.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def build_parser():
    p = argparse.ArgumentParser(prog="presto-supervise")
    p.add_argument("-fleet", type=str, required=True,
                   help="Shared fleet directory (the job ledger)")
    p.add_argument("-router", type=str, required=True,
                   help="Router base URL (the /scale advisory "
                        "source), e.g. http://127.0.0.1:8786")
    p.add_argument("-poll", type=float, default=1.0,
                   help="Advisory poll cadence, seconds")
    p.add_argument("-scale-up-after", type=int, default=2,
                   help="Consecutive polls wanting MORE replicas "
                        "before spawning (hysteresis)")
    p.add_argument("-scale-down-after", type=int, default=4,
                   help="Consecutive polls wanting FEWER replicas "
                        "before draining (hysteresis)")
    p.add_argument("-cooldown", type=float, default=5.0,
                   help="Minimum seconds between scaling actuations")
    p.add_argument("-min", type=int, default=1,
                   help="Never drain below this many replicas")
    p.add_argument("-max", type=int, default=8,
                   help="Never spawn above this many replicas")
    p.add_argument("-drain-timeout", type=float, default=30.0,
                   help="Seconds a draining replica gets to finish "
                        "in-flight work before SIGKILL escalation")
    p.add_argument("-spawn-timeout", type=float, default=60.0,
                   help="Seconds a spawned replica gets to land its "
                        "first ledger heartbeat")
    p.add_argument("-hb-timeout", type=float, default=10.0,
                   help="Ledger-heartbeat staleness that marks a "
                        "live replica process wedged (replaced)")
    p.add_argument("-workdir", type=str, default="",
                   help="Root for spawned replicas' workdirs "
                        "(default <fleet>/supervised)")
    p.add_argument("-replica-prefix", type=str, default="sup")
    p.add_argument("-replica-arg", action="append", default=[],
                   help="Extra presto-serve argv token appended to "
                        "every spawn (repeatable)")
    p.add_argument("-preempt-fraction", type=float, default=0.0,
                   help="Spot capacity as steady state: every "
                        "-preempt-interval seconds, SIGKILL-and-"
                        "replace this fraction of the replicas "
                        "holding campaign-tenant leases (at least "
                        "one while any does); 0 disables")
    p.add_argument("-preempt-interval", type=float, default=10.0,
                   help="Seconds between preempt-fraction rounds")
    p.add_argument("-preempt-tenant", type=str, default="campaign",
                   help="The backfill tenant whose lease-holders "
                        "are preemptable")
    p.add_argument("-device", type=str, default="cuda",
                   help="Device of every spawned replica (cuda, "
                        "cuda:N, or cpu)")
    p.add_argument("-teardown", action="store_true",
                   help="Drain the whole supervised fleet on exit "
                        "(default: leave replicas running for the "
                        "next supervisor to adopt)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.serve.supervisor import (FleetSupervisor,
                                                   SupervisorConfig,
                                                   check_replica_device)
    check_replica_device(args.device)
    cfg = SupervisorConfig(
        fleetdir=args.fleet,
        router_url=args.router,
        poll_s=args.poll,
        scale_up_after=args.scale_up_after,
        scale_down_after=args.scale_down_after,
        cooldown_s=args.cooldown,
        min_replicas=args.min,
        max_replicas=args.max,
        drain_timeout_s=args.drain_timeout,
        spawn_timeout_s=args.spawn_timeout,
        heartbeat_timeout=args.hb_timeout,
        workdir=args.workdir,
        replica_prefix=args.replica_prefix,
        replica_args=list(args.replica_arg),
        preempt_fraction=args.preempt_fraction,
        preempt_interval_s=args.preempt_interval,
        preempt_tenant=args.preempt_tenant,
        device=args.device)
    sup = FleetSupervisor(cfg).start()
    print("presto-supervise: fleet %s <- %s/scale "
          "(replicas %d..%d, up after %d, down after %d, "
          "cooldown %gs)"
          % (args.fleet, args.router.rstrip("/"), args.min,
             args.max, args.scale_up_after, args.scale_down_after,
             args.cooldown))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        last = None
        while not stop.wait(args.poll):
            d = sup.last_decision
            if d and d.get("action") != "steady" and d != last:
                print("presto-supervise: %s wanted=%s current=%s %s"
                      % (d["action"], d.get("wanted"),
                         d.get("current"),
                         d.get("why") or d.get("advice_reason")
                         or ""))
                last = d
        print("presto-supervise: SIGTERM — stopping "
              "(%s replicas)" % ("draining" if args.teardown
                                 else "leaving"))
    except KeyboardInterrupt:
        print("presto-supervise: shutting down")
    finally:
        sup.stop()
        if args.teardown:
            sup.drain_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
