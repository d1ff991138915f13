"""presto-campaign: drive an archive-scale reprocessing campaign.

Host copy of ``presto_tpu/apps/campaign.py`` for the PyTorch port
(``python3 -m presto_tpu_torch.apps.campaign``); it runs no device
work.

A campaign is a manifest of observations — each the `POST /dag` wire
schema (rawfiles + config + sift/fold/toa policies) — admitted to a
fleet as discovery DAGs in bounded waves, with its own durable
ledger under `<fleet>/campaigns/<id>/` (serve/campaign.py).  The
driver process is crash-only: kill it at any instant and rerun the
same command line with `-resume`; everything resumes from the ledger
with nothing lost and nothing admitted twice.

  # create from a manifest and drive to completion
  presto-campaign -fleet /scratch/fleet -id palfa-2026 \\
                  -manifest observations.json -wave-size 8

  # a crashed/preempted driver picks up where the ledger says
  presto-campaign -fleet /scratch/fleet -id palfa-2026 -resume

  # one pulse (cron-style driving), or just look
  presto-campaign -fleet /scratch/fleet -id palfa-2026 -once
  presto-campaign -fleet /scratch/fleet -id palfa-2026 -status

The manifest file is either a JSON list of observation specs, a JSON
object with a "manifest" key (the `POST /campaign` body), or JSONL
with one spec per line.  Each spec may carry an "id" — observation
ids key idempotent re-admission, so stable ids make re-created
campaigns byte-identical.

Exit status: 0 done clean, 2 done with failed observations, 3 still
running (timeout expired).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_manifest(path: str):
    """JSON list / {"manifest": [...]} object / JSONL -> list."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = [json.loads(line) for line in text.splitlines()
               if line.strip()]
    if isinstance(doc, dict):
        doc = doc.get("manifest")
    if not isinstance(doc, list) or not doc:
        raise ValueError(
            "%s: manifest must be a non-empty JSON list of "
            "observation specs (or JSONL, or {\"manifest\": [...]})"
            % path)
    return doc


def build_parser():
    p = argparse.ArgumentParser(
        prog="presto-campaign",
        description="Drive one archive-reprocessing campaign over a "
                    "fleet directory: bounded waves of discovery "
                    "DAGs, durable ledger, crash-only resume.")
    p.add_argument("-fleet", type=str, required=True,
                   help="Shared fleet directory (the job ledger)")
    p.add_argument("-id", type=str, required=True,
                   help="Campaign id (its ledger lives at "
                        "<fleet>/campaigns/<id>/campaign.json)")
    p.add_argument("-manifest", type=str, default=None,
                   help="Observation manifest file (JSON list, "
                        "JSONL, or a {\"manifest\": [...]} object); "
                        "omit with -resume/-status/-once on an "
                        "existing campaign")
    p.add_argument("-wave-size", type=int, default=4,
                   help="Max discovery DAGs outstanding at once — "
                        "jobs.json stays bounded at any archive size")
    p.add_argument("-tenant", type=str, default="campaign",
                   help="Backfill-lane tenant name")
    p.add_argument("-weight", type=float, default=0.1,
                   help="Configured WRR weight of the backfill lane "
                        "(the live weight additionally shrinks with "
                        "interactive burn)")
    p.add_argument("-priority", type=int, default=50,
                   help="Job priority for campaign DAG nodes "
                        "(higher = later than interactive work)")
    p.add_argument("-floor", type=float, default=0.05,
                   help="Yield floor: the backfill lane never drops "
                        "below this fraction of its weight")
    p.add_argument("-resume", action="store_true",
                   help="Resume an existing campaign (no manifest "
                        "needed; creation is idempotent anyway, so "
                        "this only asserts the ledger exists)")
    p.add_argument("-status", action="store_true",
                   help="Print the status + projection JSON and exit")
    p.add_argument("-once", action="store_true",
                   help="One pulse (settle + admit + yield) and exit")
    p.add_argument("-poll", type=float, default=0.5,
                   help="Seconds between pulses")
    p.add_argument("-timeout", type=float, default=None,
                   help="Give up (exit 3) after this many seconds "
                        "with the campaign still running")
    return p


def _progress_line(st: dict) -> str:
    c = st["counts"]
    proj = st.get("projection") or {}
    eta = proj.get("eta_s")
    total = proj.get("projected_total_device_seconds")
    return ("presto-campaign: %s wave %d  done=%d failed=%d "
            "out=%d pending=%d  yield=%.2f  eta=%s  cost=%s"
            % (st["campaign_id"], st["waves"], c["done"],
               c["failed"], st["outstanding"], c["pending"],
               st["yield"],
               "%.0fs" % eta if eta is not None else "?",
               "%.1f dev-s" % total if total is not None else "?"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.serve.campaign import (CampaignConfig,
                                                 CampaignDriver,
                                                 load_campaign)
    cfg = CampaignConfig(fleetdir=args.fleet, campaign_id=args.id,
                         wave_size=args.wave_size,
                         tenant=args.tenant, weight=args.weight,
                         priority=args.priority,
                         yield_floor=args.floor)
    if (args.manifest is None
            and load_campaign(args.fleet, args.id) is None):
        print("presto-campaign: campaign %r has no ledger under %s "
              "— pass -manifest to create it" % (args.id, args.fleet),
              file=sys.stderr)
        return 1
    drv = CampaignDriver(cfg)
    try:
        if args.status:
            print(json.dumps(drv.status(), indent=1, sort_keys=True))
            return 0
        if args.manifest is not None:
            drv.create(_load_manifest(args.manifest))
        else:
            drv.resume()
        deadline = (None if args.timeout is None
                    else time.time() + args.timeout)
        while True:
            st = drv.pulse()
            print(_progress_line(st))
            if args.once or st["state"] != "running":
                break
            if deadline is not None and time.time() > deadline:
                print("presto-campaign: timeout with campaign still "
                      "running (resume with the same command line)")
                return 3
            time.sleep(args.poll)
        if st["state"] != "running":
            c = st["counts"]
            print("presto-campaign: %s %s — %d done, %d failed, "
                  "%d wave(s)"
                  % (st["campaign_id"], st["state"], c["done"],
                     c["failed"], st["waves"]))
            return 2 if c["failed"] else 0
        return 3 if not args.once else 0
    finally:
        drv.close()


if __name__ == "__main__":
    sys.exit(main())
