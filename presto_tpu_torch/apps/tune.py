"""presto-tune: offline kernel-autotuning sweeps for this card.

Host copy of ``presto_tpu/apps/tune.py`` for the PyTorch port.
Measures the port's tunable families (presto_tpu_torch/tune/space.py)
on ``-device`` (default cuda) and records the best config per (card
fingerprint, family, shape key) into the persistent tuning database —
the same DB ``tune.configure(enabled=True)`` / ``SurveyConfig.tune``
runs consult.

    presto-tune                           sweep every family
    presto-tune --families accel_column_slab,plancache_bucket
    presto-tune --budget 60               stop starting sweeps after 60 s
    presto-tune --smoke                   small spaces
    presto-tune --smoke -device cpu       small spaces, plain versions
    presto-tune --device-report           fingerprint + DB contents
    presto-tune --list                    family catalog
    presto-tune --db /path/tune.json      explicit DB location

(``python -m presto_tpu_torch.apps.tune`` runs it.)  The DB is
``--db`` or ``tune.default_db_path()``; no environment variable is
read.  On the card every candidate launches the CUDA kernels, smoke or
not (there is no interpret mode and no fallback); on the CPU
(``-device cpu``) the families run their plain versions.  Prints one
JSON summary line; human detail goes to stderr.  Saves are
merge-on-write, so concurrent tuners on a shared filesystem compose
(keep-the-best per key).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="presto-tune",
        description="Offline kernel-autotuning sweeps; results land "
                    "in the persistent tuning DB consulted by tuned "
                    "runs (tune.configure(enabled=True), "
                    "SurveyConfig.tune).")
    p.add_argument("--families", default="",
                   help="Comma list of families to sweep (default: "
                        "all available; see --list)")
    p.add_argument("--budget", type=float, default=0.0,
                   help="Wall-clock budget in seconds; no new "
                        "(family, shape) sweep starts past it "
                        "(0 = unbounded)")
    p.add_argument("--db", default="",
                   help="Tuning-DB path (default: "
                        "tune.default_db_path(), "
                        "~/.cache/presto_tpu_torch/tune.json)")
    p.add_argument("--smoke", action="store_true",
                   help="Small spaces, 1 steady rep (the CUDA "
                        "kernels still run on a card)")
    p.add_argument("-device", "--device", default="cuda",
                   help="Device the benches run on (cuda, cuda:N, or "
                        "cpu for the plain versions)")
    p.add_argument("--device-report", action="store_true",
                   help="Print the device fingerprint and this "
                        "device's DB entries, then exit")
    p.add_argument("--list", action="store_true",
                   help="List the family catalog, then exit")
    p.add_argument("--k", type=int, default=0,
                   help="Steady reps per candidate (default 5, "
                        "smoke 1)")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="Per-candidate wall timeout in seconds "
                        "(default 30, smoke 10)")
    return p


def _device_report(db_path: str) -> dict:
    from presto_tpu_torch.tune import TuneDB, device_fingerprint, \
        fingerprint_key
    fp = device_fingerprint()
    db = TuneDB.load(db_path)
    nfp, nrec = db.size()
    return {
        "fingerprint": fp,
        "fingerprint_key": fingerprint_key(fp),
        "db_path": db_path,
        "db_load_error": db.load_error,
        "db_fingerprints": nfp,
        "db_records": nrec,
        "this_device": db.families(fingerprint_key(fp)),
    }


def run_sweeps(families, db_path: str, smoke: bool, budget: float,
               k: int, timeout: float, obs=None,
               device="cuda") -> dict:
    """Sweep `families` on `device`, record winners, merge-save the DB.
    Returns the JSON-safe summary."""
    from presto_tpu_torch.obs import Observability, ObsConfig
    from presto_tpu_torch.tune import TuneDB, fingerprint_key
    from presto_tpu_torch.tune.runner import TuneRunner
    if obs is None:
        obs = Observability(ObsConfig(enabled=True))
    runner = TuneRunner(k=k or (1 if smoke else 5),
                        warmup=1,
                        timeout_s=timeout or (10.0 if smoke
                                              else 30.0),
                        obs=obs, device=device)
    fp = fingerprint_key()
    db = TuneDB()
    t0 = time.time()
    summary = {"fingerprint": fp, "db_path": db_path, "smoke": smoke,
               "device": str(runner.device), "families": {},
               "budget_exhausted": False}
    for fam in families:
        fsp = obs.span("tune:family", family=fam.name)
        fam_out = summary["families"].setdefault(fam.name, [])
        for shape in fam.shapes(smoke):
            if budget and time.time() - t0 > budget:
                summary["budget_exhausted"] = True
                fsp.finish()
                break
            skey = fam.shape_key(shape)
            configs = fam.candidates(shape)
            if not configs:
                continue
            if fam.score is not None:
                # modeled family: deterministic figure of merit
                scored = sorted(
                    ((fam.score(shape, c), c) for c in configs),
                    key=lambda sc: sc[0])
                best_s, best_c = scored[0]
                db.record(fp, fam.name, skey, best_c, best_s,
                          reps=1)
                fam_out.append({"shape_key": skey, "config": best_c,
                                "median_s": round(best_s, 6),
                                "candidates": len(configs),
                                "modeled": True})
                print("# %-20s %-24s -> %s (score %.3f, modeled)"
                      % (fam.name, skey, best_c, best_s),
                      file=sys.stderr)
                continue
            cands = [(c, fam.bench(shape, c, runner.device))
                     for c in configs]
            best, results = runner.sweep(fam.name, skey, cands)
            statuses = {}
            for m in results:
                statuses[m.status] = statuses.get(m.status, 0) + 1
            if best is None:
                fam_out.append({"shape_key": skey, "config": None,
                                "candidates": len(configs),
                                "statuses": statuses})
                print("# %-20s %-24s -> no usable candidate (%s)"
                      % (fam.name, skey, statuses), file=sys.stderr)
                continue
            db.record(fp, fam.name, skey, best.config,
                      best.median_s, reps=best.reps)
            fam_out.append({"shape_key": skey, "config": best.config,
                            "median_s": round(best.median_s, 6),
                            "candidates": len(configs),
                            "statuses": statuses})
            print("# %-20s %-24s -> %s (%.4fs median of %d)"
                  % (fam.name, skey, best.config, best.median_s,
                     best.reps), file=sys.stderr)
        else:
            fsp.finish()
            continue
        break                       # budget exhausted mid-family
    db.save(db_path)
    nfp, nrec = TuneDB.load(db_path).size()
    obs.metrics.gauge(
        "tune_db_entries",
        "Records resident in the tuning DB after the last "
        "save").set(nrec)
    summary["db_records"] = nrec
    summary["elapsed_s"] = round(time.time() - t0, 2)
    return summary


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.tune import default_db_path
    from presto_tpu_torch.tune.space import FAMILIES, resolve
    db_path = args.db or default_db_path()

    if args.list:
        for name in sorted(FAMILIES):
            print("%-20s %s" % (name, FAMILIES[name].doc))
        return 0
    if args.device_report:
        print(json.dumps(_device_report(db_path), indent=1,
                         sort_keys=True))
        return 0

    names = [n for n in args.families.split(",") if n.strip()]
    try:
        families = resolve(names or None)
    except ValueError as e:
        print("presto-tune: %s" % e, file=sys.stderr)
        return 2
    summary = run_sweeps(families, db_path, smoke=args.smoke,
                         budget=args.budget, k=args.k,
                         timeout=args.timeout, device=args.device)
    print(json.dumps(summary, sort_keys=True))
    swept = sum(len(v) for v in summary["families"].values())
    return 0 if swept else 1


if __name__ == "__main__":
    sys.exit(main())
