"""presto-lint CLI for the PyTorch port: run every invariant check
family over ``presto_tpu_torch/`` and ``chip_smoke.py``.

Counterpart of ``tools/presto_lint.py``.  Exit 1 when any unsuppressed
finding (or stale baseline entry) remains; exit 0 on a clean tree.

Usage:
  python -m presto_tpu_torch.apps.presto_lint            # human output
  python -m presto_tpu_torch.apps.presto_lint --json     # JSON report
  python -m presto_tpu_torch.apps.presto_lint --check atomic-write \\
      --check lock-guard
  python -m presto_tpu_torch.apps.presto_lint --list     # the families
  python -m presto_tpu_torch.apps.presto_lint --write-baseline
                                      # grandfather current findings
                                      # (review the diff before commit)

Suppression, most-local first:
  * ``# presto-lint: allow(<check>)`` on (or directly above) the line;
  * an entry in presto_tpu_torch/lint/baseline.json (grandfathered
    sites, each with a note; stale entries fail, so the baseline only
    shrinks).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from presto_tpu_torch import lint as lintpkg
from presto_tpu_torch.lint import core

#: the checkout this package sits in
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="presto_lint",
        description="AST-driven invariant checks for presto_tpu_torch")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable JSON report")
    ap.add_argument("--check", action="append", default=None,
                    metavar="NAME",
                    help="run only this family (repeatable)")
    ap.add_argument("--baseline", default=lintpkg.BASELINE,
                    help="baseline path (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (show everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding into the "
                         "baseline and exit 0")
    ap.add_argument("--root", default=REPO,
                    help=argparse.SUPPRESS)
    ap.add_argument("--list", action="store_true",
                    help="list registered check families")
    args = ap.parse_args(argv)

    if args.list:
        for name in core.registered_checks():
            print(name)
        return 0

    tree = core.Tree.collect(args.root)
    findings = core.run_checks(tree, checks=args.check)
    entries = [] if args.no_baseline \
        else core.load_baseline(args.baseline)
    kept, suppressed, stale = core.apply_baseline(tree, findings,
                                                  entries)

    if args.write_baseline:
        rows = [core.baseline_entry(tree, f, note="grandfathered")
                for f in kept]
        keep_rows = [e for e in entries
                     if any(core._entry_matches(tree, e, f)
                            for f in suppressed)]
        core.save_baseline(args.baseline, keep_rows + rows)
        print("presto_lint: wrote %d baseline entr%s to %s"
              % (len(keep_rows + rows),
                 "y" if len(keep_rows + rows) == 1 else "ies",
                 args.baseline))
        return 0

    checks = args.check or core.registered_checks()
    if args.json:
        print(json.dumps({
            "version": 1,
            "root": os.path.abspath(args.root),
            "checks": list(checks),
            "findings": [f.to_json() for f in kept],
            "stale_baseline": [f.to_json() for f in stale],
            "suppressed": len(suppressed),
            "baseline_entries": len(entries),
            "ok": not kept and not stale,
        }, indent=1, sort_keys=True))
        return 1 if (kept or stale) else 0

    problems = kept + stale
    if problems:
        print("presto_lint: %d violation(s) across %d famil%s:"
              % (len(problems), len(checks),
                 "y" if len(checks) == 1 else "ies"))
        for f in problems:
            print("  %s" % f.format())
        if suppressed:
            print("  (%d grandfathered finding(s) suppressed by %s)"
                  % (len(suppressed), args.baseline))
        return 1
    print("presto_lint: OK — %d families (%s), %d finding(s) "
          "grandfathered" % (len(checks), ", ".join(checks),
                             len(suppressed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
