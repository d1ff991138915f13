"""trace_merge: join per-process span JSONL streams by trace id.

Counterpart of ``tools/trace_merge.py`` over the port's obs/fleetagg.

A fleet run leaves one `*.spans.jsonl` per process under
`<fleet>/obs/` — the router's admission roots plus every replica's
execution spans, stitched together by the trace context the router
stamps through the job ledger (`SpanContext.to_dict` on the admitted
row).  This tool joins those streams into cross-process traces and
exports them as ONE Perfetto/Chrome `trace_event` file, so a
discovery DAG whose search, sift, folds, and timing ran on different
replicas renders as a single timeline.

  # merge a fleet directory's streams, write one Perfetto file
  python -m presto_tpu_torch.apps.trace_merge -fleet FLEETDIR \
      -o merged.perfetto.json

  # or name the JSONL streams explicitly
  python -m presto_tpu_torch.apps.trace_merge repA.spans.jsonl \
      repB.spans.jsonl -o merged.perfetto.json

  # inspect one trace (every span, tree-ordered)
  python -m presto_tpu_torch.apps.trace_merge -fleet FLEETDIR -trace <id>

Exit status is 1 when any trace contains orphan spans (a parent_id
that resolves nowhere in its own trace — the broken-propagation
signal), so the tool doubles as a propagation check in CI scripts.
The merge/join primitives live in `presto_tpu_torch.obs.fleetagg`.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from presto_tpu_torch.obs import fleetagg


def _tree_lines(trace: List[dict]) -> List[str]:
    """One trace's spans as an indented tree (children under
    parents, start-ordered)."""
    by_parent: dict = {}
    ids = {s["span_id"] for s in trace}
    for s in trace:
        parent = s.get("parent_id")
        key = parent if parent in ids else None
        by_parent.setdefault(key, []).append(s)
    lines: List[str] = []

    def walk(parent, depth):
        for s in sorted(by_parent.get(parent, []),
                        key=lambda x: float(x.get("start", 0.0))):
            lines.append("%s%-30s %8.3fs  [%s] pid=%s %s"
                         % ("  " * depth, s.get("name", "?"),
                            float(s.get("duration_s", 0.0)),
                            s.get("status", "ok"), s.get("pid", "?"),
                            s.get("_source", "")))
            walk(s["span_id"], depth + 1)

    walk(None, 1)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace_merge")
    p.add_argument("streams", nargs="*",
                   help="Span JSONL files to join")
    p.add_argument("-fleet", type=str, default=None, metavar="DIR",
                   help="Join every *.spans.jsonl under DIR/obs/")
    p.add_argument("-o", type=str, default=None, metavar="PATH",
                   help="Write the merged Perfetto trace here")
    p.add_argument("-trace", type=str, default=None, metavar="ID",
                   help="Print one trace's span tree (prefix match)")
    args = p.parse_args(argv)
    if not args.streams and not args.fleet:
        p.error("need span JSONL files or -fleet DIR")

    spans = fleetagg.load_spans(args.streams)
    if args.fleet:
        spans += fleetagg.load_fleet_spans(args.fleet)
    if not spans:
        print("trace_merge: no spans found", file=sys.stderr)
        return 1
    traces = fleetagg.spans_by_trace(spans)
    orphans = fleetagg.orphan_spans(spans)
    print("trace_merge: %d spans, %d process(es), %d trace(s), "
          "%d orphan span(s)"
          % (len(spans), len({s.get("pid") for s in spans}),
             len(traces), len(orphans)))
    for tid in sorted(traces, key=lambda t: -len(traces[t])):
        trace = traces[tid]
        procs = len({s.get("pid") for s in trace})
        print("  %s  %3d spans  %d process(es)  root=%s"
              % (tid[:16] or "(no-trace)", len(trace), procs,
                 next((s.get("name") for s in trace
                       if not s.get("parent_id")), "?")))
    if args.trace:
        hits = [t for t in traces if t.startswith(args.trace)]
        for t in hits:
            print("\ntrace %s:" % t)
            for line in _tree_lines(traces[t]):
                print(line)
        if not hits:
            print("trace_merge: no trace matches %r" % args.trace,
                  file=sys.stderr)
    if args.o:
        fleetagg.write_merged_chrome(args.o, spans)
        print("trace_merge: merged Perfetto trace -> %s "
              "(open at https://ui.perfetto.dev)" % args.o)
    for s in orphans[:10]:
        print("trace_merge: ORPHAN span %s (%s) parent %s not in "
              "trace %s" % (s.get("span_id"), s.get("name"),
                            s.get("parent_id"),
                            (s.get("trace_id") or "")[:16]),
              file=sys.stderr)
    return 1 if orphans else 0


if __name__ == "__main__":
    sys.exit(main())
