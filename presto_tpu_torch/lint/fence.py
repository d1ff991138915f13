"""fence-discipline: ledger-owned state mutates only through the
fence-checked commit paths.

Host copy of ``presto_tpu/lint/fence.py`` for the PyTorch port.  The
JAX family also scans ``tools/``; the port's tools live in
``presto_tpu_torch/apps/``, which is scanned in its place.

The whole zombie-safety story of the elastic and fleet layers
(docs/ROBUSTNESS.md) rests on one funnel: every mutation of
ledger-owned state — the ledger row files (``shards.json`` /
``jobs.json`` / ``items.json``), per-host heartbeat files (``.hb-*``),
and fence-landed results (``result.json``) — happens inside
`pipeline/leaseledger.py` (or its two subclass modules), under the
ledger lock, behind the epoch fence.  A direct write from ``serve/``
or ``apps/`` would land state the fence never examined: a dead
replica's late output could overwrite a journaled artifact, or a
monitoring script could flip a row no epoch bump protects.

Two patterns are flagged outside the ledger modules:

1. calls into the ledger's private transaction API (``._save`` /
   ``._load`` / ``._commit_row`` / ``._readmit`` / ``._items`` /
   ``._fence_why`` / ``._reject_stale``) on any receiver whose
   expression mentions "ledger" — the public methods (lease /
   complete / fail / reap / ...) are the only supported surface;
2. write calls (``open(..., "w"/"wb")``, ``atomic_write_text`` /
   ``atomic_write_bytes``, ``os.replace`` / ``os.rename``) whose
   arguments contain a ledger-owned filename — renaming something
   onto ``result.json`` yourself is exactly the zombie write the
   fence exists to reject.

Read-only access (``ledger.read()``, opening the files with the
default mode) is deliberately out of scope: monitoring tools may look,
they may not touch.
"""

from __future__ import annotations

import ast
from typing import List

from presto_tpu_torch.lint.core import (Finding, Tree, call_name,
                                  const_strings, dotted_name,
                                  register, str_const)

CHECK = "fence-discipline"

#: the fence-checked commit paths themselves
LEDGER_MODULES = (
    "presto_tpu_torch/pipeline/leaseledger.py",
    "presto_tpu_torch/pipeline/shardledger.py",
    "presto_tpu_torch/serve/jobledger.py",
    "presto_tpu_torch/serve/federation.py",
)

#: where direct mutations would be reachable from
SCOPES = ("presto_tpu_torch/serve/", "presto_tpu_torch/pipeline/",
          "presto_tpu_torch/apps/")

PRIVATE_API = {"_save", "_load", "_commit_row", "_readmit",
               "_items", "_fence_why", "_reject_stale"}

#: filename markers of ledger-owned state; the triage weights file is
#: owned by triage/model.py (schema-versioned, atomic,
#: defensive load) — a direct write from serve/, pipeline/ or apps/
#: would be exactly the poisoned-model path ROBUSTNESS.md rules out
OWNED_MARKERS = ("jobs.json", "shards.json", "items.json",
                 "result.json", ".hb-", "fleets.json",
                 "triage_weights.json")

WRITE_CALLS = {"atomic_write_text", "atomic_write_bytes",
               "os.replace", "os.rename"}
WRITE_MODES = ("w", "wb", "w+", "wb+", "wt")


def _is_write_call(call: ast.Call) -> bool:
    name = call_name(call)
    if name in WRITE_CALLS:
        return True
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in ("atomic_write_text",
                                   "atomic_write_bytes"):
        return True
    if name in ("open", "os.fdopen", "fdopen"):
        mode = None
        if len(call.args) >= 2:
            mode = str_const(call.args[1])
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = str_const(kw.value)
        return mode in WRITE_MODES
    return False


@register(CHECK)
def check(tree: Tree) -> List[Finding]:
    out: List[Finding] = []
    for sf in tree.under(*SCOPES):
        if sf.path in LEDGER_MODULES or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            # 1. private ledger transaction API from outside
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in PRIVATE_API:
                recv = dotted_name(node.func.value) or ""
                if "ledger" in recv.lower():
                    out.append(Finding(
                        CHECK, sf.path, node.lineno,
                        "call to private ledger API %s.%s() outside "
                        "the fence-checked commit paths — only the "
                        "public lease/complete/fail/reap surface "
                        "keeps the epoch fence between a zombie and "
                        "the journal"
                        % (recv, node.func.attr)))
                continue
            # 2. direct writes to ledger-owned files
            if _is_write_call(node):
                hit = [m for m in OWNED_MARKERS
                       if any(m in s
                              for a in list(node.args)
                              + [k.value for k in node.keywords]
                              for s in const_strings(a))]
                if hit:
                    out.append(Finding(
                        CHECK, sf.path, node.lineno,
                        "direct write touching ledger-owned file "
                        "%r — ledger state lands only through the "
                        "fence-checked commit transaction "
                        "(pipeline/leaseledger.py)" % hit[0]))
    return out
