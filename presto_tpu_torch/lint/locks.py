"""lock-guard / lock-order: statically-checked lock discipline.

Host copy of ``presto_tpu/lint/locks.py`` for the PyTorch port, over
every class of ``presto_tpu_torch/`` and ``chip_smoke.py`` that
declares guards.

The serve layer is the one place the system is genuinely concurrent —
replica pump threads, the scheduler, heartbeats, HTTP handlers — and
its shared state is guarded by per-object locks.  Chaos tests sample
races; this check eliminates a whole class of them statically.

**Declaration** is in-source, next to the lock:

    self._inflight_lock = threading.Lock()  # presto-lint: guards(_inflight)

declares that ``self._inflight`` may only be read or written inside a
``with self._inflight_lock:`` block in that class.  A
``threading.Condition(self._lock)`` assigned to an attribute aliases
its lock: holding the condition counts as holding the lock (that is
what entering a condition does).  Undeclared classes are not
enforced — the check is opt-in per lock, so annotating a class is a
reviewed statement of its concurrency contract.

Rules:

* ``__init__`` is exempt (attributes are born before threads exist);
* a function nested inside a method starts with *no* held locks (it
  typically runs on another thread — exactly the bug this catches);
* a method whose whole body runs under a caller's lock declares it:
  ``def _drain_locked(self):  # presto-lint: holds(_lock)``.

**lock-order** additionally records every syntactic nesting
``with self._a: ... with self._b:`` as a directed edge ``A -> B`` on
the class's lock graph (self-locks only — cross-object acquisition
through method calls is not visible statically) and fails on any
cycle across the scanned tree: two threads taking the same two locks
in opposite orders is a deadlock waiting for load.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from presto_tpu_torch.lint.core import Finding, Tree, dotted_name, register

CHECK_GUARD = "lock-guard"
CHECK_ORDER = "lock-order"

GUARDS_RE = re.compile(r"#\s*presto-lint:\s*guards\(([^)]*)\)")
HOLDS_RE = re.compile(r"#\s*presto-lint:\s*holds\(([^)]*)\)")

LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
COND_CTORS = {"threading.Condition", "Condition"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _ClassLocks:
    """Lock declarations of one class: lock/condition attrs (mapped to
    their root lock) and the guarded-attribute table."""

    def __init__(self) -> None:
        self.roots: Dict[str, str] = {}     # lock/cond attr -> root
        self.guards: Dict[str, str] = {}    # guarded attr -> root

    def scan(self, cls: ast.ClassDef, sf) -> None:
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            ctor = dotted_name(node.value.func)
            targets = [a for a in map(_self_attr, node.targets) if a]
            if not targets or ctor is None:
                continue
            attr = targets[0]
            if ctor in LOCK_CTORS:
                self.roots[attr] = attr
                m = GUARDS_RE.search(sf.line_at(node.lineno))
                if m:
                    for g in m.group(1).split(","):
                        g = g.strip()
                        if g:
                            self.guards[g] = attr
            elif ctor in COND_CTORS:
                base = None
                if node.value.args:
                    base = _self_attr(node.value.args[0])
                self.roots[attr] = self.roots.get(base, base) \
                    if base else attr


def _holds_pragma(sf, fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for ln in (fn.lineno, fn.lineno - 1):
        m = HOLDS_RE.search(sf.line_at(ln))
        if m:
            out |= {h.strip() for h in m.group(1).split(",")
                    if h.strip()}
    return out


@register(CHECK_GUARD)
def check_guard(tree: Tree) -> List[Finding]:
    return _run(tree)[0]


@register(CHECK_ORDER)
def check_order(tree: Tree) -> List[Finding]:
    return _run(tree)[1]


def _run(tree: Tree) -> Tuple[List[Finding], List[Finding]]:
    guard_findings: List[Finding] = []
    edges: Dict[Tuple[str, str], int] = {}   # (fromkey, tokey) -> line
    edge_paths: Dict[Tuple[str, str], str] = {}

    for sf in tree.under("presto_tpu_torch/", "chip_smoke.py"):
        if sf.tree is None:
            continue
        for cls in [n for n in ast.walk(sf.tree)
                    if isinstance(n, ast.ClassDef)]:
            decl = _ClassLocks()
            decl.scan(cls, sf)
            if not decl.roots:
                continue
            key = "%s:%s" % (sf.path, cls.name)
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__":
                    continue
                held = frozenset(
                    decl.roots.get(h, h)
                    for h in _holds_pragma(sf, fn))
                _visit(fn, held, decl, sf, key, fn.name,
                       guard_findings, edges, edge_paths,
                       skip_self=True)

    order_findings = _cycles(edges, edge_paths)
    return guard_findings, order_findings


def _visit(node: ast.AST, held: FrozenSet[str], decl: _ClassLocks,
           sf, clskey: str, method: str,
           findings: List[Finding], edges, edge_paths,
           skip_self: bool = False) -> None:
    """Walk one statement/expression tracking the held-lock set."""
    if not skip_self:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # nested callable: usually another thread's body — it
            # holds nothing (its own holds() pragma may say otherwise)
            inner = frozenset(
                decl.roots.get(h, h) for h in _holds_pragma(sf, node)
            ) if not isinstance(node, ast.Lambda) else frozenset()
            for child in ast.iter_child_nodes(node):
                _visit(child, inner, decl, sf, clskey,
                       method, findings, edges, edge_paths)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            newly: List[str] = []
            for item in node.items:
                attr = _self_attr(item.context_expr)
                root = decl.roots.get(attr) if attr else None
                if root is not None:
                    for h in held:
                        if h != root:
                            e = (clskey + "." + h, clskey + "." + root)
                            edges.setdefault(e, node.lineno)
                            edge_paths.setdefault(e, sf.path)
                    newly.append(root)
                elif item.context_expr is not None:
                    _visit(item.context_expr, held, decl, sf, clskey,
                           method, findings, edges, edge_paths)
            inner = held.union(newly)
            for stmt in node.body:
                _visit(stmt, inner, decl, sf, clskey, method,
                       findings, edges, edge_paths)
            return
        attr = _self_attr(node)
        if attr is not None and attr in decl.guards \
                and decl.guards[attr] not in held:
            findings.append(Finding(
                CHECK_GUARD, sf.path, node.lineno,
                "self.%s is guarded by self.%s but %s() touches it "
                "without holding the lock (declare the guard with "
                "`with self.%s:` or mark the method "
                "`# presto-lint: holds(%s)` if every caller holds "
                "it)" % (attr, decl.guards[attr], method,
                         decl.guards[attr], decl.guards[attr])))
            return
    for child in ast.iter_child_nodes(node):
        _visit(child, held, decl, sf, clskey, method, findings,
               edges, edge_paths)


def _cycles(edges, edge_paths) -> List[Finding]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    out: List[Finding] = []
    seen_cycles: Set[FrozenSet[str]] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}

    def dfs(n: str, stack: List[str]) -> None:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            if color.get(m, WHITE) == GRAY:
                cyc = stack[stack.index(m):] + [m]
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    e = (cyc[0], cyc[1]) if len(cyc) > 1 \
                        else (cyc[0], cyc[0])
                    out.append(Finding(
                        CHECK_ORDER, edge_paths.get(
                            (n, m), e and edge_paths.get(e, "?")),
                        edges.get((n, m), 0),
                        "lock-acquisition-order cycle: %s — two "
                        "threads taking these locks in opposite "
                        "orders deadlock" % " -> ".join(cyc)))
            elif color.get(m, WHITE) == WHITE:
                dfs(m, stack)
        stack.pop()
        color[n] = BLACK

    for n in sorted(graph):
        if color.get(n, WHITE) == WHITE:
            dfs(n, [])
    return out
