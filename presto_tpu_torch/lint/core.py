"""presto-lint framework: parsed-source tree, check registry, pragma
suppression, and the committed-baseline protocol.

Host copy of ``presto_tpu/lint/core.py`` for the PyTorch port, which
imports nothing from the JAX package.  The scanned tree is the port's:
``presto_tpu_torch/`` and the file ``chip_smoke.py``.

Design choices that matter:

* **One parse per file.**  `Tree` walks the scan roots once, parses
  every ``.py`` into an AST, and hands the same `SourceFile` objects
  to every check — a check is a pure function `Tree -> [Finding]`.
* **Pragmas are positional.**  ``# presto-lint: allow(check-a,
  check-b)`` on the finding's line (or the line directly above it)
  suppresses those families at that line only — a blanket opt-out
  does not exist by design.
* **The baseline is for grandfathered sites.**  Entries match on
  (check, path, stripped source line), not on line numbers, so code
  motion does not resurrect them; an entry that matches nothing is
  *stale* and itself fails the run — the baseline can only shrink.
  A whole-file finding (line 0, e.g. obs-coverage's) has no source
  line, so its entry matches on the finding's message instead.
* **In-memory trees.**  `Tree.from_sources` builds the same structure
  from literal strings, which is how the test suite proves each check
  fires on a synthetic violation without committing bad code.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(r"#\s*presto-lint:\s*allow\(([^)]*)\)")


@dataclass(frozen=True)
class Finding:
    """One check violation, anchored to a source line."""
    check: str          # check family id, e.g. "atomic-write"
    path: str           # repo-relative, forward slashes
    line: int           # 1-based; 0 = whole-file / cross-file finding
    message: str

    def format(self) -> str:
        return "%s:%d: [%s] %s" % (self.path, self.line, self.check,
                                   self.message)

    def to_json(self) -> dict:
        return {"check": self.check, "path": self.path,
                "line": self.line, "message": self.message}


class SourceFile:
    """One parsed source file: text, line table, AST (None when the
    file does not parse — a syntax error is reported as a finding by
    run_checks, not an exception)."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        try:
            self.tree: Optional[ast.AST] = ast.parse(text)
            self.error: Optional[str] = None
        except SyntaxError as e:
            self.tree = None
            self.error = "line %s: %s" % (e.lineno, e.msg)

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def allowed(self, lineno: int) -> set:
        """Check ids suppressed at `lineno` via allow() pragmas on the
        line itself or the line directly above."""
        out: set = set()
        for ln in (lineno, lineno - 1):
            m = PRAGMA_RE.search(self.line_at(ln))
            if m:
                out |= {c.strip() for c in m.group(1).split(",")
                        if c.strip()}
        return out

    def segment(self, node: ast.AST) -> str:
        """Best-effort source text of a node (for messages)."""
        try:
            return ast.get_source_segment(self.text, node) or ""
        except Exception:
            return ""


class Tree:
    """The scanned source tree: {repo-relative path: SourceFile}."""

    #: default scan roots, relative to the repo root: directories are
    #: walked, a ``.py`` root is read as one file
    ROOTS = ("presto_tpu_torch", "chip_smoke.py")

    def __init__(self, root: str, files: Dict[str, SourceFile]):
        self.root = root
        self.files = files

    @classmethod
    def collect(cls, root: str,
                roots: Sequence[str] = ROOTS) -> "Tree":
        files: Dict[str, SourceFile] = {}
        for sub in roots:
            top = os.path.join(root, sub)
            if sub.endswith(".py"):
                paths = [top] if os.path.isfile(top) else []
            else:
                paths = []
                for dirpath, dirs, names in os.walk(top):
                    dirs[:] = [d for d in dirs if d != "__pycache__"]
                    paths += [os.path.join(dirpath, name)
                              for name in sorted(names)
                              if name.endswith(".py")]
            for p in paths:
                rel = os.path.relpath(p, root).replace(os.sep, "/")
                with open(p, encoding="utf-8") as f:
                    files[rel] = SourceFile(rel, f.read())
        return cls(root, files)

    @classmethod
    def from_sources(cls, sources: Dict[str, str],
                     root: str = "<memory>") -> "Tree":
        return cls(root, {rel: SourceFile(rel, text)
                          for rel, text in sources.items()})

    def under(self, *prefixes: str) -> List[SourceFile]:
        """Files whose path starts with any prefix, sorted."""
        return [self.files[rel] for rel in sorted(self.files)
                if rel.startswith(prefixes)]

    def get(self, rel: str) -> Optional[SourceFile]:
        return self.files.get(rel)


# ---------------------------------------------------------------------------
# check registry
# ---------------------------------------------------------------------------

CheckFn = Callable[[Tree], List[Finding]]
_REGISTRY: Dict[str, CheckFn] = {}


def register(name: str):
    """Register a check family under `name` (its Finding.check id)."""
    def deco(fn: CheckFn) -> CheckFn:
        _REGISTRY[name] = fn
        return fn
    return deco


def registered_checks() -> List[str]:
    return sorted(_REGISTRY)


def run_checks(tree: Tree,
               checks: Optional[Sequence[str]] = None
               ) -> List[Finding]:
    """Run the selected (default: all registered) check families and
    return pragma-filtered findings, sorted by (path, line, check).
    Unparseable files yield one `syntax` finding each."""
    findings: List[Finding] = []
    for rel in sorted(tree.files):
        sf = tree.files[rel]
        if sf.error is not None:
            findings.append(Finding("syntax", rel, 0, sf.error))
    names = list(checks) if checks is not None else registered_checks()
    for name in names:
        try:
            fn = _REGISTRY[name]
        except KeyError:
            raise ValueError("unknown check %r (registered: %s)"
                             % (name, ", ".join(registered_checks())))
        findings.extend(fn(tree))
    kept = []
    for f in findings:
        sf = tree.get(f.path)
        if sf is not None and f.line and f.check in sf.allowed(f.line):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.check, f.message))
    return kept


# ---------------------------------------------------------------------------
# baseline (grandfathered sites)
# ---------------------------------------------------------------------------

def baseline_entry(tree: Tree, finding: Finding,
                   note: str = "") -> dict:
    """The baseline row for one current finding: keyed by the stripped
    source line so later code motion neither orphans nor widens it (a
    line-0 finding by its message)."""
    sf = tree.get(finding.path)
    if finding.line == 0:
        ctx = finding.message
    else:
        ctx = sf.line_at(finding.line).strip() if sf else ""
    return {"check": finding.check, "path": finding.path,
            "context": ctx, "note": note}


def load_baseline(path: str) -> List[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return []
    entries = data.get("entries", []) if isinstance(data, dict) \
        else data
    return [e for e in entries if isinstance(e, dict)]


def save_baseline(path: str, entries: List[dict]) -> None:
    from presto_tpu_torch.io.atomic import atomic_write_text
    atomic_write_text(path, json.dumps(
        {"version": 1,
         "comment": "grandfathered presto-lint sites; entries match "
                    "on (check, path, stripped source line, or a "
                    "whole-file finding's message) and a stale entry "
                    "fails the run — this file only shrinks",
         "entries": entries}, indent=1, sort_keys=True) + "\n")


def _entry_matches(tree: Tree, entry: dict, finding: Finding) -> bool:
    if entry.get("check") != finding.check \
            or entry.get("path") != finding.path:
        return False
    ctx = entry.get("context", "")
    if not ctx:
        return True                       # path-wide grandfather
    if finding.line == 0:
        return finding.message == ctx
    sf = tree.get(finding.path)
    if sf is None:
        return False
    return sf.line_at(finding.line).strip() == ctx


def apply_baseline(tree: Tree, findings: List[Finding],
                   entries: List[dict]
                   ) -> Tuple[List[Finding], List[Finding],
                              List[Finding]]:
    """Split findings against the baseline.

    Returns (kept, suppressed, stale): `kept` are live violations,
    `suppressed` matched a baseline entry, and `stale` is one
    synthetic ``baseline`` finding per entry that matched nothing —
    stale entries fail the run so the baseline expires as sites are
    fixed."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    used = [False] * len(entries)
    for f in findings:
        hit = False
        for i, e in enumerate(entries):
            if _entry_matches(tree, e, f):
                used[i] = True
                hit = True
        (suppressed if hit else kept).append(f)
    stale = [
        Finding("baseline", e.get("path", "?"), 0,
                "stale baseline entry (check=%s, context=%r) matches "
                "no current finding — remove it"
                % (e.get("check"), e.get("context", "")))
        for i, e in enumerate(entries) if not used[i]]
    return kept, suppressed, stale


# ---------------------------------------------------------------------------
# shared AST helpers for the check modules
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def const_strings(node: ast.AST) -> List[str]:
    """Every string constant anywhere under `node`."""
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant)
            and isinstance(n.value, str)]


@dataclass
class FunctionScope:
    """A function body with resolved innermost ownership of each
    statement — used by checks that reason per enclosing function."""
    node: ast.AST                 # FunctionDef / AsyncFunctionDef
    qualname: str
    calls: List[ast.Call] = field(default_factory=list)


def function_scopes(sf: SourceFile) -> List[FunctionScope]:
    """Every function/method in the file with its *directly owned*
    calls (calls inside nested defs belong to the nested scope)."""
    if sf.tree is None:
        return []
    out: List[FunctionScope] = []

    def walk_fn(node, qual):
        scope = FunctionScope(node, qual)
        out.append(scope)
        stack = list(ast.iter_child_nodes(node))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(n, qual + "." + n.name)
                continue
            if isinstance(n, ast.Call):
                scope.calls.append(n)
            stack.extend(ast.iter_child_nodes(n))

    def walk_top(node, prefix):
        for n in ast.iter_child_nodes(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(n, prefix + n.name)
            elif isinstance(n, ast.ClassDef):
                walk_top(n, prefix + n.name + ".")
            else:
                walk_top(n, prefix)

    walk_top(sf.tree, "")
    return out
