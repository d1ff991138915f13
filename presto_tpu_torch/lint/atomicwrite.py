"""atomic-write: artifact writers must be crash-atomic.

Host copy of ``presto_tpu/lint/atomicwrite.py`` for the PyTorch port:
the same rules and idioms over the port's artifact layers.

The survey checkpoint contract ("a stage is skipped when its outputs
already exist", docs/ROBUSTNESS.md) makes a half-written artifact a
*silent* corruption: a resume trusts whatever is on disk.  Every
artifact writer in the artifact-producing layers — ``pipeline/``,
``serve/``, ``obs/`` — must therefore either go through
`io.atomic.atomic_open` (tmp + fsync + rename) or use a recognized
equivalent idiom:

* **tmp + replace**: the enclosing function also calls
  ``os.replace``/``os.rename`` — the open target is a staging file
  that never becomes the artifact except atomically
  (pipeline/driftprep.py's streamed rewrite used this before moving
  to atomic_open);
* **fence-staged**: the enclosing function stages via
  ``tempfile.mkstemp``/``NamedTemporaryFile`` and hands the staged
  path to a ledger ``complete()``/``complete_and_expand()`` — the
  rename happens inside the fence-checked commit transaction
  (serve/fleet.py's result staging), which is *stronger* than a local
  rename because a zombie's staged file is deleted instead of landed.

Flagged patterns: ``open(path, "w"/"wb")``, ``os.fdopen(fd,
"w"/"wb")``, and ``ndarray.tofile(<path-like>)``.  Read modes and
append-only logs (``"a"`` — the serve event JSONL, where a torn tail
line is detected by the parser) are out of scope by design.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from presto_tpu_torch.lint.core import (Finding, Tree, call_name,
                                  function_scopes, register, str_const)

CHECK = "atomic-write"

#: layers whose writes are survey/serve artifacts (io/ itself hosts
#: the atomic writer; apps/ CLIs write user-addressed files through
#: io-layer writers that are covered transitively)
SCOPES = ("presto_tpu_torch/pipeline/", "presto_tpu_torch/serve/",
          "presto_tpu_torch/obs/", "presto_tpu_torch/stream/",
          "presto_tpu_torch/tune/", "presto_tpu_torch/triage/")

WRITE_MODES = ("w", "wb", "w+", "wb+", "wt")

#: atomic replacement primitives recognized inside the enclosing
#: function
REPLACE_CALLS = {"os.replace", "os.rename"}
STAGE_CALLS = {"tempfile.mkstemp", "tempfile.NamedTemporaryFile",
               "mkstemp", "NamedTemporaryFile"}
FENCE_ATTRS = {"complete", "complete_and_expand"}


def _write_mode(call: ast.Call) -> Optional[str]:
    """The constant write mode of an open()/os.fdopen() call, or
    None when the call is not a flagged writer."""
    name = call_name(call)
    if name == "open" or name == "os.fdopen" or name == "fdopen":
        mode = None
        if len(call.args) >= 2:
            mode = str_const(call.args[1])
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = str_const(kw.value)
        if mode in WRITE_MODES:
            return mode
    return None


def _path_like(node: ast.AST, path_names=frozenset()) -> bool:
    """Is this .tofile() argument a filesystem path (vs an already-
    managed file object)?  Conservative: constants, f-strings, str
    concatenation, os.path.join(), and local names assigned from one
    of those count; anything else is presumed a file object."""
    if str_const(node) is not None or isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.BinOp):
        return _path_like(node.left, path_names) \
            or _path_like(node.right, path_names)
    if isinstance(node, ast.Call):
        return call_name(node) in ("os.path.join", "str")
    if isinstance(node, ast.Name):
        return node.id in path_names
    return False


def _local_path_names(scope) -> frozenset:
    """Names assigned a path-like expression anywhere in the scope."""
    out = set()
    for node in ast.walk(scope.node):
        if isinstance(node, ast.Assign) and _path_like(node.value):
            out |= {t.id for t in node.targets
                    if isinstance(t, ast.Name)}
    return frozenset(out)


def _scope_has_atomic_idiom(scope) -> bool:
    names = {call_name(c) for c in scope.calls}
    if names & REPLACE_CALLS:
        return True                       # tmp + os.replace idiom
    attrs = {c.func.attr for c in scope.calls
             if isinstance(c.func, ast.Attribute)}
    if (names & STAGE_CALLS) and (attrs & FENCE_ATTRS):
        return True                       # fence-staged commit idiom
    return False


def _module_scope(sf):
    """Pseudo-scope owning calls outside any function (script-level
    writers count too)."""
    from presto_tpu_torch.lint.core import FunctionScope
    scopes = function_scopes(sf)
    owned = {id(c) for s in scopes for c in s.calls}
    mod = FunctionScope(sf.tree, "<module>")
    mod.calls = [n for n in ast.walk(sf.tree)
                 if isinstance(n, ast.Call) and id(n) not in owned]
    return scopes + [mod]


@register(CHECK)
def check(tree: Tree) -> List[Finding]:
    out: List[Finding] = []
    for sf in tree.under(*SCOPES):
        if sf.tree is None:
            continue
        for scope in _module_scope(sf):
            idiom = _scope_has_atomic_idiom(scope)
            path_names = _local_path_names(scope)
            for call in scope.calls:
                mode = _write_mode(call)
                if mode is not None and not idiom:
                    out.append(Finding(
                        CHECK, sf.path, call.lineno,
                        "%s(..., %r) writes an artifact without "
                        "crash-atomicity in %s — use "
                        "io.atomic.atomic_open (or stage via tmp + "
                        "os.replace / a ledger fence commit); a "
                        "killed process leaves a half-written file "
                        "a resume will trust"
                        % (call_name(call), mode, scope.qualname)))
                    continue
                if (isinstance(call.func, ast.Attribute)
                        and call.func.attr == "tofile"
                        and call.args
                        and _path_like(call.args[0], path_names)
                        and not idiom):
                    out.append(Finding(
                        CHECK, sf.path, call.lineno,
                        ".tofile(<path>) in %s bypasses atomic "
                        "replacement — write through a file object "
                        "from io.atomic.atomic_open instead"
                        % scope.qualname))
    return out
