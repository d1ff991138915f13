"""trace-purity: the kernels' wrappers and plain versions are pure.

Counterpart of ``presto_tpu/lint/purity.py`` for the PyTorch port,
which has no ``jax.jit`` and no ``pallas_call``.  Its device boundary
is the hand-written kernels: ``chip_smoke.py`` and the tests hold each
kernel against the plain PyTorch version beside it on the same inputs,
which proves something only while both are pure functions of their
inputs.  A clock read, a stateful random draw or host file I/O reached
from either makes two calls on equal inputs differ.

Mechanics: over ``ops/``, ``search/``, ``parallel/`` the check

1. marks **entry points**: every function that calls
   ``cuda_build.launch``, every function of the same module that calls
   one of those (the public wrappers), and every ``*_plain`` function
   of such a module (the plain versions);
2. builds the **call graph** by name, as the JAX family does: bare
   calls resolve to functions of the same module (including nested
   defs), ``from``-imports and ``module.func`` attribute calls resolve
   across the three scanned packages;
3. flags any **impure call** in a reachable function: ``time.time`` and
   friends, the stateful ``random`` / ``numpy.random`` modules, builtin
   ``open`` / ``os`` file mutations, ``.tofile``, and PyTorch's global
   generator: ``torch.rand*`` (``rand``, ``randn``, ``randint``,
   ``randperm``, the ``_like`` forms) without a ``generator=`` argument
   and ``torch.manual_seed`` / ``torch.seed``.

Per-site escapes use the standard pragma:
``# presto-lint: allow(trace-purity)``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from presto_tpu_torch.lint.core import (Finding, SourceFile, Tree,
                                        dotted_name, function_scopes,
                                        register)

CHECK = "trace-purity"

SCOPES = ("presto_tpu_torch/ops/", "presto_tpu_torch/search/",
          "presto_tpu_torch/parallel/")

#: the launch every kernel wrapper goes through
LAUNCH = "cuda_build.launch"

IMPURE_EXACT = {
    "open", "input", "os.fdopen", "os.remove", "os.unlink",
    "os.replace", "os.rename", "os.makedirs", "os.mkdir",
    "os.system", "time.time", "time.monotonic", "time.perf_counter",
    "time.process_time", "time.time_ns", "time.monotonic_ns",
    "time.sleep", "torch.manual_seed", "torch.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}
IMPURE_PREFIX = ("random.", "numpy.random.")
#: PyTorch draws that use the global generator unless given one
TORCH_RNG_PREFIX = "torch.rand"


class _Module:
    """One scanned module: alias maps and function table."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.aliases: Dict[str, str] = {}      # import numpy as np
        self.from_imports: Dict[str, str] = {}  # from x import y
        self.funcs: Dict[str, List] = {}       # bare name -> scopes
        self.scopes = function_scopes(sf)
        for scope in self.scopes:
            bare = scope.qualname.rsplit(".", 1)[-1]
            self.funcs.setdefault(bare, []).append(scope)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    self.aliases[local] = a.name if a.asname \
                        else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        node.module + "." + a.name

    def resolve_dotted(self, d: str) -> str:
        head, _, rest = d.partition(".")
        if head in self.from_imports:
            base = self.from_imports[head]
        elif head in self.aliases:
            base = self.aliases[head]
        else:
            return d
        return base + "." + rest if rest else base


def _module_rel(dotted: str) -> str:
    return dotted.replace(".", "/") + ".py"


def _is_launch(mod: _Module, call: ast.Call) -> bool:
    d = dotted_name(call.func)
    if d is None:
        return False
    r = mod.resolve_dotted(d)
    return r == LAUNCH or r.endswith("." + LAUNCH)


def _collect_roots(mod: _Module) -> Set[str]:
    """Qualnames of the kernel entry points in one module: the callers
    of the launch, their callers in the module, and the plain
    versions."""
    roots = {s.qualname for s in mod.scopes
             if any(_is_launch(mod, c) for c in s.calls)}
    if not roots:
        return roots
    bare = {q.rsplit(".", 1)[-1] for q in roots}
    grew = True
    while grew:
        grew = False
        for s in mod.scopes:
            if s.qualname in roots:
                continue
            if any(dotted_name(c.func) in bare for c in s.calls):
                roots.add(s.qualname)
                bare.add(s.qualname.rsplit(".", 1)[-1])
                grew = True
    roots |= {s.qualname for s in mod.scopes
              if s.qualname.rsplit(".", 1)[-1].endswith("_plain")}
    return roots


def _impure(mod: _Module, call: ast.Call):
    """The impure name a call resolves to, or None."""
    d = dotted_name(call.func)
    if d is None or d.endswith(".tofile"):
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "tofile":
            return ".tofile()"
        return None
    r = mod.resolve_dotted(d)
    if r in IMPURE_EXACT or r.startswith(IMPURE_PREFIX):
        return r
    if r.startswith(TORCH_RNG_PREFIX) \
            and not any(k.arg == "generator" for k in call.keywords):
        return r + " without generator="
    return None


@register(CHECK)
def check(tree: Tree) -> List[Finding]:
    mods: Dict[str, _Module] = {}
    for sf in tree.under(*SCOPES):
        if sf.tree is not None:
            mods[sf.path] = _Module(sf)

    # call-graph edges: (path, qualname) -> [(path, qualname)]
    def edges(path: str, scope) -> List[Tuple[str, str]]:
        mod = mods[path]
        out: List[Tuple[str, str]] = []
        for call in scope.calls:
            d = dotted_name(call.func)
            if d is None:
                continue
            if "." not in d:
                # bare call: same-module function (any nesting), or a
                # from-import from a scanned module
                if d in mod.funcs:
                    out.extend((path, s.qualname)
                               for s in mod.funcs[d])
                    continue
                tgt = mod.from_imports.get(d)
                if tgt:
                    tmod, _, tname = tgt.rpartition(".")
                    rel = _module_rel(tmod)
                    if rel in mods and tname in mods[rel].funcs:
                        out.extend((rel, s.qualname)
                                   for s in mods[rel].funcs[tname])
            else:
                head, _, attr = d.partition(".")
                if "." in attr:
                    continue               # a.b.c: not a module func
                base = mod.from_imports.get(head) \
                    or mod.aliases.get(head)
                if base:
                    rel = _module_rel(base)
                    if rel in mods and attr in mods[rel].funcs:
                        out.extend((rel, s.qualname)
                                   for s in mods[rel].funcs[attr])
        return out

    scope_by_key = {(path, s.qualname): s
                    for path, mod in mods.items()
                    for s in mod.scopes}

    # BFS from every entry point, remembering which root reached where
    reached: Dict[Tuple[str, str], str] = {}
    queue: List[Tuple[Tuple[str, str], str]] = []
    for path, mod in mods.items():
        for qual in sorted(_collect_roots(mod)):
            key = (path, qual)
            if key in scope_by_key and key not in reached:
                reached[key] = "%s:%s" % (path, qual)
                queue.append((key, reached[key]))
    while queue:
        key, root = queue.pop()
        for nxt in edges(key[0], scope_by_key[key]):
            if nxt not in reached and nxt in scope_by_key:
                reached[nxt] = root
                queue.append((nxt, root))

    out: List[Finding] = []
    for (path, qual), root in sorted(reached.items()):
        mod = mods[path]
        for call in scope_by_key[(path, qual)].calls:
            name = _impure(mod, call)
            if name is not None:
                out.append(Finding(
                    CHECK, path, call.lineno,
                    "%s (reachable from kernel entry %s) calls %s — "
                    "impure: a kernel and the plain version it is held "
                    "against must be pure functions of their inputs "
                    "(pass host state, or a torch.Generator, as an "
                    "argument)" % (qual, root, name)))
    return out
