"""import-hygiene: no unused or duplicate imports, and the port's
isolation from the JAX package.

Host copy of ``presto_tpu/lint/imports.py`` for the PyTorch port.
Beside the JAX family's rules it flags every import of ``jax`` (or
``jaxlib``), of the JAX package ``presto_tpu`` and of its drivers under
``tools/`` anywhere in the port's tree: at module scope, inside
functions and in ``try`` blocks alike, since the port runs where JAX is
not installed (the drivers import the JAX package).  It is the
static form of the subprocess checks in tests/test_torch_isolation.py.

The in-tree twin of the ``[tool.ruff]`` config in pyproject.toml
(rules F401/F811 scoped to import hygiene + unused code): the CI
container does not ship ruff, so the same invariant is enforced here
with the presto-lint machinery and exact ``file:line`` findings.

Deliberately conservative — a finding here must be a certain dead
import, never a style opinion:

* ``__init__.py`` files are exempt (imports are re-exports);
* a name listed in ``__all__`` or carrying a ``# noqa`` on the import
  line is used by definition;
* imports inside ``try:`` blocks are exempt (the repo's gate-missing-
  deps idiom);
* a name is "used" if it appears *anywhere* else in the file — AST
  loads, decorators, annotations, and even docstrings/strings (a
  word-boundary text search backstops the AST walk, so doctest and
  ``typing``-string usage never false-positives);
* a duplicate binding is flagged only when the same name is imported
  twice at the same (module) scope.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List

from presto_tpu_torch.lint.core import Finding, Tree, register

CHECK = "import-hygiene"

NOQA_RE = re.compile(r"#\s*noqa", re.IGNORECASE)


def _bindings(node) -> List[tuple]:
    """(bound local name, full imported name) pairs.  `import a.b`
    and `import a.c` both bind `a` but are NOT duplicates (urllib
    submodule idiom), so duplicate detection keys on the full name."""
    out = []
    for a in node.names:
        if a.name == "*":
            continue
        bound = a.asname or a.name.split(".")[0]
        full = a.name if isinstance(node, ast.Import) \
            else "%s.%s" % (node.module, a.name)
        out.append((bound, full))
    return out


def _in_try(stack: List[ast.AST]) -> bool:
    return any(isinstance(n, ast.Try) for n in stack)


#: top-level packages the port never imports
FOREIGN = ("jax", "jaxlib", "presto_tpu", "tools")


def _foreign(node) -> List[str]:
    """The foreign module names an import statement names."""
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif node.level == 0 and node.module:
        names = [node.module]
    else:
        names = []
    return [n for n in names if n.split(".")[0] in FOREIGN]


def _isolation(sf) -> List[Finding]:
    return [Finding(CHECK, sf.path, node.lineno,
                    "%r is imported — the port imports neither jax, the "
                    "JAX package nor its tools (it keeps its own copy of "
                    "what it needs)" % name)
            for node in ast.walk(sf.tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for name in _foreign(node)]


@register(CHECK)
def check(tree: Tree) -> List[Finding]:
    out: List[Finding] = []
    for sf in tree.under("presto_tpu_torch/", "chip_smoke.py"):
        if sf.tree is None:
            continue
        out.extend(_isolation(sf))
        if sf.path.endswith("__init__.py"):
            continue
        # module-level imports with their guarding context
        imports: Dict[str, List[int]] = {}   # bound name -> [linenos]
        fulls: Dict[tuple, List[int]] = {}   # (bound, full) -> lines
        exempt: set = set()

        def walk(node, stack):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.Import, ast.ImportFrom)):
                    if isinstance(child, ast.ImportFrom) \
                            and (child.module == "__future__"
                                 or child.module is None):
                        continue
                    for name, full in _bindings(child):
                        imports.setdefault(name, []).append(
                            child.lineno)
                        fulls.setdefault((name, full), []).append(
                            child.lineno)
                        if _in_try(stack + [node]) \
                                or NOQA_RE.search(
                                    sf.line_at(child.lineno)):
                            exempt.add(name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.ClassDef, ast.Lambda)):
                    continue       # function-local imports: scoped,
                    #                cheap, and often lazy by design
                else:
                    walk(child, stack + [node])

        walk(sf.tree, [])
        if not imports:
            continue
        # names used anywhere outside import statements
        import_lines = {ln for lns in imports.values() for ln in lns}
        used: set = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Name) \
                    and node.lineno not in import_lines:
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                pass                       # root is a Name node too
        # __all__ entries count as used
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        for c in ast.walk(node.value):
                            if isinstance(c, ast.Constant) \
                                    and isinstance(c.value, str):
                                used.add(c.value)
        for (name, full), lines in sorted(fulls.items()):
            if len(lines) > 1 and name not in exempt:
                out.append(Finding(
                    CHECK, sf.path, lines[-1],
                    "%r is imported more than once at module scope "
                    "(first at line %d)" % (full, lines[0])))
        for name, lines in sorted(imports.items()):
            if name in exempt or name in used or name == "_":
                continue
            # text backstop: any other mention (docstring, doctest,
            # string annotation) vetoes the finding
            pat = re.compile(r"\b%s\b" % re.escape(name))
            mentions = sum(
                1 for i, line in enumerate(sf.lines, 1)
                if i not in import_lines and pat.search(line))
            if mentions:
                continue
            out.append(Finding(
                CHECK, sf.path, lines[0],
                "%r is imported but never used (ruff F401); remove "
                "it or mark the line `# noqa` if it is a deliberate "
                "re-export" % name))
    return out
