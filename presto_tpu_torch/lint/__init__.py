"""presto-lint for the PyTorch port: AST-driven invariant analysis of
``presto_tpu_torch/`` and ``chip_smoke.py``.

Counterpart of ``presto_tpu/lint``; it imports nothing from the JAX
package and walks nothing of it.  The port carries the JAX package's
crash-atomic artifact writes (`io/atomic.py`), epoch-fenced ledger
commits (`pipeline/leaseledger.py`), lock-guarded replica state (the
``# presto-lint: guards(...)`` declarations in serve/ and obs/) and
the purity of the kernels' wrappers and plain versions; each check
family walks the real source ASTs and reports exact ``file:line``
findings.

Check families:

  atomic-write      artifact writers in pipeline/ serve/ obs/ stream/
                    tune/ triage/ go through io.atomic.atomic_open or a
                    recognized tmp+os.replace / fence-staged idiom
  fence-discipline  ledger-owned state mutates only inside the
                    fence-checked commit paths
  lock-guard        attributes declared guarded are only touched with
                    their lock held
  lock-order        the lock-acquisition graph is acyclic
  trace-purity      functions reachable from the kernel wrappers (the
                    callers of ``cuda_build.launch``) and their plain
                    versions never call time/random/host-I/O
  import-hygiene    no unused or duplicate imports, and no import of
                    ``jax`` or of the JAX package anywhere in the port
  obs-coverage      the 20 instrumentation-coverage checks, read against
                    the port's obs/taxonomy.py

Use `run_lint()` for the full suite, or `core.run_checks()` for a
subset over an arbitrary (possibly in-memory) tree.  The CLI is
``python -m presto_tpu_torch.apps.presto_lint``.
"""

import os

from presto_tpu_torch.lint.core import (  # noqa: F401  (public API)
    Finding,
    Tree,
    apply_baseline,
    baseline_entry,
    load_baseline,
    registered_checks,
    run_checks,
    save_baseline,
)

# importing the check modules registers them
from presto_tpu_torch.lint import atomicwrite  # noqa: F401
from presto_tpu_torch.lint import fence        # noqa: F401
from presto_tpu_torch.lint import locks        # noqa: F401
from presto_tpu_torch.lint import purity       # noqa: F401
from presto_tpu_torch.lint import imports      # noqa: F401
from presto_tpu_torch.lint import obscoverage  # noqa: F401

#: the committed baseline of grandfathered sites
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def run_lint(root, baseline_path=None, checks=None):
    """Run every registered family over the repo at `root`, applying
    the committed baseline.  Returns (findings, suppressed, stale):
    `findings` must be empty for the tree to pass, `stale` lists
    baseline entries that no longer match anything (they fail too, so
    the baseline shrinks monotonically)."""
    tree = Tree.collect(root)
    findings = run_checks(tree, checks=checks)
    baseline = load_baseline(baseline_path) if baseline_path else []
    return apply_baseline(tree, findings, baseline)
