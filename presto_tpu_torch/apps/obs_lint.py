"""obs_lint: thin shim over presto_tpu_torch/lint/obscoverage.py.

Counterpart of ``tools/obs_lint.py``: the instrumentation-coverage
checks are the ``obs-coverage`` family of the port's presto-lint; this
entry point re-exports its ``lint()`` API, ``main()`` and the regexes.
Prefer ``python -m presto_tpu_torch.apps.presto_lint``, which runs this
family with the others.
"""

from __future__ import annotations

import sys

from presto_tpu_torch.lint.obscoverage import (  # noqa: F401
    CHAOS_RE,
    CLUSTER_EVENT_RE,
    EMIT_RE,
    EVENT_ATTR_RE,
    METRIC_RE,
    POINT_RE,
    SPAN_RE,
    STAGE_RE,
    STATUS_RE,
    lint,
    main,
)

if __name__ == "__main__":
    sys.exit(main())
