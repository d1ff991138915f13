"""Shipped data files the port reads (host).

Host copy of ``default_birds_path`` from ``presto_tpu/utils/catalog.py``
for the PyTorch port; the pulsar catalog itself is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional


def default_birds_path() -> Optional[str]:
    """The shipped default birdie list (the lib/parkes_birds.txt
    analog): power-mains harmonics."""
    p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "default_birds.txt")
    return p if os.path.exists(p) else None
