"""Range-string parsing: '0:3,10,15:17' -> [0,1,2,3,10,15,16,17].

Host copy of ``presto_tpu/utils/ranges.py`` for the PyTorch port.

Parity: ranges_to_ivect (src/range_parse.c) — PRESTO accepts both
'lo:hi' and 'lo-hi' with comma separation; ranges are inclusive.
"""

from __future__ import annotations

from typing import List


def parse_ranges(s: str) -> List[int]:
    out: List[int] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        for sep in (":", "-"):
            if sep in part:
                lo, hi = part.split(sep, 1)
                out.extend(range(int(lo), int(hi) + 1))
                break
        else:
            out.append(int(part))
    return sorted(set(out))
