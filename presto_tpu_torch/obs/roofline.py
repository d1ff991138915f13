"""Device roofline: the card's measured peaks + compute/memory placement.

PyTorch counterpart of ``presto_tpu/obs/roofline.py``.  The roofline
needs two device constants, peak FLOP/s and peak memory bandwidth, to
place a kernel by its operational intensity (FLOPs per device byte):
below the ridge ``peak_flops / peak_bandwidth`` a kernel is
memory-bound, above it compute-bound.  ``measure_peaks`` measures both
on the card with microbenchmarks (a float32 [n, n] ``torch.matmul``
with TF32 off for FLOP/s, a streaming triad for bytes/s; best of
``reps``, CUDA events) and ``device_peaks`` caches them in the tuning
DB (tune/db.py, family ``device_roofline``, shape ``peaks_v1``) under
the card's fingerprint.  Neither is a ported kernel: they time library
calls to find the card's ceilings.  A failed measurement raises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

#: tune-DB family holding the cached peaks per device fingerprint
FAMILY = "device_roofline"

#: shape key under the family (a methodology change bumps it)
SHAPE_KEY = "peaks_v1"


# ----------------------------------------------------------------------
# the microbenchmark
# ----------------------------------------------------------------------

def best_ms(fn, reps: int) -> float:
    """Best of ``reps`` CUDA-event times of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def measure_peaks(obs=None, reps: int = 5, n_mm: int = 8192,
                  n_bw: int = 1 << 28, device="cuda") -> Dict[str, float]:
    """Measure (peak FLOP/s, peak bytes/s) on a CUDA ``device``.

    * FLOP/s: an [n_mm, n_mm] @ [n_mm, n_mm] float32 matmul with TF32
      off (2 n^3 FLOPs);
    * bytes/s: the triad ``c = a * s + b`` over n_bw float32 elements
      (two arrays read and one written: 12 n_bw bytes).

    Best of ``reps`` CUDA-event times each (a peak is a ceiling, not an
    average).  Raises on a device that is not a card."""
    from presto_tpu_torch.search.accel import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("roofline: peaks are measured on a CUDA device, "
                         "not %s" % dev)
    sp = (obs.span("obs:roofline-probe", op="peaks", n_mm=n_mm,
                   n_bw=n_bw) if obs is not None and obs.enabled else None)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.cuda.device(dev):
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            a = torch.randn((n_mm, n_mm), generator=gen, device=dev)
            b = torch.randn((n_mm, n_mm), generator=gen, device=dev)
            c = torch.empty_like(a)
            mm_ms = best_ms(lambda: torch.matmul(a, b, out=c), reps)
            del a, b, c
            x = torch.randn(n_bw, generator=gen, device=dev)
            y = torch.randn(n_bw, generator=gen, device=dev)
            z = torch.empty_like(x)
            bw_ms = best_ms(lambda: torch.add(y, x, alpha=1.0001, out=z),
                             reps)
            del x, y, z
            torch.cuda.empty_cache()
    except BaseException as e:
        if sp is not None:
            sp.finish("error: %s" % type(e).__name__)
        raise
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    if sp is not None:
        sp.finish()
    flops_per_s = 2.0 * n_mm ** 3 / (mm_ms * 1e-3)
    bytes_per_s = 12.0 * n_bw / (bw_ms * 1e-3)
    return {
        "flops_per_s": flops_per_s,
        "bytes_per_s": bytes_per_s,
        "ridge_intensity": flops_per_s / bytes_per_s,
        "matmul_s": mm_ms * 1e-3,
        "triad_s": bw_ms * 1e-3,
        "n_mm": float(n_mm),
        "n_bw": float(n_bw),
        "measured_at": time.time(),
    }


# ----------------------------------------------------------------------
# fingerprint-cached access
# ----------------------------------------------------------------------

def device_peaks(obs=None, db_path: Optional[str] = None,
                 measure: bool = True, reps: int = 5
                 ) -> Optional[Dict[str, float]]:
    """Peaks for the current card's fingerprint, off the tuning DB when
    already measured; with ``measure`` a miss runs the microbenchmark
    once and merge-saves it (keep-the-best on the matmul time).  None
    when nothing is cached and ``measure`` is off."""
    from presto_tpu_torch.tune.db import (TuneDB, default_db_path,
                                          fingerprint_key)
    fp = fingerprint_key()
    path = db_path or default_db_path()
    db = TuneDB.load(path)
    rec = db.lookup(fp, FAMILY, SHAPE_KEY)
    if rec is not None:
        return dict(rec)
    if not measure:
        return None
    peaks = measure_peaks(obs=obs, reps=reps)
    db.record(fp, FAMILY, SHAPE_KEY, peaks,
              median_s=float(peaks["matmul_s"]), reps=reps,
              source="roofline")
    db.save(path)
    return peaks


# ----------------------------------------------------------------------
# classification (pure arithmetic)
# ----------------------------------------------------------------------

def classify(flops: float, hbm_bytes: float,
             peaks: Dict[str, float]) -> Optional[dict]:
    """Place one kernel on the roofline.  None when the cost or the
    peaks are unusable (zero bytes, missing fields)."""
    try:
        pf = float(peaks["flops_per_s"])
        pb = float(peaks["bytes_per_s"])
    except (KeyError, TypeError, ValueError):
        return None
    if hbm_bytes <= 0 or pf <= 0 or pb <= 0:
        return None
    intensity = float(flops) / float(hbm_bytes)
    ridge = pf / pb
    attainable = min(pf, intensity * pb)
    return {
        "intensity": intensity,
        "ridge_intensity": ridge,
        "bound": "compute" if intensity >= ridge else "memory",
        "attainable_flops_per_s": attainable,
        "frac_of_peak_flops": attainable / pf,
    }


def roofline_rows(costs: dict,
                  peaks: Optional[Dict[str, float]]) -> list:
    """Per-kind roofline rows for a kernel_costs snapshot: every kind
    with a unit gets an intensity and a verdict (or "(no peaks)"),
    every kind that only dispatched an explicit "(unavailable)" row,
    and each row its share of the total attributed device bytes."""
    kinds = (costs or {}).get("kinds", {}) or {}
    total_bytes = sum(float(e.get("hbm_bytes_total", 0.0) or 0.0)
                      for e in kinds.values())
    rows = []
    for kind, ent in sorted(kinds.items()):
        flops = ent.get("flops_per_dispatch")
        nbytes = ent.get("hbm_bytes_per_dispatch")
        row = {
            "kind": kind,
            "dispatches": int(ent.get("dispatches", 0)),
            "flops_per_dispatch": flops,
            "hbm_bytes_per_dispatch": nbytes,
            "flops_total": ent.get("flops_total", 0.0),
            "hbm_bytes_total": ent.get("hbm_bytes_total", 0.0),
            "hbm_share": (float(ent.get("hbm_bytes_total", 0.0) or
                                0.0) / total_bytes
                          if total_bytes > 0 else 0.0),
            "peak_bytes": ent.get("peak_bytes"),
        }
        if flops is None or nbytes is None:
            row["verdict"] = "(unavailable)"
        elif peaks is None:
            row["intensity"] = (flops / nbytes if nbytes else None)
            row["verdict"] = "(no peaks)"
        else:
            cls = classify(flops, nbytes, peaks)
            if cls is None:
                row["verdict"] = "(no peaks)"
            else:
                row.update(cls)
                row["verdict"] = "%s-bound" % cls["bound"]
        rows.append(row)
    return rows
