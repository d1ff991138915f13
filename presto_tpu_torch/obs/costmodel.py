"""Kernel cost attribution per dispatch kind (obs layer).

PyTorch counterpart of ``presto_tpu/obs/costmodel.py``.  The JAX
package harvests XLA's ``cost_analysis`` once per (kind, input
signature); the port has no compiler cost model to ask, so a kind's
per-dispatch unit cost (:class:`KindCost`) is an analytic count of the
work the kind does on its inputs:

  plane_build   csrc/plane_build.cu: the spectrum blocks, the kernel
                bank and the twiddle table read once, the plane written
                once; per block and z row a complex product, an inverse
                FFT (5 n log2 n) and |.|^2 of the good window
  stage_reduce  csrc/stage_reduce.cu: the plane, start columns and z
                maps read once, colmax/colz written once; one add a
                harmonic term and one compare a stage per plane element
                of the slabs
  rfft_batch    the batched packed real FFT: 5 N log2 N / 2 flops a
                row, the series read and the pairs written
  accel_search  one search_many call: per trial the forward spectra's
                FFTs, plane_build and stage_reduce
  dedisp        one dedispersion step: the subband sums and the DM
                fan-out (one add a channel and a subband per sample)
  beam_dedisp   the stacked beam step: dedisp over a beam axis
  sp_search     one search_many_resident call: the detrend, the chunked
                matched filter (FFT, product, inverse FFT a width)

``chip_smoke.py`` takes its kernel bounds from the same counts
(``plane_build_work``, ``stage_reduce_work``, ``reducer_design_bytes``).
A kind with no formula raises.  The counters and the export keep the
JAX package's names and schema:

  kernel_flops_total{kind}        cumulative modeled FLOPs per kind
  kernel_hbm_bytes_total{kind}    cumulative modeled device bytes per kind

``probe(obs, kind, **shape)`` at a dispatch site installs the unit for
that shape once (under an ``obs:roofline-probe`` span); every
``devtel.note_dispatch`` then attributes ``unit * n`` onto the counters
and onto the current span's ``flops``/``hbm_bytes`` attributes.
``Observability.flush`` writes the book as ``<workdir>/kernel_costs.json``.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Optional

#: kernel_costs.json schema (the JAX package's)
COSTS_SCHEMA = 1


# ----------------------------------------------------------------------
# the per-handle cost book
# ----------------------------------------------------------------------

class KindCost:
    """Per-dispatch unit cost of one kind at one shape."""

    __slots__ = ("kind", "flops", "hbm_bytes", "peak_bytes",
                 "argument_bytes", "output_bytes", "source",
                 "harvested_at")

    def __init__(self, kind: str, flops: float, hbm_bytes: float,
                 peak_bytes: Optional[int] = None,
                 argument_bytes: Optional[int] = None,
                 output_bytes: Optional[int] = None,
                 source: str = "analytic"):
        self.kind = kind
        self.flops = float(flops)
        self.hbm_bytes = float(hbm_bytes)
        self.peak_bytes = peak_bytes
        self.argument_bytes = argument_bytes
        self.output_bytes = output_bytes
        self.source = source
        self.harvested_at = time.time()

    def to_json(self) -> dict:
        return {
            "flops_per_dispatch": self.flops,
            "hbm_bytes_per_dispatch": self.hbm_bytes,
            "peak_bytes": self.peak_bytes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "source": self.source,
        }


class CostBook:
    """Thread-safe registry of per-kind unit costs on one Observability
    handle.  A kind's unit cost is the last one probed (a new shape
    updates it); dispatches counted before their kind's first probe are
    backfilled into the counters when it lands."""

    def __init__(self):
        self._lock = threading.Lock()  # presto-lint: guards(_units, _tried, _pending)
        self._units: Dict[str, KindCost] = {}
        self._tried: set = set()
        self._pending: Dict[str, int] = {}

    def seen(self, kind: str, sig) -> bool:
        with self._lock:
            return (kind, sig) in self._tried

    def mark(self, kind: str, sig) -> None:
        with self._lock:
            self._tried.add((kind, sig))

    def record(self, unit: KindCost) -> int:
        with self._lock:
            self._units[unit.kind] = unit
            return self._pending.pop(unit.kind, 0)

    def defer(self, kind: str, n: int) -> None:
        with self._lock:
            self._pending[kind] = self._pending.get(kind, 0) + n

    def unit(self, kind: str) -> Optional[KindCost]:
        with self._lock:
            return self._units.get(kind)

    def units(self) -> Dict[str, KindCost]:
        with self._lock:
            return dict(self._units)


def book(obs) -> Optional[CostBook]:
    """The handle's cost book (attached at first use); None when the
    handle is disabled."""
    if obs is None or not getattr(obs, "enabled", False):
        return None
    bk = getattr(obs, "_cost_book", None)
    if bk is None:
        bk = obs._cost_book = CostBook()
    return bk


# ----------------------------------------------------------------------
# the analytic counts
# ----------------------------------------------------------------------

def twiddle_count(n: int) -> int:
    """Complex entries of plane_build's twiddle table for an n-point
    FFT (search/build_cuda._twiddle_table: 16^p bases for each pass p
    >= 1 of radix 16, 16, ..., then the remaining radix)."""
    log2n = int(n).bit_length() - 1
    npass = log2n // 4 + (1 if log2n % 4 else 0)
    return sum(16 ** p for p in range(1, npass))


def plane_build_work(nblocks: int, numz: int, n: int, uselen: int,
                     numz_pad: int, numr: int):
    """(bytes, flops) of one plane_build launch: S [nblocks, n/2] and
    the bank [numz, n] (complex64) and the twiddles read once, the
    float32 plane [numz_pad, numr] written once; per block and z row
    the product (6 n), the inverse FFT (5 n log2 n) and |.|^2 of the
    good window (3 uselen)."""
    nbytes = (nblocks * (n // 2) * 8 + numz * n * 8
              + twiddle_count(n) * 8 + numz_pad * numr * 4)
    flops = nblocks * numz * (6 * n + 5 * n * math.log2(n) + 3 * uselen)
    return nbytes, flops


def stage_reduce_work(nrows: int, numr: int, nslabs: int, slab: int,
                      nstages: int, nzmaps: int):
    """(bytes, flops) of one stage_reduce launch: the plane [nrows,
    numr], the start columns and the z maps (nzmaps int32) read once,
    colmax and colz [nslabs, nstages, slab] written once; one add a
    harmonic term and one compare a stage per plane element of the
    slabs."""
    nterms = (1 << (nstages - 1)) - 1
    nbytes = (nrows * numr + nslabs + nzmaps) * 4 \
        + 2 * nslabs * nstages * slab * 4
    flops = nslabs * slab * nrows * (nterms + nstages)
    return nbytes, flops


def reducer_design_bytes(zinds, nrows: int, slab: int, nslabs: int,
                         nstages: int, threads: int, zc: int) -> int:
    """Bytes the stage reducer reads from device memory for these inputs,
    from its geometry (stage_reduce.cu: Geo<NST>, term_cap, term_width;
    ``threads`` a tile and ``zc`` rows a chunk from stage_reduce_info):
    each column's own rows, and per tile and chunk each term's staged
    window rows in 16-byte units, or, in a chunk over a window's row
    capacity, the 32-byte sectors of its direct reads; plus the z maps
    and the outputs.  ``zinds``: the z maps [terms, nrows] (numpy)."""
    terms = [(h, 1 << st) for st in range(1, nstages)
             for h in range(1, 1 << st, 2)]
    caps = [-(-(zc - 1) * h // t) + 2 for h, t in terms]
    wide = [-(-(threads - 1) * h // t) + 1 for h, t in terms]
    per_tile = nrows * threads * 4
    for z0 in range(0, nrows, zc):
        rows = min(zc, nrows - z0)
        n = [int(zi[z0 + rows - 1] - zi[z0]) + 1 for zi in zinds]
        if any(ni > c for ni, c in zip(n, caps)):
            per_tile += sum(rows * (w // 8 + 2) * 32 for w in wide)
        else:
            per_tile += sum(ni * 16 * -(-(w + 3) // 4)
                            for ni, w in zip(n, wide))
    tiles = nslabs * -(-slab // threads)
    return tiles * per_tile + zinds.nbytes + 2 * nslabs * nstages * slab * 4


def _fft_flops(n: int) -> float:
    """A complex n-point FFT's nominal flops."""
    return 5.0 * n * math.log2(max(n, 2))


def _plane_build(nblocks, numz, n, uselen, numz_pad, numr):
    nbytes, flops = plane_build_work(nblocks, numz, n, uselen, numz_pad,
                                     numr)
    return flops, nbytes, nblocks * (n // 2) * 8 + numz * n * 8, \
        numz_pad * numr * 4


def _stage_reduce(nrows, numr, nslabs, slab, nstages, nzmaps):
    nbytes, flops = stage_reduce_work(nrows, numr, nslabs, slab, nstages,
                                      nzmaps)
    out = 2 * nslabs * nstages * slab * 4
    return flops, nbytes, nbytes - out, out


def _rfft_batch(rows, n):
    inb, outb = rows * n * 4, rows * (n // 2) * 8
    return rows * _fft_flops(n) / 2.0, inb + outb, inb, outb


def _accel_search(ntrials, numbins, nblocks, numz, n, uselen, numz_pad,
                  numr, nslabs, slab, nstages, nzmaps):
    pf, pb, _pi, _po = _plane_build(nblocks, numz, n, uselen, numz_pad,
                                    numr)
    rf, rb, _ri, ro = _stage_reduce(numz_pad, numr, nslabs, slab,
                                    nstages, nzmaps)
    # the forward spectra: nblocks FFTs of n/2 points off the spectrum
    ff = nblocks * _fft_flops(n // 2)
    fb = numbins * 8 + nblocks * (n // 2) * 8
    return (ntrials * (pf + rf + ff), ntrials * (pb + rb + fb),
            ntrials * numbins * 8, ntrials * ro)


def _dedisp(numdms, nsub, nchan, numpts, beams=1):
    # subbands: two raw blocks read, one add a channel and sample; the
    # DM fan-out: two subband blocks read, one add a subband, DM and
    # sample, the series written
    sub_b = 2 * nchan * numpts * 4 + nsub * numpts * 4
    dm_b = 2 * nsub * numpts * 4 + numdms * numpts * 4
    flops = nchan * numpts + numdms * nsub * numpts
    return (beams * flops, beams * (sub_b + dm_b),
            beams * 2 * nchan * numpts * 4, beams * numdms * numpts * 4)


def _sp_search(nf, N, nwidths, chunklen, fftlen):
    nchunks = -(-N // chunklen)
    # detrend: a read and a write of the series, a few flops a sample;
    # the matched filter: a forward real FFT a chunk, then a product and
    # an inverse real FFT for each width
    det_f, det_b = 4.0 * nf * N, 3 * nf * N * 4
    mf_f = nf * nchunks * ((nwidths + 1) * _fft_flops(fftlen) / 2.0
                           + nwidths * 6 * (fftlen // 2 + 1))
    mf_b = nf * nchunks * (fftlen * 4 + nwidths * chunklen * 4)
    return det_f + mf_f, det_b + mf_b, nf * N * 4, nf * nchunks * nwidths * 8


#: kind -> formula(**shape) -> (flops, bytes, argument bytes, output bytes)
FORMULAS = {
    "plane_build": _plane_build,
    "stage_reduce": _stage_reduce,
    "rfft_batch": _rfft_batch,
    "accel_search": _accel_search,
    "dedisp": _dedisp,
    "beam_dedisp": _dedisp,
    "sp_search": _sp_search,
}


def analytic(kind: str, **shape) -> KindCost:
    """The unit cost of one dispatch of ``kind`` at ``shape``.  A kind
    with no formula raises KeyError."""
    if kind not in FORMULAS:
        raise KeyError("costmodel: no analytic cost for kind %r (have: %s)"
                       % (kind, ", ".join(sorted(FORMULAS))))
    flops, nbytes, arg_b, out_b = FORMULAS[kind](**shape)
    return KindCost(kind, flops=max(float(flops), 0.0),
                    hbm_bytes=max(float(nbytes), 0.0),
                    argument_bytes=int(arg_b), output_bytes=int(out_b),
                    source="analytic")


def searcher_shape(searcher, ntrials: int,
                   slab: int = 1 << 20) -> Optional[dict]:
    """accel_search's shape for ``ntrials`` spectra through one
    AccelSearch (None for a spectrum too short for one block); its
    plane_build and stage_reduce shapes follow from it."""
    geom = searcher.plane_geom()
    if geom is None:
        return None
    nblocks, _nb_pad, numr = geom
    plan = searcher.slab_plan(numr, slab)
    if plan is None:
        return None
    slab, _k, start_cols = plan
    return dict(ntrials=int(ntrials), numbins=int(searcher.numbins),
                nblocks=int(nblocks), numz=int(searcher.cfg.numz),
                n=int(searcher.kern.fftlen), uselen=int(searcher.cfg.uselen),
                numz_pad=int(searcher.numz_pad), numr=int(numr),
                nslabs=len(start_cols), slab=int(slab),
                nstages=int(searcher.cfg.numharmstages),
                nzmaps=int(searcher._zinds.numel()))


def kernel_shapes(shape: dict):
    """(plane_build shape, stage_reduce shape) of one trial of an
    accel_search shape."""
    pb = {k: shape[k] for k in ("nblocks", "numz", "n", "uselen",
                                "numz_pad", "numr")}
    sr = dict(nrows=shape["numz_pad"], numr=shape["numr"],
              nslabs=shape["nslabs"], slab=shape["slab"],
              nstages=shape["nstages"], nzmaps=shape["nzmaps"])
    return pb, sr


# ----------------------------------------------------------------------
# probing
# ----------------------------------------------------------------------

def probe(obs, kind: str, **shape) -> Optional[KindCost]:
    """Install the unit cost of ``kind`` at ``shape`` on the handle's
    book, once per (kind, shape), under an ``obs:roofline-probe`` span.
    None when the handle is disabled; an unknown kind raises."""
    bk = book(obs)
    if bk is None:
        return None
    sig = tuple(sorted(shape.items()))
    if bk.seen(kind, sig):
        return bk.unit(kind)
    sp = obs.span("obs:roofline-probe", kind=kind)
    try:
        unit = analytic(kind, **shape)
    except BaseException as e:
        sp.finish("error: %s" % type(e).__name__)
        raise
    bk.mark(kind, sig)
    _install(obs, bk, unit)
    sp.finish()
    return unit


def probe_search(obs, searcher, ntrials: int, slab: int = 1 << 20) -> None:
    """Probe accel_search and its two kernels for one search_many call
    of ``ntrials`` spectra through ``searcher`` at column slab ``slab``."""
    if book(obs) is None:
        return
    shape = searcher_shape(searcher, ntrials, slab)
    if shape is None:
        return
    pb, sr = kernel_shapes(shape)
    probe(obs, "accel_search", **shape)
    probe(obs, "plane_build", **pb)
    probe(obs, "stage_reduce", **sr)


def _install(obs, bk: CostBook, unit: KindCost) -> None:
    pending = bk.record(unit)
    if pending:
        _bump_counters(obs, unit.kind, unit, pending)


# ----------------------------------------------------------------------
# the dispatch join
# ----------------------------------------------------------------------

def _bump_counters(obs, kind: str, unit: KindCost, n: int) -> None:
    reg = obs.metrics
    reg.counter("kernel_flops_total",
                "Cumulative modeled FLOPs per dispatch kind",
                ("kind",)).labels(kind=kind).inc(unit.flops * n)
    reg.counter("kernel_hbm_bytes_total",
                "Cumulative modeled device bytes per dispatch kind",
                ("kind",)).labels(kind=kind).inc(unit.hbm_bytes * n)


def attribute_dispatch(obs, kind: str, n: int = 1) -> None:
    """Join a (batched) dispatch with its kind's unit cost: the
    cumulative counters, and flops/hbm_bytes attributes on the current
    span.  A dispatch counted before its kind's first probe is
    backfilled into the counters when the unit lands."""
    bk = book(obs)
    if bk is None:
        return
    unit = bk.unit(kind)
    if unit is None:
        bk.defer(kind, n)
        return
    _bump_counters(obs, kind, unit, n)
    sp = obs.tracer.current()
    if sp is not None:
        sp.set_attr("flops", sp.attrs.get("flops", 0.0) + unit.flops * n)
        sp.set_attr("hbm_bytes",
                    sp.attrs.get("hbm_bytes", 0.0) + unit.hbm_bytes * n)


# ----------------------------------------------------------------------
# snapshot / export
# ----------------------------------------------------------------------

def _counter_by_label(obs, name: str, label: str) -> Dict[str, float]:
    fam = obs.metrics.get(name)
    if fam is None:
        return {}
    out: Dict[str, float] = {}
    for labels, child in fam.children():
        key = dict(labels).get(label, "")
        out[key] = out.get(key, 0.0) + child.value
    return out


def snapshot(obs) -> dict:
    """The cost book joined with the live dispatch counters: the
    ``kernel_costs`` block of serve /metrics.  ``{}`` when nothing was
    probed (disabled handles included)."""
    bk = book(obs)
    if bk is None:
        return {}
    units = bk.units()
    if not units:
        return {}
    dispatches = _counter_by_label(obs, "jax_dispatches_total", "kind")
    flops_tot = _counter_by_label(obs, "kernel_flops_total", "kind")
    bytes_tot = _counter_by_label(obs, "kernel_hbm_bytes_total", "kind")
    kinds = {}
    for kind in sorted(set(units) | set(dispatches)):
        unit = units.get(kind)
        ent: dict = {"dispatches": int(dispatches.get(kind, 0))}
        if unit is not None:
            ent.update(unit.to_json())
            ent["flops_total"] = flops_tot.get(kind, 0.0)
            ent["hbm_bytes_total"] = bytes_tot.get(kind, 0.0)
            if unit.hbm_bytes > 0:
                ent["intensity"] = unit.flops / unit.hbm_bytes
        kinds[kind] = ent
    return {"schema": COSTS_SCHEMA, "kinds": kinds, "unavailable": {}}


def write_costs(obs, dirpath: str, db_path: Optional[str] = None
                ) -> Optional[str]:
    """Export the book as ``<dirpath>/kernel_costs.json`` (atomic; no-op
    when nothing was probed).  The card's peaks ride along when the
    roofline microbenchmark has already measured them for this
    fingerprint (the export runs no device work)."""
    snap = snapshot(obs)
    if not snap:
        return None
    from presto_tpu_torch.obs import roofline
    snap["peaks"] = roofline.device_peaks(obs=obs, db_path=db_path,
                                          measure=False)
    import json
    from presto_tpu_torch.io.atomic import atomic_write_text
    path = os.path.join(dirpath, "kernel_costs.json")
    atomic_write_text(path, json.dumps(snap, indent=1,
                                       sort_keys=True) + "\n")
    return path


def load_costs(dirpath: str) -> Optional[dict]:
    """Defensive read of a workdir's kernel_costs.json (None on absence,
    corruption, or a stale schema)."""
    import json
    try:
        with open(os.path.join(dirpath, "kernel_costs.json")) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(raw, dict) or raw.get("schema") != COSTS_SCHEMA:
        return None
    return raw
