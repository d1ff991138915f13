"""One card's share of the target-scale plan: 512 DM trials x 2^23.

Counterpart of ``tools/target_scale_chip.py``.  Device 0's rows of the
4096-DM fan-out (apps/target_scale.dm_slice: the 512 trials around the
pulsar's DM) on the card:

  * equality: the two blocks streamed after the two priming blocks, from
    host blocks (target_scale.make_block), through the subband pass and
    the 512-DM fan-out on the card, each bit-equal to the float32 NumPy
    referee that adds in the same order (target_scale.subbands_np,
    dedisp_rows_np);
  * throughput: the whole stream (nsamp / numpts blocks after the two
    priming ones) of blocks synthesized on the card (a seeded
    torch.Generator), all 512 DM rows in one fan-out a block, in
    CUDA-event ms, with the peak of torch.cuda.max_memory_allocated.
    The JAX tool split the share into 128-DM programs because XLA
    planned the whole scan's buffers at compile time; one 512-DM fan-out
    here holds a 0.5 GB gather index and 0.3 GB of output a block, so
    the share runs in one batch.  Also one fresh host block uploaded
    (pageable) and dedispersed, host clock, synchronized;
  * the search of the pulsar-DM spectrum at the target length (the
    probe series of target_scale.probe_series, 2^22 bins, zmax 200,
    numharm 8) on the card, the pulsar recovered on top.

Usage: python -m presto_tpu_torch.apps.target_scale_chip [--json FILE]
       [-device cuda] [--numdms N ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from presto_tpu_torch.apps import target_scale as ts
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.search import accel

#: blocks streamed for the equality check after the two priming blocks
EQUALITY_BLOCKS = 2


class Equality(ts.Consumer):
    """The streamed blocks at the share's DM rows on the card against the
    float32 NumPy referee (tools/target_scale_chip.py:71-111)."""

    def __init__(self, share: ts.Share, chan_d, dm_d, device,
                 nblocks: int = EQUALITY_BLOCKS):
        self.share = share
        self.blocks = 2 + nblocks
        self.dev = accel.resolve_device(device)
        self.chan_d, self.dm_d = chan_d, dm_d
        self.chan = torch.as_tensor(chan_d.astype(np.int64), device=self.dev)
        self.dm = torch.as_tensor(dm_d.astype(np.int64), device=self.dev)
        self.equal = []
        self.max_diff = 0.0
        self.last_block = None
        self.t = 0.0
        self._raw = self._sub = self._raw_np = self._sub_np = None

    def feed(self, i, block):
        t0 = time.perf_counter()
        cur = torch.as_tensor(block, device=self.dev)
        if i >= 1:
            sub = dd.dedisp_subbands_block(self._raw, cur, self.chan,
                                           self.share.nsub)
            sub_np = ts.subbands_np(self.chan_d, self.share.nsub,
                                    self._raw_np, block)
            if i >= 2:
                series = dd.float_dedisp_many_block(self._sub, sub,
                                                    self.dm).cpu().numpy()
                ref = ts.dedisp_rows_np(self.dm_d, self._sub_np, sub_np)
                self.equal.append(bool(np.array_equal(series, ref)))
                self.max_diff = max(self.max_diff,
                                    float(np.abs(series - ref).max()))
            self._sub, self._sub_np = sub, sub_np
        self._raw, self._raw_np = cur, block
        self.last_block = block
        self.t += time.perf_counter() - t0

    def result(self) -> dict:
        return {"bit_equal_vs_numpy": bool(self.equal) and all(self.equal),
                "equality_blocks": len(self.equal),
                "equality_max_diff": self.max_diff,
                "equality_sec": self.t}


def throughput(share: ts.Share, chan_d, dm_d, device) -> dict:
    """The whole stream of card-made blocks at the share's DM rows, one
    fan-out a block: device ms (CUDA events on a card, host ms elsewhere)
    after a two-block warm-up, and the peak memory."""
    dev = accel.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(share.seed)
    chan = torch.as_tensor(chan_d.astype(np.int64), device=dev)
    dm = torch.as_tensor(dm_d.astype(np.int64), device=dev)
    shape = (share.numchan, share.numpts)

    def stream(nsteps):
        prev_raw = torch.randn(shape, generator=gen, device=dev)
        raw = torch.randn(shape, generator=gen, device=dev)
        prev_sub = dd.dedisp_subbands_block(prev_raw, raw, chan, share.nsub)
        chk = torch.zeros((), device=dev)
        for _ in range(nsteps):
            cur = torch.randn(shape, generator=gen, device=dev)
            sub = dd.dedisp_subbands_block(raw, cur, chan, share.nsub)
            series = dd.float_dedisp_many_block(prev_sub, sub, dm)
            chk += series[:, ::4096].sum()
            raw, prev_sub = cur, sub
        return chk

    stream(2)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    nsteps = share.nblocks - 2
    with ts.DeviceClock(dev) as c:
        chk = stream(nsteps)
    per = c.ms / nsteps / 1e3
    trials_per_sec = dm_d.shape[0] / (per * (share.nsamp / share.numpts))
    return {
        "dm_batch": int(dm_d.shape[0]),
        "stream_blocks": nsteps,
        "stream_ms_device": c.ms if c.cuda else None,
        "stream_ms_host": None if c.cuda else c.ms,
        "sec_per_block": per,
        "dm_trials_per_sec": trials_per_sec,
        "projection_8_cards": {
            "dm_trials_per_sec": 8 * trials_per_sec,
            "plan_sec": share.numdms / (8 * trials_per_sec)},
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "checksum_finite": bool(torch.isfinite(chk)),
    }


def upload_block(share: ts.Share, block, raw, prev_sub, chan_d, dm_d,
                 device) -> float:
    """Host seconds of one fresh host block uploaded (pageable) and
    dedispersed at the share's rows, synchronized."""
    dev = accel.resolve_device(device)
    chan = torch.as_tensor(chan_d.astype(np.int64), device=dev)
    dm = torch.as_tensor(dm_d.astype(np.int64), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cur = torch.as_tensor(block).to(dev)
    sub = dd.dedisp_subbands_block(raw, cur, chan, share.nsub)
    series = dd.float_dedisp_many_block(prev_sub, sub, dm)
    float(series[0, 0])
    return time.perf_counter() - t0


def probe_search(share: ts.Share, series: np.ndarray, device) -> dict:
    """The pulsar-DM spectrum at the target length searched on the
    device: a first call, then the timed one; the pulsar on top."""
    dev = accel.resolve_device(device)
    pairs = torch.as_tensor(ts.probe_pairs(series), device=dev)
    s = accel.AccelSearch(ts.search_config(share), T=share.T,
                          numbins=pairs.shape[0], device=dev)
    t0 = time.perf_counter()
    s.search(pairs)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    cands = accel.remove_duplicates(s.search(pairs))
    sec = time.perf_counter() - t0
    top = cands[0] if cands else None
    ok = (top is not None and ts.harmonic_of(top.freq(share.T), share.psr_f0)
          and top.sigma > 50)
    return {"accelsearch_sec": sec, "accelsearch_warmup_sec": warm,
            "numbins": int(pairs.shape[0]),
            "plane": [s.numz_pad, s.plane_geom()[2]],
            "pulsar_recovered": None if top is None else {
                "f": top.freq(share.T), "sigma": top.sigma,
                "numharm": top.numharm, "n_cands": len(cands)},
            "pulsar_ok": bool(ok)}


def run(share: ts.Share = ts.SHARE, device="cuda",
        equality: Optional[Equality] = None,
        series: Optional[np.ndarray] = None) -> dict:
    """The share on the card (see the module docstring).  ``equality``:
    an Equality already fed by a pass of host blocks (else a pass of the
    first blocks is made here); ``series``: the pulsar-DM series (else
    target_scale.probe_series)."""
    dev = accel.resolve_device(device)
    t_all = time.perf_counter()
    chan_d, dm_full, dms = ts.delays(share)
    lo, hi = ts.dm_slice(share, dms)
    dm_d = np.ascontiguousarray(dm_full[lo:hi])
    art = {"device": ts.card_line(dev), "torch_device": str(dev),
           "dms_per_device": share.dms_per_dev, "dm_slice": [lo, hi]}
    if equality is None:
        equality = Equality(share, chan_d, dm_d, dev)
        ts.stream_pass(share, [equality])
    art.update(equality.result())
    art["throughput"] = throughput(share, chan_d, dm_d, dev)
    art["sec_per_block_incl_upload"] = upload_block(
        share, equality.last_block, equality._raw, equality._sub, chan_d,
        dm_d, dev)
    if series is None:
        series, art["probe_prep_host_sec"] = ts.probe_series(share)
    art["search"] = probe_search(share, series, dev)
    art["total_sec"] = time.perf_counter() - t_all
    art["ok"] = bool(art["bit_equal_vs_numpy"]
                     and art["throughput"]["checksum_finite"]
                     and art["search"]["pulsar_ok"])
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="target_scale_chip")
    ts.add_common_args(ap)
    args = ap.parse_args(argv)
    art = run(ts.share_from_args(args), device=args.device)
    ts.write_json(args.json, art)
    print(json.dumps(art, indent=1, default=float))
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
