"""perf_gate: the exit-1 perf-regression gate over the port's perf ledger.

Counterpart of ``tools/perf_gate.py``.  The ledger (obs/perfledger.py)
is the durable time series of measured episodes; this CLI judges the
newest episode against the rolling baseline — the median of the
previous ``--window`` same-fingerprint, same-workload episodes per
metric — and exits 1 when any metric's direction-adjusted delta
exceeds ``max(rel_tol * baseline, mad_k * noise)`` (noise = the wider
of the baseline's and the episode's MAD bands).

Modes:

  --smoke              judge the ledger's own newest episode (pure
                       file arithmetic, no device work)
  --measure            run the miniature smoke workload on ``--device``
                       (default cuda; no card raises), append the
                       episode, then gate it
  --inject-slowdown F  gate a synthetic episode degraded by factor F
                       instead of a real one — the deliberate-slowdown
                       proof that the gate trips (must exit 1)

The smoke's statistic.  On the CPU each sample is the host clock's best
of the calls that span SMOKE_SAMPLE_S (the JAX tool's statistic, kept).
On a card the samples are device time: each is the CUDA-event span of
SMOKE_REPS calls of the search's device steps (profile_accel.Stages.run:
forward spectra, plane_build, stage_reduce, collect and compaction on
the card) or of the dedispersion scan, queued behind a spin kernel long
enough that the host has queued every call before the first one starts
(the head start doubles until it is; _device_samples), so the span is
the card's work alone.  The host clock's samples of the whole calls
stay in the episode's meta (``host_samples_s``), not gated: on the
card machine's shared host their MAD reached 21% of the median within
an episode (PERF.md §6), and 4 x MAD had hidden a 2x injection.

The default ledger is obs/perfledger.default_ledger_path(), the port's
cache directory beside its tuning DB, outside any checkout; pass
``--ledger`` for any other file.  A corrupted or stale-schema ledger
exits 1 with the load error spelled out.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from presto_tpu_torch.obs import perfledger

#: the miniature measurement contract (--measure), the JAX package's
#: tools/perf_gate.py SMOKE: the same shapes every run so episodes
#: compare
SMOKE = {"accel_numbins": 1 << 15, "accel_zmax": 20,
         "accel_numharm": 2, "dedisp_numchan": 64, "dedisp_nsub": 16,
         "dedisp_numdms": 32, "dedisp_nsamples": 1 << 16}

#: the smoke search's observation length (s) and threshold
SMOKE_T, SMOKE_SIGMA = 100.0, 4.0

#: dedispersion blocks of the smoke scan (the first two prime the carry)
SMOKE_NBLOCKS = 4

#: the least seconds one sample spans: a call shorter than this is
#: repeated back to back and the sample is the best of those calls.  On
#: the card the smoke calls are a few ms of mostly host work, and the
#: host's cores are shared: a call's median drifts from one episode to
#: the next far more than its best does
SMOKE_SAMPLE_S = 0.2

#: on a card: calls a device sample spans (the accel steps, the
#: dedispersion scan), few enough that the host queues them all, about
#: 250 launches, inside the head start
SMOKE_REPS = {"accel": 8, "dedisp": 2}

#: on a card: the first head start (ms of a spin kernel before a
#: sample's calls) and the doublings allowed before a sample gives up
SMOKE_HEAD_MS, SMOKE_HEAD_TRIES = 20.0, 6


def smoke_pairs() -> np.ndarray:
    """The smoke search's spectrum: seeded noise and one tone."""
    rng = np.random.default_rng(99)
    numbins = SMOKE["accel_numbins"]
    pairs = np.stack([rng.normal(size=numbins),
                      rng.normal(size=numbins)], -1).astype(np.float32)
    pairs[1234] = (150.0, 0.0)
    return pairs


def smoke_searcher(device):
    from presto_tpu_torch.search.accel import AccelConfig, AccelSearch
    return AccelSearch(AccelConfig(zmax=SMOKE["accel_zmax"],
                                   numharm=SMOKE["accel_numharm"],
                                   sigma=SMOKE_SIGMA),
                       T=SMOKE_T, numbins=SMOKE["accel_numbins"],
                       device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fingerprint(dev: torch.device) -> str:
    """The tuning DB's card fingerprint, or the CPU's when the episode
    was measured on the CPU (a CPU episode never gates a card run)."""
    from presto_tpu_torch.tune.db import device_fingerprint, fingerprint_key
    fp = device_fingerprint()
    if dev.type != "cuda":
        fp.update(platform="cpu", device_kind="cpu", capability="none",
                  device_count="0")
    return fingerprint_key(fp)


def _samples(fn, k: int, dev: torch.device):
    """k steady samples of fn's seconds a call, each call ended with the
    device synchronized: one cold call, one timed warm call that sets
    the calls a sample (enough to span SMOKE_SAMPLE_S), then k samples,
    each the best of that many calls.  Returns (samples, calls a
    sample)."""
    def timed():
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return time.perf_counter() - t0
    fn()
    _sync(dev)
    calls = max(1, math.ceil(SMOKE_SAMPLE_S / max(timed(), 1e-9)))
    return [min(timed() for _ in range(calls)) for _ in range(k)], calls


class EventTimer:
    """CUDA-event spans of calls queued behind a spin kernel on ``dev``
    (torch.cuda._sleep), calibrated once: the spin's cycles a ms."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        with torch.cuda.device(dev):
            start, end = self._events()
            torch.cuda._sleep(1 << 22)        # clocks up
            start.record()
            torch.cuda._sleep(1 << 22)
            end.record()
            end.synchronize()
        self.cycles_per_ms = (1 << 22) / max(start.elapsed_time(end), 1e-6)

    @staticmethod
    def _events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def span(self, fn, reps: int, head_ms: float):
        """(ms a call, ahead): ``reps`` calls of fn queued behind a
        ``head_ms`` spin, timed from the first call's start to the last
        one's end; ahead is whether the host had queued every call
        before the spin ended (else the span holds the host's time)."""
        with torch.cuda.device(self.dev):
            start, end = self._events()
            torch.cuda._sleep(int(head_ms * self.cycles_per_ms))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            ahead = not start.query()
            end.synchronize()
        return start.elapsed_time(end) / reps, ahead


def _device_samples(fn, k: int, timer, reps: int,
                    head_ms: float = SMOKE_HEAD_MS,
                    tries: int = SMOKE_HEAD_TRIES):
    """k device samples of fn's seconds a call (timer.span over ``reps``
    queued calls each, after one warm span).  A span whose calls the
    host had not all queued before the head start ended is taken again
    with the head start doubled, at most ``tries`` times a sample (then
    this raises).  Returns (samples, head start ms)."""
    def one():
        nonlocal head_ms
        for _ in range(tries):
            ms, ahead = timer.span(fn, reps, head_ms)
            if ahead:
                return ms * 1e-3
            head_ms *= 2.0
        raise RuntimeError("perf_gate: the host did not queue %d calls "
                           "within a %.0f ms head start" % (reps, head_ms))
    one()
    return [one() for _ in range(k)], head_ms


def _dedisp_case(dev: torch.device):
    """The smoke's dedispersion scan on ``dev``: (fn, numdms); the
    delays on the device, so a call copies nothing from the host."""
    from presto_tpu_torch.ops.dedispersion import dedisperse_scan
    numchan, nsub, numdms = (SMOKE["dedisp_numchan"],
                             SMOKE["dedisp_nsub"],
                             SMOKE["dedisp_numdms"])
    numpts = SMOKE["dedisp_nsamples"] // 2
    delays = {"chan": torch.as_tensor(np.arange(numchan) % 8,
                                      dtype=torch.int64, device=dev),
              "dm": torch.as_tensor(
                  (np.arange(numdms)[:, None]
                   * np.linspace(0, 4, nsub)[None, :]).astype(np.int32),
                  dtype=torch.int64, device=dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    blocks = torch.randn((SMOKE_NBLOCKS, numchan, numpts), generator=gen,
                         device=dev)
    return (lambda: dedisperse_scan(blocks, delays, nsub)[:, ::1024].sum(),
            numdms)


def measure_smoke(k: int = 5, device="cuda") -> dict:
    """The miniature episode: a small accelsearch and a small
    dedispersion scan, k steady samples each; median-of-k + MAD via
    perfledger.metric_from_samples, the raw samples in the meta.  On
    the CPU the samples are the host clock's (_samples: warm-up
    excluded, each sample the best of the calls that span
    SMOKE_SAMPLE_S); on a card they are device time (_device_samples
    over the search's device steps and the scan, see the module
    docstring), with the host clock's samples of the whole calls
    beside them in the meta."""
    from presto_tpu_torch.apps.profile_accel import Stages
    from presto_tpu_torch.search.accel import resolve_device
    dev = resolve_device(device)
    s = smoke_searcher(dev)
    pairs = torch.as_tensor(smoke_pairs(), device=dev)
    cells = s.cfg.numz * int(s.rhi - s.rlo) * 2
    dedisp, numdms = _dedisp_case(dev)
    host = {}
    calls = {}
    host["accel"], calls["accel"] = _samples(lambda: s.search(pairs), k,
                                             dev)
    host["dedisp"], calls["dedisp"] = _samples(lambda: float(dedisp()), k,
                                               dev)
    meta = {"smoke": SMOKE, "k": k, "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "calls_per_sample": calls}
    if dev.type == "cuda":
        timer = EventTimer(dev)
        stages = Stages(s, pairs)
        samples, head = {}, {}
        samples["accel"], head["accel"] = _device_samples(
            lambda: stages.run(pairs), k, timer, SMOKE_REPS["accel"])
        samples["dedisp"], head["dedisp"] = _device_samples(
            dedisp, k, timer, SMOKE_REPS["dedisp"])
        meta.update(statistic="device", samples_s=samples,
                    host_samples_s=host, reps_per_sample=SMOKE_REPS,
                    head_start_ms=head)
    else:
        samples = host
        meta.update(statistic="host", samples_s=samples)

    return perfledger.make_episode({
        "smoke_accel_cells_per_sec": perfledger.metric_from_samples(
            [cells / t for t in samples["accel"]], "cells/s", "higher"),
        "smoke_dedisp_trials_per_sec": perfledger.metric_from_samples(
            [numdms / t for t in samples["dedisp"]], "trials/s",
            "higher"),
    }, fingerprint=_fingerprint(dev), workload="smoke", source="perf-gate",
        meta=meta)


def render(verdict: dict, episode: dict, file=None) -> None:
    out = file or sys.stderr

    def w(s=""):
        print(s, file=out)
    w("perf_gate: episode %s (%s, %s)"
      % (episode.get("run_id"), episode.get("workload"),
         episode.get("source")))
    for row in verdict["rows"]:
        if row["status"] == "no-baseline":
            w("  %-28s %12.4g %-10s NO BASELINE (seeding)"
              % (row["metric"], row["value"], row["unit"]))
            continue
        w("  %-28s %12.4g vs %12.4g %-10s %s"
          % (row["metric"], row["value"], row["baseline"],
             row["unit"],
             "OK (margin %.3g)" % (row["threshold"]
                                   - row["delta_worse"])
             if row["status"] == "ok" else
             "REGRESSION (worse by %.4g > threshold %.4g)"
             % (row["delta_worse"], row["threshold"])))
    w("perf_gate: %s" % ("PASS" if verdict["ok"] else "FAIL"))


def build_parser():
    p = argparse.ArgumentParser(
        prog="perf_gate",
        description="Exit-1 perf-regression gate over the port's "
                    "fingerprint-keyed perf ledger")
    p.add_argument("--ledger", default=None,
                   help="ledger path (default: "
                        "obs/perfledger.default_ledger_path(), outside "
                        "the checkout)")
    p.add_argument("--window", type=int, default=5,
                   help="rolling-baseline depth (default 5)")
    p.add_argument("--rel-tol", type=float, default=0.15,
                   help="relative tolerance floor (default 0.15)")
    p.add_argument("--mad-k", type=float, default=4.0,
                   help="noise-band multiplier (default 4.0)")
    p.add_argument("--smoke", action="store_true",
                   help="judge the ledger's newest episode as-is "
                        "(no device work)")
    p.add_argument("--measure", action="store_true",
                   help="run the miniature smoke workload, append "
                        "the episode, then gate it")
    p.add_argument("--device", default="cuda",
                   help="device --measure runs on (default cuda; "
                        "without a card it raises)")
    p.add_argument("--inject-slowdown", type=float, default=None,
                   metavar="F",
                   help="gate a synthetic episode degraded by factor "
                        "F (the gate must exit 1 — the deliberate-"
                        "slowdown proof)")
    p.add_argument("--json", action="store_true",
                   help="emit the verdict as JSON on stdout")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    path = args.ledger or perfledger.default_ledger_path()
    led = perfledger.PerfLedger.load(path)
    if led.load_error is not None:
        print("perf_gate: ledger %s unusable (%s)"
              % (path, led.load_error), file=sys.stderr)
        return 1

    episode = None
    if args.measure:
        episode = measure_smoke(device=args.device)
        led.append(episode)
        led.save(path)
    elif led.episodes:
        episode = led.episodes[-1]
    if episode is None:
        print("perf_gate: ledger %s has no episodes" % path,
              file=sys.stderr)
        return 1

    if args.inject_slowdown is not None:
        episode = perfledger.inject_slowdown(episode,
                                             args.inject_slowdown)

    history = led.select(fingerprint=episode.get("fingerprint"),
                         workload=episode.get("workload"))
    verdict = perfledger.gate(episode, history, window=args.window,
                              rel_tol=args.rel_tol,
                              mad_k=args.mad_k)
    if args.json:
        print(json.dumps({"ledger": os.path.abspath(path),
                          "episode": episode, "verdict": verdict},
                         indent=1, sort_keys=True))
    render(verdict, episode)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
