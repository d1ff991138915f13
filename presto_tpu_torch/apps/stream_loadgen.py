"""stream_loadgen: synthetic live-feed generator for the port's
presto-stream.

Counterpart of ``tools/stream_loadgen.py``, with its modes and flags and
``--device``.  It builds a noise filterbank with dispersed single pulses
planted at KNOWN times and DM (models/inject with a sub-observation spin
frequency, so each "rotation" is one pulse; the same bytes and truth as
the JAX tool's feed), streams it into a RingBlockSource over a real TCP
socket — paced at the sample rate (optionally speeded) or as one burst —
and verifies the acceptance contract of the streaming subsystem:

  * every injected pulse triggered EXACTLY once (matched by
    top-of-band arrival time and DM trial),
  * zero unaccounted drops: spectra in == spectra delivered +
    quarantined (ring drops / stalls are explicit ledger entries),
  * p50/p99 sample-arrival -> trigger-emitted latency read from the
    `stream_latency_seconds` histogram labelled (stream, beam="-").

  python -m presto_tpu_torch.apps.stream_loadgen --mode paced --speed 8

With --beams N it instead verifies the beam multiplexer
(stream/beams.py): per-beam trigger sets byte-equal to N independent
presto-stream instances with the veto off, device-chain dispatches
per tick O(1) in beam count, coincidence-veto precision/recall on
correlated bursts vs single-beam pulses, and trigger-latency p99
under an obs/slo.py objective as beams scale.

The streams run on ``--device`` (default cuda; without a card it raises,
nothing falls back).  ``--out`` writes the verdict JSON to the path it
names and nowhere else.  Also importable: make_feed / run_trial /
run_beam_trial.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import socket
import sys
import tempfile
import threading
import time

import numpy as np


def _pulse_period(dm: float, freqs: np.ndarray, dt: float,
                  width_s: float):
    """(sweep, period): the pulse's dispersion sweep across the band and
    the injector's "rotation" period.  InjectParams profiles live on a
    4096-bin phase grid, so the rotation must stay short enough that one
    phase bin <= one sample — each pulse goes into a local window shorter
    than that period (one occurrence per channel), never as a single
    whole-observation rotation (a 3 ms pulse on a 2-minute rotation would
    smear over ~60 ms grid bins)."""
    from presto_tpu_torch.ops.dedispersion import delay_from_dm
    sweep = float(delay_from_dm(dm, freqs.min())
                  - delay_from_dm(dm, freqs.max()))
    return sweep, max(4096 * dt, (sweep + 12 * width_s + 0.4) * 1.05)


def _inject_window(data, t0, amp, f, dm, width_s, dt, freqs, sweep):
    """One dispersed pulse at top-of-band time t0 into data [N, nchan]
    (in place, over the pulse's own window)."""
    from presto_tpu_torch.models.inject import InjectParams, inject_pulsar
    N = len(data)
    lo = max(int((t0 - 0.1) / dt), 0)
    hi = min(int((t0 + sweep + 6 * width_s + 0.2) / dt), N)
    p = InjectParams(f=f, dm=dm, amp=amp, width=width_s * f,
                     phase0=(-t0 * f) % 1.0)
    data[lo:hi] = inject_pulsar(data[lo:hi], dt, freqs, p,
                                start_sec=lo * dt)
    return p


def _header(nchan, dt, fch1, foff, N):
    from presto_tpu_torch.io import sigproc
    return sigproc.FilterbankHeader(
        nbits=32, nchans=nchan, nifs=1, tsamp=dt, fch1=fch1,
        foff=foff, tstart=60000.0, source_name="loadgen", N=N)


def make_feed(seed: int = 0, nchan: int = 64, dt: float = 5e-4,
              seconds: float = 40.0, npulses: int = 6,
              dm: float = 45.0, amp: float = 3.0,
              width_s: float = 0.003, fch1: float = 400.0,
              foff: float = -1.0, noise_sigma: float = 2.0,
              t_margin: float = 4.0):
    """(header, wire_bytes, pulse_times): a SIGPROC byte stream with
    `npulses` dispersed single pulses at known top-of-band arrival
    times, evenly spread with jitter, away from the stream edges.

    Truth comes from models/inject.truth_record at injection time —
    the same schema injectpsr writes to its `_injected.json` sidecar
    — instead of being re-derived after the fact."""
    from presto_tpu_torch.io import sigproc
    from presto_tpu_torch.models.inject import truth_record

    rng = np.random.default_rng(seed)
    N = int(seconds / dt)
    data = rng.normal(10.0, noise_sigma, (N, nchan)).astype(np.float32)
    freqs = (fch1 + foff * (nchan - 1)) + np.arange(nchan) * abs(foff)
    span = (seconds - 2 * t_margin) / max(npulses, 1)
    times = [t_margin + span * (i + 0.5)
             + float(rng.uniform(-0.2, 0.2) * span)
             for i in range(npulses)]
    sweep, period = _pulse_period(dm, freqs, dt, width_s)
    f = 1.0 / period
    truth = [truth_record(_inject_window(data, t0, amp, f, dm, width_s,
                                         dt, freqs, sweep), t=t0)
             for t0 in times]
    hdr = _header(nchan, dt, fch1, foff, N)
    buf = io.BytesIO()
    sigproc.write_filterbank_header(hdr, buf)
    arr = data[:, ::-1] if foff < 0 else data
    buf.write(sigproc.pack_bits(np.ascontiguousarray(arr).ravel(),
                                32).tobytes())
    return hdr, buf.getvalue(), [r["t"] for r in truth]


def send_wire(address, wire: bytes, hdr, mode: str = "burst",
              speed: float = 8.0, chunk_spectra: int = 512,
              faults=None) -> None:
    """Push the byte stream into a listening SocketProducer.  paced:
    real-time at `speed`x (chunk cadence = chunk_spectra * tsamp /
    speed); burst: as fast as TCP accepts."""
    s = socket.create_connection(address)
    try:
        bps = hdr.bytes_per_spectrum
        # header first, whole: pacing applies to samples, not metadata
        hdrlen = len(wire) - hdr.N * bps
        s.sendall(wire[:hdrlen])
        pos = hdrlen
        step = chunk_spectra * bps
        tick = hdr.tsamp * chunk_spectra / max(speed, 1e-6)
        sent = 0
        while pos < len(wire):
            if faults is not None:
                faults(sent)
            s.sendall(wire[pos:pos + step])
            pos += step
            sent += chunk_spectra
            if mode == "paced":
                time.sleep(tick)
    finally:
        s.close()


def run_trial(workdir: str, mode: str = "paced", speed: float = 8.0,
              seed: int = 0, seconds: float = 40.0, npulses: int = 6,
              nchan: int = 64, dt: float = 5e-4, dm: float = 45.0,
              numdms: int = 9, lodm: float = 25.0, dmstep: float = 5.0,
              nsub: int = 32, threshold: float = 7.0,
              blocklen: int = 4096, ring: int = 64,
              match_tol_s: float = 0.15, faults=None,
              stall_timeout_s=None, amp: float = 3.0,
              device="cuda") -> dict:
    """One full loadgen run against an in-process service, the stream
    on ``device``; returns the verdict dict (ok/pulse accounting/latency
    percentiles)."""
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import (RingBlockSource, SocketProducer,
                                         StreamConfig, StreamService)

    hdr, wire, truth = make_feed(seed=seed, nchan=nchan, dt=dt,
                                 seconds=seconds, npulses=npulses,
                                 dm=dm, amp=amp)
    cfg = StreamConfig(lodm=lodm, dmstep=dmstep, numdms=numdms,
                       nsub=nsub, threshold=threshold,
                       blocklen=blocklen, ring_capacity=ring,
                       stall_timeout_s=stall_timeout_s)
    service = SearchService(os.path.join(workdir, "serve"),
                            heartbeat_s=1.0, device=device)
    service.start()
    source = RingBlockSource(capacity=cfg.ring_capacity,
                             policy=cfg.ring_policy,
                             stall_timeout_s=cfg.stall_timeout_s)
    producer = SocketProducer(source).start()
    sender = threading.Thread(
        target=send_wire, args=(producer.address, wire, hdr),
        kwargs=dict(mode=mode, speed=speed, faults=faults),
        daemon=True)
    t0 = time.time()
    sender.start()
    stream = StreamService(service, source, cfg, device=device).start()
    budget = seconds / max(speed, 1e-6) * 3.0 + 120.0
    finished = stream.wait(budget)
    wall = time.time() - t0
    trigs = [e for e in service.events.tail(100000)
             if e["kind"] == "trigger"]
    heartbeats = service.events.counts().get("heartbeat", 0)

    # exactly-once matching
    matches = {i: [] for i in range(len(truth))}
    unmatched = []
    for ev in trigs:
        hit = [i for i, t in enumerate(truth)
               if abs(ev["time"] - t) <= match_tol_s]
        if hit:
            matches[hit[0]].append(ev)
        else:
            unmatched.append(ev)
    missed = [round(truth[i], 3) for i, evs in matches.items()
              if not evs]
    dupes = [round(truth[i], 3) for i, evs in matches.items()
             if len(evs) > 1]
    dm_ok = all(abs(evs[0]["dm"] - dm) <= dmstep
                for evs in matches.values() if evs)

    # drop accounting: every spectrum either reached the search or is
    # a quarantined ledger entry
    stats = source.stats()
    quality = source.quality.to_json() if source.quality else {}
    accounted = (stats["pushed_spectra"] >= hdr.N
                 and stats["dropped_spectra"]
                 <= quality.get("bad_spectra", 0))

    lat = stream.summary().get("latency", {})
    hist = service.obs.metrics.get("stream_latency_seconds")
    count = (hist.labels(stream=stream.stream_id, beam="-").count
             if hist is not None else 0)
    ok = (finished and stream.failed is None and not missed
          and not dupes and not unmatched and dm_ok and accounted
          and stats["dropped_blocks"] == 0)
    verdict = {
        "ok": bool(ok),
        "mode": mode,
        "speed": speed,
        "seconds": seconds,
        "spectra": int(hdr.N),
        "nchan": nchan,
        "numdms": numdms,
        "device": str(stream.device),
        "pulses_injected": len(truth),
        "pulse_times": [round(t, 3) for t in truth],
        "triggers": len(trigs),
        "missed": missed,
        "duplicated": dupes,
        "unmatched": [round(e["time"], 3) for e in unmatched],
        "dm_ok": dm_ok,
        "finished": bool(finished),
        "wall_s": round(wall, 2),
        "heartbeats": int(heartbeats),
        "source": stats,
        "quality": quality.get("counts", {}),
        "latency_s": {k: round(v, 4) for k, v in lat.items()},
        "latency_samples": int(count),
    }
    if stream.failed is not None:
        verdict["error"] = "%s: %s" % (type(stream.failed).__name__,
                                       stream.failed)
    service.stop()
    producer.close()
    return verdict


# ----------------------------------------------------------------------
# beam-multiplexer verdict mode (--beams N)
# ----------------------------------------------------------------------

def make_beam_feeds(nbeams: int, pulse_beams=(0,), seed: int = 0,
                    nchan: int = 32, dt: float = 5e-4,
                    seconds: float = 16.0, npulses: int = 2,
                    nrfi: int = 2, dm: float = 45.0, amp: float = 3.0,
                    rfi_amp: float = 3.5, width_s: float = 0.003,
                    fch1: float = 400.0, foff: float = -1.0,
                    noise_sigma: float = 2.0, t_margin: float = 3.0):
    """(header, [per-beam spectra], t_signal, t_rfi): independent
    noise per beam, `npulses` dispersed pulses injected ONLY into
    `pulse_beams` (the astrophysical signal a coincidence veto must
    keep), and `nrfi` correlated bursts injected into EVERY beam at
    shared times (the broadband-RFI signature the veto must kill).
    Truth is stamped by models/inject.truth_record at injection
    time, same schema as the injectpsr sidecar."""
    from presto_tpu_torch.models.inject import InjectParams, truth_record

    N = int(seconds / dt)
    freqs = (fch1 + foff * (nchan - 1)) + np.arange(nchan) * abs(foff)
    sweep, period = _pulse_period(dm, freqs, dt, width_s)
    f = 1.0 / period
    nev = npulses + nrfi
    span = (seconds - 2 * t_margin) / max(nev, 1)
    rng = np.random.default_rng(seed)
    times = [t_margin + span * (i + 0.5)
             + float(rng.uniform(-0.15, 0.15) * span)
             for i in range(nev)]
    truth = [truth_record(
        InjectParams(f=f, dm=dm, amp=amp, width=width_s * f,
                     phase0=(-t0 * f) % 1.0), t=t0)
        for t0 in times]
    t_signal = [r["t"] for r in truth[:npulses]]
    t_rfi = [r["t"] for r in truth[npulses:]]

    datas = []
    for b in range(nbeams):
        brng = np.random.default_rng(seed + 1000 * (b + 1))
        data = brng.normal(10.0, noise_sigma,
                           (N, nchan)).astype(np.float32)
        if b in pulse_beams:
            for t0 in t_signal:
                _inject_window(data, t0, amp, f, dm, width_s, dt, freqs,
                               sweep)
        for t0 in t_rfi:
            _inject_window(data, t0, rfi_amp, f, dm, width_s, dt, freqs,
                           sweep)
        # injection and push_spectra both speak ascending-frequency
        # channel order (the reader seam normalizes wire order on
        # decode), so the arrays go in as-built
        datas.append(data)
    return _header(nchan, dt, fch1, foff, N), datas, t_signal, t_rfi


def _push_beam(source, hdr, data, chunk: int = 1024) -> None:
    source.set_header(hdr)
    for lo in range(0, len(data), chunk):
        source.push_spectra(data[lo:lo + chunk])
    source.eof()


_STRIP = ("seq", "ts", "kind", "stream", "beam", "latency_s")


def _payload(ev: dict) -> str:
    return json.dumps({k: v for k, v in ev.items()
                       if k not in _STRIP}, sort_keys=True)


def _run_beam_mux(workdir: str, hdr, datas, cfg, coincidence_k: int,
                  veto_window_s: float, dm_tol, timeout: float,
                  device="cuda") -> dict:
    """One in-process BeamMultiplexer pass on ``device`` over
    pre-decoded per-beam spectra; returns per-beam trigger payloads,
    veto decisions, the device-dispatch ledger, and the per-beam
    latency histograms."""
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import RingBlockSource
    from presto_tpu_torch.stream.beams import BeamMultiplexer

    service = SearchService(workdir, heartbeat_s=5.0, device=device)
    service.start()
    try:
        sources = [RingBlockSource(capacity=cfg.ring_capacity,
                                   policy=cfg.ring_policy)
                   for _ in datas]
        feeders = [threading.Thread(target=_push_beam,
                                    args=(s, hdr, d), daemon=True)
                   for s, d in zip(sources, datas)]
        for t in feeders:
            t.start()
        mux = BeamMultiplexer(service, sources, cfg,
                              coincidence_k=coincidence_k,
                              veto_window_s=veto_window_s,
                              dm_tol=dm_tol, device=device).start()
        finished = mux.wait(timeout)
        evs = service.events.tail(100000)
        per_beam = {lane.beam_id: [] for lane in mux.lanes}
        for ev in evs:
            if ev["kind"] == "trigger":
                per_beam[ev["beam"]].append(_payload(ev))
        disp = service.obs.metrics.get("jax_dispatches_total")
        dispatches = (disp.labels(kind="beam_dedisp").value
                      if disp is not None else 0)
        summary = mux.summary()
        return {
            "finished": bool(finished),
            "failed": None if mux.failed is None
            else "%s: %s" % (type(mux.failed).__name__, mux.failed),
            "per_beam": per_beam,
            "vetoes": [e for e in evs if e["kind"] == "beam-veto"],
            "ticks": max(lane.ticks for lane in mux.lanes),
            "dispatches": int(dispatches),
            "latency": summary.get("latency", {}),
            "summary": summary,
        }
    finally:
        service.stop()


def _run_beam_reference(workdir: str, hdr, datas, cfg,
                        timeout: float, device="cuda") -> dict:
    """N independent presto-stream instances on ``device`` on the same
    spectra: the byte-equality reference the multiplexer must match."""
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import RingBlockSource, StreamService

    out = {}
    for b, data in enumerate(datas):
        service = SearchService(os.path.join(workdir, "ref-%d" % b),
                                heartbeat_s=5.0, device=device)
        service.start()
        try:
            source = RingBlockSource(capacity=cfg.ring_capacity,
                                     policy=cfg.ring_policy)
            feeder = threading.Thread(target=_push_beam,
                                      args=(source, hdr, data),
                                      daemon=True)
            feeder.start()
            stream = StreamService(service, source, cfg,
                                   device=device).start()
            if not stream.wait(timeout) or stream.failed is not None:
                raise RuntimeError(
                    "reference stream %d did not finish cleanly: %r"
                    % (b, stream.failed))
            out["beam-%d" % b] = [
                _payload(e) for e in service.events.tail(100000)
                if e["kind"] == "trigger"]
        finally:
            service.stop()
    return out


def _near(t, times, tol):
    return any(abs(float(t) - x) <= tol for x in times)


def run_beam_trial(workdir: str, nbeams: int = 4,
                   beam_counts=(2, 4), pulse_beams=(0,),
                   coincidence_k: int = 0, veto_window_s: float = 0.1,
                   seed: int = 0, seconds: float = 16.0,
                   npulses: int = 2, nrfi: int = 2,
                   nchan: int = 64, dt: float = 5e-4,
                   dm: float = 45.0, numdms: int = 9,
                   lodm: float = 25.0, dmstep: float = 5.0,
                   nsub: int = 32, threshold: float = 7.0,
                   blocklen: int = 4096, ring: int = 64,
                   match_tol_s: float = 0.15,
                   slo_latency_s: float = 30.0,
                   timeout: float = 600.0, device="cuda") -> dict:
    """The --beams verdict on ``device``: (1) the multiplexer's per-beam
    trigger sets are byte-equal to N independent presto-stream
    instances with the veto off, (2) device-chain dispatches per tick
    are O(1) in beam count, (3) the coincidence veto kills every
    correlated burst and keeps every single-beam pulse
    (precision/recall), (4) trigger latency p99 stays under an
    obs/slo.py-backed objective as beams scale."""
    from presto_tpu_torch.obs.slo import SloSpec
    from presto_tpu_torch.stream import StreamConfig

    k = coincidence_k or max(2, min(nbeams, 3))
    hdr, datas, t_signal, t_rfi = make_beam_feeds(
        nbeams, pulse_beams=pulse_beams, seed=seed, nchan=nchan,
        dt=dt, seconds=seconds, npulses=npulses, nrfi=nrfi, dm=dm)
    cfg = StreamConfig(lodm=lodm, dmstep=dmstep, numdms=numdms,
                       nsub=nsub, threshold=threshold,
                       blocklen=blocklen, ring_capacity=ring)

    def mux(name, beams, k):
        return _run_beam_mux(os.path.join(workdir, name), hdr, beams,
                             cfg, k, veto_window_s, None, timeout,
                             device=device)

    # (1) byte-equality at full beam count, veto off
    ref = _run_beam_reference(os.path.join(workdir, "ref"),
                              hdr, datas, cfg, timeout, device=device)
    flat = mux("mux-flat", datas, 0)
    byte_equal = all(
        sorted(flat["per_beam"].get("beam-%d" % b, []))
        == sorted(ref["beam-%d" % b])
        for b in range(nbeams))

    # (2)+(4) the beams axis: dispatches/tick + latency p99 per count
    spec = SloSpec(tenant="beams", objective=0.99,
                   latency_s=slo_latency_s)
    axis = []
    for count in beam_counts:
        count = min(int(count), nbeams)
        run = (flat if count == nbeams else
               mux("mux-%d" % count, datas[:count], 0))
        lat = run["latency"]
        p99 = max(float(p.get("p99") or 0.0)
                  for p in lat.values()) if lat else None
        axis.append({
            "beams": count,
            "finished": run["finished"],
            "triggers": sum(len(v) for v in run["per_beam"].values()),
            "ticks": run["ticks"],
            "dispatches": run["dispatches"],
            "dispatch_per_tick": round(
                run["dispatches"] / max(run["ticks"], 1), 3),
            "latency_p99_s": None if p99 is None else round(p99, 4),
            "slo_ok": p99 is None or p99 <= spec.latency_s,
        })
    o1_dispatch = all(row["dispatch_per_tick"] <= 1.0 + 1e-9
                      for row in axis)
    slo_ok = all(row["slo_ok"] for row in axis)

    # (3) coincidence veto: every correlated burst killed (recall),
    # no single-beam pulse killed (precision of the kept set)
    veto = mux("mux-veto", datas, k)
    veto_times = [float(v["time"]) for v in veto["vetoes"]]
    rfi_killed = [t for t in t_rfi if _near(t, veto_times, match_tol_s)]
    false_vetoes = [vt for vt in veto_times
                    if not _near(vt, t_rfi, match_tol_s)]
    kept = [json.loads(p) for ps in veto["per_beam"].values()
            for p in ps]
    signal_kept = [t for t in t_signal
                   if _near(t, [tr["time"] for tr in kept], match_tol_s)]
    rfi_leaked = [tr["time"] for tr in kept
                  if _near(tr["time"], t_rfi, match_tol_s)]
    recall = len(rfi_killed) / max(len(t_rfi), 1)
    precision = (len(veto_times) - len(false_vetoes)) \
        / max(len(veto_times), 1)
    veto_ok = (recall == 1.0 and not false_vetoes
               and len(signal_kept) == len(t_signal)
               and not rfi_leaked)

    ok = (byte_equal and o1_dispatch and slo_ok and veto_ok
          and flat["finished"] and veto["finished"]
          and flat["failed"] is None and veto["failed"] is None)
    return {
        "ok": bool(ok),
        "beams": nbeams,
        "device": str(device),
        "pulse_beams": list(pulse_beams),
        "pulses_injected": [round(t, 3) for t in t_signal],
        "rfi_injected": [round(t, 3) for t in t_rfi],
        "byte_equal": bool(byte_equal),
        "o1_dispatch": bool(o1_dispatch),
        "beams_axis": axis,
        "slo": dict(spec.to_dict(), p99_ok=bool(slo_ok)),
        "veto": {
            "k": k,
            "window_s": veto_window_s,
            "decisions": len(veto_times),
            "rfi_killed": len(rfi_killed),
            "false_vetoes": [round(t, 3) for t in false_vetoes],
            "rfi_leaked": [round(float(t), 3) for t in rfi_leaked],
            "signal_kept": len(signal_kept),
            "precision": round(precision, 3),
            "recall": round(recall, 3),
            "ok": bool(veto_ok),
        },
        "mux_totals": {kk: vv for kk, vv in
                       flat["summary"].items()
                       if isinstance(vv, (int, float, str))},
    }


def build_parser():
    ap = argparse.ArgumentParser(prog="stream_loadgen")
    ap.add_argument("--mode", choices=("paced", "burst"),
                    default="paced")
    ap.add_argument("--speed", type=float, default=8.0,
                    help="paced-mode replay speed (x real time)")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--pulses", type=int, default=6)
    ap.add_argument("--nchan", type=int, default=64)
    ap.add_argument("--dt", type=float, default=5e-4)
    ap.add_argument("--dm", type=float, default=45.0)
    ap.add_argument("--numdms", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--beams", "-beams", type=int, default=0,
                    help="Beam-multiplexer verdict mode: byte-equality"
                         " vs N independent streams, O(1) dispatch, "
                         "coincidence veto precision/recall, p99 vs "
                         "beam count")
    ap.add_argument("--coincidence", type=int, default=0,
                    help="Veto threshold K for --beams (default: "
                         "min(beams, 3))")
    ap.add_argument("--out", type=str, default=None,
                    help="Write the verdict JSON here")
    ap.add_argument("--device", "-device", type=str, default="cuda",
                    help="Device the streams run on (default cuda; "
                         "without a card it raises)")
    return ap


def main(argv=None) -> int:
    from presto_tpu_torch.search.accel import resolve_device
    args = build_parser().parse_args(argv)
    device = str(resolve_device(args.device))
    workdir = args.workdir or tempfile.mkdtemp(prefix="streamload-")
    if args.beams > 0:
        counts = sorted({max(2, args.beams // 2), args.beams})
        verdict = run_beam_trial(workdir, nbeams=args.beams,
                                 beam_counts=counts,
                                 coincidence_k=args.coincidence,
                                 seed=args.seed, device=device)
    else:
        verdict = run_trial(workdir, mode=args.mode, speed=args.speed,
                            seed=args.seed, seconds=args.seconds,
                            npulses=args.pulses, nchan=args.nchan,
                            dt=args.dt, dm=args.dm, numdms=args.numdms,
                            device=device)
    text = json.dumps(verdict, indent=1, sort_keys=True)
    print(text)
    if args.out:
        from presto_tpu_torch.io.atomic import atomic_write_text
        atomic_write_text(args.out, text + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
