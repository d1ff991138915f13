"""stream_chaos: dropout trials for the port's live streaming search.

Counterpart of ``tools/stream_chaos.py``, with its trials, flags and
report keys, and ``--device``.  Three failure classes a live beam feed
actually exhibits, each driven against a real socket feed with fault
injection (testing/chaos.StreamFaults + raw-socket truncation), each
asserting the streaming contract: the service KEEPS RUNNING, every lost
spectrum is a quarantine ledger entry (io/quality.DataQualityReport) —
never a silent gap — and pulses outside the damaged window still
trigger exactly once.

  stall       — the producer freezes mid-stream longer than the
                source's stall budget: zero fill is inserted (reason
                "stall") to hold cadence, the late data is discarded
                on resume, and post-stall pulses still trigger.
  truncation  — the connection dies mid-spectrum: the partial
                spectrum is quarantined ("truncated"), the stream
                EOFs cleanly, pre-cut pulses trigger, and the serve
                scheduler is still alive to take new work.
  ring-drop   — a burst feed against a tiny ring: backpressure sheds
                blocks (drop-oldest), every shed block is quarantined
                ("ring-drop") and counted, and no trigger duplicates.

Three more against the beam multiplexer (stream/beams.py):

  beam-stall      — one beam's feeder goes quiet: its lane degrades
                    to quarantined gap fill, siblings keep ticking,
                    late data is shed on resume.
  beam-truncation — one beam's feed dies halfway: that lane flushes
                    early while siblings run to completion.
  beam-handoff    — a replica is killed at a beam-tick kill point
                    mid-observation; a successor reaps it via the
                    beam ledger and finishes the beams with zero
                    lost and zero duplicated triggers.

Every stream and multiplexer runs on ``--device`` (default cuda;
without a card it raises, nothing falls back).  The feeds are
apps/stream_loadgen's (the JAX tool's bytes).  The budgets are the JAX
tool's, set for its host's tick times; a card ticks faster, and a
fault that no longer lands there fails its trial (nothing widens the
windows to hide it).  In the port the beam-tick kill ends replica A's
multiplexer itself (``failed`` is the SimulatedCrash), so the trial
waits for that where the JAX tool marks the headless replica failed.

    python -m presto_tpu_torch.apps.stream_chaos --out verdict.json

``--out`` writes the verdict JSON to the path it names and nowhere
else.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import threading
import time

import numpy as np

from presto_tpu_torch.apps import stream_loadgen


def _setup(workdir, seed, seconds, npulses, stall_timeout_s=None,
           ring=64, nchan=32, numdms=5, blocklen=4096,
           threshold=7.0, use_socket=True, device="cuda"):
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import (RingBlockSource, SocketProducer,
                                         StreamConfig, StreamService)
    hdr, wire, truth = stream_loadgen.make_feed(
        seed=seed, nchan=nchan, dt=5e-4, seconds=seconds,
        npulses=npulses, dm=45.0)
    cfg = StreamConfig(lodm=25.0, dmstep=5.0, numdms=numdms, nsub=32,
                       threshold=threshold, blocklen=blocklen,
                       ring_capacity=ring,
                       stall_timeout_s=stall_timeout_s)
    service = SearchService(os.path.join(workdir, "serve"),
                            heartbeat_s=0.5, device=device)
    service.start()
    source = RingBlockSource(capacity=ring, policy="drop-oldest",
                             stall_timeout_s=stall_timeout_s)
    producer = (SocketProducer(source).start() if use_socket
                else None)
    stream = StreamService(service, source, cfg, device=device).start()
    return hdr, wire, truth, service, source, producer, stream


def _triggers(service):
    return [e for e in service.events.tail(100000)
            if e["kind"] == "trigger"]


def _matched(trigs, truth, tol=0.2):
    """truth-index -> trigger count (exactly-once check per pulse)."""
    out = {i: 0 for i in range(len(truth))}
    for ev in trigs:
        for i, t in enumerate(truth):
            if abs(ev["time"] - t) <= tol:
                out[i] += 1
                break
    return out


def _scheduler_alive(service) -> bool:
    """The service must still take and run work after the fault."""
    done = threading.Event()
    service.submit_callable(lambda job: done.set() or {},
                            lane="deadline")
    return done.wait(10.0)


def trial_stall(workdir: str, seed: int = 1, device="cuda",
                stall_timeout_s: float = 0.3,
                stall_s: float = 1.0) -> dict:
    """Producer freeze mid-stream (``stall_s``), longer than the stall
    budget (``stall_timeout_s``; the JAX tool's values by default)."""
    from presto_tpu_torch.testing.chaos import StreamFaults
    seconds, npulses = 24.0, 4
    hdr, wire, truth, service, source, producer, stream = _setup(
        workdir, seed, seconds, npulses, stall_timeout_s=stall_timeout_s,
        device=device)
    # freeze right between the 2nd and 3rd pulse
    stall_at = int((truth[1] + 1.0) / hdr.tsamp)
    faults = StreamFaults([(stall_at, "stall", stall_s)])
    sender = threading.Thread(
        target=stream_loadgen.send_wire,
        args=(producer.address, wire, hdr),
        kwargs=dict(mode="paced", speed=16.0, faults=faults),
        daemon=True)
    sender.start()
    finished = stream.wait(240.0)
    trigs = _triggers(service)
    counts = _matched(trigs, truth)
    q = source.quality.counts()
    alive = _scheduler_alive(service)
    # the stall window destroys ~stall-seconds of data around pulse
    # positions stall_at..+debt; every OTHER pulse must trigger once
    safe = [i for i, t in enumerate(truth)
            if not (stall_at * hdr.tsamp - 0.5 <= t
                    <= stall_at * hdr.tsamp + 2.0)]
    ok = (finished and stream.failed is None and alive
          and q.get("stall", 0) > 0
          and all(counts[i] == 1 for i in safe)
          and all(c <= 1 for c in counts.values()))
    service.stop()
    producer.close()
    return {"trial": "stall", "ok": bool(ok), "finished": finished,
            "scheduler_alive": alive, "quarantine": q,
            "stall_fired": faults.fired != [],
            "triggers": len(trigs),
            "pulse_hits": {round(truth[i], 2): c
                           for i, c in counts.items()},
            "safe_pulses": [round(truth[i], 2) for i in safe]}


def trial_truncation(workdir: str, seed: int = 2, device="cuda") -> dict:
    """Connection dies mid-spectrum partway through the stream."""
    seconds, npulses = 24.0, 4
    hdr, wire, truth, service, source, producer, stream = _setup(
        workdir, seed, seconds, npulses, device=device)
    bps = hdr.bytes_per_spectrum
    hdrlen = len(wire) - hdr.N * bps
    # cut after the 2nd pulse, mid-spectrum (half a spectrum extra)
    cut_spectra = int((truth[1] + 1.5) / hdr.tsamp)
    cut = hdrlen + cut_spectra * bps + bps // 2

    def sender():
        s = socket.create_connection(producer.address)
        s.sendall(wire[:cut])
        s.close()

    threading.Thread(target=sender, daemon=True).start()
    finished = stream.wait(240.0)
    trigs = _triggers(service)
    counts = _matched(trigs, truth)
    q = source.quality.counts()
    alive = _scheduler_alive(service)
    margin = 1.5    # dedispersion sweep + detrend/chunk holdback
    expected = [i for i, t in enumerate(truth)
                if t < cut_spectra * hdr.tsamp - margin]
    ok = (finished and stream.failed is None and alive
          and q.get("truncated", 0) > 0
          and all(counts[i] == 1 for i in expected)
          and all(c <= 1 for c in counts.values()))
    service.stop()
    producer.close()
    return {"trial": "truncation", "ok": bool(ok),
            "finished": finished, "scheduler_alive": alive,
            "quarantine": q, "cut_at_s": round(cut_spectra
                                               * hdr.tsamp, 2),
            "triggers": len(trigs),
            "pulse_hits": {round(truth[i], 2): c
                           for i, c in counts.items()},
            "expected_pulses": [round(truth[i], 2)
                                for i in expected]}


def trial_ringdrop(workdir: str, seed: int = 3, device="cuda") -> dict:
    """Overload a 2-block ring faster than any socket can (direct
    producer pushes): backpressure must shed blocks with full
    accounting, not stall or crash."""
    seconds, npulses = 24.0, 4
    hdr, wire, truth, service, source, producer, stream = _setup(
        workdir, seed, seconds, npulses, ring=2, use_socket=False,
        device=device)
    bps = hdr.bytes_per_spectrum
    body = wire[len(wire) - hdr.N * bps:]
    raw = np.frombuffer(bytearray(body), np.float32).reshape(
        hdr.N, hdr.nchans)[:, ::-1]     # wire order -> ascending

    def pusher():
        source.set_header(hdr)
        step = 8192
        for i in range(0, hdr.N, step):
            source.push_spectra(raw[i:i + step])
        source.eof()

    threading.Thread(target=pusher, daemon=True).start()
    finished = stream.wait(240.0)
    trigs = _triggers(service)
    counts = _matched(trigs, truth)
    stats = source.stats()
    q = source.quality.counts()
    alive = _scheduler_alive(service)
    accounted = stats["dropped_spectra"] <= q.get("ring-drop", 0)
    ok = (finished and stream.failed is None and alive and accounted
          and stats["dropped_blocks"] > 0
          and all(c <= 1 for c in counts.values()))
    service.stop()
    return {"trial": "ring-drop", "ok": bool(ok),
            "finished": finished, "scheduler_alive": alive,
            "dropped_blocks": stats["dropped_blocks"],
            "dropped_spectra": stats["dropped_spectra"],
            "quarantine": q, "accounted": bool(accounted),
            "triggers": len(trigs),
            "pulse_hits": {round(truth[i], 2): c
                           for i, c in counts.items()}}


# ----------------------------------------------------------------------
# Beam-multiplexer trials (stream/beams.py): a stalled beam, a
# truncated beam, and a replica killed mid-observation with beam
# hand-off — each against the multi-beam contract: a sick beam never
# stalls the tick or its siblings, every gap is quarantined per beam,
# and hand-off re-emits nothing and loses nothing.
# ----------------------------------------------------------------------

def _beam_setup(workdir, nbeams, pulse_beams, seed, seconds=16.0,
                npulses=3):
    """Proven-sensitive beam geometry (see stream_loadgen): per-beam
    ascending-order spectra plus the StreamConfig the mux and the
    independent reference share."""
    from presto_tpu_torch.stream import StreamConfig
    hdr, datas, t_signal, _ = stream_loadgen.make_beam_feeds(
        nbeams, pulse_beams=pulse_beams, seed=seed, nchan=64,
        dt=5e-4, seconds=seconds, npulses=npulses, nrfi=0)
    cfg = StreamConfig(lodm=25.0, dmstep=5.0, numdms=9, nsub=32,
                       threshold=7.0, blocklen=4096,
                       ring_capacity=64)
    return hdr, datas, t_signal, cfg


def _beam_triggers(service):
    """beam id -> [trigger events] from the service event log."""
    out = {}
    for ev in service.events.tail(100000):
        if ev["kind"] == "trigger":
            out.setdefault(ev["beam"], []).append(ev)
    return out


def trial_beam_stall(workdir: str, seed: int = 4, device="cuda") -> dict:
    """One beam's feeder goes quiet mid-observation: the mux must
    gap-fill that lane (quarantine reason "stall"), keep the tick
    cadence for its siblings, and discard the late data on resume —
    the healthy beam's pulses trigger exactly once throughout."""
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import BeamMultiplexer, RingBlockSource

    hdr, datas, truth, cfg = _beam_setup(workdir, 2, (0,), seed)
    service = SearchService(os.path.join(workdir, "serve"),
                            heartbeat_s=0.5, device=device)
    service.start()
    sources = [RingBlockSource(capacity=cfg.ring_capacity,
                               policy=cfg.ring_policy)
               for _ in datas]
    # beam 0: full burst feed; beam 1: half its data, then silence
    # until the mux has declared it a straggler
    threading.Thread(target=stream_loadgen._push_beam,
                     args=(sources[0], hdr, datas[0]),
                     daemon=True).start()
    half = (len(datas[1]) // (2 * cfg.blocklen)) * cfg.blocklen

    def push_half():
        sources[1].set_header(hdr)
        for lo in range(0, half, 1024):
            sources[1].push_spectra(datas[1][lo:lo + 1024])

    threading.Thread(target=push_half, daemon=True).start()
    mux = BeamMultiplexer(service, sources, cfg, qos_wait_s=0.25,
                          device=device).start()
    # wait for the straggler verdict (gap fill on beam 1)
    deadline = time.time() + 240.0
    while time.time() < deadline:
        if (len(mux.lanes) == 2
                and mux.lanes[1].stalled_spectra > 0):
            break
        time.sleep(0.05)
    stalled = (len(mux.lanes) == 2
               and mux.lanes[1].stalled_spectra > 0)

    def push_rest():     # resume: this data is stale, must be shed
        for lo in range(half, len(datas[1]), 1024):
            sources[1].push_spectra(datas[1][lo:lo + 1024])
        sources[1].eof()

    threading.Thread(target=push_rest, daemon=True).start()
    finished = mux.wait(240.0)
    per_beam = _beam_triggers(service)
    counts = _matched(per_beam.get("beam-0", []), truth)
    lane1 = mux.lanes[1].health() if len(mux.lanes) == 2 else {}
    alive = _scheduler_alive(service)
    shed = (lane1.get("dropped_spectra", 0)
            + lane1.get("stalled_spectra", 0))
    ok = (finished and mux.failed is None and alive and stalled
          and lane1.get("quarantine", {}).get("stall", 0) > 0
          and shed > 0
          and all(c == 1 for c in counts.values()))
    service.stop()
    return {"trial": "beam-stall", "ok": bool(ok),
            "finished": bool(finished), "scheduler_alive": alive,
            "stalled_spectra": lane1.get("stalled_spectra", 0),
            "dropped_spectra": lane1.get("dropped_spectra", 0),
            "quarantine": lane1.get("quarantine", {}),
            "healthy_beam_hits": {round(t, 2): counts[i]
                                  for i, t in enumerate(truth)}}


def trial_beam_truncation(workdir: str, seed: int = 5,
                          device="cuda") -> dict:
    """One beam's feed dies halfway through: that lane EOFs and
    flushes early while its siblings run to completion — pre-cut
    pulses on the dead beam and every pulse on the healthy beam
    trigger exactly once, with no duplicates anywhere."""
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import BeamMultiplexer, RingBlockSource

    hdr, datas, truth, cfg = _beam_setup(workdir, 2, (0, 1), seed)
    service = SearchService(os.path.join(workdir, "serve"),
                            heartbeat_s=0.5, device=device)
    service.start()
    sources = [RingBlockSource(capacity=cfg.ring_capacity,
                               policy=cfg.ring_policy)
               for _ in datas]
    cut = len(datas[1]) // 2
    threading.Thread(target=stream_loadgen._push_beam,
                     args=(sources[0], hdr, datas[0]),
                     daemon=True).start()
    threading.Thread(target=stream_loadgen._push_beam,
                     args=(sources[1], hdr, datas[1][:cut]),
                     daemon=True).start()
    mux = BeamMultiplexer(service, sources, cfg, device=device).start()
    finished = mux.wait(240.0)
    per_beam = _beam_triggers(service)
    counts0 = _matched(per_beam.get("beam-0", []), truth)
    counts1 = _matched(per_beam.get("beam-1", []), truth)
    alive = _scheduler_alive(service)
    cut_s = cut * hdr.tsamp
    margin = 1.5    # dedispersion sweep + detrend/chunk holdback
    expected1 = [i for i, t in enumerate(truth) if t < cut_s - margin]
    states = [lane.state for lane in mux.lanes]
    ok = (finished and mux.failed is None and alive
          and states == ["done", "done"]
          and all(counts0[i] == 1 for i in range(len(truth)))
          and all(counts1[i] == 1 for i in expected1)
          and all(counts1[i] == 0 for i, t in enumerate(truth)
                  if t > cut_s)
          and all(c <= 1 for c in counts1.values()))
    service.stop()
    return {"trial": "beam-truncation", "ok": bool(ok),
            "finished": bool(finished), "scheduler_alive": alive,
            "cut_at_s": round(cut_s, 2), "lane_states": states,
            "healthy_beam_hits": {round(t, 2): counts0[i]
                                  for i, t in enumerate(truth)},
            "truncated_beam_hits": {round(t, 2): counts1[i]
                                    for i, t in enumerate(truth)},
            "expected_on_truncated": [round(truth[i], 2)
                                      for i in expected1]}


def _ledger_rows(fleet):
    with open(os.path.join(fleet, "beams.json")) as f:
        return json.load(f)["beams"]


def trial_beam_handoff(workdir: str, seed: int = 6, device="cuda") -> dict:
    """Replica A is killed at a beam-tick kill point mid-observation
    (after committing early triggers to the beam ledger); replica B
    reaps the dead host, adopts the leases, replays the feeds and
    suppresses A's committed set.  The ledger's final per-beam
    trigger sets must be byte-equal to an untouched independent
    reference: zero lost, zero duplicated."""
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.stream import BeamMultiplexer, RingBlockSource
    from presto_tpu_torch.testing.chaos import FaultInjector

    hdr, datas, truth, cfg = _beam_setup(workdir, 2, (0, 1), seed)
    ref = stream_loadgen._run_beam_reference(
        os.path.join(workdir, "ref"), hdr, datas, cfg, 240.0,
        device=device)
    fleet = os.path.join(workdir, "fleet")
    os.makedirs(fleet, exist_ok=True)

    # replica A: the injector is armed only once the ledger holds a
    # committed trigger, so the kill lands mid-observation — after a
    # partial commit, before the feeds finish
    service_a = SearchService(os.path.join(workdir, "replica-A"),
                              heartbeat_s=0.5, device=device)
    service_a.start()
    faults = FaultInjector(kill_at="beam-tick", kill_after=1,
                           mode="off")
    sources_a = [RingBlockSource(capacity=cfg.ring_capacity,
                                 policy=cfg.ring_policy)
                 for _ in datas]
    # gate each feed after 7 blocks: enough ticks for the first pulse
    # to commit, with the rest of the observation still unpushed, so
    # the armed kill is guaranteed to land mid-observation
    gate = threading.Event()
    hold = 7 * cfg.blocklen

    def push_gated(source, data):
        source.set_header(hdr)
        for lo in range(0, len(data), 1024):
            if lo >= hold:
                gate.wait(240.0)
            source.push_spectra(data[lo:lo + 1024])
        source.eof()

    for s, d in zip(sources_a, datas):
        threading.Thread(target=push_gated, args=(s, d),
                         daemon=True).start()
    mux_a = BeamMultiplexer(service_a, sources_a, cfg,
                            fleet_dir=fleet, host="replica-A",
                            lease_ttl=5.0, heartbeat_ttl=1.0,
                            faults=faults, device=device).start()

    def _ledger_triggers():
        try:
            rows = _ledger_rows(fleet)
        except (OSError, ValueError, KeyError):
            return 0
        return sum(len(row.get("triggers") or [])
                   for row in rows.values())

    deadline = time.time() + 120.0
    while _ledger_triggers() == 0 and time.time() < deadline:
        time.sleep(0.05)
    faults.mode = "raise"     # arm: the next beam tick dies
    gate.set()                # release the rest of the feeds
    while faults.fired is None and time.time() < deadline:
        time.sleep(0.05)
    killed = faults.fired is not None
    # the tick's crash ends replica A's multiplexer itself
    mux_a.wait(10.0)
    a_committed = sum(len(row.get("triggers") or [])
                      for row in _ledger_rows(fleet).values())
    service_a.stop()
    time.sleep(1.5)      # let A's ledger heartbeat expire (ttl 1.0)

    # replica B: adopt=True reaps A, leases the beams, replays
    service_b = SearchService(os.path.join(workdir, "replica-B"),
                              heartbeat_s=0.5, device=device)
    service_b.start()
    sources_b = [RingBlockSource(capacity=cfg.ring_capacity,
                                 policy=cfg.ring_policy)
                 for _ in datas]
    for s, d in zip(sources_b, datas):
        threading.Thread(target=stream_loadgen._push_beam,
                         args=(s, hdr, d), daemon=True).start()
    mux_b = BeamMultiplexer(service_b, sources_b, cfg,
                            fleet_dir=fleet, host="replica-B",
                            lease_ttl=5.0, heartbeat_ttl=1.0,
                            adopt=True, device=device).start()
    finished = mux_b.wait(240.0)
    totals = mux_b.summary_totals()
    alive = _scheduler_alive(service_b)
    rows = _ledger_rows(fleet)
    ledger = {beam: sorted(json.dumps(t, sort_keys=True)
                           for t in (row.get("triggers") or []))
              for beam, row in rows.items()}
    byte_equal = all(ledger.get(b, []) == sorted(ref[b])
                     for b in ref)
    no_dups = all(len(set(trigs)) == len(trigs)
                  for trigs in ledger.values())
    states = [row.get("state") for _, row in sorted(rows.items())]
    ok = (killed and finished and mux_b.failed is None and alive
          and a_committed >= 1
          and totals["handoffs"] == len(datas)
          and totals["replayed"] == a_committed
          and byte_equal and no_dups
          and states == ["done", "done"])
    service_b.stop()
    return {"trial": "beam-handoff", "ok": bool(ok),
            "killed_at": faults.fired, "finished": bool(finished),
            "scheduler_alive": alive,
            "committed_before_kill": a_committed,
            "handoffs": totals["handoffs"],
            "replayed": totals["replayed"],
            "byte_equal": bool(byte_equal),
            "no_duplicates": bool(no_dups),
            "ledger_states": states,
            "ledger_triggers": {b: len(v)
                                for b, v in sorted(ledger.items())},
            "reference_triggers": {b: len(v)
                                   for b, v in sorted(ref.items())}}


#: every trial by its name, in the JAX tool's order
TRIALS = {"stall": trial_stall, "truncation": trial_truncation,
          "ring-drop": trial_ringdrop,
          "beam-stall": trial_beam_stall,
          "beam-truncation": trial_beam_truncation,
          "beam-handoff": trial_beam_handoff}


def run_trials(names, device="cuda", root=None) -> dict:
    """The named trials, each in a fresh scratch directory (under
    ``root`` when given) on ``device``: the verdict (every trial's
    report with its wall seconds, passed, total, ok)."""
    results = []
    if root is not None:
        os.makedirs(root, exist_ok=True)
    for name in names:
        workdir = tempfile.mkdtemp(prefix="streamchaos-", dir=root)
        t0 = time.time()
        res = TRIALS[name.strip()](workdir, device=device)
        res["wall_s"] = round(time.time() - t0, 2)
        results.append(res)
        print("trial %-12s %s  (%.1fs)"
              % (name, "PASS" if res["ok"] else "FAIL",
                 res["wall_s"]), flush=True)
    return {
        "trials": results,
        "passed": sum(1 for r in results if r["ok"]),
        "total": len(results),
        "ok": all(r["ok"] for r in results),
    }


def build_parser():
    ap = argparse.ArgumentParser(prog="stream_chaos")
    ap.add_argument("--out", type=str, default=None,
                    help="Write the verdict JSON here")
    ap.add_argument("--trials", type=str, default=",".join(TRIALS))
    ap.add_argument("-device", "--device", type=str, default="cuda",
                    help="Device of every stream and multiplexer "
                         "(default cuda; without a card it raises)")
    return ap


def main(argv=None) -> int:
    from presto_tpu_torch.search.accel import resolve_device
    args = build_parser().parse_args(argv)
    device = str(resolve_device(args.device))
    verdict = run_trials(args.trials.split(","), device=device)
    text = json.dumps(verdict, indent=1, sort_keys=True)
    print(text)
    if args.out:
        from presto_tpu_torch.io.atomic import atomic_write_text
        atomic_write_text(args.out, text + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
