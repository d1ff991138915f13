"""The port's presto-report (apps/report) against the JAX package's, over
files the port wrote.

A port survey on the CPU with telemetry on (manifest.json, spans.jsonl,
trace.perfetto.json, kernel_costs.json from the analytic cost book, the
rfifind quality ledger) plus a tuning provenance file and a flight
recorder dump: both reports render the same sections with the same
journal, span, flight-recorder, tuning and quality lines; the roofline
section lists the same kinds and dispatches, and the port's adds the
analytic per-kind FLOP and byte totals.  A fleet directory the port
wrote (ledger, usage, SLO specs, replica snapshots with dispatch and
kernel-launch counters, a supervisor registry and decision stream from
the port's FleetSupervisor): both fleet reports render the same sections
(the port's adds its CUDA kernel launches), the same supervisor
timeline and the same scale advisory."""

import io
import json
import os
from types import SimpleNamespace

import pytest

from presto_tpu.apps import report as jreport
from presto_tpu.obs import roofline as jroofline

from presto_tpu_torch.apps import report
from presto_tpu_torch.obs import roofline

PEAKS = {"flops_per_s": 5.0e13, "bytes_per_s": 3.0e12}


def _sections(text):
    """Section heading -> its lines (headings are the unindented
    lines; the title line is skipped)."""
    out, cur = {}, None
    for ln in text.splitlines()[1:]:
        if not ln.strip():
            continue
        if not ln.startswith(" "):
            cur = ln.split(":")[0].split(" (")[0]
            out.setdefault(cur, [])
        if cur is not None:
            out[cur].append(ln)
    return out


@pytest.fixture(scope="module")
def survey_dir(tmp_path_factory):
    from tools.serve_loadgen import make_beams
    from presto_tpu_torch import tune
    from presto_tpu_torch.obs import FlightRecorder, ObsConfig
    from presto_tpu_torch.pipeline import survey
    root = tmp_path_factory.mktemp("report")
    beam = make_beams(str(root), 1, nsamp=4096, nchan=8)[0]
    work = str(root / "w")
    survey.run_survey([beam], survey.SurveyConfig(
        lodm=50, hidm=56, nsub=8, zmax=0, numharm=2, fold_top=0,
        singlepulse=False, durable_stages=True,
        obs=ObsConfig(enabled=True)), work, device="cpu")
    tune.reset()
    tune.configure(enabled=True, db_path=str(root / "tune.json"))
    try:
        tune.best("accel_column_slab", "numbins=4096,numharm=2,numz=8",
                  default={"slab": 1024})
        tune.write_provenance(work)
    finally:
        tune.reset()
    fr = FlightRecorder(capacity=16)
    fr.add("chaos-point", point="fused-chunk")
    fr.dump(work, "SimulatedCrash")
    return work


def _render(mod, info, **kw):
    out = io.StringIO()
    mod.render(info, file=out, **kw)
    return out.getvalue()


def test_survey_report_sections_equal_jax(survey_dir, monkeypatch):
    monkeypatch.setattr(roofline, "device_peaks",
                        lambda **kw: dict(PEAKS))
    monkeypatch.setattr(jroofline, "device_peaks",
                        lambda **kw: dict(PEAKS))
    info, jinfo = report.collect(survey_dir), jreport.collect(survey_dir)
    for key in ("manifest", "spans", "flightrec", "tuning", "quality"):
        assert info[key] == jinfo[key], key
    assert info["kernel_costs"]["kinds"] == jinfo["kernel_costs"]["kinds"]
    assert info["kernel_costs"]["roofline"] == \
        jinfo["kernel_costs"]["roofline"]
    assert info["kernel_costs"]["peaks_source"] == "tuning DB"
    text, jtext = _render(report, info), _render(jreport, jinfo)
    sec, jsec = _sections(text), _sections(jtext)
    assert list(sec) == list(jsec)
    assert {"Journal", "Spans", "Flight recorder", "Tuning provenance",
            "Roofline", "Data quality"} <= set(sec)
    for name in sec:
        if name == "Roofline":
            continue
        assert sec[name] == jsec[name], name
    # the roofline: the same rows and dedispersion callout (the JAX
    # one names a TPU work item), and the port's analytic totals
    rows = [ln for ln in sec["Roofline"] if ln.startswith("  ")
            and not ln.startswith("    ")
            and not ln.startswith("  analytic totals")]
    jrows = [ln.replace(" — the Hot-loop-v2 gating number", "")
             for ln in jsec["Roofline"] if ln.startswith("  ")]
    assert rows == jrows
    assert any("dedispersion HBM-byte share" in ln for ln in rows)
    totals = [ln for ln in sec["Roofline"] if ln.startswith("    ")]
    kinds = json.load(open(os.path.join(survey_dir,
                                        "kernel_costs.json")))["kinds"]
    assert len(totals) == sum(1 for e in kinds.values()
                              if e.get("flops_total") is not None) > 0
    assert all("(analytic)" in ln for ln in totals)


def test_survey_report_without_cached_peaks(survey_dir, monkeypatch):
    """No peaks in the file and none cached: the report runs no device
    work and renders intensities only, as the JAX report does without a
    backend."""
    calls = []

    def peaks(**kw):
        calls.append(kw)
        return None
    monkeypatch.setattr(roofline, "device_peaks", peaks)
    info = report.collect(survey_dir)
    assert calls == [{"measure": False}]
    text = _render(report, info)
    assert "no device peaks available" in text
    assert report.main([survey_dir, "-json"]) == 0


def _fleet(fleetdir):
    """A fleet directory written by the port: two jobs committed by a
    replica (usage rows), an SLO spec, replica snapshots with dispatch,
    cost and kernel-launch counters, and a supervisor's registry and
    events from the port's FleetSupervisor on a fake process table."""
    from presto_tpu_torch.obs import fleetagg, slo
    from presto_tpu_torch.obs.metrics import MetricsRegistry
    from presto_tpu_torch.serve import supervisor as psup
    from presto_tpu_torch.serve.jobledger import JobLedger
    led = JobLedger(fleetdir)
    led.join("r1")
    for i in range(3):
        led.admit({"rawfiles": ["x"], "config": {"lodm": 1.0}},
                  job_id="j%d" % i)
    for _ in range(2):
        lease = led.lease("r1", ttl=60.0)
        led.complete(lease, "r1", {})
    slo.save_specs(fleetdir, [slo.parse_spec("default:0.95")])
    reg = MetricsRegistry()
    reg.counter("jax_dispatches_total", "d", ("kind",)).labels(
        kind="accel_search").inc(3)
    reg.counter("kernel_flops_total", "f", ("kind",)).labels(
        kind="accel_search").inc(3e12)
    reg.counter("kernel_hbm_bytes_total", "b", ("kind",)).labels(
        kind="accel_search").inc(2e11)
    reg.counter("cuda_kernel_launches_total", "l", ("kernel",)).labels(
        kernel="plane_build").inc(24)
    reg.counter("cuda_kernel_launches_total", "l", ("kernel",)).labels(
        kernel="stage_reduce").inc(24)
    h = reg.histogram("job_e2e_seconds", "e", ("phase",))
    h.labels(phase="total").observe(3.0)
    fleetagg.publish_snapshot(fleetdir, "r1", SimpleNamespace(metrics=reg))

    class Fake(psup.FleetSupervisor):
        def _popen(self, name, argv):
            return 4242

        def _alive(self, name, pid):
            return pid is not None

        def _signal(self, name, pid, sig):
            pass

        def _reap(self, name):
            pass
    sup = Fake(psup.SupervisorConfig(fleetdir=fleetdir,
                                     router_url="http://x"))
    sup._fetch_advice = lambda: {"wanted_replicas": 1, "reason": "min",
                                 "inputs": {"backlog_jobs": 1}}
    sup.step(now=10.0)
    sup.step(now=11.0)
    sup.ledger.heartbeat("sup-0001", 0, now=12.0)
    sup.step(now=12.5)
    sup._fetch_advice = lambda: {"wanted_replicas": 3, "reason": "b",
                                 "inputs": {}}
    sup.step(now=13.0)
    sup.events.close()
    return fleetdir


def test_fleet_report_sections_equal_jax(tmp_path):
    fleetdir = _fleet(str(tmp_path / "fleet"))
    info, jinfo = report.collect_fleet(fleetdir), \
        jreport.collect_fleet(fleetdir)
    for key in ("ledger", "job_e2e", "dispatches", "usage", "supervisor",
                "dags"):
        assert info.get(key) == jinfo.get(key), key
    assert info["scale"]["wanted_replicas"] == \
        jinfo["scale"]["wanted_replicas"]
    assert info["kernel_launches"] == {
        "merged": {"plane_build": 24, "stage_reduce": 24},
        "replicas": {"r1": {"plane_build": 24, "stage_reduce": 24}}}
    assert "kernel_launches" not in jinfo
    out, jout = io.StringIO(), io.StringIO()
    report.render_fleet(info, file=out)
    jreport.render_fleet(jinfo, file=jout)
    sec, jsec = _sections(out.getvalue()), _sections(jout.getvalue())
    assert [s for s in sec if s != "CUDA kernel launches"] == list(jsec)
    assert "CUDA kernel launches" in sec
    for name in ("Supervisor", "Fleet job_e2e_seconds", "Device dispatches",
                 "Usage", "SLO observatory", "Scale advisory"):
        assert sec[name] == jsec[name], name
    assert any("spawn" in ln and "sup-0001" in ln
               for ln in sec["Supervisor"])
    assert report.main(["-fleet", fleetdir]) == 0
