"""The port's observability catalog (obs/taxonomy) — its stand-in for the
JAX package's obs_lint.

The kill-point tuples the port fires (testing/chaos, stream/beams,
serve/federation, the survey's `_chaos` points, the elastic cluster's)
equal the catalog's sets; every literal event kind, span name and
metric name in the port's serve/, stream/, obs/ and pipeline/survey.py
is in the catalog; and the catalog equals the JAX package's except for
the differences listed in CHANGES below (which obs/taxonomy.PORT_CHANGES
must list too)."""

import glob
import os
import re

import pytest

from presto_tpu.obs import taxonomy as jtax

from presto_tpu_torch.obs import taxonomy as tax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "presto_tpu_torch")

#: every difference from the JAX catalog: {set: (added, removed)}
CHANGES = {
    "STREAM_EVENTS": ({"stream-fail"}, set()),
    "METRICS": ({"cuda_kernel_launches_total"}, set()),
    "DEVICE_METRICS": ({"cuda_kernel_launches_total", "jax_compiles_total",
                        "jax_compile_seconds", "jax_dispatches_total",
                        "jax_device_put_bytes_total",
                        "jax_device_get_bytes_total",
                        "jax_donated_bytes_total", "jax_live_buffer_bytes",
                        "jax_live_buffer_hwm_bytes"}, set()),
    "SURVEY_SPANS": ({"survey"}, set()),
    "FLEET_KILL_POINTS": ({"job-leased", "batch-leased", "job-enqueued",
                           "mid-fold", "mid-triage", "fold-fanout",
                           "post-sift-commit"}, set()),
}

EMIT_RE = re.compile(r'events\.emit\(\s*\n?\s*"([^"]+)"')
OBS_EVENT_RE = re.compile(r'obs\.event\(\s*\n?\s*"([^"]+)"')
EVENT_ATTR_RE = re.compile(r'^\s*EV_[A-Z_]+\s*=\s*"([^"]+)"', re.M)
SPAN_RE = re.compile(r'\.span\(\s*\n?\s*"([^"]+)"')
METRIC_RE = re.compile(
    r'\.(?:counter|gauge|histogram)\(\s*\n?\s*"([a-z0-9_]+)"')
CHAOS_RE = re.compile(r'_chaos\(\s*cfg\s*,\s*"([^"]+)"')
POINT_RE = re.compile(r'\._point\(\s*\n?\s*"([^"]+)"')


def _sets(mod):
    return {n: getattr(mod, n) for n in dir(mod)
            if n.isupper() and isinstance(getattr(mod, n), (frozenset,
                                                            dict))
            and n != "PORT_CHANGES"}


def _all(suffix):
    out = set()
    for name, val in _sets(tax).items():
        if name.endswith(suffix) and isinstance(val, frozenset):
            out |= val
    return out


def _sources(where):
    if where.endswith(".py"):
        return [os.path.join(PKG, where)]
    return sorted(p for p in glob.glob(os.path.join(PKG, where, "*.py"))
                  if os.path.basename(p) != "taxonomy.py")


def test_catalog_equals_jax_up_to_the_listed_changes():
    port, ref = _sets(tax), _sets(jtax)
    for name in sorted(set(port) | set(ref)):
        added, removed = CHANGES.get(name, (set(), set()))
        want = set(ref.get(name, ()))
        if isinstance(ref.get(name), dict):
            assert port[name] == ref[name], name
            continue
        assert set(port.get(name, ())) == (want | added) - removed, name
    assert {k: (set(v["added"]), set(v["removed"]))
            for k, v in tax.PORT_CHANGES.items()} == CHANGES


def test_kill_point_tuples_equal_the_catalog():
    from presto_tpu_torch.serve import federation
    from presto_tpu_torch.stream import beams
    from presto_tpu_torch.testing import chaos
    assert set(chaos.BEAM_KILL_POINTS) == set(beams.BEAM_KILL_POINTS) \
        == tax.BEAM_KILL_POINTS
    assert chaos.BEAM_KILL_POINTS == beams.BEAM_KILL_POINTS
    assert set(chaos.FED_KILL_POINTS) == set(federation.FED_KILL_POINTS) \
        == tax.FED_KILL_POINTS
    assert chaos.FED_KILL_POINTS == federation.FED_KILL_POINTS
    assert set(chaos.FLEET_KILL_POINTS) == tax.FLEET_KILL_POINTS
    for tup in (chaos.BEAM_KILL_POINTS, chaos.FED_KILL_POINTS,
                chaos.FLEET_KILL_POINTS):
        assert len(set(tup)) == len(tup)
    src = open(os.path.join(PKG, "pipeline", "survey.py")).read()
    assert set(CHAOS_RE.findall(src)) <= tax.KILL_POINTS
    assert tax.SHARDED_KILL_POINTS <= set(CHAOS_RE.findall(src))
    elastic = open(os.path.join(PKG, "parallel", "elastic.py")).read()
    assert set(POINT_RE.findall(elastic)) == tax.CLUSTER_KILL_POINTS
    fed = open(os.path.join(PKG, "serve", "federation.py")).read()
    assert set(POINT_RE.findall(fed)) == tax.FED_KILL_POINTS


WHERE = ("serve", "stream", "obs", "pipeline/survey.py")


@pytest.mark.parametrize("where", WHERE)
def test_event_kinds_are_catalogued(where):
    events = _all("_EVENTS") | set(tax.JOB_STATE_EVENTS.values())
    found = set()
    for path in _sources(where):
        src = open(path).read()
        found |= set(EMIT_RE.findall(src)) | set(OBS_EVENT_RE.findall(src)) \
            | set(EVENT_ATTR_RE.findall(src))
    # obs/ has no literal kinds of its own but the flight recorder's
    assert found - events == set(), sorted(found - events)


@pytest.mark.parametrize("where", WHERE)
def test_span_names_are_catalogued(where):
    found = set()
    for path in _sources(where):
        found |= set(SPAN_RE.findall(open(path).read()))
    assert found - _all("_SPANS") == set(), sorted(found - _all("_SPANS"))


@pytest.mark.parametrize("where", WHERE)
def test_metric_names_are_catalogued(where):
    found = set()
    for path in _sources(where):
        found |= set(METRIC_RE.findall(open(path).read()))
    assert found - tax.METRICS == set(), sorted(found - tax.METRICS)


def test_new_modules_speak_the_catalog():
    """The supervisor's, the federation's and the tune CLI's own names
    are all present and each control-plane set is exactly what its
    module emits."""
    sup = open(os.path.join(PKG, "serve", "supervisor.py")).read()
    fed = open(os.path.join(PKG, "serve", "federation.py")).read()
    assert set(SPAN_RE.findall(sup)) == tax.SUPERVISOR_SPANS | {
        "campaign:preempt"}
    assert set(METRIC_RE.findall(sup)) == tax.SUPERVISOR_METRICS | {
        "campaign_preemptions_total"}
    kinds = set(EMIT_RE.findall(sup)) | set(OBS_EVENT_RE.findall(sup))
    assert kinds == tax.SUPERVISOR_EVENTS | {"campaign-preempt"}
    assert set(SPAN_RE.findall(fed)) == tax.FED_SPANS
    assert set(METRIC_RE.findall(fed)) == tax.FED_METRICS
    assert (set(EMIT_RE.findall(fed)) | set(EVENT_ATTR_RE.findall(fed))) \
        == tax.FED_EVENTS
    tune_app = open(os.path.join(PKG, "apps", "tune.py")).read()
    assert set(SPAN_RE.findall(tune_app)) <= tax.TUNE_SPANS
    assert tax.DEVICE_METRICS <= tax.METRICS
    for sub in ("SUPERVISOR_SPANS", "CAMPAIGN_SPANS", "FED_SPANS",
                "TRIAGE_SPANS", "DAG_SPANS", "FLEET_SPANS", "SLO_SPANS"):
        assert getattr(tax, sub) <= tax.SERVE_SPANS, sub
