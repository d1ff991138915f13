"""perf_gate's smoke statistic: on the CPU the host clock's samples (the
JAX tool's statistic, kept), on a card device samples from
_device_samples, whose head start doubles until the host has queued a
sample's calls before the first one starts (held here with a timer that
stands in for the CUDA events)."""

import pytest

from presto_tpu_torch.apps import perf_gate


class FakeTimer:
    """timer.span's contract: (ms a call, ahead); the host is 'ahead'
    once the head start reaches ``needs_ms``."""

    def __init__(self, needs_ms, ms=0.25):
        self.needs_ms, self.ms = needs_ms, ms
        self.heads = []

    def span(self, fn, reps, head_ms):
        for _ in range(reps):
            fn()
        self.heads.append(head_ms)
        return self.ms, head_ms >= self.needs_ms


def test_head_start_doubles_until_the_host_is_ahead():
    calls = []
    timer = FakeTimer(needs_ms=35.0)
    samples, head = perf_gate._device_samples(
        lambda: calls.append(1), 5, timer, reps=3, head_ms=10.0, tries=4)
    assert samples == [0.25e-3] * 5
    assert head == 40.0
    # the warm span took three tries (10, 20, 40 ms), the samples one each
    assert timer.heads == [10.0, 20.0, 40.0] + [40.0] * 5
    assert len(calls) == 3 * len(timer.heads)


def test_a_host_never_ahead_raises():
    timer = FakeTimer(needs_ms=1e9)
    with pytest.raises(RuntimeError, match="did not queue"):
        perf_gate._device_samples(lambda: None, 5, timer, reps=2,
                                  head_ms=1.0, tries=3)
    assert timer.heads == [1.0, 2.0, 4.0]


def test_cpu_episode_keeps_the_host_statistic():
    ep = perf_gate.measure_smoke(k=3, device="cpu")
    metrics, meta = ep["metrics"], ep["meta"]
    assert meta["statistic"] == "host"
    assert "host_samples_s" not in meta
    for key, name in (("accel", "smoke_accel_cells_per_sec"),
                      ("dedisp", "smoke_dedisp_trials_per_sec")):
        samples = meta["samples_s"][key]
        assert len(samples) == 3 and min(samples) > 0
        assert metrics[name]["k"] == 3
