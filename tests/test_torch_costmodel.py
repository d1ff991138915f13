"""obs/{devtel, costmodel, roofline}: the port's dispatch telemetry,
analytic cost book and roofline against the JAX package's
presto_tpu/obs/{jaxtel, costmodel, roofline}.

Each kind's analytic count equals a hand count; a dispatch joins its
kind's unit cost onto the counters and the current span (backfilled
when the probe comes later); the book's snapshot and kernel_costs.json
carry the JAX package's keys; classify and roofline_rows equal the JAX
package's on the same inputs; devtel's counters keep jaxtel's names and
its transfer snapshot jaxtel's keys; a survey with observability on
writes the book beside its artifacts, every device kind in it."""

import math
import os

import numpy as np
import pytest
import torch

from presto_tpu.obs import Observability as JObservability
from presto_tpu.obs import ObsConfig as JObsConfig
from presto_tpu.obs import costmodel as jcostmodel
from presto_tpu.obs import jaxtel
from presto_tpu.obs import roofline as jroofline

from presto_tpu_torch.obs import (Observability, ObsConfig, costmodel,
                                  devtel, roofline)
from presto_tpu_torch.search import build_cuda


def _obs():
    return Observability(ObsConfig(enabled=True))


# ----------------------------------------------------------------------
# analytic counts
# ----------------------------------------------------------------------

def test_plane_build_count_by_hand():
    # n = 8192 (log2 13: radix 16, 16, 16, 2 -> twiddles 16 + 256 + 4096)
    assert costmodel.twiddle_count(8192) == 16 + 256 + 4096 == \
        build_cuda._twiddle_table(8192, "cpu").numel()
    nbytes, flops = costmodel.plane_build_work(
        nblocks=3, numz=5, n=8192, uselen=6000, numz_pad=8, numr=20000)
    assert nbytes == 3 * 4096 * 8 + 5 * 8192 * 8 + 4368 * 8 + 8 * 20000 * 4
    assert flops == pytest.approx(3 * 5 * (6 * 8192 + 5 * 8192 * 13
                                           + 3 * 6000))
    unit = costmodel.analytic("plane_build", nblocks=3, numz=5, n=8192,
                              uselen=6000, numz_pad=8, numr=20000)
    assert (unit.flops, unit.hbm_bytes) == (flops, nbytes)
    assert unit.argument_bytes + unit.output_bytes == nbytes - 4368 * 8
    assert unit.source == "analytic"


def test_stage_reduce_count_by_hand():
    # 4 stages: 7 harmonic terms + 4 compares per plane element
    nbytes, flops = costmodel.stage_reduce_work(
        nrows=208, numr=1 << 20, nslabs=3, slab=1 << 18, nstages=4,
        nzmaps=7 * 208)
    assert nbytes == (208 * (1 << 20) + 3 + 7 * 208) * 4 \
        + 2 * 3 * 4 * (1 << 18) * 4
    assert flops == 3 * (1 << 18) * 208 * (7 + 4)


def test_rfft_dedisp_and_sp_counts_by_hand():
    u = costmodel.analytic("rfft_batch", rows=6, n=4096)
    assert u.flops == pytest.approx(6 * 5 * 4096 * 12 / 2)
    assert u.hbm_bytes == 6 * 4096 * 4 + 6 * 2048 * 8
    d = costmodel.analytic("dedisp", numdms=24, nsub=32, nchan=128,
                           numpts=1 << 17)
    n = 1 << 17
    assert d.flops == 128 * n + 24 * 32 * n
    assert d.hbm_bytes == (2 * 128 * n * 4 + 32 * n * 4
                           + 2 * 32 * n * 4 + 24 * n * 4)
    b = costmodel.analytic("beam_dedisp", numdms=24, nsub=32, nchan=128,
                           numpts=n, beams=13)
    assert (b.flops, b.hbm_bytes) == (13 * d.flops, 13 * d.hbm_bytes)
    s = costmodel.analytic("sp_search", nf=2, N=8000, nwidths=3,
                           chunklen=3000, fftlen=4096)
    nchunks = 3
    want = (4.0 * 2 * 8000
            + 2 * nchunks * (4 * 5 * 4096 * 12 / 2 + 3 * 6 * 2049))
    assert s.flops == pytest.approx(want)
    with pytest.raises(KeyError, match="no analytic cost"):
        costmodel.analytic("mystery", n=1)


def test_accel_search_count_is_its_kernels_and_spectra():
    from presto_tpu_torch.search.accel import AccelConfig, AccelSearch
    s = AccelSearch(AccelConfig(zmax=4, numharm=2), T=8.192, numbins=4096,
                    device="cpu")
    shape = costmodel.searcher_shape(s, 3)
    pb, sr = costmodel.kernel_shapes(shape)
    a = costmodel.analytic("accel_search", **shape)
    p = costmodel.analytic("plane_build", **pb)
    r = costmodel.analytic("stage_reduce", **sr)
    fwd = shape["nblocks"] * 5 * (shape["n"] // 2) * math.log2(
        shape["n"] // 2)
    assert a.flops == pytest.approx(3 * (p.flops + r.flops + fwd))
    assert a.hbm_bytes == 3 * (p.hbm_bytes + r.hbm_bytes
                               + shape["numbins"] * 8
                               + shape["nblocks"] * shape["n"] // 2 * 8)
    assert shape["nzmaps"] == s._zinds.numel()


# ----------------------------------------------------------------------
# the dispatch join
# ----------------------------------------------------------------------

def test_dispatch_join_counters_span_and_backfill():
    obs = _obs()
    devtel.note_dispatch(obs, "rfft_batch", 2)       # before the probe
    unit = costmodel.probe(obs, "rfft_batch", rows=4, n=1024)
    reg = obs.metrics
    assert reg.get("kernel_flops_total").labels(
        kind="rfft_batch").value == pytest.approx(2 * unit.flops)
    sp = obs.span("chunk")
    devtel.note_dispatch(obs, "rfft_batch", 3)
    assert sp.attrs["flops"] == pytest.approx(3 * unit.flops)
    assert sp.attrs["hbm_bytes"] == pytest.approx(3 * unit.hbm_bytes)
    sp.finish()
    assert reg.get("kernel_hbm_bytes_total").labels(
        kind="rfft_batch").value == pytest.approx(5 * unit.hbm_bytes)
    # once per shape: the same shape is not probed again
    n_spans = len([s for s in obs.tracer.finished()
                   if s.name == "obs:roofline-probe"])
    costmodel.probe(obs, "rfft_batch", rows=4, n=1024)
    assert len([s for s in obs.tracer.finished()
                if s.name == "obs:roofline-probe"]) == n_spans
    # a disabled handle is inert
    off = Observability(ObsConfig())
    assert costmodel.probe(off, "rfft_batch", rows=1, n=8) is None
    devtel.note_dispatch(off, "rfft_batch")
    assert costmodel.snapshot(off) == {}
    with pytest.raises(KeyError):
        costmodel.probe(obs, "mystery", n=1)


def test_snapshot_and_costs_file_keep_the_jax_schema(tmp_path):
    """The port's book and the JAX book over one dispatch of a kind:
    the same snapshot keys at every level, the same file schema."""
    import jax
    obs, jobs = _obs(), JObservability(JObsConfig(enabled=True))
    costmodel.probe(obs, "rfft_batch", rows=3, n=512)
    devtel.note_dispatch(obs, "rfft_batch", 2)
    jcostmodel.probe(jobs, "rfft_batch", jax.jit(lambda x: x.sum()),
                     np.ones((3, 512), np.float32))
    jaxtel.note_dispatch(jobs, "rfft_batch", 2)
    snap, jsnap = costmodel.snapshot(obs), jcostmodel.snapshot(jobs)
    assert sorted(snap) == sorted(jsnap)
    assert sorted(snap["kinds"]["rfft_batch"]) == \
        sorted(jsnap["kinds"]["rfft_batch"])
    assert snap["schema"] == jsnap["schema"] == jcostmodel.COSTS_SCHEMA
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(a)
    os.makedirs(b)
    db = str(tmp_path / "tune.json")
    assert costmodel.write_costs(obs, a, db_path=db) is not None
    jcostmodel.write_costs(jobs, b)
    got, jgot = costmodel.load_costs(a), jcostmodel.load_costs(b)
    assert sorted(got) == sorted(jgot)
    assert got["peaks"] is None          # nothing measured for this card
    assert got["kinds"]["rfft_batch"]["dispatches"] == 2
    with open(os.path.join(a, "kernel_costs.json"), "w") as f:
        f.write("{nope")
    assert costmodel.load_costs(a) is None
    # flush writes the book beside the spans
    obs.flush(default_dir=str(tmp_path / "flush"))
    assert costmodel.load_costs(str(tmp_path / "flush")) is not None


def test_flush_raises_when_the_cost_book_cannot_be_written(tmp_path):
    """A cost book that cannot be written fails the flush (nothing goes
    on without it); with nothing probed there is no book to write."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    _obs().flush(default_dir=str(blocker))
    obs = _obs()
    costmodel.probe(obs, "rfft_batch", rows=3, n=512)
    with pytest.raises(OSError):
        obs.flush(default_dir=str(blocker))


# ----------------------------------------------------------------------
# roofline
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flops, nbytes", [(1e6, 1e6), (1e8, 1e6),
                                           (1e7, 1e6), (1.0, 0.0),
                                           (5.0, 3.0)])
def test_classify_equals_jax(flops, nbytes):
    peaks = {"flops_per_s": 1e12, "bytes_per_s": 1e11}
    assert roofline.classify(flops, nbytes, peaks) == \
        jroofline.classify(flops, nbytes, peaks)
    assert roofline.classify(flops, nbytes, {}) is None


def test_roofline_rows_equal_jax():
    costs = {"kinds": {
        "dedisp": {"dispatches": 4, "flops_per_dispatch": 100.0,
                   "hbm_bytes_per_dispatch": 1000.0,
                   "flops_total": 400.0, "hbm_bytes_total": 4000.0},
        "plane_build": {"dispatches": 2, "flops_per_dispatch": 5e9,
                        "hbm_bytes_per_dispatch": 1e8,
                        "flops_total": 1e10, "hbm_bytes_total": 2e8},
        "mystery": {"dispatches": 2}}}
    for peaks in ({"flops_per_s": 6.7e13, "bytes_per_s": 3.35e12}, None):
        assert roofline.roofline_rows(costs, peaks) == \
            jroofline.roofline_rows(costs, peaks)


def test_peaks_cached_in_the_db_and_measured_on_a_card_only(tmp_path):
    from presto_tpu_torch.tune.db import TuneDB, fingerprint_key
    db = str(tmp_path / "tune.json")
    assert roofline.device_peaks(db_path=db, measure=False) is None
    rec = {"flops_per_s": 5e13, "bytes_per_s": 3e12,
           "ridge_intensity": 5e13 / 3e12, "matmul_s": 0.02}
    t = TuneDB()
    t.record(fingerprint_key(), roofline.FAMILY, roofline.SHAPE_KEY, rec,
             0.02)
    t.save(db)
    assert roofline.device_peaks(db_path=db, measure=False) == rec
    assert roofline.FAMILY == jroofline.FAMILY
    assert roofline.SHAPE_KEY == jroofline.SHAPE_KEY
    with pytest.raises(ValueError, match="CUDA device"):
        roofline.measure_peaks(device="cpu")


# ----------------------------------------------------------------------
# devtel against jaxtel
# ----------------------------------------------------------------------

def test_devtel_names_and_snapshot_equal_jaxtel():
    obs, jobs = _obs(), JObservability(JObsConfig(enabled=True))
    for mod, o in ((devtel, obs), (jaxtel, jobs)):
        mod.note_compile(o, "accel", 0.5, key="k", device="d")
        mod.note_put(o, 1000)
        mod.note_get(o, 300)
        mod.note_donation(o, 64)
        mod.note_dispatch(o, "sp_search", 3)
    snap, jsnap = devtel.transfer_snapshot(obs), \
        jaxtel.transfer_snapshot(jobs)
    assert snap == jsnap
    want = {"jax_compiles_total", "jax_compile_seconds",
            "jax_dispatches_total", "jax_device_put_bytes_total",
            "jax_device_get_bytes_total", "jax_donated_bytes_total"}
    for name in want:
        assert obs.metrics.get(name) is not None, name
        assert jobs.metrics.get(name) is not None, name
    assert devtel.transfer_snapshot(Observability(ObsConfig())) == \
        jaxtel.transfer_snapshot(JObservability(JObsConfig()))
    assert devtel.device_id("cpu") == "cpu_0"
    assert devtel.sample_live_buffers(obs, "cpu") is None
    assert devtel.device_id("cuda:1") == "cuda_1"
    if not torch.cuda.is_available():
        assert devtel.current_device_id() == "cpu_0"
        # a cuda service's plans are named without a card (the scheduler
        # evicts by it on an injected device error)
        assert devtel.device_id("cuda") == "cuda_0"


def test_build_telemetry_books_an_nvcc_run():
    """A kernel library's build is booked on the process default handle
    once obs.configure enables it."""
    from presto_tpu_torch import obs as tobs
    devtel.note_build("plane_build", 1.0)      # the disabled default
    handle = tobs.configure(ObsConfig(enabled=True))
    try:
        devtel.note_build("plane_build", 4.5)
    finally:
        tobs.configure(ObsConfig())
    fam = handle.metrics.get("jax_compiles_total")
    assert fam.labels(kind="nvcc:plane_build").value == 1
    assert handle.metrics.get("jax_compile_seconds").labels(
        kind="nvcc:plane_build").sum == 4.5


def test_survey_writes_its_cost_book(tmp_path):
    """A small survey with observability on: kernel_costs.json beside
    its artifacts with every device kind of the path, the dispatch
    counts and non-zero costs; the same artifacts as the run without."""
    from presto_tpu_torch.models import synth
    from presto_tpu_torch.pipeline import survey
    raw = str(tmp_path / "psr.fil")
    synth.fake_filterbank_file(raw, 1 << 13, 2e-4, 16, 400.0, 1.0,
                               synth.FakeSignal(f=17.0, dm=10.0,
                                                shape="gauss", width=0.08,
                                                amp=0.8),
                               noise_sigma=2.0, seed=5)
    kw = dict(lodm=5.0, hidm=12.0, nsub=16, zmax=0, numharm=2, sigma=3.0,
              fold_top=0, rfi_time=0.4, singlepulse=True)
    on, off = str(tmp_path / "on"), str(tmp_path / "off")
    survey.run_survey([raw], survey.SurveyConfig(
        obs=ObsConfig(enabled=True), **kw), on, device="cpu")
    survey.run_survey([raw], survey.SurveyConfig(**kw), off, device="cpu")
    costs = costmodel.load_costs(on)
    kinds = costs["kinds"]
    for kind in ("dedisp", "rfft_batch", "accel_search", "plane_build",
                 "stage_reduce", "sp_search"):
        assert kinds[kind]["dispatches"] > 0, kind
        assert kinds[kind]["flops_total"] > 0, kind
        assert kinds[kind]["hbm_bytes_total"] > 0, kind
    assert kinds["plane_build"]["dispatches"] == \
        kinds["stage_reduce"]["dispatches"] == len(
            [f for f in os.listdir(on) if f.endswith(".dat")])
    assert not os.path.exists(os.path.join(off, "kernel_costs.json"))
    for f in sorted(os.listdir(off)):
        if f.endswith((".dat", ".fft", ".singlepulse", ".cand")) \
                or "_ACCEL_" in f or f == "cands_sifted.txt":
            assert open(os.path.join(on, f), "rb").read() == \
                open(os.path.join(off, f), "rb").read(), f
    assert os.path.exists(os.path.join(on, "trace.perfetto.json"))
