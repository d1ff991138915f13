"""The port stands alone: importing every module of presto_tpu_torch
loads neither jax nor any presto_tpu module, and an entry point called
without device= (the search, the survey, the accelsearch CLI, the polish)
needs a CUDA device."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, os, pkgutil, sys
import torch
import presto_tpu_torch
mods = []
for m in pkgutil.walk_packages(presto_tpu_torch.__path__, "presto_tpu_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
assert len(mods) >= 20, mods
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu.")
             or m == "tools" or m.startswith("tools."))
assert not bad, bad
if not torch.cuda.is_available():
    import numpy as np
    from presto_tpu_torch.apps import accelsearch
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.search import accel, polish
    cfg = survey.SurveyConfig(skip_rfifind=True, singlepulse=False,
                              fold_top=0)
    for call in (lambda: accel.AccelSearch(accel.AccelConfig(zmax=20),
                                           T=10.0, numbins=1 << 15),
                 lambda: survey.survey_head("missing.fil", cfg),
                 lambda: survey.run_survey(["missing.fil"], cfg, "."),
                 lambda: accelsearch.main(["missing.fft"]),
                 lambda: polish.optimize_accelcands(
                     np.ones(64, np.complex64),
                     [accel.AccelCand(1.0, 1.0, 1, 10.0, 0.0)], 10.0,
                     [1.0])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("ISOLATED", len(mods))
"""


FOLD_SCRIPT = r"""
import sys
import torch
from presto_tpu_torch.apps import get_toas, prepfold
from presto_tpu_torch.ops import fold
from presto_tpu_torch.search import prepfold as spf
import presto_tpu_torch.astro.observatory, presto_tpu_torch.io.bestprof
import presto_tpu_torch.timing
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu."))
assert not bad, bad
if not torch.cuda.is_available():
    for call in (lambda: prepfold.main(["-f", "10", "-noplot", "x.dat"]),
                 lambda: get_toas.main(["x.pfd"]),
                 lambda: get_toas.toa_lines(["x.pfd"]),
                 lambda: prepfold.fold_dat_cands(
                     [prepfold.DatFoldSpec("x.dat", "x.cand", 1, "o")])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("FOLD ISOLATED")
"""


def test_fold_and_toa_modules_stand_alone_and_need_cuda():
    """The fold and TOA modules import neither jax nor presto_tpu, and
    prepfold.main, get_toas.main / toa_lines and fold_dat_cands called
    without device= raise without a card (before touching any file)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", FOLD_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOLD ISOLATED" in out.stdout


INGEST_SCRIPT = r"""
import sys
import torch
from presto_tpu_torch.apps import rfifind
from presto_tpu_torch.io import maskfile, native, quality, sigproc
from presto_tpu_torch.pipeline import fusion, survey
from presto_tpu_torch.search import rfifind as srfi
from presto_tpu_torch.utils import ranges
from presto_tpu_torch import cuda_build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu."))
assert not bad, bad
assert not cuda_build._libs, "a library was built at import"
if not torch.cuda.is_available():
    import numpy as np
    cfg = survey.SurveyConfig(singlepulse=False, fold_top=0)
    assert cfg.skip_rfifind is False
    for call in (lambda: rfifind.main(["-noplot", "missing.fil"]),
                 lambda: srfi.rfifind(np.zeros((64, 4), np.float32), 1e-3,
                                      1400.0, 1.0, ptsperint=16),
                 lambda: survey.run_survey(["missing.fil"], cfg, "."),
                 lambda: fusion.UploadRing(2, 8, 4, "cuda")):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e) or "accelerator" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("INGEST ISOLATED")
"""


def test_ingest_and_rfifind_modules_stand_alone_and_need_cuda():
    """The ingest and rfifind modules (io/native, quality, maskfile,
    sigproc, pipeline/fusion, search and apps rfifind, utils/ranges)
    import neither jax nor presto_tpu and build nothing at import; the
    rfifind entry points, the default survey (stage 1 on) and the pinned
    upload ring called without device= raise without a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", INGEST_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "INGEST ISOLATED" in out.stdout


SP_SCRIPT = r"""
import sys
import torch
from presto_tpu_torch.apps import make_spd, rrattrap, single_pulse_search
from presto_tpu_torch.pipeline import survey
from presto_tpu_torch.search import singlepulse
from presto_tpu_torch.singlepulse import grouping, spd, waterfaller
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu."))
assert not bad, bad
cfg = survey.SurveyConfig(fold_top=0)
assert cfg.singlepulse is True
survey._refuse_unported(cfg)
if not torch.cuda.is_available():
    for call in (lambda: singlepulse.SinglePulseSearch(),
                 lambda: single_pulse_search.main(["-p", "missing.dat"]),
                 lambda: survey.run_survey(["missing.fil"], cfg, "."),
                 lambda: survey.disk_singlepulse(["missing.dat"], cfg)):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("SP ISOLATED")
"""


def test_single_pulse_modules_stand_alone_and_need_cuda():
    """The single-pulse modules (search, CLI, survey stages 9a/9, the
    grouping, waterfaller and .spd toolchain, rrattrap and make_spd)
    import neither jax nor presto_tpu; the survey no longer refuses
    singlepulse=True; the search, the CLI and the survey's stages called
    without device= raise without a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", SP_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SP ISOLATED" in out.stdout


PARALLEL_SCRIPT = r"""
import sys
import torch
from presto_tpu_torch.apps import common, prepsubband
from presto_tpu_torch.parallel import elastic, mesh, sharded
from presto_tpu_torch.pipeline import fusion, leaseledger, shardledger, survey
from presto_tpu_torch.testing import chaos
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu."))
assert not bad, bad
assert mesh.make_mesh(device="cpu").size == 1
with mesh.set_logical_devices(4, "cpu"):
    assert mesh.make_mesh(device="cpu").size == 4
cfg = survey.SurveyConfig(fold_top=0, elastic=True,
                          fault_injector=chaos.FaultInjector(mode="off"))
survey._refuse_unported(cfg)
if not torch.cuda.is_available():
    argv = ["-coordinator", "localhost:1", "-nproc", "2", "-procid", "0",
            "-nobary", "missing.fil"]
    for call in (lambda: mesh.make_mesh(),
                 lambda: mesh.visible_devices(),
                 lambda: mesh.set_logical_devices(2).__enter__(),
                 lambda: prepsubband.main(argv),
                 lambda: prepsubband.main(["-elastic"] + argv)):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
    assert not torch.distributed.is_initialized()
print("PARALLEL ISOLATED")
"""


def test_parallel_modules_stand_alone_and_need_cuda():
    """The sharding, elastic, ledger and chaos modules import neither jax
    nor presto_tpu; the survey no longer refuses elastic runs or a fault
    injector; make_mesh() (and visible_devices, the logical-shard
    context) and prepsubband -coordinator (and -elastic) called without
    device= raise without a card, before joining any process group."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PARALLEL ISOLATED" in out.stdout


STREAM_SCRIPT = r"""
import sys, threading
import numpy as np
import torch
from presto_tpu_torch import obs, serve, stream
from presto_tpu_torch.io import sigproc
from presto_tpu_torch.stream import beams, service
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu."))
assert not bad, bad
hdr = sigproc.FilterbankHeader(nbits=32, nchans=16, nifs=1, tsamp=1e-3,
                               fch1=400.0, foff=-1.0)
cfg = stream.StreamConfig(lodm=10.0, dmstep=5.0, numdms=4, nsub=8,
                          blocklen=4096)
cb, db = np.zeros(16, np.int32), np.zeros((4, 8), np.int32)
svc = serve.SearchService("stream_isolation_work")
src = stream.RingBlockSource()
on_cpu = (lambda: stream.StreamSearch(hdr, cfg, device="cpu"),
          lambda: stream.RollingDedisp(cb, db, 8, device="cpu"),
          lambda: stream.StackedRollingDedisp(cb, db, 8, device="cpu"),
          lambda: stream.StreamService(svc, src, cfg, device="cpu"),
          lambda: stream.BeamMultiplexer(svc, [src], cfg, device="cpu"))
for call in on_cpu:
    call()
if not torch.cuda.is_available():
    for call in (lambda: stream.StreamSearch(hdr, cfg),
                 lambda: stream.RollingDedisp(cb, db, 8),
                 lambda: stream.StackedRollingDedisp(cb, db, 8),
                 lambda: stream.StreamService(svc, src, cfg),
                 lambda: stream.BeamMultiplexer(svc, [src], cfg),
                 lambda: service.main(["-tail", "missing.fil"]),
                 lambda: beams.main(["-tails", "missing.fil"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
    # the CLIs refused before starting a service, a producer or a pump
    assert threading.active_count() == 1, threading.enumerate()
print("STREAM ISOLATED")
"""


def test_stream_and_serve_modules_stand_alone_and_need_cuda(tmp_path):
    """The stream, serve and obs modules import neither jax nor
    presto_tpu; StreamSearch, RollingDedisp, StackedRollingDedisp,
    StreamService, BeamMultiplexer and the two stream CLIs (service and
    beams main) run with device="cpu" and, called without it, raise
    without a card before starting any thread."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", STREAM_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "STREAM ISOLATED" in out.stdout


SERVE_SCRIPT = r"""
import sys
import torch
from presto_tpu_torch import cuda_build, tune
from presto_tpu_torch.obs import costmodel, devtel, roofline
from presto_tpu_torch.pipeline import survey
from presto_tpu_torch.serve import batchexec, plancache, server
from presto_tpu_torch.tune import db, runner, space
from presto_tpu_torch.search.accel import AccelConfig
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu.")
             or m == "tools" or m.startswith("tools."))
assert not bad, bad
for name in ("PRESTO_TPU_STACKED", "PRESTO_TPU_COST", "PRESTO_TPU_TUNE",
             "PRESTO_TPU_TUNE_DB"):
    for mod in (batchexec, costmodel, tune, db, server, plancache):
        assert name not in open(mod.__file__).read(), (name, mod.__name__)
if not torch.cuda.is_available():
    svc = server.SearchService("serve_isolation_work")
    prov = plancache.SearcherProvider(plancache.PlanCache())
    for call in (lambda: svc.build_job({"rawfiles": [db.__file__]}),
                 lambda: prov.searcher(AccelConfig(zmax=0), 1.0, 4096),
                 lambda: runner.TuneRunner(),
                 lambda: roofline.measure_peaks(),
                 lambda: survey.run_survey_stacked([])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("SERVE ISOLATED")
"""


def test_serve_tune_obs_modules_stand_alone_and_need_cuda(tmp_path):
    """The plan cache, the stacked executor, the tuning DB, runner and
    spaces, and the dispatch telemetry, cost book and roofline import
    neither jax, presto_tpu nor tools/, read none of the JAX package's
    environment switches, and their entry points (a survey job on a
    "cuda" service, a searcher plan, the tuning runner, the peaks, the
    stacked survey) raise without a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", SERVE_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SERVE ISOLATED" in out.stdout


def test_port_imports_no_jax_and_needs_cuda():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout
