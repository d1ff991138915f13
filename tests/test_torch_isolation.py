"""The port stands alone: importing every module of presto_tpu_torch
loads neither jax nor any presto_tpu module, and an entry point called
without device= (the search, the survey, the accelsearch CLI, the polish)
needs a CUDA device."""

import os
import subprocess
import sys

import pytest

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
assert not hasattr(survey, "_refuse_unported")
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
    import neither jax nor presto_tpu; the survey refuses no config
    (singlepulse=True among them); the search, the CLI and the survey's
    stages called without device= raise without a card."""
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
assert not hasattr(survey, "_refuse_unported")
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
    nor presto_tpu; the survey refuses no config (elastic runs, a fault
    injector, bary, a zaplist); make_mesh() (and visible_devices, the
    logical-shard context) and prepsubband -coordinator (and -elastic)
    called without device= raise without a card, before joining any
    process group."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PARALLEL ISOLATED" in out.stdout


BARY_SCRIPT = r"""
import sys
import torch
from presto_tpu_torch.apps import (bary, drift_prep, pipeline, prepsubband,
                                   zapbirds)
from presto_tpu_torch.astro import (bary as abary, baryshift, ephem, kernels,
                                    spk, spkwrite)
from presto_tpu_torch.pipeline import driftprep, recipes, survey
from presto_tpu_torch import cuda_build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu."))
assert not bad, bad
assert not cuda_build._libs, "a library was built at import"
assert ephem.EPV_PATH.startswith(sys.argv[1])
assert kernels.default_cache_dir().endswith("presto_tpu_torch")
assert not hasattr(kernels, "fetch_kernel")
assert isinstance(ephem.get_ephemeris(), ephem.EpvEphemeris)
if not torch.cuda.is_available():
    cfg = recipes.get_recipe("gbncc").to_config(20.0, 24.0)
    cfg.bary = True
    assert cfg.zaplist and cfg.accel_passes
    for call in (lambda: prepsubband.main(["missing.fil"]),
                 lambda: pipeline.main(["--recipe", "gbncc",
                                        "missing.fil"]),
                 lambda: survey.run_survey(["missing.fil"], cfg, ".")):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("BARY ISOLATED")
"""


def test_bary_zapbirds_recipe_modules_stand_alone_and_need_cuda(tmp_path):
    """Barycentring, zapbirds, the recipes and drift prep import neither
    jax nor presto_tpu and build nothing at import; the ephemeris reads
    the port's own epv.npz and the kernel cache is the port's own (no
    download path); prepsubband without -nobary, pipeline --recipe and a
    barycentred zaplist survey called without device= raise without a
    card, before touching any file."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", BARY_SCRIPT,
                          os.path.join(ROOT, "presto_tpu_torch")],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BARY ISOLATED" in out.stdout
    assert os.listdir(str(tmp_path)) == []


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


FLEET_SCRIPT = r"""
import sys
import torch
from presto_tpu_torch.apps import campaign, pipeline, serve, triage
from presto_tpu_torch.obs import fleetagg, slo
from presto_tpu_torch.pipeline import leaseledger, survey
from presto_tpu_torch.serve import (batchexec, campaign as scampaign, dag,
                                    fleet, jobledger, router, server, usage)
from presto_tpu_torch.triage import calibrate, features, model
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu."))
assert not bad, bad
assert not hasattr(server, "DAG_JOBS_ITEM")
assert not hasattr(survey, "_refuse_unported")
if not torch.cuda.is_available():
    import numpy as np
    m = model.TriageModel(w=[0.0] * 14, b=0.0, mean=[0.0] * 14,
                          scale=[1.0] * 14)
    svc = server.SearchService("w_iso")
    for call in (lambda: m.score(np.zeros((2, 14))),
                 lambda: model.train_model(np.zeros((4, 14)),
                                           np.zeros(4)),
                 lambda: triage.main(["train", "--synthetic", "-o", "w.json"]),
                 lambda: serve.main(["-fleet", "f_iso"]),
                 lambda: pipeline.main(["missing.fil"]),
                 lambda: svc.build_job({"kind": "fold", "fold": {}})):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("FLEET ISOLATED")
"""


def test_fleet_and_triage_modules_stand_alone_and_need_cuda(tmp_path):
    """The fleet and triage modules (serve/{jobledger, usage, dag, fleet,
    router, campaign}, obs/{slo, fleetagg}, triage/, apps/{serve, triage,
    pipeline, campaign}) import neither jax nor presto_tpu; the survey
    refuses no config (cfg.triage, zapbirds, barycentring); the triage
    score and training, the presto-triage, presto-serve and
    pipeline CLIs and a DAG node job on a default service raise without
    a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", FLEET_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FLEET ISOLATED" in out.stdout


CONTROL_SCRIPT = r"""
import json, os, sys
import torch
from presto_tpu_torch.apps import report, supervise, tune as tune_cli
from presto_tpu_torch.obs import perfledger, taxonomy
from presto_tpu_torch.serve import federation, supervisor
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu.")
             or m == "tools" or m.startswith("tools."))
assert not bad, bad
for mod in (report, supervise, tune_cli, perfledger, taxonomy, federation,
            supervisor):
    src = open(mod.__file__).read()
    for name in ("PRESTO_TPU_PERF_LEDGER", "PRESTO_TPU_TUNE_DB",
                 "PERF_LEDGER.json", "PERF_LEDGER.jsonl"):
        assert name not in src, (name, mod.__name__)
assert "presto_tpu_torch" in perfledger.default_ledger_path()
# the control plane runs no device work: the federation, the report and
# the perf ledger work without a card
assert report.main(["-fleet", "missing_fleet"]) == 1
assert tune_cli.main(["--list"]) == 0
if not torch.cuda.is_available():
    for call in (lambda: supervise.main(["-fleet", "f_iso", "-router",
                                         "http://127.0.0.1:1"]),
                 lambda: tune_cli.main(["--smoke", "--db", "t_iso.json"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
    assert not os.path.exists("f_iso") and not os.path.exists("t_iso.json")
print("CONTROL ISOLATED")
"""


def test_control_loop_and_federation_modules_stand_alone(tmp_path):
    """The supervisor, the federation, the perf ledger, the catalog and
    the report and tune CLIs import neither jax, presto_tpu nor tools/,
    name neither the JAX package's environment switches nor a repository
    ledger file; presto-supervise (cuda replicas by default) and
    presto-tune --smoke raise without a card before writing anything,
    while the report and the tune catalog need none."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", CONTROL_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CONTROL ISOLATED" in out.stdout


BINARY_SCRIPT = r"""
import sys
import numpy as np
import torch
from presto_tpu_torch.apps import (bincand, fit_circular_orbit,
                                   monte_binresp, orbellipsefit,
                                   plotbincand, psrorbit, quicklook,
                                   search_bin)
from presto_tpu_torch.io import makfile
from presto_tpu_torch.ops import responses
from presto_tpu_torch.pipeline import monte
from presto_tpu_torch.search import bincand as sbincand, orbitfit, phasemod
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu.")
             or m == "matplotlib" or m.startswith("matplotlib."))
assert not bad, bad
if not torch.cuda.is_available():
    from presto_tpu_torch.ops.orbit import OrbitParams
    pairs = np.ones((4096, 2), np.float32)
    for call in (lambda: phasemod.search_phasemod(pairs, 8192, 1e-2),
                 lambda: sbincand.optimize_bincand(
                     pairs, 8192, 1e-2, OrbitParams(p=900.0, x=0.3), 0.02),
                 lambda: monte.run_campaign(monte.MonteConfig(ntrials=1)),
                 lambda: search_bin.main(["missing.fft"]),
                 lambda: bincand.main(["-ppsr", "0.02", "-porb", "900",
                                       "-x", "0.3", "missing.fft"]),
                 lambda: monte_binresp.main(["--ntrials", "1"]),
                 lambda: quicklook.main(["missing.dat"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
print("BINARY ISOLATED")
"""


def test_binary_search_modules_stand_alone_and_need_cuda(tmp_path):
    """The binary-search modules (search/{phasemod, bincand, orbitfit},
    pipeline/monte, ops/responses, io/makfile and the apps search_bin,
    bincand, monte_binresp, quicklook, fit_circular_orbit, orbellipsefit,
    psrorbit and plotbincand) import neither jax, presto_tpu nor
    matplotlib (the plotting CLIs import it when they draw); the search,
    the refinement, the campaign and the four device CLIs called without
    device= raise without a card, before reading a file."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", BINARY_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BINARY ISOLATED" in out.stdout
    assert os.listdir(str(tmp_path)) == []


PLOT_SCRIPT = r"""
import sys
import numpy as np
import torch
from presto_tpu_torch import plotting
from presto_tpu_torch.apps import (pfd2png, plot_spd, prepfold,
                                   psrfits_quick_bandpass, pulsestack,
                                   pyplotres, rfifind, show_pfd,
                                   single_pulse_search, sum_profiles)
from presto_tpu_torch.io.pfd import Pfd
from presto_tpu_torch.plotting import (accelplot, explore, pfdplot, rfiplot,
                                       spplot)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu.")
             or m == "matplotlib" or m.startswith("matplotlib."))
assert not bad, bad
if not torch.cuda.is_available():
    p = Pfd(npart=4, nsub=2, proflen=8, numchan=2, dt=1e-3, fold_p1=2.0,
            dms=np.array([1.0, 2.0]), periods=np.array([0.5, 0.501]),
            pdots=np.array([0.0, 1e-9]),
            profs=np.ones((4, 2, 8)), stats=np.ones((4, 2, 7)))
    for call in (lambda: pfdplot.pfd_panels(p),
                 lambda: show_pfd.main(["missing.pfd"]),
                 lambda: pfd2png.main(["missing.pfd"]),
                 lambda: prepfold.main(["-f", "10", "missing.dat"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("an entry point ran without CUDA")
    pan = pfdplot.pfd_panels(p, device="cpu")
    assert pan["plane"].shape == (2, 2) and pan["dm_chi2"].shape == (2,)
print("PLOT ISOLATED")
"""


def test_plot_modules_stand_alone_and_need_cuda(tmp_path):
    """The plotting modules (plotting/{pfdplot, accelplot, explore,
    rfiplot, spplot}) and the plot CLIs (apps/{show_pfd, pfd2png,
    sum_profiles, pulsestack, plot_spd, pyplotres}), with the CLIs whose
    plots they draw, import neither jax, presto_tpu nor matplotlib (it is
    imported when a plot is drawn); the .pfd panels, show_pfd, pfd2png
    and prepfold without -noplot called without device= raise without a
    card, before reading a file; the panels run on the CPU when asked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PLOT_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PLOT ISOLATED" in out.stdout
    assert os.listdir(str(tmp_path)) == []


TOOLS_SCRIPT = r"""
import sys
import numpy as np
import torch
from presto_tpu_torch.apps import (a2x, dat2tim, datutils, ddplan, dftfold,
                                   downsample, downsample_filterbank,
                                   event_peak, exploredat, explorefft,
                                   fb_truncate, filter_zerolags, injectpsr,
                                   makedata, makeinf, powerstats,
                                   quick_prune_cands, quickffdots, readfile,
                                   rednoise, rfifind_stats, subband_smearing,
                                   tim2dat, timeconv, weights_to_ignorechan,
                                   window)
from presto_tpu_torch.io import spectra
from presto_tpu_torch.models import inject
from presto_tpu_torch.search import accel, accel_ref, optimize
from presto_tpu_torch.triage import calibrate
from presto_tpu_torch.utils import events, gaussfit
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "presto_tpu" or m.startswith("presto_tpu.")
             or m == "matplotlib" or m.startswith("matplotlib."))
assert not bad, bad
assert calibrate.truth_sidecar_path is inject.truth_sidecar_path
assert callable(optimize.corr_rz_plane)
pairs = np.zeros((1 << 14, 2), np.float32)
cfg = accel.AccelConfig(zmax=10, numharm=2)
if not torch.cuda.is_available():
    try:
        accel.AccelSearch(cfg, T=10.0, numbins=1 << 14)
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("a search was built without CUDA")
search = accel.AccelSearch(cfg, T=10.0, numbins=1 << 14, device="cpu")
assert accel_ref.search_ref(pairs, search) == []
assert accel_ref.timed_search_ref(pairs, search)[0] == []
print("TOOLS ISOLATED")
"""


def test_host_tool_modules_stand_alone(tmp_path):
    """The host tools (the 26 CLIs of apps/, io/spectra, models/inject,
    search/accel_ref, utils/{events, gaussfit}) import neither jax,
    presto_tpu nor matplotlib; triage/calibrate names the sidecar through
    models/inject; the searcher whose geometry the referee reads needs a
    card unless built for the CPU, the referee itself runs on the host,
    and nothing is written."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", TOOLS_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TOOLS ISOLATED" in out.stdout
    assert os.listdir(str(tmp_path)) == []


def test_drawing_tools_without_matplotlib_raise(tmp_path, monkeypatch):
    """With matplotlib hidden, each drawing CLI (a2x, ddplan -o,
    subband_smearing, event_peak -o, quickffdots, window, explorefft,
    exploredat) raises ImportError naming it before any of its work: its
    inputs do not exist, and nothing is written."""
    from presto_tpu_torch.apps import (a2x, ddplan, event_peak, exploredat,
                                       explorefft, quickffdots,
                                       subband_smearing, window)
    for name in [m for m in sys.modules if m.startswith("matplotlib.")] \
            + ["matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.chdir(tmp_path)
    for call in (lambda: a2x.main(["missing.txt"]),
                 lambda: ddplan.main(["-o", "plan.png", "missing.fil"]),
                 lambda: subband_smearing.main(["-o", "s.png"]),
                 lambda: event_peak.main(["-o", "e.png", "missing.txt",
                                          "2.0"]),
                 lambda: quickffdots.main(["missing.fft", "17.3"]),
                 lambda: window.main(["-o", "w.png"]),
                 lambda: explorefft.main(["-png", "f.png", "missing.fft"]),
                 lambda: exploredat.main(["-png", "d.png", "missing.dat"])):
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    assert os.listdir(str(tmp_path)) == []
