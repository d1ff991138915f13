"""The survey recipes and drift-scan prep in the port
(pipeline/{recipes, driftprep}, apps/{drift_prep, pipeline}) against the
JAX package's, on the CPU.

Each recipe's SurveyConfig equals the JAX package's field by field (the
default zaplist is each package's copy of the same birdie list);
pipeline --recipe refuses the flags the recipe owns and runs the GBNCC
policy end to end on the synth beam (rfifind, the default zaplist, both
accel passes, the sift policy, the 20 + 10 fold caps).
The drift-scan pointings and their cut filterbanks are byte-equal to
the JAX package's, and pipeline --driftprep runs one survey a pointing.
The sift of chip_smoke.py's recipe phase on the H100 (its ACCEL tables
and cands_sifted.txt, kept in tests/data/recipe_cands.tar.xz) is the
JAX package's sift of the same candidates, and their sigmas the JAX
package's.
"""

import dataclasses
import glob
import io
import json
import os
import tarfile
from contextlib import redirect_stdout

import numpy as np
import pytest

from presto_tpu.apps import drift_prep as jdrift_app
from presto_tpu.apps.accelsearch import read_cand_file as jread_cand_file
from presto_tpu.io.infodata import read_inf as jread_inf
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.ops import stats as jstats
from presto_tpu.pipeline import driftprep as jdrift
from presto_tpu.pipeline import recipes as jrecipes
from presto_tpu.pipeline import sifting as jsifting
from presto_tpu.search import accel as jaccel
from presto_tpu_torch.apps import drift_prep as tdrift_app
from presto_tpu_torch.apps import pipeline as tpipeline
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.pipeline import driftprep as tdrift
from presto_tpu_torch.pipeline import recipes as trecipes

N, NCHAN, DT = 1 << 16, 32, 5e-4
# chip_smoke.py --keep-recipe-cands on an NVIDIA H100: the recipe phase's
# ACCEL tables, .cand and .inf files and its cands_sifted.txt
RECIPE_CANDS = os.path.join(os.path.dirname(__file__), "data",
                            "recipe_cands.tar.xz")


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "sift_policy":
            v = dataclasses.asdict(v)
        elif f.name == "zaplist" and v is not None:
            v = open(v, "rb").read()
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", ["palfa", "gbncc", "gbt350drift"])
def test_recipe_configs_equal(name, tmp_path):
    jr, tr = jrecipes.get_recipe(name), trecipes.get_recipe(name.upper())
    assert tr.name == jr.name and tr.accel_passes == jr.accel_passes
    zap = str(tmp_path / "my.zaplist")
    open(zap, "w").write("60.0 0.1\n")
    for args, kw in (((0.0, 100.0), {}), ((20.0, 24.0), {"nsub": 64}),
                     ((5.0, 30.0), {"zaplist": zap})):
        want = _fields(jr.to_config(*args, **kw))
        got = _fields(tr.to_config(*args, **kw))
        assert set(got) == set(want)
        for k in want:
            assert got[k] == want[k], (name, k)
    assert sorted(trecipes.RECIPES) == sorted(jrecipes.RECIPES)
    with pytest.raises(ValueError, match="unknown survey recipe"):
        trecipes.get_recipe("parkes")


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    d = tmp_path_factory.mktemp("recipe_beam")
    raw = str(d / "psr.fil")
    fake_filterbank_file(raw, N, DT, NCHAN, 1338.0, 4.0,
                         FakeSignal(f=41.3, dm=49.0, shape="gauss",
                                    width=0.04, amp=1.0),
                         noise_sigma=6.0, seed=21)
    return raw


@pytest.mark.parametrize("flag", [["-zmax", "50"], ["-numharm", "16"],
                                  ["-sigma", "3"], ["-rfitime", "1"],
                                  ["-foldtop", "5"]])
def test_pipeline_recipe_refuses_conflicting_flags(flag, beam, tmp_path):
    with pytest.raises(SystemExit, match="conflicts with --recipe gbncc"):
        tpipeline.main(["--recipe", "gbncc"] + flag
                       + ["-workdir", str(tmp_path), beam], device="cpu")
    assert not os.listdir(str(tmp_path))


def test_pipeline_recipe_gbncc_runs(beam, tmp_path):
    """The GBNCC recipe on the synth beam: both passes' ACCEL files for
    every trial, topocentric trials (a recipe leaves bary off, as in the
    JAX package), every .fft journaled zapped, the pulsar on top of the
    sift, folds within the 20 + 10 caps."""
    work = str(tmp_path / "w")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tpipeline.main(["--recipe", "gbncc", "-lodm", "40",
                               "-hidm", "60", "-nsub", "8", "-workdir",
                               work, beam], device="cpu") == 0
    dats = sorted(glob.glob(os.path.join(work, "psr_DM*.dat")))
    assert len(dats) == 8
    for f in dats:
        assert read_inf(f[:-4]).bary == 0
        for z in (0, 50):
            assert os.path.exists(f[:-4] + "_ACCEL_%d.cand" % z)
    arts = json.load(open(os.path.join(work, "manifest.json")))["artifacts"]
    ffts = {k: v["stage"] for k, v in arts.items() if k.endswith(".fft")}
    assert len(ffts) == 8 and set(ffts.values()) == {"zapbirds"}
    rows = [ln.split() for ln in open(os.path.join(work,
                                                   "cands_sifted.txt"))
            if ln.strip() and not ln.startswith("#") and ":" in ln]
    assert rows[0][0].startswith("psr_DM49.00_ACCEL_")
    assert abs(1000.0 / float(rows[0][7]) - 41.3) < 0.05
    folds = glob.glob(os.path.join(work, "fold_cand*.pfd"))
    by_pass = [sum(1 for r in rows[:len(folds)] if
                   r[0].split(":")[0].endswith("_ACCEL_%d" % z))
               for z in (0, 50)]
    assert 1 <= len(folds) <= 30 and by_pass[0] <= 20 and by_pass[1] <= 10
    assert os.path.exists(os.path.join(work, "psr_rfifind.mask"))


def test_card_recipe_sift_is_the_jax_sift(tmp_path):
    """The card's recipe run (GBNCC over the barycentred, zapped beam:
    24 DM trials, the zmax-0 and zmax-50 passes) ranks its candidates as
    the JAX package does: the JAX sift of the same ACCEL tables, with
    the recipe's policy, writes the card's cands_sifted.txt byte for
    byte, and every .cand candidate's sigma is the JAX package's
    candidate_sigma of its power over its pass's independent trials: the
    .cand stores float32 power and sigma, so the sigma lies between the
    JAX sigmas of the powers one float32 step either side, widened by
    float32's rounding of the sigma (the sift reads sigma to 0.01 from
    the ACCEL table)."""
    with tarfile.open(RECIPE_CANDS) as tar:
        tar.extractall(str(tmp_path))
    cfg = jrecipes.get_recipe("gbncc").to_config(20.0, 24.0, nsub=32)
    accs = sorted(f for (z, _nh, _sg, _flo) in cfg.all_passes
                  for f in glob.glob(str(tmp_path / ("*_ACCEL_%d" % z))))
    assert len(accs) == 2 * 24
    cl = jsifting.sift_candidates(accs, numdms_min=cfg.min_dm_hits,
                                  low_DM_cutoff=cfg.low_dm_cutoff,
                                  policy=cfg.sift_policy)
    jpath = str(tmp_path / "jax_sifted.txt")
    cl.to_file(jpath)
    card = open(str(tmp_path / "cands_sifted.txt")).read()
    assert len(cl) > 0 and open(jpath).read() == card
    ncands = 0
    for (zmax, nh, sg, flo) in cfg.all_passes:
        info = jread_inf(accs[0][:accs[0].rfind("_ACCEL")])
        T = info.N * info.dt
        numindep = jaccel.AccelSearch(
            jaccel.AccelConfig(zmax=zmax, numharm=nh, sigma=sg, flo=flo),
            T=T, numbins=(int(info.N) & ~1) // 2).numindep
        for acc in accs:
            if not acc.endswith("_ACCEL_%d" % zmax):
                continue
            for c in jread_cand_file(acc + ".cand"):
                p = np.float32(c.power)
                lo, hi = sorted(jstats.candidate_sigma(
                    np.float64(np.nextafter(p, np.float32(d))), c.numharm,
                    numindep[int(np.log2(c.numharm))])
                    for d in (-np.inf, np.inf))
                eps = np.finfo(np.float32).eps
                assert (lo - abs(lo) * eps <= c.sigma
                        <= hi + abs(hi) * eps), acc
                ncands += 1
    assert ncands >= len(cl)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A 2^15-sample drift scan at the Crab's position."""
    d = tmp_path_factory.mktemp("drift")
    raw = str(d / "scan.fil")
    fake_filterbank_file(raw, 1 << 15, DT, 16, 1338.0, 4.0,
                         FakeSignal(f=23.0, dm=55.0, shape="gauss",
                                    width=0.08, amp=0.8),
                         noise_sigma=2.0, seed=7)
    return raw


@pytest.mark.parametrize("kw", [{"orig_N": 1 << 14},
                                {"orig_N": 10000, "overlap_factor": 0.3},
                                {"orig_N": 1 << 14, "pointing": 1}],
                         ids=["half", "ragged", "one"])
def test_split_drift_scan_byte_equal(scan, tmp_path, kw):
    want = jdrift.split_drift_scan([scan], outdir=str(tmp_path / "j"),
                                   prefix="drift", **kw)
    got = tdrift.split_drift_scan([scan], outdir=str(tmp_path / "t"),
                                  prefix="drift", **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == (1 if "pointing" in kw else
                        (32768 // int(kw["orig_N"]
                                      * kw.get("overlap_factor", 0.5))) - 1)
    for a, b in zip(want, got):
        assert open(b, "rb").read() == open(a, "rb").read()
    # a rerun keeps the cuts; plan_pointings equal field by field
    assert tdrift.split_drift_scan([scan], outdir=str(tmp_path / "t"),
                                   prefix="drift", **kw) == got
    args = (32768, DT, 59000.0, 53431.97, 220052.1)
    for a, b in zip(jdrift.plan_pointings(*args, orig_N=10000),
                    tdrift.plan_pointings(*args, orig_N=10000)):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
    for c in ((53431.97, 220052.1), (-13000.5, -5959.9), (235959.9, 0.0)):
        assert tdrift._coord_tag(*c) == jdrift._coord_tag(*c)


def test_drift_prep_cli_equal(scan, tmp_path):
    outs = []
    for app, sub in ((jdrift_app, "j"), (tdrift_app, "t")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert app.main(["-nmax", "-orign", "8192", scan]) == 0
            assert app.main(["-num", "2", "-orign", "8192", "-outdir",
                             str(tmp_path / sub), scan]) == 0
        outs.append(buf.getvalue().replace(str(tmp_path / sub), ""))
    assert outs[1] == outs[0] and outs[0].splitlines()[0] == "6"
    for mod in (jdrift, tdrift):      # a PSRFITS scan that is not there
        with pytest.raises(FileNotFoundError):
            mod.split_drift_scan([str(tmp_path / "scan.fits")])


def test_pipeline_driftprep_runs_a_survey_a_pointing(scan, tmp_path):
    work = str(tmp_path / "w")
    assert tpipeline.main(["--driftprep", "-orign", "16384", "-lodm", "50",
                           "-hidm", "56", "-nsub", "8", "-numharm", "2",
                           "-foldtop", "0", "-nosp", "-norfi", "-workdir",
                           work, scan], device="cpu") == 0
    cuts = sorted(glob.glob(os.path.join(work, "drift_*.fil")))
    assert len(cuts) == 3
    for c in cuts:
        sub = c[:-4]
        assert os.path.exists(os.path.join(sub, "cands_sifted.txt"))
        dats = glob.glob(os.path.join(sub, "drift_*_DM*.dat"))
        assert len(dats) == len(glob.glob(os.path.join(sub, "*.fft"))) > 0
