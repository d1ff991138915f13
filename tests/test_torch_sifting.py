"""The port's sifting (sift_candidates, select_fold_candidates, the
ACCEL_sift CLI) against the JAX package's, on the CPU: the same ACCEL
files give byte-equal cands_sifted.txt and the same selections.

The ACCEL files are written by the JAX package's writer over 12 DM
trials of two accel passes: a pulsar seen over a contiguous DM span
(with harmonics and simple-ratio relatives), a mains birdie, long- and
short-period candidates, a low-DM peak, a gapped DM span, candidates
dominated by one high harmonic, and seeded noise.
"""

import glob
import os

import numpy as np
import pytest

from presto_tpu.apps import accel_sift as jsift_app
from presto_tpu.apps.accelsearch import write_accel_file
from presto_tpu.io.infodata import InfoData, write_inf
from presto_tpu.pipeline import sifting as jsift
from presto_tpu.search.accel import AccelCand
from presto_tpu_torch.apps import accel_sift as tsift_app
from presto_tpu_torch.pipeline import sifting as tsift

T = 537.0
DMS = [0.5 + 1.5 * i for i in range(12)]


def _cand(rng, f, sigma, nh, z=0.0):
    power = float(nh + sigma ** 2 / 2 + rng.uniform(0, 3))
    return AccelCand(power=power, sigma=float(sigma), numharm=nh,
                     r=float(f * T + rng.uniform(-0.3, 0.3)), z=float(z))


@pytest.fixture(scope="module")
def accel_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sift")
    rng = np.random.default_rng(12)
    for i, dm in enumerate(DMS):
        base = str(d / ("beam_DM%.2f" % dm))
        write_inf(InfoData(name=base, N=float(1 << 22), dt=T / (1 << 22),
                           telescope="Fake", object="X", dm=dm),
                  base + ".inf")
        for zmax in (20, 0):
            cands = []
            peak = 18.0 - 1.2 * abs(i - 6)
            if 2 <= i <= 10:                  # the pulsar and relatives
                cands.append(_cand(rng, 11.37, peak, 8, z=1.5))
                cands.append(_cand(rng, 22.74, peak - 3, 4))
                cands.append(_cand(rng, 11.37 * 1.5, peak - 5, 2))
            cands.append(_cand(rng, 60.0, 9.0, 1))        # mains birdie
            cands.append(_cand(rng, 0.05, 12.0, 2))       # 20 s period
            cands.append(_cand(rng, 1500.0, 10.0, 2))     # 0.67 ms period
            if i <= 2:                                    # low-DM peak
                cands.append(_cand(rng, 7.77, 15.0 - 4 * i, 4))
            if i in (4, 5, 9):                            # gapped span
                cands.append(_cand(rng, 3.21, 9.5, 4))
            if zmax == 0 and i % 3 == 0:                  # one-pass only
                cands.append(_cand(rng, 5.55, 8.0, 1))
            for _ in range(6):                            # noise
                cands.append(_cand(rng, rng.uniform(1, 400),
                                   rng.uniform(2, 8), int(rng.choice(
                                       [1, 2, 4, 8]))))
            cands.sort(key=lambda c: -c.sigma)
            write_accel_file(base + "_ACCEL_%d" % zmax, cands, T)
    return str(d)


def accel_files(d, zmaxes=(20, 0)):
    return sorted(f for z in zmaxes
                  for f in glob.glob(os.path.join(d, "*_ACCEL_%d" % z)))


def summary(cl):
    return ([(c.filename, c.candnum, c.DM, c.sigma, c.numharm, c.r,
              sorted(c.hits)) for c in cl],
            {k: sorted((c.filename, c.candnum) for c in v)
             for k, v in cl.badcands.items()},
            sorted((c.filename, c.candnum) for c in cl.duplicates))


@pytest.mark.parametrize("kw", [
    {},
    {"numdms_min": 3, "low_DM_cutoff": 4.0},
    {"known_birds_f": [(60.0, 0.2)], "r_err": 2.0},
    {"policy": "strict"},
])
def test_sift_candidates_byte_equal(tmp_path, accel_dir, kw):
    files = accel_files(accel_dir)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("policy"):
        jkw["policy"] = jsift.SiftPolicy(sigma_threshold=8.0,
                                         harm_pow_cutoff=9.0)
        tkw["policy"] = tsift.SiftPolicy(sigma_threshold=8.0,
                                         harm_pow_cutoff=9.0)
    want = jsift.sift_candidates(files, **jkw)
    got = tsift.sift_candidates(files, **tkw)
    assert len(want) > 0
    a, b = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    want.to_file(a)
    got.to_file(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert summary(got) == summary(want)


@pytest.mark.parametrize("kw", [
    {"fold_top": 3},
    {"fold_sigma": 6.0, "max_folds": 4},
    {"fold_sigma": 6.0, "max_folds_per_pass": (2, 1),
     "pass_zmaxes": [20, 0]},
])
def test_select_fold_candidates_matches_jax(accel_dir, kw):
    files = accel_files(accel_dir)
    jacct, tacct = {}, {}
    want = jsift.select_fold_candidates(jsift.sift_candidates(files),
                                        accounting=jacct, **kw)
    got = tsift.select_fold_candidates(tsift.sift_candidates(files),
                                       accounting=tacct, **kw)
    assert want
    assert [(c.filename, c.candnum) for c in got] == \
        [(c.filename, c.candnum) for c in want]
    assert tacct == jacct


def test_untagged_candidates_are_counted(accel_dir):
    """Per-pass caps over passes that do not name a file's zmax: the
    exclusion is counted and warned about, as in the JAX package."""
    files = accel_files(accel_dir)
    kw = dict(fold_sigma=6.0, max_folds_per_pass=(5,), pass_zmaxes=[20])
    jacct, tacct = {}, {}
    with pytest.warns(RuntimeWarning, match="pass tag"):
        want = jsift.select_fold_candidates(jsift.sift_candidates(files),
                                            accounting=jacct, **kw)
    with pytest.warns(RuntimeWarning, match="pass tag"):
        got = tsift.select_fold_candidates(tsift.sift_candidates(files),
                                           accounting=tacct, **kw)
    assert tacct["untagged_dropped"] == jacct["untagged_dropped"] > 0
    assert [c.candnum for c in got] == [c.candnum for c in want]


@pytest.mark.parametrize("extra", [[], ["-defaultbirds"],
                                   ["--min-dm-hits", "4"]])
def test_accel_sift_cli_byte_equal(tmp_path, accel_dir, extra):
    files = accel_files(accel_dir, (20,))
    a, b = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jsift_app.main(extra + ["-o", a] + files)
    tsift_app.main(extra + ["-o", b] + files)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_accel_sift_cli_glob(tmp_path, accel_dir, monkeypatch):
    """Without file arguments the CLI globs the working directory for
    ACCEL tables (not their .cand companions or .inf files)."""
    monkeypatch.chdir(accel_dir)
    a, b = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jsift_app.main(["-o", a])
    tsift_app.main(["-o", b])
    assert open(a, "rb").read() == open(b, "rb").read()


def test_default_birds_match_jax():
    from presto_tpu_torch.utils.catalog import default_birds_path
    assert default_birds_path().startswith(os.path.dirname(
        os.path.dirname(tsift.__file__)))
    assert tsift.default_known_birds_f() == jsift.default_known_birds_f()
    assert len(tsift.default_known_birds_f()) > 0
