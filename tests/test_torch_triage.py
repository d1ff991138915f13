"""The port's learned triage (triage/features, triage/model,
triage/calibrate, apps/triage, the survey's cfg.triage) against the JAX
package's on the same seeded candidates.

featurize is bit-equal; scores from one weights file agree within
SCORE_ATOL; training from the JAX package's own init (its PRNGKey
normals, passed in as ``init=``) agrees within TRAIN_RTOL on w and b;
TriagePolicy.select picks the same candidates; a weights file written by
either package loads in the other and saves back to the same bytes.  The
port's default init (a torch generator) differs from the JAX package's
by design, so its own training is held to the acceptance numbers the
JAX package's test pins, not to the JAX weights."""

import json
import os

import numpy as np
import pytest

from presto_tpu.pipeline.sifting import Candlist as JCandlist
from presto_tpu.pipeline.sifting import select_fold_candidates as jselect
from presto_tpu.triage import TriagePolicy as JPolicy
from presto_tpu.triage import featurize as jfeaturize
from presto_tpu.triage import load_model as jload
from presto_tpu.triage import train_model as jtrain
from presto_tpu.triage.calibrate import (label_candidates as jlabel,
                                         synthetic_campaign as jcampaign,
                                         synthetic_observation as jobs_)
from presto_tpu.triage.calibrate import \
    train_on_observations as jtrain_obs

from presto_tpu_torch.pipeline.sifting import (Candlist,
                                               select_fold_candidates)
from presto_tpu_torch.triage import (FEATURE_NAMES, TriageModel,
                                     TriagePolicy, featurize, load_model,
                                     train_model)
from presto_tpu_torch.triage.calibrate import (acceptance_report,
                                               label_candidates,
                                               synthetic_campaign,
                                               synthetic_observation,
                                               train_on_observations)

#: scores of one weights file, port against JAX (float32 on both)
SCORE_ATOL = 1e-6
#: trained w and b from the same init, port against JAX
TRAIN_RTOL = 1e-5


def _obs(seed, n_noise=60):
    """The same synthetic observation from each package's calibrate."""
    port = synthetic_observation(np.random.default_rng(seed),
                                 n_noise=n_noise, n_psr=2)
    ref = jobs_(np.random.default_rng(seed), n_noise=n_noise, n_psr=2)
    return port, ref


def _jax_init(seed, nfeat):
    """The JAX package's train_model init: 0.01 PRNGKey(seed) normals."""
    import jax
    import jax.numpy as jnp
    w0 = 0.01 * jax.random.normal(jax.random.PRNGKey(int(seed)), (nfeat,),
                                  jnp.float32)
    return np.asarray(w0), 0.0


def _jax_weights(tmp_path, seed=0, n_obs=4):
    """A JAX-trained weights file over a small synthetic campaign."""
    model = jtrain_obs(jcampaign(seed=seed, n_obs=n_obs, n_noise=80),
                       seed=seed)
    path = str(tmp_path / ("jax_weights_%d.json" % seed))
    model.save(path)
    return path


@pytest.mark.parametrize("seed", [3, 5, 11])
def test_featurize_bit_equal(seed):
    (pc, ptruth), (jc, jtruth) = _obs(seed)
    assert ptruth == jtruth
    X, Xj = featurize(pc), jfeaturize(jc)
    assert X.shape == (len(pc), len(FEATURE_NAMES))
    assert X.dtype == Xj.dtype == np.float64
    assert np.array_equal(X, Xj)
    assert np.array_equal(label_candidates(pc, ptruth), jlabel(jc, jtruth))


@pytest.mark.parametrize("seed", [0, 2])
def test_scores_of_one_weights_file_agree(tmp_path, seed):
    path = _jax_weights(tmp_path, seed=seed)
    model, why = load_model(path)
    jmodel, jwhy = jload(path)
    assert why is None and jwhy is None
    (pc, _t), (jc, _jt) = _obs(seed + 40, n_noise=200)
    s = model.score_candidates(pc, device="cpu")
    sj = jmodel.score_candidates(jc)
    assert s.dtype == np.float64 and s.shape == sj.shape
    np.testing.assert_allclose(s, sj, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("seed", [0, 7])
def test_training_from_the_jax_init_agrees(seed):
    (pc, ptruth), (jc, jtruth) = _obs(seed + 20)
    X, y = featurize(pc), label_candidates(pc, ptruth)
    init = _jax_init(seed, X.shape[1])
    port = train_model(X, y, seed=seed, init=init, device="cpu")
    ref = jtrain(jfeaturize(jc), jlabel(jc, jtruth), seed=seed)
    np.testing.assert_allclose(port.w, ref.w, rtol=TRAIN_RTOL, atol=0)
    np.testing.assert_allclose(port.b, ref.b, rtol=TRAIN_RTOL, atol=0)
    assert port.mean == ref.mean and port.scale == ref.scale
    assert (port.seed, port.trained_on) == (ref.seed, ref.trained_on)


def test_default_init_is_seeded_and_deterministic():
    """Without init= the port draws its own seeded init: the same seed
    gives the same weights, another seed moves them."""
    (pc, truth), _ = _obs(3)
    m1 = train_on_observations([(pc, truth)], seed=7, device="cpu")
    m2 = train_on_observations([(pc, truth)], seed=7, device="cpu")
    m3 = train_on_observations([(pc, truth)], seed=8, device="cpu")
    assert m1.to_doc() == m2.to_doc()
    assert m3.to_doc() != m1.to_doc()


@pytest.mark.parametrize("budget", [3, 8, 20])
def test_policy_selects_what_the_jax_policy_selects(tmp_path, budget):
    """The same weights file and budget over the same heuristic
    selection: the same survivors in the same order, the same
    accounting."""
    path = _jax_weights(tmp_path, seed=1)
    (pc, _t), (jc, _jt) = _obs(13)
    heur = select_fold_candidates(Candlist(list(pc)), fold_top=30)
    jheur = jselect(JCandlist(list(jc)), fold_top=30)
    assert [(c.filename, c.candnum) for c in heur] == \
        [(c.filename, c.candnum) for c in jheur]
    sel, acct = TriagePolicy(weights_path=path, budget=budget,
                             device="cpu").select(heur)
    jsel, jacct = JPolicy(weights_path=path, budget=budget).select(jheur)
    assert acct["mode"] == jacct["mode"] == "triage"
    assert [(c.filename, c.candnum) for c in sel] == \
        [(c.filename, c.candnum) for c in jsel]
    for k in ("scored", "selected", "budget", "folds_avoided"):
        assert acct[k] == jacct[k], k
    np.testing.assert_allclose(acct["scores"], jacct["scores"], rtol=0,
                               atol=SCORE_ATOL + 1e-6)


def test_weights_file_bytes_carry_across(tmp_path):
    """A JAX-saved file loads in the port and saves back to the same
    bytes, and the reverse; a port-trained file is schema 1."""
    jpath = _jax_weights(tmp_path, seed=4)
    model, _ = load_model(jpath)
    ppath = str(tmp_path / "port.json")
    model.save(ppath)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    (pc, truth), _ = _obs(6)
    own = train_on_observations([(pc, truth)], seed=2, device="cpu")
    opath = str(tmp_path / "own.json")
    own.save(opath)
    jmodel, why = jload(opath)
    assert why is None
    back = str(tmp_path / "back.json")
    jmodel.save(back)
    assert open(back, "rb").read() == open(opath, "rb").read()
    assert json.load(open(opath))["schema"] == 1


@pytest.mark.parametrize("poison", [
    "not json at all {",
    json.dumps(["a", "list"]),
    json.dumps({"schema": 99}),
    json.dumps({"schema": 1, "feature_names": ["x"], "w": [0.0],
                "b": 0.0, "mean": [0.0], "scale": [1.0]}),
])
def test_poisoned_weights_keep_the_heuristic(tmp_path, poison):
    """A bad weights file degrades to the heuristic selection unchanged,
    as in the JAX package; no weights path is the unconfigured
    heuristic with no load error."""
    path = str(tmp_path / "triage_weights.json")
    with open(path, "w") as f:
        f.write(poison)
    (pc, _t), _ = _obs(9)
    heur = sorted(pc, key=lambda c: -c.sigma)[:12]
    with pytest.warns(RuntimeWarning):
        sel, acct = TriagePolicy(weights_path=path, budget=3,
                                 device="cpu").select(heur)
    assert acct["mode"] == "heuristic" and acct["load_error"]
    assert [id(c) for c in sel] == [id(c) for c in heur]
    sel, acct = TriagePolicy(budget=3, device="cpu").select(heur)
    assert acct["mode"] == "heuristic" and acct["load_error"] is None
    assert sel == heur


def test_acceptance_report_on_the_port():
    """The JAX package's acceptance bar on the port's own training: at
    least 99% recall at a 5x fold reduction, the ranking deterministic
    and reproduced by a second run."""
    rep = acceptance_report(seed=20, device="cpu")
    assert rep["recall"] >= 0.99, rep
    assert rep["fold_reduction"] >= 5.0, rep
    assert rep["deterministic_ranking"] is True
    assert acceptance_report(seed=20, device="cpu")["rank_hashes"] == \
        rep["rank_hashes"]


def test_fold_profile_features_agree(tmp_path):
    """The borderline fold features of the same .dat files: within the
    fold's float32 rounding of the JAX package's, zeros for an
    unreadable item."""
    from presto_tpu.io.infodata import InfoData, write_inf
    from presto_tpu.triage.features import fold_profile_features as jfpf
    from presto_tpu_torch.triage.features import fold_profile_features
    rng = np.random.default_rng(23)
    N, dt, f0 = 8192, 1e-3, 5.0

    def dat(name, pulsed):
        base = str(tmp_path / name)
        t = np.arange(N) * dt
        x = rng.normal(0, 1.0, N)
        if pulsed:
            x += 8.0 * np.exp(20.0 * (np.cos(2 * np.pi * f0 * t) - 1.0))
        x.astype(np.float32).tofile(base + ".dat")
        write_inf(InfoData(name=base, N=N, dt=dt), base + ".inf")
        return base + ".dat"

    items = [(dat("psr", True), f0, 0.0), (dat("noise", False), f0, 0.0),
             (str(tmp_path / "missing.dat"), f0, 0.0)]
    got = fold_profile_features(items, device="cpu")
    want = jfpf(items)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[2].any()
    assert got[0, 0] > 5.0 * max(got[1, 0], 1.0)


def test_survey_triage_policy_is_built_on_the_device():
    from presto_tpu_torch.pipeline.survey import resolve_triage_policy
    assert resolve_triage_policy(None, "w") is None
    pol = resolve_triage_policy({"budget": 2, "weights": "x.json"}, "w",
                                device="cpu")
    assert isinstance(pol, TriagePolicy)
    assert (pol.budget, pol.weights_path, pol.datdir, str(pol.device)) \
        == (2, "x.json", "w", "cpu")
    given = TriagePolicy(budget=1)
    assert resolve_triage_policy(given, "d") is given and given.datdir == "d"


def test_presto_triage_cli(tmp_path, capsys):
    """train --synthetic writes a schema-1 file the JAX package loads;
    report passes the acceptance bar; the weights path is required."""
    from presto_tpu_torch.apps import triage as cli
    out = str(tmp_path / "w.json")
    assert cli.main(["train", "--synthetic", "-observations", "4",
                     "-o", out], device="cpu") == 0
    jmodel, why = jload(out)
    assert why is None and jmodel.trained_on > 0
    assert isinstance(load_model(out)[0], TriageModel)
    assert cli.main(["report", "-observations", "12"], device="cpu") == 0
    with pytest.raises(SystemExit):
        cli.main(["train", "--synthetic"], device="cpu")
    capsys.readouterr()
    assert os.path.exists(out)
