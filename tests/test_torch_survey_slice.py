"""Slice 1 of the port end to end against the JAX package.

A seeded synthetic pulsar filterbank goes through the JAX package's
survey head (DDplan -> prepsubband -> stage seam) and the port's
survey_head: the .dat files must be byte-equal.  Then the port's
seam_fft_search runs, and the JAX package's TPU search path (on the CPU,
as in test_torch_accel) runs on the JAX seam's spectra: the per-trial
candidate lists after eliminate_harmonics + remove_duplicates agree as
in test_torch_accel, and the pulsar is found at its DM and frequency.
"""

import glob
import os

import numpy as np

from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.ops import fftpack as jfft
from presto_tpu.pipeline import survey as jsurvey
from presto_tpu.search import accel as jaccel
from presto_tpu.utils.timing import StageTimer
from presto_tpu_torch.models import synth as tsynth
from presto_tpu_torch.pipeline import survey as tsurvey
from test_torch_accel import assert_lists_agree, jax_tpu_path  # noqa: F401

N, NCHAN, DT, LOFREQ, CW = 1 << 16, 32, 5e-4, 1338.0, 4.0
F0, DM, WIDTH = 41.3, 49.0, 0.04


def _config(mod):
    return mod.SurveyConfig(lodm=40.0, hidm=60.0, nsub=8, zmax=20,
                            numharm=8, skip_rfifind=True,
                            singlepulse=False, fold_top=0,
                            durable_stages=True)


def test_synth_filterbank_bytes_equal(tmp_path):
    sig = FakeSignal(f=F0, dm=DM, shape="gauss", width=0.1, amp=1.0)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a, b = str(tmp_path / "a" / "x.fil"), str(tmp_path / "b" / "x.fil")
    fake_filterbank_file(a, 4096, DT, NCHAN, LOFREQ, CW, sig,
                         noise_sigma=2.0, seed=3)
    tsynth.fake_filterbank_file(b, 4096, DT, NCHAN, LOFREQ, CW,
                                tsynth.FakeSignal(f=F0, dm=DM,
                                                  shape="gauss", width=0.1,
                                                  amp=1.0),
                                noise_sigma=2.0, seed=3)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_survey_slice_matches_jax(tmp_path, jax_tpu_path):  # noqa: F811
    raw = str(tmp_path / "psr.fil")
    fake_filterbank_file(raw, N, DT, NCHAN, LOFREQ, CW,
                         FakeSignal(f=F0, dm=DM, shape="gauss",
                                    width=WIDTH, amp=1.0),
                         noise_sigma=6.0, seed=21)
    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jwork)
    jcfg = _config(jsurvey)
    jseam, disk_only = jsurvey._survey_head(
        [raw], jcfg, jwork, os.path.join(jwork, "psr"),
        jsurvey.SurveyResult(workdir=jwork), StageTimer())
    assert not disk_only
    tcfg = _config(tsurvey)
    tseam = tsurvey.survey_head(raw, tcfg, twork, device="cpu")

    jdats = sorted(glob.glob(os.path.join(jwork, "psr_DM*.dat")))
    tdats = sorted(glob.glob(os.path.join(twork, "psr_DM*.dat")))
    assert len(jdats) == 8
    assert [os.path.basename(p) for p in jdats] == \
        [os.path.basename(p) for p in tdats]
    for a, b in zip(jdats, tdats):
        assert open(a, "rb").read() == open(b, "rb").read(), a

    got = tsurvey.seam_fft_search(tseam, tcfg, device="cpu")
    assert len(got) == 8
    for block in jseam.blocks:
        n = block.numout & ~1
        series = np.asarray(block.series_host[:, :n])
        pairs = np.asarray(jfft.realfft_packed_pairs(series))
        T = block.numout * 5e-4
        js = jaccel.AccelSearch(jaccel.AccelConfig(zmax=20, numharm=8,
                                                   sigma=jcfg.sigma,
                                                   flo=jcfg.flo),
                                T=T, numbins=n // 2)
        for name, raw_c in zip(block.names, js.search_many(pairs)):
            want = jaccel.remove_duplicates(
                jaccel.eliminate_harmonics(raw_c))
            key = os.path.join(twork, os.path.basename(name))
            assert_lists_agree(want, got[key], js.powcut)

    # the strongest candidate above flo (harmonic sums reaching down
    # to the DC bin report r below it) sits at the pulsar's DM trial
    # and on a harmonic of its frequency
    T = N * DT
    best_name, best = max(((k, c) for k, cs in got.items() for c in cs
                           if c.r / T > tcfg.flo),
                          key=lambda kc: kc[1].sigma)
    assert float(best_name.rsplit("_DM", 1)[1]) == DM
    f = best.r / T
    assert abs(f / F0 - round(f / F0)) < 0.01 and round(f / F0) >= 1
    assert os.path.exists(best_name + ".fft")
