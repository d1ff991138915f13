"""The port's TOA stack (timing/, io/bestprof.py, astro/, apps/get_toas.py)
against the JAX package's, on the CPU.

fftfit, the templates, read_bestprof and the site codes are host copies:
equal results.  TOAs from a .pfd summed as stored are host sums: the
.tim lines are byte-equal.  With -d the subbands are realigned by the
device rotate-and-sum (combine_subbands), whose float32 sums reduce in
their own order: each TOA within 1e-3 of its own error bar, errors
within rtol 1e-4.
"""

import numpy as np
import pytest

from presto_tpu.apps import get_toas as jtoas_app
from presto_tpu.apps import prepfold as jprepfold
from presto_tpu.astro import observatory as jobs
from presto_tpu.io import bestprof as jbestprof
from presto_tpu.io.pfd import read_pfd as jread_pfd
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.timing.fftfit import fftfit as jfit
from presto_tpu.timing.fftfit import gaussian_template as jgauss
from presto_tpu.timing import toas as jtoas
from presto_tpu_torch.apps import get_toas as ttoas_app
from presto_tpu_torch.apps import prepfold as tprepfold
from presto_tpu_torch.astro import observatory as tobs
from presto_tpu_torch.io import bestprof as tbestprof
from presto_tpu_torch.io.pfd import read_pfd
from presto_tpu_torch.timing.fftfit import fftfit as tfit
from presto_tpu_torch.timing.fftfit import gaussian_template as tgauss
from presto_tpu_torch.timing import toas as ttoas


@pytest.fixture(scope="module")
def pfds(tmp_path_factory):
    """A subbanded fold of a 400 MHz filterbank written by the JAX CLI
    (jax.pfd) and the same fold by the port's (torch.pfd), with their
    .bestprof files."""
    d = tmp_path_factory.mktemp("toas")
    raw = str(d / "psr.fil")
    fake_filterbank_file(raw, 1 << 15, 5e-4, 32, 400.0, 2.0,
                         FakeSignal(f=13.7, dm=30.0, shape="gauss",
                                    width=0.05, amp=2.0),
                         noise_sigma=4.0, seed=31)
    argv = ["-f", "13.7", "-dm", "29.5", "-n", "64", "-npart", "32",
            "-nsub", "8", "-npfact", "1", "-ndmfact", "1", "-noplot"]
    jprepfold.main(argv + ["-o", str(d / "jax"), raw])
    tprepfold.main(argv + ["-o", str(d / "torch"), raw], device="cpu")
    return d


def test_fftfit_matches_jax():
    rng = np.random.default_rng(3)
    tpl = tgauss(128, 0.07)
    np.testing.assert_array_equal(tpl, jgauss(128, 0.07))
    for shift in (0.0, 0.13, -0.41):
        prof = 5.0 + 3.0 * np.roll(tpl, int(shift * 128)) \
            + rng.normal(0, 0.3, 128)
        assert vars(tfit(prof, tpl)) == vars(jfit(prof, tpl))


@pytest.mark.parametrize("ntoa", [1, 4])
def test_toas_from_jax_pfd(pfds, ntoa):
    """The port's toas_from_pfd on the JAX package's .pfd: equal TOAs
    summed as stored; within the module docstring's tolerance when
    realigned at another DM."""
    path = str(pfds / "jax.pfd")
    jp, tp = jread_pfd(path), read_pfd(path)
    want = jtoas.toas_from_pfd(jp, ntoa=ntoa)
    got = ttoas.toas_from_pfd(tp, ntoa=ntoa, device="cpu")
    assert [vars(t) for t in got] == [vars(t) for t in want]
    want = jtoas.toas_from_pfd(jp, ntoa=ntoa, dm=30.3, fold_dm=tp.bestdm)
    got = ttoas.toas_from_pfd(tp, ntoa=ntoa, dm=30.3, fold_dm=tp.bestdm,
                              device="cpu")
    assert len(got) == len(want) == ntoa
    for a, b in zip(want, got):
        assert (b.mjdi, b.freq_mhz, b.obs) == (a.mjdi, a.freq_mhz, a.obs)
        assert abs(b.mjdf - a.mjdf) * 86400e6 <= 1e-3 * a.err_us
        np.testing.assert_allclose(b.err_us, a.err_us, rtol=1e-4)


def _tim(main, argv, out):
    assert main(argv + ["-o", out]) == 0
    return open(out).read().splitlines()


@pytest.mark.parametrize("extra", [[], ["-2"], ["-t", "jax.pfd.bestprof"]])
def test_get_toas_cli_byte_equal(pfds, monkeypatch, extra):
    monkeypatch.chdir(pfds)
    argv = ["-n", "4"] + extra + ["jax.pfd", "torch.pfd"]
    want = _tim(jtoas_app.main, argv, "j.tim")
    got = _tim(lambda a: ttoas_app.main(a, device="cpu"), argv, "t.tim")
    assert len(got) == 8 + ("-2" in extra)
    assert got == want


def test_get_toas_cli_with_dm(pfds, monkeypatch):
    """-d realigns on the device: the module docstring's tolerance."""
    monkeypatch.chdir(pfds)
    argv = ["-n", "4", "-d", "30.3", "torch.pfd"]
    want = _tim(jtoas_app.main, argv, "j.tim")
    got = _tim(lambda a: ttoas_app.main(a, device="cpu"), argv, "t.tim")
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        fa, fb = a.split(), b.split()
        assert fa[:3] == fb[:3] and fa[1] == fb[1]
        err = float(fa[-1])
        mjd_a = float(a[24:44])
        mjd_b = float(b[24:44])
        assert abs(mjd_a - mjd_b) * 86400e6 <= 1e-3 * err
        np.testing.assert_allclose(float(fb[-1]), err, rtol=1e-4)


def test_get_toas_missing_pfd_is_one_line(tmp_path, capsys):
    assert ttoas_app.main([str(tmp_path / "none.pfd")], device="cpu") == 1
    assert "get_TOAs:" in capsys.readouterr().out


def test_read_bestprof_of_port_file(pfds):
    path = str(pfds / "torch.pfd.bestprof")
    want, got = jbestprof.read_bestprof(path), tbestprof.read_bestprof(path)
    for k, v in vars(want).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(got, k), v)
        else:
            assert getattr(got, k) == v, k
    assert got.proflen == 64 and got.profile.size == 64
    assert got.chi_sqr > 5 and abs(got.best_dm - 30.0) < 2.0


@pytest.mark.parametrize("name", ["GBT", "Parkes", "meerkat", "FAST",
                                  "Fake", "geocenter", ""])
def test_site_codes_match_jax(name):
    assert tobs.tempo1_site_code(name) == jobs.tempo1_site_code(name)
    assert tobs.telescope_to_tempocode(name) == \
        jobs.telescope_to_tempocode(name)
