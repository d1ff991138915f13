"""The port's ephemeris and binary folds (apps/prepfold -par, -timing,
-polycos, -absphase, -barypolycos, -psr, -bin) against the JAX
package's, on the CPU.

Both CLIs run in one directory with the same arguments on a small
seeded .dat (2^16 samples of 5e-4 s): a pulsar at 41.3 Hz in a binary
of Pb = 200 s and x = 0.4 lt-s, so the orbit moves its pulses by
~17 turns over the 32.8 s.  A -nosearch .pfd is byte-equal to the JAX
package's (the polycos, the catalog parameters and the orbit's delays
are host copies; the drizzle keeps its add order); a searched fold is
held by test_torch_prepfold's rule: chi2 surfaces within rtol 1e-5 of
their peak, the same best trial, the same .pfd bytes, and the
.bestprof numbers within rtol 1e-5.
"""

import os

import numpy as np
import pytest

from presto_tpu.apps import prepfold as japp
from presto_tpu.astro import polycos as jpc
from presto_tpu.io.infodata import InfoData, write_inf
from presto_tpu_torch.apps import prepfold as tapp
from presto_tpu_torch.io.pfd import read_pfd
from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays
from presto_tpu_torch.utils.catalog import psrepoch
from test_torch_prepfold import OUTS, _assert_search_agrees, \
    assert_bestprof_agree

N, DT, F0 = 1 << 16, 5e-4, 41.3
T = N * DT
MJD0 = 57000.25
PB, X, ECC, W = 200.0, 0.4, 0.1, 30.0
T_PERI = 37.0                  # s since periastron at the first sample
RA, DEC = "05:34:31.97", "+22:00:52.1"
BIN = ["-bin", "-pb", repr(PB), "-x", repr(X), "-e", repr(ECC),
       "-To", repr(MJD0 - T_PERI / 86400.0), "-w", repr(W)]

ISO_PAR = ("PSRJ J0534+2200\nRAJ %s\nDECJ %s\nF0 %.10f\nF1 1.0e-6\n"
           "PEPOCH %.6f\nDM 22.0\n" % (RA, DEC, F0, MJD0))


def _series(seed, orbit=None, f=F0, fd=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) * DT
    if orbit is not None:
        t = t - orbit_delays(t, orbit)
    ph = f * t + 0.5 * fd * t * t
    return (rng.normal(size=N) + 0.8 * np.exp(
        -0.5 * ((ph % 1.0 - 0.5) / 0.03) ** 2) + 5.0).astype(np.float32)


@pytest.fixture
def datdir(tmp_path, monkeypatch):
    """iso.dat (topocentric, GBT), bary.dat (the same samples, a
    barycentred .inf), bin.dat (the binary), psr.dat (J0737-3039A at
    the catalog's spin and orbit for the epoch), iso.par, and
    polyco.dat made by the JAX package from iso.par; the cwd is the
    directory."""
    iso = _series(21)
    pp = psrepoch("J0737-3039A", MJD0)
    psr = _series(23, OrbitParams(p=pp.orb.p, e=pp.orb.e, x=pp.orb.x,
                                  w=pp.orb.w, t=pp.orb.t), pp.f, pp.fd)
    binary = _series(22, OrbitParams(p=PB, e=ECC, x=X, w=W, t=T_PERI))
    for name, data, bary in (("iso", iso, 0), ("bary", iso, 1),
                             ("bin", binary, 1), ("psr", psr, 1)):
        data.tofile(str(tmp_path / (name + ".dat")))
        write_inf(InfoData(name=name, N=float(N), dt=DT, telescope="GBT",
                           object="FAKEPSR", ra_str=RA, dec_str=DEC,
                           dm=22.0, mjd_i=int(MJD0), mjd_f=MJD0 % 1.0,
                           bary=bary, freq=1338.0, freqband=128.0,
                           num_chan=32, chan_wid=4.0),
                  str(tmp_path / (name + ".inf")))
    (tmp_path / "iso.par").write_text(ISO_PAR)
    jpc.make_polycos(str(tmp_path / "iso.par"), MJD0 - 1.0 / 1440.0,
                     T / 60.0 + 2.0, telescope="GBT", obsfreq=1402.0,
                     ephem="DE405", outfile=str(tmp_path / "polyco.dat"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _both(argv):
    argv = argv + ["-noplot", "-o", "fold"]
    jres = japp.run(japp.build_parser().parse_args(argv))
    want = {o: open(o, "rb").read() for o in OUTS}
    for o in OUTS:
        os.remove(o)
    tres = tapp.run(tapp.build_parser().parse_args(argv), device="cpu")
    got = {o: open(o, "rb").read() for o in OUTS}
    return want, got, (jres, tres)


NOSEARCH = {
    "par": ["-par", "iso.par", "-nosearch", "iso.dat"],
    "par_bary": ["-par", "iso.par", "-nosearch", "bary.dat"],
    "timing": ["-timing", "iso.par", "iso.dat"],
    "polycos": ["-polycos", "polyco.dat", "-nosearch", "iso.dat"],
    "absphase_par": ["-par", "iso.par", "-absphase", "-nosearch",
                     "iso.dat"],
    "absphase_polycos_start": ["-polycos", "polyco.dat", "-absphase",
                               "-nosearch", "-start", "0.25", "iso.dat"],
    "barypolycos": ["-par", "iso.par", "-barypolycos", "-nosearch",
                    "bary.dat"],
    "psr_binary": ["-psr", "J0737-3039A", "-nosearch", "psr.dat"],
    "psr_isolated": ["-psr", "B0531+21", "-nosearch", "iso.dat"],
    "bin": ["-f", repr(F0)] + BIN + ["-wdot", "3.0", "-nosearch",
                                     "bin.dat"],
}


@pytest.mark.parametrize("case", sorted(NOSEARCH))
def test_nosearch_ephemeris_fold_pfd_byte_equal(datdir, case):
    want, got, (jres, tres) = _both(list(NOSEARCH[case]))
    assert got["fold.pfd"] == want["fold.pfd"]
    assert_bestprof_agree(want["fold.pfd.bestprof"],
                          got["fold.pfd.bestprof"])
    p = read_pfd("fold.pfd")
    if case == "timing":
        assert (p.npart, p.npfact, p.pstep) == (60, 1, 1)
    if case.startswith(("par", "timing", "polycos", "absphase")):
        assert abs(p.fold_p1 - F0) < 1.1e-4 * F0     # the Doppler
        assert tres.best_redchi > 5.0
    if case == "psr_binary":
        assert tres.best_redchi > 20.0


@pytest.mark.parametrize("case", ["bin", "psr_binary", "par"])
def test_searched_ephemeris_fold_matches_jax(datdir, case):
    argv = {"bin": ["-f", repr(F0)] + BIN + ["bin.dat"],
            "psr_binary": ["-psr", "J0737-3039A", "psr.dat"],
            "par": ["-par", "iso.par", "iso.dat"]}[case]
    want, got, (jres, tres) = _both(argv + ["-n", "32", "-npart", "16",
                                            "-npfact", "1"])
    _assert_search_agrees(jres, tres)
    assert got["fold.pfd"] == want["fold.pfd"]
    assert_bestprof_agree(want["fold.pfd.bestprof"],
                          got["fold.pfd.bestprof"])


def test_the_orbit_focuses_the_binary(datdir):
    """The -bin fold of bin.dat at the injected elements reaches a
    reduced chi2 far above the same fold without the orbit, which
    smears the ~16 turns of Roemer delay flat."""
    with_orbit = tapp.run(tapp.build_parser().parse_args(
        ["-f", repr(F0)] + BIN + ["-nosearch", "-noplot", "-o", "a",
                                  "bin.dat"]), device="cpu")
    without = tapp.run(tapp.build_parser().parse_args(
        ["-f", repr(F0), "-nosearch", "-noplot", "-o", "b", "bin.dat"]),
        device="cpu")
    assert with_orbit.best_redchi > 20.0
    assert without.best_redchi < 3.0


def test_absphase_needs_an_ephemeris(datdir):
    with pytest.raises(SystemExit, match="absphase"):
        tapp.main(["-f", "41.3", "-absphase", "-noplot", "iso.dat"],
                  device="cpu")
    with pytest.raises(SystemExit, match="-pb and -x"):
        tapp.main(["-f", "41.3", "-bin", "-noplot", "iso.dat"],
                  device="cpu")
    with pytest.raises(SystemExit, match="not in catalog"):
        tapp.main(["-psr", "J9999+9999", "-noplot", "iso.dat"],
                  device="cpu")
