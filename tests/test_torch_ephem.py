"""The port's ephemeris host modules against the JAX package's, on the
CPU: io/parfile, ops/orbit, astro/binary, io/residuals, astro/polycos,
utils/catalog, apps/zapbirds' makezaplist and apps/pfd_for_timing.

Every one is a host NumPy copy of the JAX module, so the tolerance is
none: equal numbers (np.array_equal, or == on floats) and byte-equal
files.
"""

import os

import numpy as np
import pytest

from presto_tpu.apps import pfd_for_timing as jpft
from presto_tpu.apps import zapbirds as jzap
from presto_tpu.astro import binary as jbin
from presto_tpu.astro import polycos as jpc
from presto_tpu.io import parfile as jpar
from presto_tpu.io import residuals as jres
from presto_tpu.io.infodata import InfoData, write_inf
from presto_tpu.ops import orbit as jorb
from presto_tpu.utils import catalog as jcat
from presto_tpu_torch.apps import pfd_for_timing as tpft
from presto_tpu_torch.apps import zapbirds as tzap
from presto_tpu_torch.astro import binary as tbin
from presto_tpu_torch.astro import polycos as tpc
from presto_tpu_torch.io import parfile as tpar
from presto_tpu_torch.io import residuals as tres
from presto_tpu_torch.io.pfd import Pfd, write_pfd
from presto_tpu_torch.ops import orbit as torb
from presto_tpu_torch.utils import catalog as tcat

ISO_PAR = """\
PSRJ           J0332+5434
RAJ            03:32:59.4
DECJ           +54:34:43.6
F0             1.399541538720  1  0.000000000003
F1             -4.011970D-15
PEPOCH         55555.0
DM             26.7641
"""

BIN_PAR = """\
PSRJ           J1915+1606
RAJ            19:15:27.99942
DECJ           +16:06:27.3868
F0             16.940537785677
F1             -2.4733E-15
PEPOCH         55555.0
DM             168.77
BINARY         BT
PB             0.322997448918
A1             2.341782
ECC            0.6171338
OM             292.54450
T0             55555.2
PBDOT          -2.423
"""

ELL1_PAR = """\
PSR            1012+5307
RAJ            10:12:33.43
DECJ           +53:07:02.6
P0             0.005255749
P1             1.7e-20
PEPOCH         50700.0
DM             9.02
BINARY         ELL1
PB             0.60467271355
A1             0.581818
TASC           50700.08162
EPS1           1.2e-5
EPS2           2.1e-5
"""

PARS = {"iso": ISO_PAR, "bt": BIN_PAR, "ell1": ELL1_PAR}


@pytest.fixture(params=sorted(PARS))
def par(request, tmp_path):
    p = tmp_path / ("%s.par" % request.param)
    p.write_text(PARS[request.param])
    return str(p)


def _attrs(obj):
    return {k: v for k, v in vars(obj).items()}


def test_parfile_equals_jax(par):
    j, t = jpar.Parfile(par), tpar.Parfile(par)
    assert _attrs(t) == _attrs(j)
    assert str(t) == str(j) and t.name == j.name
    assert t.is_binary == j.is_binary
    assert t.spin_at(55560.25) == j.spin_at(55560.25)
    for epoch in (None, 55556.7):
        jo, to = j.orbit(epoch), t.orbit(epoch)
        assert (to is None) == (jo is None)
        if to is not None:
            assert vars(to) == vars(jo)


ORBITS = [dict(p=8834.535, e=0.0877775, x=1.415032, w=87.0331, t=1234.5),
          dict(p=27906.98, e=0.6171338, x=2.341782, w=292.5445, t=0.0,
               wd=4.2),
          dict(p=52243.6, e=0.0, x=0.58, w=0.0, t=5000.0)]


@pytest.mark.parametrize("k", range(len(ORBITS)))
def test_orbit_equals_jax(k):
    jo, to = jorb.OrbitParams(**ORBITS[k]), torb.OrbitParams(**ORBITS[k])
    t = to.t + np.linspace(0.0, 3 * to.p, 4001)
    E_j = jorb.keplers_eqn(t, jo.p, jo.e)
    E_t = torb.keplers_eqn(t, to.p, to.e)
    assert np.array_equal(E_t, E_j)
    for fn in ("E_to_phib", "E_to_v"):
        assert np.array_equal(getattr(torb, fn)(E_t, to),
                              getattr(jorb, fn)(E_j, jo))
    assert np.array_equal(torb.E_to_p(E_t, 0.0227, to),
                          jorb.E_to_p(E_j, 0.0227, jo))
    assert np.array_equal(torb.E_to_z(E_t, 0.0227, 500.0, to),
                          jorb.E_to_z(E_j, 0.0227, 500.0, jo))
    assert np.array_equal(torb.dorbint(0.3, 257, 2.0, to),
                          jorb.dorbint(0.3, 257, 2.0, jo))
    times = np.linspace(0.0, 537.0, 2049)
    assert np.array_equal(torb.orbit_delays(times, to),
                          jorb.orbit_delays(times, jo))
    assert torb.ell1_to_keplerian(1.2e-5, 2.1e-5, 50700.08, 0.6) == \
        jorb.ell1_to_keplerian(1.2e-5, 2.1e-5, 50700.08, 0.6)


def test_binary_equals_jax(tmp_path):
    p = tmp_path / "b.par"
    p.write_text(BIN_PAR)
    j, t = jbin.BinaryPsr(str(p)), tbin.BinaryPsr(str(p))
    mjds = 55555.0 + np.linspace(0.0, 1.3, 97)
    for a, b in zip(t.calc_anoms(mjds), j.calc_anoms(mjds)):
        assert np.array_equal(a, b)
    for fn in ("most_recent_peri", "calc_omega", "radial_velocity",
               "doppler_period", "demodulate_TOAs"):
        assert np.array_equal(getattr(t, fn)(mjds), getattr(j, fn)(mjds))
    for a, b in zip(t.position(mjds, returnz=True),
                    j.position(mjds, returnz=True)):
        assert np.array_equal(a, b)
    R, S = tbin.shapiro_R(1.39), tbin.shapiro_S(1.44, 1.39, 2.34, 0.323)
    assert (R, S) == (jbin.shapiro_R(1.39),
                      jbin.shapiro_S(1.44, 1.39, 2.34, 0.323))
    ma, ea, _ = t.calc_anoms(mjds)
    assert np.array_equal(t.shapiro_delays(R, S, ea),
                          j.shapiro_delays(R, S, ea))
    assert np.array_equal(t.shapiro_measurable(R, S, ma),
                          j.shapiro_measurable(R, S, ma))
    iso = tmp_path / "i.par"
    iso.write_text(ISO_PAR)
    with pytest.raises(ValueError):
        tbin.BinaryPsr(str(iso))


@pytest.mark.parametrize("marker", [4, 8])
def test_residuals_equal_jax(tmp_path, marker):
    rng = np.random.default_rng(marker)
    cols = [55000.0 + np.sort(rng.uniform(0, 100, 17))] + [
        rng.normal(size=17) for _ in range(8)]
    tres.write_residuals(str(tmp_path / "t.tmp"), *cols, marker=marker)
    jres.write_residuals(str(tmp_path / "j.tmp"), *cols, marker=marker)
    assert open(str(tmp_path / "t.tmp"), "rb").read() == \
        open(str(tmp_path / "j.tmp"), "rb").read()
    t = tres.read_residuals(str(tmp_path / "j.tmp"))
    j = jres.read_residuals(str(tmp_path / "j.tmp"))
    assert t.numTOAs == j.numTOAs == 17
    for k, v in vars(j).items():
        assert np.array_equal(getattr(t, k), v), k


@pytest.mark.parametrize("telescope,obsfreq,barytime", [
    ("GBT", 1400.0, False), ("Parkes", 0.0, False), ("GBT", 820.0, True)])
def test_polycos_make_write_read_fit_equal_jax(par, tmp_path, telescope,
                                               obsfreq, barytime):
    kw = dict(telescope=telescope, obsfreq=obsfreq, span_min=30,
              barytime=barytime, ephem="DE405")
    j = jpc.make_polycos(par, 55556.1, 75.0, **kw)
    t = tpc.make_polycos(par, 55556.1, 75.0, **kw)
    assert len(t) == len(j) == 3
    for a, b in zip(t.blocks, j.blocks):
        va, vb = dict(vars(a)), dict(vars(b))
        assert np.array_equal(va.pop("coeffs"), vb.pop("coeffs"))
        assert va == vb
    tpc.write_polycos(t, str(tmp_path / "t.dat"))
    jpc.write_polycos(j, str(tmp_path / "j.dat"))
    text = open(str(tmp_path / "j.dat")).read()
    assert open(str(tmp_path / "t.dat")).read() == text
    rt = tpc.read_polycos(str(tmp_path / "j.dat"))
    rj = jpc.read_polycos(str(tmp_path / "j.dat"))
    for a, b in zip(rt.blocks, rj.blocks):
        va, vb = dict(vars(a)), dict(vars(b))
        assert np.array_equal(va.pop("coeffs"), vb.pop("coeffs"))
        assert va == vb
    assert tpc.fit_fold_params(rt, 55556.12, 3000.0) == \
        jpc.fit_fold_params(rj, 55556.12, 3000.0)
    m = 55556.5
    assert rt.get_phs_and_freq(int(m), m % 1) == \
        rj.get_phs_and_freq(int(m), m % 1)


CATALOG_PSRS = ["J0737-3039A", "B1913+16", "B1957+20", "J0437-4715",
                "B0531+21", "1012+5307", "J1903+0327", "J2222-0137"]


@pytest.mark.parametrize("name", CATALOG_PSRS)
def test_catalog_psrepoch_and_binary_velocity_equal_jax(name):
    for epoch in (53156.0, 57000.25):
        try:
            j = jcat.psrepoch(name, epoch)
        except KeyError:
            with pytest.raises(KeyError):
                tcat.psrepoch(name, epoch)
            continue
        t = tcat.psrepoch(name, epoch)
        vt, vj = dict(vars(t)), dict(vars(j))
        ot, oj = vt.pop("orb"), vj.pop("orb")
        assert vt == vj
        assert (ot is None) == (oj is None)
        if ot is None:
            continue
        assert vars(ot) == vars(oj)
        for T in (537.0, 3 * ot.p):
            assert tcat.binary_velocity(T, ot) == \
                jcat.binary_velocity(T, oj)
    assert len(tcat.default_catalog()) == len(jcat.default_catalog())


def test_catalog_parsers_equal_jax(tmp_path):
    shipped = tcat.shipped_catalog_path()
    assert shipped and os.path.basename(shipped) == "pulsars.psrcat"
    assert open(shipped, "rb").read() == \
        open(jcat.shipped_catalog_path(), "rb").read()
    assert tcat.parse_compact_catalog(shipped) == \
        jcat.parse_compact_catalog(jcat.shipped_catalog_path())
    atnf = tmp_path / "atnf.txt"
    atnf.write_text(
        "#NAME PSRJ RAJ ...\n"
        "1 B1913+16 J1915+1606 19:15:27.99 2e-3 +16:06:27.4 3e-2 * 0 "
        "* 0 * 0 * 52984.0 * 0.059030003 1e-12 8.6e-18 1e-21 * 0 * 0 "
        "52984.0 168.77 1e-2 * 0 * 0 * 0 BT 52144.9 1e-5 0.3229974 "
        "1e-10 2.341782 3e-6 292.5445 1e-4 0.6171338 4e-7 * 0 * 0 * 0 "
        "8.3 * *\n"
        "2 * J1012+5307 10:12:33.43 1e-2 +53:07:02.6 1e-1 * 0 * 0 * 0 "
        "* * * 0.005255749 1e-12 1.7e-20 1e-22 * 0 * 0 50700.0 9.02 "
        "1e-2 * 0 * 0 * 0 ELL1 * 0 0.6046727 1e-10 0.581818 2e-6 * 0 "
        "* 0 50700.08162 1e-6 1.2e-5 3e-7 2.1e-5 3e-7 0.7 * *\n")
    recs = tcat.parse_atnf_catalog(str(atnf))
    assert recs == jcat.parse_atnf_catalog(str(atnf)) and len(recs) == 2
    cat_t, cat_j = tcat.load_catalog(str(atnf)), jcat.load_catalog(str(atnf))
    assert len(cat_t) == len(cat_j) == 2
    assert vars(cat_t.params("J1012+5307").orb) == \
        vars(cat_j.params("J1012+5307").orb)
    assert tcat.default_birds_path() is not None


BIRDS = """\
# mains
60.0 0.05 4 1
50.0 0.02
P J0737-3039A 3
P B0531+21 2
P J0437-4715 2
17.3 0.01 3 0 1
"""


def test_makezaplist_equals_jax(tmp_path):
    out = {}
    for side, mod in (("j", jzap), ("t", tzap)):
        d = tmp_path / side
        d.mkdir()
        write_inf(InfoData(name="obs", N=float(1 << 22), dt=1.28e-4,
                           telescope="GBT", object="X", mjd_i=57000,
                           mjd_f=0.25), str(d / "obs.inf"))
        (d / "obs.birds").write_text(BIRDS)
        path = mod.makezaplist(str(d / "obs.birds"))
        out[side] = open(path).read()
        mod.makezaplist_main([str(d / "obs.birds")])
        assert open(path).read() == out[side]
    assert out["t"] == out["j"]
    # 3 + 2 + 2 pulsar harmonics and the 3-harmonic barycentric train
    lines = out["t"].splitlines()
    assert sum(ln.startswith("B") for ln in lines) == 10


def _pfd(tmp_path, name, searched):
    nper = 3 if searched else 1
    p = Pfd(numdms=1, numperiods=nper, numpdots=nper, nsub=1, npart=2,
            proflen=8, numchan=1, pstep=1, pdstep=2, dmstep=1,
            ndmfact=1, npfact=1, filenm="x.dat", candnm="X",
            telescope="GBT", pgdev="x.ps/CPS", dt=1e-3, tepoch=57000.0,
            bestdm=0.0, topo_p1=0.0227, topo_p2=0.0,
            fold_p1=1.0 / 0.0227 if not searched else 44.0,
            fold_p2=0.0, fold_p3=0.0,
            dms=np.zeros(1), periods=np.full(nper, 0.0227),
            pdots=np.zeros(nper),
            profs=np.ones((2, 1, 8)), stats=np.zeros((2, 1, 7)))
    path = str(tmp_path / name)
    write_pfd(path, p)
    return path


def test_pfd_for_timing_equals_jax(tmp_path, capsys):
    good = _pfd(tmp_path, "good.pfd", searched=False)
    bad = _pfd(tmp_path, "bad.pfd", searched=True)
    missing = str(tmp_path / "none.pfd")
    for files in ([good], [bad], [good, bad, missing]):
        rc_t = tpft.main(files)
        out_t = capsys.readouterr()
        rc_j = jpft.main(files)
        out_j = capsys.readouterr()
        assert (rc_t, out_t.out) == (rc_j, out_j.out)
        assert (out_t.err == "") == (out_j.err == "")
    assert tpft.main([good]) == 0
