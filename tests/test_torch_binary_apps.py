"""The port's binary-search CLIs and campaign (apps/{search_bin,
quicklook, monte_binresp, fit_circular_orbit, orbellipsefit, psrorbit,
plotbincand}, pipeline/monte, search/orbitfit) against the JAX
package's, on the CPU, each pair run on the same files.

Tolerances.  search_bin's candidates are held as in
test_torch_phasemod.py (the same keys in the same order, mini_power
within rtol 1e-5, mini_sigma within 1e-4); its table is the port's own
candidates in the JAX package's format.  quicklook's statistics line and
its bins and frequencies are equal, its power/median within rtol 1e-4
(float32 FFTs of two libraries).  The orbit fits, psrorbit and
plotbincand are host float64 in both packages: equal output text and
equal figure bytes.  run_campaign gives the JAX package's detection
table exactly (the trials are the same floats: one NumPy generator).
"""

import json
import os

import numpy as np
import pytest
import torch

from presto_tpu.apps import (fit_circular_orbit as jfit,
                             monte_binresp as jmonte_cli,
                             orbellipsefit as jell, plotbincand as jpbc,
                             psrorbit as jpo, quicklook as jql,
                             search_bin as jsb)
from presto_tpu.pipeline import monte as jm
from presto_tpu.search import orbitfit as jof
from presto_tpu_torch.apps import (fit_circular_orbit as tfit,
                                   monte_binresp as tmonte_cli,
                                   orbellipsefit as tell, plotbincand as tpbc,
                                   psrorbit as tpo, quicklook as tql,
                                   search_bin as tsb)
from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import InfoData, write_inf
from presto_tpu_torch.pipeline import monte as tm
from presto_tpu_torch.search import orbitfit as tof
from presto_tpu_torch.search import phasemod as P

from test_torch_phasemod import assert_same_cands, binary_spectrum

QL_RTOL = 1e-4


def _in(tmp_path, side):
    d = str(tmp_path / side)
    os.makedirs(d, exist_ok=True)
    return d


def _fft_files(d, name="bt", stacked=None):
    fft, N, dt = binary_spectrum()
    base = os.path.join(d, name)
    if stacked is None:
        datfft.write_fft(base + ".fft", fft)
    else:
        stacked.astype(np.float32).tofile(base + ".fft")
    write_inf(InfoData(name=name, N=float(N), dt=dt, mjd_i=55000,
                       mjd_f=0.25), base + ".inf")
    return base


@pytest.mark.parametrize("stack", [0, 2])
def test_search_bin_cli_equals_jax(tmp_path, stack):
    """search_bin on the same .fft (or stacked powers, -stack 2): the
    .cand lists held as the phasemod tests hold them, the .txt the
    port's candidates in the reference's table."""
    stacked = None
    if stack:
        f1, _, _ = binary_spectrum()
        f2, _, _ = binary_spectrum(seed=5)
        stacked = np.abs(f1) ** 2 + np.abs(f2) ** 2
    argv = ["-ncand", "12", "-minfft", "512", "-maxfft", "1024", "-rlo",
            "49000", "-rhi", "55000", "-stack", str(stack)]
    out = {}
    for side, run in (("j", jsb.main),
                      ("t", lambda a: tsb.main(a, device="cpu"))):
        base = _fft_files(_in(tmp_path, side), stacked=stacked)
        run(argv + [base + ".fft"])
        out[side] = (P.read_bincands(base + "_bin3.cand"),
                     open(base + "_bin3.txt").read())
    (jc, _jtxt), (tc, ttxt) = out["j"], out["t"]
    assert tc
    assert_same_cands(tc, jc)
    assert ttxt == P.rawbin_report(tc)
    assert abs(tc[0].orb_p - 400.0) / 400.0 < 0.1


def test_quicklook_equals_jax(tmp_path, capsys):
    """The tone of tests/test_smallutils.py in a .dat, then its .fft."""
    rng = np.random.default_rng(4)
    N, dt, f0 = 4096, 1e-3, 50.0
    t = np.arange(N) * dt
    data = (np.sin(2 * np.pi * f0 * t) * 5 + rng.normal(0, 1, N)
            ).astype(np.float32)
    base = str(tmp_path / "tone")
    datfft.write_dat(base + ".dat", data)
    write_inf(InfoData(name=base, N=N, dt=dt), base + ".inf")
    assert jql.main([base + ".dat"]) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert tql.main([base + ".dat"], device="cpu") == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got[:2] == want[:2] and len(got) == len(want) == 12
    for g, w in zip(got[2:], want[2:]):
        g, w = g.split(), w.split()
        assert g[:2] == w[:2]
        assert abs(float(g[2]) - float(w[2])) <= QL_RTOL * float(w[2]) + 0.01
    assert abs(float(got[2].split()[1]) - f0) < 0.5
    spec = np.fft.rfft(data)[:N // 2].astype(np.complex64)
    datfft.write_fft(base + ".fft", spec)
    assert jql.main(["-n", "5", base + ".fft"]) == 0
    want = capsys.readouterr().out
    assert tql.main(["-n", "5", base + ".fft"], device="cpu") == 0
    assert capsys.readouterr().out == want


def test_orbit_fits_equal_jax():
    """search/orbitfit: the circular and eccentric fits of
    tests/test_events_fitting.py, equal to the JAX package's."""
    rng = np.random.default_rng(1)
    true = tof.OrbitFit(p_psr=0.0045, p_orb=8.1 * 3600, x=2.3, T0=1200.0)
    t = np.sort(rng.uniform(0, 3 * true.p_orb, 40))
    assert (tof.predicted_period(t, true) == jof.predicted_period(
        t, jof.OrbitFit(**true.__dict__))).all()
    p_meas = tof.predicted_period(t, true) + rng.normal(0, 2e-9, t.size)
    got = tof.fit_circular_orbit(t, p_meas, 8.0 * 3600, 2.0)
    want = jof.fit_circular_orbit(t, p_meas, 8.0 * 3600, 2.0)
    assert got.__dict__ == want.__dict__
    assert abs(got.p_orb - true.p_orb) / true.p_orb < 1e-3
    true = tof.OrbitFit(p_psr=0.012, p_orb=20000.0, x=5.0, T0=3000.0,
                        e=0.3, w=45.0)
    t = np.sort(rng.uniform(0, 3 * true.p_orb, 80))
    p_meas = tof.predicted_period(t, true) + rng.normal(0, 5e-9, t.size)
    got = tof.fit_eccentric_orbit(t, p_meas, 19000.0, 4.0, 0.2, 30.0)
    want = jof.fit_eccentric_orbit(t, p_meas, 19000.0, 4.0, 0.2, 30.0)
    assert got.__dict__ == want.__dict__
    assert abs(got.e - true.e) < 0.05


@pytest.mark.parametrize("ecc", [False, True])
def test_fit_circular_orbit_cli_equals_jax(tmp_path, capsys, ecc):
    rng = np.random.default_rng(2)
    true = tof.OrbitFit(p_psr=0.003, p_orb=6.0 * 3600, x=1.5, T0=500.0,
                        e=0.2 if ecc else 0.0, w=60.0 if ecc else 0.0)
    t = np.sort(rng.uniform(0, 2 * true.p_orb, 30))
    path = str(tmp_path / "meas.txt")
    np.savetxt(path, np.column_stack([55000.0 + t / 86400.0,
                                      tof.predicted_period(t, true)]))
    argv = ["-porb", "6.2", "-x", "1.0"] + (["-e"] if ecc else []) + [path]
    assert jfit.main(argv) == 0
    want = capsys.readouterr().out
    assert tfit.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    porb = float([ln for ln in got.splitlines()
                  if ln.startswith("P_orb")][0].split()[2])
    # the circular fit recovers the orbit (tests/test_events_fitting.py);
    # from this seed the eccentric one stops 2% off in both packages
    assert abs(porb - true.p_orb) < (60.0 if not ecc else 0.03 * porb)


def test_orbellipsefit_cli_equals_jax(tmp_path, capsys):
    """The circular orbit of tests/test_bin_tail.py sampled in .par
    files: the same printed fit."""
    CSPEED = 299792458.0
    P0, Porb, V = 0.005, 40000.0, 8.0e4
    phis = np.linspace(0.1, 2 * np.pi, 9)
    ps = P0 * (1 + V / CSPEED * np.cos(phis))
    accs = -(2 * np.pi * V / Porb) * np.sin(phis)
    files = []
    for i, (p, a) in enumerate(zip(ps, accs)):
        fn = str(tmp_path / ("o%d.par" % i))
        with open(fn, "w") as f:
            f.write("PSR J0000+0000\nPEPOCH 55000\nF0 %.15g 1e-9\n"
                    "F1 %.6e 1e-12\nDM 10\n" % (1.0 / p, -a / (CSPEED * p)))
        files.append(fn)
    assert jell.main(["-f1errmax", "1"] + files) == 0
    want = capsys.readouterr().out
    assert tell.main(["-f1errmax", "1"] + files) == 0
    got = capsys.readouterr().out
    assert got == want
    porb = float(got.split("Porb = ")[1].split()[0])
    assert abs(porb - Porb) / Porb < 0.05


@pytest.mark.parametrize("argv", [
    ["-p", "0.005", "-porb", "7200", "-x", "1.2", "-e", "0.1", "-w", "30"],
    ["-psr", "J0737-3039A"]], ids=["explicit", "catalog"])
def test_psrorbit_cli_equals_jax(tmp_path, capsys, argv):
    jo, to = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert jpo.main(argv + ["-o", jo]) == 0
    want = capsys.readouterr().out.replace(jo, "OUT")
    assert tpo.main(argv + ["-o", to]) == 0
    got = capsys.readouterr().out.replace(to, "OUT")
    assert got == want
    assert open(to, "rb").read() == open(jo, "rb").read()
    assert open(to, "rb").read(4) == b"\x89PNG"


def test_plotbincand_cli_equals_jax(tmp_path, capsys):
    """plotbincand of a search_bin candidate (tests/test_phasemod.py):
    the same text and figure as the JAX CLI on the same files."""
    base = _fft_files(str(tmp_path))
    fft, N, dt = binary_spectrum()
    cands = P.search_phasemod(fft, N, dt, P.PhaseModConfig(
        ncand=5, minfft=1024, maxfft=2048, harmsum=3, rlo=49000,
        rhi=55000), device="cpu")
    assert cands
    P.write_bincands(base + "_bin3.cand", cands)
    outs = {}
    for side, main in (("j", jpbc.main), ("t", tpbc.main)):
        png = base + "_%s.png" % side
        assert main([base, "1", "-o", png]) == 0
        outs[side] = (capsys.readouterr().out.replace(png, "OUT"),
                      open(png, "rb").read())
    assert outs["t"] == outs["j"]
    assert tpbc.main([base, "2"]) == 0
    assert os.path.exists(base + "_bin_cand_2.png")


def test_run_campaign_equals_jax(tmp_path):
    """The regimes of tests/test_explore_monte.py at a small size: ffdot
    finds the long orbit and misses the short one, which the long miniFFT
    finds; the table equals the JAX package's, and the trials are its
    floats."""
    kw = dict(N=1 << 17, dt=2e-2, f_psr=20.0, amp=0.3, asini_lts=0.2,
              pb_over_t=(0.2, 20.0), ntrials=1, sigma_cut=4.0, seed=7)
    cfg = tm.MonteConfig(**kw)
    a = tm._make_trial(cfg, 500.0, np.random.default_rng(3))
    b = jm._make_trial(jm.MonteConfig(**kw), 500.0,
                       np.random.default_rng(3))
    assert a.tobytes() == b.tobytes()
    want = jm.run_campaign(jm.MonteConfig(**kw), methods=["ffdot", "long"])
    got = tm.run_campaign(cfg, methods=["ffdot", "long"], device="cpu")
    assert got == want
    assert got["results"]["20.0"]["ffdot"] == 1.0
    assert got["results"]["0.2"]["long"] == 1.0
    assert got["results"]["0.2"]["ffdot"] == 0.0
    assert tm.format_table(got) == jm.format_table(want)
    out = str(tmp_path / "monte.json")
    tm.save_json(got, out)
    assert json.load(open(out)) == json.loads(json.dumps(want))


def test_short_method_and_cli_equal_jax(tmp_path, capsys):
    """The short miniFFT method through both monte_binresp CLIs (a small
    trial whose orbit it finds): the same table and JSON."""
    argv = ["--N", str(1 << 15), "--dt", "0.08", "--fpsr", "5", "--amp",
            "0.8", "--asini", "0.8", "--ratios", "0.2", "--ntrials", "1",
            "--sigma", "4", "--seed", "8", "--methods", "short", "-q"]
    jo, to = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jmonte_cli.main(argv + ["-o", jo])
    want = capsys.readouterr().out.replace(jo, "OUT")
    assert tmonte_cli.main(argv + ["-o", to], device="cpu") == 0
    got = capsys.readouterr().out.replace(to, "OUT")
    assert got == want
    assert open(to).read() == open(jo).read()
    assert json.load(open(to))["results"]["0.2"]["short"] == 1.0


def test_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    base = _fft_files(str(tmp_path))
    for call in (lambda: tsb.main([base + ".fft"]),
                 lambda: tql.main([base + ".fft"]),
                 lambda: tmonte_cli.main(["--ntrials", "1"]),
                 lambda: tm.run_campaign(tm.MonteConfig(ntrials=1))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.path.exists(base + "_bin3.cand")
