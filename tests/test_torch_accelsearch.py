"""The port's accelsearch app (ACCEL/.cand files, refine + write_results,
the CLI) against the JAX package's (refine_and_write), on the CPU.

The writers are byte-equal for the same candidates.  Polished
candidates agree within the tolerances of tests/test_torch_polish.py
(r 2e-3 bins, z 1e-2; power rtol 1e-4 and sigma 1e-3 on the same grid
point, 1e-3 and 1e-2 where a near-tie moved it a final-stage step).
"""

import glob
import os
import struct

import numpy as np
import pytest
import torch

from presto_tpu.apps import accelsearch as japp
from presto_tpu.io.infodata import InfoData as JInfoData
from presto_tpu.io.infodata import write_inf as jwrite_inf
from presto_tpu.search import accel as jaccel
from presto_tpu_torch.apps import accelsearch as tapp
from presto_tpu_torch.io.errors import PrestoIOError
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import polish as tpolish
from test_torch_accel import jax_tpu_path, spectra  # noqa: F401
from test_torch_polish import assert_polish_agrees

N, DT = 1 << 16, 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cand_list(kind):
    rng = np.random.default_rng(4)
    if kind == "empty":
        return []
    if kind == "edge":
        # r 0 (freq 0: the period column prints 0), negative z, huge r
        return [taccel.AccelCand(power=0.0, sigma=0.0, numharm=1, r=0.0,
                                 z=0.0),
                taccel.AccelCand(power=1234.5678, sigma=35.25, numharm=16,
                                 r=123456789.123456, z=-987.654321, w=0.0)]
    return [taccel.AccelCand(power=float(p), sigma=float(s), numharm=int(h),
                             r=float(r), z=float(z))
            for p, s, h, r, z in zip(rng.uniform(5, 500, 40),
                                     rng.uniform(2, 40, 40),
                                     rng.choice([1, 2, 4, 8, 16], 40),
                                     rng.uniform(1, 1e6, 40),
                                     rng.uniform(-200, 200, 40))]


@pytest.mark.parametrize("kind", ["empty", "edge", "random"])
def test_writers_byte_equal(tmp_path, kind):
    cands = cand_list(kind)
    jc = [jaccel.AccelCand(power=c.power, sigma=c.sigma, numharm=c.numharm,
                           r=c.r, z=c.z) for c in cands]
    a, b = str(tmp_path / "j_ACCEL_200"), str(tmp_path / "t_ACCEL_200")
    japp.write_accel_file(a, jc, 537.0)
    tapp.write_accel_file(b, cands, 537.0)
    assert open(a, "rb").read() == open(b, "rb").read()
    japp.write_cand_file(a + ".cand", jc)
    tapp.write_cand_file(b + ".cand", cands)
    assert open(a + ".cand", "rb").read() == open(b + ".cand", "rb").read()


@pytest.mark.parametrize("legacy", [False, True])
def test_read_cand_file_round_trip(tmp_path, legacy):
    """The 36-byte records (with w) and the 28-byte records of the
    format before the jerk search read back as the JAX reader reads
    them."""
    cands = cand_list("random")
    path = str(tmp_path / "x_ACCEL_20.cand")
    if legacy:
        with open(path, "wb") as f:
            for c in cands:
                f.write(struct.pack("<ffidd", c.power, c.sigma, c.numharm,
                                    c.r, c.z))
    else:
        tapp.write_cand_file(path, cands)
    got = tapp.read_cand_file(path)
    want = japp.read_cand_file(path)
    key = lambda c: (c.power, c.sigma, c.numharm, c.r, c.z, c.w)  # noqa
    assert [key(c) for c in got] == [key(c) for c in want]
    assert [(c.numharm, c.r, c.z) for c in got] == \
        [(c.numharm, c.r, c.z) for c in cands]


def test_read_cand_file_rejects_bad_sizes(tmp_path):
    path = str(tmp_path / "bad.cand")
    with open(path, "wb") as f:
        f.write(b"\0" * 37)
    with pytest.raises(PrestoIOError, match="neither"):
        tapp.read_cand_file(path)
    with pytest.raises(PrestoIOError, match="cannot read"):
        tapp.read_cand_file(str(tmp_path / "missing.cand"))


@pytest.fixture(scope="module")
def searched():
    """One spectrum with an accelerated pulsar, searched by the port on
    the CPU: (pairs, searcher, raw candidates)."""
    pairs = spectra(1)[0]
    s = taccel.AccelSearch(taccel.AccelConfig(zmax=20, numharm=8,
                                              sigma=2.0),
                           T=N * DT, numbins=N // 2, device="cpu")
    return pairs, s, s.search(pairs)


def refine_and_write(raw, amps, T, s, base, zmax, wmax=0, harmremove=True,
                     lobin=0):
    """The port's counterpart of the JAX package's refine_and_write:
    refine, then write_results.  Returns (final candidates, ACCEL
    path)."""
    trace = tapp.refine(raw, amps, T, s, wmax=wmax, harmremove=harmremove)
    return trace.final, tapp.write_results(trace, T, base, zmax, wmax,
                                           quiet=True, lobin=lobin)


def to_jax(cands):
    return [jaccel.AccelCand(power=c.power, sigma=c.sigma,
                             numharm=c.numharm, r=c.r, z=c.z)
            for c in cands]


@pytest.mark.parametrize("harmremove,lobin", [(True, 0), (False, 0),
                                              (True, 1000)])
def test_refine_and_write_matches_jax(tmp_path, searched, harmremove,
                                      lobin):
    """Same raw list and spectrum: the same count and order of final
    candidates, fields within the polish tolerances, and ACCEL/.cand
    files that parse to the same keys."""
    pairs, s, raw = searched
    amps = pairs[:, 0] + 1j * pairs[:, 1]
    want, jname = japp.refine_and_write(
        to_jax(raw), amps.astype(np.complex64), s.T, s,
        str(tmp_path / "j"), 20, quiet=True, harmremove=harmremove,
        lobin=lobin)
    got, tname = refine_and_write(
        [taccel.AccelCand(**vars(c)) for c in raw],
        torch.from_numpy(pairs), s.T, s, str(tmp_path / "t"), 20,
        harmremove=harmremove, lobin=lobin)
    assert tname.endswith("t_ACCEL_20") and os.path.exists(tname + ".cand")
    assert len(got) == len(want) > 0
    assert [c.numharm for c in got] == [c.numharm for c in want]
    assert_polish_agrees(want, got)
    back = tapp.read_cand_file(tname + ".cand")
    assert [(c.r, c.z) for c in back] == [(c.r, c.z) for c in got]
    # the pulsar tops the list at its mid-observation frequency (37.3 Hz
    # at the start, 0.004 Hz/s) and drift z = fdot T^2
    top = got[0]
    assert abs((top.r - lobin) / s.T - (37.3 + 0.004 * s.T / 2)) < 0.01
    assert abs(top.z - 0.004 * s.T ** 2) < 1.0


def test_refine_and_write_has_no_fallback(tmp_path, searched,
                                          monkeypatch):
    """A failing polish raises and leaves no ACCEL file behind (the JAX
    package catches it and falls back to the per-candidate path); so
    does a failing jerk polish, and with wmax and a working polish the
    jerk refinement runs and writes the _JERK_ table."""
    pairs, s, raw = searched

    def boom(*a, **k):
        raise RuntimeError("polish failed")
    monkeypatch.setattr(tapp, "optimize_accelcands", boom)
    with pytest.raises(RuntimeError, match="polish failed"):
        refine_and_write(list(raw), torch.from_numpy(pairs), s.T, s,
                         str(tmp_path / "t"), 20)
    assert not glob.glob(str(tmp_path / "t_ACCEL*"))
    monkeypatch.undo()
    cands, name = refine_and_write(list(raw), pairs, s.T, s,
                                   str(tmp_path / "t"), 20, wmax=10)
    assert name.endswith("t_ACCEL_20_JERK_10") and cands
    assert all(abs(c.w) <= 10 for c in cands)
    assert [c.w for c in tapp.read_cand_file(name + ".cand")] == \
        [c.w for c in cands]
    monkeypatch.setattr(tapp, "optimize_jerk_cands", boom)
    with pytest.raises(RuntimeError, match="polish failed"):
        refine_and_write(list(raw), pairs, s.T, s, str(tmp_path / "u"), 20,
                         wmax=10)
    assert not glob.glob(str(tmp_path / "u_ACCEL*"))


def test_port_has_no_polish_switches():
    """The port always runs the batched polish: no PRESTO_TPU_POLISH*
    switch and no environment read in the modules of this slice."""
    for rel in ("apps/accelsearch.py", "search/polish.py",
                "search/optimize.py", "pipeline/survey.py",
                "pipeline/sifting.py"):
        src = open(os.path.join(ROOT, "presto_tpu_torch", rel)).read()
        assert "PRESTO_TPU_POLISH" not in src, rel
        assert "os.environ" not in src and "getenv" not in src, rel


def write_spectrum(d, pairs):
    """<d>/x.fft and x.inf (float32 pairs as a complex64 .fft)."""
    os.makedirs(d, exist_ok=True)
    (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64).tofile(
        os.path.join(d, "x.fft"))
    jwrite_inf(JInfoData(name=os.path.join(d, "x"), N=float(N), dt=DT,
                         telescope="Fake", object="X", dm=10.0),
               os.path.join(d, "x.inf"))
    return os.path.join(d, "x.fft")


@pytest.mark.parametrize("argv", [
    ["-zmax", "20", "-numharm", "8", "-sigma", "2.0"],
    ["-zmax", "20", "-numharm", "4", "-sigma", "2.0", "-noharmpolish",
     "-flo", "20"],
    ["-zmax", "20", "-numharm", "8", "-sigma", "2.0", "-zaplist",
     os.path.join(ROOT, "presto_tpu_torch", "data", "default_birds.txt")],
    ["-zmax", "20", "-numharm", "2", "-sigma", "2.0", "-locpow"],
])
def test_accelsearch_cli_matches_jax(tmp_path, jax_tpu_path, argv):  # noqa: F811
    """The accelsearch CLI on the same .fft: the JAX package's (its TPU
    search path, on the CPU) and the port's write ACCEL files with the
    same candidates, within the polish tolerances."""
    pairs = spectra(1)[0]
    jf = write_spectrum(str(tmp_path / "j"), pairs)
    tf = write_spectrum(str(tmp_path / "t"), pairs)
    assert japp.main(argv + [jf]) == 0
    assert tapp.main(argv + [tf], device="cpu") == 0
    want = japp.read_cand_file(jf[:-4] + "_ACCEL_20.cand")
    got = tapp.read_cand_file(tf[:-4] + "_ACCEL_20.cand")
    assert len(got) == len(want) > 0
    assert [c.numharm for c in got] == [c.numharm for c in want]
    assert_polish_agrees(want, got)
    ja = open(jf[:-4] + "_ACCEL_20").read().splitlines()
    ta = open(tf[:-4] + "_ACCEL_20").read().splitlines()
    assert ja[:3] == ta[:3] and len(ja) == len(ta)


def test_accelsearch_cli_dat_input(tmp_path, jax_tpu_path):  # noqa: F811
    """A .dat input goes through the packed rFFT (the port's torch.fft,
    the JAX package's jnp.fft) and deredden: the same candidates, within
    the polish tolerances, with the pulsar on top."""
    rng = np.random.default_rng(2)
    t = np.arange(N) * DT
    x = (rng.normal(size=N) + 0.2 * np.cos(2 * np.pi * 37.3 * t)
         ).astype(np.float32)
    paths = []
    for side in ("j", "t"):
        d = str(tmp_path / side)
        os.makedirs(d)
        x.tofile(os.path.join(d, "x.dat"))
        jwrite_inf(JInfoData(name=os.path.join(d, "x"), N=float(N), dt=DT,
                             telescope="Fake", object="X"),
                   os.path.join(d, "x.inf"))
        paths.append(os.path.join(d, "x"))
    argv = ["-zmax", "0", "-numharm", "2"]
    assert japp.main(argv + [paths[0] + ".dat"]) == 0
    assert tapp.main(argv + [paths[1] + ".dat"], device="cpu") == 0
    want = japp.read_cand_file(paths[0] + "_ACCEL_0.cand")
    got = tapp.read_cand_file(paths[1] + "_ACCEL_0.cand")
    assert [c.numharm for c in got] == [c.numharm for c in want]
    assert_polish_agrees(want, got)
    assert abs(got[0].r / (N * DT) - 37.3) < 0.01


def test_accelsearch_cli_short_fft(tmp_path, jax_tpu_path):  # noqa: F811
    """A 3000-bin .fft (zmax 200, numharm 8): too short for the aligned
    plane geometry, searched on the JAX package's other geometry by
    both CLIs.  The same candidate count and harmonics; every candidate,
    whatever its sigma, agrees by polish.agreement (sigma-0 noise has a
    flat power surface on which a near-tie moves the polish up to two
    final-stage z steps: the powers at both points must then tie)."""
    from test_torch_accel import short_spectrum
    pairs, T = short_spectrum(3000)
    paths = []
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64).tofile(
            str(d / "x.fft"))
        jwrite_inf(JInfoData(name=str(d / "x"), N=6000.0, dt=T / 6000,
                             telescope="Fake", object="X", dm=10.0),
                   str(d / "x.inf"))
        paths.append(str(d / "x.fft"))
    argv = ["-zmax", "200", "-numharm", "8", "-sigma", "2.0"]
    assert japp.main(argv + [paths[0]]) == 0
    assert tapp.main(argv + [paths[1]], device="cpu") == 0
    want = japp.read_cand_file(paths[0][:-4] + "_ACCEL_200.cand")
    got = tapp.read_cand_file(paths[1][:-4] + "_ACCEL_200.cand")
    assert len(got) == len(want) > 0
    assert [c.numharm for c in got] == [c.numharm for c in want]
    assert sum(c.sigma > 2.0 for c in want) >= 3
    # the seeds both CLIs polished (the port's search, on the CPU), in
    # the order of the polished lists
    searcher = taccel.AccelSearch(taccel.AccelConfig(zmax=200, numharm=8,
                                                     sigma=2.0),
                                  T=T, numbins=len(pairs), device="cpu")
    seeds = taccel.remove_duplicates(taccel.eliminate_harmonics(
        searcher.search(pairs)))
    ocs = tpolish.optimize_accelcands(pairs, seeds, T, searcher.numindep,
                                      device="cpu")
    seed_of = {(o.r, o.z): s for s, o in zip(seeds, ocs)}
    rep = tpolish.agreement(pairs, want, got,
                            seeds=[seed_of[(c.r, c.z)] for c in got])
    assert rep["unexplained"] == 0, rep["flags"]
