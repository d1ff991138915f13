"""The port's host CLIs against the JAX package's, on the CPU.

Each case runs one command line (or a short chain of them) through the
JAX CLI in one directory and through the port's CLI in another, both
holding a copy of the same seeded inputs and called with the same
relative paths, so their text needs no path rewriting.  The two runs
must return the same code and print the same stdout and stderr, and
write the same files: data and text byte-equal, PNG images equal pixel
for pixel once decoded, PDF documents with the same page count (both
carry their creation date).
"""

import importlib
import os
import re
import shutil

import numpy as np
import pytest

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import InfoData, write_inf
from presto_tpu_torch.io.makfile import MakParams, write_mak
from presto_tpu_torch.io.maskfile import fill_mask, write_mask, write_statsfile
from presto_tpu_torch.io.pfd import Pfd, write_bestprof, write_pfd
from presto_tpu_torch.io.sigproc import FilterbankHeader, write_filterbank

N_DAT, DT_DAT, F_DAT = 1 << 14, 1e-3, 17.3


def _series(rng):
    t = np.arange(N_DAT) * DT_DAT
    x = rng.normal(0.0, 1.0, N_DAT) + 0.6 * np.exp(
        20.0 * (np.cos(2 * np.pi * F_DAT * t) - 1.0)) + 5.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """The seeded inputs every case starts from."""
    from presto_tpu_torch.apps import accelsearch
    d = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(20)
    p = str(d / "p")
    datfft.write_dat(p + ".dat", _series(rng))
    write_inf(InfoData(name="p", N=float(N_DAT), dt=DT_DAT,
                       telescope="GBT", object="FAKEPSR", mjd_i=59000,
                       mjd_f=0.25, freq=1400.0, chan_wid=1.0, num_chan=1,
                       freqband=1.0, onoff=[(0, N_DAT - 1)]), p + ".inf")
    full = np.fft.rfft(datfft.read_dat(p + ".dat").astype(np.float64))
    packed = full[:-1].astype(np.complex64)
    packed[0] = full[0].real + 1j * full[-1].real
    datfft.write_fft(p + ".fft", packed)
    cwd = os.getcwd()
    os.chdir(str(d))
    try:
        assert accelsearch.main(["-zmax", "0", "-numharm", "4", "p.fft"],
                                device="cpu") == 0
    finally:
        os.chdir(cwd)
    # a 16-channel 8-bit filterbank, descending on disk
    data = np.clip(np.round(rng.normal(100.0, 8.0, (8192, 16))), 0, 255)
    write_filterbank(str(d / "x.fil"), FilterbankHeader(
        nchans=16, nifs=1, nbits=8, tsamp=5e-4, fch1=1415.0, foff=-1.0,
        tstart=59000.5, source_name="FAKE", telescope_id=6, machine_id=10,
        src_raj=123456.7, src_dej=-123456.7),
        data.astype(np.float32))
    with open(str(d / "trunc.fil"), "wb") as f:
        f.write(b"\x0c\x00\x00\x00HEADER_ST")
    # rfifind products, a .pfd with its .bestprof
    numint, nchan = 12, 16
    byt = np.zeros((numint, nchan), np.uint8)
    byt[3, 4:7] = 1
    write_mask(str(d / "r_rfifind.mask"), fill_mask(
        10.0, 4.0, 59000.5, 0.5, 1400.0, 1.0, nchan, numint, 1000,
        [0, 1], [7], byt))
    pw = rng.exponential(20.0, (numint, nchan)).astype(np.float32)
    pw[:, 9] = 900.0
    avg = rng.normal(100.0, 1.0, (numint, nchan)).astype(np.float32)
    avg[:, 12] += 30.0
    std = rng.normal(8.0, 0.2, (numint, nchan)).astype(np.float32)
    write_statsfile(str(d / "r_rfifind.stats"), pw, avg, std, 1000)
    write_inf(InfoData(name="r", N=12000.0, dt=5e-4, num_chan=nchan,
                       freq=1400.0, chan_wid=1.0, freqband=16.0),
              str(d / "r_rfifind.inf"))
    profs = rng.normal(100, 5, (8, 4, 32))
    profs[:, :, 10:14] += 30.0
    pfd = Pfd(npart=8, nsub=4, proflen=32, numchan=16, dt=1e-3,
              tepoch=59000.0, fold_p1=F_DAT, lofreq=1400.0, chan_wid=1.0,
              bestdm=23.0, candnm="CAND1", telescope="GBT",
              dms=np.array([23.0]), periods=np.array([1 / F_DAT]),
              pdots=np.array([0.0]), profs=profs,
              stats=np.ones((8, 4, 7)))
    write_pfd(str(d / "c.pfd"), pfd)
    write_bestprof(str(d / "c.pfd.bestprof"), pfd,
                   profs.sum(axis=(0, 1)), 1.0 / F_DAT, 0.0, 12.5)
    # a .mak (gaussian pulses in a binary), events, zero-lags, weights,
    # TOAs and a text report
    write_mak(str(d / "m.mak"), MakParams(
        N=8192, dt=1e-3, shape="Gaussian", roundformat="Fractional",
        f=11.1, fdot=1e-4, amp=3.0, dc=10.0, orb_p=3.0, orb_x=0.01,
        orb_e=0.1, orb_w=40.0, ampmod_a=0.2, ampmod_f=0.5,
        noise_sigma=1.0, onoff=[(0.0, 0.4), (0.6, 1.0)], fwhm=0.05))
    write_mak(str(d / "s.mak"), MakParams(N=4096, dt=2e-3, f=7.0, amp=2.0,
                                          noise_sigma=0.0))
    zl = rng.normal(0.0, 1.0, 4096) + np.linspace(0.0, 20.0, 4096)
    zl.astype("<f4").tofile(str(d / "z.zerolags"))
    w = np.ones(32, int)
    w[[0, 1, 2, 7, 20, 21, 31]] = 0
    np.savetxt(str(d / "w.weights"), np.stack([np.arange(32), w], 1),
               fmt="%d", header="Chan  Weight")
    toas = np.sort(rng.uniform(0.0, 50.0, 300))
    np.savetxt(str(d / "toas.txt"), toas, fmt="%.9f")
    (55000.0 + toas / 86400.0).tofile(str(d / "toas.bin"))
    with open(str(d / "report.txt"), "w") as f:
        for i in range(150):
            f.write("line %3d\tof the report %s\n" % (i, "x" * (i % 50)))
    return str(d)


# (case id, [(CLI module, argv), ...])
CASES = [
    ("a2x_pdf", [("a2x", ["report.txt"])]),
    ("a2x_png", [("a2x", ["-landscape", "-columns", "2", "-lines", "20",
                          "-noheader", "-o", "r.png", "report.txt"])]),
    ("dat2tim_tim2dat", [("dat2tim", ["p.dat"]),
                         ("tim2dat", ["-o", "q", "p.tim"])]),
    ("datutils_shiftdata", [("datutils", ["shiftdata", "-shift", "2.3",
                                          "p.dat"])]),
    ("datutils_patchdata", [("datutils", ["patchdata", "100", "300",
                                          "p.dat", "-o", "pp.dat"])]),
    ("datutils_sdat", [("datutils", ["dat2sdat", "p.dat"]),
                       ("datutils", ["sdat2dat", "-o", "r.dat",
                                     "p.sdat"])]),
    ("datutils_toas2dat_text", [("datutils", ["toas2dat", "-dt", "0.5",
                                              "-n", "100", "toas.txt"])]),
    ("datutils_toas2dat_days", [("datutils", [
        "toas2dat", "-dt", "0.01", "-n", "500", "-double", "-days",
        "-t0", "55000.0001", "toas.bin", "-o", "td.dat"])]),
    ("ddplan", [("ddplan", ["-l", "0", "-d", "200", "-f", "1400", "-b",
                            "300", "-n", "512", "-t", "6.4e-5", "-s",
                            "32"])]),
    ("ddplan_fil_plot", [("ddplan", ["-l", "10", "-d", "60", "-r", "0.5",
                                     "-o", "plan.png", "x.fil"])]),
    ("dftfold_f", [("dftfold", ["-n", "8", "-f", "17.3", "p.dat"])]),
    ("dftfold_p_fftnorm", [("dftfold", ["-n", "16", "-p", "0.0578",
                                        "-fftnorm", "p.dat"])]),
    ("dftfold_r_norm", [("dftfold", ["-r", "283.4", "-norm", "4.0",
                                     "p.dat"])]),
    ("downsample", [("downsample", ["-factor", "3", "p.dat"]),
                    ("downsample", ["-f", "2", "-o", "ds.dat", "p.dat"])]),
    ("downsample_filterbank", [("downsample_filterbank", ["4", "x.fil"])]),
    ("exploredat", [("exploredat", ["-png", "d.png", "-start", "1", "-dur",
                                    "5", "p.dat"])]),
    ("explorefft", [("explorefft", ["-png", "f.png", "-lof", "5", "-hif",
                                    "40", "p.fft"])]),
    ("fb_truncate", [("fb_truncate", ["-L", "1", "-R", "3", "-B", "1403",
                                      "-T", "1410", "-o", "t.fil",
                                      "x.fil"])]),
    ("filter_zerolags", [("filter_zerolags", ["-dt", "1e-3",
                                              "z.zerolags"]),
                         ("filter_zerolags", ["-baseline", "-o", "b.dat",
                                              "z.zerolags"])]),
    ("makedata_binary", [("makedata", ["-seed", "3", "m.mak"])]),
    ("makedata_sine", [("makedata", ["s"])]),
    ("makeinf", [("makeinf", ["-o", "made", "-N", "4096", "-dt", "1e-3",
                              "-freq", "1400", "-numchan", "64",
                              "-chanwid", "1.5", "-telescope", "GBT",
                              "-object", "J0000+0000", "-ra", "12:00:00.0",
                              "-dec", "-30:00:00.0", "-mjd", "55000.25",
                              "-notes", "a note"])]),
    ("powerstats", [("powerstats", ["-power", "30", "-numsum", "4",
                                    "-numtrials", "1e6", "-sigma", "5"]),
                    ("powerstats", ["-sigma", "8"])]),
    ("quick_prune_cands", [("quick_prune_cands", ["p_ACCEL_0"]),
                           ("quick_prune_cands", ["p_ACCEL_0", "3.0"])]),
    ("quickffdots", [("quickffdots", ["-nr", "21", "-nz", "11", "-o",
                                      "q.png", "p.fft", "17.3"])]),
    ("readfile_describe", [("readfile", ["-n", "4", "x.fil", "p.dat",
                                         "p.fft", "p.inf", "c.pfd",
                                         "c.pfd.bestprof"])]),
    ("readfile_typed", [("readfile", ["-rzwcand", "p_ACCEL_0.cand"]),
                        ("readfile", ["-double", "-index", "0", "6",
                                      "r_rfifind.mask"]),
                        ("readfile", ["-float", "-index", "3", "9",
                                      "p.dat"]),
                        ("readfile", ["-filterbank", "x.fil"])]),
    ("readfile_truncated", [("readfile", ["trunc.fil"])]),
    ("rednoise", [("rednoise", ["p.fft"])]),
    ("rfifind_stats", [("rfifind_stats", ["r_rfifind.mask"]),
                       ("rfifind_stats", ["-invertband", "-edges", "0.1",
                                          "-power", "100", "r"])]),
    ("subband_smearing", [("subband_smearing", [
        "-lodm", "0", "-hidm", "100", "-numchan", "64", "-numsub", "8",
        "-o", "s.png"])]),
    ("timeconv", [("timeconv", ["mjd2cal", "55000.5", "59580.123"]),
                  ("timeconv", ["cal2mjd", "2020", "3", "4", "12", "30",
                                "15.5"]),
                  ("timeconv", [])]),
    ("weights_to_ignorechan", [("weights_to_ignorechan", [
        "-o", "line.txt", "w.weights"])]),
    ("window", [("window", ["-numbetween", "8", "-o", "w.png"])]),
]


def _run(pkg, steps, workdir, capsys):
    """Run the steps with ``pkg``'s CLIs in ``workdir``: per step the
    return code (a SystemExit's code) and the captured text."""
    out = []
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for name, argv in steps:
            mod = importlib.import_module("%s.apps.%s" % (pkg, name))
            try:
                rc = mod.main(list(argv))
            except SystemExit as e:
                rc = e.code
            text = capsys.readouterr()
            out.append((rc, text.out, text.err))
    finally:
        os.chdir(cwd)
    return out


def _files(d):
    return {f: os.path.join(d, f) for f in sorted(os.listdir(d))}


def _pages(path):
    with open(path, "rb") as f:
        return len(re.findall(rb"/Type\s*/Page\b", f.read()))


@pytest.mark.parametrize("steps", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cli_equals_jax(src, tmp_path, capsys, steps):
    import matplotlib.image as mimg
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    want = _run("presto_tpu", steps, a, capsys)
    got = _run("presto_tpu_torch", steps, b, capsys)
    assert got == want
    fa, fb = _files(a), _files(b)
    assert list(fb) == list(fa)
    made = [f for f in fa if f not in os.listdir(src)]
    changed = [f for f in fa if f not in made and open(
        fa[f], "rb").read() != open(os.path.join(src, f), "rb").read()]
    if any(rc not in (0, None) for rc, _o, _e in want):
        assert not made and not changed
    else:
        assert made or changed or all(o for _rc, o, _e in want)
    for f in made + changed:
        if f.endswith(".png"):
            assert np.array_equal(mimg.imread(fb[f]), mimg.imread(fa[f]))
        elif f.endswith(".pdf"):
            assert _pages(fb[f]) == _pages(fa[f]) > 0
        else:
            assert open(fb[f], "rb").read() == open(fa[f], "rb").read(), f
    if steps[0][0] == "dat2tim":
        assert open(os.path.join(b, "q.dat"), "rb").read() == \
            open(os.path.join(b, "p.dat"), "rb").read()
