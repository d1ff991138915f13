"""The port's rfifind (search/rfifind, apps/rfifind, io/maskfile) against
the JAX package's, on the CPU.

The per-cell statistics are float32 reductions and FFTs in another
order than XLA's: avg and std agree within rtol 2e-6, maxpow within
rtol 1e-5 (plus 1e-4 absolute, the FFT rounding of a channel of
constant samples, whose power is normalized by 1).  Those differences
sit far from every threshold on these inputs (cell_margins says how
far), so the bytemasks, and with them the .mask files, are byte-equal;
so are the .inf files and the quality reports.  The .stats files hold
the statistics: equal headers, values within the same tolerances.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from presto_tpu.apps import rfifind as japp
from presto_tpu.io import maskfile as jmask
from presto_tpu.io import sigproc as jsig
from presto_tpu.search import rfifind as jrfi
from presto_tpu_torch.apps import common as tcommon
from presto_tpu_torch.apps import rfifind as tapp
from presto_tpu_torch.io import maskfile as tmask
from presto_tpu_torch.search import rfifind as trfi

N, NCHAN, DT = 1 << 15, 32, 5e-4
RFI_TIME = 1.0                    # 2000 spectra an interval, 16 intervals
NARROW, PERIODIC, BURST_INT = 5, 20, 3


def rfi_filterbank(path, seed=11, N=N, nchan=NCHAN, dt=DT, zero_run=False):
    """An 8-bit filterbank (baseline 64, noise 6) with RFI: channel
    NARROW carries a persistent +15 offset, channel PERIODIC a 50 Hz
    sinusoid of amplitude 4, and interval BURST_INT (RFI_TIME long) a
    broadband +4 burst, below the clipper's 6 sigma of the band sum.
    ``zero_run`` adds 300 all-zero spectra (a backend dropout)."""
    rng = np.random.default_rng(seed)
    x = 64.0 + 6.0 * rng.normal(size=(N, nchan))
    t = np.arange(N) * dt
    x[:, NARROW] += 15.0
    x[:, PERIODIC] += 4.0 * np.sin(2 * np.pi * 50.0 * t)
    per = int(RFI_TIME / dt + 0.5)
    x[BURST_INT * per:(BURST_INT + 1) * per] += 4.0
    data = np.clip(np.round(x), 0, 255)
    if zero_run:
        data[9000:9300] = 0.0
    hdr = jsig.FilterbankHeader(nchans=nchan, nbits=8, tsamp=dt,
                                fch1=1338.0 + (nchan - 1) * 4.0, foff=-4.0,
                                tstart=59000.0, source_name="RFI",
                                telescope_id=6)
    jsig.write_filterbank(path, hdr, data)
    return path


@pytest.fixture(scope="module")
def fil(tmp_path_factory):
    return rfi_filterbank(str(tmp_path_factory.mktemp("rfi") / "rfi.fil"))


def _both(tmp_path, fil, flags, outs=(".mask", ".stats", ".inf"),
          quality=True):
    """Run both CLIs with ``flags`` in their own directories, the same
    output base; returns {side: {suffix: bytes}}."""
    got = {}
    for side, run in (("j", lambda a: japp.main(a)),
                      ("t", lambda a: tapp.main(a, device="cpu"))):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            run(flags + ["-noplot", "-o", "rfi", fil])
        finally:
            os.chdir(cwd)
        names = ["_rfifind" + o for o in outs]
        if quality:
            names.append("_rfifind_quality.json")
        got[side] = {n: open(d / ("rfi" + n), "rb").read() for n in names}
    return got


def _assert_stats_close(a, b):
    assert a[:20] == b[:20]              # header: geometry, lobin, numbetween
    va = np.frombuffer(a[20:], "<f4").reshape(3, -1)
    vb = np.frombuffer(b[20:], "<f4").reshape(3, -1)
    np.testing.assert_allclose(vb[0], va[0], rtol=1e-5, atol=1e-4)   # pow
    np.testing.assert_allclose(vb[1:], va[1:], rtol=2e-6)            # avg, std


def test_interval_stats_match_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    for n in (1000, 2000, 4096):
        cells = (64 + 6 * rng.normal(size=(NCHAN, n))).astype(np.float32)
        cells[3] += 5 * np.sin(2 * np.pi * 0.1 * np.arange(n))
        cells[7] = 10.0                  # a constant channel: var 0
        want = [np.asarray(x) for x in
                jrfi._interval_stats(jnp.asarray(cells), n)]
        got = [x.numpy() for x in trfi._interval_stats(
            torch.from_numpy(cells))]
        np.testing.assert_allclose(got[0], want[0], rtol=2e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=2e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-4)
        assert got[1][7] == 0.0 and got[2][3] > 100.0


def test_rfifind_products_match_jax(tmp_path, fil):
    """The RFI beam: .mask, .inf and the quality report byte-equal to the
    JAX CLI's, .stats within the statistics' tolerances; the mask holds
    the narrowband and periodic channels and the burst interval."""
    out = _both(tmp_path, fil, ["-time", str(RFI_TIME)])
    for k in ("_rfifind.mask", "_rfifind.inf", "_rfifind_quality.json"):
        assert out["t"][k] == out["j"][k], k
    _assert_stats_close(out["j"]["_rfifind.stats"],
                        out["t"]["_rfifind.stats"])
    m = tmask.read_mask(str(tmp_path / "t" / "rfi_rfifind.mask"))
    assert {NARROW, PERIODIC} <= set(m.zap_chans.tolist())
    assert BURST_INT in m.zap_ints.tolist()
    st = tmask.read_statsfile(str(tmp_path / "t" / "rfi_rfifind.stats"))
    margins = trfi.cell_margins(st["dataavg"], st["datastd"],
                                st["datapow"], st["ptsperint"])
    # every cell sits farther from its thresholds than the statistics'
    # tolerance: the equal masks are not luck
    assert margins.shape == (16, NCHAN) and margins.min() > 1e-5


@pytest.mark.parametrize("flags", [
    ["-zapchan", "0:2,30"], ["-zapints", "1,7:8"], ["-ignorechan", "9"],
    ["-blocks", "1", "-timesig", "6", "-freqsig", "3.5"],
    ["-chanfrac", "0.5", "-intfrac", "0.2", "-zerodm", "-noclip"]])
def test_rfifind_flags_match_jax(tmp_path, fil, flags):
    flags = flags if "-blocks" in flags else ["-time", str(RFI_TIME)] + flags
    out = _both(tmp_path, fil, flags)
    for k in ("_rfifind.mask", "_rfifind.inf"):
        assert out["t"][k] == out["j"][k], k
    _assert_stats_close(out["j"]["_rfifind.stats"],
                        out["t"]["_rfifind.stats"])


def test_rfifind_nocompute_matches_jax(tmp_path, fil):
    """-nocompute re-thresholds the JAX package's .stats/.inf (a file
    written by either package is read by the other): the same .mask
    bytes as the JAX CLI's -nocompute."""
    _both(tmp_path, fil, ["-time", str(RFI_TIME)])
    shutil.copy(tmp_path / "j" / "rfi_rfifind.stats",
                tmp_path / "t" / "rfi_rfifind.stats")
    out = _both(tmp_path, fil, ["-nocompute", "-timesig", "5",
                                "-zapchan", "11"], outs=(".mask",),
                quality=False)
    assert out["t"]["_rfifind.mask"] == out["j"]["_rfifind.mask"]


def test_quality_zaps_join_the_mask(tmp_path):
    """A zero-fill run quarantined by the reader becomes zapped
    intervals, as in the JAX CLI; the report is written beside the
    mask."""
    path = rfi_filterbank(str(tmp_path / "z.fil"), zero_run=True)
    out = _both(tmp_path, path, ["-time", str(RFI_TIME)])
    assert out["t"]["_rfifind.mask"] == out["j"]["_rfifind.mask"]
    assert out["t"]["_rfifind_quality.json"] == \
        out["j"]["_rfifind_quality.json"]
    m = tmask.read_mask(str(tmp_path / "t" / "rfi_rfifind.mask"))
    assert {BURST_INT, 4} <= set(m.zap_ints.tolist())   # 9000:9300


def test_plot_request_is_refused(tmp_path, fil, monkeypatch):
    """A run that draws the mask plot is refused with ImportError naming
    matplotlib, before any work, where matplotlib is missing; -noplot
    (with or without -rfips or -xwin, which only choose where the plot
    goes) runs without it.  With matplotlib the plot is drawn
    (tests/test_torch_plots.py holds it to the JAX CLI's)."""
    out = str(tmp_path / "x")
    with monkeypatch.context() as m:
        for name in [k for k in sys.modules
                     if k.startswith("matplotlib.")] + ["matplotlib"]:
            m.setitem(sys.modules, name, None)
        for flags in ([], ["-rfips"], ["-xwin"]):
            with pytest.raises(ImportError, match="matplotlib"):
                tapp.main(flags + ["-o", out, fil], device="cpu")
        assert not os.path.exists(out + "_rfifind.mask")
        for flags in (["-noplot", "-rfips"], ["-noplot", "-xwin"]):
            tapp.main(flags + ["-time", str(RFI_TIME), "-o", out, fil],
                      device="cpu")
        assert os.path.exists(out + "_rfifind.mask")
        assert not os.path.exists(out + "_rfifind.png")
    tapp.main(["-time", str(RFI_TIME), "-rfips", "-o", out, fil],
              device="cpu")
    for ext, magic in ((".png", b"\x89PNG"), (".ps", b"%!PS")):
        with open(out + "_rfifind" + ext, "rb") as f:
            assert f.read(4) == magic


def test_maskfile_cross_package(tmp_path):
    """Masks and stats written by one package read back by the other,
    byte for byte; determine_padvals and check_mask agree."""
    rng = np.random.default_rng(8)
    bytemask = (rng.random((12, 20)) < 0.1).astype(np.uint8) * 0x10
    bytemask[4] = 0x08
    args = (10.0, 4.0, 59000.5, 0.25, 1338.0, 4.0, 20, 12, 500, [3, 7],
            [4], bytemask)
    for w, r in ((jmask, tmask), (tmask, jmask)):
        a, b = str(tmp_path / "a.mask"), str(tmp_path / "b.mask")
        w.write_mask(a, w.fill_mask(*args))
        r.write_mask(b, r.read_mask(a))
        assert open(a, "rb").read() == open(b, "rb").read()
        pw = rng.random((12, 20)).astype(np.float32)
        w.write_statsfile(str(tmp_path / "a.stats"), pw, pw + 1, pw + 2,
                          500)
        st = r.read_statsfile(str(tmp_path / "a.stats"))
        r.write_statsfile(str(tmp_path / "b.stats"), st["datapow"],
                          st["dataavg"], st["datastd"], st["ptsperint"])
        assert open(tmp_path / "a.stats", "rb").read() == \
            open(tmp_path / "b.stats", "rb").read()
        assert np.array_equal(jmask.determine_padvals(str(
            tmp_path / "a.stats")), tmask.determine_padvals(str(
                tmp_path / "a.stats")))
    jm, tm = jmask.read_mask(a), tmask.read_mask(a)
    for t0, dur in ((0.0, 0.2), (0.9, 0.3), (1.0, 0.25), (2.9, 2.0),
                    (10.0, 5.0)):
        jn, jc = jm.check_mask(t0, dur)
        tn, tc = tm.check_mask(t0, dur)
        assert jn == tn and (jc is None) == (tc is None)
        assert jc is None or np.array_equal(jc, tc)


def test_block_prep_with_mask_matches_jax(tmp_path, fil):
    """BlockPrep with -mask (padding values from the .stats beside it)
    and -ignorechan over blocks whose boundaries fall inside rfifind
    intervals (check_mask in seconds from start_spectra): the JAX
    package's blocks, bit for bit."""
    import argparse
    from presto_tpu.apps.common import BlockPrep as JBlockPrep
    from presto_tpu_torch.io import sigproc as tsig
    _both(tmp_path, fil, ["-time", str(RFI_TIME)])
    mpath = str(tmp_path / "t" / "rfi_rfifind.mask")
    args = argparse.Namespace(mask=mpath, ignorechan="2,31", clip=6.0)
    tprep = tcommon.block_prep(args, NCHAN, DT)
    jprep = JBlockPrep(NCHAN, DT, args, mask=jmask.read_mask(mpath),
                       padvals=jmask.determine_padvals(
                           mpath.replace(".mask", ".stats")),
                       ignore=np.array([2, 31]))
    with tsig.FilterbankFile(fil) as fb:
        for start in range(0, N, 1500):
            blk = fb.read_spectra(start, 1500)
            want = jprep(blk.copy(), start)
            got = tprep(blk.copy(), start)
            assert np.array_equal(got, want), start
