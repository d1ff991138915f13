"""The port's single-pulse toolchain against the JAX package's.

The readers of the .singlepulse files (grouping and rating, the
rrattrap CLI), the waterfaller and the .spd bundles (make_spd) run on
the same seeded inputs in both packages, as tests/test_sp_toolchain.py
exercises the JAX package's: the groups, ranks, groups.txt bytes and
waterfall arrays are equal, and the .spd bundles hold equal arrays.
"""

import glob
import os

import numpy as np
import pytest

from presto_tpu.io.sigproc import FilterbankHeader, write_filterbank
from presto_tpu.ops.dedispersion import dedisp_delays
from presto_tpu.search import singlepulse as jsp
from presto_tpu import singlepulse as jtool
from presto_tpu.singlepulse import grouping as jgroup
from presto_tpu_torch.io.sigproc import FilterbankFile
from presto_tpu_torch.search import singlepulse as tsp
from presto_tpu_torch import singlepulse as ttool
from presto_tpu_torch.singlepulse import grouping as tgroup


def _events(mod, seed=5):
    """Three broadband pulses (sigma peaked in DM) and an RFI-like run
    strongest at DM 0, as SPCandidate lists of ``mod``."""
    rng = np.random.default_rng(seed)
    out = []
    for t0, dm0, peak, width in ((10.0, 50.0, 20.0, 5.0),
                                 (40.0, 50.0, 15.0, 12.0),
                                 (10.0, 90.0, 12.0, 3.0)):
        for dm in np.arange(0, 100, 1.0):
            s = peak * np.exp(-0.5 * ((dm - dm0) / width) ** 2)
            if s >= 5.0:
                out.append(mod.SPCandidate(
                    bin=int(t0 * 1000), sigma=float(s),
                    time=t0 + float(rng.normal(0, 0.005)), downfact=4,
                    dm=float(dm)))
    for dm in np.arange(0, 60, 1.0):
        s = 20.0 * np.exp(-dm / 20.0)
        if s >= 5.0:
            out.append(mod.SPCandidate(
                bin=0, sigma=float(s),
                time=30.0 + float(rng.normal(0, 0.005)), downfact=2,
                dm=float(dm)))
    return out


def _groups_key(groups):
    return [(g.rank, [(c.dm, c.sigma, c.time, c.bin) for c in g.cands])
            for g in groups]


@pytest.mark.parametrize("dm_thresh", [None, 1.5])
def test_grouping_and_ranks_equal(dm_thresh):
    for min_group in (5, 20, 30):
        jg = jgroup.group_candidates(_events(jsp), 0.1, dm_thresh)
        tg = tgroup.group_candidates(_events(tsp), 0.1, dm_thresh)
        jgroup.rank_groups(jg, min_group=min_group)
        tgroup.rank_groups(tg, min_group=min_group)
        assert _groups_key(tg) == _groups_key(jg)
        assert [str(g) for g in tg] == [str(g) for g in jg]
    assert max(g.rank for g in tg) >= 3


def test_rrattrap_cli_bytes_equal(tmp_path):
    """rrattrap over per-DM .singlepulse files written by the port: the
    same groups.txt bytes as the JAX CLI's, and read_and_group equal."""
    from presto_tpu.apps import rrattrap as japp
    from presto_tpu_torch.apps import rrattrap as tapp
    by_dm = {}
    for c in _events(tsp):
        by_dm.setdefault(c.dm, []).append(c)
    paths = []
    for dm, cs in sorted(by_dm.items()):
        p = str(tmp_path / ("x_DM%.2f.singlepulse" % dm))
        tsp.write_singlepulse(p, sorted(cs))
        paths.append(p)
    outs = []
    for app, name in ((japp, "j"), (tapp, "t")):
        out = str(tmp_path / ("%s_groups.txt" % name))
        assert app.main(["--min-group", "20", "-o", out] + paths) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    assert len(outs[1].splitlines()) >= 2
    assert _groups_key(tgroup.read_and_group(paths, min_group=10)) == \
        _groups_key(jgroup.read_and_group(paths, min_group=10))


def _pulse_fil(path, dm=100.0, t0=2.0, nchan=32, N=4096, dt=1e-3,
               lofreq=400.0, cw=1.0, amp=50.0):
    """32-bit filterbank with one dispersed pulse at t0 (highest freq)."""
    rng = np.random.default_rng(7)
    data = rng.normal(10.0, 1.0, size=(N, nchan)).astype(np.float32)
    delays = np.asarray(dedisp_delays(nchan, dm, lofreq, cw))
    delays = delays - delays.min()
    for c in range(nchan):
        k = int(round((t0 + delays[c]) / dt))
        if 0 <= k < N:
            data[k, c] += amp
    hdr = FilterbankHeader(nchans=nchan, nifs=1, nbits=32, tsamp=dt,
                           fch1=lofreq + (nchan - 1) * cw, foff=-cw,
                           tstart=58000.0, source_name="SPTEST")
    write_filterbank(path, hdr, data)


@pytest.mark.parametrize("dm,nsub,downsamp", [(0.0, 0, 1), (100.0, 0, 1),
                                              (100.0, 8, 4)])
def test_waterfall_equal(tmp_path, dm, nsub, downsamp):
    from presto_tpu.io.sigproc import FilterbankFile as JFil
    path = str(tmp_path / "sp.fil")
    _pulse_fil(path)
    with JFil(path) as jf, FilterbankFile(path) as tf:
        jw = jtool.waterfall(jf, 1.8, 0.4, dm=dm, nsub=nsub,
                             downsamp=downsamp)
        tw = ttool.waterfall(tf, 1.8, 0.4, dm=dm, nsub=nsub,
                             downsamp=downsamp)
    np.testing.assert_array_equal(tw.data, jw.data)
    np.testing.assert_array_equal(tw.freqs, jw.freqs)
    assert (tw.start_time, tw.dt, tw.dm) == (jw.start_time, jw.dt, jw.dm)
    if dm and not nsub:
        assert np.ptp(np.argmax(tw.data, axis=1)) <= 1


def test_make_spd_cli_equal(tmp_path):
    """make_spd on the same raw file and .singlepulse: the port's .spd
    bundle holds the JAX package's arrays and metadata."""
    from presto_tpu.apps.make_spd import main as jmain
    from presto_tpu_torch.apps.make_spd import main as tmain
    path = str(tmp_path / "sp3.fil")
    _pulse_fil(path)
    spfile = str(tmp_path / "sp3.singlepulse")
    tsp.write_singlepulse(spfile, [
        tsp.SPCandidate(bin=2000, sigma=30.0, time=2.0, downfact=4,
                        dm=100.0),
        tsp.SPCandidate(bin=2500, sigma=8.0, time=2.5, downfact=2,
                        dm=99.0)])
    got = {}
    for main, name in ((jmain, "j"), (tmain, "t")):
        assert main(["-n", "2", "--window", "0.4", "--nsub", "8", "-o",
                     str(tmp_path / name), path, spfile]) == 0
        files = sorted(glob.glob(str(tmp_path / (name + "_DM*.spd"))))
        assert len(files) == 2
        got[name] = [ttool.read_spd(f) for f in files]
        assert [os.path.basename(f)[1:] for f in files] == \
            ["_DM100.00_2.000s.spd", "_DM99.00_2.500s.spd"]
    for a, b in zip(got["j"], got["t"]):
        for f in ("wf_raw", "wf_dedisp", "freqs", "series", "context_dm",
                  "context_time", "context_sigma"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        for f in ("dm", "sigma", "time", "downfact", "dt", "start_time",
                  "source"):
            assert getattr(b, f) == getattr(a, f)
    spd = got["t"][0]
    t_peak = spd.start_time + np.argmax(spd.series) * spd.dt
    assert abs(t_peak - 2.0) < 0.02
    assert jtool.read_spd(str(tmp_path / "t_DM100.00_2.000s.spd")).dm == 100.0
