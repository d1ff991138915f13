"""The port's PSRFITS and multi-file readers against the JAX package's,
on the CPU.

Every case writes its files once (the JAX package's write_psrfits, which
the port's copy equals byte for byte) and opens them with both
packages' readers: the header, the stitched length, every spectrum
(whole reads and reads in odd-sized chunks across row, gap and file
boundaries) and the quality ledger are equal, byte for byte.  The
cases are those of tests/test_psrfits.py and
tests/test_psrfits_pathology.py: 1-32 bit samples, two polarizations
summed and selected, scales, offsets and weights with each -no* flag,
a descending band, dropped leading, inner and boundary rows, OFFS_SUB
drift, multi-file gaps and overlaps, and NaN-scaled rows.  The port
decodes 1/2/4/8-bit rows with the native library only; its NumPy row
decode is the plain version held against it.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest

from presto_tpu.apps import common as jcommon
from presto_tpu.io import fitsio as jfits
from presto_tpu.io import psrfits as jpsr
from presto_tpu.io import sigproc as jsig
from presto_tpu.io.infodata import write_inf as jwrite_inf
from presto_tpu_torch.apps import common as tcommon
from presto_tpu_torch.io import fitsio as tfits
from presto_tpu_torch.io import native as tnative
from presto_tpu_torch.io import psrfits as tpsr
from presto_tpu_torch.io import sigproc as tsig
from presto_tpu_torch.io.infodata import write_inf as twrite_inf

NCHAN = 16
FREQS = 1400.0 + 1.5 * np.arange(NCHAN)
DT, NSBLK, MJD0 = 1e-3, 256, 55555.0


def _data(nspec, lo=0, hi=30, seed=5, nchan=NCHAN):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(nspec, nchan)).astype(np.float32)


def _write(path, data, **kw):
    kw.setdefault("dt", DT)
    kw.setdefault("freqs", FREQS)
    kw.setdefault("nsblk", NSBLK)
    jpsr.write_psrfits(str(path), data, **kw)
    return str(path)


def _one(d, **kw):
    return [_write(d / "a.fits", _data(1280, hi=kw.pop("hi", 30)), **kw)]


def _pair(d, n1, start2, n2, drops=((), ()), data=None):
    data = _data(start2 + n2, lo=1) if data is None else data
    a = _write(d / "a.fits", data[:n1], start_mjd=MJD0, drop_rows=drops[0])
    b = _write(d / "b.fits", data[start2:start2 + n2],
               start_mjd=MJD0 + start2 * DT / 86400.0, drop_rows=drops[1])
    return [a, b]


def _nan_scaled(d):
    """Row 2's DAT_SCL with a NaN (patched into the written file) and a
    run of zero spectra: the quarantine's nan-inf and zero-fill
    entries."""
    data = _data(1024, lo=1)
    data[300:400] = 0.0
    path = _write(d / "q.fits", data,
                  scales=np.full(NCHAN, 2.0, np.float32))
    with tfits.FitsFile(path) as ff:
        sub = ff.hdu("SUBINT")
        at = (sub.data_offset + 2 * sub.naxis1
              + sub.colindex("DAT_SCL").offset + 3 * 4)
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(np.array([np.nan], ">f4").tobytes())
    return [path]


# name -> (files maker, reader keyword arguments)
CASES = {
    **{"nbits%d" % nb: (lambda d, nb=nb: _one(d, nbits=nb,
                                              hi=min(30, 1 << nb)), {})
       for nb in (1, 2, 4, 8, 16, 32)},
    "npol2_sum": (lambda d: _one(d, npol=2), {}),
    "npol2_select": (lambda d: _one(d, npol=2), {"use_poln": 1}),
    "npol2_select_4bit": (lambda d: _one(d, npol=2, nbits=4, hi=16),
                          {"use_poln": 2}),
    **{"scaled_" + name: (lambda d: [_write(
        d / "s.fits", _data(1024, lo=30, hi=100),
        scales=np.linspace(0.5, 2.0, NCHAN).astype(np.float32),
        offsets=np.linspace(0.0, 20.0, NCHAN).astype(np.float32),
        weights=np.where(np.arange(NCHAN) == 5, 0.0, 1.0).astype(
            np.float32), zero_off=3.0)], kw)
       for name, kw in (("all", {}), ("noweights", {"apply_weight": False}),
                        ("noscales", {"apply_scale": False}),
                        ("nooffsets", {"apply_offset": False}))},
    "descending": (lambda d: [_write(d / "a.fits", _data(1024),
                                     freqs=FREQS[::-1].copy())], {}),
    "dropped_rows": (lambda d: [_write(d / "a.fits", _data(2048, lo=1),
                                       drop_rows=[3, 4, 5, 7])], {}),
    "leading_row": (lambda d: [_write(d / "a.fits", _data(1280, lo=1),
                                      drop_rows=[0])], {}),
    "drift": (lambda d: [_write(d / "a.fits", _data(1280),
                                offs_jitter=100.0)], {}),
    "drift_leading_drop": (lambda d: [_write(
        d / "a.fits", _data(1280, lo=1), drop_rows=[0, 1],
        offs_jitter=100.0)], {}),
    "lowbit_drop": (lambda d: [_write(d / "a.fits", _data(1024, hi=4),
                                      nbits=2, drop_rows=[2])], {}),
    "multifile_contiguous": (lambda d: _pair(d, 768, 768, 512), {}),
    "multifile_gap": (lambda d: _pair(d, 512, 768, 256), {}),
    "multifile_overlap": (lambda d: _pair(d, 1024, 768, 768), {}),
    "multifile_gap_and_drops": (lambda d: _pair(d, 768, 1280, 768,
                                                drops=([1], [1])), {}),
    "quarantine": (_nan_scaled, {}),
}


def _readers(paths, **kw):
    return jpsr.PsrfitsFile(paths, **kw), tpsr.PsrfitsFile(paths, **kw)


def _quality(r):
    return json.dumps(r.quality.to_json(), sort_keys=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_equals_jax(tmp_path, case):
    make, kw = CASES[case]
    paths = make(tmp_path)
    j, t = _readers(paths, **kw)
    with j, t:
        assert t.nspectra == j.nspectra > 0
        assert dataclasses.asdict(t.header) == dataclasses.asdict(j.header)
        assert (t.apply_scale, t.apply_offset, t.apply_weight) == \
            (j.apply_scale, j.apply_offset, j.apply_weight)
        assert t.ptsperblk == j.ptsperblk == NSBLK
        n = t.nspectra + 100               # past the end: padding
        whole = t.read_spectra(0, n)
        assert whole.tobytes() == j.read_spectra(0, n).tobytes()
        assert _quality(t) == _quality(j)
        for s in range(0, n - 300, 300):   # across rows, gaps and files
            assert t.read_spectra(s, 300).tobytes() == \
                whole[s:s + 300].tobytes()


def test_ledger_records_gaps_drops_and_quarantine(tmp_path):
    """The quality ledger of a gapped set and of poisoned rows holds what
    the reader padded and scrubbed."""
    (tmp_path / "g").mkdir()
    (tmp_path / "q").mkdir()
    paths = CASES["multifile_gap_and_drops"][0](tmp_path / "g")
    with tpsr.PsrfitsFile(paths) as t:
        rep = t.quality.to_json()
    assert rep["counts"] == {"dropped-rows": 4 * NSBLK}
    with tpsr.PsrfitsFile(_nan_scaled(tmp_path / "q")) as t:
        t.read_spectra(0, t.nspectra)
        rep = t.quality.to_json()
    assert rep["counts"] == {"nan-inf": NSBLK, "zero-fill": 100}
    assert rep["scrubbed_samples"] == NSBLK


def test_writers_and_fitsio_equal(tmp_path):
    """The port's write_psrfits and write_fits write the JAX package's
    bytes, and each package's FitsFile reads the other's cards."""
    kw = dict(dt=DT, freqs=FREQS, nsblk=NSBLK, nbits=4, npol=2,
              drop_rows=[1], offs_jitter=3.0, start_mjd=58000.25,
              scales=np.full(2 * NCHAN, 2.0, np.float32))
    data = _data(1024, hi=16)
    a, b = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    jpsr.write_psrfits(a, data, **kw)
    tpsr.write_psrfits(b, data, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    rows = [{"X": np.float64(i), "V": np.arange(4) + i, "S": "r%d" % i}
            for i in range(3)]
    spec = ([("FOO", 42), ("BAR", "hello"), ("PI", 3.5), ("T", True)],
            [{"extname": "TAB", "cards": [("BAZ", 7)],
              "columns": [("X", "1D", "s"), ("V", "4J", ""),
                          ("S", "3A", "")], "rows": rows}])
    jfits.write_fits(a, *spec)
    tfits.write_fits(b, *spec)
    assert open(a, "rb").read() == open(b, "rb").read()
    with tfits.FitsFile(a) as ff, jfits.FitsFile(a) as jf:
        cards, tab = ff.primary.cards, ff.hdu("TAB")
        got = (tab.header["BAZ"], tab.naxis2, tab.read_col("V", 2).tolist(),
               tab.read_col_raw_bytes("X", 1).tobytes())
        want = (jf.hdu("TAB").header["BAZ"], jf.hdu("TAB").naxis2,
                jf.hdu("TAB").read_col("V", 2).tolist(),
                jf.hdu("TAB").read_col_raw_bytes("X", 1).tobytes())
        jcards = jf.primary.cards
    assert cards == jcards and got == want
    assert got == (7, 3, [2, 3, 4, 5], np.array([1.0], ">f8").tobytes())


# (nbits, npol, pol_mode, scaling): the native decoder's geometries
NATIVE_CASES = [(nb, npol, pm, sc)
                for nb in (1, 2, 4, 8)
                for npol, pm in ((1, 0), (2, -2), (2, 1))
                for sc in ("none", "all", "scale", "weights")]


@pytest.mark.parametrize("nbits,npol,pol_mode,scaling", NATIVE_CASES)
def test_native_row_decode_equals_numpy(nbits, npol, pol_mode, scaling):
    nspec, nchan = 64, 24
    rng = np.random.default_rng(nbits * 100 + npol * 10 + pol_mode + 3)
    raw = rng.integers(0, 256, nspec * npol * nchan * nbits // 8,
                       dtype=np.uint8)
    scl = offs = wts = None
    if scaling in ("all", "scale"):
        scl = rng.uniform(0.5, 2.0, npol * nchan).astype(np.float32)
    if scaling == "all":
        offs = rng.uniform(-3.0, 3.0, npol * nchan).astype(np.float32)
    if scaling in ("all", "weights"):
        wts = rng.uniform(0.0, 1.0, nchan).astype(np.float32)
    for flip in (False, True):
        args = (raw, nspec, npol, nchan, nbits, 1.5 if scaling == "all"
                else 0.0, scl, offs, wts, pol_mode, flip)
        got = tnative.decode_subint(*args)
        assert got.tobytes() == tpsr.decode_row_numpy(*args).tobytes()


@pytest.mark.parametrize("nbits", [8, 16])
def test_missing_native_library_raises(tmp_path, monkeypatch, nbits):
    """No fallback: with the native library gone an 8-bit row raises;
    16-bit rows never ask for it (their declared route is NumPy)."""
    path = _write(tmp_path / "a.fits", _data(512), nbits=nbits)

    def missing():
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(tnative, "_load", missing)
    with tpsr.PsrfitsFile(path) as t:
        if nbits == 8:
            with pytest.raises(RuntimeError, match="g\\+\\+"):
                t.read_spectra(0, 512)
        else:
            with jpsr.PsrfitsFile(path) as j:
                assert t.read_spectra(0, 512).tobytes() == \
                    j.read_spectra(0, 512).tobytes()


@pytest.mark.parametrize("what", ["nchan", "dt", "nbits", "foff"])
def test_disagreeing_sets_raise(tmp_path, what):
    """A multi-file set whose files disagree in geometry raises, for
    PSRFITS (the port checks what the JAX package decodes blindly) and
    for SIGPROC (as in the JAX package)."""
    nchan = NCHAN // 2 if what == "nchan" else NCHAN
    kw = {"dt": 2 * DT if what == "dt" else DT,
          "nbits": 4 if what == "nbits" else 8,
          "freqs": (FREQS[:nchan] * (1.5 if what == "foff" else 1.0))}
    a = _write(tmp_path / "a.fits", _data(512))
    b = _write(tmp_path / "b.fits", _data(512, hi=16, nchan=nchan),
               start_mjd=MJD0 + 512 * DT / 86400.0, **kw)
    with pytest.raises(ValueError, match="disagree"):
        tpsr.PsrfitsFile([a, b])
    fa, fb = str(tmp_path / "a.fil"), str(tmp_path / "b.fil")
    for p, n, dt, nb, foff, t0 in ((fa, NCHAN, DT, 8, -1.5, MJD0),
                                   (fb, nchan, kw["dt"], kw["nbits"],
                                    -1.5 * (1.5 if what == "foff" else 1),
                                    MJD0 + 1.0)):
        tsig.write_filterbank(p, tsig.FilterbankHeader(
            nchans=n, nbits=nb, tsamp=dt, fch1=1500.0, foff=foff,
            tstart=t0), _data(64, hi=16, nchan=n))
    with pytest.raises(ValueError, match="disagree"):
        tsig.FilterbankSet([fa, fb])


def _fil_pair(d, mod):
    """Two 8-bit .fil files of one observation, the later written first,
    the second with a zero run for the quality ledger."""
    data = _data(3000, lo=1)
    data[2100:2200] = 0.0
    paths = [str(d / "x1.fil"), str(d / "x0.fil")]
    for p, lo, hi, t0 in ((paths[0], 1700, 3000, MJD0 + 1700 * DT / 86400),
                          (paths[1], 0, 1700, MJD0)):
        mod.write_filterbank(p, mod.FilterbankHeader(
            nchans=NCHAN, nbits=8, tsamp=DT, fch1=FREQS[-1], foff=-1.5,
            tstart=t0, telescope_id=6, src_raj=53431.9, src_dej=220052.1),
            data[lo:hi])
    return paths


def test_filterbank_set_equals_jax(tmp_path):
    paths = _fil_pair(tmp_path, jsig)
    j, t = jsig.FilterbankSet(paths), tsig.FilterbankSet(paths)
    with j, t:
        assert dataclasses.asdict(t.header) == dataclasses.asdict(j.header)
        assert t.nspectra == 3000 and t.ptsperblk == j.ptsperblk
        for s, n in ((0, 3100), (1650, 100), (2999, 5)):
            assert t.read_spectra(s, n).tobytes() == \
                j.read_spectra(s, n).tobytes()
        assert [b.tobytes() for b in t.iter_blocks(700)] == \
            [b.tobytes() for b in j.iter_blocks(700)]
        assert _quality(t) == _quality(j)
        assert t.quality.counts() == {"zero-fill": 100}


def test_open_raw_dispatch_equals_jax(tmp_path):
    """Suffix, content and flag selection of the reader; mixed formats
    refuse."""
    fits = _write(tmp_path / "a.fits", _data(512))
    fits_sf = str(tmp_path / "a.raw")
    os.symlink(fits, fits_sf)
    fils = _fil_pair(tmp_path, tsig)
    for p in (fits, fits_sf, fils[0]):
        assert tcommon.identify_datatype(p) == jcommon.identify_datatype(p)
    ns = argparse.Namespace
    for paths, args, cls in (
            ([fits], ns(), tpsr.PsrfitsFile),
            ([fits_sf], ns(), tpsr.PsrfitsFile),
            ([fits_sf], ns(psrfits=True), tpsr.PsrfitsFile),
            (fils[:1], ns(), tsig.FilterbankFile),
            (fils, ns(), tsig.FilterbankSet),
            (fils, ns(filterbank=True), tsig.FilterbankSet)):
        r = tcommon.open_raw_args(paths, args)
        assert type(r) is cls
        assert type(jcommon.open_raw_args(paths, args)).__name__ == \
            cls.__name__
        r.close()
    r = tcommon.open_raw_args([fits], ns(noweights=True, noscales=True,
                                         nooffsets=True))
    assert not (r.apply_weight or r.apply_scale or r.apply_offset)
    r.close()
    with pytest.raises(SystemExit):
        tcommon.open_raw([fits, fils[0]])


@pytest.mark.parametrize("kind", ["psrfits", "psrfits_positioned",
                                  "fil_set"])
def test_inf_metadata_equals_jax(tmp_path, kind):
    """obs_metadata and fil_to_inf give the JAX package's .inf: for
    PSRFITS the header's telescope, source and position strings."""
    if kind == "fil_set":
        paths = _fil_pair(tmp_path, tsig)
    else:
        paths = _pair(tmp_path, 768, 768, 512)
        if kind == "psrfits_positioned":
            from presto_tpu_torch.apps import fitsutils
            for p in paths:
                hdus = fitsutils.read_hdus(p)
                hdus[0].set("RA", "'05:34:31.9'")
                hdus[0].set("DEC", "'+22:00:52.1'")
                hdus[0].set("TELESCOP", "'GBT'")
                fitsutils.write_hdus(p, hdus)
    out = {}
    for name, common, winf in (("j", jcommon, jwrite_inf),
                               ("t", tcommon, twrite_inf)):
        fb = common.open_raw(paths)
        assert common.obs_metadata(fb) == jcommon.obs_metadata(fb)
        info = common.fil_to_inf(fb, "obs_DM1.00", fb.header.N, dm=1.0)
        path = str(tmp_path / ("%s.inf" % name))
        winf(info, path)
        out[name] = open(path).read()
        fb.close()
    assert out["t"] == out["j"]
    if kind == "psrfits_positioned":
        assert "GBT" in out["t"] and "05:34:31.9" in out["t"]


@pytest.mark.parametrize("form", ["05:34:31.97", "05 34 31.97", "5.5",
                                  "83.63", "-12:30:00.5", "+22 00 52.1",
                                  "", "junk"])
def test_header_coordinates_equal_jax(form):
    assert tpsr._ra_str_to_sigproc(form) == jpsr._ra_str_to_sigproc(form)
    assert tpsr._dec_str_to_sigproc(form) == jpsr._dec_str_to_sigproc(form)
