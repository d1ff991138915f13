"""The port's native IO runtime and ingest against the JAX package's and
against its own plain NumPy versions, on the CPU.

The decoders are byte-equal (the same C arithmetic; the NumPy decode is
exact for these integer samples); the feeder delivers the file's bytes;
stream_blocks delivers read_spectra's blocks; the quality reports are
equal as JSON; the device feed (pipeline/fusion.feed_blocks) delivers
the channel-major blocks of the read + preprocess + transpose sequence
it replaced, bit for bit.

The JAX package builds its library in place (``make -C csrc`` on first
load), so under several test workers one of them can find the file
half written and give up on it for good.  ``jax_native`` takes a lock,
waits for the file to settle, retries such a load, and then asserts
the library is loaded: a missing reference library fails the test.
"""

import argparse
import fcntl
import json
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from presto_tpu.io import native as jnative
from presto_tpu.io import sigproc as jsig
from presto_tpu.ops import clipping as jclip
from presto_tpu_torch import cuda_build
from presto_tpu_torch.apps import common as tcommon
from presto_tpu_torch.io import native as tnative
from presto_tpu_torch.io import sigproc as tsig
from presto_tpu_torch.ops import clipping as tclip
from presto_tpu_torch.pipeline import fusion

RNG = np.random.default_rng(4321)

#: how long a load waits for another process's build of the JAX library
JAX_BUILD_WAIT_S = 300.0


def _settled(path: str, quiet_s: float = 2.0) -> bool:
    """The file exists and has not been written for ``quiet_s``."""
    try:
        return time.time() - os.path.getmtime(path) >= quiet_s
    except OSError:
        return False


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native module with its library loaded, however
    the test workers raced to build it; fails when it cannot load."""
    lock = os.path.join(tempfile.gettempdir(),
                        "presto_tpu_io_native.lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        assert not os.environ.get("PRESTO_TPU_NO_NATIVE"), \
            "PRESTO_TPU_NO_NATIVE disables the reference library"
        deadline = time.monotonic() + JAX_BUILD_WAIT_S
        while True:
            if jnative._lib is None and (
                    not os.path.exists(jnative._SO)
                    or _settled(jnative._SO)):
                # a load that failed on another worker's half-written
                # file is retried once the file has settled
                jnative._load_failed = False
                jnative._load()
            if jnative._lib is not None or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    assert jnative._lib is not None, \
        "the JAX package's native library %s did not load" % jnative._SO
    return jnative


def _hdr(mod, nchan, nbits, nifs=1, foff=-1.0):
    return mod.FilterbankHeader(nchans=nchan, nifs=nifs, nbits=nbits,
                                tsamp=1e-4, fch1=1500.0, foff=foff,
                                tstart=55000.0, source_name="synthetic")


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_unpack_bits_parity(nbits, jax_native):
    raw = RNG.integers(0, 256, size=4096).astype(np.uint8)
    got = tnative.unpack_bits(raw, nbits)
    assert np.array_equal(got, tsig.unpack_bits(raw, nbits))
    assert np.array_equal(got, jax_native.unpack_bits(raw, nbits))


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
@pytest.mark.parametrize("nifs", [1, 2])
@pytest.mark.parametrize("flip", [False, True])
def test_decode_spectra_parity(nbits, nifs, flip, jax_native):
    """Native decode == the JAX package's native decode == the port's
    NumPy decode, and the same bytes when written into a caller's
    buffer (the NumPy view of a torch tensor, as the upload ring's)."""
    nspec, nchan = 17, 32
    raw = RNG.integers(0, 256, size=nspec * nifs * nchan * nbits // 8
                       ).astype(np.uint8)
    got = tnative.decode_spectra(raw, nspec, nifs, nchan, nbits, flip)
    hdr = _hdr(tsig, nchan, nbits, nifs, -1.0 if flip else 1.0)
    assert np.array_equal(got, tsig.decode_spectra_numpy(hdr, raw, nspec))
    assert np.array_equal(got, jax_native.decode_spectra(
        raw, nspec, nifs, nchan, nbits, flip))
    buf = torch.full((nspec + 3, nchan), -1.0)
    view = tsig.decode_spectra_block(hdr, raw, nspec, out=buf.numpy())
    assert np.array_equal(view, got)
    assert np.array_equal(buf[:nspec].numpy(), got)
    assert bool((buf[nspec:] == -1.0).all())


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("npol,pol_mode", [(1, 0), (2, -2), (4, 1)])
def test_decode_subint_parity(nbits, npol, pol_mode, jax_native):
    nspec, nchan = 11, 24
    raw = RNG.integers(0, 256, size=nspec * npol * nchan * nbits // 8
                       ).astype(np.uint8)
    scl = RNG.uniform(0.5, 2.0, npol * nchan).astype(np.float32)
    offs = RNG.uniform(-3, 3, npol * nchan).astype(np.float32)
    wts = RNG.uniform(0, 1, nchan).astype(np.float32)
    args = (raw, nspec, npol, nchan, nbits, 1.5, scl, offs, wts, pol_mode,
            True)
    assert np.array_equal(tnative.decode_subint(*args),
                          jax_native.decode_subint(*args))


def test_decode_rejects_what_it_cannot_take():
    raw = np.zeros(16, np.uint8)
    with pytest.raises(ValueError):
        tnative.decode_spectra(raw, 1, 1, 8, 16, False)
    with pytest.raises(ValueError):
        tnative.decode_spectra(raw, 3, 1, 8, 8, False)   # 16 != 24 bytes
    with pytest.raises(ValueError):
        tnative.decode_spectra(raw, 2, 1, 8, 8, False,
                               out=np.empty((2, 8), np.float64))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: when the library cannot be built, decoding raises
    instead of taking the NumPy path."""
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "b"))

    def missing():
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(cuda_build, "gxx", missing)
    hdr = _hdr(tsig, 8, 8)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tsig.decode_spectra_block(hdr, np.zeros(16, np.uint8), 2)


def test_block_feeder_reads_whole_file(tmp_path):
    """The feeder delivers the exact file bytes, in order, with a short
    final block, and counts the blocks it handed over (the empty
    end-of-file slot among them)."""
    payload = RNG.integers(0, 256, size=10_000).astype(np.uint8)
    path = str(tmp_path / "raw.bin")
    with open(path, "wb") as f:
        f.write(b"HDRHDR")
        f.write(payload.tobytes())
    got = []
    with tnative.BlockFeeder(path, 6, 1024, nbuf=3) as feeder:
        for blk in feeder:
            got.append(blk.copy())
        stats = feeder.stats()
    assert stats["blocks"] - 1 == len(got) == 10
    assert len(got[-1]) == payload.size % 1024
    assert np.array_equal(np.concatenate(got), payload)


@pytest.mark.parametrize("nbits,nspec,blocklen", [
    (8, 5000, 1024), (4, 3001, 512), (2, 777, 800), (1, 4096, 1000),
    (32, 900, 256)])
def test_stream_blocks_matches_read_spectra(tmp_path, nbits, nspec,
                                            blocklen):
    """The prefetched stream delivers what blockwise read_spectra
    delivers, the zero-padded short final block included, and what the
    JAX package's stream delivers; with ``out`` it decodes into the
    caller's buffers.  32-bit data (not a native width) come through
    read_spectra."""
    nchan = 16
    hi = {1: 2, 2: 4, 4: 16, 8: 256, 32: 1000}[nbits]
    data = RNG.integers(0, hi, size=(nspec, nchan)).astype(np.float32)
    path = str(tmp_path / "s.fil")
    jsig.write_filterbank(path, _hdr(jsig, nchan, nbits), data)
    with tsig.FilterbankFile(path) as f:
        streamed = [b.copy() for b in f.stream_blocks(blocklen)]
        direct = list(f.iter_blocks(blocklen))
        bufs = []

        def out():
            bufs.append(np.full((blocklen, nchan), -7.0, np.float32))
            return bufs[-1]
        into = list(f.stream_blocks(blocklen, out=out))
    with jsig.FilterbankFile(path) as f:
        jstream = list(f.stream_blocks(blocklen))
    assert len(streamed) == len(direct) == len(jstream) == len(into) \
        == -(-nspec // blocklen)
    for a, b, c, d in zip(streamed, direct, jstream, into):
        assert a.shape == (blocklen, nchan)
        assert np.array_equal(a, b) and np.array_equal(a, c) \
            and np.array_equal(a, d)
    assert all(b is d for b, d in zip(bufs, into))
    assert not (streamed[-1][nspec % blocklen or blocklen:] != 0).any()


def _quality_fil(path, mod):
    """A 32-bit filterbank with NaN and Inf samples and a 100-spectrum
    zero-fill run."""
    nspec, nchan = 3000, 16
    data = RNG.normal(10.0, 2.0, size=(nspec, nchan)).astype(np.float32)
    data[100, 3] = np.nan
    data[101:104, 5] = np.inf
    data[2500, :] = -np.inf
    data[1200:1300] = 0.0
    mod.write_filterbank(path, _hdr(mod, nchan, 32), data)


@pytest.mark.parametrize("how", ["read_spectra", "stream_blocks"])
def test_scrub_and_zero_runs_match_jax(tmp_path, how):
    """NaN/Inf samples scrubbed to 0 and zero-fill runs recorded: the
    blocks and the DataQualityReport JSON equal the JAX package's."""
    path = str(tmp_path / "q.fil")
    _quality_fil(path, jsig)
    out = {}
    for name, mod in (("j", jsig), ("t", tsig)):
        with mod.FilterbankFile(path) as f:
            if how == "read_spectra":
                blocks = [f.read_spectra(s, 700) for s in range(0, 3000, 700)]
            else:
                blocks = [b.copy() for b in f.stream_blocks(700)]
            out[name] = (blocks, json.dumps(f.quality.to_json(),
                                            sort_keys=True))
    for a, b in zip(out["j"][0], out["t"][0]):
        assert np.array_equal(a, b)
    assert out["j"][1] == out["t"][1]
    rep = json.loads(out["t"][1])
    assert rep["counts"] == {"nan-inf": 5, "zero-fill": 100}
    assert rep["scrubbed_samples"] == 1 + 3 + 16


def test_quality_report_round_trip_and_merge(tmp_path):
    from presto_tpu.io import quality as jq
    from presto_tpu_torch.io import quality as tq
    reps = []
    for mod in (jq, tq):
        r = mod.DataQualityReport(path="x", nspectra=5000, nchan=8)
        r.add(10, 90, "zero-fill")
        r.add(80, 120, "zero-fill")
        r.add(4000, 4100, "short-read")
        m = mod.merge_reports([r, mod.DataQualityReport.from_json(
            {"nspectra": 6000, "intervals": [
                {"start": 200, "stop": 210, "reason": "nan-inf"}]})],
            path="m")
        reps.append((r.zap_intervals(1000, 5), r.summary(), m.to_json()))
        r.write(str(tmp_path / ("%s.json" % mod.__name__)))
        assert mod.DataQualityReport.read(
            str(tmp_path / ("%s.json" % mod.__name__))).to_json() \
            == r.to_json()
    assert reps[0] == reps[1]


def test_clip_and_mask_in_place_match_jax():
    """clip_times and mask_block writing into the block they are given
    equal the JAX package's copies, over blocks with clipped rows."""
    blocks = [RNG.normal(30, 3, size=(2048, 24)).astype(np.float32)
              for _ in range(4)]
    blocks[1][100:140] += 40.0          # rows the clipper replaces
    blocks[2][7] += 500.0
    jstate = tstate = None
    nclipped = 0
    for blk in blocks:
        want, nj, jstate = jclip.clip_times(blk.copy(), 6.0, jstate)
        mine = blk.copy()
        got, nt, tstate = tclip.clip_times(mine, 6.0, tstate, out=mine)
        assert got is mine and nt == nj
        assert np.array_equal(got, want)
        nclipped += nt
        chans = np.array([1, 5, 23])
        pad = RNG.normal(size=24).astype(np.float32)
        m = blk.copy()
        assert np.array_equal(tclip.mask_block(m, chans, pad, out=m),
                              jclip.mask_block(blk, chans, pad))
    assert nclipped >= 41


def _old_device_blocks(fb, prep, blocklen, nblocks, skip):
    """The ingest the feed replaced: read_spectra, preprocess, transpose
    on the host, copy to the device."""
    out = []
    for k in range(nblocks):
        nread = skip + k * blocklen
        if nread < fb.header.N:
            block = prep(fb.read_spectra(nread, blocklen), nread)
        else:
            block = np.zeros((blocklen, fb.header.nchans), np.float32)
        out.append(torch.from_numpy(np.ascontiguousarray(block.T)))
    return out


@pytest.mark.parametrize("skip,extra", [(0, []), (300, []),
                                        (0, ["-invert", "-zerodm"]),
                                        (0, ["-noclip", "-runavg"])])
def test_feed_blocks_equals_the_host_transpose(tmp_path, skip, extra):
    """fusion.feed_blocks (feeder, decode into ring buffers, BlockPrep in
    place, upload, transpose on the device) yields the channel-major
    blocks of the read + prep + host transpose sequence, bit for bit,
    flush blocks included."""
    nspec, nchan, blocklen = 5000, 16, 1024
    data = RNG.normal(64, 6, size=(nspec, nchan))
    data[2000:2040] += 60.0
    path = str(tmp_path / "f.fil")
    jsig.write_filterbank(path, _hdr(jsig, nchan, 8),
                          np.clip(np.round(data), 0, 255))
    ns = argparse.Namespace(
        **{a.lstrip("-"): True for a in extra})
    nblocks = -(-(nspec - skip) // blocklen) + 2
    with tsig.FilterbankFile(path) as fb:
        want = _old_device_blocks(
            fb, tcommon.block_prep(ns, nchan, 1e-4), blocklen, nblocks,
            skip)
    with tsig.FilterbankFile(path) as fb:
        got = list(fusion.feed_blocks(fb, tcommon.block_prep(
            ns, nchan, 1e-4), blocklen, nblocks, "cpu", skip=skip))
        assert fb.feeder_stats is None or \
            fb.feeder_stats["blocks"] >= nblocks - 2
    assert [s for s, _b in got] == [skip + k * blocklen
                                    for k in range(nblocks)]
    for a, (_s, b) in zip(want, got):
        assert b.shape == (nchan, blocklen) and b.is_contiguous()
        assert torch.equal(a, b)
