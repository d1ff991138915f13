"""The port's pulsar injection (models/inject, apps/injectpsr) against the
JAX package's, and an injected pulsar through the port's search and
triage labels, on the CPU.

The injection is host NumPy in both packages (a float64 phase per
channel, the float32 add, then rounding, clipping and bit packing), so
the injected samples and the injected .fil are byte-equal; the
ground-truth sidecar's JSON is equal apart from the data file's path it
names.
"""

import json
import os

import numpy as np
import pytest

from presto_tpu.apps import injectpsr as jinjectpsr
from presto_tpu.io.sigproc import FilterbankHeader, write_filterbank
from presto_tpu.models import inject as jinject
from presto_tpu.ops.orbit import OrbitParams as JOrbit
from presto_tpu_torch.apps import accelsearch, prepdata, realfft
from presto_tpu_torch.apps import injectpsr as tinjectpsr
from presto_tpu_torch.models import inject as tinject
from presto_tpu_torch.ops.orbit import OrbitParams as TOrbit
from presto_tpu_torch.pipeline import sifting
from presto_tpu_torch.triage import calibrate

FREQS = 400.0 + np.arange(16) * 1.0


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def noise_fil(path, nchan=8, N=4096, dt=1e-3, sigma=4.0, nbits=8, seed=17):
    """tests/test_triage.py's noise filterbank (8 channels at 400-407 MHz
    by default, descending on disk)."""
    rng = np.random.default_rng(seed)
    data = rng.normal(40.0, sigma, (N, nchan))
    hdr = FilterbankHeader(nchans=nchan, nifs=1, nbits=nbits, tsamp=dt,
                           fch1=400.0 + (nchan - 1), foff=-1.0,
                           tstart=58000.0, source_name="NOISE")
    write_filterbank(path, hdr, np.clip(np.round(data), 0,
                                        255).astype(np.float32))
    return path


@pytest.mark.parametrize("extra", [
    {},
    {"orbit": (200.0, 0.05, 0.1, 30.0, 12.0)},
    {"tau": 2e-3, "tau_ref_mhz": 405.0},
    {"profile": np.array([0.0, 1.0, 3.0, 1.0, 0.5, 0.0]), "fdot": 1e-3},
], ids=["plain", "orbit", "scattering", "profile"])
def test_inject_pulsar_bytes_equal_jax(extra):
    """inject_pulsar's float32 samples are the JAX function's bytes, with
    and without an orbit, scattering, a custom profile."""
    rng = np.random.default_rng(4)
    data = rng.normal(10.0, 2.0, (3000, FREQS.size)).astype(np.float32)
    kw = dict(f=7.7, dm=30.0, amp=1.5, width=0.04, phase0=0.2)
    kw.update({k: v for k, v in extra.items() if k != "orbit"})
    orb = extra.get("orbit")
    jp = jinject.InjectParams(**kw, orbit=None if orb is None else JOrbit(
        p=orb[0], x=orb[1], e=orb[2], w=orb[3], t=orb[4]))
    tp = tinject.InjectParams(**kw, orbit=None if orb is None else TOrbit(
        p=orb[0], x=orb[1], e=orb[2], w=orb[3], t=orb[4]))
    want = jinject.inject_pulsar(data, 2e-3, FREQS, jp, start_sec=1.5)
    got = tinject.inject_pulsar(data, 2e-3, FREQS, tp, start_sec=1.5)
    assert got.dtype == np.float32 and got.shape == data.shape
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, data)
    assert tinject.amp_for_snr(12.0, tp, 4096, 3.0, 8) == \
        jinject.amp_for_snr(12.0, jp, 4096, 3.0, 8)


@pytest.mark.parametrize("nbits", [8, 4])
def test_inject_into_filterbank_equals_jax(tmp_path, nbits):
    """The injected .fil (streamed in blocks, the last one short) is the
    JAX package's bytes; the sidecar's JSON is equal apart from the
    datafile it names."""
    inp = noise_fil(str(tmp_path / "noise.fil"), N=5000, nbits=nbits,
                    sigma=2.0 if nbits == 4 else 4.0)
    kw = dict(f=4.0, dm=40.0, amp=3.0, width=0.05)
    a, b = str(tmp_path / "jax.fil"), str(tmp_path / "port.fil")
    jinject.inject_into_filterbank(inp, a, jinject.InjectParams(**kw),
                                   block=1 << 11)
    tinject.inject_into_filterbank(inp, b, tinject.InjectParams(**kw),
                                   block=1 << 11)
    assert _bytes(b) == _bytes(a)
    assert _bytes(b) != _bytes(inp)
    ja = json.load(open(jinject.truth_sidecar_path(a)))
    tb = json.load(open(tinject.truth_sidecar_path(b)))
    assert (ja.pop("datafile"), tb.pop("datafile")) == (a, b)
    assert tb == ja
    assert tb["injected"][0]["f"] == 4.0


def test_injectpsr_cli_equals_jax(tmp_path, capsys):
    """injectpsr -snr with an orbit and scattering: the JAX CLI's .fil
    bytes and printed line; -truth-out redirects the sidecar and 'none'
    disables it (tests/test_triage.py's cases)."""
    inp = noise_fil(str(tmp_path / "noise.fil"))
    flags = ["-f", "4.0", "-dm", "40.0", "-snr", "30", "-noise", "4",
             "-porb", "60", "-xorb", "0.02", "-torb", "5", "-tau", "1e-3"]
    a, b = str(tmp_path / "a.fil"), str(tmp_path / "b.fil")
    assert jinjectpsr.main(flags + ["-o", a, inp]) == 0
    want = capsys.readouterr().out.replace(a, "OUT")
    assert tinjectpsr.main(flags + ["-o", b, inp]) == 0
    assert capsys.readouterr().out.replace(b, "OUT") == want
    assert _bytes(b) == _bytes(a)
    assert os.path.exists(tinject.truth_sidecar_path(b))
    base = ["-f", "4.0", "-dm", "40.0", "-amp", "2.0"]
    out2 = str(tmp_path / "c.fil")
    custom = str(tmp_path / "labels.json")
    assert tinjectpsr.main(base + ["-truth-out", custom, "-o", out2,
                                   inp]) == 0
    assert os.path.exists(custom)
    assert not os.path.exists(tinject.truth_sidecar_path(out2))
    assert calibrate.load_truth(custom)[0]["f"] == 4.0
    out3 = str(tmp_path / "d.fil")
    assert tinjectpsr.main(base + ["-truth-out", "none", "-o", out3,
                                   inp]) == 0
    assert not os.path.exists(tinject.truth_sidecar_path(out3))
    assert calibrate.truth_sidecar_path(out3) == \
        tinject.truth_sidecar_path(out3)


def _search_and_label(fil, truth, dm, workdir):
    """prepdata -nobary at ``dm``, realfft, accelsearch -zmax 0 on the
    CPU; the ACCEL file's sifted candidates and their triage labels."""
    base = os.path.join(workdir, os.path.splitext(os.path.basename(fil))[0])
    assert prepdata.main(["-dm", str(dm), "-nobary", "-o", base, fil],
                         device="cpu") == 0
    assert realfft.main([base + ".dat"], device="cpu") == 0
    assert accelsearch.main(["-zmax", "0", "-numharm", "8",
                             base + ".fft"], device="cpu") == 0
    cands = list(sifting.sift_candidates([base + "_ACCEL_0"]))
    return cands, calibrate.label_candidates(cands, truth)


def test_injected_pulsar_is_labelled_after_the_search(tmp_path):
    """An injected pulsar (injectpsr -snr into a noise beam) through the
    port's prepdata, realfft and accelsearch on the CPU: triage's
    label_candidates labels a sifted candidate against the sidecar; the
    same search of the beam without the injection labels nothing."""
    inp = noise_fil(str(tmp_path / "beam.fil"), nchan=16, N=1 << 15,
                    dt=5e-4, sigma=4.0)
    out = str(tmp_path / "inj.fil")
    assert tinjectpsr.main(["-f", "17.3", "-dm", "23.0", "-snr", "60",
                            "-noise", "4", "-o", out, inp]) == 0
    truth = calibrate.load_truth(tinject.truth_sidecar_path(out))
    assert [r["f"] for r in truth] == [17.3]
    cands, labels = _search_and_label(out, truth, 23.0, str(tmp_path))
    assert labels.sum() >= 1
    hit = cands[int(np.argmax(labels))]
    assert abs(hit.f / 17.3 - round(hit.f / 17.3)) < 0.02 or \
        abs(17.3 / hit.f - round(17.3 / hit.f)) < 0.02
    ctl, ctl_labels = _search_and_label(inp, truth, 23.0, str(tmp_path))
    assert ctl_labels.sum() == 0, [(c.f, c.sigma) for c in ctl]


def test_calibrate_rule_meets_the_beams_own_harmonics(tmp_path):
    """calibrate's rule (2% of any of 32 harmonics and subharmonics, DM
    within 3), on the card's recipe run of chip_smoke.py's beam
    (tests/data/recipe_cands.tar.xz: the zmax-0 sift of its DM-23 trial,
    numharm 16), labels 7 of 40 candidates against a 17.3 Hz pulsar that
    the beam does not hold: harmonics of its own pulsars.  The JAX
    package's rule gives the same labels.  At the search's resolution
    (f_tol = R_ERR / (T f)) it labels none: the chip script's control."""
    import tarfile
    from presto_tpu.triage import calibrate as jcalibrate
    with tarfile.open(os.path.join(os.path.dirname(__file__), "data",
                                   "recipe_cands.tar.xz")) as tar:
        for name in ("psrb_DM23.00_ACCEL_0", "psrb_DM23.00.inf"):
            tar.extract(name, str(tmp_path), filter="data")
    cands = list(sifting.sift_candidates(
        [str(tmp_path / "psrb_DM23.00_ACCEL_0")]))
    truth = [{"f": 17.3, "dm": 23.0}]
    labels = calibrate.label_candidates(cands, truth)
    assert labels.tolist() == jcalibrate.label_candidates(
        cands, truth).tolist()
    assert (len(cands), int(labels.sum())) == (40, 7)
    tight = sifting.R_ERR / (cands[0].T * 17.3)
    assert calibrate.label_candidates(cands, truth, f_tol=tight).sum() == 0
