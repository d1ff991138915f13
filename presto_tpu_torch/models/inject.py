"""Inject synthetic pulsars into existing filterbank data
(bin/injectpsr.py analog — the reference's fault-injection tool,
SURVEY.md §5.3).

Adds a parameterized pulsar signal on top of REAL (or synthetic) data:
per-channel cold-plasma delays, intra-channel DM smearing (the profile
convolved with the channel's smearing boxcar), an optional exponential
scattering tail (tau scaled per channel as tau ~ nu^-4, the injectpsr
scattering model), optional binary-orbit phase modulation
(ops/orbit.orbit_delays), and either a fixed amplitude or a target
folded S/N.

Host copy of ``presto_tpu/models/inject.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from presto_tpu_torch.models.synth import pulse_shape
from presto_tpu_torch.ops.dedispersion import delay_from_dm
from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays

_NFINE = 4096


@dataclass
class InjectParams:
    f: float = 1.0                 # spin frequency, Hz (at t=0)
    fdot: float = 0.0
    phase0: float = 0.0            # turns
    dm: float = 0.0
    amp: float = 1.0               # peak amplitude, data units/sample
    shape: str = "gauss"
    width: float = 0.05            # FWHM in rotations (gauss)
    profile: Optional[np.ndarray] = field(default=None)  # custom, any len
    orbit: Optional[OrbitParams] = None
    # interstellar scattering: one-sided exponential tail of timescale
    # tau (seconds) at tau_ref_mhz (0 -> the highest channel), scaled
    # per channel as tau * (nu/nu_ref)**tau_index (thin-screen
    # Kolmogorov-ish default -4, bin/injectpsr.py's model)
    tau: float = 0.0
    tau_ref_mhz: float = 0.0
    tau_index: float = -4.0


def _base_profile(params: InjectParams) -> np.ndarray:
    """Unit-peak profile sampled on the fine phase grid."""
    ph = np.arange(_NFINE) / _NFINE
    if params.profile is not None:
        prof = np.asarray(params.profile, float)
        peak = np.abs(prof).max()
        if peak > 0:
            prof = prof / peak          # unit peak: amp semantics hold
        x = np.arange(len(prof)) / len(prof)
        return np.interp(ph, x, prof, period=1.0)
    # pulse_shape centers gauss at 0.5; shift so peak sits at phase 0
    return pulse_shape(ph + 0.5, params.shape, params.width)


def scattering_taus(params: InjectParams,
                    freqs: np.ndarray) -> np.ndarray:
    """Per-channel scattering timescales (seconds): tau at the
    reference frequency scaled by (nu/nu_ref)**tau_index."""
    freqs = np.asarray(freqs, float)
    if params.tau <= 0.0:
        return np.zeros(len(freqs))
    nu_ref = params.tau_ref_mhz or float(freqs.max())
    return params.tau * (np.maximum(freqs, 1e-3)
                         / nu_ref) ** params.tau_index


def _smeared_profiles(params: InjectParams, freqs: np.ndarray,
                      chanwidth: float, dt: float) -> np.ndarray:
    """[nchan, _NFINE] profiles convolved with each channel's DM
    smearing boxcar + the sampling boxcar (injectpsr.py applies both)
    and, when params.tau > 0, the channel's one-sided exponential
    scattering tail."""
    base = _base_profile(params)
    F = np.fft.rfft(base)
    k = np.arange(F.size)
    # smear time across one channel: d(delay)/d(f) * chanwidth
    lo = freqs - 0.5 * chanwidth
    hi = freqs + 0.5 * chanwidth
    smear_sec = np.abs(delay_from_dm(params.dm, np.maximum(lo, 1e-3))
                       - delay_from_dm(params.dm, hi))
    taus = scattering_taus(params, freqs)
    out = np.empty((len(freqs), _NFINE))
    for c, sm in enumerate(smear_sec):
        width = np.hypot(sm, dt) * params.f     # rotations
        width = min(max(width, 0.0), 1.0)
        # boxcar of `width` rotations in the Fourier domain: sinc
        resp = np.sinc(k * width).astype(complex)
        if taus[c] > 0.0:
            # unit-area one-sided exponential exp(-t/tau)/tau has
            # harmonic response 1/(1 + 2*pi*i*k*tau_rot); periodic
            # wrap-around comes free in the harmonic domain.  Flux is
            # conserved (k=0 untouched) so the peak DROPS as the tail
            # grows — the physical behavior, and why a target-S/N
            # injection should set amp via amp_for_snr on the
            # unscattered profile then expect the scattered S/N loss.
            tau_rot = taus[c] * params.f        # rotations
            resp = resp / (1.0 + 2j * np.pi * k * tau_rot)
        out[c] = np.fft.irfft(F * resp, _NFINE)
    return out


def _channel_model(params: InjectParams, freqs: np.ndarray, dt: float):
    """(profiles [nchan, _NFINE], delays [nchan] s from the band top) of
    an injection: they depend on the band and the pulsar, not on the
    block of data, so a streamed injection computes them once."""
    freqs = np.asarray(freqs, float)
    nchan = len(freqs)
    chanwidth = float(np.median(np.diff(freqs))) if nchan > 1 else 1.0
    profs = _smeared_profiles(params, freqs, abs(chanwidth), dt)
    delays = delay_from_dm(params.dm, freqs)
    return profs, delays - delays.min()


def _add_pulsar(data: np.ndarray, dt: float, params: InjectParams,
                profs: np.ndarray, delays: np.ndarray,
                start_sec: float) -> np.ndarray:
    """data + the pulsar, channel by channel: the float64 phase at the
    channel's delayed time, its profile sample, and the float32 add."""
    N, nchan = data.shape
    t = start_sec + (np.arange(N) + 0.5) * dt
    out = data.copy()
    for c in range(nchan):
        tc = t - delays[c]
        if params.orbit is not None:
            tc = tc - np.asarray(orbit_delays(tc, params.orbit))
        ph = (params.phase0 + params.f * tc
              + 0.5 * params.fdot * tc * tc)
        idx = np.mod((ph % 1.0) * _NFINE, _NFINE).astype(np.int64)
        out[:, c] += (params.amp * profs[c, idx]).astype(np.float32)
    return out


def inject_pulsar(data: np.ndarray, dt: float, freqs: np.ndarray,
                  params: InjectParams,
                  start_sec: float = 0.0) -> np.ndarray:
    """Return data + injected pulsar.

    data: [N, nchan] float, channels ASCENDING to match `freqs` (MHz).
    start_sec: observation time of data[0] (for chunked injection).
    The highest channel carries zero dispersive offset, matching the
    convention of the dedispersion ops (delays referenced to band top).
    """
    data = np.asarray(data, np.float32)
    if len(freqs) != data.shape[1]:
        raise ValueError("freqs length != nchan")
    profs, delays = _channel_model(params, freqs, dt)
    return _add_pulsar(data, dt, params, profs, delays, start_sec)


def amp_for_snr(snr: float, params: InjectParams, N: int,
                noise_sigma: float, nchan: int) -> float:
    """Peak amplitude per channel-sample for a target matched-filter
    S/N over the whole observation: a unit-peak periodic signal p(t)
    in nchan channels of per-sample noise sigma has
    S/N = A*sqrt(N*nchan*<p^2>)/sigma (mean-subtracted profile)."""
    prof = _base_profile(params)
    prof = prof - prof.mean()
    p2 = float(np.mean(prof ** 2))
    return float(snr * noise_sigma / np.sqrt(N * nchan * p2))


def truth_record(params: InjectParams, t: float = 0.0,
                 snr: Optional[float] = None) -> dict:
    """One injected pulsar as a ground-truth sidecar record.  This is
    the single schema every producer (injectpsr, the stream loadgen,
    synthetic campaigns) shares, so triage calibration can label
    candidates against any of them."""
    f = float(params.f)
    return {
        "t": float(t),
        "dm": float(params.dm),
        "f": f,
        "period": (1.0 / f) if f > 0 else 0.0,
        "fdot": float(params.fdot),
        "snr": float(snr) if snr is not None else None,
        "amp": float(params.amp),
        "width": float(params.width),
    }


def truth_sidecar_path(datapath: str) -> str:
    """``<out>_injected.json`` beside an injected data file."""
    import os
    return os.path.splitext(datapath)[0] + "_injected.json"


def write_truth_sidecar(datapath: str, records: list,
                        truth_out: Optional[str] = None) -> str:
    """Atomically write the ground-truth sidecar for an injected
    file; returns the path written."""
    import json

    from presto_tpu_torch.io.atomic import atomic_write_text

    path = truth_out or truth_sidecar_path(datapath)
    atomic_write_text(path, json.dumps(
        {"schema": 1, "datafile": datapath,
         "injected": list(records)}, indent=1, sort_keys=True) + "\n")
    return path


def inject_into_filterbank(inpath: str, outpath: str,
                           params: InjectParams,
                           block: int = 1 << 14,
                           truth_out: Optional[str] = None,
                           write_truth: bool = True) -> None:
    """Stream a .fil through the injector (chunked; constant memory).

    Unless ``write_truth`` is False, a ground-truth sidecar
    (``<out>_injected.json``, or ``truth_out``) records what was
    injected — downstream triage calibration labels its candidates
    against this for free."""
    from presto_tpu_torch.io import sigproc

    with sigproc.FilterbankFile(inpath) as fb:
        hdr = fb.header
        if hdr.nifs != 1:
            raise ValueError("injection into multi-IF files is lossy "
                             "(reader sums IFs); split pols first")
        freqs = hdr.lofreq + np.arange(hdr.nchans) * abs(hdr.foff)
        profs, delays = _channel_model(params, freqs, hdr.tsamp)
        maxval = (1 << min(hdr.nbits, 16)) - 1 if hdr.nbits <= 16 \
            else None
        with open(outpath, "wb") as f:
            sigproc.write_filterbank_header(hdr, f)
            for start in range(0, hdr.N, block):
                n = min(block, hdr.N - start)
                blk = fb.read_spectra(start, n)
                blk = _add_pulsar(blk, hdr.tsamp, params, profs, delays,
                                  start * hdr.tsamp)
                if maxval is not None:
                    blk = np.clip(np.round(blk), 0, maxval)
                arr = blk[:, ::-1] if hdr.foff < 0 else blk
                packed = sigproc.pack_bits(
                    arr.reshape(-1), hdr.nbits)
                packed.tofile(f)
    if write_truth:
        write_truth_sidecar(outpath, [truth_record(params)],
                            truth_out=truth_out)
