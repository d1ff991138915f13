"""TOA extraction from folded profiles (bin/get_TOAs.py analog).

Copy of ``presto_tpu/timing/toas.py`` for the PyTorch port: host code
but for the subband realignment (ops/fold.combine_subbands), which runs
on ``device``.

Flow (get_TOAs.py): read a .pfd, align subbands at the candidate DM,
sum sub-integrations into groups, FFTFIT each group profile against a
template, and convert the fitted phase shift into a topocentric TOA at
the group's mid-time using the fold's phase polynomial
(fold_p1/p2/p3 = f, fd, fdd — the same convention prepfold folds with).

TOA MJDs are kept as (int day, fractional day) pairs: a single float64
MJD only resolves ~1 us, below timing precision.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from presto_tpu_torch.io.pfd import Pfd, pfd_subfreqs
from presto_tpu_torch.ops.fold import combine_subbands, subband_fold_shifts
from presto_tpu_torch.timing.fftfit import fftfit, gaussian_template

SECPERDAY = 86400.0



@dataclass
class TOA:
    mjdi: int          # integer MJD (topocentric, uncorrected)
    mjdf: float        # fractional day in [0, 1)
    err_us: float
    freq_mhz: float
    obs: str = "@"
    snr: float = 0.0
    shift: float = 0.0  # fitted phase shift, rotations

    @property
    def mjd(self) -> float:
        return self.mjdi + self.mjdf


def _fold_phase(t: float, f: float, fd: float, fdd: float) -> float:
    return t * (f + t * (fd / 2.0 + t * fdd / 6.0))


def _fold_freq(t: float, f: float, fd: float, fdd: float) -> float:
    return f + t * (fd + t * fdd / 2.0)


def toas_from_pfd(p: Pfd, template: Optional[np.ndarray] = None,
                  ntoa: int = 1, dm: Optional[float] = None,
                  fold_dm: Optional[float] = None,
                  gauss_fwhm: float = 0.1,
                  obs: str = "@", device="cuda") -> List[TOA]:
    """Extract `ntoa` TOAs from a .pfd's profile cube.

    template: profile template (defaults to a Gaussian of FWHM
    `gauss_fwhm` rotations centered at phase 0.5, as get_TOAs -g).
    dm/fold_dm: when both given and nsub > 1, subbands are re-aligned
    from fold_dm to dm before summing (pfd.dedisperse analog, on
    ``device``); when omitted the stored cube is assumed already
    aligned.
    """
    profs = np.asarray(p.profs, np.float64)     # [npart, nsub, proflen]
    npart, nsub, proflen = profs.shape
    f, fd, fdd = p.fold_p1, p.fold_p2, p.fold_p3
    if f <= 0:
        raise ValueError("pfd has no fold frequency (fold_p1)")

    # the fold cube is dedispersed referenced to the HIGHEST channel
    # (dedisp_delays/subband_fold_shifts zero the delay at the band
    # top), so TOAs are quoted at that frequency — get_TOAs.py keeps
    # the same frame via its sumsubdelays correction
    freq_ref = p.lofreq + (p.numchan - 1) * p.chan_wid
    if nsub > 1 and dm is not None and fold_dm is not None:
        subfreqs = pfd_subfreqs(p)
        shifts = subband_fold_shifts(subfreqs, dm, fold_dm, f, proflen,
                                     ref_freq=freq_ref)
        part_profs = np.asarray(combine_subbands(profs, shifts, device))
    else:
        part_profs = profs.sum(axis=1)          # [npart, proflen]

    if template is None:
        template = gaussian_template(proflen, gauss_fwhm)
    template = np.asarray(template, np.float64)

    numdata = p.stats[:, 0, 0].astype(np.float64)
    if not np.all(numdata > 0):
        numdata = np.full(npart, 1.0)
    starts_sec = np.concatenate([[0.0], np.cumsum(numdata)[:-1]]) * p.dt
    ends_sec = np.cumsum(numdata) * p.dt

    ntoa = max(1, min(ntoa, npart))
    per = npart // ntoa

    out: List[TOA] = []
    for g in range(ntoa):
        lo = g * per
        hi = npart if g == ntoa - 1 else (g + 1) * per
        prof = part_profs[lo:hi].sum(axis=0)
        t_mid = 0.5 * (starts_sec[lo] + ends_sec[hi - 1])
        fit = fftfit(prof, template)
        f_inst = _fold_freq(t_mid, f, fd, fdd)
        ph = _fold_phase(t_mid, f, fd, fdd)
        dph = (fit.shift - ph) % 1.0
        if dph >= 0.5:
            dph -= 1.0                           # nearest pulse to t_mid
        t_toa = t_mid + dph / f_inst
        mjdi = int(p.tepoch)
        mjdf = (p.tepoch - mjdi) + t_toa / SECPERDAY
        carry = np.floor(mjdf)
        mjdi += int(carry)
        mjdf -= carry
        out.append(TOA(mjdi=mjdi, mjdf=float(mjdf),
                       err_us=fit.eshift / f_inst * 1e6,
                       freq_mhz=freq_ref, obs=obs, snr=fit.snr,
                       shift=fit.shift))
    return out


def format_princeton(toa: TOA, name: str = "") -> str:
    """Princeton TOA format (psr_utils.write_princeton_toa layout):
    cols 1-1 obs code, 16-24 freq, 25-44 TOA (d.13f), 45-53 error."""
    frac = "%.13f" % toa.mjdf
    if frac.startswith("1"):                     # rounding carried over
        return format_princeton(
            TOA(toa.mjdi + 1, 0.0, toa.err_us, toa.freq_mhz, toa.obs,
                toa.snr, toa.shift), name)
    return "%1s %13s %8.3f %5d%s %8.2f" % (
        toa.obs, name[:13], toa.freq_mhz, toa.mjdi, frac[1:], toa.err_us)


def format_tempo2(toa: TOA, name: str = "unk") -> str:
    """tempo2 .tim line: name freq MJD error(us) site."""
    frac = "%.13f" % toa.mjdf
    if frac.startswith("1"):                     # rounding carried over
        return format_tempo2(
            TOA(toa.mjdi + 1, 0.0, toa.err_us, toa.freq_mhz, toa.obs,
                toa.snr, toa.shift), name)
    return "%s %.3f %5d.%s %.3f %s" % (
        name, toa.freq_mhz, toa.mjdi, frac[2:], toa.err_us, toa.obs)


def format_tim_lines(toas: Sequence[TOA], names,
                     fmt: str = "princeton") -> List[str]:
    """.tim lines for TOAs; `names` is one name or a per-TOA sequence.
    The single source of the .tim convention (CLI and write_tim)."""
    if isinstance(names, str):
        names = [names] * len(toas)
    lines = ["FORMAT 1"] if fmt == "tempo2" else []
    for t, nm in zip(toas, names):
        lines.append(format_tempo2(t, nm) if fmt == "tempo2"
                     else format_princeton(t, nm))
    return lines


def write_tim(path: str, toas: Sequence[TOA], name="unk",
              fmt: str = "princeton") -> None:
    with open(path, "w") as fh:
        fh.write("\n".join(format_tim_lines(toas, name, fmt)) + "\n")
