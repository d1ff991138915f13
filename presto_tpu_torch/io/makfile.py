""".mak parameter files (iomak.c / makeinf.c analog).

Host copy of ``presto_tpu/io/makfile.py`` for the PyTorch port, which
imports nothing from the JAX package (bincand -mak reads its orbit).

The reference's synthetic ground-truth system: a .mak file declares an
exact signal (N, dt, shape, f/fdot/fdotdot, amplitude, phase, binary
orbit, amplitude modulation, noise, on/off windows) and makedata
renders it to .dat+.inf (tests/test_fdot.mak etc., SURVEY §4 item 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class MakParams:
    description: str = "makedata parameters"
    N: int = 0
    dt: float = 1.0
    shape: str = "Sine"            # Sine | Gaussian | Crab | ...
    roundformat: str = "Whole Numbers"   # or "Fractional"
    f: float = 1.0
    fdot: float = 0.0
    fdotdot: float = 0.0
    amp: float = 1.0
    phs_deg: float = 0.0
    dc: float = 0.0
    orb_p: float = 0.0
    orb_x: float = 0.0
    orb_e: float = 0.0
    orb_w: float = 0.0
    orb_t: float = 0.0
    ampmod_a: float = 0.0
    ampmod_phs_deg: float = 0.0
    ampmod_f: float = 0.0
    noise_type: str = "Standard"   # Standard (gaussian) | Other
    noise_sigma: float = 1.0
    onoff: List[Tuple[float, float]] = field(default_factory=list)
    fwhm: float = 0.1              # gaussian pulse FWHM (rotations)


_KEYMAP = [
    ("Num data pts", "N", int),
    ("dt per bin (s)", "dt", float),
    ("Pulse shape", "shape", str),
    ("Rounding format", "roundformat", str),
    ("Pulse freq (hz)", "f", float),
    ("fdot (s-2)", "fdot", float),
    ("fdotdot (s-3)", "fdotdot", float),
    ("Pulse amp", "amp", float),
    ("Pulse phs (deg)", "phs_deg", float),
    ("DC backgrnd level", "dc", float),
    ("Binary period (s)", "orb_p", float),
    ("Bin asini/c (s)", "orb_x", float),
    ("Bin eccentricity", "orb_e", float),
    ("Ang of Peri (deg)", "orb_w", float),
    ("Tm since peri (s)", "orb_t", float),
    ("Amp Mod amplitude", "ampmod_a", float),
    ("Amp Mod phs (deg)", "ampmod_phs_deg", float),
    ("Amp Mod freq (hz)", "ampmod_f", float),
    ("Noise type", "noise_type", str),
    ("Noise sigma", "noise_sigma", float),
    ("Gauss FWHM", "fwhm", float),
]


def read_mak(path: str) -> MakParams:
    mk = MakParams()
    keymap = {k: (attr, typ) for k, attr, typ in _KEYMAP}
    with open(path) as f:
        lines = f.read().splitlines()
    if lines and "=" not in lines[0]:
        mk.description = lines[0].strip()
        lines = lines[1:]
    for line in lines:
        if "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key.startswith("On/Off Pair"):
            a, b = val.split()
            mk.onoff.append((float(a), float(b)))
            continue
        if key in keymap:
            attr, typ = keymap[key]
            setattr(mk, attr, typ(val))
    if not mk.onoff:
        mk.onoff = [(0.0, 1.0)]
    return mk


def write_mak(path: str, mk: MakParams) -> None:
    with open(path, "w") as f:
        f.write(mk.description + "\n")
        for key, attr, typ in _KEYMAP:
            val = getattr(mk, attr)
            f.write("%-17s = %s\n" % (key, ("%.17g" % val)
                                      if typ is not str else val))
        for i, (a, b) in enumerate(mk.onoff, 1):
            f.write("On/Off Pair %2d    = %g %g\n" % (i, a, b))
