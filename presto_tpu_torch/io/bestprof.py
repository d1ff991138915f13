""".bestprof reader (lib/python/bestprof.py analog).

Host copy of ``presto_tpu/io/bestprof.py`` for the PyTorch
port, which imports nothing from the JAX package.

Parses the text files written by io/pfd.write_bestprof / the reference
prepfold: '#'-prefixed key = value header lines followed by
'bin  value' profile rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Bestprof:
    filenm: str = ""
    candnm: str = ""
    telescope: str = ""
    epochi: int = 0            # integer part of topo epoch
    epochf: float = 0.0        # fractional part
    bepoch: float = 0.0
    dt: float = 0.0
    N: float = 0.0
    data_avg: float = 0.0
    data_std: float = 0.0
    proflen: int = 0
    prof_avg: float = 0.0
    prof_std: float = 0.0
    chi_sqr: float = 0.0
    best_dm: float = 0.0
    p0_topo: float = 0.0       # seconds
    p0err_topo: float = 0.0
    p1_topo: float = 0.0       # s/s
    p1err_topo: float = 0.0
    profile: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def epoch(self) -> float:
        return self.epochi + self.epochf


def _pm_split(val: str):
    if "+/-" in val:
        a, b = val.split("+/-")
        return float(a), float(b)
    return float(val), 0.0


def read_bestprof(path: str) -> Bestprof:
    bp = Bestprof()
    prof = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#") and "=" in line:
                key, _, val = line[1:].partition("=")
                key = key.strip()
                val = val.strip()
                if val in ("", "N/A"):
                    continue
                if key == "Input file":
                    bp.filenm = val
                elif key == "Candidate":
                    bp.candnm = val
                elif key == "Telescope":
                    bp.telescope = val
                elif key == "Epoch_topo":
                    e = float(val)
                    bp.epochi = int(e)
                    bp.epochf = e - bp.epochi
                elif key.startswith("Epoch_bary"):
                    bp.bepoch = float(val)
                elif key == "T_sample":
                    bp.dt = float(val)
                elif key == "Data Folded":
                    bp.N = float(val)
                elif key == "Data Avg":
                    bp.data_avg = float(val)
                elif key == "Data StdDev":
                    bp.data_std = float(val)
                elif key == "Profile Bins":
                    bp.proflen = int(val)
                elif key == "Profile Avg":
                    bp.prof_avg = float(val)
                elif key == "Profile StdDev":
                    bp.prof_std = float(val)
                elif key == "Reduced chi-sqr":
                    bp.chi_sqr = float(val)
                elif key == "Best DM":
                    bp.best_dm = float(val)
                elif key.startswith("P_topo"):
                    v, e = _pm_split(val)
                    bp.p0_topo, bp.p0err_topo = v / 1000.0, e / 1000.0
                elif key.startswith("P'_topo"):
                    bp.p1_topo, bp.p1err_topo = _pm_split(val)
            elif line and not line.startswith("#"):
                parts = line.split()
                if len(parts) == 2:
                    prof.append(float(parts[1]))
    bp.profile = np.array(prof)
    if not bp.proflen:
        bp.proflen = len(prof)
    return bp
