"""makedata: render a .mak parameter file to a synthetic .dat + .inf
(src/makedata.c + com.c — the ground-truth generator behind the
reference's test strategy, SURVEY §4 item 2).

Usage: makedata <basename>         (reads <basename>.mak)
Signal model: amp * shape(phase(t)) * ampmod(t) + dc + noise, with
phase(t) = phs0 + f*tb + fd*tb^2/2 + fdd*tb^3/6 evaluated at the
binary-delayed time tb = t - roemer(t), zeroed outside the on/off
windows, optionally rounded to whole numbers.

Host copy of ``presto_tpu/apps/makedata.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.makfile import MakParams, read_mak
from presto_tpu_torch.models.synth import artificial_inf, pulse_shape


def render_mak(mk: MakParams, seed: int = 0) -> np.ndarray:
    t = (np.arange(mk.N) + 0.5) * mk.dt
    tb = t
    if mk.orb_p > 0 and mk.orb_x > 0:
        from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays
        orb = OrbitParams(p=mk.orb_p, x=mk.orb_x, e=mk.orb_e,
                          w=mk.orb_w, t=mk.orb_t)
        tb = t - np.asarray(orbit_delays(t, orb))
    phase = (mk.phs_deg / 360.0 + mk.f * tb
             + 0.5 * mk.fdot * tb ** 2 + mk.fdotdot * tb ** 3 / 6.0)
    shape = {"sine": "sine", "gaussian": "gauss", "gauss": "gauss",
             "crab": "crab"}.get(mk.shape.strip().lower(), "sine")
    data = mk.amp * np.asarray(
        pulse_shape(phase, shape, mk.fwhm), np.float64)
    if mk.ampmod_a != 0.0 and mk.ampmod_f != 0.0:
        data *= 1.0 + mk.ampmod_a * np.cos(
            2 * np.pi * mk.ampmod_f * t
            + np.deg2rad(mk.ampmod_phs_deg))
    data += mk.dc
    if mk.noise_sigma > 0 and mk.noise_type.strip().lower() not in \
            ("other", "none"):
        rng = np.random.default_rng(seed)
        data = data + rng.normal(0.0, mk.noise_sigma, mk.N)
    # on/off windows are fractions of the observation
    if mk.onoff and mk.onoff != [(0.0, 1.0)]:
        gate = np.zeros(mk.N, bool)
        for a, b in mk.onoff:
            gate[int(a * mk.N):int(np.ceil(b * mk.N))] = True
        data = np.where(gate, data, 0.0)
    if mk.roundformat.strip().lower().startswith("whole"):
        data = np.floor(data + 0.5)
    return data.astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="makedata")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("basename",
                   help="Reads <basename>.mak, writes .dat/.inf")
    args = p.parse_args(argv)
    base = args.basename
    if base.endswith(".mak"):
        base = base[:-4]
    mk = read_mak(base + ".mak")
    data = render_mak(mk, seed=args.seed)
    datfft.write_dat(base + ".dat", data)
    info = artificial_inf(os.path.basename(base), mk.N, mk.dt)
    from presto_tpu_torch.io.infodata import write_inf
    write_inf(info, base + ".inf")
    print("makedata: %s.mak -> %s.dat (%d pts, f=%.10g Hz%s)"
          % (base, base, mk.N, mk.f,
             ", binary" if mk.orb_p > 0 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
