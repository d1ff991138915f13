"""mjd2cal / cal2mjd: MJD <-> calendar conversions (src/mjd2cal.c,
src/cal2mjd.c).  Both entry points live here; `python -m
presto_tpu_torch.apps.timeconv mjd2cal 55000.5` etc.

Host copy of ``presto_tpu/apps/timeconv.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import sys

from presto_tpu_torch.astro.time import calendar_to_mjd, mjd_to_calendar


def mjd2cal_main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: mjd2cal MJD [MJD ...]")
        return 1
    for a in argv:
        mjd = float(a)
        y, m, d, frac = mjd_to_calendar(mjd)
        hh = int(frac * 24)
        mm = int((frac * 24 - hh) * 60)
        ss = ((frac * 24 - hh) * 60 - mm) * 60
        print("MJD %s = %04d-%02d-%02d %02d:%02d:%06.3f UTC"
              % (a, y, m, d, hh, mm, ss))
    return 0


def cal2mjd_main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print("usage: cal2mjd YYYY MM DD [HH MM SS]")
        return 1
    y, m, d = int(argv[0]), int(argv[1]), int(argv[2])
    hh = int(argv[3]) if len(argv) > 3 else 0
    mm = int(argv[4]) if len(argv) > 4 else 0
    ss = float(argv[5]) if len(argv) > 5 else 0.0
    frac = (hh + (mm + ss / 60.0) / 60.0) / 24.0
    print("%04d-%02d-%02d %02d:%02d:%06.3f UTC = MJD %.10f"
          % (y, m, d, hh, mm, ss, calendar_to_mjd(y, m, d, frac)))
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in ("mjd2cal", "cal2mjd"):
        print("usage: timeconv {mjd2cal|cal2mjd} args...")
        return 1
    fn = mjd2cal_main if argv[0] == "mjd2cal" else cal2mjd_main
    return fn(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
