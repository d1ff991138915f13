"""Pulsar unit conversions and planning helpers (host-side, float64 numpy).

Host copy of ``presto_tpu/utils/psr.py`` for the PyTorch port, which imports
nothing from the JAX package.

Parity targets in the reference: lib/python/psr_utils.py and
src/misc_utils.c (next2_to_n), src/dispersion.c (smearing formulas),
src/barycenter.c:3 (doppler).  All planning math runs in float64 on the
host; only bulk per-sample compute goes to the device in float32.
"""

from __future__ import annotations

import numpy as np

# Speed of light (m/s), seconds per day.
SOL = 299792458.0
SECPERDAY = 86400.0
# PRESTO's dispersion constant appears as delay = DM / (0.000241 f^2)
# (reference src/dispersion.c:30-39).  Keep the literal for parity.
DM_CONST_INV = 0.000241  # MHz^-2 cm^3 pc^-1 s^-1


def doppler(freq_observed, voverc):
    """Frequency emitted given observed frequency and radial v/c.

    Parity: reference src/barycenter.c:3-10.
    """
    return freq_observed * (1.0 + voverc)


def next2_to_n(x: float) -> int:
    """Smallest power of 2 >= x (reference src/misc_utils.c next2_to_n)."""
    n = 1
    while n < x:
        n <<= 1
    return n


def _is_smooth(n: int, primes=(2, 3, 5, 7)) -> bool:
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def good_fft_size(n: int, multiple_of: int = 16) -> int:
    """Smallest 7-smooth integer >= n divisible by `multiple_of`.

    The analog of psr_utils.choose_N (reference lib/python/psr_utils.py:33):
    a highly-factorable series length, divisible by max_downsample*2 = 16,
    friendly to both XLA's FFT and downsampling.
    """
    n = int(n)
    m = ((n + multiple_of - 1) // multiple_of) * multiple_of
    while not _is_smooth(m):
        m += multiple_of
    return m


def choose_N(orig_N: int) -> int:
    """Pick a highly-factorable series length >= orig_N, divisible by 16.

    Behavioral parity with psr_utils.choose_N: returns 0 for N < 10000.
    """
    if orig_N < 10000:
        return 0
    return good_fft_size(orig_N, multiple_of=16)


# --- frequency/period/acceleration conversions (psr_utils.py:387-407) ---

def z_to_accel(z, T, freq):
    """Convert Fourier f-dot drift z (bins) to acceleration (m/s^2).

    z = f_dot * T^2;  accel = z * c / (T^2 * f).
    """
    return z * SOL / (T * T * freq)


def accel_to_z(accel, T, freq):
    """Inverse of z_to_accel."""
    return accel * T * T * freq / SOL


def p_to_f(p, pd=0.0, pdd=None):
    """Period (+derivatives) -> frequency (+derivatives).

    Parity: psr_utils.p_to_f / src/characteristics.c switch_f_and_p.
    """
    f = 1.0 / p
    fd = -pd / (p * p)
    if pdd is None:
        return f, fd
    if pdd == 0.0:
        fdd = 0.0
    else:
        fdd = 2.0 * pd * pd / (p ** 3) - pdd / (p * p)
    return f, fd, fdd


def f_to_p(f, fd=0.0, fdd=None):
    """Frequency (+derivatives) -> period (+derivatives) (same formula)."""
    return p_to_f(f, fd, fdd)


# --- dispersion smearing (src/dispersion.c:3-27) ---

def smearing_from_bw(dm, center_freq, bandwidth):
    """Dispersion smearing (s) across `bandwidth` MHz at `center_freq` MHz."""
    cf = np.asarray(center_freq, dtype=np.float64)
    out = dm * bandwidth / (0.0001205 * cf * cf * cf)
    return np.where(cf == 0.0, 0.0, out)


def dm_smear(dm, bw_mhz, center_freq_mhz):
    """Alias matching psr_utils.dm_smear."""
    return smearing_from_bw(dm, center_freq_mhz, bw_mhz)


def rad_to_hms(rad: float):
    """Radians -> (hours, minutes, seconds) of right ascension."""
    rad = rad % (2 * np.pi)
    hours = rad * 12.0 / np.pi
    h = int(hours)
    minutes = (hours - h) * 60.0
    m = int(minutes)
    s = (minutes - m) * 60.0
    return h, m, s


def rad_to_dms(rad: float):
    """Radians -> (degrees, minutes, seconds) of declination."""
    sign = -1 if rad < 0 else 1
    rad = abs(rad)
    deg = rad * 180.0 / np.pi
    d = int(deg)
    minutes = (deg - d) * 60.0
    m = int(minutes)
    s = (minutes - m) * 60.0
    return sign * d, m, s
