"""PRESTO `.inf` metadata sidecar files: read/write with format parity.

Host copy of ``presto_tpu/io/infodata.py`` for the PyTorch port, which imports
nothing from the JAX package.

Every .dat / .fft artifact carries a `basename.inf` text sidecar.  The
format is the fixed-label key=value layout written by the reference's
writeinf (src/ioinf.c:257-350); fields mirror `struct infodata`
(include/makeinf.h:23-56).  Files written here are byte-compatible with
the reference for the radio-band case, so reference tools can consume
our artifacts and vice versa.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

ARTIFICIAL_TELESCOPE = "None (Artificial Data Set)"
_RADIO = "Radio"


@dataclass
class InfoData:
    """Python analog of struct infodata (makeinf.h:23-56)."""
    name: str = ""                       # data file name without suffix
    telescope: str = ARTIFICIAL_TELESCOPE
    instrument: str = "Unknown"
    object: str = "Unknown"
    ra_str: str = "00:00:00.0000"        # hh:mm:ss.ssss
    dec_str: str = "00:00:00.0000"       # dd:mm:ss.ssss
    observer: str = "Unknown"
    mjd_i: int = -1                      # epoch integer part
    mjd_f: float = 0.0                   # epoch fractional part
    bary: int = 0
    N: float = 0                         # number of bins
    dt: float = 0.0                      # seconds per bin
    numonoff: int = 1
    onoff: List[Tuple[float, float]] = field(default_factory=list)
    band: str = _RADIO
    fov: float = 0.0                     # beam diameter, arcsec
    dm: float = 0.0
    freq: float = 0.0                    # central freq of low channel, MHz
    freqband: float = 0.0                # total bandwidth, MHz
    num_chan: int = 1
    chan_wid: float = 0.0                # channel bandwidth, MHz
    analyzer: str = "Unknown"
    notes: str = ""

    @property
    def mjd(self) -> float:
        return self.mjd_i + self.mjd_f

    @property
    def is_artificial(self) -> bool:
        return self.telescope == ARTIFICIAL_TELESCOPE

    def basename(self) -> str:
        return self.name


def _fmt(label: str, value: str) -> str:
    # Label padded so '=' lands at index 40, matching writeinf
    # (ioinf.c:268-348) and the read fast path (ioinf.c:29).
    return " {:<39s}=  {}\n".format(label, value)


def write_inf(info: InfoData, filename: str | None = None) -> str:
    """Write `info` to `<name>.inf` (or `filename`).  Returns the path.

    Format parity: src/ioinf.c:257-350 writeinf.
    """
    path = filename or (info.name + ".inf")
    lines = []
    lines.append(_fmt("Data file name without suffix", info.name))
    lines.append(_fmt("Telescope used", info.telescope))
    if not info.is_artificial:
        lines.append(_fmt("Instrument used", info.instrument))
        lines.append(_fmt("Object being observed", info.object))
        lines.append(_fmt("J2000 Right Ascension (hh:mm:ss.ssss)",
                          info.ra_str))
        lines.append(_fmt("J2000 Declination     (dd:mm:ss.ssss)",
                          info.dec_str))
        lines.append(_fmt("Data observed by", info.observer))
        frac = "{:.15f}".format(info.mjd_f)
        assert frac.startswith("0.")
        lines.append(_fmt("Epoch of observation (MJD)",
                          "{:d}.{}".format(info.mjd_i, frac[2:])))
        lines.append(_fmt("Barycentered?           (1 yes, 0 no)",
                          str(info.bary)))
    lines.append(_fmt("Number of bins in the time series",
                      "{:<11.0f}".format(info.N)))
    lines.append(_fmt("Width of each time series bin (sec)",
                      "{:.15g}".format(info.dt)))
    breaks = 1 if info.numonoff > 1 else 0
    lines.append(_fmt("Any breaks in the data? (1 yes, 0 no)", str(breaks)))
    if info.numonoff > 1:
        for ii, (on, off) in enumerate(info.onoff):
            lines.append(_fmt("On/Off bin pair #{:3d}".format(ii + 1),
                              "{:<11.0f}, {:<11.0f}".format(on, off)))
    if not info.is_artificial:
        lines.append(_fmt("Type of observation (EM band)", info.band))
        if info.band == _RADIO:
            lines.append(_fmt("Beam diameter (arcsec)",
                              "{:.0f}".format(info.fov)))
            lines.append(_fmt("Dispersion measure (cm-3 pc)",
                              "{:.12g}".format(info.dm)))
            lines.append(_fmt("Central freq of low channel (MHz)",
                              "{:.12g}".format(info.freq)))
            lines.append(_fmt("Total bandwidth (MHz)",
                              "{:.12g}".format(info.freqband)))
            lines.append(_fmt("Number of channels",
                              "{:d}".format(info.num_chan)))
            lines.append(_fmt("Channel bandwidth (MHz)",
                              "{:.12g}".format(info.chan_wid)))
    lines.append(_fmt("Data analyzed by", info.analyzer))
    lines.append(" Any additional notes:\n    {}\n\n".format(info.notes))
    from presto_tpu_torch.io.atomic import atomic_write_text
    atomic_write_text(path, "".join(lines))
    return path


def _val(line: str) -> str:
    """Extract the value after '=' the way read_inf_line_valstr does
    (ioinf.c:20-79): '=' at col 40 if present, else last '=' in line."""
    if len(line) > 40 and line[40] == "=":
        return line[41:].strip()
    idx = line.rfind("=")
    if idx < 0:
        raise ValueError("no '=' in .inf line: %r" % line)
    return line[idx + 1:].strip()


def read_inf(filenm: str) -> InfoData:
    """Read `<base>.inf` (accepts base name or full path with .inf)."""
    path = filenm if filenm.endswith(".inf") else filenm + ".inf"
    try:
        return _read_inf(path)
    except StopIteration:
        raise ValueError("truncated or malformed .inf file: %s" % path) \
            from None


def _read_inf(path: str) -> InfoData:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()]
    it = iter([ln for ln in lines if ln.strip()])
    info = InfoData()
    info.name = _val(next(it))
    info.telescope = _val(next(it))
    if not info.is_artificial:
        info.instrument = _val(next(it))
        info.object = _val(next(it))
        info.ra_str = _val(next(it))
        info.dec_str = _val(next(it))
        info.observer = _val(next(it))
        mjd = _val(next(it))
        ipart, fpart = mjd.split(".")
        info.mjd_i = int(ipart)
        info.mjd_f = float("0." + fpart)
        info.bary = int(_val(next(it)))
    else:
        info.mjd_i = -1
        info.object = "fake pulsar"
    info.N = float(_val(next(it)))
    info.dt = float(_val(next(it)))
    breaks = int(_val(next(it)))
    info.onoff = []
    if breaks:
        while True:
            line = next(it)
            if "On/Off" not in line:
                pushed = line
                break
            on_s, off_s = _val(line).split(",")
            info.onoff.append((float(on_s), float(off_s)))
            if info.onoff[-1][1] >= info.N - 1:
                pushed = None
                break
        info.numonoff = len(info.onoff)
    else:
        info.numonoff = 1
        info.onoff = [(0.0, info.N - 1)]
        pushed = None
    rest = ([pushed] if pushed else []) + list(it)
    it = iter(rest)
    if not info.is_artificial:
        info.band = _val(next(it))
        if info.band == _RADIO:
            info.fov = float(_val(next(it)))
            info.dm = float(_val(next(it)))
            info.freq = float(_val(next(it)))
            info.freqband = float(_val(next(it)))
            info.num_chan = int(_val(next(it)))
            info.chan_wid = float(_val(next(it)))
    for line in it:
        if "Data analyzed by" in line:
            info.analyzer = _val(line)
        elif "Any additional notes" in line:
            break
    # notes: the indented line(s) after the marker
    try:
        marker = next(i for i, ln in enumerate(lines)
                      if "Any additional notes" in ln)
        info.notes = "\n".join(ln.strip() for ln in lines[marker + 1:]
                               if ln.strip())
    except StopIteration:
        pass
    return info


def ra_to_string(h: int, m: int, s: float) -> str:
    return "{:02d}:{:02d}:{:07.4f}".format(h, m, s)


def dec_to_string(d: int, m: int, s: float) -> str:
    sign = "-" if d < 0 else ""
    return "{}{:02d}:{:02d}:{:07.4f}".format(sign, abs(d), m, s)
