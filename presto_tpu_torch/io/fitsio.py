"""Minimal FITS reader/writer (primary HDU + binary tables).

Host copy of ``presto_tpu/io/fitsio.py`` for the PyTorch port, which
imports nothing from the JAX package.

astropy/CFITSIO are not dependencies of the package, and the
reference's own pure-Python PSRFITS reader (lib/python/psrfits.py)
proves a small purpose-built reader suffices.  This module implements
just the FITS subset PSRFITS search-mode data uses:
  - 2880-byte logical blocks of 80-char header cards
  - primary HDU with no data
  - BINTABLE extensions (BITPIX=8) with TFORM codes
    L/B/X/I/J/K/E/D/A including repeat counts
Row data is exposed lazily as numpy arrays; column reads slice the
row-record memory-map, so reading one column of one row never touches
the rest of the file.
"""

from __future__ import annotations

import mmap
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch.io.errors import PrestoIOError

BLOCK = 2880
CARD = 80

# TFORM letter -> (numpy dtype (big-endian), bytes per element)
_TFORM_DTYPES = {
    "L": (np.dtype("u1"), 1),
    "B": (np.dtype("u1"), 1),
    "X": (np.dtype("u1"), 1),          # bit array: repeat counts BITS
    "I": (np.dtype(">i2"), 2),
    "J": (np.dtype(">i4"), 4),
    "K": (np.dtype(">i8"), 8),
    "E": (np.dtype(">f4"), 4),
    "D": (np.dtype(">f8"), 8),
    "A": (np.dtype("S1"), 1),
}


def _fmt_card(key: str, value, comment: str = "") -> bytes:
    """Format one 80-byte header card."""
    if key in ("COMMENT", "HISTORY", "END"):
        return ("%-8s%s" % (key, value))[:CARD].ljust(CARD).encode()
    if isinstance(value, bool):
        vstr = "T" if value else "F"
        card = "%-8s= %20s" % (key, vstr)
    elif isinstance(value, (int, np.integer)):
        card = "%-8s= %20d" % (key, value)
    elif isinstance(value, (float, np.floating)):
        card = "%-8s= %20s" % (key, repr(float(value)))
    else:
        card = "%-8s= %-20s" % (key, "'%s'" % str(value))
    if comment:
        card += " / " + comment
    return card[:CARD].ljust(CARD).encode()


def _parse_value(raw: str):
    v = raw.strip()
    if not v:
        return None
    if v.startswith("'"):
        end = v.rfind("'")
        return v[1:end].rstrip()
    if v == "T":
        return True
    if v == "F":
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v.replace("D", "E").replace("d", "e"))
    except ValueError:
        return v


@dataclass
class Header:
    cards: Dict[str, Any] = field(default_factory=dict)

    def get(self, key, default=None):
        return self.cards.get(key, default)

    def __getitem__(self, key):
        return self.cards[key]

    def __contains__(self, key):
        return key in self.cards

    def __setitem__(self, key, value):
        self.cards[key] = value


def _read_header(buf, offset: int, path: str = "") -> Tuple[Header, int]:
    """Parse header cards from `offset`; returns (header, data_offset)."""
    hdr = Header()
    pos = offset
    done = False
    while not done:
        block = buf[pos:pos + BLOCK]
        if len(block) < BLOCK:
            raise PrestoIOError("truncated FITS header", path=path,
                                offset=pos, expected_bytes=BLOCK,
                                actual_bytes=len(block),
                                kind="truncated-header")
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] == "= ":
                body = card[10:]
                slash = _find_comment_slash(body)
                hdr.cards[key] = _parse_value(
                    body[:slash] if slash >= 0 else body)
        pos += BLOCK
    return hdr, pos


def _find_comment_slash(body: str) -> int:
    """Index of the comment '/', respecting quoted strings."""
    inq = False
    for i, ch in enumerate(body):
        if ch == "'":
            inq = not inq
        elif ch == "/" and not inq:
            return i
    return -1


@dataclass
class Column:
    name: str
    code: str          # TFORM letter
    repeat: int        # element count (bits for X)
    offset: int        # byte offset within the row record
    nbytes: int
    unit: str = ""

    @property
    def dtype(self):
        return _TFORM_DTYPES[self.code][0]


@dataclass
class BinTableHDU:
    header: Header
    columns: List[Column]
    data_offset: int
    naxis1: int        # row record bytes
    naxis2: int        # rows
    _buf: Any = None
    path: str = ""

    def colindex(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def _check(self, start: int, nbytes: int, name: str) -> None:
        """Bounds-check a column read against the actual file size —
        a table whose NAXIS2 promises more rows than the file holds
        (truncated download, killed writer) must fail with a typed
        error, not a numpy buffer exception."""
        avail = len(self._buf) - start
        if start < 0 or avail < nbytes:
            raise PrestoIOError(
                "truncated FITS table data (column %s)" % name,
                path=self.path, offset=start, expected_bytes=nbytes,
                actual_bytes=max(0, avail), kind="truncated-data")

    def read_col(self, name: str, row: int,
                 count: Optional[int] = None) -> np.ndarray:
        """Read one row's worth of column `name` (0-based row)."""
        c = self.colindex(name)
        start = self.data_offset + row * self.naxis1 + c.offset
        if c.code == "X":
            nbytes = (c.repeat + 7) // 8
            self._check(start, nbytes, name)
            raw = np.frombuffer(self._buf, np.uint8, nbytes, start)
            return raw
        n = count if count is not None else c.repeat
        elem = _TFORM_DTYPES[c.code][1]
        self._check(start, n * elem, name)
        raw = np.frombuffer(self._buf, c.dtype, n, start)
        if c.code == "A":
            return raw
        return raw.astype(c.dtype.newbyteorder("="))

    def read_col_raw_bytes(self, name: str, row: int) -> np.ndarray:
        """The undecoded bytes of column `name` for one row."""
        c = self.colindex(name)
        start = self.data_offset + row * self.naxis1 + c.offset
        self._check(start, c.nbytes, name)
        return np.frombuffer(self._buf, np.uint8, c.nbytes, start)


def _parse_bintable(hdr: Header, data_offset: int, buf,
                    path: str = "") -> BinTableHDU:
    tfields = int(hdr["TFIELDS"])
    cols = []
    off = 0
    for i in range(1, tfields + 1):
        tform = str(hdr["TFORM%d" % i]).strip()
        j = 0
        while j < len(tform) and tform[j].isdigit():
            j += 1
        repeat = int(tform[:j]) if j else 1
        code = tform[j] if j < len(tform) else "A"
        if code not in _TFORM_DTYPES:
            raise ValueError("unsupported TFORM %r" % tform)
        if code == "X":
            nbytes = (repeat + 7) // 8
        else:
            nbytes = repeat * _TFORM_DTYPES[code][1]
        cols.append(Column(name=str(hdr.get("TTYPE%d" % i, "COL%d" % i)
                                    ).strip(),
                           code=code, repeat=repeat, offset=off,
                           nbytes=nbytes,
                           unit=str(hdr.get("TUNIT%d" % i, "")).strip()))
        off += nbytes
    naxis1 = int(hdr["NAXIS1"])
    if off > naxis1:
        raise PrestoIOError("FITS columns overflow NAXIS1 (%d > %d)"
                            % (off, naxis1), path=path,
                            kind="bad-header")
    return BinTableHDU(header=hdr, columns=cols, data_offset=data_offset,
                       naxis1=naxis1, naxis2=int(hdr["NAXIS2"]),
                       _buf=buf, path=path)


class FitsFile:
    """Read-only FITS file: primary header + list of HDUs."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            try:
                self._mm = mmap.mmap(self._f.fileno(), 0,
                                     access=mmap.ACCESS_READ)
            except (ValueError, OSError):
                self._mm = self._f.read()
            self.primary, pos = _read_header(self._mm, 0, path)
            if self.primary.get("NAXIS", 0) not in (0, None):
                # skip primary data if any
                nax = int(self.primary["NAXIS"])
                if nax > 0:
                    n = abs(int(self.primary["BITPIX"])) // 8
                    for a in range(1, nax + 1):
                        n *= int(self.primary["NAXIS%d" % a])
                    pos += (n + BLOCK - 1) // BLOCK * BLOCK
            self.hdus: List[BinTableHDU] = []
            size = len(self._mm)
            while pos < size:
                hdr, doff = _read_header(self._mm, pos, path)
                if str(hdr.get("XTENSION", "")).strip() != "BINTABLE":
                    raise ValueError(
                        "only BINTABLE extensions supported")
                hdu = _parse_bintable(hdr, doff, self._mm, path)
                self.hdus.append(hdu)
                nbytes = hdu.naxis1 * hdu.naxis2
                pos = doff + (nbytes + BLOCK - 1) // BLOCK * BLOCK
        except KeyError as e:
            # a required card (TFIELDS/NAXIS1/...) vanished: typed
            # corruption error, not a KeyError escape
            self.close()
            raise PrestoIOError("missing FITS card %s" % e, path=path,
                                kind="bad-header") from None
        except BaseException:
            self.close()
            raise

    def hdu(self, extname: str) -> BinTableHDU:
        for h in self.hdus:
            if str(h.header.get("EXTNAME", "")).strip() == extname:
                return h
        raise KeyError(extname)

    def close(self):
        if getattr(self, "_mm", None) is not None \
                and isinstance(self._mm, mmap.mmap):
            self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------------
# Writing (for synthesis of test corpora and converters)
# ----------------------------------------------------------------------

def _pad_block(b: bytes, fill: bytes = b" ") -> bytes:
    rem = len(b) % BLOCK
    return b if rem == 0 else b + fill * (BLOCK - rem)


def write_fits(path: str, primary_cards: Sequence[Tuple],
               tables: Sequence[Dict]) -> None:
    """Write a FITS file.

    primary_cards: [(key, value, comment)] for the primary HDU.
    tables: each {"extname", "cards": [(k,v,c)], "columns":
    [(name, tform, unit)], "rows": [ {colname: ndarray/scalar} ]}.
    """
    out = bytearray()
    cards = [_fmt_card("SIMPLE", True), _fmt_card("BITPIX", 8),
             _fmt_card("NAXIS", 0), _fmt_card("EXTEND", True)]
    for kvc in primary_cards:
        k, v = kvc[0], kvc[1]
        c = kvc[2] if len(kvc) > 2 else ""
        cards.append(_fmt_card(k, v, c))
    cards.append(_fmt_card("END", ""))
    out += _pad_block(b"".join(cards))

    for tab in tables:
        colspecs = tab["columns"]
        # compute row layout
        offsets, off = [], 0
        dts = []
        for name, tform, *_ in colspecs:
            j = 0
            while j < len(tform) and tform[j].isdigit():
                j += 1
            repeat = int(tform[:j]) if j else 1
            code = tform[j]
            nbytes = ((repeat + 7) // 8 if code == "X"
                      else repeat * _TFORM_DTYPES[code][1])
            offsets.append(off)
            dts.append((code, repeat, nbytes))
            off += nbytes
        naxis1 = off
        rows = tab["rows"]
        cards = [_fmt_card("XTENSION", "BINTABLE"),
                 _fmt_card("BITPIX", 8), _fmt_card("NAXIS", 2),
                 _fmt_card("NAXIS1", naxis1),
                 _fmt_card("NAXIS2", len(rows)),
                 _fmt_card("PCOUNT", 0), _fmt_card("GCOUNT", 1),
                 _fmt_card("TFIELDS", len(colspecs))]
        for i, (name, tform, *rest) in enumerate(colspecs, 1):
            cards.append(_fmt_card("TTYPE%d" % i, name))
            cards.append(_fmt_card("TFORM%d" % i, tform))
            if rest and rest[0]:
                cards.append(_fmt_card("TUNIT%d" % i, rest[0]))
        cards.append(_fmt_card("EXTNAME", tab["extname"]))
        for kvc in tab.get("cards", []):
            k, v = kvc[0], kvc[1]
            c = kvc[2] if len(kvc) > 2 else ""
            cards.append(_fmt_card(k, v, c))
        cards.append(_fmt_card("END", ""))
        out += _pad_block(b"".join(cards))

        data = bytearray()
        for row in rows:
            rec = bytearray(naxis1)
            for (name, tform, *_), offset, (code, repeat, nbytes) \
                    in zip(colspecs, offsets, dts):
                val = row[name]
                if code == "A":
                    s = str(val).encode()[:repeat].ljust(repeat)
                    rec[offset:offset + repeat] = s
                elif code == "X":
                    raw = np.asarray(val, np.uint8).tobytes()[:nbytes]
                    rec[offset:offset + len(raw)] = raw
                else:
                    dt = _TFORM_DTYPES[code][0]
                    arr = np.asarray(val, dtype=dt.newbyteorder("=")) \
                        .astype(dt).ravel()
                    raw = arr.tobytes()[:nbytes].ljust(nbytes, b"\0")
                    rec[offset:offset + nbytes] = raw
            data += rec
        out += _pad_block(bytes(data), fill=b"\0")

    from presto_tpu_torch.io.atomic import atomic_write_bytes
    atomic_write_bytes(path, bytes(out))
