"""FITS surgery utilities: psrfits_dumparrays, weight_psrfits,
fitsdelrow, fitsdelcol (src/psrfits_dumparrays.c, weight_psrfits.py,
src/fitsdelrow.c, src/fitsdelcol.c).

All four work on SEARCH-mode PSRFITS via raw byte surgery on the
2880-byte FITS block structure (no CFITSIO): dump prints the
DAT_FREQ/DAT_WTS/DAT_SCL/DAT_OFFS arrays, weight patches DAT_WTS in
place, delrow/delcol rewrite the binary table with rows/columns
removed and the header cards fixed up.

Host copy of ``presto_tpu/apps/fitsutils.py`` for the PyTorch port:

    python -m presto_tpu_torch.apps.fitsutils dumparrays -rows 0 f.fits
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

BLOCK = 2880


# ----------------------------------------------------------------------
# Minimal HDU splitter (cards + data bytes), re-serializable
# ----------------------------------------------------------------------

class RawHdu:
    def __init__(self, cards, data):
        self.cards = cards          # list of 80-char strings (with END)
        self.data = bytearray(data)

    def get(self, key, default=None):
        for c in self.cards:
            if c.startswith(key.ljust(8)):
                val = c[10:].split("/")[0].strip().strip("'").strip()
                return val
        return default

    def geti(self, key, default=0):
        v = self.get(key)
        return int(v) if v is not None else default

    def set(self, key, value):
        new = "%-8s= %20s" % (key, value)
        new = new.ljust(80)[:80]
        for i, c in enumerate(self.cards):
            if c.startswith(key.ljust(8)):
                self.cards[i] = new
                return
        self.cards.insert(len(self.cards) - 1, new)

    def remove(self, key):
        self.cards = [c for c in self.cards
                      if not c.startswith(key.ljust(8))]

    def serialize(self) -> bytes:
        hdr = "".join(self.cards)
        pad = (-len(hdr)) % BLOCK
        out = (hdr + " " * pad).encode("ascii")
        data = bytes(self.data)
        dpad = (-len(data)) % BLOCK
        return out + data + b"\x00" * dpad


def read_hdus(path: str):
    buf = open(path, "rb").read()
    hdus = []
    off = 0
    while off < len(buf):
        cards = []
        pos = off
        done = False
        while not done:
            if pos >= len(buf):
                raise ValueError("truncated FITS file: header block "
                                 "without END card at offset %d" % off)
            block = buf[pos:pos + BLOCK].decode("ascii", "replace")
            for i in range(0, BLOCK, 80):
                card = block[i:i + 80]
                cards.append(card)
                if card.startswith("END"):
                    done = True
                    break
            pos += BLOCK
        hdu = RawHdu(cards, b"")
        bitpix = abs(hdu.geti("BITPIX", 8))
        naxis = hdu.geti("NAXIS", 0)
        size = 1 if naxis else 0
        for i in range(1, naxis + 1):
            size *= hdu.geti("NAXIS%d" % i, 0)
        size = size * bitpix // 8 + hdu.geti("PCOUNT", 0)
        dsize = ((size + BLOCK - 1) // BLOCK) * BLOCK
        hdu.data = bytearray(buf[pos:pos + size])
        hdus.append(hdu)
        off = pos + dsize
    return hdus


def write_hdus(path: str, hdus) -> None:
    with open(path, "wb") as f:
        for h in hdus:
            f.write(h.serialize())


def _find_subint(hdus):
    for h in hdus:
        if (h.get("EXTNAME") or "").startswith("SUBINT"):
            return h
    raise SystemExit("no SUBINT HDU found")


def _columns(hdu: RawHdu):
    """[(name, code, repeat, offset, nbytes)] from TFORM/TTYPE cards."""
    sizes = {"B": 1, "I": 2, "J": 4, "K": 8, "E": 4, "D": 8, "A": 1}
    cols = []
    off = 0
    for i in range(1, hdu.geti("TFIELDS", 0) + 1):
        tform = (hdu.get("TFORM%d" % i) or "1A").strip()
        j = 0
        while j < len(tform) and tform[j].isdigit():
            j += 1
        repeat = int(tform[:j]) if j else 1
        code = tform[j] if j < len(tform) else "A"
        nb = ((repeat + 7) // 8 if code == "X"
              else repeat * sizes.get(code, 1))
        cols.append((str(hdu.get("TTYPE%d" % i) or "").strip(),
                     code, repeat, off, nb))
        off += nb
    return cols


# ----------------------------------------------------------------------
# The four tools
# ----------------------------------------------------------------------

def dumparrays(path: str, rows=None) -> None:
    hdu = _find_subint(read_hdus(path))
    cols = {c[0]: c for c in _columns(hdu)}
    naxis1 = hdu.geti("NAXIS1")
    nrows = hdu.geti("NAXIS2")
    rows = rows if rows is not None else range(min(nrows, 1))
    for name in ("DAT_FREQ", "DAT_WTS", "DAT_OFFS", "DAT_SCL"):
        if name not in cols:
            continue
        _, code, repeat, off, nb = cols[name]
        dt = {"E": ">f4", "D": ">f8"}.get(code, ">f4")
        for r in rows:
            start = r * naxis1 + off
            arr = np.frombuffer(bytes(hdu.data[start:start + nb]), dt)
            print("%s[row %d] (%d):" % (name, r, repeat))
            print("  " + " ".join("%.6g" % v for v in arr))


def weight_psrfits(path: str, wtsfile: str) -> int:
    """Overwrite DAT_WTS in EVERY subint with weights from a text file
    ('chan weight' or one weight per line), in place."""
    arr = np.loadtxt(wtsfile, ndmin=2)
    wts = arr[:, -1].astype(">f4")
    hdus = read_hdus(path)
    hdu = _find_subint(hdus)
    cols = {c[0]: c for c in _columns(hdu)}
    _, code, repeat, off, nb = cols["DAT_WTS"]
    if len(wts) != repeat:
        raise SystemExit("weights length %d != nchan %d"
                         % (len(wts), repeat))
    naxis1 = hdu.geti("NAXIS1")
    nrows = hdu.geti("NAXIS2")
    payload = wts.tobytes()
    with open(path, "r+b") as f:
        base = _data_offset_of(hdus, hdu)
        for r in range(nrows):
            f.seek(base + r * naxis1 + off)
            f.write(payload)
    return nrows


def _data_offset_of(hdus, target: RawHdu) -> int:
    """Byte offset of `target`'s data area, from an already-parsed HDU
    list (avoids re-reading a possibly huge file)."""
    buf_off = 0
    for h in hdus:
        hdr_bytes = ((len(h.cards) * 80 + BLOCK - 1) // BLOCK) * BLOCK
        if h is target or h.get("EXTNAME") == target.get("EXTNAME"):
            return buf_off + hdr_bytes
        dsize = ((len(h.data) + BLOCK - 1) // BLOCK) * BLOCK
        buf_off += hdr_bytes + dsize
    raise SystemExit("HDU not found")


def fitsdelrow(path: str, outpath: str, lorow: int, hirow: int) -> int:
    """Delete subint rows [lorow, hirow] (1-based, inclusive)."""
    hdus = read_hdus(path)
    hdu = _find_subint(hdus)
    naxis1 = hdu.geti("NAXIS1")
    nrows = hdu.geti("NAXIS2")
    lo, hi = max(lorow, 1), min(hirow, nrows)
    keep = bytearray()
    for r in range(nrows):
        if not (lo <= r + 1 <= hi):
            keep += hdu.data[r * naxis1:(r + 1) * naxis1]
    hdu.data = keep
    ndel = nrows - len(keep) // naxis1
    hdu.set("NAXIS2", len(keep) // naxis1)
    write_hdus(outpath, hdus)
    return ndel


def fitsdelcol(path: str, outpath: str, colname: str) -> None:
    """Delete one column from the SUBINT table."""
    hdus = read_hdus(path)
    hdu = _find_subint(hdus)
    cols = _columns(hdu)
    names = [c[0] for c in cols]
    if colname not in names:
        raise SystemExit("column %r not in SUBINT (%s)"
                         % (colname, names))
    ci = names.index(colname)
    _, _, _, off, nb = cols[ci]
    naxis1 = hdu.geti("NAXIS1")
    nrows = hdu.geti("NAXIS2")
    out = bytearray()
    for r in range(nrows):
        row = hdu.data[r * naxis1:(r + 1) * naxis1]
        out += row[:off] + row[off + nb:]
    hdu.data = out
    # renumber EVERY indexed column keyword (TTYPE/TFORM/TUNIT plus
    # TDIM/TSCAL/TZERO/TNULL/... as real telescope files carry)
    nf = hdu.geti("TFIELDS")
    import re
    prefixes = set()
    for card in hdu.cards:
        m = re.match(r"^(T[A-Z]+?)(\d+) *=", card)
        if m and 1 <= int(m.group(2)) <= nf \
                and m.group(1) != "TFIELDS":
            prefixes.add(m.group(1))
    for key in sorted(prefixes):
        # carry each card's RAW value+comment field verbatim so numeric
        # keywords (TSCAL/TZERO/TNULL/TBCOL) keep their FITS type —
        # re-quoting them would corrupt the header
        raws = {}
        for card in hdu.cards:
            m = re.match(r"^%s(\d+) *= (.*)$" % key, card)
            if m and 1 <= int(m.group(1)) <= nf:
                raws[int(m.group(1))] = m.group(2)
        vals = [raws.get(i) for i in range(1, nf + 1)]
        for i in range(1, nf + 1):
            hdu.remove("%s%d" % (key, i))
        vals.pop(ci)
        for i, v in enumerate(vals, 1):
            if v is not None:
                hdu.set("%s%d" % (key, i), v.rstrip())
    hdu.set("TFIELDS", nf - 1)
    hdu.set("NAXIS1", naxis1 - nb)
    write_hdus(outpath, hdus)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fitsutils")
    sub = p.add_subparsers(dest="tool", required=True)
    s = sub.add_parser("dumparrays")
    s.add_argument("-rows", type=str, default="0")
    s.add_argument("fitsfile")
    s = sub.add_parser("weight")
    s.add_argument("-wts", type=str, required=True)
    s.add_argument("fitsfile")
    s = sub.add_parser("delrow")
    s.add_argument("lorow", type=int)
    s.add_argument("hirow", type=int)
    s.add_argument("fitsfile")
    s.add_argument("-o", type=str, required=True)
    s = sub.add_parser("delcol")
    s.add_argument("colname")
    s.add_argument("fitsfile")
    s.add_argument("-o", type=str, required=True)
    args = p.parse_args(argv)
    if args.tool == "dumparrays":
        rows = [int(r) for r in args.rows.split(",")]
        dumparrays(args.fitsfile, rows)
    elif args.tool == "weight":
        n = weight_psrfits(args.fitsfile, args.wts)
        print("weight_psrfits: patched DAT_WTS in %d subints" % n)
    elif args.tool == "delrow":
        n = fitsdelrow(args.fitsfile, args.o, args.lorow, args.hirow)
        print("fitsdelrow: removed %d rows -> %s" % (n, args.o))
    else:
        fitsdelcol(args.fitsfile, args.o, args.colname)
        print("fitsdelcol: removed %s -> %s" % (args.colname, args.o))
    return 0


if __name__ == "__main__":
    sys.exit(main())
