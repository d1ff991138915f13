"""rfifind mask / stats artifacts: binary parity with the reference.

Host copy of ``presto_tpu/io/maskfile.py`` for the PyTorch port: a
.mask or .stats file written by either package is read by the other,
byte for byte.

Formats: mask file (mask.c:103-265 read_mask/write_mask), .stats file
(rfifind.c:600-617 write_statsfile).  Flag bits and the mask struct
mirror include/mask.h:1-29.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np

# byte-mask flag bits (mask.h:1-10)
GOODDATA = 0x00
PADDING = 0x01
OLDMASK = 0x02
USERCHAN = 0x04
USERINTS = 0x08
BAD_POW = 0x10
BAD_STD = 0x20
BAD_AVG = 0x40
BADDATA = BAD_POW | BAD_STD | BAD_AVG
USERZAP = USERCHAN | USERINTS


@dataclass
class Mask:
    """Python analog of struct mask (mask.h:13-29)."""
    timesigma: float
    freqsigma: float
    mjd: float
    dtint: float
    lofreq: float
    dfreq: float
    numchan: int
    numint: int
    ptsperint: int
    zap_chans: np.ndarray = field(default_factory=lambda: np.array([], int))
    zap_ints: np.ndarray = field(default_factory=lambda: np.array([], int))
    chans_per_int: List[np.ndarray] = field(default_factory=list)

    def check_mask(self, starttime: float, duration: float):
        """Channels to mask for [starttime, starttime+duration) (s).

        Returns (-1, None) if everything is masked, else (n, channels).
        Parity: check_mask (mask.c:268-...).
        """
        loint = int(starttime / self.dtint)
        hiint = int((starttime + duration) / self.dtint)
        hiint = min(hiint, self.numint - 1)
        loint = min(loint, self.numint - 1)
        chans = set(self.zap_chans.tolist())
        for it in range(loint, hiint + 1):
            if it in self.zap_ints:
                return -1, None
            if it < len(self.chans_per_int):
                chans.update(self.chans_per_int[it].tolist())
        if len(chans) >= self.numchan:
            return -1, None
        return len(chans), np.array(sorted(chans), dtype=np.int32)

    def masked_fraction(self) -> float:
        total = self.numint * self.numchan
        zapped = len(self.zap_ints) * self.numchan
        for it in range(self.numint):
            if it in self.zap_ints:
                continue
            zapped += len(self.chans_per_int[it]) if \
                it < len(self.chans_per_int) else 0
        return zapped / max(total, 1)


def fill_mask(timesigma, freqsigma, mjd, dtint, lofreq, dfreq,
              numchan, numint, ptsperint, zap_chans, zap_ints,
              bytemask: np.ndarray) -> Mask:
    """Build a Mask from the bytemask: a channel is zapped in an
    interval when its BADDATA or USERZAP bits are set.
    Parity: fill_mask (mask.c:10-59)."""
    bad = (bytemask & (BADDATA | USERZAP)) != 0
    chans_per_int = [np.flatnonzero(bad[i]).astype(np.int32)
                     for i in range(numint)]
    return Mask(timesigma=timesigma, freqsigma=freqsigma, mjd=mjd,
                dtint=dtint, lofreq=lofreq, dfreq=dfreq, numchan=numchan,
                numint=numint, ptsperint=ptsperint,
                zap_chans=np.asarray(zap_chans, dtype=np.int32),
                zap_ints=np.asarray(zap_ints, dtype=np.int32),
                chans_per_int=chans_per_int)


def write_mask(path: str, m: Mask) -> None:
    """Binary parity: write_mask (mask.c:233-265); atomic on disk."""
    from presto_tpu_torch.io.atomic import atomic_open
    with atomic_open(path, "wb") as f:
        f.write(struct.pack("<6d", m.timesigma, m.freqsigma, m.mjd,
                            m.dtint, m.lofreq, m.dfreq))
        f.write(struct.pack("<3i", m.numchan, m.numint, m.ptsperint))
        f.write(struct.pack("<i", len(m.zap_chans)))
        if len(m.zap_chans):
            np.asarray(m.zap_chans, "<i4").tofile(f)
        f.write(struct.pack("<i", len(m.zap_ints)))
        if len(m.zap_ints):
            np.asarray(m.zap_ints, "<i4").tofile(f)
        counts = np.array([len(c) for c in m.chans_per_int], "<i4")
        counts.tofile(f)
        for c in m.chans_per_int:
            # full-interval zaps are implicit (read reconstructs them)
            if 0 < len(c) < m.numchan:
                np.asarray(c, "<i4").tofile(f)


def read_mask(path: str) -> Mask:
    """Binary parity: read_mask (mask.c:103-148).  Truncated masks
    raise a typed PrestoIOError, not a bare struct.error."""
    from presto_tpu_torch.io.errors import read_exact
    with open(path, "rb") as f:
        ts, fs, mjd, dtint, lofreq, dfreq = struct.unpack(
            "<6d", read_exact(f, 48, path, "mask header"))
        numchan, numint, ptsperint = struct.unpack(
            "<3i", read_exact(f, 12, path, "mask header"))
        nzc, = struct.unpack("<i", read_exact(f, 4, path,
                                              "mask header"))
        zap_chans = np.fromfile(f, "<i4", nzc) if nzc else \
            np.array([], np.int32)
        nzi, = struct.unpack("<i", read_exact(f, 4, path,
                                              "mask zap data"))
        zap_ints = np.fromfile(f, "<i4", nzi) if nzi else \
            np.array([], np.int32)
        counts = np.fromfile(f, "<i4", numint)
        chans = []
        for n in counts:
            if 0 < n < numchan:
                chans.append(np.fromfile(f, "<i4", n))
            elif n == numchan:
                chans.append(np.arange(numchan, dtype=np.int32))
            else:
                chans.append(np.array([], np.int32))
    return Mask(timesigma=ts, freqsigma=fs, mjd=mjd, dtint=dtint,
                lofreq=lofreq, dfreq=dfreq, numchan=numchan,
                numint=numint, ptsperint=ptsperint, zap_chans=zap_chans,
                zap_ints=zap_ints, chans_per_int=chans)


def write_statsfile(path: str, datapow, dataavg, datastd, ptsperint,
                    lobin=0, numbetween=2) -> None:
    """Binary parity: write_statsfile (rfifind.c:600-617).
    datapow/avg/std: [numint, numchan] float32; atomic on disk."""
    from presto_tpu_torch.io.atomic import atomic_open
    numint, numchan = datapow.shape
    with atomic_open(path, "wb") as f:
        f.write(struct.pack("<5i", numchan, numint, ptsperint, lobin,
                            numbetween))
        np.asarray(datapow, "<f4").tofile(f)
        np.asarray(dataavg, "<f4").tofile(f)
        np.asarray(datastd, "<f4").tofile(f)


def read_statsfile(path: str):
    with open(path, "rb") as f:
        numchan, numint, ptsperint, lobin, numbetween = struct.unpack(
            "<5i", f.read(20))
        n = numchan * numint
        datapow = np.fromfile(f, "<f4", n).reshape(numint, numchan)
        dataavg = np.fromfile(f, "<f4", n).reshape(numint, numchan)
        datastd = np.fromfile(f, "<f4", n).reshape(numint, numchan)
    return dict(numchan=numchan, numint=numint, ptsperint=ptsperint,
                lobin=lobin, numbetween=numbetween, datapow=datapow,
                dataavg=dataavg, datastd=datastd)


def determine_padvals(statsfile_path: str) -> np.ndarray:
    """Per-channel padding values = middle-80% clipped mean of each
    channel's per-interval averages (determine_padvals, mask.c:177-...)."""
    st = read_statsfile(statsfile_path)
    avg = np.sort(st["dataavg"], axis=0)      # [numint, numchan]
    numint = st["numint"]
    lo = int(0.1 * numint)
    hi = max(lo + 1, int(0.9 * numint))
    return avg[lo:hi].mean(axis=0).astype(np.float32)
