"""SIGPROC filterbank (.fil) reader/writer.

Host copy of ``presto_tpu/io/sigproc.py`` for the PyTorch port, which imports
nothing from the JAX package.

Format parity: reference src/sigproc_fb.c — length-prefixed keyword
strings between HEADER_START/HEADER_END, little-endian binary values
(write_filterbank_header sigproc_fb.c:191-226, read_filterbank_header
sigproc_fb.c:229-336).  Data: nsamples × nifs × nchans samples of
nbits each, time-major, typically descending frequency (foff < 0).

Host code: the native decoder and prefetching feeder of io/native
(built from csrc/native_io.cpp) for 1/2/4/8-bit data, NumPy for 16 and
32 bits; the ingest quality report of io/quality.  The NumPy decoder
(decode_spectra_numpy) is the plain version the tests hold the native
one against.  FilterbankSet presents several .fil files as one
observation.
"""

from __future__ import annotations

import copy
import io
import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Callable, Iterator, Optional

import numpy as np

from presto_tpu_torch.io import native
from presto_tpu_torch.io.errors import PrestoIOError, read_exact
from presto_tpu_torch.io.quality import (DataQualityReport,
                                         record_zero_runs, scrub_nonfinite)

_TELESCOPES = {0: "Fake", 1: "Arecibo", 2: "Ooty", 3: "Nancay", 4: "Parkes",
               5: "Jodrell", 6: "GBT", 7: "GMRT", 8: "Effelsberg"}

_INT_KEYS = {"machine_id", "telescope_id", "data_type", "nchans", "nbits",
             "nifs", "nbeams", "ibeam", "barycentric", "pulsarcentric",
             "nsamples"}
_DBL_KEYS = {"az_start", "za_start", "src_raj", "src_dej", "tstart", "tsamp",
             "fch1", "foff", "refdm", "period"}
_STR_KEYS = {"rawdatafile", "source_name"}


def _send_string(f: BinaryIO, s: str) -> None:
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _send_int(f: BinaryIO, name: str, val: int) -> None:
    _send_string(f, name)
    f.write(struct.pack("<i", int(val)))


def _send_double(f: BinaryIO, name: str, val: float) -> None:
    _send_string(f, name)
    f.write(struct.pack("<d", float(val)))


def _get_string(f: BinaryIO, path: str = "") -> str:
    nbytes = struct.unpack(
        "<i", read_exact(f, 4, path, "SIGPROC header"))[0]
    if not 0 < nbytes < 200:
        raise ValueError("bad SIGPROC header string length %d" % nbytes)
    return read_exact(f, nbytes, path, "SIGPROC header").decode()


@dataclass
class FilterbankHeader:
    """Header of a SIGPROC filterbank file (sigproc_fb.c sigprocfb)."""
    source_name: str = "fake"
    rawdatafile: str = ""
    machine_id: int = 10
    telescope_id: int = 0
    data_type: int = 1
    fch1: float = 0.0          # MHz, center freq of FIRST (highest) channel
    foff: float = 0.0          # MHz, channel offset (negative: descending)
    nchans: int = 0
    nbits: int = 8
    tstart: float = 0.0        # MJD
    tsamp: float = 0.0         # seconds
    nifs: int = 1
    nbeams: int = 1
    ibeam: int = 1
    src_raj: float = 0.0       # hhmmss.s
    src_dej: float = 0.0       # ddmmss.s
    az_start: float = 0.0
    za_start: float = 0.0
    headerlen: int = 0         # filled in by read
    N: int = 0                 # samples in file, filled in by read

    @property
    def band_ascending(self) -> bool:
        return self.foff > 0

    @property
    def lofreq(self) -> float:
        """Center frequency of the lowest channel, MHz."""
        if self.foff < 0:
            return self.fch1 + (self.nchans - 1) * self.foff
        return self.fch1

    @property
    def bytes_per_spectrum(self) -> int:
        return self.nchans * self.nifs * self.nbits // 8


def write_filterbank_header(hdr: FilterbankHeader, f: BinaryIO) -> None:
    """Parity: write_filterbank_header (sigproc_fb.c:191-226)."""
    _send_string(f, "HEADER_START")
    if hdr.rawdatafile:
        _send_string(f, "rawdatafile")
        _send_string(f, hdr.rawdatafile)
    if hdr.source_name:
        _send_string(f, "source_name")
        _send_string(f, hdr.source_name)
    _send_int(f, "machine_id", hdr.machine_id)
    _send_int(f, "telescope_id", hdr.telescope_id)
    _send_double(f, "src_raj", hdr.src_raj)
    _send_double(f, "src_dej", hdr.src_dej)
    _send_double(f, "az_start", hdr.az_start)
    _send_double(f, "za_start", hdr.za_start)
    _send_int(f, "data_type", 1)
    _send_double(f, "fch1", hdr.fch1)
    _send_double(f, "foff", hdr.foff)
    _send_int(f, "nchans", hdr.nchans)
    _send_int(f, "nbits", hdr.nbits)
    _send_double(f, "tstart", hdr.tstart)
    _send_double(f, "tsamp", hdr.tsamp)
    _send_int(f, "nifs", hdr.nifs)
    _send_string(f, "HEADER_END")


def read_filterbank_header(f: BinaryIO,
                           path: str = "") -> FilterbankHeader:
    """Parity: read_filterbank_header (sigproc_fb.c:229-336).

    Truncated headers raise a typed PrestoIOError (file, offset,
    expected/actual bytes) instead of a bare struct.error escape.
    """
    hdr = FilterbankHeader()
    first = _get_string(f, path)
    if first != "HEADER_START":
        raise ValueError("not a SIGPROC filterbank file")
    while True:
        key = _get_string(f, path)
        if key == "HEADER_END":
            break
        if key in _INT_KEYS:
            val = struct.unpack(
                "<i", read_exact(f, 4, path, "SIGPROC header"))[0]
            if key == "nsamples":
                continue
            if hasattr(hdr, key):
                setattr(hdr, key, val)
        elif key in _DBL_KEYS:
            val = struct.unpack(
                "<d", read_exact(f, 8, path, "SIGPROC header"))[0]
            if hasattr(hdr, key):
                setattr(hdr, key, val)
        elif key in _STR_KEYS:
            setattr(hdr, key, _get_string(f, path))
        else:
            raise ValueError("unknown SIGPROC header key: %r" % key)
    hdr.headerlen = f.tell()
    if hdr.nchans <= 0 or hdr.nifs <= 0 or hdr.nbits <= 0:
        # corrupt header values would divide by zero below / poison
        # every downstream geometry computation
        raise PrestoIOError(
            "invalid SIGPROC geometry (nchans=%d nifs=%d nbits=%d)"
            % (hdr.nchans, hdr.nifs, hdr.nbits), path=path,
            kind="bad-header")
    try:
        pos = f.tell()
        f.seek(0, os.SEEK_END)
        filelen = f.tell()
        f.seek(pos)
        hdr.N = (filelen - hdr.headerlen) * 8 \
            // (hdr.nbits * hdr.nchans * hdr.nifs)
    except (OSError, io.UnsupportedOperation):
        # unseekable stream (live socket/pipe feed): the observation
        # length is unknown until EOF — N stays 0 and the streaming
        # consumer accounts spectra as they arrive
        hdr.N = 0
    return hdr


def unpack_bits(raw: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack 1/2/4-bit samples from a uint8 array; passthrough for >=8.

    Bit order parity: PRESTO unpacks most-significant-first within each
    byte (psrfits.c:828-866 convention).
    """
    if nbits == 8:
        return raw
    if nbits == 16:
        return raw.view(np.uint16)
    if nbits == 32:
        return raw.view(np.float32)
    if nbits == 4:
        out = np.empty(raw.size * 2, dtype=np.uint8)
        out[0::2] = raw >> 4
        out[1::2] = raw & 0x0F
        return out
    if nbits == 2:
        out = np.empty(raw.size * 4, dtype=np.uint8)
        for i, shift in enumerate((6, 4, 2, 0)):
            out[i::4] = (raw >> shift) & 0x03
        return out
    if nbits == 1:
        out = np.unpackbits(raw.reshape(-1, 1), axis=1, bitorder="big")
        return out.reshape(-1)
    raise ValueError("unsupported nbits=%d" % nbits)


def pack_bits(data: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of unpack_bits for writing packed .fil files."""
    if nbits == 8:
        return data.astype(np.uint8)
    if nbits == 16:
        return data.astype(np.uint16).view(np.uint8)
    if nbits == 32:
        return data.astype(np.float32).view(np.uint8)
    d = data.astype(np.uint8)
    if nbits == 4:
        return ((d[0::2] << 4) | (d[1::2] & 0x0F)).astype(np.uint8)
    if nbits == 2:
        out = np.zeros(d.size // 4, dtype=np.uint8)
        for i, shift in enumerate((6, 4, 2, 0)):
            out |= (d[i::4] & 0x03) << shift
        return out
    if nbits == 1:
        return np.packbits(d.reshape(-1, 8), axis=1, bitorder="big").ravel()
    raise ValueError("unsupported nbits=%d" % nbits)


def decode_spectra_numpy(hdr: FilterbankHeader, raw: np.ndarray,
                         nspec: int) -> np.ndarray:
    """Packed filterbank bytes -> [nspec, nchans] float32, channels in
    ASCENDING frequency order: numpy unpack + IF-sum + descending-band
    flip (the plain version of the native decoder)."""
    vals = unpack_bits(raw, hdr.nbits)
    arr = vals.astype(np.float32).reshape(nspec, hdr.nifs, hdr.nchans)
    arr = arr.sum(axis=1) if hdr.nifs > 1 else arr[:, 0, :]
    if hdr.foff < 0:
        arr = np.ascontiguousarray(arr[:, ::-1])
    return arr


def decode_spectra_block(hdr: FilterbankHeader, raw: np.ndarray,
                         nspec: int,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
    """Packed filterbank bytes -> [nspec, nchans] float32, channels in
    ASCENDING frequency order, written into ``out`` ([>= nspec, nchans],
    C-contiguous float32) when given.  The native decoder for 1/2/4/8-bit
    byte-aligned spectra, NumPy for the other widths."""
    if native.supports(hdr.nbits, hdr.nifs, hdr.nchans):
        return native.decode_spectra(raw, nspec, hdr.nifs, hdr.nchans,
                                     hdr.nbits, hdr.foff < 0, out=out)
    arr = decode_spectra_numpy(hdr, raw, nspec)
    if out is None:
        return arr
    out[:nspec] = arr
    return out[:nspec]


class FilterbankFile:
    """A SIGPROC .fil file with block reads in channel-ascending order.

    read_spectra() returns float32 [nsamp, nchans] with channels in
    ASCENDING frequency order (flipping if foff < 0), the order the
    dedispersion ops expect — the reference does the same flip inside
    its readers (get_filterbank_rawblock, sigproc_fb.c:419-).
    """

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        try:
            self.header = read_filterbank_header(self.f, path)
        except PrestoIOError:
            # already typed (truncated header): keep file/offset info
            self.f.close()
            raise
        except (ValueError, struct.error) as e:
            self.f.close()
            raise ValueError("%s is not a SIGPROC filterbank file (%s)"
                             % (path, e)) from None
        self.quality = DataQualityReport(path=path,
                                         nspectra=self.header.N,
                                         nchan=self.header.nchans)
        # the prefetching feeder's overlap counts of the last
        # stream_blocks pass (native.BlockFeeder.stats)
        self.feeder_stats = None

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def nspectra(self) -> int:
        return self.header.N

    @property
    def ptsperblk(self) -> int:
        """Spectra per "block" for interval sizing (rfifind -blocks).

        SIGPROC filterbanks are flat streams with no native block
        structure; the reference adopts 2400 spectra as the blocksize
        (sigproc_fb.c:388).
        """
        return 2400

    def read_spectra(self, start: int, count: int) -> np.ndarray:
        """Read `count` spectra starting at `start`; zero-pad past EOF.

        Short reads (the file shrank after open — a writer died or the
        volume went away) are quarantined: the missing tail is recorded
        in self.quality and zero-filled rather than crashing in the
        decoder's reshape.
        """
        hdr = self.header
        bps = hdr.bytes_per_spectrum
        self.f.seek(hdr.headerlen + start * bps)
        navail = max(0, min(count, hdr.N - start))
        raw = np.frombuffer(self.f.read(navail * bps), dtype=np.uint8)
        got = len(raw) // bps
        if got < navail:
            raw = raw[:got * bps]
            self.quality.add(start + got, start + navail, "short-read")
        arr = decode_spectra_block(hdr, raw, got)
        arr = self._scrub(arr, start, got)
        if got < count:
            pad = np.zeros((count - got, hdr.nchans), dtype=np.float32)
            arr = np.concatenate([arr, pad], axis=0)
        return np.ascontiguousarray(arr)

    def _scrub(self, arr: np.ndarray, start: int,
               nspec: int) -> np.ndarray:
        """Ingest quarantine on a decoded block: NaN/Inf samples are
        scrubbed to 0 (only 32-bit data can hold them) and long
        zero-fill runs recorded; both land in self.quality for the
        mask integration downstream."""
        if nspec == 0:
            return arr
        if self.header.nbits == 32:
            arr = scrub_nonfinite(arr, start, self.quality)
        record_zero_runs(arr[:nspec], start, self.quality)
        return arr

    def iter_blocks(self, block_size: int,
                    start: int = 0) -> Iterator[np.ndarray]:
        pos = start
        while pos < self.header.N:
            yield self.read_spectra(pos, block_size)
            pos += block_size

    def stream_blocks(self, block_size: int, start: int = 0,
                      out: Optional[Callable[[], np.ndarray]] = None
                      ) -> Iterator[np.ndarray]:
        """Sequential [block_size, nchans] float32 blocks (zero-padded
        final block), read through the native prefetching feeder so disk
        IO overlaps the consumer's compute (the INSTRUMENTOBJS
        double-buffer role, csrc/native_io.cpp); blocks of the widths
        the native decoder does not take come from read_spectra.

        ``out``, when given, is called once per block for the writable
        C-contiguous float32 [block_size, nchans] array to decode into
        (a pinned host buffer of the device feed); the block yielded is
        that array."""
        hdr = self.header
        bps = hdr.bytes_per_spectrum
        if not native.supports(hdr.nbits, hdr.nifs, hdr.nchans):
            for blk in self.iter_blocks(block_size, start):
                if out is not None:
                    buf = out()
                    buf[:] = blk
                    blk = buf
                yield blk
            return
        feeder = native.BlockFeeder(self.path,
                                    hdr.headerlen + start * bps,
                                    block_size * bps, nbuf=4)
        try:
            delivered = 0
            total = hdr.N - start
            for raw in feeder:
                nspec = min(len(raw) // bps, total - delivered)
                if nspec <= 0:
                    break
                buf = (out() if out is not None
                       else np.empty((block_size, hdr.nchans), np.float32))
                decode_spectra_block(hdr, raw[:nspec * bps], nspec,
                                     out=buf)
                self._scrub(buf[:nspec], start + delivered, nspec)
                buf[nspec:] = 0.0
                delivered += nspec
                yield buf
        finally:
            self.feeder_stats = feeder.stats()
            feeder.close()


class FilterbankSet:
    """Multiple .fil files presented as one time-contiguous observation
    (the reference reads multi-file observations the same way: all
    readers take N files and stitch them — read_filterbank_files,
    sigproc_fb.c:338; the multifiles virtual-file idea, multifiles.c).

    Files are ordered by start MJD; headers must agree on nchans/tsamp/
    foff/nbits, or the set raises.  The files are concatenated: a gap
    between them is NOT padded (the reference pads via start_spec
    bookkeeping), as in the JAX package.
    """

    def __init__(self, paths):
        if isinstance(paths, str):
            paths = [paths]
        self.files = [FilterbankFile(p) for p in paths]
        self.files.sort(key=lambda fb: fb.header.tstart)
        h0 = self.files[0].header
        for fb in self.files[1:]:
            h = fb.header
            if (h.nchans != h0.nchans or h.nbits != h0.nbits
                    or abs(h.tsamp - h0.tsamp) > 1e-12
                    or abs(h.foff - h0.foff) > 1e-9):
                self.close()
                raise ValueError("filterbank files disagree: %s vs %s"
                                 % (fb.path, self.files[0].path))
        self.header = copy.copy(h0)
        self.header.N = sum(fb.header.N for fb in self.files)
        self.path = self.files[0].path
        # absolute starting spectrum of each file within the set
        self._starts = np.cumsum(
            [0] + [fb.header.N for fb in self.files[:-1]])

    @property
    def quality(self) -> DataQualityReport:
        """Merged member-file quarantine ledgers, shifted to the
        stitched observation's spectrum indices."""
        out = DataQualityReport(path=self.path,
                                nspectra=int(self.header.N),
                                nchan=self.header.nchans)
        for fb, start in zip(self.files, self._starts):
            out.scrubbed_samples += fb.quality.scrubbed_samples
            for iv in fb.quality.intervals:
                out.add(iv.start + int(start), iv.stop + int(start),
                        iv.reason)
        return out

    def close(self):
        for fb in self.files:
            fb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def nspectra(self) -> int:
        return self.header.N

    @property
    def ptsperblk(self) -> int:
        return 2400              # see FilterbankFile.ptsperblk

    def read_spectra(self, start: int, count: int) -> np.ndarray:
        out = np.zeros((count, self.header.nchans), dtype=np.float32)
        got = 0
        while got < count:
            pos = start + got
            i = int(np.searchsorted(self._starts, pos, side="right")) - 1
            if i >= len(self.files):
                break
            fb = self.files[i]
            local = pos - int(self._starts[i])
            if local >= fb.header.N:
                break             # past the last file: stay zero-padded
            n = min(count - got, fb.header.N - local)
            out[got:got + n] = fb.read_spectra(local, n)
            got += n
        return out

    def iter_blocks(self, block_size: int,
                    start: int = 0) -> Iterator[np.ndarray]:
        pos = start
        while pos < self.header.N:
            yield self.read_spectra(pos, block_size)
            pos += block_size


def write_filterbank(path: str, hdr: FilterbankHeader,
                     data: np.ndarray) -> None:
    """Write [nsamp, nchans] data (ascending freq) to a .fil file.

    If hdr.foff < 0 the channel axis is flipped to descending order on
    disk, matching standard SIGPROC convention.
    """
    from presto_tpu_torch.io.atomic import atomic_open
    arr = data
    if hdr.foff < 0:
        arr = arr[:, ::-1]
    with atomic_open(path, "wb") as f:
        write_filterbank_header(hdr, f)
        packed = pack_bits(np.ascontiguousarray(arr).ravel(), hdr.nbits)
        f.write(packed.tobytes())
