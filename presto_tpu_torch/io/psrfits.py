"""PSRFITS search-mode reader (+ synthesizer for tests/converters).

Host copy of ``presto_tpu/io/psrfits.py`` for the PyTorch port, which
imports nothing from the JAX package.  Reference: src/psrfits.c.
Semantics reproduced:
  - primary-HDU observation metadata + SUBINT-HDU geometry
    (read_PSRFITS_files, psrfits.c:103-660): TBIN/NCHAN/NPOL/NSBLK/
    NBITS/NAXIS2/NSUBOFFS, ZERO_OFF, CHAN_DM, DAT_FREQ-derived band
    orientation (flip ascending bands to PRESTO's descending layout),
    start-time stitching of multiple files via STT_*MJD + OFFS_SUB
  - dropped/missing subint detection via OFFS_SUB discrepancy with
    per-channel padding (get_PSRFITS_rawblock, psrfits.c:663-786)
  - 1/2/4/8/16/32-bit sample unpack (psrfits.c:828-866)
  - DAT_SCL/DAT_OFFS/DAT_WTS application with ZERO_OFF
    (psrfits.c:899-908) and polarization summing (AABB/2-pol) or
    selection (psrfits.c:887-...)

A subint of 1/2/4/8-bit byte-aligned samples is decoded by the native
library (io/native.decode_subint, csrc/native_io.cpp); there is no
fallback, so a library that cannot be built or loaded raises.  16- and
32-bit rows, which the native decoder does not take, are decoded by
decode_row_numpy, the plain version the tests hold the native decoder
against.  Unlike the JAX package, the files of a multi-file set must
agree on TBIN, NCHAN, NPOL, NSBLK, NBITS and the channel spacing, or
the reader raises.

The class exposes the FilterbankFile protocol (header/read_spectra/
nspectra) with frequency-ascending [n, nchan] float32 blocks, so every
app's reader dispatch works on PSRFITS unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from presto_tpu_torch.io import native
from presto_tpu_torch.io.errors import PrestoIOError
from presto_tpu_torch.io.fitsio import FitsFile, write_fits
from presto_tpu_torch.io.quality import (DataQualityReport,
                                         record_zero_runs, scrub_nonfinite)
from presto_tpu_torch.io.sigproc import FilterbankHeader

SECPERDAY = 86400.0


def _ra_str_to_sigproc(s) -> float:
    """RA string ('hh:mm:ss.s', 'hh mm ss.s', or numeric hours) ->
    SIGPROC packed hhmmss.s — via the shared coordinate parser
    (astro/bary.parse_ra) instead of a third hand-rolled split."""
    from presto_tpu_torch.astro.bary import parse_ra
    from presto_tpu_torch.utils.psr import rad_to_hms
    try:
        if isinstance(s, str) and ":" not in s and " " not in s.strip():
            # Bare number in a string: hours by convention — but some
            # PSRFITS writers store decimal DEGREES here.  Values
            # >= 24 cannot be hours: treat as degrees (ADVICE r4);
            # the ambiguous 0-24 range stays hours (documented
            # convention), values in it are wrong by 15x only for
            # degree-writing sources within 24 deg of RA 0.
            v = float(s)
            rad = v * np.pi / (12.0 if abs(v) < 24.0 else 180.0)
        else:
            rad = parse_ra(s)
    except (ValueError, IndexError, TypeError):
        return 0.0
    h, m, sec = rad_to_hms(rad)
    return h * 10000.0 + m * 100.0 + sec


def _dec_str_to_sigproc(s) -> float:
    """DEC string ('[+-]dd:mm:ss.s', spaces, or numeric degrees) ->
    SIGPROC packed [+-]ddmmss.s."""
    from presto_tpu_torch.astro.bary import parse_dec
    from presto_tpu_torch.utils.psr import rad_to_dms
    try:
        if isinstance(s, str) and ":" not in s and " " not in s.strip():
            rad = float(s) * np.pi / 180.0
        else:
            rad = parse_dec(s)
    except (ValueError, IndexError, TypeError):
        return 0.0
    d, m, sec = rad_to_dms(rad)
    sign = -1.0 if d < 0 or (d == 0 and rad < 0) else 1.0
    return sign * (abs(d) * 10000.0 + m * 100.0 + sec)


def unpack_samples(raw: np.ndarray, nbits: int) -> np.ndarray:
    """Packed big-endian-bit samples -> uint8/uint16/etc array.
    Vectorized analog of the unpack loops (psrfits.c:828-866)."""
    raw = np.asarray(raw, np.uint8)
    if nbits == 8:
        return raw
    if nbits == 4:
        out = np.empty(raw.size * 2, np.uint8)
        out[0::2] = raw >> 4
        out[1::2] = raw & 0x0F
        return out
    if nbits == 2:
        out = np.empty(raw.size * 4, np.uint8)
        for i, sh in enumerate((6, 4, 2, 0)):
            out[i::4] = (raw >> sh) & 0x03
        return out
    if nbits == 1:
        return np.unpackbits(raw)
    if nbits == 16:
        return raw.view(">i2").astype(np.int32)
    if nbits == 32:
        return raw.view(">f4").astype(np.float32)
    raise ValueError("unsupported NBITS=%d" % nbits)


def decode_row_numpy(raw: np.ndarray, nspec: int, npol: int, nchan: int,
                     nbits: int, zero_off: float,
                     scl: Optional[np.ndarray], offs: Optional[np.ndarray],
                     wts: Optional[np.ndarray], pol_mode: int,
                     flip: bool) -> np.ndarray:
    """One subint's DATA bytes -> [nspec, nchan] float32, ascending
    frequency when ``flip``: the JAX package's NumPy row decode, with
    io/native.decode_subint's arguments (scl/offs [npol*nchan], wts
    [nchan], each None when not applied; pol_mode >= 0 selects that pol,
    -2 sums the first two).  The decoder of 16- and 32-bit rows and the
    plain version of the native one."""
    data = np.asarray(unpack_samples(raw, nbits), np.float32).reshape(
        nspec, npol, nchan)
    if npol > 1:
        if pol_mode >= 0:
            data = data[:, pol_mode:pol_mode + 1, :]
            polsl = slice(pol_mode * nchan, (pol_mode + 1) * nchan)
        else:                                  # -2: sum AA+BB
            data = data[:, :2, :]
            polsl = slice(0, 2 * nchan)
    else:
        polsl = slice(0, nchan)
    data = data - zero_off
    if scl is not None or offs is not None:
        if scl is None:
            scl = np.ones(nchan * npol, np.float32)
        if offs is None:
            offs = np.zeros(nchan * npol, np.float32)
        npol_used = data.shape[1]
        scl = np.asarray(scl, np.float32)[polsl].reshape(npol_used, nchan)
        offs = np.asarray(offs, np.float32)[polsl].reshape(npol_used, nchan)
        data = data * scl[None] + offs[None]
    if data.shape[1] > 1:
        data = data.sum(axis=1, keepdims=True)
    data = data[:, 0, :]
    if wts is not None:
        data = data * np.asarray(wts, np.float32)[None, :]
    if flip:
        data = data[:, ::-1]      # present ascending
    return np.ascontiguousarray(data, dtype=np.float32)


@dataclass
class PsrfitsMeta:
    """Per-file SUBINT geometry (spectra_info analog for one file)."""
    path: str
    nsubint: int
    start_subint: int        # rows missing before this file's first row
    start_spec: int          # spectrum index of first row rel. to obs
    start_mjd: float


class PsrfitsFile:
    """One or more PSRFITS files as a contiguous observation."""

    def __init__(self, paths, apply_weight: Optional[bool] = None,
                 apply_scale: Optional[bool] = None,
                 apply_offset: Optional[bool] = None,
                 use_poln: int = 0):
        if isinstance(paths, str):
            paths = [paths]
        self.paths = list(paths)
        self.files: List[FitsFile] = []
        self.meta: List[PsrfitsMeta] = []
        self.use_poln = use_poln
        try:
            self._open_all()
        except (KeyError, TypeError) as e:
            # a missing HDU/column (SUBINT, TBIN, DATA...) or a card
            # whose value rotted to the wrong type is file corruption,
            # not a dict bug: surface it typed
            self.close()
            raise PrestoIOError(
                "missing/corrupt PSRFITS structure: %s" % e,
                path=self.paths[0], kind="bad-header") from None
        except BaseException:
            self.close()
            raise
        self._auto_scaling(apply_weight, apply_scale, apply_offset)
        self._cache_row = (None, None)
        self._init_quality()

    # -- setup --------------------------------------------------------
    def _open_all(self):
        first = True
        for path in self.paths:
            ff = FitsFile(path)
            self.files.append(ff)
            pri = ff.primary
            sub = ff.hdu("SUBINT")
            h = sub.header
            if first:
                obs_mode = str(pri.get("OBS_MODE", "SEARCH")).strip()
                if obs_mode == "SRCH":        # Parkes DFB quirk
                    obs_mode = "SEARCH"
                if obs_mode != "SEARCH":
                    raise ValueError("%s is not SEARCH-mode PSRFITS"
                                     % path)
                self.dt = float(h["TBIN"])
                self.nchan = int(h["NCHAN"])
                self.npol = int(h.get("NPOL", 1))
                self.poln_order = str(h.get("POL_TYPE", "AA+BB")).strip()
                self.nsblk = int(h["NSBLK"])
                self.nbits = int(h.get("NBITS", 8))
                if (self.nchan <= 0 or self.nsblk <= 0
                        or self.dt <= 0.0
                        or self.nbits not in (1, 2, 4, 8, 16, 32)):
                    raise PrestoIOError(
                        "invalid SUBINT geometry (NCHAN=%d NSBLK=%d "
                        "TBIN=%g NBITS=%d)" % (self.nchan, self.nsblk,
                                               self.dt, self.nbits),
                        path=path, kind="bad-header")
                self.zero_offset = abs(float(h.get("ZERO_OFF", 0.0) or 0.0))
                self.chan_dm = float(pri.get("CHAN_DM", 0.0) or 0.0)
                self.source = str(pri.get("SRC_NAME", "")).strip()
                self.telescope = str(pri.get("TELESCOP", "")).strip()
                self.ra_str = str(pri.get("RA", "")).strip()
                self.dec_str = str(pri.get("DEC", "")).strip()
                freqs = np.asarray(sub.read_col("DAT_FREQ", 0),
                                   np.float64)
                if len(freqs) >= 2:
                    self.df = float(freqs[1] - freqs[0])
                else:
                    self.df = float(pri.get("OBSBW", 1.0)) / self.nchan
                self.freqs = freqs
                self.fctr = float(pri.get("OBSFREQ",
                                          freqs.mean() if len(freqs)
                                          else 0.0))
            else:
                self._check_agrees(ff, path)
            imjd = int(pri.get("STT_IMJD", 55000))
            smjd = int(pri.get("STT_SMJD", 0))
            offs = float(pri.get("STT_OFFS", 0.0) or 0.0)
            start_mjd = imjd + (smjd + offs) / SECPERDAY
            nsub = sub.naxis2
            nsuboffs = int(h.get("NSUBOFFS", 0) or 0)
            tsub = self.dt * self.nsblk
            # OFFS_SUB of row 1 overrides NSUBOFFS (psrfits.c:253-287)
            offs_sub0 = float(sub.read_col("OFFS_SUB", 0)[0])
            if offs_sub0 != 0.0:
                # ROUND like the row-grid snap in _row_start_spec so
                # negative OFFS_SUB drift on a leading dropped row
                # cannot place the file origin one subint early
                numrows = int(round((offs_sub0 - 0.5 * tsub) / tsub))
                start_subint = numrows
                self._offs_sub_zero = False
            else:
                start_subint = nsuboffs
                self._offs_sub_zero = True
            start_mjd += (tsub * start_subint) / SECPERDAY
            if first:
                start_spec = 0
                self.start_mjd = start_mjd
            else:
                dmjd = start_mjd - self.meta[0].start_mjd
                if dmjd < 0:
                    raise ValueError("PSRFITS files out of time order")
                start_spec = int(round(dmjd * SECPERDAY / self.dt))
            self.meta.append(PsrfitsMeta(
                path=path, nsubint=nsub, start_subint=start_subint,
                start_spec=start_spec, start_mjd=start_mjd))
            first = False
        # Cache every row's absolute start spectrum once (one pass per
        # file) so read_spectra can binary-search instead of re-reading
        # OFFS_SUB per row per call (O(nsubint * nblocks) otherwise).
        self._row_specs = []
        for fi, m in enumerate(self.meta):
            self._row_specs.append(np.asarray(
                [self._row_start_spec_uncached(fi, r)
                 for r in range(m.nsubint)], dtype=np.int64))
        last = self.meta[-1]
        self.N = last.start_spec + self._last_spec_of(len(self.meta) - 1)
        self.padvals = np.zeros(self.nchan, np.float32)

    def _check_agrees(self, ff: FitsFile, path: str) -> None:
        """A later file of the set must have the first file's sample
        time, channels, polarizations, subint length, sample width and
        channel spacing: the set is decoded with the first's geometry."""
        sub = ff.hdu("SUBINT")
        h = sub.header
        freqs = np.asarray(sub.read_col("DAT_FREQ", 0), np.float64)
        df = float(freqs[1] - freqs[0]) if len(freqs) >= 2 else self.df
        if (abs(float(h["TBIN"]) - self.dt) > 1e-12
                or int(h["NCHAN"]) != self.nchan
                or int(h.get("NPOL", 1)) != self.npol
                or int(h["NSBLK"]) != self.nsblk
                or int(h.get("NBITS", 8)) != self.nbits
                or abs(df - self.df) > 1e-9):
            raise ValueError("PSRFITS files disagree: %s vs %s"
                             % (path, self.paths[0]))

    def _init_quality(self) -> None:
        """Build the quarantine ledger; pad gaps the row geometry
        already implies (dropped subints, inter-file holes) are
        recorded up front so the report is complete even before any
        data is read."""
        self.quality = DataQualityReport(path=self.paths[0],
                                         nspectra=int(self.N),
                                         nchan=self.nchan)
        covered = sorted((int(s), int(s) + self.nsblk)
                         for specs in self._row_specs for s in specs)
        pos = 0
        for lo, hi in covered:
            if lo > pos:
                self.quality.add(pos, lo, "dropped-rows")
            pos = max(pos, hi)

    def _last_spec_of(self, fi: int) -> int:
        """Spectrum index just past file fi's last row (rel. to file
        start), honoring OFFS_SUB row positions."""
        ff, m = self.files[fi], self.meta[fi]
        sub = ff.hdu("SUBINT")
        row_spec = self._row_start_spec(fi, m.nsubint - 1) - m.start_spec
        return row_spec + self.nsblk

    def _auto_scaling(self, w, s, o):
        """Default scale/offset/weight policy: apply when non-trivial
        (the reference asks the user; auto-detection is kinder)."""
        sub = self.files[0].hdu("SUBINT")
        try:
            scales = sub.read_col("DAT_SCL", 0)
            offsets = sub.read_col("DAT_OFFS", 0)
            weights = sub.read_col("DAT_WTS", 0)
            self.apply_scale = bool(np.any(scales != 1.0)) if s is None \
                else s
            self.apply_offset = bool(np.any(offsets != 0.0)) if o is None \
                else o
            self.apply_weight = bool(np.any(weights != 1.0)) if w is None \
                else w
        except KeyError:
            self.apply_scale = self.apply_offset = self.apply_weight = \
                False

    # -- FilterbankFile protocol --------------------------------------
    @property
    def header(self) -> FilterbankHeader:
        # read_spectra always presents ascending frequency, so the
        # header describes the band with fch1 = lowest center, foff > 0
        # (same convention FilterbankFile ends up with post-flip).
        return FilterbankHeader(
            source_name=self.source or "Unknown",
            nchans=self.nchan, nbits=self.nbits,
            fch1=float(self.freqs.min()), foff=abs(self.df),
            tsamp=self.dt, tstart=float(self.start_mjd),
            src_raj=_ra_str_to_sigproc(getattr(self, "ra_str", "")),
            src_dej=_dec_str_to_sigproc(getattr(self, "dec_str", "")),
            nifs=1, N=int(self.N))

    @property
    def nspectra(self) -> int:
        return int(self.N)

    @property
    def ptsperblk(self) -> int:
        """Spectra per block = spectra per subint (rfifind.c:214)."""
        return int(self.nsblk)

    def close(self):
        for f in self.files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- row geometry -------------------------------------------------
    def _row_start_spec_uncached(self, fi: int, row: int) -> int:
        """Absolute starting spectrum of (file, row), via OFFS_SUB when
        present (get_PSRFITS_rawblock, psrfits.c:690-705)."""
        m = self.meta[fi]
        sub = self.files[fi].hdu("SUBINT")
        tsub = self.dt * self.nsblk
        if self._offs_sub_zero:
            return m.start_spec + row * self.nsblk
        offs_sub = float(sub.read_col("OFFS_SUB", row)[0])
        rel = (offs_sub - (m.start_subint + 0.5) * tsub) / self.dt
        # snap to the row grid: the reference counts dropped blocks as
        # round(OFFS_SUB gap / TSUBINT) (psrfits.c:741-768), so
        # OFFS_SUB rounding drift (fractions of a row) must NOT
        # scatter rows off the nsblk grid and leave phantom pad gaps
        return m.start_spec + self.nsblk * int(round(rel / self.nsblk))

    def _row_start_spec(self, fi: int, row: int) -> int:
        if hasattr(self, "_row_specs"):
            return int(self._row_specs[fi][row])
        return self._row_start_spec_uncached(fi, row)

    # -- decoding -----------------------------------------------------
    def _pol_mode(self) -> int:
        """Polarization handling shared by the native and NumPy decoders:
        >=0 select that pol, -2 sum the first two (AA+BB)."""
        if self.npol == 1:
            return 0
        sum_polns = (self.poln_order.startswith("AABB")
                     or self.npol == 2)
        if self.use_poln > 0 or (self.npol > 2 and not sum_polns):
            return max(self.use_poln - 1, 0)
        return -2

    def _row_scaling(self, sub, row: int):
        """(DAT_SCL, DAT_OFFS, DAT_WTS) of one row as float32, each None
        when it is not applied."""
        scl = offs = wts = None
        if self.apply_scale:
            scl = np.asarray(sub.read_col("DAT_SCL", row), np.float32)
        if self.apply_offset:
            offs = np.asarray(sub.read_col("DAT_OFFS", row), np.float32)
        if self.apply_weight:
            wts = np.asarray(sub.read_col("DAT_WTS", row), np.float32)
        return scl, offs, wts

    def _decode_row(self, fi: int, row: int) -> np.ndarray:
        """One subint -> [nsblk, nchan] float32 (ascending freq): the
        native decoder for 1/2/4/8-bit byte-aligned rows (it raises when
        its library cannot be built or loaded), decode_row_numpy for 16
        and 32 bits."""
        if self._cache_row[0] == (fi, row):
            return self._cache_row[1]
        sub = self.files[fi].hdu("SUBINT")
        raw = sub.read_col_raw_bytes("DATA", row)
        scl, offs, wts = self._row_scaling(sub, row)
        decode = (native.decode_subint
                  if native.supports(self.nbits, self.npol, self.nchan)
                  else decode_row_numpy)
        out = decode(raw, self.nsblk, self.npol, self.nchan, self.nbits,
                     self.zero_offset, scl, offs, wts, self._pol_mode(),
                     self.df < 0)
        out = self._scrub_row(out, fi, row)
        self._cache_row = ((fi, row), out)
        return out

    def _scrub_row(self, data: np.ndarray, fi: int,
                   row: int) -> np.ndarray:
        """Ingest quarantine on one decoded subint: NaN/Inf samples
        (32-bit data, or poisoned DAT_SCL/DAT_OFFS/DAT_WTS) scrub to
        0 and long zero-fill runs are recorded — both become mask
        entries downstream instead of exceptions or silent garbage."""
        start = self._row_start_spec(fi, row)
        data = scrub_nonfinite(data, start, self.quality)
        record_zero_runs(data, start, self.quality)
        return data

    def read_spectra(self, start: int, count: int) -> np.ndarray:
        """[count, nchan] float32, ascending frequency; gaps (dropped
        rows, inter-file gaps, reads past EOF) fill with padvals."""
        out = np.empty((count, self.nchan), np.float32)
        out[:] = self.padvals[None, :]
        want_lo, want_hi = start, start + count
        for fi, m in enumerate(self.meta):
            specs = self._row_specs[fi]
            # only rows whose window can intersect [want_lo, want_hi)
            r0 = int(np.searchsorted(specs, want_lo - self.nsblk,
                                     side="right"))
            r1 = int(np.searchsorted(specs, want_hi, side="left"))
            for row in range(r0, r1):
                row_lo = int(specs[row])
                row_hi = row_lo + self.nsblk
                if row_hi <= want_lo or row_lo >= want_hi:
                    continue
                data = self._decode_row(fi, row)
                lo = max(row_lo, want_lo)
                hi = min(row_hi, want_hi)
                out[lo - start:hi - start] = data[lo - row_lo:hi - row_lo]
        return out

    def iter_blocks(self, block_size: int):
        for start in range(0, int(self.N), block_size):
            n = min(block_size, int(self.N) - start)
            yield start, self.read_spectra(start, n)


# ----------------------------------------------------------------------
# Synthesis (test corpus + converter source)
# ----------------------------------------------------------------------

def write_psrfits(path: str, data: np.ndarray, dt: float,
                  freqs: np.ndarray, nsblk: int = 256,
                  nbits: int = 8, npol: int = 1,
                  start_mjd: float = 55555.0,
                  scales: Optional[np.ndarray] = None,
                  offsets: Optional[np.ndarray] = None,
                  weights: Optional[np.ndarray] = None,
                  zero_off: float = 0.0,
                  drop_rows: Sequence[int] = (),
                  offs_jitter: float = 0.0,
                  src_name: str = "FAKE") -> None:
    """Write a SEARCH-mode PSRFITS file.

    data: [nspectra, nchan] float (will be quantized to nbits);
    freqs: [nchan] channel centers (MHz), ascending or descending;
    drop_rows: subint indices to OMIT (their OFFS_SUB gap simulates
    dropped blocks, the psrfits.c:741-768 test case);
    offs_jitter: deterministic alternating OFFS_SUB error in SAMPLES
    (real backends accumulate rounding drift; readers must snap to the
    row grid rather than see phantom gaps).
    """
    nspec, nchan = data.shape
    nsub = (nspec + nsblk - 1) // nsblk
    tsub = dt * nsblk
    if scales is None:
        scales = np.ones(nchan * npol, np.float32)
    if offsets is None:
        offsets = np.zeros(nchan * npol, np.float32)
    if weights is None:
        weights = np.ones(nchan, np.float32)

    nsamp_row = nsblk * npol * nchan
    rows = []
    for isub in range(nsub):
        if isub in drop_rows:
            continue
        chunk = np.zeros((nsblk, nchan), np.float32)
        have = data[isub * nsblk:(isub + 1) * nsblk]
        chunk[:len(have)] = have
        # invert the scaling the reader will apply
        q = (chunk - offsets[None, :nchan]) / \
            np.where(scales[None, :nchan] == 0, 1, scales[None, :nchan]) \
            + zero_off
        if nbits == 32:
            samples = q.astype(">f4").tobytes()
        elif nbits == 16:
            samples = np.clip(np.round(q), -32768,
                              32767).astype(">i2").tobytes()
        else:
            maxval = (1 << nbits) - 1
            qq = np.clip(np.round(q), 0, maxval).astype(np.uint8)
            if npol > 1:
                qq = np.repeat(qq[:, None, :], npol, axis=1)
            flat = qq.ravel()
            if nbits == 8:
                samples = flat.tobytes()
            elif nbits == 4:
                samples = ((flat[0::2] << 4) | flat[1::2]).tobytes()
            elif nbits == 2:
                samples = (flat[0::4] << 6 | flat[1::4] << 4
                           | flat[2::4] << 2 | flat[3::4]).tobytes()
            elif nbits == 1:
                samples = np.packbits(flat).tobytes()
            else:
                raise ValueError(nbits)
        jit = offs_jitter * dt * (1 if isub % 2 else -1)
        rows.append({
            "TSUBINT": np.float64(tsub),
            "OFFS_SUB": np.float64((isub + 0.5) * tsub + jit),
            "DAT_FREQ": np.asarray(freqs, np.float64),
            "DAT_WTS": np.asarray(weights, np.float32),
            "DAT_OFFS": np.asarray(offsets, np.float32),
            "DAT_SCL": np.asarray(scales, np.float32),
            "DATA": np.frombuffer(samples, np.uint8),
        })

    databytes = nsamp_row * nbits // 8
    imjd = int(start_mjd)
    smjd = int((start_mjd - imjd) * SECPERDAY)
    soffs = (start_mjd - imjd) * SECPERDAY - smjd
    primary = [
        ("OBS_MODE", "SEARCH"), ("TELESCOP", "FAKE_SCOPE"),
        ("OBSERVER", "presto_tpu"), ("SRC_NAME", src_name),
        ("FRONTEND", "synth"), ("BACKEND", "synth"),
        ("PROJID", "TEST"), ("DATE-OBS", "2020-01-01T00:00:00"),
        ("FD_POLN", "LIN"), ("RA", "00:00:00.0"),
        ("DEC", "00:00:00.0"),
        ("OBSFREQ", float(np.mean(freqs))),
        ("OBSNCHAN", nchan),
        ("OBSBW", float(freqs[-1] - freqs[0]) + 0.0),
        ("CHAN_DM", 0.0), ("BMIN", 0.1),
        ("STT_IMJD", imjd), ("STT_SMJD", smjd), ("STT_OFFS", soffs),
        ("TRK_MODE", "TRACK"),
    ]
    cards = [
        ("TBIN", dt), ("NCHAN", nchan), ("NPOL", npol),
        ("POL_TYPE", "AA+BB" if npol > 1 else "AA"),
        ("NCHNOFFS", 0), ("NSBLK", nsblk), ("NBITS", nbits),
        ("NSUBOFFS", 0), ("ZERO_OFF", zero_off),
    ]
    columns = [
        ("TSUBINT", "1D", "s"), ("OFFS_SUB", "1D", "s"),
        ("DAT_FREQ", "%dD" % nchan, "MHz"),
        ("DAT_WTS", "%dE" % nchan, ""),
        ("DAT_OFFS", "%dE" % (nchan * npol), ""),
        ("DAT_SCL", "%dE" % (nchan * npol), ""),
        ("DATA", "%dB" % databytes, "Jy"),
    ]
    write_fits(path, primary, [{
        "extname": "SUBINT", "cards": cards, "columns": columns,
        "rows": rows}])
