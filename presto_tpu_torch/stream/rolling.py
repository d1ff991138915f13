"""Rolling dedispersion + incremental single-pulse triggering.

The port of ``presto_tpu/stream/rolling.py``.  The dedispersion carry
lives on the device (CUDA unless the caller passes device="cpu"; no CUDA
device raises): each raw block is staged in a pinned buffer and uploaded
(pipeline/fusion.UploadRing), and the previous raw and subband blocks
stay resident on the card between blocks.  The per-trial single-pulse
searches run on the same device.

The online composition of two existing engines:

  * ops/dedispersion's explicit two-block carry
    (dedisp_subbands_block -> float_dedisp_many_block), driven block
    by block exactly like apps/prepsubband's streaming loop — same
    delay plan (apps.prepsubband.plan_delays), same priming, same two
    zero flush blocks, same valid-length trim.  Because every output
    sample's accumulation order is channel-then-subband ascending
    regardless of where block boundaries fall, the dedispersed series
    is byte-identical to the batch driver's whatever block length the
    live feed uses.
  * search/singlepulse's incremental carry (SinglePulseStream), one
    per DM trial, fed only *valid* dedispersed samples: the last
    `maxd` samples are held back until newer raw data proves them
    uncontaminated by flush padding — the streaming analog of the
    batch driver trimming to (N - maxd) before writing .dat files.

Candidates across the DM fan-out are deduplicated into *triggers*: a
physical pulse peaks in several adjacent DM trials and boxcar widths,
so finalized candidates are clustered by arrival time and the
strongest candidate of each cluster is emitted exactly once.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.pipeline.fusion import UploadRing
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.search.singlepulse import (SinglePulseSearch,
                                                 SinglePulseStream,
                                                 SPCandidate)


@dataclass
class StreamConfig:
    """Streaming search parameters (wire-safe plain values)."""
    lodm: float = 0.0
    dmstep: float = 1.0
    numdms: int = 8
    nsub: int = 32
    downsamp: int = 1
    subdm: Optional[float] = None
    #: spectra per ring block; None resolves via
    #: apps.common.stream_blocklen (the batch streaming bound)
    blocklen: Optional[int] = None
    threshold: float = 6.0
    #: matched-filter geometry: smaller chunks than the batch default
    #: (8000/8192) bound the trigger holdback — a chunk is searchable
    #: only one whole chunk behind the normalization frontier
    chunklen: int = 1920
    fftlen: int = 2048
    detrendlen: int = 1000
    topk: int = 256
    max_pulse_width_s: float = 0.0       # 0 -> MAX_DOWNFACT bin cap
    #: candidates within this many seconds of an emitted trigger are
    #: the same physical event (adjacent DM trials / widths)
    trigger_dedup_s: float = 0.25
    #: ring capacity (blocks) and overload policy
    ring_capacity: int = 16
    ring_policy: str = "drop-oldest"
    #: socket read timeout that converts a producer stall into
    #: quarantined zero fill (None = wait forever)
    stall_timeout_s: Optional[float] = None


@dataclass
class Trigger:
    """One emitted single-pulse trigger (the deduplicated event).
    `time` is the pulse's top-of-band arrival (per-trial dispersion
    offset added back), directly comparable across DM trials."""
    time: float                 # top-of-band arrival, s from start
    dm: float
    sigma: float
    downfact: int
    bin: int                    # downsampled dedispersed sample index
    members: int = 1            # candidates merged into this trigger
    latency_s: float = 0.0      # sample-arrival -> trigger-emitted

    def to_json(self) -> dict:
        return {"time": round(self.time, 6), "dm": self.dm,
                "sigma": round(float(self.sigma), 3),
                "downfact": int(self.downfact), "bin": int(self.bin),
                "members": int(self.members),
                "latency_s": round(self.latency_s, 4)}


class RollingDedisp:
    """The two-block dedispersion carry as an object, resident on
    ``device``.

    feed() mirrors one iteration of the batch streaming loop
    (apps/prepsubband.run): block j primes the raw carry, j+1 primes
    the subband carry, every later block yields one dedispersed
    series block covering the window two blocks back.  flush() pushes
    the batch driver's two zero blocks through the carry.  The step is
    ops/dedispersion's block functions, so the series bytes equal
    prepsubband's .dat whatever the block length.  Blocks may carry
    leading axes ([beams, blocklen, nchan]: the stacked multibeam carry
    of stream/beams.py), the same ops running over them.
    """

    def __init__(self, chan_bins: np.ndarray, dm_bins: np.ndarray,
                 nsub: int, downsamp: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.nsub = int(nsub)
        self.downsamp = int(downsamp)
        self._chan_bins = dd._as_delays(chan_bins, self.device)
        self._dm_bins = dd._as_delays(dm_bins, self.device)
        self._ring: Optional[UploadRing] = None
        self._prev_raw = None
        self._prev_sub = None
        self.blocks_in = 0

    def _upload(self, block_tc: np.ndarray):
        """[..., blocklen, nchan] host block -> [..., nchan, blocklen]
        on the device, through a pinned staging buffer refilled only
        after its previous upload completed."""
        if self._ring is None:
            *lead, blocklen, nchan = block_tc.shape
            self._ring = UploadRing(2, blocklen, nchan, self.device,
                                    lead=tuple(lead))
        i = self._ring.acquire()
        self._ring.array(i)[...] = block_tc
        return self._ring.upload(i)

    def step(self, prev_raw, cur, prev_sub):
        """One carry step on device tensors: (subband block, series
        block [..., numdms, blocklen // downsamp])."""
        sub = dd.dedisp_subbands_block(prev_raw, cur, self._chan_bins,
                                       self.nsub)
        series = dd.float_dedisp_many_block(prev_sub, sub, self._dm_bins)
        return sub, dd.downsample_block(series, self.downsamp)

    def feed(self, block_tc: np.ndarray) -> Optional[np.ndarray]:
        """block_tc: [..., blocklen, nchan] float32 ascending.  Returns
        the next [..., numdms, blocklen // downsamp] series block
        (host), or None while the carry is still priming."""
        cur = self._upload(block_tc)
        out = None
        if self._prev_raw is not None:
            if self._prev_sub is None:
                self._prev_sub = dd.dedisp_subbands_block(
                    self._prev_raw, cur, self._chan_bins, self.nsub)
            else:
                self._prev_sub, series = self.step(self._prev_raw, cur,
                                                   self._prev_sub)
                out = series.cpu().numpy()
        self._prev_raw = cur
        self.blocks_in += 1
        return out

    def flush(self, blocklen: int, nchan: int) -> List[np.ndarray]:
        """The batch loop's two zero flush blocks: drains the carry,
        returning the final series blocks."""
        outs = []
        lead = () if self._ring is None else \
            self._ring.array(0).shape[:-2]
        zero = np.zeros(lead + (blocklen, nchan), np.float32)
        for _ in range(2):
            out = self.feed(zero)
            if out is not None:
                outs.append(out)
        return outs


def plan_stream(hdr, cfg: StreamConfig):
    """DM-grid delay plan for a live header — the SAME plan the batch
    prepsubband builds (apps.prepsubband.plan_delays), so the rolling
    series is comparable byte-for-byte."""
    from presto_tpu_torch.apps.prepsubband import plan_delays
    args = SimpleNamespace(lodm=cfg.lodm, dmstep=cfg.dmstep,
                           numdms=cfg.numdms, nsub=cfg.nsub,
                           subdm=cfg.subdm)
    # the port's plan_delays is topocentric only (it has no avgvoverc:
    # barycentring is refused); the JAX stream passes avgvoverc=0.0,
    # which is the same topocentric plan, as a live feed has no
    # barycentric one
    dms, chan_bins, dm_bins = plan_delays(hdr, args)
    maxd = int(chan_bins.max()) + int(dm_bins.max())
    return dms, chan_bins, dm_bins, maxd


def resolve_blocklen(hdr, cfg: StreamConfig, maxd: int,
                     chan_bins, dm_bins) -> int:
    """The ring block length: explicit config, else the batch
    streaming bound (stream_blocklen) — always larger than any delay
    so the two-block window algebra holds, and a multiple of the
    downsample factor like the batch driver rounds."""
    from presto_tpu_torch.apps.common import stream_blocklen
    stage_max = max(int(np.max(chan_bins)), int(np.max(dm_bins)))
    blocklen = (int(cfg.blocklen) if cfg.blocklen
                else stream_blocklen(hdr.nchans, stage_max))
    if blocklen <= stage_max:
        raise ValueError(
            "blocklen %d <= max per-stage delay %d: the two-block "
            "carry needs every delay inside one block"
            % (blocklen, stage_max))
    if blocklen % cfg.downsamp:
        blocklen += cfg.downsamp - blocklen % cfg.downsamp
    return blocklen


class StreamSearch:
    """The full rolling pipeline for one beam: raw blocks in, triggers
    out.  Owns the dedispersion carry, one SinglePulseStream per DM
    trial, the valid-sample holdback, quarantine -> offregion mapping,
    and cross-DM trigger dedup.  The carry and the searches run on
    ``device`` (CUDA unless the caller passes "cpu")."""

    def __init__(self, hdr, cfg: StreamConfig,
                 blocklen: Optional[int] = None, obs=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.hdr = hdr
        self.cfg = cfg
        self.obs = obs              # Observability | None
        self.dt = float(hdr.tsamp)
        self.dms, self._chan_bins, self._dm_bins, self.maxd = \
            plan_stream(hdr, cfg)
        self.blocklen = (int(blocklen) if blocklen else
                         resolve_blocklen(hdr, cfg, self.maxd,
                                          self._chan_bins,
                                          self._dm_bins))
        self.rolling = RollingDedisp(self._chan_bins, self._dm_bins,
                                     cfg.nsub, cfg.downsamp,
                                     device=self.device)
        sp = SinglePulseSearch(threshold=cfg.threshold,
                               maxwidth=cfg.max_pulse_width_s,
                               detrendlen=cfg.detrendlen,
                               badblocks=False,
                               chunklen=cfg.chunklen,
                               fftlen=cfg.fftlen, topk=cfg.topk,
                               device=self.device)
        self.sp = sp
        self.dt_ds = self.dt * cfg.downsamp
        self.streams = [SinglePulseStream(sp, self.dt_ds, dm=float(dm))
                        for dm in self.dms]
        # per-trial arrival alignment: trial d's series lags the
        # top-of-band arrival by its highest-frequency subband offset
        # (dm_bins are globally min-normalized), so candidates from
        # different DM trials of the SAME pulse cluster only after
        # adding each trial's min delay back — in seconds, the
        # residual dispersion sweep across the grid can exceed any
        # reasonable dedup window
        self._shift_s = {float(dm): float(self._dm_bins[d].min())
                         * self.dt
                         for d, dm in enumerate(self.dms)}
        self._nreal = 0             # real spectra fed (no flush pad)
        self._produced = 0          # downsampled series samples out
        self._sp_fed = 0            # series samples handed to search
        self._lag = np.zeros((cfg.numdms, 0), np.float32)
        # holdback (downsampled samples): series closer than maxd raw
        # samples to the frontier may still change (flush padding)
        self._hold = -(-self.maxd // cfg.downsamp)
        self._finished = False
        self.candidates = 0         # finalized candidates (pre-dedup)
        self.triggers: List[Trigger] = []
        self._open: List[Trigger] = []      # clusters still refining
        self._recent: List[Trigger] = []    # emitted (absorb-only)

    # -- quarantine routing -------------------------------------------
    def note_quarantine(self, lo: int, hi: int) -> None:
        """Raw spectra [lo, hi) are damaged/synthetic: any dedispersed
        sample whose accumulation window touches them becomes an
        offregion for border pruning in every DM trial (the streaming
        analog of the batch .inf onoff regions).  One extra detrend
        block of guard on each side: the data/damage edge perturbs the
        whole detrend block it lands in, and edge discontinuities
        would otherwise read as spurious wide-boxcar triggers."""
        ds = self.cfg.downsamp
        guard = self.cfg.detrendlen
        lo_ds = max(max(lo - self.maxd, 0) // ds - guard, 0)
        hi_ds = -(-hi // ds) + guard
        for s in self.streams:
            s.add_offregion(lo_ds, hi_ds)

    # -- feeding ------------------------------------------------------
    def feed_block(self, data: np.ndarray,
                   nreal: int) -> List[Trigger]:
        """One ring block ([blocklen, nchan], `nreal` real spectra —
        the rest is EOF padding).  Returns triggers finalized by this
        block."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._nreal += int(nreal)
        span = (self.obs.span("stream:dedisp", block=self.rolling.
                              blocks_in) if self.obs else None)
        series = self.rolling.feed(data)
        if span is not None:
            span.finish()
        span = (self.obs.span("stream:search") if self.obs else None)
        out = self._dedup(self._advance(series))
        if span is not None:
            span.finish()
        return out

    def finish(self) -> List[Trigger]:
        """End of stream: flush the dedispersion carry, trim to the
        valid length ((N - maxd) // downsamp, the batch trim), flush
        every DM search, emit remaining triggers."""
        if self._finished:
            return []
        return self.finish_series(
            self.rolling.flush(self.blocklen, self.hdr.nchans))

    # -- external-dedispersion entry points ---------------------------
    # The beam multiplexer (stream/beams.py) computes the rolling
    # series for many beams in ONE stacked device step and hands each
    # beam's slice back here, so the trigger logic — holdback, valid
    # trim, offregions, dedup — is literally this class's code and
    # per-beam triggers stay byte-equal to an independent stream.

    def feed_series(self, series: Optional[np.ndarray],
                    nreal: int) -> List[Trigger]:
        """Account `nreal` real spectra and absorb one externally
        dedispersed series block ([numdms, blocklen // downsamp], or
        None while the external carry is still priming).  Equivalent
        to feed_block when `series` is what rolling.feed would have
        produced for the same raw block."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._nreal += int(nreal)
        self.rolling.blocks_in += 1     # keep summary()/spans honest
        return self._dedup(self._advance(series))

    def finish_series(self,
                      flush_series: List[np.ndarray]) -> List[Trigger]:
        """finish() with externally computed flush blocks (what
        rolling.flush would have produced from two zero blocks)."""
        if self._finished:
            return []
        self._finished = True
        cands: List[SPCandidate] = []
        for series in flush_series:
            cands.extend(self._advance(series))
        cands.extend(self._advance(None))   # drain the lag to `valid`
        for s in self.streams:
            cands.extend(s.flush())
        return self._dedup(cands, final=True)

    def _advance(self,
                 series: Optional[np.ndarray]) -> List[SPCandidate]:
        """Append a produced series block to the lag buffer and feed
        every sample that can no longer change to the per-DM searches:
        mid-stream that is (produced - holdback); once finished the
        exact batch trim ((N - maxd) // downsamp) applies — series
        past it is flush-padding-contaminated and the batch driver
        never searches it either."""
        cands: List[SPCandidate] = []
        if series is not None:
            self._produced += series.shape[1]
            self._lag = (np.concatenate([self._lag, series], axis=1)
                         if self._lag.shape[1] else series)
        if self._finished:
            valid = max((self._nreal - self.maxd)
                        // self.cfg.downsamp, 0)
            feed_to = min(valid, self._produced)
        else:
            feed_to = self._produced - self._hold
        if feed_to > self._sp_fed:
            take = feed_to - self._sp_fed
            for d, s in enumerate(self.streams):
                cands.extend(s.feed(self._lag[d, :take]))
            self._lag = self._lag[:, take:]
            self._sp_fed = feed_to
        return cands

    # -- trigger dedup ------------------------------------------------
    def _frontier_time(self) -> float:
        """Aligned arrival time no future candidate can precede: each
        DM trial's emission floor shifted into the common top-of-band
        frame, minimized over trials.  Clusters older than this (minus
        the dedup window) are complete and safe to emit with their
        best member's DM/sigma."""
        return min(
            s.emission_floor() * self.dt_ds
            + self._shift_s[float(dm)]
            for dm, s in zip(self.dms, self.streams))

    def _dedup(self, cands: List[SPCandidate],
               final: bool = False) -> List[Trigger]:
        """Cluster finalized candidates (all DM trials) by aligned
        arrival time.  A cluster stays open — absorbing members and
        refining its leader to the strongest candidate — until every
        trial's emission frontier has passed it (the residual
        dispersion sweep across the grid: the price of emitting the
        *best* DM exactly once instead of the first DM early)."""
        self.candidates += len(cands)
        win = self.cfg.trigger_dedup_s
        for c in sorted(cands, key=lambda c: -c.sigma):
            t = c.time + self._shift_s.get(c.dm, 0.0)
            home = None
            for trig in self._open + self._recent:
                if abs(trig.time - t) <= win:
                    home = trig
                    break
            if home is None:
                self._open.append(Trigger(time=t, dm=c.dm,
                                          sigma=c.sigma,
                                          downfact=c.downfact,
                                          bin=c.bin))
            else:
                home.members += 1
                if any(home is tr for tr in self._open) \
                        and c.sigma > home.sigma:
                    home.time, home.dm = t, c.dm
                    home.sigma = c.sigma
                    home.downfact, home.bin = c.downfact, c.bin
        if final:
            out, self._open = self._open, []
        else:
            ft = self._frontier_time()
            out = [tr for tr in self._open if tr.time + win < ft]
            self._open = [tr for tr in self._open
                          if tr.time + win >= ft]
        # emit in arrival order: clusters are *created* in sigma order
        # within a batch, and the frontier already guarantees batch k's
        # emissions all precede batch k+1's, so an in-batch sort makes
        # the whole trigger stream time-monotonic
        out.sort(key=lambda tr: tr.time)
        # emitted history: a pathological late straggler is absorbed
        # (counted, never re-emitted) instead of double-triggering
        self._recent = (self._recent + out)[-64:]
        self.triggers.extend(out)
        return out

    # -- views --------------------------------------------------------
    @property
    def spectra_fed(self) -> int:
        return self._nreal

    def summary(self) -> dict:
        return {
            "spectra": self._nreal,
            "blocks": self.rolling.blocks_in,
            "numdms": self.cfg.numdms,
            "maxd": self.maxd,
            "blocklen": self.blocklen,
            "candidates": self.candidates,
            "triggers": len(self.triggers),
        }
