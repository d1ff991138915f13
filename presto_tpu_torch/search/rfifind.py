"""rfifind: RFI detection over (interval x channel) cells, in PyTorch.

PyTorch counterpart of ``presto_tpu/search/rfifind.py`` (reference
src/rfifind.c:300-470 + src/rfifind_plot.c:69-280): for each interval x
channel, the time-domain mean and standard deviation and the largest
normalized FFT power of the interval's channel series; thresholds from
robust (middle-fraction) statistics; bytemask bits BAD_POW/BAD_AVG/
BAD_STD; whole-row/column rejection above trigger fractions; fill_mask
-> .mask/.stats artifacts.

The per-cell statistics (``_interval_stats``) run on the device as torch
ops, batched over the channels of an interval: the JAX package computes
them with XLA, not Pallas, so no hand-written kernel replaces them.  An
interval arrives time-major from the reader and is transposed to
channel-major on the device.  Thresholding and mask assembly are host
copies in float64 NumPy (tiny data).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from presto_tpu_torch.io.maskfile import (Mask, fill_mask, write_mask,
                                          write_statsfile, BAD_POW, BAD_AVG,
                                          BAD_STD, BADDATA, USERCHAN,
                                          USERINTS)
from presto_tpu_torch.ops.stats import power_for_sigma
from presto_tpu_torch.search.accel import resolve_device


def calc_avgmedstd(arr: np.ndarray, fraction: float,
                   axis: Optional[int] = None):
    """avg/median/std of the middle `fraction` of the sorted values.
    Parity: calc_avgmedstd (mask.c:149-174).  Vectorized over `axis`."""
    a = np.sort(np.asarray(arr, dtype=np.float64), axis=axis)
    if axis is None:
        a = a.ravel()
        n = a.size
        length = int(n * fraction + 0.5)
        start = (n - length) // 2
        mid = a[start:start + length]
        return float(mid.mean()), float(a[n // 2]), float(mid.std())
    n = a.shape[axis]
    length = int(n * fraction + 0.5)
    start = (n - length) // 2
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(start, start + length)
    mid = a[tuple(sl)]
    med_sl = [slice(None)] * a.ndim
    med_sl[axis] = n // 2
    return (mid.mean(axis=axis), a[tuple(med_sl)], mid.std(axis=axis))


def _interval_stats(cells: torch.Tensor):
    """Batched per-cell statistics.

    cells: [ncells, ptsperint] float32 (each row one interval x channel
    series).  Returns (avg, std, maxpow), each [ncells] float32, where
    maxpow is the largest spectral power over bins 1..n/2-1 normalized
    by var * ptsperint (rfifind.c:370-377).  The variance is the
    population variance (ddof 0), as jnp.var's."""
    n = cells.shape[-1]
    avg = cells.mean(dim=-1)
    var = torch.var(cells, dim=-1, correction=0)
    spec = torch.fft.rfft(cells, dim=-1)
    pows = spec[..., 1:-1].abs() ** 2
    norm = torch.where(var == 0.0, torch.ones_like(var), var * n)
    maxpow = pows.max(dim=-1).values / norm
    return avg, torch.sqrt(var), maxpow


@dataclass
class RfifindResult:
    dataavg: np.ndarray       # [numint, numchan]
    datastd: np.ndarray
    datapow: np.ndarray
    bytemask: np.ndarray      # [numint, numchan] uint8
    mask: Mask
    ptsperint: int

    def masked_fraction(self) -> float:
        return float(((self.bytemask & (BADDATA | USERCHAN | USERINTS))
                      != 0).mean())


def rfifind(data: np.ndarray, dt: float, lofreq: float, chanwidth: float,
            time_sec: float = 30.0, timesigma: float = 10.0,
            freqsigma: float = 4.0, chantrigfrac: float = 0.7,
            inttrigfrac: float = 0.3, mjd: float = 0.0,
            zap_chans=(), zap_ints=(),
            ptsperint: Optional[int] = None,
            device="cuda") -> RfifindResult:
    """Run the rfifind analysis over [N, numchan] time-major data on
    ``device``.

    time_sec: integration time per interval (the -time flag, default
    rfifind.c's 30 s).  Returns stats + bytemask + Mask.
    """
    dev = resolve_device(device)
    N, numchan = data.shape
    if ptsperint is None:
        ptsperint = max(1, int(time_sec / dt + 0.5))
    numint = N // ptsperint
    if numint < 1:
        raise ValueError("data shorter than one rfifind interval")

    def intervals():
        for i in range(numint):
            blk = torch.as_tensor(np.ascontiguousarray(
                data[i * ptsperint:(i + 1) * ptsperint], np.float32))
            yield blk.to(dev).t().contiguous()

    return rfifind_stream(intervals(), numchan, ptsperint, dt, lofreq,
                          chanwidth, timesigma, freqsigma, chantrigfrac,
                          inttrigfrac, mjd, zap_chans, zap_ints)


def rfifind_stream(intervals: Iterable[torch.Tensor], numchan: int,
                   ptsperint: int, dt: float, lofreq: float,
                   chanwidth: float, timesigma: float = 10.0,
                   freqsigma: float = 4.0, chantrigfrac: float = 0.7,
                   inttrigfrac: float = 0.3, mjd: float = 0.0,
                   zap_chans=(), zap_ints=()) -> RfifindResult:
    """Streaming rfifind: one channel-major [numchan, ptsperint] float32
    interval at a time, on the device the statistics run on (the
    reference also reads interval by interval, rfifind.c:323-403).  The
    statistics stay on the device until the last interval: one download
    for the whole observation."""
    avgs, stds, pows = [], [], []
    for cells in intervals:
        a, s, p = _interval_stats(cells)
        avgs.append(a)
        stds.append(s)
        pows.append(p)
    numint = len(avgs)
    if numint < 1:
        raise ValueError("data shorter than one rfifind interval")
    dataavg = torch.stack(avgs).cpu().numpy()
    datastd = torch.stack(stds).cpu().numpy()
    datapow = torch.stack(pows).cpu().numpy()
    return _result(dataavg, datastd, datapow, ptsperint, dt, lofreq,
                   chanwidth, timesigma, freqsigma, chantrigfrac,
                   inttrigfrac, mjd, zap_chans, zap_ints)


def _result(dataavg, datastd, datapow, ptsperint, dt, lofreq, chanwidth,
            timesigma, freqsigma, chantrigfrac, inttrigfrac, mjd,
            zap_chans, zap_ints) -> RfifindResult:
    """Threshold the statistics and assemble the mask."""
    numint, numchan = dataavg.shape
    bytemask = _threshold(dataavg, datastd, datapow, ptsperint,
                          timesigma, freqsigma, chantrigfrac, inttrigfrac,
                          list(zap_chans), list(zap_ints))
    userchan = sorted({c for c in range(numchan)
                       if (bytemask[:, c] & USERCHAN).all()})
    userints = sorted({i for i in range(numint)
                       if (bytemask[i] & USERINTS).all()})
    m = fill_mask(timesigma, freqsigma, mjd, ptsperint * dt, lofreq,
                  chanwidth, numchan, numint, ptsperint, userchan,
                  userints, bytemask)
    return RfifindResult(dataavg=dataavg, datastd=datastd,
                         datapow=datapow, bytemask=bytemask, mask=m,
                         ptsperint=ptsperint)


def _tests(dataavg, datastd, datapow, ptsperint, timesigma, freqsigma):
    """The statistics of every cell and the threshold each is held to
    (rfifind_plot.c:131-224): [(statistic, threshold, flag bit)], the
    statistics [numint, numchan] float64, the thresholds scalars.  A
    cell is flagged where a statistic exceeds its threshold."""
    # global robust stats (rfifind_plot.c:131-136)
    _, dataavg_med, dataavg_std = calc_avgmedstd(dataavg, 0.8)
    _, datastd_med, datastd_std = calc_avgmedstd(datastd, 0.8)
    avg_reject = timesigma * dataavg_std
    std_reject = timesigma * datastd_std
    pow_reject = power_for_sigma(freqsigma, 1, ptsperint / 2)

    # per-interval and per-channel medians (rfifind_plot.c:139-155)
    _, avg_int_med, _ = calc_avgmedstd(dataavg, 0.8, axis=1)
    _, std_int_med, _ = calc_avgmedstd(datastd, 0.8, axis=1)
    _, avg_chan_med, _ = calc_avgmedstd(dataavg, 0.8, axis=0)
    _, std_chan_med, _ = calc_avgmedstd(datastd, 0.8, axis=0)

    out = [(np.asarray(datapow, np.float64), pow_reject, BAD_POW)]
    # averages, then standard deviations: deviation from the interval
    # and channel medians, each median snapped to the global one when
    # itself outlying (:192-224)
    for data, med, reject, int_med, chan_med, bit in (
            (dataavg, dataavg_med, avg_reject, avg_int_med, avg_chan_med,
             BAD_AVG),
            (datastd, datastd_med, std_reject, std_int_med, std_chan_med,
             BAD_STD)):
        int_med = np.where(np.abs(int_med - med) > reject, med, int_med)
        chan_med = np.where(np.abs(chan_med - med) > reject, med, chan_med)
        out.append((np.abs(data - int_med[:, None]), reject, bit))
        out.append((np.abs(data - chan_med[None, :]), reject, bit))
    return out


def cell_margins(dataavg, datastd, datapow, ptsperint, timesigma=10.0,
                 freqsigma=4.0) -> np.ndarray:
    """Per cell, the smallest relative distance |statistic / threshold -
    1| over its statistics: how near the cell sits to flipping a bit of
    the bytemask.  [numint, numchan] float64."""
    return np.min([np.abs(stat / thr - 1.0) for stat, thr, _bit in
                   _tests(dataavg, datastd, datapow, ptsperint, timesigma,
                          freqsigma)], axis=0)


def _threshold(dataavg, datastd, datapow, ptsperint, timesigma, freqsigma,
               chantrigfrac, inttrigfrac, zap_chans, zap_ints):
    """Bytemask generation. Parity: rfifind_plot.c:126-268."""
    numint, numchan = dataavg.shape
    bytemask = np.zeros((numint, numchan), dtype=np.uint8)

    # user zaps
    for i in zap_ints:
        if 0 <= i < numint:
            bytemask[i, :] |= USERINTS
    for c in zap_chans:
        if 0 <= c < numchan:
            bytemask[:, c] |= USERCHAN

    for stat, thr, bit in _tests(dataavg, datastd, datapow, ptsperint,
                                 timesigma, freqsigma):
        bytemask[stat > thr] |= bit

    # whole-interval / whole-channel triggers (:230-268)
    bad = (bytemask & BADDATA) != 0
    int_trig = int(numchan * chantrigfrac)
    for i in np.flatnonzero(bad.sum(axis=1) > int_trig):
        bytemask[i, :] |= USERINTS
    chan_trig = int(numint * inttrigfrac)
    for c in np.flatnonzero(bad.sum(axis=0) > chan_trig):
        bytemask[:, c] |= USERCHAN
    return bytemask


def rfifind_from_stats(stats: dict, dt: float, lofreq: float,
                       chanwidth: float, timesigma: float = 10.0,
                       freqsigma: float = 4.0,
                       chantrigfrac: float = 0.7,
                       inttrigfrac: float = 0.3, mjd: float = 0.0,
                       zap_chans=(), zap_ints=()) -> RfifindResult:
    """Re-threshold previously computed statistics (the -nocompute
    path, rfifind.c:414-429: remake the mask from the .stats file
    without touching the raw data).  `stats` is the dict from
    io.maskfile.read_statsfile."""
    return _result(stats["dataavg"], stats["datastd"], stats["datapow"],
                   int(stats["ptsperint"]), dt, lofreq, chanwidth,
                   timesigma, freqsigma, chantrigfrac, inttrigfrac, mjd,
                   zap_chans, zap_ints)


def write_rfifind_products(result: RfifindResult, rootname: str,
                           lobin: int = 0, numbetween: int = 2) -> None:
    """Write rootname_rfifind.mask and rootname_rfifind.stats."""
    write_mask(rootname + "_rfifind.mask", result.mask)
    write_statsfile(rootname + "_rfifind.stats", result.datapow,
                    result.dataavg, result.datastd, result.ptsperint,
                    lobin, numbetween)
