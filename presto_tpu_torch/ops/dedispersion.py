"""Dedispersion: delay planning (host, float64) + shift-and-sum (torch).

PyTorch counterpart of ``presto_tpu/ops/dedispersion.py``.

Parity targets: reference src/dispersion.c.
  delay_from_dm            dispersion.c:30-39   Δt = DM / (0.000241 f²)
  dedisp_delays            dispersion.c:54-73
  subband_delays           dispersion.c:103-121
  subband_search_delays    dispersion.c:124-162
  dedisp_subbands          dispersion.c:165-203 (hot loop 1a)
  float_dedisp             dispersion.c:206-229 (hot loop 1b)

Streaming convention (same as the JAX package): output sample t of a
block whose window starts at stream position S is
out[t] = Σ_ch x_ch[S + t + delay_ch]; the previous block is explicit
state, concatenated in front of the current one.

Bit-identity: every sum is a row-ascending chain of float32 adds
(``acc = row0; acc += row1; ...``), never a ``sum()`` over a stacked
axis, so the float32 results equal the JAX package's bit for bit.  A
step over several rows at once (all subbands, or all DM trials) gathers
one shifted window per row and adds it to that row's accumulator, which
keeps each row's add order.
"""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu_torch.utils.psr import doppler


# ----------------------------------------------------------------------
# Host-side delay planning (float64)
# ----------------------------------------------------------------------

def delay_from_dm(dm, freq_emitted):
    """Dispersion delay in seconds. Parity: dispersion.c:30-39."""
    freq = np.asarray(freq_emitted, dtype=np.float64)
    with np.errstate(divide="ignore"):
        d = dm / (0.000241 * freq * freq)
    return np.where(freq == 0.0, 0.0, d)


def dedisp_delays(numchan, dm, lofreq, chanwidth, voverc=0.0):
    """Per-channel delays (s) at `dm`; lofreq = center freq of lowest
    channel.  Parity: dispersion.c:54-73."""
    freqs = doppler(lofreq + np.arange(numchan, dtype=np.float64)
                    * chanwidth, voverc)
    return delay_from_dm(dm, freqs)


def subband_delays(numchan, numsubbands, dm, lofreq, chanwidth,
                   voverc=0.0):
    """Delays (s) for the highest-frequency channel of each subband.
    Parity: dispersion.c:103-121."""
    chan_per_subband = numchan // numsubbands
    subbandwidth = chanwidth * chan_per_subband
    losub_hifreq = lofreq + subbandwidth - chanwidth
    return dedisp_delays(numsubbands, dm, losub_hifreq, subbandwidth,
                         voverc)


def subband_search_delays(numchan, numsubbands, dm, lofreq, chanwidth,
                          voverc=0.0):
    """Per-channel delays for subband dedispersion at a nominal `dm`:
    each channel's delay minus that of the highest channel of its
    subband.  Parity: dispersion.c:124-162."""
    chan_per_subband = numchan // numsubbands
    sdelays = subband_delays(numchan, numsubbands, dm, lofreq, chanwidth,
                             voverc)
    delays = dedisp_delays(numchan, dm, lofreq, chanwidth, voverc)
    return delays - np.repeat(sdelays, chan_per_subband)


def delays_to_bins(delays_sec, dt):
    """Seconds -> integer sample bins, rounded half-up like the
    reference ((int)(delay/dt + 0.5))."""
    return np.floor(np.asarray(delays_sec, dtype=np.float64) / dt
                    + 0.5).astype(np.int32)


# ----------------------------------------------------------------------
# Device ops (float32)
# ----------------------------------------------------------------------

def _accum_shifted_rows(x2: torch.Tensor, delays: torch.Tensor,
                        numpts: int) -> torch.Tensor:
    """Σ_r x2[..., r, d_r : d_r + numpts], row-ascending.

    x2: [G, R, W] (G independent groups); delays: [G, R] int64.
    Returns [G, numpts].  The loop runs over R, each step adding one
    shifted window per group, so every group's sum is the chain
    row0 + row1 + ... in order (see the module docstring)."""
    G, R, _ = x2.shape
    ar = torch.arange(numpts, device=x2.device)
    rows = torch.arange(G, device=x2.device)
    acc = None
    for r in range(R):
        win = x2[rows[:, None], r, delays[:, r:r + 1] + ar[None]]
        acc = win if acc is None else acc + win
    return acc


def _as_delays(delays, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(delays, dtype=np.int64)
                           if not isinstance(delays, torch.Tensor)
                           else delays, device=device).to(torch.int64)


def dedisp_subbands_block(lastdata: torch.Tensor, data: torch.Tensor,
                          delays, numsubbands: int) -> torch.Tensor:
    """Channels -> subbands shift-and-add for one streaming block.

    lastdata, data: [numchan, numpts] float32 channel-major, ascending
    frequency.  delays: [numchan] int bins, each < numpts.  Returns
    [numsubbands, numpts]; channel-ascending within each subband.
    Parity: dispersion.c:165-203."""
    numchan, numpts = lastdata.shape
    x2 = torch.cat([lastdata, data], dim=1)
    per = numchan // numsubbands
    x3 = x2.reshape(numsubbands, per, 2 * numpts)
    d2 = _as_delays(delays, x2.device).reshape(numsubbands, per)
    return _accum_shifted_rows(x3, d2, numpts)


def float_dedisp_many_block(lastdata: torch.Tensor, data: torch.Tensor,
                            delays_dm, approx_mean: float = 0.0
                            ) -> torch.Tensor:
    """float_dedisp over many DM trials at once.

    lastdata, data: [nsub, numpts]; delays_dm: [numdms, nsub] int.
    Returns [numdms, numpts], each row the subband-ascending sum.
    Parity: dispersion.c:206-229."""
    nsub, numpts = lastdata.shape
    x2 = torch.cat([lastdata, data], dim=1)              # [nsub, 2T]
    d = _as_delays(delays_dm, x2.device)                 # [numdms, nsub]
    ar = torch.arange(numpts, device=x2.device)
    acc = None
    for s in range(nsub):
        win = x2[s][d[:, s:s + 1] + ar[None]]            # [numdms, T]
        acc = win if acc is None else acc + win
    return acc - approx_mean


def downsample_block(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Time-average consecutive groups of `factor` samples (x: [..., T],
    T divisible by factor).  The reference sums then divides
    (prepsubband.c:967-984); the sum is taken in sample order."""
    if factor == 1:
        return x
    y = x.reshape(x.shape[:-1] + (x.shape[-1] // factor, factor))
    acc = y[..., 0]
    for i in range(1, factor):
        acc = acc + y[..., i]
    return acc / factor


def make_block_step(chan_delays, dm_delays, numsubbands: int,
                    downsamp: int = 1):
    """The prep family's streaming step: channels->subbands shift-add +
    per-DM dedispersion + downsample.

    chan_delays: [numchan] int bins; dm_delays: [numdms, nsub] int.
    Returns step(prev_raw, cur, prev_sub) -> (sub, series).  The delay
    tensors move to the blocks' device on first use."""
    cache = {}

    def _on(dev):
        if dev not in cache:
            cache[dev] = (_as_delays(chan_delays, dev),
                          _as_delays(dm_delays, dev))
        return cache[dev]

    def step(prev_raw, cur, prev_sub):
        chan_d, dm_d = _on(cur.device)
        sub = dedisp_subbands_block(prev_raw, cur, chan_d, numsubbands)
        series = float_dedisp_many_block(prev_sub, sub, dm_d)
        return sub, downsample_block(series, downsamp)

    return step


def dedisperse_scan(blocks, delays_dm, numsubbands: int,
                    approx_mean: float = 0.0, downsamp: int = 1
                    ) -> torch.Tensor:
    """The streaming pipeline over in-memory blocks [nblocks, numchan,
    numpts] (nblocks >= 2) at delays_dm {"chan": [numchan], "dm":
    [numdms, nsub]}: [numdms, (nblocks-2) * numpts // downsamp], the
    dedispersed series from stream sample 0.  The first two blocks only
    prime the carry (the reference's two-buffer SWAP priming,
    prepsubband.c:985-991)."""
    blocks = torch.as_tensor(blocks)
    chan = _as_delays(delays_dm["chan"], blocks.device)
    dm = _as_delays(delays_dm["dm"], blocks.device)
    last_raw, last_sub = blocks[1], dedisp_subbands_block(
        blocks[0], blocks[1], chan, numsubbands)
    outs = []
    for block in blocks[2:]:
        sub = dedisp_subbands_block(last_raw, block, chan, numsubbands)
        outs.append(downsample_block(float_dedisp_many_block(
            last_sub, sub, dm, approx_mean), downsamp))
        last_raw, last_sub = block, sub
    return torch.cat(outs, dim=1)


def dedisperse_series(data: torch.Tensor, delays) -> torch.Tensor:
    """Whole-series dedispersion of an in-memory [numchan, N] array:
    out[t] = Σ_c data[c, t + d_c], zero beyond the end."""
    numchan, N = data.shape
    d = _as_delays(delays, data.device)
    maxd = int(d.max())
    x = torch.cat([data, data.new_zeros((numchan, maxd))], dim=1)
    return _accum_shifted_rows(x[None], d[None], N)[0]
