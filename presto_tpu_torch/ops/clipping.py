"""Time-domain clipping and zero-DM removal (host-side per block).

Host copy of ``presto_tpu/ops/clipping.py`` for the PyTorch port, which imports
nothing from the JAX package.

Parity targets:
  clip_times      src/clipping.c:48-...  (running-average block clipper)
  remove_zerodm   src/zerodm.c           (per-sample band-mean subtract)
  mask_block      backend_common.c:557-572 (masked channels -> padvals)

The reference keeps the clipper's running state in function statics
(clipping.c:56-61) — single-stream only.  Here the state is an explicit
dataclass threaded by the caller (pure-function policy, SURVEY.md §5.2).
Runs in numpy: it sits in the host read path before data reach the
device, on small per-block arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class ClipState:
    """Explicit carry replacing clipping.c's statics."""
    chan_running_avg: Optional[np.ndarray] = None
    running_avg: float = 0.0
    running_std: float = 0.0
    blocksread: int = 0


def clip_times(block: np.ndarray, clip_sigma: float,
               state: Optional[ClipState] = None,
               out: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, int, ClipState]:
    """Clip RFI-contaminated time samples in one raw block.

    block: [ptsperblk, numchan] float32 (time-major, like the reader).
    Samples whose zero-DM (band-summed) value deviates more than
    clip_sigma from the running mean are replaced by the per-channel
    running averages.  Returns (clipped_block, nclipped, new_state).
    The clipped block is written into ``out`` when given (``out`` may be
    ``block`` itself: every statistic is taken before the write), else
    into a copy; the values are the same either way.

    Algorithm parity with clipping.c:48-:
      1. zero-DM series; median + std
      2. re-estimate avg/std from points within ±3 std of the median
         (robust to strong RFI); per-channel means from the same points
      3. exponential running average (alpha=0.9/0.1 after first block)
      4. clip where |zerodm - running_avg| > clip_sigma*running_std
    """
    if state is None:
        state = ClipState()
    ptsperblk, numchan = block.shape
    zero_dm = block.sum(axis=1).astype(np.float64)
    current_med = float(np.median(zero_dm))
    current_std = float(zero_dm.std())

    lo = current_med - 3.0 * current_std
    hi = current_med + 3.0 * current_std
    good = (zero_dm > lo) & (zero_dm < hi)
    ngood = int(good.sum())
    if ngood < 1:
        current_avg = state.running_avg
        current_std = state.running_std
        chan_avg = (state.chan_running_avg if state.chan_running_avg
                    is not None else block.mean(axis=0))
    else:
        current_avg = float(zero_dm[good].mean())
        current_std = float(zero_dm[good].std())
        chan_avg = block[good].mean(axis=0)

    if state.blocksread:
        running_avg = 0.9 * state.running_avg + 0.1 * current_avg
        running_std = 0.9 * state.running_std + 0.1 * current_std
        chan_running = 0.9 * state.chan_running_avg + 0.1 * chan_avg
    else:
        running_avg = current_avg
        running_std = current_std
        chan_running = chan_avg.astype(np.float64)

    trigger = clip_sigma * running_std
    bad = np.abs(zero_dm - running_avg) > trigger
    if out is None:
        out = block.copy()
    elif out is not block:
        np.copyto(out, block)
    if bad.any():
        out[bad] = chan_running.astype(np.float32)
    new_state = ClipState(chan_running_avg=chan_running,
                          running_avg=running_avg,
                          running_std=running_std,
                          blocksread=state.blocksread + 1)
    return out, int(bad.sum()), new_state


def remove_zerodm(block: np.ndarray,
                  bandpass: Optional[np.ndarray] = None) -> np.ndarray:
    """Bandpass-weighted zero-DM removal (Eatough, Keane & Lyne 2009).

    block: [ptsperblk, numchan].  Parity: remove_zerodm (zerodm.c:4-74):
    each sample's band-summed power is subtracted channel-wise with
    weights w_c = bandpass_c / Σ bandpass, then the constant bandpass is
    added back so power stays positive:
        x[t,c] -= w_c * Σ_c' x[t,c']  - bandpass_c.
    `bandpass` defaults to this block's per-channel means (the
    reference's firsttime fallback, zerodm.c:28-38; pass rfifind
    padvals for the preferred behavior).
    """
    if bandpass is None or bandpass.sum() <= 0:
        bandpass = block.mean(axis=0)
    tot = bandpass.sum()
    if tot <= 0:       # all-zero block (e.g. padding): nothing to remove
        return block.astype(np.float32)
    wts = bandpass / tot
    zerodm = block.sum(axis=1, keepdims=True)        # [T, 1]
    return (block - wts[None, :] * zerodm
            + bandpass[None, :]).astype(np.float32)


def mask_block(block: np.ndarray, maskchans: np.ndarray,
               padvals: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Replace masked channels with their padding values, into ``out``
    when given (``block`` itself for in place), else into a copy.
    Parity: the mask substitution in read_psrdata
    (backend_common.c:557-572)."""
    if out is None:
        out = block.copy()
    elif out is not block:
        np.copyto(out, block)
    if len(maskchans):
        out[:, maskchans] = padvals[maskchans]
    return out
