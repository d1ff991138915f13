"""Fourier-domain F–Fdot acceleration search, on PyTorch and CUDA.

PyTorch counterpart of ``presto_tpu/search/accel.py``.  The port has
ONE engine and the two geometries of the JAX package's TPU path: the
aligned direct-plane geometry (uselen a multiple of 128 filling the FFT
length beside a 128-aligned output offset) where it holds, else the
geometry of its non-Pallas engines (exact halfwidth, any even uselen,
the plane padded to the reducer tile), which short spectra and an
explicit uselen take.  Both run on

  * the plane build as a CUDA kernel (search/build_cuda.py, the
    counterpart of search/build_pallas.py), fed by forward spectra from
    ``torch.fft`` (the JAX package computes those outside Pallas too);
  * the staged harmonic sum as a CUDA kernel (search/accel_cuda.py, the
    counterpart of search/accel_pallas.py);
  * threshold + segment-max + top-k + per-trial compaction in torch,
    with ties broken by lowest index like ``jax.lax.top_k``;
  * candidate sigma math on the host in float64.

With cfg.wmax it is the jerk search, the (r, z, w) volume: one plane per
w on the ACCEL_DW grid, each built from that w's response bank, and each
harmonic term read from the plane of its own subharmonic w
(calc_required_w); planes are built in |w| order and kept in a plane
cache, the multi-plane reducer sums them.

Reference call stack (src/accelsearch.c:134-221, src/accel_utils.c):
subharm_ffdot_plane builds the plane per r-block, inmem harmonic sums
add subharmonic cells, search_ffdotpows thresholds at powcut[stage].

The survey tunes the column slab (``search_many(slab=)``, the tuning
DB's ``accel_column_slab``) and books each search's dispatches and
analytic costs (obs/devtel, obs/costmodel) around ``search_many``.
Nothing here reads environment variables.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from presto_tpu_torch.ops import responses as resp
from presto_tpu_torch.ops import stats as st
from presto_tpu_torch.search import accel_cuda, build_cuda
from presto_tpu_torch.utils.psr import next2_to_n

# Search grid constants (include/accel.h:18-31)
ACCEL_NUMBETWEEN = 2
ACCEL_DR = 0.5
ACCEL_RDR = 2
ACCEL_DZ = 2
ACCEL_RDZ = 0.5
ACCEL_CLOSEST_R = 15.0
ACCEL_USELEN = 7470
ACCEL_DW = 20                    # w grid step of the jerk search
DBLCORRECT = 1e-14

ROW_PAD = 8          # plane rows pad to a multiple of this (the JAX
BLOCK_PAD = 8        # plane kernel's ZT/BB), and blocks, with >= 1 zero block
SLAB_TILES = (1024, 512, 256)   # the JAX stage reducer's column tiles
REF_VMEM_BUDGET = 14 * 2 ** 20  # its scratch budget (accel_pallas.py)
SEARCH_SEG = 16      # columns per segment-max before top-k (8 r-bins <
                     # ACCEL_CLOSEST_R: merged candidates are ones the
                     # r-dedup collapses anyway)
COMPACT_CANDS = 2048  # default top-m budget per trial
_CMP_ZBITS = 12      # compact meta word: zrow | stage << 12 | slab << 15
_CMP_SBITS = 3
MEM_HEADROOM = 0.9   # share of free device memory one trial may use
MAX_INFLIGHT = 2     # jerk scans queued on the card ahead of the host collect


def _ref_scratch_bytes(fracs_zinds, numz: int, tile: int) -> int:
    """The JAX stage reducer's VMEM scratch estimate at one column tile
    (accel_pallas.scratch_bytes with its _stage_terms/_term_geom)."""
    numz_pad = -(-numz // 8) * 8
    total = 3 * numz_pad * tile * 4      # accumulator + fundamental banks
    for stage in fracs_zinds:
        for harm, htot, zinds in stage:
            rows = -(-(int(np.max(zinds)) + 1) // 8) * 8
            cspan = ((tile - 1) * harm + (htot >> 1)) // htot + 2
            win = -(-(112 + cspan) // 128) * 128
            total += 2 * rows * win * 4 + numz_pad * 3 * rows * 2
    return total


def reference_tile(fracs_zinds, numz: int, slab: int) -> Optional[int]:
    """The JAX package's rule for its segment grid (accel_pallas.
    pick_tile with tuning off): the first of SLAB_TILES that divides
    the slab and whose scratch estimate fits REF_VMEM_BUDGET, else None
    (the JAX package then scans numharm-aligned slabs).  Kept so that
    the slab starts, and so the candidate lists, match the JAX
    package's."""
    for t in SLAB_TILES:
        if (128 <= t <= slab and t % 128 == 0 and slab % t == 0
                and _ref_scratch_bytes(fracs_zinds, numz, t)
                <= REF_VMEM_BUDGET):
            return t
    return None


def _nearest_int(x: float) -> int:
    """Round half away from zero (the reference's NEAREST_INT)."""
    return int(np.ceil(x - 0.5)) if x < 0 else int(np.floor(x + 0.5))


def calc_required_z(harm_fract: float, zfull: float) -> float:
    """z of the subharmonic for fundamental z (accel_utils.c:53-59)."""
    return _nearest_int(ACCEL_RDZ * zfull * harm_fract) * ACCEL_DZ


def calc_required_w(harm_fract: float, wfull: float) -> float:
    """w of the subharmonic for fundamental w, rounded to the jerk grid
    (modern PRESTO's calc_required_w)."""
    return _nearest_int(wfull * harm_fract / ACCEL_DW) * ACCEL_DW


def index_from_z(z: float, loz: float) -> int:
    return int((z - loz) * ACCEL_RDZ + DBLCORRECT)


def calc_fftlen(numharm: int, harmnum: int, max_zfull: int,
                uselen: int = ACCEL_USELEN, max_wfull: int = 0) -> int:
    """FFT length for a subharmonic block (accel_utils.c:116-131; the
    jerk search's banks size for the widest w kernel)."""
    harm_fract = harmnum / numharm
    bins_needed = uselen * harmnum // numharm + 2
    z_req = calc_required_z(harm_fract, max_zfull)
    hw = (resp.w_resp_halfwidth(z_req, max_wfull, resp.LOWACC)
          if max_wfull else resp.z_resp_halfwidth(z_req, resp.LOWACC))
    return next2_to_n(bins_needed + 2 * ACCEL_NUMBETWEEN * hw)


def kernel_halfwidth(cfg: "AccelConfig") -> int:
    """Half width of the widest kernel of a search's banks: the
    w-response's at (zmax, wmax) for a jerk search (every plane's bank,
    w = 0 included, shares it), else the z-response's at zmax."""
    if cfg.wmax:
        return resp.w_resp_halfwidth(float(cfg.zmax), float(cfg.wmax),
                                     resp.LOWACC)
    return resp.z_resp_halfwidth(float(cfg.zmax), resp.LOWACC)


@dataclass
class AccelConfig:
    zmax: int = 200              # max |z| searched (fundamental)
    wmax: int = 0                # max |w| of the jerk search (0 = off)
    numharm: int = 8             # max harmonics summed (power of two)
    sigma: float = 2.0           # candidate sigma cutoff
    rlo: float = 0.0             # min Fourier freq searched (bins)
    rhi: float = 0.0             # 0 -> numbins - 1
    flo: float = 1.0             # min freq (Hz) if rlo not given
    uselen: int = ACCEL_USELEN   # half-bins of fundamental per block
    max_cands_per_stage: int = 2048   # top-k size per (slab, stage)
    norm: str = "median"         # "median" or "prenorm"

    @property
    def numharmstages(self) -> int:
        return int(np.log2(self.numharm)) + 1

    @property
    def numz(self) -> int:
        return (self.zmax // ACCEL_DZ) * 2 + 1

    @property
    def ws(self) -> np.ndarray:
        """The jerk search's w grid; [0.] (one plane) when wmax is 0."""
        if not self.wmax:
            return np.zeros(1)
        nside = self.wmax // ACCEL_DW
        return (np.arange(2 * nside + 1) - nside) * float(ACCEL_DW)


@dataclass
class AccelKernels:
    """The response kernel bank of one plane (host-built in float64,
    stored time-domain, centered in a common kmax-tap window): the
    z-responses, or for a jerk search's w != 0 plane the w-responses."""
    fftlen: int
    halfwidth: int
    numz: int
    zlo: int
    kmax: int
    kern_pairs: np.ndarray       # [numz, kmax, 2] float32, centered

    @classmethod
    def build(cls, cfg: AccelConfig, w: float = 0.0) -> "AccelKernels":
        """Parity: init_kernel (accel_utils.c:133-151) for harm 1/1, one
        kernel per z in [-zmax, zmax] step ACCEL_DZ, at plane w.  Every
        plane of a jerk search shares the kmax of the widest kernel.  A
        w != 0 bank is one whole-bank quadrature at kmax taps, each z's
        kernel then cut to its own width (the centred sub-grids of the
        kmax grid coincide, so this is the per-z kernel)."""
        fftlen = calc_fftlen(1, 1, cfg.zmax, cfg.uselen, cfg.wmax)
        halfwidth = kernel_halfwidth(cfg)
        numz = cfg.numz
        kmax = 2 * ACCEL_NUMBETWEEN * halfwidth
        kerns = np.zeros((numz, kmax), dtype=np.complex128)
        zs = -cfg.zmax + np.arange(numz, dtype=np.float64) * ACCEL_DZ
        if abs(w) >= 1e-7:
            full = resp.gen_w_response_bank(0.0, ACCEL_NUMBETWEEN, zs,
                                            float(w), kmax)
        for i in range(numz):
            if abs(w) < 1e-7:
                hw = resp.z_resp_halfwidth(float(zs[i]), resp.LOWACC)
                numkern = min(2 * ACCEL_NUMBETWEEN * hw, kmax)
                k = resp.gen_z_response(0.0, ACCEL_NUMBETWEEN, float(zs[i]),
                                        numkern)
                start = kmax // 2 - numkern // 2
                kerns[i, start:start + numkern] = k[:numkern]
            else:
                hw = resp.w_resp_halfwidth(float(zs[i]), float(w),
                                           resp.LOWACC)
                numkern = min(2 * ACCEL_NUMBETWEEN * hw, kmax)
                start = kmax // 2 - numkern // 2
                kerns[i, start:start + numkern] = \
                    full[i, start:start + numkern]
        pairs = np.stack([kerns.real, kerns.imag],
                         axis=-1).astype(np.float32)
        return cls(fftlen=fftlen, halfwidth=halfwidth, numz=numz,
                   zlo=-cfg.zmax, kmax=kmax, kern_pairs=pairs)


def _harm_fracs_and_zinds(cfg: AccelConfig, numz: int):
    """Per stage s >= 1, per odd harm < 2^s: (harm, 2^s, z-row map)
    (inmem_add_ffdotpows index math, accel_utils.c:1160-1207)."""
    out = []
    zlo = -cfg.zmax
    zs = zlo + np.arange(numz) * ACCEL_DZ
    for stage in range(1, cfg.numharmstages):
        harmtosum = 1 << stage
        stage_list = []
        for harm in range(1, harmtosum, 2):
            frac = harm / harmtosum
            zinds = np.array([index_from_z(calc_required_z(frac, z), zlo)
                              for z in zs], dtype=np.int32)
            stage_list.append((harm, harmtosum, zinds))
        out.append(stage_list)
    return out


def _powcuts(cfg: AccelConfig, rlo: float, rhi: float):
    """numindep and powcut per stage (accel_utils.c:1629-1641); a jerk
    search counts each w plane as another set of independent trials."""
    numindep, powcut = [], []
    for ii in range(cfg.numharmstages):
        harmtosum = 1 << ii
        if cfg.numz == 1:
            ni = (rhi - rlo) / harmtosum
        else:
            ni = ((rhi - rlo) * (cfg.numz + 1) * (ACCEL_DZ / 6.95)
                  / harmtosum)
        ni *= len(cfg.ws)
        numindep.append(ni)
        powcut.append(float(st.power_for_sigma(cfg.sigma, harmtosum, ni)))
    return numindep, powcut


def fft_kernel_bank(kern_pairs: np.ndarray, fftlen: int,
                    device) -> torch.Tensor:
    """Compact time-domain bank -> conjugated FFT'd complex64 bank
    [numz, fftlen] (NR wrap placement, corr_prep.c:58-80, then a
    complex64 forward FFT as the JAX package's _fft_kernel_bank_c)."""
    kp = torch.as_tensor(np.ascontiguousarray(kern_pairs), device=device)
    kc = torch.view_as_complex(kp)
    half = kc.shape[-1] // 2
    placed = torch.zeros((kc.shape[0], fftlen), dtype=torch.complex64,
                         device=device)
    placed[:, :half] = kc[:, half:]
    placed[:, fftlen - half:] = kc[:, :half]
    return torch.fft.fft(placed, dim=-1).conj_physical()


def block_median_norms(data: torch.Tensor) -> torch.Tensor:
    """Per-block median power normalization, 1/sqrt(median(|a|^2)/ln2)
    (accel_utils.c:952-967); [B, numdata] complex -> [B, 1] float32.
    The median of an even count is the mean of the two middle order
    statistics, (lo + hi) * 0.5, as jnp.median computes it."""
    pows = data.real ** 2 + data.imag ** 2
    n = pows.shape[-1]
    srt = torch.sort(pows, dim=-1).values
    lo, hi = (n - 1) // 2, n // 2
    med = (srt[:, lo] + srt[:, hi]) * 0.5
    med = torch.clamp(med, min=1e-30)
    ln2 = torch.log(torch.tensor(2.0, dtype=torch.float32,
                                 device=data.device))
    return (1.0 / torch.sqrt(med / ln2))[:, None]


def _topk_desc(x: torch.Tensor, k: int):
    """Top-k along the last axis, descending, ties to the lowest index
    (the jax.lax.top_k order; torch.topk promises no tie order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def collect_from_reduced(colmax: torch.Tensor, colz: torch.Tensor,
                         powcuts: torch.Tensor, k: int) -> torch.Tensor:
    """Threshold + segment-max + top-k over the reducer's [nslabs,
    stages, slab] arrays -> packed int32 [3, nslabs, stages, kk]
    (power bits, within-slab column, z row)."""
    nslabs, nstages, slab = colmax.shape
    nseg = -(-slab // SEARCH_SEG)
    kk = min(k, nseg)
    masked = torch.where(colmax > powcuts[None, :, None], colmax,
                         torch.zeros((), dtype=colmax.dtype,
                                     device=colmax.device))
    masked = torch.nn.functional.pad(masked, (0, nseg * SEARCH_SEG - slab))
    segs = masked.reshape(nslabs, nstages, nseg, SEARCH_SEG)
    segmax, segarg = segs.max(dim=-1)          # first max on a tie
    v, si = _topk_desc(segmax, kk)
    ci = si * SEARCH_SEG + torch.gather(segarg, -1, si)
    zrow = torch.gather(colz, -1, ci.clamp(max=slab - 1))
    return torch.stack([v.view(torch.int32), ci.int(), zrow.int()])


def compact_scan_packed(packed: torch.Tensor,
                        m: int = COMPACT_CANDS) -> torch.Tensor:
    """Top-m of one trial's packed [3, nslabs, stages, k] cells by power
    -> int32 [3, m]: power bits, column, meta = zrow | stage << 12 |
    slab << 15.  Lossless while fewer than m cells are positive
    (collect_compacted raises otherwise)."""
    valbits, cidx, zrow = packed[0], packed[1], packed[2]
    nslabs, stages, k = valbits.shape
    assert stages < (1 << _CMP_SBITS) and nslabs < (1 << 16), \
        (nslabs, stages)
    m = min(m, nslabs * stages * k)
    dev = packed.device
    si = torch.arange(nslabs, dtype=torch.int32, device=dev)[:, None, None]
    sg = torch.arange(stages, dtype=torch.int32, device=dev)[None, :, None]
    meta = zrow | (sg << _CMP_ZBITS) | (si << (_CMP_ZBITS + _CMP_SBITS))
    v, idx = _topk_desc(valbits.view(torch.float32).reshape(-1), m)
    return torch.stack([v.view(torch.int32), cidx.reshape(-1)[idx],
                        meta.reshape(-1)[idx]])


def _unpack_scan(packed: np.ndarray):
    arr = np.asarray(packed)
    return arr[0].view(np.float32), arr[1], arr[2]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU, with its index (the current device when none is named);
    no CUDA device raises (nothing falls back)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("presto_tpu_torch: no CUDA device is "
                               "available; pass device='cpu' to run the "
                               "plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_full_f32_matmul(device: torch.device, what: str) -> None:
    """Raise on a CUDA device while TF32 matmuls are on: ``what`` needs
    full float32 products, as the JAX package computes them."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("%s needs full float32 matmuls, and TF32 is on "
                           "(set torch.backends.cuda.matmul.allow_tf32 = "
                           "False)" % what)


@dataclass
class AccelCand:
    """A raw search candidate (accelcand, accel.h:76-86, minus the
    optimization fields)."""
    power: float
    sigma: float
    numharm: int
    r: float
    z: float
    w: float = 0.0

    def freq(self, T: float) -> float:
        return self.r / T


class AccelSearch:
    """In-memory accelsearch over packed spectra on one device.

        s = AccelSearch(cfg, T=obs_seconds, numbins=n)   # device="cuda"
        per_dm = s.search_many(pairs_batch)   # [nd, numbins, 2] float32
    """

    def __init__(self, cfg: AccelConfig, T: float, numbins: int,
                 device="cuda"):
        self.device = resolve_device(device)
        max_uselen = max(64, 2 * (numbins - 16))
        if cfg.uselen > max_uselen or cfg.uselen % 2:
            cfg = replace(cfg, uselen=min(cfg.uselen & ~1, max_uselen))
        # the aligned direct-plane geometry (accel.py:768-806 of the
        # JAX package): only the DEFAULT uselen is retuned
        if cfg.uselen == ACCEL_USELEN:
            fft0 = calc_fftlen(1, 1, cfg.zmax, cfg.uselen, cfg.wmax)
            hw0 = kernel_halfwidth(cfg)
            u_al = (fft0 - 4 * (-(-hw0 // 64) * 64)) & ~127
            if (1024 <= u_al <= max_uselen
                    and calc_fftlen(1, 1, cfg.zmax, u_al, cfg.wmax) == fft0):
                cfg = replace(cfg, uselen=u_al)
        self.cfg = cfg
        self.T = T
        self.numbins = numbins
        self.rlo = cfg.rlo if cfg.rlo > 0 else max(cfg.flo * T, 8.0)
        self.rhi = cfg.rhi if cfg.rhi > 0 else numbins - 1
        kern = AccelKernels.build(cfg)
        self._set_state(kern, _harm_fracs_and_zinds(cfg, cfg.numz),
                        *_powcuts(cfg, self.rlo, self.rhi))

    def _set_state(self, kern: AccelKernels, fracs_zinds, numindep,
                   powcut) -> None:
        """Install the search state: kernel bank, z-row maps, powcuts."""
        cfg = self.cfg
        self.kern = kern
        log2n = kern.fftlen.bit_length() - 1
        if not (build_cuda.LOG2N_MIN <= log2n <= build_cuda.LOG2N_MAX):
            raise ValueError(
                "accel: fftlen %d (zmax %d, uselen %d) is outside the plane "
                "builder's templates (2^%d .. 2^%d)"
                % (kern.fftlen, cfg.zmax, cfg.uselen, build_cuda.LOG2N_MIN,
                   build_cuda.LOG2N_MAX))
        # the read windows start hw_eff bins below each block and the
        # good window sits at 2 * hw_eff: the halfwidth rounded up to 64
        # on the aligned geometry, the exact halfwidth on the other
        hw_al = -(-kern.halfwidth // 64) * 64
        self.aligned = (kern.fftlen % 256 == 0 and cfg.uselen % 128 == 0
                        and cfg.uselen + 4 * hw_al <= kern.fftlen)
        self.hw_eff = hw_al if self.aligned else kern.halfwidth
        self.fracs_zinds = fracs_zinds
        self.numindep = list(numindep)
        self.powcut = list(powcut)
        self.numz_pad = -(-cfg.numz // ROW_PAD) * ROW_PAD
        zi = [np.concatenate([np.asarray(z, np.int32),
                              np.arange(cfg.numz, self.numz_pad,
                                        dtype=np.int32)])
              for stage in fracs_zinds for (_h, _t, z) in stage]
        self._zinds = torch.as_tensor(
            np.stack(zi) if zi else np.zeros((0, self.numz_pad), np.int32),
            device=self.device).contiguous()
        self._powcut_dev = torch.tensor(self.powcut, dtype=torch.float32,
                                        device=self.device)
        self._kbank = fft_kernel_bank(kern.kern_pairs, kern.fftlen,
                                      self.device)
        # the jerk search's banks, by grid w, for the searcher's
        # lifetime: host banks, and the FFT'd device banks of w != 0
        self._w_banks = {0.0: kern}
        self._w_banks_dev = {}
        # copies of (bank, z maps, powcuts) on the other devices of a
        # mesh, made once a device
        self._copies = {}

    def state_on(self, device):
        """(FFT'd w = 0 bank, z-row maps, powcuts) on ``device``: the
        searcher's own on its device, else a copy made once for the
        searcher's lifetime."""
        device = torch.device(device)
        if device == self.device:
            return self._kbank, self._zinds, self._powcut_dev
        st = self._copies.get(device)
        if st is None:
            st = self._copies[device] = tuple(
                t.to(device) for t in (self._kbank, self._zinds,
                                       self._powcut_dev))
        return st

    # -- plane ---------------------------------------------------------

    def _plan_blocks(self):
        """r-block starts (whole bins) from r=0; only full blocks below
        rhi (accelsearch.c:167)."""
        blocks = []
        startr = 0.0
        step = self.cfg.uselen * ACCEL_DR
        while startr + step < self.rhi:
            blocks.append(startr)
            startr += step
        return blocks

    def plane_geom(self):
        """(nblocks, nb_pad, plane_numr), or None for a spectrum too
        short for one block.  On the aligned geometry the plane carries
        >= 1 zero block on the right, like the JAX direct-plane
        builder's.  Otherwise plane_numr is the JAX package's plane
        width there (the blocks' columns padded to the reducer tile) and
        the built plane has nb_pad * uselen >= plane_numr columns, zero
        past the blocks: the slab plan reads plane_numr."""
        nblocks = len(self._plan_blocks())
        if not nblocks:
            return None
        uselen = self.cfg.uselen
        if self.aligned:
            nb_pad = -(-(nblocks + 1) // BLOCK_PAD) * BLOCK_PAD
            return nblocks, nb_pad, nb_pad * uselen
        numr = nblocks * uselen
        numr += (-numr) % max(16, self.cfg.numharm, SLAB_TILES[0])
        return nblocks, -(-numr // uselen), numr

    def forward_spectra(self, pairs: torch.Tensor) -> torch.Tensor:
        """Block read windows -> median-normalized forward spectra
        S [nblocks, fftlen/2] complex64.  Window j is bins
        [j*hop - hw_eff, j*hop - hw_eff + fftlen/2) of the spectrum
        (hop = uselen/2), zero outside it."""
        nblocks, _nb_pad, _numr = self.plane_geom()
        numdata = self.kern.fftlen // 2
        hop = self.cfg.uselen // 2
        pad_hi = max(0, (nblocks - 1) * hop + numdata
                     - (self.numbins + self.hw_eff))
        c = torch.view_as_complex(torch.nn.functional.pad(
            pairs, (0, 0, self.hw_eff, pad_hi)).contiguous())
        frames = c.unfold(0, numdata, hop)[:nblocks]
        if self.cfg.norm == "median":
            frames = frames * block_median_norms(frames)
        return torch.fft.fft(frames, dim=-1).contiguous()

    def build_plane(self, pairs: torch.Tensor, kbank=None,
                    spectra=None) -> torch.Tensor:
        """The fundamental F-Fdot plane [numz_pad, plane_numr] of one
        spectrum ([numbins, 2] float32, on any device the searcher has
        state on): plane column c is absolute half-bin c.  ``kbank`` is a
        device bank on the spectrum's device (default: the w = 0 bank
        there); ``spectra`` the spectrum's forward_spectra, when already
        computed."""
        _nblocks, nb_pad, _numr = self.plane_geom()
        if spectra is None:
            spectra = self.forward_spectra(pairs)
        if kbank is None:
            kbank = self.state_on(spectra.device)[0]
        return build_cuda.build_plane(
            spectra, kbank, self.numz_pad, nb_pad, self.cfg.uselen,
            self.hw_eff * ACCEL_NUMBETWEEN)

    # -- jerk search ---------------------------------------------------

    def bank(self, w: float) -> AccelKernels:
        """The host bank of grid plane w, built once a searcher."""
        w = float(w)
        kern = self._w_banks.get(w)
        if kern is None:
            kern = self._w_banks[w] = AccelKernels.build(self.cfg, w)
        return kern

    def _w_bank_dev(self, w: float) -> torch.Tensor:
        """The FFT'd device bank of grid plane w: the searcher's own at
        w = 0, else built once and kept for the searcher's lifetime (all
        len(cfg.ws) banks of a search fit: _jerk_budget)."""
        w = float(w)
        if w == 0.0:
            return self._kbank
        kb = self._w_banks_dev.get(w)
        if kb is None:
            kern = self.bank(w)
            kb = self._w_banks_dev[w] = fft_kernel_bank(
                kern.kern_pairs, kern.fftlen, self.device)
        return kb

    def _jerk_budget(self, plane_bytes: int, work_bytes: int,
                     keep: int) -> int:
        """The planes the jerk search may cache, from the device memory
        free now (torch.cuda.mem_get_info) plus what its bank cache
        already holds, after every device bank of cfg.ws and
        ``work_bytes``.  Raises when the banks and the ``keep`` planes
        one scan reads do not fit.  Unbounded on the CPU."""
        nws = len(self.cfg.ws)
        if self.device.type != "cuda":
            return nws
        free, _total = torch.cuda.mem_get_info(self.device)
        cached = (torch.cuda.memory_reserved(self.device)
                  - torch.cuda.memory_allocated(self.device))
        bank_bytes = self._kbank.numel() * 8
        banks = sum(1 for w in self.cfg.ws if w != 0.0) * bank_bytes
        avail = (MEM_HEADROOM * (free + cached)
                 + len(self._w_banks_dev) * bank_bytes)
        max_planes = int((avail - banks - work_bytes) // plane_bytes)
        if max_planes < keep:
            raise MemoryError("accel: the jerk search holds %d banks of "
                              "%.3f GB and reads %d planes of %.2f GB at "
                              "once, and the device has room for %d planes"
                              % (nws, bank_bytes / 1e9, keep,
                                 plane_bytes / 1e9, max(max_planes, 0)))
        return max_planes

    def _search_jerk(self, pairs: torch.Tensor, slab: int,
                     compact_m: int) -> List[AccelCand]:
        """The (r, z, w) jerk search of one spectrum over the ACCEL_DW w
        grid (the JAX package's _search_jerk).  numharm 1: one build +
        reduce per w, in grid order.  Else per w, in |w| order, the
        multi-plane reduce of the plane at w and the planes at each
        term's subharmonic w, from a least-recently-used plane cache
        whose planes of the current scan are never evicted.  A scan's
        compacted candidates are copied to the host behind an event, and
        collected one scan later (MAX_INFLIGHT), so the host decode
        overlaps the next scan on the card.  What the caches hold
        changes how often a plane is built, never the candidates."""
        cfg = self.cfg
        geom = self.plane_geom()
        plan = self.slab_plan(geom[2], slab) if geom else None
        if plan is None:
            return []
        slab, k, start_cols = plan
        scols = torch.tensor(start_cols, dtype=torch.int32,
                             device=self.device)
        nst = cfg.numharmstages
        fracs = [h / t for stage in self.fracs_zinds for (h, t, _z) in stage]
        ladder = [float(w) for w in cfg.ws]
        if fracs:
            ladder.sort(key=abs)
        subs_of = {w: [float(calc_required_w(f, w)) for f in fracs]
                   for w in ladder}
        keep_max = max(len(set(v) | {w}) for w, v in subs_of.items())
        plane_bytes = self.numz_pad * geom[1] * cfg.uselen * 4
        spectra = self.forward_spectra(pairs)
        work = (spectra.numel() * 8 + plane_bytes
                + (MAX_INFLIGHT + 1) * len(start_cols) * nst * slab * 8 * 3)
        max_planes = self._jerk_budget(plane_bytes, work,
                                       keep_max if fracs else 1)
        planes: OrderedDict = OrderedDict()

        def plane_for(w: float, keep: set) -> torch.Tensor:
            pl = planes.pop(w, None)
            if pl is None:
                # evict before building: at most max_planes resident (the
                # budget holds a whole scan's keep set)
                while len(planes) >= max_planes:
                    del planes[next(x for x in planes if x not in keep)]
                pl = self.build_plane(pairs, self._w_bank_dev(w),
                                      spectra=spectra)
            planes[w] = pl
            return pl

        all_cands: List[AccelCand] = []
        pend = []

        def drain(down_to: int) -> None:
            while len(pend) > down_to:
                w, packed, comp, done = pend.pop(0)
                if done is not None:
                    done.synchronize()
                for c in self._decode(comp.numpy(), packed, start_cols,
                                      compact_m):
                    # the plane cell is the numharm-th harmonic: its
                    # (r, z, w) all scale down to the fundamental
                    c.w = w / c.numharm
                    all_cands.append(c)

        for w in ladder:
            if fracs:
                keep = set(subs_of[w]) | {w}
                src = [plane_for(w, keep)] + [plane_for(x, keep)
                                              for x in subs_of[w]]
                colmax, colz = accel_cuda.reduce_stages_planes(
                    src, scols, self._zinds, slab, nst)
                del src
            else:
                pl = self.build_plane(pairs, self._w_bank_dev(w),
                                      spectra=spectra)
                colmax, colz = accel_cuda.reduce_stages(
                    pl, scols, self._zinds, slab, nst)
                del pl
            packed = collect_from_reduced(colmax, colz, self._powcut_dev, k)
            del colmax, colz
            comp = compact_scan_packed(packed, compact_m)
            done = None
            if self.device.type == "cuda":
                host = torch.empty(comp.shape, dtype=comp.dtype,
                                   pin_memory=True)
                host.copy_(comp, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                comp = host
            pend.append((w, packed, comp, done))
            drain(MAX_INFLIGHT - 1)
        drain(0)
        return self._merge_w_cands(all_cands)

    @staticmethod
    def _merge_w_cands(all_cands: List[AccelCand]) -> List[AccelCand]:
        """The same (numharm, r) found in several w planes: keep the
        strongest (the volume's local max)."""
        best = {}
        for c in sorted(all_cands, key=lambda c: -c.sigma):
            best.setdefault((c.numharm, c.r), c)
        return sorted(best.values(), key=lambda c: (-c.sigma, c.r))

    def _decode(self, comp: np.ndarray, packed: torch.Tensor, start_cols,
                compact_m: int) -> List[AccelCand]:
        """One scan's candidates from its compacted output, or, when the
        compaction budget ran out, from the dense packed output."""
        try:
            return self.collect_compacted(comp, start_cols,
                                          requested_m=compact_m)
        except ValueError:
            vals, cidx, zrow = _unpack_scan(packed.cpu().numpy())
            return self._dedup_sort(
                self._collect_group(vals, cidx, zrow, start_cols))

    # -- search --------------------------------------------------------

    def slab_plan(self, plane_numr: int, slab: int = 1 << 20):
        """(slab, k, start_cols) covering [rlo, rhi) in aligned slabs,
        the last one overlapped backwards (accel.py:1467-1555)."""
        cfg = self.cfg
        r0 = int(self.rlo) * ACCEL_RDR
        self._r0min = r0
        numr = min(int(self.rhi) * ACCEL_RDR, plane_numr) - r0
        if numr <= 0:
            return None
        top = r0 + numr
        self._rtop = top
        slab = min(slab, numr)
        tile = None
        if cfg.numharm <= 16 and plane_numr % SLAB_TILES[0] == 0:
            tile = reference_tile(self.fracs_zinds, cfg.numz, slab)
        align = max(cfg.numharm, tile or 1)
        aligned = (slab % align == 0 or slab > 4 * align) \
            and plane_numr % align == 0
        if aligned and slab % align:
            slab -= slab % align
        r0a = r0 - (r0 % align) if aligned else r0
        top_a = min(top + ((-top) % align), plane_numr) if aligned \
            else top
        k = min(cfg.max_cands_per_stage, slab)
        start_cols = []
        off = r0a
        while True:
            if off + slab >= top_a:
                start_cols.append(max(top_a - slab, 0))
                break
            start_cols.append(off)
            off += slab
        return slab, k, start_cols

    def _check_memory(self, plane_numr: int, slab: int, nslabs: int,
                      device=None):
        """One trial's plane and reducer outputs must fit in the memory
        free now (torch.cuda.mem_get_info) on ``device`` (default: the
        searcher's): the port holds one plane at a time a device instead
        of the JAX package's TPU-sized groups."""
        device = self.device if device is None else torch.device(device)
        if device.type != "cuda":
            return
        free, _total = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        need = (self.numz_pad * plane_numr * 4
                + nslabs * self.cfg.numharmstages * slab * 8 * 3)
        if need > MEM_HEADROOM * (free + cached):
            raise MemoryError("accel: a %d-column plane needs %.2f GB, "
                              "more than the device has free"
                              % (plane_numr, need / 1e9))

    def search(self, pairs, slab: int = 1 << 20) -> List[AccelCand]:
        """The staged search of one spectrum ([numbins, 2] float32)."""
        return self.search_many(torch.as_tensor(pairs)[None], slab=slab)[0]

    def search_many(self, pairs_batch, slab: int = 1 << 20,
                    compact_m: int = COMPACT_CANDS, mesh=None
                    ) -> List[List[AccelCand]]:
        """Search many same-length spectra ([nd, numbins, 2] float32,
        numpy or a tensor) -> per-spectrum candidate lists, sorted by
        (-sigma, r), at most one per ~8 r-bins (apply remove_duplicates /
        eliminate_harmonics for the reference's final-list semantics).
        The trials are searched by parallel/sharded.sharded_accel_search_
        many over ``mesh`` (parallel/mesh.Mesh; ``pairs_batch`` may then
        be its per-shard tensors), by default a one-entry mesh of the
        searcher's device; the lists do not depend on the mesh.  A jerk
        search (cfg.wmax) takes one spectrum at a time on the searcher's
        device."""
        if self.cfg.wmax:
            if isinstance(pairs_batch, (list, tuple)):
                pairs_batch = torch.cat([p.to(self.device)
                                         for p in pairs_batch])
            batch = torch.as_tensor(pairs_batch, dtype=torch.float32,
                                    device=self.device)
            return [self._search_jerk(batch[d], slab, compact_m)
                    for d in range(batch.shape[0])]
        from presto_tpu_torch.parallel.mesh import Mesh
        from presto_tpu_torch.parallel.sharded import (
            sharded_accel_search_many)
        return sharded_accel_search_many(
            self, pairs_batch, mesh or Mesh((self.device,)), slab=slab,
            compact_m=compact_m)

    @staticmethod
    def _dedup_sort(cands: List[AccelCand]) -> List[AccelCand]:
        # the overlapped last slab duplicates candidates on purpose:
        # dedup on exact (numharm, r, z)
        seen = set()
        uniq = []
        for c in cands:
            key = (c.numharm, c.r, c.z)
            if key not in seen:
                seen.add(key)
                uniq.append(c)
        return sorted(uniq, key=lambda c: (-c.sigma, c.r))

    def _collect_group(self, vals: np.ndarray, cidx: np.ndarray,
                       zrow: np.ndarray, start_cols) -> List[AccelCand]:
        """Host collection over dense [nslabs, stages, k] output
        (search_ffdotpows, accel_utils.c:1259-1298)."""
        cfg = self.cfg
        sc = np.asarray(start_cols, dtype=np.int64)[:, None, None]
        absc = sc + cidx
        good = (vals > 0.0) & (zrow < cfg.numz)   # pad rows are zeros
        good &= absc >= self._r0min
        good &= absc < self._rtop
        stg = np.broadcast_to(
            np.arange(vals.shape[1], dtype=np.int32)[None, :, None],
            vals.shape)
        g = good.ravel()
        return self._cands_from_flat(
            vals.ravel()[g], absc.ravel()[g], zrow.ravel()[g],
            stg.ravel()[g])

    def collect_compacted(self, comp: np.ndarray, start_cols,
                          requested_m: Optional[int] = None
                          ) -> List[AccelCand]:
        """Host decode of compact_scan_packed output [3, m]; raises
        ValueError when all m slots are positive (possible truncation)."""
        cfg = self.cfg
        assert cfg.numz < (1 << _CMP_ZBITS), cfg.numz
        comp = np.asarray(comp)
        v = comp[0].view(np.float32)
        if (v.size and v[-1] > 0.0
                and (requested_m is None or v.size >= requested_m)):
            raise ValueError(
                "compact_scan_packed budget exhausted (m=%d slots all "
                "positive): candidates may have been dropped — raise m"
                % v.size)
        cidx = comp[1]
        zrow = comp[2] & ((1 << _CMP_ZBITS) - 1)
        stg = (comp[2] >> _CMP_ZBITS) & ((1 << _CMP_SBITS) - 1)
        si = comp[2] >> (_CMP_ZBITS + _CMP_SBITS)
        absc = np.asarray(start_cols, dtype=np.int64)[si] + cidx
        good = ((v > 0.0) & (zrow < cfg.numz) & (absc >= self._r0min)
                & (absc < self._rtop))
        return self._dedup_sort(self._cands_from_flat(
            v[good], absc[good], zrow[good], stg[good]))

    def _cands_from_flat(self, v: np.ndarray, absc: np.ndarray,
                         zrow: np.ndarray,
                         stg: np.ndarray) -> List[AccelCand]:
        """Filtered hits -> AccelCands, sigma batched per stage; float64
        (col * DR) / numharm and (-zmax + z * DZ) / numharm."""
        cfg = self.cfg
        out: List[AccelCand] = []
        for stage in np.unique(stg).tolist():
            m = stg == stage
            numharm = 1 << int(stage)
            sigmas = np.atleast_1d(st.candidate_sigma(
                v[m], numharm, self.numindep[stage]))
            rr = (absc[m] * ACCEL_DR) / numharm
            zz = (-cfg.zmax + zrow[m] * ACCEL_DZ) / numharm
            for p, s, r_, z_ in zip(v[m].tolist(), sigmas.tolist(),
                                    rr.tolist(), zz.tolist()):
                out.append(AccelCand(power=p, sigma=s, numharm=numharm,
                                     r=r_, z=z_))
        return out


def from_reference_arrays(cfg: AccelConfig, T: float, numbins: int,
                          kern_pairs: np.ndarray, fracs_zinds,
                          numindep, powcut, w_banks=None,
                          device="cuda") -> AccelSearch:
    """A searcher whose state comes from arrays built elsewhere (the JAX
    package's kernel bank, z-row maps and powcuts, as numpy; for a jerk
    search also its w banks, {w: kern_pairs}): ``cfg`` is the final
    configuration (after the uselen choice)."""
    s = AccelSearch(cfg, T, numbins, device=device)
    if s.cfg != cfg:
        raise ValueError("from_reference_arrays: cfg %r resolves to %r"
                         % (cfg, s.cfg))
    kern = replace(s.kern, kern_pairs=np.asarray(kern_pairs, np.float32))
    if kern.kern_pairs.shape != (kern.numz, kern.kmax, 2):
        raise ValueError("from_reference_arrays: kernel bank shape %s"
                         % (kern.kern_pairs.shape,))
    s._set_state(kern, fracs_zinds, numindep, powcut)
    for w, pairs in (w_banks or {}).items():
        if float(w) != 0.0:
            wk = replace(kern, kern_pairs=np.asarray(pairs, np.float32))
            if wk.kern_pairs.shape != kern.kern_pairs.shape:
                raise ValueError("from_reference_arrays: w bank %g shape %s"
                                 % (w, wk.kern_pairs.shape))
            s._w_banks[float(w)] = wk
    return s


# ----------------------------------------------------------------------
# Candidate post-processing (host)
# ----------------------------------------------------------------------

# The reference's "other common harmonic ratios" (accel_utils.c:415-439)
_HARM_RATIOS = [3 / 2, 5 / 2, 2 / 3, 4 / 3, 5 / 3, 3 / 4, 5 / 4, 2 / 5,
                3 / 5, 4 / 5, 5 / 6, 2 / 7, 3 / 7, 4 / 7, 3 / 8, 5 / 8,
                2 / 9, 3 / 10, 2 / 11, 3 / 11, 2 / 13, 3 / 13, 2 / 15]


def eliminate_harmonics(cands: List[AccelCand], tooclose: float = 1.5,
                        maxharm: int = 16) -> List[AccelCand]:
    """Drop less-significant harmonically related candidates
    (accel_utils.c:384-460): walking the (-sigma, r)-sorted list, a
    candidate goes when its r lies within ``tooclose`` of r_k*ii,
    r_k/ii (ii <= maxharm) or r_k*ratio for a kept r_k.  Each test runs
    over all kept candidates at once in numpy, with the float64
    products and quotients of the JAX package's loop, so the kept list
    is the same."""
    if not cands:
        return []
    cands = sorted(cands, key=lambda c: (-c.sigma, c.r))
    ii = np.arange(1, maxharm + 1, dtype=np.float64)
    ratios = np.asarray(_HARM_RATIOS, dtype=np.float64)
    kept: List[AccelCand] = []
    rk = np.empty(len(cands), dtype=np.float64)
    for c in cands:
        r = rk[:len(kept), None]
        rc = c.r
        if not kept or not (
                (np.abs(r / ii - rc) < tooclose).any()
                or (np.abs(r * ii - rc) < tooclose).any()
                or (np.abs(r * ratios - rc) < tooclose).any()):
            rk[len(kept)] = c.r
            kept.append(c)
    return kept


def remove_duplicates(cands: List[AccelCand]) -> List[AccelCand]:
    """Collapse candidates within ACCEL_CLOSEST_R bins of a stronger one
    (insert_new_accelcand, accel_utils.c:294-382), keyed on r alone."""
    kept: List[AccelCand] = []
    rk = np.empty(len(cands), dtype=np.float64)
    for c in sorted(cands, key=lambda c: (-c.sigma, c.r)):
        if not (np.abs(c.r - rk[:len(kept)]) < ACCEL_CLOSEST_R).any():
            rk[len(kept)] = c.r
            kept.append(c)
    return kept
