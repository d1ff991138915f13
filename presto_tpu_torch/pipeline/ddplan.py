"""DDplan: optimal dedispersion planning.

Host copy of ``presto_tpu/pipeline/ddplan.py`` for the PyTorch port, which imports
nothing from the JAX package.

Reference: bin/DDplan.py — choose (dDM, downsamp, dsubDM, #DMs, #calls)
per DM range so the total smearing (quadrature sum of sample time,
per-channel DM smearing, subband step smearing, and DM step smearing
across the band) stays near the floor set by the data, stepping to
coarser dDM/downsamp as channel smearing grows with DM.

Smearing model (DDplan.py:141-190):
  dm_smear       t = 1000 * |DM - cDM| * BW / (0.0001205 f^3)   [ms]
  BW_smear       dm_smear at the worst-case step error dDM/2 over BW
  subband_smear  dm_smear at dsubDM/2 over BW/numsub
Plan construction (dm_steps, DDplan.py:205-295): pick downsamp so
eff_dt tracks the channel smearing, pick dDM from an allowed ladder so
BW smearing ~ eff_dt, extend each method until channel smearing
dominates by smearfact=2, then coarsen.

Pure planning math — host float64, no device work.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

ALLOW_DDMS = (0.01, 0.02, 0.03, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0,
              2.0, 3.0, 5.0, 10.0, 20.0, 30.0, 50.0, 100.0, 200.0, 300.0)
ALLOW_DOWNSAMPS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
FF = 1.2          # time-scale equality fudge factor (DDplan.py:218)


def dm_smear(dm, bw_mhz, f_ctr_mhz, cdm=0.0):
    """Smearing (ms) from DM over bw centered at f_ctr (DDplan.py:146)."""
    return 1000.0 * np.abs(dm - cdm) * bw_mhz / (0.0001205
                                                 * f_ctr_mhz ** 3)


def bw_smear(dm_step, bw_mhz, f_ctr_mhz):
    """Worst-case step-error smearing over the band (DDplan.py:153)."""
    return dm_smear(0.5 * dm_step, bw_mhz, f_ctr_mhz)


def guess_dm_step(dt, bw_mhz, f_ctr_mhz):
    """dDM that makes full-band smearing equal dt (DDplan.py:161)."""
    return dt * 0.0001205 * f_ctr_mhz ** 3 / (0.5 * bw_mhz)


def subband_smear(sub_dm_step, numsub, bw_mhz, f_ctr_mhz):
    """Step-error smearing within one subband (DDplan.py:169)."""
    if numsub == 0:
        return 0.0
    return dm_smear(0.5 * sub_dm_step, bw_mhz / numsub, f_ctr_mhz)


@dataclass
class Observation:
    dt: float            # s
    f_ctr: float         # MHz
    bw: float            # MHz
    numchan: int
    cdm: float = 0.0     # coherent (already-removed) DM

    @property
    def chanwidth(self) -> float:
        return self.bw / self.numchan


@dataclass
class DedispMethod:
    """One row of the DDplan table: a (dDM, downsamp) regime."""
    obs: Observation
    downsamp: int
    lodm: float
    ddm: float
    numsub: int = 0
    bw_smearing: float = 0.0
    dsub_dm: float = 0.0
    dms_per_prepsub: int = 0
    numprepsub: int = 0
    numdms: int = 0
    hidm: float = 0.0

    @property
    def dms(self) -> np.ndarray:
        return self.lodm + np.arange(self.numdms) * self.ddm

    def chan_smear(self, dm):
        dm = np.where(np.asarray(dm) - self.obs.cdm == 0.0,
                      self.obs.cdm + self.ddm / 2.0, dm)
        return dm_smear(dm, self.obs.chanwidth, self.obs.f_ctr,
                        self.obs.cdm)

    def total_smear(self, dm):
        """Quadrature total (DDplan.py:71-82)."""
        return np.sqrt((1000.0 * self.obs.dt) ** 2
                       + (1000.0 * self.obs.dt * self.downsamp) ** 2
                       + self.bw_smearing ** 2
                       + subband_smear(self.dsub_dm, self.numsub,
                                       self.obs.bw, self.obs.f_ctr) ** 2
                       + self.chan_smear(dm) ** 2)

    def dm_for_smearfact(self, smearfact: float) -> float:
        """DM where channel smearing = smearfact x everything else
        (DDplan.py:83-92)."""
        other = np.sqrt((1000.0 * self.obs.dt) ** 2
                        + (1000.0 * self.obs.dt * self.downsamp) ** 2
                        + self.bw_smearing ** 2
                        + subband_smear(self.dsub_dm, self.numsub,
                                        self.obs.bw,
                                        self.obs.f_ctr) ** 2)
        return smearfact * 0.001 * other / self.obs.chanwidth \
            * 0.0001205 * self.obs.f_ctr ** 3 + self.obs.cdm

    def __str__(self):
        if self.numsub:
            return ("%9.3f  %9.3f  %6.2f    %4d  %6.2f  %6d  %6d  %6d"
                    % (self.lodm, self.hidm, self.ddm, self.downsamp,
                       self.dsub_dm, self.numdms, self.dms_per_prepsub,
                       self.numprepsub))
        return "%9.3f  %9.3f  %6.2f    %4d  %6d" % (
            self.lodm, self.hidm, self.ddm, self.downsamp, self.numdms)


def make_method(obs: Observation, downsamp: int, lodm: float,
                hidm: float, ddm: float, numsub: int = 0,
                smearfact: float = 2.0) -> DedispMethod:
    """Build one regime: subband step sizing + crossover DM
    (dedisp_method.__init__, DDplan.py:22-61)."""
    m = DedispMethod(obs=obs, downsamp=downsamp, lodm=lodm, ddm=ddm,
                     numsub=numsub)
    m.bw_smearing = bw_smear(ddm, obs.bw, obs.f_ctr)
    if numsub:
        dms_per = 2
        while True:
            next_dsub = (dms_per + 2) * ddm
            next_ss = subband_smear(next_dsub, numsub, obs.bw, obs.f_ctr)
            # 0.8 fudge keeps subband smearing subdominant (DDplan.py:38)
            if next_ss > 0.8 * min(m.bw_smearing,
                                   1000.0 * obs.dt * downsamp):
                m.dsub_dm = dms_per * ddm
                m.dms_per_prepsub = dms_per
                break
            dms_per += 2
    else:
        m.dsub_dm = ddm
    # The crossover may fall below lodm when channel smearing already
    # dominates there — clamp so every regime covers at least one step
    # (otherwise numdms goes negative and the plan is empty).
    cross = min(max(m.dm_for_smearfact(smearfact), lodm + ddm), hidm)
    m.numdms = max(int(np.ceil((cross - lodm) / ddm)), 1)
    if numsub:
        m.numprepsub = int(np.ceil(m.numdms * ddm / m.dsub_dm))
        m.numdms = m.numprepsub * m.dms_per_prepsub
    m.hidm = lodm + m.numdms * ddm
    return m


@dataclass
class DDplan:
    obs: Observation
    lodm: float
    hidm: float
    methods: List[DedispMethod] = field(default_factory=list)

    @property
    def total_numdms(self) -> int:
        return sum(m.numdms for m in self.methods)

    @property
    def dms(self) -> np.ndarray:
        return np.concatenate([m.dms for m in self.methods]) \
            if self.methods else np.zeros(0)

    def work_fracts(self) -> np.ndarray:
        w = np.array([m.numdms / m.downsamp for m in self.methods],
                     dtype=np.float64)
        return w / w.sum()

    def __str__(self):
        sub = self.methods and self.methods[0].numsub
        if sub:
            hdr = ("  Low DM    High DM     dDM  DownSamp  dsubDM   "
                   "#DMs  DMs/call  calls")
        else:
            hdr = "  Low DM    High DM     dDM  DownSamp   #DMs"
        rows = [hdr] + [str(m) for m in self.methods]
        return "\n".join(rows) + "\n"


def plan_dedispersion(obs: Observation, lodm: float, hidm: float,
                      numsub: int = 0, ok_smearing: float = 0.0,
                      allow_ddms=ALLOW_DDMS,
                      allow_downsamps=ALLOW_DOWNSAMPS) -> DDplan:
    """Compute the DDplan (dm_steps, DDplan.py:205-295)."""
    dtms = 1000.0 * obs.dt
    min_chan_smearing = float(dm_smear(
        np.linspace(lodm, hidm, 10000), obs.chanwidth, obs.f_ctr,
        obs.cdm).min())
    ok_smearing = max(ok_smearing, min_chan_smearing,
                      bw_smear(allow_ddms[0], obs.bw, obs.f_ctr), dtms)

    i_ds = 0
    if FF * min_chan_smearing > dtms or ok_smearing > dtms:
        okval = ok_smearing if ok_smearing > FF * min_chan_smearing \
            else FF * min_chan_smearing
        while (i_ds + 1 < len(allow_downsamps)
               and dtms * allow_downsamps[i_ds + 1] < okval):
            i_ds += 1
    downsamp = allow_downsamps[i_ds]

    i_ddm = 0
    ddm_guess = guess_dm_step(obs.dt * downsamp, obs.bw, obs.f_ctr)
    while (i_ddm + 1 < len(allow_ddms)
           and allow_ddms[i_ddm + 1] < FF * ddm_guess):
        i_ddm += 1

    plan = DDplan(obs=obs, lodm=lodm, hidm=hidm)
    plan.methods.append(make_method(obs, downsamp, lodm, hidm,
                                    allow_ddms[i_ddm], numsub=numsub))
    while plan.methods[-1].hidm < hidm:
        i_ds = min(i_ds + 1, len(allow_downsamps) - 1)
        downsamp = allow_downsamps[i_ds]
        eff_dt = dtms * downsamp
        while (i_ddm + 1 < len(allow_ddms)
               and bw_smear(allow_ddms[i_ddm + 1], obs.bw,
                            obs.f_ctr) < FF * eff_dt):
            i_ddm += 1
        nxt = make_method(obs, downsamp, plan.methods[-1].hidm, hidm,
                          allow_ddms[i_ddm], numsub=numsub)
        if nxt.numdms <= 0:
            break
        plan.methods.append(nxt)
    return plan
