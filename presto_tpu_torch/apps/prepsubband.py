"""prepsubband: raw data -> numdms dedispersed series in one pass.

PyTorch counterpart of ``presto_tpu/apps/prepsubband.py``: the same
flags and two-level subband delay scheme (src/prepsubband.c,
dispersion.c:103-162), the streamed block loop, the DM-sharded mesh path
(the mpiprepsubband analog), the hand-off of the DM fan-out to an
in-memory stage seam, multi-process runs (-coordinator, -nproc,
-procid), elastic leased-shard runs (-elastic) and -resume.  Output
bytes equal the JAX package's.

The filterbank streams through the native prefetching feeder and
decoder into pinned staging buffers (pipeline/fusion.feed_blocks): the
mask substitution, clip and -ignorechan run there on the host, in NumPy
(the clip's reduction order fixes the .dat bytes), the upload is
asynchronous (one copy to each distinct device of the mesh) and the
time-major -> channel-major transpose runs on the device.  -mask takes
its padding values from the .stats beside the mask, as the JAX package
does.

The mesh: when more than one device is visible (parallel/mesh.
visible_devices: every card, or logical shards) or the run spans several
processes, and numdms divides the device count of the whole run, each
device dedisperses a contiguous range of the DM rows (parallel/sharded.
ShardedDedispPlan); setting PRESTO_TORCH_DISABLE_MESH turns it off.  A
multi-process run must take it (numdms not dividing raises): each
process reads the file, dedisperses its own rows on its own devices and
writes only those rows' files.

Not in this slice (they raise NotImplementedError): -sub, barycentring
(run with -nobary) and PSRFITS input.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from presto_tpu_torch.apps.common import (CLIResume, add_common_flags,
                                          add_raw_flags, block_prep,
                                          fil_to_inf, good_numout, open_raw,
                                          pad_to_good_N, set_onoff,
                                          start_skip_spectra,
                                          stream_blocklen)
from presto_tpu_torch.io.datfft import write_dat
from presto_tpu_torch.obs import costmodel, devtel
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.parallel import mesh as pmesh
from presto_tpu_torch.parallel.sharded import ShardedDedispPlan
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.search.accel import resolve_device

#: set (to anything) to keep a run with several devices on one device
DISABLE_MESH_ENV = "PRESTO_TORCH_DISABLE_MESH"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prepsubband",
        description="De-disperse raw data into many DM trials")
    add_common_flags(p)
    p.add_argument("-lodm", type=float, default=0.0)
    p.add_argument("-dmstep", type=float, default=1.0)
    p.add_argument("-numdms", type=int, default=10)
    p.add_argument("-nsub", type=int, default=32)
    p.add_argument("-downsamp", type=int, default=1)
    p.add_argument("-mask", type=str, default=None)
    p.add_argument("-clip", type=float, default=6.0)
    p.add_argument("-zerodm", action="store_true")
    p.add_argument("-nobary", action="store_true")
    p.add_argument("-numout", type=int, default=0)
    p.add_argument("-runavg", action="store_true")
    p.add_argument("-sub", action="store_true")
    p.add_argument("-subdm", type=float, default=None)
    p.add_argument("-dmprec", type=int, default=2)
    p.add_argument("-ignorechan", type=str, default=None)
    p.add_argument("-coordinator", type=str, default=None,
                   help="host:port of the process group's rendezvous "
                        "(multi-process runs; give -nproc and -procid)")
    p.add_argument("-nproc", type=int, default=None,
                   help="Total process count of the multi-process run")
    p.add_argument("-procid", type=int, default=None,
                   help="This process's id (0-based)")
    p.add_argument("-elastic", action="store_true",
                   help="Run the DM fan-out as leased shards from a "
                        "crash-safe shard ledger")
    p.add_argument("-shard-rows", dest="shard_rows", type=int, default=0,
                   help="DM rows per elastic shard (0 = auto)")
    p.add_argument("-lease-ttl", dest="lease_ttl", type=float,
                   default=120.0, help="Elastic shard lease TTL in seconds")
    p.add_argument("-barrier-timeout", dest="barrier_timeout", type=float,
                   default=60.0,
                   help="Max seconds any collective may stall before the "
                        "survivors go on")
    p.add_argument("-heartbeat-interval", dest="heartbeat_interval",
                   type=float, default=2.0,
                   help="Elastic heartbeat cadence in seconds")
    p.add_argument("-resume", action="store_true",
                   help="Skip a run whose .dat/.inf outputs verify against "
                        "the manifest.json journal beside them; journal "
                        "the outputs on completion")
    add_raw_flags(p)
    p.add_argument("rawfiles", nargs="+")
    return p


def plan_delays(hdr, args):
    """Two-level delays: channel->subband at the center DM (or -subdm),
    then per-DM subband offsets (prepsubband.c:353-372)."""
    nchan, dt = hdr.nchans, hdr.tsamp
    dms = args.lodm + np.arange(args.numdms) * args.dmstep
    center_dm = args.lodm + 0.5 * (args.numdms - 1) * args.dmstep
    if getattr(args, "subdm", None) is not None:
        center_dm = args.subdm
    chan_del = dd.subband_search_delays(nchan, args.nsub, center_dm,
                                        hdr.lofreq, abs(hdr.foff))
    chan_bins = dd.delays_to_bins(chan_del, dt)
    sub_del = np.stack([dd.subband_delays(nchan, args.nsub, dm,
                                          hdr.lofreq, abs(hdr.foff))
                        for dm in dms])
    sub_del -= sub_del.min()
    dm_bins = dd.delays_to_bins(sub_del, dt)
    return dms, chan_bins, dm_bins


def _refuse_unported(args) -> None:
    for flag, on in (("-sub", args.sub),
                     ("barycentring (pass -nobary)", not args.nobary),
                     ("-psrfits", args.psrfits)):
        if on:
            raise NotImplementedError(
                "prepsubband: %s comes in a later slice of the port"
                % flag)
    if args.downsamp < 1:
        raise SystemExit("prepsubband: -downsamp must be >= 1")


class _Setup:
    """What every execution path (the streamed mesh run and the elastic
    shard loop) derives from the args and the raw header: the open
    reader and the FULL-range delay plan and geometry.  A shard must use
    the full-range plan (centre DM, delay normalization, blocklen, valid
    length), or its rows would not be byte-equal to an unsharded run's."""

    def __init__(self, args):
        self.fb = open_raw(args.rawfiles)
        hdr = self.hdr = self.fb.header
        self.nchan, self.dt = hdr.nchans, hdr.tsamp
        self.skip = start_skip_spectra(args, int(hdr.N))
        self.Neff = int(hdr.N) - self.skip
        self.dms, self.chan_bins, self.dm_bins = plan_delays(hdr, args)
        self.maxd = int(self.chan_bins.max()) + int(self.dm_bins.max())
        blocklen = stream_blocklen(
            self.nchan, max(int(self.chan_bins.max()),
                            int(self.dm_bins.max())), nspec=self.Neff)
        if blocklen % args.downsamp:
            blocklen += args.downsamp - blocklen % args.downsamp
        self.blocklen = blocklen
        self.valid = max((self.Neff - self.maxd) // args.downsamp, 0)

    def trial_inf(self, args, name, numout, valid, dmval):
        info = fil_to_inf(self.fb, name, numout, dm=float(dmval))
        if self.skip:
            info.mjd_f += self.skip * self.dt / 86400.0
            info.mjd_i += int(info.mjd_f)
            info.mjd_f %= 1.0
        info.dt = self.dt * args.downsamp
        set_onoff(info, valid, numout)
        info.name = name
        info.N = numout
        return info


def _trial_names(args):
    """(outbase, per-DM base names): known from the args alone, so
    -resume can verify before any compute."""
    outbase = args.outfile or "prepsubband_out"
    dms = args.lodm + np.arange(args.numdms) * args.dmstep
    return outbase, ["%s_DM%.*f" % (outbase, args.dmprec, dm) for dm in dms]


def _dedisperse(s: _Setup, args, plan: ShardedDedispPlan, width: int,
                obs=None):
    """One streamed pass over the file through ``plan``: per-shard output
    tensors [rows_k, width] on the shards' devices, the data in
    [:, :s.valid].  Each block's series goes straight into its columns:
    no list of blocks and no concatenation held beside them.  ``obs``
    books each steady step as one dedisp dispatch a shard, with the
    unit cost of one shard's step."""
    outs = [torch.empty((hi - lo, width), dtype=torch.float32, device=d)
            for d, (lo, hi) in zip(plan.devices, plan.row_ranges)]
    distinct = plan.mesh.distinct_devices()
    nblocks = -(-s.Neff // s.blocklen) + 2   # data, then two zero flushes
    pos = 0
    prev_raw = prev_sub = None
    with contextlib.closing(fusion.feed_blocks(
            s.fb, block_prep(args, s.nchan, s.dt), s.blocklen, nblocks,
            distinct, skip=s.skip)) as feed:
        for _nread, blk in feed:
            by_dev = dict(zip(distinct, blk))
            cur = [by_dev[d] for d in plan.devices]
            if prev_raw is not None:
                if prev_sub is None:
                    prev_sub = plan.prime(prev_raw, cur)
                else:
                    lo, hi = plan.row_ranges[0]
                    costmodel.probe(obs, "dedisp", numdms=hi - lo,
                                    nsub=args.nsub, nchan=s.nchan,
                                    numpts=s.blocklen)
                    devtel.note_dispatch(obs, "dedisp", len(plan.devices))
                    prev_sub, series = plan.step(prev_raw, cur, prev_sub)
                    take = min(series[0].shape[1], s.valid - pos)
                    if take > 0:
                        for o, ser in zip(outs, series):
                            o[:, pos:pos + take] = ser[:, :take]
                        pos += take
            prev_raw = cur
    return outs


def run(args, device="cuda", seam: fusion.StageSeam = None):
    """Dedisperse ``args.rawfiles`` on ``device`` (split over the mesh of
    its visible devices, see the module docstring).  With a ``seam`` (a
    one-process run) the fan-out is deposited there (see _seam_handoff);
    otherwise the .dat and .inf files are written, by each process for
    its own rows.  Returns (outbase, dms)."""
    if args.elastic:
        return _elastic_run(args, device)
    _refuse_unported(args)
    dev = resolve_device(device)
    nproc, rank = 1, 0
    if args.coordinator or args.nproc is not None:
        nproc = pmesh.init_distributed(args.coordinator, args.nproc,
                                       args.procid)
        rank = pmesh.process_index()
        print("prepsubband: joined a %d-process cluster as process %d"
              % (nproc, rank))
    outbase, names = _trial_names(args)
    resume = None
    if args.resume and nproc == 1:
        expected = [n + x for n in names for x in (".dat", ".inf")]
        resume = CLIResume(outbase, "prepsubband-cli")
        if resume.complete(expected):
            print("prepsubband: -resume verified %d DM outputs against the "
                  "journal — skipping" % len(names))
            return outbase, args.lodm + np.arange(args.numdms) * args.dmstep
        resume.invalidate_stale(expected)
    local = pmesh.visible_devices(dev)
    ndev = nproc * len(local)
    disabled = bool(os.environ.get(DISABLE_MESH_ENV))
    use_mesh = ndev > 1 and args.numdms % ndev == 0 and not disabled
    if not use_mesh and nproc > 1:
        # the one-device fallback would have every process compute the
        # whole job and race on the same files
        raise SystemExit(
            "prepsubband: a multi-process run needs the DM-sharded path: "
            "numdms (%d) must divide the run's device count (%d), and %s "
            "must be unset" % (args.numdms, ndev, DISABLE_MESH_ENV))
    if use_mesh:
        mesh = pmesh.Mesh(tuple(local))
        where = (", ".join(str(d) for d in local)
                 if len(set(local)) == len(local)
                 else "%d logical shards of %s" % (len(local), local[0]))
        print("prepsubband: DM fan-out sharded over %d devices (%s%s)"
              % (ndev, where, " in each of %d processes" % nproc
                 if nproc > 1 else ""))
    else:
        mesh = pmesh.Mesh((dev,))
        if ndev > 1:
            print("prepsubband: %d devices visible but %s — running on "
                  "one device" % (ndev, "%s is set" % DISABLE_MESH_ENV
                                  if disabled else "numdms=%d is not "
                                  "divisible by %d" % (args.numdms, ndev)))
    s = _Setup(args)
    # this process's DM rows: all of them, or its share of a cluster run
    per = args.numdms // nproc
    lo, hi = rank * per, (rank + 1) * per
    plan = ShardedDedispPlan(mesh, args.nsub, args.downsamp, s.chan_bins,
                             s.dm_bins[lo:hi])
    use_seam = seam is not None and nproc == 1
    if use_mesh:
        print("prepsubband: sharded routing = %s"
              % ("fused-seam" if use_seam else "staged"))
    width = (max(s.valid, good_numout(s.valid, args.numout)) if use_seam
             else s.valid)
    parts = _dedisperse(s, args, plan, width,
                        obs=seam.obs if use_seam else None)
    if use_seam:
        return _seam_handoff(args, s, seam, parts, plan, outbase,
                             names, sharded=use_mesh)
    host = fusion.gather_shards([p[:, :s.valid] for p in parts],
                                plan.row_ranges)
    result, valid, numout = pad_to_good_N(host, args.numout)
    for row, i in enumerate(range(lo, hi)):
        write_dat(names[i] + ".dat", result[row],
                  s.trial_inf(args, names[i], numout, valid, s.dms[i]))
    s.fb.close()
    if resume is not None:
        resume.record([names[i] + x for i in range(lo, hi)
                       for x in (".dat", ".inf")])
    if nproc > 1:
        import torch.distributed as dist
        dist.barrier()
    print("Wrote %d DMs x %d samples (lodm=%g dmstep=%g nsub=%d)"
          % (hi - lo, numout, args.lodm, args.dmstep, args.nsub))
    return outbase, s.dms


def _seam_handoff(args, s: _Setup, seam, parts, plan, outbase, names,
                  sharded: bool):
    """Deposit the DM fan-out at the seam: one download a shard gives the
    host copy; the pad tail is computed on the host with pad_to_good_N's
    NumPy semantics and written into each shard's spare columns, so the
    device series equal the .dat bytes bit for bit.  Each part is
    [rows_k, >= max(valid, numout)] with the data in [:, :valid].  On the
    mesh the deposit is a ShardedSeamBlock whose shards stay where they
    were dedispersed."""
    nvalid = s.valid
    host, valid, numout = pad_to_good_N(
        fusion.gather_shards([p[:, :nvalid] for p in parts],
                             plan.row_ranges), args.numout)
    devs = []
    for p, (lo, hi) in zip(parts, plan.row_ranges):
        if numout > nvalid:
            p[:, nvalid:numout] = torch.from_numpy(
                np.ascontiguousarray(host[lo:hi, nvalid:]))
        devs.append(p if p.shape[1] == numout
                    else p[:, :numout].contiguous())
    infos = [s.trial_inf(args, name, numout, valid, dmval)
             for name, dmval in zip(names, s.dms)]
    kw = dict(names=names, infos=infos, dms=[float(d) for d in s.dms],
              series_host=host, valid=valid, numout=numout,
              dt=s.dt * args.downsamp)
    if sharded:
        seam.add_block(fusion.ShardedSeamBlock(
            series_dev=devs, row_ranges=list(plan.row_ranges),
            mesh=plan.mesh, **kw))
    else:
        seam.add_block(fusion.SeamBlock(series_dev=devs[0], **kw))
    s.fb.close()
    return outbase, s.dms


def _elastic_run(args, device):
    """The worker-loss-tolerant DM fan-out: every DM shard is a leased row
    in the workdir's shard ledger, any process computes any shard on its
    own device with the full-range plan, and commits ride the ledger's
    epoch fence, so a dead member costs a lease TTL, not the run."""
    from presto_tpu_torch.io.infodata import write_inf
    from presto_tpu_torch.parallel import elastic
    from presto_tpu_torch.pipeline.shardledger import make_dm_shards

    if args.sub:
        raise SystemExit("prepsubband: -elastic does not support -sub")
    _refuse_unported(args)
    dev = resolve_device(device)
    outbase, names = _trial_names(args)
    workdir = os.path.dirname(os.path.abspath(outbase)) or "."
    host = elastic.default_host_id(args.procid)
    ecfg = elastic.ElasticConfig(
        barrier_timeout=args.barrier_timeout, lease_ttl=args.lease_ttl,
        heartbeat_interval=args.heartbeat_interval,
        shard_rows=args.shard_rows)
    cluster = elastic.ElasticCluster(workdir, host, ecfg)
    cluster.join(args.coordinator, args.nproc, args.procid)
    s = _Setup(args)
    nproc = max(int(args.nproc or 1), 1)
    # auto shard size: ~2 shards a process, so one loss re-admits at most
    # half a process's work
    rows = args.shard_rows or max(1, -(-args.numdms // (2 * nproc)))
    # shard ids name the method (its first trial): the survey runs every
    # DDplan method in one workdir and so one ledger, and plain "dm0000"
    # ids would find a later method's shards done by an earlier one's
    specs = make_dm_shards(args.numdms, rows,
                           prefix=os.path.basename(names[0]) + "-")

    def compute(lease):
        lo, hi = lease.rows
        plan = ShardedDedispPlan(pmesh.Mesh((dev,)), args.nsub,
                                 args.downsamp, s.chan_bins,
                                 s.dm_bins[lo:hi])
        out = _dedisperse(s, args, plan, s.valid)[0]
        result, valid, numout = pad_to_good_N(out.cpu().numpy(),
                                              args.numout)
        staged = {}
        for k, i in enumerate(range(lo, hi)):
            name = names[i]
            info = s.trial_inf(args, name, numout, valid, s.dms[i])
            dat_tmp = elastic.stage_path(name + ".dat", host, lease.epoch)
            inf_tmp = elastic.stage_path(name + ".inf", host, lease.epoch)
            write_dat(dat_tmp, result[k])
            write_inf(info, inf_tmp)
            staged[os.path.abspath(name + ".dat")] = dat_tmp
            staged[os.path.abspath(name + ".inf")] = inf_tmp
        return staged

    try:
        n = cluster.run(specs, compute,
                        meta={"outbase": os.path.basename(outbase),
                              "numdms": int(args.numdms),
                              "shard_rows": int(rows)})
    finally:
        cluster.close()
        s.fb.close()
    print("prepsubband: elastic run complete — %d/%d shards by this "
          "process (epoch %d)" % (n, len(specs), cluster.epoch))
    return outbase, s.dms


def main(argv=None, device="cuda"):
    run(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
