"""presto_tpu_torch.stream — the live streaming search on the card.

The port of ``presto_tpu/stream``: a live filterbank feed in, single-
pulse triggers out within seconds.

  * source.py  — bounded ring-buffer block source behind the reader
    seam, fed by a socket or file-tail producer; backpressure with
    drop accounting, dropout quarantine via io/quality.
  * rolling.py — rolling dedispersion over the DM grid (the two-block
    carry of ops/dedispersion, resident on the card) plus incremental
    single-pulse triggering (search/singlepulse.SinglePulseStream)
    that matches the batch search on the same bytes.
  * service.py — the presto-stream CLI and the deadline-lane glue into
    the port's serve scheduler; triggers stream on serve's /events.
  * beams.py   — the presto-beams multiplexer: N same-geometry beam
    feeds stacked into ONE rolling-dedispersion step per deadline tick,
    with per-beam QoS degradation, a cross-beam coincidence veto, and
    lease/fence beam hand-off across replicas.

Every entry point runs on the CUDA device unless the caller passes
device="cpu"; none falls back.
"""

from presto_tpu_torch.stream.rolling import (RollingDedisp, StreamConfig,
                                             StreamSearch, Trigger)
from presto_tpu_torch.stream.source import (FileTailProducer,
                                            RingBlockSource,
                                            SocketProducer, StreamBlock,
                                            feed_stream)
from presto_tpu_torch.stream.service import StreamService
from presto_tpu_torch.stream.beams import (BeamLedger, BeamMultiplexer,
                                           CoincidenceVeto,
                                           StackedRollingDedisp,
                                           make_beam_block_step)

__all__ = [
    "RollingDedisp", "StreamConfig", "StreamSearch", "Trigger",
    "FileTailProducer", "RingBlockSource", "SocketProducer",
    "StreamBlock", "feed_stream", "StreamService",
    "BeamLedger", "BeamMultiplexer", "CoincidenceVeto",
    "StackedRollingDedisp", "make_beam_block_step",
]
