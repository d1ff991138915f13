"""presto_tpu_torch.serve — the always-on search service.

The port of ``presto_tpu/serve``'s core: an always-on service whose
scheduler thread does the device work, fed by a bounded two-lane queue.

  queue.py      bounded priority job queue with backpressure and the
                deadline/throughput lanes
  scheduler.py  the serving loop: same-bucket coalescing, per-job
                timeout, bounded retry with exponential backoff, plan
                eviction on a device error
  server.py     SearchService (survey jobs, and in-process callable jobs:
                the stream's deadline-lane ticks) + threaded HTTP front
                end (/submit /healthz /readyz /metrics /events /jobs)
  plancache.py  the searcher-plan cache, its pad-to-bucket keys and the
                persistent plan store
  batchexec.py  the stacked cross-job batch executor
  events.py     structured JSON event log with a resumable cursor

The fleet (job ledger, replicas, router, DAGs) comes with ROADMAP queue
1 item 3.
"""

from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.queue import (Job, JobQueue, JobStatus, Lanes,
                                          QueueClosed, QueueFull)
from presto_tpu_torch.serve.scheduler import (JobTimeout, Scheduler,
                                              SchedulerConfig,
                                              is_device_error)
from presto_tpu_torch.serve.server import (SearchService, ServeHTTPServer,
                                           start_http)

__all__ = [
    "EventLog", "Job", "JobQueue", "JobStatus", "JobTimeout", "Lanes",
    "QueueClosed", "QueueFull", "Scheduler", "SchedulerConfig",
    "SearchService", "ServeHTTPServer", "is_device_error", "start_http",
]
