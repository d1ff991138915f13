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

Fleet scale (N replicas, one shared on-disk job ledger, the JAX
package's files):

  jobledger.py  durable job ledger (pipeline/leaseledger core: leases,
                heartbeats, epoch fencing, staged fence-checked
                commits) + tenant WRR fairness and quotas + job
                dependencies (blocked_on, fenced dynamic fan-out)
  usage.py      the per-tenant usage journal (usage.jsonl)
  fleet.py      FleetReplica: the lease-and-execute pump around one
                SearchService, with graceful drain and chaos points
  router.py     front-door admission (shedding with Retry-After, typed
                tenant-quota rejections, /dag, /campaign, /scale)
  dag.py        discovery DAGs: search -> sift -> (triage) -> folds ->
                toa as one submitted unit (POST /dag), with stacked
                same-geometry folds
  campaign.py   campaign ledgers: waves of DAGs over a manifest

The control plane above the fleets:

  supervisor.py FleetSupervisor: the actuator that spawns and drains
                replica processes from the router's /scale advisory
                (hysteresis, cooldown, repair, crash-only registry,
                preempt_fraction); apps/supervise.py is its CLI
  federation.py FederationRouter over N fleets: priced placement,
                spill-over, whole-fleet failover through FedLedger's
                epoch fence, federated metric/SLO/usage folds, presto-fed
"""

from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.queue import (Job, JobQueue, JobStatus, Lanes,
                                          QueueClosed, QueueFull)
from presto_tpu_torch.serve.scheduler import (JobTimeout, Scheduler,
                                              SchedulerConfig,
                                              is_device_error)
from presto_tpu_torch.serve.server import (SearchService, ServeHTTPServer,
                                           start_http)
from presto_tpu_torch.serve.jobledger import (JobLedger, JobLedgerError,
                                              StaleResultError,
                                              TenantQuotaExceeded)
from presto_tpu_torch.serve.dag import (build_node_job, execute_node,
                                        plan_dag, run_folds_stacked)
from presto_tpu_torch.serve.fleet import (FleetConfig, FleetReplica,
                                          artifact_digests)
from presto_tpu_torch.serve.router import (FleetBusy, FleetRouter,
                                           NoReadyReplica, RouterConfig)
from presto_tpu_torch.serve.supervisor import (FleetSupervisor,
                                               SupervisorConfig)
from presto_tpu_torch.serve.federation import (FederationConfig,
                                               FederationRouter, FedLedger,
                                               FleetMember, start_fed_http)

__all__ = [
    "EventLog", "FedLedger", "FederationConfig", "FederationRouter",
    "FleetBusy", "FleetConfig", "FleetMember", "FleetReplica",
    "FleetRouter", "FleetSupervisor", "Job", "JobLedger", "JobLedgerError",
    "JobQueue", "JobStatus", "JobTimeout", "Lanes", "NoReadyReplica",
    "QueueClosed", "QueueFull", "RouterConfig", "Scheduler",
    "SchedulerConfig", "SearchService", "ServeHTTPServer",
    "StaleResultError", "SupervisorConfig", "TenantQuotaExceeded",
    "artifact_digests", "build_node_job", "execute_node", "is_device_error",
    "plan_dag", "run_folds_stacked", "start_fed_http", "start_http",
]
