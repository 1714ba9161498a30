"""Online projection serving: the long-lived counterpart of ``project``.

A panel is fitted once and new samples are placed into its coordinates.
Offline, every ``project`` streams the panel again; this package keeps
the model and the panel resident on the device and answers queries one
at a time through a micro-batching queue, with bounded admission and
load-shedding, per-request deadlines and cancellation, an LRU result
cache keyed by genotype digest, and a graceful drain. A served row is
bit for bit the offline single-query ``project`` of that sample
(serve/engine.py).

- :class:`~spark_examples_tpu_torch.serve.engine.ProjectionEngine`: the
  device-resident model and panel (no queueing).
- :class:`~spark_examples_tpu_torch.serve.server.ProjectionServer`: the
  micro-batching worker and admission envelope over one engine.
- :mod:`~spark_examples_tpu_torch.serve.http`: a stdlib HTTP front.
- :mod:`~spark_examples_tpu_torch.serve.loadgen`: the closed-loop load
  generators behind ``serve --loadgen`` (single-model and the fleet's
  multi-tenant mix) and replica hedging.

Fleet serving (``serve --fleet fleet.json``) routes many named
(model, panel) pairs through one process:

- :mod:`~spark_examples_tpu_torch.serve.pool`: the warm panel pool,
  staged panels under an explicit budget with LRU eviction; an evicted
  panel re-stages on demand from its store.
- :mod:`~spark_examples_tpu_torch.serve.router`: priority-class
  admission (interactive before batch) and the fleet's one batching
  worker.
- :mod:`~spark_examples_tpu_torch.serve.fleet`: the manifest registry
  and fleet assembly.
"""

from spark_examples_tpu_torch.serve.cache import ResultCache, genotype_digest
from spark_examples_tpu_torch.serve.engine import ProjectionEngine
from spark_examples_tpu_torch.serve.fleet import (
    FleetFormatError,
    FleetManifest,
    build_fleet,
)
from spark_examples_tpu_torch.serve.health import (
    DEGRADED,
    DRAINING,
    HEALTHY,
    CircuitBreaker,
)
from spark_examples_tpu_torch.serve.loadgen import (
    BurstSchedule,
    run_fleet_loadgen,
    run_hedged_loadgen,
    run_loadgen,
)
from spark_examples_tpu_torch.serve.pool import PanelPool, PanelUnavailable
from spark_examples_tpu_torch.serve.router import FleetRouter, UnknownRoute
from spark_examples_tpu_torch.serve.server import (
    DeadlineExceeded,
    ProjectionServer,
    ServerClosed,
    ServerOverloaded,
)

__all__ = [
    "BurstSchedule",
    "CircuitBreaker",
    "DEGRADED",
    "DRAINING",
    "DeadlineExceeded",
    "FleetFormatError",
    "FleetManifest",
    "FleetRouter",
    "HEALTHY",
    "PanelPool",
    "PanelUnavailable",
    "ProjectionEngine",
    "ProjectionServer",
    "ResultCache",
    "ServerClosed",
    "ServerOverloaded",
    "UnknownRoute",
    "build_fleet",
    "genotype_digest",
    "run_fleet_loadgen",
    "run_hedged_loadgen",
    "run_loadgen",
]
