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
  generator behind ``serve --loadgen``.
"""

from spark_examples_tpu_torch.serve.cache import ResultCache, genotype_digest
from spark_examples_tpu_torch.serve.engine import ProjectionEngine
from spark_examples_tpu_torch.serve.health import (
    DEGRADED,
    DRAINING,
    HEALTHY,
    CircuitBreaker,
)
from spark_examples_tpu_torch.serve.loadgen import run_loadgen
from spark_examples_tpu_torch.serve.server import (
    DeadlineExceeded,
    ProjectionServer,
    ServerClosed,
    ServerOverloaded,
)

__all__ = [
    "CircuitBreaker",
    "DEGRADED",
    "DRAINING",
    "DeadlineExceeded",
    "HEALTHY",
    "ProjectionEngine",
    "ProjectionServer",
    "ResultCache",
    "ServerClosed",
    "ServerOverloaded",
    "genotype_digest",
    "run_loadgen",
]
