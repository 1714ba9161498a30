"""Fleet control plane: the replica controller over serve replicas.

The serve layer (serve/) is one process; this package is the layer
that owns MANY of them — spawning, watching, draining, and scaling a
pool of serve replicas against the autoscale signals they already
export on ``GET /metrics``:

- :mod:`~spark_examples_tpu_torch.fleet.replica` — the replica handle: a
  transport-decoupled :class:`ReplicaSnapshot` built either from a
  real Prometheus ``/metrics`` scrape (subprocess replicas) or
  directly from an in-process :class:`FleetRouter` (tests), plus the
  process lifecycle (heartbeat files, SIGTERM drain, TERM->KILL
  escalation — core/supervisor.py idiom) and the fleet's one child
  command, :func:`serve_child_command` (this package's ``serve
  --fleet`` on the controller's ``--device``).
- :mod:`~spark_examples_tpu_torch.fleet.placement` — first-fit-decreasing
  bin packing of panel bytes against per-replica warm-pool budgets:
  which replica keeps which panel warm.
- :mod:`~spark_examples_tpu_torch.fleet.controller` — the control loop:
  crash/hang/stale-scrape detection, bounded-backoff respawn with a
  flap breaker, sustained-pressure scale-up, idle drain-retire,
  graceful preemption, an atomic incident ledger
  (``controller.json``), and ``controller.*`` telemetry.
- :mod:`~spark_examples_tpu_torch.fleet.slo` and
  :mod:`~spark_examples_tpu_torch.fleet.timeline` — the flight
  recorder: the per-round ``timeline.jsonl`` ring, its fleet folds and
  ``GET /fleet/metrics``, and the manifest's SLOs evaluated as
  multi-window burn rates over it.

Plain Python over the serve layer, as in the JAX package: no module
here touches a device.
"""

from spark_examples_tpu_torch.fleet.controller import (
    ControllerConfig,
    FleetController,
)
from spark_examples_tpu_torch.fleet.placement import Placement, pack
from spark_examples_tpu_torch.fleet.replica import (
    LocalReplica,
    ProcessReplica,
    Replica,
    ReplicaSnapshot,
    ScrapeError,
    parse_prometheus,
    serve_child_command,
)

__all__ = [
    "ControllerConfig",
    "FleetController",
    "LocalReplica",
    "Placement",
    "ProcessReplica",
    "Replica",
    "ReplicaSnapshot",
    "ScrapeError",
    "pack",
    "parse_prometheus",
    "serve_child_command",
]
