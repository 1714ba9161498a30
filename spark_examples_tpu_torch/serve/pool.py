"""The fleet's warm panel pool: staged reference panels under a budget.

A single-model server stages its panel once and keeps it forever; a
fleet process serves *many* (model, panel) routes, and the panels are
the expensive part — dense device-resident genotype blocks, megabytes
to gigabytes each. The pool is the explicit device-memory discipline
over them:

- **Lazy staging.** A route's panel is staged on first demand, through
  the ordinary store read path (readahead, decode cache, verify —
  whatever the route's IngestConfig arms), inside a ``fleet.stage``
  span with the ``fleet.stage`` fault site fired first.
- **Budget + LRU.** Staged bytes are charged against one explicit
  budget; staging a panel past it evicts least-recently-used panels
  (never the one just staged) until the pool fits — counted in
  ``fleet.evictions``. An evicted panel loses only warmth: the next
  request re-stages it from the store (the shared cold tier), counted
  in ``fleet.restage_total``.
- **Breaker-guarded.** Each stage runs through the route's
  :class:`~spark_examples_tpu_torch.serve.health.CircuitBreaker`: repeated
  store failures trip it open and later acquires fail fast with
  :class:`PanelUnavailable` (the route degrades; others keep serving)
  until the half-open probe heals it.

Each panel is charged the ``nbytes`` of its host int8 blocks
(``serve/engine.py::stage_blocks``), as the JAX package charges, so one
manifest, budget and request sequence evict and re-stage in the same
order in both packages.

Concurrency contract: **callers serialize staging** (the fleet's single
batching worker owns all device work, exactly like the single-model
server; route admin ops take the router's engine lock). The pool's own
lock only guards its bookkeeping — the staging IO/device work runs
outside it, so a slow stage can never block a concurrent metrics
scrape of the pool gauges. An evicted panel's tensors are released
when its entry is dropped, on the thread that staged past the budget
while holding the engine lock, so no batch is reading them.
"""

from __future__ import annotations

import threading
import warnings
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass

from spark_examples_tpu_torch.core import faults, telemetry


class PanelUnavailable(RuntimeError):
    """The route's panel is not staged and cannot be right now: the
    stage failed, or the route's circuit breaker is open and the
    attempt was short-circuited. Requests waiting on it are failed
    explicitly with this (the fleet's analogue of cached-panel-only
    mode — with no cached panel, there is nothing to degrade to)."""


@dataclass
class StagedPanel:
    """One warm panel: the staged device blocks plus the accounting the
    budget charges."""

    route: str
    blocks: list
    n_variants: int
    nbytes: int


class PanelPool:
    """Budgeted LRU pool of staged reference panels, keyed by route."""

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError(
                f"panel pool budget must be positive, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, StagedPanel] = OrderedDict()
        # Shard-staged residency (router._sharded_blocks): bytes a
        # route is holding transiently while one shard of an
        # over-budget panel serves. Charged against the same budget
        # (they evict warm panels) but never evictable themselves —
        # evicting the shard being computed on would tear the batch.
        self._transient: dict[str, int] = {}
        self._ever_staged: set[str] = set()
        self._warned_oversize: set[str] = set()

    # -- bookkeeping reads -------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return (sum(e.nbytes for e in self._entries.values())
                    + sum(self._transient.values()))

    def pressure(self) -> float:
        """resident / budget (the autoscale signal)."""
        return self.resident_bytes() / self.budget_bytes

    def resident_routes(self) -> list[str]:
        """LRU -> MRU order."""
        with self._lock:
            return list(self._entries)

    def is_staged(self, route: str) -> bool:
        with self._lock:
            return route in self._entries

    def stats(self) -> dict:
        with self._lock:
            transient = sum(self._transient.values())
            resident = (sum(e.nbytes for e in self._entries.values())
                        + transient)
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": resident,
                "transient_bytes": transient,
                "pressure": resident / self.budget_bytes,
                "staged_routes": list(self._entries),
            }

    # -- the hot path ------------------------------------------------------

    def acquire(self, route: str, stage_fn, breaker=None) -> StagedPanel:
        """The warm panel for ``route``, staging it on a miss.

        ``stage_fn()`` -> ``(blocks, n_variants, nbytes)`` (typically
        :func:`serve.engine.stage_blocks` over a fresh source). A miss
        whose route was staged before counts ``fleet.restage_total`` —
        that is a cold start the budget traded away. Raises
        :class:`PanelUnavailable` when the breaker short-circuits, and
        re-raises (after feeding the breaker) whatever the stage
        itself raised."""
        with self._lock:
            entry = self._entries.get(route)
            if entry is not None:
                self._entries.move_to_end(route)
                return entry
        if breaker is not None and not breaker.allow():
            raise PanelUnavailable(
                f"route {route!r}: panel not staged and its store "
                f"breaker is {breaker.state} — re-stage attempts are "
                "short-circuited until the reset window's probe"
            )
        try:
            with telemetry.span("fleet.stage", cat="fleet", route=route):
                faults.fire("fleet.stage")
                blocks, n_variants, nbytes = stage_fn()
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        except BaseException:
            # SIGINT/SystemExit mid-stage says nothing about the store:
            # give the half-open probe slot back and let it propagate.
            if breaker is not None:
                breaker.release_probe()
            raise
        if breaker is not None:
            breaker.record_success()
        entry = StagedPanel(route=route, blocks=blocks,
                            n_variants=n_variants, nbytes=int(nbytes))
        with self._lock:
            if route in self._ever_staged:
                telemetry.count("fleet.restage_total")
            self._ever_staged.add(route)
            self._entries[route] = entry
            self._entries.move_to_end(route)
            self._evict_over_budget_locked(keep=route)
            self._publish_locked()
        return entry

    def _evict_over_budget_locked(self, keep: str) -> None:
        resident = (sum(e.nbytes for e in self._entries.values())
                    + sum(self._transient.values()))
        while resident > self.budget_bytes:
            victim = next((r for r in self._entries if r != keep), None)
            if victim is None:
                # Everything left is ``keep``'s own bytes (or transient
                # shard residency) and it still exceeds the budget:
                # serve anyway (evicting it would deadlock the route),
                # but say so once. Routes whose panel length is known
                # up front never land here — the router serves their
                # over-budget panels shard-staged (_sharded_blocks)
                # instead of staging them whole; only a length-blind
                # source or a direct acquire of an oversized panel can.
                if keep not in self._warned_oversize:
                    self._warned_oversize.add(keep)
                    warnings.warn(
                        f"route {keep!r}: its resident bytes alone "
                        f"({resident} B) exceed the pool budget "
                        f"({self.budget_bytes} B) — serving it "
                        "unevictable; raise --fleet-budget-mb (panels "
                        "with a known length serve shard-staged "
                        "instead)",
                        RuntimeWarning, stacklevel=3,
                    )
                return
            resident -= self._entries.pop(victim).nbytes
            telemetry.count("fleet.evictions")

    @contextmanager
    def transient(self, route: str, nbytes: int):
        """Charge ``nbytes`` of shard residency for ``route`` while the
        body runs: the shard counts against the budget exactly like a
        warm panel (entering may evict other routes' LRU panels) but is
        never an eviction candidate itself, and the charge is released
        when the shard is dropped — the accounting half of shard-staged
        serving (router._sharded_blocks owns the staging half)."""
        nbytes = int(nbytes)
        with self._lock:
            self._transient[route] = (
                self._transient.get(route, 0) + nbytes)
            self._evict_over_budget_locked(keep=route)
            self._publish_locked()
        try:
            yield
        finally:
            with self._lock:
                left = self._transient.get(route, 0) - nbytes
                if left > 0:
                    self._transient[route] = left
                else:
                    self._transient.pop(route, None)
                self._publish_locked()

    # -- admin -------------------------------------------------------------

    def evict(self, route: str) -> bool:
        """Drop a staged panel (it re-stages on next demand)."""
        with self._lock:
            entry = self._entries.pop(route, None)
            if entry is not None:
                telemetry.count("fleet.evictions")
            self._publish_locked()
            return entry is not None

    def remove(self, route: str) -> bool:
        """Forget a route entirely (unload): its panel AND its
        staged-before history, so a later reload of the same name is a
        first stage again, not a 'restage'."""
        with self._lock:
            entry = self._entries.pop(route, None)
            self._ever_staged.discard(route)
            self._warned_oversize.discard(route)
            self._publish_locked()
            return entry is not None

    def _publish_locked(self) -> None:
        resident = (sum(e.nbytes for e in self._entries.values())
                    + sum(self._transient.values()))
        telemetry.gauge_set("fleet.pool_bytes", float(resident))
        telemetry.gauge_set("fleet.pool_pressure",
                            resident / self.budget_bytes)
