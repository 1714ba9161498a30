"""Warm-panel placement: bin-pack panel bytes against replica budgets.

Every replica in the fleet can SERVE every route (a cold request
re-stages its panel through the shared content-addressed store), but
only the panels a replica keeps warm answer at interactive latency.
This module decides warmth: first-fit-decreasing bin packing of panel
bytes against each replica's warm-pool budget (the same budget
``serve/pool.py`` enforces with LRU eviction at run time), so the
controller can hand each replica a warm set that actually fits — a
warm assignment past budget would just churn the pool it was meant to
protect.

Pure functions over plain dicts — no serve imports, no clocks — so
the packing is unit-testable in microseconds and the controller's
rebalance decisions are exactly reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Placement:
    """One packing outcome: which replica keeps which panels warm.

    ``assignments`` maps replica name -> route names (in packed
    order); ``overflow`` is the routes no replica could fit under its
    remaining budget — still servable cold, but the controller should
    treat a nonempty overflow as a scale-up (or budget) signal, and a
    route larger than EVERY budget as a config problem to surface, not
    to silently spread.
    """

    assignments: dict[str, tuple[str, ...]] = field(default_factory=dict)
    overflow: tuple[str, ...] = ()

    def replica_for(self, route: str) -> str | None:
        for name, routes in self.assignments.items():
            if route in routes:
                return name
        return None

    def routes_for(self, replica: str) -> tuple[str, ...]:
        return self.assignments.get(replica, ())


def pack(panel_bytes: dict[str, int],
         budgets: dict[str, int]) -> Placement:
    """First-fit-decreasing: biggest panels first, each into the first
    replica (stable dict order — the controller passes slots in spawn
    order) with room left.

    Determinism matters more than optimality here: FFD is within 11/9
    of optimal and, fed the same panels and budgets, always returns
    the same assignment — so a controller rebalance after a respawn
    reproduces the previous warm layout instead of shuffling every
    replica's pool.
    """
    remaining = {name: max(0, int(b)) for name, b in budgets.items()}
    assignments: dict[str, list[str]] = {name: [] for name in remaining}
    overflow: list[str] = []
    # Ties broken by route name so equal-sized panels pack stably.
    ordered = sorted(panel_bytes.items(), key=lambda kv: (-kv[1], kv[0]))
    for route, nbytes in ordered:
        nbytes = max(0, int(nbytes))
        for name in remaining:
            if nbytes <= remaining[name]:
                assignments[name].append(route)
                remaining[name] -= nbytes
                break
        else:
            overflow.append(route)
    return Placement(
        assignments={n: tuple(r) for n, r in assignments.items()},
        overflow=tuple(overflow),
    )


def rebalance_needed(current: Placement, panels: dict[str, int],
                     budgets: dict[str, int]) -> bool:
    """True when re-packing today's panels over today's budgets lands
    somewhere else than ``current`` — membership changed, a panel
    grew, or a budget moved."""
    return pack(panels, budgets) != current
