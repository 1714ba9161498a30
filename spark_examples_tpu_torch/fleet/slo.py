"""Declarative SLOs with multi-window burn-rate evaluation.

The fleet manifest (serve/fleet.py) declares per-route objectives —
a served p99 latency target and/or an availability floor — and the
controller evaluates them every control round over the fleet timeline
(fleet/timeline.py). Evaluation is the classic multi-window burn-rate
recipe: an objective's error budget (the fraction of rounds allowed to
violate it, ``budget``) is checked over a **fast** window (minutes:
catches an active regression while it is happening) and a **slow**
window (the sustained view: keeps a single blip from paging). A breach
requires BOTH windows over budget — fast-only is noise, slow-only is
old news — and lands three ways at once: a ``slo_breach`` ledger
incident, ``slo.*`` gauges on the controller's ``/fleet/metrics``, and
**scale-up pressure in the same control round** (the controller treats
a breach as an immediate pressure signal that bypasses the sustained
``pressure_rounds`` requirement — observability closed back into
control).

Objective semantics per round, judged against the timeline's round
records:

- ``p99_ms``: the round violates when any slot's observed p99 for the
  route exceeds the target.
- ``availability``: the round violates when the route's worst shed
  rate implies availability (1 - shed_rate) below the floor.

``route="*"`` applies the objective to every route in the round.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from spark_examples_tpu_torch.core import telemetry

# Fraction of rounds inside a window allowed to violate the objective
# before that window's burn rate reads 1.0 (fully burned).
DEFAULT_BUDGET = 0.1
DEFAULT_FAST_WINDOW_S = 30.0
DEFAULT_SLOW_WINDOW_S = 300.0
_MIN_ROUNDS = 3  # windows thinner than this cannot claim a burn


@dataclass(frozen=True)
class SLOSpec:
    """One declared objective, validated at parse time."""

    route: str  # route name or "*" (every route)
    p99_ms: float | None = None
    availability: float | None = None
    budget: float = DEFAULT_BUDGET
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S

    @property
    def key(self) -> str:
        return self.route if self.route != "*" else "fleet"


def parse_slos(obj, route_names, error=ValueError) -> tuple[SLOSpec, ...]:
    """Validate the manifest's ``slos`` list into specs. Raises
    ``error`` (serve/fleet.py passes FleetFormatError) naming the
    offending ``slos[i]``/field — a nonsense objective dies at parse
    time, never as a silent never-firing alert."""
    if not isinstance(obj, list):
        raise error(
            f"manifest field 'slos' must be a list of objective "
            f"objects, got {type(obj).__name__}")
    known = {"route", "p99_ms", "availability", "budget",
             "fast_window_s", "slow_window_s"}
    out = []
    for i, entry in enumerate(obj):
        where = f"slos[{i}]"
        if not isinstance(entry, dict):
            raise error(f"{where} must be an object, "
                        f"got {type(entry).__name__}")
        unknown = set(entry) - known
        if unknown:
            raise error(
                f"{where} has unknown field(s) "
                f"{sorted(unknown)}; known: {sorted(known)}")
        route = entry.get("route", "*")
        if not isinstance(route, str) or not route:
            raise error(f"{where}.route must be a route name or '*', "
                        f"got {route!r}")
        if route != "*" and route not in route_names:
            raise error(
                f"{where}.route={route!r} names no declared route "
                f"(routes: {sorted(route_names)})")

        def _num(fieldname, lo, hi, default=None, where=where,
                 entry=entry):
            v = entry.get(fieldname, default)
            if v is None:
                return None
            if (not isinstance(v, (int, float))
                    or isinstance(v, bool) or not lo <= v <= hi):
                raise error(
                    f"{where}.{fieldname}={v!r} — expected a number "
                    f"in [{lo}, {hi}]")
            return float(v)

        p99_ms = _num("p99_ms", 0.001, 3.6e6)
        availability = _num("availability", 0.0, 1.0)
        if p99_ms is None and availability is None:
            raise error(
                f"{where} declares no objective — set p99_ms and/or "
                "availability")
        budget = _num("budget", 1e-6, 1.0, DEFAULT_BUDGET)
        fast = _num("fast_window_s", 0.001, 86400.0,
                    DEFAULT_FAST_WINDOW_S)
        slow = _num("slow_window_s", 0.001, 86400.0,
                    DEFAULT_SLOW_WINDOW_S)
        if slow < fast:
            raise error(
                f"{where}: slow_window_s={slow} < fast_window_s={fast} "
                "— the slow window must contain the fast one")
        out.append(SLOSpec(route=route, p99_ms=p99_ms,
                           availability=availability, budget=budget,
                           fast_window_s=fast, slow_window_s=slow))
    return tuple(out)


def _round_violates(spec: SLOSpec, rec: dict) -> bool:
    slots = [s for s in rec.get("slots", {}).values()
             if s.get("present")]
    if not slots:
        return False
    routes = ([spec.route] if spec.route != "*"
              else sorted({r for s in slots
                           for r in s.get("routes", {})}))
    for route in routes:
        for s in slots:
            r = s.get("routes", {}).get(route)
            if r is None:
                continue
            if (spec.p99_ms is not None
                    and r.get("p99_s", 0.0) * 1e3 > spec.p99_ms):
                return True
            if (spec.availability is not None
                    and 1.0 - r.get("shed_rate", 0.0)
                    < spec.availability):
                return True
    return False


def _window_burn(spec: SLOSpec, rounds: list[dict], now_unix: float,
                 window_s: float) -> float:
    """Violating-round fraction over the window, normalised by the
    error budget: 1.0 = the budget is exactly spent."""
    recent = [r for r in rounds if r["t_unix"] >= now_unix - window_s]
    if len(recent) < _MIN_ROUNDS:
        return 0.0
    bad = sum(1 for r in recent if _round_violates(spec, r))
    return (bad / len(recent)) / spec.budget


class SLOEvaluator:
    """Per-round burn-rate evaluation over a FleetTimeline."""

    def __init__(self, slos: tuple[SLOSpec, ...], timeline):
        self.slos = tuple(slos)
        self.timeline = timeline

    def evaluate(self, now_unix: float | None = None) -> list[dict]:
        """Evaluate every objective; publish ``slo.*`` gauges; return
        the breaches (both windows over budget) as incident-shaped
        dicts the controller ledgers and acts on."""
        if not self.slos:
            return []
        now = time.time() if now_unix is None else float(now_unix)
        rounds = self.timeline.recent_rounds(
            since_unix=now - max(s.slow_window_s for s in self.slos))
        breaches = []
        all_ok = True
        for spec in self.slos:
            fast = _window_burn(spec, rounds, now, spec.fast_window_s)
            slow = _window_burn(spec, rounds, now, spec.slow_window_s)
            prefix = "slo." + spec.key
            telemetry.gauge_set(prefix + ".fast_burn", fast)
            telemetry.gauge_set(prefix + ".slow_burn", slow)
            breached = fast >= 1.0 and slow >= 1.0
            telemetry.gauge_set(prefix + ".breached",
                                1.0 if breached else 0.0)
            if breached:
                all_ok = False
                telemetry.count("slo.breaches")
                objective = []
                if spec.p99_ms is not None:
                    objective.append(f"p99<={spec.p99_ms:g}ms")
                if spec.availability is not None:
                    objective.append(
                        f"availability>={spec.availability:g}")
                breaches.append({
                    "route": spec.route,
                    "key": spec.key,
                    "objective": " & ".join(objective),
                    "fast_burn": round(fast, 4),
                    "slow_burn": round(slow, 4),
                    "fast_window_s": spec.fast_window_s,
                    "slow_window_s": spec.slow_window_s,
                })
        telemetry.gauge_set("slo.ok", 1.0 if all_ok else 0.0)
        return breaches
