"""The fleet controller: the loop that closes the autoscale circuit.

The serve replicas export the autoscale signals (per-route queue depth,
served p99, shed rate, pool pressure on ``GET /metrics``); this is
their consumer — one control loop over a pool of
:class:`~spark_examples_tpu_torch.fleet.replica.Replica` handles, the
JAX package's ``fleet/controller.py`` decision for decision:

- **Failure detection** distinguishes the three ways a replica goes
  bad: *crash* (the process/router is gone), *hang* (alive but its
  heartbeat went silent past the budget — process replicas only; an
  in-process replica's dead worker surfaces through its snapshot),
  and *stale scrape* (alive, beating, but ``/metrics`` unreadable for
  N consecutive rounds — the controller keeps acting on the last-good
  snapshot marked ``stale``, the live proxy's rule, until the budget
  runs out and the replica is declared lost).
- **Bounded-backoff respawn with a flap breaker.** A lost replica's
  slot respawns after an exponentially growing backoff (capped); a
  slot that keeps dying — more than ``flap_max_respawns`` respawns
  inside ``flap_window_s`` — is *parked* (``controller.
  flap_breaker_open``) instead of burning the fleet on a poisoned
  config, exactly like the store breaker short-circuits a failing
  cold tier.
- **Autoscale.** Sustained interactive queue depth or served p99 over
  ``pressure_rounds`` consecutive rounds spawns a replica (up to
  ``max_replicas``); a fleet idle for ``idle_rounds`` rounds retires
  one (down to ``min_replicas``) via SIGTERM drain — admitted
  requests are answered, and the hedged client's failover covers the
  drain window.
- **Placement.** New/respawned replicas get their warm set from
  :func:`~spark_examples_tpu_torch.fleet.placement.pack` (panel bytes
  against per-replica budgets) and stage those panels from the shared
  content-addressed store before taking traffic (``/readyz`` gates
  admission until staging lands).
- **Evidence.** Every decision and incident lands in an atomic
  ``controller.json`` ledger (telemetry's tmp+rename write — a killed
  controller leaves the last-good ledger readable) and in the
  ``controller.*`` telemetry series.

``step()`` is the whole loop body and takes no wall-clock of its own
(the clock is injected), so tests drive the controller
deterministically round by round; ``run()`` wraps it in the
``fleet-controller`` daemon thread for production use.

The controller is plain Python: it holds no device, and over
:class:`~spark_examples_tpu_torch.fleet.replica.ProcessReplica` handles
only the serve children touch the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.fleet import placement as P
from spark_examples_tpu_torch.fleet import slo as SLO
from spark_examples_tpu_torch.fleet import timeline as TL
from spark_examples_tpu_torch.fleet.replica import Replica, ScrapeError

# Literal-name tables (the telemetry-name lint bans f-string names).
_DECISION_COUNTERS = {
    "respawn": "controller.respawns",
    "scale_up": "controller.scale_ups",
    "retire": "controller.retires",
    "preempt": "controller.preemptions",
}

LEDGER_KEEP = 200  # incidents/decisions retained in controller.json


@dataclass
class ControllerConfig:
    """Control-loop knobs, validated at construction (the ServeConfig
    convention: a nonsense knob dies as a config error with the flag
    named, never as a wedged control loop)."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 0.5
    # Scale-up pressure: sustained interactive depth per ready replica,
    # or sustained worst-route p99 (0 disables the p99 trigger).
    scale_up_depth: float = 4.0
    scale_up_p99_s: float = 0.0
    pressure_rounds: int = 2
    idle_rounds: int = 8
    # Failure detection. A process replica binds its scrape port
    # seconds after spawn: failed scrapes on a never-scraped replica
    # inside the grace window are startup, not loss (0 disables).
    stale_scrapes: int = 3
    hang_heartbeat_s: float = 15.0
    startup_grace_s: float = 20.0
    # Respawn backoff + flap breaker.
    backoff_initial_s: float = 0.05
    backoff_max_s: float = 5.0
    flap_window_s: float = 30.0
    flap_max_respawns: int = 5
    # Graceful drain budget for retire/preempt (the hedge partner
    # covers this window for interactive traffic).
    drain_timeout_s: float = 30.0
    ledger_path: str | None = None
    # Fleet flight recorder: the per-round timeline ring lands beside
    # the ledger (timeline_path=None derives <ledger dir>/timeline.jsonl
    # when a ledger is configured; memory-only otherwise), and declared
    # SLOs (fleet/slo.py SLOSpec tuple, usually parsed from the fleet
    # manifest) are burn-rate-evaluated over it every round.
    timeline_path: str | None = None
    timeline_max_bytes: int = TL.DEFAULT_MAX_BYTES
    slos: tuple = ()

    def __post_init__(self):
        def _check(flag, value, lo, hi, why):
            if not (isinstance(value, (int, float))
                    and not isinstance(value, bool)
                    and lo <= value <= hi):
                raise ValueError(
                    f"bad controller config: {flag}={value!r} — expected "
                    f"a number in [{lo}, {hi}] ({why})"
                )

        _check("min_replicas", self.min_replicas, 0, 1024,
               "replicas the controller never drains below")
        _check("max_replicas", self.max_replicas,
               max(1, self.min_replicas), 1024,
               "scale-up ceiling; must be >= min_replicas")
        _check("interval_s", self.interval_s, 0.01, 3600.0,
               "control-round period of the run() thread")
        _check("scale_up_depth", self.scale_up_depth, 0.0, 1e9,
               "sustained interactive depth per ready replica that "
               "triggers a scale-up")
        _check("scale_up_p99_s", self.scale_up_p99_s, 0.0, 86400.0,
               "sustained worst-route p99 trigger; 0 disables")
        _check("pressure_rounds", self.pressure_rounds, 1, 10000,
               "consecutive pressured rounds before scaling up")
        _check("idle_rounds", self.idle_rounds, 1, 100000,
               "consecutive idle rounds before retiring a replica")
        _check("stale_scrapes", self.stale_scrapes, 1, 10000,
               "consecutive failed scrapes before a replica is lost")
        _check("hang_heartbeat_s", self.hang_heartbeat_s, 0.1, 86400.0,
               "heartbeat silence that declares a process replica hung")
        _check("startup_grace_s", self.startup_grace_s, 0.0, 86400.0,
               "window after spawn where a never-scraped replica's "
               "failed scrapes are startup, not loss")
        _check("backoff_initial_s", self.backoff_initial_s, 0.0, 3600.0,
               "first respawn delay; doubles per loss")
        _check("backoff_max_s", self.backoff_max_s,
               self.backoff_initial_s, 86400.0,
               "respawn delay ceiling; must be >= backoff_initial_s")
        _check("flap_window_s", self.flap_window_s, 0.1, 86400.0,
               "window the flap breaker counts respawns over")
        _check("flap_max_respawns", self.flap_max_respawns, 1, 10000,
               "respawns inside the window before the slot is parked")
        _check("--drain-timeout-s", self.drain_timeout_s, 0.1, 86400.0,
               "graceful drain budget for retire/preempt")
        if not (isinstance(self.timeline_max_bytes, int)
                and not isinstance(self.timeline_max_bytes, bool)
                and self.timeline_max_bytes >= TL._MIN_MAX_BYTES):
            raise ValueError(
                f"bad controller config: --timeline-max-bytes="
                f"{self.timeline_max_bytes!r} — expected an int >= "
                f"{TL._MIN_MAX_BYTES} (the timeline ring compacts past "
                "this size)")
        for s in self.slos:
            if not isinstance(s, SLO.SLOSpec):
                raise ValueError(
                    f"bad controller config: slos={self.slos!r} — "
                    "expected a tuple of fleet.slo.SLOSpec (parse the "
                    "manifest's 'slos' list with fleet.slo.parse_slos)")


@dataclass
class _Slot:
    """One replica's seat: survives the replica's deaths."""

    index: int
    replica: Replica | None = None
    state: str = "down"  # down | up | backoff | parked | retired
    generation: int = 0
    last_snapshot: object | None = None
    scrape_failures: int = 0
    backoff_s: float = 0.0
    respawn_at: float = 0.0
    spawned_at: float = 0.0
    respawn_times: deque = field(default_factory=deque)

    @property
    def name(self) -> str:
        return f"replica-{self.index}"


class FleetController:
    """The control plane over one fleet of serve replicas.

    ``factory(slot_name, generation) -> Replica`` builds (but does not
    start) a replica for a slot; ``panel_bytes`` maps route name ->
    staged panel size, the placement input. The controller starts
    ``min_replicas`` on :meth:`start` and owns every replica it spawns
    (retired/lost ones included) until :meth:`close`.
    """

    def __init__(self, factory, panel_bytes: dict[str, int],
                 cfg: ControllerConfig | None = None,
                 clock=time.monotonic):
        self.cfg = cfg or ControllerConfig()
        self.factory = factory
        self.panel_bytes = dict(panel_bytes)
        self.clock = clock
        self.slots: list[_Slot] = []
        self.incidents: deque = deque(maxlen=LEDGER_KEEP)
        self.decisions: deque = deque(maxlen=LEDGER_KEEP)
        self.rounds = 0
        self._pressure_rounds = 0
        self._idle_rounds = 0
        self._placement: P.Placement | None = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False
        # The flight recorder: timeline ring beside the ledger (or
        # memory-only), plus per-round SLO burn evaluation over it.
        tl_path = self.cfg.timeline_path
        if tl_path is None and self.cfg.ledger_path:
            tl_path = os.path.join(
                os.path.dirname(os.path.abspath(self.cfg.ledger_path)),
                "timeline.jsonl")
        self.timeline = TL.FleetTimeline(
            path=tl_path, max_bytes=self.cfg.timeline_max_bytes)
        self._slo = SLO.SLOEvaluator(tuple(self.cfg.slos), self.timeline)
        self._slo_pressure = False
        self._since_rotate = 0
        self._metrics_server: TL.TimelineMetricsServer | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetController":
        with self._lock:
            for _ in range(self.cfg.min_replicas):
                slot = _Slot(index=len(self.slots))
                self.slots.append(slot)
                self._spawn(slot, reason="bootstrap")
            self._rebalance("bootstrap")
        self._publish()
        self._write_ledger()
        return self

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self) -> "FleetController":
        """The production loop: step() every interval_s until stop()."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="fleet-controller", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.step()
            except Exception as e:  # the loop must outlive one bad round
                self._incident("controller", "step_error", repr(e))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def close(self) -> None:
        """Stop the loop and drain every live replica."""
        self.stop()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server = None
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for slot in self.slots:
                if slot.replica is not None and slot.state == "up":
                    slot.replica.drain(self.cfg.drain_timeout_s)
                    slot.state = "retired"
        self._write_ledger()

    def serve_metrics(self, host: str = "127.0.0.1", port: int = 0,
                      port_file: str | None = None
                      ) -> TL.TimelineMetricsServer:
        """Start (idempotently) the controller's own metrics surface:
        ``GET /fleet/metrics`` Prometheus text with the cross-replica
        ``timeline.*``/``slo.*`` folds, ``GET /fleet/timeline`` JSON."""
        if self._metrics_server is None:
            self._metrics_server = TL.TimelineMetricsServer(
                self.timeline, host=host, port=port,
                port_file=port_file).serve_in_thread()
        return self._metrics_server

    # -- introspection -----------------------------------------------------

    def replicas(self) -> list[Replica]:
        """Live (up) replicas, slot order — the hedged client's view."""
        with self._lock:
            return [s.replica for s in self.slots
                    if s.state == "up" and s.replica is not None]

    def ready_count(self) -> int:
        with self._lock:
            return sum(
                1 for s in self.slots
                if s.state == "up" and s.last_snapshot is not None
                and not s.last_snapshot.stale and s.last_snapshot.ready)

    def describe(self) -> dict:
        with self._lock:
            return {
                "rounds": self.rounds,
                "slots": [
                    {
                        "name": s.name,
                        "state": s.state,
                        "generation": s.generation,
                        "scrape_failures": s.scrape_failures,
                        "stale": bool(s.last_snapshot is not None
                                      and s.last_snapshot.stale),
                    }
                    for s in self.slots
                ],
                "placement": (
                    dict(self._placement.assignments)
                    if self._placement else {}),
                "incidents": list(self.incidents),
                "decisions": list(self.decisions),
            }

    # -- the loop body -----------------------------------------------------

    def step(self) -> list[dict]:
        """One control round. Returns the decisions it made (also
        recorded in the ledger) so callers can drive deterministically
        to a condition instead of sleeping."""
        before = len(self.decisions)
        with telemetry.span("controller.step", cat="controller"):
            with self._lock:
                self.rounds += 1
                now = self.clock()
                for slot in self.slots:
                    self._watch_slot(slot, now)
                self._observe()
                self._autoscale(now)
            self._publish()
            self._write_ledger()
        with self._lock:
            new = len(self.decisions) - before
            return list(self.decisions)[-new:] if new else []

    def _watch_slot(self, slot: _Slot, now: float) -> None:
        if slot.state in ("parked", "retired"):
            return
        if slot.state in ("down", "backoff"):
            if now >= slot.respawn_at:
                self._spawn(slot, reason="respawn")
            return
        replica = slot.replica
        if replica is None:  # defensive: an up slot always has one
            slot.state = "down"
            return
        if not replica.alive():
            self._lost(slot, now, "crash",
                       f"{slot.name} gen {slot.generation}: process/"
                       "router gone")
            return
        age = replica.heartbeat_age_s()
        if age is not None and age > self.cfg.hang_heartbeat_s:
            replica.kill()
            self._lost(slot, now, "hang",
                       f"{slot.name} gen {slot.generation}: heartbeat "
                       f"silent {age:.1f}s (budget "
                       f"{self.cfg.hang_heartbeat_s:.0f}s)")
            return
        try:
            faults.fire("controller.scrape")
            snap = replica.scrape()
        except (ScrapeError, faults.InjectedFault) as e:
            slot.scrape_failures += 1
            telemetry.count("controller.scrape_stale")
            if slot.last_snapshot is not None:
                # Last-good marked stale: the autoscale math keeps a
                # (conservative) view instead of a hole.
                slot.last_snapshot = slot.last_snapshot.as_stale()
            elif now - slot.spawned_at <= self.cfg.startup_grace_s:
                # Never scraped this generation and still inside the
                # startup grace: the replica is coming up (a process
                # replica binds its port seconds after spawn), not
                # lost. Failures keep counting, so an expired grace
                # declares loss on the very next round.
                return
            if slot.scrape_failures >= self.cfg.stale_scrapes:
                replica.kill()
                self._lost(slot, now, "stale",
                           f"{slot.name} gen {slot.generation}: "
                           f"{slot.scrape_failures} consecutive failed "
                           f"scrapes ({e})")
            return
        telemetry.count("controller.scrapes")
        slot.scrape_failures = 0
        slot.last_snapshot = snap

    def _observe(self) -> None:
        """The flight-recorder phase of every round: persist this
        round's per-slot snapshots into the timeline ring, evaluate
        the declared SLOs' burn windows over it, and ledger breaches —
        which also arm scale-up pressure for THIS round's autoscale
        (a breach bypasses the sustained pressure_rounds gate)."""
        slots = {s.name: (s.last_snapshot if s.state == "up" else None)
                 for s in self.slots if s.state != "retired"}
        up = sum(1 for s in self.slots if s.state == "up")
        self.timeline.record_round(self.rounds, slots, up,
                                   self.ready_count())
        breaches = self._slo.evaluate()
        self._slo_pressure = bool(breaches)
        for b in breaches:
            self._incident(
                b["key"], "slo_breach",
                f"{b['objective']} burned: fast {b['fast_burn']}x / "
                f"slow {b['slow_burn']}x over budget "
                f"(windows {b['fast_window_s']:g}s/"
                f"{b['slow_window_s']:g}s)")

    def _autoscale(self, now: float) -> None:
        up = [s for s in self.slots if s.state == "up"]
        snaps = [s.last_snapshot for s in up
                 if s.last_snapshot is not None]
        fresh = [sn for sn in snaps if not sn.stale]
        ready = [sn for sn in fresh if sn.ready]
        if not fresh:
            self._pressure_rounds = 0
            self._idle_rounds = 0
            return
        depth = sum(sn.queue_interactive for sn in fresh)
        p99 = max(sn.p99_s for sn in fresh)
        per_ready = depth / max(1, len(ready))
        pressured = per_ready >= self.cfg.scale_up_depth or (
            self.cfg.scale_up_p99_s > 0.0
            and p99 >= self.cfg.scale_up_p99_s)
        idle = all(sn.idle for sn in fresh)
        self._pressure_rounds = self._pressure_rounds + 1 if pressured \
            else 0
        self._idle_rounds = self._idle_rounds + 1 if idle else 0
        active = [s for s in self.slots
                  if s.state in ("up", "down", "backoff")]
        if ((self._pressure_rounds >= self.cfg.pressure_rounds
                or self._slo_pressure)
                and len(active) < self.cfg.max_replicas):
            slot = _Slot(index=len(self.slots))
            self.slots.append(slot)
            why = (f"interactive depth/ready={per_ready:.1f} "
                   f"(trigger {self.cfg.scale_up_depth}), worst "
                   f"p99={p99 * 1e3:.1f}ms, sustained "
                   f"{self._pressure_rounds} rounds")
            if self._slo_pressure:
                # An SLO breach IS the pressure signal — it already
                # proved sustained burn over its fast+slow windows, so
                # it does not wait out pressure_rounds again.
                why = "slo breach pressure (this round); " + why
            self._decide("scale_up", slot.name, why)
            self._spawn(slot, reason="scale_up")
            self._rebalance("scale_up")
            self._pressure_rounds = 0
            self._slo_pressure = False
        elif (self._idle_rounds >= self.cfg.idle_rounds
              and len(up) > self.cfg.min_replicas):
            slot = up[-1]  # newest first out: LIFO keeps slot 0 warm
            self._decide("retire", slot.name,
                         f"fleet idle {self._idle_rounds} rounds "
                         f"(threshold {self.cfg.idle_rounds}); draining "
                         f"to {len(up) - 1} replicas")
            clean = slot.replica.drain(self.cfg.drain_timeout_s)
            if not clean:
                self._incident(slot.name, "dirty_retire",
                               "drain ran past its budget; stragglers "
                               "failed loudly")
            slot.state = "retired"
            slot.last_snapshot = None
            self._rebalance("retire")
            self._idle_rounds = 0

    def preempt(self, name: str) -> bool:
        """Graceful preemption of one replica BY NAME: drain it within
        the budget and respawn its slot immediately (no backoff — a
        preemption is the platform's fault, not the replica's). The
        hedge partner covers the drain window; zero admitted requests
        are dropped by a clean drain."""
        with self._lock:
            for slot in self.slots:
                if slot.name == name and slot.state == "up":
                    self._decide("preempt", slot.name,
                                 "preemption notice: draining within "
                                 f"{self.cfg.drain_timeout_s:.0f}s and "
                                 "respawning")
                    clean = slot.replica.drain(self.cfg.drain_timeout_s)
                    if not clean:
                        self._incident(slot.name, "dirty_preempt",
                                       "drain ran past its budget")
                    slot.state = "down"
                    slot.last_snapshot = None
                    slot.respawn_at = self.clock()  # immediate
                    slot.backoff_s = 0.0
                    self._spawn(slot, reason="preempt_respawn")
                    return True
        return False

    # -- spawn/loss machinery ----------------------------------------------

    def _spawn(self, slot: _Slot, reason: str) -> None:
        with telemetry.span("controller.spawn", cat="controller",
                            slot=slot.name, reason=reason):
            replica = None
            try:
                faults.fire("controller.spawn")
                replica = self.factory(slot.name, slot.generation)
                replica.start()
                want = self._warm_set(slot)
                if want:
                    replica.warm(want)
            except BaseException as e:
                self._incident(slot.name, "spawn_failure",
                               f"gen {slot.generation} ({reason}): {e!r}")
                if replica is not None:
                    # A half-started replica (worker thread up, warm
                    # failed) must not outlive the failed spawn.
                    try:
                        replica.kill()
                    except Exception:
                        pass
                self._backoff(slot, self.clock())
                return
        slot.replica = replica
        slot.state = "up"
        slot.scrape_failures = 0
        slot.last_snapshot = None
        slot.spawned_at = self.clock()
        if slot.generation > 0 or reason == "respawn":
            self._decide("respawn", slot.name,
                         f"gen {slot.generation} up ({reason}); warm "
                         f"set {list(replica.warm_routes)}")
        slot.generation += 1

    def _warm_set(self, slot: _Slot) -> tuple[str, ...]:
        """This slot's warm-assigned routes under the current packing
        (recomputed over active budgets so a respawn re-stages what
        its predecessor kept warm)."""
        budgets = {}
        for s in self.slots:
            if s.state in ("up",) or s is slot:
                budget = (s.replica.budget_bytes if s.replica is not None
                          else self._factory_budget())
                budgets[s.name] = budget
        packed = P.pack(self.panel_bytes, budgets)
        self._placement = packed
        return packed.routes_for(slot.name)

    def _factory_budget(self) -> int:
        # Budget of a yet-unbuilt replica: every live one's, or the
        # total panel bytes as the conservative fallback.
        for s in self.slots:
            if s.replica is not None:
                return s.replica.budget_bytes
        return sum(self.panel_bytes.values()) or 1

    def _rebalance(self, reason: str) -> None:
        budgets = {s.name: s.replica.budget_bytes
                   for s in self.slots
                   if s.state == "up" and s.replica is not None}
        if not budgets:
            return
        packed = P.pack(self.panel_bytes, budgets)
        # No-op only when the packing AND every replica's actual warm
        # set already agree — a bootstrap spawn warms against a
        # provisional single-slot packing, so the placement can match
        # while a replica still carries extra routes.
        in_sync = packed == self._placement and all(
            tuple(packed.routes_for(s.name))
            == tuple(s.replica.warm_routes)
            for s in self.slots
            if s.state == "up" and s.replica is not None)
        if in_sync:
            return
        self._placement = packed
        if packed.overflow:
            self._incident("controller", "placement_overflow",
                           f"routes {list(packed.overflow)} fit no "
                           "replica's warm budget — served cold; raise "
                           "budgets or max_replicas")
        self._decide("rebalance", "fleet",
                     f"{reason}: " + json.dumps(
                         {k: list(v)
                          for k, v in packed.assignments.items()},
                         sort_keys=True))
        for s in self.slots:
            if s.state != "up" or s.replica is None:
                continue
            want = packed.routes_for(s.name)
            if tuple(want) != tuple(s.replica.warm_routes):
                try:
                    s.replica.warm(want)
                except Exception as e:
                    self._incident(s.name, "warm_failure",
                                   f"staging {list(want)}: {e!r}")

    def _lost(self, slot: _Slot, now: float, kind: str,
              detail: str) -> None:
        self._incident(slot.name, kind, detail)
        slot.replica = None
        slot.last_snapshot = None
        slot.scrape_failures = 0
        self._backoff(slot, now)

    def _backoff(self, slot: _Slot, now: float) -> None:
        slot.respawn_times.append(now)
        while (slot.respawn_times
               and now - slot.respawn_times[0] > self.cfg.flap_window_s):
            slot.respawn_times.popleft()
        if len(slot.respawn_times) > self.cfg.flap_max_respawns:
            slot.state = "parked"
            self._incident(
                slot.name, "flap_breaker",
                f"{len(slot.respawn_times)} respawns inside "
                f"{self.cfg.flap_window_s:.0f}s — slot parked (reset "
                "with reset_flap_breaker())")
            return
        slot.backoff_s = min(
            self.cfg.backoff_max_s,
            slot.backoff_s * 2 if slot.backoff_s
            else self.cfg.backoff_initial_s)
        slot.respawn_at = now + slot.backoff_s
        slot.state = "backoff"

    def reset_flap_breaker(self, name: str) -> bool:
        """Operator override: un-park a slot after fixing the cause."""
        with self._lock:
            for slot in self.slots:
                if slot.name == name and slot.state == "parked":
                    slot.respawn_times.clear()
                    slot.backoff_s = 0.0
                    slot.respawn_at = self.clock()
                    slot.state = "down"
                    self._decide("respawn", slot.name,
                                 "flap breaker reset by operator")
                    return True
        return False

    # -- evidence ----------------------------------------------------------

    def _incident(self, who: str, kind: str, detail: str) -> None:
        self._rotate_ledger_if_full(self.incidents)
        self.incidents.append({
            "round": self.rounds, "who": who, "kind": kind,
            "detail": detail, "t_unix": time.time(),
        })
        telemetry.count("controller.incidents")
        self.timeline.record_marker(self.rounds, who, kind, detail)

    def _decide(self, action: str, who: str, detail: str) -> None:
        self._rotate_ledger_if_full(self.decisions)
        self.decisions.append({
            "round": self.rounds, "action": action, "who": who,
            "detail": detail, "t_unix": time.time(),
        })
        counter = _DECISION_COUNTERS.get(action)
        if counter:
            telemetry.count(counter)
        self.timeline.record_marker(self.rounds, who, action, detail)

    def _rotate_ledger_if_full(self, dq: deque) -> None:
        """The ledger deques are bounded at LEDGER_KEEP: before a full
        deque drops its oldest entry, snapshot the whole current ledger
        to ``<ledger>.old`` (tmp+rename, the checkpoint idiom) — one
        rotation covers the next LEDGER_KEEP drops, so history rolls
        into generations instead of silently vanishing."""
        if len(dq) < LEDGER_KEEP or not self.cfg.ledger_path:
            return
        if self._since_rotate > 0:
            self._since_rotate -= 1
            return
        try:
            telemetry._atomic_write(
                self.cfg.ledger_path + ".old",
                json.dumps(self.describe(), indent=1, sort_keys=True))
            telemetry.count("controller.ledger_rotations")
        except OSError:
            pass  # evidence is best-effort; the loop must keep going
        self._since_rotate = LEDGER_KEEP - 1

    def _publish(self) -> None:
        with self._lock:
            up = sum(1 for s in self.slots if s.state == "up")
            parked = sum(1 for s in self.slots if s.state == "parked")
            ready = self.ready_count()
        telemetry.gauge_set("controller.replicas", float(up))
        telemetry.gauge_set("controller.ready", float(ready))
        telemetry.gauge_set("controller.flap_breaker_open",
                            float(parked))

    def _write_ledger(self) -> None:
        path = self.cfg.ledger_path
        if not path:
            return
        try:
            telemetry._atomic_write(path, json.dumps(
                self.describe(), indent=1, sort_keys=True))
        except OSError:
            pass  # evidence is best-effort; the loop must keep going
