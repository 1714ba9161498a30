"""Serving health: the state machine and the store-read circuit breaker.

The server's condition is one of three states:

- ``healthy``: serving, every subsystem nominal.
- ``degraded``: still serving, but something recovered or is routed
  around: the batching worker was restarted within the cooloff window,
  or the store-read breaker is open and the panel runs cached-only.
- ``draining``: admission closed (SIGTERM / drain()); in-flight
  requests are answered, new ones get 503.

``/healthz`` reports the state as a string; every transition is
mirrored into the ``serve.health`` gauge (0/1/2).

:class:`CircuitBreaker` guards the panel's store read path: after
``trip_after`` consecutive failures it opens (re-stages short-circuit
without touching the store), and after ``reset_s`` one half-open probe
is let through; success closes it, failure re-opens the clock.
"""

from __future__ import annotations

import threading
import time

from spark_examples_tpu_torch.core import telemetry

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"

HEALTH_CODE = {HEALTHY: 0, DEGRADED: 1, DRAINING: 2}

# How long a worker recovery keeps the server reporting degraded.
DEGRADED_COOLOFF_S = 30.0


def publish(state: str) -> None:
    """Mirror a state into the ``serve.health`` gauge."""
    telemetry.gauge_set("serve.health", float(HEALTH_CODE[state]))


def readiness(worker_alive: bool, draining: bool, unstaged=()) -> bool:
    """The readiness rule (``/readyz``): the batching worker is alive,
    admission is open and every warmed route is staged (the
    single-model server passes none). A degraded server is still
    ready; a draining one is not."""
    return bool(worker_alive and not draining and not list(unstaged))


def worst(states) -> str:
    """The most severe of several states; empty input is healthy."""
    states = list(states)
    if not states:
        return HEALTHY
    return max(states, key=HEALTH_CODE.__getitem__)


class CircuitBreaker:
    """closed -> (trip_after consecutive failures) -> open ->
    (reset_s elapsed) -> half-open probe -> closed on success / open on
    failure. Thread-safe; the clock is injectable for tests."""

    def __init__(self, trip_after: int = 3, reset_s: float = 30.0,
                 clock=time.monotonic):
        self.trip_after = max(1, int(trip_after))
        self.reset_s = float(reset_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.reset_s:
            return "half-open"
        return "open"

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def allow(self) -> bool:
        """May the guarded operation run now? Open: no. Half-open: one
        probe at a time."""
        with self._lock:
            if self._opened_at is None:
                return True
            if self._clock() - self._opened_at < self.reset_s:
                return False
            if self._probing:
                return False
            self._probing = True
            return True

    def release_probe(self) -> None:
        """Give back a half-open probe slot without an outcome (a probe
        aborted by something that says nothing about the store)."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            self._probing = False
            if self._opened_at is not None:
                self._opened_at = self._clock()  # a failed probe
                return
            self._failures += 1
            if self._failures >= self.trip_after:
                self._opened_at = self._clock()
                tripped = True
        if tripped:
            telemetry.count("serve.breaker_open")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state_locked(),
                "consecutive_failures": self._failures,
                "trip_after": self.trip_after,
                "reset_s": self.reset_s,
            }
