"""Closed-loop load generators: single-model, multi-tenant fleet mix,
and replica hedging.

``clients`` threads each submit queries back to back (a new request the
moment the previous one resolves), drawing striped rows from a query
pool. Because the loop is closed, *offered* load is what the clients
managed to attempt (sheds included) and *sustained* is what the server
completed; under overload the gap is the shed and error count, never
silent queueing.

Latency percentiles are read from the telemetry registry's
``serve.latency_s`` histogram, the numbers ``--telemetry-dir`` exports.

Fleet additions:

- :func:`run_fleet_loadgen`: a multi-tenant mix over a
  :class:`~spark_examples_tpu_torch.serve.router.FleetRouter`, one
  ``(route, priority class, clients)`` entry per traffic source, with
  latencies tracked client-side per (route, class); the report's
  per-class ``p99_s`` (interactive against batch) is the priority
  contract's number.
- :func:`run_hedged_loadgen`: client-side request hedging between
  replicas: a request unanswered after the rolling p95 of completed
  primaries is re-sent to a second replica, first answer wins, the
  loser is cancelled (``fleet.hedge_launched``/``fleet.hedge_wins``).
- :class:`BurstSchedule`: a seeded diurnal/bursty arrival schedule.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, wait
from dataclasses import dataclass

import numpy as np

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.config import DEFAULT_PRIORITY
from spark_examples_tpu_torch.serve.server import (
    DeadlineExceeded,
    ProjectionServer,
    ServerClosed,
    ServerOverloaded,
)


@dataclass
class _ClientTally:
    attempts: int = 0
    ok: int = 0
    shed: int = 0
    deadline: int = 0
    errors: int = 0


# Client-side error records carry the server's run_id (and the request's
# trace_id where one exists) so a client log line joins the server-side
# trace export without guessing which run produced it.
_ERROR_RECORDS_MAX = 50


class _ErrorLog:
    def __init__(self):
        self._lock = threading.Lock()
        self.records: list[dict] = []
        self.dropped = 0

    def record(self, **fields) -> None:
        rec = {"run_id": telemetry.run_id(), **fields}
        with self._lock:
            if len(self.records) < _ERROR_RECORDS_MAX:
                self.records.append(rec)
            else:
                self.dropped += 1

    def report(self) -> list[dict]:
        with self._lock:
            return list(self.records)


def run_loadgen(server: ProjectionServer, pool: np.ndarray,
                clients: int = 4, requests_per_client: int = 50,
                deadline_s: float | None = None,
                result_timeout_s: float = 30.0) -> dict:
    """Drive ``server`` with ``clients`` concurrent closed-loop clients
    and return the serving report (offered vs sustained QPS, latency
    p50/p99 from the telemetry export, shed/error accounting).

    ``pool`` is a (Q, V) int8 query-genotype pool; client ``c`` cycles
    through rows ``c, c+clients, c+2*clients, ...`` so concurrent
    clients never submit the same row at the same step (a pool smaller
    than the result cache turns the run into a cache benchmark — size
    the pool accordingly for device numbers).
    """
    pool = np.ascontiguousarray(pool, dtype=np.int8)
    if pool.ndim != 2 or not len(pool):
        raise ValueError(f"query pool must be (Q, V) int8, got {pool.shape}")
    tallies = [_ClientTally() for _ in range(clients)]
    errlog = _ErrorLog()
    start = threading.Barrier(clients + 1)

    def client(c: int) -> None:
        tally = tallies[c]
        start.wait()
        for k in range(requests_per_client):
            q = pool[(c + k * clients) % len(pool)]
            tally.attempts += 1
            try:
                server.project(q, timeout=result_timeout_s,
                               deadline_s=deadline_s)
                tally.ok += 1
            except ServerOverloaded:
                tally.shed += 1
            except DeadlineExceeded:
                tally.deadline += 1
            except Exception as e:
                tally.errors += 1
                errlog.record(client=c, error=repr(e))

    threads = [
        threading.Thread(target=client, args=(c,), daemon=True,
                         name=f"loadgen-client-{c}")
        for c in range(clients)
    ]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    duration = max(time.perf_counter() - t0, 1e-9)

    attempts = sum(t.attempts for t in tallies)
    ok = sum(t.ok for t in tallies)
    lat = telemetry.metrics_snapshot()["histograms"].get(
        "serve.latency_s", {})
    return {
        "clients": clients,
        "requests_per_client": requests_per_client,
        "duration_s": round(duration, 4),
        "offered_qps": round(attempts / duration, 2),
        "sustained_qps": round(ok / duration, 2),
        "completed": ok,
        "shed": sum(t.shed for t in tallies),
        "deadline_expired": sum(t.deadline for t in tallies),
        "errors": sum(t.errors for t in tallies),
        "latency_p50_ms": round(lat.get("p50", 0.0) * 1e3, 3),
        "latency_p99_ms": round(lat.get("p99", 0.0) * 1e3, 3),
        "latency_max_ms": round(lat.get("max", 0.0) * 1e3, 3),
        "error_records": errlog.report(),
        "server": server.stats.snapshot(),
    }


# --------------------------------------------------------------- fleet mix


def run_fleet_loadgen(fleet, pools: dict[str, np.ndarray],
                      mix: list[tuple[str, str, int]],
                      requests_per_client: int = 50,
                      deadline_s: float | None = None,
                      result_timeout_s: float = 60.0) -> dict:
    """Multi-tenant closed-loop mix against a fleet router.

    ``pools`` maps route name -> (Q, V_route) int8 query pool; ``mix``
    is the tenant table — one ``(route, priority_class, clients)``
    entry per traffic source. Latencies are measured CLIENT-side per
    (route, class) so the per-class percentiles include queueing (the
    thing priorities exist to shape), and the report's
    ``p99_interactive_s`` / ``p99_batch_s`` pair is the priority
    contract's acceptance number."""
    tenants = []  # (route, cls, tally, hist) per client thread
    for route, cls, clients in mix:
        if route not in pools:
            raise ValueError(
                f"mix names route {route!r} but pools has no query "
                f"pool for it (pools: {sorted(pools)})"
            )
        for _ in range(max(0, int(clients))):
            tenants.append((route, cls, _ClientTally(),
                            telemetry.Histogram()))
    if not tenants:
        raise ValueError("empty mix — nothing to offer")
    start = threading.Barrier(len(tenants) + 1)

    errlog = _ErrorLog()

    def client(idx: int) -> None:
        route, cls, tally, hist = tenants[idx]
        pool = pools[route]
        stride = max(1, len(tenants))
        start.wait()
        for k in range(requests_per_client):
            q = pool[(idx + k * stride) % len(pool)]
            tally.attempts += 1
            t0 = time.perf_counter()
            try:
                fleet.project(route, q, timeout=result_timeout_s,
                              priority=cls, deadline_s=deadline_s)
                tally.ok += 1
                hist.record(time.perf_counter() - t0)
            except ServerOverloaded:
                tally.shed += 1
            except DeadlineExceeded:
                tally.deadline += 1
            except Exception as e:
                tally.errors += 1
                errlog.record(route=route, cls=cls, error=repr(e))

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True,
                         name=f"loadgen-client-{i}")
        for i in range(len(tenants))
    ]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    duration = max(time.perf_counter() - t0, 1e-9)

    def _merge(selector) -> telemetry.Histogram:
        merged = telemetry.Histogram()
        for route, cls, _tally, hist in tenants:
            if selector(route, cls):
                merged.merge(hist)
        return merged

    per_class = {}
    for cls in sorted({c for _r, c, _t, _h in tenants}):
        h = _merge(lambda _r, c, cls=cls: c == cls)
        tallies = [t for _r, c, t, _h in tenants if c == cls]
        per_class[cls] = {
            "clients": len(tallies),
            "completed": sum(t.ok for t in tallies),
            "shed": sum(t.shed for t in tallies),
            "deadline_expired": sum(t.deadline for t in tallies),
            "errors": sum(t.errors for t in tallies),
            "p50_s": round(h.quantile(0.5), 6),
            "p99_s": round(h.quantile(0.99), 6),
        }
    per_route = {}
    for route in sorted({r for r, _c, _t, _h in tenants}):
        h = _merge(lambda r, _c, route=route: r == route)
        tallies = [t for r, _c, t, _h in tenants if r == route]
        per_route[route] = {
            "completed": sum(t.ok for t in tallies),
            "shed": sum(t.shed for t in tallies),
            "errors": sum(t.errors for t in tallies),
            "p99_s": round(h.quantile(0.99), 6),
        }
    attempts = sum(t.attempts for _r, _c, t, _h in tenants)
    ok = sum(t.ok for _r, _c, t, _h in tenants)
    return {
        "clients": len(tenants),
        "requests_per_client": requests_per_client,
        "duration_s": round(duration, 4),
        "offered_qps": round(attempts / duration, 2),
        "sustained_qps": round(ok / duration, 2),
        "completed": ok,
        "shed": sum(t.shed for _r, _c, t, _h in tenants),
        "errors": sum(t.errors for _r, _c, t, _h in tenants),
        "error_records": errlog.report(),
        "per_class": per_class,
        "per_route": per_route,
    }


# ---------------------------------------------------------------- hedging


class _HedgeDelay:
    """Rolling p95 of completed primary latencies (shared by all
    clients of one hedged run) — the hedge trigger. Until enough
    samples exist the caller's floor delay applies; passing ``seed``
    pre-charges the ring with a deterministic floor-scale prior so the
    first hedge decisions replay identically run to run (SOAK-REPRO)
    instead of depending on which client's warmup sample lands
    first."""

    def __init__(self, floor_s: float, window: int = 256,
                 min_samples: int = 20, seed: int | None = None):
        self.floor_s = float(floor_s)
        self._ring: deque[float] = deque(maxlen=window)
        self._min = int(min_samples)
        self._lock = threading.Lock()
        if seed is not None:
            rng = np.random.default_rng(int(seed))
            for x in rng.uniform(0.8, 1.5, size=self._min):
                self._ring.append(self.floor_s * float(x))

    def record(self, latency_s: float) -> None:
        with self._lock:
            self._ring.append(latency_s)

    def delay_s(self) -> float:
        with self._lock:
            if len(self._ring) < self._min:
                return self.floor_s
            ordered = sorted(self._ring)
            p95 = ordered[min(len(ordered) - 1,
                              int(0.95 * len(ordered)))]
        return max(self.floor_s, p95)


class BurstSchedule:
    """Seeded diurnal/bursty arrival schedule — the controller bench's
    traffic shape, deterministic under ``--loadgen-seed``.

    The instantaneous offered rate is a diurnal sinusoid over
    ``duration_s`` (one full day compressed into the run) times a
    ``burst_factor`` inside ``n_bursts`` seeded burst windows — the
    scale-up trigger the controller must answer. ``arrivals()``
    realises it as a sorted tuple of request-start offsets via a
    seeded non-homogeneous Poisson draw, so two runs with the same
    seed offer bit-identical traffic (the SOAK-REPRO contract's
    precondition for pinning served coordinates across a recovery)."""

    def __init__(self, duration_s: float, base_qps: float,
                 seed: int = 0, diurnal_amplitude: float = 0.3,
                 n_bursts: int = 2, burst_factor: float = 6.0,
                 burst_len_s: float | None = None):
        def _check(flag, value, lo, hi, why):
            if not (isinstance(value, (int, float))
                    and lo <= value <= hi):
                raise ValueError(
                    f"bad burst schedule: {flag}={value!r} — expected "
                    f"a number in [{lo}, {hi}] ({why})")

        _check("duration_s", duration_s, 1e-3, 86_400.0,
               "the run's wall-clock span")
        _check("base_qps", base_qps, 1e-6, 1e9,
               "the diurnal baseline offered rate")
        _check("diurnal_amplitude", diurnal_amplitude, 0.0, 0.99,
               "sinusoid swing around the baseline")
        _check("n_bursts", n_bursts, 0, 1000,
               "seeded burst windows inside the run")
        _check("burst_factor", burst_factor, 1.0, 1e6,
               "rate multiplier inside a burst window")
        self.duration_s = float(duration_s)
        self.base_qps = float(base_qps)
        self.seed = int(seed)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.burst_factor = float(burst_factor)
        self.burst_len_s = float(
            burst_len_s if burst_len_s is not None
            else self.duration_s / 10.0)
        rng = np.random.default_rng(self.seed)
        starts = np.sort(rng.uniform(
            0.0, max(1e-9, self.duration_s - self.burst_len_s),
            size=int(n_bursts)))
        self.bursts = tuple(
            (float(s), float(s + self.burst_len_s)) for s in starts)

    def rate_at(self, t: float) -> float:
        rate = self.base_qps * (
            1.0 + self.diurnal_amplitude
            * np.sin(2.0 * np.pi * t / self.duration_s))
        for lo, hi in self.bursts:
            if lo <= t < hi:
                rate *= self.burst_factor
                break
        return float(max(rate, 1e-9))

    def arrivals(self) -> tuple[float, ...]:
        """The realised offsets: thinning-free sequential draw — each
        gap is exponential at the rate where the previous request
        landed. Deterministic for a given (seed, shape)."""
        rng = np.random.default_rng(self.seed + 1)
        out, t = [], 0.0
        while True:
            t += float(rng.exponential(1.0 / self.rate_at(t)))
            if t >= self.duration_s:
                return tuple(out)
            out.append(t)


def run_hedged_loadgen(replicas, pool: np.ndarray,
                       clients: int = 4, requests_per_client: int = 50,
                       route: str | None = None,
                       priority: str = DEFAULT_PRIORITY,
                       hedge_floor_s: float = 0.01,
                       deadline_s: float | None = None,
                       result_timeout_s: float = 60.0,
                       seed: int | None = None) -> dict:
    """Closed-loop load with client-side request hedging between two
    (or more) replicas. ``replicas[0]`` is every client's primary; a
    request unanswered after the p95-derived hedge delay is re-sent to
    the next replica round-robin — first answer wins, the loser future
    is cancelled (a queued loser is dropped at batch pickup; one
    already running finishes and is ignored). ``route`` switches the
    submit surface to the fleet router's; None drives single-model
    ProjectionServers.

    Replica processes share the content-addressed store as their cold
    tier, so a hedge landing on a cold replica pays at worst one
    re-stage — which is exactly the tail the hedge exists to cut.

    The zero-loss contract (the controller's chaos proof leans on it):
    a replica lost mid-traffic costs latency, never an answer — a
    request refused or failed with :class:`ServerClosed` (the loss/
    drain signal) is re-admitted on the client's hedge partner and
    counted in ``failovers``/``fleet.failovers``, not in ``errors``."""
    if len(replicas) < 2:
        raise ValueError("hedging needs >= 2 replicas")
    pool = np.ascontiguousarray(pool, dtype=np.int8)

    def _submit(replica, q, trace=None):
        if route is None:
            # Single-model ProjectionServer surface: no fleet trace
            # plumbing (the fleet router owns phase write-back).
            return replica.submit(q, deadline_s=deadline_s)
        return replica.submit(route, q, priority=priority,
                              deadline_s=deadline_s, trace=trace)

    def _leg_trace(trace_id: str, sampled: bool, leg: str) -> dict:
        # Both legs of one logical request share ONE trace_id (the
        # waterfall key) with distinct span ids per leg.
        return {"trace_id": trace_id,
                "span_id": telemetry.new_span_id(),
                "sampled": sampled, "leg": leg, "phases": {}}

    tallies = [_ClientTally() for _ in range(clients)]
    hists = [telemetry.Histogram() for _ in range(clients)]
    errlog = _ErrorLog()
    hedges = [[0, 0] for _ in range(clients)]  # [launched, wins]
    failovers = [0] * clients
    delay = _HedgeDelay(hedge_floor_s, seed=seed)
    start = threading.Barrier(clients + 1)

    def client(c: int) -> None:
        tally, hist = tallies[c], hists[c]
        backup_replica = replicas[1 + (c % (len(replicas) - 1))]
        start.wait()
        for k in range(requests_per_client):
            q = pool[(c + k * clients) % len(pool)]
            tally.attempts += 1
            t0 = time.perf_counter()
            tid = telemetry.new_trace_id()
            sampled = telemetry.should_sample(tid)

            def _finish() -> None:
                dt = time.perf_counter() - t0
                tally.ok += 1
                hist.record(dt)
                delay.record(dt)

            def _failover() -> None:
                # The primary was lost/drained: re-admit on the hedge
                # partner — latency, never a lost admitted request.
                failovers[c] += 1
                telemetry.count("fleet.failovers")
                try:
                    fut = _submit(backup_replica, q,
                                  _leg_trace(tid, sampled, "failover"))
                    fut.result(timeout=result_timeout_s)
                except Exception as e:
                    tally.errors += 1
                    errlog.record(client=c, trace_id=tid,
                                  leg="failover", error=repr(e))
                    return
                _finish()

            try:
                primary = _submit(replicas[0], q,
                                  _leg_trace(tid, sampled, "primary"))
            except ServerClosed:
                _failover()
                continue
            except Exception as e:
                tally.errors += 1
                errlog.record(client=c, trace_id=tid, leg="primary",
                              error=repr(e))
                continue
            hedge_after = delay.delay_s()
            try:
                primary.result(timeout=hedge_after)
                _finish()
                continue
            except ServerClosed:
                # Admitted, then the replica died out from under it
                # (kill/preempt mid-flight): the survivor still owes
                # the answer.
                _failover()
                continue
            except Exception as e:
                # done-with-exception = a real failure (shed, deadline,
                # fault) — NOT a hedge trigger. Only an unanswered
                # primary past the delay hedges (the wait timed out and
                # the future is still pending/running).
                if primary.done():
                    tally.errors += 1
                    errlog.record(client=c, trace_id=tid,
                                  leg="primary", error=repr(e))
                    continue
            # Primary is the straggler: hedge to the next replica.
            hedges[c][0] += 1
            telemetry.count("fleet.hedge_launched")
            try:
                hedge = _submit(backup_replica, q,
                                _leg_trace(tid, sampled, "hedge"))
            except Exception:
                hedge = None
            futs = [f for f in (primary, hedge) if f is not None]
            done, _pending = wait(futs, timeout=result_timeout_s,
                                  return_when=FIRST_COMPLETED)
            # wait(FIRST_COMPLETED) returns EVERY future already done,
            # not just the first — when both landed in the window,
            # crediting the hedge would inflate the win rate, so the
            # primary takes attribution ties (wins are undercounted,
            # never overcounted).
            winner = None
            if primary in done:
                winner = primary
            elif hedge is not None and hedge in done:
                winner = hedge
            if winner is None:
                tally.errors += 1
                errlog.record(client=c, trace_id=tid, leg="hedged",
                              error="no leg answered in time")
                continue
            loser = primary if winner is hedge else hedge
            try:
                winner.result(timeout=result_timeout_s)
            except ServerClosed:
                # The winning leg was on a dying replica. The other
                # leg (if any) may still answer; else re-admit.
                salvaged = False
                if loser is not None:
                    try:
                        loser.result(timeout=result_timeout_s)
                        salvaged = True
                    except Exception:
                        salvaged = False
                if salvaged:
                    if loser is hedge:
                        hedges[c][1] += 1
                        telemetry.count("fleet.hedge_wins")
                    telemetry.event(
                        "trace.hedge", trace_id=tid,
                        winner="hedge" if loser is hedge else "primary",
                        loser="cancelled_by_replica_loss",
                        salvaged=True)
                    _finish()
                else:
                    _failover()
                continue
            except Exception as e:
                if loser is not None:
                    loser.cancel()
                tally.errors += 1
                errlog.record(client=c, trace_id=tid, leg="winner",
                              error=repr(e))
                continue
            # Cancelled only AFTER the winner resolved: a queued loser
            # drops at batch pickup; one already running finishes and
            # is ignored — but it stays claimable while the winner
            # could still turn out to sit on a dying replica.
            if loser is not None:
                loser.cancel()
            if winner is hedge:
                hedges[c][1] += 1
                telemetry.count("fleet.hedge_wins")
            telemetry.event(
                "trace.hedge", trace_id=tid,
                winner="hedge" if winner is hedge else "primary",
                loser="cancelled" if loser is not None else "none")
            # The hedged request's end-to-end latency feeds the p95 too
            # — a systematically slow primary keeps the trigger honest.
            _finish()

    threads = [
        threading.Thread(target=client, args=(c,), daemon=True,
                         name=f"loadgen-client-{c}")
        for c in range(clients)
    ]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    duration = max(time.perf_counter() - t0, 1e-9)
    merged = telemetry.Histogram()
    for h in hists:
        merged.merge(h)
    launched = sum(h[0] for h in hedges)
    wins = sum(h[1] for h in hedges)
    ok = sum(t.ok for t in tallies)
    return {
        "clients": clients,
        "requests_per_client": requests_per_client,
        "duration_s": round(duration, 4),
        "completed": ok,
        "errors": sum(t.errors for t in tallies),
        "error_records": errlog.report(),
        "sustained_qps": round(ok / duration, 2),
        "failovers": sum(failovers),
        "hedge_launched": launched,
        "hedge_wins": wins,
        "hedge_win_frac": round(wins / launched, 4) if launched else 0.0,
        "p50_s": round(merged.quantile(0.5), 6),
        "p99_s": round(merged.quantile(0.99), 6),
    }
