"""The async micro-batching projection server.

One background worker owns the engine and therefore all device work: it
makes the engine's device and CUDA stream current on itself first, and
so does a worker restarted at admission. HTTP handler threads and other
clients pass only numpy arrays and Futures, through
:meth:`ProjectionServer.submit`, which returns a
``concurrent.futures.Future``. The production envelope:

- **Admission control / load-shedding.** The request queue is bounded
  (``max_queue``); a full queue rejects the submit with an explicit
  :class:`ServerOverloaded` instead of letting latency grow without
  bound. Shedding is counted (``serve.shed``) — an overloaded server is
  *visibly* overloaded.
- **Micro-batching.** The worker takes the first waiting request, then
  lingers up to ``max_linger_s`` for more, up to the engine's
  ``max_batch``; the batch is padded to the engine's fixed shape.
- **Deadlines / cancellation.** A request whose deadline passed before
  batch pickup is answered with :class:`DeadlineExceeded` rather than
  occupying device time; a Future cancelled by its client is dropped at
  pickup. Both are counted.
- **Result cache.** Hits by genotype digest (namespaced by the model
  fingerprint) are answered at submit — no queue slot, no device work.
- **Graceful drain.** :meth:`drain` closes admission, waits for every
  in-flight request to resolve, and joins the worker; anything still
  unanswered after the timeout is failed explicitly with
  :class:`ServerClosed` — no silent drops, no hang.
- **Chaos.** Every request crosses the ``serve.request`` fault site
  (core/faults.py) in the worker's assembly sweep: an ``io_error``
  fails exactly that request, a ``delay`` stalls the worker so the
  bounded queue must shed, a ``kill`` simulates preemption.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.serve import health as H
from spark_examples_tpu_torch.serve.cache import ResultCache, genotype_digest
from spark_examples_tpu_torch.serve.engine import ProjectionEngine, bind_stream


class ServerOverloaded(RuntimeError):
    """Admission rejected: the bounded request queue is full. The
    explicit alternative to unbounded queueing latency — clients back
    off or retry elsewhere."""


class ServerClosed(RuntimeError):
    """Submit after drain/close (or a request stranded by shutdown)."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before the server got to it."""


@dataclass
class _Pending:
    genotypes: np.ndarray  # (V,) int8, contiguous
    future: Future
    digest: str | None
    t_submit: float  # perf_counter at admission
    deadline: float | None  # perf_counter deadline, None = none
    finished: bool = False  # guards double in-flight decrement

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


@dataclass
class ServerStats:
    """Point-in-time request accounting (monotonic counters; the same
    numbers flow into the telemetry registry under ``serve.*``)."""

    admitted: int = 0
    completed: int = 0
    shed: int = 0
    cache_hits: int = 0
    errors: int = 0
    deadline_expired: int = 0
    cancelled: int = 0
    batches: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False)

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "admitted": self.admitted,
                "completed": self.completed,
                "shed": self.shed,
                "cache_hits": self.cache_hits,
                "errors": self.errors,
                "deadline_expired": self.deadline_expired,
                "cancelled": self.cancelled,
                "batches": self.batches,
            }


class ProjectionServer:
    """Async micro-batching front over one :class:`ProjectionEngine`."""

    def __init__(self, engine: ProjectionEngine,
                 max_linger_s: float = 0.002,
                 max_queue: int = 64,
                 cache_entries: int = 256,
                 default_deadline_s: float | None = None,
                 drain_timeout_s: float = 60.0):
        self.engine = engine
        self.max_batch = engine.max_batch
        self.max_linger_s = float(max_linger_s)
        self.default_deadline_s = default_deadline_s
        self.drain_timeout_s = float(drain_timeout_s)
        self._q: queue.Queue[_Pending] = queue.Queue(
            maxsize=max(1, int(max_queue)))
        self._cache = ResultCache(cache_entries)
        self._cache_ns = engine.model.digest()
        self.stats = ServerStats()
        self._closed = False
        self._drained = False
        self._drain_clean = True
        self._stop = threading.Event()
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()
        # Serializes admission against the drain transition: drain flips
        # _closed under this lock, so a submit has either completed its
        # enqueue BEFORE the flip (drain then waits it out via
        # in_flight) or observes _closed — a request can never slip into
        # the queue after drain's backstop sweep and hang its Future.
        self._admission_lock = threading.Lock()
        # Serializes device work (the worker's batch step) against model
        # hot-reload — a reload must never tear a batch mid-flight.
        self._engine_lock = threading.Lock()
        self._idle = threading.Event()  # set while in_flight == 0
        self._idle.set()
        self._worker: threading.Thread | None = None
        # Worker supervision: recoveries are counted and time-stamped;
        # the health state machine reports degraded for a cooloff
        # window after each one (serve/health.py).
        self._worker_restarts = 0
        self._last_recovery = 0.0  # monotonic; 0 = never

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ProjectionServer":
        if self._worker is not None:
            raise RuntimeError("server already started")
        self._worker = threading.Thread(
            target=self._run, name="projection-serve-worker", daemon=True)
        self._worker.start()
        # Published before any request exists, so an idle server's
        # backlog reads 0 rather than absent.
        telemetry.gauge_set("serve.in_flight", 0)
        self._publish_health()
        return self

    # -- health state machine ----------------------------------------------

    def _publish_health(self) -> None:
        """Explicit transition-point publication (start, recovery,
        restage, drain) — the property also republishes on reads, but
        an explicit call is not mistakable for a dead statement."""
        H.publish(self._health_state())

    def _health_state(self) -> str:
        if self._closed:
            return H.DRAINING
        breaker = getattr(self.engine, "breaker", None)
        if breaker is not None and breaker.state != "closed":
            return H.DEGRADED
        if (self._last_recovery
                and time.monotonic() - self._last_recovery
                < H.DEGRADED_COOLOFF_S):
            return H.DEGRADED
        return H.HEALTHY

    @property
    def health(self) -> str:
        """healthy | degraded | draining (serve/health.py). Degraded =
        the batching worker recovered within the cooloff window, or the
        panel's store-read circuit breaker is open (cached-panel-only
        mode) — still serving either way. Every read republishes the
        ``serve.health`` gauge: several transitions are TIME-driven
        (cooloff expiry, the breaker's reset window) with no event to
        hook, so observation is what keeps the exported gauge from
        reading 'degraded' forever after a long-recovered incident."""
        state = self._health_state()
        H.publish(state)
        return state

    def health_info(self) -> dict:
        """The /healthz payload beyond the bare state string."""
        breaker = getattr(self.engine, "breaker", None)
        return {
            "status": self.health,
            "in_flight": self.in_flight,
            "worker_restarts": self._worker_restarts,
            "worker_alive": (self._worker is not None
                             and self._worker.is_alive()),
            "panel": getattr(self.engine, "panel_mode", "staged"),
            "breaker": (breaker.snapshot() if breaker is not None
                        else None),
        }

    def ready_info(self) -> dict:
        """Readiness (vs /healthz liveness): the single-model server is
        ready once its batching worker is alive and it is not draining
        — the engine's panel was staged before construction, so there
        is no warmup window beyond worker start. Degraded-but-serving
        is still ready."""
        alive = self._worker is not None and self._worker.is_alive()
        return {
            "ready": H.readiness(alive, self._closed),
            "worker_alive": alive,
            "draining": self._closed,
        }

    def stats_payload(self) -> dict:
        """The ``/stats`` payload — ONE coherent schema (documented in
        README "Serving"):

        - request accounting, flat (``admitted``/``completed``/
          ``shed``/``cache_hits``/``errors``/``deadline_expired``/
          ``cancelled``/``batches``),
        - ``latency_p50_ms``/``latency_p99_ms``/``batch_rows_mean``
          from the live telemetry histograms,
        - ``health`` — the full health-machine view
          (:meth:`health_info`: status string, worker restarts +
          liveness, panel mode, circuit-breaker snapshot), previously
          scattered between /healthz and ad-hoc /stats fields,
        - ``store_cache`` — the staged panel's decode-cache accounting
          (absent for non-store panels).
        """
        hists = telemetry.metrics_snapshot()["histograms"]
        lat = hists.get("serve.latency_s", {})
        rows = hists.get("serve.batch_rows", {})
        payload = {
            **self.stats.snapshot(),
            "latency_p50_ms": round(lat.get("p50", 0.0) * 1e3, 3),
            "latency_p99_ms": round(lat.get("p99", 0.0) * 1e3, 3),
            "batch_rows_mean": round(rows.get("mean", 0.0), 2),
            "health": self.health_info(),
        }
        store_cache = self.engine.store_cache_stats()
        if store_cache is not None:
            payload["store_cache"] = store_cache
        return payload

    def _note_recovery(self, reason: str) -> None:
        self._worker_restarts += 1
        self._last_recovery = time.monotonic()
        telemetry.count("serve.worker_restarts")
        self._publish_health()
        import warnings

        warnings.warn(
            f"projection server worker recovered ({reason}) — admitted "
            "requests were NOT dropped; health degrades for "
            f"{H.DEGRADED_COOLOFF_S:.0f}s",
            RuntimeWarning, stacklevel=3,
        )

    def _ensure_worker(self) -> None:
        """Supervision at admission: a worker thread that died
        unexpectedly (anything the in-loop recovery net could not
        catch) is replaced before the request queues — the queue's
        contents survive, so nothing admitted is dropped. The
        check-and-start runs under the admission lock: concurrent
        submits (the HTTP front is one handler thread per request)
        must not each observe the dead worker and start duplicate
        replacements — an orphaned extra loop would split batches and
        survive drain's single join."""
        w = self._worker
        if w is None or w.is_alive():
            return  # cheap unlocked fast path for the healthy case
        with self._admission_lock:
            w = self._worker
            if (w is None or w.is_alive() or self._stop.is_set()
                    or self._closed):
                return
            self._worker = threading.Thread(
                target=self._run, name="projection-serve-worker",
                daemon=True)
            self._worker.start()
        self._note_recovery("worker thread found dead at admission")

    def restage_panel(self, source_ref=None) -> bool:
        """Refresh the staged panel through the engine's circuit
        breaker (serialized against in-flight batches). False =
        cached-panel-only mode; health reports degraded while the
        breaker is open."""
        with self._engine_lock:
            ok = self.engine.restage(source_ref)
        self._publish_health()
        return ok

    def __enter__(self) -> "ProjectionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self, timeout: float | None = None) -> bool:
        """Close admission and wait for every in-flight request to
        resolve, then stop the worker. Returns True on a clean drain;
        on timeout (or a dead worker) the stragglers are failed with
        ServerClosed and counted as ``serve.drain_abandoned`` — an
        admitted request is ALWAYS answered, and the final telemetry
        export says how many hit the deadline.
        ``timeout=None`` uses the configured ``--drain-timeout-s``.
        Idempotent: a second drain (e.g. close() after drain()) returns
        the first one's verdict without re-walking the shutdown."""
        if timeout is None:
            timeout = self.drain_timeout_s
        with self._admission_lock:
            if self._drained:
                return self._drain_clean
            self._closed = True
        self._publish_health()  # -> draining
        clean = True
        with telemetry.span("serve.drain", cat="serve"):
            deadline = time.perf_counter() + timeout
            while not self._idle.wait(timeout=0.05):
                alive = self._worker is not None and self._worker.is_alive()
                if time.perf_counter() > deadline or not alive:
                    clean = False
                    break
            self._stop.set()
            if self._worker is not None:
                self._worker.join(timeout=max(1.0, timeout / 2))
                clean = clean and not self._worker.is_alive()
            # Backstop: anything the worker never picked up (it died, or
            # the drain timed out) is failed loudly, never dropped.
            abandoned = 0
            while True:
                try:
                    p = self._q.get_nowait()
                except queue.Empty:
                    break
                abandoned += 1
                self._fail(p, ServerClosed("server drained before this "
                                           "request was processed"))
            if abandoned:
                telemetry.count("serve.drain_abandoned", abandoned)
        self._drained = True
        self._drain_clean = clean
        return clean

    def close(self) -> None:
        if self._worker is None:
            self._closed = True
            return
        self.drain()  # idempotent: a no-op after an explicit drain()

    @property
    def in_flight(self) -> int:
        with self._in_flight_lock:
            return self._in_flight

    def reload_model(self, model) -> None:
        """Hot-swap the served model (same reference panel) without
        restarting: waits out any in-flight batch (the engine lock), then
        swaps + re-warms the engine and clears/re-namespaces the result
        cache so a stale coordinate can never be served."""
        if isinstance(model, (str, bytes)):
            from spark_examples_tpu_torch.pipelines.project import load_model

            model = load_model(model)
        with self._engine_lock:
            # Re-namespace + clear BEFORE the engine swap: a submit
            # racing the reload either hits the old cache while the old
            # model is still installed (consistent), or — once the
            # namespace flips — misses and queues behind the engine
            # lock, to be served by (and cached under) the new model.
            # The inverse order had a window serving old-model cache
            # entries after the new model was live.
            old_ns = self._cache_ns
            self._cache_ns = model.digest()
            self._cache.clear()
            try:
                self.engine.reload_model(model)
            except BaseException:
                # Rejected reload (e.g. wrong panel): the old model is
                # still serving — restore its namespace (the cache is
                # already empty, so nothing stale can ever match).
                self._cache_ns = old_ns
                raise

    # -- client surface ----------------------------------------------------

    def submit(self, genotypes: np.ndarray,
               deadline_s: float | None = None) -> Future:
        """Admit one single-sample query; returns a Future resolving to
        its (1, k) coordinates. Raises ServerOverloaded when the bounded
        queue is full, ServerClosed after drain, ValueError on a
        malformed query."""
        if self._closed:
            raise ServerClosed("server is draining/closed")
        self._ensure_worker()
        g = np.ascontiguousarray(genotypes, dtype=np.int8)
        if g.ndim == 2 and g.shape[0] == 1:
            g = g[0]
        if g.ndim != 1 or g.shape[0] != self.engine.n_variants:
            raise ValueError(
                f"a query is one sample's ({self.engine.n_variants},) "
                f"int8 dosage vector, got shape {g.shape}"
            )
        t0 = time.perf_counter()
        digest = None
        if self._cache.capacity:
            digest = genotype_digest(g)
            hit = self._cache.get(digest, namespace=self._cache_ns)
            if hit is not None:
                telemetry.count("serve.cache_hits")
                telemetry.observe("serve.latency_s",
                                  time.perf_counter() - t0)
                with self.stats.lock:
                    self.stats.cache_hits += 1
                    self.stats.completed += 1
                fut: Future = Future()
                # Copy (k floats): a hit hands out the same writable
                # result a miss does, never the cache's frozen storage.
                fut.set_result(np.array(hit))
                return fut
            telemetry.count("serve.cache_misses")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        pending = _Pending(
            genotypes=g,
            future=Future(),
            digest=digest,
            t_submit=t0,
            deadline=(t0 + deadline_s) if deadline_s else None,
        )
        # Admission happens under the drain-transition lock (see
        # __init__), and in_flight is raised BEFORE the put: the worker
        # may finish the request between put and a late increment, and
        # drain would then see a phantom in-flight forever.
        with self._admission_lock:
            if self._closed:
                raise ServerClosed("server is draining/closed")
            self._track(+1)
            try:
                self._q.put_nowait(pending)
            except queue.Full:
                self._track(-1)
                telemetry.count("serve.shed")
                with self.stats.lock:
                    self.stats.shed += 1
                raise ServerOverloaded(
                    f"admission queue full ({self._q.maxsize} waiting); "
                    "retry with backoff"
                ) from None
        telemetry.count("serve.requests")
        with self.stats.lock:
            self.stats.admitted += 1
        return pending.future

    def project(self, genotypes: np.ndarray,
                timeout: float | None = None,
                deadline_s: float | None = None) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(genotypes, deadline_s=deadline_s).result(
            timeout=timeout)

    # -- worker ------------------------------------------------------------

    def _track(self, delta: int) -> None:
        with self._in_flight_lock:
            self._in_flight += delta
            n = self._in_flight
            # The idle event flips INSIDE the lock: set/clear outside it
            # can interleave inverted (0->1 clears after 1->0 set) and
            # mark an occupied server idle — drain would then stop the
            # worker under a live request.
            if n == 0:
                self._idle.set()
            else:
                self._idle.clear()
            # Gauge published inside the lock for the same reason the
            # event flips inside it: out-of-order publishes would leave
            # the exported backlog reading stale/inverted.
            telemetry.gauge_set("serve.in_flight", n)

    def _finish(self, p: _Pending) -> None:
        if not p.finished:
            p.finished = True
            self._track(-1)

    def _fail(self, p: _Pending, exc: BaseException) -> None:
        if not p.future.done():
            p.future.set_exception(exc)
        self._finish(p)

    def _run(self) -> None:
        bind_stream(self.engine.device, self.engine.stream)
        while not self._stop.is_set():
            try:
                batch = self._collect()
                if batch:
                    try:
                        self._process(batch)
                    except BaseException as e:  # backstop: answer, don't die
                        for p in batch:
                            self._fail(p, e)
            except BaseException as e:
                # The supervision net around the loop body itself: a
                # failure in _collect (or in the failure handling
                # above) must not silently end the serving thread —
                # recover in place, leave the queue intact, degrade.
                if self._stop.is_set():
                    return
                self._note_recovery(f"worker loop error: {e!r}")
                time.sleep(0.005)  # never a hot crash loop

    def _collect(self) -> list[_Pending]:
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        linger_until = time.perf_counter() + self.max_linger_s
        while len(batch) < self.max_batch:
            remaining = linger_until - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _process(self, batch: list[_Pending]) -> None:
        with telemetry.span("serve.assemble", cat="serve"):
            live: list[_Pending] = []
            for p in batch:
                now = time.perf_counter()
                telemetry.observe("serve.enqueue_wait_s", now - p.t_submit)
                try:
                    # Chaos site: per admitted request (see module doc).
                    faults.fire("serve.request")
                except BaseException as e:
                    telemetry.count("serve.errors")
                    with self.stats.lock:
                        self.stats.errors += 1
                    self._fail(p, e)
                    continue
                if p.expired(now):
                    telemetry.count("serve.deadline_expired")
                    with self.stats.lock:
                        self.stats.deadline_expired += 1
                    self._fail(p, DeadlineExceeded(
                        "deadline passed before batch pickup"))
                    continue
                if not p.future.set_running_or_notify_cancel():
                    telemetry.count("serve.cancelled")
                    with self.stats.lock:
                        self.stats.cancelled += 1
                    self._finish(p)
                    continue
                live.append(p)
            if not live:
                return
            g = np.stack([p.genotypes for p in live])
        with telemetry.span("serve.device_step", cat="serve",
                            rows=len(live)):
            try:
                with self._engine_lock:
                    coords = self.engine.project_batch(g)
            except BaseException as e:
                telemetry.count("serve.errors", len(live))
                with self.stats.lock:
                    self.stats.errors += len(live)
                for p in live:
                    self._fail(p, e)
                return
        telemetry.observe("serve.batch_rows", len(live))
        with self.stats.lock:
            self.stats.batches += 1
        now = time.perf_counter()
        for p, row in zip(live, coords):
            result = row[None, :]
            if p.digest is not None:
                # Namespace read HERE, not at submit: a request that
                # raced a hot-reload was computed by the NEW model
                # (behind the engine lock), so its row must land under
                # the new namespace.
                self._cache.put(p.digest, result,
                                namespace=self._cache_ns)
            p.future.set_result(result)
            telemetry.observe("serve.latency_s", now - p.t_submit)
            with self.stats.lock:
                self.stats.completed += 1
            self._finish(p)
