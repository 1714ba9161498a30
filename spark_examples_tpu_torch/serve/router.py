"""Multi-model request router: priority admission + the fleet worker.

One :class:`FleetRouter` is a whole serving fleet in one process: many
named routes (each a (model, panel) pair — serve/fleet.py builds them
from a manifest), one warm panel pool under an explicit budget
(serve/pool.py), one shared result cache namespaced by model
fingerprint, and ONE batching worker owning all device work — the same
single-writer discipline the single-model server proved, so panel
eviction/re-staging can never tear an in-flight batch.

Admission is class-aware (core/config.py ``PRIORITY_CLASSES``):
``interactive`` requests drain strictly before ``batch`` backfill, each
class has its own bounded queue (its shed threshold) and default
deadline, and batch-class coalescing yields early when interactive work
arrives. Served coordinates ride the exact single-model math
(:func:`serve.engine.batch_coords`), so every route is bit-identical to
its own single-model server and to the offline ``project`` CLI —
including immediately after an LRU eviction + re-stage of its panel
(pinned by tests/test_torch_fleet.py).

On a CUDA device the router owns one stream. The worker makes the
router's device and stream current on itself before its first batch,
and every stage, eviction and batch runs there; an admin warm from
another thread stages on the same stream under the engine lock. An
evicted panel's tensors are dropped under that lock, after the batch
that read them synchronised (its answers are copied to the host), so
the caching allocator never hands their memory to the next stage while
a kernel still reads it.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import (
    DEFAULT_PRIORITY,
    PRIORITY_CLASSES,
)
from spark_examples_tpu_torch.ingest.source import close_source
from spark_examples_tpu_torch.pipelines import project as P
from spark_examples_tpu_torch.serve import engine as E
from spark_examples_tpu_torch.serve import health as H
from spark_examples_tpu_torch.serve.cache import ResultCache, genotype_digest
from spark_examples_tpu_torch.serve.health import CircuitBreaker
from spark_examples_tpu_torch.serve.pool import PanelPool, PanelUnavailable
from spark_examples_tpu_torch.serve.server import (
    DeadlineExceeded,
    ServerClosed,
    ServerOverloaded,
)

# Literal gauge names per class (the graftlint telemetry-name rule
# wants literal declarations; the class picks WHICH literal at run
# time). Keys are the PRIORITY_CLASSES members.
_DEPTH_GAUGES = {
    PRIORITY_CLASSES[0]: "serve.priority.depth_interactive",
    PRIORITY_CLASSES[1]: "serve.priority.depth_batch",
}
_SHED_COUNTERS = {
    PRIORITY_CLASSES[0]: "serve.priority.shed_interactive",
    PRIORITY_CLASSES[1]: "serve.priority.shed_batch",
}


class UnknownRoute(ValueError):
    """Request names a route the fleet does not serve."""


def _copy_result(value):
    """Defensive copy of a cached/served result — (1, k) coords for
    project requests, an (ids, sims) tuple for topk — so no caller can
    mutate the cache's arrays in place."""
    if isinstance(value, tuple):
        return tuple(np.array(v) for v in value)
    return np.array(value)


@dataclass
class Route:
    """One servable (model, panel) pair, by name.

    ``panel_source_fn`` builds a FRESH panel source per stage (store
    readahead threads and memmaps live only for the stage's duration);
    ``n_variants`` is probed at load when the source knows its length
    (a store manifest does) and pinned by the first stage either way.
    """

    name: str
    ctx: E.ModelContext
    panel_source_fn: object  # () -> GenotypeSource
    block_variants: int
    n_variants: int | None = None
    # Manifest capability: this route also answers /neighbors (exact
    # query-vs-panel top-k through the model metric's PairSpec).
    topk: bool = False
    breaker: CircuitBreaker = field(default_factory=CircuitBreaker)
    # Per-class client-visible latency histograms (autoscale p99) and
    # request tallies — route-local, beside the process-wide serve.*
    # registry series.
    lat: dict = field(default_factory=dict)
    tally: dict = field(default_factory=dict)
    tally_lock: threading.Lock = field(default_factory=threading.Lock,
                                       repr=False)

    def __post_init__(self):
        for cls in PRIORITY_CLASSES:
            self.lat.setdefault(cls, telemetry.Histogram())
        self.tally.setdefault("admitted", 0)
        self.tally.setdefault("completed", 0)
        self.tally.setdefault("shed", 0)
        self.tally.setdefault("errors", 0)
        self.tally.setdefault("deadline_expired", 0)
        self.tally.setdefault("cancelled", 0)
        self.tally.setdefault("cache_hits", 0)
        self.tally.setdefault("stages", 0)
        self.tally.setdefault("topk_requests", 0)

    @property
    def cache_ns(self) -> str:
        return self.ctx.model.digest()

    @property
    def panel_bytes_hint(self) -> int | None:
        """Projected dense panel residency (n_ref x n_variants int8
        bytes), or None before the panel length is known. The router
        compares it to the pool budget to choose whole-panel staging
        vs shard-staged serving BEFORE any bytes move."""
        if self.n_variants is None:
            return None
        return int(self.ctx.n_ref) * int(self.n_variants)

    def bump(self, key: str, n: int = 1) -> None:
        with self.tally_lock:
            self.tally[key] += n

    def stage(self):
        """One panel stage: fresh source, identity-checked against the
        model, closed afterwards (readahead pools must not outlive the
        stage)."""
        src = self.panel_source_fn()
        try:
            P.check_reference_panel(self.ctx.model, src)
            blocks, n_variants, nbytes = E.stage_blocks(
                src, self.block_variants, self.ctx.device)
            if self.n_variants is not None and n_variants != self.n_variants:
                raise ValueError(
                    f"route {self.name!r}: panel streamed {n_variants} "
                    f"variants, expected {self.n_variants} — the panel "
                    "changed under the model; refit it"
                )
        finally:
            _close_source(src)
        self.n_variants = n_variants
        self.bump("stages")
        return blocks, n_variants, nbytes


def _close_source(src) -> None:
    try:
        close_source(src)  # wrappers forward close to what they wrap
    except Exception:
        pass  # a close failure must not mask the stage outcome


@dataclass
class _Pending:
    route: str
    cls: str
    genotypes: np.ndarray  # (V,) int8, contiguous
    future: Future
    digest: str | None
    t_submit: float
    deadline: float | None
    # "project" -> (1, k) coordinates; "topk" -> ((1, k) neighbor
    # indices, (1, k) exact similarities). Batches coalesce only within
    # one kind — the two kinds finalize differently.
    kind: str = "project"
    k: int = 0  # topk only: neighbors requested
    finished: bool = False
    # Request-scoped trace context (serve/http.py mints it): the worker
    # writes phase timings into trace["phases"] BEFORE resolving the
    # future, so the handler reads them with happens-before for free.
    trace: dict | None = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class _PriorityQueues:
    """Bounded two-class admission: strict class order on take, per-
    class shed thresholds on put, same-route coalescing for the
    batcher. One condition guards both deques."""

    def __init__(self, bounds: dict[str, int]):
        self._bounds = dict(bounds)
        self._cond = threading.Condition()
        self._q: dict[str, deque] = {cls: deque()
                                     for cls in PRIORITY_CLASSES}
        self._route_depth: dict[str, int] = {}

    def put(self, p: _Pending) -> None:
        with self._cond:
            if len(self._q[p.cls]) >= self._bounds[p.cls]:
                telemetry.count(_SHED_COUNTERS[p.cls])
                raise ServerOverloaded(
                    f"{p.cls} admission queue full "
                    f"({self._bounds[p.cls]} waiting); retry with "
                    "backoff"
                )
            self._q[p.cls].append(p)
            self._route_depth[p.route] = \
                self._route_depth.get(p.route, 0) + 1
            telemetry.gauge_set(_DEPTH_GAUGES[p.cls],
                                float(len(self._q[p.cls])))
            self._cond.notify()

    def _first_class_locked(self) -> str | None:
        for cls in PRIORITY_CLASSES:
            if self._q[cls]:
                return cls
        return None

    def _pop_locked(self, cls: str) -> _Pending:
        p = self._q[cls].popleft()
        self._route_depth[p.route] = \
            max(0, self._route_depth.get(p.route, 1) - 1)
        telemetry.gauge_set(_DEPTH_GAUGES[cls],
                            float(len(self._q[cls])))
        return p

    def take_batch(self, max_batch: int, linger_s: float,
                   timeout: float = 0.05) -> list[_Pending]:
        """Up to ``max_batch`` same-route, same-class requests;
        interactive strictly first. Batch-class coalescing stops
        lingering the moment interactive work arrives (the preemption
        half of the priority contract)."""
        with self._cond:
            cls = self._first_class_locked()
            if cls is None:
                self._cond.wait(timeout)
                cls = self._first_class_locked()
                if cls is None:
                    return []
            if cls == PRIORITY_CLASSES[0]:
                head = self._q[cls][0]
                if any(self._q[other] and
                       self._q[other][0].t_submit < head.t_submit
                       for other in PRIORITY_CLASSES[1:]):
                    telemetry.count("serve.priority.preemptions")
            first = self._pop_locked(cls)
            batch = [first]
            linger_until = time.perf_counter() + linger_s

            def _same(p: _Pending) -> bool:
                # Same route AND same kind: project and topk rows
                # finalize differently, so a mixed batch cannot share a
                # device step.
                return p.route == first.route and p.kind == first.kind

            while len(batch) < max_batch:
                q = self._q[cls]
                while q and _same(q[0]) and len(batch) < max_batch:
                    batch.append(self._pop_locked(cls))
                if len(batch) >= max_batch:
                    break
                if q and not _same(q[0]):
                    break  # different route/kind waiting — serve it next
                if (cls != PRIORITY_CLASSES[0]
                        and self._q[PRIORITY_CLASSES[0]]):
                    break  # interactive arrived: stop padding batch work
                remaining = linger_until - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            return batch

    def drain_all(self) -> list[_Pending]:
        with self._cond:
            out = []
            for cls in PRIORITY_CLASSES:
                out.extend(self._q[cls])
                self._q[cls].clear()
                telemetry.gauge_set(_DEPTH_GAUGES[cls], 0.0)
            self._route_depth.clear()
            return out

    def depths(self) -> dict[str, int]:
        with self._cond:
            return {cls: len(self._q[cls]) for cls in PRIORITY_CLASSES}

    def route_depth(self, route: str) -> int:
        with self._cond:
            return self._route_depth.get(route, 0)


class FleetRouter:
    """The multi-model server: routes + pool + priority admission +
    one batching worker. Build one from a manifest with
    :func:`serve.fleet.build_fleet` (or hand it routes directly; each
    route's model context must live on the router's ``device``, which
    defaults to the card and raises where there is none)."""

    def __init__(self, pool: PanelPool,
                 max_batch: int = 8,
                 max_linger_s: float = 0.002,
                 cache_entries: int = 256,
                 queue_bounds: dict[str, int] | None = None,
                 class_deadlines_s: dict[str, float] | None = None,
                 drain_timeout_s: float = 60.0,
                 device="cuda"):
        self.device, self.stream = E.device_stream(device)
        self.routes: dict[str, Route] = {}
        self.pool = pool
        self.max_batch = int(max_batch)
        self.max_linger_s = float(max_linger_s)
        self._queues = _PriorityQueues(
            queue_bounds
            or {cls: 64 for cls in PRIORITY_CLASSES})
        self._class_deadlines_s = dict(class_deadlines_s or {})
        self.drain_timeout_s = float(drain_timeout_s)
        self._cache = ResultCache(cache_entries)
        self._closed = False
        self._drained = False
        self._drain_clean = True
        self._stop = threading.Event()
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()
        self._admission_lock = threading.Lock()
        # Serializes device/pool work (the worker's batch step) against
        # route admin (load/unload, explicit evictions).
        self._engine_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._worker: threading.Thread | None = None
        self._worker_restarts = 0
        self._last_recovery = 0.0
        # Routes explicitly warmed (controller placement / startup):
        # readiness means every one of THESE is staged right now.
        # Lazily-staged routes don't count — LRU churn on cold routes
        # must not flap /readyz.
        self._warmed: set[str] = set()

    # -- route admin -------------------------------------------------------

    def add_route(self, route: Route) -> None:
        if route.ctx.device != self.device:
            raise ValueError(
                f"route {route.name!r} holds its model on "
                f"{route.ctx.device}, the router serves on {self.device}")
        with self._engine_lock:
            if route.name in self.routes:
                raise ValueError(
                    f"route {route.name!r} is already loaded")
            self.routes[route.name] = route
            telemetry.gauge_set("fleet.routes", float(len(self.routes)))

    def unload_route(self, name: str) -> bool:
        """Drop a route: its panel leaves the pool and its result-cache
        namespace is evicted whole (the lifecycle fix — entries of a
        gone model must not squat in the LRU until pressure happens to
        push them out)."""
        with self._engine_lock:
            route = self.routes.pop(name, None)
            if route is None:
                return False
            self._warmed.discard(name)
            self.pool.remove(name)
            evicted = self._cache.evict_namespace(route.cache_ns)
            if evicted:
                telemetry.count("fleet.cache_namespace_evictions",
                                evicted)
            telemetry.gauge_set("fleet.routes", float(len(self.routes)))
        self.publish_autoscale()
        return True

    def warm_route(self, name: str) -> None:
        """Stage a route's panel now (startup warming) instead of on
        first demand. Over-budget routes (panel_bytes_hint exceeds the
        pool budget) have no warm state to pre-stage — they serve
        shard-staged per request — so warming them is a no-op with a
        warning, not a budget violation."""
        route = self._route(name)
        hint = route.panel_bytes_hint
        if hint is not None and hint > self.pool.budget_bytes:
            warnings.warn(
                f"route {name!r}: its panel (~{hint} B) exceeds the "
                f"pool budget ({self.pool.budget_bytes} B), so it "
                "serves shard-staged per request and cannot be kept "
                "warm — raise --fleet-budget-mb to warm it",
                RuntimeWarning, stacklevel=2,
            )
            return
        with self._engine_lock, E.on_stream(self.stream):
            self.pool.acquire(route.name, route.stage,
                              breaker=route.breaker)
            self._warmed.add(route.name)
        self.publish_autoscale()

    def _route(self, name: str) -> Route:
        route = self.routes.get(name)
        if route is None:
            raise UnknownRoute(
                f"unknown route {name!r}; loaded routes: "
                f"{sorted(self.routes) or '(none)'}"
            )
        return route

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._worker is not None:
            raise RuntimeError("fleet router already started")
        self._worker = threading.Thread(
            target=self._run, name="fleet-serve-worker", daemon=True)
        self._worker.start()
        telemetry.gauge_set("serve.in_flight", 0)
        telemetry.gauge_set("fleet.routes", float(len(self.routes)))
        H.publish(self.health)
        return self

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def health(self) -> str:
        """Fleet health: draining once closed; else the worst member
        state (health.worst) over every route's breaker and the
        worker's recovery cooloff — one route serving cached-only
        degrades the whole process's /healthz."""
        if self._closed:
            return H.DRAINING
        states = [
            H.DEGRADED if r.breaker.state != "closed" else H.HEALTHY
            for r in list(self.routes.values())  # snapshot: routes
            # mutate under the engine lock while scrapes read freely
        ]
        states.append(
            H.DEGRADED
            if (self._last_recovery
                and time.monotonic() - self._last_recovery
                < H.DEGRADED_COOLOFF_S)
            else H.HEALTHY)
        return H.worst(states)

    def health_info(self) -> dict:
        state = self.health
        H.publish(state)
        return {
            "status": state,
            "in_flight": self.in_flight,
            "worker_restarts": self._worker_restarts,
            "worker_alive": (self._worker is not None
                             and self._worker.is_alive()),
            "routes": {
                name: {
                    "staged": self.pool.is_staged(name),
                    "breaker": r.breaker.snapshot(),
                }
                for name, r in sorted(list(self.routes.items()))
            },
            "pool": self.pool.stats(),
        }

    def ready_info(self) -> dict:
        """Readiness (vs /healthz liveness): a replica is READY when
        its worker is alive, it is not draining, and every explicitly
        warmed route is staged in the pool right now — the controller
        gates admission on this so hedges never land on a replica
        still staging its warm set. A degraded-but-serving replica is
        ready; a warming one is not."""
        alive = self._worker is not None and self._worker.is_alive()
        warmed = sorted(self._warmed)
        missing = [n for n in warmed if not self.pool.is_staged(n)]
        return {
            "ready": H.readiness(alive, self._closed, missing),
            "worker_alive": alive,
            "draining": self._closed,
            "warmed_routes": warmed,
            "unstaged_routes": missing,
        }

    @property
    def in_flight(self) -> int:
        with self._in_flight_lock:
            return self._in_flight

    def drain(self, timeout: float | None = None) -> bool:
        """Close admission, answer everything admitted, stop the
        worker; stragglers are failed loudly (ServerClosed) and
        counted as ``serve.drain_abandoned``, never dropped.
        ``timeout=None`` uses the configured ``--drain-timeout-s``.
        Idempotent."""
        if timeout is None:
            timeout = self.drain_timeout_s
        with self._admission_lock:
            if self._drained:
                return self._drain_clean
            self._closed = True
        H.publish(self.health)  # -> draining
        clean = True
        with telemetry.span("serve.drain", cat="serve"):
            deadline = time.perf_counter() + timeout
            while not self._idle.wait(timeout=0.05):
                alive = (self._worker is not None
                         and self._worker.is_alive())
                if time.perf_counter() > deadline or not alive:
                    clean = False
                    break
            self._stop.set()
            if self._worker is not None:
                self._worker.join(timeout=max(1.0, timeout / 2))
                clean = clean and not self._worker.is_alive()
            abandoned = 0
            for p in self._queues.drain_all():
                abandoned += 1
                self._fail(p, ServerClosed(
                    "fleet drained before this request was processed"))
            if abandoned:
                # The supervising parent reads this from the final
                # telemetry flush: how many admitted requests hit the
                # drain deadline unanswered (failed loudly, not lost).
                telemetry.count("serve.drain_abandoned", abandoned)
        self._drained = True
        self._drain_clean = clean
        return clean

    def close(self) -> None:
        if self._worker is None:
            self._closed = True
            return
        self.drain()

    # -- client surface ----------------------------------------------------

    def submit(self, route_name: str, genotypes: np.ndarray,
               priority: str = DEFAULT_PRIORITY,
               deadline_s: float | None = None,
               trace: dict | None = None,
               kind: str = "project", k: int = 0) -> Future:
        """Admit one single-sample query against ``route_name``;
        returns a Future resolving to its (1, k) coordinates — or, for
        ``kind="topk"``, to an ``(ids, sims)`` pair of (1, k) arrays
        (exact nearest panel neighbors). Raises :class:`UnknownRoute`,
        :class:`ServerOverloaded` (the class's bounded queue is full),
        :class:`ServerClosed` after drain, or ValueError on a malformed
        query / unknown priority class / a topk request against a route
        without the capability."""
        if self._closed:
            raise ServerClosed("fleet is draining/closed")
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {priority!r}; classes: "
                f"{' | '.join(PRIORITY_CLASSES)}"
            )
        route = self._route(route_name)
        if kind not in ("project", "topk"):
            raise ValueError(f"unknown request kind {kind!r}")
        if kind == "topk":
            if not route.topk:
                raise ValueError(
                    f"route {route_name!r} does not declare the 'topk' "
                    "capability — add \"topk\": true to its manifest "
                    "entry"
                )
            if not 1 <= int(k) <= 65536:
                raise ValueError(
                    f"topk request needs 1 <= k <= 65536, got {k!r}")
            k = int(k)
            route.bump("topk_requests")
            telemetry.count("neighbors.requests")
        g = np.ascontiguousarray(genotypes, dtype=np.int8)
        if g.ndim == 2 and g.shape[0] == 1:
            g = g[0]
        if g.ndim != 1 or (route.n_variants is not None
                           and g.shape[0] != route.n_variants):
            raise ValueError(
                f"a query is one sample's ({route.n_variants},) int8 "
                f"dosage vector for route {route_name!r}, got shape "
                f"{g.shape}"
            )
        t0 = time.perf_counter()
        digest = None
        if self._cache.capacity:
            # topk results live beside project results in the same
            # model-fingerprint namespace; the digest's namespace arg
            # keys the KIND (and k), so the two can never answer each
            # other — while unload_route still evicts both at once.
            digest = genotype_digest(
                g, namespace=f"topk:{k}" if kind == "topk" else "")
            hit = self._cache.get(digest, namespace=route.cache_ns)
            if hit is not None:
                telemetry.count("serve.cache_hits")
                telemetry.observe("serve.latency_s",
                                  time.perf_counter() - t0)
                route.bump("cache_hits")
                route.bump("completed")
                route.lat[priority].record(time.perf_counter() - t0)
                if trace is not None:
                    trace["cache_hit"] = True
                    trace.setdefault("phases", {})["cache"] = \
                        time.perf_counter() - t0
                fut: Future = Future()
                fut.set_result(_copy_result(hit))
                return fut
            telemetry.count("serve.cache_misses")
        if deadline_s is None:
            deadline_s = self._class_deadlines_s.get(priority) or None
        pending = _Pending(
            route=route_name,
            cls=priority,
            genotypes=g,
            future=Future(),
            digest=digest,
            t_submit=t0,
            deadline=(t0 + deadline_s) if deadline_s else None,
            kind=kind,
            k=k,
            trace=trace,
        )
        with self._admission_lock:
            if self._closed:
                raise ServerClosed("fleet is draining/closed")
            self._track(+1)
            try:
                self._queues.put(pending)
            except ServerOverloaded:
                self._track(-1)
                telemetry.count("serve.shed")
                route.bump("shed")
                raise
        telemetry.count("serve.requests")
        route.bump("admitted")
        return pending.future

    def project(self, route_name: str, genotypes: np.ndarray,
                timeout: float | None = None,
                priority: str = DEFAULT_PRIORITY,
                deadline_s: float | None = None,
                trace: dict | None = None) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(route_name, genotypes, priority=priority,
                           deadline_s=deadline_s,
                           trace=trace).result(timeout=timeout)

    def topk(self, route_name: str, genotypes: np.ndarray, k: int,
             timeout: float | None = None,
             priority: str = DEFAULT_PRIORITY,
             deadline_s: float | None = None,
             trace: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous topk convenience: ``(ids, sims)`` (1, k) arrays
        of the query's exact nearest panel neighbors."""
        return self.submit(route_name, genotypes, priority=priority,
                           deadline_s=deadline_s, trace=trace,
                           kind="topk", k=k).result(timeout=timeout)

    # -- introspection -----------------------------------------------------

    def queue_depths(self) -> dict[str, int]:
        return self._queues.depths()

    def publish_autoscale(self) -> None:
        """Per-route autoscale gauges onto the live telemetry plane
        (scraped via GET /metrics): queue depth, served p99, shed rate,
        panel residency — recomputed at publish time, so a scrape
        always reads the current truth."""
        for name, route in list(self.routes.items()):
            prefix = "fleet.route." + name
            telemetry.gauge_set(prefix + ".queue_depth",
                                float(self._queues.route_depth(name)))
            p99 = max(route.lat[cls].quantile(0.99)
                      for cls in PRIORITY_CLASSES)
            telemetry.gauge_set(prefix + ".p99_s", p99)
            with route.tally_lock:
                shed = route.tally["shed"]
                offered = route.tally["admitted"] + shed
            telemetry.gauge_set(
                prefix + ".shed_rate", shed / offered if offered else 0.0)
            telemetry.gauge_set(
                prefix + ".staged",
                1.0 if self.pool.is_staged(name) else 0.0)
            with route.tally_lock:
                topk_reqs = route.tally["topk_requests"]
            # The topk path is first-class autoscale input: a route
            # whose load is mostly /neighbors must scale on it too.
            telemetry.gauge_set(prefix + ".topk_requests",
                                float(topk_reqs))
        telemetry.gauge_set("fleet.routes", float(len(self.routes)))
        telemetry.gauge_set("fleet.pool_bytes",
                            float(self.pool.resident_bytes()))
        telemetry.gauge_set("fleet.pool_pressure", self.pool.pressure())

    def stats_payload(self) -> dict:
        """The fleet /stats payload: pool + per-route accounting with
        per-class latency digests (README 'Fleet serving')."""
        self.publish_autoscale()
        per_route = {}
        for name, route in sorted(list(self.routes.items())):
            with route.tally_lock:
                tally = dict(route.tally)
            per_route[name] = {
                **tally,
                "staged": self.pool.is_staged(name),
                "topk": route.topk,
                "n_variants": route.n_variants,
                "queue_depth": self._queues.route_depth(name),
                "breaker": route.breaker.snapshot(),
                "latency_ms": {
                    cls: {
                        "p50": round(
                            route.lat[cls].quantile(0.5) * 1e3, 3),
                        "p99": round(
                            route.lat[cls].quantile(0.99) * 1e3, 3),
                        "count": route.lat[cls].count,
                    }
                    for cls in PRIORITY_CLASSES
                },
            }
        return {
            "health": self.health_info(),
            "queues": self.queue_depths(),
            "pool": self.pool.stats(),
            "result_cache": self._cache.stats(),
            "routes": per_route,
        }

    # -- worker ------------------------------------------------------------

    def _track(self, delta: int) -> None:
        with self._in_flight_lock:
            self._in_flight += delta
            n = self._in_flight
            if n == 0:
                self._idle.set()
            else:
                self._idle.clear()
            telemetry.gauge_set("serve.in_flight", n)

    def _finish(self, p: _Pending) -> None:
        if not p.finished:
            p.finished = True
            self._track(-1)

    def _fail(self, p: _Pending, exc: BaseException) -> None:
        if not p.future.done():
            p.future.set_exception(exc)
        self._finish(p)

    def _note_recovery(self, reason: str) -> None:
        self._worker_restarts += 1
        self._last_recovery = time.monotonic()
        telemetry.count("serve.worker_restarts")
        warnings.warn(
            f"fleet worker recovered ({reason}) — admitted requests "
            "were NOT dropped; health degrades for "
            f"{H.DEGRADED_COOLOFF_S:.0f}s",
            RuntimeWarning, stacklevel=2,
        )

    def _run(self) -> None:
        E.bind_stream(self.device, self.stream)
        while not self._stop.is_set():
            try:
                batch = self._queues.take_batch(
                    self.max_batch, self.max_linger_s)
                if batch:
                    try:
                        self._process(batch)
                    except BaseException as e:
                        for p in batch:
                            self._fail(p, e)
            except BaseException as e:
                if self._stop.is_set():
                    return
                self._note_recovery(f"worker loop error: {e!r}")
                time.sleep(0.005)

    def _sharded_blocks(self, route: Route):
        """Shard-staged panel feed for a route whose panel exceeds the
        pool budget: a generator of ``(device_block, meta)`` pairs that
        stages the panel as a SEQUENCE of store-fed shards (engine.
        shard_stream), each at most one budget's worth of bytes. Every
        shard stage runs the same protocol as a pooled stage — breaker
        admission (PanelUnavailable when open; the first shard of the
        next request is the half-open probe), a ``fleet.stage`` span
        with the ``fleet.stage`` fault site fired first, breaker
        feedback — and charges the pool as transient residency
        (evicting other routes' warm panels, never evictable itself)
        for exactly as long as its blocks are being consumed. The
        consumer is the UNCHANGED batch_coords/batch_pair_sims loop:
        integer cross accumulation is partition-invariant, so sharded
        answers are bit-identical to whole-panel ones by construction.
        Runs under the engine lock (only the worker consumes it)."""
        src = route.panel_source_fn()
        try:
            P.check_reference_panel(route.ctx.model, src)
            it = E.shard_stream(src, route.block_variants,
                                self.pool.budget_bytes, route.ctx.device)
            shard = 0
            stop = 0
            while True:
                if not route.breaker.allow():
                    raise PanelUnavailable(
                        f"route {route.name!r}: shard {shard} cannot "
                        f"stage — the store breaker is "
                        f"{route.breaker.state}; attempts are short-"
                        "circuited until the reset window's probe"
                    )
                try:
                    with telemetry.span("fleet.stage", cat="fleet",
                                        route=route.name, shard=shard):
                        faults.fire("fleet.stage")
                        item = next(it, None)
                except Exception:
                    route.breaker.record_failure()
                    raise
                except BaseException:
                    # SIGINT/SystemExit mid-stage says nothing about
                    # the store: give the half-open probe slot back.
                    route.breaker.release_probe()
                    raise
                route.breaker.record_success()
                if item is None:
                    break
                blocks, nbytes = item
                telemetry.count("fleet.shard_stages")
                shard += 1
                with self.pool.transient(route.name, nbytes):
                    yield from blocks
                stop = blocks[-1][1].stop
                del blocks  # free the shard before staging the next
            if stop != route.n_variants:
                raise ValueError(
                    f"route {route.name!r}: sharded panel streamed "
                    f"{stop} variants, expected {route.n_variants} — "
                    "the panel changed under the model; refit it"
                )
            route.bump("stages")
        finally:
            _close_source(src)

    def _process(self, batch: list[_Pending]) -> None:
        route = self.routes.get(batch[0].route)
        with telemetry.span("serve.assemble", cat="serve"):
            live: list[_Pending] = []
            for p in batch:
                now = time.perf_counter()
                telemetry.observe("serve.enqueue_wait_s",
                                  now - p.t_submit)
                if p.trace is not None:
                    p.trace.setdefault("phases", {})["queue"] = \
                        now - p.t_submit
                try:
                    faults.fire("serve.request")
                except BaseException as e:
                    telemetry.count("serve.errors")
                    if route is not None:
                        route.bump("errors")
                    self._fail(p, e)
                    continue
                if route is None:
                    # Unloaded between admission and pickup: answered,
                    # never dropped.
                    self._fail(p, UnknownRoute(
                        f"route {p.route!r} was unloaded while this "
                        "request waited"))
                    continue
                if p.expired(now):
                    telemetry.count("serve.deadline_expired")
                    route.bump("deadline_expired")
                    self._fail(p, DeadlineExceeded(
                        "deadline passed before batch pickup"))
                    continue
                if not p.future.set_running_or_notify_cancel():
                    telemetry.count("serve.cancelled")
                    route.bump("cancelled")
                    self._finish(p)
                    continue
                live.append(p)
            if live and route.n_variants is None:
                # Pre-first-stage a route built over a length-blind
                # source admits any query length; a mixed batch would
                # blow up np.stack and fail EVERYONE with an error
                # about someone else's query. Fail only the rows that
                # disagree with the batch head — the stage itself then
                # validates the survivors against the real panel.
                want = live[0].genotypes.shape[0]
                kept = []
                for p in live:
                    if p.genotypes.shape[0] != want:
                        telemetry.count("serve.errors")
                        route.bump("errors")
                        self._fail(p, ValueError(
                            f"query carries {p.genotypes.shape[0]} "
                            f"variants but this batch's head carries "
                            f"{want} (route {route.name!r} has not "
                            "staged its panel yet)"))
                    else:
                        kept.append(p)
                live = kept
            if not live:
                return
            g = np.stack([p.genotypes for p in live])
        t_device = time.perf_counter()
        cold = not self.pool.is_staged(route.name)
        stage_s = 0.0
        kind = live[0].kind  # take_batch coalesces within one kind
        with telemetry.span("serve.device_step", cat="serve",
                            rows=len(live), route=route.name):
            hint = route.panel_bytes_hint
            sharded = hint is not None and hint > self.pool.budget_bytes
            try:
                with self._engine_lock:
                    if sharded:
                        # The panel cannot fit warm: feed the SAME
                        # batch loop a shard-staged block stream
                        # instead of a pooled panel. Staging overlaps
                        # compute, so stage_s stays 0 and every
                        # request is honestly cold.
                        telemetry.gauge_set(
                            "fleet.panel_over_budget_x",
                            hint / self.pool.budget_bytes)
                        blocks = self._sharded_blocks(route)
                        n_variants = route.n_variants
                        t_compute = time.perf_counter()
                    else:
                        panel = self.pool.acquire(
                            route.name, route.stage,
                            breaker=route.breaker)
                        blocks = panel.blocks
                        n_variants = panel.n_variants
                        t_compute = time.perf_counter()
                        if cold:
                            stage_s = t_compute - t_device
                    if kind == "topk":
                        sims = E.batch_pair_sims(
                            route.ctx, blocks, g, self.max_batch,
                            n_variants)
                    else:
                        coords = E.batch_coords(
                            route.ctx, blocks, g, self.max_batch,
                            n_variants)
            except BaseException as e:  # incl. PanelUnavailable
                telemetry.count("serve.errors", len(live))
                route.bump("errors", len(live))
                for p in live:
                    self._fail(p, e)
                return
        compute_s = time.perf_counter() - t_compute
        telemetry.observe("serve.batch_rows", len(live))
        if kind == "topk":
            # Per-row reduction on the host: each request may ask a
            # different k, and the reduction is the SAME topk_rows the
            # offline CLI runs — bit-identity by shared code.
            from spark_examples_tpu_torch.neighbors.engine import topk_rows

            results = [
                (p, topk_rows(sims[i:i + 1], p.k))
                for i, p in enumerate(live)
            ]
        else:
            results = [(p, row[None, :]) for p, row in zip(live, coords)]
        if self._cache.capacity:
            # Cache puts under the engine lock: unload_route (same
            # lock) may have raced batch completion, and entries put
            # AFTER its namespace eviction would squat unreclaimable
            # in the LRU — the exact leak evict_namespace exists to
            # close. Still loaded -> put; gone -> skip.
            with self._engine_lock:
                if self.routes.get(route.name) is route:
                    for p, result in results:
                        if p.digest is not None:
                            self._cache.put(p.digest, result,
                                            namespace=route.cache_ns)
        now = time.perf_counter()
        for p, result in results:
            if p.trace is not None:
                # Phase write-back BEFORE set_result: the HTTP handler
                # reads trace["phases"] after .result() returns, so
                # future resolution is the happens-before edge.
                ph = p.trace.setdefault("phases", {})
                if stage_s:
                    ph["stage"] = stage_s
                ph["compute"] = compute_s
                p.trace["cold_start"] = cold
                if p.trace.get("sampled"):
                    ids = {"trace_id": p.trace.get("trace_id", ""),
                           "span_id": p.trace.get("span_id", "")}
                    telemetry.span_at(
                        "trace.queue", p.t_submit,
                        ph.get("queue", 0.0),
                        route=p.route, cls=p.cls, **ids)
                    telemetry.span_at(
                        "trace.compute", t_device, now - t_device,
                        route=p.route, cls=p.cls, rows=len(results),
                        cold_start=cold,
                        stage_s=round(stage_s, 6), **ids)
            p.future.set_result(result)
            dt = now - p.t_submit
            telemetry.observe("serve.latency_s", dt)
            route.lat[p.cls].record(dt)
            route.bump("completed")
            self._finish(p)
