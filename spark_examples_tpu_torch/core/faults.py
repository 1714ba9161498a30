"""Deterministic, seeded fault injection.

Named **sites** in the ingest and store code call :func:`fire`; tests
and chaos runs arm **specs** against those sites to raise transient
IOErrors, delay a read, truncate a file just before it is read, or kill
the process. A seeded ``random.Random`` and per-site hit counters
decide every fire, so an injected run repeats exactly. With nothing
armed, :func:`fire` is one global check and a return.

Sites wired in the port (all sixteen of the JAX package's
``core/faults.py``):

==========================  ================================================
``ingest.block_read``       per block, inside the retry boundary of
                            ``ingest/resilient.py::RetryingSource`` and
                            per shard attempt in ``ingest/parallel.py``
``store.read``              per chunk read in the store
                            (``store/reader.py``), with the chunk file's
                            path, before the bytes are mapped
``store.readahead.decode``  per background chunk warm, inside the
                            readahead pool worker (``store/readahead.py``)
``checkpoint.tile_write``   per checkpoint file, AFTER its sha256 was
                            recorded, so a truncation corrupts it against
                            the manifest (``core/checkpoint.py``)
``checkpoint.tile_read``    per checkpoint file during verification on
                            load, before it is hashed
``multihost.consensus``     per control-plane allgather round of the
                            consensus feeder (``parallel/multihost.py``),
                            outside its span: a delay is this rank's own
                            lateness, the span its wait for the others
``neighbors.candidates``    per block attempt of the neighbors job's exact
                            candidate evaluation, inside its IO retry
                            boundary (``neighbors/engine.py``)
``device.put``              per block, just before the feed's host->device
                            copy (``ingest/prefetch.py``)
``prefetch.transfer_wait``  per staging slab retired by the CUDA feed,
                            before it waits out the slab's copy
``serve.request``           per admitted request, in the serving worker's
                            batch assembly (``serve/server.py``): an
                            io_error fails exactly that request
``telemetry.flush``         inside each periodic telemetry flush, before
                            ``metrics.json`` is rewritten
``trace.export``            before ``requests.json`` (the slowest-request
                            exemplars) is written
``supervisor.heartbeat``    before each heartbeat file write of a supervised
                            child (``core/supervisor.py``): a delay freezes
                            the heartbeat thread, an io_error fails one
                            write with a warning
``fleet.stage``             before each panel (or shard) stage of the fleet's
                            warm pool (``serve/pool.py``, ``serve/router.py``),
                            inside the ``fleet.stage`` span and the route's
                            breaker
``controller.scrape``       per replica scrape in the fleet controller's watch
                            loop (``fleet/controller.py``): an io_error
                            blackholes /metrics, so the slot acts on its
                            last-good snapshot marked stale until
                            stale_scrapes consecutive failures declare the
                            replica lost
``controller.spawn``        per replica spawn (bootstrap, respawn, scale-up)
                            in the fleet controller: an io_error is a
                            spawn-failure cascade, which backs the slot off
                            and, repeated, parks it behind the flap breaker
==========================  ================================================

Env grammar (``;``-separated specs, ``:``-separated fields), read
lazily on the first ``fire``::

    SPARK_EXAMPLES_TPU_FAULTS="ingest.block_read:io_error:max=2;store.read:delay:delay=0.1"
    SPARK_EXAMPLES_TPU_FAULT_SEED=7

Fields after ``site:kind`` are ``key=value``: ``p`` (probability,
default 1), ``after`` (hits passed through before firing starts,
default 0), ``max`` (fires before the spec exhausts, default 1; 0 =
unlimited), ``delay`` (seconds, ``delay`` kind), ``keep`` (bytes kept,
``truncate`` kind).
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from spark_examples_tpu_torch.core import telemetry

ENV_SPECS = "SPARK_EXAMPLES_TPU_FAULTS"
ENV_SEED = "SPARK_EXAMPLES_TPU_FAULT_SEED"

KINDS = ("io_error", "delay", "truncate", "kill")

SITES = (
    "ingest.block_read",
    "store.read",
    "store.readahead.decode",
    "checkpoint.tile_write",
    "checkpoint.tile_read",
    "multihost.consensus",
    "neighbors.candidates",
    "device.put",
    "prefetch.transfer_wait",
    "serve.request",
    "telemetry.flush",
    "trace.export",
    "supervisor.heartbeat",
    "fleet.stage",
    "controller.scrape",
    "controller.spawn",
)

# Exit code of the "kill" kind, so a test can tell an injected kill from
# an ordinary crash.
KILL_EXIT_CODE = 113


class InjectedFault(IOError):
    """The io_error kind's exception: an IOError, so the retry layer
    treats it exactly like a flaky filesystem read."""


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault: where (site), what (kind), when (after/max/p)."""

    site: str
    kind: str = "io_error"
    probability: float = 1.0
    after: int = 0  # hits passed through before firing begins
    max_fires: int = 1  # 0 = unlimited
    delay_s: float = 0.05  # "delay" kind
    keep_bytes: int = 8  # "truncate" kind: bytes kept

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; instrumented sites: "
                f"{', '.join(SITES)}"
            )
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: "
                f"{', '.join(KINDS)}"
            )

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """``site:kind[:key=value...]`` -> FaultSpec (the env grammar)."""
        parts = [p for p in spec.strip().split(":") if p]
        if len(parts) < 2:
            raise ValueError(
                f"bad fault spec {spec!r}: expected site:kind[:key=value...]"
            )
        kw: dict = {"site": parts[0], "kind": parts[1]}
        keys = {"p": ("probability", float), "after": ("after", int),
                "max": ("max_fires", int), "delay": ("delay_s", float),
                "keep": ("keep_bytes", int)}
        for field in parts[2:]:
            key, _, val = field.partition("=")
            if key not in keys:
                raise ValueError(
                    f"bad fault spec field {field!r} in {spec!r}; valid "
                    f"keys: {', '.join(keys)}"
                )
            name, cast = keys[key]
            kw[name] = cast(val)
        return cls(**kw)


class Injector:
    """Seeded registry of armed specs with per-site hit/fire counters."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self._rng = random.Random(seed)
        self._hits: dict[str, int] = {}
        self._fires: dict = {}
        self._lock = threading.Lock()  # sites fire from worker threads

    def fire(self, site: str, path: str | None = None) -> None:
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            spec = None
            for s in self.specs:
                if s.site != site or hit < s.after:
                    continue
                if s.max_fires and self._fires.get(id(s), 0) >= s.max_fires:
                    continue
                if s.probability < 1.0 and self._rng.random() >= s.probability:
                    continue
                spec = s
                self._fires[id(s)] = self._fires.get(id(s), 0) + 1
                self._fires[site] = self._fires.get(site, 0) + 1
                break
        if spec is None:
            return
        telemetry.count("faults.fired")
        telemetry.event("fault", cat="faults", site=site, kind=spec.kind)
        self._execute(spec, site, path)

    @staticmethod
    def _execute(spec: FaultSpec, site: str, path: str | None) -> None:
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.kind == "io_error":
            raise InjectedFault(
                f"injected transient IO error at {site}"
                + (f" ({path})" if path else "")
            )
        if spec.kind == "truncate":
            if path is None:
                raise ValueError(
                    f"truncate fault armed at {site}, but the site passed "
                    "no file path to corrupt"
                )
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(min(spec.keep_bytes, size))
            return
        # kill: a preemption — no cleanup, no atexit, no flush.
        os._exit(KILL_EXIT_CODE)

    def fire_count(self, site: str) -> int:
        with self._lock:
            return self._fires.get(site, 0)

    def hit_count(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


_active: Injector | None = None
_env_checked = False
# Guards the lazy env arming in fire(): the first fires can race in from
# worker threads, and an unlocked check-then-arm could arm twice.
_arm_lock = threading.Lock()


def arm(specs, seed: int = 0) -> Injector:
    """Install an injector (replacing any armed one) and return it."""
    global _active, _env_checked
    _env_checked = True  # explicit arming overrides the env
    _active = Injector([s if isinstance(s, FaultSpec) else FaultSpec.parse(s)
                        for s in specs], seed=seed)
    return _active


def disarm() -> None:
    global _active
    _active = None


@contextmanager
def armed(specs, seed: int = 0):
    """``with faults.armed([...]) as inj:`` — scoped arming for tests."""
    inj = arm(specs, seed=seed)
    try:
        yield inj
    finally:
        disarm()


def from_env() -> Injector | None:
    """Arm from ``SPARK_EXAMPLES_TPU_FAULTS``; None when it is absent or
    empty."""
    raw = os.environ.get(ENV_SPECS, "").strip()
    if not raw:
        return None
    seed = int(os.environ.get(ENV_SEED, "0"))
    return arm([s for s in raw.split(";") if s.strip()], seed=seed)


def fire(site: str, path: str | None = None) -> None:
    """The hook at each site: a no-op unless armed."""
    global _env_checked
    inj = _active
    if inj is None:
        if _env_checked:
            return
        with _arm_lock:
            inj = _active
            if inj is None:
                if _env_checked:
                    return
                _env_checked = True
                inj = from_env()
                if inj is None:
                    return
    inj.fire(site, path=path)


def fire_count(site: str) -> int:
    """Fires recorded at ``site`` by the armed injector (0 if disarmed)."""
    return _active.fire_count(site) if _active is not None else 0
