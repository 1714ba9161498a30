"""Replica handles: one serve replica as the controller sees it.

The controller never touches a :class:`FleetRouter` directly — it
holds :class:`Replica` handles and consumes transport-decoupled
:class:`ReplicaSnapshot` state. Two implementations share the
contract:

- :class:`LocalReplica` wraps an in-process
  :class:`~spark_examples_tpu_torch.serve.router.FleetRouter` (tests):
  snapshots come straight from ``router.stats_payload()``, so many
  replicas coexist without fighting over the process-global telemetry
  registry, and a "crash" is an abrupt close the controller must
  detect and heal from.
- :class:`ProcessReplica` owns a real serve child: heartbeat file
  (core/supervisor.py's :data:`ENV_HEARTBEAT` plumbing), an
  ephemeral-port announce file, ``GET /readyz`` for warmup gating,
  and snapshots parsed from the child's actual Prometheus
  ``GET /metrics`` text — the same bytes an external scraper reads.
  SIGTERM starts the child's drain; KILL follows after the drain
  budget (the supervisor's TERM->KILL idiom). The fleet's child is
  :func:`serve_child_command` (``ProcessReplica.serving``): this
  package's ``serve --fleet`` with the controller's ``--device``
  always passed, so a controller for ``cuda`` never gets a CPU
  replica; a device that is not there fails the spawn.

:func:`parse_prometheus` inverts ``core/live.py``'s name mangling
(``fleet.route.<name>.p99_s`` -> ``fleet_route_<name>_p99_s``) far
enough for the controller's needs: a flat ``{metric: value}`` dict the
snapshot functions read well-known keys from.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field, replace

from spark_examples_tpu_torch.core.config import PRIORITY_CLASSES


def serve_child_command(manifest: str, device: str,
                        extra_args=()) -> list[str]:
    """The fleet's replica command, spelled in this one place: this
    package's ``serve --fleet <manifest> --port 0 --device <device>``
    (plus ``extra_args``, e.g. ``--telemetry-dir``). ``ProcessReplica``
    appends ``--port-file``."""
    return [sys.executable, "-m", "spark_examples_tpu_torch", "serve",
            "--fleet", manifest, "--port", "0", "--device", device,
            *extra_args]


class ScrapeError(RuntimeError):
    """A replica's metrics could not be read this round (HTTP failure,
    torn payload, injected controller.scrape fault). The controller
    keeps the last-good snapshot marked stale — PR-8's proxy rule:
    never error during the exact window an operator most wants data."""


@dataclass(frozen=True)
class ReplicaSnapshot:
    """One scrape's worth of a replica's autoscale/health signals."""

    t: float
    ready: bool
    health: str
    worker_alive: bool
    in_flight: int
    queue_interactive: int
    queue_batch: int
    p99_s: float  # worst per-route served p99
    shed_rate: float  # worst per-route shed/offered
    pool_bytes: float
    pool_pressure: float
    routes: dict[str, dict] = field(default_factory=dict)
    stale: bool = False  # last-good served after a failed scrape

    @property
    def idle(self) -> bool:
        return (self.in_flight == 0 and self.queue_interactive == 0
                and self.queue_batch == 0)

    def as_stale(self) -> "ReplicaSnapshot":
        return replace(self, stale=True)


def snapshot_from_stats(payload: dict, t: float,
                        ready: bool) -> ReplicaSnapshot:
    """Build a snapshot from ``FleetRouter.stats_payload()`` — the
    in-process transport (router-local truth; no /metrics round trip,
    and no clash on the process-global gauge registry)."""
    health = payload.get("health", {})
    queues = payload.get("queues", {})
    pool = payload.get("pool", {})
    routes: dict[str, dict] = {}
    worst_p99 = 0.0
    worst_shed = 0.0
    for name, r in payload.get("routes", {}).items():
        p99 = max(r["latency_ms"][cls]["p99"]
                  for cls in PRIORITY_CLASSES) / 1e3
        offered = r.get("admitted", 0) + r.get("shed", 0)
        shed_rate = r.get("shed", 0) / offered if offered else 0.0
        routes[name] = {
            "staged": bool(r.get("staged")),
            "queue_depth": int(r.get("queue_depth", 0)),
            "p99_s": p99,
            "shed_rate": shed_rate,
        }
        worst_p99 = max(worst_p99, p99)
        worst_shed = max(worst_shed, shed_rate)
    interactive, batch = PRIORITY_CLASSES
    return ReplicaSnapshot(
        t=t,
        ready=ready,
        health=health.get("status", "unknown"),
        worker_alive=bool(health.get("worker_alive")),
        in_flight=int(health.get("in_flight", 0)),
        queue_interactive=int(queues.get(interactive, 0)),
        queue_batch=int(queues.get(batch, 0)),
        p99_s=worst_p99,
        shed_rate=worst_shed,
        pool_bytes=float(pool.get("resident_bytes", 0)),
        pool_pressure=float(pool.get("pressure", 0.0)),
        routes=routes,
    )


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def parse_prometheus(text: str) -> dict[str, float]:
    """Prometheus text -> flat ``{series_name: value}``. Labelled
    series keep their label string in the key (the controller reads
    only unlabelled gauges/counters); unparsable lines are skipped —
    a scrape is judged by the keys it yields, not line perfection."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(None, 1)
        if len(parts) != 2:
            continue
        try:
            out[parts[0]] = float(parts[1])
        except ValueError:
            continue
    return out


def snapshot_from_prometheus(flat: dict[str, float],
                             route_names: list[str], t: float,
                             ready: bool,
                             health: str = "unknown") -> ReplicaSnapshot:
    """Build a snapshot from a parsed ``GET /metrics`` scrape — the
    subprocess transport. ``route_names`` drives the per-route series
    lookup (the mangled names are not invertible without it)."""
    interactive, batch = PRIORITY_CLASSES
    routes: dict[str, dict] = {}
    worst_p99 = 0.0
    worst_shed = 0.0
    for name in route_names:
        prefix = _prom_name(f"fleet.route.{name}.")
        p99 = float(flat.get(prefix + "p99_s", 0.0))
        shed_rate = float(flat.get(prefix + "shed_rate", 0.0))
        routes[name] = {
            "staged": flat.get(prefix + "staged", 0.0) >= 1.0,
            "queue_depth": int(flat.get(prefix + "queue_depth", 0.0)),
            "p99_s": p99,
            "shed_rate": shed_rate,
        }
        worst_p99 = max(worst_p99, p99)
        worst_shed = max(worst_shed, shed_rate)
    return ReplicaSnapshot(
        t=t,
        ready=ready,
        health=health,
        # A worker death shows up as serve.worker_restarts churn and
        # /readyz going false; the scrape itself proves the process.
        worker_alive=ready or health == "healthy",
        in_flight=int(flat.get("serve_in_flight", 0.0)),
        queue_interactive=int(flat.get(
            _prom_name(f"serve.priority.depth_{interactive}"), 0.0)),
        queue_batch=int(flat.get(
            _prom_name(f"serve.priority.depth_{batch}"), 0.0)),
        p99_s=worst_p99,
        shed_rate=worst_shed,
        pool_bytes=float(flat.get("fleet_pool_bytes", 0.0)),
        pool_pressure=float(flat.get("fleet_pool_pressure", 0.0)),
        routes=routes,
    )


# ---------------------------------------------------------------------------
# The handle contract.


class Replica:
    """What the controller needs from one replica, transport-blind."""

    name: str
    budget_bytes: int
    generation: int
    warm_routes: tuple[str, ...] = ()

    def start(self) -> "Replica":
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def heartbeat_age_s(self) -> float | None:
        """Seconds since the replica's last heartbeat write, or None
        when this transport has no heartbeat plumbing (in-process
        replicas are hang-checked through their snapshots instead)."""
        return None

    def ready(self) -> bool:
        raise NotImplementedError

    def scrape(self) -> ReplicaSnapshot:
        """Fresh signals or :class:`ScrapeError` — never a half-read."""
        raise NotImplementedError

    def warm(self, routes: tuple[str, ...]) -> None:
        """Stage ``routes``' panels now (from the shared store), and
        remember them as this replica's warm-assigned set."""
        raise NotImplementedError

    def drain(self, timeout_s: float) -> bool:
        """Graceful stop: close admission, answer everything admitted,
        then stop. True = clean within the budget."""
        raise NotImplementedError

    def kill(self) -> None:
        """Abrupt stop — preemption/crash semantics, no drain."""
        raise NotImplementedError


class LocalReplica(Replica):
    """An in-process replica over a real :class:`FleetRouter`.

    ``make_router()`` builds AND starts the router (the factory owns
    route construction so soak/bench fixtures decide panels/budgets).
    ``kill()`` is deliberately ungraceful: the worker is stopped and
    every admitted future fails with ServerClosed — exactly what a
    lost process does to its clients, which is the event the
    controller (and the hedged loadgen's failover) must absorb.
    """

    def __init__(self, name: str, make_router, budget_bytes: int,
                 generation: int = 0):
        self.name = name
        self.budget_bytes = int(budget_bytes)
        self.generation = int(generation)
        self.warm_routes = ()
        self._make_router = make_router
        self.router = None
        self._killed = False

    def start(self) -> "LocalReplica":
        self.router = self._make_router()
        self._killed = False
        return self

    def alive(self) -> bool:
        r = self.router
        return (r is not None and not self._killed
                and not r._closed)

    def ready(self) -> bool:
        r = self.router
        if r is None or self._killed:
            return False
        return bool(r.ready_info()["ready"])

    def scrape(self) -> ReplicaSnapshot:
        r = self.router
        if r is None or self._killed:
            raise ScrapeError(f"replica {self.name}: no live router")
        try:
            payload = r.stats_payload()
        except Exception as e:
            raise ScrapeError(
                f"replica {self.name}: stats read failed: {e!r}"
            ) from e
        return snapshot_from_stats(payload, t=time.monotonic(),
                                   ready=self.ready())

    def warm(self, routes: tuple[str, ...]) -> None:
        self.warm_routes = tuple(routes)
        for name in routes:
            self.router.warm_route(name)

    def drain(self, timeout_s: float) -> bool:
        r = self.router
        if r is None:
            return True
        clean = r.drain(timeout=timeout_s)
        r.close()
        return clean

    def kill(self) -> None:
        r = self.router
        self._killed = True
        if r is None:
            return
        # No drain: close admission and stop the worker immediately;
        # admitted futures fail with ServerClosed like clients of a
        # dead process (drain with a zero budget fails stragglers
        # loudly instead of waiting for them).
        r.drain(timeout=0.0)


class ProcessReplica(Replica):
    """A serve child process: heartbeats, port file, HTTP scrape.

    ``argv`` is the full child command (the fleet's is
    :func:`serve_child_command`, see :meth:`serving`); the constructor
    adds ``--port-file`` plumbing via the serve CLI flag and arms the
    heartbeat through the environment, so any serve invocation works
    unmodified as a fleet replica. ``device``: the device the child was
    told to use; :meth:`start` resolves it first (no CUDA context is
    created), so a ``cuda`` replica on a host without a card fails its
    spawn instead of starting.
    """

    def __init__(self, name: str, argv: list[str], workdir: str,
                 budget_bytes: int, route_names: list[str],
                 env: dict | None = None, generation: int = 0,
                 scrape_timeout_s: float = 2.0, device: str | None = None):
        from spark_examples_tpu_torch.core import supervisor, telemetry

        self.name = name
        self.budget_bytes = int(budget_bytes)
        self.generation = int(generation)
        self.warm_routes = ()
        self.route_names = list(route_names)
        self.workdir = workdir
        self.heartbeat_path = os.path.join(workdir, f"{name}.hb")
        self.port_file = os.path.join(workdir, f"{name}.port")
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.argv = list(argv) + ["--port-file", self.port_file]
        self.env = dict(os.environ if env is None else env)
        self.env[supervisor.ENV_HEARTBEAT] = self.heartbeat_path
        # Trace continuity across the process boundary: the child
        # stamps the SAME run_id into its exported trace events (so
        # `telemetry stitch --fleet` joins them onto one timeline) and
        # makes the SAME deterministic keep/drop sampling decision for
        # any trace_id the parent forwarded.
        self.env.setdefault(telemetry.ENV_RUN_ID, telemetry.run_id())
        self.env.setdefault(telemetry.ENV_TRACE_SAMPLE,
                            repr(telemetry.trace_sample()))
        self.device = device
        self.proc: subprocess.Popen | None = None
        self._port: int | None = None

    @classmethod
    def serving(cls, name: str, manifest: str, device: str, workdir: str,
                budget_bytes: int, route_names: list[str],
                extra_args=(), env: dict | None = None, generation: int = 0,
                scrape_timeout_s: float = 2.0) -> "ProcessReplica":
        """A replica running :func:`serve_child_command` on ``device``.
        The child exports its telemetry (with ``--telemetry-dir`` in
        ``extra_args``) under ``attempt<generation>/``, so a respawned
        generation does not overwrite its killed predecessor's ring."""
        from spark_examples_tpu_torch.core import telemetry

        env = dict(os.environ if env is None else env)
        env[telemetry.ENV_ATTEMPT] = str(int(generation))
        return cls(name, serve_child_command(manifest, device, extra_args),
                   workdir, budget_bytes, route_names, env=env,
                   generation=generation, scrape_timeout_s=scrape_timeout_s,
                   device=device)

    def start(self) -> "ProcessReplica":
        if self.device is not None:
            from spark_examples_tpu_torch.core.device import resolve_device

            resolve_device(self.device)
        for stale in (self.heartbeat_path, self.port_file):
            try:
                os.remove(stale)
            except OSError:
                pass
        self._port = None
        self.proc = subprocess.Popen(
            self.argv, env=self.env, cwd=self.workdir,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return self

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def heartbeat_age_s(self) -> float | None:
        try:
            return max(0.0,
                       time.time() - os.stat(self.heartbeat_path).st_mtime)
        except OSError:
            return None  # not written yet: startup, not a hang

    def port(self) -> int | None:
        """The child's bound HTTP port, from its atomic port file."""
        if self._port is not None:
            return self._port
        try:
            with open(self.port_file) as f:
                self._port = int(json.load(f)["port"])
        except (OSError, ValueError, KeyError):
            return None
        return self._port

    def _get(self, path: str) -> tuple[int, bytes]:
        port = self.port()
        if port is None:
            raise ScrapeError(
                f"replica {self.name}: no port announced yet")
        url = f"http://127.0.0.1:{port}{path}"
        try:
            with urllib.request.urlopen(
                    url, timeout=self.scrape_timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (OSError, urllib.error.URLError) as e:
            raise ScrapeError(
                f"replica {self.name}: GET {path} failed: {e!r}") from e

    def ready(self) -> bool:
        try:
            status, _body = self._get("/readyz")
        except ScrapeError:
            return False
        return status == 200

    def scrape(self) -> ReplicaSnapshot:
        status, body = self._get("/metrics")
        if status != 200:
            raise ScrapeError(
                f"replica {self.name}: /metrics answered {status}")
        flat = parse_prometheus(body.decode("utf-8", "replace"))
        if not flat:
            raise ScrapeError(
                f"replica {self.name}: empty/unparsable /metrics body")
        ready = self.ready()
        return snapshot_from_prometheus(
            flat, self.route_names, t=time.monotonic(), ready=ready,
            health="healthy" if ready else "unknown")

    def warm(self, routes: tuple[str, ...]) -> None:
        self.warm_routes = tuple(routes)
        if self.port() is None:
            # The child has not announced its port yet (a spawn warms
            # immediately after Popen). The serve process stages
            # panels lazily on first demand, so pre-warming is a
            # latency optimization, not a correctness requirement:
            # record the intent and let the child come up.
            return
        for name in routes:
            status, body = self._get(f"/warm/{name}")
            if status != 200:
                raise ScrapeError(
                    f"replica {self.name}: warm {name!r} answered "
                    f"{status}: {body[:200]!r}")

    def drain(self, timeout_s: float) -> bool:
        """SIGTERM (the serve CLI's drain handler), KILL past the
        budget — core/supervisor.py's ``_kill_child`` escalation with
        the drain budget as the grace."""
        proc = self.proc
        if proc is None or proc.poll() is not None:
            return True
        try:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=timeout_s)
            return proc.returncode == 0
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30.0)
            return False
        except OSError:
            return True  # already gone

    def kill(self) -> None:
        proc = self.proc
        if proc is None:
            return
        try:
            proc.kill()
            proc.wait(timeout=30.0)
        except OSError:
            pass
