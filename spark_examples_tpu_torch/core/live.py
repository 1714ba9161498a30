"""Live introspection: HTTP views over the telemetry registry.

``core/telemetry.py`` collects and flushes; this module is what an
operator or an autoscaler scrapes while the job runs:

- :func:`prometheus_text`: the registry as Prometheus exposition text
  (counters as ``<name>_total``, gauges with ``_min``/``_max``,
  histograms as summaries with p50/p95/p99 plus ``_sum``/``_count``),
  the one renderer the serve front's ``/metrics`` and the batch sidecar
  share. Byte for byte the JAX package's for the same snapshot.
- :class:`LiveTelemetryServer`: the ``--live-port`` stdlib HTTP sidecar
  of a batch job: ``/metrics``, ``/debug/telemetry`` (the full
  :func:`telemetry.live_snapshot` JSON) and ``/healthz``, served from a
  daemon thread. Port 0 binds an ephemeral port, written to the
  :data:`ENV_PORT_FILE` / :data:`ENV_ANNOUNCE` paths when they are set.
- :class:`SupervisorLiveProxy`: a supervised job's public endpoint,
  owned by the ``--supervise`` parent. It forwards each scrape to the
  current child's ephemeral sidecar, answers from the last good body
  (marked stale) while the child is down, and appends the parent's
  ``supervisor_*`` series.

Environment arming (any process can set these)::

    SPARK_EXAMPLES_TPU_LIVE_PORT=0          # start the sidecar, ephemeral
    SPARK_EXAMPLES_TPU_LIVE_PORT_FILE=/p    # write the bound port here
    SPARK_EXAMPLES_TPU_LIVE_ANNOUNCE=/a     # write "host:port" here
"""

from __future__ import annotations

import json
import os
import re
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from spark_examples_tpu_torch.core import telemetry

ENV_PORT = "SPARK_EXAMPLES_TPU_LIVE_PORT"
ENV_PORT_FILE = "SPARK_EXAMPLES_TPU_LIVE_PORT_FILE"
ENV_ANNOUNCE = "SPARK_EXAMPLES_TPU_LIVE_ANNOUNCE"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

# Prometheus quantile labels of each histogram's summary.
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _prom_name(name: str) -> str:
    """``serve.latency_s`` -> ``serve_latency_s``."""
    return _NAME_RE.sub("_", name)


def _esc(value) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(snap: dict | None = None) -> str:
    """Render a metrics snapshot (default: a fresh one) as Prometheus
    exposition text, each section sorted so two scrapes diff cleanly."""
    if snap is None:
        snap = telemetry.metrics_snapshot()
    meta = snap.get("meta") or telemetry._meta(0)
    out: list[str] = []
    out.append("# HELP telemetry_info job identity (labels carry the "
               "stitch keys)")
    out.append("# TYPE telemetry_info gauge")
    out.append(
        'telemetry_info{run_id="%s",attempt="%s",rank="%s"} 1'
        % (_esc(meta["run_id"]), meta["attempt"], meta["rank"]))
    out.append("# TYPE telemetry_uptime_seconds gauge")
    out.append(f"telemetry_uptime_seconds {meta.get('uptime_s', 0.0):.3f}")
    for name, v in sorted(snap.get("counters", {}).items()):
        n = _prom_name(name) + "_total"
        out.append(f"# TYPE {n} counter")
        out.append(f"{n} {v}")
    phases = sorted(snap.get("phases", {}).items())
    if phases:
        out.append("# TYPE phase_seconds_total counter")
    for phase, v in phases:
        out.append('phase_seconds_total{phase="%s"} %s' % (_esc(phase), v))
    for name, g in sorted(snap.get("gauges", {}).items()):
        n = _prom_name(name)
        out.append(f"# TYPE {n} gauge")
        out.append(f"{n} {g.get('last', 0.0)}")
        out.append(f"{n}_min {g.get('min', 0.0)}")
        out.append(f"{n}_max {g.get('max', 0.0)}")
    for name, h in sorted(snap.get("histograms", {}).items()):
        n = _prom_name(name)
        out.append(f"# TYPE {n} summary")
        for label, key in _QUANTILES:
            out.append('%s{quantile="%s"} %s' % (n, label, h.get(key, 0.0)))
        out.append(f"{n}_sum {h.get('sum', 0.0)}")
        out.append(f"{n}_count {h.get('count', 0)}")
    return "\n".join(out) + "\n"


def _reply(handler: BaseHTTPRequestHandler, code: int, body: bytes,
           content_type: str) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def reply_metrics(handler: BaseHTTPRequestHandler) -> None:
    """Serve ``/metrics`` from the live registry."""
    telemetry.count("live.requests")
    snap = telemetry.metrics_snapshot()
    snap["meta"] = telemetry._meta(0)
    _reply(handler, 200, prometheus_text(snap).encode(),
           "text/plain; version=0.0.4; charset=utf-8")


def reply_debug_telemetry(handler: BaseHTTPRequestHandler) -> None:
    """Serve ``/debug/telemetry``: the full live snapshot as JSON."""
    telemetry.count("live.requests")
    body = json.dumps(telemetry.live_snapshot(), default=str,
                      sort_keys=True).encode()
    _reply(handler, 200, body, "application/json")


class _SidecarHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # telemetry is the access log
        pass

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path == "/metrics":
            reply_metrics(self)
        elif self.path == "/debug/telemetry":
            reply_debug_telemetry(self)
        elif self.path == "/healthz":
            telemetry.count("live.requests")
            body = json.dumps({"ok": True, **telemetry.identity(),
                               "pid": os.getpid()}).encode()
            _reply(self, 200, body, "application/json")
        else:
            _reply(self, 404,
                   json.dumps({"error": f"unknown path {self.path!r}"})
                   .encode(), "application/json")


class LiveTelemetryServer:
    """The ``--live-port`` sidecar: bind, serve in a daemon thread,
    publish the bound port, shut down."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 port_file: str | None = None,
                 announce_path: str | None = None):
        self._httpd = ThreadingHTTPServer((host, port), _SidecarHandler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        for path, text in ((port_file, str(self.port)),
                           (announce_path, f"{self.host}:{self.port}")):
            if path:
                telemetry._atomic_write(path, text)

    def serve_in_thread(self) -> "LiveTelemetryServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="live-telemetry-http",
            daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def maybe_start_live(port: int | None = None, host: str = "127.0.0.1",
                     environ=None) -> LiveTelemetryServer | None:
    """Start the sidecar when asked: an explicit ``port`` (the
    ``--live-port`` flag) or :data:`ENV_PORT` in the environment.
    Returns the running server, or None."""
    env = os.environ if environ is None else environ
    if port is None:
        raw = env.get(ENV_PORT, "").strip()
        if not raw:
            return None
        port = int(raw)
    server = LiveTelemetryServer(
        host=host, port=port,
        port_file=env.get(ENV_PORT_FILE, "").strip() or None,
        announce_path=env.get(ENV_ANNOUNCE, "").strip() or None,
    )
    return server.serve_in_thread()


# ---------------------------------------------------------------------------
# Supervisor-side proxy.


class SupervisorLiveProxy:
    """The supervised job's public live endpoint, owned by the parent.

    Scrapes are forwarded to the current child's sidecar (its ephemeral
    port read from ``child_port_file`` on every request — a restarted
    child lands on a new port and the very next scrape follows it). A
    child that is down mid-restart answers with the last-good cached
    body, marked stale, so "is the endpoint up" and "is the child up"
    stay separate questions. Every ``/metrics`` answer appends the
    parent's own ``supervisor_*`` series — the restart visibility no
    child can report about itself.
    """

    def __init__(self, host: str, port: int, child_port_file: str,
                 state_fn, announce_path: str | None = None):
        self.child_port_file = child_port_file
        self.state_fn = state_fn  # () -> dict (attempt/restarts/...)
        self._cache: dict[str, bytes] = {}
        self._cache_type: dict[str, str] = {}
        self._cache_lock = threading.Lock()
        proxy = self

        class _ProxyHandler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802 (stdlib API)
                proxy._handle(self)

        self._httpd = ThreadingHTTPServer((host, port), _ProxyHandler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        if announce_path:
            telemetry._atomic_write(announce_path,
                                    f"{self.host}:{self.port}")

    # -- child fetch --------------------------------------------------------

    def _child_port(self) -> int | None:
        try:
            with open(self.child_port_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _fetch_child(self, path: str) -> tuple[bytes, str] | None:
        port = self._child_port()
        if port is None:
            return None
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=2.0) as r:
                body = r.read()
                ctype = r.headers.get("Content-Type", "application/json")
        except Exception:
            return None
        with self._cache_lock:
            self._cache[path] = body
            self._cache_type[path] = ctype
        return body, ctype

    def _cached(self, path: str) -> tuple[bytes, str] | None:
        with self._cache_lock:
            if path in self._cache:
                return self._cache[path], self._cache_type[path]
        return None

    # -- request handling ---------------------------------------------------

    def _supervisor_lines(self, state: dict, child_up: bool,
                          stale: bool) -> str:
        return "\n".join([
            "# TYPE supervisor_restarts counter",
            f"supervisor_restarts {state.get('restarts', 0)}",
            f"supervisor_watchdog_kills {state.get('watchdog_kills', 0)}",
            f"supervisor_attempt {state.get('attempt', 0)}",
            f"supervisor_child_up {int(child_up)}",
            f"supervisor_scrape_stale {int(stale)}",
            'supervisor_info{run_id="%s"} 1' % _esc(state.get("run_id", "")),
        ]) + "\n"

    def _handle(self, handler: BaseHTTPRequestHandler) -> None:
        telemetry.count("live.proxy_requests")
        path = handler.path
        state = self.state_fn()
        if path == "/healthz":
            # The parent answers liveness itself: the proxy being up IS
            # the supervised job being alive (restarting included).
            child_up = self._fetch_child("/healthz") is not None
            _reply(handler, 200,
                   json.dumps({"ok": True, "child_up": child_up,
                               **state}).encode(),
                   "application/json")
            return
        if path not in ("/metrics", "/debug/telemetry"):
            _reply(handler, 404,
                   json.dumps({"error": f"unknown path {path!r}"}).encode(),
                   "application/json")
            return
        got = self._fetch_child(path)
        stale = got is None
        if stale:
            telemetry.count("live.proxy_stale")
            got = self._cached(path)
        if path == "/metrics":
            body = got[0].decode(errors="replace") if got else ""
            body += self._supervisor_lines(state, child_up=not stale,
                                           stale=stale)
            _reply(handler, 200, body.encode(),
                   "text/plain; version=0.0.4; charset=utf-8")
            return
        child_payload = None
        if got is not None:
            try:
                child_payload = json.loads(got[0])
            except ValueError:
                child_payload = None
        _reply(handler, 200, json.dumps({
            "supervisor": state,
            "stale": stale,
            "child": child_payload,
        }, default=str).encode(), "application/json")

    # -- lifecycle ----------------------------------------------------------

    def serve_in_thread(self) -> "SupervisorLiveProxy":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="supervisor-live-proxy",
            daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
