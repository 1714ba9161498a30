"""Thin stdlib HTTP front for the projection server.

One process, no dependencies: ``ThreadingHTTPServer`` handlers block on
the projection Future while the batching worker coalesces concurrent
requests — HTTP concurrency IS the micro-batch source. Endpoints:

- ``POST /project`` — body ``{"genotypes": [<V int8 dosages>],
  "deadline_ms": <optional>}``; answers ``{"coords": [[...]]}``.
  Errors map onto status codes the envelope semantics imply: 429
  overloaded (shed), 503 draining, 504 deadline, 400 malformed.
- ``GET /healthz`` — liveness + in-flight/backlog counts.
- ``GET /readyz`` — readiness: 200 once the batching worker is alive
  and the server is not draining, 503 with the evidence otherwise.
- ``GET /stats`` — the coherent operator payload
  (:meth:`ProjectionServer.stats_payload`): request accounting,
  latency digest, the full health-machine view (status, breaker
  snapshot, worker restarts), and the staged panel's store-cache
  accounting.
- ``GET /metrics`` — the live telemetry registry as Prometheus
  exposition text (core/live.py — the same renderer the ``--live-port``
  batch sidecar uses, so serving and batch jobs scrape identically).
- ``GET /debug/telemetry`` — the full ``telemetry.live_snapshot()``
  JSON: every counter/gauge/histogram plus a rolling ring of recent
  trace events and the run_id/attempt/rank identity.
- ``GET /debug/requests`` — the slowest-K request exemplars by trace id.

Every answer carries ``X-Run-Id``; ``POST /project`` also echoes the
client's ``X-Trace-Id`` (or a minted one) and a ``Server-Timing``
header.

The fleet front (``serve --fleet``, :func:`fleet_http_server`) adds
route addressing: ``POST /project`` with a ``route`` (and optional
``priority``) in the body or ``POST /project/<route>``;
``POST /neighbors[/<route>]`` (exact query-vs-panel top-k on routes
with the manifest's ``topk`` capability); ``GET /routes``;
``GET /warm/<route>``; and a readiness that also waits on every warmed
route being staged.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from spark_examples_tpu_torch.core import live as live_view
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.serve.server import (
    DeadlineExceeded,
    ProjectionServer,
    ServerClosed,
    ServerOverloaded,
)

_TRACE_ID_MAX = 64


def _request_trace_id(handler) -> str:
    """Accept the client's X-Trace-Id (sanitized: url-safe token chars,
    bounded length) or mint a fresh one — either way the id is echoed
    back, so client and server logs join on it without guessing."""
    raw = (handler.headers.get("X-Trace-Id") or "").strip()
    if (raw and len(raw) <= _TRACE_ID_MAX
            and all(c.isalnum() or c in "-_." for c in raw)):
        return raw
    return telemetry.new_trace_id()


def _server_timing(phases: dict) -> str:
    """The per-request phase breakdown as a Server-Timing header value
    (milliseconds, RFC 8941 shape: ``queue;dur=1.2, compute;dur=3.4``)."""
    return ", ".join(f"{k};dur={v * 1e3:.3f}"
                     for k, v in phases.items()
                     if isinstance(v, (int, float)))


def _reply_debug_requests(handler) -> None:
    """GET /debug/requests: the slowest-K request exemplar ring keyed
    by trace_id, plus the active sample rate."""
    body = json.dumps({
        "exemplars": telemetry.request_exemplars(),
        "trace_sample": telemetry.trace_sample(),
    }, default=str).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.send_header("X-Run-Id", telemetry.run_id())
    handler.end_headers()
    handler.wfile.write(body)


def _parse_project_body(handler) -> tuple[np.ndarray, float | None, dict]:
    """Shared POST /project body decoding: (genotypes, deadline_s, raw
    request dict). Raises the body's problem for the caller's 400."""
    length = int(handler.headers.get("Content-Length", "0"))
    req = json.loads(handler.rfile.read(length) or b"{}")
    raw = np.asarray(req["genotypes"])
    if raw.dtype.kind not in "iu":
        raise ValueError(
            f"genotypes must be integer dosages (got {raw.dtype} values)")
    # dtype= on the original list (not .astype, which wraps silently):
    # an out-of-int8-range dosage raises here and becomes a 400, never
    # a dropped socket.
    genotypes = np.asarray(req["genotypes"], dtype=np.int8)
    deadline_ms = req.get("deadline_ms")
    # Converted HERE so a non-numeric deadline is a 400 (client error),
    # not a 500 from deep in the submit.
    deadline_s = float(deadline_ms) / 1e3 if deadline_ms else None
    return genotypes, deadline_s, req


def _make_handler(pserver: ProjectionServer):
    class Handler(BaseHTTPRequestHandler):
        # Silence the default per-request stderr lines (telemetry is the
        # observability surface, not the access log).
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            # Every answer names the serving run: client-side error
            # records join server-side traces on this id.
            self.send_header("X-Run-Id", telemetry.run_id())
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                # The health state machine (serve/health.py): healthy |
                # degraded (worker recovered recently, or the store
                # breaker is open and the panel is cached-only) |
                # draining — plus the evidence behind the verdict.
                self._reply(200, {
                    **pserver.health_info(),
                    "n_variants": pserver.engine.n_variants,
                    "n_components": pserver.engine.n_components,
                    "max_batch": pserver.max_batch,
                })
                return
            if self.path == "/readyz":
                info = pserver.ready_info()
                self._reply(200 if info["ready"] else 503, info)
                return
            if self.path == "/stats":
                self._reply(200, pserver.stats_payload())
                return
            if self.path == "/metrics":
                live_view.reply_metrics(self)
                return
            if self.path == "/debug/telemetry":
                live_view.reply_debug_telemetry(self)
                return
            if self.path == "/debug/requests":
                _reply_debug_requests(self)
                return
            self._reply(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802 (stdlib API)
            if self.path != "/project":
                self._reply(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                genotypes, deadline_s, _req = _parse_project_body(self)
            except (ValueError, KeyError, TypeError, OverflowError) as e:
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            tid = _request_trace_id(self)
            sampled = telemetry.should_sample(tid)
            t0 = time.perf_counter()
            code, payload = 200, None
            try:
                with telemetry.trace_scope(trace_id=tid):
                    coords = pserver.project(genotypes,
                                             deadline_s=deadline_s)
            except ServerOverloaded as e:
                code, payload = 429, {"error": str(e)}
            except DeadlineExceeded as e:
                code, payload = 504, {"error": str(e)}
            except ServerClosed as e:
                code, payload = 503, {"error": str(e)}
            except ValueError as e:
                code, payload = 400, {"error": str(e)}
            except Exception as e:  # answered, never a dropped socket
                code, payload = 500, {"error": repr(e)}
            else:
                payload = {"coords": coords.tolist()}
            total = time.perf_counter() - t0
            phases = {"total": total}
            if sampled:
                telemetry.count("trace.sampled")
                telemetry.span_at("trace.request", t0, total,
                                  trace_id=tid, route="", cls="",
                                  status=code)
                telemetry.record_request_exemplar(
                    tid, total, phases, route="", cls="", status=code)
            self._reply(code, payload, headers={
                "X-Trace-Id": tid,
                "Server-Timing": _server_timing(phases),
            })

    return Handler


def _make_fleet_handler(fleet):
    """The fleet front (serve --fleet): same endpoints as the
    single-model handler plus route addressing — ``POST /project``
    takes ``route`` (and optional ``priority``) in the body, or the
    route rides the path as ``POST /project/<route>``; ``POST
    /neighbors`` (or ``/neighbors/<route>``, body ``k`` optional,
    default 10) answers exact query-vs-panel top-k on routes declaring
    the manifest ``topk`` capability; ``GET /routes`` lists the
    registry with per-route stats; ``GET /warm/<route>`` stages a
    route's panel now (the controller's placement push)."""
    from spark_examples_tpu_torch.serve.pool import PanelUnavailable
    from spark_examples_tpu_torch.serve.router import UnknownRoute

    class FleetHandler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Run-Id", telemetry.run_id())
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._reply(200, fleet.health_info())
                return
            if self.path == "/readyz":
                info = fleet.ready_info()
                self._reply(200 if info["ready"] else 503, info)
                return
            if self.path.startswith("/warm/"):
                # The controller's placement push: stage this route's
                # panel now so /readyz flips ready before traffic.
                name = self.path[len("/warm/"):]
                try:
                    fleet.warm_route(name)
                except UnknownRoute as e:
                    self._reply(404, {"error": str(e)})
                except PanelUnavailable as e:
                    self._reply(503, {"error": str(e)})
                except Exception as e:
                    self._reply(500, {"error": repr(e)})
                else:
                    self._reply(200, {"warmed": name})
                return
            if self.path == "/stats":
                self._reply(200, fleet.stats_payload())
                return
            if self.path == "/routes":
                self._reply(200, fleet.stats_payload()["routes"])
                return
            if self.path == "/metrics":
                # Autoscale gauges recomputed at scrape time: the
                # per-route series an autoscaler reads must be current,
                # not last-batch-stale.
                fleet.publish_autoscale()
                live_view.reply_metrics(self)
                return
            if self.path == "/debug/telemetry":
                live_view.reply_debug_telemetry(self)
                return
            if self.path == "/debug/requests":
                _reply_debug_requests(self)
                return
            self._reply(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802 (stdlib API)
            # Two verbs, one envelope: /project answers coordinates,
            # /neighbors answers exact query-vs-panel top-k (routes
            # declaring the manifest "topk" capability). Both take the
            # route in the body or on the path.
            verb = None
            for v in ("project", "neighbors"):
                if self.path == f"/{v}" or self.path.startswith(f"/{v}/"):
                    verb = v
                    break
            if verb is None:
                self._reply(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                genotypes, deadline_s, req = _parse_project_body(self)
                route = (self.path[len(f"/{verb}/"):]
                         if self.path.startswith(f"/{verb}/")
                         else req.get("route"))
                if not route:
                    raise ValueError(
                        "fleet request names no route (body 'route' "
                        f"field or POST /{verb}/<route>)")
                kwargs = {}
                if req.get("priority") is not None:
                    kwargs["priority"] = str(req["priority"])
                k = 0
                if verb == "neighbors":
                    k = int(req.get("k", 10))
            except (ValueError, KeyError, TypeError, OverflowError) as e:
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            tid = _request_trace_id(self)
            sampled = telemetry.should_sample(tid)
            # The router writes the per-phase breakdown (queue wait,
            # cold-start stage share, compute share, cache hits) back
            # into this dict before resolving the request's future —
            # the Server-Timing header and the exemplar ring read it.
            trace = {"trace_id": tid, "span_id": telemetry.new_span_id(),
                     "sampled": sampled, "phases": {}}
            t0 = time.perf_counter()
            code = 200
            try:
                with telemetry.trace_scope(trace_id=tid,
                                           span_id=trace["span_id"]):
                    if verb == "neighbors":
                        ids, sims = fleet.topk(route, genotypes, k,
                                               deadline_s=deadline_s,
                                               trace=trace, **kwargs)
                        # Panel indices -> the model's sample ids: the
                        # client-facing identity, beside the raw
                        # indices for positional consumers.
                        panel_ids = fleet.routes[route].ctx.model \
                            .sample_ids
                        payload = {
                            "neighbor_ids": [
                                [panel_ids[j] for j in row]
                                for row in ids.tolist()
                            ],
                            "neighbor_indices": ids.tolist(),
                            "similarities": sims.tolist(),
                            "k": int(ids.shape[1]),
                        }
                    else:
                        coords = fleet.project(route, genotypes,
                                               deadline_s=deadline_s,
                                               trace=trace, **kwargs)
                        payload = {"coords": coords.tolist()}
            except UnknownRoute as e:
                code, payload = 404, {"error": str(e)}
            except ServerOverloaded as e:
                code, payload = 429, {"error": str(e)}
            except DeadlineExceeded as e:
                code, payload = 504, {"error": str(e)}
            except ServerClosed as e:
                code, payload = 503, {"error": str(e)}
            except PanelUnavailable as e:
                # The route's panel cannot stage right now (breaker
                # open / store down) — unavailable, not a client error.
                code, payload = 503, {"error": str(e)}
            except ValueError as e:
                code, payload = 400, {"error": str(e)}
            except Exception as e:  # answered, never a dropped socket
                code, payload = 500, {"error": repr(e)}
            total = time.perf_counter() - t0
            phases = {**trace["phases"], "total": total}
            cls = kwargs.get("priority", "")
            if sampled:
                telemetry.count("trace.sampled")
                telemetry.span_at(
                    "trace.request", t0, total, trace_id=tid,
                    span_id=trace["span_id"], route=route, cls=cls,
                    status=code,
                    cache_hit=bool(trace.get("cache_hit")))
                telemetry.record_request_exemplar(
                    tid, total, phases, route=route, cls=cls,
                    status=code)
            self._reply(code, payload, headers={
                "X-Trace-Id": tid,
                "Server-Timing": _server_timing(phases),
            })

    return FleetHandler


class ProjectionHTTPServer:
    """Lifecycle wrapper: bind (port 0 = ephemeral), serve in a daemon
    thread or in the foreground, shut down. ``handler`` overrides the
    single-model handler (the fleet front passes its own)."""

    def __init__(self, pserver: ProjectionServer | None,
                 host: str = "127.0.0.1", port: int = 0, handler=None):
        self._httpd = ThreadingHTTPServer(
            (host, port), handler or _make_handler(pserver))
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def serve_in_thread(self) -> "ProjectionHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="projection-http",
            daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def start_http_server(pserver: ProjectionServer, host: str = "127.0.0.1",
                      port: int = 0) -> ProjectionHTTPServer:
    """Bind + serve in a background thread; returns the wrapper (read
    ``.port`` for the ephemeral bind)."""
    return ProjectionHTTPServer(pserver, host=host, port=port).serve_in_thread()


def fleet_http_server(fleet, host: str = "127.0.0.1",
                      port: int = 0) -> ProjectionHTTPServer:
    """The fleet front, not yet serving (call ``serve_forever`` or
    ``serve_in_thread``)."""
    return ProjectionHTTPServer(None, host=host, port=port,
                                handler=_make_fleet_handler(fleet))


def start_fleet_http_server(fleet, host: str = "127.0.0.1",
                            port: int = 0) -> ProjectionHTTPServer:
    """Bind the fleet front + serve in a background thread."""
    return fleet_http_server(fleet, host=host, port=port).serve_in_thread()
