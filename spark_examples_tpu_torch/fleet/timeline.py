"""Fleet timeline recorder: the controller's continuous flight tape.

Before this module the controller discarded every per-slot
:class:`~spark_examples_tpu_torch.fleet.replica.ReplicaSnapshot` the moment
the round's autoscale math consumed it — an interactive p99 spike left
no artifact saying what the fleet looked like when it happened. The
timeline closes that hole with three pieces:

- **The ring file.** Every control round appends one compact record
  (per-slot p99/queues/shed/pool-pressure plus fleet counts) to an
  append-only ``timeline.jsonl`` beside the ledger; replica lifecycle
  incidents and controller decisions land between rounds as ``marker``
  records. The file is size-bounded: past ``max_bytes`` it compacts to
  the in-memory window via tmp+rename (the checkpoint idiom), so a
  killed controller always leaves a readable last-good tape, and a
  torn append tail is skipped by :func:`read_timeline` — the same
  torn-tail tolerance ``core/stitch.py`` applies to trace exports.
  Both the append and the compaction are ``trace.export`` fault sites.
- **Fleet folds.** Each round folds cross-replica aggregates into
  fleet-wide series: queue depths sum, shed rates take the worst
  route, and p99 history folds through ``Histogram.merge`` (per-slot
  per-route histograms of observed round p99s merged at read time) so
  the fleet quantile is a real merge, not a max-of-maxes guess. The
  folds publish as ``timeline.*`` gauges in the controller's registry,
  which ``GET /fleet/metrics`` (:class:`TimelineMetricsServer`)
  renders as Prometheus text — one scrape for the whole fleet.
- **The read side.** ``telemetry timeline`` (cli) and the SLO
  evaluator (fleet/slo.py) both consume :meth:`FleetTimeline.recent`
  — rounds and markers on one clock, newest last.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from spark_examples_tpu_torch.core import faults, live, telemetry

# In-memory rounds retained for folds, SLO burn windows, and the CLI
# render; also the compaction survivor set — the ring's "last good"
# window after a size-bound rewrite.
TIMELINE_WINDOW = 512
DEFAULT_MAX_BYTES = 1_000_000
_MIN_MAX_BYTES = 4096


def snapshot_record(snap) -> dict:
    """A ReplicaSnapshot (or None) as the timeline's compact per-slot
    dict — only the series the folds, SLOs, and the CLI render read."""
    if snap is None:
        return {"present": False}
    return {
        "present": True,
        "ready": bool(snap.ready),
        "stale": bool(snap.stale),
        "health": snap.health,
        "in_flight": int(snap.in_flight),
        "queue_interactive": int(snap.queue_interactive),
        "queue_batch": int(snap.queue_batch),
        "p99_s": round(float(snap.p99_s), 6),
        "shed_rate": round(float(snap.shed_rate), 6),
        "pool_pressure": round(float(snap.pool_pressure), 6),
        "routes": {
            name: {
                "p99_s": round(float(r.get("p99_s", 0.0)), 6),
                "queue_depth": int(r.get("queue_depth", 0)),
                "shed_rate": round(float(r.get("shed_rate", 0.0)), 6),
                "staged": bool(r.get("staged")),
            }
            for name, r in (snap.routes or {}).items()
        },
    }


class FleetTimeline:
    """The append-only, size-bounded fleet tape + its live folds.

    ``path=None`` keeps the timeline memory-only (tests, and fleets
    run without a ledger directory) — folds and SLO evaluation work
    identically; only the on-disk ring is skipped.
    """

    def __init__(self, path: str | None = None,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 window: int = TIMELINE_WINDOW):
        if not (isinstance(max_bytes, int)
                and not isinstance(max_bytes, bool)
                and max_bytes >= _MIN_MAX_BYTES):
            raise ValueError(
                f"bad timeline config: --timeline-max-bytes="
                f"{max_bytes!r} — expected an int >= {_MIN_MAX_BYTES} "
                "(the ring compacts past this size; smaller bounds "
                "cannot hold even one compaction window)")
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._rounds: deque = deque(maxlen=int(window))
        self._markers: deque = deque(maxlen=int(window))
        self._seq = 0
        # route -> slot -> Histogram of per-round observed p99 samples;
        # fixed-size log-bucket histograms, so a week-long run grows
        # the fold state by zero bytes.
        self._route_hists: dict[str, dict[str, telemetry.Histogram]] = {}
        self._bytes = 0
        if path:
            try:
                self._bytes = os.path.getsize(path)
            except OSError:
                self._bytes = 0

    # -- write side --------------------------------------------------------

    def record_round(self, round_no: int, slots: dict[str, object],
                     replicas_up: int, ready: int) -> dict:
        """Persist one control round's per-slot snapshots and refresh
        the fleet folds. ``slots`` maps slot name -> ReplicaSnapshot
        (None for a slot with nothing scraped this generation)."""
        rec = {
            "type": "round",
            "round": int(round_no),
            "t_unix": time.time(),
            "replicas": int(replicas_up),
            "ready": int(ready),
            "slots": {name: snapshot_record(snap)
                      for name, snap in slots.items()},
        }
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._rounds.append(rec)
            for slot_name, s in rec["slots"].items():
                if not s.get("present") or s.get("stale"):
                    continue
                for route, r in s.get("routes", {}).items():
                    per_slot = self._route_hists.setdefault(route, {})
                    h = per_slot.get(slot_name)
                    if h is None:
                        h = per_slot[slot_name] = telemetry.Histogram()
                    h.record(r["p99_s"])
        telemetry.count("timeline.rounds")
        self._append(rec)
        self._fold(rec)
        return rec

    def record_marker(self, round_no: int, who: str, kind: str,
                      detail: str, t_unix: float | None = None) -> dict:
        """One lifecycle incident/decision as a timeline marker — the
        crash/respawn/preempt/park/SLO-breach pins the CLI render and
        the fleet stitch align against the metric history."""
        rec = {
            "type": "marker",
            "round": int(round_no),
            "t_unix": time.time() if t_unix is None else float(t_unix),
            "who": who,
            "kind": kind,
            "detail": detail,
        }
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._markers.append(rec)
        telemetry.count("timeline.markers")
        self._append(rec)
        return rec

    def _append(self, rec: dict) -> None:
        if not self.path:
            return
        line = json.dumps(rec, sort_keys=True)
        try:
            faults.fire("trace.export", path=self.path)
            with open(self.path, "a") as f:
                f.write(line)
                f.write("\n")
            with self._lock:
                self._bytes += len(line) + 1
        except OSError:
            telemetry.count("timeline.write_errors")
        telemetry.gauge_set("timeline.bytes", float(self._bytes))
        if self._bytes > self.max_bytes:
            self._compact()

    def _compact(self) -> None:
        """Size bound tripped: atomically rewrite the ring as the
        in-memory window (rounds + markers in arrival order). tmp +
        rename — a controller killed mid-compaction leaves the
        previous complete ring, never a torn one."""
        with self._lock:
            keep = sorted(list(self._rounds) + list(self._markers),
                          key=lambda r: r.get("seq", 0))
            lines = [json.dumps(r, sort_keys=True) for r in keep]
        try:
            faults.fire("trace.export", path=self.path)
            telemetry._atomic_write_lines(self.path, lines)
        except OSError:
            telemetry.count("timeline.write_errors")
            return
        with self._lock:
            self._bytes = sum(len(ln) + 1 for ln in lines)
        telemetry.count("timeline.compactions")
        telemetry.gauge_set("timeline.bytes", float(self._bytes))

    # -- folds -------------------------------------------------------------

    def route_quantile(self, route: str, q: float = 0.99) -> float:
        """Fleet-wide quantile of ``route``'s per-round p99 samples:
        per-slot histograms merged (Histogram.merge), then read — the
        cross-replica aggregate a single replica's export can't say."""
        merged = telemetry.Histogram()
        with self._lock:
            for h in self._route_hists.get(route, {}).values():
                merged.merge(h)
        return merged.quantile(q) if merged.count else 0.0

    def _fold(self, rec: dict) -> None:
        slots = [s for s in rec["slots"].values() if s.get("present")]
        depth = sum(s["queue_interactive"] + s["queue_batch"]
                    for s in slots)
        shed = max((s["shed_rate"] for s in slots), default=0.0)
        with self._lock:
            routes = sorted(self._route_hists)
        fleet_p99 = 0.0
        for route in routes:
            p99 = self.route_quantile(route, 0.99)
            fleet_p99 = max(fleet_p99, p99)
            latest_depth = sum(
                s.get("routes", {}).get(route, {}).get("queue_depth", 0)
                for s in slots)
            latest_shed = max(
                (s.get("routes", {}).get(route, {}).get("shed_rate", 0.0)
                 for s in slots), default=0.0)
            prefix = "timeline.route." + route
            telemetry.gauge_set(prefix + ".p99_s", p99)
            telemetry.gauge_set(prefix + ".queue_depth",
                                float(latest_depth))
            telemetry.gauge_set(prefix + ".shed_rate", latest_shed)
        telemetry.gauge_set("timeline.fleet_p99_s", fleet_p99)
        telemetry.gauge_set("timeline.fleet_queue_depth", float(depth))
        telemetry.gauge_set("timeline.fleet_shed_rate", shed)

    # -- read side ---------------------------------------------------------

    def recent(self, n: int | None = None) -> list[dict]:
        """Rounds and markers on one clock, oldest first (newest
        last); ``n`` bounds the tail."""
        with self._lock:
            out = sorted(list(self._rounds) + list(self._markers),
                         key=lambda r: r.get("seq", 0))
        return out[-n:] if n else out

    def recent_rounds(self, since_unix: float | None = None) -> list[dict]:
        with self._lock:
            rounds = list(self._rounds)
        if since_unix is None:
            return rounds
        return [r for r in rounds if r["t_unix"] >= since_unix]


def read_timeline(path: str) -> list[dict]:
    """Load a timeline ring from disk, torn-tail-tolerant: a crashed
    (or fault-truncated) appender leaves at most one unparseable line,
    which is skipped — every complete record before it survives."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn append tail / fault-truncated line
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out


# ---------------------------------------------------------------------------
# The controller's metrics surface.


class TimelineMetricsServer:
    """``GET /fleet/metrics`` — the controller's own Prometheus text
    (fleet-wide ``timeline.*``/``slo.*``/``controller.*`` series folded
    from every replica's scrapes), plus ``GET /fleet/timeline`` as the
    recent ring in JSON. One scrape covers the whole fleet; per-replica
    detail stays on each replica's own ``/metrics``."""

    def __init__(self, timeline: FleetTimeline,
                 host: str = "127.0.0.1", port: int = 0,
                 port_file: str | None = None):
        tl = timeline

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: telemetry counts it
                pass

            def do_GET(self):
                if self.path in ("/fleet/metrics", "/metrics"):
                    snap = telemetry.metrics_snapshot()
                    snap["meta"] = telemetry._meta(0)
                    live._reply(
                        self, 200, live.prometheus_text(snap).encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/fleet/timeline":
                    body = json.dumps(
                        {"records": tl.recent()}, sort_keys=True).encode()
                    live._reply(self, 200, body, "application/json")
                else:
                    live._reply(self, 404, b'{"error": "not found"}',
                                "application/json")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        if port_file:
            telemetry._atomic_write(port_file, str(self.port))

    def serve_in_thread(self) -> "TimelineMetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-metrics-http",
            daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
