"""Closed-loop load generator of the single-model server.

``clients`` threads each submit queries back to back (a new request the
moment the previous one resolves), drawing striped rows from a query
pool. Because the loop is closed, *offered* load is what the clients
managed to attempt (sheds included) and *sustained* is what the server
completed; under overload the gap is the shed and error count, never
silent queueing.

Latency percentiles are read from the telemetry registry's
``serve.latency_s`` histogram, the numbers ``--telemetry-dir`` exports.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.serve.server import (
    DeadlineExceeded,
    ProjectionServer,
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
