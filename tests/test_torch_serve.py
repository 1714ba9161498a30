"""Single-model serving: the port's engine, server, HTTP front, loadgen
and ``serve`` CLI on the CPU, against its own offline ``project`` and
against the JAX package's server.

- The JAX package's single-model cases (tests/test_serve.py) on the
  port: padded micro-batches bitwise equal to the offline single-query
  ``project`` (pcoa, pca and the factorized model), the result cache
  and its LRU, overload shedding under an injected stall, deadlines, an
  injected ``io_error`` failing exactly one request, cancellation, the
  HTTP front, hot reload, malformed queries, worker recovery, the store
  breaker and cached-panel mode, the restage refusal, the CLI loadgen.
- Across packages: one model file served by the port and by JAX's
  ``ProjectionServer``: the int32 cross accumulators bitwise, the
  coordinates within 1e-5 of max|coords|.
- The ``serve`` CLI over HTTP in a subprocess: port file, X-Trace-Id
  echo, SIGTERM drain and the exported ``serve.*`` histograms.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import project as jproject
from spark_examples_tpu.serve import ProjectionEngine as JEngine
from spark_examples_tpu.serve import ProjectionServer as JServer
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job, variants_pca_job
from spark_examples_tpu_torch.pipelines.project import pcoa_project_job
from spark_examples_tpu_torch.serve import (
    CircuitBreaker,
    DeadlineExceeded,
    ProjectionEngine,
    ProjectionServer,
    ServerClosed,
    ServerOverloaded,
    engine as E,
    run_loadgen,
)

from conftest import random_genotypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BV = 128  # staging/fit block width of every test panel


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()
    telemetry.configure(dir=None)


def _job(bv=BV, model_path=None, **compute):
    return JobConfig(ingest=IngestConfig(block_variants=bv),
                     compute=ComputeConfig(device="cpu", **compute),
                     model_path=model_path)


def _fit(tmp_path, rng, kind="pcoa", n=16, v=256, num_pc=4):
    """A tiny fitted panel: (panel, model path, job)."""
    g_ref = random_genotypes(rng, n=n, v=v, missing_rate=0.1)
    model = str(tmp_path / f"model_{kind}_{n}x{v}.npz")
    if kind == "factorized":
        job = _job(model_path=model, metric="ibs", num_pc=num_pc,
                   solver="corrected", sketch_rank=8)
    else:
        job = _job(model_path=model, num_pc=num_pc,
                   metric="ibs" if kind == "pcoa" else None)
    fit = variants_pca_job if kind == "pca" else pcoa_job
    fit(job, source=ArraySource(g_ref))
    return g_ref, model, job.replace(model_path=None)


def _offline(job, model, g_ref, query):
    """The offline single-query ``project``: the serving contract's
    ground truth."""
    return pcoa_project_job(
        job, model_path=model,
        source_new=ArraySource(query[None, :] if query.ndim == 1 else query),
        source_ref=ArraySource(g_ref),
    ).coords


def _engine(model, g_ref, **kw):
    kw.setdefault("block_variants", BV)
    kw.setdefault("max_batch", 2)
    return ProjectionEngine(model, ArraySource(g_ref), device="cpu", **kw)


@pytest.mark.parametrize("kind", ["pcoa", "pca", "factorized"])
def test_batch_padding_equivalence(rng, tmp_path, kind):
    """Padded micro-batches of 1, 3, max and max+1 (two batches) give
    rows bitwise equal to the offline single-query job."""
    g_ref, model, job = _fit(tmp_path, rng, kind=kind, n=24, v=384)
    max_batch = 4
    engine = _engine(model, g_ref, max_batch=max_batch)
    queries = random_genotypes(rng, n=max_batch + 1, v=384, missing_rate=0.1)
    offline = [_offline(job, model, g_ref, q) for q in queries]
    for b in (1, 3, max_batch):
        got = engine.project_batch(queries[:b])
        assert got.shape == (b, engine.n_components)
        for i in range(b):
            np.testing.assert_array_equal(got[i:i + 1], offline[i])
    server = ProjectionServer(engine, max_linger_s=0.01,
                              cache_entries=0).start()
    try:
        futs = [server.submit(q) for q in queries]
        for fut, want in zip(futs, offline):
            np.testing.assert_array_equal(fut.result(timeout=60), want)
        assert server.stats.snapshot()["batches"] >= 2
    finally:
        server.close()


def test_serve_smoke(rng, tmp_path):
    g_ref, model, _job_ = _fit(tmp_path, rng, n=12, v=256)
    engine = _engine(model, g_ref)
    query = random_genotypes(rng, n=1, v=256)[0]
    with ProjectionServer(engine) as server:
        coords = server.project(query, timeout=60)
        assert coords.shape == (1, engine.n_components)
        assert np.isfinite(coords).all()
    assert server.in_flight == 0
    with pytest.raises(ServerClosed):
        server.submit(query)


def test_result_cache_hit_and_lru_eviction(rng, tmp_path):
    g_ref, model, _job_ = _fit(tmp_path, rng, n=12, v=256)
    engine = _engine(model, g_ref)
    queries = random_genotypes(rng, n=3, v=256)
    server = ProjectionServer(engine, cache_entries=2).start()
    try:
        first = server.project(queries[0], timeout=60)
        again = server.project(queries[0], timeout=60)
        np.testing.assert_array_equal(first, again)
        assert server.stats.snapshot()["cache_hits"] == 1
        assert telemetry.counter_value("serve.cache_hits") == 1
        server.project(queries[1], timeout=60)
        server.project(queries[2], timeout=60)
        server.project(queries[0], timeout=60)  # evicted: a miss
        assert server.stats.snapshot()["cache_hits"] == 1
        assert telemetry.counter_value("serve.cache_misses") == 4
    finally:
        server.close()


def test_result_cache_namespaces_and_accounting():
    from spark_examples_tpu_torch.serve import ResultCache, genotype_digest
    from spark_examples_tpu.serve import genotype_digest as jdigest

    g = np.arange(10, dtype=np.int8)
    assert genotype_digest(g, "ns") == jdigest(g, "ns")
    cache = ResultCache(3)
    row = np.ones((1, 4), np.float32)
    cache.put("a", row, namespace="m1")
    cache.put("a", row * 2, namespace="m2")
    cache.put("b", (np.arange(3, dtype=np.int32), np.ones(3)),
              namespace="m1")
    assert cache.get("a", namespace="m2")[0, 0] == 2.0
    ids, _ = cache.get("b", namespace="m1")
    assert ids.dtype == np.int32 and not ids.flags.writeable
    assert cache.stats() == {"entries": 3, "bytes": 16 + 16 + 12 + 24,
                             "namespaces": 2}
    assert cache.evict_namespace("m1") == 2
    assert cache.stats() == {"entries": 1, "bytes": 16, "namespaces": 1}


def test_overload_sheds_and_drains_under_injected_stall(rng, tmp_path):
    g_ref, model, _job_ = _fit(tmp_path, rng, n=12, v=256)
    engine = _engine(model, g_ref)
    server = ProjectionServer(engine, max_linger_s=0.0, max_queue=2,
                              cache_entries=0).start()
    queries = random_genotypes(rng, n=30, v=256)
    futs, shed = [], 0
    try:
        with faults.armed(["serve.request:delay:delay=0.05:max=8"],
                          seed=3) as inj:
            for q in queries:
                try:
                    futs.append(server.submit(q))
                except ServerOverloaded:
                    shed += 1
            assert shed > 0, "bounded queue never filled"
            assert futs, "everything shed — queue bound miswired"
            for fut in futs:
                assert fut.result(timeout=60).shape[0] == 1
            assert inj.fire_count("serve.request") > 0
        assert server.drain(timeout=60)
    finally:
        server.close()
    assert server.in_flight == 0
    assert telemetry.counter_value("serve.shed") == shed
    assert server.stats.snapshot()["shed"] == shed


def test_deadline_expires_while_queued(rng, tmp_path):
    g_ref, model, _job_ = _fit(tmp_path, rng, n=12, v=256)
    engine = _engine(model, g_ref)
    server = ProjectionServer(engine, max_linger_s=0.0,
                              cache_entries=0).start()
    queries = random_genotypes(rng, n=2, v=256)
    try:
        with faults.armed(["serve.request:delay:delay=0.2:max=1"]):
            stalled = server.submit(queries[0])
            doomed = server.submit(queries[1], deadline_s=0.05)
            assert stalled.result(timeout=60).shape == (
                1, engine.n_components)
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=60)
        assert telemetry.counter_value("serve.deadline_expired") == 1
        assert server.drain(timeout=60)
    finally:
        server.close()


def test_injected_io_error_fails_exactly_one_request(rng, tmp_path):
    g_ref, model, _job_ = _fit(tmp_path, rng, n=12, v=256)
    engine = _engine(model, g_ref)
    server = ProjectionServer(engine, cache_entries=0).start()
    queries = random_genotypes(rng, n=4, v=256)
    try:
        with faults.armed(["serve.request:io_error:max=1"]):
            futs = [server.submit(q) for q in queries]
            outcomes = []
            for fut in futs:
                try:
                    fut.result(timeout=60)
                    outcomes.append("ok")
                except faults.InjectedFault:
                    outcomes.append("fault")
        assert outcomes.count("fault") == 1
        assert outcomes.count("ok") == 3
        assert telemetry.counter_value("serve.errors") == 1
        assert server.drain(timeout=60)
    finally:
        server.close()


def test_cancellation_before_pickup(rng, tmp_path):
    g_ref, model, _job_ = _fit(tmp_path, rng, n=12, v=256)
    engine = _engine(model, g_ref)
    server = ProjectionServer(engine, max_linger_s=0.0,
                              cache_entries=0).start()
    queries = random_genotypes(rng, n=2, v=256)
    try:
        with faults.armed(["serve.request:delay:delay=0.2:max=1"]):
            stalled = server.submit(queries[0])
            victim = server.submit(queries[1])
            assert victim.cancel()  # still queued behind the stall
            stalled.result(timeout=60)
        assert server.drain(timeout=60)
        assert server.stats.snapshot()["cancelled"] == 1
    finally:
        server.close()


def test_loadgen_sustained_qps_and_telemetry_export(rng, tmp_path):
    g_ref, model, _job_ = _fit(tmp_path, rng, n=16, v=256)
    engine = _engine(model, g_ref, max_batch=4)
    server = ProjectionServer(engine, max_linger_s=0.001, max_queue=32,
                              cache_entries=8).start()
    pool = random_genotypes(rng, n=24, v=256)
    telemetry.configure(dir=str(tmp_path / "tel"), trace_events=False)
    try:
        report = run_loadgen(server, pool, clients=4,
                             requests_per_client=10)
        assert server.drain(timeout=60)
    finally:
        server.close()
        telemetry.export()
        telemetry.configure(dir=None)
    assert report["completed"] == 40
    assert report["errors"] == 0 and report["shed"] == 0
    assert report["sustained_qps"] > 0
    assert report["offered_qps"] >= report["sustained_qps"]
    assert report["latency_p99_ms"] >= report["latency_p50_ms"] > 0
    with open(tmp_path / "tel" / "rank0" / "metrics.json") as f:
        exported = json.load(f)
    lat = exported["histograms"]["serve.latency_s"]
    assert lat["count"] == 40
    assert lat["p99"] >= lat["p50"] > 0
    assert exported["counters"]["serve.requests"] > 0


def _post(url, body, headers=None, timeout=30):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read(), dict(r.headers)


def test_http_front(rng, tmp_path):
    from spark_examples_tpu_torch.serve.http import start_http_server

    g_ref, model, job = _fit(tmp_path, rng, n=10, v=256)
    engine = _engine(model, g_ref)
    server = ProjectionServer(engine).start()
    http = start_http_server(server, port=0)
    base = f"http://127.0.0.1:{http.port}"
    query = random_genotypes(rng, n=1, v=256)[0]
    try:
        out, headers = _post(
            f"{base}/project",
            json.dumps({"genotypes": [int(x) for x in query]}).encode(),
            headers={"X-Trace-Id": "deadbeefcafe0009"})
        got = np.asarray(out["coords"], np.float32)
        want = _offline(job, model, g_ref, query).astype(np.float32)
        np.testing.assert_array_equal(got, want)
        assert headers["X-Trace-Id"] == "deadbeefcafe0009"
        assert headers["X-Run-Id"] == telemetry.run_id()
        assert headers["Server-Timing"].startswith("total;dur=")
        health = json.loads(_get(f"{base}/healthz")[0])
        assert health["status"] == "healthy"
        assert health["panel"] == "staged"
        assert health["worker_alive"] and health["worker_restarts"] == 0
        assert health["n_variants"] == 256
        ready = json.loads(_get(f"{base}/readyz")[0])
        assert ready == {"ready": True, "worker_alive": True,
                         "draining": False}
        stats = json.loads(_get(f"{base}/stats")[0])
        assert stats["completed"] >= 1
        assert stats["health"]["status"] == "healthy"
        assert stats["health"]["breaker"]["state"] == "closed"
        assert stats["latency_p99_ms"] >= stats["latency_p50_ms"]
        prom, ph = _get(f"{base}/metrics")
        assert ph["Content-Type"].startswith("text/plain")
        prom = prom.decode()
        assert "serve_requests_total" in prom
        assert 'serve_latency_s{quantile="0.99"}' in prom
        assert "telemetry_info{run_id=" in prom
        debug = json.loads(_get(f"{base}/debug/telemetry")[0])
        assert debug["counters"]["serve.requests"] >= 1
        assert debug["meta"]["run_id"]
        assert "recent_events" in debug
        exemplars = json.loads(_get(f"{base}/debug/requests")[0])
        assert [e["trace_id"] for e in exemplars["exemplars"]] == [
            "deadbeefcafe0009"]
        # An unusable X-Trace-Id is replaced by a minted one.
        _, headers = _post(
            f"{base}/project",
            json.dumps({"genotypes": [int(x) for x in query]}).encode(),
            headers={"X-Trace-Id": "bad id!"})
        assert len(headers["X-Trace-Id"]) == 16
        for body in (b'{"genotypes": "nope"}',
                     json.dumps({"genotypes": [300] * 256}).encode(),
                     json.dumps({"genotypes": [0.7] * 256}).encode(),
                     json.dumps({"genotypes": [1] * 10}).encode()):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"{base}/project", body)
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{base}/nope")
        assert err.value.code == 404
    finally:
        http.shutdown()
        server.close()


def test_hot_reload_swaps_model_and_rejects_wrong_panel(rng, tmp_path):
    g_ref, model3, _ = _fit(tmp_path, rng, n=16, v=256, num_pc=3)
    model5 = str(tmp_path / "m5.npz")
    pcoa_job(_job(model_path=model5, metric="ibs", num_pc=5),
             source=ArraySource(g_ref))
    other_panel = random_genotypes(rng, n=16, v=256)
    model_other = str(tmp_path / "other.npz")
    pcoa_job(_job(model_path=model_other, metric="ibs", num_pc=5),
             source=ArraySource(other_panel,
                                ids=[f"OTHER{i}" for i in range(16)]))
    engine = _engine(model3, g_ref)
    query = random_genotypes(rng, n=1, v=256)[0]
    server = ProjectionServer(engine, cache_entries=4).start()
    try:
        before = server.project(query, timeout=60)
        server.project(query, timeout=60)  # prime the cache
        server.reload_model(model5)
        after = server.project(query, timeout=60)
        assert after.shape[1] > before.shape[1]
        with pytest.raises(ValueError, match="different reference panel"):
            server.reload_model(model_other)
        assert server.project(query, timeout=60).shape == after.shape
        assert server.drain(timeout=60)
    finally:
        server.close()


def test_engine_rejects_malformed_queries(rng, tmp_path):
    g_ref, model, _ = _fit(tmp_path, rng, n=12, v=256)
    engine = _engine(model, g_ref)
    server = ProjectionServer(engine).start()
    try:
        with pytest.raises(ValueError, match="dosage vector"):
            server.submit(np.zeros(100, np.int8))
        with pytest.raises(ValueError):
            engine.project_batch(np.zeros((3, 256), np.int8))
        with pytest.raises(ValueError, match="fitted on"):
            ProjectionEngine(model, ArraySource(g_ref[:6]),
                             block_variants=BV, device="cpu")
    finally:
        server.close()


def test_worker_loop_error_recovers_without_dropping(rng, tmp_path,
                                                     monkeypatch):
    from spark_examples_tpu_torch.serve import health as H

    g_ref, model, job = _fit(tmp_path, rng, n=10, v=256)
    engine = _engine(model, g_ref)
    server = ProjectionServer(engine).start()
    try:
        assert server.health == "healthy"
        real_collect = server._collect
        blown = []

        def exploding_collect():
            if not blown:
                blown.append(True)
                raise RuntimeError("synthetic worker-loop failure")
            return real_collect()

        monkeypatch.setattr(server, "_collect", exploding_collect)
        query = random_genotypes(rng, n=1, v=256)[0]
        with pytest.warns(RuntimeWarning, match="worker recovered"):
            got = server.project(query, timeout=60)
        np.testing.assert_array_equal(got, _offline(job, model, g_ref, query))
        assert server._worker_restarts == 1
        assert server.health == "degraded"
        info = server.health_info()
        assert info["worker_alive"] and info["worker_restarts"] == 1
        server._last_recovery = time.monotonic() - H.DEGRADED_COOLOFF_S - 1
        assert server.health == "healthy"
        assert server.drain(timeout=60)
        assert server.health == "draining"
        assert telemetry.metrics_snapshot()["gauges"]["serve.health"][
            "last"] == 2.0
    finally:
        server.close()


def test_in_flight_gauge_published_at_start(rng, tmp_path):
    g_ref, model, _ = _fit(tmp_path, rng, n=10, v=256)
    server = ProjectionServer(_engine(model, g_ref)).start()
    try:
        gauges = telemetry.metrics_snapshot()["gauges"]
        assert gauges["serve.in_flight"]["last"] == 0
    finally:
        server.close()


def test_dead_worker_thread_restarted_at_admission(rng, tmp_path):
    g_ref, model, job = _fit(tmp_path, rng, n=10, v=256)
    server = ProjectionServer(_engine(model, g_ref)).start()
    try:
        server._stop.set()
        server._worker.join(timeout=10)
        assert not server._worker.is_alive()
        server._stop.clear()
        query = random_genotypes(rng, n=1, v=256)[0]
        with pytest.warns(RuntimeWarning, match="found dead at admission"):
            got = server.project(query, timeout=60)
        np.testing.assert_array_equal(got, _offline(job, model, g_ref, query))
        assert server._worker_restarts == 1
        assert telemetry.counter_value("serve.worker_restarts") == 1
    finally:
        server.close()


def test_store_breaker_trips_to_cached_panel_mode(rng, tmp_path):
    from spark_examples_tpu_torch.pipelines import runner as R
    from spark_examples_tpu_torch.store import compact

    g_ref, model, job = _fit(tmp_path, rng, n=10, v=256)
    store = str(tmp_path / "panel_store")
    compact(store, ArraySource(g_ref), chunk_variants=64)
    panel_cfg = IngestConfig(source="store", path=store, block_variants=BV,
                             readahead_chunks=0, io_retries=0)
    sources = [R.build_source(panel_cfg, "cpu")]
    engine = ProjectionEngine(model, sources[0], block_variants=BV,
                              max_batch=2, device="cpu")
    engine.breaker = CircuitBreaker(trip_after=2, reset_s=0.05)
    server = ProjectionServer(engine).start()
    query = random_genotypes(rng, n=1, v=256)[0]
    want = _offline(job, model, g_ref, query)
    try:
        np.testing.assert_array_equal(server.project(query, timeout=60), want)
        assert engine.store_cache_stats() is not None
        with faults.armed(["store.read:io_error:max=0"]):
            for _ in range(2):
                sources.append(R.build_source(panel_cfg, "cpu"))
                with pytest.warns(RuntimeWarning, match="re-stage failed"):
                    assert server.restage_panel(sources[-1]) is False
            assert engine.breaker.state in ("open", "half-open")
            assert engine.panel_mode == "cached-only"
            assert server.health == "degraded"
            assert server.health_info()["panel"] == "cached-only"
            np.testing.assert_array_equal(server.project(query, timeout=60),
                                          want)
        time.sleep(0.06)
        sources.append(R.build_source(panel_cfg, "cpu"))
        assert server.restage_panel(sources[-1]) is True
        assert engine.breaker.state == "closed"
        assert server.health == "healthy"
        np.testing.assert_array_equal(server.project(query, timeout=60), want)
    finally:
        server.close()
        for src in sources:
            src.close()


def test_restage_refuses_panel_identity_change(rng, tmp_path):
    g_ref, model, _ = _fit(tmp_path, rng, n=10, v=256)
    engine = _engine(model, g_ref)
    with pytest.warns(RuntimeWarning, match="re-stage failed"):
        assert engine.restage(ArraySource(g_ref[:, :128])) is False
    with pytest.warns(RuntimeWarning, match="different sample ids"):
        assert engine.restage(ArraySource(
            g_ref, ids=[f"X{i}" for i in range(10)])) is False


def test_breaker_state_machine():
    now = [0.0]
    b = CircuitBreaker(trip_after=2, reset_s=10.0, clock=lambda: now[0])
    assert b.state == "closed" and b.allow()
    b.record_failure()
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open" and not b.allow()
    assert telemetry.counter_value("serve.breaker_open") == 1
    now[0] = 10.1
    assert b.state == "half-open"
    assert b.allow() and not b.allow()
    b.release_probe()
    assert b.allow()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    now[0] = 20.3
    assert b.allow()
    b.record_success()
    assert b.state == "closed" and b.allow()


def test_health_rules():
    from spark_examples_tpu_torch.serve import health as H

    assert H.readiness(True, False) and not H.readiness(True, True)
    assert not H.readiness(False, False)
    assert not H.readiness(True, False, unstaged=["r"])
    assert H.worst([]) == H.HEALTHY
    assert H.worst([H.HEALTHY, H.DRAINING, H.DEGRADED]) == H.DRAINING


def test_shard_stream_partitions_the_panel(rng):
    g = random_genotypes(rng, n=6, v=1000)
    shards = list(E.shard_stream(ArraySource(g), 128, 2 * 6 * 128, "cpu"))
    assert [len(b) for b, _ in shards] == [2, 2, 2, 2]
    got = np.concatenate([blk.numpy() for b, _ in shards for blk, _m in b],
                         axis=1)
    np.testing.assert_array_equal(got, g)
    blocks, n_variants, nbytes = E.stage_blocks(ArraySource(g), 128, "cpu")
    assert n_variants == 1000 and nbytes == g.nbytes
    assert sum(n for _, n in shards) == nbytes


def test_topk_gate_refuses_pca_models(rng, tmp_path):
    _g, model, _ = _fit(tmp_path, rng, kind="pca", n=10, v=256)
    from spark_examples_tpu_torch.pipelines.project import load_model

    with pytest.raises(ValueError, match="metric-bearing"):
        E.check_topkable(load_model(model))


def test_engine_on_cuda_without_a_card_raises(monkeypatch, rng, tmp_path):
    g_ref, model, _ = _fit(tmp_path, rng, n=10, v=256)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        ProjectionEngine(model, ArraySource(g_ref), block_variants=BV)
    with pytest.raises(RuntimeError, match="--device cuda"):
        E.ModelContext(model)


# ------------------------------------------------- against the JAX package

@pytest.mark.parametrize("kind", ["pcoa", "pca", "factorized"])
def test_port_and_jax_servers_agree_on_one_model_file(rng, tmp_path, kind):
    """One model file (fitted by the port) served by both packages: the
    padded-batch int32 cross accumulators bitwise equal, the served
    coordinates within 1e-5 of max|coords|."""
    g_ref, model, _job_ = _fit(tmp_path, rng, kind=kind, n=20, v=384)
    queries = random_genotypes(rng, n=3, v=384)
    engine = _engine(model, g_ref, max_batch=4)
    jengine = JEngine(model, JArraySource(g_ref), block_variants=BV,
                      max_batch=4)
    ctx = engine._ctx
    g, _b = E._padded_batch(queries, 4, 384)
    acc, _ = E._cross_batch(ctx, engine._ref_blocks, g, ctx.stats)
    jacc = {k: jnp.zeros((4, ctx.n_ref), jnp.int32) for k in ctx.stats}
    for ref_dev, meta in jengine._ref_blocks:
        jacc = jproject._update_cross(
            jacc, jnp.asarray(g[:, meta.start:meta.stop]), ref_dev)
    for k in ctx.stats:
        np.testing.assert_array_equal(acc[k].numpy(), np.asarray(jacc[k]))
    server = ProjectionServer(engine, cache_entries=0).start()
    jserver = JServer(jengine, cache_entries=0).start()
    try:
        for q in queries:
            got = server.project(q, timeout=60)
            want = jserver.project(q, timeout=60)
            assert got.shape == want.shape
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-5 * scale
    finally:
        server.close()
        jserver.close()


def test_jax_fitted_model_serves_like_its_own_server(rng, tmp_path):
    """A model file written by the JAX package, served by the port."""
    g_ref = random_genotypes(rng, n=18, v=256)
    model = str(tmp_path / "jax.npz")
    jjobs.pcoa_job(jconfig.JobConfig(
        ingest=jconfig.IngestConfig(block_variants=BV),
        compute=jconfig.ComputeConfig(metric="ibs", num_pc=3),
        model_path=model), source=JArraySource(g_ref))
    queries = random_genotypes(rng, n=2, v=256)
    got = _engine(model, g_ref).project_batch(queries)
    want = JEngine(model, JArraySource(g_ref), block_variants=BV,
                   max_batch=2).project_batch(queries)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ----------------------------------------------------------------- the CLI

def test_serve_cli_loadgen_mode(rng, tmp_path, capsys):
    from spark_examples_tpu_torch.cli.main import main
    from spark_examples_tpu_torch.ingest.packed import save_packed

    g_ref = random_genotypes(rng, n=16, v=256, missing_rate=0.1)
    store = str(tmp_path / "panel_store")
    save_packed(store, g_ref)
    model = str(tmp_path / "cli_model.npz")
    common = ["--device", "cpu", "--block-variants", str(BV)]
    assert main(["pcoa", "--source", "packed", "--path", store,
                 "--num-pc", "3", "--save-model", model] + common) == 0
    telemetry.reset()
    assert main(["serve", "--model", model, "--ref-source", "packed",
                 "--ref-path", store, "--source", "synthetic",
                 "--n-samples", "8", "--max-batch", "4",
                 "--max-linger-ms", "1", "--loadgen", "2",
                 "--loadgen-requests", "6",
                 "--telemetry-dir", str(tmp_path / "cli_tel")]
                + common) == 0
    out = capsys.readouterr().out
    report = json.loads(out.strip().splitlines()[-1])
    assert report["completed"] == 12 and report["errors"] == 0
    assert report["sustained_qps"] > 0
    with open(tmp_path / "cli_tel" / "rank0" / "metrics.json") as f:
        exported = json.load(f)
    assert exported["histograms"]["serve.latency_s"]["count"] > 0


@pytest.mark.parametrize("argv,match", [
    (["serve", "--device", "cpu"], "serve needs --model"),
    (["serve", "--device", "cpu", "--model", "m.npz"],
     "serve requires --ref-path"),
    (["serve", "--device", "cpu", "--model", "m.npz", "--ref-path", "p",
      "--max-batch", "0"], "--max-batch=0"),
    (["serve", "--device", "cpu", "--model", "m.npz", "--ref-path", "p",
      "--fleet", "f.json"], "--fleet and --model are mutually exclusive"),
    (["pcoa", "--device", "cpu", "--trace-sample", "2"], "--trace-sample=2"),
    (["pcoa", "--device", "cpu", "--telemetry-flush-s", "1"],
     "--telemetry-flush-s needs --telemetry-dir"),
])
def test_serve_and_telemetry_usage_errors(argv, match, capsys):
    from spark_examples_tpu_torch.cli.main import main

    with pytest.raises(SystemExit):
        main(argv)
    assert match in capsys.readouterr().err


def test_serve_on_cuda_without_a_card_raises(monkeypatch, rng, tmp_path):
    from spark_examples_tpu_torch.cli.main import main
    from spark_examples_tpu_torch.ingest.packed import save_packed

    g_ref, model, _ = _fit(tmp_path, rng, n=10, v=256)
    store = str(tmp_path / "panel")
    save_packed(store, g_ref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        main(["serve", "--model", model, "--ref-path", store,
              "--block-variants", str(BV), "--loadgen", "1"])


def test_serve_cli_over_http_drains_on_sigterm(rng, tmp_path):
    """``serve`` as a process: the port file, one POST with its trace id
    echoed, SIGTERM, a clean exit, and the exported serve.* counts."""
    from spark_examples_tpu_torch.ingest.packed import save_packed

    g_ref, model, job = _fit(tmp_path, rng, n=12, v=256)
    store = str(tmp_path / "panel")
    save_packed(store, g_ref)
    port_file = tmp_path / "port.json"
    tel = tmp_path / "tel"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch", "serve",
         "--device", "cpu", "--model", model, "--ref-path", store,
         "--block-variants", str(BV), "--port", "0", "--port-file",
         str(port_file), "--telemetry-dir", str(tel)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 120
        while not port_file.exists():
            assert proc.poll() is None, proc.communicate(timeout=30)
            assert time.time() < deadline, "server never bound"
            time.sleep(0.05)
        port = json.loads(port_file.read_text())["port"]
        query = random_genotypes(rng, n=1, v=256)[0]
        out, headers = _post(
            f"http://127.0.0.1:{port}/project",
            json.dumps({"genotypes": [int(x) for x in query]}).encode(),
            headers={"X-Trace-Id": "feedface00000039"})
        assert headers["X-Trace-Id"] == "feedface00000039"
        np.testing.assert_array_equal(
            np.asarray(out["coords"], np.float32),
            _offline(job, model, g_ref, query))
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "draining..." in err
    with open(tel / "rank0" / "metrics.json") as f:
        exported = json.load(f)
    assert exported["histograms"]["serve.latency_s"]["count"] == 1
    assert exported["counters"]["serve.requests"] == 1
    assert exported["gauges"]["serve.health"]["last"] == 2.0
