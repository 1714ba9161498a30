"""Fleet serving in the port (serve/fleet.py, pool.py, router.py, the
fleet HTTP front, the fleet and hedged loadgens, ``serve --fleet``) on
the CPU, against its own offline ``project`` and single-model server and
against the JAX package's fleet.

- The JAX package's fleet cases (tests/test_fleet.py) on the port:
  manifest validation, three routes bitwise equal to the single-model
  server and the offline ``project`` (also right after an LRU eviction
  and re-stage), the multi-tenant mix, priority admission (preemption,
  per-class sheds and deadlines), the ``fleet.stage`` fault site and the
  route breaker, the result cache's namespace on unload, hedging, the
  pool alone, the HTTP front and its trace surfaces, the CLI.
- Across packages: one manifest served by the port's and JAX's
  ``FleetRouter``: int32 cross accumulators bitwise, coordinates within
  1e-5 of max|coords|, top-k ids equal; one budget and request sequence
  evict and re-stage the same number of times; JAX's bad manifests are
  refused with JAX's ``FleetFormatError`` text.
- ``serve --fleet`` over HTTP in a subprocess, drained by SIGTERM.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu.pipelines import project as jproject
from spark_examples_tpu.serve import FleetFormatError as JFleetFormatError
from spark_examples_tpu.serve import FleetManifest as JFleetManifest
from spark_examples_tpu.serve import build_fleet as jbuild_fleet
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import (
    PRIORITY_CLASSES,
    ComputeConfig,
    IngestConfig,
    JobConfig,
    ServeConfig,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job, variants_pca_job
from spark_examples_tpu_torch.pipelines.project import pcoa_project_job
from spark_examples_tpu_torch.serve import (
    CircuitBreaker,
    DeadlineExceeded,
    FleetFormatError,
    FleetManifest,
    PanelPool,
    PanelUnavailable,
    ProjectionEngine,
    ProjectionServer,
    ServerOverloaded,
    UnknownRoute,
    build_fleet,
    run_fleet_loadgen,
    run_hedged_loadgen,
)
from spark_examples_tpu_torch.serve import engine as E
from spark_examples_tpu_torch.store import quarantine as qledger

from conftest import random_genotypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BV = 128  # staging/fit block width for every test panel
N, V = 12, 256
PANEL_BYTES = N * V  # dense int8 staged bytes per test panel

INTERACTIVE, BATCH = PRIORITY_CLASSES


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    telemetry.configure(dir=None)
    jtelemetry.reset()


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Three fitted (model, store-backed panel) routes — ibs PCoA,
    shared-alt PCA, jaccard PCoA — plus their offline ground truths."""
    from spark_examples_tpu_torch.store.writer import compact

    base = tmp_path_factory.mktemp("fleet_fixture")
    rng = np.random.default_rng(42)
    routes = {}
    for i, (name, kind, metric) in enumerate([
        ("r-ibs", "pcoa", "ibs"),
        ("r-pca", "pca", None),
        ("r-jac", "pcoa", "jaccard"),
    ]):
        g = random_genotypes(rng, n=N, v=V, missing_rate=0.1)
        store = str(base / f"store_{i}")
        compact(store, ArraySource(g), chunk_variants=64)
        model = str(base / f"model_{i}.npz")
        job = JobConfig(
            ingest=IngestConfig(block_variants=BV),
            compute=ComputeConfig(metric=metric, num_pc=3, device="cpu"),
            model_path=model,
        )
        (pcoa_job if kind == "pcoa" else variants_pca_job)(
            job, source=ArraySource(g))
        routes[name] = SimpleNamespace(
            name=name, genotypes=g, store=store, model=model,
            job=job.replace(model_path=None))
    return SimpleNamespace(base=base, routes=routes)


def _manifest_doc(fx, topk=(), **top) -> dict:
    return {
        "routes": [
            {"name": r.name, "model": r.model,
             "source": f"store:{r.store}",
             **({"topk": True} if r.name in topk else {})}
            for r in fx.routes.values()
        ],
        **top,
    }


def _build(fx, budget_mb=1.0, cfg=None, readahead=0, topk=(),
           **manifest_top):
    manifest = FleetManifest.parse(
        _manifest_doc(fx, topk=topk, budget_mb=budget_mb, **manifest_top))
    return build_fleet(
        manifest, cfg or ServeConfig(),
        ingest_defaults=IngestConfig(block_variants=BV,
                                     readahead_chunks=readahead),
        device="cpu",
    )


def _jbuild(fx, budget_mb=1.0, cfg=None, topk=()):
    manifest = JFleetManifest.parse(
        _manifest_doc(fx, topk=topk, budget_mb=budget_mb))
    return jbuild_fleet(
        manifest, cfg or jconfig.ServeConfig(),
        ingest_defaults=jconfig.IngestConfig(block_variants=BV,
                                             readahead_chunks=0),
    )


def _offline(route, query) -> np.ndarray:
    """The offline single-query `project` path — the serving
    contract's ground truth."""
    return pcoa_project_job(
        route.job, model_path=route.model,
        source_new=ArraySource(
            query[None, :] if query.ndim == 1 else query),
        source_ref=ArraySource(route.genotypes),
    ).coords


# ----------------------------------------------------------- manifest


def test_manifest_validation_names_the_problem(tmp_path):
    with pytest.raises(FleetFormatError, match="routes"):
        FleetManifest.parse({"routes": []})
    with pytest.raises(FleetFormatError, match="'model'"):
        FleetManifest.parse(
            {"routes": [{"name": "a", "source": "synthetic"}]})
    with pytest.raises(FleetFormatError, match="duplicate route"):
        FleetManifest.parse({"routes": [
            {"name": "a", "model": "m.npz", "source": "synthetic"},
            {"name": "a", "model": "m2.npz", "source": "synthetic"},
        ]})
    with pytest.raises(FleetFormatError, match="unknown field"):
        FleetManifest.parse({"routes": [
            {"name": "a", "model": "m.npz", "source": "synthetic",
             "modle": "typo"},
        ]})
    with pytest.raises(FleetFormatError, match="unknown top-level"):
        FleetManifest.parse({"routes": [
            {"name": "a", "model": "m", "source": "s"}], "budget_gb": 1})
    p = tmp_path / "broken.json"
    p.write_text("{not json")
    with pytest.raises(FleetFormatError, match="not readable JSON"):
        FleetManifest.load(str(p))
    good_routes = [{"name": "a", "model": "m", "source": "s"}]
    with pytest.raises(FleetFormatError, match="budget_mb"):
        FleetManifest.parse({"routes": good_routes, "budget_mb": "256"})
    with pytest.raises(FleetFormatError, match="max_batch"):
        FleetManifest.parse({"routes": good_routes, "max_batch": True})
    with pytest.raises(FleetFormatError, match="block_variants"):
        FleetManifest.parse({"routes": [
            {"name": "a", "model": "m", "source": "s",
             "block_variants": "4096"}]})
    # The fleet controller's objectives parse as the JAX package's
    # manifest parses them (fleet/slo.py), and a bad one is refused
    # with its text.
    slos = [{"route": "a", "p99_ms": 50, "budget": 0.2},
            {"route": "*", "availability": 0.99}]
    got = FleetManifest.parse({"routes": good_routes, "slos": slos}).slos
    want = JFleetManifest.parse({"routes": good_routes, "slos": slos}).slos
    assert [dataclasses.asdict(s) for s in got] == [
        dataclasses.asdict(s) for s in want]
    assert FleetManifest.parse({"routes": good_routes, "slos": []}).slos == ()
    with pytest.raises(FleetFormatError, match="names no declared route"):
        FleetManifest.parse({"routes": good_routes,
                             "slos": [{"route": "b", "p99_ms": 5}]})


_GOOD = {"name": "a", "model": "m.npz", "source": "synthetic"}
BAD_MANIFESTS = {
    "not an object": ["routes"],
    "no routes": {"routes": []},
    "routes not a list": {"routes": {"a": 1}},
    "route not an object": {"routes": ["a"]},
    "missing model": {"routes": [{"name": "a", "source": "synthetic"}]},
    "empty name": {"routes": [{**_GOOD, "name": ""}]},
    "duplicate": {"routes": [_GOOD, {**_GOOD, "model": "m2.npz"}]},
    "unknown field": {"routes": [{**_GOOD, "modle": "typo"}]},
    "topk not bool": {"routes": [{**_GOOD, "topk": "yes"}]},
    "unknown top-level": {"routes": [_GOOD], "budget_gb": 1},
    "budget string": {"routes": [_GOOD], "budget_mb": "256"},
    "budget negative": {"routes": [_GOOD], "budget_mb": -1},
    "max_batch bool": {"routes": [_GOOD], "max_batch": True},
    "max_batch zero": {"routes": [_GOOD], "max_batch": 0},
    "block_variants string": {"routes": [{**_GOOD,
                                          "block_variants": "4096"}]},
    "block_variants zero": {"routes": [{**_GOOD, "block_variants": 0}]},
}


@pytest.mark.parametrize("case", sorted(BAD_MANIFESTS))
def test_bad_manifests_refused_with_jax_text(case):
    """Each of JAX's manifest refusals, on the port: the same
    FleetFormatError text for the same document."""
    doc = BAD_MANIFESTS[case]
    with pytest.raises(JFleetFormatError) as jerr:
        JFleetManifest.parse(doc, origin="'m.json'")
    with pytest.raises(FleetFormatError) as err:
        FleetManifest.parse(doc, origin="'m.json'")
    assert str(err.value) == str(jerr.value)


def test_unreadable_manifest_file_same_text(tmp_path):
    p = tmp_path / "broken.json"
    p.write_text("{not json")
    with pytest.raises(JFleetFormatError) as jerr:
        JFleetManifest.load(str(p))
    with pytest.raises(FleetFormatError) as err:
        FleetManifest.load(str(p))
    assert str(err.value) == str(jerr.value)


# ------------------------------------------------- bit-identity (tier-1)


def test_three_routes_bit_identical_to_single_model_and_offline(fx):
    """Every route's served coordinates equal BOTH its own single-model
    ProjectionServer's and the offline `project`'s, bit for bit."""
    fleet = _build(fx, budget_mb=1.0).start()
    rng = np.random.default_rng(7)
    try:
        for route in fx.routes.values():
            q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
            offline = _offline(route, q)
            got = fleet.project(route.name, q, timeout=60)
            np.testing.assert_array_equal(got, offline)
            engine = ProjectionEngine(
                route.model, ArraySource(route.genotypes),
                block_variants=BV, max_batch=fleet.max_batch, device="cpu")
            with ProjectionServer(engine, cache_entries=0) as single:
                single_coords = single.project(q, timeout=60)
            np.testing.assert_array_equal(got, single_coords)
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_lru_eviction_restage_stays_bit_identical(fx):
    """Budget of ONE panel: round-robin traffic churns the pool
    (evictions + re-stages counted) and every answer — including the
    first after a route's panel was just evicted and re-staged — stays
    bit-identical to the offline path. The pool never exceeds budget."""
    budget = int(PANEL_BYTES * 1.5)  # fits exactly one staged panel
    fleet = _build(fx, budget_mb=budget / 1e6,
                   cfg=ServeConfig(cache_entries=0)).start()
    rng = np.random.default_rng(11)
    try:
        for _sweep in range(3):
            for route in fx.routes.values():
                q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
                got = fleet.project(route.name, q, timeout=60)
                np.testing.assert_array_equal(got, _offline(route, q))
                assert fleet.pool.resident_bytes() <= budget
                assert fleet.pool.resident_routes() == [route.name]
        assert telemetry.counter_value("fleet.evictions") >= 6
        assert telemetry.counter_value("fleet.restage_total") >= 6
        for route in fx.routes.values():
            assert qledger.load(route.store) == []
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_acceptance_multi_tenant_mix(fx):
    """3 routes under a 2-panel budget driven by the multi-tenant mix —
    all traffic served, pool under budget with evictions observed,
    interactive p99 under batch p99, bit-identity spot-checked after
    the storm, no quarantine."""
    budget = int(PANEL_BYTES * 2.5)  # fits two of the three panels
    fleet = _build(fx, budget_mb=budget / 1e6,
                   cfg=ServeConfig(cache_entries=0)).start()
    rng = np.random.default_rng(13)
    pools = {
        name: random_genotypes(rng, n=24, v=V, missing_rate=0.1)
        for name in fx.routes
    }
    mix = []
    for name in fx.routes:
        mix.append((name, INTERACTIVE, 1))
        mix.append((name, BATCH, 2))
    try:
        report = run_fleet_loadgen(fleet, pools, mix,
                                   requests_per_client=8)
        assert report["errors"] == 0 and report["shed"] == 0
        assert report["completed"] == 9 * 8
        assert report["per_class"][INTERACTIVE]["p99_s"] > 0
        assert (report["per_class"][INTERACTIVE]["p99_s"]
                <= report["per_class"][BATCH]["p99_s"])
        assert fleet.pool.resident_bytes() <= budget
        assert telemetry.counter_value("fleet.evictions") > 0
        assert telemetry.counter_value("fleet.restage_total") > 0
        for route in fx.routes.values():
            q = pools[route.name][0]
            np.testing.assert_array_equal(
                fleet.project(route.name, q, timeout=60),
                _offline(route, q))
            assert qledger.load(route.store) == []
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_over_budget_route_serves_shard_staged_bitwise(fx):
    """A panel larger than the whole pool budget is served as a sequence
    of budget-sized shards (never kept warm): answers bitwise equal to
    the offline path, shards counted, the transient charge released."""
    budget = int(PANEL_BYTES * 0.5)  # two shards of the 2-block panel
    fleet = _build(fx, budget_mb=budget / 1e6,
                   cfg=ServeConfig(cache_entries=0)).start()
    rng = np.random.default_rng(15)
    route = fx.routes["r-ibs"]
    try:
        for _ in range(2):
            q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
            np.testing.assert_array_equal(
                fleet.project(route.name, q, timeout=60),
                _offline(route, q))
        assert telemetry.counter_value("fleet.shard_stages") == 4
        assert not fleet.pool.is_staged(route.name)
        assert fleet.pool.resident_bytes() == 0
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


# ------------------------------------------------------------ priority


def test_interactive_preempts_queued_batch(fx):
    """With the worker stalled, batch requests queued FIRST are
    overtaken by a later interactive request (completion order pinned
    via done-callbacks; serve.priority.preemptions counts it)."""
    fleet = _build(fx, cfg=ServeConfig(cache_entries=0,
                                       max_linger_ms=0.0)).start()
    rng = np.random.default_rng(17)
    route = next(iter(fx.routes))
    order: list[str] = []

    def tag(name):
        def cb(_fut):
            order.append(name)
        return cb

    try:
        qs = random_genotypes(rng, n=4, v=V, missing_rate=0.1)
        with faults.armed(["serve.request:delay:delay=0.25:max=1"]):
            stalled = fleet.submit(route, qs[0], priority=BATCH)
            stalled.add_done_callback(tag("b0"))
            time.sleep(0.05)  # the worker picks b0 up and stalls
            b1 = fleet.submit(route, qs[1], priority=BATCH)
            b1.add_done_callback(tag("b1"))
            b2 = fleet.submit(route, qs[2], priority=BATCH)
            b2.add_done_callback(tag("b2"))
            i0 = fleet.submit(route, qs[3], priority=INTERACTIVE)
            i0.add_done_callback(tag("i0"))
            for f in (stalled, b1, b2, i0):
                f.result(timeout=60)
        assert order.index("i0") < order.index("b1")
        assert order.index("i0") < order.index("b2")
        assert telemetry.counter_value("serve.priority.preemptions") >= 1
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_per_class_shed_thresholds(fx):
    """The batch queue sheds at its own bound while interactive keeps
    admitting — per-class counters prove which class was protected."""
    fleet = _build(fx, cfg=ServeConfig(
        cache_entries=0, max_linger_ms=0.0,
        queue_interactive=8, queue_batch=2)).start()
    rng = np.random.default_rng(19)
    route = next(iter(fx.routes))
    qs = random_genotypes(rng, n=12, v=V, missing_rate=0.1)
    futs, shed_batch = [], 0
    try:
        with faults.armed(["serve.request:delay:delay=0.1:max=1"]):
            futs.append(fleet.submit(route, qs[0], priority=BATCH))
            time.sleep(0.05)  # worker stalled on the first request
            for q in qs[1:8]:
                try:
                    futs.append(fleet.submit(route, q, priority=BATCH))
                except ServerOverloaded:
                    shed_batch += 1
            assert shed_batch > 0
            futs.append(fleet.submit(route, qs[8],
                                     priority=INTERACTIVE))
            for f in futs:
                f.result(timeout=60)
        assert telemetry.counter_value(
            "serve.priority.shed_batch") == shed_batch
        assert telemetry.counter_value(
            "serve.priority.shed_interactive") == 0
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_per_class_default_deadlines(fx):
    """ServeConfig's per-class deadlines apply by class: the batch
    default expires a queued batch request while the interactive one
    (no deadline) survives the same stall."""
    fleet = _build(fx, cfg=ServeConfig(
        cache_entries=0, max_linger_ms=0.0,
        deadline_batch_ms=60.0)).start()
    rng = np.random.default_rng(23)
    route = next(iter(fx.routes))
    qs = random_genotypes(rng, n=3, v=V, missing_rate=0.1)
    try:
        with faults.armed(["serve.request:delay:delay=0.25:max=1"]):
            stalled = fleet.submit(route, qs[0], priority=INTERACTIVE)
            time.sleep(0.05)
            doomed = fleet.submit(route, qs[1], priority=BATCH)
            safe = fleet.submit(route, qs[2], priority=INTERACTIVE)
            assert stalled.result(timeout=60).shape == (1, 3)
            assert safe.result(timeout=60).shape == (1, 3)
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=60)
        assert telemetry.counter_value("serve.deadline_expired") == 1
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_unknown_route_and_bad_priority(fx):
    fleet = _build(fx).start()
    try:
        q = np.zeros(V, np.int8)
        with pytest.raises(UnknownRoute, match="r-ibs"):
            fleet.submit("nope", q)
        with pytest.raises(ValueError, match="priority"):
            fleet.submit("r-ibs", q, priority="urgent")
        with pytest.raises(ValueError, match="dosage vector"):
            fleet.submit("r-ibs", np.zeros(7, np.int8))
        with pytest.raises(ValueError, match="'topk' capability"):
            fleet.submit("r-ibs", q, kind="topk", k=3)
    finally:
        fleet.close()


# ------------------------------------------- fleet.stage chaos + breaker


def test_fleet_stage_fault_feeds_breaker_then_recovers(fx):
    """Injected fleet.stage io_errors fail exactly the waiting requests
    (explicitly), feed the route's breaker to open (later requests fail
    fast with PanelUnavailable, health degrades), and the half-open
    probe re-stages bit-identically once the fault clears."""
    fleet = _build(fx, cfg=ServeConfig(cache_entries=0)).start()
    rng = np.random.default_rng(29)
    route = fx.routes["r-ibs"]
    now = [0.0]  # injected breaker clock
    fleet.routes[route.name].breaker = CircuitBreaker(
        trip_after=2, reset_s=10.0, clock=lambda: now[0])
    q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
    try:
        with faults.armed(["fleet.stage:io_error:max=0"]) as inj:
            for _ in range(2):
                with pytest.raises(faults.InjectedFault):
                    fleet.project(route.name, q, timeout=60)
            assert inj.fire_count("fleet.stage") == 2
            with pytest.raises(PanelUnavailable):
                fleet.project(route.name, q, timeout=60)
            assert inj.fire_count("fleet.stage") == 2
            assert fleet.health == "degraded"
        with pytest.raises(PanelUnavailable):
            fleet.project(route.name, q, timeout=60)
        other = fx.routes["r-pca"]
        np.testing.assert_array_equal(
            fleet.project(other.name, q, timeout=60),
            _offline(other, q))
        assert fleet.health == "degraded"
        now[0] = 10.1  # reset window -> half-open probe
        np.testing.assert_array_equal(
            fleet.project(route.name, q, timeout=60),
            _offline(route, q))
        assert fleet.routes[route.name].breaker.state == "closed"
        assert fleet.health == "healthy"
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_fleet_stage_delay_is_absorbed(fx):
    """A slow cold tier (fleet.stage delay) costs latency, never
    correctness."""
    fleet = _build(fx, cfg=ServeConfig(cache_entries=0)).start()
    rng = np.random.default_rng(31)
    route = fx.routes["r-jac"]
    q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
    try:
        with faults.armed(["fleet.stage:delay:delay=0.05:max=1"]):
            np.testing.assert_array_equal(
                fleet.project(route.name, q, timeout=60),
                _offline(route, q))
        assert fleet.drain(timeout=60)
    finally:
        fleet.close()


# ----------------------------------------- result-cache lifecycle


def test_route_unload_evicts_cache_namespace_bytes_flat(fx):
    """A load/serve/unload loop leaves the shared result cache's byte
    accounting exactly where it started — an unloaded route's namespace
    is evicted whole, not stranded in the LRU."""
    from spark_examples_tpu_torch.serve.fleet import RouteSpec, build_route

    fleet = _build(fx, cfg=ServeConfig(cache_entries=64)).start()
    rng = np.random.default_rng(37)
    extra = fx.routes["r-jac"]
    spec = RouteSpec(name="tenant-x", model=extra.model,
                     source=f"store:{extra.store}")
    try:
        fleet.unload_route("r-jac")
        q0 = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
        fleet.project("r-ibs", q0, timeout=60)
        baseline = fleet._cache.stats()
        assert baseline["bytes"] > 0
        for cycle in range(3):
            fleet.add_route(build_route(
                spec, IngestConfig(block_variants=BV,
                                   readahead_chunks=0), BV, device="cpu"))
            for _k in range(4):
                q = random_genotypes(rng, n=1, v=V,
                                     missing_rate=0.1)[0]
                fleet.project("tenant-x", q, timeout=60)
            grown = fleet._cache.stats()
            assert grown["bytes"] > baseline["bytes"]
            assert fleet.unload_route("tenant-x")
            after = fleet._cache.stats()
            assert after == baseline, f"cycle {cycle}: cache leaked"
        assert telemetry.counter_value(
            "fleet.cache_namespace_evictions") == 3 * 4
        before_hits = telemetry.counter_value("serve.cache_hits")
        fleet.project("r-ibs", q0, timeout=60)
        assert telemetry.counter_value("serve.cache_hits") \
            == before_hits + 1
    finally:
        fleet.close()


# ------------------------------------------------------------- hedging


def test_hedging_cuts_tail_on_delay_injected_replica(fx):
    """Two replicas over the SAME stores; the primary holds every batch
    for a long linger. The hedged run's p99 lands under the unhedged
    run's, hedges win, and nothing errors."""
    slow_cfg = ServeConfig(cache_entries=0, max_linger_ms=120.0)
    fast_cfg = ServeConfig(cache_entries=0, max_linger_ms=0.0)
    slow = _build(fx, cfg=slow_cfg).start()
    fast = _build(fx, cfg=fast_cfg).start()
    rng = np.random.default_rng(41)
    pool = random_genotypes(rng, n=32, v=V, missing_rate=0.1)
    route = "r-ibs"
    try:
        unhedged = run_hedged_loadgen(
            [slow, slow], pool, clients=2, requests_per_client=6,
            route=route, hedge_floor_s=10.0)
        assert unhedged["hedge_launched"] == 0
        assert unhedged["errors"] == 0
        hedged = run_hedged_loadgen(
            [slow, fast], pool, clients=2, requests_per_client=6,
            route=route, hedge_floor_s=0.02)
        assert hedged["errors"] == 0
        assert hedged["completed"] == 12
        assert hedged["hedge_launched"] > 0
        assert hedged["hedge_wins"] > 0
        assert hedged["hedge_win_frac"] > 0.5
        assert hedged["p99_s"] < unhedged["p99_s"]
        assert telemetry.counter_value("fleet.hedge_wins") \
            == hedged["hedge_wins"]
    finally:
        slow.close()
        fast.close()


def test_hedge_delay_and_burst_schedule_match_jax():
    """The seeded hedge-delay prior and the burst schedule's arrivals
    are the JAX package's for the same seed (numpy draws both)."""
    from spark_examples_tpu.serve import loadgen as jloadgen
    from spark_examples_tpu_torch.serve import loadgen

    ours, theirs = loadgen._HedgeDelay(0.01, seed=3), \
        jloadgen._HedgeDelay(0.01, seed=3)
    assert list(ours._ring) == list(theirs._ring)
    for x in (0.02, 0.005, 0.03):
        ours.record(x)
        theirs.record(x)
    assert ours.delay_s() == theirs.delay_s()
    kw = dict(duration_s=5.0, base_qps=20.0, seed=9, n_bursts=2)
    a = loadgen.BurstSchedule(**kw)
    b = jloadgen.BurstSchedule(**kw)
    assert a.bursts == b.bursts and a.arrivals() == b.arrivals()
    with pytest.raises(ValueError, match="burst_factor"):
        loadgen.BurstSchedule(1.0, 1.0, burst_factor=0.5)


# ------------------------------------------------------- pool semantics


def test_panel_pool_unit_semantics():
    """PanelPool in isolation: LRU order, budget eviction, restage
    accounting, oversize tolerance (warn, serve anyway), and remove()
    forgetting the staged-before history."""
    pool = PanelPool(1000)

    def stage(nbytes):
        return lambda: ([("blocks", None)], 64, nbytes)

    pool.acquire("a", stage(400))
    pool.acquire("b", stage(400))
    assert pool.resident_routes() == ["a", "b"]
    pool.acquire("a", lambda: (_ for _ in ()).throw(
        AssertionError("hit must not re-stage")))
    assert pool.resident_routes() == ["b", "a"]
    pool.acquire("c", stage(400))  # 1200 > 1000: evicts LRU ("b")
    assert pool.resident_routes() == ["a", "c"]
    assert telemetry.counter_value("fleet.evictions") == 1
    pool.acquire("b", stage(400))
    assert telemetry.counter_value("fleet.restage_total") == 1
    with pytest.warns(RuntimeWarning, match="exceed the pool budget"):
        pool.acquire("huge", stage(5000))
    assert pool.is_staged("huge")
    pool.remove("huge")
    with pytest.warns(RuntimeWarning, match="exceed the pool budget"):
        pool.acquire("huge", stage(5000))
    assert telemetry.counter_value("fleet.restage_total") == 1


def test_pool_stage_failure_leaves_pool_consistent():
    pool = PanelPool(1000)
    with pytest.raises(RuntimeError, match="boom"):
        pool.acquire("a", lambda: (_ for _ in ()).throw(
            RuntimeError("boom")))
    assert not pool.is_staged("a")
    assert pool.resident_bytes() == 0


def test_pool_rejects_nonpositive_budget_and_charges_host_bytes(fx):
    with pytest.raises(ValueError, match="must be positive"):
        PanelPool(0)
    fleet = _build(fx)
    try:
        fleet.warm_route("r-ibs")
        assert fleet.pool.resident_bytes() == PANEL_BYTES
        assert fleet.ready_info()["warmed_routes"] == ["r-ibs"]
    finally:
        fleet.close()


def test_route_on_another_device_is_refused(fx):
    from spark_examples_tpu_torch.serve.fleet import RouteSpec, build_route

    fleet = _build(fx)
    route = build_route(RouteSpec(name="x", model=fx.routes["r-ibs"].model,
                                  source=f"store:{fx.routes['r-ibs'].store}"),
                        IngestConfig(block_variants=BV), BV, device="cpu")
    route.ctx.device = torch.device("meta")  # not the router's device
    try:
        with pytest.raises(ValueError, match="router serves on cpu"):
            fleet.add_route(route)
    finally:
        fleet.close()


# ----------------------------------------------------- against JAX


def test_port_and_jax_fleets_agree_on_one_manifest(fx):
    """One manifest served by both packages' FleetRouter: the
    padded-batch int32 cross accumulators of every route bitwise
    equal, the served coordinates within 1e-5 of max|coords|, the
    topk route's neighbor ids equal."""
    fleet = _build(fx, topk=("r-ibs",), cfg=ServeConfig(cache_entries=0))
    jfleet = _jbuild(fx, topk=("r-ibs",),
                     cfg=jconfig.ServeConfig(cache_entries=0))
    rng = np.random.default_rng(51)
    queries = random_genotypes(rng, n=3, v=V, missing_rate=0.1)
    try:
        for name, route in fleet.routes.items():
            panel = fleet.pool.acquire(name, route.stage)
            jroute = jfleet.routes[name]
            jpanel = jfleet.pool.acquire(name, jroute.stage)
            g, _b = E._padded_batch(queries, fleet.max_batch, V)
            acc, _ = E._cross_batch(route.ctx, panel.blocks, g,
                                    route.ctx.stats)
            jacc = {k: jnp.zeros((fleet.max_batch, N), jnp.int32)
                    for k in route.ctx.stats}
            for ref_dev, meta in jpanel.blocks:
                jacc = jproject._update_cross(
                    jacc, jnp.asarray(g[:, meta.start:meta.stop]), ref_dev)
            for k in route.ctx.stats:
                np.testing.assert_array_equal(acc[k].numpy(),
                                              np.asarray(jacc[k]))
        fleet.start()
        jfleet.start()
        for name in fleet.routes:
            for q in queries:
                got = fleet.project(name, q, timeout=60)
                want = jfleet.project(name, q, timeout=60)
                assert got.shape == want.shape
                assert np.abs(got - want).max() <= \
                    1e-5 * np.abs(want).max()
        for q in queries:
            ids, sims = fleet.topk("r-ibs", q, 5, timeout=60)
            jids, jsims = jfleet.topk("r-ibs", q, 5, timeout=60)
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_array_equal(sims, jsims)
    finally:
        fleet.close()
        jfleet.close()


def test_same_budget_and_requests_evict_like_jax(fx):
    """One budget (1.5 panels) and one request sequence through both
    packages' fleets: the same evictions and re-stages, in the same
    resident order after every request (both charge the host blocks'
    bytes)."""
    budget = int(PANEL_BYTES * 1.5)
    fleet = _build(fx, budget_mb=budget / 1e6,
                   cfg=ServeConfig(cache_entries=0)).start()
    jfleet = _jbuild(fx, budget_mb=budget / 1e6,
                     cfg=jconfig.ServeConfig(cache_entries=0)).start()
    rng = np.random.default_rng(53)
    names = ["r-ibs", "r-pca", "r-ibs", "r-jac", "r-jac", "r-pca", "r-ibs"]
    try:
        for name in names:
            q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
            fleet.project(name, q, timeout=60)
            jfleet.project(name, q, timeout=60)
            assert fleet.pool.resident_routes() == \
                jfleet.pool.resident_routes()
            assert fleet.pool.resident_bytes() == \
                jfleet.pool.resident_bytes()
        for counter in ("fleet.evictions", "fleet.restage_total"):
            assert telemetry.counter_value(counter) == \
                jtelemetry.counter_value(counter) > 0
    finally:
        fleet.close()
        jfleet.close()


# ------------------------------------------------------------ HTTP front


def _post(url: str, payload: dict, headers=None, timeout: float = 60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), resp.headers


def _get(url: str, timeout: float = 30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def test_fleet_http_front(fx):
    from spark_examples_tpu_torch.serve.http import start_fleet_http_server

    fleet = _build(fx, topk=("r-ibs",)).start()
    http = start_fleet_http_server(fleet, port=0)
    base = f"http://127.0.0.1:{http.port}"
    rng = np.random.default_rng(43)
    q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
    body = [int(x) for x in q]
    try:
        out, _h = _post(f"{base}/project", {
            "route": "r-ibs", "priority": BATCH, "genotypes": body})
        np.testing.assert_array_equal(
            np.asarray(out["coords"], np.float32),
            _offline(fx.routes["r-ibs"], q).astype(np.float32))
        out2, _h = _post(f"{base}/project/r-pca", {"genotypes": body})
        np.testing.assert_array_equal(
            np.asarray(out2["coords"], np.float32),
            _offline(fx.routes["r-pca"], q).astype(np.float32))
        nb, _h = _post(f"{base}/neighbors/r-ibs", {"genotypes": body,
                                                   "k": 4})
        ids, sims = fleet.topk("r-ibs", q, 4, timeout=60)
        assert nb["neighbor_indices"] == ids.tolist()
        assert nb["similarities"] == sims.tolist()
        assert nb["k"] == 4 and len(nb["neighbor_ids"][0]) == 4
        health = json.loads(_get(f"{base}/healthz"))
        assert health["status"] == "healthy"
        assert set(health["routes"]) == set(fx.routes)
        routes = json.loads(_get(f"{base}/routes"))
        assert routes["r-ibs"]["completed"] >= 1
        assert routes["r-ibs"]["staged"] is True
        assert json.loads(_get(f"{base}/warm/r-jac")) == {"warmed": "r-jac"}
        ready = json.loads(_get(f"{base}/readyz"))
        assert ready["ready"] and ready["warmed_routes"] == ["r-jac"]
        stats = json.loads(_get(f"{base}/stats"))
        assert stats["pool"]["resident_bytes"] > 0
        assert stats["result_cache"]["entries"] >= 1
        prom = _get(f"{base}/metrics").decode()
        for series in ("fleet_routes", "fleet_pool_bytes",
                       "fleet_route_r_ibs_queue_depth",
                       "fleet_route_r_ibs_p99_s",
                       "serve_priority_depth_interactive"):
            assert series in prom
        for path, payload, code in (
                ("/project", {"route": "nope", "genotypes": [0] * V}, 404),
                ("/project", {"genotypes": [0] * V}, 400),
                ("/neighbors/r-pca", {"genotypes": [0] * V}, 400),
                ("/nope", {"genotypes": [0] * V}, 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base + path, payload)
            assert err.value.code == code, path
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{base}/warm/nope")
        assert err.value.code == 404
    finally:
        http.shutdown()
        fleet.close()


def test_http_front_trace_surfaces(fx, tmp_path):
    """The fleet HTTP front echoes the client's X-Trace-Id (or mints
    one), stamps X-Run-Id and a Server-Timing phase breakdown on every
    response, and serves the slowest-K exemplar ring at GET
    /debug/requests."""
    from spark_examples_tpu_torch.serve.http import start_fleet_http_server

    telemetry.configure(dir=str(tmp_path / "tel"), trace_events=True)
    sample0 = telemetry.trace_sample()
    telemetry.set_trace_sample(1.0)
    fleet = _build(fx).start()
    http = start_fleet_http_server(fleet, port=0)
    base = f"http://127.0.0.1:{http.port}"
    rng = np.random.default_rng(47)
    q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
    body = {"genotypes": [int(x) for x in q]}
    try:
        _out, hdrs = _post(f"{base}/project/r-ibs", body,
                           headers={"X-Trace-Id": "client-chosen-trace-01"})
        assert hdrs["X-Trace-Id"] == "client-chosen-trace-01"
        assert hdrs["X-Run-Id"] == telemetry.run_id()
        timing = hdrs["Server-Timing"]
        assert "total;dur=" in timing
        assert "compute;dur=" in timing
        _out, hdrs2 = _post(f"{base}/project/r-ibs", body)
        minted = hdrs2["X-Trace-Id"]
        assert len(minted) == 16 and int(minted, 16) >= 0
        dbg = json.loads(_get(f"{base}/debug/requests"))
        assert dbg["trace_sample"] == 1.0
        by_tid = {e["trace_id"]: e for e in dbg["exemplars"]}
        ex = by_tid["client-chosen-trace-01"]
        assert ex["route"] == "r-ibs" and ex["status"] == 200
        assert "total" in ex["phases"] and "compute" in ex["phases"]
        assert telemetry.metrics_snapshot()[
            "histograms"]["trace.request"]["count"] >= 2
    finally:
        telemetry.set_trace_sample(sample0)
        http.shutdown()
        fleet.close()


def test_hedged_legs_share_one_trace_id(fx, tmp_path):
    """Both legs of a hedged request carry ONE trace_id with distinct
    span ids — the waterfall key that joins the client's trace.hedge
    attribution event to the server-side queue/compute spans."""
    telemetry.configure(dir=str(tmp_path / "tel"), trace_events=True)
    sample0 = telemetry.trace_sample()
    telemetry.set_trace_sample(1.0)
    slow = _build(fx, cfg=ServeConfig(cache_entries=0,
                                      max_linger_ms=120.0)).start()
    fast = _build(fx, cfg=ServeConfig(cache_entries=0,
                                      max_linger_ms=0.0)).start()
    rng = np.random.default_rng(48)
    pool = random_genotypes(rng, n=16, v=V, missing_rate=0.1)
    try:
        report = run_hedged_loadgen(
            [slow, fast], pool, clients=2, requests_per_client=6,
            route="r-ibs", hedge_floor_s=0.02)
        assert report["errors"] == 0 and report["hedge_launched"] > 0
        evs = telemetry.recent_events()
        hedge_tids = {e["args"]["trace_id"] for e in evs
                      if e["name"] == "trace.hedge"}
        assert hedge_tids
        span_ids = {}
        for e in evs:
            if e["name"] in ("trace.queue", "trace.compute"):
                span_ids.setdefault(
                    e["args"]["trace_id"], set()).add(
                        e["args"]["span_id"])
        assert hedge_tids & set(span_ids)
        tid = telemetry.new_trace_id()
        legs = []
        for _ in range(2):
            tr = {"trace_id": tid, "span_id": telemetry.new_span_id(),
                  "sampled": True, "phases": {}}
            legs.append((tr, fast.submit(
                "r-ibs", pool[0], priority=INTERACTIVE, trace=tr)))
        for _tr, fut in legs:
            fut.result(timeout=60.0)
        spans = [e for e in telemetry.recent_events()
                 if e["name"] == "trace.compute"
                 and e["args"]["trace_id"] == tid]
        assert {e["args"]["span_id"] for e in spans} == \
            {tr["span_id"] for tr, _f in legs}
        assert report["error_records"] == []
    finally:
        telemetry.set_trace_sample(sample0)
        slow.close()
        fast.close()


# ------------------------------------------------------------------ CLI


def test_serve_fleet_cli_loadgen(fx, tmp_path, capsys):
    """`serve --fleet manifest.json --loadgen N` end to end: the
    multi-tenant report (interactive + batch clients per route) prints
    as JSON with per-class percentiles and fleet stats."""
    from spark_examples_tpu_torch.cli.main import main

    manifest_path = tmp_path / "fleet.json"
    manifest_path.write_text(json.dumps(_manifest_doc(fx, budget_mb=1.0)))
    rc = main([
        "serve", "--fleet", str(manifest_path), "--device", "cpu",
        "--source", "synthetic", "--n-samples", "4",
        "--block-variants", str(BV), "--readahead-chunks", "0",
        "--max-batch", "4", "--max-linger-ms", "1",
        "--loadgen", "1", "--loadgen-requests", "4",
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["completed"] == 24 and report["errors"] == 0
    assert set(report["per_class"]) == set(PRIORITY_CLASSES)
    assert set(report["per_route"]) == set(fx.routes)
    assert report["stats"]["pool"]["resident_bytes"] > 0


def test_serve_cli_fleet_and_model_are_exclusive(fx, tmp_path, capsys):
    from spark_examples_tpu_torch.cli.main import main

    manifest_path = tmp_path / "fleet.json"
    manifest_path.write_text(json.dumps(_manifest_doc(fx)))
    with pytest.raises(SystemExit):
        main(["serve", "--device", "cpu", "--fleet", str(manifest_path),
              "--model", "m.npz"])
    assert "mutually exclusive" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["serve", "--device", "cpu"])
    assert "--fleet fleet.json" in capsys.readouterr().err
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"routes": []}))
    with pytest.raises(SystemExit):
        main(["serve", "--device", "cpu", "--fleet", str(bad)])
    assert "'routes' must be a non-empty" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["serve", "--device", "cpu", "--fleet", str(manifest_path),
              "--queue-batch", "0"])
    assert "--queue-batch=0" in capsys.readouterr().err


def test_serve_fleet_cli_on_cuda_without_a_card_raises(fx, tmp_path,
                                                       monkeypatch):
    from spark_examples_tpu_torch.cli.main import main

    manifest_path = tmp_path / "fleet.json"
    manifest_path.write_text(json.dumps(_manifest_doc(fx)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        main(["serve", "--fleet", str(manifest_path), "--loadgen", "1"])


def test_serve_fleet_cli_over_http_drains_on_sigterm(fx, tmp_path):
    """``serve --fleet`` as a process: the port file, one POST per
    route equal to the in-process router's answer, ``/metrics`` with
    the pool gauge, SIGTERM, a clean exit."""
    manifest_path = tmp_path / "fleet.json"
    manifest_path.write_text(json.dumps(
        _manifest_doc(fx, topk=("r-ibs",), budget_mb=1.0)))
    port_file = tmp_path / "port.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch", "serve",
         "--device", "cpu", "--fleet", str(manifest_path),
         "--block-variants", str(BV), "--readahead-chunks", "0",
         "--port", "0", "--port-file", str(port_file)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    fleet = _build(fx, topk=("r-ibs",)).start()
    try:
        deadline = time.time() + 120
        while not port_file.exists():
            assert proc.poll() is None, proc.communicate(timeout=30)
            assert time.time() < deadline, "server never bound"
            time.sleep(0.05)
        base = f"http://127.0.0.1:{json.loads(port_file.read_text())['port']}"
        rng = np.random.default_rng(59)
        q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
        body = {"genotypes": [int(x) for x in q]}
        for name in fx.routes:
            out, _h = _post(f"{base}/project/{name}", body)
            np.testing.assert_array_equal(
                np.asarray(out["coords"], np.float32),
                fleet.project(name, q, timeout=60))
        nb, _h = _post(f"{base}/neighbors/r-ibs", {**body, "k": 3})
        ids, _sims = fleet.topk("r-ibs", q, 3, timeout=60)
        assert nb["neighbor_indices"] == ids.tolist()
        assert "fleet_pool_bytes" in _get(f"{base}/metrics").decode()
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
    finally:
        fleet.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "draining..." in err and "serving fleet of 3 route(s)" in err


def test_fleet_config_fields_match_jax():
    """The fleet's ServeConfig fields, defaults and refusals are the JAX
    package's."""
    ours = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jconfig.ServeConfig)}
    assert ours == theirs
    assert PRIORITY_CLASSES == jconfig.PRIORITY_CLASSES
    for bad in ({"fleet_budget_mb": 0.0}, {"queue_interactive": 0},
                {"deadline_batch_ms": -1.0}, {"loadgen_seed": 1.5}):
        with pytest.raises(ValueError) as err:
            ServeConfig(**bad)
        with pytest.raises(ValueError) as jerr:
            jconfig.ServeConfig(**bad)
        assert str(err.value) == str(jerr.value)
