"""The fleet control plane of the port (``fleet/``) against the JAX
package's, on the CPU.

The cases of tests/test_controller.py, ported: warm-panel bin packing,
the two snapshot transports, the controller's failure matrix (crash,
hang, stale scrape) with bounded-backoff respawn and the flap breaker,
autoscale with its floor and ceiling, graceful preemption, the atomic
``controller.json`` ledger and its rotation, the two fault sites, the
readiness surfaces and the zero-admitted-requests-lost contract across
a replica kill and a drain. Then the cross-package parity:

- the same scripted replica snapshots, fed round by round with an
  injected clock through JAX's ``FleetController`` and the port's, give
  the same decisions and incidents (round, action or kind, who, detail,
  in order) and the same placement and slot states;
- ``pack`` and ``parse_prometheus`` give the same results on the same
  input, and ``snapshot_from_prometheus`` reads the port's real
  ``/metrics`` text;
- ``ProcessReplica`` plumbing, one real crash and respawn of a
  ``--device cpu`` serve child, and a ``--device cuda`` child on a host
  without a card, which ends in ``spawn_failure`` and a parked slot,
  never in a CPU replica.
"""

import dataclasses
import json
import os
import sys
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import spark_examples_tpu.fleet as jfleet
from spark_examples_tpu.core import faults as jfaults
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu.fleet import slo as jslo
from spark_examples_tpu.fleet.placement import pack as jpack
from spark_examples_tpu.fleet.replica import (
    parse_prometheus as jparse_prometheus,
)
from spark_examples_tpu.fleet.replica import (
    snapshot_from_stats as jsnapshot_from_stats,
)
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import (
    PRIORITY_CLASSES,
    ComputeConfig,
    IngestConfig,
    JobConfig,
    ServeConfig,
)
from spark_examples_tpu_torch.fleet import (
    ControllerConfig,
    FleetController,
    LocalReplica,
    ProcessReplica,
    Replica,
    ReplicaSnapshot,
    ScrapeError,
    pack,
    parse_prometheus,
    serve_child_command,
)
from spark_examples_tpu_torch.fleet import slo as tslo
from spark_examples_tpu_torch.fleet.controller import LEDGER_KEEP
from spark_examples_tpu_torch.fleet.placement import (
    Placement,
    rebalance_needed,
)
from spark_examples_tpu_torch.fleet.replica import (
    snapshot_from_prometheus,
    snapshot_from_stats,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job, variants_pca_job
from spark_examples_tpu_torch.pipelines.project import pcoa_project_job
from spark_examples_tpu_torch.serve import (
    DRAINING,
    BurstSchedule,
    FleetManifest,
    ProjectionEngine,
    ProjectionServer,
    ServerClosed,
    build_fleet,
    run_hedged_loadgen,
)
from spark_examples_tpu_torch.serve.loadgen import _HedgeDelay

from conftest import random_genotypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BV = 128
N, V = 12, 256
PANEL_BYTES = N * V
INTERACTIVE, BATCH = PRIORITY_CLASSES

# The two packages side by side, for the harness.
PORT = SimpleNamespace(
    FleetController=FleetController, ControllerConfig=ControllerConfig,
    Replica=Replica, ReplicaSnapshot=ReplicaSnapshot,
    ScrapeError=ScrapeError, SLOSpec=tslo.SLOSpec, faults=faults,
    telemetry=telemetry)
JAX = SimpleNamespace(
    FleetController=jfleet.FleetController,
    ControllerConfig=jfleet.ControllerConfig, Replica=jfleet.Replica,
    ReplicaSnapshot=jfleet.ReplicaSnapshot, ScrapeError=jfleet.ScrapeError,
    SLOSpec=jslo.SLOSpec, faults=jfaults, telemetry=jtelemetry)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for t in (telemetry, jtelemetry):
        t.reset()
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(dir=None)


# ---------------------------------------------------------- placement


def test_pack_first_fit_decreasing_and_lookups():
    p = pack({"big": 70, "mid": 40, "small": 20},
             {"r0": 100, "r1": 60})
    assert p.assignments["r0"] == ("big", "small")
    assert p.assignments["r1"] == ("mid",)
    assert p.overflow == ()
    assert p.replica_for("mid") == "r1"
    assert p.replica_for("nope") is None
    assert p.routes_for("r0") == ("big", "small")
    assert p.routes_for("ghost") == ()


def test_pack_overflow_and_determinism():
    p = pack({"a": 80, "b": 80, "c": 80}, {"r0": 100, "r1": 100})
    assert p.overflow == ("c",)  # equal sizes tie-break by name
    assert pack({"a": 80, "b": 80, "c": 80},
                {"r0": 100, "r1": 100}) == p
    q = pack({"z": -5}, {"r0": 0})
    assert q.assignments["r0"] == ("z",)


def test_rebalance_needed_tracks_membership_and_growth():
    panels = {"a": 60, "b": 30}
    budgets = {"r0": 100}
    current = pack(panels, budgets)
    assert not rebalance_needed(current, panels, budgets)
    assert rebalance_needed(current, panels, {"r0": 100, "r1": 100})
    assert rebalance_needed(current, {"a": 60, "b": 50}, {"r0": 100})
    assert rebalance_needed(Placement(), panels, budgets)


@pytest.mark.parametrize("seed", range(6))
def test_pack_equals_jax_s_on_random_inputs(seed):
    """Seeded random panels and budgets (ties included): the same
    assignments, in the same packed order, and the same overflow."""
    rng = np.random.default_rng(seed)
    panels = {f"route-{i}": int(rng.integers(-5, 400))
              for i in range(int(rng.integers(1, 12)))}
    budgets = {f"replica-{i}": int(rng.integers(0, 700))
               for i in range(int(rng.integers(1, 5)))}
    got, want = pack(panels, budgets), jpack(panels, budgets)
    assert got.assignments == want.assignments
    assert got.overflow == want.overflow


# ----------------------------------------------------------- snapshots


def _stats_payload(qi=0, qb=0, in_flight=0, p99_ms=12.0, admitted=9,
                   shed=1):
    return {
        "health": {"status": "healthy", "worker_alive": True,
                   "in_flight": in_flight},
        "queues": {INTERACTIVE: qi, BATCH: qb},
        "pool": {"budget_bytes": 1000, "resident_bytes": 700,
                 "pressure": 0.7, "staged_routes": ["ibs"]},
        "routes": {
            "ibs": {
                "staged": True, "queue_depth": qi,
                "admitted": admitted, "shed": shed,
                "latency_ms": {
                    INTERACTIVE: {"p99": p99_ms},
                    BATCH: {"p99": p99_ms / 2},
                },
            },
        },
    }


def test_snapshot_from_stats_maps_the_autoscale_signals():
    snap = snapshot_from_stats(_stats_payload(qi=5, qb=2, in_flight=1),
                               t=3.0, ready=True)
    assert snap.ready and snap.worker_alive
    assert snap.queue_interactive == 5 and snap.queue_batch == 2
    assert snap.in_flight == 1
    assert snap.p99_s == pytest.approx(0.012)
    assert snap.shed_rate == pytest.approx(0.1)
    assert snap.pool_bytes == 700.0
    assert snap.pool_pressure == pytest.approx(0.7)
    assert snap.routes["ibs"]["staged"] is True
    assert not snap.idle and not snap.stale
    stale = snap.as_stale()
    assert stale.stale and stale.queue_interactive == 5
    idle = snapshot_from_stats(_stats_payload(qi=0, qb=0, in_flight=0),
                               t=4.0, ready=True)
    assert idle.idle
    # Field for field the JAX package's snapshot of the same payload.
    want = jsnapshot_from_stats(_stats_payload(qi=5, qb=2, in_flight=1),
                                t=3.0, ready=True)
    assert dataclasses.asdict(snap) == dataclasses.asdict(want)


def test_parse_prometheus_skips_garbage_lines():
    text = ("# HELP x y\n"
            "# TYPE x gauge\n"
            "fleet_pool_bytes 700\n"
            "serve_in_flight 2\n"
            "not-a-number-line abc\n"
            "  \n"
            "loneword\n"
            "fleet_route_r_ibs_p99_s 0.034\n"
            'labelled{route="a"} 3\n')
    flat = parse_prometheus(text)
    assert flat == {"fleet_pool_bytes": 700.0, "serve_in_flight": 2.0,
                    "fleet_route_r_ibs_p99_s": 0.034,
                    'labelled{route="a"}': 3.0}
    assert flat == jparse_prometheus(text)


def test_snapshot_from_prometheus_unmangles_route_series():
    flat = {
        "serve_in_flight": 1.0,
        "serve_priority_depth_interactive": 4.0,
        "serve_priority_depth_batch": 7.0,
        "fleet_pool_bytes": 600.0,
        "fleet_pool_pressure": 0.6,
        "fleet_route_r_ibs_p99_s": 0.05,
        "fleet_route_r_ibs_shed_rate": 0.25,
        "fleet_route_r_ibs_staged": 1.0,
        "fleet_route_r_ibs_queue_depth": 3.0,
    }
    snap = snapshot_from_prometheus(flat, ["r-ibs"], t=1.0, ready=True)
    assert snap.queue_interactive == 4 and snap.queue_batch == 7
    assert snap.p99_s == pytest.approx(0.05)
    assert snap.shed_rate == pytest.approx(0.25)
    assert snap.routes["r-ibs"]["staged"] is True
    assert snap.routes["r-ibs"]["queue_depth"] == 3
    assert snap.pool_bytes == 600.0


# ------------------------------------------------------ config contract


def test_controller_config_validation_names_the_knob():
    for kw, match in ((dict(min_replicas=4, max_replicas=2), "max_replicas"),
                      (dict(interval_s=0.0), "interval_s"),
                      (dict(backoff_initial_s=2.0, backoff_max_s=1.0),
                       "backoff_max_s"),
                      (dict(drain_timeout_s=0.0), "--drain-timeout-s"),
                      (dict(stale_scrapes=True), "stale_scrapes"),
                      (dict(slos=("p99",)), "fleet.slo.SLOSpec")):
        with pytest.raises(ValueError, match=match) as got:
            ControllerConfig(**kw)
        with pytest.raises(ValueError) as want:
            jfleet.ControllerConfig(**kw)
        assert str(got.value) == str(want.value)
    assert dataclasses.asdict(ControllerConfig()) == dataclasses.asdict(
        jfleet.ControllerConfig())


def test_serve_config_drain_and_seed_flags_validated():
    cfg = ServeConfig(drain_timeout_s=5.0, loadgen_seed=42)
    assert cfg.drain_timeout_s == 5.0 and cfg.loadgen_seed == 42
    with pytest.raises(ValueError, match="--drain-timeout-s"):
        ServeConfig(drain_timeout_s=0.0)
    with pytest.raises(ValueError, match="--loadgen-seed"):
        ServeConfig(loadgen_seed=-1)
    with pytest.raises(ValueError, match="--loadgen-seed"):
        ServeConfig(loadgen_seed=1.5)


# --------------------------------------------- the controller, faked out


def _fake_replica_class(pkg):
    """A scriptable replica of ``pkg``'s handle contract: the
    controller's failure matrix without engines, sockets or clocks."""

    def snap(ready=True, qi=0, qb=0, in_flight=0, p99=0.0, shed=0.0,
             route=None):
        return pkg.ReplicaSnapshot(
            t=0.0, ready=ready, health="healthy", worker_alive=True,
            in_flight=in_flight, queue_interactive=qi, queue_batch=qb,
            p99_s=p99, shed_rate=shed, pool_bytes=0.0, pool_pressure=0.0,
            routes=({} if route is None else
                    {route: {"p99_s": p99, "queue_depth": 0,
                             "shed_rate": shed, "staged": True}}))

    class FakeReplica(pkg.Replica):
        def __init__(self, name, generation=0, budget_bytes=1000):
            self.name = name
            self.generation = generation
            self.budget_bytes = budget_bytes
            self.warm_routes = ()
            self.snap = snap()
            self.scrape_exc = None
            self.warm_exc = None
            self.hb_age = None
            self.dead = False
            self.killed = False
            self.drain_calls = []
            self.drain_clean = True
            self.warm_calls = []

        def start(self):
            return self

        def alive(self):
            return not self.dead and not self.killed

        def heartbeat_age_s(self):
            return self.hb_age

        def ready(self):
            return self.snap.ready

        def scrape(self):
            if self.scrape_exc is not None:
                raise self.scrape_exc
            return self.snap

        def warm(self, routes):
            if self.warm_exc is not None:
                raise self.warm_exc
            self.warm_routes = tuple(routes)
            self.warm_calls.append(tuple(routes))

        def drain(self, timeout_s):
            self.drain_calls.append(timeout_s)
            self.dead = True
            return self.drain_clean

        def kill(self):
            self.killed = True

    return FakeReplica, snap


class Harness:
    """Controller + injected clock + scripted factory, for either
    package."""

    def __init__(self, ledger=None, pkg=PORT, slos=None, **cfg_kw):
        self.pkg = pkg
        self.Fake, self.snap = _fake_replica_class(pkg)
        self.clk = [0.0]
        self.made = []
        self.fail_spawns = 0
        self.warm_fail_next = False
        defaults = dict(
            min_replicas=2, max_replicas=3, idle_rounds=10_000,
            pressure_rounds=2, stale_scrapes=2, hang_heartbeat_s=5.0,
            backoff_initial_s=0.5, backoff_max_s=4.0,
            flap_window_s=100.0, flap_max_respawns=3,
            drain_timeout_s=7.0, ledger_path=ledger,
        )
        defaults.update(cfg_kw)
        if slos:
            defaults["slos"] = tuple(pkg.SLOSpec(**s) for s in slos)
        # Budgets fit exactly one route per replica: a -> slot 0,
        # b -> slot 1 (FFD with 1000-byte budgets).
        self.ctrl = pkg.FleetController(
            self._factory, {"a": 600, "b": 500},
            pkg.ControllerConfig(**defaults), clock=lambda: self.clk[0])

    def _factory(self, name, generation):
        if self.fail_spawns > 0:
            self.fail_spawns -= 1
            raise RuntimeError("spawn denied by harness")
        r = self.Fake(name, generation)
        if self.warm_fail_next:
            self.warm_fail_next = False
            r.warm_exc = RuntimeError("warm denied by harness")
        self.made.append(r)
        return r

    def current(self, slot):
        return [r for r in self.made if r.name == f"replica-{slot}"][-1]

    def tick(self, dt=1.0):
        self.clk[0] += dt
        return self.ctrl.step()


def test_bootstrap_spawns_min_replicas_with_placement(tmp_path):
    ledger = str(tmp_path / "controller.json")
    h = Harness(ledger=ledger)
    h.ctrl.start()
    assert len(h.ctrl.replicas()) == 2
    assert h.made[0].warm_routes == ("a",)
    assert h.made[1].warm_routes == ("b",)
    with open(ledger) as f:
        led = json.load(f)
    assert [s["state"] for s in led["slots"]] == ["up", "up"]
    h.ctrl.close()
    with open(ledger) as f:
        led = json.load(f)
    assert [s["state"] for s in led["slots"]] == ["retired", "retired"]
    assert h.made[0].drain_calls == [7.0]


def test_crash_backs_off_then_respawns():
    h = Harness()
    h.ctrl.start()
    h.made[0].dead = True
    h.tick()
    desc = h.ctrl.describe()
    assert desc["slots"][0]["state"] == "backoff"
    assert any(x["kind"] == "crash" for x in desc["incidents"])
    assert len(h.ctrl.replicas()) == 1
    h.tick(0.1)
    assert h.ctrl.describe()["slots"][0]["state"] == "backoff"
    h.tick(0.5)
    assert h.ctrl.describe()["slots"][0]["state"] == "up"
    assert len(h.ctrl.replicas()) == 2
    assert h.made[-1].generation == 1
    assert h.made[-1].warm_routes == ("a",)
    assert telemetry.counter_value("controller.respawns") == 1
    assert any(d["action"] == "respawn" for d in
               h.ctrl.describe()["decisions"])


def test_hang_is_killed_then_respawned():
    h = Harness()
    h.ctrl.start()
    h.made[1].hb_age = 9.0
    h.tick()
    assert h.made[1].killed
    desc = h.ctrl.describe()
    assert desc["slots"][1]["state"] == "backoff"
    assert any(x["kind"] == "hang" for x in desc["incidents"])
    h.tick(1.0)
    assert len(h.ctrl.replicas()) == 2


def test_stale_scrape_serves_last_good_then_declares_lost():
    h = Harness()
    h.ctrl.start()
    h.made[0].snap = h.snap(qi=3)
    h.tick()
    h.made[0].scrape_exc = ScrapeError("blackholed /metrics")
    h.tick()
    desc = h.ctrl.describe()
    assert desc["slots"][0]["state"] == "up"
    assert desc["slots"][0]["stale"] is True
    assert telemetry.counter_value("controller.scrape_stale") == 1
    h.tick()
    desc = h.ctrl.describe()
    assert desc["slots"][0]["state"] == "backoff"
    assert h.made[0].killed
    assert any(x["kind"] == "stale" for x in desc["incidents"])
    assert telemetry.counter_value("controller.scrapes") >= 1


def test_startup_grace_tolerates_unscrapable_fresh_replica():
    h = Harness(startup_grace_s=10.0)
    h.ctrl.start()
    for r in h.made:
        r.scrape_exc = ScrapeError("connection refused")
    h.tick()
    h.tick()
    desc = h.ctrl.describe()
    assert desc["slots"][0]["state"] == "up"
    assert not h.made[0].killed
    assert telemetry.counter_value("controller.scrape_stale") >= 2
    h.made[0].scrape_exc = None
    h.tick()
    assert h.ctrl.describe()["slots"][0]["stale"] is False
    h.tick(11.0)
    desc = h.ctrl.describe()
    assert desc["slots"][1]["state"] == "backoff"
    assert h.made[1].killed
    assert any(x["kind"] == "stale" for x in desc["incidents"])
    with pytest.raises(ValueError, match="startup_grace_s"):
        ControllerConfig(startup_grace_s=-1.0)


def test_flap_breaker_parks_a_dying_slot_and_resets():
    h = Harness(backoff_initial_s=0.0, flap_max_respawns=3,
                flap_window_s=1000.0)
    h.ctrl.start()
    for _ in range(10):
        if h.ctrl.describe()["slots"][0]["state"] == "parked":
            break
        for r in h.made:
            if r.name == "replica-0":
                r.dead = True
        h.tick()
    desc = h.ctrl.describe()
    assert desc["slots"][0]["state"] == "parked"
    assert any(x["kind"] == "flap_breaker" for x in desc["incidents"])
    assert telemetry._gauges["controller.flap_breaker_open"]["last"] == 1.0
    made_before = len(h.made)
    h.tick()
    h.tick()
    assert len(h.made) == made_before
    assert h.ctrl.reset_flap_breaker("replica-0") is True
    assert h.ctrl.reset_flap_breaker("replica-0") is False
    h.tick()
    assert h.ctrl.describe()["slots"][0]["state"] == "up"
    assert len(h.ctrl.replicas()) == 2


def test_scale_up_needs_sustained_pressure_and_respects_ceiling():
    h = Harness()
    h.ctrl.start()
    for r in h.made:
        r.snap = h.snap(qi=10)
    h.tick()
    assert len(h.ctrl.replicas()) == 2
    h.tick()
    assert len(h.ctrl.replicas()) == 3
    assert telemetry.counter_value("controller.scale_ups") == 1
    assert any(d["action"] == "scale_up"
               for d in h.ctrl.describe()["decisions"])
    for r in h.made:
        r.snap = h.snap(qi=10)
    h.tick()
    h.tick()
    h.tick()
    assert len(h.ctrl.replicas()) == 3


def test_idle_retire_drains_lifo_down_to_the_floor():
    h = Harness(min_replicas=1, max_replicas=2, pressure_rounds=1,
                idle_rounds=2)
    h.ctrl.start()
    h.made[0].snap = h.snap(qi=10)
    h.tick()
    assert len(h.ctrl.replicas()) == 2
    for r in h.made:
        r.snap = h.snap(qi=0)
    h.tick()
    assert len(h.ctrl.replicas()) == 2
    h.tick()
    assert len(h.ctrl.replicas()) == 1
    retired = h.ctrl.describe()["slots"][1]
    assert retired["state"] == "retired"
    assert h.made[-1].drain_calls == [7.0]
    assert telemetry.counter_value("controller.retires") == 1
    for _ in range(5):
        h.tick()
    assert len(h.ctrl.replicas()) == 1


def test_preempt_drains_within_budget_and_respawns_immediately():
    h = Harness()
    h.ctrl.start()
    victim = h.made[0]
    assert h.ctrl.preempt("replica-0") is True
    assert victim.drain_calls == [7.0]
    assert len(h.ctrl.replicas()) == 2
    assert h.ctrl.describe()["slots"][0]["state"] == "up"
    assert h.made[-1].generation == 1
    assert telemetry.counter_value("controller.preemptions") == 1
    assert h.ctrl.preempt("replica-99") is False
    h.made[-1].drain_clean = False
    assert h.ctrl.preempt("replica-0") is True
    assert any(x["kind"] == "dirty_preempt"
               for x in h.ctrl.describe()["incidents"])


def test_spawn_failure_backs_off_and_tears_down_half_starts():
    h = Harness()
    h.fail_spawns = 1
    h.ctrl.start()
    desc = h.ctrl.describe()
    assert desc["slots"][0]["state"] == "backoff"
    assert any(x["kind"] == "spawn_failure" for x in desc["incidents"])
    assert len(h.ctrl.replicas()) == 1
    h.tick(1.0)
    assert len(h.ctrl.replicas()) == 2
    h.warm_fail_next = True
    cur = next(r for r in h.made
               if r.name == "replica-0" and r.alive())
    cur.dead = True
    h.tick()
    h.tick(1.0)
    half = h.made[-1]
    assert half.warm_exc is not None and half.killed
    assert h.ctrl.describe()["slots"][0]["state"] == "backoff"
    h.tick(2.0)
    assert len(h.ctrl.replicas()) == 2


def test_ledger_is_atomic_json_and_bounded(tmp_path):
    ledger = str(tmp_path / "controller.json")
    h = Harness(ledger=ledger, backoff_initial_s=0.0,
                flap_max_respawns=10_000, flap_window_s=0.5)
    h.ctrl.start()
    for _ in range(2 * LEDGER_KEEP + 60):
        h.made[-1].dead = True
        h.tick()
    with open(ledger) as f:
        led = json.load(f)
    assert len(led["incidents"]) <= LEDGER_KEEP
    assert len(led["decisions"]) <= LEDGER_KEEP
    assert led["rounds"] == h.ctrl.rounds
    assert telemetry.counter_value("controller.incidents") > LEDGER_KEEP
    h.ctrl.close()


def test_step_survives_a_bad_round_in_run_loop():
    h = Harness(interval_s=0.01)
    h.ctrl.start()
    h.made[0].scrape_exc = RuntimeError("not a ScrapeError")
    h.ctrl.run()
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            h.clk[0] += 0.01
            if any(x["kind"] == "step_error"
                   for x in h.ctrl.describe()["incidents"]):
                break
            time.sleep(0.005)
    finally:
        h.ctrl.close()
    assert any(x["kind"] == "step_error"
               for x in h.ctrl.describe()["incidents"])


def test_controller_scrape_fault_marks_stale_then_recovers():
    h = Harness(stale_scrapes=3)
    h.ctrl.start()
    h.tick()
    with faults.armed(["controller.scrape:io_error:after=0:max=1"],
                      seed=11) as inj:
        h.tick()
        assert inj.fire_count("controller.scrape") == 1
    desc = h.ctrl.describe()
    assert desc["slots"][0]["stale"] is True
    assert desc["slots"][0]["state"] == "up"
    assert telemetry.counter_value("controller.scrape_stale") == 1
    h.tick()
    assert h.ctrl.describe()["slots"][0]["stale"] is False
    assert len(h.ctrl.replicas()) == 2


def test_controller_spawn_fault_cascade_backs_off_and_heals():
    h = Harness(backoff_initial_s=0.5)
    with faults.armed(["controller.spawn:io_error:after=0:max=1"],
                      seed=11) as inj:
        h.ctrl.start()
        assert inj.fire_count("controller.spawn") == 1
        desc = h.ctrl.describe()
        assert desc["slots"][0]["state"] == "backoff"
        assert any(x["kind"] == "spawn_failure"
                   for x in desc["incidents"])
        assert len(h.ctrl.replicas()) == 1
        h.tick(1.0)
        assert len(h.ctrl.replicas()) == 2


def test_controller_threads_end_with_close(tmp_path):
    """The controller's two thread families (the JAX soak's hygiene
    table names them: ``fleet-controller``, ``fleet-metrics-http``) run
    while the loop and the metrics surface are up and are gone after
    close()."""
    h = Harness(interval_s=0.01, ledger=str(tmp_path / "controller.json"))
    h.ctrl.start()
    h.ctrl.run()
    h.ctrl.serve_metrics()
    names = {t.name for t in threading.enumerate()}
    assert {"fleet-controller", "fleet-metrics-http"} <= names
    h.ctrl.close()
    names = {t.name for t in threading.enumerate() if t.is_alive()}
    assert not {"fleet-controller", "fleet-metrics-http"} & names


# ------------------------------------------- the same rounds, both packages

def _script(h, steps):
    """Apply one scripted scenario to a harness; return every decision
    and incident (without wall-clock stamps), the placement and the slot
    table."""
    for op, *args in steps:
        if op == "start":
            h.ctrl.start()
        elif op == "tick":
            h.tick(*args)
        elif op == "snap":
            slot, kw = args
            h.current(slot).snap = h.snap(**kw)
        elif op == "snap_all":
            for r in h.made:
                r.snap = h.snap(**args[0])
        elif op == "dead":
            h.current(args[0]).dead = True
        elif op == "hb":
            h.current(args[0]).hb_age = args[1]
        elif op == "scrape_fail":
            h.current(args[0]).scrape_exc = h.pkg.ScrapeError("blackholed")
        elif op == "scrape_ok":
            h.current(args[0]).scrape_exc = None
        elif op == "preempt":
            h.ctrl.preempt(f"replica-{args[0]}")
        elif op == "fail_spawns":
            h.fail_spawns = args[0]
        elif op == "warm_fail_next":
            h.warm_fail_next = True
        elif op == "reset":
            h.ctrl.reset_flap_breaker(f"replica-{args[0]}")
        elif op == "arm":
            with h.pkg.faults.armed([args[0]], seed=11):
                h.tick()
        else:
            raise AssertionError(op)
    desc = h.ctrl.describe()
    h.ctrl.close()
    strip = ("t_unix",)
    return {
        "decisions": [{k: v for k, v in d.items() if k not in strip}
                      for d in desc["decisions"]],
        "incidents": [{k: v for k, v in d.items() if k not in strip}
                      for d in desc["incidents"]],
        "placement": desc["placement"],
        "slots": desc["slots"],
        "rounds": desc["rounds"],
        "generations": [(r.name, r.generation, r.warm_calls)
                        for r in h.made],
    }


SCENARIOS = {
    "crash and respawn": (
        {}, [("start",), ("dead", 0), ("tick",), ("tick", 0.1),
             ("tick", 0.5), ("tick",)]),
    "hang": (
        {}, [("start",), ("hb", 1, 9.0), ("tick",), ("tick", 1.0),
             ("tick",)]),
    "stale scrape": (
        {}, [("start",), ("snap", 0, {"qi": 3}), ("tick",),
             ("scrape_fail", 0), ("tick",), ("tick",), ("tick", 1.0),
             ("tick",)]),
    "startup grace": (
        {"startup_grace_s": 10.0},
        [("start",), ("scrape_fail", 0), ("scrape_fail", 1), ("tick",),
         ("tick",), ("scrape_ok", 0), ("tick",), ("tick", 11.0),
         ("tick", 1.0)]),
    "flap breaker and reset": (
        {"backoff_initial_s": 0.0, "flap_max_respawns": 2,
         "flap_window_s": 1000.0},
        [("start",)] + [("dead", 0), ("tick",)] * 5
        + [("tick",), ("reset", 0), ("tick",), ("tick",)]),
    "scale up to the ceiling": (
        {}, [("start",), ("snap_all", {"qi": 10}), ("tick",), ("tick",),
             ("snap_all", {"qi": 10}), ("tick",), ("tick",), ("tick",)]),
    "idle retire to the floor": (
        {"min_replicas": 1, "max_replicas": 2, "pressure_rounds": 1,
         "idle_rounds": 2},
        [("start",), ("snap", 0, {"qi": 10}), ("tick",),
         ("snap_all", {"qi": 0}), ("tick",), ("tick",), ("tick",),
         ("tick",)]),
    "preempt": (
        {}, [("start",), ("tick",), ("preempt", 0), ("tick",),
             ("preempt", 1), ("tick",)]),
    "spawn failure and half start": (
        {}, [("fail_spawns", 1), ("start",), ("tick", 1.0),
             ("warm_fail_next",), ("dead", 0), ("tick",), ("tick", 1.0),
             ("tick", 2.0), ("tick",)]),
    "fault sites": (
        {"stale_scrapes": 3},
        [("start",), ("tick",),
         ("arm", "controller.scrape:io_error:after=0:max=1"), ("tick",),
         ("arm", "controller.spawn:io_error:after=0:max=1"),
         ("dead", 1), ("tick",), ("tick", 1.0), ("tick", 1.0)]),
    "slo breach": (
        {"pressure_rounds": 99,
         "slos": [{"route": "a", "p99_ms": 5.0, "fast_window_s": 30.0,
                   "slow_window_s": 30.0}]},
        [("start",), ("snap_all", {"p99": 0.2, "route": "a"}), ("tick",),
         ("tick",), ("tick",), ("tick",), ("tick",)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_rounds_same_decisions_as_jax(scenario, tmp_path):
    cfg, steps = SCENARIOS[scenario]
    cfg = dict(cfg)
    slos = cfg.pop("slos", None)
    got = _script(Harness(pkg=PORT, slos=slos,
                          ledger=str(tmp_path / "port.json"), **cfg), steps)
    want = _script(Harness(pkg=JAX, slos=slos,
                           ledger=str(tmp_path / "jax.json"), **cfg), steps)
    assert got == want
    assert got["decisions"] or got["incidents"]
    with open(tmp_path / "port.json") as a, open(tmp_path / "jax.json") as b:
        port_led, jax_led = json.load(a), json.load(b)
    assert port_led["slots"] == jax_led["slots"]
    assert port_led.keys() == jax_led.keys()


# --------------------------------------------- real replicas + readiness


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Two fitted routes (ibs PCoA + shared-alt PCA) over one compacted
    store, fitted by the port on the CPU."""
    from spark_examples_tpu_torch.store.writer import compact

    base = tmp_path_factory.mktemp("controller_fixture")
    rng = np.random.default_rng(42)
    g = random_genotypes(rng, n=N, v=V, missing_rate=0.1)
    store = str(base / "store")
    compact(store, ArraySource(g), chunk_variants=64)
    routes = {}
    for name, fit, metric in (("r-ibs", pcoa_job, "ibs"),
                              ("r-pca", variants_pca_job, None)):
        model = str(base / f"model_{name}.npz")
        job = JobConfig(
            ingest=IngestConfig(block_variants=BV),
            compute=ComputeConfig(metric=metric, num_pc=3, device="cpu"),
            model_path=model,
        )
        fit(job, source=ArraySource(g))
        routes[name] = SimpleNamespace(
            name=name, genotypes=g, store=store, model=model, job=job)
    manifest = str(base / "fleet.json")
    with open(manifest, "w") as f:
        json.dump({"budget_mb": 1.0, "block_variants": BV, "routes": [
            {"name": r.name, "model": r.model, "source": f"store:{r.store}"}
            for r in routes.values()]}, f)
    return SimpleNamespace(base=base, routes=routes, genotypes=g,
                           manifest=manifest)


def _build(fx, budget_mb=1.0, cfg=None):
    manifest = FleetManifest.parse({
        "budget_mb": budget_mb,
        "routes": [
            {"name": r.name, "model": r.model,
             "source": f"store:{r.store}"}
            for r in fx.routes.values()
        ],
    })
    return build_fleet(
        manifest, cfg or ServeConfig(cache_entries=0),
        ingest_defaults=IngestConfig(block_variants=BV,
                                     readahead_chunks=0),
        device="cpu")


def _offline(route, query):
    return pcoa_project_job(
        route.job.replace(model_path=None), model_path=route.model,
        source_new=ArraySource(query[None, :]),
        source_ref=ArraySource(route.genotypes),
    ).coords


def test_router_ready_info_transitions(fx):
    fleet = _build(fx)
    info = fleet.ready_info()
    assert info["ready"] is False and info["worker_alive"] is False
    fleet.start()
    assert fleet.ready_info()["ready"] is True
    try:
        fleet.warm_route("r-ibs")
        info = fleet.ready_info()
        assert info["ready"] is True
        assert info["warmed_routes"] == ["r-ibs"]
        assert info["unstaged_routes"] == []
    finally:
        fleet.drain()
        info = fleet.ready_info()
        assert info["ready"] is False and info["draining"] is True
        fleet.close()


def test_http_readyz_and_warm_endpoints(fx):
    import urllib.error

    from spark_examples_tpu_torch.serve.http import start_fleet_http_server

    fleet = _build(fx).start()
    http = start_fleet_http_server(fleet, port=0)
    base = f"http://127.0.0.1:{http.port}"
    try:
        with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
            body = json.loads(r.read())
        assert r.status == 200 and body["ready"] is True
        with urllib.request.urlopen(f"{base}/warm/r-pca",
                                    timeout=60) as r:
            assert json.loads(r.read()) == {"warmed": "r-pca"}
        assert fleet.pool.is_staged("r-pca")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/warm/nope", timeout=30)
        assert err.value.code == 404
        # The scrape the controller reads: the port's real /metrics text.
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            flat = parse_prometheus(r.read().decode())
        snap = snapshot_from_prometheus(flat, ["r-ibs", "r-pca"], t=1.0,
                                        ready=True)
        assert snap.routes["r-pca"]["staged"] is True
        assert snap.pool_bytes == fleet.pool.resident_bytes() > 0
        assert 0.0 < snap.pool_pressure <= 1.0
        fleet.drain()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/readyz", timeout=30)
        assert err.value.code == 503
        assert json.loads(err.value.read())["draining"] is True
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == DRAINING
    finally:
        http.shutdown()
        fleet.close()


def test_single_model_server_readyz(fx):
    route = fx.routes["r-ibs"]
    engine = ProjectionEngine(route.model, ArraySource(route.genotypes),
                              block_variants=BV, max_batch=4, device="cpu")
    server = ProjectionServer(engine, drain_timeout_s=5.0)
    assert server.ready_info()["ready"] is False
    server.start()
    try:
        assert server.ready_info()["ready"] is True
    finally:
        server.drain()
        info = server.ready_info()
        assert info["ready"] is False and info["draining"] is True
        server.close()


def _local_replica(fx, name, cfg=None):
    return LocalReplica(
        name, lambda: _build(fx, cfg=cfg).start(),
        budget_bytes=2 * PANEL_BYTES)


def test_zero_admitted_requests_lost_on_replica_kill(fx):
    """Kill the primary under hedged load: every admitted request is
    answered (failovers, never errors), and the survivor still serves
    bit-identical coordinates. Both routers linger 20 ms a batch so the
    load is still running when the kill lands (the port's CPU batches
    are faster than the JAX package's)."""
    cfg = ServeConfig(cache_entries=0, max_linger_ms=20.0)
    r0 = _local_replica(fx, "replica-0", cfg=cfg).start()
    r1 = _local_replica(fx, "replica-1", cfg=cfg).start()
    rng = np.random.default_rng(3)
    pool = random_genotypes(rng, n=8, v=V, missing_rate=0.1)
    box = {}

    def _drive():
        box["report"] = run_hedged_loadgen(
            [r0.router, r1.router], pool, clients=2,
            requests_per_client=10, route="r-ibs",
            hedge_floor_s=0.005, result_timeout_s=120.0, seed=5)

    t = threading.Thread(target=_drive, name="hedged-load",
                         daemon=True)
    t.start()
    time.sleep(0.05)
    r0.kill()
    t.join(timeout=120.0)
    report = box["report"]
    try:
        assert report["errors"] == 0
        assert report["completed"] == 20
        assert report["failovers"] >= 1
        assert not r0.alive() and r1.alive()
        q = pool[0]
        got = r1.router.project("r-ibs", q, timeout=120.0)
        np.testing.assert_array_equal(
            got, _offline(fx.routes["r-ibs"], q).astype(np.float32))
    finally:
        r1.drain(30.0)


def test_sigterm_drain_with_inflight_hedged_requests(fx):
    slow_cfg = ServeConfig(cache_entries=0, max_linger_ms=20.0)
    r0 = _local_replica(fx, "replica-0", cfg=slow_cfg).start()
    r1 = _local_replica(fx, "replica-1", cfg=slow_cfg).start()
    box = {}
    rng = np.random.default_rng(4)
    pool = random_genotypes(rng, n=8, v=V, missing_rate=0.1)

    def _drive():
        box["report"] = run_hedged_loadgen(
            [r0.router, r1.router], pool, clients=2,
            requests_per_client=8, route="r-ibs",
            hedge_floor_s=0.01, result_timeout_s=120.0, seed=6)

    t = threading.Thread(target=_drive, name="hedged-load",
                         daemon=True)
    t.start()
    time.sleep(0.05)
    clean = r0.drain(30.0)
    t.join(timeout=120.0)
    report = box["report"]
    try:
        assert clean is True
        assert report["errors"] == 0
        assert report["completed"] == 16
        assert telemetry._gauges["serve.health"]["max"] == 2.0  # DRAINING
        assert not r0.alive()
    finally:
        r1.drain(30.0)


def test_drain_reports_requests_abandoned_at_deadline(fx):
    fleet = _build(fx)  # admission open, worker never started
    rng = np.random.default_rng(8)
    futs = [fleet.submit("r-ibs",
                         random_genotypes(rng, n=1, v=V,
                                          missing_rate=0.1)[0],
                         priority=INTERACTIVE)
            for _ in range(6)]
    assert fleet.drain(timeout=0.0) is False
    for f in futs:
        with pytest.raises(ServerClosed):
            f.result(timeout=120.0)
    assert telemetry.counter_value("serve.drain_abandoned") == 6
    fleet.close()


def test_controller_over_local_replicas_end_to_end(fx, tmp_path):
    ledger = str(tmp_path / "controller.json")

    def factory(name, generation):
        return LocalReplica(name, lambda: _build(fx).start(),
                            budget_bytes=2 * PANEL_BYTES,
                            generation=generation)

    ctrl = FleetController(
        factory, {"r-ibs": PANEL_BYTES, "r-pca": PANEL_BYTES},
        ControllerConfig(
            min_replicas=2, max_replicas=3, idle_rounds=10_000,
            stale_scrapes=2, backoff_initial_s=0.01, backoff_max_s=0.5,
            flap_window_s=60.0, flap_max_respawns=10,
            drain_timeout_s=30.0, ledger_path=ledger,
        ))
    try:
        ctrl.start()
        assert len(ctrl.replicas()) == 2
        assert ctrl.ready_count() == 0
        ctrl.step()
        assert ctrl.ready_count() == 2
        ctrl.replicas()[0].kill()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            ctrl.step()
            reps = ctrl.replicas()
            if len(reps) == 2 and all(r.alive() for r in reps):
                break
            time.sleep(0.02)
        reps = ctrl.replicas()
        assert len(reps) == 2 and all(r.alive() for r in reps)
        assert ctrl.preempt("replica-1") is True
        assert len(ctrl.replicas()) == 2
        rng = np.random.default_rng(9)
        q = random_genotypes(rng, n=1, v=V, missing_rate=0.1)[0]
        want = _offline(fx.routes["r-ibs"], q).astype(np.float32)
        for replica in ctrl.replicas():
            np.testing.assert_array_equal(
                replica.router.project("r-ibs", q, timeout=120.0), want)
    finally:
        ctrl.close()
    with open(ledger) as f:
        led = json.load(f)
    actions = {d["action"] for d in led["decisions"]}
    assert {"respawn", "preempt"} <= actions
    assert any(x["kind"] == "crash" for x in led["incidents"])


# ------------------------------------------------- ProcessReplica bits


def test_process_replica_plumbing(tmp_path):
    from spark_examples_tpu_torch.core import supervisor

    r = ProcessReplica(
        "replica-0", argv=["true"], workdir=str(tmp_path),
        budget_bytes=1000, route_names=["r-ibs"])
    assert r.argv[-2:] == ["--port-file", r.port_file]
    assert r.env[supervisor.ENV_HEARTBEAT] == r.heartbeat_path
    assert r.env[telemetry.ENV_RUN_ID] == telemetry.run_id()
    assert r.port() is None
    assert r.heartbeat_age_s() is None
    assert r.alive() is False
    assert r.drain(1.0) is True
    r.warm(("r-ibs",))
    assert r.warm_routes == ("r-ibs",)
    with open(r.port_file, "w") as f:
        json.dump({"port": 4242}, f)
    assert r.port() == 4242
    with pytest.raises(ScrapeError, match="/metrics"):
        r.scrape()
    with pytest.raises(ScrapeError):
        r.warm(("r-ibs",))
    # A real (trivial) child: started, exits, reaped.
    r2 = ProcessReplica("replica-1", argv=["true"], workdir=str(tmp_path),
                        budget_bytes=1000, route_names=[]).start()
    r2.proc.wait(timeout=30)
    assert r2.alive() is False
    r2.kill()


def test_the_fleet_child_command_always_names_the_device(tmp_path):
    """The one spelling of the replica command: this package's serve
    --fleet with --device, and ProcessReplica.serving passes the
    controller's device, pins the generation as the telemetry attempt
    and appends the port file."""
    cmd = serve_child_command("f.json", "cuda", ["--telemetry-dir", "t"])
    assert cmd[:3] == [sys.executable, "-m", "spark_examples_tpu_torch"]
    assert cmd[3:] == ["serve", "--fleet", "f.json", "--port", "0",
                       "--device", "cuda", "--telemetry-dir", "t"]
    r = ProcessReplica.serving("replica-3", "f.json", "cpu", str(tmp_path),
                               1000, ["a"], generation=2)
    assert r.argv[r.argv.index("--device") + 1] == "cpu"
    assert r.argv[-2:] == ["--port-file", r.port_file]
    assert r.env[telemetry.ENV_ATTEMPT] == "2" and r.generation == 2
    assert r.device == "cpu"


def _child_env():
    return dict(os.environ,
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _step_until(ctrl, cond, budget_s=120.0):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        ctrl.step()
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"not reached in {budget_s} s: "
                         f"{json.dumps(ctrl.describe(), default=str)}")


def _post(replica, route, query):
    req = urllib.request.Request(
        f"http://127.0.0.1:{replica.port()}/project/{route}",
        data=json.dumps({"genotypes": query.tolist()}).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.asarray(json.loads(resp.read())["coords"], np.float32)


def test_process_replica_crash_and_respawn_on_cpu(fx, tmp_path):
    """One real serve child on --device cpu under the controller: ready,
    answering bitwise the offline project; SIGKILLed, detected as a
    crash, respawned (generation 1, its own telemetry attempt), and
    answering bitwise again. Then the workdir reads back: the ledger's
    crash incident, the timeline through both CLIs, the fleet stitch
    through both packages."""
    from spark_examples_tpu.cli.main import main as jmain
    from spark_examples_tpu.core import stitch as jstitch
    from spark_examples_tpu_torch.cli.main import main as tmain
    from spark_examples_tpu_torch.core import stitch as tstitch

    work = str(tmp_path / "fleetdir")
    os.makedirs(work)
    spawned = []

    def factory(name, generation):
        r = ProcessReplica.serving(
            name, fx.manifest, "cpu", work, 10_000_000,
            ["r-ibs", "r-pca"],
            extra_args=["--telemetry-dir", os.path.join(work, name),
                        "--telemetry-flush-s", "0.2",
                        "--cache-entries", "0"],
            env=_child_env(), generation=generation)
        spawned.append(r)
        return r

    ctrl = FleetController(
        factory, {"r-ibs": PANEL_BYTES, "r-pca": PANEL_BYTES},
        ControllerConfig(
            min_replicas=1, max_replicas=1, startup_grace_s=120.0,
            backoff_initial_s=0.05, hang_heartbeat_s=120.0,
            drain_timeout_s=60.0,
            ledger_path=os.path.join(work, "controller.json")))
    q = random_genotypes(np.random.default_rng(9), n=1, v=V,
                         missing_rate=0.1)[0]
    want = _offline(fx.routes["r-ibs"], q).astype(np.float32)
    try:
        ctrl.start()
        _step_until(ctrl, lambda: ctrl.ready_count() == 1)
        np.testing.assert_array_equal(_post(spawned[0], "r-ibs", q), want)
        time.sleep(0.5)  # a live flush of the first generation's ring
        spawned[0].proc.kill()
        spawned[0].proc.wait(timeout=30)
        _step_until(ctrl, lambda: any(
            d["action"] == "respawn" for d in ctrl.describe()["decisions"]))
        _step_until(ctrl, lambda: ctrl.ready_count() == 1)
        assert len(spawned) == 2 and spawned[1].generation == 1
        np.testing.assert_array_equal(_post(spawned[1], "r-ibs", q), want)
    finally:
        ctrl.close()
        for r in spawned:
            r.kill()
    assert all(r.argv[r.argv.index("--device") + 1] == "cpu"
               for r in spawned)
    with open(os.path.join(work, "controller.json")) as f:
        led = json.load(f)
    assert [i["kind"] for i in led["incidents"]] == ["crash"]
    # The fleet stitch through both packages: the same slots, events and
    # markers (the killed generation from its live ring).
    got = tstitch.stitch_fleet(work, output=str(tmp_path / "t.jsonl"))
    want_rep = jstitch.stitch_fleet(work, output=str(tmp_path / "j.jsonl"))
    assert got["slots"] == want_rep["slots"] == ["replica-0"]
    assert got["events"] == want_rep["events"] > 0
    assert got["incident_markers"] == want_rep["incident_markers"] == 1
    assert not got["mixed_run_ids"]
    with open(got["output"]) as a, open(want_rep["output"]) as b:
        assert a.read() == b.read()
    assert os.path.isdir(os.path.join(work, "replica-0", "attempt1",
                                      "rank0"))
    # The timeline through both CLIs: the same report.
    reports = []
    for main in (tmain, jmain):
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert main(["telemetry", "timeline", "--path", work]) == 0
        reports.append(json.loads(out.getvalue().strip().splitlines()[-1]))
    assert reports[0] == reports[1]
    assert reports[0]["rounds"] == led["rounds"]
    assert "crash" in reports[0]["marker_kinds"]


def test_cuda_child_without_a_card_parks_and_never_runs_on_cpu(tmp_path):
    """A controller for cuda on a host without a card: every spawn fails
    (the device is resolved before the child starts), the flap breaker
    parks the slot, and no child ever starts — on the CPU or at all."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    spawned = []

    def factory(name, generation):
        r = ProcessReplica.serving(name, "fleet.json", "cuda",
                                   str(tmp_path), 1000, ["a"],
                                   generation=generation)
        spawned.append(r)
        return r

    clk = [0.0]
    ctrl = FleetController(
        factory, {"a": 100},
        ControllerConfig(min_replicas=1, max_replicas=1,
                         backoff_initial_s=0.0, flap_max_respawns=2,
                         flap_window_s=1000.0),
        clock=lambda: clk[0])
    ctrl.start()
    for _ in range(6):
        clk[0] += 1.0
        ctrl.step()
    desc = ctrl.describe()
    kinds = [i["kind"] for i in desc["incidents"]]
    assert kinds == ["spawn_failure"] * 3 + ["flap_breaker"]
    assert all("no CUDA device" in i["detail"] for i in desc["incidents"]
               if i["kind"] == "spawn_failure")
    assert desc["slots"][0]["state"] == "parked"
    assert ctrl.replicas() == []
    assert spawned and all(r.proc is None for r in spawned)
    assert all(r.device == "cuda" and r.argv[r.argv.index("--device") + 1]
               == "cuda" for r in spawned)
    ctrl.close()


# --------------------------------------------- seeded load


def test_burst_schedule_is_deterministic_and_validated():
    a = BurstSchedule(duration_s=10.0, base_qps=5.0, seed=7)
    b = BurstSchedule(duration_s=10.0, base_qps=5.0, seed=7)
    assert a.bursts == b.bursts
    assert a.arrivals() == b.arrivals()
    c = BurstSchedule(duration_s=10.0, base_qps=5.0, seed=8)
    assert c.arrivals() != a.arrivals()
    assert all(0.0 < t < 10.0 for t in a.arrivals())
    lo, _hi = a.bursts[0]
    base_rate = 5.0 * (1.0 + 0.3 * np.sin(2.0 * np.pi * lo / 10.0))
    assert a.rate_at(lo) == pytest.approx(base_rate * 6.0)
    with pytest.raises(ValueError, match="bad burst schedule"):
        BurstSchedule(duration_s=0.0, base_qps=5.0)
    with pytest.raises(ValueError, match="burst_factor"):
        BurstSchedule(duration_s=1.0, base_qps=5.0, burst_factor=0.5)


def test_hedge_delay_seed_precharges_the_ring():
    seeded = _HedgeDelay(0.01, seed=42)
    again = _HedgeDelay(0.01, seed=42)
    assert seeded.delay_s() == again.delay_s()
    assert seeded.delay_s() >= 0.01
    cold = _HedgeDelay(0.01)
    assert cold.delay_s() == 0.01
    for _ in range(256):
        seeded.record(0.5)
    assert seeded.delay_s() == pytest.approx(0.5)


# ------------------------------- flight recorder rides the controller


def _route_snap(p99=0.01, shed=0.0, route="a"):
    return ReplicaSnapshot(
        t=0.0, ready=True, health="healthy", worker_alive=True,
        in_flight=0, queue_interactive=0, queue_batch=0, p99_s=p99,
        shed_rate=shed, pool_bytes=0.0, pool_pressure=0.0,
        routes={route: {"p99_s": p99, "queue_depth": 0,
                        "shed_rate": shed, "staged": True}})


def test_slo_breach_scales_up_within_the_same_round(tmp_path):
    ledger = str(tmp_path / "controller.json")
    h = Harness(ledger=ledger, pressure_rounds=99,
                slos=[{"route": "a", "p99_ms": 5.0, "fast_window_s": 30.0,
                       "slow_window_s": 30.0}])
    h.ctrl.start()
    for r in h.made:
        r.snap = _route_snap(p99=0.2)
    rounds_to_trip = 0
    while len(h.ctrl.replicas()) < 3 and rounds_to_trip < 10:
        h.tick()
        rounds_to_trip += 1
    led = h.ctrl.describe()
    breach = next(i for i in led["incidents"]
                  if i["kind"] == "slo_breach")
    assert breach["who"] == "a" and "p99<=5" in breach["detail"]
    scale = next(d for d in led["decisions"]
                 if d["action"] == "scale_up")
    assert scale["detail"].startswith("slo breach pressure (this round)")
    assert scale["round"] == breach["round"]
    assert len(h.ctrl.replicas()) == 3
    gauges = telemetry.metrics_snapshot()["gauges"]
    assert gauges["slo.a.breached"]["last"] == 1.0
    h.ctrl.close()


def test_healthy_fleet_never_trips_slo_pressure(tmp_path):
    h = Harness(pressure_rounds=99,
                slos=[{"route": "a", "p99_ms": 500.0, "fast_window_s": 30.0,
                       "slow_window_s": 30.0}])
    h.ctrl.start()
    for r in h.made:
        r.snap = _route_snap(p99=0.01)
    for _ in range(6):
        h.tick()
    assert len(h.ctrl.replicas()) == 2
    assert not any(i["kind"] == "slo_breach"
                   for i in h.ctrl.describe()["incidents"])
    gauges = telemetry.metrics_snapshot()["gauges"]
    assert gauges["slo.ok"]["last"] == 1.0
    h.ctrl.close()


def test_timeline_ring_lands_beside_the_ledger(tmp_path):
    from spark_examples_tpu_torch.fleet.timeline import read_timeline

    ledger = str(tmp_path / "controller.json")
    h = Harness(ledger=ledger)
    h.ctrl.start()
    for _ in range(3):
        h.tick()
    h.made[0].dead = True
    h.tick()
    recs = read_timeline(str(tmp_path / "timeline.jsonl"))
    rounds = [r for r in recs if r["type"] == "round"]
    assert rounds and rounds[-1]["replicas"] >= 1
    assert "replica-0" in rounds[1]["slots"]
    assert any(r["type"] == "marker" and r["kind"] == "crash"
               for r in recs)
    h.ctrl.close()


def test_ledger_rotates_full_generations_to_old(tmp_path):
    ledger = str(tmp_path / "controller.json")
    h = Harness(ledger=ledger)
    h.ctrl.start()
    for i in range(LEDGER_KEEP + 30):
        h.ctrl._incident("replica-0", "probe", f"synthetic #{i}")
    old = ledger + ".old"
    assert os.path.exists(old)
    with open(old) as f:
        gen0 = json.load(f)
    assert len(gen0["incidents"]) == LEDGER_KEEP
    assert gen0["incidents"][0]["detail"] == "synthetic #0"
    assert telemetry.counter_value("controller.ledger_rotations") == 1
    for i in range(LEDGER_KEEP - 30):
        h.ctrl._incident("replica-0", "probe", f"late #{i}")
    assert telemetry.counter_value("controller.ledger_rotations") == 1
    h.ctrl._incident("replica-0", "probe", "tips the second generation")
    assert telemetry.counter_value("controller.ledger_rotations") == 2
    with open(old) as f:
        gen1 = json.load(f)
    assert gen1["incidents"][-1]["detail"] == "late #169"
    h.ctrl.close()


def test_controller_serves_the_fleet_metrics_surface(tmp_path):
    h = Harness(ledger=str(tmp_path / "controller.json"))
    h.ctrl.start()
    for r in h.made:
        r.snap = _route_snap(p99=0.02)
    for _ in range(2):
        h.tick()
    port_file = str(tmp_path / "metrics_port.json")
    srv = h.ctrl.serve_metrics(port_file=port_file)
    assert h.ctrl.serve_metrics() is srv
    with open(port_file) as f:
        port = int(f.read())
    assert port == srv.port
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/fleet/metrics", timeout=30) as r:
        prom = r.read().decode()
    assert "timeline_fleet_p99_s" in prom
    assert "timeline_route_a_p99_s" in prom
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/fleet/timeline", timeout=30) as r:
        doc = json.loads(r.read())
    assert any(rec["type"] == "round" for rec in doc["records"])
    h.ctrl.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/fleet/metrics", timeout=5)
