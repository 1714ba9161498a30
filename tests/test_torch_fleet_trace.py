"""The fleet flight recorder of the port against the JAX package's, on
the CPU: the fleet parts of tests/test_trace.py.

The controller's timeline ring (``fleet/timeline.py``: round-trip,
cross-slot quantile folds, size-bounded compaction, ``trace.export``
faults absorbed), the manifest's SLOs (``fleet/slo.py``: validation and
multi-window burn), ``GET /fleet/metrics`` and ``/fleet/timeline``, the
fleet stitch (``core/stitch.py::stitch_fleet``) and the ``telemetry
timeline`` verb. Across the packages: the same rounds give the same
tape records and the same SLO verdicts, both stitchers read one workdir
(the rotated ledger included) to the same slots, events and markers,
and both CLIs render one tape to the same report.
"""

import contextlib
import io
import json
import os
import time
import urllib.error
import urllib.request

import pytest

from spark_examples_tpu.cli.main import main as jmain
from spark_examples_tpu.core import stitch as jstitch
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu.fleet import replica as jreplica
from spark_examples_tpu.fleet import slo as jslo
from spark_examples_tpu.fleet import timeline as jtimeline
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import faults, stitch, telemetry
from spark_examples_tpu_torch.fleet.replica import ReplicaSnapshot
from spark_examples_tpu_torch.fleet.slo import SLOEvaluator, SLOSpec
from spark_examples_tpu_torch.fleet.timeline import (
    FleetTimeline,
    TimelineMetricsServer,
    read_timeline,
)
from spark_examples_tpu_torch.serve import FleetFormatError, FleetManifest


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for t in (telemetry, jtelemetry):
        t.reset()
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(dir=None)


def _snap(p99=0.01, shed=0.0, qi=0, qb=0, route="r-a", staged=True,
          stale=False, ready=True, cls=ReplicaSnapshot):
    return cls(
        t=time.monotonic(), ready=ready, health="healthy",
        worker_alive=True, in_flight=0, queue_interactive=qi,
        queue_batch=qb, p99_s=p99, shed_rate=shed, pool_bytes=0.0,
        pool_pressure=0.0, stale=stale,
        routes={route: {"p99_s": p99, "queue_depth": qi + qb,
                        "shed_rate": shed, "staged": staged}})


# ------------------------------------------------------------ timeline


def test_timeline_roundtrip_markers_and_folds(tmp_path):
    path = str(tmp_path / "timeline.jsonl")
    tl = FleetTimeline(path=path)
    for rd in range(4):
        tl.record_round(rd, {"replica-0": _snap(p99=0.01 * (rd + 1)),
                             "replica-1": None}, 1, 1)
    tl.record_marker(3, "replica-0", "crash", "killed mid-burst")
    recs = read_timeline(path)
    assert [r["type"] for r in recs] == ["round"] * 4 + ["marker"]
    assert recs[0]["slots"]["replica-1"] == {"present": False}
    assert recs[2]["slots"]["replica-0"]["routes"]["r-a"]["p99_s"] == \
        pytest.approx(0.03)
    assert recs[-1]["kind"] == "crash"
    assert [r["seq"] for r in tl.recent()] == [1, 2, 3, 4, 5]
    gauges = telemetry.metrics_snapshot()["gauges"]
    assert gauges["timeline.fleet_p99_s"]["last"] > 0.0
    assert gauges["timeline.route.r-a.p99_s"]["last"] > 0.0
    assert tl.route_quantile("r-a", 0.99) >= 0.01
    assert telemetry.counter_value("timeline.rounds") == 4
    assert telemetry.counter_value("timeline.markers") == 1


def test_timeline_records_and_folds_equal_jax_s(tmp_path):
    """The same rounds through both recorders: the same tape lines but
    for the wall-clock stamps, the same fold gauges, the same merged
    quantiles."""
    tapes = {}
    for name, mod, tel, cls in (
            ("port", None, telemetry, ReplicaSnapshot),
            ("jax", jtimeline, jtelemetry, jreplica.ReplicaSnapshot)):
        path = str(tmp_path / f"{name}.jsonl")
        tl = (FleetTimeline if mod is None else mod.FleetTimeline)(path=path)
        for rd in range(12):
            tl.record_round(rd, {
                "replica-0": _snap(p99=0.004 * (rd % 5 + 1), qi=rd % 3,
                                   cls=cls),
                "replica-1": (None if rd % 4 == 0 else
                              _snap(p99=0.05, shed=0.01 * rd, cls=cls,
                                    stale=rd % 5 == 0)),
            }, 2, 1)
            if rd % 6 == 5:
                tl.record_marker(rd, "replica-1", "respawn", f"gen {rd}")
        gauges = tel.metrics_snapshot()["gauges"]
        tapes[name] = (
            [{k: v for k, v in r.items() if k != "t_unix"}
             for r in (read_timeline if mod is None
                       else mod.read_timeline)(path)],
            {k: v["last"] for k, v in gauges.items()
             if k.startswith("timeline.") and k != "timeline.bytes"},
            [tl.route_quantile("r-a", q) for q in (0.1, 0.5, 0.99)])
    assert tapes["port"] == tapes["jax"]


def test_timeline_merges_quantiles_across_slots():
    tl = FleetTimeline(path=None)
    for rd in range(20):
        tl.record_round(rd, {
            "replica-0": _snap(p99=0.010),
            "replica-1": _snap(p99=0.100),
        }, 2, 2)
    assert tl.route_quantile("r-a", 0.99) >= 0.09
    assert tl.route_quantile("r-a", 0.10) <= 0.02


def test_timeline_compacts_past_the_size_bound(tmp_path):
    path = str(tmp_path / "timeline.jsonl")
    tl = FleetTimeline(path=path, max_bytes=4096, window=6)
    for rd in range(60):
        tl.record_round(rd, {"replica-0": _snap()}, 1, 1)
    assert telemetry.counter_value("timeline.compactions") >= 1
    assert os.path.getsize(path) <= 4096 + 2048
    recs = read_timeline(path)
    assert recs[-1]["round"] == 59
    assert 6 <= len([r for r in recs if r["type"] == "round"]) < 30


def test_timeline_absorbs_trace_export_io_errors(tmp_path):
    path = str(tmp_path / "timeline.jsonl")
    tl = FleetTimeline(path=path)
    with faults.armed(["trace.export:io_error:after=1:max=2"]):
        for rd in range(5):
            tl.record_round(rd, {"replica-0": _snap()}, 1, 1)
    assert telemetry.counter_value("timeline.write_errors") == 2
    recs = read_timeline(path)
    assert len(recs) == 3
    assert recs[-1]["round"] == 4


def test_timeline_truncate_fault_leaves_last_good_tape(tmp_path):
    path = str(tmp_path / "timeline.jsonl")
    tl = FleetTimeline(path=path)
    with faults.armed(["trace.export:truncate:keep=8:after=3:max=1"]):
        for rd in range(8):
            tl.record_round(rd, {"replica-0": _snap()}, 1, 1)
    recs = read_timeline(path)
    assert [r["round"] for r in recs] == [4, 5, 6, 7]


def test_timeline_config_validation_names_the_knob():
    for bad in (10, True):
        with pytest.raises(ValueError, match="--timeline-max-bytes") as got:
            FleetTimeline(max_bytes=bad)
        with pytest.raises(ValueError) as want:
            jtimeline.FleetTimeline(max_bytes=bad)
        assert str(got.value) == str(want.value)
    from spark_examples_tpu_torch.fleet import ControllerConfig
    with pytest.raises(ValueError, match="--timeline-max-bytes"):
        ControllerConfig(timeline_max_bytes=1)


def test_fleet_metrics_server_serves_folds_and_timeline(tmp_path):
    tl = FleetTimeline(path=None)
    for rd in range(3):
        tl.record_round(rd, {"replica-0": _snap(p99=0.02, qi=3)}, 1, 1)
    tl.record_marker(2, "r-a", "slo_breach", "p99<=5ms burned")
    port_file = str(tmp_path / "port")
    srv = TimelineMetricsServer(tl, port_file=port_file).serve_in_thread()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert int(open(port_file).read()) == srv.port
        with urllib.request.urlopen(f"{base}/fleet/metrics",
                                    timeout=30) as r:
            prom = r.read().decode()
        assert "timeline_fleet_p99_s" in prom
        assert "timeline_fleet_queue_depth" in prom
        assert "timeline_route_r_a_p99_s" in prom
        with urllib.request.urlopen(f"{base}/fleet/timeline",
                                    timeout=30) as r:
            doc = json.loads(r.read())
        assert len(doc["records"]) == 4
        assert doc["records"][-1]["kind"] == "slo_breach"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert err.value.code == 404
    finally:
        srv.shutdown()


# ------------------------------------------------------------- SLOs


def _manifest(slos):
    return {"routes": [{"name": "r-a", "model": "m.npz",
                        "source": "synthetic"}],
            "slos": slos}


BAD_SLOS = {
    "not a list": ({"route": "r-a"}, "'slos' must be a list"),
    "unknown field": ([{"route": "r-a", "p99ms": 5}],
                      r"slos\[0\] has unknown"),
    "undeclared route": ([{"route": "r-b", "p99_ms": 5}],
                         "names no declared route"),
    "no objective": ([{"route": "r-a"}], "declares no objective"),
    "bad p99": ([{"route": "r-a", "p99_ms": -1}], r"slos\[0\]\.p99_ms"),
    "bad availability": ([{"route": "r-a", "availability": 1.5}],
                         r"slos\[0\]\.availability"),
    "windows": ([{"route": "r-a", "p99_ms": 5, "fast_window_s": 60,
                  "slow_window_s": 30}], "slow_window_s"),
    "entry not an object": (["r-a"], r"slos\[0\] must be an object"),
    "bool budget": ([{"route": "r-a", "p99_ms": 5, "budget": True}],
                    r"slos\[0\]\.budget"),
}


@pytest.mark.parametrize("case", sorted(BAD_SLOS))
def test_slo_manifest_validation_names_the_entry(case):
    """Each bad objective is refused at parse time with the JAX
    package's text."""
    from spark_examples_tpu.serve import FleetManifest as JFleetManifest

    slos, match = BAD_SLOS[case]
    with pytest.raises(FleetFormatError, match=match) as got:
        FleetManifest.parse(_manifest(slos))
    with pytest.raises(Exception) as want:
        JFleetManifest.parse(_manifest(slos))
    assert str(got.value) == str(want.value)


def test_slo_manifest_parses_like_jax():
    m = FleetManifest.parse(_manifest([
        {"route": "r-a", "p99_ms": 50, "budget": 0.2},
        {"route": "*", "availability": 0.99},
    ]))
    assert m.slos[0].p99_ms == 50.0 and m.slos[0].budget == 0.2
    assert m.slos[0].key == "r-a"
    assert m.slos[1].key == "fleet"
    assert FleetManifest.parse(_manifest(None) | {"slos": None}).slos == ()


def test_slo_burn_needs_min_rounds_before_claiming():
    tl = FleetTimeline(path=None)
    spec = SLOSpec(route="r-a", p99_ms=5.0, fast_window_s=30.0,
                   slow_window_s=30.0)
    for rd in range(2):
        tl.record_round(rd, {"replica-0": _snap(p99=0.2)}, 1, 1)
    assert SLOEvaluator((spec,), tl).evaluate() == []
    gauges = telemetry.metrics_snapshot()["gauges"]
    assert gauges["slo.r-a.fast_burn"]["last"] == 0.0
    assert gauges["slo.ok"]["last"] == 1.0


def test_slo_breach_when_both_windows_burn():
    tl = FleetTimeline(path=None)
    spec = SLOSpec(route="r-a", p99_ms=5.0, fast_window_s=30.0,
                   slow_window_s=30.0)
    for rd in range(6):
        tl.record_round(rd, {"replica-0": _snap(p99=0.2)}, 1, 1)
    breaches = SLOEvaluator((spec,), tl).evaluate()
    assert len(breaches) == 1
    b = breaches[0]
    assert b["route"] == "r-a" and "p99<=5" in b["objective"]
    assert b["fast_burn"] >= 1.0 and b["slow_burn"] >= 1.0
    gauges = telemetry.metrics_snapshot()["gauges"]
    assert gauges["slo.r-a.breached"]["last"] == 1.0
    assert gauges["slo.ok"]["last"] == 0.0
    assert telemetry.counter_value("slo.breaches") == 1


def test_slo_availability_objective_reads_shed_rate():
    tl = FleetTimeline(path=None)
    spec = SLOSpec(route="*", availability=0.99, fast_window_s=30.0,
                   slow_window_s=30.0)
    for rd in range(4):
        tl.record_round(rd, {"replica-0": _snap(shed=0.5)}, 1, 1)
    breaches = SLOEvaluator((spec,), tl).evaluate()
    assert breaches and breaches[0]["key"] == "fleet"
    assert "availability>=0.99" in breaches[0]["objective"]
    tl2 = FleetTimeline(path=None)
    for rd in range(40):
        tl2.record_round(rd, {"replica-0": _snap(shed=0.0)}, 1, 1)
    assert SLOEvaluator((spec,), tl2).evaluate() == []


@pytest.mark.parametrize("p99,shed,rounds", [(0.2, 0.0, 6), (0.001, 0.5, 4),
                                             (0.2, 0.0, 2), (0.004, 0.0, 9)])
def test_slo_verdicts_equal_jax_s(p99, shed, rounds):
    """One tape, both evaluators (a p99 and an availability objective, a
    fixed evaluation instant): the same breaches and the same burn
    gauges."""
    out = []
    for tl_mod, slo_mod, cls, tel in (
            (None, None, ReplicaSnapshot, telemetry),
            (jtimeline, jslo, jreplica.ReplicaSnapshot, jtelemetry)):
        tl = (FleetTimeline if tl_mod is None else tl_mod.FleetTimeline)(
            path=None)
        for rd in range(rounds):
            tl.record_round(rd, {"replica-0": _snap(p99=p99, shed=shed,
                                                    cls=cls)}, 1, 1)
        spec_cls = SLOSpec if slo_mod is None else slo_mod.SLOSpec
        ev_cls = SLOEvaluator if slo_mod is None else slo_mod.SLOEvaluator
        specs = (spec_cls(route="r-a", p99_ms=5.0, fast_window_s=30.0,
                          slow_window_s=60.0),
                 spec_cls(route="*", availability=0.9, budget=0.2))
        now = time.time()
        out.append((ev_cls(specs, tl).evaluate(now_unix=now),
                    {k: v["last"]
                     for k, v in tel.metrics_snapshot()["gauges"].items()
                     if k.startswith("slo.")}))
    assert out[0] == out[1]


# ----------------------------------------------------- fleet stitch


def _write_slot_export(base, slot, events, run_id="rid1", epoch=1000.0,
                       live_ring=False, attempt=None):
    d = os.path.join(base, slot, *(() if attempt is None
                                   else (f"attempt{attempt}",)), "rank0")
    os.makedirs(d)
    if not live_ring:
        with open(os.path.join(d, "metrics.json"), "w") as f:
            json.dump({"counters": {}, "meta": {
                "rank": 0, "attempt": attempt or 0, "run_id": run_id,
                "epoch_unix_s": epoch}}, f)
    name = "live_trace.jsonl" if live_ring else "trace.jsonl"
    with open(os.path.join(d, name), "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


SPAN = {"name": "trace.compute", "cat": "trace", "ph": "X", "dur": 5e3,
        "tid": 1}


def _fleet_dir(base):
    """A fleet workdir: slot 0 killed mid-burst (its live ring only),
    slot 1 with a full export and a respawned second attempt, the
    controller ledger and its rotated generation (one overlapping
    incident), and the files a controller leaves beside them."""
    _write_slot_export(base, "replica-0", [
        {**SPAN, "ts": 10.0, "args": {"trace_id": "tt1",
                                      "span_id": "a1"}}], live_ring=True)
    _write_slot_export(base, "replica-1", [
        {**SPAN, "ts": 20.0, "args": {"trace_id": "tt1",
                                      "span_id": "b1"}},
        {**SPAN, "ts": 30.0, "args": {"trace_id": "tt2",
                                      "span_id": "b2"}}], attempt=0)
    _write_slot_export(base, "replica-1", [
        {**SPAN, "ts": 5.0, "args": {"trace_id": "tt3",
                                     "span_id": "c1"}}],
        attempt=1, epoch=1002.0)
    inc = {"round": 1, "who": "replica-0", "kind": "crash",
           "detail": "old generation", "t_unix": 1000.1}
    with open(os.path.join(base, "controller.json.old"), "w") as f:
        json.dump({"incidents": [inc]}, f)
    with open(os.path.join(base, "controller.json"), "w") as f:
        json.dump({"incidents": [inc, {
            "round": 9, "who": "replica-1", "kind": "hang",
            "detail": "new generation", "t_unix": 1001.0}]}, f)
    for stray in ("replica-0.hb", "replica-0.port", "timeline.jsonl"):
        with open(os.path.join(base, stray), "w") as f:
            f.write("{}\n")


def test_stitch_fleet_merges_slots_with_incident_markers(tmp_path):
    base = str(tmp_path / "fleet")
    _write_slot_export(base, "replica-0", [
        {**SPAN, "ts": 10.0, "args": {"trace_id": "tt1",
                                      "span_id": "a1"}}], live_ring=True)
    _write_slot_export(base, "replica-1", [
        {**SPAN, "ts": 20.0, "args": {"trace_id": "tt1",
                                      "span_id": "b1"}},
        {**SPAN, "ts": 30.0, "args": {"trace_id": "tt2",
                                      "span_id": "b2"}}])
    with open(os.path.join(base, "controller.json"), "w") as f:
        json.dump({"incidents": [
            {"round": 3, "who": "replica-0", "kind": "crash",
             "detail": "killed mid-burst", "t_unix": 1000.5}]}, f)
    report = stitch.stitch_fleet(base)
    assert report["slots"] == ["replica-0", "replica-1"]
    assert report["events"] == 3
    assert report["incident_markers"] == 1
    lines = [json.loads(line)
             for line in open(report["output"]) if line.strip()]
    legs = [e for e in lines
            if e.get("args", {}).get("trace_id") == "tt1"]
    assert len(legs) == 2
    assert abs(legs[0]["pid"] - legs[1]["pid"]) >= 1_000_000
    assert {e["args"]["span_id"] for e in legs} == {"a1", "b1"}
    marker = next(e for e in lines if e["name"] == "incident: crash")
    assert marker["ph"] == "i" and marker["s"] == "g"
    assert marker["args"]["who"] == "replica-0"
    names = {e["args"].get("name") for e in lines if e.get("ph") == "M"}
    assert {"replica-0 attempt 0 rank 0", "replica-1 attempt 0 rank 0",
            "controller"} <= names


def test_stitch_fleet_rejects_a_non_fleet_dir(tmp_path):
    with pytest.raises(stitch.StitchError, match="fleet workdir"):
        stitch.stitch_fleet(str(tmp_path))
    with pytest.raises(stitch.StitchError, match="cannot read fleet dir"):
        stitch.stitch_fleet(str(tmp_path / "missing"))


def test_stitch_fleet_reads_rotated_ledger_generation(tmp_path):
    base = str(tmp_path / "fleet")
    _write_slot_export(base, "replica-0", [
        {"name": "trace.request", "ph": "X", "ts": 1.0, "dur": 1.0,
         "tid": 1, "args": {}}])
    inc = {"round": 1, "who": "replica-0", "kind": "crash",
           "detail": "old generation", "t_unix": 1000.1}
    with open(os.path.join(base, "controller.json.old"), "w") as f:
        json.dump({"incidents": [inc]}, f)
    with open(os.path.join(base, "controller.json"), "w") as f:
        json.dump({"incidents": [inc, {
            "round": 9, "who": "replica-0", "kind": "flap",
            "detail": "new generation", "t_unix": 1001.0}]}, f)
    report = stitch.stitch_fleet(base)
    assert report["incident_markers"] == 2


def test_stitch_fleet_through_both_packages_on_one_workdir(tmp_path):
    """One workdir (a killed slot's live ring, a respawned attempt, the
    rotated ledger, a controller's stray files): both stitchers give the
    same report and the same stitched lines."""
    base = str(tmp_path / "fleet")
    _fleet_dir(base)
    got = stitch.stitch_fleet(base, output=str(tmp_path / "port.jsonl"))
    want = jstitch.stitch_fleet(base, output=str(tmp_path / "jax.jsonl"))
    for rep in (got, want):
        rep.pop("output")
    assert got == want
    assert got["slots"] == ["replica-0", "replica-1"]
    assert got["events"] == 4 and got["incident_markers"] == 2
    with open(tmp_path / "port.jsonl") as a, open(tmp_path / "jax.jsonl") as b:
        assert a.read() == b.read()
    pids = {json.loads(line)["pid"] for line in open(tmp_path / "port.jsonl")
            if "trace_id" in line}
    assert pids == {0, 1_000_000, 1_010_000}  # slot blocks, attempt 1


# ----------------------------------------------------------- CLI


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_telemetry_timeline_cli_renders_the_tape(tmp_path):
    tl = FleetTimeline(path=str(tmp_path / "timeline.jsonl"))
    for rd in range(3):
        tl.record_round(rd, {"replica-0": _snap(p99=0.025, qi=2)}, 1, 1)
    tl.record_marker(2, "r-a", "slo_breach", "p99<=5ms burned: fast 3x")
    rc, out, err = _cli(tmain, ["telemetry", "timeline", "--path",
                                str(tmp_path)])
    assert rc == 0
    report = json.loads(out.strip().splitlines()[-1])
    assert report["rounds"] == 3 and report["markers"] == 1
    assert report["replicas_last"] == 1
    assert report["routes"]["r-a"]["p99_last_ms"] == pytest.approx(25.0)
    assert report["marker_kinds"] == ["slo_breach"]
    assert "slo_breach" in err and "round" in err
    # The same tape through the JAX CLI: the same report and rows.
    jrc, jout, jerr = _cli(jmain, ["telemetry", "timeline", "--path",
                                   str(tmp_path / "timeline.jsonl"),
                                   "--last", "2"])
    rc, out, err = _cli(tmain, ["telemetry", "timeline", "--path",
                                str(tmp_path / "timeline.jsonl"),
                                "--last", "2"])
    assert (rc, out, err) == (jrc, jout, jerr)
    assert len(err.strip().splitlines()) == 2


def test_telemetry_timeline_cli_empty_tape_fails_loudly(tmp_path):
    rc, _out, err = _cli(tmain, ["telemetry", "timeline", "--path",
                                 str(tmp_path)])
    assert rc == 1
    assert "no readable records" in err


def test_telemetry_stitch_fleet_cli_through_both_packages(tmp_path):
    base = str(tmp_path / "fleet")
    _fleet_dir(base)
    reports = []
    for main, name in ((tmain, "port"), (jmain, "jax")):
        out_path = str(tmp_path / f"{name}.jsonl")
        rc, out, err = _cli(main, ["telemetry", "stitch", "--fleet",
                                   "--path", base, "--output", out_path])
        assert rc == 0
        assert "incident marker(s)" in err
        rep = json.loads(out.strip().splitlines()[-1])
        assert rep.pop("output") == out_path
        reports.append(rep)
    assert reports[0] == reports[1]
    rc, _out, err = _cli(tmain, ["telemetry", "stitch", "--fleet", "--path",
                                 str(tmp_path / "nothing-here")])
    assert rc == 1 and "telemetry stitch --fleet" in err
