"""``BENCHMARK.json`` against the rules it is written to (names, units,
files found by name, bounds), the import boundary of everything under
``benchmark/``, and the trace reduction on a hand-made trace."""

from __future__ import annotations

import ast
import json
import re

import pytest

from benchmark import trace
from benchmark.harness import Spec
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
# Top-level imports nothing under benchmark/ may make: the JAX stack, the
# JAX package, and the repository's older harnesses.
FORBIDDEN = {"jax", "jaxlib", "flax", "spark_examples_tpu", "bench",
             "bench_torch", "chip_smoke", "tools"}
PROGRAM = "spark_examples_tpu_torch"


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [w[k] for w in BENCH["workloads"]
                for k in ("config", "traffic")]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_shape_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for text in [c["why"] for c in BENCH["configs"]] + [
            c["source"] for c in BENCH["configs"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\t" not in text


def test_every_name_has_its_files():
    spec = Spec(ROOT)
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        config = spec.config(cell["config"])
        assert config["reduced"] == next(
            c["reduced"] for c in BENCH["configs"]
            if c["name"] == cell["config"])
        mix = spec.traffic(cell["traffic"])
        assert (ROOT / "benchmark" / "traffic" /
                f"{mix['generator']}.py").exists()
        assert set(cell["limits"]) == {"eig_gap", "resid", "orth"}
    for m in METRICS:
        assert callable(spec.reader(m["name"]))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_import_boundary(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.parts:
        assert PROGRAM not in tops


def test_summarize_a_hand_made_trace():
    def ev(cat, name, ts, dur, device=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if device is not None:
            e["args"] = {"device": device}
        return e

    events = [
        ev("user_annotation", "phase.gram", 0, 100),
        ev("user_annotation", "phase.eigh", 150, 50),
        ev("kernel", "k1", 10, 20, 0), ev("kernel", "k1", 25, 20, 0),
        ev("gpu_memcpy", "copy", 60, 10, 0),
        ev("kernel", "syevd", 160, 30, 0),
        ev("kernel", "k1", 10, 40, 1),
        ev("cpu_op", "aten::mm", 0, 500),
    ]
    s = trace.summarize(events, n_devices=2)
    # Card 0: [10, 45] + [60, 70] + [160, 190] = 75 us; card 1: 40 us.
    assert s["busy_s"] == pytest.approx((75 + 40) / 2 * 1e-6)
    assert s["phase_kernel_s"]["gram"] == pytest.approx(80e-6)
    assert s["phase_kernel_s"]["eigh"] == pytest.approx(30e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(80e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["phase.gram"] == pytest.approx(15e-6)
    assert gaps["between_phases"] == pytest.approx(90e-6)
