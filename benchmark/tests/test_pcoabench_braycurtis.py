"""The Bray-Curtis cell on the CPU: its generator and traffic driven end
to end at a tiny cut of its configuration, its reference against its
control, the community model's rows, and the three readers it adds
(``k2_launch_ms``, ``k2_roofline``, ``table_upload_s``) on hand-built
run views."""

from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import roofline_k2
from benchmark.community import Community
from benchmark.harness import RunView, Spec, run_cell
from benchmark.reference.control_braycurtis import control_readings
from conftest import ROOT

CELL = "emp-10k.braycurtis-memory"
TINY = dict(n_samples=301, n_features=3001, depth=1000, pool_features=800,
            groups={"soil": 76, "gut": 75, "water": 75, "plant": 75})


@pytest.fixture
def emp_root(tmp_path):
    """The repository's benchmark with the cell's configuration cut to a
    size a test run holds."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "benchmark" / "configs" / "emp-10k.json"
    config = json.loads(path.read_text())
    config.update(TINY)
    path.write_text(json.dumps(config))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_end_to_end_on_the_cpu(emp_root, trace):
    res = run_cell(Spec(emp_root), CELL, 2**33 + 11, 0.3, trace,
                   time.time(), device="cpu", log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    if not trace:
        assert names == {"pcoa_job_s", "setup_s"}
        return
    # No device trace and no K2 on the CPU: those readers find nothing.
    assert names == {"eigh_s", "eigh_solve_s", "table_upload_s"}
    assert res["metrics"]["table_upload_s"]["value"] > 0


@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_the_control_fails_where_the_reference_passes(emp_root, seed):
    out = control_readings(Spec(emp_root), CELL, seed, "cpu")
    assert out["control_not_correct"], out


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_every_row_sums_to_the_depth(seed):
    config = dict(Spec(ROOT).config("emp-10k"), **TINY)
    a = Community(config, seed, torch.device("cpu"))
    indptr, indices, counts = a.csr()
    assert (np.add.reduceat(counts, indptr[:-1]) == TINY["depth"]).all()
    assert indices.dtype == np.int32 and 0 <= indices.min()
    assert indices.max() < TINY["n_features"]
    for lo, hi in zip(indptr[:-1], indptr[1:]):
        assert np.all(np.diff(indices[lo:hi]) > 0)
    assert len(a.sample_ids) == TINY["n_samples"]
    again = Community(config, seed, torch.device("cpu")).csr()
    assert all(np.array_equal(x, y) for x, y in
               zip((indptr, indices, counts), again))


def test_the_configuration_holds_the_source_s_shapes():
    config = Spec(ROOT).config("emp-10k")
    assert config["n_samples"] == sum(config["groups"].values()) == 10_000
    assert len(config["groups"]) == 17
    assert config["depth"] == 5000
    assert config["reduced"] == ["n_features"]
    cell = Spec(ROOT).cell(CELL)
    assert cell["chips"] == 1 and cell["config"] == "emp-10k"


def _view(jobs=4, trace=None, hists=None, counters=None):
    return RunView(config={"n_samples": 10_000, "n_features": 262_144},
                   mix={"metric": "braycurtis"}, jobs=[object()] * jobs,
                   window_s=51.0, setup_s=20.0, n_devices=1,
                   counters=dict(counters or {}), hist_sums=dict(hists or {}),
                   trace=trace)


def test_k2_launch_ms_reads_its_span_over_its_launches():
    read = Spec(ROOT).reader("k2_launch_ms")
    hists = {"kernel.braycurtis.launch": 4.4}
    counters = {"kernel.braycurtis.launches": 4.0}
    assert read(_view(hists=hists, counters=counters)) == pytest.approx(1100)
    assert read(_view(hists=hists)) is None
    assert read(_view(counters=counters)) is None
    assert read(_view(jobs=0, hists=hists, counters=counters)) is None


def test_table_upload_s_reads_its_span_over_the_jobs():
    read = Spec(ROOT).reader("table_upload_s")
    assert read(_view(hists={"table.upload": 0.02})) == pytest.approx(0.005)
    assert read(_view()) is None
    assert read(_view(jobs=0, hists={"table.upload": 0.02})) is None


def test_k2_roofline_is_the_bound_over_the_distance_phase_s_kernels():
    read = Spec(ROOT).reader("k2_roofline")
    bound = roofline_k2.manhattan_bound_s(10_000, 262_144)
    # 2 N (N + 1) / 2 F FP32 instructions at 132 x 128 x 1.98 GHz.
    assert bound == pytest.approx(0.78367, rel=1e-4)
    trace = {"phase_kernel_s": {"distance": 4 * 1.1, "eigh": 3.0},
             "busy_s": 30.0}
    assert read(_view(trace=trace)) == pytest.approx(100 * bound / 1.1)
    assert read(_view(trace=None)) is None
    assert read(_view(trace={"phase_kernel_s": {"gram": 1.0}})) is None
    ibs = _view(trace=trace)
    ibs.mix = {"metric": "ibs"}
    assert read(ibs) is None


def test_the_new_entries_name_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, layer in (("k2_launch_ms", "distance"),
                        ("k2_roofline", "distance"),
                        ("table_upload_s", "table feed")):
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "pcoa_job_s"
        assert m["layer"] == layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("pcoa_job_s", "eigh_s", "eigh_solve_s",
                         "device_idle_frac"):
            assert m["workloads"][-1] == CELL
