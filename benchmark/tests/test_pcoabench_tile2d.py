"""The four-card tile2d cell: its configuration, cell and mix as the
spec has them, the four-chip share, a CPU drive of a tiny cell over four
virtual slots through ``run_cell``, and the readers of its per-layer
metrics."""

from __future__ import annotations

import json
import math
import time

import pytest

from benchmark.harness import RunView, Spec, run_cell
from conftest import ROOT, TINY_CELLS

CELL = "gnomad3g-76156.tile2d-4chip"
TINY = "tiny.tile2d"
NEW_METRICS = {
    "tile_fanout_s": ("tile2d.fanout", "hist"),
    "mirror_fetch_s": ("tile2d.mirror", "hist"),
    "tile_skew_frac": ("gram.tile_skew_s", "counter"),
    "tiled_product_s": ("eigh.tiled_product", "hist"),
}
APPENDED = ("pcoa_job_s", "gram_s", "gram_roofline", "k1_launch_ms",
            "feed_wait_frac", "finalize_s", "eigh_s", "eigh_solve_s",
            "device_idle_frac")
V31_GROUPS = {"AFR": 20744, "AMI": 456, "AMR": 7647, "ASJ": 1736,
              "EAS": 2604, "FIN": 5316, "MID": 158, "NFE": 34029,
              "SAS": 2419, "OTH": 1047}


def test_configuration_cell_and_mix():
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    assert cell["chips"] == 4 and cell["config"] == "gnomad3g-76156"
    config = spec.config("gnomad3g-76156")
    assert config["groups"] == V31_GROUPS
    assert sum(config["groups"].values()) == config["n_samples"] == 76156
    assert config["n_variants"] == 131072
    assert (config["fst"], config["missing_rate"], config["maf_low"]) == (
        0.1, 0.01, 0.05)
    entry = next(c for c in spec.bench["configs"]
                 if c["name"] == "gnomad3g-76156")
    assert entry["reduced"] == config["reduced"] == ["n_variants"]
    mix = spec.traffic(cell["traffic"])
    assert mix["generator"] == "pcoa_tile2d_jobs"
    assert (mix["gram_mode"], mix["mesh_shape"], mix["tile2d_transport"]
            ) == ("tile2d", [2, 2], "gather")
    assert (mix["eigh_mode"], mix["eigh_iters"], mix["eigh_oversample"]
            ) == ("auto", 8, 32)
    assert mix["feed"] == "memory" and mix["block_variants"] == 16384
    assert config["n_variants"] // mix["block_variants"] == 8
    assert set(cell["limits"]) == {"eig_gap", "resid", "orth"}


def test_metrics_list_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in APPENDED:
        assert CELL in metrics[name]["workloads"], name
    for name in NEW_METRICS:
        m = metrics[name]
        assert m["workloads"] == [CELL] and m["moves"] == "pcoa_job_s"


def test_four_chip_share():
    """At most a quarter of the cells, rounded down, ask for four chips,
    and one always may."""
    cells = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    four = sum(c["chips"] == 4 for c in cells)
    assert all(c["chips"] in (1, 4) for c in cells)
    assert four <= max(1, len(cells) // 4)


@pytest.fixture
def tile2d_root(tiny_root):
    """``tiny_root`` plus a tiny cell of the four-card cell's mix over
    four virtual slots, its solve given 40 power steps (at 48 samples the
    bulk starts near ``lam_1``)."""
    d = tiny_root / "benchmark"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    mix = json.loads((d / "traffic" / "tile2d-memory.json").read_text())
    mix.update(block_variants=1024, eigh_iters=40)
    (d / "traffic" / "tiny-tile2d.json").write_text(json.dumps(mix))
    limits = json.loads((d / "workloads" / f"{CELL}.json").read_text())[
        "limits"]
    entry = {"name": TINY, "config": "tiny", "traffic": "tiny-tile2d",
             "chips": 4, "why": "a test"}
    bench["workloads"].append(entry)
    (d / "workloads" / f"{TINY}.json").write_text(json.dumps(
        {k: v for k, v in entry.items() if k != "name"} | {"limits": limits}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_tile2d_cell_end_to_end(tile2d_root, trace):
    res = run_cell(Spec(tile2d_root), TINY, 2**33 + 7, 0.3, trace,
                   time.time(), device="cpu", log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    if not trace:
        assert names == {"pcoa_job_s", "setup_s"}
        return
    # Virtual slots of one device: no copy between cards, no second card
    # to skew against; the tiled products are host spans on the CPU.
    assert not names & {"tile_fanout_s", "mirror_fetch_s", "tile_skew_frac"}
    assert {"tiled_product_s", "gram_s", "finalize_s", "eigh_s"} <= names


def _view(hist=None, counters=None, jobs=2):
    job = type("Job", (), {"phases": {"gram": 2.0}})()
    return RunView(config={}, mix={}, jobs=[job] * jobs, window_s=10.0,
                   setup_s=1.0, n_devices=4, counters=counters or {},
                   hist_sums=hist or {})


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_reader_finds_its_span_or_counter(metric):
    read = Spec(ROOT).reader(metric)
    key, kind = NEW_METRICS[metric]
    assert read(_view()) is None
    # A name left in the process's registry by an earlier run, unmoved
    # in this window, is not a reading either.
    zero = {key: 0.0}
    assert read(_view(**{"hist" if kind == "hist" else "counters": zero})
                ) is None
    got = read(_view(**{"hist" if kind == "hist" else "counters":
                        {key: 0.8}}))
    want = 0.8 / 4.0 if kind == "counter" else 0.8 / 2
    assert math.isclose(got, want)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_one_slot_cells_do_not_gain_the_new_names(tile2d_root, cell):
    """The tiny one-slot cells list every metric the four-card cell
    lists (``conftest.py``); their traced drive, after a tile2d one in
    the same process, reads none of the new ones."""
    spec = Spec(tile2d_root)
    run_cell(spec, TINY, 2**33 + 7, 0.3, True, time.time(), device="cpu",
             log=lambda msg: None)
    res = run_cell(spec, cell, 2**33 + 5, 0.3, True, time.time(),
                   device="cpu", log=lambda msg: None)
    assert not set(res["metrics"]) & set(NEW_METRICS)
