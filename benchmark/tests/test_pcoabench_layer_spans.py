"""The readers of the program's feed, gram-stream, K1 and eigensolve
spans, on hand-built run views: each reads its span or counter over the
window's jobs, and finds nothing without it or without a job."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import RunView, Spec
from conftest import ROOT

CELL = "gnomad2g-15708.chr22-memory"
JOBS = 4
HISTS = {"feed.read": 0.8, "feed.pin": 1.2, "feed.copy": 0.32,
         "kernel.packed_gram.launch": 10.24, "eigh.solve": 9.0,
         "prefetch.get_wait_s": 3.0}
COUNTERS = {"gram.device_gap_s": 2.6, "kernel.packed_gram.launches": 256.0}
# metric: (the value from HISTS and COUNTERS over JOBS jobs, the names it
# reads).
READINGS = {
    "feed_read_s": (0.2, ("feed.read",)),
    "feed_pin_s": (0.3, ("feed.pin",)),
    "feed_copy_s": (0.08, ("feed.copy",)),
    "gram_gap_s": (0.65, ("gram.device_gap_s",)),
    "k1_launch_ms": (40.0, ("kernel.packed_gram.launch",
                            "kernel.packed_gram.launches")),
    "eigh_solve_s": (2.25, ("eigh.solve",)),
}


def _view(jobs=JOBS, drop=()):
    return RunView(config={}, mix={}, jobs=[object()] * jobs, window_s=51.0,
                   setup_s=20.0, n_devices=1,
                   counters={k: v for k, v in COUNTERS.items()
                             if k not in drop},
                   hist_sums={k: v for k, v in HISTS.items()
                              if k not in drop})


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_reads_its_span_or_counter(metric):
    read = Spec(ROOT).reader(metric)
    want, names = READINGS[metric]
    assert read(_view()) == pytest.approx(want)
    for name in names:
        assert read(_view(drop=(name,))) is None, name
    assert read(_view(jobs=0)) is None


def test_no_launch_no_time_a_launch():
    view = _view()
    view.counters["kernel.packed_gram.launches"] = 0.0
    assert Spec(ROOT).reader("k1_launch_ms")(view) is None


def test_entries_name_the_cell_and_an_existing_layer():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    layers = {m["layer"] for m in per_layer.values()
              if m["name"] not in READINGS}
    for metric in READINGS:
        m = per_layer[metric]
        assert m["workloads"] == [CELL] and m["moves"] == "pcoa_job_s"
        assert m["layer"] in layers, m["layer"]
