"""One run of one cell: find the cell's files by name, make its cohort,
warm it, run the window, read the metrics and judge the outputs.

The data is read from ``<root>/BENCHMARK.json`` and the files under
``<root>/benchmark/``; the traffic generators are the modules of
``benchmark/traffic/``. A later change adds a cell, a configuration, a
mix or a metric as new files and entries, and edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

# Top-level module names no run may hold once its window has closed:
# the JAX stack and the JAX package (the port's name begins with it, so
# names are compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "spark_examples_tpu")
CELL_KEYS = ("config", "traffic", "chips", "why")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names.intersection(FORBIDDEN_MODULES))


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.bench = _read_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        """The cell's file, which has to agree with its entry in
        ``BENCHMARK.json``."""
        entries = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = _read_json(self.dir / "workloads" / f"{name}.json")
        differ = [k for k in CELL_KEYS if cell.get(k) != entries[0].get(k)]
        if differ:
            raise ValueError(f"workloads/{name}.json and BENCHMARK.json "
                             f"differ in {differ}")
        return dict(cell, name=name)

    def config(self, name: str) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return dict(_read_json(self.root / entry["file"]), name=name)

    def traffic(self, name: str) -> dict:
        return _read_json(self.dir / "traffic" / f"{name}.json")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        untraced, the per-layer ones traced, each where its
        ``workloads`` (if any) name the cell."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


@dataclass
class RunView:
    """What a metric's reader reads: the window's jobs and phases, the
    program's counters and histograms over the window, the window's
    device memory peak and, in a traced run, the trace's summary."""

    config: dict
    mix: dict
    jobs: list
    window_s: float
    setup_s: float
    n_devices: int
    peak_bytes: int | None = None
    counters: dict = field(default_factory=dict)
    hist_sums: dict = field(default_factory=dict)
    trace: dict | None = None

    def phase_total(self, name: str) -> float:
        return sum(j.phases.get(name, 0.0) for j in self.jobs)

    def phase_mean(self, name: str) -> float | None:
        if not self.jobs or not any(name in j.phases for j in self.jobs):
            return None
        return self.phase_total(name) / len(self.jobs)


def _telemetry_sums():
    from spark_examples_tpu_torch.core import telemetry

    snap = telemetry.metrics_snapshot()
    return (dict(snap["counters"]),
            {k: h.get("sum", 0.0) for k, h in snap["histograms"].items()})


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def device_info(torch, device: str, n_devices: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n_devices, "memory_peak_bytes": 0}


def run_cell(spec: Spec, name: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             log=None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``t_start``: the process's start on the ``time.time()`` clock.
    ``device``: ``cuda`` on the card; ``cpu`` drives the same run with
    the program's plain versions (the tests)."""
    import torch

    from benchmark import trace as tr

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), device=device)
    n_dev = int(cell["chips"]) if device == "cuda" else 1
    gen = importlib.import_module(f"benchmark.traffic.{mix['generator']}")
    traffic = gen.Traffic(config, mix, seed, device)
    cuda = device == "cuda"
    try:
        traffic.setup()
        if cuda:
            torch.cuda.synchronize()
            setup_peak = max(torch.cuda.max_memory_allocated(d)
                             for d in range(n_dev))
            for d in range(n_dev):
                torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.time() - t_start
        log(f"set-up {setup_s:.3f} s; window of {seconds} s")
        c0, h0 = _telemetry_sums()
        with tr.capture(trace, cuda) as cap:
            window = traffic.run_window(seconds)
        c1, h1 = _telemetry_sums()
        peak = None
        if cuda:
            peak = max(torch.cuda.max_memory_allocated(d)
                       for d in range(n_dev))
        t0 = time.perf_counter()
        summary = (tr.summarize(cap["events"], n_dev)
                   if cap["events"] is not None else None)
        cap["seconds"]["reduce"] = time.perf_counter() - t0
        view = RunView(config, mix, window.jobs, window.seconds, setup_s,
                       n_dev, peak, _delta(c1, c0), _delta(h1, h0),
                       summary)
        metrics = {}
        for m in spec.metrics(name, trace):
            val = spec.reader(m["name"])(view) if window.jobs else None
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        dev = device_info(torch, device, n_dev)
        if cuda:
            dev["memory_peak_bytes"] = int(max(setup_peak, peak))
        if summary is not None and cuda:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = window.seconds
        phases = {k: round(view.phase_mean(k), 4) for k in
                  sorted({p for j in window.jobs for p in j.phases})}
        walls = sorted(j.wall_s for j in window.jobs)
        log(f"window {window.seconds:.3f} s, {len(window.jobs)} jobs, "
            f"{window.failed} failed {window.error or ''}; mean phases "
            f"{phases}; job walls min / median / max "
            f"{walls[0]:.4f} / {walls[len(walls) // 2]:.4f} / "
            f"{walls[-1]:.4f}" if walls else "no job")
        if summary is not None:
            cost = ", ".join(f"{k} {v:.1f} s"
                             for k, v in cap["seconds"].items())
            log(f"trace: {summary['device_events']} device events of "
                f"{len(cap['events'])}, busy {summary['busy_s']:.3f} s; "
                f"{cost}")
        t0 = time.perf_counter()
        readings = traffic.check(window) if window.jobs else {}
        log(f"reference and comparison {time.perf_counter() - t0:.3f} s")
    finally:
        traffic.close()
    limits = cell["limits"]
    checks = {k: {"value": readings.get(k, math.inf), "limit": limits[k]}
              for k in limits}
    correct = (window.failed == 0 and bool(window.jobs)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result
