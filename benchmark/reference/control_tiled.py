"""The tiled control's readings at a cell's own size, and beside them the
program's: for each seed, the cell's cohort, the tiled reference
(``pcoa_ref_tiled.py``), and the control, the reference one precision
below the configuration's in the program's place, judged as the
program's jobs are. Every control reading has to exceed its limit.

The control, as ``compare.control_outputs`` makes it: the reference's
exact counts finalized, squared and Gower-centered in bfloat16, tile by
tile (the row, column and grand means of the bfloat16 squares summed in
float32 and rounded to bfloat16, as a bfloat16 ``mean`` does); its top
eigenpairs from the reference's own float64 solve of that matrix; the
outputs rounded to bfloat16.

    python3 -m benchmark.reference.control_tiled --workload <cell> \\
        --seeds 11 12 13 [--program]

Prints one JSON line a seed: the control's readings, the cell's limits,
whether the control came out not correct, the reference's own seconds,
basis size and top eigenvalues, and with ``--program`` the readings of
one job of the cell's generator on the same cohort (its first window's,
after the warm job) and each card's peak memory over the two jobs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.cohort import Cohort
from benchmark.harness import Spec
from benchmark.reference.compare import judge
from benchmark.reference.pcoa_ref import ibs_distance
from benchmark.reference.pcoa_ref_tiled import (
    BAND_ROWS,
    TiledMatrix,
    TiledReference,
    block_lanczos,
    bounds,
    devices_for,
)
from benchmark.traffic.pcoa_tile2d_jobs import worst


def control_tiles(ref: TiledReference) -> dict:
    """The control's centered tiles (bfloat16 values, held as float64
    for the solve) from the reference's count tiles."""
    n = ref.b.shape[0]
    e = bounds(n)
    home = ref.b.device
    d2 = {}
    for t in ref.d1:
        out = torch.empty(ref.d1[t].shape, dtype=torch.bfloat16,
                          device=ref.d1[t].device)
        for r in range(0, out.shape[0], BAND_ROWS):
            d = ibs_distance(ref.d1[t][r:r + BAND_ROWS],
                             ref.m[t][r:r + BAND_ROWS],
                             torch.float32).to(torch.bfloat16)
            out[r:r + BAND_ROWS] = d * d
        d2[t] = out
    rows = torch.zeros(n, dtype=torch.float32, device=home)
    cols = torch.zeros(n, dtype=torch.float32, device=home)
    for (i, j), t in d2.items():
        rows[e[i]:e[i + 1]] += t.sum(dim=1, dtype=torch.float32).to(home)
        cols[e[j]:e[j + 1]] += t.sum(dim=0, dtype=torch.float32).to(home)
    grand = (rows.sum() / (n * n)).to(torch.bfloat16)
    rows = (rows / n).to(torch.bfloat16)
    cols = (cols / n).to(torch.bfloat16)
    b = {}
    for (i, j), t in d2.items():
        dev = t.device
        out = torch.empty(t.shape, dtype=torch.float64, device=dev)
        row = rows[e[i]:e[i + 1], None].to(dev)
        col = cols[None, e[j]:e[j + 1]].to(dev)
        for r in range(0, t.shape[0], BAND_ROWS):
            band = (t[r:r + BAND_ROWS] - row[r:r + BAND_ROWS] - col
                    + grand.to(dev)) * -0.5
            out[r:r + BAND_ROWS] = band.double()
        b[(i, j)] = out
    return b


def control_outputs_tiled(ref: TiledReference, k: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The control's ``(coords, vals)``."""
    n = ref.b.shape[0]
    b = TiledMatrix(control_tiles(ref), n, ref.b.device)
    vals, vecs, _, _ = block_lanczos(b.__matmul__, n, k, b.device)
    del b
    coords = vecs * torch.sqrt(vals.clamp(min=0.0))
    return (coords.to(torch.bfloat16).double().cpu().numpy(),
            vals.to(torch.bfloat16).double().cpu().numpy())


def readings(spec: Spec, cell_name: str, seed: int, device: str,
             program: bool) -> dict:
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), device=device)
    k = int(mix["num_pc"])
    devices = devices_for(device)
    out = {"workload": cell_name, "seed": seed}
    jobs = []
    if program:
        gen = importlib.import_module(
            f"benchmark.traffic.{mix['generator']}")
        traffic = gen.Traffic(config, mix, seed, device)
        try:
            traffic.setup()
            window = traffic.run_window(0.0)
            packed = traffic.packed
        finally:
            traffic.close()
        jobs = window.jobs
        out["program_failed"] = window.failed
        out["program_error"] = window.error
        out["program_phases"] = jobs[0].phases if jobs else None
        if torch.cuda.is_available():
            out["program_peak_bytes"] = [
                torch.cuda.max_memory_allocated(d)
                for d in range(torch.cuda.device_count())]
            torch.cuda.empty_cache()
    else:
        packed = Cohort(config, seed, devices[0]).to_host()
    t0 = time.perf_counter()
    ref = TiledReference(packed, k, devices, keep_counts=True)
    out["reference_s"] = time.perf_counter() - t0
    out["basis_size"] = ref.basis_size
    out["reference_vals"] = ref.vals.tolist()
    if program:
        out["program"] = worst(ref, jobs)
    t0 = time.perf_counter()
    out["readings"] = judge(ref, *control_outputs_tiled(ref, k))
    out["control_s"] = time.perf_counter() - t0
    limits = cell["limits"]
    out["limits"] = limits
    out["control_not_correct"] = any(out["readings"][n] > limits[n]
                                     for n in limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(Spec(root), args.workload, seed, device,
                       args.program)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
