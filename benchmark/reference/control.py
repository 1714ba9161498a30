"""The control's readings at a cell's own size: for each seed, the cell's
cohort, the reference, and the control (the reference one precision
below the configuration's, ``compare.control_outputs``) judged as the
program's jobs are. Every reading has to exceed its limit.

    python3 -m benchmark.reference.control --workload <cell> \
        --seeds 11 12 13

Prints one JSON line a seed: the readings, the cell's limits and
whether the control came out not correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark.cohort import Cohort
from benchmark.harness import Spec
from benchmark.reference.compare import control_outputs, judge
from benchmark.reference.pcoa_ref import Reference


def control_readings(spec: Spec, cell_name: str, seed: int,
                     device) -> dict:
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    packed = Cohort(config, seed, device).to_host()
    ref = Reference(packed, int(mix["num_pc"]), device)
    readings = judge(ref, *control_outputs(ref))
    limits = cell["limits"]
    failed = any(readings[k] > limits[k] for k in limits)
    return {"workload": cell_name, "seed": seed, "readings": readings,
            "limits": limits, "control_not_correct": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    device = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_readings(Spec(root), args.workload, seed, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
