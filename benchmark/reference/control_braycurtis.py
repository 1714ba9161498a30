"""The Bray-Curtis control's readings at a cell's own size: for each seed,
the cell's count table, the reference (``braycurtis_ref.py``) and the
control, judged as the program's jobs are. Every reading has to exceed
its limit.

The control is the reference one precision below the configuration's
float32, in the program's place: the table in bfloat16 (counts above
256 rounded), its Manhattan numerator summed exactly and rounded to
bfloat16, the totals, the Bray-Curtis ratio, the squares and the
centering in bfloat16, the eigensolve of that matrix in float32
(``torch.linalg.eigh`` needs it), the outputs rounded to bfloat16.

    python3 -m benchmark.reference.control_braycurtis --workload <cell> \\
        --seeds 11 12 13

Prints one JSON line a seed: the readings, the cell's limits, whether
the control came out not correct, and the reference's own seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.community import Community
from benchmark.harness import Spec
from benchmark.reference.braycurtis_ref import (
    Reference,
    braycurtis,
    manhattan,
    row_totals,
)
from benchmark.reference.compare import judge
from benchmark.reference.pcoa_ref import gower_center


def control_outputs(ref: Reference) -> tuple[np.ndarray, np.ndarray]:
    """The control's ``(coords, vals)`` from the reference's CSR
    arrays."""
    indptr, indices, counts, n_features = ref.csr
    device = ref.b.device
    k = ref.vals.shape[0]
    rounded = torch.as_tensor(np.asarray(counts)).to(torch.bfloat16).to(
        torch.int64).numpy()
    num = manhattan(indptr, indices, rounded, n_features, device).to(
        torch.bfloat16)
    totals = row_totals(indptr, rounded, device).float().to(torch.bfloat16)
    d = braycurtis(num, totals)
    del num
    b = gower_center(d)
    del d
    vals, vecs = torch.linalg.eigh(b.float())
    del b
    vals, vecs = vals.flip(0)[:k], vecs.flip(1)[:, :k]
    coords = vecs * torch.sqrt(vals.clamp(min=0.0))
    return (coords.to(torch.bfloat16).double().cpu().numpy(),
            vals.to(torch.bfloat16).double().cpu().numpy())


def control_readings(spec: Spec, cell_name: str, seed: int,
                     device) -> dict:
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    indptr, indices, counts = Community(config, seed, device).csr()
    t0 = time.perf_counter()
    ref = Reference(indptr, indices, counts, int(config["n_features"]),
                    int(mix["num_pc"]), device)
    reference_s = time.perf_counter() - t0
    readings = judge(ref, *control_outputs(ref))
    limits = cell["limits"]
    failed = any(readings[k] > limits[k] for k in limits)
    return {"workload": cell_name, "seed": seed, "readings": readings,
            "limits": limits, "control_not_correct": failed,
            "reference_s": reference_s, "nnz": int(indptr[-1])}


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
