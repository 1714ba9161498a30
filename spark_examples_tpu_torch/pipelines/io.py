"""Output writers: coordinate TSVs and self-describing matrices (a
``<path>.meta.json`` sidecar records the sample ids and whether the
matrix holds similarities or distances). Same formats as the JAX
package's writers."""

from __future__ import annotations

import json
import os

import numpy as np


def write_coords_tsv(path: str, sample_ids: list[str],
                     coords: np.ndarray) -> None:
    """``sample<TAB>pc1<TAB>pc2...``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    k = coords.shape[1]
    with open(path, "w") as f:
        f.write("sample\t" + "\t".join(f"pc{i + 1}" for i in range(k)) + "\n")
        for sid, row in zip(sample_ids, np.asarray(coords)):
            f.write(sid + "\t" + "\t".join(f"{v:.6g}" for v in row) + "\n")


def write_matrix(path: str, sample_ids: list[str], matrix: np.ndarray,
                 kind: str | None = None) -> None:
    """Square matrix as TSV (header row of sample ids) or ``.npy``, plus
    the sidecar. ``kind``: similarity | distance."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, matrix)
    else:
        with open(path, "w") as f:
            f.write("sample\t" + "\t".join(sample_ids) + "\n")
            for sid, row in zip(sample_ids, np.asarray(matrix)):
                f.write(sid + "\t" + "\t".join(f"{v:.6g}" for v in row) + "\n")
    with open(path + ".meta.json", "w") as f:
        json.dump({"kind": kind, "sample_ids": list(sample_ids)}, f)
