"""Output writers and the matrix reader: coordinate TSVs and
self-describing matrices (a ``<path>.meta.json`` sidecar records the
sample ids and whether the matrix holds similarities or distances), so
the similarity -> ``pcoa --matrix-path`` handoff cannot center a
similarity matrix as if it held distances. Same formats as the JAX
package's."""

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
                 kind: str | None = None,
                 col_ids: list[str] | None = None) -> None:
    """Matrix as TSV (header row of column ids) or ``.npy``, plus the
    sidecar. ``kind``: similarity | distance. ``col_ids``: for a
    rectangular matrix whose columns index another cohort than its rows
    (cross-kinship); a square matrix leaves it None (columns = rows)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = col_ids if col_ids is not None else sample_ids
    if path.endswith(".npy"):
        np.save(path, matrix)
    else:
        with open(path, "w") as f:
            f.write("sample\t" + "\t".join(cols) + "\n")
            for sid, row in zip(sample_ids, np.asarray(matrix)):
                f.write(sid + "\t" + "\t".join(f"{v:.6g}" for v in row) + "\n")
    meta = {"kind": kind, "sample_ids": list(sample_ids)}
    if col_ids is not None:
        meta["col_ids"] = list(col_ids)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def read_matrix(path: str) -> tuple[list[str], np.ndarray, str | None]:
    """Inverse of :func:`write_matrix` for square matrices: (sample ids,
    matrix, kind or None). A ``.npy`` file without a sidecar gets the ids
    ``S000000, ...``; a TSV reads its header row. A rectangular
    cross-cohort matrix (its sidecar names ``col_ids``) is refused: rows
    and columns must index one cohort."""
    kind = None
    sidecar_ids = None
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        kind = meta.get("kind")
        sidecar_ids = meta.get("sample_ids")
        if meta.get("col_ids") is not None:
            raise ValueError(
                f"{path}: rectangular cross-cohort matrix (rows and "
                "columns index different cohorts) — not consumable by "
                "the square-matrix jobs (pcoa --matrix-path)"
            )
    if path.endswith(".npy"):
        m = np.load(path)
        ids = sidecar_ids or [f"S{i:06d}" for i in range(m.shape[0])]
        return ids, m, kind
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")[1:]
        rows = [line.rstrip("\n").split("\t")[1:] for line in f]
    m = np.asarray(rows, dtype=np.float64)
    if m.shape[0] != m.shape[1]:
        raise ValueError(
            f"{path}: matrix is {m.shape[0]}x{m.shape[1]} — read_matrix "
            "serves the square similarity/distance handoff only"
        )
    return header, m, kind
