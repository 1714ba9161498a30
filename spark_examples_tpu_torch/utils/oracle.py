"""CPU oracle: plain NumPy implementations for parity tests, and the
host backend that stands in for the reference baseline.

Two tiers, as in the JAX package's ``utils/oracle.py``:

- ``naive_*``: direct per-pair loops over variants with explicit
  missing handling. Slow, tiny inputs only; they define the semantics
  the matmul reformulation must match.
- ``cpu_*``: vectorized NumPy, the same operands and combine algebra as
  the device route, accumulated in float64 (every count is an exact
  integer below 2^53). This is ``--backend cpu-reference``: the user's
  explicit choice of a host route that touches no device, and the
  measured stand-in for the Spark MLlib baseline.

The oracle keeps its own NumPy copies of the operand and combine tables
(:data:`PRODUCT_OPERANDS`, :data:`PIECE_PRODUCTS`, :func:`operands`,
:func:`combine_products`) instead of calling the port's torch
``ops/genotype.py``: it must stay independent of the code it judges.
Only the registry's ``np_finalize`` twins (``kernels``) are shared, as
in the JAX package.
"""

from __future__ import annotations

import numpy as np

# raw product name -> (left operand, right operand): one A B^T each.
PRODUCT_OPERANDS: dict[str, tuple[str, str]] = {
    "cc": ("c", "c"),
    "t1c": ("t1", "c"),
    "t2c": ("t2", "c"),
    "yc": ("y", "c"),
    "qc": ("qr", "c"),
    "yy": ("yr", "yr"),
    "t1t1": ("t1", "t1"),
    "t1t2": ("t1", "t2"),
    "t2t2": ("t2", "t2"),
}

# statistic -> raw products it needs.
PIECE_PRODUCTS: dict[str, tuple[str, ...]] = {
    "m": ("cc",),
    "s": ("t1t1",),
    "sc": ("t1c",),
    "d1": ("yc", "t1t1", "t2t2"),
    "ibs2": ("cc", "t1c", "t1t1", "t1t2", "t2t2"),
    "dot": ("yy",),
    "e2": ("qc", "yy"),
    "hh": ("t1t1", "t1t2", "t2t2"),
    "opp": ("t2c", "t1t2"),
    "hc": ("t1c", "t2c"),
}


# ----------------------------------------------------------------- naive

def naive_pairwise(genotypes: np.ndarray):
    """Per-pair statistics by explicit iteration. genotypes: (N, V) int8.

    Returns dict of (N, N) f64: m (valid pairs), d1 (sum |a-b|), s
    (shared-alt count), ibs2 (exact matches), dot, e2.
    """
    g = genotypes.astype(np.int64)
    n = g.shape[0]
    out = {k: np.zeros((n, n)) for k in ("m", "d1", "s", "ibs2", "dot", "e2")}
    for i in range(n):
        for j in range(n):
            a, b = g[i], g[j]
            valid = (a >= 0) & (b >= 0)
            av, bv = a[valid], b[valid]
            out["m"][i, j] = valid.sum()
            out["d1"][i, j] = np.abs(av - bv).sum()
            out["s"][i, j] = ((av >= 1) & (bv >= 1)).sum()
            out["ibs2"][i, j] = (av == bv).sum()
            out["dot"][i, j] = (av * bv).sum()
            out["e2"][i, j] = ((av - bv) ** 2).sum()
    return out


def naive_ibs_distance(genotypes: np.ndarray) -> np.ndarray:
    p = naive_pairwise(genotypes)
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.where(p["m"] > 0, p["d1"] / (2.0 * p["m"]), 0.0)
    return d


def naive_king(genotypes: np.ndarray) -> np.ndarray:
    """KING-robust kinship by explicit per-pair counting, not derived
    from the combine algebra (between-family estimator over
    pairwise-complete variants; self-kinship 0.5)."""
    g = genotypes.astype(np.int64)
    n = g.shape[0]
    phi = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            valid = (g[i] >= 0) & (g[j] >= 0)
            a, b = g[i][valid], g[j][valid]
            het_het = int(((a == 1) & (b == 1)).sum())
            opp = int((((a == 0) & (b == 2)) | ((a == 2) & (b == 0))).sum())
            den = int((a == 1).sum() + (b == 1).sum())
            phi[i, j] = (het_het - 2 * opp) / den if den > 0 else 0.0
    np.fill_diagonal(phi, 0.5)
    return phi


def naive_jaccard(genotypes: np.ndarray) -> np.ndarray:
    """Carrier-set Jaccard by explicit per-pair set algebra over
    pairwise-complete variants; an empty union scores 1."""
    g = genotypes.astype(np.int64)
    n = g.shape[0]
    sim = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            valid = (g[i] >= 0) & (g[j] >= 0)
            a = g[i][valid] >= 1
            b = g[j][valid] >= 1
            union = int((a | b).sum())
            sim[i, j] = (a & b).sum() / union if union > 0 else 1.0
    return sim


def naive_braycurtis(x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            num = np.abs(x[i] - x[j]).sum()
            den = (x[i] + x[j]).sum()
            d[i, j] = num / den if den > 0 else 0.0
    return d


def naive_grm(genotypes: np.ndarray) -> np.ndarray:
    """VanRaden GRM with in-matrix allele frequencies, mean-imputed
    missing: the grm kernel's update run as one block."""
    g = genotypes.astype(np.float64)
    valid = g >= 0
    y = np.where(valid, g, 0.0)
    cnt = valid.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(cnt > 0, y.sum(axis=0) / (2.0 * cnt), 0.0)
    denom = 2.0 * p * (1.0 - p)
    keep = (denom > 1e-8) & (cnt > 1)
    scale = np.where(keep, 1.0 / np.sqrt(np.maximum(denom, 1e-8)), 0.0)
    z = np.where(valid, (y - 2.0 * p) * scale, 0.0)
    return (z @ z.T) / max(keep.sum(), 1)


# ------------------------------------------------------- centering / eig

def center_matrix(a: np.ndarray) -> np.ndarray:
    return a - a.mean(1, keepdims=True) - a.mean(0, keepdims=True) + a.mean()


def pcoa(distance: np.ndarray, k: int = 10):
    """Classical MDS: returns (coords, eigenvalues, proportion)."""
    b = -0.5 * center_matrix(distance.astype(np.float64) ** 2)
    vals, vecs = np.linalg.eigh(b)
    vals, vecs = vals[::-1][:k], vecs[:, ::-1][:, :k]
    pos = np.maximum(vals, 0.0)
    coords = vecs * np.sqrt(pos)[None, :]
    prop = pos / max(np.trace(b), 1e-30)
    return coords, vals, prop


def pca_mllib_route(similarity: np.ndarray, k: int = 10,
                    return_values: bool = False):
    """The reference's literal route: center, column covariance,
    eigenvectors, project rows.

    ``return_values``: also return the matrix eigenvalues of centered C
    (signed: the square root of the covariance spectrum times the sign
    of the Rayleigh quotient), so the host backend reports a real
    spectrum.
    """
    c = center_matrix(similarity.astype(np.float64))
    cov = (c.T @ c) / c.shape[0]
    vals, vecs = np.linalg.eigh(cov)
    vals, vecs = vals[::-1][:k], vecs[:, ::-1][:, :k]
    coords = c @ vecs  # (N, k) projections
    if not return_values:
        return coords
    # cov = C^2 / n for symmetric C, so |lambda_C| = sqrt(n * lambda_cov);
    # the sign is the Rayleigh quotient's sign.
    signs = np.sign(np.einsum("ij,ij->j", vecs, coords))
    matrix_vals = signs * np.sqrt(np.maximum(vals * c.shape[0], 0.0))
    return coords, matrix_vals


# --------------------------------------------------------- cpu backend

def operands(block: np.ndarray) -> dict[str, np.ndarray]:
    """(N, V) int8 values -> the float64 matmul operands. A missing call
    (any negative value) contributes zero to every operand, which gives
    the pairwise-complete semantics; ``yr``/``qr`` carry the raw masked
    value and its square (exact for arbitrary int8 tables)."""
    valid = block >= 0
    c = valid.astype(np.float64)
    t1 = (block >= 1).astype(np.float64)
    t2 = (block >= 2).astype(np.float64)
    yr = (valid * block).astype(np.float64)
    return {"c": c, "t1": t1, "t2": t2, "y": t1 + t2, "yr": yr,
            "qr": yr * yr}


def combine_products(prod: dict, pieces: tuple[str, ...]) -> dict:
    """Accumulated raw products -> named pairwise statistics (the JAX
    package's ``ops/genotype.py::combine_products``, on NumPy arrays)."""
    out = {}
    for piece in pieces:
        if piece == "m":
            out["m"] = prod["cc"]
        elif piece == "s":
            out["s"] = prod["t1t1"]
        elif piece == "sc":
            out["sc"] = prod["t1c"]
        elif piece == "d1":
            p = prod["t1t1"] + prod["t2t2"]
            out["d1"] = prod["yc"] + prod["yc"].T - 2 * p
        elif piece == "ibs2":
            out["ibs2"] = (
                prod["cc"] - prod["t1c"] - prod["t1c"].T
                + 2 * prod["t1t1"] - prod["t1t2"] - prod["t1t2"].T
                + 2 * prod["t2t2"]
            )
        elif piece == "dot":
            out["dot"] = prod["yy"]
        elif piece == "e2":
            out["e2"] = prod["qc"] + prod["qc"].T - 2 * prod["yy"]
        elif piece == "hh":
            out["hh"] = (
                prod["t1t1"] - prod["t1t2"] - prod["t1t2"].T
                + prod["t2t2"]
            )
        elif piece == "opp":
            out["opp"] = (
                prod["t2c"] + prod["t2c"].T
                - prod["t1t2"] - prod["t1t2"].T
            )
        elif piece == "hc":
            out["hc"] = prod["t1c"] - prod["t2c"]
        else:
            raise ValueError(f"unknown statistic {piece!r}")
    return out


def cpu_gram_products(genotypes: np.ndarray, products: tuple[str, ...]):
    """The raw products ``products`` of one (N, V) block, float64: one
    matmul each (``qc`` too, where the integer path splits it into two
    int8 contractions)."""
    ops = operands(genotypes)
    return {
        p: ops[PRODUCT_OPERANDS[p][0]] @ ops[PRODUCT_OPERANDS[p][1]].T
        for p in products
    }


def cpu_gram_pieces(genotypes: np.ndarray,
                    pieces: tuple[str, ...] | None = None):
    """Raw products, then the combine step -> named statistics (f64)."""
    if pieces is None:
        pieces = tuple(PIECE_PRODUCTS)
    needed = tuple(
        sorted({p for piece in pieces for p in PIECE_PRODUCTS[piece]})
    )
    return combine_products(cpu_gram_products(genotypes, needed), pieces)


def cpu_finalize(acc: dict, metric: str) -> dict:
    """Statistics -> ``{"similarity", "distance"}`` through the kernel's
    registered ``np_finalize`` (the NumPy twin declared beside its torch
    finalize in ``kernels``)."""
    from spark_examples_tpu_torch import kernels

    kern = kernels.maybe_get(metric)
    if kern is None or kern.np_finalize is None:
        raise ValueError(f"unknown metric {metric!r}")
    return kern.np_finalize(acc)


def cpu_braycurtis(x: np.ndarray) -> np.ndarray:
    from scipy.spatial.distance import pdist, squareform

    d = squareform(pdist(x.astype(np.float64), metric="braycurtis"))
    return np.nan_to_num(d, nan=0.0)


def gower_f32(similarity: np.ndarray) -> np.ndarray:
    """The Gower transform ``sqrt(max(s_ii + s_jj - 2 s_ij, 0))`` in
    float32, as the JAX package's cpu-reference route takes it for a
    float-family similarity and a persisted similarity matrix (its
    ``ops/distances.py`` runs in f32)."""
    s = np.asarray(similarity, dtype=np.float32)
    diag = np.diagonal(s)
    d2 = diag[:, None] + diag[None, :] - np.float32(2.0) * s
    return np.sqrt(np.maximum(d2, np.float32(0.0)))
