"""PCA on the similarity matrix, the flagship variants-PCA math:
N x N shared-alt similarity -> center by row/col/grand means -> one
symmetric eigh -> the top k eigenpairs by |lambda| -> projections.

For a symmetric centered matrix C, the covariance route (eigenvectors v
of C^T C / n, then the projection C v) is this spectral route:
eigenvectors of C^2 are those of C ordered by |lambda|, and C v =
lambda v. So one eigh of C gives the same coordinates (up to per-column
sign) at half the work.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_examples_tpu_torch.core.profiling import check_nans
from spark_examples_tpu_torch.ops.centering import center_matrix


@dataclass
class PCAResult:
    coords: torch.Tensor  # (N, k) projections onto the top components
    eigenvalues: torch.Tensor  # (k,) matrix eigenvalues, by descending |.|


def fit_pca(similarity: torch.Tensor, k: int = 10) -> PCAResult:
    c = center_matrix(similarity)
    c = 0.5 * (c + c.T)  # guard symmetry against accumulation round-off
    check_nans("centering", c)
    vals, vecs = torch.linalg.eigh(c)
    order = torch.argsort(-torch.abs(vals), stable=True)[:k]
    vals_k = vals[order]
    coords = vecs[:, order] * vals_k[None, :]  # projection C v = lambda v
    check_nans("eigh", vals_k, coords)
    return PCAResult(coords, vals_k)
