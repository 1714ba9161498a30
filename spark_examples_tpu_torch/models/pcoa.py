"""PCoA (classical MDS): distance -> D^2 -> double-center -> symmetric
eig -> coords_i = eigvec_i * sqrt(lambda_i), negative eigenvalues
clamped to zero coordinates."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_examples_tpu_torch.core.config import (
    EIGH_ITERS_DEFAULT,
    EIGH_OVERSAMPLE_DEFAULT,
)
from spark_examples_tpu_torch.core.profiling import check_nans
from spark_examples_tpu_torch.ops.centering import gower_center
from spark_examples_tpu_torch.ops.eigh import (
    coords_from_eigpairs,
    randomized_eigh,
    top_k_eigh,
)


@dataclass
class PCoAResult:
    coords: torch.Tensor  # (N, k) principal coordinates
    eigenvalues: torch.Tensor  # (k,) descending
    proportion_explained: torch.Tensor  # (k,) share of total inertia


def fit_pcoa(
    distance: torch.Tensor,
    k: int = 10,
    method: str = "dense",
    iters: int = EIGH_ITERS_DEFAULT,
    oversample: int = EIGH_OVERSAMPLE_DEFAULT,
    probes: torch.Tensor | None = None,
) -> PCoAResult:
    """PCoA on an (N, N) distance matrix. ``method``: dense | randomized.
    The randomized probes default to a ``torch.Generator`` seeded 0 on
    the distance's device, so results on that route differ from the JAX
    package's (whose probes come from ``jax.random.key(0)``); pass
    ``probes`` to fix them."""
    b = gower_center(distance)
    check_nans("centering", b)
    trace = torch.trace(b)  # total inertia = sum of all eigenvalues
    if method == "dense":
        vals, vecs = top_k_eigh(b, k)
    elif method == "randomized":
        vals, vecs = randomized_eigh(b, k, probes=probes,
                                     oversample=oversample, iters=iters)
    else:
        raise ValueError(f"unknown eigh method {method!r}")
    check_nans("eigh", vals, vecs)
    coords = coords_from_eigpairs(vals, vecs)
    prop = torch.clamp(vals, min=0.0) / torch.clamp(trace, min=1e-30)
    return PCoAResult(coords, vals, prop)
