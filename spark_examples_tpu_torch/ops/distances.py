"""Distance / similarity finalization of the accumulated gram products."""

from __future__ import annotations

import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.ops import gram


def finalize(acc: dict, metric: str) -> dict[str, torch.Tensor]:
    """Raw-product accumulators -> {"similarity", "distance"} (N, N) f32:
    the integer-exact combine, then the kernel's declared finalize (e.g.
    ibs: ``distance = d1 / (2m)`` over pairwise-complete variants,
    zero-overlap pairs -> distance 0)."""
    kern = kernels.get(metric)
    if kern.finalize is None:
        raise ValueError(
            f"the finalize of metric {metric!r} is not yet ported; "
            f"finalizable kernels: {' | '.join(kernels.finalizable_names())}"
        )
    return kern.finalize(gram.combine(acc, metric))


def similarity_to_distance(s: torch.Tensor) -> torch.Tensor:
    """Gower transform: d_ij = sqrt(s_ii + s_jj - 2 s_ij) (>= 0 for PSD s)."""
    diag = torch.diagonal(s)
    d2 = diag[:, None] + diag[None, :] - 2.0 * s
    return torch.sqrt(torch.clamp(d2, min=0.0))
