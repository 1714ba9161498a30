"""Double-centering: B = -1/2 J D^2 J with J = I - 11^T/n, done as
row/column/grand mean subtraction (J is never materialised)."""

from __future__ import annotations

import torch


def center_matrix(a: torch.Tensor) -> torch.Tensor:
    """J A J: subtract row means, col means, add grand mean."""
    row = a.mean(dim=1, keepdim=True)
    col = a.mean(dim=0, keepdim=True)
    grand = a.mean()
    return a - row - col + grand


def gower_center(distance: torch.Tensor) -> torch.Tensor:
    """B = -1/2 J D^2 J from a distance matrix D (classical MDS / PCoA)."""
    return -0.5 * center_matrix(distance * distance)
