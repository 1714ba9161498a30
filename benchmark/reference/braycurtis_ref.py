"""The plain reference of a Bray-Curtis PCoA job, worked out again from
the count table's CSR bytes (row offsets, feature indices, counts).

Frozen arithmetic the job must reproduce, in plain PyTorch (no kernel
of the program, nothing of its table source):

- the Manhattan numerator ``sum_f |x_if - x_jf|``, exact: for
  nonnegative integer counts it is ``T_i + T_j - 2 sum_f min(x_if,
  x_jf)`` with ``T`` the row totals, and the min-sum is a product of
  0/1 level indicators, ``sum_f sum_t [x_if >= t] [x_jf >= t]``. A
  level of a feature that fewer than two samples reach adds to the
  diagonal only, whose numerator is 0, so the columns kept are the
  levels ``t <= s2_f``, ``s2_f`` the feature's second largest count.
  The columns are contracted in bands as int8 products with int32 sums
  (``pcoa_ref.int_gemm``: ``torch._int_mm`` on a card, float64 on the
  CPU), exact while a min-sum stays below 2^31;
- the Bray-Curtis ratio ``num / (T_i + T_j)`` (0 where both totals are
  0), Gower centering (``pcoa_ref.gower_center``) and the top-k
  eigenvalues (``pcoa_ref.top_eigenvalues``), all in float64.

TF32 is off for the products this module makes.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.pcoa_ref import gower_center, int_gemm, top_eigenvalues

# Indicator columns contracted per step: operands of (N, BAND) int8.
BAND_COLUMNS = 1 << 16


def _csr(indptr, indices, counts, device):
    """The CSR arrays on ``device``, with each nonzero's row."""
    ptr = torch.as_tensor(np.asarray(indptr), dtype=torch.int64,
                          device=device)
    col = torch.as_tensor(np.asarray(indices), dtype=torch.int64,
                          device=device)
    cnt = torch.as_tensor(np.asarray(counts), dtype=torch.int64,
                          device=device)
    n = ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(n, device=device),
                                  ptr.diff())
    return n, row, col, cnt


def dense_table(indptr, indices, counts, n_features: int, device,
                dtype=torch.float64) -> torch.Tensor:
    """The (N, F) table of the CSR arrays."""
    n, row, col, cnt = _csr(indptr, indices, counts, device)
    out = torch.zeros((n, n_features), dtype=dtype, device=device)
    out[row, col] = cnt.to(dtype)
    return out


def row_totals(indptr, counts, device) -> torch.Tensor:
    """Each row's total count, (N,) int64."""
    ptr = torch.as_tensor(np.asarray(indptr), dtype=torch.int64)
    cum = torch.zeros(len(counts) + 1, dtype=torch.int64)
    torch.cumsum(torch.as_tensor(np.asarray(counts), dtype=torch.int64),
                 dim=0, out=cum[1:])
    return (cum[ptr[1:]] - cum[ptr[:-1]]).to(device)


def _second_largest(col, cnt, n_features: int) -> torch.Tensor:
    """Each feature's second largest count over the samples (its largest
    when two samples share it), (F,) int64."""
    first = torch.zeros(n_features, dtype=torch.int64, device=col.device)
    first.scatter_reduce_(0, col, cnt, "amax")
    at_max = cnt == first[col]
    ties = torch.bincount(col[at_max], minlength=n_features)
    second = torch.zeros_like(first)
    second.scatter_reduce_(0, col, torch.where(at_max, 0, cnt), "amax")
    return torch.where(ties >= 2, first, second)


def min_sums(indptr, indices, counts, n_features: int, device,
             band: int = BAND_COLUMNS) -> torch.Tensor:
    """``sum_f min(x_if, x_jf)`` off the diagonal, (N, N) int32 (the
    diagonal holds only the levels two samples reach)."""
    n, row, col, cnt = _csr(indptr, indices, counts, device)
    levels = _second_largest(col, cnt, n_features)
    first_col = torch.cumsum(levels, 0) - levels
    # One indicator a nonzero and a kept level of its feature.
    ones = torch.minimum(cnt, levels[col])
    owner = torch.repeat_interleave(torch.arange(len(cnt), device=device),
                                    ones)
    start = torch.cumsum(ones, 0) - ones
    where = first_col[col[owner]] + (
        torch.arange(len(owner), device=device) - start[owner])
    where, order = torch.sort(where)
    rows = row[owner[order]]
    del owner, start, order
    total = int(levels.sum())
    edges = torch.searchsorted(
        where, torch.arange(0, total + band, band, device=device))
    out = torch.zeros((n, n), dtype=torch.int32, device=device)
    for b in range(len(edges) - 1):
        lo, hi = int(edges[b]), int(edges[b + 1])
        if lo == hi:
            continue
        width = min(band, total - b * band)
        ind = torch.zeros((n, -(-width // 8) * 8), dtype=torch.int8,
                          device=device)
        ind[rows[lo:hi], where[lo:hi] - b * band] = 1
        out += int_gemm(ind, ind)
        del ind
    return out


def manhattan(indptr, indices, counts, n_features: int,
              device) -> torch.Tensor:
    """The exact numerator ``sum_f |x_if - x_jf|``, (N, N) float64."""
    t = row_totals(indptr, counts, device)
    num = (t[:, None] + t[None, :]
           - 2 * min_sums(indptr, indices, counts, n_features, device))
    num.fill_diagonal_(0)
    return num.to(torch.float64)


def braycurtis(num: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """``num / (T_i + T_j)``, 0 where both totals are 0, in ``num``'s
    type."""
    den = (totals[:, None] + totals[None, :]).to(num.dtype)
    return torch.where(den > 0, num / den, torch.zeros((), dtype=num.dtype,
                                                       device=num.device))


class Reference:
    """The reference's centered matrix ``b`` and top-k eigenvalues
    ``vals`` of a count table, with its CSR arrays kept for the
    control."""

    def __init__(self, indptr, indices, counts, n_features: int, k: int,
                 device):
        self.csr = (indptr, indices, counts, int(n_features))
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            num = manhattan(indptr, indices, counts, n_features, device)
            d = braycurtis(num, row_totals(indptr, counts, device))
            del num
            self.b = gower_center(d)
            del d
            self.vals = top_eigenvalues(self.b, k)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
