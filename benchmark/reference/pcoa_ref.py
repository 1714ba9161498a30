"""The plain reference of an IBS PCoA job, worked out again from the
cohort's 2-bit bytes.

Frozen copies of the arithmetic the job must reproduce, written here in
plain PyTorch (no kernel, cache or tiling of the program):

- the 2-bit unpack (code 3 a missing call);
- the pair counts over pairwise-complete variants,
  ``m = C C^T`` and ``d1 = sum |a - b| = Y C^T + C Y^T - 2 (T1 T1^T +
  T2 T2^T)`` with ``C = [g >= 0]``, ``Y`` the dosage (0 where missing),
  ``T1 = [g >= 1]``, ``T2 = [g >= 2]``; exact integers, contracted as
  int8 products with int32 sums (``torch._int_mm`` on a card, float64
  on the CPU, both exact at these sizes);
- the IBS distance ``d1 / (2 m)`` (0 where ``m = 0``);
- Gower centering ``B = -1/2 J D^2 J``;
- the top-k eigenvalues of ``B`` (``torch.linalg.eigvalsh``).

Everything after the counts is float64. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

CODE_MISSING = 3
# Variants contracted per step: operands of (N, 4 x CHUNK) int8.
CHUNK_VARIANTS = 16_384


def unpack_2bit(packed: torch.Tensor) -> torch.Tensor:
    """(N, W) uint8 -> (N, 4 W) int8 dosages, code 3 -> -1."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(packed.shape[0], -1)
    return torch.where(codes == CODE_MISSING, -1,
                       codes.to(torch.int8)).to(torch.int8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def int_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b^T`` of int8 operands with exact int32 sums. On a card,
    ``torch._int_mm`` (rows padded past 16 and to multiples of 8, the
    contracted axis to a multiple of 8, with zero operands)."""
    if a.device.type != "cuda":
        return (a.double() @ b.double().T).round().to(torch.int32)
    (n, k), m = a.shape, b.shape[0]
    kp = _round_up(k, 8)
    ap = torch.nn.functional.pad(a, (0, kp - k, 0, _round_up(max(n, 24), 8)
                                     - n))
    bp = torch.nn.functional.pad(b, (0, kp - k, 0, _round_up(max(m, 24), 8)
                                     - m))
    return torch._int_mm(ap, bp.t())[:n, :m]


def ibs_counts(packed: np.ndarray, device,
               chunk_variants: int = CHUNK_VARIANTS):
    """``(d1, m)``, (N, N) int32 on ``device``, from the host's (N, W)
    2-bit bytes (pad codes are missing calls and count nowhere)."""
    device = torch.device(device)
    n = packed.shape[0]
    d1 = torch.zeros((n, n), dtype=torch.int32, device=device)
    m = torch.zeros((n, n), dtype=torch.int32, device=device)
    step = chunk_variants // 4
    for lo in range(0, packed.shape[1], step):
        hi = min(lo + step, packed.shape[1])
        g = unpack_2bit(torch.from_numpy(
            np.array(packed[:, lo:hi])).to(device))
        c = (g >= 0).to(torch.int8)
        t1 = (g >= 1).to(torch.int8)
        t2 = (g >= 2).to(torch.int8)
        y = t1 + t2
        left = torch.cat([y, c, t1, t2], dim=1)
        right = torch.cat([c, y, -2 * t1, -2 * t2], dim=1)
        del g, y, t1, t2
        d1 += int_gemm(left, right)
        del left, right
        m += int_gemm(c, c)
    return d1, m


def ibs_distance(d1: torch.Tensor, m: torch.Tensor,
                 dtype=torch.float64) -> torch.Tensor:
    d = d1.to(dtype) / (2.0 * m.to(dtype))
    return torch.where(m > 0, d, torch.zeros((), dtype=dtype,
                                             device=d.device))


def gower_center(d: torch.Tensor) -> torch.Tensor:
    """``-1/2 J D^2 J``: row, column and grand means of ``D^2``."""
    d2 = d * d
    row = d2.mean(dim=1, keepdim=True)
    col = d2.mean(dim=0, keepdim=True)
    grand = d2.mean()
    return d2.sub_(row).sub_(col).add_(grand).mul_(-0.5)


def top_eigenvalues(b: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest eigenvalues of symmetric ``b``, descending."""
    return torch.linalg.eigvalsh(b).flip(0)[:k]


class Reference:
    """The reference's centered matrix and top eigenvalues of a cohort,
    with the exact counts kept for the control."""

    def __init__(self, packed: np.ndarray, k: int, device):
        self.d1, self.m = ibs_counts(packed, device)
        self.b = gower_center(ibs_distance(self.d1, self.m))
        self.vals = top_eigenvalues(self.b, k)
