"""The yardstick of the Bray-Curtis contraction (K2): the card's
published FP32 rate and the work a job's Manhattan numerator needs in
its dense formulation, whatever kernel does it.

Peak (the arithmetic of ``chip_smoke.py``'s K2 bound, frozen here): an
H100 SXM's 132 SMs x 128 FP32 lanes at its 1.980 GHz boost clock,
3.35e13 FP32 instructions a second at the full 700 W power limit;
3.35 TB/s of HBM3.

Work: ``|x_i - x_j|`` is not a product, so no tensor core runs it; each
(i, j, f) triple of the N (N + 1) / 2 pairs ``i <= j`` the symmetric
output needs costs two FP32 instructions (a subtraction, then an add of
its absolute value into the accumulator). Bytes: the (N, F) float32
table read once and the (N, N) float32 numerator written once. A kernel
that skips zero features does less than this count: its share would
read over 100 %, and it needs its own count first.
"""

from __future__ import annotations

PEAK_FP32_INSTR_S = 132 * 128 * 1.980e9
PEAK_BYTES_S = 3.35e12


def manhattan_work(n: int, n_features: int) -> tuple[float, float]:
    """``(FP32 instructions, bytes)`` the numerator of ``n`` samples over
    ``n_features`` needs."""
    instr = 2.0 * n * (n + 1) / 2 * n_features
    nbytes = 4.0 * n * n_features + 4.0 * n * n
    return instr, nbytes


def manhattan_bound_s(n: int, n_features: int) -> float:
    """The least seconds one card needs for that numerator."""
    instr, nbytes = manhattan_work(n, n_features)
    return max(instr / PEAK_FP32_INSTR_S, nbytes / PEAK_BYTES_S)
