"""The yardstick of the gram contraction: the card's published peaks and
the work a job's gram needs, whatever kernel, tiling or mirror-skipping
does it.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit: 1,979 TOP/s int8 on the tensor cores, 3.35 TB/s of HBM3.

Work (the arithmetic of ``chip_smoke.py::k1_bounds``, frozen here): a
product whose two operands are the same indicator needs the N (N + 1) / 2
pairs ``i <= j``, any other product all N^2; each pair costs 2 int8
operations a variant. Bytes: the cohort's 2-bit bytes read once and
each product's int32 (N, N) written once.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1.979e15
PEAK_BYTES_S = 3.35e12

# A count metric's raw products as (left, right) indicator operands
# (the port's ``ops/genotype.py::PRODUCT_OPERANDS`` for these metrics).
PRODUCTS = {
    "ibs": (("c", "c"), ("y", "c"), ("t1", "t1"), ("t2", "t2")),
}


def gram_work(metric: str, n: int, n_variants: int) -> tuple[float, float]:
    """``(int8 operations, bytes)`` a gram of ``n`` samples over
    ``n_variants`` needs."""
    pairs = sum(n * (n + 1) / 2 if left == right else float(n) * n
                for left, right in PRODUCTS[metric])
    ops = 2.0 * n_variants * pairs
    nbytes = n * (-(-n_variants // 4)) + 4.0 * n * n * len(PRODUCTS[metric])
    return ops, nbytes


def gram_bound_s(metric: str, n: int, n_variants: int) -> float:
    """The least seconds one card needs for that gram."""
    ops, nbytes = gram_work(metric, n, n_variants)
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_S)
