"""``gram_roofline``'s count against hand counts at a small N, and its
reader."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import roofline
from conftest import ROOT


def test_ibs_work_by_hand():
    # N = 3, V = 8: three symmetric products of 3 * 4 / 2 = 6 pairs and
    # one rectangular (yc) of 9, two operations a pair and variant.
    ops, nbytes = roofline.gram_work("ibs", 3, 8)
    assert ops == 2 * 8 * (3 * 6 + 9)
    # 2-bit bytes (3 rows of 2) and four int32 (3, 3) outputs.
    assert nbytes == 3 * 2 + 4 * 9 * 4


@pytest.mark.parametrize("products, pairs", [
    ((("c", "c"),), 6),                       # symmetric: i <= j
    ((("y", "c"),), 9),                       # rectangular: all N^2
    ((("c", "c"), ("y", "c")), 6 + 9),
])
def test_symmetric_and_rectangular_pairs(monkeypatch, products, pairs):
    monkeypatch.setitem(roofline.PRODUCTS, "m", products)
    ops, nbytes = roofline.gram_work("m", 3, 5)  # 5 variants: 2 bytes
    assert ops == 2 * 5 * pairs
    assert nbytes == 3 * 2 + 4 * 9 * len(products)


def test_bound_is_operations_at_the_cells_shapes():
    n, v = 2504, 1_048_576
    ops, nbytes = roofline.gram_work("ibs", n, v)
    assert roofline.gram_bound_s("ibs", n, v) == ops / roofline.PEAK_INT8_OPS
    assert nbytes / roofline.PEAK_BYTES_S < ops / roofline.PEAK_INT8_OPS
    # 64 launches at (2504, 4,096 B): chip_smoke.py's 0.2596 ms each.
    assert roofline.gram_bound_s("ibs", n, v) / 64 == pytest.approx(
        0.2596e-3, rel=1e-3)


def test_reader():
    from benchmark.harness import Spec

    read = Spec(ROOT).reader("gram_roofline")
    run = SimpleNamespace(
        mix={"metric": "ibs"}, config={"n_samples": 2504,
                                       "n_variants": 1_048_576},
        jobs=[None] * 3, trace={"phase_kernel_s": {"gram": 0.5}})
    bound = roofline.gram_bound_s("ibs", 2504, 1_048_576)
    assert read(run) == pytest.approx(100 * 3 * bound / 0.5)
    assert read(SimpleNamespace(**{**vars(run), "trace": None})) is None
    no_gram = SimpleNamespace(**{**vars(run), "trace": {"phase_kernel_s":
                                                         {}}})
    assert read(no_gram) is None
