"""The packed-gram kernel's plain version against the JAX Pallas kernel,
and the wrapper's contract.

``fused_tile_products`` of the JAX package runs in the Pallas
interpreter off-TPU (its default), so these compare the port's plain
version with the TPU kernel's own semantics, bitwise, for every count
product set on ragged shapes. The CUDA kernel itself is compared with
the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu import kernels as jkernels
from spark_examples_tpu.ingest import bitpack as jbitpack
from spark_examples_tpu.ops.pallas import packed_gram as jpacked
from spark_examples_tpu_torch import kernels as tkernels
from spark_examples_tpu_torch.ingest import bitpack as tbitpack
from spark_examples_tpu_torch.ops import genotype as tgenotype
from spark_examples_tpu_torch.ops import packed_gram as tpacked

from conftest import random_genotypes

METRICS = sorted(jkernels.fused_names())


@pytest.fixture(scope="module")
def ragged_packed():
    """37 x 21 samples over 301 bytes (1204 variants, off every tile)."""
    rng = np.random.default_rng(2024)
    rows = jbitpack.pack_dosages(random_genotypes(rng, 37, 1203, 0.2))
    cols = jbitpack.pack_dosages(random_genotypes(rng, 21, 1203, 0.2))
    return rows, cols


@pytest.mark.parametrize("metric", METRICS)
def test_plain_matches_jax_kernel_on_ragged_tiles(ragged_packed, metric):
    rows, cols = ragged_packed
    pieces = jkernels.get(metric).pieces
    assert tkernels.get(metric).pieces == pieces
    want = jpacked.fused_tile_products(rows, cols, pieces)
    got = tpacked.fused_tile_products(torch.from_numpy(rows),
                                      torch.from_numpy(cols), pieces)
    for p in pieces:
        g, w = got[p].numpy(), np.asarray(want[p])
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w, err_msg=f"{metric}/{p}")


def test_plain_symmetric_matches_jax_kernel_with_padding_bytes():
    """The same tensor on both sides (the gram update's call), with whole
    bytes of 0xFF padding that must contribute nothing."""
    rng = np.random.default_rng(5)
    packed = jbitpack.pack_dosages(random_genotypes(rng, 19, 97, 0.1))
    packed = np.concatenate([packed, np.full((19, 3), 0xFF, np.uint8)], 1)
    pieces = tuple(sorted(tpacked.PRODUCT_OPERANDS.keys() - {"qc", "yy"}))
    want = jpacked.fused_tile_products(packed, packed, pieces)
    t = torch.from_numpy(packed)
    got = tpacked.fused_tile_products(t, t, pieces)
    for p in pieces:
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want[p]))


def test_check_fusable_rejects_undecodable_products():
    with pytest.raises(ValueError, match="qc"):
        tpacked.check_fusable(("t1t1", "qc"))
    with pytest.raises(ValueError, match="yy"):
        tpacked.fused_tile_products_plain(
            torch.zeros((2, 2), dtype=torch.uint8),
            torch.zeros((2, 2), dtype=torch.uint8), ("yy",))


@pytest.mark.parametrize("rows,cols,exc,match", [
    (torch.zeros((4, 3), dtype=torch.int8),
     torch.zeros((4, 3), dtype=torch.uint8), TypeError, "uint8"),
    (torch.zeros((4, 3, 1), dtype=torch.uint8),
     torch.zeros((4, 3), dtype=torch.uint8), ValueError, "2-D"),
    (torch.zeros((4, 3), dtype=torch.uint8),
     torch.zeros((4, 5), dtype=torch.uint8), ValueError, "widths disagree"),
    (torch.zeros((4, 6), dtype=torch.uint8)[:, ::2],
     torch.zeros((4, 3), dtype=torch.uint8), ValueError, "contiguous"),
    (np.zeros((4, 3), np.uint8),
     torch.zeros((4, 3), dtype=torch.uint8), TypeError, "torch.Tensor"),
])
def test_wrapper_rejects_bad_inputs(rows, cols, exc, match):
    with pytest.raises(exc, match=match):
        tpacked.fused_tile_products(rows, cols, ("cc",))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = tpacked.launches
    t = torch.full((3, 2), 0x24, dtype=torch.uint8)
    out = tpacked.fused_tile_products(t, t, ("cc", "t2t2"))
    assert tpacked.launches == before
    # 0x24 = codes (0, 1, 2, 0): four valid calls, one hom-alt per byte.
    assert out["cc"].tolist() == [[8] * 3] * 3
    assert out["t2t2"].tolist() == [[2] * 3] * 3


def test_plain_version_counts_no_fused_blocks():
    """``gram.fused_blocks`` counts block updates through the fused
    lowering (the JAX meaning; the exported count a supervised child
    reports), so a direct call of the wrapper adds none."""
    from spark_examples_tpu_torch.core import telemetry

    before = telemetry.counter_value("gram.fused_blocks")
    launched = telemetry.counter_value("kernel.packed_gram.launches")
    t = torch.full((5, 3), 0x1B, dtype=torch.uint8)
    tpacked.fused_tile_products(t, t, ("cc", "t1t1"))
    assert telemetry.counter_value("gram.fused_blocks") == before
    assert telemetry.is_declared("gram.fused_blocks")
    # The plain version launches nothing, so the launch counter stays.
    assert telemetry.counter_value("kernel.packed_gram.launches") == launched


def _run_plan_tile_by_tile(packed: torch.Tensor, products, tile: int):
    """The symmetric launch in plain torch: every contraction of the plan
    on each tile with I <= J, its tile stored at [I, J] of ``direct`` and
    its transpose at [J, I] of ``mirror`` (off the diagonal). Unwritten
    elements keep a sentinel."""
    plan = tpacked.contraction_plan(products, symmetric=True)
    ops = tgenotype.operands(tbitpack.unpack_dosages(packed))
    n = packed.shape[0]
    out = torch.full((len(products), n, n), -(2 ** 31), dtype=torch.int32)
    for i0 in range(0, n, tile):
        for j0 in range(i0, n, tile):
            ri, rj = slice(i0, i0 + tile), slice(j0, j0 + tile)
            for left, right, direct, mirror in plan:
                tile_sum = tgenotype.int_dot(ops[left][ri], ops[right][rj])
                if direct >= 0:
                    out[direct, ri, rj] = tile_sum
                if mirror >= 0 and i0 != j0:
                    out[mirror, rj, ri] = tile_sum.T
    return {p: out[i] for i, p in enumerate(products)}


@pytest.fixture(scope="module")
def ragged_square():
    """75 samples over 37 bytes (148 variants): off every tile and chunk."""
    rng = np.random.default_rng(75)
    return jbitpack.pack_dosages(random_genotypes(rng, 75, 147, 0.15))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tile", [16, tpacked.TILE])
def test_symmetric_plan_matches_plain_and_jax_bitwise(ragged_square, metric,
                                                      tile):
    pieces = tkernels.get(metric).pieces
    packed = torch.from_numpy(ragged_square)
    got = _run_plan_tile_by_tile(packed, pieces, tile)
    plain = tpacked.fused_tile_products_plain(packed, packed, pieces)
    want = jpacked.fused_tile_products(ragged_square, ragged_square, pieces)
    for p in pieces:
        assert torch.equal(got[p], plain[p]), f"{metric}/{p}"
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want[p]),
                                      err_msg=f"{metric}/{p}")


@pytest.mark.parametrize("metric,count", [
    ("ibs", 5), ("ibs2", 7), ("shared-alt", 1), ("king", 8), ("jaccard", 3),
    ("pc-invariant", 9),
])
def test_symmetric_plan_contraction_counts(metric, count):
    pieces = tkernels.get(metric).pieces
    plan = tpacked.contraction_plan(pieces, symmetric=True)
    assert len(plan) == count
    # Every product is written at [I, J] once and mirrored once.
    assert sorted(q[2] for q in plan if q[2] >= 0) == list(range(len(pieces)))
    assert sorted(q[3] for q in plan if q[3] >= 0) == list(range(len(pieces)))
    assert len({(q[0], q[1]) for q in plan}) == count


def test_asymmetric_plan_is_one_contraction_per_product():
    pieces = tkernels.get("ibs").pieces
    assert tpacked.contraction_plan(pieces, symmetric=False) == (
        ("c", "c", 0, -1), ("y", "c", 1, -1), ("t1", "t1", 2, -1),
        ("t2", "t2", 3, -1))
    assert tpacked.contraction_plan(pieces, symmetric=True) == (
        ("c", "c", 0, 0), ("y", "c", 1, -1), ("c", "y", -1, 1),
        ("t1", "t1", 2, 2), ("t2", "t2", 3, 3))


# The card the benchmark's cells run on (an H100 SXM).
_H100_SMS = 132


def test_launch_plan_fills_the_card_at_the_flagship_shape():
    """(2504, 2048 B) ibs, symmetric: 210 tiles of 128, three sweeps of
    the five contractions, 630 items for 132 blocks."""
    plan = tpacked.launch_plan(2504, 2504, True, 5, _H100_SMS)
    assert plan["tiles"] == 20 * 21 // 2
    assert plan["items"] == 3 * plan["tiles"]
    assert plan["grid"] == _H100_SMS
    assert plan["items"] >= 4 * plan["grid"]


@pytest.mark.parametrize("nr,nc,symmetric,contractions", [
    (15708, 15708, True, 5),    # the one-card cell's launch
    (38078, 38078, True, 5),    # the four-card cell's diagonal tiles
    (38078, 38078, False, 4),   # and its off-diagonal ones
])
def test_launch_plan_large_launches_take_the_large_tile(nr, nc, symmetric,
                                                        contractions):
    plan = tpacked.launch_plan(nr, nc, symmetric, contractions, _H100_SMS)
    assert plan["tile"] == tpacked.TILE == 128
    assert plan["grid"] == _H100_SMS
    assert plan["items"] > 100 * _H100_SMS


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_every_contraction_lands_in_one_sweep(metric, symmetric):
    pieces = tkernels.get(metric).pieces
    n = len(tpacked.contraction_plan(pieces, symmetric))
    plan = tpacked.launch_plan(300, 300, symmetric, n, _H100_SMS)
    flat = [q for sweep in plan["sweeps"] for q in sweep]
    assert flat == list(range(n))
    assert all(1 <= len(s) <= tpacked.SWEEP_CONTRACTIONS
               for s in plan["sweeps"])
    assert len(plan["sweeps"]) == -(-n // tpacked.SWEEP_CONTRACTIONS)


@pytest.mark.parametrize("symmetric", [True, False])
def test_launch_plan_walk_covers_each_tile_once_a_sweep(symmetric):
    """Blocks b, b + grid, ... over the items, sweep-major: every (sweep,
    tile) once, and every block's share within one item of the others."""
    nr, nc = 5 * tpacked.TILE + 1, 5 * tpacked.TILE + 1
    if not symmetric:
        nc = 3 * tpacked.TILE
    plan = tpacked.launch_plan(nr, nc, symmetric, 5, 7)
    seen = []
    per_block = []
    for b in range(plan["grid"]):
        mine = list(range(b, plan["items"], plan["grid"]))
        per_block.append(len(mine))
        seen += [divmod(item, plan["tiles"]) for item in mine]
    assert sorted(seen) == [(s, t) for s in range(len(plan["sweeps"]))
                            for t in range(plan["tiles"])]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("args", [
    (0, 5, False, 1, 132), (5, 5, True, 0, 132), (5, 4, True, 1, 132),
    (5, 5, True, 1, 0),
])
def test_launch_plan_refuses_an_empty_or_ill_formed_launch(args):
    with pytest.raises(ValueError):
        tpacked.launch_plan(*args)
