"""Gram accumulation and finalize of the PyTorch port against the JAX
package: int32 accumulators after several blocks, and the ibs finalize,
must be bitwise equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.ingest import bitpack as jbitpack
from spark_examples_tpu.ops import distances as jdistances
from spark_examples_tpu.ops import gram as jgram
from spark_examples_tpu_torch.ops import distances as tdistances
from spark_examples_tpu_torch.ops import gram as tgram
from spark_examples_tpu_torch.pipelines import runner as trunner

from conftest import random_genotypes

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def blocks():
    """Four (29, 256) dosage blocks with missing calls, the last ragged
    (pad columns of missing, as the feed pads them)."""
    rng = np.random.default_rng(77)
    out = [random_genotypes(rng, 29, 256, 0.1) for _ in range(3)]
    last = random_genotypes(rng, 29, 256, 0.1)
    last[:, 100:] = -1
    return out + [last]


def _jax_acc(blocks, packed):
    acc = jgram.init(29, "ibs")
    for b in blocks:
        acc = (jgram.update_packed(acc, jbitpack.pack_dosages(b), "ibs")
               if packed else jgram.update(acc, b, "ibs"))
    return {k: np.asarray(v) for k, v in acc.items()}


# The whole square (the updaters, rows and columns one tensor), or one
# off-diagonal tile (``add_count_products`` on row and column slices,
# as a tile2d slot calls it).
_OFF_DIAGONAL = (slice(0, 13), slice(13, 29))


@pytest.mark.parametrize("region", ["square", "tile"])
@pytest.mark.parametrize("lowering", ["dense", "packed", "fused"])
def test_accumulators_after_several_blocks_match_jax(blocks, lowering,
                                                     region):
    pieces = ("cc", "yc", "t1t1", "t2t2")
    rows, cols = _OFF_DIAGONAL
    if region == "square":
        acc = tgram.init(29, "ibs", CPU)
    else:
        acc = {k: torch.zeros((13, 16), dtype=torch.int32) for k in pieces}
    for b in blocks:
        block = (torch.from_numpy(b) if lowering == "dense"
                 else torch.from_numpy(jbitpack.pack_dosages(b)))
        if region == "tile":
            tgram.add_count_products(
                acc, block[rows], block[cols], pieces,
                lowering != "dense",
                "fused" if lowering == "fused" else "reference")
            continue
        if lowering == "dense":
            out = tgram.update(acc, block, "ibs")
        else:
            update = (tgram.update_fused if lowering == "fused"
                      else tgram.update_packed)
            out = update(acc, block, "ibs")
        assert out is acc  # in-place accumulation
    want = _jax_acc(blocks, packed=lowering != "dense")
    if region == "tile":
        want = {k: v[rows, cols] for k, v in want.items()}
    assert acc.keys() == want.keys() == set(pieces)
    for k in want:
        assert acc[k].dtype == torch.int32
        np.testing.assert_array_equal(acc[k].numpy(), want[k], err_msg=k)


def test_ibs_finalize_is_bitwise_equal_on_the_jax_state(blocks):
    """The same int32 state (taken over from the JAX side) finalizes to
    bit-identical float32 similarity and distance."""
    jacc = _jax_acc(blocks, packed=True)
    tacc = tgram.from_jax_state(jacc, CPU)
    got = tdistances.finalize(tacc, "ibs")
    want = jdistances.finalize({k: jnp.asarray(v) for k, v in jacc.items()},
                               "ibs")
    for f in ("similarity", "distance"):
        g, w = got[f].numpy(), np.asarray(want[f])
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=f)
    d = trunner.finalize_field(tacc, "ibs", "distance")
    np.testing.assert_array_equal(d.numpy(), np.asarray(want["distance"]))


def test_ibs_finalize_zero_overlap_pairs_get_distance_zero():
    """Pairs sharing no complete variant: distance 0 on both sides."""
    g = np.array([[0, -1, 2], [-1, 1, -1]], np.int8)
    jacc = _acc_np(g)
    got = tdistances.finalize(tgram.from_jax_state(jacc, CPU), "ibs")
    want = jdistances.finalize({k: jnp.asarray(v) for k, v in jacc.items()},
                               "ibs")
    np.testing.assert_array_equal(got["distance"].numpy(),
                                  np.asarray(want["distance"]))
    assert got["distance"][0, 1] == 0.0


def _acc_np(g):
    acc = jgram.update(jgram.init(g.shape[0], "ibs"), g, "ibs")
    return {k: np.asarray(v) for k, v in acc.items()}


def test_from_jax_state_rejects_non_int32():
    with pytest.raises(ValueError, match="int32"):
        tgram.from_jax_state({"cc": np.zeros((2, 2), np.float32)}, CPU)


def test_similarity_to_distance_matches_jax(rng):
    a = rng.standard_normal((9, 5)).astype(np.float32)
    s = a @ a.T
    got = tdistances.similarity_to_distance(torch.from_numpy(s)).numpy()
    want = np.asarray(jdistances.similarity_to_distance(s))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unported_finalize_is_refused():
    """Every count kernel's finalize is ported now; a table kernel has no
    gram finalize to run, and asking for one is refused by name."""
    with pytest.raises(ValueError, match="no gram finalize"):
        tdistances.finalize({}, "braycurtis")


@pytest.mark.parametrize("requested,packed,device,want", [
    ("auto", True, "cuda", "fused"),
    ("auto", True, "cpu", "reference"),
    ("auto", False, "cuda", "reference"),
    ("reference", True, "cuda", "reference"),
    ("fused", True, "cuda", "fused"),
])
def test_resolve_gram_lowering(requested, packed, device, want):
    """auto picks the CUDA kernel exactly where it can run (decided from
    the device type: no card is touched here)."""
    assert tgram.resolve_gram_lowering(requested, packed,
                                       torch.device(device)) == want


def test_forced_fused_on_cpu_raises_naming_the_flag():
    with pytest.raises(ValueError, match="--gram-lowering fused"):
        tgram.resolve_gram_lowering("fused", True, CPU)
    with pytest.raises(ValueError, match="packed"):
        tgram.resolve_gram_lowering("fused", False, torch.device("cuda"))


def test_flops_per_block_matches_jax():
    for metric in ("ibs", "shared-alt", "pc-invariant"):
        assert tgram.flops_per_block(50, 1000, metric) == \
            jgram.flops_per_block(50, 1000, metric)
