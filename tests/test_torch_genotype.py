"""The PyTorch port's codec and genotype ops against the JAX package.

Inputs come from a numpy seed; JAX runs on the CPU (tests/conftest.py).
Integer results must be bitwise equal: the port's int8 contractions are
exact (float64 below 2^53, cast to int32), as the JAX int32 dots are.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu.ingest import bitpack as jbitpack
from spark_examples_tpu.ingest import synthetic as jsynthetic
from spark_examples_tpu.ops import genotype as jgenotype
from spark_examples_tpu_torch import kernels as tkernels
from spark_examples_tpu_torch.ingest import bitpack as tbitpack
from spark_examples_tpu_torch.ingest import synthetic as tsynthetic
from spark_examples_tpu_torch.ops import genotype as tgenotype

from conftest import random_genotypes

ALL_PRODUCTS = tuple(jgenotype.PRODUCT_OPERANDS)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: v.numpy() for k, v in d.items()}


@pytest.mark.parametrize("name", ["PRODUCT_OPERANDS", "_INT8_SPLIT",
                                  "PIECE_PRODUCTS"])
def test_tables_equal_the_jax_tables(name):
    assert getattr(tgenotype, name) == getattr(jgenotype, name)


def test_registry_pieces_and_stats_equal_the_jax_registry():
    """The port registers the six fused-capable count kernels with the
    JAX registrations' products, statistics, increments and flops."""
    from spark_examples_tpu import kernels as jkernels

    assert set(tkernels.fused_names()) == set(jkernels.fused_names())
    for name in tkernels.fused_names():
        t, j = tkernels.get(name), jkernels.get(name)
        assert (t.pieces, t.stats, t.max_increment) == (
            j.pieces, j.stats, j.max_increment), name
        assert t.flops(37, 211) == j.flops(37, 211)


@pytest.mark.parametrize("n,v", [(37, 211), (5, 4), (1, 1)])
def test_pack_and_unpack_match_jax(n, v):
    g = random_genotypes(np.random.default_rng(n * 1000 + v), n, v, 0.2)
    packed = tbitpack.pack_dosages(g)
    np.testing.assert_array_equal(packed, jbitpack.pack_dosages(g))
    np.testing.assert_array_equal(tbitpack.unpack_dosages_np(packed),
                                  jbitpack.unpack_dosages_np(packed))
    got = tbitpack.unpack_dosages(torch.from_numpy(packed)).numpy()
    want = np.asarray(jbitpack.unpack_dosages(packed))
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_pack_rejects_out_of_range_values():
    with pytest.raises(ValueError, match="2-bit range"):
        tbitpack.pack_dosages(np.array([[0, 3]], np.int8))


def test_operands_match_jax(genotypes):
    got = _t(tgenotype.operands(torch.from_numpy(genotypes)))
    want = _np(jgenotype.operands(genotypes))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("products", [ALL_PRODUCTS, ("cc", "yc", "t1t1",
                                                     "t2t2"), ("qc",)])
def test_gram_products_match_jax(genotypes, products):
    got = _t(tgenotype.gram_products(torch.from_numpy(genotypes), products))
    want = _np(jgenotype.gram_products(genotypes, products))
    for p in products:
        assert got[p].dtype == want[p].dtype == np.int32
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_tile_products_match_jax(rng):
    rows = random_genotypes(rng, 23, 150, 0.15)
    cols = random_genotypes(rng, 40, 150, 0.15)
    got = _t(tgenotype.tile_products(torch.from_numpy(rows),
                                     torch.from_numpy(cols), ALL_PRODUCTS))
    want = _np(jgenotype.tile_products(rows, cols, ALL_PRODUCTS))
    for p in ALL_PRODUCTS:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_combine_products_match_jax(genotypes):
    pieces = tuple(tgenotype.PIECE_PRODUCTS)
    prods_t = tgenotype.gram_products(torch.from_numpy(genotypes),
                                      ALL_PRODUCTS)
    prods_j = jgenotype.gram_products(genotypes, ALL_PRODUCTS)
    got = _t(tgenotype.combine_products(prods_t, pieces))
    want = _np(jgenotype.combine_products(prods_j, pieces))
    for s in pieces:
        np.testing.assert_array_equal(got[s], want[s], err_msg=s)
    with pytest.raises(ValueError, match="unknown gram piece"):
        tgenotype.combine_products(prods_t, ("bogus",))


def test_synthetic_source_is_byte_identical_to_jax():
    kw = dict(n_samples=30, n_variants=2500, n_populations=3, seed=7)
    t_src = tsynthetic.SyntheticSource(**kw)
    j_src = jsynthetic.SyntheticSource(**kw)
    assert t_src.sample_ids == j_src.sample_ids
    np.testing.assert_array_equal(t_src.populations, j_src.populations)
    t_blocks = list(t_src.blocks(700, start_variant=700))
    j_blocks = list(j_src.blocks(700, start_variant=700))
    assert len(t_blocks) == len(j_blocks) == 3
    for (tb, tm), (jb, jm) in zip(t_blocks, j_blocks):
        assert tb.dtype == jb.dtype == np.int8
        assert tb.tobytes() == jb.tobytes()
        assert (tm.index, tm.start, tm.stop) == (jm.index, jm.start, jm.stop)
