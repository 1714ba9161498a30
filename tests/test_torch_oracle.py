"""The port's NumPy oracle (``utils/oracle.py``) and its registry twins
(``np_finalize``, ``oracle_similarity``) against the JAX package's, on
the CPU.

Both sides are NumPy float64 on the same seeded inputs, through the same
NumPy build in one process, so every comparison is bitwise. The
oracle's products and combine algebra are its own NumPy copies, not the
port's torch ``ops/genotype.py``; the last tests hold those copies
against the JAX tables they mirror.
"""

import numpy as np
import pytest

from spark_examples_tpu import kernels as jkernels
from spark_examples_tpu.ops import distances as jdistances
from spark_examples_tpu.ops import genotype as jgenotype
from spark_examples_tpu.utils import oracle as joracle
from spark_examples_tpu_torch import kernels as tkernels
from spark_examples_tpu_torch.utils import oracle as toracle

from conftest import random_genotypes

GRAM_METRICS = ("ibs", "ibs2", "shared-alt", "king", "jaccard",
                "pc-invariant", "euclidean", "dot", "grm")


def _genotypes(seed=3, n=23, v=157, missing=0.15):
    """Random dosages with the rows that drive every guarded branch: an
    all-missing sample, an all-hom-ref one and an all-hom-alt one."""
    g = random_genotypes(np.random.default_rng(seed), n, v, missing)
    g[2] = -1
    g[5] = 0
    g[9] = 2
    return g


def _counts(seed=4, n=17, v=131):
    """An arbitrary int8 count table (values up to 60, 10 % missing): the
    dot/euclidean domain."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 61, (n, v)).astype(np.int8)
    x[rng.random((n, v)) < 0.1] = -1
    return x


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
        return
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["naive_pairwise", "naive_ibs_distance",
                                  "naive_king", "naive_jaccard",
                                  "naive_grm"])
def test_naive_definitions_bitwise_equal_to_jax(name):
    g = _genotypes(n=11, v=41)
    _equal(getattr(toracle, name)(g), getattr(joracle, name)(g))


def test_naive_braycurtis_bitwise_equal_to_jax():
    x = np.abs(_counts(n=9, v=33)).astype(np.float64)
    x[3] = 0.0  # an all-zero row: the empty-denominator branch
    _equal(toracle.naive_braycurtis(x), joracle.naive_braycurtis(x))


@pytest.mark.parametrize("product", sorted(toracle.PRODUCT_OPERANDS))
@pytest.mark.parametrize("table", ["dosages", "counts"])
def test_cpu_gram_products_bitwise_equal_to_jax(product, table):
    g = _genotypes() if table == "dosages" else _counts()
    _equal(toracle.cpu_gram_products(g, (product,)),
           joracle.cpu_gram_products(g, (product,)))


@pytest.mark.parametrize("piece", sorted(toracle.PIECE_PRODUCTS))
def test_cpu_gram_pieces_bitwise_equal_to_jax(piece):
    g = _genotypes(seed=8)
    _equal(toracle.cpu_gram_pieces(g, (piece,)),
           joracle.cpu_gram_pieces(g, (piece,)))


def test_cpu_gram_pieces_default_set_matches_jax_and_naive():
    g = _genotypes(seed=9)
    _equal(toracle.cpu_gram_pieces(g), joracle.cpu_gram_pieces(g))
    # The vectorized route reproduces the per-pair definitions.
    small = _genotypes(seed=9, n=11, v=37)
    naive = toracle.naive_pairwise(small)
    pieces = toracle.cpu_gram_pieces(small, ("m", "d1", "s", "ibs2", "dot",
                                             "e2"))
    for k in pieces:
        np.testing.assert_array_equal(pieces[k], naive[k], err_msg=k)


def _stats(metric: str, g: np.ndarray) -> dict:
    """The float64 statistics a metric's finalize reads, from the JAX
    oracle (so both finalizes see one input)."""
    if metric == "grm":
        return {"zz": joracle.naive_grm(g) * 37.0, "nvar": np.float64(37.0)}
    return joracle.cpu_gram_pieces(g, jkernels.get(metric).stats)


@pytest.mark.parametrize("metric", GRAM_METRICS)
def test_cpu_finalize_bitwise_equal_to_jax(metric):
    g = _counts() if metric in ("dot", "euclidean") else _genotypes()
    acc = _stats(metric, g)
    _equal(toracle.cpu_finalize(acc, metric),
           joracle.cpu_finalize(acc, metric))


@pytest.mark.parametrize("metric", GRAM_METRICS)
def test_registry_np_finalize_is_jax_s(metric):
    g = _counts(seed=6) if metric in ("dot", "euclidean") else _genotypes(
        seed=6)
    acc = _stats(metric, g)
    tk, jk = tkernels.get(metric), jkernels.get(metric)
    _equal(tk.np_finalize(acc), jk.np_finalize(acc))
    assert (tk.oracle_similarity is None) == (jk.oracle_similarity is None)
    if jk.oracle_similarity is not None:
        _equal(tk.oracle_similarity(g), jk.oracle_similarity(g))


def test_every_gram_kernel_declares_its_numpy_twin():
    """The registries agree on which kernels carry a host finalize: every
    count and float kernel, never the table kernel."""
    for kern in tkernels._REGISTRY.values():
        twin = jkernels.get(kern.name)
        assert (kern.np_finalize is None) == (twin.np_finalize is None)
        assert (kern.np_finalize is not None) == (
            kern.family in ("count", "float"))
    with pytest.raises(ValueError, match="unknown metric"):
        toracle.cpu_finalize({}, "braycurtis")


def test_registration_refuses_a_kernel_without_its_numpy_twin():
    """JAX's rule (kernels/base.py::register): a count kernel must
    register its np_finalize, a float kernel its np_finalize and host
    oracle; a name registers once."""
    ibs = tkernels.get("ibs")
    half = tkernels.Kernel(name="half-ibs", family="count",
                           pieces=ibs.pieces, stats=ibs.stats,
                           max_increment=2, finalize=ibs.finalize)
    with pytest.raises(ValueError, match=r"count kernel 'half-ibs' is "
                                         r"missing \['np_finalize'\]"):
        tkernels._register(half)
    grm = tkernels.get("grm")
    no_oracle = tkernels.Kernel(name="half-grm", family="float",
                                finalize=grm.finalize,
                                np_finalize=grm.np_finalize,
                                init=grm.init, update=grm.update)
    with pytest.raises(ValueError, match="oracle_similarity"):
        tkernels._register(no_oracle)
    with pytest.raises(ValueError, match="already registered"):
        tkernels._register(ibs)
    assert tkernels.maybe_get("half-ibs") is None
    assert tkernels.maybe_get("half-grm") is None


def test_cpu_braycurtis_bitwise_equal_to_jax():
    x = np.maximum(_counts(seed=7, n=31, v=97), 0)
    x[4] = 0  # two all-zero rows: scipy's 0/0 -> 0
    x[8] = 0
    got = toracle.cpu_braycurtis(x)
    _equal(got, joracle.cpu_braycurtis(x))
    np.testing.assert_allclose(
        got, toracle.naive_braycurtis(x.astype(np.float64)),
        rtol=1e-12, atol=1e-15)


def test_center_pcoa_and_mllib_route_bitwise_equal_to_jax():
    g = _genotypes(seed=10, n=40, v=300)
    d = joracle.cpu_ibs_distance(g)
    _equal(toracle.center_matrix(d), joracle.center_matrix(d))
    _equal(toracle.pcoa(d, k=5), joracle.pcoa(d, k=5))
    s = joracle.cpu_gram_pieces(g, ("s",))["s"]
    _equal(toracle.pca_mllib_route(s, k=4), joracle.pca_mllib_route(s, k=4))
    _equal(toracle.pca_mllib_route(s, k=4, return_values=True),
           joracle.pca_mllib_route(s, k=4, return_values=True))


def test_gower_f32_matches_the_jax_transform():
    """The f32 Gower transform the host route applies to a grm similarity
    and a persisted similarity matrix equals the JAX package's
    ``similarity_to_distance`` on the f32-cast matrix, which its
    cpu-reference route calls there."""
    g = _genotypes(seed=12, n=37, v=211)
    for sim in (joracle.naive_grm(g),
                joracle.cpu_gram_pieces(g, ("s",))["s"]):
        got = toracle.gower_f32(sim)
        want = np.asarray(jdistances.similarity_to_distance(
            sim.astype(np.float32)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_operand_and_combine_tables_are_jax_s():
    """The oracle's own NumPy copies of the operand and combine tables
    equal the JAX package's: the same operands on an int8 table, the same
    product and piece tables, the same statistics from one set of
    products."""
    assert toracle.PRODUCT_OPERANDS == jgenotype.PRODUCT_OPERANDS
    assert toracle.PIECE_PRODUCTS == jgenotype.PIECE_PRODUCTS
    x = _counts(seed=11)
    want = jgenotype.operands(x, dtype=np.float64)
    _equal(toracle.operands(x), {k: np.asarray(v) for k, v in want.items()})
    prods = joracle.cpu_gram_products(x, tuple(toracle.PRODUCT_OPERANDS))
    pieces = tuple(toracle.PIECE_PRODUCTS)
    _equal(toracle.combine_products(prods, pieces),
           jgenotype.combine_products(prods, pieces))
    with pytest.raises(ValueError, match="unknown statistic"):
        toracle.combine_products(prods, ("nope",))
