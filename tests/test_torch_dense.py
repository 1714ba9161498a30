"""The dense-transport count kernels of the PyTorch port (euclidean and
dot: exact raw-value products on arbitrary int8 tables) against the JAX
package, on the CPU. int32 accumulators and finalizes must be bitwise
equal; the feed's transport choice and the value-scaled int32 budget
must resolve as JAX's do."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu import kernels as jkernels
from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core.profiling import PhaseTimer as JPhaseTimer
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.ops import distances as jdistances
from spark_examples_tpu.ops import gram as jgram
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest import prefetch as tprefetch
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ops import distances as tdistances
from spark_examples_tpu_torch.ops import genotype as tgenotype
from spark_examples_tpu_torch.ops import gram as tgram
from spark_examples_tpu_torch.pipelines import runner as trunner

CPU = torch.device("cpu")
DENSE = ("euclidean", "dot")


def raw_table(rng, n, v, missing=0.1, hi=127):
    """Raw-value int8 table: values 0..hi, ``missing`` share of -1."""
    x = rng.integers(0, hi + 1, (n, v)).astype(np.int8)
    x[rng.random((n, v)) < missing] = -1
    return x


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(21)
    out = [raw_table(rng, 31, 200) for _ in range(3)]
    out[1][:, :7] = 127  # the largest raw value, qh = 126
    out.append(raw_table(rng, 31, 77))  # ragged tail
    return out


def _jax_acc(blocks, metric):
    acc = jgram.init(31, metric)
    for b in blocks:
        acc = jgram.update(acc, b, metric)
    return {k: np.asarray(v) for k, v in acc.items()}


@pytest.mark.parametrize("metric", DENSE)
def test_dense_accumulators_match_jax_bitwise(blocks, metric):
    acc = tgram.init(31, metric, CPU)
    for b in blocks:
        assert tgram.update(acc, torch.from_numpy(b), metric) is acc
    want = _jax_acc(blocks, metric)
    assert acc.keys() == want.keys() == set(kernels.get(metric).pieces)
    for k in want:
        assert acc[k].dtype == torch.int32
        np.testing.assert_array_equal(acc[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("metric", DENSE)
def test_dense_finalize_matches_jax_bitwise(blocks, metric):
    """The same int32 state finalizes to bit-identical f32 matrices; the
    euclidean root is taken in f64 and rounded once (the correctly
    rounded root, as XLA's f32 sqrt is)."""
    jacc = _jax_acc(blocks, metric)
    got = tdistances.finalize(tgram.from_jax_state(jacc, CPU), metric)
    want = jdistances.finalize({k: jnp.asarray(v) for k, v in jacc.items()},
                               metric)
    for f in ("similarity", "distance"):
        g, w = got[f].numpy(), np.asarray(want[f])
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=f"{metric}/{f}")


@pytest.mark.parametrize("n", [1, 5, 17, 24, 33])
@pytest.mark.parametrize("v", [1, 8, 13, 200])
def test_int_mm_pads_to_the_library_shapes_and_matches_int_dot(n, v):
    """The int8 library product (zero operands padding rows to > 16 and
    both sizes to multiples of 8) equals the plain float64 contraction,
    at values up to 127 (qh up to 126)."""
    rng = np.random.default_rng(n * 100 + v)
    a = torch.from_numpy(rng.integers(0, 128, (n, v)).astype(np.int8))
    b = torch.from_numpy(rng.integers(0, 128, (n + 3, v)).astype(np.int8))
    got = tgenotype.int_mm(a, b)
    assert got.shape == (n, n + 3) and got.dtype == torch.int32
    assert torch.equal(got, tgenotype.int_dot(a, b))


def test_int_mm_takes_int8_only():
    with pytest.raises(ValueError, match="int8"):
        tgenotype.int_mm(torch.zeros((4, 8), dtype=torch.int16),
                         torch.zeros((4, 8), dtype=torch.int8))


def test_dense_products_are_the_same_through_either_contraction(blocks):
    b = torch.from_numpy(blocks[1])
    for metric in DENSE:
        pieces = kernels.get(metric).pieces
        lib = tgenotype.gram_products(b, pieces, dot=tgenotype.int_mm)
        plain = tgenotype.gram_products(b, pieces)
        for p in pieces:
            assert torch.equal(lib[p], plain[p]), p


@pytest.mark.parametrize("metric", ["ibs", "shared-alt", "euclidean", "dot",
                                    "grm"])
@pytest.mark.parametrize("pack_stream", ["auto", "packed", "dense"])
def test_pack_stream_resolves_per_kernel_as_jax(metric, pack_stream):
    """auto packs exactly the kernels declaring pack_auto; the bytes the
    feed ships say which transport ran, on both sides."""
    want_packed = pack_stream == "packed" or (
        pack_stream == "auto" and jkernels.get(metric).pack_auto)
    assert kernels.streams_packed(metric, pack_stream) == want_packed
    n, v, bv = 12, 700, 256
    table = raw_table(np.random.default_rng(4), n, v, hi=2)
    tjob = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=bv),
        compute=tconfig.ComputeConfig(metric=metric, pack_stream=pack_stream,
                                      device="cpu"))
    jjob = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(block_variants=bv),
        compute=jconfig.ComputeConfig(metric=metric,
                                      pack_stream=pack_stream))
    tg = trunner.run_gram(tjob, ArraySource(table), PhaseTimer())
    jg = jrunner.run_gram(jjob, JArraySource(table), JPhaseTimer())
    shipped = tg.timer.counters["ingest_bytes"]
    assert shipped == jg.timer.counters["ingest_bytes"]
    assert shipped == 3 * n * (bv // 4 if want_packed else bv)
    if metric != "grm":
        for k in jg.acc:
            np.testing.assert_array_equal(tg.acc[k].numpy(),
                                          np.asarray(jg.acc[k]), err_msg=k)


def _warns(fn, *args) -> bool:
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn(*args)
    return any("int32 accumulator budget" in str(w.message) for w in rec)


@pytest.mark.parametrize("metric", ["dot", "euclidean", "ibs", "grm"])
@pytest.mark.parametrize("max_value", [1, 2, 3, 46, 127])
def test_int32_budget_warning_fires_at_the_same_point_as_jax(metric,
                                                             max_value):
    """The value-scaled bound (max_value^2, at least the registered 4)
    crosses 2^31 at the same variant count on both sides; grm is exempt."""
    inc = max(4, max_value ** 2) if metric in DENSE else 2
    edge = -(-2 ** 31 // inc)
    for n_variants in (edge - 1, edge):
        want = _warns(jrunner._check_int32_budget, metric, n_variants,
                      max_value)
        got = _warns(trunner._check_int32_budget, metric, n_variants,
                     max_value)
        assert got == want
        assert got == (metric != "grm" and n_variants == edge)


def test_the_dense_feed_tracks_the_largest_value():
    table = raw_table(np.random.default_rng(8), 6, 900, hi=90)
    table[3, 811] = 101
    stats = {}
    got = list(tprefetch.stream_to_device(ArraySource(table), 256, CPU,
                                          stats=stats))
    assert stats["max_value"] == 101
    np.testing.assert_array_equal(
        np.concatenate([b.numpy() for b, _ in got], axis=1)[:, :900], table)
    packed_stats = {}
    list(tprefetch.stream_to_device(ArraySource(np.maximum(table, 0) % 3),
                                    256, CPU, pack=True, stats=packed_stats))
    assert packed_stats == {}  # the packed transport holds dosages only


def test_dense_job_warns_when_the_stream_outruns_the_budget():
    """dot on a (3, 133,200) table of 127s: 127^2 x 133,200 > 2^31, and
    the feed's max_value makes the runner warn."""
    table = np.full((3, 133_200), 127, np.int8)
    job = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=16384),
        compute=tconfig.ComputeConfig(metric="dot", device="cpu"))
    with pytest.warns(RuntimeWarning, match="int32 accumulator budget"):
        trunner.run_gram(job, ArraySource(table), PhaseTimer())


@pytest.mark.parametrize("metric", ["euclidean", "dot", "grm"])
def test_fused_lowering_is_refused_naming_the_flag(metric):
    """The packed-gram kernel decodes 2-bit dosages: it carries neither
    raw values up to 127 nor standardized floats."""
    assert metric not in kernels.fused_names()
    for pack_stream in ("auto", "packed"):
        with pytest.raises(ValueError, match="--gram-lowering fused"):
            tconfig.ComputeConfig(metric=metric, gram_lowering="fused",
                                  pack_stream=pack_stream)
    with pytest.raises(ValueError, match="--gram-lowering fused"):
        tgram.resolve_gram_lowering("fused", True, torch.device("cuda"),
                                    metric)
    assert tgram.resolve_gram_lowering("auto", True, torch.device("cuda"),
                                       metric) == "reference"
    with pytest.raises(SystemExit):
        tmain(["pcoa", "--device", "cpu", "--metric", metric,
               "--gram-lowering", "fused"])


def test_registry_matches_jax_for_the_new_kernels():
    assert set(kernels.fused_names()) == set(jkernels.fused_names())
    for metric in ("euclidean", "dot", "grm"):
        t, j = kernels.get(metric), jkernels.get(metric)
        assert (t.family, t.pack_auto, t.max_increment,
                t.value_scaled_budget) == (j.family, j.pack_auto,
                                           j.max_increment,
                                           j.value_scaled_budget)
        if t.family == "count":
            assert (t.pieces, t.stats) == (j.pieces, j.stats)
        assert tgram.flops_per_block(50, 1000, metric) == \
            jgram.flops_per_block(50, 1000, metric)
