"""The PyTorch port's QC filter and LD pruning against the JAX package,
on the CPU: the kept-variant sets must be identical (not merely close),
and blocks and metas equal. The r^2 matrices themselves come from f32
products summed in different orders, so they agree within a tolerance
(``1e-5`` absolute, r^2 being in [0, 1]); the keep decisions compare r^2
with the threshold, and on these inputs no r^2 lies within that
tolerance of a threshold, which the test checks too."""

import numpy as np
import pytest
import torch

from spark_examples_tpu.ingest import filters as jfilters
from spark_examples_tpu.ingest import ldprune as jldprune
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu_torch.ingest import filters as tfilters
from spark_examples_tpu_torch.ingest import ldprune as tldprune
from spark_examples_tpu_torch.ingest.source import ArraySource

from conftest import random_genotypes
from test_torch_sources import assert_same_stream

R2_ATOL = 1e-5


def ld_cohort(rng, n=300, n_indep=40, copies=4, flip_rate=0.02):
    """Each independent variant followed by near-duplicates (planted LD
    blocks), with 5 % missing calls."""
    base = rng.integers(0, 3, (n, n_indep), dtype=np.int8)
    cols = []
    for j in range(n_indep):
        cols.append(base[:, j])
        for _ in range(copies - 1):
            c = base[:, j].copy()
            flip = rng.random(n) < flip_rate
            c[flip] = rng.integers(0, 3, flip.sum(), dtype=np.int8)
            cols.append(c)
    g = np.stack(cols, axis=1)
    g[rng.random(g.shape) < 0.05] = -1
    return g


def test_qc_mask_matches_jax():
    rng = np.random.default_rng(3)
    g = random_genotypes(rng, 40, 500, 0.2)
    g[:, 0] = -1
    g[:, 1] = 0
    g[:, 2] = 2
    g[:5, 3] = 1
    g[5:, 3] = 0
    for maf in (0.0, 0.01, 0.05, 0.3):
        for max_missing in (1.0, 0.25, 0.1, 0.0):
            np.testing.assert_array_equal(
                tfilters.qc_mask(g, maf, max_missing),
                jfilters.qc_mask(g, maf, max_missing),
                err_msg=f"maf={maf} max_missing={max_missing}")


@pytest.mark.parametrize("maf,max_missing", [(0.05, 1.0), (0.0, 0.12),
                                             (0.1, 0.15)])
def test_filtered_source_matches_jax(maf, max_missing):
    rng = np.random.default_rng(4)
    g = random_genotypes(rng, 30, 900, 0.12)
    g[:, ::7] = np.minimum(g[:, ::7], 0)  # rare and monomorphic columns
    pos = np.arange(900, dtype=np.int64) * 11
    t = tfilters.FilteredSource(ArraySource(g, contig="c1", positions=pos),
                                maf=maf, max_missing=max_missing)
    j = jfilters.FilteredSource(JArraySource(g, contig="c1", positions=pos),
                                maf=maf, max_missing=max_missing)
    got = list(t.blocks(128))
    assert_same_stream(got, list(j.blocks(128)))
    assert t.n_variants == j.n_variants
    assert 0 < t.n_variants < 900
    assert_same_stream(list(t.blocks(128, start_variant=256)),
                       list(j.blocks(128, start_variant=256)))


def _kept_positions(src, bv=4096):
    return np.concatenate([m.positions for _, m in src.blocks(bv)])


@pytest.mark.parametrize("r2", [0.1, 0.2, 0.5, 0.8])
@pytest.mark.parametrize("window,carry", [(64, 16), (100, 33)])
def test_ld_kept_sets_are_identical_to_jax(r2, window, carry):
    rng = np.random.default_rng(int(r2 * 100) + window)
    g = ld_cohort(rng)
    pos = np.arange(g.shape[1], dtype=np.int64) * 5
    t = tldprune.LdPruneSource(ArraySource(g, positions=pos), r2=r2,
                               window=window, carry=carry, device="cpu")
    j = jldprune.LdPruneSource(JArraySource(g, positions=pos), r2=r2,
                               window=window, carry=carry)
    np.testing.assert_array_equal(_kept_positions(t), _kept_positions(j))
    assert_same_stream(list(t.blocks(50)), list(j.blocks(50)))
    assert t.n_variants == j.n_variants
    assert 40 <= t.n_variants < g.shape[1]


def test_ld_prune_resets_at_contig_boundaries_as_jax(tmp_path):
    from spark_examples_tpu.ingest import plink as jplink
    from spark_examples_tpu_torch.ingest.plink import PlinkSource

    g = ld_cohort(np.random.default_rng(9), n_indep=30)
    prefix = str(tmp_path / "ld")
    jplink.write_plink(prefix, g, chroms=["1"] * 50 + ["2"] * 70,
                       positions=np.arange(120) + 1)
    t = tldprune.LdPruneSource(PlinkSource(prefix), r2=0.3, window=32,
                               carry=8, device="cpu")
    j = jldprune.LdPruneSource(jplink.PlinkSource(prefix), r2=0.3,
                               window=32, carry=8)
    got = list(t.blocks(16))
    assert_same_stream(got, list(j.blocks(16)))
    assert {m.contig for _, m in got} == {"1", "2"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_r2_agrees_and_no_pair_sits_on_a_threshold(seed):
    rng = np.random.default_rng(seed)
    x = ld_cohort(rng, n_indep=20)[:, :80]
    x = np.concatenate([x, np.full((x.shape[0], 16), -1, np.int8)], axis=1)
    want = np.asarray(jldprune._window_r2(x, x.shape[1]))
    got = tldprune._window_r2(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=R2_ATOL)
    assert not got[80:].any() and not got[:, 80:].any()  # pad columns
    for thresh in (0.1, 0.2, 0.3, 0.5, 0.8):
        assert not (np.abs(want - thresh) <= R2_ATOL).any()


def test_greedy_keep_matches_jax():
    rng = np.random.default_rng(6)
    r2 = rng.random((40, 40)).astype(np.float32)
    r2 = (r2 + r2.T) / 2
    for base in (0, 5):
        for thresh in (0.2, 0.6, 0.9):
            np.testing.assert_array_equal(
                tldprune._greedy_keep(r2, base, thresh),
                jldprune._greedy_keep(r2, base, thresh))


@pytest.mark.parametrize("kw", [dict(r2=0.0), dict(r2=1.5),
                                dict(carry=0), dict(carry=256)])
def test_ld_prune_rejects_bad_params(kw):
    with pytest.raises(ValueError):
        tldprune.LdPruneSource(ArraySource(np.zeros((2, 2), np.int8)),
                               **kw)
