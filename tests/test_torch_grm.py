"""grm (VanRaden genomic relationship matrix, the float family) of the
PyTorch port against the JAX package, on the CPU.

Tolerance: ``zz`` agrees within ``1e-5 * max|zz|``. Both sides take the
same bf16 (or f32) standardized dosages; JAX sums each block's products
in f32, the port in float64 and rounds once. A sum of V f32 products
is off the exact one by about ``sqrt(V) * 2^-24`` of the sum of
magnitudes (2.3e-6 at V = 1,536), at most ``V * 2^-24``. Measured here
over 10 seeds: 1.3e-7 (bf16) and 2.6e-7 (precise) of max|zz|. The bound
sits far below what ``precise`` changes (bf16 rounds z at 2^-9
relative). ``nvar`` is an exact count and
must be equal. ``torch.rsqrt`` and XLA's CPU rsqrt differ by up to 2 ulp
(measured on 1e5 values in [1e-3, 0.5]: 37 % of them differ), so the
standardized dosages differ by up to 2 f32 ulp under ``precise``
(measured: 2 ulp, over 30 seeds) and may differ by one bf16 ulp
otherwise, where a value sits at a bf16 rounding boundary (measured:
none over 30 seeds); that is why ``zz`` gets a tolerance and not bitwise
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.ops import distances as jdistances
from spark_examples_tpu.ops import gram as jgram
from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.ops import distances as tdistances
from spark_examples_tpu_torch.ops import gram as tgram

CPU = torch.device("cpu")
N, V = 48, 512
ZZ_RTOL = 1e-5


def grm_blocks(seed, n=N, v=V, k=3):
    """k dosage blocks with 10 % missing, a monomorphic column, an
    all-missing column and a single-call column (the three kept-mask
    edges)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        g = rng.integers(0, 3, (n, v)).astype(np.int8)
        g[rng.random((n, v)) < 0.1] = -1
        g[:, 0] = 2
        g[:, 1] = -1
        g[1:, 2] = -1
        out.append(g)
    return out


def _runs(blocks, precise):
    jacc = jgram.init(N, "grm")
    jupdate = jgram._float_update_jit("grm", False)
    tacc = tgram.init(N, "grm", CPU)
    for b in blocks:
        jacc = jupdate(jacc, b, precise=precise)
        assert tgram.update(tacc, torch.from_numpy(b), "grm",
                            precise) is tacc
    return {k: np.asarray(v) for k, v in jacc.items()}, tacc


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_grm_accumulators_match_jax_within_tolerance(precise, seed):
    want, got = _runs(grm_blocks(seed), precise)
    assert got["zz"].dtype == torch.float32 and got["zz"].shape == (N, N)
    assert got["nvar"].dtype == torch.float32 and got["nvar"].ndim == 0
    assert float(got["nvar"]) == float(want["nvar"])
    assert float(got["nvar"]) == 3 * (V - 3)  # the three edge columns
    zz = got["zz"].numpy()
    scale = np.abs(want["zz"]).max()
    np.testing.assert_allclose(zz, want["zz"], rtol=0, atol=ZZ_RTOL * scale)
    np.testing.assert_array_equal(zz, zz.T)


@pytest.mark.parametrize("precise", [False, True])
def test_grm_standardize_matches_jax(precise):
    block = grm_blocks(9, k=1)[0]
    zj, kj = jgram.grm_standardize(jnp.asarray(block), precise)
    zt, kt = tgram.grm_standardize(torch.from_numpy(block), precise)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert zt.dtype == (torch.float32 if precise else torch.bfloat16)
    zt32, zj32 = zt.float().numpy(), np.asarray(zj, np.float32)
    if precise:
        np.testing.assert_array_max_ulp(zt32, zj32, maxulp=2)
    else:
        # one bf16 ulp: 2^-7 of the value's binade
        np.testing.assert_array_less(np.abs(zt32 - zj32),
                                     2.0 ** -7 * np.abs(zj32) + 1e-30)
    assert not zt32[:, :3].any()  # unkept columns contribute nothing


def test_bf16_and_precise_differ_by_the_bf16_rounding():
    blocks = grm_blocks(11)
    _, bf = _runs(blocks, False)
    _, f32 = _runs(blocks, True)
    rel = float((bf["zz"] - f32["zz"]).abs().max() / f32["zz"].abs().max())
    assert 1e-6 < rel < 2e-2


def test_grm_from_jax_state_and_finalize_match_jax():
    """The JAX state's float leaves carry over, and the finalize (zz /
    max(nvar, 1), then the Gower transform rooted in f64) is bitwise."""
    want_acc, _ = _runs(grm_blocks(12), False)
    tacc = tgram.from_jax_state(want_acc, CPU)
    assert tacc["nvar"].ndim == 0 and tacc["zz"].dtype == torch.float32
    got = tdistances.finalize(tacc, "grm")
    want = jdistances.finalize(
        {k: jnp.asarray(v) for k, v in want_acc.items()}, "grm")
    for f in ("similarity", "distance"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)


def test_grm_finalize_with_no_kept_variant_divides_by_one():
    acc = {"zz": torch.full((3, 3), 2.0), "nvar": torch.zeros(())}
    got = tdistances.finalize(acc, "grm")["similarity"]
    assert torch.equal(got, torch.full((3, 3), 2.0))


@pytest.mark.parametrize("leaf,arr,match", [
    ("zz", np.zeros((2, 2), np.int32), "float32"),
    ("nvar", np.zeros((1,), np.float32), "0-d float32"),
    ("zz", np.zeros((2,), np.float32), "2-d float32"),
])
def test_from_jax_state_checks_grm_leaves(leaf, arr, match):
    with pytest.raises(ValueError, match=match):
        tgram.from_jax_state({leaf: arr}, CPU)


def test_packed_grm_update_equals_the_dense_one():
    from spark_examples_tpu.ingest import bitpack as jbitpack

    blocks = grm_blocks(13, k=2)
    dense = tgram.init(N, "grm", CPU)
    packed = tgram.init(N, "grm", CPU)
    for b in blocks:
        tgram.update(dense, torch.from_numpy(b), "grm")
        tgram.update_packed(packed,
                            torch.from_numpy(jbitpack.pack_dosages(b)),
                            "grm")
    for k in dense:
        assert torch.equal(dense[k], packed[k]), k


def test_grm_is_a_float_kernel_without_an_int32_budget():
    kern = kernels.get("grm")
    assert kern.family == "float" and kern.max_increment is None
    assert kern.pack_auto and not kern.fused
    assert "grm" in kernels.gram_names()
    with pytest.raises(ValueError, match="gram metric"):
        tgram.init(4, "braycurtis", CPU)
