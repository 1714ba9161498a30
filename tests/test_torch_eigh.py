"""Centering and eigensolves of the PyTorch port against the JAX package.

Floating-point sums run in another order on each side, so these compare
within tolerances stated per test; eigenvectors are compared per column,
up to sign.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu.ops import centering as jcentering
from spark_examples_tpu.ops import eigh as jeigh
from spark_examples_tpu_torch.ops import centering as tcentering
from spark_examples_tpu_torch.ops import eigh as teigh


def _planted_b(n=60, k=4, seed=0):
    """A symmetric f32 matrix with k well-separated top eigenvalues over
    a small noise bulk (a PCoA-class spectrum)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    vals = np.concatenate([[40.0, 25.0, 12.0, 6.0][:k],
                           rng.uniform(0.0, 0.5, n - k)])
    b = (q * vals) @ q.T
    return ((b + b.T) / 2).astype(np.float32)


def _assert_cols_match_up_to_sign(got, want, atol):
    for j in range(want.shape[1]):
        s = np.sign(np.dot(got[:, j], want[:, j])) or 1.0
        np.testing.assert_allclose(s * got[:, j], want[:, j], atol=atol,
                                   err_msg=f"column {j}")


def test_gower_center_matches_jax():
    """f32 row/col/grand means summed in another order: agree to a few
    f32 ulps of the entries (rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(3)
    d = rng.uniform(0.0, 1.0, (41, 41)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    got = tcentering.gower_center(torch.from_numpy(d)).numpy()
    want = np.asarray(jcentering.gower_center(d))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_top_k_eigh_matches_jax():
    """Two LAPACK-class f32 solvers: eigenvalues within 1e-4 relative to
    lambda_1, eigenvectors (gaps >= 6 here) within 1e-3 up to sign."""
    b = _planted_b()
    vals_t, vecs_t = teigh.top_k_eigh(torch.from_numpy(b), 4)
    vals_j, vecs_j = jeigh.top_k_eigh(b, 4)
    vals_j, vecs_j = np.asarray(vals_j), np.asarray(vecs_j)
    np.testing.assert_allclose(vals_t.numpy(), vals_j,
                               atol=1e-4 * vals_j[0])
    _assert_cols_match_up_to_sign(vecs_t.numpy(), vecs_j, atol=1e-3)


@pytest.mark.parametrize("iters", [0, 3])
def test_randomized_eigh_matches_jax_subspace_iterate_on_same_probes(iters):
    """randomized_eigh(b, k, probes=q, iters) runs iters + 1 power steps
    from q, as JAX subspace_iterate(b, q, k, iters + 1) does. QR signs
    may differ per column, which spans the same subspace: eigenvalues
    within 1e-4 of lambda_1, vectors within 1e-3 up to sign."""
    b = _planted_b(seed=1)
    q = np.random.default_rng(9).standard_normal((60, 12)).astype(np.float32)
    vals_t, vecs_t = teigh.randomized_eigh(torch.from_numpy(b), 4,
                                           probes=torch.from_numpy(q),
                                           iters=iters)
    vals_j, vecs_j, _ = jeigh.subspace_iterate(b, q, 4, iters + 1)
    vals_j, vecs_j = np.asarray(vals_j), np.asarray(vecs_j)
    np.testing.assert_allclose(vals_t.numpy(), vals_j,
                               atol=1e-4 * vals_j[0])
    _assert_cols_match_up_to_sign(vecs_t.numpy(), vecs_j, atol=1e-3)


def test_randomized_eigh_default_probes_find_the_planted_spectrum():
    """Generator-drawn probes (seed 0): the top eigenvalues agree with
    the dense solve within 1e-4 relative to lambda_1."""
    b = torch.from_numpy(_planted_b(seed=2))
    vals_r, _ = teigh.randomized_eigh(b, 4, oversample=8, iters=4)
    vals_d, _ = teigh.top_k_eigh(b, 4)
    np.testing.assert_allclose(vals_r.numpy(), vals_d.numpy(),
                               atol=1e-4 * float(vals_d[0]))


def test_coords_and_flops_match_jax():
    vals = np.array([3.0, 0.5, -0.2], np.float32)
    vecs = np.random.default_rng(2).standard_normal((7, 3)).astype(np.float32)
    got = teigh.coords_from_eigpairs(torch.from_numpy(vals),
                                     torch.from_numpy(vecs)).numpy()
    want = np.asarray(jeigh.coords_from_eigpairs(vals, vecs))
    np.testing.assert_array_equal(got, want)
    for method in ("dense", "randomized"):
        assert teigh.eigh_flops(500, method, k=10) == \
            jeigh.eigh_flops(500, method, k=10)
