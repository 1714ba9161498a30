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


def test_top_k_eigh_on_the_cpu_keeps_the_full_solve():
    """A CPU tensor takes ``torch.linalg.eigh``, whatever N and k: the
    same numbers as the full solve's top k, and no subset solve."""
    from spark_examples_tpu_torch.core import telemetry

    b = torch.from_numpy(_planted_b(seed=4))
    before = telemetry.counter_value("eigh.subset_solves")
    vals, vecs = teigh.top_k_eigh(b, 4)
    full_vals, full_vecs = torch.linalg.eigh(b)
    assert telemetry.counter_value("eigh.subset_solves") == before
    assert torch.equal(vals, full_vals.flip(0)[:4])
    assert torch.equal(vecs, full_vecs.flip(1)[:, :4])


@pytest.mark.parametrize("device,n,k,subset", [
    ("cpu", 15708, 10, False),
    ("cuda", 15708, 10, True),
    ("cuda:1", 15708, 10, True),
    ("cuda", 15708, 64, True),
    ("cuda", 3584, 10, True),
    ("cuda", 3072, 10, False),
    ("cuda", 2504, 10, False),
    ("cuda", 3584, 32, False),
    ("cuda", 8192, 32, True),
    ("cuda", 8192, 64, False),
    ("cuda", 16384, 16384, False),
    ("cuda", 15708, 0, False),
])
def test_subset_route_picks_by_device_n_and_k(device, n, k, subset):
    """The rule against the probe's pairs (full against subset on the
    card): each shape goes to the solve that was faster there."""
    assert teigh.subset_route(torch.device(device), n, k) is subset


def _tridiagonal(n, top, seed, gap=None):
    """A symmetric tridiagonal (d, e) in float64 whose top eigenvalues
    are ``top`` over a bulk in [0, 0.5]; with ``gap`` the two largest
    bulk eigenvalues lie ``gap`` apart. Built as Lanczos would: the
    reduction of a planted dense matrix (LAPACK dsytrd)."""
    from scipy.linalg import lapack

    rng = np.random.default_rng(seed)
    bulk = rng.uniform(0.0, 0.5, n - len(top))
    if gap is not None:
        bulk[:2] = [0.5, 0.5 - gap]
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.concatenate([top, bulk])) @ q.T
    _, d, e, _, info = lapack.dsytrd((a + a.T) / 2, lower=1)
    assert info == 0
    return d, e


@pytest.mark.parametrize("n,k,top,gap", [
    (80, 4, [40.0, 25.0, 12.0, 6.0], None),          # separated top k
    (81, 5, [40.0, 25.0, 12.0, 6.0], 1e-7),          # odd n; a cluster at k
    (60, 1, [9.0], None),                            # k = 1
    (64, 5, [3.0, 2.0, 1.0], 1e-9),                  # k reaches the bulk
])
def test_tridiagonal_top_k_matches_numpy(n, k, top, gap):
    """The host step of the subset solve against ``numpy.linalg.eigh`` of
    the same tridiagonal, in float64: the top k descending, within the
    bisection's stop (1e-10 of the norm, so 1e-9 of lambda_1 here); the
    vectors orthonormal to 1e-12, each an eigenvector to 1e-9 of lambda_1
    (well posed inside a cluster, where a column is not), and equal to
    numpy's up to sign where their gaps exceed 1e-3 of lambda_1."""
    d, e = _tridiagonal(n, np.array(top), seed=n + k, gap=gap)
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    want_vals, want_vecs = np.linalg.eigh(t)
    want_vals, want_vecs = want_vals[::-1][:k], want_vecs[:, ::-1][:, :k]
    vals, vecs = teigh.tridiagonal_top_k(d, e, k)
    assert vals.dtype == vecs.dtype == np.float64
    assert vals.shape == (k,) and vecs.shape == (n, k)
    scale = want_vals[0]
    np.testing.assert_allclose(vals, want_vals, rtol=0, atol=1e-9 * scale)
    assert np.all(np.diff(vals) <= 0)
    np.testing.assert_allclose(vecs.T @ vecs, np.eye(k), rtol=0, atol=1e-12)
    resid = np.linalg.norm(t @ vecs - vecs * vals, axis=0)
    assert resid.max() <= 1e-9 * scale
    all_vals = np.linalg.eigvalsh(t)[::-1]
    for j in range(k):
        gaps = np.abs(np.delete(all_vals, j) - all_vals[j])
        if gaps.min() > 1e-3 * scale:
            _assert_cols_match_up_to_sign(vecs[:, j:j + 1],
                                          want_vecs[:, j:j + 1], atol=1e-9)


def _band_dense(am, b):
    """The symmetric band of width b that ``am`` holds read column-major
    (its lower band), as a dense float64 matrix."""
    n = am.shape[0]
    out = np.zeros((n, n))
    for d in range(min(b, n - 1) + 1):
        out += np.diag(np.diagonal(am, d).astype(np.float64), -d)
    return np.tril(out) + np.tril(out, -1).T


@pytest.mark.parametrize("n,b", [(60, 8), (60, 32), (200, 8), (200, 32)])
def test_dense_to_band_keeps_the_spectrum_and_q1_rebuilds_a(n, b):
    """The first stage in torch on the CPU (``torch.geqrf`` in cuSOLVER's
    place): the band it leaves has the matrix's eigenvalues (scipy
    ``eig_banded`` in float64) within 1e-6 of lambda_1, nothing past the
    band's width is read, and ``Q1`` (from its reflectors and T factors,
    applied to the identity) is orthogonal within 2e-6 and rebuilds A,
    ``Q1 B Q1^T``, within 1e-6 of lambda_1."""
    from scipy.linalg import eig_banded

    from spark_examples_tpu_torch.ops import band_chase

    a0 = _planted_b(n=n, k=4, seed=n * b)
    a = torch.from_numpy(a0.copy())
    tees = teigh.dense_to_band(a, b)
    assert tees.shape == (len(range(0, n - b - 1, b)), b, b)
    am = a.numpy()
    band = band_chase.band_of(am, b)[:, :b + 1]
    got = eig_banded(band.T.astype(np.float64), lower=True,
                     eigvals_only=True)
    want = np.linalg.eigvalsh(a0.astype(np.float64))
    scale = want[-1]
    assert np.abs(got - want).max() <= 1e-6 * scale
    q1 = torch.eye(n, dtype=torch.float32)
    teigh.apply_q1(a, b, tees, q1)
    q = q1.double().numpy().T
    assert np.abs(q.T @ q - np.eye(n)).max() <= 2e-6
    rebuilt = q @ _band_dense(am, b) @ q.T
    assert np.abs(rebuilt - a0).max() <= 1e-6 * scale


@pytest.mark.parametrize("n,b", [(60, 8), (61, 16), (200, 7), (200, 32)])
def test_plain_band_chase_gives_a_tridiagonal_with_the_bands_spectrum(n, b):
    """The plain bulge chase, the kernel's stand-in on the CPU, on the
    lower band of a planted matrix: status 0; T's eigenvalues are the
    band's (``eigvalsh`` in float64) within 1e-6 of lambda_1; its
    reflectors, stored in ``a``'s strict lower triangle, rebuild the
    band, ``Q2 T Q2^T``, within 1e-6 of lambda_1, and leave the band's
    first stage reflectors (``a``'s upper triangle past the band) as
    they were."""
    from spark_examples_tpu_torch.ops import band_chase

    a0 = _planted_b(n=n, k=4, seed=n + b)
    a = torch.from_numpy(a0.copy())
    tri = torch.empty(2 * n, dtype=torch.float32)
    band_chase.chase(a, b, tri)
    assert int(tri[-1:].view(torch.int32)) == 0
    d, e = tri[:n].double().numpy(), tri[n:-1].double().numpy()
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    band = _band_dense(a0, b)
    want = np.linalg.eigvalsh(band)
    scale = np.abs(want).max()
    assert np.abs(np.linalg.eigvalsh(t) - want).max() <= 1e-6 * scale
    np.testing.assert_array_equal(np.triu(a.numpy(), b + 1),
                                  np.triu(a0, b + 1))
    q2 = torch.eye(n, dtype=torch.float32)
    band_chase.apply_q2(a, b, q2)
    q = q2.double().numpy().T
    assert np.abs(q @ t @ q.T - band).max() <= 1e-6 * scale


@pytest.mark.parametrize("n,k", [(60, 4), (61, 1), (61, 7), (200, 10)])
def test_two_stage_subset_eigh_with_the_stand_ins(monkeypatch, n, k):
    """The two-stage subset solve on the CPU (its route's reach lowered
    to these sizes), its stand-ins in the card's place: LAPACK's
    ``geqrf`` through ``torch.geqrf`` for cuSOLVER's, the plain chase and
    back-transform for the kernels. The layouts, the one copy of T and
    its status, the host step and the k vectors' way back through both
    stages give the top k of the full float64 solve: eigenvalues within
    1e-5 of lambda_1, residuals and orthogonality under 1e-5, and the
    separated columns of JAX's solve up to sign."""
    monkeypatch.setattr(teigh, "TWO_STAGE_FROM", 0)
    b = _planted_b(n=n, k=4, seed=n + k)
    vals, vecs = teigh.subset_eigh(torch.from_numpy(b), k)
    assert vals.dtype == vecs.dtype == torch.float32
    assert vals.shape == (k,) and vecs.shape == (n, k)
    want = np.linalg.eigvalsh(b.astype(np.float64))[::-1][:k]
    scale = want[0]
    v, lam = vecs.double().numpy(), vals.double().numpy()
    np.testing.assert_allclose(lam, want, rtol=0, atol=1e-5 * scale)
    resid = np.linalg.norm(b.astype(np.float64) @ v - v * lam, axis=0)
    assert resid.max() <= 1e-5 * scale
    assert np.abs(v.T @ v - np.eye(k)).max() <= 1e-5
    vals_j, vecs_j = jeigh.top_k_eigh(b, min(k, 4))
    _assert_cols_match_up_to_sign(v[:, :min(k, 4)], np.asarray(vecs_j),
                                  atol=1e-3)


def test_two_stage_subset_eigh_raises_on_a_failed_chase(monkeypatch):
    """A nonzero status from the reduction's second stage raises where T
    reaches the host; no full solve takes its place."""
    from spark_examples_tpu_torch.ops import band_chase

    def failed(a, b, tri):
        tri[-1:].view(torch.int32).fill_(2)

    monkeypatch.setattr(teigh, "TWO_STAGE_FROM", 0)
    monkeypatch.setattr(band_chase, "chase_plain", failed)
    with pytest.raises(RuntimeError, match="band_chase.*status 2"):
        teigh.subset_eigh(torch.from_numpy(_planted_b()), 4)


@pytest.mark.parametrize("words,raised", [
    ([0, 0, 0], None), ([0, -5, 0, 0], -5), ([3, 0, 9], 3), ([0, 0, 7], 7),
])
def test_a_status_of_several_words_raises_on_any_nonzero_one(words, raised):
    """A status of several words (the first stage's devInfo, one a
    panel) raises on its first nonzero word wherever it lies, so a later
    panel's 0 does not hide an earlier panel's failure; all zeros pass."""
    from spark_examples_tpu_torch.core import profiling

    status = torch.tensor(words, dtype=torch.int32)
    if raised is None:
        profiling.check_at_barrier(status, "cusolverDnSgeqrf")
        return
    with pytest.raises(RuntimeError,
                       match=f"cusolverDnSgeqrf.*status {raised}$"):
        profiling.check_at_barrier(status, "cusolverDnSgeqrf")


@pytest.mark.parametrize("n,two_stage", [
    (3584, False), (4096, False), (4352, False), (4607, False),
    (4608, True), (4864, True), (5120, True), (10000, True), (15708, True),
    (76156, True),
])
def test_two_stage_route_follows_n_alone(n, two_stage):
    """One rule on the shape, set from the probe's pairs (one-stage
    against two-stage subset solves on the card): the two-stage
    reduction from n = 4,608 on: one stage is as fast or faster at
    4,352 and two are faster at 4,608, at k = 1, 10 and 32 alike; one
    band width; no option."""
    assert teigh.two_stage_route(n) is two_stage
    assert teigh.BAND_WIDTH == 64


def _lapack_in_cusolvers_place(monkeypatch):
    """``cusolver.sytrd`` and ``ormtr`` on CPU tensors, read as cuSOLVER
    reads them (a contiguous (n, n) tensor as its column-major
    transpose, (k, n) as n x k columns): LAPACK's own ``ssytrd``, and
    its reflectors applied in float64 from the last to the first."""
    from scipy.linalg import lapack

    from spark_examples_tpu_torch.ops import cusolver

    def sytrd(a, d, e, tau, info):
        col_major = a.numpy().T
        c, d_, e_, tau_, info_ = lapack.ssytrd(
            np.asfortranarray(col_major), lower=1)
        col_major[:] = c
        d.numpy()[:], e.numpy()[:], tau.numpy()[:] = d_, e_, tau_
        info.numpy()[0] = info_

    def ormtr(a, tau, c, info):
        refl = a.numpy().T.astype(np.float64)
        cols = c.numpy().T
        n = refl.shape[0]
        x = cols.astype(np.float64)
        for i in range(n - 2, -1, -1):
            v = np.zeros(n)
            v[i + 1] = 1.0
            v[i + 2:] = refl[i + 2:, i]
            x -= float(tau[i]) * np.outer(v, v @ x)
        cols[:] = x
        info.numpy()[0] = 0

    monkeypatch.setattr(cusolver, "sytrd", sytrd)
    monkeypatch.setattr(cusolver, "ormtr", ormtr)


@pytest.mark.parametrize("n,k", [(60, 4), (61, 1), (61, 7)])
def test_subset_eigh_with_lapack_in_cusolvers_place(monkeypatch, n, k):
    """The subset solve's plumbing on the CPU, LAPACK standing in for
    cuSOLVER: the layouts handed to the library, the one copy of T and
    its status, the host step and the k vectors' way back give the top
    k of the full float64 solve: eigenvalues within 1e-5 of lambda_1,
    residuals and orthogonality under 1e-5, and the separated columns
    of JAX's solve up to sign."""
    _lapack_in_cusolvers_place(monkeypatch)
    b = _planted_b(n=n, k=4, seed=n + k)
    vals, vecs = teigh.subset_eigh(torch.from_numpy(b), k)
    assert vals.dtype == vecs.dtype == torch.float32
    assert vals.shape == (k,) and vecs.shape == (n, k)
    want = np.linalg.eigvalsh(b.astype(np.float64))[::-1][:k]
    scale = want[0]
    v, lam = vecs.double().numpy(), vals.double().numpy()
    np.testing.assert_allclose(lam, want, rtol=0, atol=1e-5 * scale)
    resid = np.linalg.norm(b.astype(np.float64) @ v - v * lam, axis=0)
    assert resid.max() <= 1e-5 * scale
    assert np.abs(v.T @ v - np.eye(k)).max() <= 1e-5
    vals_j, vecs_j = jeigh.top_k_eigh(b, min(k, 4))
    _assert_cols_match_up_to_sign(v[:, :min(k, 4)], np.asarray(vecs_j),
                                  atol=1e-3)


def test_subset_eigh_raises_on_a_failed_reduction(monkeypatch):
    """A nonzero status from the reduction raises where T reaches the
    host; no full solve takes its place."""
    from spark_examples_tpu_torch.ops import cusolver

    _lapack_in_cusolvers_place(monkeypatch)

    def failed(a, d, e, tau, info):
        info.fill_(-4)

    monkeypatch.setattr(cusolver, "sytrd", failed)
    with pytest.raises(RuntimeError, match="cusolverDnSsytrd.*status -4"):
        teigh.subset_eigh(torch.from_numpy(_planted_b()), 4)
