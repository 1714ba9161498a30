"""Symmetric eigendecomposition of the centered matrix.

- :func:`top_k_eigh`: the top k eigenpairs, the counterpart of the JAX
  package's ``jnp.linalg.eigh`` route. On the CPU, and on a card where
  :func:`subset_route` says no, the full dense ``torch.linalg.eigh``,
  then the top k. On a card otherwise the subset solve: the same
  Householder reduction to a tridiagonal ``T`` (cuSOLVER ``sytrd``),
  only ``T``'s top k eigenpairs, found on the host in float64 by
  bisection and inverse iteration (LAPACK ``stebz`` + ``stein``,
  :func:`tridiagonal_top_k`), and only those k vectors transformed back
  (``ormtr``). Each subset solve counts ``eigh.subset_solves``.
- :func:`randomized_eigh`: randomized subspace iteration (k + p probes,
  QR re-orthonormalisation each power step, a small Rayleigh eigh) for
  large N and for tiled matrices, which it reads only through ``b @ q``. Its probes come from a ``torch.Generator`` unless the caller
  hands them in, so tests can feed the JAX and PyTorch sides the same
  numbers.

Either solve is the device span ``eigh.solve`` (its device seconds on a
card, read at the caller's next barrier).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.config import (
    EIGH_ITERS_DEFAULT,
    EIGH_OVERSAMPLE_DEFAULT,
)
from spark_examples_tpu_torch.core.profiling import (
    check_at_barrier,
    device_span,
)
from spark_examples_tpu_torch.ops import cusolver

# The subset solve's reach: N^2 at least SUBSET_N2_PER_PAIR times k
# (see subset_route).
SUBSET_N2_PER_PAIR = 1.1e6
# Where the tridiagonal's bisection stops, relative to its norm.
TRIDIAGONAL_TOL = 1e-10


def subset_route(device, n: int, k: int) -> bool:
    """Whether :func:`top_k_eigh` runs the subset solve for an (n, n)
    matrix on ``device``: on a card, for 0 < k < n with n^2 at least
    ``SUBSET_N2_PER_PAIR`` times k.

    After the reduction both solves share, the subset solve spares the
    card the full solve's divide and conquer and its back-transform of
    all n vectors, which grow as n^3, and pays a host step of bisection
    and inverse iteration a vector, which grows as k n, and a round trip
    to the host. So it wins where n^2 / k passes a constant. The host
    clock a solve, full against subset, on an H100 80GB HBM3 at 700 W
    (``python3 -m tools.eigh_probe``): at k = 10, 40.9 against 42.4 ms
    at N = 2,504, 59.0 against 59.8 at 3,072, 82.2 against 77.4 at
    3,584, 109.6 against 94.8 at 4,096, 631 against 479 at 8,192, 1,035
    against 726 at 10,000 and 2,804 against 1,858 at 15,708; at k = 32,
    81.7 against 97.0 at 3,584, 633 against 535 at 8,192; at k = 64,
    633 against 651 at 8,192 and 2,844 against 2,135 at 15,708. The
    constant puts the line between each pair that changes sides."""
    return torch.device(device).type == "cuda" and 0 < k < n \
        and n * n >= SUBSET_N2_PER_PAIR * k


def top_k_eigh(b: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of symmetric ``b``, eigenvalues descending:
    (vals (k,), vecs (N, k))."""
    n = b.shape[0]
    with device_span("eigh.solve", b.device):
        if subset_route(b.device, n, k):
            vals, vecs = subset_eigh(b, k)
            telemetry.count("eigh.subset_solves")
            return vals, vecs
        vals, vecs = torch.linalg.eigh(b)  # ascending
    return vals.flip(0)[:k], vecs.flip(1)[:, :k]


def tridiagonal_top_k(d: np.ndarray, e: np.ndarray, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The top-k eigenpairs of the symmetric tridiagonal matrix with
    diagonal ``d`` (n,) and off-diagonal ``e`` (n - 1,), in float64,
    eigenvalues descending: (vals (k,), vecs (n, k)). Bisection finds
    the eigenvalues by index, inverse iteration their vectors, which it
    orthogonalises within each cluster of close eigenvalues. Bisection
    stops at ``TRIDIAGONAL_TOL`` of ``T``'s norm (its Gershgorin bound):
    a ``T`` reduced in float32 holds its eigenvalues to ~6e-8 of it, and
    the halvings past that point would resolve its rounding only."""
    from scipy.linalg import eigh_tridiagonal

    n = d.shape[0]
    off = np.abs(e)
    norm = float(np.max(np.abs(d) + np.append(off, 0.0)
                        + np.insert(off, 0, 0.0)))
    vals, vecs = eigh_tridiagonal(d, e, select="i",
                                  select_range=(n - k, n - 1),
                                  tol=TRIDIAGONAL_TOL * norm,
                                  lapack_driver="stebz")
    return vals[::-1], vecs[:, ::-1]


def subset_eigh(b: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The subset solve of symmetric float32 ``b`` (n, n) on a card:
    (vals (k,), vecs (n, k)), descending. Reduces a copy of ``b`` to
    ``T``, reads ``T`` (2n - 1 numbers) and the reduction's status to the
    host in one copy, which is the solve's one wait, solves ``T``'s top
    k there, and applies the reduction's reflectors to those k vectors
    on the card; that step's status is read at the next barrier."""
    n = b.shape[0]
    a = b.clone(memory_format=torch.contiguous_format)
    # T's diagonal, its off-diagonal, and the reduction's devInfo in the
    # last slot, so that one copy brings all three.
    tri = torch.empty(2 * n, dtype=torch.float32, device=b.device)
    tau = torch.empty(n - 1, dtype=torch.float32, device=b.device)
    cusolver.sytrd(a, tri[:n], tri[n:-1], tau, tri[-1:].view(torch.int32))
    host = tri.cpu()
    # A status already on the host is checked at once.
    check_at_barrier(host[-1:].view(torch.int32), "cusolverDnSsytrd")
    vals, vecs = tridiagonal_top_k(host[:n].double().numpy(),
                                   host[n:-1].double().numpy(), k)
    # The k vectors as (k, n) rows, which cuSOLVER reads as n x k
    # columns, and the k values after them: one copy up, which waits on
    # nothing (CUDA stages pageable memory before the call returns).
    up = np.empty(k * (n + 1), dtype=np.float32)
    up[:k * n].reshape(k, n)[:] = vecs.T
    up[k * n:] = vals
    up = torch.from_numpy(up).to(b.device, non_blocking=True)
    cols = up[:k * n].view(k, n)
    info = torch.empty(1, dtype=torch.int32, device=b.device)
    cusolver.ormtr(a, tau, cols, info)
    check_at_barrier(info, "cusolverDnSormtr")
    return up[k * n:], cols.T


def _select(vals, vecs, k: int, select: str):
    """The k pairs to keep from an ascending eigh: the largest values
    (``top``, descending) or the largest |lambda| (``abs``, the PCA
    ordering: power iteration amplifies |lambda|, so the subspace already
    targets those)."""
    if select == "abs":
        order = torch.argsort(-torch.abs(vals), stable=True)[:k]
        return vals[order], vecs[:, order]
    if select != "top":
        raise ValueError(f"unknown select {select!r}; valid: top | abs")
    return vals.flip(0)[:k], vecs.flip(1)[:, :k]


def subspace_iterate(b, q: torch.Tensor, k: int, iters: int = 1,
                     select: str = "top"):
    """``iters`` power steps from an (N, p) subspace ``q``, then a
    Rayleigh solve: (vals (k,), vecs (N, k), q_new (N, p)). ``b`` is the
    symmetric matrix, or a function ``q -> b @ q`` (a tiled matrix's
    product, ``parallel/pcoa_sharded.py``). ``select``: see
    :func:`_select`."""
    bq = b if callable(b) else b.__matmul__
    for _ in range(iters):
        q, _ = torch.linalg.qr(bq(q))
    t = q.T @ bq(q)
    t = 0.5 * (t + t.T)
    vals, s = torch.linalg.eigh(t)
    vals_k, vecs = _select(vals, q @ s, k, select)
    return vals_k, vecs, q


def init_probes(n: int, p: int, generator: torch.Generator,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Random (N, min(p, N)) Gaussian probe block — the cold start."""
    return torch.randn((n, min(p, n)), generator=generator, dtype=dtype,
                       device=device)


def coords_from_eigpairs(vals: torch.Tensor,
                         vecs: torch.Tensor) -> torch.Tensor:
    """coords_i = v_i * sqrt(max(lambda_i, 0)): negative eigenvalues
    (non-Euclidean distances) become zero coordinate axes."""
    return vecs * torch.sqrt(torch.clamp(vals, min=0.0))[None, :]


def randomized_eigh(
    b,
    k: int,
    probes: torch.Tensor | None = None,
    oversample: int = EIGH_OVERSAMPLE_DEFAULT,
    iters: int = EIGH_ITERS_DEFAULT,
    generator: torch.Generator | None = None,
    select: str = "top",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Randomized top-k eigenpairs of symmetric ``b``: ``iters + 1``
    power steps from the probes, then a Rayleigh solve. ``probes`` (N, p)
    default to Gaussian draws of width k + oversample from ``generator``
    (seeded 0 on ``b``'s device when none is given); a ``b`` given as a
    function ``q -> b @ q`` needs its probes. ``select="abs"`` keeps the
    largest-|lambda| pairs (the PCA ordering)."""
    if probes is None:
        if generator is None:
            generator = torch.Generator(device=b.device).manual_seed(0)
        probes = init_probes(b.shape[0], k + oversample, generator,
                             dtype=b.dtype, device=b.device)
    with device_span("eigh.solve", probes.device):
        vals, vecs, _ = subspace_iterate(b, probes, k, iters + 1, select)
    return vals, vecs


def eigh_flops(n: int, method: str = "dense", k: int = 0,
               oversample: int = EIGH_OVERSAMPLE_DEFAULT,
               iters: int = EIGH_ITERS_DEFAULT) -> float:
    """Operation estimate matching the solver actually run: ~9 n^3 for
    the dense solve; for the randomized one, (iters + 2) B @ Q products at
    2 n^2 p each plus (iters + 1) QR factorisations at ~4 n p^2. For the
    sketch solver (``iters`` = its passes, ``k + oversample`` = its rank)
    only the solve stage's residue: a CholeskyQR2 (~6 n p^2) between
    passes and the terminal Nystrom or Rayleigh solve (~4 n p^2); its
    B @ Q products streamed with the passes and are credited there."""
    if method == "randomized":
        p = k + oversample
        return (iters + 2) * 2.0 * n * n * p + (iters + 1) * 4.0 * n * p * p
    if method == "sketch":
        p = k + oversample
        return max(iters - 1, 0) * 6.0 * n * p * p + 4.0 * n * p * p
    return 9.0 * float(n) ** 3
