"""Symmetric eigendecomposition of the centered matrix.

- :func:`top_k_eigh`: the top k eigenpairs, the counterpart of the JAX
  package's ``jnp.linalg.eigh`` route. On the CPU, and on a card where
  :func:`subset_route` says no, the full dense ``torch.linalg.eigh``,
  then the top k. On a card otherwise the subset solve: a Householder
  reduction to a tridiagonal ``T``, only ``T``'s top k eigenpairs, found
  on the host in float64 by bisection and inverse iteration (LAPACK
  ``stebz`` + ``stein``, :func:`tridiagonal_top_k`), and only those k
  vectors transformed back. The reduction is cuSOLVER's one-stage
  ``sytrd`` (``ormtr`` back) below ``TWO_STAGE_FROM``, and from there
  two stages (:func:`two_stage_route`): dense to a band of width
  ``BAND_WIDTH`` by blocked FP32 products (:func:`dense_to_band`), band
  to tridiagonal by the bulge-chasing kernel (``ops/band_chase.py``),
  and back through both (:func:`apply_q1`). Each subset solve counts
  ``eigh.subset_solves``, each two-stage one ``eigh.two_stage_solves``.
- :func:`randomized_eigh`: randomized subspace iteration (k + p probes,
  QR re-orthonormalisation each power step, a small Rayleigh eigh) for
  large N and for tiled matrices, which it reads only through ``b @ q``.
  Its probes come from a ``torch.Generator`` unless the caller hands
  them in, so tests can feed the JAX and PyTorch sides the same
  numbers.

Either solve is the device span ``eigh.solve`` (its device seconds on a
card, read at the caller's next barrier); the two stages are the spans
``eigh.band`` and ``eigh.chase`` inside it.
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
from spark_examples_tpu_torch.ops import band_chase, cusolver

# The subset solve's reach: N^2 at least SUBSET_N2_PER_PAIR times k
# (see subset_route).
SUBSET_N2_PER_PAIR = 1.1e6
# Where the tridiagonal's bisection stops, relative to its norm.
TRIDIAGONAL_TOL = 1e-10
# Where the subset solve reduces in two stages (see two_stage_route), and
# the band width between them (see dense_to_band).
TWO_STAGE_FROM = 4608
BAND_WIDTH = 64

# A card's stream for the first stage's panel factorisations (see
# _side_stream), by device index.
_SIDE_STREAMS: dict[int, torch.cuda.Stream] = {}


def subset_route(device, n: int, k: int) -> bool:
    """Whether :func:`top_k_eigh` runs the subset solve for an (n, n)
    matrix on ``device``: on a card, for 0 < k < n with n^2 at least
    ``SUBSET_N2_PER_PAIR`` times k.

    After the reduction both solves share, the subset solve spares the
    card the full solve's divide and conquer and its back-transform of
    all n vectors, which grow as n^3, and pays a host step of bisection
    and inverse iteration a vector, which grows as k n, and a round trip
    to the host. So it wins where n^2 / k passes a constant. The host
    clock a solve, full against the one-stage subset solve, on an H100
    80GB HBM3 at 700 W (``python3 -m tools.eigh_probe``, k = 10, the
    best of two): 41.0 against 45.9 ms at N = 2,504, 82.0 against 77.4
    at 3,584, 110.3 against 97.8 at 4,096; from 4,608 on the subset
    solve reduces in two stages (:func:`two_stage_route`) and wins by
    more: 205.1 against 144.0 at 5,120, 644.0 against 253.4 at 8,192,
    1,063.6 against 316.9 at 10,000, 2,854.7 against 660.1 at 15,708.
    At k = 32 and 64 (the one-stage solve, an earlier run of the probe):
    81.7 against 97.0 at 3,584 and 633 against 535 at 8,192 (k = 32);
    633 against 651 at 8,192 and 2,844 against 2,135 at 15,708 (k = 64).
    The constant puts the line between each pair that changes sides."""
    return torch.device(device).type == "cuda" and 0 < k < n \
        and n * n >= SUBSET_N2_PER_PAIR * k


def two_stage_route(n: int) -> bool:
    """Whether the subset solve of an (n, n) matrix reduces it in two
    stages (:func:`dense_to_band`, then the band chase), else in one
    (cuSOLVER ``sytrd``): from ``TWO_STAGE_FROM`` on.

    The one-stage reduction reads the trailing matrix once a column
    (``symv``), ~2n^3/3 bytes, so it grows as n^3 at the card's memory
    rate. The two stages read it once a panel of ``BAND_WIDTH`` columns,
    but pay ~1 ms of host time and a QR a panel and the chase's chain of
    2n dependent steps, so they grow more slowly from a larger start.
    The host clock a solve at k = 10, one stage against two at a band
    of 64 (in parentheses a band of 32, through a kernel built for 32
    rows), on an H100 80GB HBM3 at 700 W (``python3 -m
    tools.eigh_probe``, the best of two): 45.9 against 81.5 (109.5) ms
    at 2,504, 77.4 against 94.5 (144.4) at 3,584, 97.8 against 111.5
    (185.7) at 4,096, 173.7 against 144.0 (166.8) at 5,120, 261.3
    against 174.5 (217.0) at 6,144, 486.7 against 253.4 (245.2) at
    8,192, 724.2 against 316.9 (385.8) at 10,000 and 1,912.2 against
    660.1 (692.6) at 15,708: a band of 64 is as fast or faster at every
    size but 8,192, where the two widths are within their runs' spread.
    Around the line, the median of five at k = 1 / 10 / 32: 84.4 /
    97.5 / 122.0 against 114.8 / 95.0 / 125.4 ms at 4,096, 100.6 /
    113.8 / 142.6 against 106.9 / 114.0 / 152.1 at 4,352, 118.9 / 132.6
    / 157.1 against 93.4 / 113.4 / 152.2 at 4,608, 137.4 / 151.7 /
    185.1 against 101.0 / 120.7 / 170.0 at 4,864. One stage is as fast
    or faster up to 4,352 at each k, two are faster from 4,608 at
    each, so the line lies at 4,608 whatever k."""
    return n >= TWO_STAGE_FROM


def top_k_eigh(b: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of symmetric ``b``, eigenvalues descending:
    (vals (k,), vecs (N, k))."""
    n = b.shape[0]
    with device_span("eigh.solve", b.device):
        if subset_route(b.device, n, k):
            vals, vecs = subset_eigh(b, k)
            telemetry.count("eigh.subset_solves")
            if two_stage_route(n):
                telemetry.count("eigh.two_stage_solves")
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


def _panels(n: int, b: int) -> range:
    """The first columns of the first stage's panels: every b columns
    while at least two rows lie below the band."""
    return range(0, max(n - b - 1, 0), b)


def _geqrf(panel: torch.Tensor, tau: torch.Tensor,
           info: torch.Tensor | None) -> None:
    """QR of the column-major ``panel`` in place (LAPACK's layout: R on
    and above the diagonal, the reflectors below it, their taus in
    ``tau``): cuSOLVER on the card, ``torch.geqrf`` on the CPU."""
    if panel.device.type == "cuda":
        cusolver.geqrf(panel, tau, info)
        return
    qr, t = torch.geqrf(panel)
    panel.copy_(qr)
    tau.copy_(t)


def _triangular_factor(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The compact-WY factor T of the reflectors ``v`` (m, kk), unit
    diagonal, and ``tau``: ``H_1 ... H_kk = I - V T V^T``, by the UT
    transform, ``T = (I + diag(tau) striu(V^T V))^-1 diag(tau)``. A
    reflector with tau 0 is the identity, and its row and column of T
    come out 0."""
    u = (v.T @ v).triu_(1).mul_(tau[:, None])
    return torch.linalg.solve_triangular(u, torch.diag(tau), upper=True,
                                         unitriangular=True)


def _panel_reflectors(at: torch.Tensor, j0: int, b: int) -> torch.Tensor:
    """Panel ``j0``'s reflectors as an explicit (m, kk) V, unit diagonal,
    from below the band of the column-major ``at``."""
    j1 = j0 + b
    v = at[j1:, j0:j0 + min(at.shape[0] - j1, b)].tril(-1)
    v.diagonal().fill_(1.0)
    return v


def _side_stream(device) -> torch.cuda.Stream:
    """The card's stream for the first stage's panel factorisations, made
    at its first use and kept: a high priority lets the factorisation,
    which runs on few SMs, take SMs as the trailing update's blocks
    retire."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _SIDE_STREAMS.get(index)
    if stream is None:
        stream = _SIDE_STREAMS.setdefault(
            index, torch.cuda.Stream(index, priority=-1))
    return stream


def dense_to_band(a: torch.Tensor, b: int) -> torch.Tensor:
    """The first stage: reduce symmetric ``a`` (n, n), read column-major
    as ``A``, in place to ``B = Q1^T A Q1`` of band width ``b``, in FP32
    (TF32 off). For each panel of b columns: QR of the panel below the
    band, its compact-WY factor T, and the two-sided update of the
    trailing matrix, ``A22 -= W V^T + V W^T`` with ``W = X - V T^T V^T X
    / 2`` and ``X = A22 V T``, as two products of the whole square (both
    triangles stay current). On the card the update of the next panel's
    columns goes first, and the next panel's QR runs on a second stream
    (:func:`_side_stream`; it touches only ``a``, the taus and its own
    workspace, so no tensor crosses the streams) while the rest of the
    update runs. The band is left in ``A``'s lower band, the
    reflectors below it; returns the panels' T factors (panels, b, b)."""
    n = a.shape[0]
    at = a.T
    starts = _panels(n, b)
    tees = torch.zeros((len(starts), b, b), dtype=a.dtype, device=a.device)
    if not starts:
        return tees
    tau = torch.empty(n, dtype=a.dtype, device=a.device)
    cuda = a.device.type == "cuda"
    # Each panel's devInfo in its own slot, all read at the barrier.
    info = torch.zeros(len(starts), dtype=torch.int32, device=a.device) \
        if cuda else None

    def qr(p):
        j0 = starts[p]
        _geqrf(at[j0 + b:, j0:j0 + b], tau[j0:j0 + min(n - j0 - b, b)],
               info[p:p + 1] if cuda else None)

    def reflectors(p):
        j0 = starts[p]
        kk = min(n - j0 - b, b)
        v = _panel_reflectors(at, j0, b)
        t = _triangular_factor(v, tau[j0:j0 + kk])
        tees[p, :kk, :kk] = t
        return v, t

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qr(0)
        v, t = reflectors(0)
        for p in range(len(starts)):
            a22 = at[starts[p] + b:, starts[p] + b:]
            x = a22 @ (v @ t)
            w = torch.addmm(x, v, t.T @ (v.T @ x), alpha=-0.5)
            wv, vw = torch.cat([w, v], 1), torch.cat([v, w], 1)
            if p + 1 == len(starts):
                a22.addmm_(wv, vw.T, alpha=-1.0)
                break
            a22[:, :b].addmm_(wv, vw[:b].T, alpha=-1.0)
            if cuda:
                main, side = torch.cuda.current_stream(a.device), \
                    _side_stream(a.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    qr(p + 1)
                a22[:, b:].addmm_(wv, vw[b:].T, alpha=-1.0)
                main.wait_stream(side)
            else:
                qr(p + 1)
                a22[:, b:].addmm_(wv, vw[b:].T, alpha=-1.0)
            v, t = reflectors(p + 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if cuda:
        check_at_barrier(info, "cusolverDnSgeqrf")
    return tees


def apply_q1(a: torch.Tensor, b: int, tees: torch.Tensor,
             cols: torch.Tensor) -> None:
    """``C := Q1 C`` in place for the columns ``cols`` (k, n), Q1 the
    first stage's reflectors in ``a`` and T factors ``tees``: the panels
    last to first, each ``C[j1:] -= V (T (V^T C[j1:]))``, in FP32."""
    n = a.shape[0]
    at, x = a.T, cols.T
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for p, j0 in reversed(list(enumerate(_panels(n, b)))):
            v = _panel_reflectors(at, j0, b)
            kk = v.shape[1]
            rows = x[j0 + b:]
            rows.addmm_(v, tees[p, :kk, :kk] @ (v.T @ rows), alpha=-1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def subset_eigh(b: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The subset solve of symmetric float32 ``b`` (n, n) on a card:
    (vals (k,), vecs (n, k)), descending. Reduces a copy of ``b`` to
    ``T``: where :func:`two_stage_route` says so in two stages, dense to
    band (:func:`dense_to_band`, the device span ``eigh.band``) and band
    to tridiagonal (``ops/band_chase.py``, ``eigh.chase``), else by
    cuSOLVER's ``sytrd``. Reads ``T`` (2n - 1 numbers) and the reduction's
    status to the host in one copy, which is the solve's one wait, solves
    ``T``'s top k there, and applies the reduction's reflectors to those
    k vectors on the card (``ormtr``'s status is read at the next
    barrier)."""
    n = b.shape[0]
    a = b.clone(memory_format=torch.contiguous_format)
    # T's diagonal, its off-diagonal, and the reduction's status in the
    # last slot, so that one copy brings all three.
    tri = torch.empty(2 * n, dtype=torch.float32, device=b.device)
    if two_stage_route(n):
        width = BAND_WIDTH
        with device_span("eigh.band", b.device):
            tees = dense_to_band(a, width)
        with device_span("eigh.chase", b.device):
            band_chase.chase(a, width, tri)
        what = "band_chase"

        def back(cols):
            band_chase.apply_q2(a, width, cols)
            apply_q1(a, width, tees, cols)
    else:
        tau = torch.empty(n - 1, dtype=torch.float32, device=b.device)
        cusolver.sytrd(a, tri[:n], tri[n:-1], tau, tri[-1:].view(torch.int32))
        what = "cusolverDnSsytrd"

        def back(cols):
            info = torch.empty(1, dtype=torch.int32, device=b.device)
            cusolver.ormtr(a, tau, cols, info)
            check_at_barrier(info, "cusolverDnSormtr")
    host = tri.cpu()
    # A status already on the host is checked at once.
    check_at_barrier(host[-1:].view(torch.int32), what)
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
    back(cols)
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
