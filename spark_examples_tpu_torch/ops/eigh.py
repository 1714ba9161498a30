"""Symmetric eigendecomposition of the centered matrix.

- :func:`top_k_eigh`: full dense ``torch.linalg.eigh``, then the top k —
  the counterpart of the JAX package's ``jnp.linalg.eigh`` route.
- :func:`randomized_eigh`: randomized subspace iteration (k + p probes,
  QR re-orthonormalisation each power step, a small Rayleigh eigh) for
  large N and for tiled matrices, which it reads only through ``b @ q``. Its probes come from a ``torch.Generator`` unless the caller
  hands them in, so tests can feed the JAX and PyTorch sides the same
  numbers.

Either solve is the device span ``eigh.solve`` (its device seconds on a
card, read at the caller's next barrier).
"""

from __future__ import annotations

import torch

from spark_examples_tpu_torch.core.config import (
    EIGH_ITERS_DEFAULT,
    EIGH_OVERSAMPLE_DEFAULT,
)
from spark_examples_tpu_torch.core.profiling import device_span


def top_k_eigh(b: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of symmetric ``b``, eigenvalues descending:
    (vals (k,), vecs (N, k))."""
    with device_span("eigh.solve", b.device):
        vals, vecs = torch.linalg.eigh(b)  # ascending
    return vals.flip(0)[:k], vecs.flip(1)[:, :k]


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
