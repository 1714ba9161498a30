"""The solve stage: eigenpairs from the sketch, no N x N eigh.

Everything here works on (N, r) skinny blocks and (r, r) cores: the
N x N operator only existed implicitly, as the streamed passes of
:mod:`solvers.sketch`. The JAX package's ``solvers/solve.py``, on one
device (no plan, no row sharding). The (r, r) Cholesky and eigh are
``torch.linalg`` library calls (cuSOLVER on the card): no Pallas kernel
stands behind them in the JAX package either. Products run in full f32
(:func:`sketch.ieee_f32`).

- :func:`orthonormalize` — shifted CholeskyQR2, two rounds of
  ``Y chol(Y^T Y + eps I)^-T``: the between-pass step of the corrected
  rung.
- :func:`nystrom_eigs` — the single-pass rung: with ``Y = B Omega`` and
  the core ``C = Omega^T Y``, ``B ~ Y C^+ Y^T`` gives eigenpairs from a
  shifted Cholesky of C, a triangular solve and an (r, r) eigh.
- :func:`nystrom_eigs_scaled` — the same for ``B = M NUM M^T`` from the
  NUM sketch and its row-transformed twin (the dual sketch's rung).
- :func:`rayleigh_eigs` — the corrected rung: the last pass was
  ``Y = B Q`` with Q orthonormal, so ``T = Q^T Y`` gives Ritz pairs.
"""

from __future__ import annotations

import torch

from spark_examples_tpu_torch.solvers.sketch import ieee_f32

# Relative Cholesky shift: keeps the factor finite on a rank-deficient
# core at f32, and is noise against any eigenvalue the sketch resolves.
_SHIFT = 1e-6


def _shifted_chol(g: torch.Tensor):
    """(r, r) gram or core -> (lower Cholesky factor of g + shift I,
    shift)."""
    g = 0.5 * (g + g.T)
    r = g.shape[0]
    shift = _SHIFT * torch.clamp(torch.trace(g), min=1e-30) / r
    eye = torch.eye(r, dtype=g.dtype, device=g.device)
    return torch.linalg.cholesky(g + shift * eye), shift


def _inv_lower(l: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def _chol_qr_once(y: torch.Tensor) -> torch.Tensor:
    l, _ = _shifted_chol(y.T @ y)
    # y @ L^-T, the triangular solve on the skinny side.
    return y @ _inv_lower(l).T


@ieee_f32()
def orthonormalize(y: torch.Tensor) -> torch.Tensor:
    """Shifted CholeskyQR2 of an (N, r) block: orthonormal columns
    spanning the same space (still centered when ``y`` is: it is a right
    multiplication)."""
    return _chol_qr_once(_chol_qr_once(y))


def _top_from_factor(f: torch.Tensor, k: int):
    """B ~ F F^T -> the top-k eigenpairs from the (r, r) eigh of F^T F."""
    g = f.T @ f
    e, s = torch.linalg.eigh(0.5 * (g + g.T))  # ascending
    vals = e.flip(0)[:k]
    vecs = f @ (s.flip(1)[:, :k] / torch.sqrt(torch.clamp(vals, min=1e-30)))
    return vals, vecs


@ieee_f32()
def nystrom_eigs(y: torch.Tensor, qc: torch.Tensor, k: int):
    """Top-k eigenpairs of the single-pass Nystrom approximation from the
    sketch ``y = B @ omega`` and test block ``qc``: (vals (k,) descending
    >= 0, vecs (N, k) orthonormal)."""
    l, shift = _shifted_chol(qc.T @ y)
    vals, vecs = _top_from_factor(y @ _inv_lower(l).T, k)
    # Undo the stabilizing shift; B is PSD for every sketchable metric.
    return torch.clamp(vals - shift, min=0.0), vecs


@ieee_f32()
def nystrom_eigs_scaled(y: torch.Tensor, qc: torch.Tensor, g: torch.Tensor,
                        k: int):
    """Top-k eigenpairs of ``B = M NUM M^T`` from the NUM sketch
    ``y = NUM @ qc`` and its row-transformed twin ``g = M y``. The core
    ``qc^T NUM qc`` must be PSD (the registry's ``num_psd`` gate)."""
    l, shift = _shifted_chol(qc.T @ y)
    vals, vecs = _top_from_factor(g @ _inv_lower(l).T, k)
    return torch.clamp(vals - shift, min=0.0), vecs


@ieee_f32()
def rayleigh_eigs(y: torch.Tensor, q: torch.Tensor, k: int):
    """Top-k Ritz pairs from the last subspace-iteration pass
    (``y = B q``, q orthonormal): (vals (k,) descending, vecs (N, k))."""
    t = q.T @ y
    e, s = torch.linalg.eigh(0.5 * (t + t.T))  # ascending
    return e.flip(0)[:k], q @ s.flip(1)[:, :k]
