"""The solve stage: eigenpairs from the sketch, no N x N eigh.

Everything here works on (N, r) skinny blocks and (r, r) cores: the
N x N operator only existed implicitly, as the streamed passes of
:mod:`solvers.sketch`. The JAX package's ``solvers/solve.py``. The
(r, r) Cholesky, triangular solve and eigh are ``torch.linalg`` library
calls (cuSOLVER on the card): no Pallas kernel stands behind them in the
JAX package either. Products run in full f32 (:func:`sketch.ieee_f32`).

Under a plan with more than one slot the (N, r) blocks are split by rows
over the flattened slots (``meshes.rows_flat``, JAX's ``_pin_rows``):
each r x r contraction (``Y^T Y``, ``Q^T Y``) is a local product on
every slot, the products summed on the block's device in slot order
(JAX's psum), and the (r, r) math runs once there and is shared. The
result comes back whole on the block's device. Slot-order sums differ
from one slot's and from the psum by rounding only.

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
- :func:`stage_runtimes` — the three stages timed at an (n, rank) shape
  on a plan (``bench_torch.py --multichip``).
"""

from __future__ import annotations

import time

import torch

from spark_examples_tpu_torch.core import meshes
from spark_examples_tpu_torch.core.profiling import hard_sync
from spark_examples_tpu_torch.solvers.sketch import ieee_f32

# Relative Cholesky shift: keeps the factor finite on a rank-deficient
# core at f32, and is noise against any eigenvalue the sketch resolves.
_SHIFT = 1e-6


def _rows(plan, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` split by rows over the plan's slots, each piece on its
    slot's device (``meshes.rows_flat``); ``[x]`` without a plan or on
    one slot."""
    if plan is None or plan.mesh.size == 1:
        return [x]
    mesh = plan.mesh
    return [x[sl].to(mesh.devices[s])
            for s, sl in enumerate(meshes.rows_flat(mesh, x.shape[0]))]


def _gram(lefts, rights, home: torch.device) -> torch.Tensor:
    """``sum_s lefts[s]^T @ rights[s]``: a local (r, r) product per slot,
    summed on ``home`` in slot order."""
    total = None
    for a, b in zip(lefts, rights):
        p = (a.T @ b).to(home)
        total = p if total is None else total + p
    return total


def _times(blocks, m: torch.Tensor):
    """Each row block times the shared (r, c) matrix ``m``, on its slot."""
    return [b @ m.to(b.device) for b in blocks]


def _whole(blocks, home: torch.device) -> torch.Tensor:
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat([b.to(home) for b in blocks])


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


def _chol_qr_once(ys, home):
    l, _ = _shifted_chol(_gram(ys, ys, home))
    # y @ L^-T, the triangular solve on the skinny side.
    return _times(ys, _inv_lower(l).T)


@ieee_f32()
def orthonormalize(y: torch.Tensor, plan=None) -> torch.Tensor:
    """Shifted CholeskyQR2 of an (N, r) block: orthonormal columns
    spanning the same space (still centered when ``y`` is: it is a right
    multiplication)."""
    home = y.device
    return _whole(_chol_qr_once(_chol_qr_once(_rows(plan, y), home), home),
                  home)


def _top_from_factor(fs, k: int, home):
    """B ~ F F^T -> the top-k eigenpairs from the (r, r) eigh of F^T F."""
    g = _gram(fs, fs, home)
    e, s = torch.linalg.eigh(0.5 * (g + g.T))  # ascending
    vals = e.flip(0)[:k]
    m = s.flip(1)[:, :k] / torch.sqrt(torch.clamp(vals, min=1e-30))
    return vals, _whole(_times(fs, m), home)


@ieee_f32()
def nystrom_eigs(y: torch.Tensor, qc: torch.Tensor, k: int, plan=None):
    """Top-k eigenpairs of the single-pass Nystrom approximation from the
    sketch ``y = B @ omega`` and test block ``qc``: (vals (k,) descending
    >= 0, vecs (N, k) orthonormal)."""
    home = y.device
    ys = _rows(plan, y)
    l, shift = _shifted_chol(_gram(_rows(plan, qc), ys, home))
    vals, vecs = _top_from_factor(_times(ys, _inv_lower(l).T), k, home)
    # Undo the stabilizing shift; B is PSD for every sketchable metric.
    return torch.clamp(vals - shift, min=0.0), vecs


@ieee_f32()
def nystrom_eigs_scaled(y: torch.Tensor, qc: torch.Tensor, g: torch.Tensor,
                        k: int, plan=None):
    """Top-k eigenpairs of ``B = M NUM M^T`` from the NUM sketch
    ``y = NUM @ qc`` and its row-transformed twin ``g = M y``. The core
    ``qc^T NUM qc`` must be PSD (the registry's ``num_psd`` gate)."""
    home = y.device
    l, shift = _shifted_chol(_gram(_rows(plan, qc), _rows(plan, y), home))
    vals, vecs = _top_from_factor(_times(_rows(plan, g), _inv_lower(l).T), k,
                                  home)
    return torch.clamp(vals - shift, min=0.0), vecs


@ieee_f32()
def rayleigh_eigs(y: torch.Tensor, q: torch.Tensor, k: int, plan=None):
    """Top-k Ritz pairs from the last subspace-iteration pass
    (``y = B q``, q orthonormal): (vals (k,) descending, vecs (N, k))."""
    home = y.device
    qs = _rows(plan, q)
    t = _gram(qs, _rows(plan, y), home)
    e, s = torch.linalg.eigh(0.5 * (t + t.T))  # ascending
    return e.flip(0)[:k], _whole(_times(qs, s.flip(1)[:, :k]), home)


def stage_runtimes(n: int, rank: int, plan=None, k: int = 10,
                   repeats: int = 3, seed: int = 0,
                   device="cuda") -> dict[str, float]:
    """Wall-clock seconds of the solve stages at an ``(n, rank)`` sketch
    shape on ``plan``'s slots (on ``device`` without a plan), the best of
    ``repeats`` after one warm run per stage:

    - ``cholqr2_s`` — one shifted CholeskyQR2 (two local r x r grams
      summed over the slots, two triangular solves, two skinny products);
    - ``nystrom_s`` — the single-pass terminal Nystrom solve;
    - ``rayleigh_s`` — the corrected rung's terminal Rayleigh solve.

    The input is a seeded normal block from a CPU ``torch.Generator``
    (the time depends on the shape, not the spectrum), placed on the
    plan's home device and used as both the sketch and the probes: JAX
    draws two independent blocks, whose Nystrom core ``qc^T y`` is
    indefinite, and ``jnp.linalg.cholesky`` returns NaN there where
    ``torch.linalg.cholesky`` raises. Each run ends with ``hard_sync``
    on every device of the plan."""
    if plan is not None:
        device = plan.mesh.home
    else:
        from spark_examples_tpu_torch.core.device import resolve_device

        device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    y = torch.randn((n, rank), generator=gen).to(device)
    qc = y.clone()
    slots = [y] if plan is None else [
        torch.empty(0, device=d) for d in plan.mesh.physical]
    out: dict[str, float] = {}
    for name, fn in (
        ("cholqr2_s", lambda: orthonormalize(y, plan)),
        ("nystrom_s", lambda: nystrom_eigs(y, qc, k, plan)),
        ("rayleigh_s", lambda: rayleigh_eigs(y, qc, k, plan)),
    ):
        hard_sync((fn(), slots))  # warm
        best = float("inf")
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            hard_sync((fn(), slots))
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    return out
