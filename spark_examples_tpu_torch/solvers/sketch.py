"""Streaming range sketch: the N x N-free half of the sketch solver.

The exact route accumulates N x N gram pieces and eigensolves them,
which caps the cohort at what one card holds (at 100,000 samples the
four int32 ibs leaves alone are 160 GB). This module replaces that
state with an (N, r) range sketch folded block by block during the
variant pass: the JAX package's ``solvers/sketch.py``.

For every factor-sketchable metric (``kernels.FactorSketch``) the
centered solve operator is an exact Gram of per-block features
``A = [A_1 | A_2 | ...]``::

    B = (J A)(J A)^T / denom,      J = I - 11^T / N

so, since ``B J = J B = B``, a matvec block against probes Q is
``B Q = J sum_b A_b (A_b^T (J Q)) / denom``: two skinny products per
genotype block, (v, r) = A_b^T qc and then (N, r) = A_b w, at 4 N v r
operations instead of the exact route's 2 N^2 v.

Ratio metrics (``kernels.DualSketch``: ibs, jaccard) stream their
numerator and pair-count denominator as two sketches in pass 0, take
the rank-1 scale ``a = sqrt(diag(DEN))`` from the exactly streamed
denominator diagonal, and iterate the scaled operator
``J diag(1/a) NUM diag(1/a) J`` on the later passes.

Under a plan with more than one slot (``driver.sketch_plan``: the
``variant`` plan, never tile2d) each block is split by variant over the
slots with the gram route's own split and padding
(``gram_sharded._shards``, ``meshes.variants_flat``). Each slot forms its
partial ``y``, ``cm``, ``trace`` and ``nvar`` (the dual ``y``, ``yd``,
``d``, ``cm``) on its device against its copy of the replicated probes;
the partials are summed in slot order (JAX's psum) and added onto the
state, which is replicated: whole on the plan's home device. A pad
shard (all missing) adds zeros.

The products are ``torch.matmul`` in f32: the JAX package computes them
with ``dot_general`` outside any Pallas kernel, so no hand-written
kernel stands behind them. On CUDA every product here runs under
:func:`ieee_f32`, which turns TF32 off for its duration (the process's
setting is restored after), so the f32 products keep full f32 operands
whatever the caller configured.

The state is a dict of tensors (``y qc trace nvar cm``; the dual one
``y yd d q qc scale cm``) that rides ``core/checkpoint.py`` like a gram
accumulator. Updates add into it in place, in the block order, so a
resume from any block cursor is bit-identical to an uninterrupted run.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.ingest.bitpack import unpack_dosages
from spark_examples_tpu_torch.parallel import gram_sharded

# Checkpointed leaves (the JAX package's names). ``cm`` is the streamed
# column mass S @ 1 = A (A^T 1) that a persisted model's centering reads;
# the port accumulates it too, so that its checkpoints and the JAX
# package's hold the same leaves.
STATE_LEAVES = ("y", "qc", "trace", "nvar", "cm")

# The dual state: numerator sketch ``y``, denominator sketch ``yd``, the
# exactly streamed denominator diagonal ``d``, the orthonormal test
# basis ``q``, the streamed probes ``qc`` (q / a after pass 0), the
# rank-1 scale ``a`` (ones until pass 0 ends) and the scaled column mass
# ``cm`` (streamed on passes >= 1 only).
DUAL_STATE_LEAVES = ("y", "yd", "d", "q", "qc", "scale", "cm")


@contextmanager
def ieee_f32():
    """Run CUDA f32 matmuls with full f32 operands (TF32 off) inside the
    block, restoring the process's setting after. Also a decorator:
    ``@ieee_f32()``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def probes(n: int, rank: int, seed: int) -> torch.Tensor:
    """Deterministic (N, min(rank, N)) Gaussian probes on the CPU, from
    ``torch.Generator("cpu").manual_seed(seed)``: the same seed gives the
    same probes on the CPU and on the card (they move there after).
    These are not the JAX package's probes for the same seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((n, min(rank, n)), generator=gen,
                       dtype=torch.float32)


def center_cols(x: torch.Tensor) -> torch.Tensor:
    """J x: subtract each column's mean over samples (always an (N, r)
    block, never anything N x N)."""
    return x - x.mean(dim=0, keepdim=True)


def _dosages(block: torch.Tensor, packed: bool) -> torch.Tensor:
    return unpack_dosages(block) if packed else block


def _features(block: torch.Tensor, metric: str, precise: bool):
    """(N, v) int8 dosages -> (A_b, kept): the kernel's feature columns
    and the kept-variant count of the nvar denominator. Padding columns
    (all missing) give all-zero features: no contribution anywhere."""
    spec = kernels.get(metric).sketch
    if not isinstance(spec, kernels.FactorSketch):
        raise ValueError(f"metric {metric!r} has no factor sketch")
    return spec.features(block, precise)


def _splits(plan) -> bool:
    """Whether ``plan`` splits each block over several slots."""
    return (plan is not None and plan.mode != "replicated"
            and plan.mesh.size > 1)


def _slot_blocks(plan, block: torch.Tensor, packed: bool) -> dict:
    """The block's variant shards by slot, each on its slot's device:
    the gram route's variant split and padding; the whole block as slot
    0 when ``plan`` does not split."""
    if not _splits(plan):
        return {0: block}
    mesh = plan.mesh
    return gram_sharded._shards(
        plan, gram_sharded._pad(block, len(mesh.local_slots), packed))


def _on(t: torch.Tensor, device, copies: dict) -> torch.Tensor:
    """A replicated leaf on ``device``: one copy a physical device."""
    if device not in copies:
        copies[device] = t.to(device)
    return copies[device]


def _add_partials(state: dict, partials: list[dict]) -> dict:
    """Each leaf's slot partials summed in slot order on the state's
    device, then added onto the state (in place; the 0-d ``trace`` is
    copied into)."""
    home = state["y"].device
    for k in partials[0]:
        total = None
        for p in partials:
            v = torch.as_tensor(p[k], dtype=torch.float32).to(home)
            total = v if total is None else total + v
        if state[k].dim() == 0:
            state[k].copy_(state[k] + total)
        else:
            state[k].add_(total)
    return state


@ieee_f32()
def _factor_partial(block: torch.Tensor, qc: torch.Tensor, metric: str,
                    packed: bool, precise: bool) -> dict:
    """One slot's share of a factor update, from its variant shard:
    A (A^T qc); ||J A||_F^2 = sum_v (||a_v||^2 - (1^T a_v)^2 / N) (the
    total-inertia denominator); the kept count; the column mass
    A (A^T 1)."""
    a, kept = _features(_dosages(block, packed), metric, precise)
    colsum = a.sum(dim=0)
    return {"y": a @ (a.T @ qc),
            "trace": (a * a).sum() - (colsum * colsum).sum() / a.shape[0],
            "nvar": kept, "cm": a @ colsum}


def _factor_step(state: dict, shards: dict, metric: str, packed: bool,
                 precise: bool) -> dict:
    copies: dict = {}
    return _add_partials(state, [
        _factor_partial(shard, _on(state["qc"], shard.device, copies),
                        metric, packed, precise)
        for shard in shards.values()])


def update(state: dict, block: torch.Tensor, metric: str,
           packed: bool = False, precise: bool = False) -> dict:
    """One block into the factor sketch, in place (one slot): ``y`` gains
    A (A^T qc), ``trace`` ||J A_b||_F^2, ``nvar`` the kept count, ``cm``
    the column mass."""
    return _factor_step(state, {0: block}, metric, packed, precise)


def make_update(metric: str, packed: bool = False, precise: bool = False,
                plan=None):
    """``(state, block) -> state`` for the factor sketch of ``metric``;
    under a plan of several slots, each block split over them."""
    kernels.check_sketchable(metric, "sketch")
    return lambda state, block: _factor_step(
        state, _slot_blocks(plan, block, packed), metric, packed, precise)


def init_state(n: int, rank: int, seed: int, device=None,
               plan=None) -> dict:
    """Fresh factor state: zero sketch, centered probes, zero stats; on
    the plan's home device when a plan is given (JAX's argument), else
    on ``device``."""
    if plan is not None:
        device = plan.mesh.home
    r = min(rank, n)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "y": torch.zeros((n, r), **f32),
        "qc": center_cols(probes(n, rank, seed)).to(device),
        "trace": torch.zeros((), **f32),
        "nvar": torch.zeros((), **f32),
        "cm": torch.zeros((n,), **f32),
    }


def reset_for_pass(state: dict, qc: torch.Tensor, plan=None) -> dict:
    """Fresh accumulators for the next pass, streaming against ``qc``
    (the orthonormalized range the corrected rung iterates). ``cm``
    re-accumulates to the same value every pass, so it restarts too.
    The state stays where it is (the plan's home device); ``plan`` is
    the JAX signature's and is not read, the state being replicated."""
    return {
        "y": torch.zeros_like(state["y"]),
        "qc": qc.to(state["y"].device),
        "trace": torch.zeros_like(state["trace"]),
        "nvar": torch.zeros_like(state["nvar"]),
        "cm": torch.zeros_like(state["cm"]),
    }


def finalize_pass(y: torch.Tensor, trace: torch.Tensor, nvar: torch.Tensor,
                  is_grm: bool = False):
    """A completed pass -> (B @ q_in, trace(B)): the outer J and the
    metric's denominator."""
    denom = torch.clamp(nvar, min=1.0) if is_grm else 1.0
    return center_cols(y) / denom, trace / denom


@ieee_f32()
def _dual_partial(block: torch.Tensor, qc: torch.Tensor, u, metric: str,
                  packed: bool, with_den: bool) -> dict:
    """One slot's share of a dual update, from its variant shard:
    ``y`` = NUM_b @ qc and, on pass 0 (``with_den``), ``yd`` = DEN_b @ qc
    plus the exact denominator diagonal ``d``; on later passes the scaled
    column mass ``cm`` = NUM_b @ ``u`` (u = 1 / a)."""
    spec = kernels.get(metric).sketch
    ops = spec.operands(_dosages(block, packed))
    terms = spec.num_terms + (spec.den_terms if with_den else ())
    # Each distinct right operand meets the probes once: (v, r).
    rights = {}
    for _l, r, _w in terms:
        if r not in rights:
            rights[r] = ops[r].T @ qc

    def total(terms, product):
        out = None
        for left, right, w in terms:
            c = product(left, right)
            c = c * w if w != 1.0 else c
            out = c if out is None else out + c
        return out

    part = {"y": total(spec.num_terms,
                       lambda left, right: ops[left] @ rights[right])}
    if with_den:
        part["yd"] = total(spec.den_terms,
                           lambda left, right: ops[left] @ rights[right])
        # diag(L R^T) is a rowsum per term: the scale is exact.
        part["d"] = total(spec.den_terms, lambda left, right: (
            ops[left] * ops[right]).sum(dim=1))
    else:
        part["cm"] = total(spec.num_terms, lambda left, right: (
            ops[left] @ (ops[right].T @ u)))
    return part


def _dual_step(state: dict, shards: dict, metric: str, packed: bool,
               with_den: bool) -> dict:
    qcs: dict = {}
    us: dict = {}
    u = None if with_den else 1.0 / state["scale"]
    return _add_partials(state, [
        _dual_partial(shard, _on(state["qc"], shard.device, qcs),
                      None if u is None else _on(u, shard.device, us),
                      metric, packed, with_den)
        for shard in shards.values()])


def dual_update(state: dict, block: torch.Tensor, metric: str,
                packed: bool = False, with_den: bool = True) -> dict:
    """One block into the dual sketches, in place (one slot): y += NUM_b
    @ qc and, on pass 0 (``with_den``), yd += DEN_b @ qc plus the exact
    denominator diagonal. Later passes are power steps of the scaled
    operator and stream the numerator only, plus the scaled column
    mass NUM_b @ (1 / a)."""
    return _dual_step(state, {0: block}, metric, packed, with_den)


def make_dual_update(metric: str, packed: bool = False,
                     with_den: bool = True, plan=None):
    """``(state, block) -> state`` for the dual sketch of ``metric``;
    ``with_den=False`` is the numerator-only update of passes >= 1.
    Under a plan of several slots, each block is split over them."""
    kernels.check_sketchable(metric, "corrected")
    return lambda state, block: _dual_step(
        state, _slot_blocks(plan, block, packed), metric, packed, with_den)


def init_dual_state(n: int, rank: int, seed: int, device=None,
                    plan=None) -> dict:
    """Fresh dual state: zero sketches, the centered probes as both the
    test basis ``q`` and the streamed ``qc``, unit scale.
    Centered on purpose: NUM and DEN both carry a huge near-constant
    rank-1 component that the double centering removes, so the rank
    budget goes to the components B keeps. On the plan's home device
    when a plan is given (JAX's argument), else on ``device``."""
    if plan is not None:
        device = plan.mesh.home
    r = min(rank, n)
    f32 = dict(dtype=torch.float32, device=device)
    qc = center_cols(probes(n, rank, seed)).to(device)
    return {
        "y": torch.zeros((n, r), **f32),
        "yd": torch.zeros((n, r), **f32),
        "d": torch.zeros((n,), **f32),
        "q": qc,
        "qc": qc,
        "scale": torch.ones((n,), **f32),
        "cm": torch.zeros((n,), **f32),
    }


@ieee_f32()
def dual_scale(state: dict, plan=None):
    """``(a, defect)`` from the completed pass-0 state: the rank-1 factor
    ``a = sqrt(diag(DEN))`` (floored at 1e-3 of its mean, so an empty
    denominator scales finitely) and the probe-space estimate of how far
    DEN is from ``a a^T``, over the exact trace mass ``sum(d)``.
    ``plan`` is the JAX signature's and is not read: the state is
    replicated under every plan, so this reads no slot."""
    d, yd, qc = state["d"], state["yd"], state["qc"]
    a = torch.sqrt(torch.clamp(d, min=0.0))
    a = torch.maximum(a, 1e-3 * torch.clamp(a.mean(), min=1e-30))
    resid = yd - a[:, None] * (a @ qc)[None, :]
    r = qc.shape[1]
    defect = (torch.linalg.norm(resid) / (1.0 * r) ** 0.5) / torch.clamp(
        d.sum(), min=1e-30)
    return a, defect


def dual_apply(state: dict) -> torch.Tensor:
    """The scaled, centered factor ``J diag(1/a) (NUM @ qc)``: B @ q on
    passes >= 1, the starting block of the corrected rung on pass 0."""
    return center_cols(state["y"] / state["scale"][:, None])


def reset_dual_pass(state: dict, q_next: torch.Tensor,
                    plan=None) -> dict:
    """Fresh sketches for the next pass: track ``q_next`` and stream
    against ``q_next / a`` (the inner half of B's matvec). ``d`` is
    carried (passes >= 1 never touch it); ``cm`` restarts. The state
    stays where it is (the plan's home device); ``plan`` is the JAX
    signature's and is not read, the state being replicated."""
    q_next = q_next.to(state["y"].device)
    return {
        "y": torch.zeros_like(state["y"]),
        "yd": torch.zeros_like(state["yd"]),
        "d": state["d"],
        "q": q_next,
        "qc": q_next / state["scale"][:, None],
        "scale": state["scale"],
        "cm": torch.zeros_like(state["cm"]),
    }


def factor_centering(state: dict) -> tuple[np.ndarray, float]:
    """A completed factor pass -> (colmean, grand) of S = A A^T from the
    streamed column mass ``cm = S @ 1``, in f64 on the host."""
    cm = state["cm"].detach().cpu().numpy().astype(np.float64)
    n = cm.shape[0]
    return (cm / n).astype(np.float32), float(cm.sum() / (n * n))


def dual_centering(state: dict) -> tuple[np.ndarray, float, float]:
    """A completed dual pass -> (colmean, grand, scale_floor) of the
    scaled similarity NUM_ij / (a_i a_j), from ``cm = NUM @ (1/a)``;
    ``scale_floor`` re-derives :func:`dual_scale`'s floor from ``d``."""
    host = {k: state[k].detach().cpu().numpy().astype(np.float64)
            for k in ("cm", "scale", "d")}
    n = host["cm"].shape[0]
    u = host["cm"] / host["scale"]
    a_raw = np.sqrt(np.maximum(host["d"], 0.0))
    floor = 1e-3 * max(float(a_raw.mean()), 1e-30)
    return (u / n).astype(np.float32), float(u.sum() / (n * n)), floor


def state_bytes(n: int, rank: int) -> int:
    """Factor-solver state residency: the y and qc leaves plus the (N,)
    column mass (the scalars are noise)."""
    r = min(rank, n)
    return (2 * n * r + n) * 4


def dual_state_bytes(n: int, rank: int) -> int:
    """Dual-solver state residency: four (N, r) leaves plus the (N,)
    diagonal, scale and column mass."""
    r = min(rank, n)
    return (4 * n * r + 3 * n) * 4


def nxn_bytes(n: int, metric: str) -> int:
    """What the exact route's accumulators would allocate for this
    cohort: one int32 (N, N) leaf per count product, one f32 for grm."""
    kern = kernels.get(metric)
    n_acc = len(kern.pieces) if kern.family == "count" else 1
    return 4 * n * n * max(n_acc, 1)


def flops_per_block(n: int, v: int, rank: int) -> float:
    """The two skinny products of one factor-sketch block update."""
    return 4.0 * n * v * min(rank, n)


def dual_flops_per_block(n: int, v: int, rank: int, metric: str,
                         with_den: bool = True) -> float:
    """One dual-sketch block update: a (v, r) probe product per distinct
    right operand plus an (N, v) x (v, r) product per streamed term."""
    spec = kernels.get(metric).sketch
    terms = spec.num_terms + (spec.den_terms if with_den else ())
    n_rights = len({r for (_l, r, _w) in terms})
    return 2.0 * n * v * min(rank, n) * (n_rights + len(terms))
