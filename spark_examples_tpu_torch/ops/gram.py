"""Streaming gram accumulation.

Count kernels: each block's raw int32 products are added into resident
(N, N) int32 accumulators, one per product, under the JAX package's leaf
names (``cc yc t1t1 t2t2`` for ibs); the combination algebra runs once,
in :func:`combine`. Float kernels (grm) keep their own f32 leaves and
update: VanRaden standardized dosages ``z`` (allele frequency estimated
within the block, missing calls contributing zero), ``zz += z z^T``
(each block's product an f32 value, see :func:`f32_xxt`), and the count
of usable variants in the scalar ``nvar``.

The update functions add into the accumulators **in place** (``add_``),
the counterpart of the JAX package's jit buffer donation: the caller's
dict is updated and returned, and no second (N, N) set is allocated.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.ingest.bitpack import unpack_dosages
from spark_examples_tpu_torch.ops import genotype, packed_gram

# Float-family leaves the JAX package's state carries, by name.
_FLOAT_LEAVES = {"zz": 2, "nvar": 0}


def flops_per_block(n: int, v: int, metric: str) -> float:
    """Contraction operations one block contributes; ``v`` is the true
    streamed variant span, not the padded width."""
    return kernels.get(metric).flops(n, v)


def _check_metric(metric: str) -> kernels.Kernel:
    kern = kernels.get(metric)
    if kern.family not in ("count", "float"):
        raise ValueError(
            f"metric {metric!r} is a {kern.family}-family kernel, not a "
            f"gram metric; gram metrics: {' | '.join(kernels.gram_names())}"
        )
    return kern


def acc_leaves(metric: str) -> tuple[str, ...]:
    """Accumulator leaf names for a gram metric: the checkpoint schema,
    the JAX package's ``ops/gram.py::acc_leaves``."""
    kern = _check_metric(metric)
    if kern.family == "float":
        return tuple(_FLOAT_LEAVES)
    return kern.pieces


def scalar_leaves(metric: str) -> tuple[str, ...]:
    """The 0-d leaves (grm's ``nvar``): replicated under every plan."""
    if _check_metric(metric).family == "float":
        return tuple(k for k, nd in _FLOAT_LEAVES.items() if nd == 0)
    return ()


def init(n: int, metric: str, device) -> dict[str, torch.Tensor]:
    """Fresh zero accumulators for ``metric`` on ``device``: int32 (N, N)
    per product for count kernels, the kernel's own for float ones."""
    kern = _check_metric(metric)
    if kern.family == "float":
        return kern.init(n, device)
    return {k: torch.zeros((n, n), dtype=torch.int32, device=device)
            for k in kern.pieces}


def from_jax_state(acc: dict[str, np.ndarray], device
                   ) -> dict[str, torch.Tensor]:
    """The JAX package's accumulators (as numpy) -> this package's, so
    both sides can finalize and solve the same state: int32 (N, N)
    products, or grm's f32 (N, N) ``zz`` and 0-d ``nvar``."""
    out = {}
    for k, v in acc.items():
        a = np.asarray(v)
        if k in _FLOAT_LEAVES:
            ok = a.dtype == np.float32 and a.ndim == _FLOAT_LEAVES[k]
            want = f"a {_FLOAT_LEAVES[k]}-d float32 array"
        else:
            ok = a.dtype == np.int32 and a.ndim == 2
            want = "an (N, N) int32 array"
        if not ok:
            raise ValueError(
                f"accumulator {k!r}: expected {want}, got {a.dtype} "
                f"{a.shape}"
            )
        out[k] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def f32_xxt(z: torch.Tensor, zc: torch.Tensor | None = None
            ) -> torch.Tensor:
    """``z @ zc^T`` (``zc`` defaults to ``z``) of f32 (or bf16) values
    as f32: accumulated in float64 and rounded once. No TF32 setting of
    the process can round the operands to 10 mantissa bits this way, and
    no process-wide flag is touched; the H100 runs float64 matmuls at its
    non-tensor f32 rate."""
    z64 = z.to(torch.float64)
    zc64 = z64 if zc is None else zc.to(torch.float64)
    return torch.matmul(z64, zc64.T).to(torch.float32)


def grm_init(n: int, device) -> dict[str, torch.Tensor]:
    return {"zz": torch.zeros((n, n), dtype=torch.float32, device=device),
            "nvar": torch.zeros((), dtype=torch.float32, device=device)}


def grm_standardize(block: torch.Tensor, precise: bool = False):
    """VanRaden standardization of one int8 dosage block: ``(z, keep)``.

    Per-variant allele frequency ``p`` over the block's called genotypes;
    dosages centered by 2p and scaled by 1/sqrt(2p(1-p)); missing calls
    give 0; ``keep`` marks variants with a usable frequency (more than
    one call, 2p(1-p) > 1e-8), whose count feeds the denominator. ``z``
    is bf16, or f32 when ``precise``.
    """
    p, cnt, y, valid = genotype.af_stats(block)
    denom = 2.0 * p * (1.0 - p)
    keep = (denom > 1e-8) & (cnt > 1)
    scale = torch.where(keep, torch.rsqrt(torch.clamp(denom, min=1e-8)),
                        0.0)
    dt = torch.float32 if precise else torch.bfloat16
    z = torch.where(valid, (y - 2.0 * p) * scale, 0.0).to(dt)
    return z, keep


def grm_update(acc: dict, block: torch.Tensor, precise: bool = False
               ) -> dict:
    """Add one dense block's ``z z^T`` and kept-variant count to ``acc``.
    bf16 ``z`` is widened exactly before the product, so each block's
    contribution is an f32 value, not rounded to bf16 (the JAX package's
    bf16 ``dot_general`` has an f32 result too)."""
    z, keep = grm_standardize(block, precise)
    acc["zz"].add_(f32_xxt(z))
    acc["nvar"].add_(keep.sum())
    return acc


def grm_tile_update(acc: dict, block: torch.Tensor, rows: slice,
                    cols: slice, precise: bool = False,
                    scalars: bool = True) -> dict:
    """grm under a tile2d plan: the standardization statistics come from
    the whole chunk (all N rows of its variants), then only the tile's
    rows and columns are contracted into ``acc["zz"]``; ``nvar`` grows
    only where ``scalars`` (one slot owns the replicated scalar)."""
    z, keep = grm_standardize(block, precise)
    acc["zz"].add_(f32_xxt(z[rows], z[cols]))
    if scalars:
        acc["nvar"].add_(keep.sum())
    return acc


def update(acc: dict, block: torch.Tensor, metric: str,
           precise: bool = False) -> dict:
    """Add one (N, v_blk) int8 block's contribution to ``acc``: the count
    products through the int8 library product on CUDA
    (:func:`genotype.int_mm`) and the plain float64 one elsewhere, or the
    float kernel's own update (``precise`` reaches grm)."""
    kern = _check_metric(metric)
    if kern.family == "float":
        return kern.update(acc, block, precise)
    dot = genotype.int_mm if block.is_cuda else genotype.int_dot
    g = genotype.gram_products(block, kern.pieces, dot=dot)
    for k in kern.pieces:
        acc[k].add_(g[k])
    return acc


def update_packed(acc: dict, packed: torch.Tensor, metric: str,
                  precise: bool = False) -> dict:
    """The same contribution from a 2-bit packed (N, v_blk/4) uint8 block
    on the reference lowering: unpack, then :func:`update`."""
    return update(acc, unpack_dosages(packed), metric, precise)


def update_fused(acc: dict, packed: torch.Tensor, metric: str) -> dict:
    """Fused-lowering twin of :func:`update_packed`: the packed-gram
    kernel contracts the 2-bit bytes directly (ops/packed_gram.py) —
    bit-identical int32 accumulators."""
    pieces = kernels.get(metric).pieces
    prods = packed_gram.fused_tile_products(packed, packed, pieces)
    for k in pieces:
        acc[k].add_(prods[k])
    return acc


def resolve_gram_lowering(requested: str, packed: bool,
                          device: torch.device, metric: str = "ibs") -> str:
    """Resolve ``--gram-lowering`` to the lowering actually run.

    ``auto`` is the CUDA kernel when the device is CUDA, the stream is
    packed and the kernel serves ``metric``, else ``reference``. An
    explicit ``fused`` raises, naming the flag, where the kernel cannot
    run: a metric it does not serve, a dense stream, or the CPU (there is
    no CUDA kernel to launch there).
    """
    device = torch.device(device)
    if requested == "fused":
        kernels.check_fused_lowering(metric, packed)
        if device.type != "cuda":
            raise ValueError(
                "--gram-lowering fused launches the packed-gram CUDA "
                f"kernel, but the job runs on {device} — use --device "
                "cuda, or --gram-lowering auto|reference"
            )
        return "fused"
    if requested == "auto":
        fusable = packed and kernels.get(metric).fused
        return "fused" if device.type == "cuda" and fusable else "reference"
    if requested == "reference":
        return "reference"
    raise ValueError(f"unknown gram lowering {requested!r}")


def impl_for(metric: str, packed: bool, grm_precise: bool = False,
             lowering: str = "reference"):
    """The one dispatch point: ``(acc, block) -> acc`` for a metric /
    transport / RESOLVED lowering. ``grm_precise`` reaches the float
    family only; float kernels have no fused lowering."""
    kern = _check_metric(metric)
    if lowering == "fused" and kern.family != "float":
        kernels.check_fused_lowering(metric, packed)
        return lambda acc, block: update_fused(acc, block, metric)
    step = update_packed if packed else update
    return lambda acc, block: step(acc, block, metric, grm_precise)


def combine(acc: dict, metric: str, t=None) -> dict[str, torch.Tensor]:
    """Accumulated raw products -> the named statistics ``finalize``
    consumes (integer-exact; runs once per job). Float-family
    accumulators are already statistics and pass through. ``t``: the
    products' transposes (``genotype.combine_products``)."""
    kern = _check_metric(metric)
    if kern.family == "float":
        return acc
    return genotype.combine_products(acc, kern.stats, t)
