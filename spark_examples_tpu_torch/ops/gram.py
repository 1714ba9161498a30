"""Streaming gram accumulation: each block's raw int32 products are added
into resident (N, N) int32 accumulators, one per product, under the JAX
package's leaf names (``cc yc t1t1 t2t2`` for ibs). The combination
algebra runs once, in :func:`combine`.

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


def flops_per_block(n: int, v: int, metric: str) -> float:
    """Contraction operations one block contributes; ``v`` is the true
    streamed variant span, not the padded width."""
    return kernels.get(metric).flops(n, v)


def init(n: int, metric: str, device) -> dict[str, torch.Tensor]:
    """Fresh zero int32 accumulators for ``metric`` on ``device``."""
    kern = kernels.get(metric)
    return {k: torch.zeros((n, n), dtype=torch.int32, device=device)
            for k in kern.pieces}


def from_jax_state(acc: dict[str, np.ndarray], device
                   ) -> dict[str, torch.Tensor]:
    """The JAX package's accumulators (as numpy) -> this package's, so
    both sides can finalize and solve the same state."""
    out = {}
    for k, v in acc.items():
        a = np.asarray(v)
        if a.dtype != np.int32 or a.ndim != 2:
            raise ValueError(
                f"accumulator {k!r}: expected an (N, N) int32 array, got "
                f"{a.dtype} {a.shape}"
            )
        out[k] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def update(acc: dict, block: torch.Tensor, metric: str) -> dict:
    """Add one (N, v_blk) int8 dosage block's products to ``acc``."""
    pieces = kernels.get(metric).pieces
    g = genotype.gram_products(block, pieces)
    for k in pieces:
        acc[k].add_(g[k])
    return acc


def update_packed(acc: dict, packed: torch.Tensor, metric: str) -> dict:
    """The same contribution from a 2-bit packed (N, v_blk/4) uint8 block
    on the reference lowering: unpack, then contract."""
    return update(acc, unpack_dosages(packed), metric)


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
                          device: torch.device) -> str:
    """Resolve ``--gram-lowering`` to the lowering actually run.

    ``auto`` is the CUDA kernel when the device is CUDA and the stream is
    packed, else ``reference``. An explicit ``fused`` raises, naming the
    flag, where the kernel cannot run: on the CPU (there is no CUDA kernel
    to launch there) or on a dense stream.
    """
    device = torch.device(device)
    if requested == "fused":
        if device.type != "cuda":
            raise ValueError(
                "--gram-lowering fused launches the packed-gram CUDA "
                f"kernel, but the job runs on {device} — use --device "
                "cuda, or --gram-lowering auto|reference"
            )
        if not packed:
            raise ValueError(
                "--gram-lowering fused consumes the 2-bit packed "
                "transport directly, but the stream is dense — use "
                "pack_stream auto|packed (or --gram-lowering "
                "auto|reference)"
            )
        return "fused"
    if requested == "auto":
        return "fused" if device.type == "cuda" and packed else "reference"
    if requested == "reference":
        return "reference"
    raise ValueError(f"unknown gram lowering {requested!r}")


def impl_for(metric: str, packed: bool, lowering: str = "reference"):
    """The one dispatch point: ``(acc, block) -> acc`` for a metric /
    transport / RESOLVED lowering triple."""
    kernels.get(metric)
    if lowering == "fused":
        if not packed:
            raise ValueError("the fused lowering needs a packed stream")
        return lambda acc, block: update_fused(acc, block, metric)
    if packed:
        return lambda acc, block: update_packed(acc, block, metric)
    return lambda acc, block: update(acc, block, metric)


def combine(acc: dict, metric: str) -> dict[str, torch.Tensor]:
    """Accumulated raw products -> the named statistics ``finalize``
    consumes (integer-exact; runs once per job)."""
    return genotype.combine_products(acc, kernels.get(metric).stats)
