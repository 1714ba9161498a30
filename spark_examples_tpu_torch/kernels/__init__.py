"""The count-family kernel registry: one declarative object per metric.

A :class:`Kernel` says which raw int32 products a metric accumulates
(``pieces``), which statistics its finalize reads (``stats``,
``ops.genotype.combine_products`` names), its finalize, and the worst
per-variant accumulator increment feeding the int32 exactness guard.

All six kernels here are 2-bit packable count kernels, so every one of
them streams packed under ``pack_stream="auto"`` and every product set
is served by the packed-gram CUDA kernel (``ops/packed_gram.py``).
Only ``ibs`` has its finalize ported; the others carry their product
tuples so the kernel's parity checks cover every product set the TPU
kernel serves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from spark_examples_tpu_torch.ops import genotype


@dataclass(frozen=True)
class Kernel:
    name: str
    pieces: tuple[str, ...]
    stats: tuple[str, ...]
    max_increment: int
    finalize: Callable | None = None  # stats -> {"similarity", "distance"}

    def flops(self, n: int, v: int) -> float:
        """Matmul operations one (n, v) block contributes: one
        ``2 n^2 v`` contraction per int8-split term of each product."""
        n_matmuls = sum(
            len(genotype._INT8_SPLIT.get(p, (None,))) for p in self.pieces
        )
        return 2.0 * n * n * v * n_matmuls


def _ibs_finalize(stats):
    """PLINK-convention IBS distance ``d1 / (2m)`` over pairwise-complete
    variants; pairs sharing no complete variant get distance 0."""
    m = stats["m"]
    dist = torch.where(m > 0, stats["d1"] / (2.0 * m), 0.0)
    return {"similarity": 1.0 - dist, "distance": dist}


_REGISTRY: dict[str, Kernel] = {}


def _register(kernel: Kernel) -> None:
    _REGISTRY[kernel.name] = kernel


_register(Kernel(
    name="ibs",
    pieces=("cc", "yc", "t1t1", "t2t2"),
    stats=("m", "d1"),
    max_increment=2,  # yc with y <= 2
    finalize=_ibs_finalize,
))
_register(Kernel(
    name="ibs2",
    pieces=("cc", "t1c", "t1t1", "t1t2", "t2t2"),
    stats=("m", "ibs2"),
    max_increment=2,
))
_register(Kernel(
    name="shared-alt",
    pieces=("t1t1",),
    stats=("s",),
    max_increment=1,
))
_register(Kernel(
    name="king",
    pieces=("t1c", "t2c", "t1t1", "t1t2", "t2t2"),
    stats=("hh", "opp", "hc"),
    max_increment=2,
))
_register(Kernel(
    name="jaccard",
    pieces=("t1c", "t1t1"),
    stats=("s", "sc"),
    max_increment=2,
))
_register(Kernel(
    name="pc-invariant",
    pieces=("cc", "t1c", "t2c", "t1t1", "t1t2", "t2t2"),
    stats=("m", "ibs2", "opp"),
    max_increment=2,
))


def get(name: str) -> Kernel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; registered kernels: "
            f"{' | '.join(sorted(_REGISTRY))}"
        ) from None


def names() -> tuple[str, ...]:
    """Every registered kernel name, in registration order."""
    return tuple(_REGISTRY)


def finalizable_names() -> tuple[str, ...]:
    """Kernels whose finalize is ported (the metrics a job can run)."""
    return tuple(k.name for k in _REGISTRY.values() if k.finalize is not None)
