"""GenotypeSource: anything that yields dense int8 dosage blocks over a
fixed sample cohort, streamed along the variant axis."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Protocol, runtime_checkable

import numpy as np


@dataclass(frozen=True)
class BlockMeta:
    """Metadata for one streamed genotype block."""

    index: int  # block ordinal in the stream
    start: int  # first variant (global index, inclusive)
    stop: int  # past-the-end variant (global index)
    contig: str | None = None
    positions: np.ndarray | None = None  # (v_blk,) int64, optional


@runtime_checkable
class GenotypeSource(Protocol):
    """The ingest contract: sample axis fixed, variant axis streamed."""

    @property
    def n_samples(self) -> int: ...

    @property
    def n_variants(self) -> int: ...

    @property
    def sample_ids(self) -> list[str]: ...

    def blocks(
        self, block_variants: int, start_variant: int = 0
    ) -> Iterator[tuple[np.ndarray, BlockMeta]]:
        """Yield (int8 (n_samples, <=block_variants) dosage block, meta),
        starting at global variant index ``start_variant``."""
        ...
