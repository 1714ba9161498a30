"""GenotypeSource: anything that yields dense int8 dosage blocks over a
fixed sample cohort, streamed along the variant axis."""

from __future__ import annotations

import dataclasses
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


def rechunk(items, width: int, start_variant: int = 0):
    """Re-chunk a stream of ``(cols, positions | None, contig)`` pieces
    into steady ``width``-wide ``(block, BlockMeta)`` outputs.

    The shared machinery of the stream transforms that change the
    variant count (QC filtering, LD pruning): buffers pieces, splits off
    full-width heads, flushes partials at contig boundaries (blocks never
    span a contig), and numbers ordinals over the OUTPUT stream.
    ``start_variant`` skips any block starting before it. Positions
    propagate when every contributing piece carries them, else None.
    """
    cols: list[np.ndarray] = []
    pos: list[np.ndarray | None] = []
    cur_contig: str | None = None
    idx = 0
    emitted = 0

    def assemble():
        block = cols[0] if len(cols) == 1 else np.concatenate(cols, axis=1)
        positions = (
            (pos[0] if len(pos) == 1 else np.concatenate(pos))
            if all(p is not None for p in pos) else None
        )
        return block, positions

    def emit(block, positions):
        nonlocal idx, emitted
        meta = BlockMeta(idx, emitted, emitted + block.shape[1],
                         cur_contig, positions)
        emitted += block.shape[1]
        idx += 1
        if meta.start >= start_variant:
            yield np.ascontiguousarray(block), meta

    for piece, p, contig in items:
        if cols and contig != cur_contig:
            yield from emit(*assemble())
            cols, pos = [], []
        cur_contig = contig
        if piece.shape[1] == 0:
            continue
        cols.append(piece)
        pos.append(np.asarray(p) if p is not None else None)
        while sum(c.shape[1] for c in cols) >= width:
            block, positions = assemble()
            head, tail = block[:, :width], block[:, width:]
            hp = tp = None
            if positions is not None:
                hp, tp = positions[:width], positions[width:]
            cols = [np.ascontiguousarray(tail)] if tail.shape[1] else []
            pos = (
                ([tp] if positions is not None else [None])
                if tail.shape[1] else []
            )
            yield from emit(head, hp)
    if cols:
        yield from emit(*assemble())


@dataclass
class ArraySource:
    """An in-memory or memmapped (N, V) int8 matrix as a source: dosage
    blocks, or any raw-value int8 table (negatives missing) for the dense
    euclidean/dot kernels."""

    genotypes: np.ndarray  # (N, V) int8
    ids: list[str] | None = None
    contig: str | None = None
    positions: np.ndarray | None = None

    exact_n_variants = True  # the array's shape is the count

    @property
    def n_samples(self) -> int:
        return int(self.genotypes.shape[0])

    @property
    def n_variants(self) -> int:
        return int(self.genotypes.shape[1])

    @property
    def sample_ids(self) -> list[str]:
        if self.ids is not None:
            return self.ids
        return [f"S{i:06d}" for i in range(self.n_samples)]

    def blocks(self, block_variants: int, start_variant: int = 0):
        v = self.n_variants
        # ceil: a cursor inside a partial final block must not re-emit it.
        first = -(-start_variant // block_variants)
        for idx in range(first, -(-v // block_variants)):
            lo = idx * block_variants
            hi = min(lo + block_variants, v)
            block = np.ascontiguousarray(self.genotypes[:, lo:hi],
                                         dtype=np.int8)
            pos = None
            if self.positions is not None:
                pos = self.positions[lo:hi]
            yield block, BlockMeta(idx, lo, hi, self.contig, pos)


def close_source(source) -> None:
    """Stop the background work a source holds (a store's readahead
    pool), through any wrapper that forwards ``close``; a no-op for
    sources that hold none."""
    close = getattr(source, "close", None)
    if close is not None:
        close()


@dataclass
class EmptyShare:
    """A zero-variant source that still answers cohort metadata (a
    ``--references`` filter that matched nothing)."""

    inner: GenotypeSource

    exact_n_variants = True  # zero, exactly

    @property
    def n_samples(self) -> int:
        return self.inner.n_samples

    @property
    def n_variants(self) -> int:
        return 0

    @property
    def sample_ids(self) -> list[str]:
        return self.inner.sample_ids

    def blocks(self, block_variants: int, start_variant: int = 0):
        return iter(())

    def close(self) -> None:
        close_source(self.inner)


@dataclass
class ChainSource:
    """Sources concatenated along the variant axis (one per reference
    range). Not ``exact_n_variants``: the block grid restarts at every
    part boundary."""

    parts: list

    def __post_init__(self):
        ns = {p.n_samples for p in self.parts}
        if len(ns) != 1:
            raise ValueError(f"sources disagree on n_samples: {ns}")

    @property
    def n_samples(self) -> int:
        return self.parts[0].n_samples

    @property
    def n_variants(self) -> int:
        return sum(p.n_variants for p in self.parts)

    @property
    def sample_ids(self) -> list[str]:
        return self.parts[0].sample_ids

    def blocks(self, block_variants: int, start_variant: int = 0):
        offset = 0
        idx = 0
        for part in self.parts:
            pv = part.n_variants
            if start_variant >= offset + pv:
                offset += pv
                continue
            local_start = max(0, start_variant - offset)
            for block, meta in part.blocks(block_variants, local_start):
                yield block, dataclasses.replace(
                    meta, index=idx, start=meta.start + offset,
                    stop=meta.stop + offset)
                idx += 1
            offset += pv

    def close(self) -> None:
        for part in self.parts:
            close_source(part)
