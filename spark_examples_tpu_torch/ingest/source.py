"""GenotypeSource: anything that yields dense int8 dosage blocks over a
fixed sample cohort, streamed along the variant axis."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Protocol, Sequence, runtime_checkable

import numpy as np

from spark_examples_tpu_torch.ingest import bitpack


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


def materialize(source, block_variants: int) -> np.ndarray:
    """The source's whole (N, V) int8 table, block by block."""
    return np.concatenate([b for b, _ in source.blocks(block_variants)],
                          axis=1)


def close_source(source) -> None:
    """Stop the background work a source holds (a store's readahead
    pool), through any wrapper that forwards ``close``; a no-op for
    sources that hold none."""
    close = getattr(source, "close", None)
    if close is not None:
        close()


def partition_ranges(references: Sequence, splits_per_contig: int) -> list:
    """Split each genomic range into ``splits_per_contig`` ~equal
    sub-ranges (the reference partitioner's ``FixedContigSplits(n)``):
    the units of concurrent reading (``--splits-per-contig``) and of a
    rank's share under several processes."""
    out = []
    for ref in references:
        span = ref.end - ref.start
        if span <= 0 or splits_per_contig <= 1:
            out.append(ref)
            continue
        step = -(-span // splits_per_contig)
        for s in range(ref.start, ref.end, step):
            out.append(dataclasses.replace(ref, start=s,
                                           end=min(s + step, ref.end)))
    return out


def window_for_process(n_variants: int, block_variants: int,
                       process_index: int,
                       process_count: int) -> tuple[int, int]:
    """Block-aligned contiguous ``[start, stop)`` window for one process:
    ceil(V / bv) blocks in ``process_count`` contiguous runs of at most
    ceil(n_blocks / P) blocks; trailing processes may get an empty
    window (the consensus feeder pads their steps)."""
    n_blocks = -(-n_variants // block_variants)
    per = -(-n_blocks // max(1, process_count))
    start = min(process_index * per * block_variants, n_variants)
    stop = min((process_index + 1) * per * block_variants, n_variants)
    return start, stop


@dataclass
class WindowSource:
    """A source restricted to the contiguous variant window ``[start,
    stop)``: one rank's partition of a random-access source (synthetic,
    the packed and dataset stores). ``start`` lies on the stream's block
    grid; ``stop`` on it or at the end of the inner source. Cursors and
    block ordinals are local to the window. The inner source's packed
    transport and its decode-into-buffer drive are forwarded when it has
    them, so a rank decodes only its own variants."""

    inner: GenotypeSource
    start: int
    stop: int

    def __post_init__(self):
        if not 0 <= self.start <= self.stop <= self.inner.n_variants:
            raise ValueError(
                f"window [{self.start}, {self.stop}) out of range for a "
                f"{self.inner.n_variants}-variant source"
            )
        # The feed dispatches on hasattr: advertise only what the inner
        # source has.
        if hasattr(self.inner, "packed_blocks"):
            self.packed_blocks = self._packed_blocks
        if hasattr(self.inner, "packed_views"):
            self.packed_views = self._packed_views
        if hasattr(self.inner, "decode_range_into") and hasattr(
                self.inner, "block_spans"):
            self.block_spans = self._block_spans
            self.decode_range_into = self._decode_range_into

    @property
    def n_samples(self) -> int:
        return self.inner.n_samples

    @property
    def n_variants(self) -> int:
        return self.stop - self.start

    @property
    def exact_n_variants(self) -> bool:
        # Exact iff the count the window was cut from is (a filtered
        # inner source could under-produce).
        return bool(getattr(self.inner, "exact_n_variants", False))

    @property
    def sample_ids(self) -> list[str]:
        return self.inner.sample_ids

    def _check_aligned(self, block_variants: int) -> None:
        if self.start % block_variants:
            raise ValueError(
                f"window start {self.start} not aligned to block grid "
                f"{block_variants} — inner cursors would ceil-align past "
                "the window's own variants"
            )

    def _relocalize(self, it, packed: bool = False, views: bool = False):
        """The inner stream in the window's coordinates, cut at its end;
        ``views``: items are ``packed_views``' ``(bytes, meta, view)``,
        and a cut block stays a view."""
        idx = 0
        for block, meta, *rest in it:
            if meta.start >= self.stop:
                break
            take = min(meta.stop, self.stop) - meta.start
            # Packed blocks are (N, width / 4) bytes.
            cols = bitpack.packed_width(take) if packed else take
            if cols < block.shape[1]:
                block = block[:, :cols]
                if not views:
                    block = np.ascontiguousarray(block)
            pos = None if packed else meta.positions
            if pos is not None and take < len(pos):
                pos = pos[:take]
            yield (block, dataclasses.replace(
                meta, index=idx, start=meta.start - self.start,
                stop=meta.start - self.start + take, positions=pos), *rest)
            idx += 1

    def blocks(self, block_variants: int, start_variant: int = 0):
        self._check_aligned(block_variants)
        yield from self._relocalize(
            self.inner.blocks(block_variants, self.start + start_variant))

    def _packed_blocks(self, block_variants: int, start_variant: int = 0):
        self._check_aligned(block_variants)
        yield from self._relocalize(
            self.inner.packed_blocks(block_variants,
                                     self.start + start_variant),
            packed=True)

    def _packed_views(self, block_variants: int, start_variant: int = 0):
        self._check_aligned(block_variants)
        yield from self._relocalize(
            self.inner.packed_views(block_variants,
                                    self.start + start_variant),
            packed=True, views=True)

    def _block_spans(self, block_variants: int, start_variant: int = 0):
        """The inner block grid's spans in the window's coordinates,
        truncated at the window's end: the decode-free twin of
        :meth:`blocks` for a feed that drives :meth:`decode_range_into`."""
        self._check_aligned(block_variants)
        idx = 0
        for lo, hi, meta in self.inner.block_spans(
                block_variants, self.start + start_variant):
            if lo >= self.stop:
                break
            hi = min(hi, self.stop)
            pos = meta.positions
            if pos is not None and hi - lo < len(pos):
                pos = pos[:hi - lo]
            yield lo - self.start, hi - self.start, dataclasses.replace(
                meta, index=idx, start=lo - self.start,
                stop=hi - self.start, positions=pos)
            idx += 1

    def _decode_range_into(self, lo: int, hi: int, out, col_off: int = 0):
        # Checked against the window: an over-long span would decode
        # another rank's variants into this one's partial sum.
        if not 0 <= lo <= hi <= self.n_variants:
            raise ValueError(
                f"variant range [{lo}, {hi}) out of bounds for a "
                f"{self.n_variants}-variant window"
            )
        self.inner.decode_range_into(self.start + lo, self.start + hi,
                                     out, col_off)

    def close(self) -> None:
        close_source(self.inner)


@dataclass
class EmptyShare:
    """A zero-variant source that still answers cohort metadata (a
    ``--references`` filter that matched nothing, or a rank whose range
    share came out empty: ``references=[]`` would mean "no filter" and
    read the whole input into that rank's partial sum)."""

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
