"""Packed columnar genotype store: a directory holding a memmappable
genotype matrix and a JSON sidecar of sample ids and positions.

Two on-disk layouts, the JAX package's own, so a store written by either
package reads in the other byte for byte:

- ``bits=2`` (default): ``genotypes.2bit.npy``, (N, ceil(V/4)) uint8,
  four dosages per byte (ingest/bitpack.py). The feed streams these
  bytes as they are (``packed_views``, ``packed_blocks``) and the gram
  update decodes on the device.
- ``bits=8``: ``genotypes.npy``, (N, V) int8 dosages.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from spark_examples_tpu_torch.core.dtypes import GENOTYPE_DTYPE
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest.source import ArraySource, BlockMeta

# Sidecar schema version (the JAX package's): load_packed refuses a
# sidecar it cannot interpret with a PackedFormatError naming the cause.
PACKED_SCHEMA_VERSION = 2

_REQUIRED_META = ("n_samples", "n_variants", "bits")


class PackedFormatError(ValueError):
    """A packed store that cannot be safely interpreted: missing or
    truncated meta.json, a pre-versioning store, a store from a newer
    build, a missing required field, or a missing or unreadable
    genotype file — always with the cause named."""


def _write_sidecar(
    path: str,
    n_samples: int,
    n_variants: int,
    bits: int,
    sample_ids: list[str] | None,
    contig: str | None,
    positions: np.ndarray | None,
    contig_runs: list[tuple[str | None, int]] | None = None,
) -> None:
    """The store's meta.json + positions.npy, shared by both writers.

    ``contig_runs``: [(name, start_index), ...] for multi-chromosome
    cohorts — run i spans [start_i, start_{i+1}).
    """
    meta = {
        "schema_version": PACKED_SCHEMA_VERSION,
        "n_samples": int(n_samples),
        "n_variants": int(n_variants),
        "bits": bits,
        "sample_ids": sample_ids,
        "contig": contig,
    }
    if contig_runs is not None:
        meta["contig_runs"] = [[c, int(s)] for c, s in contig_runs]
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if positions is not None:
        np.save(os.path.join(path, "positions.npy"),
                np.asarray(positions, np.int64))


def save_packed(
    path: str,
    genotypes: np.ndarray,
    sample_ids: list[str] | None = None,
    contig: str | None = None,
    positions: np.ndarray | None = None,
    bits: int = 2,
) -> None:
    if bits not in (2, 8):
        raise ValueError(f"bits must be 2 or 8, got {bits}")
    os.makedirs(path, exist_ok=True)
    if bits == 2:
        np.save(os.path.join(path, "genotypes.2bit.npy"),
                bitpack.pack_dosages(np.asarray(genotypes)))
    else:
        np.save(os.path.join(path, "genotypes.npy"),
                np.ascontiguousarray(genotypes, dtype=GENOTYPE_DTYPE))
    _write_sidecar(path, genotypes.shape[0], genotypes.shape[1], bits,
                   sample_ids, contig, positions)


@dataclass
class Packed2BitSource:
    """2-bit columnar store as a GenotypeSource: ``blocks()`` unpacks on
    the host; ``packed_views()`` and ``packed_blocks()`` yield the stored
    bytes for the packed transport (ingest/prefetch.stream_to_device(
    pack=True)), as views and as copies."""

    packed: np.ndarray  # (N, ceil(V/4)) uint8, possibly memmapped
    v: int  # true variant count (last byte may hold pad codes)
    ids: list[str] | None = None
    contig: str | None = None
    positions: np.ndarray | None = None
    # Multi-chromosome stores: [(name, start_index), ...] — run i spans
    # [start_i, start_{i+1}). None = single-contig store (``contig``).
    contig_runs: list | None = None

    @property
    def n_samples(self) -> int:
        return int(self.packed.shape[0])

    @property
    def n_variants(self) -> int:
        return self.v

    @property
    def sample_ids(self) -> list[str]:
        if self.ids is not None:
            return self.ids
        return [f"S{i:06d}" for i in range(self.n_samples)]

    @property
    def exact_n_variants(self) -> bool:
        """Single-run stores stream exactly ceil(v/bv) blocks on both
        transports; a multi-contig store's dense blocks flush at each
        chromosome run, so it declines."""
        return self.contig_runs is None or len(self.contig_runs) <= 1

    def _contig_of(self, lo: int, hi: int) -> str | None:
        """Contig of the variant range [lo, hi) — None when the range
        spans a run boundary (multi-contig stores pack continuously, so
        a byte-aligned packed block can straddle chromosomes)."""
        if self.contig_runs is None:
            return self.contig
        name = None
        for c, s in self.contig_runs:
            if s <= lo:
                name = c
            elif s < hi:
                return None  # a later run starts inside the range
        return name

    def _bounds(self) -> list[int]:
        """Segment boundaries dense blocks must not cross."""
        if not self.contig_runs:
            return [0, self.v]
        starts = [int(s) for _, s in self.contig_runs]
        return starts + [self.v]

    def packed_views(self, block_variants: int, start_variant: int = 0):
        """Yield ((N, <=block_variants/4) uint8, meta, True): each block's
        stored bytes as a view of ``packed``, with no copy (the third
        item says so); the feed gathers it into its staging slab, the
        block's one host copy. Requires ``block_variants`` divisible by
        4 so blocks fall on byte boundaries (``blocks()`` has no such
        restriction). The fixed byte grid can straddle chromosome runs;
        such blocks carry ``contig=None`` (positions stay exact)."""
        if block_variants % bitpack.VARIANTS_PER_BYTE:
            raise ValueError(
                f"packed_blocks needs block_variants divisible by "
                f"{bitpack.VARIANTS_PER_BYTE}, got {block_variants}"
            )
        bw = block_variants // bitpack.VARIANTS_PER_BYTE
        total_w = self.packed.shape[1]
        first = -(-start_variant // block_variants)
        for idx in range(first, -(-self.v // block_variants)):
            lo_b, hi_b = idx * bw, min((idx + 1) * bw, total_w)
            lo, hi = idx * block_variants, min(
                (idx + 1) * block_variants, self.v
            )
            pos = None
            if self.positions is not None:
                pos = self.positions[lo:hi]
            yield self.packed[:, lo_b:hi_b], BlockMeta(
                idx, lo, hi, self._contig_of(lo, hi), pos), True

    def packed_blocks(self, block_variants: int, start_variant: int = 0):
        """Yield ((N, <=block_variants/4) uint8, meta): the stored bytes,
        not unpacked, each block a contiguous copy the caller owns
        (:meth:`packed_views` without the views)."""
        for view, meta, _ in self.packed_views(block_variants,
                                               start_variant):
            yield np.ascontiguousarray(view), meta

    def blocks(self, block_variants: int, start_variant: int = 0):
        """Dense int8 blocks: unpack the covering byte range and slice
        off the sub-byte offset. Blocks never span a chromosome run (as
        for VCF and PLINK), so ``meta.contig`` is exact; blocks starting
        before ``start_variant`` are skipped."""
        vpb = bitpack.VARIANTS_PER_BYTE
        bounds = self._bounds()
        idx = 0
        for s in range(len(bounds) - 1):
            for lo in range(bounds[s], bounds[s + 1], block_variants):
                hi = min(lo + block_variants, bounds[s + 1])
                if lo < start_variant:
                    idx += 1
                    continue
                dense = bitpack.unpack_dosages_np(
                    self.packed[:, lo // vpb : -(-hi // vpb)]
                )
                block = dense[:, lo % vpb : lo % vpb + (hi - lo)]
                pos = None
                if self.positions is not None:
                    pos = self.positions[lo:hi]
                yield block, BlockMeta(idx, lo, hi,
                                       self._contig_of(lo, hi), pos)
                idx += 1


def pack_source(
    path: str,
    source,
    block_variants: int = 16384,
) -> int:
    """Stream any GenotypeSource into a 2-bit store in one pass (the
    ``pack`` command): parse once, then every later job streams the
    packed bytes.

    The (N, ceil(V/4)) uint8 matrix is preallocated as a memmapped .npy
    (variant count comes from the source) and filled block-by-block at
    byte offsets, so the cohort never materializes dense in host RAM.
    Returns the number of variants written.
    """
    vpb = bitpack.VARIANTS_PER_BYTE
    n, v = source.n_samples, source.n_variants
    os.makedirs(path, exist_ok=True)
    out = np.lib.format.open_memmap(
        os.path.join(path, "genotypes.2bit.npy"), mode="w+",
        dtype=np.uint8, shape=(n, bitpack.packed_width(v)),
    )
    positions = np.full(v, -1, np.int64)
    runs: list[tuple[str | None, int]] = []  # (contig, start) per run
    written = 0  # variants consumed from the stream
    flushed = 0  # variants whose bytes have landed (always % 4 == 0)
    carry = np.empty((n, 0), np.int8)  # sub-byte tail awaiting alignment

    def flush(cols: np.ndarray, final: bool = False) -> np.ndarray:
        """Write the byte-aligned prefix of ``cols``; return the rest.
        Contig-flush blocks make arbitrary widths — a sub-byte tail must
        wait for the next block (packing it early would misalign every
        later variant by the pad codes)."""
        nonlocal flushed
        aligned = cols.shape[1] if final else cols.shape[1] // vpb * vpb
        if aligned:
            pb = bitpack.pack_dosages(np.ascontiguousarray(
                cols[:, :aligned]
            ))
            out[:, flushed // vpb : flushed // vpb + pb.shape[1]] = pb
            flushed += aligned
        return cols[:, aligned:]

    for block, meta in source.blocks(block_variants):
        if meta.start != written:
            raise ValueError(
                f"non-contiguous block stream: expected start {written}, "
                f"got {meta.start}"
            )
        if meta.positions is not None:
            positions[meta.start : meta.stop] = meta.positions
        if not runs or runs[-1][0] != meta.contig:
            runs.append((meta.contig, meta.start))
        written = meta.stop
        carry = flush(
            np.concatenate([carry, block], axis=1) if carry.size else block
        )
    flush(carry, final=True)
    if written != v:
        raise ValueError(
            f"source stream ended at {written} of {v} declared variants"
        )
    out.flush()
    single = runs[0][0] if len(runs) == 1 else None
    _write_sidecar(
        path, n, v, 2, source.sample_ids,
        contig=single,
        positions=positions if (positions >= 0).all() else None,
        contig_runs=runs if len(runs) > 1 else None,
    )
    return written


def _load_meta(path: str) -> dict:
    """The sidecar, validated: every way a bad store directory can fail
    raises :class:`PackedFormatError` naming the cause."""
    meta_path = os.path.join(path, "meta.json")
    noun, repair = "packed-store sidecar", "re-pack the store"
    try:
        with open(meta_path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        raise PackedFormatError(
            f"{path!r} is not a packed store: no meta.json (create one "
            "with the `pack` command or save_packed)"
        ) from None
    except (OSError, ValueError) as e:
        raise PackedFormatError(
            f"{noun} {meta_path!r} is unreadable ({e}) — truncated or "
            f"corrupt? {repair}"
        ) from None
    if "schema_version" not in raw:
        raise PackedFormatError(
            f"{noun} {meta_path!r} has no 'schema_version' field — written "
            f"by a pre-versioning build; {repair} to upgrade"
        )
    version = int(raw["schema_version"])
    raw["schema_version"] = version
    if version > PACKED_SCHEMA_VERSION:
        raise PackedFormatError(
            f"{noun} {meta_path!r} has schema_version {version}, newer than "
            f"this build's {PACKED_SCHEMA_VERSION} — upgrade the code or "
            f"{repair} with this version"
        )
    missing = [k for k in _REQUIRED_META if k not in raw]
    if missing:
        raise PackedFormatError(
            f"{noun} {meta_path!r} (schema_version {version}) is missing "
            f"required field(s) {missing} — truncated or hand-edited? "
            f"{repair}"
        )
    return raw


def load_packed(path: str, mmap: bool = True):
    meta = _load_meta(path)
    positions = None
    pos_path = os.path.join(path, "positions.npy")
    if os.path.exists(pos_path):
        positions = np.load(pos_path)
    mode = "r" if mmap else None
    bits = meta["bits"]
    fname = "genotypes.2bit.npy" if bits == 2 else "genotypes.npy"
    try:
        g = np.load(os.path.join(path, fname), mmap_mode=mode)
    except FileNotFoundError:
        raise PackedFormatError(
            f"packed store {path!r}: sidecar says bits={bits} but "
            f"{fname} is missing — interrupted pack? re-pack the store"
        ) from None
    except ValueError as e:
        raise PackedFormatError(
            f"packed store {path!r}: {fname} is not a readable .npy "
            f"({e}) — truncated or corrupt? re-pack the store"
        ) from None
    if bits == 2:
        runs = meta.get("contig_runs")
        return Packed2BitSource(
            packed=g,
            v=meta["n_variants"],
            ids=meta.get("sample_ids"),
            contig=meta.get("contig"),
            positions=positions,
            contig_runs=[(c, int(s)) for c, s in runs] if runs else None,
        )
    return ArraySource(
        genotypes=g,
        ids=meta.get("sample_ids"),
        contig=meta.get("contig"),
        positions=positions,
    )
