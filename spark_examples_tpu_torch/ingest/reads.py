"""Reads tier: aligned reads streamed per genomic range for the
coverage example (:mod:`spark_examples_tpu_torch.pipelines.coverage`).

A ``Read`` record and two sources of (starts, lengths) batches: seeded
synthetic reads and a minimal SAM reader. Host-only NumPy, a copy of
the JAX package's ``ingest/reads.py``, so both packages stream the same
reads for the same seed and file.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np

from spark_examples_tpu_torch.core.config import ReferenceRange


@dataclass(frozen=True)
class Read:
    """Serializable mirror of an aligned read (reference: the ``Read``
    case class, SURVEY.md §2.1 'Serializable data model')."""

    name: str
    contig: str
    start: int  # 0-based alignment start
    length: int  # aligned span on the reference
    mapq: int = 60

    @property
    def end(self) -> int:
        return self.start + self.length


class ReadsSource:
    """Protocol: stream (starts, lengths) int64 array batches per range."""

    def ranges(self) -> Sequence[ReferenceRange]: ...

    def read_batches(
        self, ref: ReferenceRange, batch: int = 65536
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]: ...


@dataclass
class SyntheticReadsSource(ReadsSource):
    """Seeded synthetic aligned reads over given ranges: uniform starts,
    fixed-ish lengths — enough to validate coverage math at any scale."""

    references: Sequence[ReferenceRange]
    reads_per_range: int = 100_000
    read_length: int = 150
    length_jitter: int = 10
    seed: int = 0

    def ranges(self) -> Sequence[ReferenceRange]:
        return list(self.references)

    def read_batches(self, ref: ReferenceRange, batch: int = 65536):
        # Two independent streams so the generated reads are identical
        # regardless of the caller's batch size (prefix-stable draws).
        # zlib.crc32, not hash(): str hashes are salted per process and
        # would break cross-run reproducibility of --seed.
        contig_key = zlib.crc32(ref.contig.encode()) & 0xFFFF
        key = [self.seed, contig_key, ref.start]
        rng_s = np.random.default_rng(np.random.SeedSequence(key + [1]))
        rng_l = np.random.default_rng(np.random.SeedSequence(key + [2]))
        remaining = self.reads_per_range
        while remaining > 0:
            m = min(batch, remaining)
            starts = rng_s.integers(
                ref.start, max(ref.end - 1, ref.start + 1), m
            )
            lengths = self.read_length + rng_l.integers(
                -self.length_jitter, self.length_jitter + 1, m
            )
            yield starts.astype(np.int64), np.maximum(lengths, 1).astype(np.int64)
            remaining -= m


@dataclass
class SamSource(ReadsSource):
    """Minimal SAM text reader (dependency-free): name, contig, 1-based
    pos, and CIGAR-less length from the SEQ field. Good enough for the
    coverage example tier; BAM needs htslib and is out of scope."""

    path: str
    references: Sequence[ReferenceRange] = field(default_factory=list)

    def ranges(self) -> Sequence[ReferenceRange]:
        if self.references:
            return list(self.references)
        # default: one open-ended range per contig seen in the header
        contigs = []
        with open(self.path) as f:
            for line in f:
                if line.startswith("@SQ"):
                    fields = dict(
                        kv.split(":", 1) for kv in line.rstrip().split("\t")[1:]
                    )
                    contigs.append(
                        ReferenceRange(fields["SN"], 0, int(fields["LN"]))
                    )
                elif not line.startswith("@"):
                    break
        return contigs

    _by_contig: dict | None = field(default=None, repr=False)

    def _load(self) -> dict:
        """Single-pass parse, bucketed per contig — avoids re-reading the
        file once per queried range."""
        if self._by_contig is None:
            buckets: dict[str, tuple[list[int], list[int]]] = {}
            with open(self.path) as f:
                for line in f:
                    if line.startswith("@"):
                        continue
                    fields = line.rstrip("\n").split("\t")
                    contig, pos, seq = fields[2], int(fields[3]) - 1, fields[9]
                    s, l = buckets.setdefault(contig, ([], []))
                    s.append(pos)
                    l.append(len(seq))
            self._by_contig = {
                c: (np.asarray(s, np.int64), np.asarray(l, np.int64))
                for c, (s, l) in buckets.items()
            }
        return self._by_contig

    def read_batches(self, ref: ReferenceRange, batch: int = 65536):
        data = self._load().get(ref.contig)
        if data is None:
            return
        starts, lengths = data
        keep = (starts >= ref.start) & (starts < ref.end)
        starts, lengths = starts[keep], lengths[keep]
        for i in range(0, len(starts), batch):
            yield starts[i : i + batch], lengths[i : i + batch]
