"""Streaming VCF ingest (plain or gzip).

A dependency-free text parser: the header gives the sample ids; records
stream in file order and are stacked column by column into (N, v_blk)
int8 dosage blocks. Any non-reference allele counts toward the dosage
(multi-allelic sites collapse to alt-carrier dosage), a half-call counts
its called allele, and ``.`` genotypes are missing. ``--references
chr:start:end`` keeps only the records inside one of the ranges.

The per-sample GT parse, the loop that runs N times per record, is one
GIL-released native call (``native/codec.cpp::vcf_parse_gt``) when the
library is available; its fallback is pure Python with a cache keyed by
the GT string (a cohort has few distinct GT strings), byte-identical.
"""

from __future__ import annotations

import gzip
import warnings
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np

from spark_examples_tpu_torch import native
from spark_examples_tpu_torch.ingest.source import BlockMeta


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _open_bytes(path: str):
    """Binary record stream: the parse stays on bytes, decoding only the
    fields it reads."""
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _dosage(gt: str) -> int:
    """GT string -> dosage in {-1, 0, 1, 2}."""
    alleles = gt.replace("|", "/").split("/")
    dose = 0
    seen = False
    for a in alleles:
        if a == "." or a == "":
            continue
        seen = True
        if a != "0":
            dose += 1
    if not seen:
        return -1
    return min(dose, 2)


def parse_record_lines(lines, n_samples: int, in_range, path: str,
                       ) -> Iterator[tuple[str, int, np.ndarray]]:
    """Yield ``(contig, pos, int8 dosage column)`` from raw VCF record
    lines (bytes). Header lines, lines with fewer than 10 columns and
    records without a GT subfield are skipped; a record with fewer than
    ``n_samples`` sample columns is skipped with one warning per stream.
    CRLF line ends are stripped; a sample column too short to hold the
    GT subfield reads as missing."""
    n = n_samples
    gt_cache: dict[bytes, int] = {}
    short_records = 0
    use_native = native.load() is not None
    for line in lines:
        if line.startswith(b"#"):
            continue
        line = line.rstrip(b"\r\n")
        prefix = line.split(b"\t", 9)
        if len(prefix) < 10:
            continue
        contig, pos = prefix[0].decode(), int(prefix[1])
        if not in_range(contig, pos):
            continue
        fmt = prefix[8].split(b":")
        try:
            gt_idx = fmt.index(b"GT")
        except ValueError:
            continue  # no genotypes at this site
        if use_native:
            col = np.empty(n, dtype=np.int8)
            if native.vcf_parse_gt(line, gt_idx, n, col):
                yield contig, pos, col
                continue
        gts = prefix[9].split(b"\t")
        if len(gts) < n:
            # A truncated or malformed record: computing on reduced data
            # without a word would look like a clean job.
            short_records += 1
            if short_records == 1:
                warnings.warn(
                    f"{path}: record at {contig}:{pos} has "
                    f"{len(gts)} sample columns, expected {n} — "
                    "skipping record(s); the file may be "
                    "truncated or malformed",
                    RuntimeWarning,
                    stacklevel=3,
                )
            continue
        if b":" not in prefix[9]:
            # One subfield per sample: the column is the GT itself.
            gt_of = gts[:n] if gt_idx == 0 else [b""] * n
        else:
            # VCF permits dropping trailing subfields: no GT -> missing.
            gt_of = [sub[gt_idx] if gt_idx < len(sub) else b""
                     for sub in (g.split(b":") for g in gts[:n])]
        doses = [gt_cache.get(gt) for gt in gt_of]
        if None in doses:
            for gt in set(gt_of).difference(gt_cache):
                gt_cache[gt] = _dosage(gt.decode())
            doses = [gt_cache[gt] for gt in gt_of]
        yield contig, pos, np.array(doses, dtype=np.int8)


@dataclass
class VcfSource:
    path: str
    references: Sequence = ()  # ReferenceRange-like: contig, start, end
    _samples: list[str] | None = field(default=None, repr=False)
    _n_variants: int | None = field(default=None, repr=False)

    def _read_header(self) -> list[str]:
        with _open(self.path) as f:
            for line in f:
                if line.startswith("#CHROM"):
                    return line.rstrip("\r\n").split("\t")[9:]
                if not line.startswith("#"):
                    break
        raise ValueError(f"{self.path}: no #CHROM header line")

    @property
    def sample_ids(self) -> list[str]:
        if self._samples is None:
            self._samples = self._read_header()
        return self._samples

    @property
    def n_samples(self) -> int:
        return len(self.sample_ids)

    @property
    def n_variants(self) -> int:
        """Record count: one cached pre-scan with the yield conditions of
        the parse (range, GT in FORMAT, enough sample columns) but
        without the per-sample GT parse."""
        if self._n_variants is None:
            n = self.n_samples
            count = 0
            with _open_bytes(self.path) as f:
                for line in f:
                    if line.startswith(b"#"):
                        continue
                    line = line.rstrip(b"\r\n")
                    prefix = line.split(b"\t", 9)
                    if len(prefix) < 10:
                        continue
                    if not self._in_range(prefix[0].decode(),
                                          int(prefix[1])):
                        continue
                    if b"GT" not in prefix[8].split(b":"):
                        continue
                    if prefix[9].count(b"\t") + 1 < n:
                        continue  # short record (skipped by the parse)
                    count += 1
            self._n_variants = count
        return self._n_variants

    def _in_range(self, contig: str, pos: int) -> bool:
        if not self.references:
            return True
        for r in self.references:
            if r.contig == contig and r.start <= pos < r.end:
                return True
        return False

    def _records(self) -> Iterator[tuple[str, int, np.ndarray]]:
        with _open_bytes(self.path) as f:
            yield from parse_record_lines(
                f, self.n_samples, self._in_range, self.path
            )

    def blocks(self, block_variants: int, start_variant: int = 0):
        """Stream (N, <=block_variants) blocks. Blocks never span a
        contig boundary (a boundary flushes the partial block), so
        ``BlockMeta.contig`` is exact; ``start_variant`` is a record
        ordinal."""
        cols: list[np.ndarray] = []
        positions: list[int] = []
        cur_contig: str | None = None
        idx = 0
        emitted_start = start_variant
        seen = 0

        def flush():
            nonlocal cols, positions, idx, emitted_start
            block = (
                np.stack(cols, axis=1),
                BlockMeta(
                    idx,
                    emitted_start,
                    emitted_start + len(cols),
                    cur_contig,
                    np.asarray(positions, np.int64),
                ),
            )
            emitted_start += len(cols)
            idx += 1
            cols, positions = [], []
            return block

        for contig, pos, col in self._records():
            if seen < start_variant:
                seen += 1
                continue
            seen += 1
            if cols and (len(cols) == block_variants or contig != cur_contig):
                yield flush()
            cur_contig = contig
            cols.append(col)
            positions.append(pos)
        if cols:
            yield flush()
        # A completed pass has counted every record.
        self._n_variants = seen


def write_vcf(
    path: str,
    genotypes: np.ndarray,
    sample_ids: list[str] | None = None,
    contig: str = "chr22",
    start_pos: int = 16_050_000,
) -> None:
    """Write an (N, V) dosage matrix as a minimal diploid VCF (the
    inverse of :class:`VcfSource`; ``.gz`` paths are gzip-compressed)."""
    g = np.asarray(genotypes)
    n, v = g.shape
    if g.size and (g.min() < -1 or g.max() > 2):
        raise ValueError("write_vcf takes dosages in {-1, 0, 1, 2}")
    ids = sample_ids or [f"S{i:06d}" for i in range(n)]
    gt_of = np.array(["./.", "0/0", "0/1", "1/1"])[g.astype(np.int64) + 1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={contig}>\n")
        f.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(ids)
            + "\n"
        )
        for j in range(v):
            row = "\t".join(gt_of[:, j].tolist())
            f.write(f"{contig}\t{start_pos + j}\trs{j}\tA\tC\t.\tPASS\t.\t"
                    f"GT\t{row}\n")
