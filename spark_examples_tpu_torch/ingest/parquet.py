"""Parquet variant-table ingest (``--source parquet``): the wide
variant-by-sample table a BigQuery export writes.

- one row per variant;
- optional ``contig`` (string) and ``position`` (int64) columns;
- every other column is one sample's integer dosage ({0, 1, 2}, negative
  or NULL = missing), the column name being the sample id.

Reading is row-group granular, so parquet's own metadata does the heavy
lifting: under ``--references contig:start:end`` the row groups whose
contig/position column statistics cannot overlap any range are skipped
without touching their bytes, and the candidate groups decode their two
metadata columns first; the N sample columns are decoded only when the
range mask keeps a row. Blocks then stream through
:func:`~spark_examples_tpu_torch.ingest.source.rechunk` (steady widths,
flushes at contig changes, resume cursors), as every other file source
does. The JAX package's ``ingest/parquet.py`` is the spec.

pyarrow is the only reader dependency. Its import is deferred and
failure-gated, so an environment without it loses only this source,
with an ``ImportError`` that says what to do.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from spark_examples_tpu_torch.ingest.source import rechunk

_META_COLUMNS = ("contig", "position")


def _pyarrow():
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "the parquet source needs pyarrow, which is not installed "
            "in this environment — re-export the table as VCF or a "
            "packed store, or install pyarrow"
        ) from e
    return pq


def _column_np(table, name: str, dtype=None, null_fill=None) -> np.ndarray:
    """A (possibly chunked) table column as one numpy array.

    Arrow NULLs do NOT survive ``np.asarray`` on integer columns — the
    cast backfills them with arbitrary values (observed: 0), which for a
    dosage column silently recodes every uncalled genotype as
    homozygous-reference. So nulls are handled explicitly: filled with
    ``null_fill`` when given (sample columns pass -1, the documented
    missing code), otherwise a hard error naming the column (metadata
    columns, where a null has no meaningful encoding).
    """
    col = table.column(name)
    if col.null_count:
        if null_fill is None:
            raise ValueError(
                f"column {name!r} has {col.null_count} NULL value(s); "
                "NULLs cannot be cast losslessly — re-export the table "
                "without nulls in this column"
            )
        import pyarrow.compute as pc

        col = pc.fill_null(col, null_fill)
    chunks = col.chunks
    arrs = [np.asarray(c) if dtype is None else np.asarray(c, dtype)
            for c in chunks]
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)


@dataclass
class ParquetSource:
    path: str
    references: Sequence = ()  # ReferenceRange-like: contig, start, end
    _samples: list[str] | None = field(default=None, repr=False)
    _n_variants: int | None = field(default=None, repr=False)
    _single_contig: bool | None = field(default=None, repr=False)

    def _file(self):
        return _pyarrow().ParquetFile(self.path)

    @property
    def sample_ids(self) -> list[str]:
        if self._samples is None:
            names = [
                c for c in self._file().schema_arrow.names
                if c not in _META_COLUMNS
            ]
            if not names:
                raise ValueError(
                    f"{self.path}: no sample columns (only "
                    f"{_META_COLUMNS}) — not a variant-by-sample table"
                )
            self._samples = names
        return self._samples

    @property
    def n_samples(self) -> int:
        return len(self.sample_ids)

    @property
    def exact_n_variants(self) -> bool:
        """True only when the stream provably satisfies the steady
        ceil(v/bv) block-count contract (GenotypeSource docstring):
        unfiltered AND single-contig — multi-contig tables flush
        partial blocks at contig changes. Single-contig is decided from
        row-group column statistics alone (no data read); inconclusive
        statistics decline conservatively. Min/max statistics IGNORE
        nulls, so a contig column containing any NULL (which ``_pieces``
        treats as its own contig=None run, with boundary flushes) must
        also decline — the statistics must prove ``null_count == 0``
        before one (min == max) value means one contig."""
        if self.references:
            return False
        if self._single_contig is None:
            f = self._file()
            if "contig" not in f.schema_arrow.names:
                self._single_contig = True
            else:
                md = f.metadata
                seen: set = set()
                ok = True
                for rg in range(md.num_row_groups):
                    rg_meta = md.row_group(rg)
                    st = self._rg_stats(rg_meta, "contig")
                    nulls = self._rg_null_count(rg_meta, "contig")
                    if st is None or nulls != 0:
                        ok = False  # inconclusive or null-bearing
                        break
                    seen.update((st[0], st[1]))
                self._single_contig = ok and len(seen) == 1
        return self._single_contig

    @property
    def n_variants(self) -> int:
        if self._n_variants is None:
            f = self._file()
            if not self.references:
                self._n_variants = f.metadata.num_rows
            else:
                # Counting scan over pruned row groups' metadata
                # columns only — no sample data is read.
                count = 0
                for _rg, meta_tbl in self._candidate_groups(f):
                    count += int(self._range_mask(meta_tbl).sum())
                self._n_variants = count
        return self._n_variants

    @staticmethod
    def _rg_stats(rg_meta, name: str):
        """(min, max) statistics of one column in one row group, or
        None when the writer recorded none."""
        for i in range(rg_meta.num_columns):
            col = rg_meta.column(i)
            if col.path_in_schema == name:
                st = col.statistics
                if st is None or not st.has_min_max:
                    return None
                return st.min, st.max
        return None

    @staticmethod
    def _rg_null_count(rg_meta, name: str):
        """Recorded null count of one column in one row group, or None
        when the writer recorded no statistics (conservatively
        inconclusive — NOT zero)."""
        for i in range(rg_meta.num_columns):
            col = rg_meta.column(i)
            if col.path_in_schema == name:
                st = col.statistics
                if st is None or not st.has_null_count:
                    return None
                return int(st.null_count)
        return None

    def _rg_may_overlap(self, rg_meta, names) -> bool:
        """Can this row group contain any row inside the ranges? False
        only on a provable miss (missing statistics keep the group)."""
        cstat = self._rg_stats(rg_meta, "contig") if "contig" in names else None
        pstat = self._rg_stats(rg_meta, "position") if "position" in names else None
        for r in self.references:
            if cstat is not None and not (cstat[0] <= r.contig <= cstat[1]):
                continue
            if pstat is not None and (pstat[1] < r.start or pstat[0] >= r.end):
                continue
            return True
        return False

    def _candidate_groups(self, f):
        """Yield (row-group index, metadata-columns table) for groups
        that may intersect the ranges — the stats-pruned scan both
        counting and streaming share."""
        names = f.schema_arrow.names
        meta_cols = [c for c in _META_COLUMNS if c in names]
        if not meta_cols:
            raise ValueError(
                f"{self.path}: --references filtering needs 'contig' "
                "and 'position' columns in the table"
            )
        for rg in range(f.metadata.num_row_groups):
            if not self._rg_may_overlap(f.metadata.row_group(rg), names):
                continue
            yield rg, f.read_row_group(rg, columns=meta_cols)

    def _range_mask(self, meta_tbl) -> np.ndarray:
        names = meta_tbl.schema.names
        if "contig" not in names or "position" not in names:
            raise ValueError(
                f"{self.path}: --references filtering needs 'contig' "
                "and 'position' columns in the table"
            )
        contigs = np.asarray(meta_tbl.column("contig").to_pylist())
        pos = _column_np(meta_tbl, "position", np.int64)
        mask = np.zeros(meta_tbl.num_rows, bool)
        for r in self.references:
            mask |= (contigs == r.contig) & (pos >= r.start) & (pos < r.end)
        return mask

    def _pieces(self):
        """Yield (int8 (N, v) piece, positions | None, contig | None) per
        row group, split on contig changes (the rechunk contract)."""
        f = self._file()
        names = f.schema_arrow.names
        samples = self.sample_ids
        has_contig = "contig" in names
        has_pos = "position" in names
        meta_cols = [c for c in _META_COLUMNS if c in names]

        if self.references:
            groups = self._candidate_groups(f)
        else:
            groups = (
                (rg, f.read_row_group(rg, columns=meta_cols)
                 if meta_cols else None)
                for rg in range(f.metadata.num_row_groups)
            )
        for rg, meta_tbl in groups:
            if self.references:
                mask = self._range_mask(meta_tbl)
                if not mask.any():
                    continue  # sample columns never decoded
            else:
                mask = None
            data = f.read_row_group(rg, columns=samples)
            # (v_rows, N) → (N, v): one astype per sample column, then a
            # stack — columnar decode, no per-record Python loop. NULL
            # dosages (routine in BigQuery exports for uncalled
            # genotypes) become -1, the documented missing code — NOT
            # the silent NULL->0 (homozygous-reference) an unchecked
            # arrow->numpy cast produces.
            cols = np.stack(
                [_column_np(data, s, np.int8, null_fill=-1)
                 for s in samples]
            )
            pos = (
                _column_np(meta_tbl, "position", np.int64)
                if has_pos else None
            )
            contigs = (
                np.asarray(meta_tbl.column("contig").to_pylist())
                if has_contig else None
            )
            if mask is not None:
                cols = cols[:, mask]
                pos = pos[mask] if pos is not None else None
                contigs = contigs[mask] if contigs is not None else None
            if contigs is None:
                yield cols, pos, None
                continue
            # Split the group at contig changes so no piece spans one.
            # NULL contigs (None entries from to_pylist) form their own
            # contig=None runs — boundaries against named contigs still
            # flush, and the label is a real None, not the str(None)
            # "None" pseudo-contig an unchecked str() would mint.
            edges = np.flatnonzero(contigs[1:] != contigs[:-1]) + 1
            for lo, hi in zip(
                np.concatenate(([0], edges)),
                np.concatenate((edges, [len(contigs)])),
            ):
                label = contigs[lo]
                yield (
                    cols[:, lo:hi],
                    pos[lo:hi] if pos is not None else None,
                    None if label is None else str(label),
                )

    def blocks(self, block_variants: int, start_variant: int = 0):
        seen = 0
        for block, meta in rechunk(
            self._pieces(), block_variants, start_variant
        ):
            seen = meta.stop
            yield block, meta
        if self._n_variants is None and start_variant == 0:
            self._n_variants = seen  # full pass counted the stream


def write_parquet(
    path: str,
    genotypes: np.ndarray,
    sample_ids: list[str] | None = None,
    contig: str | None = "chr22",
    positions: np.ndarray | None = None,
    start_pos: int = 16_050_000,
    row_group_rows: int = 8192,
) -> None:
    """Write an (N, V) dosage matrix as a wide parquet variant table
    (tests and interchange; the inverse of :class:`ParquetSource`)."""
    pq = _pyarrow()
    import pyarrow as pa

    n, v = genotypes.shape
    ids = sample_ids or [f"S{i:06d}" for i in range(n)]
    cols: dict = {}
    if contig is not None:
        cols["contig"] = pa.array([contig] * v)
        if positions is None:
            positions = np.arange(start_pos, start_pos + v, dtype=np.int64)
        cols["position"] = pa.array(np.asarray(positions, np.int64))
    for i, s in enumerate(ids):
        cols[s] = pa.array(np.asarray(genotypes[i], np.int8))
    pq.write_table(
        pa.table(cols), path, row_group_size=row_group_rows
    )
