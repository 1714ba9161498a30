"""Variant QC filtering as a stream transform (``--maf``,
``--max-missing``).

A source wrapper: per incoming block the allele frequency and missing
rate are computed on the host (the producer side, so dropped columns
never reach the device), surviving columns are re-chunked into steady
``block_variants``-wide blocks, and contig boundaries still flush.
Ordinals index the filtered stream, which is deterministic for a fixed
source and thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spark_examples_tpu_torch.ingest.source import close_source, rechunk


def qc_mask(block: np.ndarray, maf: float, max_missing: float) -> np.ndarray:
    """Boolean keep-mask over the block's variant axis.

    MAF = min(p, 1-p) with p the alt-allele frequency over called
    genotypes (dosage mean / 2); variants with zero calls have missing
    rate 1.0 and undefined MAF, so either active threshold drops them.
    """
    valid = block >= 0
    n_called = valid.sum(axis=0)
    miss = 1.0 - n_called / block.shape[0]
    keep = miss <= max_missing
    if maf > 0.0:
        with np.errstate(invalid="ignore"):
            p = np.where(
                n_called > 0,
                np.where(valid, block, 0).sum(axis=0) / (2.0 * n_called),
                np.nan,
            )
        keep &= np.minimum(p, 1.0 - p) >= maf
    return keep


@dataclass
class FilteredSource:
    """QC-filtered view of any GenotypeSource."""

    inner: object
    maf: float = 0.0
    max_missing: float = 1.0
    _n_variants: int | None = field(default=None, repr=False)

    @property
    def sample_ids(self) -> list[str]:
        return self.inner.sample_ids

    @property
    def n_samples(self) -> int:
        return self.inner.n_samples

    @property
    def n_variants(self) -> int:
        """Kept-variant count: a full pass over the inner source, lazy
        and cached (a completed streaming pass caches it too)."""
        if self._n_variants is None:
            count = 0
            for block, _ in self.inner.blocks(16384):
                count += int(qc_mask(block, self.maf, self.max_missing).sum())
            self._n_variants = count
        return self._n_variants

    def _filtered(self):
        for block, meta in self.inner.blocks(16384):
            keep = qc_mask(block, self.maf, self.max_missing)
            yield (
                np.ascontiguousarray(block[:, keep]),
                (np.asarray(meta.positions)[keep]
                 if meta.positions is not None else None),
                meta.contig,
            )

    def close(self) -> None:
        close_source(self.inner)

    def blocks(self, block_variants: int, start_variant: int = 0):
        emitted = 0
        for block, meta in rechunk(self._filtered(), block_variants,
                                   start_variant):
            emitted = meta.stop
            yield block, meta
        if start_variant == 0:
            self._n_variants = emitted
