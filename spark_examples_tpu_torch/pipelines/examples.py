"""The example tier's variant jobs: per-variant genotype histograms
(``search-variants``, the Klotho/BRCA1 genotype-count shape) and
per-sample QC statistics (``sample-stats``), each one streaming pass
over the source's blocks.

Each block goes to the job's device and is reduced there: four one-hot
sums over the sample axis for the histogram, three over the variant
axis for the per-sample counts, which accumulate in an (N, 3) int32
tensor that stays on the device until the stream ends. A position
filter is matched on the host first, so a block without a hit is never
copied or reduced. Counts are integers, so the results equal the JAX
package's exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_examples_tpu_torch.core.device import resolve_device


def block_histogram(block: torch.Tensor) -> torch.Tensor:
    """(N, v) int8 dosages -> (v, 4) int32 counts of [hom-ref, het,
    hom-alt, missing] across samples."""
    return torch.stack([(block == g).sum(dim=0, dtype=torch.int32)
                        for g in (0, 1, 2, -1)], dim=1)


def block_sample_counts(block: torch.Tensor) -> torch.Tensor:
    """(N, v) int8 dosages -> (N, 3) int32 per-sample counts of [called,
    het, hom-alt] over the block's variants."""
    return torch.stack([
        (block >= 0).sum(dim=1, dtype=torch.int32),
        (block == 1).sum(dim=1, dtype=torch.int32),
        (block == 2).sum(dim=1, dtype=torch.int32),
    ], dim=1)


@dataclass
class VariantCounts:
    contig: str | None
    position: int  # genomic position when known, else global index
    hom_ref: int
    het: int
    hom_alt: int
    missing: int

    @property
    def allele_freq(self) -> float:
        called = self.hom_ref + self.het + self.hom_alt
        return (self.het + 2 * self.hom_alt) / (2 * called) if called else 0.0


@dataclass
class SampleStats:
    sample_id: str
    n_variants: int
    n_called: int
    n_het: int
    n_hom_alt: int

    @property
    def call_rate(self) -> float:
        return self.n_called / self.n_variants if self.n_variants else 0.0

    @property
    def het_rate(self) -> float:
        """Heterozygosity over called genotypes."""
        return self.n_het / self.n_called if self.n_called else 0.0


def sample_stats(source, block_variants: int = 8192,
                 device: str = "cuda") -> list[SampleStats]:
    """Per-sample call rate and heterozygosity over one streaming pass:
    an (N, 3) int32 accumulator on ``device``, read back once."""
    dev = resolve_device(device)
    acc = None
    n_variants = 0
    for block, meta in source.blocks(block_variants):
        counts = block_sample_counts(torch.from_numpy(block).to(dev))
        acc = counts if acc is None else acc + counts
        n_variants = meta.stop
    if acc is None:
        return []
    a = acc.cpu().numpy()
    return [
        SampleStats(sid, n_variants, int(a[i, 0]), int(a[i, 1]),
                    int(a[i, 2]))
        for i, sid in enumerate(source.sample_ids)
    ]


def genotype_histogram(
    source,
    block_variants: int = 8192,
    positions: set[int] | None = None,
    device: str = "cuda",
) -> list[VariantCounts]:
    """Genotype histograms per variant, optionally only at a set of
    genomic positions (global variant indices where the source carries
    no positions). ``None`` scans everything; an empty set matches
    nothing."""
    dev = resolve_device(device)
    out: list[VariantCounts] = []
    pos_arr = (np.fromiter(positions, dtype=np.int64)
               if positions is not None else None)
    if pos_arr is not None and pos_arr.size == 0:
        return out
    for block, meta in source.blocks(block_variants):
        blk_pos = (np.asarray(meta.positions, dtype=np.int64)
                   if meta.positions is not None
                   else np.arange(meta.start, meta.stop, dtype=np.int64))
        keep = None
        if pos_arr is not None:
            keep = np.nonzero(np.isin(blk_pos, pos_arr))[0]
            if keep.size == 0:
                continue  # no hit: no copy, no reduction
        hist = block_histogram(torch.from_numpy(block).to(dev)).cpu().numpy()
        if keep is not None:
            hist, blk_pos = hist[keep], blk_pos[keep]
        out.extend(
            VariantCounts(meta.contig, int(p), h0, h1, h2, hm)
            for p, (h0, h1, h2, hm) in zip(blk_pos, hist.tolist())
        )
    return out
