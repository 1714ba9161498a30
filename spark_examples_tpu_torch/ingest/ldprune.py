"""LD pruning as a stream transform (``--ld-prune-r2``), the
``--indep-pairwise`` step of PLINK-family workflows.

The stream is windowed (``rechunk``, window-sized blocks, chromosome
flush); each window's squared correlation of variants is one
``z^T z`` product of per-variant standardized dosages (missing calls
mean-imputed) on the job's device, accumulated in float64 and rounded
to f32 (never TF32), at the fixed padded width ``carry + window``; the
greedy keep scan runs on the host over the (W, W) matrix. Kept columns
re-chunk into steady blocks.

Windows do not overlap; the last ``carry`` KEPT variants are carried
into the next window's comparison set, so pairs spanning a boundary
within ``carry`` variants are still checked. LD context resets at
chromosome boundaries. Ordinals index the pruned stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spark_examples_tpu_torch.ingest.source import close_source, rechunk
from spark_examples_tpu_torch.ops.gram import f32_xxt


def _window_r2(x: torch.Tensor) -> torch.Tensor:
    """(N, w) int8 dosages -> (w, w) squared correlation of variants.

    Missing calls are mean-imputed per variant (zero after centering);
    zero-variance variants, the all-missing pad columns among them, get
    r = 0 against everything. f32 values; ``z^T z`` is accumulated in
    float64 (``ops.gram.f32_xxt``), so no TF32 setting rounds its
    operands to 10 mantissa bits.
    """
    valid = x >= 0
    v = valid.to(torch.float32)
    y = torch.where(valid, x, 0).to(torch.float32)
    cnt = torch.clamp(v.sum(dim=0), min=1.0)
    mean = y.sum(dim=0) / cnt
    z = torch.where(valid, y - mean[None, :], 0.0)
    cov = f32_xxt(z.T)
    var = torch.diagonal(cov)
    # Rooted in f64 and rounded once: the correctly rounded f32 root
    # (PyTorch's vectorised f32 sqrt on the CPU is not).
    denom = torch.sqrt(torch.outer(var, var).to(torch.float64)).to(
        torch.float32)
    r = torch.where(denom > 1e-12, cov / denom, 0.0)
    return r * r


def _greedy_keep(r2: np.ndarray, base: int, thresh: float) -> np.ndarray:
    """Greedy scan: keep variant j iff its r^2 with every PREVIOUSLY kept
    variant (including the ``base`` carried-in columns, which are not
    re-decided) stays <= thresh. Returns the keep mask of columns
    base..W."""
    w = r2.shape[0]
    kept = list(range(base))
    keep = np.zeros(w - base, bool)
    for j in range(base, w):
        if not kept or (r2[j, kept] <= thresh).all():
            keep[j - base] = True
            kept.append(j)
    return keep


@dataclass
class LdPruneSource:
    """LD-pruned view of any GenotypeSource; the r^2 products run on
    ``device``."""

    inner: object
    r2: float = 0.2
    window: int = 256
    carry: int = 64
    device: str = "cuda"
    _n_variants: int | None = field(default=None, repr=False)

    def __post_init__(self):
        if not 0.0 < self.r2 <= 1.0:
            raise ValueError(f"r2 threshold must be in (0, 1], got {self.r2}")
        if not 1 <= self.carry < self.window:
            raise ValueError(
                f"carry must be in [1, window), got carry={self.carry} "
                f"window={self.window}"
            )

    @property
    def sample_ids(self) -> list[str]:
        return self.inner.sample_ids

    @property
    def n_samples(self) -> int:
        return self.inner.n_samples

    @property
    def n_variants(self) -> int:
        """Kept count: a full pruning pass, lazy and cached (a completed
        streaming pass caches it too)."""
        if self._n_variants is None:
            self._n_variants = sum(
                b.shape[1] for b, _ in self.blocks(16384)
            )
        return self._n_variants

    def _pruned_windows(self):
        """Yield (kept_block, positions, contig) per window, carrying
        kept-variant context within each contig."""
        n = self.inner.n_samples
        wpad = self.carry + self.window
        device = torch.device(self.device)
        ctx: np.ndarray | None = None  # (N, <=carry) kept tail
        ctx_contig: str | None = None

        def pieces():
            for block, meta in self.inner.blocks(self.window):
                yield (
                    block,
                    (np.asarray(meta.positions)
                     if meta.positions is not None else None),
                    meta.contig,
                )

        for cols, meta in rechunk(pieces(), self.window):
            if ctx_contig != meta.contig:
                ctx = None  # LD does not span chromosomes
            base = 0 if ctx is None else ctx.shape[1]
            w = cols.shape[1]
            x = np.full((n, wpad), -1, np.int8)  # pad = all-missing:
            if base:                             # zero variance, r = 0
                x[:, :base] = ctx
            x[:, base: base + w] = cols
            r2m = _window_r2(torch.from_numpy(x).to(device)).cpu().numpy()
            r2m = r2m[: base + w, : base + w]
            keep = _greedy_keep(r2m, base, self.r2)[:w]
            kept = np.ascontiguousarray(cols[:, keep])
            all_kept = (
                kept if ctx is None
                else np.concatenate([ctx, kept], axis=1)
            )
            ctx = np.ascontiguousarray(all_kept[:, -self.carry:])
            ctx_contig = meta.contig
            kp = (
                meta.positions[keep]
                if meta.positions is not None else None
            )
            yield kept, kp, meta.contig

    def close(self) -> None:
        close_source(self.inner)

    def blocks(self, block_variants: int, start_variant: int = 0):
        """Re-chunk pruned windows into (N, <=block_variants) blocks,
        contig-flush, pruned-stream ordinals."""
        emitted = 0
        for block, meta in rechunk(self._pruned_windows(), block_variants,
                                   start_variant):
            emitted = meta.stop
            yield block, meta
        if start_variant == 0:
            self._n_variants = emitted
