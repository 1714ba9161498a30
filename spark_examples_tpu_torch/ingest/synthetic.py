"""Seeded synthetic cohorts with planted population structure.

A Balding-Nichols model: ancestral allele frequency per variant,
population-specific frequencies drawn Beta-distributed around it with
drift F_ST, genotypes Binomial(2, p_pop), a share of calls missing.
Recovering the planted clusters is an assertable property at any scale.

Generation is chunk-deterministic: variants come from a fixed 1024-wide
grid, each chunk from its own ``SeedSequence([seed, 1, chunk])`` stream,
so the data for variant ``i`` does not depend on ``block_variants``. The
same seed gives byte-identical blocks to the JAX package's source.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spark_examples_tpu_torch.ingest.source import BlockMeta

_CHUNK = 1024


@dataclass
class SyntheticSource:
    n_samples: int = 2504
    n_variants: int = 100_000
    n_populations: int = 5
    fst: float = 0.1  # drift between populations
    missing_rate: float = 0.01
    maf_low: float = 0.05
    seed: int = 0
    _pops: np.ndarray = field(init=False, repr=False)

    exact_n_variants = True  # ceil(V / bv) blocks, no flushes

    def __post_init__(self):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0xC0]))
        self._pops = rng.integers(0, self.n_populations, self.n_samples)

    @property
    def populations(self) -> np.ndarray:
        """Planted population label per sample (for validation)."""
        return self._pops

    @property
    def sample_ids(self) -> list[str]:
        return [f"P{self._pops[i]}_S{i:06d}" for i in range(self.n_samples)]

    def _chunk(self, c: int) -> np.ndarray:
        """Generate the int8 (n_samples, <=_CHUNK) chunk ``c``."""
        lo = c * _CHUNK
        width = min(_CHUNK, self.n_variants - lo)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 1, c]))
        p_anc = rng.uniform(self.maf_low, 1.0 - self.maf_low, width)
        if self.fst > 0:
            a = p_anc * (1.0 - self.fst) / self.fst
            b = (1.0 - p_anc) * (1.0 - self.fst) / self.fst
            p_pop = rng.beta(np.maximum(a, 1e-3), np.maximum(b, 1e-3),
                             (self.n_populations, width))
        else:
            p_pop = np.broadcast_to(p_anc, (self.n_populations, width))
        p = p_pop[self._pops]  # (n_samples, width)
        # Binomial(2, p) drawn as two Bernoulli trials.
        g = (
            (rng.random((self.n_samples, width)) < p).astype(np.int8)
            + (rng.random((self.n_samples, width)) < p).astype(np.int8)
        )
        if self.missing_rate > 0:
            miss = rng.random((self.n_samples, width)) < self.missing_rate
            g[miss] = -1
        return g

    def blocks(self, block_variants: int, start_variant: int = 0):
        v = self.n_variants
        first = -(-start_variant // block_variants)
        for idx in range(first, -(-v // block_variants)):
            lo = idx * block_variants
            hi = min(lo + block_variants, v)
            c0, c1 = lo // _CHUNK, (hi - 1) // _CHUNK
            chunks = [self._chunk(c) for c in range(c0, c1 + 1)]
            wide = np.concatenate(chunks, axis=1)
            block = np.ascontiguousarray(
                wide[:, lo - c0 * _CHUNK: hi - c0 * _CHUNK]
            )
            yield block, BlockMeta(idx, lo, hi, contig="synthetic")
