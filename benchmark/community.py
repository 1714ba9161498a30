"""Seeded rarefied count tables (sample x sOTU), drawn on the device and
handed to the host as CSR.

The community model (the configuration's ``assumed``): each environment
(a group of the configuration) has its own pool of ``pool_features``
sOTUs, a sorted random subset of the whole axis, so the pools of two
environments overlap by chance (by ``pool_features / n_features`` of
each on average), and over its pool heavy-tailed log-normal abundances
``exp(abundance_sigma z)``, scaled to mean 1. A sample draws Dirichlet
proportions over its environment's pool, with concentration ``a`` times
the abundances and ``a`` log-uniform over ``concentration`` (small
``a``: a few sOTUs dominate, so few are seen), then exactly ``depth``
reads from those proportions: the table rarefied to ``depth`` reads a
sample. Group sizes are the configuration's and the row order a
permutation drawn from the seed (``cohort.group_labels``), so every
seed does the same work.

Chunks of ``CHUNK_SAMPLES`` rows are drawn from one ``torch.Generator``
on the device, counted there and copied once to the host as their CSR
pieces (row offsets, feature indices ascending within a row, counts).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.cohort import group_labels, sample_ids

CHUNK_SAMPLES = 1024


class Community:
    """The configuration's count table for ``seed``: labels and ids on
    the host, counts drawn chunk by chunk on ``device``."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        self.config = config
        self.n_samples = int(config["n_samples"])
        self.n_features = int(config["n_features"])
        self.depth = int(config["depth"])
        self.pool = int(config["pool_features"])
        groups = config["groups"]
        if sum(groups.values()) != self.n_samples:
            raise ValueError(
                f"{config['name']}: the groups hold "
                f"{sum(groups.values())} samples, not {self.n_samples}")
        if not 0 < self.pool <= self.n_features:
            raise ValueError(f"pool_features {self.pool} outside "
                             f"(0, {self.n_features}]")
        self.labels = group_labels(list(groups.values()), seed)
        self.sample_ids = sample_ids(groups, self.labels)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % 2**63)
        self._labels_t = torch.from_numpy(self.labels).to(self.device)
        self._n_groups = len(groups)

    def _pools(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Each environment's sorted sOTUs, (G, pool) int64, and their
        abundances, (G, pool) float64 of mean 1."""
        dev, gen = self.device, self.gen
        pools = torch.stack([
            torch.randperm(self.n_features, generator=gen, device=dev)[
                :self.pool].sort().values
            for _ in range(self._n_groups)])
        z = torch.randn((self._n_groups, self.pool), generator=gen,
                        device=dev, dtype=torch.float64)
        w = torch.exp(float(self.config["abundance_sigma"]) * z)
        return pools, w / w.mean(dim=1, keepdim=True)

    def _chunk(self, lo: int, hi: int, pools: torch.Tensor,
               w: torch.Tensor):
        """Rows ``[lo, hi)`` as (row nnz, feature indices, counts) on the
        device."""
        dev, gen = self.device, self.gen
        rows = hi - lo
        lab = self._labels_t[lo:hi]
        a_lo, a_hi = (math.log(float(v))
                      for v in self.config["concentration"])
        a = torch.exp(a_lo + (a_hi - a_lo) * torch.rand(
            (rows, 1), generator=gen, device=dev, dtype=torch.float64))
        alpha = w.index_select(0, lab)
        g = torch._standard_gamma(a * alpha, generator=gen)
        # A row whose every gamma underflowed takes its pool's shape.
        g = torch.where(g.sum(dim=1, keepdim=True) > 0, g, alpha)
        cum = g.cumsum_(dim=1)
        del alpha
        u = torch.rand((rows, self.depth), generator=gen, device=dev,
                       dtype=torch.float64) * cum[:, -1:]
        pick = torch.searchsorted(cum, u, right=True).clamp_(
            max=self.pool - 1)
        del cum, u
        counts = torch.zeros((rows, self.pool), dtype=torch.int32,
                             device=dev)
        counts.scatter_add_(1, pick, torch.ones_like(pick, dtype=torch.int32))
        r, j = counts.nonzero(as_tuple=True)
        return (torch.bincount(r, minlength=rows),
                pools[lab[r], j].to(torch.int32), counts[r, j])

    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The whole table as host CSR: ``(indptr int64 (N + 1,),
        indices int32, counts int32)``; every row sums to ``depth``."""
        pools, w = self._pools()
        nnz, idx, cnt = [], [], []
        for lo in range(0, self.n_samples, CHUNK_SAMPLES):
            hi = min(lo + CHUNK_SAMPLES, self.n_samples)
            for out, part in zip((nnz, idx, cnt),
                                 self._chunk(lo, hi, pools, w)):
                out.append(part.cpu().numpy())
        indptr = np.zeros(self.n_samples + 1, dtype=np.int64)
        np.cumsum(np.concatenate(nnz), out=indptr[1:])
        return indptr, np.concatenate(idx), np.concatenate(cnt)
