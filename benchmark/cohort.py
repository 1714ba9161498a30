"""Seeded genotype cohorts, made on the device in a few large calls.

The Balding-Nichols model (the port's ``ingest/synthetic.py`` model,
redrawn here in PyTorch): per variant an ancestral allele frequency
``p ~ U(maf_low, 1 - maf_low)``; per group a frequency
``Beta(p (1 - F) / F, (1 - p) (1 - F) / F)`` with drift ``F`` (F_ST);
per sample a genotype ``Binomial(2, p_group)``, drawn from one uniform
``u`` as ``[u < p^2] + [u < p (2 - p)]``; a share of calls missing
(-1). Group sizes are the configuration's, the row order a permutation
drawn from the seed, so every seed does the same work.

Chunks of ``CHUNK_VARIANTS`` variants are drawn from one
``torch.Generator`` on the card, packed to 2 bits there (the JAX
package's layout, frozen here: four dosages a byte, variant ``v`` at
bits ``2 (v % 4)`` of byte ``v // 4``, code 3 for a missing call or a
pad) and copied once into a host array or a packed store.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

CODE_MISSING = 3
VARIANTS_PER_BYTE = 4
CHUNK_VARIANTS = 16_384
# The packed store's sidecar schema (the port's ``ingest/packed.py``).
STORE_SCHEMA_VERSION = 2


def packed_width(n_variants: int) -> int:
    return -(-n_variants // VARIANTS_PER_BYTE)


def pack_2bit(g: torch.Tensor) -> torch.Tensor:
    """(N, V) int8 dosages in {-1, 0, 1, 2} -> (N, ceil(V / 4)) uint8."""
    n, v = g.shape
    codes = torch.where(g < 0, CODE_MISSING, g.to(torch.int16)).to(
        torch.uint8)
    pad = -v % VARIANTS_PER_BYTE
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad),
                                        value=CODE_MISSING)
    c = codes.reshape(n, -1, VARIANTS_PER_BYTE)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


def group_labels(sizes: list[int], seed: int) -> np.ndarray:
    """Each sample's group index: ``sizes[k]`` samples of group ``k``, in
    an order drawn from ``seed``."""
    labels = np.repeat(np.arange(len(sizes)), sizes)
    return np.random.default_rng([seed, 0x50]).permutation(labels)


def sample_ids(groups: dict[str, int], labels: np.ndarray) -> list[str]:
    names = list(groups)
    return [f"{names[k]}_{i:06d}" for i, k in enumerate(labels)]


class Cohort:
    """The configuration's cohort for ``seed``: its labels and ids on the
    host, its 2-bit bytes drawn chunk by chunk on ``device``."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        self.config = config
        self.n_samples = int(config["n_samples"])
        self.n_variants = int(config["n_variants"])
        groups = config["groups"]
        if sum(groups.values()) != self.n_samples:
            raise ValueError(
                f"{config['name']}: the groups hold "
                f"{sum(groups.values())} samples, not {self.n_samples}")
        self.labels = group_labels(list(groups.values()), seed)
        self.sample_ids = sample_ids(groups, self.labels)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % 2**63)
        self._labels_t = torch.from_numpy(self.labels).to(self.device)
        self._n_groups = len(groups)

    def _dosages(self, width: int) -> torch.Tensor:
        cfg, dev, gen = self.config, self.device, self.gen
        f, maf = float(cfg["fst"]), float(cfg["maf_low"])
        p_anc = maf + (1.0 - 2.0 * maf) * torch.rand(
            width, generator=gen, device=dev, dtype=torch.float64)
        a = (p_anc * (1.0 - f) / f).clamp(min=1e-3)
        b = ((1.0 - p_anc) * (1.0 - f) / f).clamp(min=1e-3)
        ga = torch._standard_gamma(a.expand(self._n_groups, width)
                                   .contiguous(), generator=gen)
        gb = torch._standard_gamma(b.expand(self._n_groups, width)
                                   .contiguous(), generator=gen)
        p_grp = (ga / (ga + gb).clamp(min=1e-300)).to(torch.float32)
        p = p_grp.index_select(0, self._labels_t)  # (N, width)
        u = torch.rand((self.n_samples, width), generator=gen, device=dev)
        g = (u < p * p).to(torch.int8) + (u < p * (2.0 - p)).to(torch.int8)
        del p, u
        miss = torch.rand((self.n_samples, width), generator=gen,
                          device=dev) < float(cfg["missing_rate"])
        return g.masked_fill_(miss, -1)

    def chunks(self):
        """Yield ``(byte offset, (N, w) uint8 packed chunk on the device)``
        over the whole cohort."""
        for lo in range(0, self.n_variants, CHUNK_VARIANTS):
            width = min(CHUNK_VARIANTS, self.n_variants - lo)
            yield lo // VARIANTS_PER_BYTE, pack_2bit(self._dosages(width))

    def fill(self, out: np.ndarray) -> np.ndarray:
        """Write the packed cohort into ``out``, (N, ceil(V / 4)) uint8."""
        for off, chunk in self.chunks():
            out[:, off:off + chunk.shape[1]] = chunk.cpu().numpy()
        return out

    def to_host(self) -> np.ndarray:
        out = np.empty((self.n_samples, packed_width(self.n_variants)),
                       np.uint8)
        return self.fill(out)

    def write_store(self, path: str) -> np.ndarray:
        """A 2-bit packed store at ``path`` as the port's ``pack`` writes
        it: ``genotypes.2bit.npy`` and the ``meta.json`` sidecar. Returns
        the store's matrix, mapped read-only."""
        os.makedirs(path, exist_ok=True)
        npy = os.path.join(path, "genotypes.2bit.npy")
        out = np.lib.format.open_memmap(
            npy, mode="w+", dtype=np.uint8,
            shape=(self.n_samples, packed_width(self.n_variants)))
        self.fill(out)
        out.flush()
        del out
        meta = {"schema_version": STORE_SCHEMA_VERSION,
                "n_samples": self.n_samples,
                "n_variants": self.n_variants, "bits": 2,
                "sample_ids": self.sample_ids,
                "contig": self.config.get("contig")}
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        return np.load(npy, mmap_mode="r")
