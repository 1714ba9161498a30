"""PLINK 1.x .bed/.bim/.fam ingest.

The .bed payload is SNP-major: 3 magic bytes, then per variant
ceil(N/4) bytes, each holding four samples at 2 bits (LSB first). The
codes differ from this package's 2-bit codec (ingest/bitpack.py) and the
axes are transposed, so reading is a 256-entry LUT decode of the
memmapped byte rows plus one transpose per block. The dosage counts A1
alleles:

    0b00 A1/A1 -> 2      0b10 A1/A2 -> 1
    0b11 A2/A2 -> 0      0b01 missing -> -1

Blocks never span a chromosome boundary (as for VcfSource, so
``BlockMeta.contig`` is exact). The packed transport re-packs the blocks
into this package's codec in the feed's producer thread.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from spark_examples_tpu_torch.ingest.source import BlockMeta

_MAGIC = bytes([0x6C, 0x1B])
_SNP_MAJOR = 0x01

# byte -> 4 int8 dosages (LSB pair first).
_LUT = np.empty((256, 4), np.int8)
_CODE_DOSE = np.array([2, -1, 1, 0], np.int8)  # 00, 01, 10, 11
for _b in range(256):
    for _k in range(4):
        _LUT[_b, _k] = _CODE_DOSE[(_b >> (2 * _k)) & 3]


def _resolve_prefix(path: str) -> str:
    """Accept either the fileset prefix or the .bed path itself."""
    return path[:-4] if path.endswith(".bed") else path


@dataclass
class PlinkSource:
    """PLINK fileset as a GenotypeSource (``--source plink``): a fileset
    prefix or the ``.bed`` path. ``references``: optional genomic ranges
    (``--references chr:start:end``, as for VcfSource); block ordinals
    then index the filtered stream."""

    path: str
    references: Sequence = ()  # ReferenceRange-like
    _ids: list[str] | None = field(default=None, repr=False)
    _chroms: np.ndarray | None = field(default=None, repr=False)
    _positions: np.ndarray | None = field(default=None, repr=False)
    _sel: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self):
        self.prefix = _resolve_prefix(self.path)
        bed = self.prefix + ".bed"
        with open(bed, "rb") as f:
            head = f.read(3)
        if len(head) < 3 or head[:2] != _MAGIC:
            raise ValueError(f"{bed}: not a PLINK .bed file (bad magic)")
        if head[2] != _SNP_MAJOR:
            raise ValueError(
                f"{bed}: sample-major .bed layout is not supported "
                "(re-export with modern PLINK, which writes SNP-major)"
            )

    def _read_fam(self) -> list[str]:
        if self._ids is None:
            ids = []
            with open(self.prefix + ".fam") as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        ids.append(parts[1])  # IID
            self._ids = ids
        return self._ids

    def _read_bim(self) -> tuple[np.ndarray, np.ndarray]:
        if self._chroms is None:
            chroms, pos = [], []
            with open(self.prefix + ".bim") as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        chroms.append(parts[0])
                        pos.append(int(parts[3]))
            self._chroms = np.asarray(chroms)
            self._positions = np.asarray(pos, np.int64)
        return self._chroms, self._positions

    @property
    def sample_ids(self) -> list[str]:
        return self._read_fam()

    @property
    def n_samples(self) -> int:
        return len(self._read_fam())

    def _selection(self) -> np.ndarray:
        """Indices of the variants that stream (all, or in-range),
        cached."""
        if self._sel is None:
            chroms, positions = self._read_bim()
            if not self.references:
                self._sel = np.arange(chroms.shape[0])
            else:
                mask = np.zeros(chroms.shape[0], bool)
                for r in self.references:
                    mask |= (
                        (chroms == r.contig)
                        & (positions >= r.start)
                        & (positions < r.end)
                    )
                self._sel = np.nonzero(mask)[0]
        return self._sel

    @property
    def n_variants(self) -> int:
        return int(self._selection().shape[0])

    def _bed_rows(self) -> np.ndarray:
        """(V_total, ceil(N/4)) uint8 memmap of the .bed payload — the
        FILE's variant count (every .bim row), not the filtered
        ``n_variants``: the selection indexes into these rows."""
        v_total = int(self._read_bim()[0].shape[0])
        bpr = -(-self.n_samples // 4)  # bytes per variant row
        return np.memmap(self.prefix + ".bed", np.uint8, mode="r",
                         offset=3, shape=(v_total, bpr))

    def blocks(self, block_variants: int, start_variant: int = 0):
        """(N, <=block_variants) int8 dosage blocks, chromosome-flush:
        LUT over the (w, ceil(N/4)) byte rows, slice N, transpose to the
        sample-major layout. Contiguous selections slice the memmap,
        filtered ones gather from it."""
        chroms, positions = self._read_bim()
        n = self.n_samples
        sel = self._selection()
        v = sel.shape[0]
        if v == 0:
            return
        rows = self._bed_rows()
        # Fixed grid over the selected stream, split at chromosome
        # boundaries.
        sel_chroms = chroms[sel]
        bounds = [0] + (
            np.nonzero(sel_chroms[1:] != sel_chroms[:-1])[0] + 1
        ).tolist() + [v]
        idx = 0
        for s in range(len(bounds) - 1):
            seg_lo, seg_hi = bounds[s], bounds[s + 1]
            for lo in range(seg_lo, seg_hi, block_variants):
                hi = min(lo + block_variants, seg_hi)
                # Chromosome flushes make the grid irregular: skip by
                # each block's own stop.
                if hi <= start_variant:
                    idx += 1
                    continue
                take = sel[lo:hi]
                if take[-1] - take[0] == hi - lo - 1:  # contiguous run
                    raw = rows[take[0] : take[-1] + 1]  # memmap view
                else:
                    raw = rows[take]  # gather (filtered selection)
                dense = _LUT[raw]  # (w, bpr, 4)
                block = np.ascontiguousarray(
                    dense.reshape(hi - lo, -1)[:, :n].T
                )
                yield block, BlockMeta(
                    idx, lo, hi, str(sel_chroms[lo]), positions[take]
                )
                idx += 1


def write_plink(
    prefix: str,
    genotypes: np.ndarray,
    sample_ids: list[str] | None = None,
    chroms: list[str] | None = None,
    positions: np.ndarray | None = None,
) -> None:
    """Write an (N, V) dosage matrix as a PLINK fileset (the inverse of
    :class:`PlinkSource`)."""
    g = np.asarray(genotypes, np.int8)
    n, v = g.shape
    ids = sample_ids or [f"S{i:06d}" for i in range(n)]
    chroms = chroms if chroms is not None else ["1"] * v
    positions = (np.asarray(positions, np.int64) if positions is not None
                 else np.arange(1, v + 1, dtype=np.int64))
    # dosage -> PLINK code (inverse of _CODE_DOSE)
    code_of = np.zeros(4, np.uint8)
    code_of[2], code_of[1], code_of[0] = 0b00, 0b10, 0b11
    codes = np.where(g < 0, 0b01, code_of[np.clip(g, 0, 2)]).astype(np.uint8)
    pad = -n % 4
    if pad:
        codes = np.concatenate(
            [codes, np.full((pad, v), 0b11, np.uint8)], axis=0
        )  # pad samples encode as hom A2 (dosage 0) and are never read
    c = codes.T.reshape(v, -1, 4)  # SNP-major
    rows = (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6))
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC + bytes([_SNP_MAJOR]))
        f.write(np.ascontiguousarray(rows).tobytes())
    with open(prefix + ".fam", "w") as f:
        for i, s in enumerate(ids):
            f.write(f"FAM{i} {s} 0 0 0 -9\n")
    with open(prefix + ".bim", "w") as f:
        for j in range(v):
            f.write(f"{chroms[j]}\trs{j}\t0\t{positions[j]}\tA\tC\n")
