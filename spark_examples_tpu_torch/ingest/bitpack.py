"""2-bit genotype codec: four dosages per byte.

    code 0 -> dosage 0      code 2 -> dosage 2
    code 1 -> dosage 1      code 3 -> missing (-1)

Variant ``v`` lives in byte ``v // 4`` at bit offset ``2 * (v % 4)``.
Ragged widths are padded with code 3 (missing), which contributes zero
to every gram product.

The host-side pack and unpack run in the feed's producer thread and the
ingest's workers, so they take the native single-pass loops
(``native/codec.cpp``) when the library is available; the numpy code
below is the byte-identical fallback and the tests' oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_examples_tpu_torch import native

CODE_MISSING = 3
VARIANTS_PER_BYTE = 4


def packed_width(n_variants: int) -> int:
    """Bytes per sample row needed to hold ``n_variants`` dosages."""
    return -(-n_variants // VARIANTS_PER_BYTE)


def pack_dosages(g: np.ndarray) -> np.ndarray:
    """(N, V) int8 dosages in {-1, 0, 1, 2} -> (N, ceil(V/4)) uint8.
    Values outside the dosage domain are rejected: the 2-bit truncation
    would corrupt them silently."""
    g = np.asarray(g)
    if g.ndim != 2:
        raise ValueError(f"expected (N, V) matrix, got shape {g.shape}")
    out = native.pack_dosages(g)
    if out is not None:
        return out
    lo, hi = int(g.min(initial=0)), int(g.max(initial=0))
    if lo < -1 or hi > 2:
        raise ValueError(
            f"dosage values out of 2-bit range [-1, 2]: min={lo} max={hi} "
            "(pack_dosages is for genotype dosages only)"
        )
    n, v = g.shape
    codes = np.where(g < 0, CODE_MISSING, g).astype(np.uint8)
    pad = -v % VARIANTS_PER_BYTE
    if pad:
        codes = np.concatenate(
            [codes, np.full((n, pad), CODE_MISSING, np.uint8)], axis=1
        )
    c = codes.reshape(n, -1, VARIANTS_PER_BYTE)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


def unpack_dosages_np(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`pack_dosages`: the full (N, 4 * W) int8
    matrix, pad columns coming back as missing (-1)."""
    packed = np.asarray(packed, np.uint8)
    out = native.unpack_dosages(packed)
    if out is not None:
        return out
    shifts = np.array([0, 2, 4, 6], np.uint8)
    codes = (packed[:, :, None] >> shifts) & np.uint8(3)
    codes = codes.reshape(packed.shape[0], -1)
    return np.where(codes == CODE_MISSING, -1, codes).astype(np.int8)


def unpack_dosages(packed: torch.Tensor) -> torch.Tensor:
    """Device-side unpack: (N, W) uint8 -> (N, 4 * W) int8 dosages."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = (packed[:, :, None] >> shifts) & 3
    codes = codes.reshape(packed.shape[0], -1)
    return torch.where(codes == CODE_MISSING, -1,
                       codes.to(torch.int8)).to(torch.int8)
