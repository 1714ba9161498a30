"""Genotype-block transforms: pair counting as int8 contractions.

For a dosage block ``G`` of shape (N, V) with values {0, 1, 2, -1 =
missing}, the indicator operands are

    C  = [G >= 0]   valid (non-missing) call
    T1 = [G >= 1]   carries at least one alt allele
    T2 = [G >= 2]   homozygous alt

plus Y = T1 + T2 (clipped dosage), YR = the raw masked value and QR =
YR^2. Every pairwise co-occurrence count is a bilinear form in these
operands: the raw products (``cc``, ``yc``, ``t1t1``, ...) are what
the stream accumulates in int32, and the named statistics are assembled
once, in :func:`combine_products`. Counts stay bit-exact while the
worst per-variant increment times the stream length is below 2^31.

Products are exact integers either way they are contracted:
:func:`int_dot` (the plain version) contracts the int8 operands in
float64 (exact below 2^53) and casts back to int32; :func:`int_mm` runs
the int8 tensor-core library product ``torch._int_mm`` with int32
accumulation on a CUDA device, the counterpart of the JAX package's
int8 ``dot_general``. The packed CUDA kernel (``ops/packed_gram.py``)
serves the six dosage kernels' products straight from 2-bit bytes.
"""

from __future__ import annotations

import torch

# raw product name -> (left operand, right operand); each is one
# ``A B^T`` contraction with int32 results.
PRODUCT_OPERANDS: dict[str, tuple[str, str]] = {
    "cc": ("c", "c"),
    "t1c": ("t1", "c"),
    "t2c": ("t2", "c"),
    "yc": ("y", "c"),
    "qc": ("qr", "c"),
    "yy": ("yr", "yr"),
    "t1t1": ("t1", "t1"),
    "t1t2": ("t1", "t2"),
    "t2t2": ("t2", "t2"),
}

# Products whose left operand exceeds int8: product -> weighted sum of
# int8-operand contractions. qc = 128*(qh c^T) + (ql c^T) with
# qh = qr >> 7, ql = qr & 127.
_INT8_SPLIT: dict[str, tuple[tuple[tuple[str, str], int], ...]] = {
    "qc": ((("qh", "c"), 128), (("ql", "c"), 1)),
}

# statistic -> raw products it needs.
PIECE_PRODUCTS: dict[str, tuple[str, ...]] = {
    "m": ("cc",),
    "s": ("t1t1",),
    "sc": ("t1c",),
    "d1": ("yc", "t1t1", "t2t2"),
    "ibs2": ("cc", "t1c", "t1t1", "t1t2", "t2t2"),
    "dot": ("yy",),
    "e2": ("qc", "yy"),
    "hh": ("t1t1", "t1t2", "t2t2"),
    "opp": ("t2c", "t1t2"),
    "hc": ("t1c", "t2c"),
}


def operands(block: torch.Tensor) -> dict[str, torch.Tensor]:
    """(N, V) int8 values -> the contraction operands. Missing (any
    negative value) contributes zero to every operand, which gives the
    pairwise-complete semantics. ``qr`` is int16 (127^2 > int8)."""
    valid = block >= 0
    c = valid.to(torch.int8)
    t1 = (block >= 1).to(torch.int8)
    t2 = (block >= 2).to(torch.int8)
    yr = (valid * block).to(torch.int8)
    qr = yr.to(torch.int16) ** 2
    return {"c": c, "t1": t1, "t2": t2, "y": t1 + t2, "yr": yr, "qr": qr}


def af_stats(block: torch.Tensor):
    """Missing-aware per-variant allele statistics of an int8 dosage
    block: ``(p, cnt, y, valid)`` — alt-allele frequency over called
    genotypes, call counts, zero-masked f32 dosages and the valid mask.
    Every sum is of small integers, exact in f32 in any order."""
    valid = block >= 0
    y = torch.where(valid, block, 0).to(torch.float32)
    cnt = valid.sum(dim=0).to(torch.float32)
    p = torch.where(cnt > 0, y.sum(dim=0) / (2.0 * cnt), 0.0)
    return p, cnt, y, valid


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b^T`` of integer operands, as int32: contracted in
    float64, exact while every partial sum stays below 2^53."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64).T).to(
        torch.int32)


def _pad_to(n: int, multiple: int, least: int = 0) -> int:
    return max(least, -(-n // multiple) * multiple)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b^T`` of int8 operands through ``torch._int_mm`` (int32
    accumulation on the tensor cores), bitwise :func:`int_dot`.

    ``_int_mm`` on CUDA wants more than 16 rows and inner and outer sizes
    that are multiples of 8: rows and the contracted axis are padded
    with zero operands, which add nothing, and the result is sliced back.
    Operands must fit int8 (``qh = qr >> 7`` reaches 126, ``ql`` 127).
    """
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int_mm takes int8 operands, got {a.dtype} and "
                         f"{b.dtype}")
    (n, v), (m, v2) = a.shape, b.shape
    if v != v2:
        raise ValueError(f"int_mm: inner sizes differ ({v} vs {v2})")
    vp = _pad_to(v, 8, least=8)
    ap = torch.nn.functional.pad(a, (0, vp - v, 0, _pad_to(n, 8, 24) - n))
    bp = torch.nn.functional.pad(b, (0, vp - v, 0, _pad_to(m, 8, 24) - m))
    return torch._int_mm(ap, bp.t())[:n, :m]



def _prepped_operands(block: torch.Tensor) -> dict[str, torch.Tensor]:
    """Operands ready to contract: ``qr`` split radix-128 into the int8
    halves ``qh``/``ql``."""
    ops = operands(block)
    sq = ops.pop("qr")
    ops["qh"] = (sq >> 7).to(torch.int8)
    ops["ql"] = (sq & 127).to(torch.int8)
    return ops


def _product_spec(products: tuple[str, ...]):
    """product -> weighted operand-pair terms, honoring the int8 split."""
    return {
        p: _INT8_SPLIT.get(p, ((PRODUCT_OPERANDS[p], 1),)) for p in products
    }


def _weighted_products(spec, ops_l, ops_r,
                       dot=int_dot) -> dict[str, torch.Tensor]:
    """name -> sum_w w * (opL @ opR^T), in int32, each term contracted
    by ``dot``."""
    out = {}
    for p, terms in spec.items():
        acc = None
        for (left, right), w in terms:
            prod = dot(ops_l[left], ops_r[right])
            prod = prod * w if w != 1 else prod
            acc = prod if acc is None else acc + prod
        out[p] = acc
    return out


def gram_products(block: torch.Tensor, products: tuple[str, ...],
                  dot=int_dot) -> dict[str, torch.Tensor]:
    """Per-block raw products: int8 operands, int32 (N, N) outputs. Only
    the requested products are contracted (ibs costs exactly four,
    euclidean three); ``dot`` is :func:`int_dot` or :func:`int_mm`."""
    ops = _prepped_operands(block)
    return _weighted_products(_product_spec(products), ops, ops, dot)


def tile_products(block_rows: torch.Tensor, block_cols: torch.Tensor,
                  products: tuple[str, ...],
                  dot=int_dot) -> dict[str, torch.Tensor]:
    """:func:`gram_products` for one (rows, cols) tile of the pair
    matrix: product[p] = opL(rows) @ opR(cols)^T. The same slice for both
    sides reproduces ``gram_products``."""
    return _weighted_products(
        _product_spec(products),
        _prepped_operands(block_rows),
        _prepped_operands(block_cols),
        dot,
    )


# Cross-cohort statistics (out-of-sample projection, cross-kinship): each
# statistic as weighted operand pairs (NEW-cohort operand, REFERENCE
# operand). Unlike the symmetric products, the mirrored pairs (C_n Y_r^T
# and Y_n C_r^T) are not each other's transposes, so each orientation is
# its own contraction. The KING pieces expand H = T1 - T2 and
# X0 = C - T1 with both orientations explicit:
#   hh   = H_n H_r^T                 (het-het co-occurrence)
#   opp  = X0_n T2_r^T + T2_n X0_r^T (opposite homozygotes, both ways)
#   hcn  = H_n C_r^T                 (new-side het over complete pairs)
#   hcr  = C_n H_r^T                 (ref-side het over complete pairs)
# sn / sr are each side's carrier count over pairwise-complete variants
# (the jaccard union is sn + sr - s).
CROSS_STATS: dict[str, tuple[tuple[tuple[str, str], int], ...]] = {
    "m": ((("c", "c"), 1),),
    "d1": ((("y", "c"), 1), (("c", "y"), 1),
           (("t1", "t1"), -2), (("t2", "t2"), -2)),
    "s": ((("t1", "t1"), 1),),
    "hh": ((("t1", "t1"), 1), (("t1", "t2"), -1),
           (("t2", "t1"), -1), (("t2", "t2"), 1)),
    "opp": ((("c", "t2"), 1), (("t1", "t2"), -1),
            (("t2", "c"), 1), (("t2", "t1"), -1)),
    "hcn": ((("t1", "c"), 1), (("t2", "c"), -1)),
    "hcr": ((("c", "t1"), 1), (("c", "t2"), -1)),
    "sn": ((("t1", "c"), 1),),
    "sr": ((("c", "t1"), 1),),
}


def cross_stats(block_new: torch.Tensor, block_ref: torch.Tensor,
                stats: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """Cross-cohort pair statistics over one shared variant block:
    ``block_new`` (A, V) against ``block_ref`` (N, V), the same variants
    in the same order, giving (A, N) int32 statistics that add across
    blocks like the symmetric ones. Every operand is a 0/1 indicator or
    the clipped dosage, so each term is an int8 contraction: the tensor
    cores' :func:`int_mm` on a CUDA device, :func:`int_dot` elsewhere."""
    dot = int_mm if block_new.device.type == "cuda" else int_dot
    return _weighted_products(
        {s: CROSS_STATS[s] for s in stats},
        operands(block_new), operands(block_ref), dot)


def combine_products(prod: dict[str, torch.Tensor],
                     pieces: tuple[str, ...],
                     t=None) -> dict[str, torch.Tensor]:
    """Accumulated raw products -> named pairwise statistics, in integer
    arithmetic (the subtractions are exact):

      ``m``    valid-pair counts            C C^T
      ``s``    shared-alt counts            T1 T1^T
      ``sc``   carrier-by-valid counts      T1 C^T
      ``d1``   Manhattan (sum |a-b|)        YC + YC^T - 2(T1T1 + T2T2)
      ``ibs2`` exact-match counts
      ``dot``  raw-value inner products     YR YR^T
      ``e2``   squared euclidean            QC + QC^T - 2 YR YR^T
      ``hh``   het-het co-occurrence
      ``opp``  opposite homozygotes, both directions
      ``hc``   het-by-valid counts

    ``t(name)``: the transpose of product ``name``; by default
    ``prod[name].T``. A tile of a tiled accumulator passes the mirrored
    tile's transpose instead (``parallel/pcoa_sharded.py``).
    """
    if t is None:
        def t(name):
            return prod[name].T
    out = {}
    for piece in pieces:
        if piece == "m":
            out["m"] = prod["cc"]
        elif piece == "s":
            out["s"] = prod["t1t1"]
        elif piece == "sc":
            out["sc"] = prod["t1c"]
        elif piece == "d1":
            p = prod["t1t1"] + prod["t2t2"]
            out["d1"] = prod["yc"] + t("yc") - 2 * p
        elif piece == "ibs2":
            out["ibs2"] = (
                prod["cc"] - prod["t1c"] - t("t1c")
                + 2 * prod["t1t1"] - prod["t1t2"] - t("t1t2")
                + 2 * prod["t2t2"]
            )
        elif piece == "dot":
            out["dot"] = prod["yy"]
        elif piece == "e2":
            out["e2"] = prod["qc"] + t("qc") - 2 * prod["yy"]
        elif piece == "hh":
            out["hh"] = (
                prod["t1t1"] - prod["t1t2"] - t("t1t2") + prod["t2t2"]
            )
        elif piece == "opp":
            out["opp"] = (
                prod["t2c"] + t("t2c") - prod["t1t2"] - t("t1t2")
            )
        elif piece == "hc":
            out["hc"] = prod["t1c"] - prod["t2c"]
        else:
            raise ValueError(f"unknown gram piece {piece!r}")
    return out
