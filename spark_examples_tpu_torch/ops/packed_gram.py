"""The packed count-family contraction: 2-bit bytes in, int32 products out.

Counterpart of ``spark_examples_tpu/ops/pallas/packed_gram.py``: packed
rows ``(tn, W)`` and cols ``(tm, W)`` uint8 -> ``{product: (tn, tm)
int32}``, decode + mask + contract without materialising a dosage block.

- :func:`fused_tile_products` is the wrapper the gram update calls. For
  CUDA tensors it launches the hand-written kernel ``csrc/packed_gram.cu``
  (built at first use, see ``ops/cuda_build.py``) or raises; for CPU
  tensors, and only for those, it runs :func:`fused_tile_products_plain`.
- :func:`fused_tile_products_plain` is the plain PyTorch version: decode
  per bit plane, contract each plane, sum. The CPU tests hold it against
  the JAX kernel; the chip smoke holds the CUDA kernel against it.
- :func:`contraction_plan` is what a launch computes: the operand pairs
  it contracts and where each lands. When rows and cols are the same
  tensor (the gram update's call) the kernel runs only the tiles with
  I <= J and mirrors each into [J, I] from the plan.
- :func:`launch_plan` is how a launch is cut: its output tile, its sweeps
  over the contractions, and its grid of persistent blocks.

``launches`` counts the CUDA kernel's launches (one per call on CUDA
tensors), so a run can show that its main path went through the kernel;
each launch also counts ``kernel.packed_gram.launches`` in the telemetry
registry, so a job run as a subprocess exports its count in
``metrics.json``, and is timed on its stream by the device span
``kernel.packed_gram.launch`` (read at the next barrier). The counter
``gram.fused_blocks`` keeps the JAX package's meaning instead: one per
block update through the fused lowering
(``parallel/gram_sharded.py::make_update``), whatever the number of
tiles.
"""

from __future__ import annotations

import ctypes

import torch

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.profiling import device_span
from spark_examples_tpu_torch.ops.genotype import PRODUCT_OPERANDS, int_dot

# Operands the 2-bit decode can form; the kernel's operand codes.
_OPERAND_CODES = {"c": 0, "t1": 1, "t2": 2, "y": 3}
_PACKABLE_OPERANDS = frozenset(_OPERAND_CODES)
MAX_PRODUCTS = 7
# The kernel's square output tile and the packed bytes it stages per step
# (TILE and KB in csrc/packed_gram.cu): the edges the tests probe.
TILE = 128
CHUNK_BYTES = 32
# Contractions a sweep (G_MAX in csrc/packed_gram.cu): two m64n128 int32
# accumulator sets are 128 registers a thread.
SWEEP_CONTRACTIONS = 2

launches = 0


def check_fusable(products: tuple[str, ...]) -> None:
    """Raise unless every product's operands decode from 2-bit codes."""
    for p in products:
        ops = PRODUCT_OPERANDS.get(p)
        if ops is None or not set(ops) <= _PACKABLE_OPERANDS:
            raise ValueError(
                f"product {p!r} is not lowerable by the fused packed "
                f"kernel: its operands {ops} are not all 2-bit "
                f"decodable ({sorted(_PACKABLE_OPERANDS)})"
            )


def _plane_operands(packed: torch.Tensor, shift: int, names) -> dict:
    """Decode one bit plane's indicator operands: ``(packed >> shift) & 3``
    holds every 4th variant; c = [code != 3], t1 = [code in {1, 2}],
    t2 = [code == 2], y = t1 + t2."""
    codes = (packed >> shift) & 3
    valid = codes != 3
    t1 = (valid & (codes >= 1)).to(torch.int8)
    t2 = (codes == 2).to(torch.int8)
    ops = {"c": valid.to(torch.int8), "t1": t1, "t2": t2, "y": t1 + t2}
    return {k: ops[k] for k in names}


def fused_tile_products_plain(packed_rows: torch.Tensor,
                              packed_cols: torch.Tensor,
                              products: tuple[str, ...]
                              ) -> dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel: four plane-restricted exact
    contractions per product, summed in int32."""
    products = tuple(products)
    check_fusable(products)
    left = {PRODUCT_OPERANDS[p][0] for p in products}
    right = {PRODUCT_OPERANDS[p][1] for p in products}
    out = {p: None for p in products}
    for shift in (0, 2, 4, 6):
        lops = _plane_operands(packed_rows, shift, left)
        rops = _plane_operands(packed_cols, shift, right)
        for p in products:
            lo, ro = PRODUCT_OPERANDS[p]
            d = int_dot(lops[lo], rops[ro])
            out[p] = d if out[p] is None else out[p] + d
    return out


def contraction_plan(products: tuple[str, ...], symmetric: bool
                     ) -> tuple[tuple[str, str, int, int], ...]:
    """The contractions one launch computes, as ``(left, right, direct,
    mirror)``: the operand pair, the index of the product whose [I, J]
    tile it writes and of the product whose [J, I] tile it writes
    transposed (-1 for none).

    Asymmetric: one contraction per product, no mirror. Symmetric (rows
    and cols are one tensor, only tiles with I <= J run): an (L, L)
    product is its own mirror, and an (L, R) product takes its [J, I]
    tile from the partner contraction (R, L), since
    ``out[j][i] = sum_v L_j R_i``. ibs (cc, yc, t1t1, t2t2) needs 5.
    """
    products = tuple(products)
    check_fusable(products)
    if not symmetric:
        return tuple((*PRODUCT_OPERANDS[p], i, -1)
                     for i, p in enumerate(products))
    plan: dict[tuple[str, str], list[int]] = {}
    for i, p in enumerate(products):
        left, right = PRODUCT_OPERANDS[p]
        plan.setdefault((left, right), [-1, -1])[0] = i
        plan.setdefault((right, left), [-1, -1])[1] = i
    return tuple((lo, ro, d, m) for (lo, ro), (d, m) in plan.items())


def launch_plan(nr: int, nc: int, symmetric: bool, n_contractions: int,
                sms: int) -> dict:
    """How the kernel cuts a launch of ``n_contractions`` over ``nr`` rows
    and ``nc`` columns on a card of ``sms`` SMs (the geometry
    ``csrc/packed_gram.cu::packed_gram_products`` computes).

    The output is cut into ``TILE``-square tiles (the I <= J ones when
    symmetric) and the plan's contractions into consecutive sweeps of at
    most ``SWEEP_CONTRACTIONS``; an item is one (sweep, tile), and a grid
    of at most one block per SM walks the items. A small launch fills the
    card through its sweeps: (2504, 2048 B) ibs is 210 tiles x 3 sweeps.
    Returns ``tile``, ``sweeps`` (tuples of plan indices), ``tiles``,
    ``items`` and ``grid``.
    """
    if nr < 1 or nc < 1 or n_contractions < 1 or sms < 1:
        raise ValueError(f"no launch: nr {nr}, nc {nc}, contractions "
                         f"{n_contractions}, sms {sms}")
    if symmetric and nr != nc:
        raise ValueError(f"a symmetric launch is square, got {nr} x {nc}")
    tiles_r = -(-nr // TILE)
    tiles_c = -(-nc // TILE)
    tiles = tiles_r * (tiles_r + 1) // 2 if symmetric else tiles_r * tiles_c
    sweeps = tuple(
        tuple(range(q, min(q + SWEEP_CONTRACTIONS, n_contractions)))
        for q in range(0, n_contractions, SWEEP_CONTRACTIONS))
    items = tiles * len(sweeps)
    return {"tile": TILE, "sweeps": sweeps, "tiles": tiles,
            "items": items, "grid": min(items, sms)}


def _check_inputs(rows, cols) -> None:
    for name, t in (("packed_rows", rows), ("packed_cols", cols)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8 packed codes, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D (samples, bytes), got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows.shape[1] != cols.shape[1]:
        raise ValueError(
            f"row/col packed widths disagree: {rows.shape[1]} vs "
            f"{cols.shape[1]} bytes"
        )
    if rows.device != cols.device:
        raise ValueError(
            f"packed_rows on {rows.device} but packed_cols on {cols.device}"
        )
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")


def _library():
    from spark_examples_tpu_torch.ops import cuda_build

    lib = cuda_build.load("packed_gram")
    lib.packed_gram_products.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.packed_gram_products.restype = ctypes.c_int
    lib.packed_gram_error_string.argtypes = [ctypes.c_int]
    lib.packed_gram_error_string.restype = ctypes.c_char_p
    return lib


def _launch(rows: torch.Tensor, cols: torch.Tensor,
            products: tuple[str, ...]) -> dict[str, torch.Tensor]:
    global launches
    if len(products) > MAX_PRODUCTS:
        raise ValueError(f"at most {MAX_PRODUCTS} products per launch, got "
                         f"{len(products)}")
    nr, w = rows.shape
    nc = cols.shape[0]
    out = torch.empty((len(products), nr, nc), dtype=torch.int32,
                      device=rows.device)
    if nr == 0 or nc == 0 or not products:
        return {p: out[i] for i, p in enumerate(products)}
    symmetric = rows.data_ptr() == cols.data_ptr() and rows.shape == cols.shape
    plan = contraction_plan(products, symmetric)
    codes = ctypes.c_int * len(plan)
    left = codes(*(_OPERAND_CODES[q[0]] for q in plan))
    right = codes(*(_OPERAND_CODES[q[1]] for q in plan))
    direct = codes(*(q[2] for q in plan))
    mirror = codes(*(q[3] for q in plan))
    lib = _library()
    with torch.cuda.device(rows.device), \
            device_span("kernel.packed_gram.launch", rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.packed_gram_products(
            rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
            nr, nc, w, len(plan), left, right, direct, mirror,
            int(symmetric), stream,
        )
    if rc != 0:
        msg = lib.packed_gram_error_string(rc).decode()
        raise RuntimeError(
            f"packed_gram kernel launch failed: CUDA error {rc} ({msg}) "
            f"at rows {tuple(rows.shape)}, cols {tuple(cols.shape)}, "
            f"products {products}"
        )
    launches += 1
    telemetry.count("kernel.packed_gram.launches")
    return {p: out[i] for i, p in enumerate(products)}


def fused_tile_products(packed_rows: torch.Tensor, packed_cols: torch.Tensor,
                        products: tuple[str, ...]
                        ) -> dict[str, torch.Tensor]:
    """``(tn, W) x (tm, W) uint8 -> {product: (tn, tm) int32}``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Feeding
    the same tensor for both sides gives the full symmetric update (the
    kernel then computes only the tiles with I <= J)."""
    products = tuple(dict.fromkeys(products))
    check_fusable(products)
    _check_inputs(packed_rows, packed_cols)
    if packed_rows.device.type == "cpu":
        return fused_tile_products_plain(packed_rows, packed_cols, products)
    return _launch(packed_rows, packed_cols, products)
