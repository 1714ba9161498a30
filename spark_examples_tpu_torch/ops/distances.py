"""Distance / similarity finalization of the accumulated gram products,
and the Bray-Curtis table metric (not a bilinear form, so it has its own
lowerings instead of the gram accumulator)."""

from __future__ import annotations

import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import config
from spark_examples_tpu_torch.core.profiling import check_nans
from spark_examples_tpu_torch.ops import gram


def finalize(acc: dict, metric: str, frame=None) -> dict[str, torch.Tensor]:
    """Raw-product accumulators -> {"similarity", "distance"} (N, N) f32:
    the integer-exact combine, then the kernel's declared finalize (e.g.
    ibs: ``distance = d1 / (2m)`` over pairwise-complete variants,
    zero-overlap pairs -> distance 0). ``frame``: where the accumulators
    are one tile of a tiled matrix (``parallel/pcoa_sharded.py``), the
    frame answering for the other tiles; None for a whole matrix."""
    kern = kernels.get(metric)
    if kern.finalize is None:
        raise ValueError(
            f"metric {metric!r} has no gram finalize (a {kern.family}-"
            "family kernel); gram-finalizable kernels: "
            f"{' | '.join(kernels.gram_names())}"
        )
    if frame is None:
        out = kern.finalize(gram.combine(acc, metric))
    else:
        out = kern.finalize(gram.combine(acc, metric, frame.t_product),
                            frame)
    check_nans("finalize", out)
    return out


def similarity_to_distance(s: torch.Tensor) -> torch.Tensor:
    """Gower transform: d_ij = sqrt(s_ii + s_jj - 2 s_ij) (>= 0 for PSD s).

    The square root is taken in float64 and rounded once to the input's
    type, which is the correctly rounded f32 root: PyTorch's vectorised
    f32 ``sqrt`` on the CPU is not (it differs in the last bit)."""
    diag = torch.diagonal(s)
    d2 = torch.clamp(diag[:, None] + diag[None, :] - 2.0 * s, min=0.0)
    return torch.sqrt(d2.to(torch.float64)).to(d2.dtype)


def pairwise_manhattan(x: torch.Tensor, row_tile: int = 128,
                       feat_tile: int = 128) -> torch.Tensor:
    """Blocked ``sum_f |x_i - x_j|``: (N, F) -> (N, N) f32.

    Double-tiled so peak memory is ``row_tile * N * feat_tile`` elements
    whatever F is; each feature chunk's partial sum is added into the
    row block's accumulator in feature order. The plain version of the
    Manhattan CUDA kernel (``ops/braycurtis_kernel.py``). Zero padding of
    N and F adds ``|0 - 0| = 0``.
    """
    n, f = x.shape
    n_pad = -(-n // row_tile) * row_tile
    f_pad = -(-f // feat_tile) * feat_tile
    xp = torch.nn.functional.pad(x.to(torch.float32),
                                 (0, f_pad - f, 0, n_pad - n))
    out = torch.empty((n_pad, n_pad), dtype=torch.float32, device=x.device)
    for r0 in range(0, n_pad, row_tile):
        acc = out[r0:r0 + row_tile]
        acc.zero_()
        for f0 in range(0, f_pad, feat_tile):
            a = xp[r0:r0 + row_tile, f0:f0 + feat_tile]
            b = xp[:, f0:f0 + feat_tile]
            diff = a[:, None, :] - b[None, :, :]
            acc += diff.abs_().sum(-1)
    return out[:n, :n]


def bc_from_manhattan(num: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """Shared Bray-Curtis finalization: Manhattan numerator + row totals
    -> BC matrix, ``num / (totals_i + totals_j)``. Pins the zero-total
    pair -> 0 convention once for every lowering."""
    den = totals[:, None] + totals[None, :]
    return torch.where(den > 0, num / den, 0.0)


def braycurtis(x: torch.Tensor, row_tile: int = 128,
               feat_tile: int = 128) -> torch.Tensor:
    """Bray-Curtis dissimilarity on a nonnegative (N, F) abundance table:
    ``BC_ij = sum_f |x_i - x_j| / sum_f (x_i + x_j)``, zero-total pairs 0.
    The exact lowering."""
    num = pairwise_manhattan(x, row_tile=row_tile, feat_tile=feat_tile)
    return bc_from_manhattan(num, x.to(torch.float32).sum(dim=1))


def braycurtis_matmul(x: torch.Tensor, levels: int = 256,
                      precise: bool = False) -> torch.Tensor:
    """Bray-Curtis via threshold-decomposed matrix products.

    The min-sum is not bilinear, but its threshold decomposition is:
    ``min(a, b) = sum_t w_t [a >= v_t] [b >= v_t]``. Per-feature
    normalisation to [0, 1] puts every feature on a shared ``levels``-point
    grid, with the per-feature scale folded symmetrically into the
    indicators as ``sqrt(scale / levels)``; then ``BC = (den - 2 minsum) /
    den`` with ``den = totals_i + totals_j``.

    Quantisation error per feature is at most ``scale_f / (2 levels)``
    (exact when each feature takes at most ``levels`` evenly spaced
    values). The folded weights are rounded to bf16 unless ``precise``;
    the products accumulate in f32 (bf16 values are exact in f32, so the
    f32 product of the rounded operands is the bf16 product with f32
    accumulation).
    """
    if levels < 1:
        raise ValueError(f"braycurtis levels must be >= 1, got {levels}")
    x = torch.clamp(x.to(torch.float32), min=0.0)
    n, f = x.shape
    scale = x.amax(dim=0)
    xn = torch.where(scale > 0, x / torch.clamp(scale, min=1e-30), 0.0)
    sw = torch.sqrt(scale / levels)
    if not precise:
        sw = sw.to(torch.bfloat16).to(torch.float32)

    # CHUNK thresholds per product: K = F * chunk. The grid is padded to
    # a chunk multiple with sentinel thresholds > 1 whose indicators are
    # identically zero, so a ragged tail contributes 0.
    chunk = max(1, min(8, levels))
    n_iters = -(-levels // chunk)
    thr_grid = (torch.arange(n_iters * chunk, dtype=torch.float32,
                             device=x.device) + 0.5) / levels
    thr_grid = torch.where(thr_grid < 1.0, thr_grid, 2.0)
    minsum = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    for c in range(n_iters):
        thr = thr_grid[c * chunk:(c + 1) * chunk]
        a = (xn[:, :, None] >= thr[None, None, :]).to(torch.float32)
        a = (a * sw[None, :, None]).reshape(n, f * chunk)
        minsum += a @ a.T
    totals = x.sum(dim=1)
    den = totals[:, None] + totals[None, :]
    num = torch.clamp(den - 2.0 * minsum, min=0.0)
    return bc_from_manhattan(num, totals)


def resolve_braycurtis_method(requested: str, device: torch.device) -> str:
    """Resolve ``--braycurtis-method`` to the lowering actually run:
    ``auto`` is the CUDA kernel on a CUDA device and ``exact`` on the CPU.
    An explicit ``fused`` on the CPU raises, naming the flag: there is no
    CUDA kernel to launch there."""
    device = torch.device(device)
    if requested == "auto":
        return "fused" if device.type == "cuda" else "exact"
    if requested == "fused" and device.type != "cuda":
        raise ValueError(
            "--braycurtis-method fused launches the Manhattan CUDA kernel, "
            f"but the job runs on {device} — use --device cuda, or "
            "--braycurtis-method auto|exact|matmul"
        )
    if requested in config.BRAYCURTIS_METHODS:
        return requested
    raise ValueError(f"unknown braycurtis method {requested!r}")
