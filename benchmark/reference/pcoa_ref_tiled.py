"""The plain reference of an IBS PCoA job whose N x N state does not fit
one card, worked out again from the cohort's 2-bit bytes over a (2, 2)
grid of tiles, one a device.

The arithmetic of ``pcoa_ref.py`` (its frozen ``unpack_2bit``,
``int_gemm`` and ``ibs_distance``, imported), laid out as tiles:

- tile ``(i, j)`` holds rows ``[b_i, b_{i+1})`` and columns
  ``[b_j, b_{j+1})`` of every N x N matrix, on device ``2 i + j``;
- its pair counts ``d1`` and ``m`` are contracted from the unpacked
  operands of its row samples and its column samples, exact int32;
- the distance ``d1 / (2 m)`` in float64, a band of rows at a time;
- Gower centering ``B = -1/2 J D^2 J`` with float64 row, column and
  grand means summed across the tiles;
- the top-k eigenpairs of ``B`` by block Lanczos with full
  reorthogonalisation in float64 (:func:`block_lanczos`), run until
  every one of the k Ritz pairs has ``||B y - theta y|| <= TOL lam_1``,
  within ``MAX_BASIS`` basis vectors (past that it raises).

``TiledReference.b`` has ``shape``, ``device`` and ``@`` (a float64
product tile by tile, summed on the first device): all that
``compare.judge`` reads. Everything after the counts is float64, TF32
off. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.pcoa_ref import (
    CHUNK_VARIANTS,
    ibs_distance,
    int_gemm,
    unpack_2bit,
)

GRID = 2
# Rows a step of the distance and the centering (float64 temporaries of
# this many rows of a tile).
BAND_ROWS = 4096
# Block Lanczos: block width, the largest basis, how often the Ritz
# pairs are checked (in blocks), and the residual each of the top k has
# to reach, relative to the largest Ritz value.
BLOCK = 32
MAX_BASIS = 6144
CHECK_EVERY = 8
TOL = 1e-9


def bounds(n: int) -> list[int]:
    """Row (and column) boundaries of the grid's tiles."""
    return [n * g // GRID for g in range(GRID + 1)]


class TiledMatrix:
    """A symmetric (N, N) float64 matrix held as ``GRID x GRID`` tiles,
    ``tiles[(i, j)]`` on its own device."""

    def __init__(self, tiles: dict, n: int, home: torch.device):
        self.tiles = tiles
        self.edges = bounds(n)
        self.shape = (n, n)
        self.device = home

    def spans(self, i: int, j: int) -> tuple[int, int, int, int]:
        e = self.edges
        return e[i], e[i + 1], e[j], e[j + 1]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        """``B @ x`` for an (N, p) ``x``, in float64 on ``device``."""
        x = x.to(self.device, torch.float64)
        out = torch.zeros(x.shape, dtype=torch.float64, device=self.device)
        for (i, j), t in self.tiles.items():
            r0, r1, c0, c1 = self.spans(i, j)
            out[r0:r1] += (t @ x[c0:c1].to(t.device)).to(self.device)
        return out


def _operands(g: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(c, y, t1, t2)`` int8 indicators of (n, v) dosages."""
    c = (g >= 0).to(torch.int8)
    t1 = (g >= 1).to(torch.int8)
    t2 = (g >= 2).to(torch.int8)
    return c, t1 + t2, t1, t2


def tile_counts(packed: np.ndarray, devices: list) -> tuple[dict, dict]:
    """``(d1, m)``: dicts of (i, j) -> int32 tiles of the pair counts,
    each on ``devices[GRID i + j]``, from the host's (N, W) 2-bit
    bytes."""
    n = packed.shape[0]
    e = bounds(n)
    tiles = [(i, j) for i in range(GRID) for j in range(GRID)]
    dev = {t: torch.device(devices[GRID * t[0] + t[1]]) for t in tiles}
    d1 = {t: torch.zeros((e[t[0] + 1] - e[t[0]], e[t[1] + 1] - e[t[1]]),
                         dtype=torch.int32, device=dev[t]) for t in tiles}
    m = {t: torch.zeros_like(d1[t]) for t in tiles}
    step = CHUNK_VARIANTS // 4
    for lo in range(0, packed.shape[1], step):
        hi = min(lo + step, packed.shape[1])
        bands = [torch.from_numpy(np.array(
            packed[e[g]:e[g + 1], lo:hi])) for g in range(GRID)]
        for t in tiles:
            c, y, t1, t2 = _operands(unpack_2bit(bands[t[0]].to(dev[t])))
            if t[0] == t[1]:
                cc, yc, t1c, t2c = c, y, t1, t2
            else:
                cc, yc, t1c, t2c = _operands(unpack_2bit(
                    bands[t[1]].to(dev[t])))
            left = torch.cat([y, c, t1, t2], dim=1)
            right = torch.cat([cc, yc, -2 * t1c, -2 * t2c], dim=1)
            d1[t] += int_gemm(left, right)
            del left, right, y, t1, t2, yc, t1c, t2c
            m[t] += int_gemm(c, cc)
            del c, cc
    return d1, m


def gower_tiles(d1: dict, m: dict, n: int, home: torch.device) -> dict:
    """``B = -1/2 J D^2 J`` as float64 tiles from the count tiles: ``D``
    from :func:`ibs_distance` and squared a band of rows at a time, the
    row, column and grand means of ``D^2`` summed across the tiles."""
    e = bounds(n)
    b = {}
    for t in d1:
        out = torch.empty(d1[t].shape, dtype=torch.float64,
                          device=d1[t].device)
        for r in range(0, out.shape[0], BAND_ROWS):
            d = ibs_distance(d1[t][r:r + BAND_ROWS], m[t][r:r + BAND_ROWS])
            out[r:r + BAND_ROWS] = d * d
        b[t] = out
    rows = torch.zeros(n, dtype=torch.float64, device=home)
    cols = torch.zeros(n, dtype=torch.float64, device=home)
    for (i, j), t in b.items():
        rows[e[i]:e[i + 1]] += t.sum(dim=1, dtype=torch.float64).to(home)
        cols[e[j]:e[j + 1]] += t.sum(dim=0, dtype=torch.float64).to(home)
    grand = rows.sum() / (n * n)
    rows, cols = rows / n, cols / n
    for (i, j), t in b.items():
        row = rows[e[i]:e[i + 1], None].to(t.device)
        col = cols[None, e[j]:e[j + 1]].to(t.device)
        g = grand.to(t.device)
        for r in range(0, t.shape[0], BAND_ROWS):
            band = t[r:r + BAND_ROWS]
            band.sub_(row[r:r + BAND_ROWS]).sub_(col).add_(g).mul_(-0.5)
    return b


def block_lanczos(op, n: int, k: int, device, block: int = BLOCK,
                  max_basis: int = MAX_BASIS,
                  check_every: int = CHECK_EVERY):
    """The top-``k`` eigenpairs of the symmetric operator ``op`` (an
    (N, p) float64 block to ``B @`` it), descending: block Lanczos from a
    seeded random block, each new block orthogonalised twice against the
    whole basis, and a Rayleigh-Ritz solve of ``V^T B V`` every
    ``check_every`` blocks. Returns ``(vals, vecs, residuals, basis
    size)`` once every top-k residual is at most ``TOL`` times the
    largest Ritz value; raises past ``max_basis`` vectors."""
    gen = torch.Generator().manual_seed(0)
    cap = min(max_basis, n)
    v = torch.zeros((n, cap), dtype=torch.float64, device=device)
    bv = torch.zeros_like(v)
    q, _ = torch.linalg.qr(torch.randn((n, min(block, cap)), generator=gen,
                                       dtype=torch.float64).to(device))
    size, blocks = 0, 0
    while True:
        w = op(q)
        v[:, size:size + q.shape[1]] = q
        bv[:, size:size + q.shape[1]] = w
        size += q.shape[1]
        blocks += 1
        if blocks % check_every == 0 or size == cap:
            vals, vecs, res = _ritz(v[:, :size], bv[:, :size], k)
            if res.max() <= TOL * vals[0]:
                return vals, vecs, res, size
            if size == cap:
                raise RuntimeError(
                    f"block Lanczos: the top-{k} residuals reached "
                    f"{float(res.max() / vals[0]):.3e} lam_1, not {TOL:.0e}, "
                    f"within {size} basis vectors")
        basis = v[:, :size]
        for _ in range(2):
            w = w - basis @ (basis.T @ w)
        q, _ = torch.linalg.qr(w[:, :cap - size])


def _ritz(v: torch.Tensor, bv: torch.Tensor, k: int):
    """The top-``k`` Ritz pairs of the basis ``v`` (with ``bv = B v``),
    descending, and their residual norms."""
    t = v.T @ bv
    theta, s = torch.linalg.eigh(0.5 * (t + t.T))
    s = s[:, -k:].flip(1)
    theta = theta[-k:].flip(0)
    vecs = v @ s
    res = (bv @ s - vecs * theta).norm(dim=0)
    return theta, vecs, res


def devices_for(device) -> list[torch.device]:
    """The grid's devices: a card a tile on ``cuda`` (the first
    ``GRID**2`` visible), every tile on the one device otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", g) for g in range(GRID * GRID)]
    return [device] * (GRID * GRID)


class TiledReference:
    """The reference's centered matrix (tiled) and top eigenpairs of a
    cohort; with ``keep_counts`` the exact count tiles stay for the
    control."""

    def __init__(self, packed: np.ndarray, k: int, devices: list,
                 keep_counts: bool = False):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            n = packed.shape[0]
            home = torch.device(devices[0])
            d1, m = tile_counts(packed, devices)
            self.b = TiledMatrix(gower_tiles(d1, m, n, home), n, home)
            if keep_counts:
                self.d1, self.m = d1, m
            del d1, m
            (self.vals, _, self.residuals,
             self.basis_size) = block_lanczos(self.b.__matmul__, n, k, home)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
