"""Tile2d finalize -> center -> randomized eigh -> coordinates.

Counterpart of the JAX package's ``parallel/pcoa_sharded.py``: every
N x N intermediate stays :class:`~core.meshes.Tiled` from the raw
accumulators to the eigensolve, whose only large operations are the
``B @ Q`` products (each slot multiplies its tile by its columns' rows
of Q; the row blocks are summed on slot 0). The (N, k + p) subspace,
its QR and the small Rayleigh eigh live on slot 0.

Where JAX lets XLA move tiles for the non-elementwise parts, the port
moves them itself:

- a finalize reads a statistic's transpose (``yc + yc^T``, KING's
  ``hc + hc^T``), the diagonal (KING's self-kinship) and the Gower
  transform's ``s_ii + s_jj``. :class:`TileFrame` answers these for slot
  ``(i, j)``: the mirrored block ``X[cols, rows]^T`` of each leaf the
  kernel declares it reads transposed (``kernels.Kernel.transposed``;
  tile ``(j, i)^T`` on a square mesh), the global diagonal entries that
  fall in the tile, and the similarity's diagonal, which
  :func:`_similarity_diagonal` finalizes from the diagonal entries of the
  statistics alone. Every kernel's own finalize then runs unchanged on
  each tile, bitwise the whole-matrix finalize;
- centering takes row, column and grand means across tiles (summed in
  float64), then subtracts per tile; PCA's symmetry guard
  ``0.5 (c + c^T)`` assembles the mirrored block of the similarity.

One path serves every mesh, on one process or spanning the ranks of a
job (``core/meshes.py::process_mesh``): every rank finalizes, centers
and multiplies its own tiles, and what it needs of the others' moves
through ``parallel/multihost.py`` (on one process, device copies):

- the mirrored blocks, in lockstep: at step ``l`` every rank fetches
  those of its ``l``-th slot, point to point across ranks;
- the similarity's diagonal and the trace from the ranks that hold the
  diagonal tiles;
- per-tile float64 row and column sums gathered on every rank, and the
  per-tile ``B @ Q`` row blocks gathered on rank 0, each added **in slot
  order**, the one-process order;
- the (N, k + p) subspace, its QR and the small Rayleigh eigh run on
  rank 0 alone (:func:`solve_on_rank0`), the others serving its
  products; its results are broadcast, so no rank can drift. Every
  product takes ``Q`` row-major on every rank: the QR's ``Q`` is
  column-major and a peer's received copy is not, and on the card cuBLAS
  sums the two layouts in different orders.

So every rank holds the bits of the one-process tiled run.
"""

from __future__ import annotations

import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core.config import (
    EIGH_ITERS_DEFAULT,
    EIGH_OVERSAMPLE_DEFAULT,
)
from spark_examples_tpu_torch.core.meshes import Tiled
from spark_examples_tpu_torch.core.profiling import (
    PhaseTimer,
    check_nans,
    hard_sync,
)
from spark_examples_tpu_torch.models.pca import PCAResult
from spark_examples_tpu_torch.models.pcoa import PCoAResult
from spark_examples_tpu_torch.ops import distances, gram
from spark_examples_tpu_torch.ops.eigh import (
    coords_from_eigpairs,
    init_probes,
    randomized_eigh,
)
from spark_examples_tpu_torch.parallel import multihost as mh
from spark_examples_tpu_torch.parallel.gram_sharded import GramPlan
from spark_examples_tpu_torch.solvers.sketch import ieee_f32


class TileFrame(kernels.Frame):
    """The frame of slot ``s``'s tile (rows ``[r0, r1)``, columns
    ``[c0, c1)``) of the tiled accumulators ``acc``: see the module
    docstring. ``mirror``: the mirrored blocks ``X[cols, rows]^T`` of the
    leaves the kernel reads transposed; ``sim_diag``: the similarity's
    whole diagonal, where the kernel forms the Gower distance."""

    def __init__(self, acc: dict, metric: str, s: int, mirror: dict,
                 sim_diag: torch.Tensor | None):
        leaf = next(v for v in acc.values() if isinstance(v, Tiled))
        self.metric = metric
        self.r0, self.r1, self.c0, self.c1 = leaf.spans(s)
        self.device = leaf.mesh.devices[s]
        self.prod = {k: (v.tiles[s] if isinstance(v, Tiled)
                         else v.to(self.device)) for k, v in acc.items()}
        self.mirror = mirror
        self._stats_t = None
        self._sim_diag = sim_diag

    def t_product(self, name: str) -> torch.Tensor:
        return self.mirror[name]

    def t(self, stats: dict, name: str) -> torch.Tensor:
        if self._stats_t is None:
            # The statistics of the mirrored block, whose own mirror is
            # this tile: their transpose restricted to this tile.
            self._stats_t = gram.combine(self.mirror, self.metric,
                                         self.prod.__getitem__)
        return self._stats_t[name]

    def fill_diagonal(self, x: torch.Tensor, value: float) -> torch.Tensor:
        lo, hi = max(self.r0, self.c0), min(self.r1, self.c1)
        if lo < hi:
            g = torch.arange(lo, hi, device=x.device)
            x[g - self.r0, g - self.c0] = value
        return x

    def gower(self, sim: torch.Tensor) -> torch.Tensor:
        if self._sim_diag is None:
            raise ValueError(
                f"metric {self.metric!r} forms the Gower distance without "
                "declaring it (kernels.Kernel.gower)")
        dr = self._sim_diag[self.r0:self.r1].to(sim.device)
        dc = self._sim_diag[self.c0:self.c1].to(sim.device)
        # ops.distances.similarity_to_distance, elementwise the same.
        d2 = torch.clamp(dr[:, None] + dc[None, :] - 2.0 * sim, min=0.0)
        return torch.sqrt(d2.to(torch.float64)).to(d2.dtype)


class _DiagonalFrame(kernels.Frame):
    """The frame of a (1, L) row of DIAGONAL entries: every entry is its
    own transpose and lies on the diagonal."""

    def t_product(self, name: str) -> torch.Tensor:
        return self.prod[name]

    def t(self, stats: dict, name: str) -> torch.Tensor:
        return stats[name]

    def fill_diagonal(self, x: torch.Tensor, value: float) -> torch.Tensor:
        return x.fill_(value)

    def gower(self, sim):
        return None


def _similarity_diagonal(acc: dict, metric: str) -> torch.Tensor:
    """The finalized similarity's diagonal (N,), on this rank's first
    slot: each stretch of the global diagonal finalized from the
    statistics' diagonal entries in the tile that holds it (across
    ranks by the rank that holds it, then shared)."""
    leaf = next(v for v in acc.values() if isinstance(v, Tiled))
    mesh = leaf.mesh
    parts = []
    for s, rows, cols in leaf.diagonal_spans():
        sim = None
        if mesh.is_local(s):
            frame = _DiagonalFrame()
            frame.prod = {
                k: (torch.diagonal(v.tiles[s][rows, cols])[None, :]
                    if isinstance(v, Tiled) else v.to(mesh.devices[s]))
                for k, v in acc.items()}
            out = distances.finalize(frame.prod, metric, frame)
            sim = out["similarity"][0].to(mesh.home)
        parts.append(mh.from_owner(mesh, sim, mesh.owner(s),
                                   (rows.stop - rows.start,), torch.float32,
                                   mesh.home))
    return torch.cat(parts)


def _mirror_walk(like: Tiled, leaves: dict):
    """``(slot, {key: X[cols, rows]^T})`` of the tiled ``leaves`` (laid
    out as ``like``) for this rank's slots, in lockstep across the ranks:
    at step ``l`` every rank fetches the mirrored blocks of its ``l``-th
    slot (``multihost.regions``), one tile's worth held at a time."""
    mesh = like.mesh
    for l, s in enumerate(mesh.local_slots):
        wanted = []
        for rank in range(mesh.processes):
            slot = mesh.slots_of(rank)[l]
            r0, r1, c0, c1 = like.spans(slot)
            wanted.append((slot, (c0, c1, r0, r1)))
        yield s, {k: mh.regions(v, wanted)[s].T
                  for k, v in sorted(leaves.items())}


def finalize_tiles(plan: GramPlan, acc: dict, metric: str,
                   fields: tuple[str, ...]) -> dict[str, Tiled]:
    """Tiled accumulators -> the finalized matrices named in ``fields``
    (``"distance"``, ``"similarity"``), tiled the same way, from one
    pass over the tiles; bitwise the whole-matrix finalize's tiles.
    Across ranks every rank calls this together."""
    leaf = next(v for v in acc.values() if isinstance(v, Tiled))
    mesh = leaf.mesh
    kern = kernels.get(metric)
    # A collective across ranks: taken before the walk.
    diag = _similarity_diagonal(acc, metric) if kern.gower else None
    tiles: dict[str, list] = {f: [None] * mesh.size for f in fields}
    for s, mirror in _mirror_walk(leaf, {k: acc[k]
                                         for k in kern.transposed}):
        frame = TileFrame(acc, metric, s, mirror, diag)
        out = distances.finalize(frame.prod, metric, frame)
        for f in fields:
            tiles[f][s] = out[f]
    return {f: Tiled(mesh, leaf.shape, t) for f, t in tiles.items()}


def _means(x: Tiled):
    """Row means (n,), column means (m,) and the grand mean of a tiled
    matrix: per-tile sums in float64, added in slot order (across ranks
    gathered on every rank first), returned in its dtype on this rank's
    first slot."""
    n, m = x.shape
    home = x.mesh.home
    row_sums, col_sums = [], []
    for _, t in x.local():
        t64 = t.to(torch.float64)  # one float64 tile at a time
        row_sums.append(t64.sum(dim=1).to(home))
        col_sums.append(t64.sum(dim=0).to(home))
        del t64
    rows = mh.gather_slots(x.mesh, torch.stack(row_sums))
    cols = mh.gather_slots(x.mesh, torch.stack(col_sums))
    row = torch.zeros(n, dtype=torch.float64, device=home)
    col = torch.zeros(m, dtype=torch.float64, device=home)
    for s in range(x.mesh.size):
        r0, r1, c0, c1 = x.spans(s)
        row[r0:r1] += rows[s]
        col[c0:c1] += cols[s]
    grand = row.sum() / (n * m)
    return row.div(m).to(x.dtype), col.div(n).to(x.dtype), grand.to(x.dtype)


def center_tiles(a: Tiled) -> Tiled:
    """J A J per tile: subtract the row and column means, add the grand
    mean (``ops.centering.center_matrix``)."""
    row, col, grand = _means(a)

    def center(t, s):
        r0, r1, c0, c1 = a.spans(s)
        dev = t.device
        return (t - row[r0:r1, None].to(dev) - col[None, c0:c1].to(dev)
                + grand.to(dev))

    return a.map(center)


def gower_center_tiles(distance: Tiled) -> Tiled:
    """B = -1/2 J D^2 J (``ops.centering.gower_center``), tiled."""
    return center_tiles(distance.map(lambda t, s: t * t)).map(
        lambda t, s: -0.5 * t)


def center_sym_tiles(sim: Tiled) -> Tiled:
    """PCA centering: the symmetrized ``0.5 (c + c^T)`` of ``c = J S J``
    (``models/pca.fit_pca``'s form), the transpose taken from the
    mirrored block of ``S``."""
    row, col, grand = _means(sim)
    mesh = sim.mesh
    tiles = [None] * mesh.size
    for s, mirror in _mirror_walk(sim, {"s": sim}):
        mirror = mirror["s"]
        t = sim.tiles[s]
        r0, r1, c0, c1 = sim.spans(s)
        dev = t.device
        c = (t - row[r0:r1, None].to(dev) - col[None, c0:c1].to(dev)
             + grand.to(dev))
        ct = (mirror - row[None, c0:c1].to(dev) - col[r0:r1, None].to(dev)
              + grand.to(dev))
        tiles[s] = 0.5 * (c + ct)
    return Tiled(mesh, sim.shape, tiles)


def tiled_matmul(b: Tiled, q: torch.Tensor) -> torch.Tensor | None:
    """``B @ Q`` of a tiled (N, N) matrix and an (N, p) block: each slot
    multiplies its tile by its columns' rows of Q (row-major on every
    rank: the module docstring), and the row blocks are summed in slot
    order (the JAX route's psum over ``j``) on this rank's first slot.
    Across ranks every rank calls it with rank 0's ``q``, and a failure
    on any rank raises on every rank in one vote before the gather; the
    blocks are gathered and summed on rank 0, which alone gets the
    product (the others None)."""
    mesh = b.mesh
    home = mesh.home
    q = q.contiguous()
    error = None
    try:
        blocks = torch.stack([(t @ q[c0:c1].to(t.device)).to(home)
                              for (s, t), (_, _, c0, c1)
                              in zip(b.local(), map(b.spans,
                                                    mesh.local_slots))])
    except Exception as e:  # every rank learns of it in the vote
        error = e
    mh.vote_all_ok(error is None, lambda bad: RuntimeError(
        f"the tiled B @ Q product failed on rank(s) {bad} — see their "
        "logs"))
    if error is not None:
        raise error
    by_slot = mh.gather_slots(mesh, blocks, dst=0)
    if by_slot is None:
        return None
    out = torch.zeros((b.shape[0], q.shape[1]), dtype=q.dtype, device=home)
    for s, block in enumerate(by_slot):
        r0, r1, _, _ = b.spans(s)
        out[r0:r1] += block
    return out


def solve_on_rank0(b: Tiled, fn):
    """``fn(op)`` with ``op(q) = B @ q`` (:func:`tiled_matmul`), its
    result a tuple of tensors, run on rank 0 while the other ranks serve
    its products (each call: ``q`` sent from rank 0, every rank's tile
    blocks gathered on rank 0); rank 0's results are then broadcast, so
    every rank returns rank 0's bits (on one process: a plain call). A
    failure inside a product raises on every rank through its vote; one
    elsewhere on rank 0 is sent to the others, which raise too."""
    mesh = b.mesh
    home = mesh.home
    if mesh.rank == 0:
        in_product = []

        def op(q):
            in_product.append(True)
            mh.broadcast_object(mesh, ("op", tuple(q.shape), q.dtype))
            mh.from_owner(mesh, q, 0, q.shape, q.dtype, home)
            out = tiled_matmul(b, q)
            in_product.pop()
            return out

        try:
            out = tuple(fn(op))
        except Exception as e:
            if not in_product:  # the serving ranks wait for a message
                mh.broadcast_object(mesh, ("error",
                                           f"{type(e).__name__}: {e}"))
            raise
        mh.broadcast_object(mesh, ("done", [(tuple(t.shape), t.dtype)
                                            for t in out]))
        return tuple(mh.from_owner(mesh, t, 0, t.shape, t.dtype, home)
                     for t in out)
    while True:
        msg = mh.broadcast_object(mesh, None)
        if msg[0] == "op":
            _, shape, dtype = msg
            tiled_matmul(b, mh.from_owner(mesh, None, 0, shape, dtype,
                                          home))
        elif msg[0] == "done":
            return tuple(mh.from_owner(mesh, None, 0, shape, dtype, home)
                         for shape, dtype in msg[1])
        else:
            raise RuntimeError(
                f"the sharded eigensolve failed on rank 0: {msg[1]}")


def assert_tiled(x, plan: GramPlan, what: str) -> None:
    """Assert an N x N stage output is genuinely tiled: every slot holds
    a proper tile, never the full matrix."""
    if plan.mesh.size == 1:
        return  # one slot: tiling is vacuous
    if not isinstance(x, Tiled):
        raise AssertionError(
            f"{what}: a whole {tuple(x.shape)} leaf on {x.device}, want "
            "one tile per slot — a full-size leaf landed on one device")
    n, m = x.shape
    want = (n // plan.mesh.shape[0], m // plan.mesh.shape[1])
    for _, t in x.local():
        if tuple(t.shape) != want:
            raise AssertionError(
                f"{what}: shard on {t.device} has shape {tuple(t.shape)}, "
                f"want tile {want} — a full-size leaf landed on one device")


_CENTER = {"gower": gower_center_tiles, "pca": center_sym_tiles}


def default_probes(n: int, p: int) -> torch.Tensor:
    """The sharded solve's cold-start probes: (N, min(p, N)) Gaussian
    draws from a CPU ``torch.Generator`` seeded 0 (the same on the CPU
    and the card). Not the JAX package's ``jax.random.key(0)`` draws:
    tests comparing the two routes patch JAX's probes in here."""
    return init_probes(n, p, torch.Generator("cpu").manual_seed(0))


def _as_tiled(plan: GramPlan, acc: dict) -> dict:
    """A one-slot plan's whole leaves as one-tile ``Tiled`` leaves, so the
    sharded route runs on it unchanged (as the JAX route does on a (1, 1)
    mesh)."""
    if plan.mesh.size > 1:
        return acc
    return {k: (Tiled(plan.mesh, v.shape, [v])
                if isinstance(v, torch.Tensor) and v.dim() == 2 else v)
            for k, v in acc.items()}


@ieee_f32()
def _solve_sharded(plan, acc, metric, field, center_kind, k, probes,
                   oversample, iters, select, with_trace, check_shardings,
                   timer):
    """The stages both routes share: finalize -> center -> randomized
    eigh, tile-asserted at each boundary. Probes default to a CPU
    ``torch.Generator`` seeded 0 (the JAX route's come from
    ``jax.random.key(0)``; pass them in to compare)."""
    if timer is None:
        timer = PhaseTimer()
    home = plan.mesh.home
    acc = _as_tiled(plan, acc)
    with timer.phase("finalize"):
        mat = finalize_tiles(plan, acc, metric, (field,))[field]
        if check_shardings:
            assert_tiled(mat, plan, f"finalize {field}")
        b = hard_sync(_CENTER[center_kind](mat))
        del mat
    if check_shardings:
        assert_tiled(b, plan, f"{center_kind}-centered matrix")
    check_nans("centering", b)
    with timer.phase("eigh"):
        n = b.shape[0]
        if probes is None:
            probes = default_probes(n, k + oversample)
        trace = (mh.tiled_diagonal(b, home).sum() if with_trace
                 else None)
        vals, vecs = solve_on_rank0(b, lambda op: randomized_eigh(
            op, k, probes=probes.to(device=home, dtype=torch.float32),
            iters=iters, select=select))
        hard_sync((vals, vecs, trace))
    check_nans("eigh", vals, vecs)
    return vals, vecs, trace


def pcoa_coords_sharded(plan: GramPlan, acc: dict, metric: str, k: int = 10,
                        probes: torch.Tensor | None = None,
                        oversample: int = EIGH_OVERSAMPLE_DEFAULT,
                        iters: int = EIGH_ITERS_DEFAULT,
                        check_shardings: bool = True,
                        timer=None) -> PCoAResult:
    """Tiled accumulators -> PCoA coordinates with no full N x N leaf on
    any slot: finalize -> gower_center -> top-k randomized eigh ->
    coordinates, the dense route stage for stage (tensors on slot 0)."""
    vals, vecs, trace = _solve_sharded(
        plan, acc, metric, "distance", "gower", k, probes, oversample,
        iters, "top", True, check_shardings, timer)
    coords = coords_from_eigpairs(vals, vecs)
    prop = torch.clamp(vals, min=0.0) / torch.clamp(trace, min=1e-30)
    return PCoAResult(coords, vals, prop)


def pca_coords_sharded(plan: GramPlan, acc: dict,
                       metric: str = "shared-alt", k: int = 10,
                       probes: torch.Tensor | None = None,
                       oversample: int = EIGH_OVERSAMPLE_DEFAULT,
                       iters: int = EIGH_ITERS_DEFAULT,
                       check_shardings: bool = True,
                       timer=None) -> PCAResult:
    """Tiled accumulators -> PCA coordinates with no full N x N leaf on
    any slot: finalize the similarity -> center and symmetrize ->
    top-|lambda| randomized eigh -> coords = v * lambda
    (``models/pca.fit_pca`` stage for stage)."""
    vals, vecs, _ = _solve_sharded(
        plan, acc, metric, "similarity", "pca", k, probes, oversample,
        iters, "abs", False, check_shardings, timer)
    return PCAResult(vecs * vals[None, :], vals)
