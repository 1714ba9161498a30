"""Mesh-sharded gram accumulation, with the collectives as tensor moves.

Counterpart of the JAX package's ``parallel/gram_sharded.py``. One
process drives every slot of its mesh (``core/meshes.py``); where JAX's
``shard_map`` body runs once per device, the port loops over the slots
and launches each slot's work on that slot's device. The modes:

- **replicated** (a ``(1, 1)`` mesh): the single-device update.
- **variant**: each slot takes one variant shard of the block and
  computes the full N x N partial of it; the partials are summed into
  the accumulators on slot 0's device (the ``psum``). The count family
  runs K1 per slot here (symmetric launches on a shard): the JAX
  package refuses ``fused`` in multi-device variant mode only because
  XLA cannot split one ``pallas_call`` across chips, and the port's SPMD
  is explicit.
- **tile2d**: the N x N accumulators are :class:`~core.meshes.Tiled`,
  slot ``(i, j)`` holding rows ``[i tn, (i+1) tn)`` and columns
  ``[j tm, (j+1) tm)``. Blocks arrive variant-sharded (each slot's shard
  made contiguous once, where the block is split), and the transport
  says how every slot sees every shard:

  * ``gather``: each slot gets a copy of every shard (one per physical
    device: virtual slots share it, and nothing writes to it), then
    contracts its row slice against its column slice: one K1 launch per
    tile a block, symmetric on the diagonal tiles (rows and columns one
    tensor), rectangular off it;
  * ``ring``: D steps a block; each slot contracts the shard it holds,
    then the shards rotate one hop by ``meshes.ring_perm`` (slot ``s``
    sends its shard to slot ``s - 1``), so every slot contracts every shard once:
    D K1 launches per tile a block, on shards a D-th of the block wide.
    Integer sums are exact in any order, so the count family is bitwise
    the gather transport's.

  Across the ranks of a job of several processes the mesh spans them
  (``core/meshes.py::process_mesh``) and each rank updates only its own
  slots' tiles. A step's global block is every rank's slab side by side,
  in rank order (the JAX package's ``make_array_from_process_local_data``):
  the gather all-gathers the slabs to every rank; the ring splits each
  rank's slab over its slots (global shard ``r L + l`` on rank ``r``'s
  slot ``l``) and hops the shards around the global ring, a device copy
  between slots of one rank and point to point between ranks. A rank
  whose partition is drained feeds an all-MISSING slab, which is
  contracted with the rest (it adds zeros): every rank runs its launches
  on every step.

  The count family hands each tile's row and column slices to
  ``ops/gram.py::add_count_products``, the single-device update's own
  contraction (K1 on the packed slices, or the reference lowering); the
  float family (grm) takes each chunk's per-variant statistics from all
  of its rows (``Kernel.tile_body``).

Counters: ``gram.fused_blocks`` one per block update under the fused
lowering (the JAX meaning, whatever the number of tiles),
``gram.ring_steps`` D per ring block. K1's own launches are
``ops/packed_gram.launches`` and the counter
``kernel.packed_gram.launches``, both counted where K1 launches. The
gather transport's fan-out of a block to the other cards is the device
span ``tile2d.fanout`` (one a copy, on the block's stream) and the
counter ``tile2d.fanout_bytes`` (bytes copied to a device other than
the block's: 0 on virtual slots). On two or more cards, tile2d counts
``gram.tile_skew_s``: a block's contraction on each card (its K1
launches and adds, between events on the card's stream), the slowest
card's seconds less the fastest's, summed over the blocks and read
after the gram phase's closing barrier (:func:`read_tile_skew`).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import meshes, telemetry
from spark_examples_tpu_torch.core.config import (
    GRAM_PLAN_MODES,
    TILE2D_TRANSPORTS,
)
from spark_examples_tpu_torch.core.profiling import CardSkew, device_span
from spark_examples_tpu_torch.ingest.bitpack import unpack_dosages
from spark_examples_tpu_torch.ops import gram as gram_ops
from spark_examples_tpu_torch.parallel import multihost as mh

# Rough per-device budget for resident accumulators (bytes).
_ACC_BUDGET = 8 * 2**30


@dataclass(frozen=True)
class GramPlan:
    mesh: meshes.Mesh
    mode: str  # replicated | variant | tile2d
    # Ranks of the job. Under tile2d the mesh spans them; under variant
    # and replicated each rank drives its own mesh over its own variant
    # partition, and the partial sums are added across ranks.
    processes: int = 1
    # The job's mesh shape over every rank's slots, where ``mesh`` is a
    # rank's own (variant and replicated across ranks).
    job_shape: tuple[int, int] | None = None

    @property
    def tiled(self) -> bool:
        """Whether the N x N leaves are :class:`~core.meshes.Tiled`."""
        return self.mode == "tile2d" and self.mesh.size > 1

    @property
    def block_shards(self) -> int:
        """How many ways the variant axis of this rank's block is split
        (its own slots)."""
        return len(self.mesh.local_slots) if self.mode != "replicated" else 1

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """The job's mesh shape, every rank's slots counted (what a
        checkpoint's manifest records)."""
        return self.job_shape or self.mesh.shape


def check_tile_divisible(n_samples: int, mesh: meshes.Mesh) -> None:
    """tile2d needs the SAMPLE axis divisible by both mesh axes, and it
    cannot be padded (a padded row would join the distance matrix as a
    phantom sample): caught up front with the fixes named."""
    n_i, n_j = mesh.shape
    if n_samples % n_i or n_samples % n_j:
        lcm = math.lcm(n_i, n_j)
        trim = (n_samples // lcm) * lcm
        trim_fix = f", or trim the cohort to {trim} samples" if trim else ""
        raise ValueError(
            f"tile2d cannot tile N={n_samples} samples over the "
            f"({n_i}, {n_j}) mesh: N must be divisible by both mesh "
            f"axes (N % {n_i} = {n_samples % n_i}, N % {n_j} = "
            f"{n_samples % n_j}). Fix: pick --mesh-shape with axes "
            f"dividing {n_samples}{trim_fix} "
            "(the sample axis cannot be padded — a padding row would "
            "appear in the output matrix as a phantom sample)."
        )


def plan_for(mesh: meshes.Mesh, n_samples: int, metric: str,
             mode: str = "auto", processes: int = 1) -> GramPlan:
    """Pick a distribution mode (or validate a forced one): one slot is
    replicated; else variant while the N x N leaves fit the per-device
    budget, tile2d past it.

    Under ``processes > 1`` ranks (``parallel/multihost.py``) the job's
    slots are those of every rank: ``mesh`` spans them
    (``meshes.process_mesh``), or is this rank's own and is spread over
    ``processes`` ranks of the same slot count. auto counts every slot
    (variant, or tile2d past the budget, as the JAX package's
    process-spanning mesh does). tile2d tiles the N x N over the spanning
    mesh; variant and replicated run on this rank's own slots (each
    rank's update of its own slab, the partial sums added across
    ranks)."""
    if processes > 1 and not mesh.owners:
        mesh = meshes.process_mesh(mesh.devices, processes,
                                   meshes.process_index())
    if mode == "auto":
        kern = kernels.get(metric)
        n_acc = 1
        if kern.family in ("count", "float"):
            n_acc = max(len(gram_ops.acc_leaves(metric))
                        - len(gram_ops.scalar_leaves(metric)), 1)
        acc_bytes = 4 * n_samples * n_samples * n_acc
        if mesh.size == 1:
            mode = "replicated"
        elif acc_bytes <= _ACC_BUDGET:
            mode = "variant"
        else:
            mode = "tile2d"
    if mode not in GRAM_PLAN_MODES:
        raise ValueError(f"unknown gram mode {mode!r}")
    if mode == "tile2d":
        check_tile_divisible(n_samples, mesh)
        return GramPlan(mesh, mode, processes)
    if mesh.spans_processes:
        return GramPlan(meshes.local_mesh(mesh), mode, processes,
                        job_shape=mesh.shape)
    return GramPlan(mesh, mode, processes)


def init_sharded(plan: GramPlan, n: int, metric: str) -> dict:
    """Zero accumulators laid out per the plan: whole on slot 0's device,
    or Tiled N x N leaves (scalar leaves stay whole on slot 0)."""
    home = plan.mesh.home
    if not plan.tiled:
        return gram_ops.init(n, metric, home)
    check_tile_divisible(n, plan.mesh)
    scalars = gram_ops.scalar_leaves(metric)
    acc = {}
    for k, v in gram_ops.init(1, metric, "cpu").items():
        acc[k] = (torch.zeros((), dtype=v.dtype, device=home)
                  if k in scalars
                  else meshes.Tiled.zeros(plan.mesh, (n, n), v.dtype))
    return acc


def resolve_transport(plan: GramPlan, transport: str) -> str:
    """The tile2d transport a job runs: ``gather`` or ``ring`` as asked,
    and ``auto`` is gather. Plans that are not tiled have none (gather).

    The JAX package's ``auto`` picks ring once one ring step's
    contraction outweighs one shard hop at 512 operations a byte, a
    v5e-class ratio. The port's does not: its ring splits each tile's K1
    launch into D smaller ones issued from one host thread, and on four
    H100 cards it lost to the gather at 2504 samples and tied within the
    noise at 8192 and 16384 (``tests/mesh_reading.py``, PERF.md), while
    on virtual slots no hop moves a byte at all."""
    if not plan.tiled or transport == "auto":
        return "gather"
    return transport


def check_ring_divisible(block_width: int, plan: GramPlan,
                         packed: bool) -> None:
    """The ring needs the shard count to divide the block's width (every
    slot rotates an equal shard). The streamed feeds pad to this grid;
    this names the flags for direct callers."""
    n_dev = plan.mesh.size
    if n_dev > 1 and block_width % n_dev:
        unit = "packed bytes" if packed else "variants"
        raise ValueError(
            f"--tile2d-transport ring cannot rotate a block of "
            f"{block_width} {unit} over the {n_dev}-device mesh: the "
            f"shard count must divide the block's variant width "
            f"({block_width} % {n_dev} = {block_width % n_dev}). Fix: "
            f"pick --block-variants a multiple of "
            f"{n_dev * (4 if packed else 1)} (the streamed feeds pad to "
            "this grid automatically; direct update calls must pad "
            "their own blocks — prefetch.pad_block/pad_packed)"
        )


def _pad(block: torch.Tensor, n_shards: int, packed: bool) -> torch.Tensor:
    """Right-pad the variant axis to a multiple of ``n_shards`` with
    missing calls (0xFF bytes when packed): they add nothing to any
    product or statistic."""
    w = block.shape[1]
    width = -(-w // n_shards) * n_shards
    if width == w:
        return block
    fill = 0xFF if packed else -1
    pad = torch.full((block.shape[0], width - w), fill, dtype=block.dtype,
                     device=block.device)
    return torch.cat([block, pad], dim=1)


def _shards(plan: GramPlan, block: torch.Tensor) -> dict[int, torch.Tensor]:
    """This rank's block split over its slots (``variants_flat``; the
    whole block over every slot on one process), each shard made
    contiguous once and placed on its slot's device: the copies every
    later launch reads (K1 takes contiguous operands). By slot."""
    mesh = plan.mesh
    spans = meshes.variants_flat(mesh, block.shape[1])
    return {s: block[:, sl].to(mesh.devices[s], non_blocking=True)
            .contiguous() for s, sl in zip(mesh.local_slots, spans)}


def _gathered(mesh: meshes.Mesh, block: torch.Tensor) -> dict:
    """The gather transport's all-gather of one block: the global block
    (every rank's slab side by side, in rank order; on one process the
    block itself) copied once onto each physical device of this rank's
    slots, by device. Virtual slots share their device's copy, and
    nothing writes to it. Each copy to another device is a
    ``tile2d.fanout`` span and counts its ``tile2d.fanout_bytes``."""
    whole = torch.cat(mh.allgather_tensor(mesh, block), dim=1)
    copies = {}
    for d in mesh.physical:
        if d == whole.device:
            copies[d] = whole
            continue
        if whole.is_cuda and d.type == "cuda":
            # torch's own barrier for a copy between cards (the block's
            # stream waits for the destination's), taken before the span
            # opens so that it holds the copy alone.
            torch.cuda.current_stream(whole.device).wait_stream(
                torch.cuda.current_stream(d))
        with device_span("tile2d.fanout", whole.device):
            copies[d] = whole.to(d, non_blocking=True)
        telemetry.count("tile2d.fanout_bytes",
                        whole.numel() * whole.element_size())
    return copies


def make_gather_probe(plan: GramPlan, n_samples: int, width: int,
                      packed: bool = False):
    """``probe(block) -> copies``: ONLY the tile2d gather transport's
    block all-gather (:func:`_gathered`, the code the transport runs, no
    contraction) for an ``(n_samples, width)`` block, padded to the slot
    grid as the transport pads it. Timing it at the job's block cadence
    gives the gather wait the ring transport exists to hide: the
    ``gram.gather_wait_s`` histogram and the numerator of
    ``gram.overlap_frac`` (``bench_torch.py --multichip``).

    On distinct cards each call copies the block from the home card to
    every other card. On virtual slots of one card no byte crosses
    between devices: the probe is one copy on the card (the concatenation
    of the ranks' slabs), so its wait is small and ``overlap_frac`` reads
    near 1."""
    mesh = plan.mesh
    local = mesh.local_slots

    def probe(block: torch.Tensor) -> dict:
        if tuple(block.shape) != (n_samples, width):
            raise ValueError(
                f"gather probe built for ({n_samples}, {width}) "
                f"{'packed ' if packed else ''}blocks, got "
                f"{tuple(block.shape)}")
        return _gathered(mesh, _pad(block, len(local), packed))

    return probe


class _TileContraction:
    """One block's contraction of a chunk (the whole block, or one ring
    shard) into every slot's tiles. Per-chunk host-side work (unpacking
    a chunk for grm, standardizing it) is done once per chunk object and
    shared by the virtual slots that hold the same chunk."""

    def __init__(self, plan: GramPlan, metric: str, packed: bool,
                 grm_precise: bool, lowering: str):
        self.plan = plan
        self.kern = kernels.get(metric)
        self.packed = packed
        self.grm_precise = grm_precise
        self.lowering = lowering
        self.pieces = self.kern.pieces
        self.scalars = gram_ops.scalar_leaves(metric)

    def __call__(self, acc: dict, s: int, chunk: torch.Tensor,
                 dense_cache: dict) -> None:
        mesh = self.plan.mesh
        n = chunk.shape[0]
        tn, tm = n // mesh.shape[0], n // mesh.shape[1]
        i, j = mesh.coords(s)
        rows = slice(i * tn, (i + 1) * tn)
        cols = slice(j * tm, (j + 1) * tm)
        if self.kern.family == "float":
            # Keyed by identity; the entry holds the chunk itself, so
            # its id cannot be reused by another tensor meanwhile.
            hit = dense_cache.get(id(chunk))
            if hit is None:
                dense = unpack_dosages(chunk) if self.packed else chunk
                hit = dense_cache[id(chunk)] = (chunk, dense)
            dense = hit[1]
            tile = {k: (acc[k] if k in self.scalars else acc[k].tiles[s])
                    for k in acc}
            # The replicated scalars (grm's nvar) grow on one slot a
            # rank: every rank sees every variant of the global block, so
            # each holds the whole value (JAX's replicated leaf).
            self.kern.tile_body(tile, dense, rows, cols, self.grm_precise,
                                s == mesh.local_slots[0])
            return
        r = chunk[rows]
        # The same slice on both sides of a diagonal tile: it then takes
        # the symmetric route (K1's I <= J launch).
        c = r if (rows == cols) else chunk[cols]
        tiles = {k: acc[k].tiles[s] for k in self.pieces}
        gram_ops.add_count_products(tiles, r, c, self.pieces, self.packed,
                                    self.lowering)


def make_update(plan: GramPlan, metric: str, packed: bool = False,
                grm_precise: bool = False, transport: str = "gather",
                lowering: str = "reference"):
    """``(acc, block) -> acc`` under the plan, updating ``acc`` in place.

    ``packed``: blocks arrive 2-bit packed ((N, v/4) uint8), split over
    the slots and reassembled per ``transport``. ``transport``: the
    tile2d reassembly, ``gather`` or ``ring`` (``auto`` here means an
    unresolved caller and takes ``gather``). ``lowering``: the RESOLVED
    count-family lowering, ``reference`` or ``fused`` (K1 on CUDA
    tensors, its plain version on CPU ones). Blocks of any width are
    padded to the shard grid. Under ``fused`` each call counts one
    ``gram.fused_blocks``.
    """
    if transport not in TILE2D_TRANSPORTS:
        raise ValueError(
            f"unknown tile2d transport {transport!r}; valid: "
            f"{' | '.join(TILE2D_TRANSPORTS)}"
        )
    if lowering not in ("reference", "fused"):
        raise ValueError(
            f"unresolved gram lowering {lowering!r}: make_update takes "
            "the RESOLVED choice (reference | fused) — callers resolve "
            "auto via gram.resolve_gram_lowering"
        )
    if lowering == "fused":
        kernels.check_fused_lowering(metric, packed)
    update = _plan_update(plan, metric, packed, grm_precise, transport,
                          lowering)
    if lowering != "fused":
        return update

    @functools.wraps(update)  # carries ``tile_skew`` over
    def update_fused(acc, block):
        telemetry.count("gram.fused_blocks", 1)
        return update(acc, block)

    return update_fused


def _plan_update(plan: GramPlan, metric: str, packed: bool,
                 grm_precise: bool, transport: str, lowering: str):
    """:func:`make_update`'s update under the plan's mode, uncounted."""
    mesh = plan.mesh
    n_dev = mesh.size
    ring = transport == "ring" and plan.tiled
    perm = meshes.ring_perm(mesh)
    home = mesh.home
    local = mesh.local_slots

    if n_dev == 1 or plan.mode == "replicated":
        step = gram_ops.impl_for(metric, packed, grm_precise, lowering)

        def update_single(acc, block):
            return step(acc, block.to(home))

        return update_single

    if plan.mode == "variant":
        step = gram_ops.impl_for(metric, packed, grm_precise, lowering)

        def update_variant(acc, block):
            for shard in _shards(plan, _pad(block, n_dev,
                                            packed)).values():
                partial = step(gram_ops.init(shard.shape[0], metric,
                                             shard.device), shard)
                for k in acc:
                    acc[k].add_(partial[k].to(home))
            return acc

        return update_variant

    contract = _TileContraction(plan, metric, packed, grm_precise, lowering)
    skew = CardSkew(mesh.physical)

    def contract_timed(acc, s, chunk, cache):
        dev = mesh.devices[s]
        skew.mark(dev)
        contract(acc, s, chunk, cache)
        skew.mark(dev)

    def update_tile2d(acc, block):
        skew.next_block()
        cache: dict = {}
        # This rank's slab, split over its slots; on one process the
        # whole block over every slot.
        block = _pad(block, len(local), packed)
        if ring:
            check_ring_divisible(block.shape[1] * mesh.processes, plan,
                                 packed)
            telemetry.count("gram.ring_steps", n_dev)
            held = _shards(plan, block)
            for step in range(n_dev):
                # The hop is issued before the contraction, as in the JAX
                # schedule, so on distinct cards (and across ranks) it can
                # ride behind it.
                last = step == n_dev - 1
                if not last:
                    nxt, arriving, into = _hop(held)
                for s in local:
                    contract_timed(acc, s, held[s], cache)
                if not last:
                    nxt.update(zip(into, arriving.wait()))
                    held = nxt
            return acc
        copies = _gathered(mesh, block)
        for s in local:
            contract_timed(acc, s, copies[mesh.devices[s]], cache)
        return acc

    def _hop(held: dict):
        """One ring hop of the held shards (slot ``src`` to ``dst`` by
        ``ring_perm``), started: ``(next, arriving, into)`` with the
        copies within this rank in ``next``; ``arriving.wait()`` gives
        the shards that come from another rank, for the slots ``into``."""
        nxt, sends, recvs, into = {}, [], [], []
        like = held[local[0]]
        for tag, (src, dst) in enumerate(perm):
            if mesh.is_local(src) and mesh.is_local(dst):
                nxt[dst] = held[src].to(mesh.devices[dst], non_blocking=True)
            elif mesh.is_local(src):
                sends.append((tag, mesh.owner(dst), held[src]))
            elif mesh.is_local(dst):
                recvs.append((tag, mesh.owner(src), tuple(like.shape),
                              like.dtype, mesh.devices[dst]))
                into.append(dst)
        return nxt, mh.start_exchange(sends, recvs), into

    update_tile2d.tile_skew = skew
    return update_tile2d


def read_tile_skew(update) -> None:
    """Count the tile2d update's ``gram.tile_skew_s`` since its last
    read; every card has synchronised. Other updates have none."""
    skew = getattr(update, "tile_skew", None)
    if skew is not None:
        skew.count("gram.tile_skew_s")
