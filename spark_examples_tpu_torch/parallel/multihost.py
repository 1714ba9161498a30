"""Jobs of several processes: per-rank ingest feeding per-rank partial
sums, over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/multihost.py``. Every rank
(``core/meshes.py::maybe_init_distributed``) builds a source over only
its share of the input (``pipelines/runner.py::build_source``: a range
share of ``--references``, else a block-aligned variant window) and
streams it through its own mesh. The ranks must still agree on the step
count, since every rank runs the same hooks (a checkpoint, a streaming
refresh) at the same global step; :func:`stream_global_blocks` keeps
JAX's control-plane contract:

- sources that know their length (``exact_n_variants``) agree on the
  step count in ONE upfront allgather, stream with no control traffic,
  and close with ONE terminal agreement round on an ok flag, so a broken
  length claim aborts every rank in that round instead of leaving peers
  parked in a collective;
- otherwise one "anyone still has data?" round per ``consensus_every``
  blocks, exhausted ranks stepping with all-MISSING slabs.

Two planes: :func:`allgather` carries small host values (step counts,
flags, cursors, votes) on the gloo ``control`` group; the tensor
collectives (:func:`allreduce_sum`, :func:`allgather_tensor`,
:func:`gather_slots`, :func:`from_owner`, :func:`start_exchange`) move
device tensors on NCCL, and on gloo move host tensors directly and
device tensors staged through the host (ranks that share a card).

Under the variant and replicated plans, where JAX psums every block
(every process holds the global accumulator), the port keeps per-rank
int32 partials and sums them only where the global value is read: a
hook that reads the accumulators (:class:`ReducedView`), a checkpoint,
and the end of the stream. Integer sums are exact in any order, so the
result is bitwise JAX's.

Under tile2d across ranks (a mesh that spans the processes,
``core/meshes.py::process_mesh``) nothing is summed across ranks: each
step's global block is every rank's slab side by side
(:func:`allgather_tensor`, or the ring's point-to-point hops), so every
tile is a global sum from the start. What a rank needs of another's
tiles (a mirrored block, the diagonal, per-tile partial sums) moves
point to point or from its owner (:func:`regions`,
:func:`tiled_diagonal`, :func:`gather_slots`), in one order fixed by the
mesh on every rank.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from spark_examples_tpu_torch.core import faults, meshes, telemetry
from spark_examples_tpu_torch.core.dtypes import MISSING
from spark_examples_tpu_torch.ingest.prefetch import (
    PACKED_MISSING,
    padded_width,
    stream_to_device,
)


def is_multihost() -> bool:
    return meshes.process_count() > 1


def allgather(value) -> np.ndarray:
    """One small host value from every rank -> a ``(P, ...)`` array, on
    the gloo control group: control-plane traffic, never genotype
    data. Every rank passes the same shape and dtype."""
    arr = np.asarray(value)
    d = meshes.distributed()
    if d is None or d.world == 1:
        return arr[None]
    import torch.distributed as dist

    dtype = np.int64 if arr.dtype == np.bool_ else arr.dtype
    mine = torch.from_numpy(np.ascontiguousarray(arr, dtype).reshape(-1))
    out = [torch.empty_like(mine) for _ in range(d.world)]
    dist.all_gather(out, mine, group=d.control)
    return np.stack([o.numpy().reshape(arr.shape) for o in out])


def allreduce_sum(x, inplace: bool = False):
    """The sum over ranks of ``x`` (a tensor, or a numpy array), every
    rank getting it: the data plane beside :func:`allgather`. On NCCL a
    device ``all_reduce``; on gloo a CPU tensor directly and a device
    tensor staged through the host (``.cpu()``, the collective,
    ``.to(device)``). Integer dtypes keep their wraparound, so callers
    own the same int32 budget as any accumulation. ``inplace`` sums into
    ``x`` itself (a tensor)."""
    d = meshes.distributed()
    if d is None or d.world == 1:
        return x
    import torch.distributed as dist

    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.array(x, copy=True))
        dist.all_reduce(t.reshape(-1), group=d.control)
        return t.numpy()
    out = x if inplace else x.clone()
    if out.is_cuda and d.backend == "nccl":
        dist.all_reduce(out.reshape(-1))
        return out
    # A host tensor, or a device tensor staged through the host, on the
    # gloo group (the job's own under gloo).
    host = out.cpu() if out.is_cuda else out
    dist.all_reduce(host.reshape(-1), group=d.control)
    if host is not out:
        out.copy_(host)
    return out


def vote_all_ok(local_ok: bool, make_peer_error) -> None:
    """The abort protocol of every fallible step that spans ranks:
    allgather the ranks' ok flags (the gather is also the barrier) and,
    when any failed, raise ``make_peer_error(bad_ranks)`` on the ranks
    whose own step succeeded; the failed ones re-raise their own error
    after. Raising beside a collective instead would leave the others
    waiting in it. One process: a no-op."""
    if not is_multihost():
        return
    oks = allgather(np.int32(bool(local_ok)))
    if not oks.all() and local_ok:
        raise make_peer_error([int(i) for i in np.flatnonzero(oks == 0)])


def _plane(t: torch.Tensor):
    """``(group, staged)`` for moving ``t`` between ranks: NCCL's default
    group for a card tensor under nccl; else the gloo group, a card
    tensor staged through the host."""
    d = meshes.distributed()
    if t.is_cuda and d.backend == "nccl":
        return None, False
    return d.control, t.is_cuda


def allgather_tensor(mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape and dtype on every rank), in rank
    order, on ``t``'s device: the data-plane all_gather over the ranks
    ``mesh`` spans (on one process: ``[t]``)."""
    if not mesh.spans_processes:
        return [t]
    d = meshes.distributed()
    import torch.distributed as dist

    group, staged = _plane(t)
    src = (t.detach().cpu() if staged else t).contiguous()
    out = [torch.empty_like(src) for _ in range(d.world)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


def gather_slots(mesh, stack: torch.Tensor, dst: int | None = None):
    """Per-slot pieces of a mesh that spans the ranks, by global slot:
    ``stack`` holds this rank's, one a local slot in slot order (the
    same shape on every rank). Every rank gets the list (``dst`` None),
    or rank ``dst`` alone (the others get None). On one process: the
    stack's rows."""
    d = meshes.distributed()
    if not mesh.spans_processes:
        return list(stack)
    import torch.distributed as dist

    group, staged = _plane(stack)
    src = (stack.detach().cpu() if staged else stack).contiguous()
    if dst is None:
        parts = [torch.empty_like(src) for _ in range(d.world)]
        dist.all_gather(parts, src, group=group)
    else:
        parts = ([torch.empty_like(src) for _ in range(d.world)]
                 if d.rank == dst else None)
        dist.gather(src, parts, dst=dst, group=group)
        if parts is None:
            return None
    # Slots are rank-major, so rank order is slot order.
    return [row.to(stack.device) if staged else row
            for part in parts for row in part]


def from_owner(mesh, t: torch.Tensor | None, owner: int, shape, dtype,
               device) -> torch.Tensor:
    """``owner``'s tensor on every rank ``mesh`` spans (a broadcast):
    ``t`` on the owner; elsewhere a tensor of ``shape``, ``dtype`` on
    ``device`` is received. On one process: ``t``."""
    if not mesh.spans_processes:
        return t
    d = meshes.distributed()
    import torch.distributed as dist

    buf = (t if d.rank == owner
           else torch.empty(shape, dtype=dtype, device=device))
    group, staged = _plane(buf)
    host = (buf.detach().cpu() if staged else buf).contiguous()
    dist.broadcast(host, src=owner, group=group)
    if d.rank == owner:
        return t
    return host.to(device) if staged else host


def broadcast_object(mesh, obj, src: int = 0):
    """A small picklable value from ``src`` to every rank ``mesh`` spans,
    on the gloo control group. On one process: ``obj``."""
    if not mesh.spans_processes:
        return obj
    import torch.distributed as dist

    d = meshes.distributed()
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=d.control)
    return box[0]


class Exchange:
    """Point-to-point moves in flight (:func:`start_exchange`);
    :meth:`wait` returns the received tensors, in the order asked."""

    def __init__(self, works, received, devices):
        self._works = works
        self._received = received
        self._devices = devices

    def wait(self) -> list[torch.Tensor]:
        for w in self._works:
            w.wait()
        return [t if t.device == dev else t.to(dev)
                for t, dev in zip(self._received, self._devices)]


def start_exchange(sends, recvs) -> Exchange:
    """Post point-to-point moves at once, without waiting: ``sends``
    ``(tag, peer, tensor)``, ``recvs`` ``(tag, peer, shape, dtype,
    device)``. Tags number the moves in one order that every rank
    derives from the mesh alone; each rank posts its own in tag order,
    so the two ends of every move pair up on gloo (by tag) and on NCCL
    (by order). Card tensors move on NCCL, else on gloo staged through
    the host."""
    if not sends and not recvs:
        return Exchange([], [], [])
    import torch.distributed as dist

    ops, received, devices = [], [], []
    for move in sorted([(m[0], 0, m) for m in sends]
                       + [(m[0], 1, m) for m in recvs]):
        _tag, is_recv, m = move
        if is_recv:
            tag, peer, shape, dtype, device = m
            buf = torch.empty(shape, dtype=dtype, device=device)
            group, staged = _plane(buf)
            if staged:
                buf = torch.empty(shape, dtype=dtype)
            received.append(buf)
            devices.append(torch.device(device))
            ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag))
        else:
            tag, peer, tensor = m
            group, staged = _plane(tensor)
            src = (tensor.detach().cpu() if staged else tensor).contiguous()
            ops.append(dist.P2POp(dist.isend, src, peer, group, tag))
    return Exchange(dist.batch_isend_irecv(ops), received, devices)


def regions(x, wanted) -> dict:
    """Global sub-blocks of the tiled leaf ``x`` where they are wanted:
    ``wanted`` lists ``(slot, (r0, r1, c0, c1))``, the same list on every
    rank, each block to be assembled on that slot's device by the rank
    that owns it. Every rank calls this together: pieces within a rank
    are device copies, between ranks point to point. Returns this rank's
    ``{slot: block}``."""
    mesh = x.mesh
    me = mesh.rank
    sends, recvs, keys, local = [], [], [], {}
    layouts = {}
    tag = 0
    for dst, (r0, r1, c0, c1) in wanted:
        to = mesh.owner(dst)
        bands = x.region_pieces(r0, r1, c0, c1)
        if to == me:
            layouts[dst] = bands
        for b, band in enumerate(bands):
            for p, (s, rows, cols) in enumerate(band):
                frm = mesh.owner(s)
                if frm == me and to == me:
                    local[(dst, b, p)] = x.tiles[s][rows, cols].to(
                        mesh.devices[dst])
                elif frm == me:
                    sends.append((tag, to, x.tiles[s][rows, cols]))
                elif to == me:
                    recvs.append((tag, frm, (rows.stop - rows.start,
                                             cols.stop - cols.start),
                                  x.dtype, mesh.devices[dst]))
                    keys.append((dst, b, p))
                tag += 1
    local.update(zip(keys, start_exchange(sends, recvs).wait()))
    return {dst: meshes.assemble([[local[(dst, b, p)]
                                   for p in range(len(band))]
                                  for b, band in enumerate(bands)])
            for dst, bands in layouts.items()}


def tiled_diagonal(x, device) -> torch.Tensor:
    """The global diagonal of a square tiled leaf on ``device``, on every
    rank: each stretch from the rank that holds it."""
    mesh = x.mesh
    parts = []
    for s, rows, cols in x.diagonal_spans():
        mine = (torch.diagonal(x.tiles[s][rows, cols]).to(device)
                if mesh.is_local(s) else None)
        parts.append(from_owner(mesh, mine, mesh.owner(s),
                                (rows.stop - rows.start,), x.dtype, device))
    return torch.cat(parts)


def fetch_replicated(x) -> np.ndarray:
    """A replicated value as a host array. Every rank holds the whole
    value in the port (it sums partials into whole tensors; the routes
    that would fetch a matrix tiled across ranks are refused before the
    stream, ``runner.check_gatherable``), so this is ``np.asarray``; kept
    so the call sites read as the JAX package's."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def reduce_acc(acc: dict, inplace: bool = False) -> dict:
    """Every leaf summed over ranks, in leaf order (the same collectives
    on every rank, whichever leaf a caller reads first)."""
    return {k: allreduce_sum(acc[k], inplace=inplace) for k in sorted(acc)}


class ReducedView(Mapping):
    """The global accumulators a hook sees while the ranks keep partial
    sums: reduced on first read, then cached. A read is a collective, so
    every rank reads the view at the same steps (the streaming refresh
    does, on the global step count); a hook that never reads it costs
    nothing."""

    def __init__(self, partial: dict):
        self._partial = partial
        self._reduced: dict | None = None

    def _acc(self) -> dict:
        if self._reduced is None:
            self._reduced = reduce_acc(self._partial)
        return self._reduced

    def __getitem__(self, k):
        return self._acc()[k]

    def __iter__(self):
        return iter(self._partial)

    def __len__(self) -> int:
        return len(self._partial)


def _exact_local_steps(source, block_variants: int,
                       start_variant: int) -> int:
    """Blocks this rank will stream, or -1 when the source cannot say
    without streaming (range shares of a VCF, filtered streams)."""
    if not getattr(source, "exact_n_variants", False):
        return -1
    remaining = max(0, source.n_variants - start_variant)
    return -(-remaining // block_variants)


def stream_global_blocks(source, block_variants: int, start_variant: int,
                         plan, pack: bool, stats: dict | None = None,
                         prefetch: int = 2, consensus_every: int = 8):
    """Yield ``(block, meta | None)`` on every rank, one per step of the
    global grid. ``source`` is this rank's partition; ``block`` its slab
    on the plan's home device at the agreed width (padded to the plan's
    variant shards); ``meta`` None where this rank had nothing left and
    the slab is all-MISSING padding (``PACKED_MISSING`` bytes when
    packed), which adds nothing to any product.

    Control-plane cost: one upfront step-count allgather plus one
    terminal agreement round when every rank's source is
    ``exact_n_variants``, else one has-data round per
    ``consensus_every`` blocks. ``stats["consensus_rounds"]`` counts the
    rounds. The next block is pulled (its copy to the device started)
    before the current one is yielded. ``multihost.shard_feed_bytes``
    counts the bytes of real slabs only.

    Every rank must drain the iterator: leaving early desynchronizes the
    rounds.
    """
    device = plan.mesh.home
    w_local = padded_width(block_variants, pack=pack,
                           pad_multiple=plan.block_shards)
    n = source.n_samples
    missing: list[torch.Tensor] = []

    def missing_slab() -> torch.Tensor:
        if not missing:
            missing.append(
                torch.full((n, w_local), PACKED_MISSING, dtype=torch.uint8,
                           device=device) if pack
                else torch.full((n, w_local), MISSING,
                                dtype=torch.int8, device=device))
        return missing[0]

    def gather_round(value) -> np.ndarray:
        if stats is not None:
            stats["consensus_rounds"] = stats.get("consensus_rounds", 0) + 1
        # Fired outside the span: an injected delay is this rank's own
        # lateness, while the span measures the wait for the others (the
        # straggler shows on the ranks that did not straggle).
        faults.fire("multihost.consensus")
        with telemetry.span("multihost.consensus", cat="multihost"):
            return allgather(value)

    def assemble(item):
        if item is None:
            return missing_slab(), None
        block, meta = item
        if block.shape[1] != w_local:  # every slab must agree
            raise AssertionError(
                f"local slab width {block.shape[1]} != agreed {w_local}")
        telemetry.count("multihost.shard_feed_bytes",
                        float(block.numel() * block.element_size()))
        return block, meta

    it = stream_to_device(source, block_variants, device,
                          start_variant=start_variant, prefetch=prefetch,
                          pack=pack, stats=stats,
                          pad_multiple=plan.block_shards)
    try:
        local_steps = _exact_local_steps(source, block_variants,
                                         start_variant)
        gathered = gather_round(np.int64(local_steps))
        if (gathered >= 0).all():
            produced = 0
            pending = None
            for _ in range(int(gathered.max())):
                item = next(it, None)
                produced += item is not None
                assembled = assemble(item)
                if pending is not None:
                    yield pending
                pending = assembled
            if pending is not None:
                yield pending
            # Every rank joins one final round on its own ok flag, so a
            # broken length claim aborts all of them here; a rank-local
            # raise would leave the others in their next collective.
            ok = produced == local_steps and next(it, None) is None
            oks = gather_round(np.int32(ok))
            if not oks.all():
                bad = [int(i) for i in np.flatnonzero(oks == 0)]
                mine = ("ok" if ok else f"{produced} blocks against "
                        f"claimed {local_steps}")
                raise RuntimeError(
                    f"process(es) {bad} streamed a different block count "
                    "than their claimed exact_n_variants (this process: "
                    f"{mine}) — the source's contract is broken; fix the "
                    "source (trusting the claim would silently corrupt the "
                    "global accumulation). All processes abort together "
                    "in this agreement round."
                )
            return
        # Some rank cannot count its blocks: one has-data round per
        # group, stragglers padding the group out.
        pending = next(it, None)
        while bool(gather_round(np.int32(pending is not None)).any()):
            for _ in range(max(1, consensus_every)):
                item = pending
                pending = next(it, None) if item is not None else None
                yield assemble(item)
    finally:
        it.close()  # stops the producer thread on every way out

