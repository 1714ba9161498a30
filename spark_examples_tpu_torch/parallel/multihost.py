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
flags, cursors, votes) on the gloo ``control`` group; :func:`allreduce_sum`
sums tensors, a device ``all_reduce`` on NCCL and host-staged on gloo.

Where JAX psums every block (every process holds the global
accumulator), the port keeps per-rank int32 partials and sums them only
where the global value is read: a hook that reads the accumulators
(:class:`ReducedView`), a checkpoint, and the end of the stream. Integer
sums are exact in any order, so the result is bitwise JAX's.
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


def fetch_replicated(x) -> np.ndarray:
    """A replicated value as a host array. Every rank holds the whole
    value in the port (it sums partials into whole tensors), so this is
    ``np.asarray``; kept so the call sites read as the JAX package's."""
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

