"""Streaming incremental PCoA: coordinate snapshots during the stream,
not only after the terminal solve (``pcoa --stream-refresh-blocks``).

Two facts make it cheap:

- the gram accumulator is associative, so after any block its partial
  state finalizes into a valid distance matrix over the variants seen;
- the randomized subspace (``ops/eigh.py::subspace_iterate``) can be
  warm-started: between refreshes the accumulator changes by a
  ~1/blocks_done relative delta, so one power step per refresh (two
  B @ Q products, a QR and a small Rayleigh eigh) tracks the top-k
  eigenspace.

Every ``stream_refresh_blocks`` blocks a refresh is enqueued on the
device's stream behind the block updates, and its snapshot is copied
to pinned host memory without a wait. Before the next refresh the
previous snapshot is materialized: that waits for the previous refresh
only (an event recorded behind it), never for the block updates queued
since, so at most one refresh and one centered N x N matrix are pending
at a time. The terminal solve takes ``FINAL_ITERS`` tightening steps
from the tracked subspace, reusing the last refresh's centered matrix
when the stream ended on a refresh boundary.

In a job of several processes every rank refreshes at the same global
step (the consensus feeder's step count, also on steps where its own
partition was drained and it fed a padding slab): the hook reads the
accumulators summed over ranks (or, under tile2d, the tiles, global
sums already), and a snapshot is stamped with this rank's own cursor,
as in the JAX package.

Under a tile2d plan the refresh runs on the tiles
(``parallel/pcoa_sharded.py``: finalize, centering and ``B @ Q`` per
tile), as the JAX package's does under its plan's shardings; when the
tiles span the ranks, every rank takes part and the subspace step runs
on rank 0, its results broadcast (``pcoa_sharded.solve_on_rank0``).

The cold-start probes come from :func:`probes` (a ``torch.Generator``
on the CPU, seed 0), not from ``jax.random``; tests comparing with the
JAX package patch JAX's probes into that seam.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.core.meshes import Tiled
from spark_examples_tpu_torch.core.profiling import PhaseTimer, hard_sync
from spark_examples_tpu_torch.ops import distances
from spark_examples_tpu_torch.ops.centering import gower_center
from spark_examples_tpu_torch.ops.eigh import (
    coords_from_eigpairs,
    init_probes,
    subspace_iterate,
)
from spark_examples_tpu_torch.pipelines import runner
from spark_examples_tpu_torch.pipelines.jobs import CoordsOutput, _emit_coords
from spark_examples_tpu_torch.solvers.sketch import ieee_f32

OVERSAMPLE = 32  # matches randomized_eigh's default subspace width
FINAL_ITERS = 4  # tightening steps for the terminal solve


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to host memory; on a CUDA device into pinned memory
    without waiting (the caller records an event behind the copy)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


@dataclass
class StreamSnapshot:
    """Coordinates after ``n_variants`` variants. Until
    :meth:`materialize` the values are host tensors whose copy may still
    be in flight behind ``ready``."""

    n_variants: int
    eigenvalues: np.ndarray | torch.Tensor
    coords: np.ndarray | torch.Tensor
    ready: torch.cuda.Event | None = None

    def materialize(self) -> "StreamSnapshot":
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        if isinstance(self.eigenvalues, torch.Tensor):
            self.eigenvalues = self.eigenvalues.numpy()
            self.coords = self.coords.numpy()
        return self


def probes(n: int, p: int, device) -> torch.Tensor:
    """The cold-start subspace: (N, min(p, N)) Gaussian draws from a CPU
    generator seeded 0, moved to ``device``. The clamp keeps reduced QR
    from collapsing a wider-than-square block."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    return init_probes(n, p, gen).to(device)


def _center(acc: dict, metric: str):
    """acc -> Gower-centered B, on the accumulators' device(s): tiled
    when the accumulators are (a tile2d plan). The accumulators are only
    read: the stream keeps adding into them."""
    tiled = [v for v in acc.values() if isinstance(v, Tiled)]
    if tiled:
        from spark_examples_tpu_torch.parallel import pcoa_sharded as ps

        plan = ps.GramPlan(tiled[0].mesh, "tile2d")
        return ps.gower_center_tiles(
            ps.finalize_tiles(plan, acc, metric, ("distance",))["distance"])
    return gower_center(distances.finalize(acc, metric)["distance"])


def _iterate(b, q: torch.Tensor, k: int, iters: int):
    """``subspace_iterate`` against the matrix ``b``, or a tiled matrix
    through ``q -> B @ q`` (across ranks on rank 0, its results on every
    rank)."""
    if isinstance(b, torch.Tensor):
        return subspace_iterate(b, q, k, iters)
    from spark_examples_tpu_torch.parallel.pcoa_sharded import (
        solve_on_rank0,
    )

    return solve_on_rank0(b, lambda op: subspace_iterate(op, q, k, iters))


def _check_streamable(cfg) -> None:
    """Raise unless the compute config can run the streaming route (the
    JAX package's refusals)."""
    if cfg.stream_refresh_blocks <= 0:
        raise ValueError(
            "incremental_pcoa_job requires compute.stream_refresh_blocks > 0"
        )
    if cfg.backend == "cpu-reference":
        raise ValueError(
            "streaming pcoa runs on the jax backend with a gram metric"
        )
    metric = cfg.metric or "ibs"
    if metric == "braycurtis":
        raise ValueError(
            "streaming pcoa runs on the gram path with a gram metric; "
            "--metric braycurtis is a table kernel with no accumulator to "
            "refresh — run the batch pcoa job for it"
        )
    if cfg.eigh_mode == "dense":
        raise ValueError(
            "streaming pcoa is the rank-k subspace path by construction; "
            "eigh_mode='dense' would be silently ignored — use the batch "
            "pcoa job for a dense solve"
        )
    if cfg.solver != "exact":
        raise ValueError(
            "--solver sketch/corrected applies to the batch pcoa/pca "
            "solve; the streaming incremental route tracks its own warm "
            "subspace over the LIVE N x N accumulator and would silently "
            "shadow the sketch state — drop --stream-refresh-blocks to "
            "run the sketch solver, or --solver exact to stream snapshots"
        )


def incremental_pcoa_job(
    job, source=None
) -> tuple[CoordsOutput, list[StreamSnapshot]]:
    """PCoA with mid-stream coordinate snapshots. Streams blocks through
    the gram accumulators exactly like ``pcoa_job``; every
    ``compute.stream_refresh_blocks`` blocks a warm subspace refresh is
    enqueued and a snapshot recorded. Returns the final coordinates
    (tightened from the tracked subspace) and the snapshots, all
    materialized. The ``stream_refresh`` phase counts the enqueue, the
    ``stream_drain`` phase the waits for previous snapshots; a refresh's
    end-to-end cost is the gram phase with refreshes minus without."""
    cfg = job.compute
    _check_streamable(cfg)
    refresh_every = cfg.stream_refresh_blocks
    metric = cfg.metric or "ibs"
    resolve_device(cfg.device)
    k = cfg.num_pc
    timer = PhaseTimer()
    with runner.job_source(job, source, timer) as source:
        n = source.n_samples
        plan = runner.plan_for_job(job, source)
        device = plan.mesh.home
        state = {
            "q": probes(n, k + OVERSAMPLE, device),
            "snapshots": [],
            # The last refresh's centered matrix and its global step: a
            # stream ending on a refresh boundary reuses it for the
            # terminal solve instead of finalizing the same accumulators
            # again (a decision every rank takes alike).
            "b": None,
            "b_step": -1,
            "steps": 0,
            # This rank's last cursor: a pad step of a job of several
            # processes passes meta=None but still refreshes.
            "last_stop": 0,
        }

        def on_block(acc, blocks_done, meta):
            state["steps"] = blocks_done
            if meta is not None:
                state["last_stop"] = meta.stop
            if blocks_done % refresh_every:
                return
            # Backpressure: wait for the previous snapshot (and so the
            # previous refresh) before enqueueing the next one.
            if state["snapshots"]:
                with timer.phase("stream_drain"):
                    state["snapshots"][-1].materialize()
            with timer.phase("stream_refresh"):
                state["b"] = None  # free the held B before the next
                with ieee_f32():
                    b = _center(acc, metric)
                    vals, vecs, q = _iterate(b, state["q"], k, 1)
                coords = coords_from_eigpairs(vals, vecs)
                stop = state["last_stop"]
                snap = StreamSnapshot(stop, _host_copy(vals),
                                      _host_copy(coords))
                if device.type == "cuda":
                    snap.ready = torch.cuda.Event()
                    snap.ready.record()
            state.update(q=q, b=b, b_step=blocks_done)
            state["snapshots"].append(snap)
            telemetry.event("stream.snapshot", cat="stream",
                            n_variants=stop, blocks_done=blocks_done)

        grun = runner.run_gram(job, source, timer, plan=plan,
                               on_block=on_block)
    for snap in state["snapshots"]:
        snap.materialize()

    with timer.phase("eigh"):
        with ieee_f32():
            if state["b"] is not None and state["b_step"] == state["steps"]:
                b = state["b"]
            else:
                b = _center(grun.acc, metric)
            vals, vecs, _q = hard_sync(_iterate(b, state["q"], k,
                                                FINAL_ITERS))
    coords = coords_from_eigpairs(vals, vecs).cpu().numpy()
    # eigh_iters mirrors the terminal solve actually run.
    out = _emit_coords(job, grun.sample_ids, coords, vals.cpu().numpy(),
                       timer, grun.n_variants, method="randomized",
                       eigh_iters=FINAL_ITERS)
    return out, state["snapshots"]
