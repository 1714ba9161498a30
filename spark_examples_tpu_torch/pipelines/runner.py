"""The job core: build the source, then either stream the cohort
through the gram accumulators under a distribution plan and finalize
(count and float kernels), or materialise the whole table and lower it
(table kernels: Bray-Curtis).

One process drives the job's device mesh (``core/meshes.py``):
:func:`plan_for_job` picks the plan, the JAX package's rule: on one
slot (one card, or ``--device cpu``) it is ``replicated`` and the
accumulators are whole tensors on that device; on more it is
``variant`` or ``tile2d`` (``parallel/gram_sharded.py``). A job with
``--checkpoint-dir`` resumes from the checkpoint it finds there and,
with ``--checkpoint-every-blocks``, saves one every that many blocks
(core/checkpoint.py). The gram accumulation and each pass of the sketch
solver stream through one loop, :func:`run_pass` (the JAX package's
``run_gram`` loop and ``run_sketch_pass``), so they share the feed, the
cursor and the checkpoint cadence, and the ``gram.block`` span of each
block period (producer wait, copy, update, hooks and checkpoint) under
the ``phase.gram`` span.

A job of several processes (``torch.distributed``, started with the
JAX package's environment names: ``core/meshes.py``) gives every rank
its own share of the input (:func:`build_source`) and the consensus
feeder of ``parallel/multihost.py``. Under the variant and replicated
plans each rank adds its slabs into partial sums on its own slots,
summed across ranks where the global value is read (a hook, a
checkpoint, the end of the stream); under tile2d the mesh spans the
ranks and each rank's tiles take every rank's slabs (global sums from
the start, nothing summed across ranks).

``--backend cpu-reference`` routes a similarity through the NumPy
oracle instead (``utils/oracle.py``): host blocks from
``source.blocks()``, float64 products, the kernels' ``np_finalize``
twins, scipy's Bray-Curtis. It touches no device; the job's
``--device`` is still resolved, so a missing card fails as it does on
the device route.
"""

from __future__ import annotations

import dataclasses
import warnings
from contextlib import closing, contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import meshes, telemetry
from spark_examples_tpu_torch.core.config import IngestConfig, JobConfig
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.core.profiling import (
    PhaseTimer,
    check_nans,
    hard_sync,
)
from spark_examples_tpu_torch.ingest.filters import FilteredSource
from spark_examples_tpu_torch.ingest.ldprune import LdPruneSource
from spark_examples_tpu_torch.ingest.packed import load_packed
from spark_examples_tpu_torch.ingest.plink import PlinkSource
from spark_examples_tpu_torch.ingest.prefetch import stream_to_device
from spark_examples_tpu_torch.ingest.resilient import (
    RetryingSource,
    RetryPolicy,
)
from spark_examples_tpu_torch.ingest.partitioned import PartitionedSource
from spark_examples_tpu_torch.ingest.source import (
    EmptyShare,
    WindowSource,
    close_source,
    partition_ranges,
    window_for_process,
)
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ingest.vcf import VcfSource
from spark_examples_tpu_torch.ops import braycurtis_kernel, distances, gram
from spark_examples_tpu_torch.parallel import gram_sharded
from spark_examples_tpu_torch.store import open_store
from spark_examples_tpu_torch.utils import oracle


def finalize_field(acc: dict, metric: str, field: str) -> torch.Tensor:
    """One finalized matrix ("similarity" or "distance"), left on the
    accumulators' device."""
    return distances.finalize(acc, metric)[field]


def build_source(cfg: IngestConfig, device: str = "cuda"):
    """IngestConfig -> GenotypeSource, with the QC filter and then LD
    pruning layered on as the config asks (QC first: monomorphic and
    high-missing variants are its job). LD pruning's r^2 products run on
    ``device``.

    In a job of several processes (joined here, before the job touches
    its device) the source is this rank's partition of the input
    (:func:`_build_local_partition`); the filters then apply per
    partition, so LD windows do not reach across partition boundaries
    (as they do not across contigs)."""
    meshes.maybe_init_distributed(device)
    if meshes.process_count() > 1:
        src = _build_local_partition(cfg, device)
    else:
        src = _build_raw_source(cfg, device)
    if cfg.maf > 0.0 or cfg.max_missing < 1.0:
        src = FilteredSource(src, maf=cfg.maf, max_missing=cfg.max_missing)
    if cfg.ld_r2 > 0.0:
        carry = cfg.ld_carry or max(1, cfg.ld_window // 4)
        src = LdPruneSource(src, r2=cfg.ld_r2, window=cfg.ld_window,
                            carry=carry, device=device)
    return src


def _build_local_partition(cfg: IngestConfig, device: str):
    """This rank's share of the input. File sources with
    ``--references``: each range split into one sub-range per rank
    (``partition_ranges``), this rank keeping its index's share of every
    range (an empty share streams nothing). Random-access sources
    (synthetic, the packed and dataset stores): a block-aligned variant
    window. A VCF or parquet file without references would have every
    rank parse all of it to keep a slice, so it is refused with the fix
    named."""
    p, n_proc = meshes.process_index(), meshes.process_count()
    if cfg.source in ("vcf", "plink", "parquet", "store") and cfg.references:
        mine = []
        for ref in cfg.references:
            mine.extend(partition_ranges([ref], n_proc)[p::n_proc])
        if not mine:
            return EmptyShare(_build_raw_source(cfg, device))
        return _build_raw_source(dataclasses.replace(cfg, references=mine),
                                 device)
    if cfg.source in ("vcf", "parquet"):
        raise ValueError(
            f"multi-host {cfg.source} ingest needs --references so each "
            "process can read only its genomic range; alternatively "
            "`pack` the file once and run the job from the packed store"
        )
    src = _build_raw_source(cfg, device)
    start, stop = window_for_process(src.n_variants, cfg.block_variants, p,
                                     n_proc)
    return WindowSource(src, start, stop)


def _maybe_partitioned(cls, cfg: IngestConfig):
    """A range-filterable file source, split into concurrent sub-range
    readers when ``--splits-per-contig`` asks (read concurrently,
    consumed in range order: the same stream as one reader for
    position-sorted, non-overlapping ranges)."""
    if cfg.splits_per_contig > 1 and cfg.references:
        parts = [cls(cfg.path, references=(r,))
                 for r in partition_ranges(cfg.references,
                                           cfg.splits_per_contig)]
        return PartitionedSource(parts, max_workers=cfg.ingest_workers)
    return cls(cfg.path, references=tuple(cfg.references))


def _maybe_retrying(src, cfg: IngestConfig, reopen=None):
    """Wrap a file-backed source in the transient-IO retry boundary
    (ingest/resilient.py): a flaky read re-opens the source and seeks
    back to the cursor instead of killing the job. ``io_retries = 0``
    disables it. ``reopen`` (a fresh-source factory) is required for
    sources whose mapping lives on the object (the packed and dataset
    stores): without it a retry would re-slice the same dead mapping."""
    if cfg.io_retries <= 0:
        return src
    return RetryingSource(
        src,
        policy=RetryPolicy(max_retries=cfg.io_retries,
                           backoff_s=cfg.io_retry_backoff_s),
        # The rank in the jitter seed: ranks on one flaky filesystem must
        # not retry in lockstep.
        seed=cfg.seed + meshes.process_index(),
        reopen=reopen,
    )


def _open_store(cfg: IngestConfig, device: str):
    """The dataset store at ``cfg.path``, restricted to
    ``--references`` through its position index (no chunk touched).
    An inline heal from the origin runs on ``device``."""
    src = open_store(cfg.path,
                     cache_bytes=cfg.store_cache_mb << 20,
                     readahead_chunks=cfg.readahead_chunks,
                     readahead_chunks_max=cfg.readahead_chunks_max,
                     replicas=tuple(cfg.store_replicas),
                     device=device)
    if cfg.references:
        return src.restrict(cfg.references)
    return src


def _build_raw_source(cfg: IngestConfig, device: str):
    if cfg.source == "synthetic":
        return SyntheticSource(
            n_samples=cfg.n_samples,
            n_variants=cfg.n_variants,
            n_populations=cfg.n_populations,
            seed=cfg.seed,
        )
    if not cfg.path:
        raise ValueError(
            f"{cfg.source} source requires --path (a .vcf/.vcf.gz file, "
            "a PLINK fileset prefix or .bed path, a packed store "
            "directory, a .parquet variant table, or a dataset store "
            "directory — also spelled --source store:<dir>)"
        )
    if cfg.source == "vcf":
        return _maybe_retrying(_maybe_partitioned(VcfSource, cfg), cfg)
    if cfg.source == "plink":
        return _maybe_retrying(_maybe_partitioned(PlinkSource, cfg), cfg)
    if cfg.source == "packed":
        return _maybe_retrying(load_packed(cfg.path), cfg,
                               reopen=lambda: load_packed(cfg.path))
    if cfg.source == "store":
        return _maybe_retrying(_open_store(cfg, device), cfg,
                               reopen=lambda: _open_store(cfg, device))
    if cfg.source == "parquet":
        from spark_examples_tpu_torch.ingest.parquet import ParquetSource

        return _maybe_retrying(_maybe_partitioned(ParquetSource, cfg), cfg)
    raise ValueError(f"unknown source {cfg.source!r}")


@dataclass
class SimilarityResult:
    similarity: np.ndarray
    distance: np.ndarray
    sample_ids: list[str]
    metric: str
    timer: PhaseTimer
    n_variants: int


@dataclass
class GramRun:
    """A finished accumulation whose (N, N) state is still on the
    device(s): whole tensors, or ``Tiled`` leaves under a tile2d plan."""

    acc: dict
    sample_ids: list[str]
    metric: str
    timer: PhaseTimer
    n_variants: int
    lowering: str
    plan: gram_sharded.GramPlan


def plan_for_job(job: JobConfig, source) -> gram_sharded.GramPlan:
    """The distribution plan the job runs under: its mesh (the default
    slots of ``--device`` on every rank, shaped by ``--mesh-shape``) and
    mode (``--gram-mode``). Across ranks the plan is checked (a sample
    count the tiles cannot split is refused on every rank) before the
    ranks agree, in one control round, that each has the same slot
    count."""
    from spark_examples_tpu_torch.parallel import multihost as mh

    meshes.maybe_init_distributed(job.compute.device)
    device = resolve_device(job.compute.device)
    mesh = meshes.job_mesh(device, job.compute.mesh_shape)
    plan = gram_sharded.plan_for(mesh, source.n_samples,
                                 job.compute.metric or "ibs",
                                 job.compute.gram_mode,
                                 processes=meshes.process_count())
    if plan.processes > 1:
        slots = mh.allgather(np.int64(len(mesh.local_slots)))
        if len(set(slots.tolist())) > 1:
            raise ValueError(
                f"the ranks have {slots.tolist()} mesh slots each: a job of "
                "several processes needs the same slot count on every rank "
                "(the same --virtual-devices, one card a rank)")
    return plan


def run_gram(job: JobConfig, source, timer: PhaseTimer,
             plan: gram_sharded.GramPlan | None = None,
             on_block=None) -> GramRun:
    """Stream the cohort through the accumulators under ``plan`` (the
    job's own by default): one update per block through the resolved
    lowering, on every slot of the mesh. With ``--checkpoint-dir`` the
    stream starts at the cursor of the checkpoint found there, from its
    accumulators and stream statistics, and a checkpoint is saved every
    ``--checkpoint-every-blocks`` blocks after a sync of every slot.

    ``on_block(acc, blocks_done, meta)``: called after each block's
    update (the streaming PCoA refreshes its subspace there); it must
    treat ``acc`` as read-only."""
    cfg = job.compute
    device = resolve_device(cfg.device)
    if plan is None:
        plan = plan_for_job(job, source)
    n = source.n_samples
    metric = cfg.metric or "ibs"
    kern = kernels.get(metric)
    packed = kernels.streams_packed(metric, cfg.pack_stream)
    bv = job.ingest.block_variants
    # The tile2d transport is resolved once per job; the ring's
    # divisibility is checked where the block shape is known.
    transport = gram_sharded.resolve_transport(plan, cfg.tile2d_transport)
    if transport == "ring":
        from spark_examples_tpu_torch.ingest.prefetch import padded_width

        # The ring rotates the global block: every rank's slab.
        gram_sharded.check_ring_divisible(
            padded_width(bv, pack=packed, pad_multiple=plan.block_shards)
            * plan.mesh.processes, plan, packed)
    lowering = gram.resolve_gram_lowering(cfg.gram_lowering, packed, device,
                                          metric)
    telemetry.gauge_set("gram.lowering", 1.0 if lowering == "fused" else 0.0)
    update = gram_sharded.make_update(plan, metric, packed=packed,
                                      grm_precise=cfg.grm_precise,
                                      transport=transport, lowering=lowering)
    # Only value-scaled kernels on a dense stream read the largest value;
    # a resumed job starts from the saved one, so the int32 guard sees
    # the whole stream's.
    stream_stats = ({} if kern.value_scaled_budget and not packed
                    else None)
    acc, start_variant = None, 0
    if cfg.checkpoint_dir:
        restored = ckpt.load(cfg.checkpoint_dir, metric, source.sample_ids,
                             block_variants=bv, plan=plan)
        if restored is not None:
            acc, start_variant, saved_stats = restored
            if stream_stats is not None:
                stream_stats.update(saved_stats)
            if meshes.process_index() > 0 and not plan.tiled:
                # Rank 0 carries the restored global sums; the others
                # add their partials from zero. (Tiles are global sums:
                # each rank restored its own.)
                acc = {k: torch.zeros_like(v) for k, v in acc.items()}
    if acc is None:
        acc = gram_sharded.init_sharded(plan, n, metric)

    def save(state, cursor):
        ckpt.save(cfg.checkpoint_dir, state, cursor, metric, bv,
                  source.sample_ids, stream_stats=stream_stats, plan=plan)

    if plan.processes > 1:
        return _run_gram_multihost(
            job, source, timer, plan, update, acc, start_variant, packed,
            lowering, stream_stats, on_block,
            save if cfg.checkpoint_dir else None)
    acc, n_variants = run_pass(
        job, source, timer, plan.mesh.home, update, acc, start_variant,
        packed, block_flops=lambda v: gram.flops_per_block(n, v, metric),
        save_cb=save if cfg.checkpoint_dir else None, stats=stream_stats,
        on_block=on_block, pad_multiple=plan.block_shards)
    _check_int32_budget(metric, n_variants,
                        (stream_stats or {}).get("max_value", 2))
    return GramRun(acc, source.sample_ids, metric, timer, n_variants,
                   lowering, plan)


def _run_gram_multihost(job: JobConfig, source, timer: PhaseTimer, plan,
                        update, acc: dict, start_variant: int, packed: bool,
                        lowering: str, stream_stats, on_block,
                        save_cb) -> GramRun:
    """The multi-process tail of :func:`run_gram`: this rank's partition
    streamed by the consensus feeder, one loop step per step of the
    global grid (so hooks and checkpoints fire on JAX's cadence).

    Variant and replicated plans: into this rank's partial sums. A pad
    step (this rank's partition is drained) launches no update: its
    all-MISSING slab would add zeros. It still counts one
    ``gram.fused_blocks`` under the fused lowering (one per global step,
    JAX's meaning) and is a ``gram.pad_step`` event, not a ``gram.block``
    span. ``on_block`` sees the global accumulators (a
    :class:`~parallel.multihost.ReducedView`), a checkpoint saves them
    (rank 0 writes them; cursors are per rank), and the partials are
    summed in place at the end (the ``allreduce`` phase).

    tile2d across ranks: every step is an update on every rank (a
    collective: the global block is every rank's slab), a pad slab
    included; the tiles are global sums, so ``on_block`` and a checkpoint
    see them as they are (each rank saves its own), and nothing is
    reduced at the end.

    Operation and byte credit count this rank's own variants. The job's
    ``n_variants`` is the sum of the ranks' cursors and ``max_value``
    their max, both before the int32 budget check."""
    from spark_examples_tpu_torch.ingest.bitpack import packed_width
    from spark_examples_tpu_torch.parallel import multihost as mh

    cfg = job.compute
    n = source.n_samples
    metric = cfg.metric or "ibs"
    bv = job.ingest.block_variants
    blocks_done = 0
    last_stop = start_variant
    tiled = plan.tiled
    feed = closing(mh.stream_global_blocks(
        source, bv, start_variant, plan, packed, stats=stream_stats,
        prefetch=job.ingest.prefetch_blocks))
    with timer.phase("gram"), feed as blocks:
        sp = telemetry.begin("gram.block", cat="gram")
        for block, meta in blocks:
            blocks_done += 1
            if tiled or meta is not None:
                acc = update(acc, block)
            if meta is not None:
                w_local = meta.stop - meta.start
                timer.add("gram_flops",
                          gram.flops_per_block(n, w_local, metric))
                timer.add("ingest_bytes",
                          n * (packed_width(w_local) if packed
                               else w_local))
                last_stop = meta.stop
            elif lowering == "fused" and not tiled:
                telemetry.count("gram.fused_blocks", 1)
            if on_block is not None:
                on_block(acc if tiled else mh.ReducedView(acc), blocks_done,
                         meta)
            if (save_cb is not None and cfg.checkpoint_every_blocks
                    and blocks_done % cfg.checkpoint_every_blocks == 0):
                hard_sync(acc)
                save_cb(acc if tiled else mh.reduce_acc(acc), last_stop)
            if meta is not None:
                sp.end(index=blocks_done, stop=meta.stop)
            else:
                sp.cancel()
                telemetry.event("gram.pad_step", cat="gram",
                                index=blocks_done)
            sp = telemetry.begin("gram.block", cat="gram")
        sp.cancel()
        acc = hard_sync(acc)
    if not tiled:
        with timer.phase("allreduce"):
            acc = hard_sync(mh.reduce_acc(acc, inplace=True))
    n_variants = int(mh.allgather(np.int64(last_stop)).sum())
    if stream_stats is not None:
        stream_stats["max_value"] = int(mh.allgather(
            np.int64(stream_stats.get("max_value", 0))).max())
    _check_int32_budget(metric, n_variants,
                        (stream_stats or {}).get("max_value", 2))
    return GramRun(acc, source.sample_ids, metric, timer, n_variants,
                   lowering, plan)


def run_pass(job: JobConfig, source, timer: PhaseTimer, device, update,
             state: dict, start_variant: int = 0, packed: bool = False,
             block_flops=None, save_cb=None, stats: dict | None = None,
             on_block=None, pad_multiple: int = 1):
    """One streamed pass over the cohort from ``start_variant``, under
    the ``gram`` phase: ``state = update(state, block)`` for each block
    (the gram accumulators, or the sketch solver's (N, r) state).

    ``block_flops(v)``: the operation credit of a block spanning ``v``
    variants (the true span, not the padded width). ``save_cb(state,
    cursor)``: the checkpoint hook, called every
    ``--checkpoint-every-blocks`` blocks after a device sync.
    ``stats``: the feed's stream statistics (``max_value``), updated in
    place. ``on_block(state, blocks_done, meta)``: a read-only hook after
    each block's update, before its checkpoint. ``pad_multiple``: the
    plan's variant shards, which every block's width is padded to a
    multiple of. Returns ``(state, n_variants)`` with the state synced.
    """
    cfg = job.compute
    blocks_done = 0
    last_stop = start_variant
    # closing(): a failed update stops the feed's producer at once, not
    # when the traceback lets go of the generator.
    feed = closing(stream_to_device(
        source, job.ingest.block_variants, device,
        start_variant=start_variant, pack=packed, stats=stats,
        prefetch=job.ingest.prefetch_blocks, pad_multiple=pad_multiple,
    ))
    with timer.phase("gram"), feed as blocks:
        # Each span is begun before the block is pulled, so it holds the
        # wait for the feed as well as the work.
        sp = telemetry.begin("gram.block", cat="gram")
        for block, meta in blocks:
            state = update(state, block)
            if block_flops is not None:
                timer.add("gram_flops", block_flops(meta.stop - meta.start))
            timer.add("ingest_bytes", block.numel())
            blocks_done += 1
            last_stop = meta.stop
            if on_block is not None:
                on_block(state, blocks_done, meta)
            if (save_cb is not None and cfg.checkpoint_every_blocks
                    and blocks_done % cfg.checkpoint_every_blocks == 0):
                hard_sync(state)
                save_cb(state, meta.stop)
            if meta.stop > meta.start:
                sp.end(index=blocks_done, stop=meta.stop)
            else:  # a padding slab: no block time to record
                sp.cancel()
                telemetry.event("gram.pad_step", cat="gram",
                                index=blocks_done)
            sp = telemetry.begin("gram.block", cat="gram")
        sp.cancel()  # the last span saw only the stream's end
        state = hard_sync(state)
    n_variants = last_stop if last_stop > 0 else source.n_variants
    return state, n_variants


@contextmanager
def job_source(job: JobConfig, source, timer: PhaseTimer):
    """The job's source: ``source`` itself when given (its caller owns
    it), else one built from ``job.ingest`` under the ``ingest_setup``
    phase and closed when the job ends, so a store's readahead threads
    end with the job."""
    if source is not None:
        yield source
        return
    with timer.phase("ingest_setup"):
        source = build_source(job.ingest, job.compute.device)
    try:
        yield source
    finally:
        close_source(source)


def run_similarity(job: JobConfig, source=None) -> SimilarityResult:
    """Stream the cohort and produce the pairwise similarity + distance
    matrices on the host."""
    timer = PhaseTimer()
    metric = job.compute.metric or "ibs"
    with job_source(job, source, timer) as source:
        # Table-family kernels (braycurtis) carry their own dense-table
        # runner instead of riding the gram accumulator.
        table = kernels.get(metric).table_runner
        if table is not None:
            dist = table(job, source, timer).cpu().numpy()
            return SimilarityResult(1.0 - dist, dist, source.sample_ids,
                                    metric, timer, source.n_variants)
        if job.compute.backend == "cpu-reference":
            return _run_similarity_cpu(job, source, timer)
        plan = plan_for_job(job, source)
        check_gatherable(plan)
        g = run_gram(job, source, timer, plan=plan)
    with timer.phase("finalize"):
        if g.plan.tiled:
            # Finalized tile by tile; only the host gathers the whole
            # matrices, which are this job's output.
            from spark_examples_tpu_torch.parallel.pcoa_sharded import (
                finalize_tiles,
            )

            out = finalize_tiles(g.plan, g.acc, metric,
                                 ("similarity", "distance"))
            sim, dist = (out[f].full("cpu").numpy()
                         for f in ("similarity", "distance"))
        else:
            out = hard_sync(distances.finalize(g.acc, metric))
            sim = out["similarity"].cpu().numpy()
            dist = out["distance"].cpu().numpy()
    return SimilarityResult(sim, dist, g.sample_ids, metric, timer,
                            g.n_variants)


def check_gatherable(plan: gram_sharded.GramPlan) -> None:
    """Refuse, before the stream, a route that needs the whole N x N
    matrix (the similarity job's output, the dense eigh) under tile2d
    across ranks: no rank holds more than its own tiles, and the JAX
    package's ``fetch_replicated`` raises on such a matrix after the
    stream."""
    if plan.tiled and plan.mesh.spans_processes:
        raise ValueError(
            f"the {plan.mesh.shape[0]}x{plan.mesh.shape[1]} tile2d mesh "
            f"spans {plan.processes} processes, each holding only its own "
            "tiles of the N x N matrix: a route that needs the whole "
            "matrix (the similarity job's output, pcoa --eigh-mode dense) "
            "cannot fetch it — run pcoa/pca (the sharded solve) across "
            "the ranks, or --gram-mode variant for the whole matrix"
        )


def _run_similarity_cpu(job: JobConfig, source,
                        timer: PhaseTimer) -> SimilarityResult:
    """The host oracle's similarity (``--backend cpu-reference``, the
    measured stand-in for the Spark MLlib baseline): float64 raw
    products accumulated block by block from ``source.blocks()``, the
    oracle's combine, the kernel's ``np_finalize``. A float kernel (grm)
    takes its whole-matrix oracle instead (its allele frequencies need
    the full table) and the f32 Gower transform of the JAX package's
    route."""
    resolve_device(job.compute.device)
    metric = job.compute.metric or "ibs"
    n = source.n_samples
    kern = kernels.get(metric)
    if kern.family == "float":
        with timer.phase("gram"):
            g = kern.oracle_similarity(
                _materialize(source, job.ingest.block_variants))
        return SimilarityResult(g, oracle.gower_f32(g), source.sample_ids,
                                metric, timer, source.n_variants)
    acc = {k: np.zeros((n, n)) for k in kern.pieces}
    with timer.phase("gram"):
        for block, _meta in source.blocks(job.ingest.block_variants):
            prods = oracle.cpu_gram_products(block, kern.pieces)
            for k in acc:
                acc[k] += prods[k]
            timer.add("gram_flops", kern.flops(n, block.shape[1]))
    with timer.phase("finalize"):
        out = oracle.cpu_finalize(
            oracle.combine_products(acc, kern.stats), metric)
    return SimilarityResult(out["similarity"], out["distance"],
                            source.sample_ids, metric, timer,
                            source.n_variants)


def _materialize(source, block_variants: int) -> np.ndarray:
    """The source's whole (N, F) int8 table, block by block."""
    return np.concatenate([b for b, _ in source.blocks(block_variants)],
                          axis=1)


def braycurtis_distance(job: JobConfig, source,
                        timer: PhaseTimer) -> torch.Tensor:
    """The Bray-Curtis (N, N) distance, left on the job's device: the
    dense (N, F) table (the dosage matrix doubles as the count table;
    missing counts as absence), lowered by the resolved
    ``--braycurtis-method``. Under ``--backend cpu-reference`` it is
    scipy's float64 ``pdist`` on the host (a CPU tensor)."""
    cfg = job.compute
    device = resolve_device(cfg.device)
    method = distances.resolve_braycurtis_method(cfg.braycurtis_method,
                                                 device)
    host = cfg.backend == "cpu-reference"
    with timer.phase("ingest"):
        x = np.maximum(_materialize(source, job.ingest.block_variants), 0)
        if not host:
            # int8 over the link, widened on the device.
            table = hard_sync(
                torch.from_numpy(x).to(device).to(torch.float32))
    if host:
        with timer.phase("distance"):
            return torch.from_numpy(oracle.cpu_braycurtis(x))
    with timer.phase("distance"):
        if method == "matmul":
            d = distances.braycurtis_matmul(table,
                                            levels=cfg.braycurtis_levels)
        elif method == "fused":
            d = braycurtis_kernel.braycurtis_kernel(table)
        else:
            d = distances.braycurtis(table)
        d = hard_sync(d)
    check_nans("distance", d)
    return d


def _check_int32_budget(metric: str, n_variants: int,
                        max_value: int = 2) -> None:
    """Warn when a stream outruns the int32 accumulators' exactness bound:
    counts are bit-exact while the kernel's worst per-variant increment
    times the variant count stays below 2^31. Value-scaled kernels
    (dot/euclidean on arbitrary int8 tables) are bounded by
    ``max_value^2`` (the feed tracks it); float kernels (grm) round
    rather than wrap and are exempt."""
    kern = kernels.get(metric)
    if kern.max_increment is None:
        return
    inc = kern.max_increment
    if kern.value_scaled_budget:
        inc = max(inc, max(1, int(max_value)) ** 2)
    if inc * n_variants >= 2**31:
        warnings.warn(
            f"metric {metric!r}: {n_variants} variants with per-variant "
            f"increment bound {inc} exceeds the int32 accumulator budget "
            f"(2^31) — pairwise counts may have wrapped; split the stream "
            "into shorter jobs and merge finalized statistics instead",
            RuntimeWarning,
            stacklevel=2,
        )
