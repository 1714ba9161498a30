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

``--backend cpu-reference`` routes a similarity through the NumPy
oracle instead (``utils/oracle.py``): host blocks from
``source.blocks()``, float64 products, the kernels' ``np_finalize``
twins, scipy's Bray-Curtis. It touches no device; the job's
``--device`` is still resolved, so a missing card fails as it does on
the device route.
"""

from __future__ import annotations

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
from spark_examples_tpu_torch.ingest.source import close_source
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
    ``device``."""
    src = _build_raw_source(cfg, device)
    if cfg.maf > 0.0 or cfg.max_missing < 1.0:
        src = FilteredSource(src, maf=cfg.maf, max_missing=cfg.max_missing)
    if cfg.ld_r2 > 0.0:
        carry = cfg.ld_carry or max(1, cfg.ld_window // 4)
        src = LdPruneSource(src, r2=cfg.ld_r2, window=cfg.ld_window,
                            carry=carry, device=device)
    return src


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
        seed=cfg.seed,
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
        return _maybe_retrying(
            VcfSource(cfg.path, references=tuple(cfg.references)), cfg)
    if cfg.source == "plink":
        return _maybe_retrying(
            PlinkSource(cfg.path, references=tuple(cfg.references)), cfg)
    if cfg.source == "packed":
        return _maybe_retrying(load_packed(cfg.path), cfg,
                               reopen=lambda: load_packed(cfg.path))
    if cfg.source == "store":
        return _maybe_retrying(_open_store(cfg, device), cfg,
                               reopen=lambda: _open_store(cfg, device))
    if cfg.source == "parquet":
        from spark_examples_tpu_torch.ingest.parquet import ParquetSource

        return _maybe_retrying(
            ParquetSource(cfg.path, references=tuple(cfg.references)), cfg)
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
    slots of ``--device``, shaped by ``--mesh-shape``) and mode
    (``--gram-mode``)."""
    device = resolve_device(job.compute.device)
    mesh = meshes.make_mesh(meshes.default_devices(device),
                            shape=job.compute.mesh_shape)
    return gram_sharded.plan_for(mesh, source.n_samples,
                                 job.compute.metric or "ibs",
                                 job.compute.gram_mode)


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

        gram_sharded.check_ring_divisible(
            padded_width(bv, pack=packed, pad_multiple=plan.block_shards),
            plan, packed)
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
    if acc is None:
        acc = gram_sharded.init_sharded(plan, n, metric)

    def save(state, cursor):
        ckpt.save(cfg.checkpoint_dir, state, cursor, metric, bv,
                  source.sample_ids, stream_stats=stream_stats, plan=plan)

    acc, n_variants = run_pass(
        job, source, timer, plan.mesh.home, update, acc, start_variant,
        packed, block_flops=lambda v: gram.flops_per_block(n, v, metric),
        save_cb=save if cfg.checkpoint_dir else None, stats=stream_stats,
        on_block=on_block, pad_multiple=plan.block_shards)
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
        g = run_gram(job, source, timer)
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
