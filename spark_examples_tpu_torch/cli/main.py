"""Command-line entry: ``python -m spark_examples_tpu_torch
{pcoa,pca,similarity,project,cross-kinship,pack,ingest,store,telemetry,
search-variants,sample-stats,coverage,neighbors,serve,lint}``.

Flag names and defaults follow the JAX package's CLI for the flags the
ported paths read, plus ``--device {cuda,cpu}`` (default cuda; a missing
card raises). Every job command takes the telemetry flags
(``--telemetry-dir``, ``--trace-events``, ``--trace-sample``,
``--telemetry-flush-s``, ``--live-port``) and ``--trace-dir``, a
``torch.profiler`` capture of the whole job, and ``--debug-nans`` (a NaN
check at each phase boundary). ``--backend cpu-reference`` runs
similarity, pcoa and pca on the host NumPy oracle instead of the device
route (``--backend jax-tpu``, the JAX package's name for it).

    python -m spark_examples_tpu_torch pcoa --n-samples 2504 \\
        --n-variants 100000 --metric ibs --num-pc 10 --output-path coords.tsv
    python -m spark_examples_tpu_torch pcoa --source plink --path cohort \\
        --maf 0.01 --max-missing 0.1 --ld-prune-r2 0.2 --metric grm
    python -m spark_examples_tpu_torch pack --source vcf --path c.vcf.gz \\
        --output-path store/
    python -m spark_examples_tpu_torch similarity --source packed \\
        --path store/ --metric king --output-path king.npy
    python -m spark_examples_tpu_torch ingest --source vcf --path c.vcf \\
        --output-path ds/ --store-codec zlib
    python -m spark_examples_tpu_torch pcoa --source store:ds/ --metric ibs
    python -m spark_examples_tpu_torch store heal --path ds/ --verify-all
    python -m spark_examples_tpu_torch pca --n-samples 2504 \\
        --n-variants 100000 --num-pc 10
    python -m spark_examples_tpu_torch pcoa --checkpoint-dir ck \\
        --checkpoint-every-blocks 4      # killed? the rerun resumes
    python -m spark_examples_tpu_torch similarity --output-path d.npy
    python -m spark_examples_tpu_torch pcoa --matrix-path d.npy
    python -m spark_examples_tpu_torch pcoa --solver corrected \\
        --sketch-rank 64 --sketch-iters 2 --source store:ds/
    python -m spark_examples_tpu_torch pcoa --source store:panel/ \\
        --save-model m.npz              # fit the panel once, then:
    python -m spark_examples_tpu_torch project --model m.npz \\
        --ref-source store:panel/ --source vcf --path new.vcf.gz
    python -m spark_examples_tpu_torch cross-kinship --source plink \\
        --path new --ref-source store:panel/ --output-path phi.tsv
    python -m spark_examples_tpu_torch pcoa --source parquet \\
        --path cohort.parquet
    python -m spark_examples_tpu_torch pcoa --stream-refresh-blocks 4
    python -m spark_examples_tpu_torch search-variants --source store:ds/ \\
        --positions 33200 41100 --output-path hist.tsv
    python -m spark_examples_tpu_torch sample-stats --output-path qc.tsv
    python -m spark_examples_tpu_torch coverage \\
        --references chr22:16050000:16150000 --output-path depth.tsv
    python -m spark_examples_tpu_torch neighbors --source store:ds/ \\
        --metric ibs --neighbors-k 10 --output-path nb.topk
    python -m spark_examples_tpu_torch neighbors --model m.npz \\
        --ref-source store:panel/ --source vcf --path new.vcf.gz
    python -m spark_examples_tpu_torch serve --model m.npz \\
        --ref-source store:panel/ --port 8777 --telemetry-dir tel/
    python -m spark_examples_tpu_torch serve --model m.npz \\
        --ref-source store:panel/ --source vcf --path new.vcf.gz \\
        --loadgen 4 --loadgen-requests 50
    python -m spark_examples_tpu_torch pcoa --source store:ds/ \\
        --telemetry-dir tel/ --trace-dir prof/
    python -m spark_examples_tpu_torch similarity --source store:ds/ \\
        --checkpoint-dir ck --checkpoint-every-blocks 4 \\
        --telemetry-dir tel/ --output-path d.npy --supervise
    python -m spark_examples_tpu_torch telemetry stitch --path tel/
    python -m spark_examples_tpu_torch serve --fleet fleet.json \\
        --port 8777 --fleet-budget-mb 512
    python -m spark_examples_tpu_torch pcoa --backend cpu-reference
    python -m spark_examples_tpu_torch telemetry timeline --path fleetdir/
    python -m spark_examples_tpu_torch telemetry stitch --fleet \\
        --path fleetdir/     # a fleet controller's workdir (fleet/)
    python -m spark_examples_tpu_torch lint   # graftlint over the port

``--supervise`` re-invokes the command as a watched child and restarts
it on a crash, hang or stall (it resumes from its checkpoint); the
parent holds no device. ``lint`` runs the port's graftlint suite
(``tools/graftlint``) and touches no device: it takes no ``--device``,
and it is dispatched before anything that imports torch (this module
imports none at module level; each verb's handler imports what it
uses), as the JAX package's CLI dispatches it before any jax import.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from typing import TYPE_CHECKING

import numpy as np

from spark_examples_tpu_torch import __version__

if TYPE_CHECKING:
    from spark_examples_tpu_torch.core.config import JobConfig
    from spark_examples_tpu_torch.core.profiling import PhaseTimer

# ComputeConfig fields that only the neighbors command has flags for.
_NEIGHBORS_FLAGS = ("neighbors_output", "neighbors_k", "minhash_hashes",
                    "minhash_bands", "minhash_seed", "minhash_bucket_cap")


def _source_arg(value: str) -> str:
    """``--source`` and ``--ref-source``: a source name, or
    ``store:<dir>`` (the dataset store at <dir>)."""
    from spark_examples_tpu_torch.core.config import SOURCES as _SOURCES

    base, sep, rest = value.partition(":")
    if base not in _SOURCES or (sep and base != "store"):
        raise argparse.ArgumentTypeError(
            f"invalid source {value!r} (choose from "
            f"{', '.join(_SOURCES)}, or store:<dir>; other sources "
            "take --path)"
        )
    if sep and not rest:
        raise argparse.ArgumentTypeError(
            "bad source 'store:': expected store:<dir> (the compacted "
            "store directory)"
        )
    return value


def _add_common(p: argparse.ArgumentParser) -> None:
    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.core import config
    from spark_examples_tpu_torch.core.device import DEVICES

    _SOURCES = config.SOURCES
    g = p.add_argument_group("ingest")
    g.add_argument("--source", default="synthetic", type=_source_arg,
                   metavar="{" + ",".join(_SOURCES) + "}",
                   help="genotype source; store:<dir> reads the dataset "
                   "store at <dir>; parquet reads a wide variant-by-"
                   "sample table (needs pyarrow)")
    g.add_argument("--path", default=None,
                   help="input for vcf (.vcf/.vcf.gz), plink (fileset "
                   "prefix or .bed path), packed (packed store "
                   "directory), parquet (.parquet variant table) or "
                   "store (dataset store directory) sources")
    g.add_argument("--references", nargs="*", default=[],
                   metavar="CONTIG:START:END",
                   help="genomic ranges to ingest (vcf, plink, parquet "
                   "and store; a store answers them from its position "
                   "index, parquet prunes row groups by their column "
                   "statistics)")
    g.add_argument("--n-samples", type=int, default=2504)
    g.add_argument("--n-variants", type=int, default=100_000)
    g.add_argument("--n-populations", type=int, default=5)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--block-variants", type=int, default=8192,
                   help="variants per streamed block (the partition size)")
    g.add_argument("--prefetch-blocks", type=int, default=2,
                   help="host->device pipeline depth (blocks queued "
                   "while earlier copies drain; minimum 1)")
    g.add_argument("--maf", type=float, default=0.0,
                   help="drop variants with minor-allele frequency below "
                   "this (QC stream filter)")
    g.add_argument("--max-missing", type=float, default=1.0,
                   help="drop variants with missing-call rate above this")
    g.add_argument("--ld-prune-r2", type=float, default=0.0,
                   help="LD-prune: drop variants whose within-window r^2 "
                   "against a kept variant exceeds this (0 = off; the "
                   "PLINK --indep-pairwise analogue)")
    g.add_argument("--ld-window", type=int, default=256,
                   help="LD pruning window (variant count)")
    g.add_argument("--ld-carry", type=int, default=0,
                   help="kept variants carried across window boundaries "
                   "(0 = auto: window/4)")
    g.add_argument("--splits-per-contig", type=int, default=1,
                   help="split each --references range into N sub-ranges "
                   "read concurrently (the reference partitioner's "
                   "FixedContigSplits); 1 disables")
    g.add_argument("--ingest-workers", type=int, default=4,
                   help="host-side ingest parallelism: concurrent range "
                   "readers for --splits-per-contig AND parse/pack/hash/"
                   "write workers for `ingest` compaction (ordered "
                   "reassembly keeps the output byte for byte the "
                   "1-worker one)")
    g.add_argument("--io-retries", type=int, default=3,
                   help="transient-IO retries per incident (consecutive "
                   "failures without a successfully read block) for "
                   "file-backed sources: a failed block read re-opens "
                   "the source and seeks back to the cursor (0 "
                   "disables; corrupt blocks always fail fast)")
    g.add_argument("--io-retry-backoff", type=float, default=0.05,
                   help="initial retry backoff in seconds (exponential "
                   "with jitter)")
    g.add_argument("--store-cache-mb", type=int, default=256,
                   help="host-RAM budget of the dataset store's decode "
                   "cache (LRU with hit/miss accounting; 0 disables)")
    g.add_argument("--readahead-chunks", type=int, default=2,
                   help="dataset-store readahead depth floor: chunks "
                   "verified and decoded ahead of the streaming cursor "
                   "by a background pool (0 disables)")
    g.add_argument("--readahead-chunks-max", type=int, default=16,
                   help="adaptive readahead ceiling: the pool deepens "
                   "from --readahead-chunks toward this while the "
                   "consumer outruns the decode (0 pins the depth at "
                   "the floor)")
    g.add_argument("--store-codec", default="zlib",
                   choices=list(config.STORE_CODEC_SPECS),
                   help="chunk payload codec for `ingest` compactions: "
                   "raw = uncompressed 2-bit payload, zlib = per-chunk "
                   "deflate, zlib-dict = deflate with a per-contig "
                   "dictionary trained during compaction; reads take "
                   "each chunk's codec from the manifest")
    g.add_argument("--store-replicas", nargs="*", default=[],
                   metavar="DIR",
                   help="peer store directories holding content-"
                   "addressed copies of the chunks: a chunk that fails "
                   "its digest verify is healed in place from a "
                   "replica (else from the manifest's recorded origin) "
                   "instead of failing the run")
    s = p.add_argument_group("supervision")
    s.add_argument("--supervise", action="store_true",
                   help="run this job as a supervised, crash-resumable "
                   "unit of work: a child process streams under a "
                   "heartbeat watchdog, and a crash, kill, hang, or "
                   "stall restarts it from the latest sha256-verified "
                   "checkpoint (pair with --checkpoint-dir/"
                   "--checkpoint-every-blocks so restarts resume "
                   "instead of recomputing); the parent holds no device")
    s.add_argument("--supervise-max-restarts", type=int, default=3,
                   help="restarts before the supervisor gives up and "
                   "exits with the last failure")
    s.add_argument("--supervise-stall-timeout", type=float, default=60.0,
                   help="seconds of frozen progress (heartbeats alive, "
                   "no forward motion) before the watchdog kills and "
                   "restarts; the effective budget never drops below "
                   "50 block-periods of the job's own reported block "
                   "p95")
    c = p.add_argument_group("compute")
    c.add_argument("--backend", default="jax-tpu",
                   choices=list(config.BACKENDS),
                   help="jax-tpu (the JAX package's name, kept so its "
                   "command lines carry over) = this package's device "
                   "route on --device: the CUDA kernels on a card; "
                   "cpu-reference = the NumPy/SciPy oracle on the host "
                   "(float64 counts, scipy Bray-Curtis), the measured "
                   "stand-in for the Spark MLlib baseline; --device is "
                   "still resolved")
    c.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="where the job runs; cuda raises when no card is "
                   "visible")
    c.add_argument("--metric", default="ibs",
                   choices=list(kernels.finalizable_names()))
    c.add_argument("--grm-precise", action="store_true",
                   help="grm: standardized dosages in f32 instead of "
                   "bf16 (~1e-3 better relative accuracy)")
    c.add_argument("--braycurtis-method", default="auto",
                   choices=list(config.BRAYCURTIS_METHODS),
                   help="braycurtis lowering: 'exact' = plain tiled "
                   "broadcast-abs-sum; 'matmul' = threshold-decomposed "
                   "products (quantised to --braycurtis-levels); 'fused' "
                   "= the Manhattan CUDA kernel; 'auto' = fused on a CUDA "
                   "device, exact elsewhere")
    c.add_argument("--braycurtis-levels", type=int, default=256)
    c.add_argument("--num-pc", type=int, default=10)
    c.add_argument("--gram-lowering", default="auto",
                   choices=list(config.GRAM_LOWERINGS),
                   help="count-family contraction lowering: 'reference' "
                   "= plain unpack-then-contract; 'fused' = the packed "
                   "CUDA kernel (bit-identical); 'auto' = fused on a "
                   "CUDA device, reference elsewhere")
    c.add_argument("--eigh-mode", default="auto",
                   choices=list(config.EIGH_MODES))
    c.add_argument("--eigh-iters", type=int,
                   default=config.EIGH_ITERS_DEFAULT,
                   help="randomized solver power iterations")
    c.add_argument("--eigh-oversample", type=int,
                   default=config.EIGH_OVERSAMPLE_DEFAULT,
                   help="randomized solver subspace oversample (k+p "
                   "probe columns)")
    c.add_argument("--solver", default="exact",
                   choices=list(config.SOLVER_LADDER),
                   help="pcoa/pca eigensolve accuracy ladder: 'exact' "
                   "materializes the N x N matrix; 'sketch' folds a "
                   "low-rank range sketch into (N, rank) state during "
                   "the single variant pass and solves from the Nystrom "
                   "core — no N x N anywhere, the route for cohorts past "
                   "one card's memory; 'corrected' adds --sketch-iters "
                   "extra streamed power-iteration passes before a "
                   "Rayleigh solve")
    c.add_argument("--sketch-rank", type=int,
                   default=config.SKETCH_RANK_DEFAULT,
                   help="sketch probe columns (>= --num-pc; clamped to "
                   "N): the r of the O(N*r) solver state")
    c.add_argument("--sketch-iters", type=int,
                   default=config.SKETCH_ITERS_DEFAULT,
                   help="extra streamed passes of the corrected rung "
                   "(each one full pass over the cohort)")
    c.add_argument("--sketch-seed", type=int, default=0,
                   help="probe RNG seed — a resumed job must keep it (the "
                   "checkpoint records it and refuses a mismatch); the "
                   "probes differ from the JAX package's for one seed")
    c.add_argument("--checkpoint-dir", default=None,
                   help="directory for accumulator checkpoints: a job "
                   "finding one there resumes from its cursor (the JAX "
                   "package's layout; either package resumes the "
                   "other's)")
    c.add_argument("--checkpoint-every-blocks", type=int, default=0,
                   help="save a checkpoint every this many blocks (0 = "
                   "never save, only resume)")
    c.add_argument("--gram-mode", default="auto",
                   choices=list(config.GRAM_MODES),
                   help="gram accumulation plan over the device mesh: "
                   "'replicated' = one device holds the N x N "
                   "accumulators; 'variant' = each slot contracts a "
                   "variant shard of every block, partials summed; "
                   "'tile2d' = the accumulators tiled over the (i, j) "
                   "mesh, finalize/center/eigensolve tiled too; 'auto' "
                   "= replicated on one slot, variant while the "
                   "accumulators fit a device, tile2d past it")
    c.add_argument("--mesh-shape", default=None, type=_mesh_shape_arg,
                   metavar="IxJ",
                   help="IxJ, e.g. 2x4 (default: a near-square factoring "
                   "of the slots: every visible card on --device cuda, "
                   "or the --virtual-devices slots)")
    c.add_argument("--tile2d-transport", default="auto",
                   choices=list(config.TILE2D_TRANSPORTS),
                   help="tile2d block reassembly: 'gather' = every slot "
                   "copies every variant shard, then contracts its tile "
                   "(one packed-gram kernel launch per tile a block); "
                   "'ring' = the shards rotate one hop per step while "
                   "each slot contracts the one it holds (D launches per "
                   "tile a block, bitwise the gather for count kernels); "
                   "'auto' = gather (no crossover where the ring wins "
                   "has been measured on H100 cards)")
    c.add_argument("--virtual-devices", type=int, default=0, metavar="N",
                   help="rehearsal only: split the one --device into N "
                   "mesh slots (the counterpart of the JAX package's "
                   "forced virtual CPU devices): every slot holds its own "
                   "tiles and runs its own launches, which shows the mesh "
                   "route on one card or the CPU, not scaling; not part "
                   "of the job's config (0 = off)")
    p.add_argument("--output-path", default=None)
    p.add_argument("--timings", action="store_true",
                   help="print per-phase timing JSON to stderr")
    t = p.add_argument_group("telemetry")
    t.add_argument("--telemetry-dir", default=None,
                   help="export structured telemetry: Chrome trace events "
                   "(rank<k>/trace.jsonl, loadable in Perfetto / "
                   "chrome://tracing), the metrics registry "
                   "(rank<k>/metrics.json: counters, gauges, "
                   "p50/p95/p99 histograms, derived throughputs) and a "
                   "summary table")
    t.add_argument("--trace-events", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="buffer per-block span events into trace.jsonl "
                   "(--no-trace-events keeps the metrics.json export but "
                   "skips the event timeline for very long streams)")
    t.add_argument("--trace-sample", type=float, default=1.0,
                   metavar="RATE",
                   help="request-trace sampling rate in [0, 1]: a served "
                   "request's trace.request span and slowest-K exemplar "
                   "entry are kept iff its trace id samples in "
                   "(deterministic on the id); 1 keeps everything, 0 "
                   "disables request tracing")
    t.add_argument("--telemetry-flush-s", type=float, default=0.0,
                   metavar="SECONDS",
                   help="publish live telemetry snapshots every this many "
                   "seconds (atomic metrics.json + rolling "
                   "live_trace.jsonl under --telemetry-dir); 0 = export "
                   "at exit only")
    t.add_argument("--live-port", type=int, default=None, metavar="PORT",
                   help="bind a live-introspection HTTP sidecar on this "
                   "port (0 = ephemeral): GET /metrics (Prometheus "
                   "text), /debug/telemetry (full live snapshot JSON), "
                   "/healthz")
    t.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the job into "
                   "this directory (a Chrome trace: host activity, and "
                   "the card's kernels on --device cuda)")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail loudly (FloatingPointError naming the "
                   "phase) when finalize, distance, centering, eigh, the "
                   "sketch or a served batch produces a NaN, instead of "
                   "emitting NaN coordinates; checked at those phase "
                   "boundaries, not at every operation (one device sync "
                   "each; off, none)")


def _add_ref_source(p: argparse.ArgumentParser) -> None:
    from spark_examples_tpu_torch.core.config import SOURCES as _SOURCES

    p.add_argument("--ref-source", default="plink", type=_source_arg,
                   metavar="{" + ",".join(_SOURCES) + "}",
                   help="reference cohort genotypes (the panel the model "
                   "was fitted on); store:<dir> works here too")
    p.add_argument("--ref-path", default=None)


def _needs_ref_path(args) -> bool:
    """Whether --ref-path is still required: synthetic generates its
    panel and store:<dir> carries the path in the source spec."""
    return (not args.ref_path and args.ref_source != "synthetic"
            and not args.ref_source.startswith("store:"))


def _job_from_args(args) -> JobConfig:
    from spark_examples_tpu_torch.core import config
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
        ReferenceRange,
    )

    return JobConfig(
        telemetry=config.TelemetryConfig(
            dir=args.telemetry_dir,
            trace_events=args.trace_events,
            flush_s=args.telemetry_flush_s,
            live_port=args.live_port,
            trace_sample=args.trace_sample,
        ),
        ingest=IngestConfig(
            source=args.source,
            path=args.path,
            references=[ReferenceRange.parse(r) for r in args.references],
            n_samples=args.n_samples,
            n_variants=args.n_variants,
            n_populations=args.n_populations,
            seed=args.seed,
            block_variants=args.block_variants,
            prefetch_blocks=args.prefetch_blocks,
            maf=args.maf,
            max_missing=args.max_missing,
            ld_r2=args.ld_prune_r2,
            ld_window=args.ld_window,
            ld_carry=args.ld_carry,
            splits_per_contig=args.splits_per_contig,
            ingest_workers=args.ingest_workers,
            io_retries=args.io_retries,
            io_retry_backoff_s=args.io_retry_backoff,
            store_cache_mb=args.store_cache_mb,
            readahead_chunks=args.readahead_chunks,
            readahead_chunks_max=args.readahead_chunks_max,
            store_codec=args.store_codec,
            store_replicas=list(args.store_replicas),
        ),
        compute=ComputeConfig(
            backend=args.backend,
            metric=args.metric,
            braycurtis_method=args.braycurtis_method,
            braycurtis_levels=args.braycurtis_levels,
            num_pc=args.num_pc,
            grm_precise=args.grm_precise,
            gram_lowering=args.gram_lowering,
            eigh_mode=args.eigh_mode,
            eigh_iters=args.eigh_iters,
            eigh_oversample=args.eigh_oversample,
            device=args.device,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every_blocks=args.checkpoint_every_blocks,
            solver=args.solver,
            sketch_rank=args.sketch_rank,
            sketch_iters=args.sketch_iters,
            sketch_seed=args.sketch_seed,
            gram_mode=args.gram_mode,
            mesh_shape=args.mesh_shape,
            tile2d_transport=args.tile2d_transport,
            **{name: getattr(args, name, getattr(ComputeConfig, name))
               for name in _NEIGHBORS_FLAGS},
        ),
        output_path=args.output_path,
        model_path=getattr(args, "save_model", None),
    )


def _add_lint_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("paths", nargs="*",
                   help="files/dirs (default: the production tree)")
    p.add_argument("--rules", default=None, metavar="ID[,ID...]")
    p.add_argument("--format", default="text", choices=["text", "json"])
    p.add_argument("--list-rules", action="store_true")


_LINT_HELP = (
    "run graftlint, the AST-based invariant analyzer suite distilled from "
    "this repo's bug history (registry-literal drift, donation safety, "
    "blocking-under-lock, atomic-write discipline, jax-import purity, "
    "telemetry/fault-site names, thread hygiene), here over the port and "
    "its registries — exit 1 on findings; see README 'Static analysis "
    "(port)'"
)


def _lint(argv: list[str]) -> int:
    """The ``lint`` verb: its own parser, so nothing that imports torch
    is loaded to parse it (the suite reads sources and registries only,
    and never touches a device)."""
    p = argparse.ArgumentParser(prog="spark_examples_tpu_torch lint",
                                description=_LINT_HELP)
    _add_lint_args(p)
    args = p.parse_args(argv)
    argv_lint = list(args.paths)
    if args.rules:
        argv_lint += ["--rules", args.rules]
    if args.list_rules:
        argv_lint += ["--list-rules"]
    argv_lint += ["--format", args.format]
    from spark_examples_tpu_torch.tools.graftlint.__main__ import (
        main as graftlint_main,
    )

    return graftlint_main(argv_lint)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["lint"]:
        return _lint(argv[1:])
    from spark_examples_tpu_torch.core import config, virtual
    from spark_examples_tpu_torch.core.config import ComputeConfig
    from spark_examples_tpu_torch.core.device import DEVICES

    _SOURCES = config.SOURCES
    parser = argparse.ArgumentParser(
        prog="spark_examples_tpu_torch",
        description="population-genomics pipelines on PyTorch/CUDA "
        "(similarity / PCoA / PCA, streaming PCoA snapshots, "
        "fit-then-project and cross-kinship, top-k neighbors, the "
        "search/sample-stats/coverage examples, the pack and ingest ETL, "
        "store maintenance, supervised crash-resumable jobs and the "
        "telemetry stitch, and single-model or fleet serving)",
    )
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_common(sub.add_parser("similarity", help="pairwise similarity "
                               "matrix"))
    p_pcoa = sub.add_parser("pcoa", help="principal coordinates analysis")
    _add_common(p_pcoa)
    p_pcoa.add_argument("--save-model", default=None,
                        help="persist the fitted embedding (.npz) so "
                        "`project` can later place new samples into "
                        "this coordinate space")
    p_pca = sub.add_parser("pca", help="flagship variants-PCA job")
    _add_common(p_pca)
    p_pca.add_argument("--save-model", default=None,
                       help="persist the fitted PCA embedding (.npz) so "
                       "`project` can later place new samples into this "
                       "coordinate space")
    p_pcoa.add_argument("--matrix-path", default=None,
                        help="consume a persisted similarity/distance "
                        "matrix (the similarity job's --output-path, .npy "
                        "or TSV) instead of streaming a cohort")
    p_pcoa.add_argument("--matrix-kind", default="auto",
                        choices=["auto", "distance", "similarity"],
                        help="what the persisted matrix holds (auto: trust "
                        "the file's sidecar, else assume distance)")
    p_pcoa.add_argument("--stream-refresh-blocks", type=int, default=0,
                        help="streaming mode: emit coordinate snapshots "
                        "every N blocks via warm rank-k subspace "
                        "refreshes (incremental PCoA)")
    p_sv = sub.add_parser("search-variants",
                          help="genotype histograms at positions")
    _add_common(p_sv)
    p_sv.add_argument("--positions", nargs="*", type=int, default=None)
    _add_common(sub.add_parser(
        "sample-stats", help="per-sample QC: call rate and heterozygosity "
        "over one streaming pass"))
    p_nb = sub.add_parser(
        "neighbors",
        help="sparse top-k nearest neighbors of a cohort: MinHash "
        "signatures folded into one streamed variant pass, LSH banding "
        "proposes candidate pairs, only those pairs are evaluated exactly "
        "through the metric's pairwise finalize, and the per-sample top-k "
        "(or the candidate edge list with --neighbors-output pairs) is "
        "written as a self-describing binary to --output-path",
    )
    _add_common(p_nb)
    p_nb.add_argument("--neighbors-output",
                      default=ComputeConfig.neighbors_output,
                      choices=list(config.NEIGHBORS_OUTPUTS),
                      help="'topk' = per-sample k best neighbors (the "
                      "default); 'pairs' = the evaluated candidate edge "
                      "list with exact similarities")
    p_nb.add_argument("--neighbors-k", type=int,
                      default=ComputeConfig.neighbors_k,
                      help="neighbors kept per sample (topk output)")
    p_nb.add_argument("--minhash-hashes", type=int,
                      default=ComputeConfig.minhash_hashes,
                      help="MinHash signature length (k seeded "
                      "permutations; a multiple of --minhash-bands)")
    p_nb.add_argument("--minhash-bands", type=int,
                      default=ComputeConfig.minhash_bands,
                      help="LSH bands: more bands (fewer rows each) = more "
                      "candidates and higher recall; fewer = stronger "
                      "filtering")
    p_nb.add_argument("--minhash-seed", type=int,
                      default=ComputeConfig.minhash_seed,
                      help="permutation seed — a resumed job must keep it "
                      "(the checkpoint records it and refuses a mismatch)")
    p_nb.add_argument("--minhash-bucket-cap", type=int,
                      default=ComputeConfig.minhash_bucket_cap,
                      help="max samples per band bucket; an over-cap "
                      "bucket keeps its first members and counts the rest "
                      "in neighbors.bucket_overflows")
    p_nb.add_argument("--model", default=None,
                      help="query-vs-panel mode: a pcoa .npz from "
                      "--save-model; the --source cohort's top-k panel "
                      "neighbors by exact similarity (no MinHash), through "
                      "the serving engine's padded-batch cross statistics")
    p_nb.add_argument("--ref-source", default="packed", type=_source_arg,
                      metavar="{" + ",".join(_SOURCES) + "}",
                      help="reference panel genotypes (query-vs-panel "
                      "mode); store:<dir> works here too")
    p_nb.add_argument("--ref-path", default=None)
    p_cov = sub.add_parser("coverage",
                           help="per-base read coverage over ranges (the "
                           "reads example)")
    p_cov.add_argument("--references", nargs="*", default=[],
                       metavar="CONTIG:START:END")
    p_cov.add_argument("--reads-source", default="synthetic",
                       choices=["synthetic", "sam"])
    p_cov.add_argument("--path", default=None, help="SAM file path")
    p_cov.add_argument("--reads-per-range", type=int, default=100_000)
    p_cov.add_argument("--read-length", type=int, default=150)
    p_cov.add_argument("--seed", type=int, default=0)
    p_cov.add_argument("--device", default="cuda", choices=list(DEVICES),
                       help="where the scatter-add and scan run; cuda "
                       "raises when no card is visible")
    p_cov.add_argument("--output-path", default=None,
                       help="write per-base depth TSV")
    p_proj = sub.add_parser(
        "project",
        help="place NEW samples into a fitted reference PCoA/PCA space "
        "(out-of-sample Nystrom extension; fit with pcoa|pca "
        "--save-model)",
    )
    _add_common(p_proj)  # --source/--path describe the NEW cohort
    p_proj.add_argument("--model", required=True,
                        help=".npz from pcoa|pca --save-model")
    _add_ref_source(p_proj)
    p_ck = sub.add_parser(
        "cross-kinship",
        help="KING-robust kinship BETWEEN two cohorts (same variant "
        "set): phi ~ 0.5 flags the same individual in both, ~0.25 "
        "first-degree relatives — the cross-dataset dedupe/QC screen",
    )
    _add_common(p_ck)  # --source/--path describe the NEW cohort
    _add_ref_source(p_ck)
    p_ck.add_argument("--min-phi", type=float, default=0.177,
                      help="console report threshold (0.177 ~ the "
                      "KING 2nd-degree cutoff); the full matrix goes "
                      "to --output-path")
    _add_common(sub.add_parser(
        "pack", help="ETL: stream any source (QC and LD pruning "
        "included) into the 2-bit packed store at --output-path; later "
        "jobs read it with --source packed --path <dir>"))
    p_ing = sub.add_parser(
        "ingest",
        help="compact any source ONCE into the content-addressed "
        "dataset store: 2-bit packed sha256-named chunk files + a JSON "
        "manifest (catalog: sample ids, contig/position index, "
        "per-chunk digests). Every later job reads it with "
        "--source store:<dir> — mmap zero-copy, range queries, "
        "verified reads",
    )
    _add_common(p_ing)
    p_ing.add_argument("--chunk-variants", type=int, default=16384,
                       help="catalog granularity: variants per chunk "
                       "file (the unit of range addressing, integrity "
                       "verification, and decode caching; must be a "
                       "multiple of 4)")
    p_store = sub.add_parser(
        "store",
        help="dataset-store maintenance. `store heal --path <dir>`: "
        "repair every quarantined chunk in place — a verified copy "
        "from a --replica dir, else a re-compaction of the chunk's "
        "origin span recorded in the manifest — re-verify against the "
        "content address, and clear the quarantine ledger entries that "
        "healed",
    )
    p_store.add_argument("verb", choices=["heal"],
                         help="maintenance action")
    p_store.add_argument("--path", required=True,
                         help="the store directory")
    p_store.add_argument("--replica", action="append", default=[],
                         metavar="DIR",
                         help="peer store directory to copy verified "
                         "chunks from (repeatable; tried before origin "
                         "re-compaction)")
    p_store.add_argument("--verify-all", action="store_true",
                         help="re-hash EVERY chunk against its content "
                         "address (not just the quarantine ledger) and "
                         "heal whatever fails")
    p_store.add_argument("--device", default="cuda", choices=list(DEVICES),
                         help="where an origin re-compaction runs (LD "
                         "pruning's r^2); cuda raises when no card is "
                         "visible")
    p_tel = sub.add_parser(
        "telemetry",
        help="telemetry maintenance. `telemetry stitch --path <dir>`: "
        "merge a job's per-attempt, per-rank exports "
        "(attempt<a>/rank<r>/trace.jsonl from supervised restarts, "
        "rank<r>/ otherwise) into ONE Perfetto-loadable session trace "
        "on a shared wall-clock timeline, with the supervisor's "
        "crash/hang/stall incidents as restart markers. `telemetry "
        "timeline --path <dir|file>`: render the fleet controller's "
        "timeline.jsonl ring (route p99 / queue depth / replica counts "
        "with incident and decision markers interleaved)",
    )
    p_tel.add_argument("verb", choices=["stitch", "timeline"],
                       help="maintenance action")
    p_tel.add_argument("--path", required=True,
                       help="stitch: the --telemetry-dir of the job (or, "
                       "with --fleet, the fleet controller's workdir); "
                       "timeline: the controller's workdir or its "
                       "timeline.jsonl")
    p_tel.add_argument("--output", default=None,
                       help="stitched trace path (default: "
                       "<path>/stitched_trace.jsonl, or "
                       "<path>/stitched_fleet_trace.jsonl with --fleet)")
    p_tel.add_argument("--fleet", action="store_true",
                       help="stitch a fleet workdir: every replica "
                       "slot's attempt/rank exports on one Perfetto "
                       "timeline, one pid block per slot, controller "
                       "incidents (controller.json + rotated .old) as "
                       "global markers")
    p_tel.add_argument("--last", type=int, default=30, metavar="N",
                       help="timeline verb: rows rendered from the "
                       "tail of the ring (default 30)")
    # Listed for --help; ``main`` dispatches the verb before this parser.
    _add_lint_args(sub.add_parser("lint", help=_LINT_HELP))
    p_srv = sub.add_parser(
        "serve",
        help="long-lived online projection server: model + reference "
        "panel staged on the device once, queries answered through a "
        "micro-batching queue (bit-identical to the offline `project`); "
        "binds a local HTTP endpoint, or with --loadgen N drives it with "
        "N closed-loop clients and prints the serving report. With "
        "--fleet: many named (model, panel) routes in one process under "
        "a budgeted warm panel pool with LRU eviction and priority-class "
        "admission",
    )
    _add_common(p_srv)  # --source/--path describe the LOADGEN query pool
    p_srv.add_argument("--model", default=None,
                       help=".npz from pcoa/pca --save-model "
                       "(single-model mode; --fleet replaces it)")
    p_srv.add_argument("--fleet", default=None, metavar="MANIFEST",
                       help="fleet manifest JSON (route registry: "
                       "name -> model path + panel source); serves "
                       "every route from one process — POST /project "
                       "with a 'route' field, or /project/<route>")
    p_srv.add_argument("--fleet-budget-mb", type=float,
                       default=config.ServeConfig.fleet_budget_mb,
                       help="warm panel pool budget (fleet mode): "
                       "staged panels past it are LRU-evicted and "
                       "re-stage on demand through the store "
                       "(fleet.restage_total counts the cold starts); "
                       "a budget_mb in the manifest wins")
    p_srv.add_argument("--queue-interactive", type=int,
                       default=config.ServeConfig.queue_interactive,
                       help="interactive-class admission bound (fleet "
                       "mode): the protected class's shed threshold")
    p_srv.add_argument("--queue-batch", type=int,
                       default=config.ServeConfig.queue_batch,
                       help="batch-class admission bound (fleet mode): "
                       "backfill sheds here first under overload while "
                       "interactive keeps admitting")
    p_srv.add_argument("--deadline-interactive-ms", type=float,
                       default=config.ServeConfig.deadline_interactive_ms,
                       help="default deadline for interactive-class "
                       "requests (fleet mode; 0 = none)")
    p_srv.add_argument("--deadline-batch-ms", type=float,
                       default=config.ServeConfig.deadline_batch_ms,
                       help="default deadline for batch-class requests "
                       "(fleet mode; 0 = none)")
    p_srv.add_argument("--ref-source", default="packed", type=_source_arg,
                       metavar="{" + ",".join(_SOURCES) + "}",
                       help="reference panel genotypes (the panel the "
                       "model was fitted on), staged on the device once; "
                       "store:<dir> works here too")
    p_srv.add_argument("--ref-path", default=None)
    p_srv.add_argument("--max-batch", type=int,
                       default=config.ServeConfig.max_batch,
                       help="micro-batch ceiling; batches are padded to "
                       "this")
    p_srv.add_argument("--max-linger-ms", type=float,
                       default=config.ServeConfig.max_linger_ms,
                       help="max wait past the first queued query while "
                       "coalescing a batch (the latency/throughput dial)")
    p_srv.add_argument("--max-queue", type=int,
                       default=config.ServeConfig.max_queue,
                       help="bounded admission queue; a full queue sheds "
                       "with an explicit ServerOverloaded (HTTP 429)")
    p_srv.add_argument("--cache-entries", type=int,
                       default=config.ServeConfig.cache_entries,
                       help="LRU result cache size, keyed by genotype "
                       "digest (0 disables)")
    p_srv.add_argument("--deadline-ms", type=float,
                       default=config.ServeConfig.deadline_ms,
                       help="default per-request deadline (0 = none); "
                       "expired requests answer DeadlineExceeded/504")
    p_srv.add_argument("--host", default=config.ServeConfig.host)
    p_srv.add_argument("--port", type=int, default=config.ServeConfig.port,
                       help="HTTP bind port (0 = ephemeral)")
    p_srv.add_argument("--loadgen", type=int, default=0, metavar="CLIENTS",
                       help="instead of serving HTTP, drive the server "
                       "with this many concurrent closed-loop clients "
                       "(queries from --source/--path) and print the "
                       "offered/sustained QPS + latency report as JSON")
    p_srv.add_argument("--loadgen-requests", type=int, default=50,
                       help="requests per loadgen client")
    p_srv.add_argument("--loadgen-seed", type=int,
                       default=config.ServeConfig.loadgen_seed,
                       help="seeds the loadgen hedge-delay ring and "
                       "burst schedule so runs replay deterministically")
    p_srv.add_argument("--drain-timeout-s", type=float,
                       default=config.ServeConfig.drain_timeout_s,
                       help="SIGTERM drain budget: admitted requests get "
                       "this long to resolve; stragglers past it fail "
                       "loudly (ServerClosed) and are counted in "
                       "serve.drain_abandoned")
    p_srv.add_argument("--port-file", default=None, metavar="PATH",
                       help="after the HTTP endpoint binds, atomically "
                       "write {\"port\": N} here (how a parent learns "
                       "an ephemeral --port 0 bind)")
    # The pca job is defined on the shared-alt similarity; any other
    # --metric would be silently ignored, so it is rejected instead.
    sub.choices["pca"].set_defaults(metric="shared-alt")
    args = parser.parse_args(argv)
    if args.command == "store":
        return _run_store_admin(args)
    if args.command == "coverage":
        return _run_coverage(args)
    if args.command == "telemetry":
        return _run_telemetry_admin(args)
    if args.command == "pca" and args.metric != "shared-alt":
        parser.error(
            "pca computes the shared-alt similarity by definition; "
            f"--metric {args.metric} is not accepted (use the similarity "
            "or pcoa subcommands for other metrics)"
        )
    try:
        job = _job_from_args(args)
    except ValueError as e:
        parser.error(str(e))
    if args.supervise:
        return _supervise(args, argv, job)
    with contextlib.ExitStack() as stack:
        if args.virtual_devices:
            stack.enter_context(virtual.virtual_slots(args.virtual_devices))
        if args.virtual_devices or args.mesh_shape:
            _print_mesh(job)
        _observe(stack, args, job)
        return _dispatch(args, job, parser)


def _mesh_shape_arg(spec: str) -> tuple[int, int]:
    """``IxJ`` -> (I, J), an argparse type."""
    try:
        i, j = spec.lower().split("x")
        shape = (int(i), int(j))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bad --mesh-shape {spec!r}: expected IxJ, e.g. 2x4") from None
    if min(shape) < 1:
        raise argparse.ArgumentTypeError(
            f"bad --mesh-shape {spec!r}: both axes must be >= 1")
    return shape


def _print_mesh(job: JobConfig) -> None:
    """Say on stderr what the job's mesh is: the slot count and the
    physical devices behind them (a mesh of virtual slots says so; one
    that spans the ranks of a job, which ranks own which slots)."""
    from spark_examples_tpu_torch.core import meshes
    from spark_examples_tpu_torch.core.device import resolve_device

    meshes.maybe_init_distributed(job.compute.device)
    mesh = meshes.job_mesh(resolve_device(job.compute.device),
                           job.compute.mesh_shape)
    print(f"mesh: {mesh.describe()}", file=sys.stderr)


def _supervise(args, argv, job: JobConfig) -> int:
    """``--supervise``: re-invoke this command (the flags stripped) as a
    watched child and restart it on crash, hang or stall. The flags the
    child reads are validated here first, and whether the device is
    there (``resolve_device``, which creates no CUDA context), so a bad
    flag or a missing card fails once, not once per restart; the parent
    does no job work and holds no device. ``--live-port`` moves to the
    parent, which proxies the children's ephemeral sidecars so the
    scrape endpoint survives restarts; ``--telemetry-dir`` (kept on the
    child) names where the parent writes its incident ledger."""
    from spark_examples_tpu_torch.core.device import resolve_device
    from spark_examples_tpu_torch.core.supervisor import supervise_cli

    resolve_device(job.compute.device)
    return supervise_cli(
        list(argv) if argv is not None else sys.argv[1:],
        max_restarts=args.supervise_max_restarts,
        stall_timeout_s=args.supervise_stall_timeout,
        live_port=job.telemetry.live_port,
        telemetry_dir=job.telemetry.dir,
    )


def _run_telemetry_admin(args) -> int:
    """The ``telemetry`` maintenance subcommand (``stitch`` — single job
    or ``--fleet`` — and ``timeline``). Prints the report as JSON; exit 0
    iff something was read."""
    from spark_examples_tpu_torch.core.stitch import (
        StitchError,
        stitch,
        stitch_fleet,
    )

    if args.verb == "timeline":
        return _run_telemetry_timeline(args)
    if args.fleet:
        try:
            report = stitch_fleet(args.path, output=args.output)
        except StitchError as e:
            print(f"telemetry stitch --fleet: {e}", file=sys.stderr)
            return 1
        print(json.dumps(report, sort_keys=True))
        print(
            f"telemetry stitch --fleet: {report['events']} events "
            f"from {len(report['slots'])} replica slot(s), "
            f"{report['incident_markers']} incident marker(s) -> "
            f"{report['output']} (open in https://ui.perfetto.dev)",
            file=sys.stderr,
        )
        return 0
    try:
        report = stitch(args.path, output=args.output)
    except StitchError as e:
        print(f"telemetry stitch: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report, sort_keys=True))
    if report["mixed_run_ids"]:
        print(
            f"telemetry stitch: WARNING — {len(report['run_ids'])} "
            "distinct run_ids merged; this directory holds exports "
            "from more than one logical job",
            file=sys.stderr,
        )
    print(
        f"telemetry stitch: {report['events']} events from "
        f"{len(report['attempts'])} attempt(s) x "
        f"{len(report['ranks'])} rank(s), "
        f"{report['restart_markers']} restart marker(s) -> "
        f"{report['output']} (open in https://ui.perfetto.dev)",
        file=sys.stderr,
    )
    return 0


def _run_telemetry_timeline(args) -> int:
    """``telemetry timeline --path <dir|file>``: the fleet flight
    recorder's read side — route p99 / queue-depth / replica-count
    history from the controller's timeline.jsonl ring, incident and
    decision markers interleaved where they happened."""
    import os

    from spark_examples_tpu_torch.fleet.timeline import read_timeline

    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "timeline.jsonl")
    records = read_timeline(path)
    if not records:
        print(f"telemetry timeline: no readable records in {path!r} "
              "(run the fleet controller with a ledger/timeline path)",
              file=sys.stderr)
        return 1
    rounds = [r for r in records if r.get("type") == "round"]
    markers = [r for r in records if r.get("type") == "marker"]
    routes: dict[str, dict] = {}
    for rec in rounds:
        for s in rec.get("slots", {}).values():
            if not s.get("present"):
                continue
            for name, r in s.get("routes", {}).items():
                agg = routes.setdefault(
                    name, {"p99_max_ms": 0.0, "p99_last_ms": 0.0})
                p99_ms = r.get("p99_s", 0.0) * 1e3
                agg["p99_max_ms"] = max(agg["p99_max_ms"], p99_ms)
                agg["p99_last_ms"] = p99_ms
    report = {
        "path": path,
        "rounds": len(rounds),
        "markers": len(markers),
        "replicas_last": rounds[-1]["replicas"] if rounds else 0,
        "ready_last": rounds[-1]["ready"] if rounds else 0,
        "routes": {k: {kk: round(vv, 3) for kk, vv in v.items()}
                   for k, v in sorted(routes.items())},
        "marker_kinds": sorted({m.get("kind", "?") for m in markers}),
    }
    print(json.dumps(report, sort_keys=True))
    t0 = records[0].get("t_unix", 0.0)
    tail = sorted(records, key=lambda r: r.get("seq", 0))[-args.last:]
    for rec in tail:
        dt = rec.get("t_unix", t0) - t0
        if rec.get("type") == "round":
            slots = [s for s in rec.get("slots", {}).values()
                     if s.get("present")]
            p99 = max((s.get("p99_s", 0.0) for s in slots), default=0.0)
            depth = sum(s.get("queue_interactive", 0)
                        + s.get("queue_batch", 0) for s in slots)
            shed = max((s.get("shed_rate", 0.0) for s in slots),
                       default=0.0)
            print(f"t+{dt:7.2f}s round {rec.get('round', 0):>4} "
                  f"replicas={rec.get('replicas', 0)} "
                  f"ready={rec.get('ready', 0)} "
                  f"p99={p99 * 1e3:8.1f}ms depth={depth:>3} "
                  f"shed={shed:6.1%}", file=sys.stderr)
        else:
            print(f"t+{dt:7.2f}s !! [{rec.get('kind', '?')}] "
                  f"{rec.get('who', '?')}: "
                  f"{str(rec.get('detail', ''))[:90]}",
                  file=sys.stderr)
    return 0


def _observe(stack: contextlib.ExitStack, args, job: JobConfig) -> None:
    """Arm the job's observability on ``stack``: the ``--trace-dir``
    capture around everything, the supervised child's heartbeat (a
    no-op unless the parent named a heartbeat file), the telemetry
    export (configured before the job, written on every way out, after
    the flusher's final publish) and the ``--live-port`` sidecar."""
    from spark_examples_tpu_torch.core import live, profiling, telemetry
    from spark_examples_tpu_torch.core.supervisor import (
        maybe_start_heartbeat,
    )

    stack.enter_context(profiling.trace(args.trace_dir, job.compute.device))
    if args.debug_nans:
        profiling.set_debug_nans(True)
        stack.callback(profiling.set_debug_nans, False)
    hb = maybe_start_heartbeat()
    if hb is not None:
        stack.callback(hb.stop)
    if job.telemetry.dir:
        telemetry.configure(dir=job.telemetry.dir,
                            trace_events=job.telemetry.trace_events,
                            flush_s=job.telemetry.flush_s,
                            trace_sample=job.telemetry.trace_sample)

        def export():
            d = telemetry.export()
            if d:
                print(f"telemetry -> {d}", file=sys.stderr)

        stack.callback(export)
        stack.callback(telemetry.stop_periodic_flush)
    else:
        telemetry.set_trace_sample(job.telemetry.trace_sample)
    sidecar = live.maybe_start_live(port=job.telemetry.live_port)
    if sidecar is not None:
        stack.callback(sidecar.shutdown)
        if job.telemetry.live_port is not None:
            print(f"live telemetry on http://{sidecar.host}:{sidecar.port} "
                  "(GET /metrics, /debug/telemetry, /healthz)",
                  file=sys.stderr)


def _dispatch(args, job: JobConfig, parser: argparse.ArgumentParser) -> int:
    from spark_examples_tpu_torch.pipelines import jobs

    if args.command == "serve":
        return _serve(args, job, parser)
    if args.command == "pack":
        timer = _pack(job, parser)
    elif args.command == "ingest":
        timer = _ingest(job, args.chunk_variants, parser)
    elif args.command in ("project", "cross-kinship"):
        timer = _cross(args, job, parser)
    elif args.command in ("search-variants", "sample-stats"):
        timer = _examples(args, job)
    elif args.command == "neighbors":
        timer = _neighbors(args, job, parser)
    elif args.command == "pcoa" and args.stream_refresh_blocks > 0:
        timer = _stream_pcoa(args, job, parser)
    elif args.command == "similarity":
        res = jobs.similarity_matrix_job(job)
        print(
            f"similarity[{res.metric}] {res.similarity.shape[0]}x"
            f"{res.similarity.shape[1]} over {res.n_variants} variants"
            + (f" -> {job.output_path}" if job.output_path else "")
        )
        timer = res.timer
    else:
        if args.command == "pcoa":
            out = jobs.pcoa_job(job, matrix_path=args.matrix_path,
                                matrix_kind=args.matrix_kind)
        else:
            out = jobs.variants_pca_job(job)
        _print_coords(out, job)
        timer = out.timer
    if args.timings:
        print(json.dumps(timer.report(), sort_keys=True), file=sys.stderr)
    return 0


def _cross(args, job: JobConfig,
           parser: argparse.ArgumentParser) -> PhaseTimer:
    """The ``project`` and ``cross-kinship`` commands: the new cohort
    (--source/--path) against the reference panel (--ref-source/
    --ref-path), streamed in lockstep. Both sources are built here and
    closed when the job ends."""
    from spark_examples_tpu_torch.ingest.source import close_source
    from spark_examples_tpu_torch.pipelines import project
    from spark_examples_tpu_torch.pipelines.runner import build_source

    if _needs_ref_path(args):
        parser.error(
            "project requires --ref-path (the panel genotypes the model "
            "was fitted on)" if args.command == "project"
            else "cross-kinship requires --ref-path")
    if args.maf > 0.0 or args.max_missing < 1.0 or args.ld_prune_r2 > 0.0:
        if args.command == "project":
            parser.error(
                "--maf/--max-missing/--ld-prune-r2 cannot apply during "
                "project: these masks are data-dependent, so each cohort "
                "would keep a DIFFERENT variant subset and cross-"
                "statistics would mix misaligned variants. Filter/prune "
                "the panel once (pack --maf/--ld-prune-r2 ... into a "
                "store), fit the model on that store, and supply a new "
                "cohort genotyped at the same sites"
            )
        parser.error(
            "--maf/--max-missing/--ld-prune-r2 cannot apply during "
            "cross-kinship (data-dependent masks would keep "
            "different variant subsets per cohort); filter both "
            "cohorts to the same sites beforehand"
        )
    try:
        ref_cfg = dataclasses.replace(job.ingest, source=args.ref_source,
                                      path=args.ref_path)
    except ValueError as e:
        parser.error(str(e))
    device = job.compute.device
    src_new = build_source(job.ingest, device)
    try:
        src_ref = build_source(ref_cfg, device)
        try:
            if args.command == "project":
                out = project.pcoa_project_job(
                    job, model_path=args.model, source_new=src_new,
                    source_ref=src_ref)
                _print_coords(out, job)
                return out.timer
            res = project.cross_kinship_job(job, src_new, src_ref)
            ref_ids = src_ref.sample_ids
        finally:
            close_source(src_ref)
    finally:
        close_source(src_new)
    phi = res.similarity
    hits = [(res.sample_ids[i], ref_ids[j], float(phi[i, j]))
            for i, j in zip(*np.nonzero(phi >= args.min_phi))]
    print(
        f"cross-kinship {phi.shape[0]}x{phi.shape[1]} over "
        f"{res.n_variants} variants; {len(hits)} pairs with "
        f"phi >= {args.min_phi}"
        + (f" -> {job.output_path}" if job.output_path else "")
    )
    for a, b, p in sorted(hits, key=lambda t: -t[2])[:50]:
        print(f"{a}\t{b}\tphi={p:.4f}")
    return res.timer


def _stream_pcoa(args, job: JobConfig,
                 parser: argparse.ArgumentParser) -> PhaseTimer:
    """``pcoa --stream-refresh-blocks N``: the streaming route, with a
    line per snapshot."""
    from spark_examples_tpu_torch.pipelines.streaming import (
        incremental_pcoa_job,
    )

    if args.matrix_path:
        parser.error("--stream-refresh-blocks streams the cohort; "
                     "it cannot consume a persisted --matrix-path")
    if args.save_model:
        parser.error(
            "--save-model is not supported by the streaming "
            "route (it needs the final dense distance matrix "
            "for the projection centering statistics) — fit "
            "the model with a batch pcoa run"
        )
    job = job.replace(compute=dataclasses.replace(
        job.compute, stream_refresh_blocks=args.stream_refresh_blocks))
    out, snapshots = incremental_pcoa_job(job)
    for s in snapshots:
        print(f"snapshot@{s.n_variants} variants: "
              f"top eigenvalue {s.eigenvalues[0]:.6g}")
    _print_coords(out, job)
    return out.timer


_PREVIEW_ROWS = 50


def _emit_table(job: JobConfig, header: str, lines: list[str], noun: str,
                preview: list[str] | None = None) -> None:
    """The search/stats table protocol: the full TSV to
    ``--output-path`` (when set), up to ``_PREVIEW_ROWS`` console rows
    (``preview``, a per-row rendering, or the TSV itself with its
    header), and a '... N more' tail pointing at the file."""
    import os

    if job.output_path:
        os.makedirs(os.path.dirname(job.output_path) or ".", exist_ok=True)
        with open(job.output_path, "w") as f:
            f.write(header)
            f.writelines(lines)
    shown = preview if preview is not None else lines
    if preview is None:
        sys.stdout.write(header)
    sys.stdout.writelines(shown[:_PREVIEW_ROWS])
    if len(shown) > _PREVIEW_ROWS:
        tail = f"... {len(shown) - _PREVIEW_ROWS} more {noun}"
        if job.output_path:
            tail += f" (full table in {job.output_path})"
        print(tail)


def _examples(args, job: JobConfig) -> PhaseTimer:
    """``search-variants`` and ``sample-stats``: one streaming pass over
    the source (closed when it ends), then the table."""
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.pipelines import examples, runner

    timer = PhaseTimer()
    bv, device = job.ingest.block_variants, job.compute.device
    with runner.job_source(job, None, timer) as src, timer.phase("scan"):
        if args.command == "search-variants":
            positions = set(args.positions) if args.positions else None
            counts = examples.genotype_histogram(src, bv, positions, device)
        else:
            stats = examples.sample_stats(src, bv, device)
    if args.command == "search-variants":
        _emit_table(
            job,
            header="contig\tposition\thom_ref\thet\thom_alt\tmissing\taf\n",
            lines=[
                f"{c.contig or '?'}\t{c.position}\t{c.hom_ref}\t"
                f"{c.het}\t{c.hom_alt}\t{c.missing}\t"
                f"{c.allele_freq:.6f}\n"
                for c in counts
            ],
            noun="variants",
            preview=[
                f"{c.contig or '?'}:{c.position}\t0/0={c.hom_ref}\t"
                f"0/1={c.het}\t1/1={c.hom_alt}\t./.={c.missing}\t"
                f"af={c.allele_freq:.4f}\n"
                for c in counts
            ],
        )
    else:
        _emit_table(
            job,
            header=("sample\tn_called\tcall_rate\tn_het\thet_rate\t"
                    "n_hom_alt\n"),
            lines=[
                f"{s.sample_id}\t{s.n_called}\t{s.call_rate:.6f}\t"
                f"{s.n_het}\t{s.het_rate:.6f}\t{s.n_hom_alt}\n"
                for s in stats
            ],
            noun="samples",
        )
    return timer


def _neighbors(args, job: JobConfig,
               parser: argparse.ArgumentParser) -> PhaseTimer:
    """``neighbors``: in cohort mode the MinHash/LSH/exact-evaluation job
    (neighbors/engine.py); with ``--model`` each query's top-k panel
    neighbors through the serving engine's padded-batch pair statistics.
    The file goes to --output-path and a preview of the first rows is
    printed."""
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.neighbors import save_result
    from spark_examples_tpu_torch.neighbors.engine import neighbors_job

    timer = PhaseTimer()
    if args.model:
        res, panel_ids = _neighbors_vs_panel(args, job, parser, timer)
    else:
        res = neighbors_job(job, timer=timer)
        panel_ids = list(res.sample_ids)
    if job.output_path:
        with timer.phase("write"):
            save_result(job.output_path, res)
    suffix = f" -> {job.output_path}" if job.output_path else ""
    if res.kind == "topk":
        print(
            f"neighbors[{res.metric}] top-{res.k} for "
            f"{len(res.sample_ids)} samples over {res.n_variants} "
            f"variants{suffix}"
        )
        for sid, ids, sims in list(zip(res.sample_ids, res.ids,
                                       res.sims))[:5]:
            cells = [
                f"{panel_ids[j]}={s:.4f}"
                for j, s in zip(ids.tolist(), sims.tolist()) if j >= 0
            ]
            print(sid + "\t" + "\t".join(cells[:5]))
    else:
        print(
            f"neighbors[{res.metric}] {len(res.pairs)} evaluated "
            f"candidate pairs among {len(res.sample_ids)} samples "
            f"over {res.n_variants} variants{suffix}"
        )
        order = np.argsort(-res.sims, kind="stable")[:5]
        for t in order:
            i, j = res.pairs[t]
            print(f"{res.sample_ids[i]}\t{res.sample_ids[j]}\t"
                  f"{res.sims[t]:.4f}")
    return timer


# Queries per padded batch of ``neighbors --model``: hom-ref padding keeps
# each row's integer sums independent of the chunk, so any chunking
# matches a server's answers bit for bit.
_NEIGHBORS_BATCH = 8


def _neighbors_vs_panel(args, job: JobConfig,
                        parser: argparse.ArgumentParser,
                        timer: PhaseTimer):
    """``neighbors --model``: stage the model's panel on the job's
    device, then every query's top-k panel samples by exact similarity,
    ``_NEIGHBORS_BATCH`` queries at a time. Returns (TopKResult, the
    panel's sample ids); both sources are closed when it ends."""
    from spark_examples_tpu_torch.ingest.source import close_source
    from spark_examples_tpu_torch.neighbors import TopKResult
    from spark_examples_tpu_torch.pipelines import project as P
    from spark_examples_tpu_torch.pipelines.runner import build_source
    from spark_examples_tpu_torch.serve import engine as E

    if args.maf > 0.0 or args.max_missing < 1.0 or args.ld_prune_r2 > 0:
        parser.error(
            "--maf/--max-missing/--ld-prune-r2 cannot apply during "
            "query-vs-panel neighbors (data-dependent masks would "
            "keep different variant subsets per cohort); filter "
            "both cohorts to the same sites beforehand"
        )
    if _needs_ref_path(args):
        parser.error("neighbors --model requires --ref-path (the "
                     "panel genotypes the model was fitted on)")
    try:
        model = P.load_model(args.model)
        E.check_topkable(model)
    except ValueError as e:
        parser.error(str(e))
    device = job.compute.device
    ctx = E.ModelContext(model, device)
    ref_cfg = dataclasses.replace(job.ingest, source=args.ref_source,
                                  path=args.ref_path)
    src_ref = build_source(ref_cfg, device)
    try:
        P.check_reference_panel(model, src_ref)
        with timer.phase("stage"):
            blocks, n_variants, _nbytes = E.stage_blocks(
                src_ref, job.ingest.block_variants, ctx.device)
    finally:
        close_source(src_ref)
    queries, query_ids = _query_pool(job, n_variants, parser, "query cohort")
    k = job.compute.neighbors_k
    ids_rows, sim_rows = [], []
    with timer.phase("neighbors_eval"):
        for i in range(0, queries.shape[0], _NEIGHBORS_BATCH):
            ids, sims = E.batch_topk(
                ctx, blocks, queries[i:i + _NEIGHBORS_BATCH],
                _NEIGHBORS_BATCH, n_variants, k)
            ids_rows.append(ids)
            sim_rows.append(sims)
    res = TopKResult(
        ids=np.concatenate(ids_rows, axis=0),
        sims=np.concatenate(sim_rows, axis=0),
        sample_ids=tuple(query_ids),
        metric=model.metric,
        k=int(ids_rows[0].shape[1]), n_variants=n_variants,
    )
    return res, list(model.sample_ids)


def _query_pool(job: JobConfig, n_variants: int,
                parser: argparse.ArgumentParser,
                noun: str) -> tuple[np.ndarray, list[str]]:
    """The --source cohort as one (Q, V) int8 array with its sample ids
    (a synthetic source is generated at the panel's variant count);
    a cohort of another width is a usage error."""
    from spark_examples_tpu_torch.ingest.source import close_source
    from spark_examples_tpu_torch.pipelines.runner import build_source

    q_cfg = job.ingest
    if q_cfg.source == "synthetic":
        q_cfg = dataclasses.replace(q_cfg, n_variants=n_variants)
    q_src = build_source(q_cfg, job.compute.device)
    try:
        pool = np.concatenate(
            [b for b, _ in q_src.blocks(q_cfg.block_variants)], axis=1)
        ids = list(q_src.sample_ids)
    finally:
        close_source(q_src)
    if pool.shape[1] != n_variants:
        parser.error(
            f"{noun} carries {pool.shape[1]} variants but the model's "
            f"panel has {n_variants} — both cohorts must be genotyped "
            "at the panel's sites"
        )
    return pool, ids


def _write_port_file(path, port) -> None:
    """--port-file: atomically publish the bound port."""
    if not path:
        return
    from spark_examples_tpu_torch.core import telemetry

    telemetry._atomic_write(path, json.dumps({"port": int(port)}))


def _serve(args, job: JobConfig, parser: argparse.ArgumentParser) -> int:
    """``serve``: engine and server up on the job's device, then either
    a local HTTP endpoint (SIGTERM or Ctrl-C drains) or an in-process
    closed-loop loadgen run whose JSON report goes to stdout. The
    telemetry export (the job's exit stack) runs after the drain, so
    the exported serve.* histograms cover the whole serving life."""
    from spark_examples_tpu_torch.core import config
    from spark_examples_tpu_torch.ingest.source import close_source
    from spark_examples_tpu_torch.pipelines.runner import build_source
    from spark_examples_tpu_torch.serve import (
        ProjectionEngine,
        ProjectionServer,
        run_loadgen,
    )

    if not args.fleet and not args.model:
        parser.error("serve needs --model MODEL.npz (single-model "
                     "mode) or --fleet fleet.json (multi-model mode)")
    if args.fleet and args.model:
        parser.error("--fleet and --model are mutually exclusive: the "
                     "fleet manifest names every route's model")
    if not args.fleet and _needs_ref_path(args):
        parser.error("serve requires --ref-path (the panel genotypes "
                     "the model was fitted on)")
    try:
        cfg = config.ServeConfig(
            model_path=args.model,
            max_batch=args.max_batch,
            max_linger_ms=args.max_linger_ms,
            max_queue=args.max_queue,
            cache_entries=args.cache_entries,
            deadline_ms=args.deadline_ms,
            host=args.host,
            port=args.port,
            fleet_manifest=args.fleet,
            fleet_budget_mb=args.fleet_budget_mb,
            queue_interactive=args.queue_interactive,
            queue_batch=args.queue_batch,
            deadline_interactive_ms=args.deadline_interactive_ms,
            deadline_batch_ms=args.deadline_batch_ms,
            drain_timeout_s=args.drain_timeout_s,
            loadgen_seed=args.loadgen_seed,
        )
        ref_cfg = dataclasses.replace(job.ingest, source=args.ref_source,
                                      path=args.ref_path)
    except ValueError as e:
        parser.error(str(e))
    if args.fleet:
        return _serve_fleet(args, job, cfg, parser)
    device = job.compute.device
    src_ref = build_source(ref_cfg, device)
    try:
        engine = ProjectionEngine(
            cfg.model_path, src_ref,
            block_variants=job.ingest.block_variants,
            max_batch=cfg.max_batch, device=device,
        )
        server = ProjectionServer(
            engine,
            max_linger_s=cfg.max_linger_ms / 1e3,
            max_queue=cfg.max_queue,
            cache_entries=cfg.cache_entries,
            default_deadline_s=(cfg.deadline_ms / 1e3) or None,
            drain_timeout_s=cfg.drain_timeout_s,
        )
        server.start()
        try:
            if args.loadgen > 0:
                pool, _ids = _query_pool(job, engine.n_variants, parser,
                                         "loadgen query pool")
                report = run_loadgen(
                    server, pool, clients=args.loadgen,
                    requests_per_client=args.loadgen_requests,
                    deadline_s=(cfg.deadline_ms / 1e3) or None,
                )
                print(json.dumps(report, sort_keys=True))
            else:
                from spark_examples_tpu_torch.serve.http import (
                    ProjectionHTTPServer,
                )

                http = ProjectionHTTPServer(server, host=cfg.host,
                                            port=cfg.port)
                _serve_http(
                    args, http,
                    f"serving projections on http://{http.host}:"
                    f"{http.port} (POST /project, GET /healthz, GET "
                    f"/stats; {engine.n_variants} variants x "
                    f"{engine.n_components} components; Ctrl-C drains)")
        finally:
            server.close()
    finally:
        close_source(src_ref)
    return 0


def _serve_fleet(args, job: JobConfig, cfg,
                 parser: argparse.ArgumentParser) -> int:
    """``serve --fleet``: manifest -> FleetRouter on the job's device;
    then either the fleet HTTP front (SIGTERM or Ctrl-C drains) or a
    multi-tenant loadgen mix (per route: --loadgen interactive and
    --loadgen batch clients) whose JSON report goes to stdout."""
    from spark_examples_tpu_torch.core import config
    from spark_examples_tpu_torch.serve import (
        FleetFormatError,
        FleetManifest,
        build_fleet,
        run_fleet_loadgen,
    )
    from spark_examples_tpu_torch.serve.http import fleet_http_server

    try:
        manifest = FleetManifest.load(cfg.fleet_manifest)
        fleet = build_fleet(manifest, cfg, ingest_defaults=job.ingest,
                            block_variants=job.ingest.block_variants,
                            device=job.compute.device)
    except (FleetFormatError, ValueError, OSError) as e:
        parser.error(str(e))
    fleet.start()
    try:
        if args.loadgen > 0:
            pools = {
                name: _query_pool(
                    job, route.n_variants or job.ingest.n_variants,
                    parser, f"loadgen query pool of route {name!r}")[0]
                for name, route in fleet.routes.items()
            }
            mix = [(name, cls, args.loadgen)
                   for name in sorted(fleet.routes)
                   for cls in config.PRIORITY_CLASSES]
            report = run_fleet_loadgen(
                fleet, pools, mix,
                requests_per_client=args.loadgen_requests,
            )
            report["stats"] = fleet.stats_payload()
            print(json.dumps(report, sort_keys=True))
        else:
            http = fleet_http_server(fleet, host=cfg.host, port=cfg.port)
            _serve_http(
                args, http,
                f"serving fleet of {len(fleet.routes)} route(s) on "
                f"http://{http.host}:{http.port} (POST /project "
                "{'route': ..., 'genotypes': [...], 'priority': ...}, "
                "GET /routes, /healthz, /stats, /metrics; pool budget "
                f"{fleet.pool.budget_bytes / 1e6:.0f} MB; Ctrl-C drains)")
    finally:
        fleet.close()
    return 0


def _serve_http(args, http, banner: str) -> None:
    """Serve ``http`` in the foreground until SIGTERM or Ctrl-C, which
    drain rather than kill: admitted requests are answered before the
    process exits."""
    import signal

    _write_port_file(args.port_file, http.port)

    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (embedded use)
    print(banner, file=sys.stderr, flush=True)
    try:
        http.serve_forever()
    except KeyboardInterrupt:
        print("draining...", file=sys.stderr)
    finally:
        http.shutdown()


def _run_coverage(args) -> int:
    """``coverage``: per-base depth of each range on --device, a summary
    line per range, and the depth TSV when asked."""
    from spark_examples_tpu_torch.core.config import ReferenceRange
    from spark_examples_tpu_torch.ingest.reads import (
        SamSource,
        SyntheticReadsSource,
    )
    from spark_examples_tpu_torch.pipelines.coverage import coverage

    refs = [ReferenceRange.parse(r) for r in args.references]
    if args.reads_source == "sam":
        if not args.path:
            raise SystemExit("coverage --reads-source sam requires --path")
        src = SamSource(args.path, references=refs)
    else:
        if not refs:
            refs = [ReferenceRange("chr22", 16_050_000, 16_150_000)]
        src = SyntheticReadsSource(
            references=refs,
            reads_per_range=args.reads_per_range,
            read_length=args.read_length,
            seed=args.seed,
        )
    results = coverage(src, device=args.device)
    for r in results:
        h = [int(v) for v in r.histogram(10)]
        print(
            f"{r.reference}\treads={r.n_reads}\tmean_depth={r.mean:.2f}\t"
            f"depth_hist[0..10+]={h}"
        )
    if args.output_path:
        with open(args.output_path, "w") as f:
            f.write("contig\tposition\tdepth\n")
            for r in results:
                contig, start = r.reference.contig, r.reference.start
                f.writelines(
                    f"{contig}\t{start + i}\t{d}\n"
                    for i, d in enumerate(r.depth.astype(np.int64).tolist()))
        print(f"depth table -> {args.output_path}")
    return 0


def _pack(job: JobConfig, parser: argparse.ArgumentParser) -> PhaseTimer:
    """The ``pack`` command: stream the source into a 2-bit store."""
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest.source import close_source
    from spark_examples_tpu_torch.ingest.packed import pack_source
    from spark_examples_tpu_torch.pipelines.runner import build_source

    if not job.output_path:
        parser.error("pack requires --output-path (the store directory)")
    timer = PhaseTimer()
    with timer.phase("ingest_setup"):
        src = build_source(job.ingest, job.compute.device)
    try:
        with timer.phase("pack"):
            written = pack_source(job.output_path, src,
                                  job.ingest.block_variants)
    finally:
        close_source(src)
    print(
        f"packed {src.n_samples} samples x {written} variants "
        f"({src.n_samples * written / 4 / 1e6:.1f} MB 2-bit) -> "
        f"{job.output_path} in {timer.phases['pack']:.1f}s"
    )
    return timer


def _ingest(job: JobConfig, chunk_variants: int,
            parser: argparse.ArgumentParser) -> PhaseTimer:
    """The ``ingest`` command: compact the source into a dataset store,
    recording the origin (the self-healing recipe) in its manifest."""
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest.source import close_source
    from spark_examples_tpu_torch.pipelines.runner import build_source
    from spark_examples_tpu_torch.store import compact, origin_from_ingest

    if not job.output_path:
        parser.error("ingest requires --output-path (the store "
                     "directory to compact into)")
    timer = PhaseTimer()
    with timer.phase("ingest_setup"):
        src = build_source(job.ingest, job.compute.device)
    try:
        with timer.phase("compact"):
            manifest = compact(
                job.output_path, src, chunk_variants=chunk_variants,
                workers=job.ingest.ingest_workers,
                codec=job.ingest.store_codec,
                origin=origin_from_ingest(job.ingest, chunk_variants))
    finally:
        close_source(src)
    dt = timer.phases["compact"]
    dense_mb = manifest.n_samples * manifest.n_variants / 1e6
    n = manifest.n_samples
    raw_b = sum(c.payload_size(n) for c in manifest.chunks)
    stored_b = sum(c.disk_size(n) for c in manifest.chunks)
    print(
        f"compacted {manifest.n_samples} samples x "
        f"{manifest.n_variants} variants into {len(manifest.chunks)} "
        f"content-addressed chunks ({dense_mb / 4:.1f} MB 2-bit -> "
        f"{stored_b / 1e6:.1f} MB stored, "
        f"{raw_b / max(stored_b, 1):.2f}x {job.ingest.store_codec}) "
        f"-> {job.output_path} in {dt:.1f}s "
        f"({dense_mb / max(dt, 1e-9):.0f} MB/s dense-equivalent, "
        f"{stored_b / 1e6 / max(dt, 1e-9):.0f} MB/s written, "
        f"{job.ingest.ingest_workers} workers); "
        f"read it back with --source store:{job.output_path}"
    )
    return timer


def _run_store_admin(args) -> int:
    """The ``store`` maintenance subcommand (``heal``). Prints the heal
    report as JSON; exit 0 iff nothing is left damaged."""
    from spark_examples_tpu_torch.store.heal import heal

    report = heal(args.path, replicas=tuple(args.replica),
                  verify_all=args.verify_all, device=args.device)
    print(json.dumps(report, sort_keys=True))
    if report["failed"]:
        print(
            f"store heal: {len(report['failed'])} chunk(s) could not be "
            "healed (no replica holds them and the origin no longer "
            "reproduces them) — restore the files or re-run the "
            "compaction",
            file=sys.stderr,
        )
        return 1
    if report["healed"]:
        print(f"store heal: {len(report['healed'])} chunk(s) healed and "
              "re-verified; quarantine ledger cleared", file=sys.stderr)
    return 0


def _print_coords(out, job: JobConfig) -> None:
    k = out.coords.shape[1]
    print(
        f"{len(out.sample_ids)} samples x {k} components over "
        f"{out.n_variants} variants"
        + (f" -> {job.output_path}" if job.output_path else "")
    )
    vals = np.asarray(out.eigenvalues, float)
    if vals.size:
        line = "eigenvalues: " + " ".join(f"{v:.6g}" for v in vals[:10])
        if out.proportion is not None:
            line += "  (explained: " + " ".join(
                f"{p:.1%}" for p in np.asarray(out.proportion, float)[:10]
            ) + ")"
        print(line)
    for sid, row in list(zip(out.sample_ids, out.coords))[:5]:
        print(sid + "\t" + "\t".join(f"{v:.4g}" for v in row[:4]))


if __name__ == "__main__":
    sys.exit(main())
