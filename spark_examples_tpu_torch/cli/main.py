"""Command-line entry: ``python -m spark_examples_tpu_torch
{pcoa,pca,similarity,project,cross-kinship,pack,ingest,store,
search-variants,sample-stats,coverage,neighbors}``.

Flag names and defaults follow the JAX package's CLI for the flags the
ported paths read, plus ``--device {cuda,cpu}`` (default cuda; a missing
card raises).

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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from spark_examples_tpu_torch import __version__, kernels
from spark_examples_tpu_torch.core import config
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
    ReferenceRange,
)
from spark_examples_tpu_torch.core.device import DEVICES
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.source import close_source

_SOURCES = config.SOURCES
# ComputeConfig fields that only the neighbors command has flags for.
_NEIGHBORS_FLAGS = ("neighbors_output", "neighbors_k", "minhash_hashes",
                    "minhash_bands", "minhash_seed", "minhash_bucket_cap")


def _source_arg(value: str) -> str:
    """``--source`` and ``--ref-source``: a source name, or
    ``store:<dir>`` (the dataset store at <dir>)."""
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
    g.add_argument("--ingest-workers", type=int, default=4,
                   help="parse/pack/hash/write worker threads of `ingest` "
                   "compaction (ordered reassembly keeps the store byte "
                   "for byte the 1-worker one)")
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
    c = p.add_argument_group("compute")
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
                   help="gram accumulation plan; one device holds the "
                   "matrix ('tile2d' is refused)")
    p.add_argument("--output-path", default=None)
    p.add_argument("--timings", action="store_true",
                   help="print per-phase timing JSON to stderr")


def _add_ref_source(p: argparse.ArgumentParser) -> None:
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
    return JobConfig(
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
            **{name: getattr(args, name, getattr(ComputeConfig, name))
               for name in _NEIGHBORS_FLAGS},
        ),
        output_path=args.output_path,
        model_path=getattr(args, "save_model", None),
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="spark_examples_tpu_torch",
        description="population-genomics pipelines on PyTorch/CUDA "
        "(similarity / PCoA / PCA, streaming PCoA snapshots, "
        "fit-then-project and cross-kinship, top-k neighbors, the "
        "search/sample-stats/coverage examples, the pack and ingest ETL, "
        "and store maintenance)",
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
    # The pca job is defined on the shared-alt similarity; any other
    # --metric would be silently ignored, so it is rejected instead.
    sub.choices["pca"].set_defaults(metric="shared-alt")
    args = parser.parse_args(argv)
    if args.command == "store":
        return _run_store_admin(args)
    if args.command == "coverage":
        return _run_coverage(args)
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

    from spark_examples_tpu_torch.pipelines import jobs

    if args.command == "pack":
        timer = _pack(job, parser)
    elif args.command == "ingest":
        timer = _ingest(job, args.chunk_variants, parser)
    elif args.command in ("project", "cross-kinship"):
        timer = _cross(args, job, parser)
    elif args.command in ("search-variants", "sample-stats"):
        timer = _examples(args, job)
    elif args.command == "neighbors":
        timer = _neighbors(job)
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


def _neighbors(job: JobConfig) -> PhaseTimer:
    """``neighbors`` in cohort mode: the MinHash/LSH/exact-evaluation
    job (neighbors/engine.py), its file written to --output-path, a
    preview of the first rows printed."""
    from spark_examples_tpu_torch.neighbors import save_result
    from spark_examples_tpu_torch.neighbors.engine import neighbors_job

    timer = PhaseTimer()
    res = neighbors_job(job, timer=timer)
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
                f"{res.sample_ids[j]}={s:.4f}"
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


def _run_coverage(args) -> int:
    """``coverage``: per-base depth of each range on --device, a summary
    line per range, and the depth TSV when asked."""
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
