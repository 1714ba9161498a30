"""Command-line entry:
``python -m spark_examples_tpu_torch {pcoa,pca,similarity,pack}``.

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
    python -m spark_examples_tpu_torch pca --n-samples 2504 \\
        --n-variants 100000 --num-pc 10
"""

from __future__ import annotations

import argparse
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

_SOURCES = config.SOURCES + config.UNPORTED_SOURCES


def _source_arg(value: str) -> str:
    """``--source``: a source name, or ``store:<dir>``. parquet and the
    store are accepted here and refused when the job builds its source,
    with a message saying they are not ported yet."""
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
                   help="genotype source (parquet and store are not "
                   "ported yet and are refused)")
    g.add_argument("--path", default=None,
                   help="input for vcf (.vcf/.vcf.gz), plink (fileset "
                   "prefix or .bed path) or packed (store directory) "
                   "sources")
    g.add_argument("--references", nargs="*", default=[],
                   metavar="CONTIG:START:END",
                   help="genomic ranges to ingest (vcf and plink)")
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
    c.add_argument("--checkpoint-dir", default=None,
                   help="not yet ported: refused")
    c.add_argument("--solver", default="exact",
                   choices=list(config.SOLVER_LADDER),
                   help="eigensolve accuracy ladder; only 'exact' is "
                   "ported (the sketch rungs are refused)")
    c.add_argument("--gram-mode", default="auto",
                   choices=list(config.GRAM_MODES),
                   help="gram accumulation plan; one device holds the "
                   "matrix ('tile2d' is refused)")
    p.add_argument("--output-path", default=None)
    p.add_argument("--timings", action="store_true",
                   help="print per-phase timing JSON to stderr")


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
            solver=args.solver,
            gram_mode=args.gram_mode,
        ),
        output_path=args.output_path,
        model_path=getattr(args, "save_model", None),
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="spark_examples_tpu_torch",
        description="population-genomics pipelines on PyTorch/CUDA "
        "(similarity / PCoA / PCA, and the pack ETL)",
    )
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_common(sub.add_parser("similarity", help="pairwise similarity "
                               "matrix"))
    for name, helptext in (("pcoa", "principal coordinates analysis"),
                           ("pca", "flagship variants-PCA job")):
        p = sub.add_parser(name, help=helptext)
        _add_common(p)
        p.add_argument("--save-model", default=None,
                       help="not yet ported: refused")
    _add_common(sub.add_parser(
        "pack", help="ETL: stream any source (QC and LD pruning "
        "included) into the 2-bit packed store at --output-path; later "
        "jobs read it with --source packed --path <dir>"))
    # The pca job is defined on the shared-alt similarity; any other
    # --metric would be silently ignored, so it is rejected instead.
    sub.choices["pca"].set_defaults(metric="shared-alt")
    args = parser.parse_args(argv)
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
    elif args.command == "similarity":
        res = jobs.similarity_matrix_job(job)
        print(
            f"similarity[{res.metric}] {res.similarity.shape[0]}x"
            f"{res.similarity.shape[1]} over {res.n_variants} variants"
            + (f" -> {job.output_path}" if job.output_path else "")
        )
        timer = res.timer
    else:
        run = jobs.pcoa_job if args.command == "pcoa" else jobs.variants_pca_job
        out = run(job)
        _print_coords(out, job)
        timer = out.timer
    if args.timings:
        print(json.dumps(timer.report(), sort_keys=True), file=sys.stderr)
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
    with timer.phase("pack"):
        written = pack_source(job.output_path, src,
                              job.ingest.block_variants)
    print(
        f"packed {src.n_samples} samples x {written} variants "
        f"({src.n_samples * written / 4 / 1e6:.1f} MB 2-bit) -> "
        f"{job.output_path} in {timer.phases['pack']:.1f}s"
    )
    return timer


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
