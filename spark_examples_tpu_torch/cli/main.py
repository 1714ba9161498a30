"""Command-line entry: ``python -m spark_examples_tpu_torch {pcoa,pca,similarity}``.

Flag names and defaults follow the JAX package's CLI for the flags the
ported path reads, plus ``--device {cuda,cpu}`` (default cuda; a missing
card raises).

    python -m spark_examples_tpu_torch pcoa --n-samples 2504 \\
        --n-variants 100000 --metric ibs --num-pc 10 --output-path coords.tsv
    python -m spark_examples_tpu_torch pcoa --metric braycurtis \\
        --n-samples 10000 --n-variants 4096 --num-pc 10
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
)
from spark_examples_tpu_torch.core.device import DEVICES


def _add_common(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("ingest")
    g.add_argument("--source", default="synthetic",
                   help="genotype source (ported so far: synthetic)")
    g.add_argument("--n-samples", type=int, default=2504)
    g.add_argument("--n-variants", type=int, default=100_000)
    g.add_argument("--n-populations", type=int, default=5)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--block-variants", type=int, default=8192,
                   help="variants per streamed block (the partition size)")
    g.add_argument("--prefetch-blocks", type=int, default=2,
                   help="host->device pipeline depth (blocks queued "
                   "while earlier copies drain; minimum 1)")
    c = p.add_argument_group("compute")
    c.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="where the job runs; cuda raises when no card is "
                   "visible")
    c.add_argument("--metric", default="ibs",
                   choices=list(kernels.finalizable_names()))
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
            n_samples=args.n_samples,
            n_variants=args.n_variants,
            n_populations=args.n_populations,
            seed=args.seed,
            block_variants=args.block_variants,
            prefetch_blocks=args.prefetch_blocks,
        ),
        compute=ComputeConfig(
            metric=args.metric,
            braycurtis_method=args.braycurtis_method,
            braycurtis_levels=args.braycurtis_levels,
            num_pc=args.num_pc,
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
        "(similarity / PCoA / PCA)",
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

    if args.command == "similarity":
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


def _print_coords(out, job: JobConfig) -> None:
    k = out.coords.shape[1]
    print(
        f"{len(out.sample_ids)} samples x {k} components"
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
