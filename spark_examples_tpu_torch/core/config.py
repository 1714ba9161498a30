"""Job configuration: the fields, defaults and validation the ported
job routes read (the JAX package's ``core/config.py`` is the spec).

Knobs are validated at config time with the flag named, so a nonsense
value dies as a usage error rather than deep inside a streaming job.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core.device import DEVICES

# Count-family contraction lowering (--gram-lowering): "reference" = the
# plain unpack-then-contract path, "fused" = the packed CUDA kernel
# (ops/packed_gram.py), "auto" = fused on a CUDA device for a packed
# stream, reference elsewhere. Bit-identical int32 accumulators either way.
GRAM_LOWERINGS = ("auto", "reference", "fused")
# Bray-Curtis lowering (--braycurtis-method): "exact" = the plain tiled
# broadcast-abs-sum, "matmul" = the threshold-decomposed matrix products
# (quantised to --braycurtis-levels), "fused" = the Manhattan CUDA kernel
# (ops/braycurtis_kernel.py), "auto" = fused on a CUDA device, exact on
# the CPU.
BRAYCURTIS_METHODS = ("auto", "exact", "matmul", "fused")
EIGH_MODES = ("auto", "dense", "randomized")
PACK_STREAMS = ("auto", "packed", "dense")
# Accepted so that a config naming them is refused with a message: only
# the exact rung on one device is ported.
SOLVER_LADDER = ("exact", "sketch", "corrected")
GRAM_MODES = ("auto", "replicated", "variant", "tile2d")

# Randomized-eigh defaults (power iterations / subspace oversample).
EIGH_ITERS_DEFAULT = 8
EIGH_OVERSAMPLE_DEFAULT = 32


def _check_int(section, name, value, lo, hi, why):
    if not (isinstance(value, int) and lo <= value <= hi):
        raise ValueError(
            f"bad {section} config: {name}={value!r} — expected an "
            f"integer in [{lo}, {hi}] ({why})"
        )


def _check_enum(section, name, value, members, why):
    if value not in members:
        raise ValueError(
            f"bad {section} config: {name}={value!r} — expected one of "
            f"{' | '.join(members)} ({why})"
        )


@dataclass
class IngestConfig:
    """Which variants to stream, from where, in what block shape."""

    source: str = "synthetic"
    n_samples: int = 2504  # synthetic default: 1000 Genomes phase-3 cohort
    n_variants: int = 100_000
    n_populations: int = 5
    seed: int = 0
    block_variants: int = 8192  # variants per streamed block
    # Host->device pipeline depth: produced blocks that may wait in the
    # prefetch queue while earlier copies and updates drain.
    prefetch_blocks: int = 2

    def __post_init__(self):
        _check_int("ingest", "block_variants", self.block_variants, 1,
                   1 << 26, "variants per streamed block")
        _check_int("ingest", "prefetch_blocks", self.prefetch_blocks, 1,
                   4096, "host->device pipeline depth; the stream cannot "
                   "run unbuffered, so at least 1")


@dataclass
class ComputeConfig:
    """Compute-path knobs."""

    # None = the job's default (ibs; the pca job always uses shared-alt).
    metric: str | None = None
    braycurtis_method: str = "auto"
    braycurtis_levels: int = 256
    num_pc: int = 10
    # Host->device transport: "packed" ships 2-bit packed blocks, "dense"
    # int8; "auto" packs (every ported kernel takes dosage inputs).
    pack_stream: str = "auto"
    gram_lowering: str = "auto"
    eigh_mode: str = "auto"
    eigh_iters: int = EIGH_ITERS_DEFAULT
    eigh_oversample: int = EIGH_OVERSAMPLE_DEFAULT
    device: str = "cuda"
    # Not ported yet; set only to be refused with a message.
    checkpoint_dir: str | None = None
    solver: str = "exact"
    gram_mode: str = "auto"

    def __post_init__(self):
        _check_enum("compute", "--gram-lowering", self.gram_lowering,
                    GRAM_LOWERINGS, "reference = plain unpack-then-contract, "
                    "fused = the packed CUDA kernel, auto = fused on CUDA")
        _check_enum("compute", "--braycurtis-method", self.braycurtis_method,
                    BRAYCURTIS_METHODS, "exact = plain broadcast-abs-sum, "
                    "matmul = threshold-decomposed products, fused = the "
                    "Manhattan CUDA kernel, auto = fused on CUDA")
        _check_int("compute", "--braycurtis-levels", self.braycurtis_levels,
                   1, 1 << 16, "threshold grid of the matmul lowering")
        _check_enum("compute", "--solver", self.solver, SOLVER_LADDER,
                    "eigensolve accuracy ladder")
        if self.solver != "exact":
            raise ValueError(
                f"bad compute config: --solver={self.solver!r} — the sketch "
                "rungs are not yet ported to the PyTorch package; use "
                "--solver exact"
            )
        _check_enum("compute", "--gram-mode", self.gram_mode, GRAM_MODES,
                    "gram accumulation plan")
        if self.gram_mode == "tile2d":
            raise ValueError(
                "bad compute config: --gram-mode='tile2d' — the tile-sharded "
                "plan is not yet ported to the PyTorch package (one device "
                "holds the whole matrix); use --gram-mode auto"
            )
        _check_enum("compute", "--eigh-mode", self.eigh_mode, EIGH_MODES,
                    "dense eigh vs randomized subspace solver; auto picks "
                    "by shape")
        _check_enum("compute", "pack_stream", self.pack_stream, PACK_STREAMS,
                    "host->device block transport")
        _check_enum("compute", "--device", self.device, DEVICES,
                    "cuda unless the CPU is asked for")
        _check_int("compute", "--num-pc", self.num_pc, 1, 1 << 20,
                   "principal coordinates to keep")
        _check_int("compute", "--eigh-iters", self.eigh_iters, 0, 10_000,
                   "randomized solver power iterations")
        _check_int("compute", "--eigh-oversample", self.eigh_oversample, 0,
                   1 << 20, "randomized solver extra probe columns")
        if self.metric is not None and \
                self.metric not in kernels.finalizable_names():
            raise ValueError(
                f"bad compute config: --metric={self.metric!r} — "
                f"registered kernels: {' | '.join(kernels.finalizable_names())}"
            )


@dataclass
class JobConfig:
    ingest: IngestConfig = field(default_factory=IngestConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    output_path: str | None = None
    # Not ported yet; set only to be refused with a message.
    model_path: str | None = None

    def __post_init__(self):
        if self.model_path:
            raise ValueError(
                "bad job config: --save-model — persisted models (and the "
                "projection that reads them) are not yet ported to the "
                "PyTorch package; run without it"
            )

    def replace(self, **kw) -> "JobConfig":
        return dataclasses.replace(self, **kw)
