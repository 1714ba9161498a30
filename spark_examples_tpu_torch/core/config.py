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

# Compute backends (--backend): the JAX package's names, so its command
# lines carry over. "jax-tpu" is the port's device route (the job's
# --device, the CUDA kernels on a card); "cpu-reference" is the NumPy /
# SciPy oracle (utils/oracle.py), a host route chosen explicitly, never
# a fallback.
BACKENDS = ("jax-tpu", "cpu-reference")
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
# Genotype sources. ``store`` is the content-addressed dataset store
# (also spelled ``store:<dir>``); ``parquet`` a wide variant-by-sample
# table (ingest/parquet.py, needs pyarrow).
SOURCES = ("synthetic", "vcf", "plink", "packed", "parquet", "store")
# Chunk-payload codecs of the store's --store-codec flag (store/codec.py
# reads this tuple): "raw" = no compression, "zlib" = per-chunk deflate
# at a fixed level, "zlib-dict" = deflate with a per-contig preset
# dictionary trained during compaction.
STORE_CODEC_SPECS = ("raw", "zlib", "zlib-dict")
# Accuracy ladder of the PCoA/PCA eigensolve (solvers/): "exact" is the
# dense route (materialized N x N -> dense or randomized eigh); "sketch"
# folds a low-rank range sketch Y = B @ Omega into (N, rank) state during
# the single variant pass and solves from the Nystrom core, with no N x N
# anywhere; "corrected" re-streams the cohort sketch_iters more times as
# subspace-iteration power steps before a Rayleigh solve.
SOLVER_LADDER = ("sketch", "corrected", "exact")
# Numeric twin of the ladder for the solver.rung gauge (0 sketch,
# 1 corrected, 2 exact).
SOLVER_RUNG_ID = {rung: i for i, rung in enumerate(SOLVER_LADDER)}
SKETCH_RANK_DEFAULT = 64
SKETCH_ITERS_DEFAULT = 2
# Gram accumulation plans over the device mesh (parallel/gram_sharded):
# "replicated" = one device holds the N x N accumulators; "variant" =
# each slot takes a variant shard of every block and the N x N partials
# are summed; "tile2d" = the accumulators are tiled over the (i, j) mesh,
# no slot holding more than its tile. "auto" = replicated on one slot,
# variant while the leaves fit a device's budget, tile2d past it.
GRAM_PLAN_MODES = ("replicated", "variant", "tile2d")
GRAM_MODES = ("auto",) + GRAM_PLAN_MODES
# tile2d block reassembly (parallel/gram_sharded): "gather" = every slot
# gets a copy of every variant shard before it contracts; "ring" = D
# steps, each slot contracting the shard it holds while the shards rotate
# one hop (bitwise the gather for the count family); "auto" = gather
# (the JAX package's v5e rule is not the port's: parallel/gram_sharded.py
# resolve_transport).
TILE2D_TRANSPORTS = ("auto", "gather", "ring")
# Sparse-neighbor output shapes (neighbors/, the --neighbors-output
# flag): "topk" writes per-sample k-nearest rows (TopKResult), "pairs"
# the deduplicated candidate pair list with exact similarities.
NEIGHBORS_OUTPUTS = ("topk", "pairs")
# Admission priority classes of the fleet router (serve/router.py):
# "interactive" requests drain strictly before "batch" backfill, and each
# class has its own shed threshold and default deadline (ServeConfig).
# Earlier is higher priority; PRIORITY_CLASSES[0] is the default class.
PRIORITY_CLASSES = ("interactive", "batch")
DEFAULT_PRIORITY = PRIORITY_CLASSES[0]

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


@dataclass(frozen=True)
class ReferenceRange:
    """A genomic range ``contig:start:end`` (``--references``): the
    half-open position interval ``[start, end)`` on ``contig``."""

    contig: str
    start: int
    end: int

    @classmethod
    def parse(cls, spec: str) -> "ReferenceRange":
        try:
            contig, start, end = spec.split(":")
            rng = cls(contig, int(start), int(end))
        except ValueError:
            raise ValueError(
                f"bad reference range {spec!r}: expected CONTIG:START:END "
                "(e.g. chr22:16050000:17000000)"
            ) from None
        if rng.end <= rng.start:
            raise ValueError(
                f"bad reference range {spec!r}: end must be > start"
            )
        return rng

    def __str__(self) -> str:
        return f"{self.contig}:{self.start}:{self.end}"


@dataclass
class IngestConfig:
    """Which variants to stream, from where, in what block shape."""

    # synthetic | vcf | plink | packed | parquet | store. "store:<dir>" is
    # normalized here into source="store", path="<dir>".
    source: str = "synthetic"
    # file or directory of a vcf/plink/packed/parquet/store source
    path: str | None = None
    references: list[ReferenceRange] = field(default_factory=list)
    n_samples: int = 2504  # synthetic default: 1000 Genomes phase-3 cohort
    n_variants: int = 100_000
    n_populations: int = 5
    seed: int = 0
    block_variants: int = 8192  # variants per streamed block
    # Host->device pipeline depth: produced blocks that may wait in the
    # prefetch queue while earlier copies and updates drain.
    prefetch_blocks: int = 2
    # Variant QC (ingest/filters.py): drop variants with minor-allele
    # frequency < maf or missing-call rate > max_missing. The defaults
    # keep everything.
    maf: float = 0.0
    max_missing: float = 1.0
    # LD pruning (ingest/ldprune.py, the PLINK --indep-pairwise
    # analogue), applied after the QC filter: greedily drop variants
    # whose within-window r^2 against a kept variant exceeds ld_r2
    # (0 = off).
    ld_r2: float = 0.0
    ld_window: int = 256
    ld_carry: int = 0  # 0 = auto (window // 4)
    # Parse/pack/hash/write worker threads of the `ingest` compaction
    # (ingest/parallel.py); ordered reassembly keeps the store byte for
    # byte the 1-worker one.
    ingest_workers: int = 4
    # Transient-IO retries per incident for file-backed sources
    # (ingest/resilient.py): a failed read re-opens the source and seeks
    # back to the cursor, with exponential backoff and jitter from
    # io_retry_backoff_s. 0 disables the wrapper. Corrupt blocks are
    # never retried.
    io_retries: int = 3
    io_retry_backoff_s: float = 0.05
    # Dataset-store reads: the decode cache's host-RAM budget (0 = no
    # cache), and the readahead pool's depth floor and adaptive ceiling
    # (chunks verified and decoded ahead of the cursor; 0 = off / pinned
    # at the floor).
    store_cache_mb: int = 256
    readahead_chunks: int = 2
    readahead_chunks_max: int = 16
    # Chunk codec of `ingest` compactions (STORE_CODEC_SPECS); reads
    # take each chunk's codec from the manifest.
    store_codec: str = "zlib"
    # Peer store directories holding content-addressed chunk copies: a
    # chunk failing its verify is healed from a replica, else from the
    # manifest's recorded origin.
    store_replicas: list[str] = field(default_factory=list)

    def __post_init__(self):
        _check_int("ingest", "block_variants", self.block_variants, 1,
                   1 << 26, "variants per streamed block")
        _check_int("ingest", "prefetch_blocks", self.prefetch_blocks, 1,
                   4096, "host->device pipeline depth; the stream cannot "
                   "run unbuffered, so at least 1")
        _check_int("ingest", "--ld-window", self.ld_window, 2, 1 << 20,
                   "LD pruning window, variants")
        _check_int("ingest", "--ld-carry", self.ld_carry, 0,
                   self.ld_window - 1, "kept variants carried across "
                   "windows; 0 = window // 4, below the window")
        _check_int("ingest", "--ingest-workers", self.ingest_workers, 1,
                   256, "parse/pack worker threads; 1 = serial")
        _check_int("ingest", "--io-retries", self.io_retries, 0, 1000,
                   "transient-IO retries per incident; 0 = no retry")
        _check_int("ingest", "--store-cache-mb", self.store_cache_mb, 0,
                   1 << 20, "decode-cache budget in MB; 0 = no cache")
        _check_int("ingest", "--readahead-chunks", self.readahead_chunks,
                   0, 65536, "store chunks decoded ahead of the cursor; "
                   "0 = off")
        _check_int("ingest", "--readahead-chunks-max",
                   self.readahead_chunks_max, 0, 65536,
                   "adaptive readahead ceiling; 0 = pin the depth at "
                   "--readahead-chunks")
        if 0 < self.readahead_chunks_max < self.readahead_chunks:
            raise ValueError(
                f"bad ingest config: --readahead-chunks-max="
                f"{self.readahead_chunks_max} sits under "
                f"--readahead-chunks={self.readahead_chunks} — the "
                "adaptive ceiling cannot be below the floor (raise it, "
                "or set it to 0 to pin the depth)"
            )
        _check_enum("ingest", "--store-codec", self.store_codec,
                    STORE_CODEC_SPECS, "raw = no compression, zlib = "
                    "per-chunk deflate, zlib-dict = deflate with a "
                    "per-contig dictionary trained during compaction")
        if not self.io_retry_backoff_s >= 0.0:
            raise ValueError(
                f"bad ingest config: --io-retry-backoff="
                f"{self.io_retry_backoff_s!r} — expected seconds >= 0"
            )
        for name, value, hi in (("--maf", self.maf, 0.5),
                                ("--max-missing", self.max_missing, 1.0),
                                ("--ld-prune-r2", self.ld_r2, 1.0)):
            if not 0.0 <= value <= hi:
                raise ValueError(
                    f"bad ingest config: {name}={value!r} — expected a "
                    f"number in [0, {hi}]"
                )
        if self.source.startswith("store:"):
            spec_path = self.source.split(":", 1)[1]
            if self.path:
                raise ValueError(
                    f"ambiguous ingest: source {self.source!r} names a "
                    f"store directory AND path={self.path!r} is set — "
                    "use one or the other"
                )
            if not spec_path:
                raise ValueError(
                    "bad source 'store:': expected store:<dir> (the "
                    "compacted store directory)"
                )
            self.source = "store"
            self.path = spec_path


@dataclass
class ComputeConfig:
    """Compute-path knobs."""

    backend: str = "jax-tpu"  # jax-tpu (the device route) | cpu-reference
    # None = the job's default (ibs; the pca job always uses shared-alt).
    metric: str | None = None
    braycurtis_method: str = "auto"
    braycurtis_levels: int = 256
    num_pc: int = 10
    # grm only: standardized dosages in f32 instead of bf16 (~1e-3
    # better relative accuracy; the count metrics are exact either way).
    grm_precise: bool = False
    # Host->device transport: "packed" ships 2-bit packed blocks, "dense"
    # int8; "auto" packs the kernels that declare pack_auto (inputs that
    # are dosages by definition) and keeps dot/euclidean dense: they take
    # arbitrary int8 tables that the 2-bit codec cannot represent.
    pack_stream: str = "auto"
    gram_lowering: str = "auto"
    eigh_mode: str = "auto"
    eigh_iters: int = EIGH_ITERS_DEFAULT
    eigh_oversample: int = EIGH_OVERSAMPLE_DEFAULT
    device: str = "cuda"
    # Accumulator checkpoints (core/checkpoint.py): a job finding one in
    # checkpoint_dir resumes from its cursor; with
    # checkpoint_every_blocks > 0 it saves every that many blocks
    # (0 = resume only, never save).
    checkpoint_dir: str | None = None
    checkpoint_every_blocks: int = 0
    solver: str = "exact"
    sketch_rank: int = SKETCH_RANK_DEFAULT  # probe columns (>= num_pc)
    sketch_iters: int = SKETCH_ITERS_DEFAULT  # extra passes (corrected)
    sketch_seed: int = 0  # probe RNG seed (a resume must keep it)
    gram_mode: str = "auto"  # auto | replicated | variant | tile2d
    # The (i, j) device mesh; None = a near-square factoring of the
    # job's slots (every visible card on cuda; --virtual-devices N slots
    # on one device).
    mesh_shape: tuple[int, int] | None = None
    tile2d_transport: str = "auto"  # auto | gather | ring
    # Streaming incremental PCoA (pipelines/streaming.py): emit
    # coordinate snapshots every this many blocks via warm rank-k
    # subspace refreshes; 0 runs the plain terminal solve.
    stream_refresh_blocks: int = 0
    # Sparse top-k neighbors (neighbors/, the `neighbors` command):
    # MinHash signatures over variant carrier sets, LSH-banded into
    # candidate pairs; only candidates pay the exact evaluation. hashes
    # must divide evenly into bands (each band hashes/bands rows);
    # bucket_cap bounds any one band bucket's share of the candidates
    # (overflow is counted, never unbounded).
    neighbors_output: str = "topk"  # topk | pairs
    neighbors_k: int = 10  # neighbors kept per sample (topk output)
    minhash_hashes: int = 128  # signature length (k permutations)
    minhash_bands: int = 32  # LSH bands (hashes % bands == 0)
    minhash_seed: int = 0  # permutation seed (a resume must keep it)
    minhash_bucket_cap: int = 64  # max samples per band bucket

    def __post_init__(self):
        _check_enum("compute", "--backend", self.backend, BACKENDS,
                    "jax-tpu = the accelerator path, cpu-reference = "
                    "the NumPy/SciPy oracle")
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
                    "the accuracy ladder: sketch = one-pass range sketch, "
                    "corrected = +power-iteration passes, exact = dense "
                    "N x N route")
        _check_int("compute", "--checkpoint-every-blocks",
                   self.checkpoint_every_blocks, 0, 1 << 40,
                   "blocks between checkpoint saves; 0 = never save")
        _check_int("compute", "--sketch-rank", self.sketch_rank, 1, 65536,
                   "range-sketch probe columns; clamped to N at run time")
        _check_int("compute", "--sketch-iters", self.sketch_iters, 0, 1000,
                   "extra streamed power-iteration passes of the "
                   "corrected rung; each is one full pass over the cohort")
        _check_int("compute", "--sketch-seed", self.sketch_seed,
                   -(2 ** 63), 2 ** 63 - 1,
                   "probe RNG seed; a resumed job must keep it")
        _check_enum("compute", "--gram-mode", self.gram_mode, GRAM_MODES,
                    "gram accumulation plan; auto picks from the mesh "
                    "and accumulator size")
        _check_enum("compute", "--tile2d-transport", self.tile2d_transport,
                    TILE2D_TRANSPORTS,
                    "gather = every slot copies every variant shard "
                    "before it contracts; ring = shards rotate one hop "
                    "per step while each slot contracts the one it holds; "
                    "auto = gather")
        if self.mesh_shape is not None:
            shape = tuple(self.mesh_shape)
            if not (len(shape) == 2 and all(
                    isinstance(a, int) and a >= 1 for a in shape)):
                raise ValueError(
                    f"bad compute config: --mesh-shape={self.mesh_shape!r} "
                    "— expected IxJ with positive integers, e.g. 2x4")
            self.mesh_shape = shape
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
        _check_enum("compute", "--neighbors-output", self.neighbors_output,
                    NEIGHBORS_OUTPUTS, "topk = per-sample k-nearest rows, "
                    "pairs = the deduplicated candidate pair list with "
                    "exact similarities")
        _check_int("compute", "--neighbors-k", self.neighbors_k, 1, 65536,
                   "neighbors kept per sample; clamped to N-1 at run time")
        _check_int("compute", "--minhash-hashes", self.minhash_hashes, 1,
                   65536, "MinHash signature length (k permutations)")
        _check_int("compute", "--minhash-bands", self.minhash_bands, 1,
                   65536, "LSH bands; each band hashes/bands signature rows")
        _check_int("compute", "--minhash-seed", self.minhash_seed,
                   -(2 ** 63), 2 ** 63 - 1,
                   "permutation seed; a resumed job must keep it")
        _check_int("compute", "--minhash-bucket-cap",
                   self.minhash_bucket_cap, 1, 1 << 20,
                   "max samples admitted per band bucket; overflow is "
                   "counted in neighbors.bucket_overflows")
        if self.minhash_hashes % self.minhash_bands != 0:
            raise ValueError(
                f"bad compute config: --minhash-hashes="
                f"{self.minhash_hashes} is not a multiple of "
                f"--minhash-bands={self.minhash_bands} — LSH banding "
                "slices the signature into equal bands of "
                "hashes/bands rows each"
            )
        if self.metric is not None and \
                self.metric not in kernels.finalizable_names():
            raise ValueError(
                f"bad compute config: --metric={self.metric!r} — "
                f"registered kernels: {' | '.join(kernels.finalizable_names())}"
            )
        if self.gram_lowering == "fused":
            # A metric/transport pair the packed kernel can never serve
            # dies here, flag named, not inside the streaming job.
            metric = self.metric or "ibs"
            if kernels.get(metric).family != "table":
                kernels.check_fused_lowering(
                    metric, kernels.streams_packed(metric, self.pack_stream))
        if self.solver != "exact":
            if self.sketch_rank < self.num_pc:
                raise ValueError(
                    f"bad compute config: --sketch-rank={self.sketch_rank} "
                    f"< --num-pc={self.num_pc} — the sketch cannot recover "
                    "more eigenpairs than it has probe columns; raise "
                    "--sketch-rank (components + ~32 oversample is the "
                    "usual shape)"
                )
            if self.solver == "corrected" and self.sketch_iters < 1:
                raise ValueError(
                    "bad compute config: --solver=corrected with "
                    "--sketch-iters=0 is the plain sketch rung — ask for "
                    "--solver=sketch, or give corrected >= 1 extra pass"
                )
            if self.metric is not None:
                try:
                    kernels.check_sketchable(self.metric, self.solver)
                except ValueError as e:
                    raise ValueError(f"bad compute config: {e}") from None


@dataclass
class TelemetryConfig:
    """Structured-telemetry export (core/telemetry.py).

    ``dir`` turns export on: ``<dir>/rank<k>/{trace.jsonl,metrics.json}``
    (trace.jsonl loads in Perfetto / chrome://tracing) and a summary
    table. ``trace_events=False`` keeps the metrics export but buffers
    no per-block span events. ``flush_s > 0`` republishes
    ``metrics.json`` and a rolling ``live_trace.jsonl`` every ``flush_s``
    seconds while the job runs. ``live_port`` (0 = ephemeral) binds the
    HTTP sidecar (core/live.py: ``/metrics``, ``/debug/telemetry``,
    ``/healthz``). ``trace_sample`` is the share of served requests
    that get a ``trace.request`` span and an exemplar slot
    (deterministic on the trace id). Metrics are collected either way.
    """

    dir: str | None = None
    trace_events: bool = True
    flush_s: float = 0.0  # 0 = export at exit only
    live_port: int | None = None  # None = no sidecar; 0 = ephemeral
    trace_sample: float = 1.0

    def __post_init__(self):
        if not (isinstance(self.flush_s, (int, float))
                and 0.0 <= self.flush_s <= 86400.0):
            raise ValueError(
                f"bad telemetry config: --telemetry-flush-s="
                f"{self.flush_s!r} — expected seconds in [0, 86400] "
                "(0 disables the periodic flusher)"
            )
        if self.flush_s and not self.dir:
            raise ValueError(
                "bad telemetry config: --telemetry-flush-s needs "
                "--telemetry-dir (the periodic flusher publishes "
                "snapshots under the export directory)"
            )
        if self.live_port is not None and not (
                isinstance(self.live_port, int)
                and 0 <= self.live_port <= 65535):
            raise ValueError(
                f"bad telemetry config: --live-port={self.live_port!r} "
                "— expected a TCP port in [0, 65535] (0 binds an "
                "ephemeral port)"
            )
        if not (isinstance(self.trace_sample, (int, float))
                and not isinstance(self.trace_sample, bool)
                and 0.0 <= self.trace_sample <= 1.0):
            raise ValueError(
                f"bad telemetry config: --trace-sample="
                f"{self.trace_sample!r} — expected a sample rate in "
                "[0, 1] (the fraction of requests granted detailed "
                "per-request tracing; 0 disables, 1 traces everything)"
            )


@dataclass
class ServeConfig:
    """Online projection server knobs (serve/, the ``serve`` command).

    ``max_batch`` x ``max_linger_ms`` is the latency/throughput dial:
    the batching worker coalesces up to max_batch queued queries but
    never waits longer than the linger past the first one, and the
    batch is padded to max_batch. ``max_queue`` bounds admission — a
    full queue sheds with an explicit ServerOverloaded. ``deadline_ms``
    (0 = none) is the default per-request deadline; ``cache_entries``
    (0 = off) sizes the LRU result cache keyed by genotype digest.
    ``drain_timeout_s`` is the SIGTERM drain budget: stragglers past it
    fail loudly (ServerClosed) and count in ``serve.drain_abandoned``.

    Fleet mode (``serve --fleet fleet.json``, serve/fleet.py): one
    process routes requests over many named (model, panel) routes.
    ``fleet_manifest`` names the route registry; ``fleet_budget_mb``
    bounds the warm panel pool (panels past it are LRU-evicted and
    re-stage on demand, counted in ``fleet.restage_total``). Admission
    gains the PRIORITY_CLASSES: per-class shed thresholds
    (``queue_interactive``/``queue_batch``) and default deadlines
    (``deadline_interactive_ms``/``deadline_batch_ms``; 0 = none).
    ``loadgen_seed`` seeds the hedge-delay ring and the burst schedule.
    """

    model_path: str | None = None
    max_batch: int = 8
    max_linger_ms: float = 2.0
    max_queue: int = 64
    cache_entries: int = 256
    deadline_ms: float = 0.0
    host: str = "127.0.0.1"
    port: int = 8777
    fleet_manifest: str | None = None
    fleet_budget_mb: float = 1024.0
    queue_interactive: int = 64
    queue_batch: int = 256
    deadline_interactive_ms: float = 0.0
    deadline_batch_ms: float = 0.0
    drain_timeout_s: float = 60.0
    loadgen_seed: int = 0

    def __post_init__(self):
        def _check(flag, value, lo, hi, why):
            if not (isinstance(value, (int, float)) and lo <= value <= hi):
                raise ValueError(
                    f"bad serve config: {flag}={value!r} — expected a "
                    f"number in [{lo}, {hi}] ({why})"
                )

        _check("--max-batch", self.max_batch, 1, 4096,
               "micro-batch ceiling; batches pad to it")
        _check("--max-linger-ms", self.max_linger_ms, 0.0, 60_000.0,
               "max coalescing wait past the first queued query")
        _check("--max-queue", self.max_queue, 1, 1 << 20,
               "bounded admission queue; a full queue sheds")
        _check("--cache-entries", self.cache_entries, 0, 1 << 20,
               "LRU result cache size; 0 disables")
        _check("--deadline-ms", self.deadline_ms, 0.0, 86_400_000.0,
               "default per-request deadline; 0 = none")
        _check("--fleet-budget-mb", self.fleet_budget_mb, 0.001, 1 << 24,
               "warm panel pool budget for fleet mode")
        _check("--queue-interactive", self.queue_interactive, 1, 1 << 20,
               "interactive-class shed threshold (fleet admission)")
        _check("--queue-batch", self.queue_batch, 1, 1 << 20,
               "batch-class shed threshold (fleet admission)")
        _check("--deadline-interactive-ms", self.deadline_interactive_ms,
               0.0, 86_400_000.0,
               "interactive-class default deadline; 0 = none")
        _check("--deadline-batch-ms", self.deadline_batch_ms,
               0.0, 86_400_000.0,
               "batch-class default deadline; 0 = none")
        _check("--drain-timeout-s", self.drain_timeout_s, 0.1, 86_400.0,
               "SIGTERM drain budget before stragglers fail loudly")
        _check("--loadgen-seed", self.loadgen_seed, 0, 2**63 - 1,
               "seeds the hedge-delay ring and burst schedule")
        if not isinstance(self.loadgen_seed, int):
            raise ValueError(
                f"bad serve config: --loadgen-seed={self.loadgen_seed!r} "
                "— expected an integer seed (deterministic replay needs "
                "an exact value)")


@dataclass
class JobConfig:
    ingest: IngestConfig = field(default_factory=IngestConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    output_path: str | None = None
    # pcoa/pca: persist the fitted embedding (eigenpairs + centering
    # statistics) so `project` can place new samples into the same
    # coordinates without refitting (pipelines/project.py). The sketch
    # rungs save the factorized model (models/factorized.py) where the
    # metric has a factorized projection path, validated below.
    model_path: str | None = None

    def __post_init__(self):
        # --save-model x --solver x --metric crosses the two configs, so
        # it is checked here. Only combinations invalid for every job
        # kind are refused: one JobConfig serves pcoa, pca and
        # similarity, and the kind-specific rows resolve in the job.
        if self.model_path and self.compute.solver != "exact":
            try:
                kernels.check_factorized_savable(self.compute.metric,
                                                 self.compute.solver)
            except ValueError as e:
                raise ValueError(f"bad job config: {e}") from None

    def replace(self, **kw) -> "JobConfig":
        return dataclasses.replace(self, **kw)
