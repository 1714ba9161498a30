#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught and ignored):

1. Refuse to run without a CUDA device; print the card's name and power
   limit (``nvidia-smi``) and ``torch.cuda.get_device_name(0)``.
2. Build every kernel of ``spark_examples_tpu_torch/csrc`` with nvcc
   (one process per source, started together) and print the ptxas
   report: registers, shared memory, spills. Read the SASS of the built
   libraries (``cuobjdump -sass``): K1's must hold an int8 tensor-core
   instruction (IMMA or IGMMA); K2's FADD count, and how many take the
   ``|.|`` modifier, is printed.
3. Hold the packed-gram kernel (K1) against its plain PyTorch version on
   the card, bitwise: all six count kernels' product sets on ragged
   shapes and shapes at the tile and chunk edges, each as a symmetric
   launch (one tensor on both sides: I <= J tiles, mirrored) and an
   asymmetric one, and the main shape (2504 samples x 2048 bytes, ibs).
4. Time K1 at the main shape with CUDA events, beside its bound (the
   work the output needs, and the full square), the plain version and one library yardstick
   (``torch._int_mm`` x4 on the pre-decoded int8 operands, which
   computes the full square). Then at the largest N on the dense route
   (16,384 samples x 2048 bytes, random bytes): K1 bitwise against
   ``torch._int_mm`` and both timed (no plain version at that shape).
5. Run the Quickstart job through the CLI's ``main``:
   ``pcoa --n-samples 2504 --n-variants 100000 --metric ibs --num-pc 10``,
   with K1's launch count set to 0 just before and read just after; it
   must be ceil(100000 / 8192) = 13. The coordinates must be finite and
   separate the planted populations in PC1-2 (between-centroid over
   within-population distance >= SEPARATION_MIN).
6. Run the same job's gram stage under ``--gram-lowering reference`` and
   under ``auto`` (K1) through the library: the int32 accumulators and
   the finalized distances must be bitwise equal.
7. Hold the Manhattan kernel (K2) against its plain PyTorch version on
   the card: bitwise on ragged integer OTU-like tables (N at the 128
   tile's edges, F % 4 in {0, 1, 3}) and at the
   Bray-Curtis job's shape (10,000 samples x 4,096 features), within
   ``rtol = 2 F 2^-24`` on a non-integer table (the recursive-summation
   bound of two f32 sums of F nonnegative terms in different orders).
8. Time K2 at the job's shape with CUDA events, beside its bound (the
   i <= j half the output needs, and the full square), the plain version
   (one rep), ``torch.cdist(p=1)`` (the full square; it must agree
   bitwise on the integer table) and the ``matmul`` lowering
   (levels 256).
9. Run the Bray-Curtis job through the CLI: ``pcoa --metric braycurtis
   --n-samples 10000 --n-variants 4096 --num-pc 10``; K2 must launch
   exactly once, the coordinates must be finite and separate the
   planted populations (PC1-2 separation >= SEPARATION_MIN; the JAX
   package's own CPU run of this job on 500 and 1,000 samples of the
   same seed gives 20.3 and 20.0).
10. The ``exact`` and ``fused`` Bray-Curtis lowerings of the job's table
    must give bitwise equal distances.
11. Run the ``pca`` job through the CLI at the Quickstart shape: K1 must
    launch 13 times, the coordinates must be finite and separate the
    populations.
12. Dense transport: a (2504, 16,384) int8 raw-value table (numpy seed
    3, values 0..127, 10 % missing): the ``torch._int_mm`` lowering of
    the euclidean and dot product sets bitwise against the plain
    ``int_dot``, both timed. Then ``similarity --metric euclidean`` and
    ``--metric dot`` through the CLI on the Quickstart cohort (dense
    transport, 13 blocks): K1 launches 0 times.
13. grm: ``pcoa --metric grm`` through the CLI at the Quickstart shape
    (packed transport, bf16; K1 launches 0 times); coordinates finite
    and separating the populations. The gram stage again in bf16 and
    with ``--grm-precise``: ``nvar`` equal, max |bf16 - f32| / max |f32|
    of ``zz`` printed.
14. Packed store: ``pack`` the Quickstart cohort through the CLI, then
    ``pcoa --source packed``: K1 launches 13 times; the store's gram
    stage gives int32 accumulators bitwise equal to phase 6's.
15. PLINK: the cohort written with ``write_plink`` (62.6 MB ``.bed``),
    ``pcoa --source plink``: K1 launches 13 times; accumulators bitwise
    equal to phase 6's.
16. VCF: the cohort's first 4,096 variants written with ``write_vcf``;
    the parsed blocks bitwise equal to the synthetic source's, the
    parse timed; ``similarity --source vcf`` through the CLI.
17. QC + LD: ``pcoa --source plink --maf 0.01 --max-missing 0.1
    --ld-prune-r2 0.2`` on phase 15's fileset: the kept variant count
    printed, the coordinates separating the populations.
18. Dataset store: ``ingest`` the Quickstart cohort (chunks of 16,384)
    with ``--store-codec zlib`` (4 workers), ``raw`` and ``zlib-dict``,
    printing compaction seconds, stored MB and the compression ratio;
    the zlib store compacted again with ``--ingest-workers 1`` must be
    identical to the 4-worker one, file for file.
19. ``pcoa --source store:<dir>`` for each codec: K1 launches 13 times;
    the store's gram stage gives int32 accumulators bitwise equal to
    phase 6's; the gram phase is printed beside phase 14's.
20. ``similarity --metric euclidean --source store:<dir>`` on the dense
    transport (each block decoded into its pinned slab): K1 launches 0
    times; accumulators bitwise equal to phase 12's.
21. ``ingest`` phase 15's PLINK fileset, then ``pcoa --source
    store:<dir> --references 1:30001:70001``: 40,000 variants answered
    from the position index, 5 K1 launches, accumulators bitwise equal
    to ``--source plink`` with the same range.
22. Damage, then heal: a byte flipped in a zlib chunk heals inline from
    the origin during ``pcoa`` (13 launches, accumulators bitwise); a
    byte flipped in a copy of the raw store fails the read when
    auto-heal is off (``StoreCorruptError`` with the cursor, quarantine
    ledger written); ``store heal --replica <raw store>`` repairs it,
    another flip is repaired by ``store heal --verify-all`` from the
    origin; the healed store equals the raw store file for file, and
    its job is bitwise again.
23. Checkpoint kill and resume at the Quickstart shape: the ibs gram
    stage through the library with ``--checkpoint-every-blocks 4`` and a
    wrapping source that dies when asked for block 11 (generations at
    variants 32,768 in ``.old`` and 65,536); ``pcoa --checkpoint-dir``
    through the CLI resumes with 5 K1 launches (coordinates as phase
    5's), and through the library with int32 accumulators bitwise equal
    to phase 6's; then a byte flipped in the latest generation's leaf:
    the reruns fall back to ``.old`` with 9 launches, bitwise again, and
    the corrupt generation is set aside as ``.corrupt``.
24. ``similarity --output-path d.npy`` (13 launches) then ``pcoa
    --matrix-path d.npy`` (0 launches): the handoff Gower-transforms the
    similarity (the JAX package's rule), so its coordinates are held
    against the PCoA of the Gower distance of phase 6's accumulators,
    per column up to sign, and must separate the populations.
25. The accuracy ladder, ``pcoa --metric grm`` from phase 14's packed
    store through the CLI at exact, sketch and corrected with 1 and 3
    iterations (rank 64; the eigenvalues and proportions are read from
    the job's output at full precision): K1 launches 0 times on
    the sketch rungs; the JAX package's accuracy contract (corrected(3)
    within 1e-2 on the top 4 eigenvalues and 0.15 on all 10, sketch
    within 0.5, the ladder monotone, proportions within 5 %).
26. ``pcoa --metric ibs --solver corrected`` and ``pca --solver
    corrected`` from the packed store through the CLI: 0 launches,
    coordinates separating the populations; a corrected-rung job killed
    6 blocks into its second pass (checkpoint every 4 blocks) resumes
    to coordinates bitwise equal to phase 25's uninterrupted run.
27. ``ingest`` 100,000 synthetic samples x 16,384 variants into a raw
    store, then ``pcoa --metric ibs --solver corrected --sketch-iters 2
    --source store:<dir>``: ``torch.cuda.max_memory_allocated()`` is
    printed beside ``sketch.nxn_bytes`` (160 GB) and must stay below one
    N x N leaf (40 GB); the coordinates must be finite and separate the
    populations.
28. The native host codec (built in phase 2 beside the CUDA kernels,
    with g++ into ``spark_examples_tpu_torch/_build/``): the library
    must be there and export all five entries. Phase 16's VCF parsed
    native and Python, timed, blocks identical; a Quickstart block packed
    and unpacked both ways, bytes identical. The zlib store's ibs job,
    its euclidean dense route and phase 21's ``--references`` job run
    through the CLI natively and with the Python decode forced:
    ``store.codec.fallback`` 0 on the native runs and 1 on the forced
    runs of the two routes that decode chunks (the packed route inflates
    whole chunks with Python's zlib either way), K1 launches as before
    (13, 0, 5), accumulators bitwise equal to phases 6, 12 and 21, gram
    phases printed side by side.
29. Fit, then project: phase 14's packed cohort split into a 2,004-
    sample panel and 500 new samples (two packed stores).
    ``pcoa --metric ibs --save-model`` (13 K1 launches), ``pca
    --save-model`` (13) and ``pcoa --solver corrected --save-model`` (a
    factorized model, 0) on the panel; ``project`` of the 500 and of the
    panel itself under each model (0 launches): every held-out sample
    must lie nearest its own population's centroid (PC1-4), and the
    panel must land on its fitted coordinates (top 4 components within
    1e-3 of max|coords|) for the exact models. The cross products of one
    block timed, bitwise equal to the CPU's.
30. ``cross-kinship`` of the 500 new samples, 10 of them replaced by
    copies of panel samples, against the panel: phi >= 0.45 on exactly
    those 10 pairs; 0 launches.
31. Parquet: whether pyarrow is present. If it is, the cohort's first
    4,096 variants written with ``write_parquet`` read back bitwise and
    ``similarity --source parquet`` runs (1 K1 launch); if not, the CLI
    must refuse ``--source parquet`` with its ImportError.
32. Streaming PCoA: ``pcoa --source packed --stream-refresh-blocks 4
    --metric ibs --num-pc 10`` on phase 14's store through the CLI: K1
    launches 13 times, snapshots at 32,768, 65,536 and 98,304 variants;
    the 4 structure eigenvalues within rtol 1e-2 (atol 1e-4) of phase
    14's dense job (rerun through the library) and |coords| on PC1-2
    within rtol 1e-2, atol 1e-3 (the JAX package's own tolerances), all
    10 within 1e-2 of the top eigenvalue (the 6 bulk ones converge only
    to a few percent, in the JAX package's route too); the first
    snapshot's top eigenvalue within 25 % of the final one, the later
    ones within 10 %; the populations separate. The gram phase with
    refreshes is printed beside phase 14's without them.
33. The example tier on phase 14's store through the CLI:
    ``search-variants`` (a full scan, then ``--positions`` with 5
    positions that are there and 1 that is not) and ``sample-stats``;
    the TSVs must equal counts NumPy computes from the unpacked cohort,
    exactly; K1 launches 0 times.
34. ``coverage`` of chr22:16050000:51050000 (35 Mb) with 7,000,000
    synthetic reads of 150 bp (30x): the depth must equal a NumPy
    ``bincount``/``cumsum`` of the same reads, bitwise; a SAM file of
    200,000 of those reads on its first 1 Mb, written here, gives the
    same depth as the reads themselves.
35. ``neighbors --metric ibs`` on phase 14's store with the JAX
    package's defaults (128 hashes, 32 bands, k 10): K1 launches 0
    times; the candidate-pair count and the sha256 of the top-k file
    equal the JAX package's CPU run of the same job (constants below,
    with the command that produced them); every evaluated similarity is
    bitwise equal to the float64 finalize of phase 6's accumulators at
    that pair and within 1e-6 of phase 6's f32 similarity; the job
    killed in its MinHash pass under ``--checkpoint-dir`` (through the
    library) resumes through the CLI to a byte-identical file.
36. (Retired number: the closing print is phase 54.)
37. A traced gram job: ``pcoa --source packed --metric ibs --num-pc 10``
    on phase 14's store through the CLI, once with ``--telemetry-dir``
    and once with ``--telemetry-dir`` and ``--trace-dir`` (a
    ``torch.profiler`` capture): 13 K1 launches, coordinates bitwise
    equal to phase 14's untraced run; the export's ``trace.jsonl`` holds
    one ``phase.gram`` and 13 ``gram.block`` spans and ``metrics.json``
    the feed's ``prefetch.*`` waits; the profiler trace holds 13 K1
    kernel events (found by the kernel names of K1's SASS, phase 2).
    Printed: K1's summed device time from the trace beside phase 4's
    CUDA-event time, the device's busy and idle share of the
    ``phase.gram`` range, the gram phase traced, with telemetry only and
    untraced (phase 14).
38. Served projections in-process: ``serve --model <phase 29's pcoa
    model> --loadgen 4 --loadgen-requests 125 --cache-entries 0`` over
    the 500 new samples: 500 answers, 0 errors, 0 sheds, 0 K1 launches;
    sustained QPS and latency p50/p95/p99 printed. Then a
    ``ProjectionServer`` on the card under the pcoa, pca and factorized
    models of phase 29: every new sample nearest its own population, 16
    rows bitwise equal to the CLI ``project`` of that one sample, all
    500 within 1e-5 of max|coords| of phase 29's 500-row ``project``.
39. HTTP: the CLI ``serve`` as a subprocess (``--port 0 --port-file``,
    ``--telemetry-dir``): 32 ``POST /project`` answers bitwise equal to
    phase 38's rows with their X-Trace-Id echoed; ``/healthz``,
    ``/readyz``, ``/stats``, ``/metrics`` (``serve.*`` series) and
    ``/debug/requests`` answer; SIGTERM drains and the process exits 0
    with the exported ``serve.*`` counts equal to the requests sent.
40. ``neighbors --model`` (phase 29's pcoa model and panel, phase 30's
    cohort with its 10 planted copies as the queries, k 10): 0 K1
    launches; each planted copy's top-1 is its panel twin at similarity
    1.0; every similarity bitwise equal to the ibs pair finalize of the
    cross statistics accumulated on the card; the file's sha256 equal to
    the JAX package's CPU run of the same job (constant below, with the
    commands that produced it).
41. Supervision: ``similarity --metric ibs --source packed`` on phase
    14's store with ``--checkpoint-every-blocks 4 --telemetry-dir
    --supervise`` as a subprocess, killed at phase 23's block (the 11th
    block read, ``ingest.block_read:kill`` from the environment): exit 0
    after ``supervisor: attempt 0: crash: exit code 113``, ``.npy``
    bytes equal to the unsupervised run's, ``supervisor.json`` with 1
    restart, ``telemetry stitch`` giving tracks ``attempt 0 rank 0`` and
    ``attempt 1 rank 0`` and a restart marker, K1 in both attempts as
    each attempt's own ``metrics.json`` counts it
    (``kernel.packed_gram.launches``, counted where K1 launches;
    attempt 0 dies by ``os._exit``, so its count is that of its last
    live flush, a lower bound), the resumed attempt one launch a
    ``gram.block`` from a checkpoint generation, the kernels loaded
    from ``_build/``, and never more than this script plus one child
    holding a context on the card (the parent holds none).
42. The same job with a block read stalled 120 s and
    ``--supervise-stall-timeout 5``: the watchdog's verdict is a stall,
    the child dies by TERM (KILL after the grace; its TERM export gives
    attempt 0's exact K1 count), and the restart writes the same
    bytes.
43. Fleet in-process: a manifest of three routes over phase 29's panel
    under phase 38's pcoa (with ``topk``), pca and factorized models,
    budget 2.5 staged panels: 16 new samples a route through
    ``FleetRouter`` bitwise equal to phase 38's rows, again after every
    panel is evicted and re-staged, ``fleet.evictions`` and
    ``fleet.restage_total`` >= 1; then ``serve --fleet --loadgen 2``
    through the CLI (interactive p99 <= batch p99) and
    ``run_hedged_loadgen`` over a lingering and a fast router (hedged
    p99 below unhedged, 0 errors); 0 K1 launches.
44. ``serve --fleet`` over HTTP as a subprocess: ``POST
    /project/<route>`` and ``/neighbors/pcoa`` equal phase 43's
    in-process answers, ``/metrics`` carries ``fleet_pool_bytes``,
    SIGTERM drains with exit 0.
45. ``--backend cpu-reference`` against K1, at the Quickstart width cut
    to 16,384 variants (2 blocks; the oracle's float64 host products stay
    within seconds): ``pcoa --metric ibs`` and ``pca`` through the CLI
    with the host oracle (K1 launches 0, K2 0) and on the default route
    (K1 2 launches); the oracle's float64 products summed over its blocks
    equal K1's int32 accumulators exactly (cast both ways), and its
    pieces ``m``, ``d1`` equal K1's; the f64 host and f32 device ibs
    distances within 1e-6; the top 4 coordinates per column up to sign
    within 1e-3 of the column scale. Both walls printed with their
    phases, beside the card line and the host's CPU model and ``nproc``
    (the host route's time is the host's: the measured stand-in for
    BASELINE config 1). Then ``pcoa --debug-nans``: the same coordinates,
    byte for byte, and 2 K1 launches.
46. Bray-Curtis at 1,000 x 4,096: ``pcoa --metric braycurtis
    --backend cpu-reference`` (scipy's ``pdist``, 0 K2 launches) against
    the default route (1 K2 launch): distances within 1e-6 on the
    integer table, coordinates as phase 45's.
47. The fleet controller on the card, in a process of its own
    (``controller_process``): a ``FleetController`` over two
    ``ProcessReplica`` children (``serve --fleet --device cuda`` of phase
    43's manifest with an ``slos`` block, each exporting telemetry under
    ``<workdir>/<slot>``), started side by side and stepped until both
    are ready; 16 new samples a route through each equal phase 43's rows
    bitwise; one child SIGKILLed, the controller steps to a ``respawn``
    decision and the respawned child answers bitwise again.
    ``controller.json`` holds the ``crash`` incident; ``telemetry
    timeline --path`` prints rows; ``telemetry stitch --fleet`` gives one
    pid block per slot and a controller marker; every child got
    ``--device cuda``; K1 launches 0 (here and as the children export
    it); the controller process never initialised CUDA, and the card
    never held more processes than this script and two children.
48. The device mesh on one card: ``pcoa --metric ibs`` from phase 14's
    packed store through the CLI with ``--gram-mode tile2d --mesh-shape
    2x2 --tile2d-transport gather`` inside ``virtual.virtual_slots(4)``:
    a 2 x 2 mesh of four virtual slots on cuda:0 (the route, not
    scaling). K1 launches 4 a block (one per tile: the two diagonal
    tiles symmetric, the two others rectangular) = 52, ``gram.fused_blocks`` 13 (one a block, the
    JAX meaning), the run's plan tile2d with tiled accumulators, the
    accumulators gathered from the slots bitwise phase 6's, and the
    structure PCs of the tiled randomized solve within 1e-3 of phase
    14's dense solve.
49. The same with ``--tile2d-transport ring``: K1 16 a block (4 ring
    steps x 4 tiles, on 512-byte shards) = 208, ``gram.ring_steps`` 52,
    ``gram.fused_blocks`` 13; accumulators bitwise.
50. ``--gram-mode variant``: each slot takes a quarter of the block and
    computes the whole 2504 x 2504 partial (K1 symmetric on 512-byte
    shards, 52 launches; the JAX package refuses the fused lowering
    there); accumulators and coordinates bitwise phase 14's.
51. ``pca --gram-mode tile2d`` on the mesh, the transport left at
    ``auto`` (gather: the port's auto, ``resolve_transport``): 52 K1
    launches, ``gram.ring_steps`` 0, ``t1t1`` bitwise phase 6's, the
    structure PCs within 1e-3 of phase 11's.
52. A tiled checkpoint: the tile2d ring job through the library, every 4
    blocks, dying when asked for block 11 (160 K1 launches); 16 tile
    files ``{leaf}.t{row0}_{col0}.npy``, manifest mesh ``[2, 2]`` mode
    tile2d; the CLI resumes with 80 launches (5 blocks x 16) to
    accumulators bitwise phase 6's and coordinates bitwise phase 49's.
53. ``project`` of phase 29's 500 new samples with its pcoa model under
    ``--gram-mode tile2d`` (a tile2d CrossPlan: the cross statistics
    tiled over the mesh while they stream): 0 K1 launches, coordinates
    bitwise phase 29's. Then K1 timed at the tile shapes those phases
    launch it at (1252 x 1252 x 2048 bytes rectangular, the 1252-row
    diagonal tile, 1252 x 1252 x 512-byte ring shards, 2504 x 512-byte
    variant shards), bitwise against its plain version and
    ``torch._int_mm`` x4, beside their bounds.
54. A job of two processes on the pinned card: two ranks of ``python -m
    spark_examples_tpu_torch pcoa --gram-mode variant`` over phase 14's
    packed store, started with ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Each prints its
    backend: gloo with host staging (NCCL refuses two ranks on one GPU).
    ``window_for_process`` gives 7 + 6 blocks: K1 launches 7 and 6 (each
    rank's own ``kernel.packed_gram.launches``), ``gram.fused_blocks`` 7
    on both (one per global step), 2 consensus rounds each, rank 1's one
    pad step, ``multihost.shard_feed_bytes`` of the real slabs only. The
    checkpoint at the last step holds the ranks' reduced accumulators,
    bitwise phase 6's, with the per-rank cursors; rank 0 alone writes the
    coordinates, bitwise phase 14's. The gram phase of each rank and the
    final all_reduce's time are printed.
55. The same job, rank 0 killed (exit 113) at its 7th block read with a
    checkpoint every 2 global steps; rank 1 fails on the lost peer. Both
    resume from the checkpoint's per-rank cursors: K1 launches the blocks
    after each cursor, accumulators bitwise phase 6's.
56. Rank 1 delayed before every consensus round: coordinates bitwise
    phase 14's, the wait shows on rank 0. Then a broken length claim on
    rank 1 (``contract_rank``, a window claiming one block more than it
    has): both ranks raise the contract error in the terminal agreement
    round; a rank past ``MULTIHOST_TIMEOUT_S`` fails the phase.
57. ``--source plink --references`` with ``--splits-per-contig 4`` (four
    concurrent range readers, ``PartitionedSource``): accumulators
    bitwise the one-split run.
58. tile2d across two ranks on the pinned card (gloo with host staging),
    each rank with two virtual slots of a 2x2 mesh spanning both (rank 0
    holds tiles (0, 0) and (0, 1), rank 1 (1, 0) and (1, 1)), over phase
    14's packed store. One rank pair (``tile2d_rank``) runs phases 58-60
    through the CLI's ``main``: ``pcoa --gram-mode tile2d
    --tile2d-transport gather``: each global step's block is both ranks'
    slabs side by side (all-gathered), every rank launching K1 on its 2
    tiles: 2 x 7 steps = 14 launches a rank (rank 1's drained partition
    feeds an all-MISSING slab in step 7, contracted too),
    ``gram.fused_blocks`` 7 on both; the tiles the ranks hold, assembled
    here, bitwise phase 6's; rank 0's coordinates bitwise phase 48's
    (the one-process 2x2 gather run) and the structure PCs within 1e-3
    of phase 14's dense solve. The gram, finalize and eigh phases of
    each rank are printed.
59. The same under ``--tile2d-transport ring``: each rank's slab split
    over its 2 slots, the 4 global shards hopping 3 times around the
    ring (device copies within a rank, point to point between them): K1
    2 x 4 x 7 = 56 launches a rank on 1024-byte shards,
    ``gram.ring_steps`` 28; tiles bitwise phase 6's, coordinates bitwise
    phase 58's.
60. ``pca --gram-mode tile2d`` across the ranks: 14 K1 launches a rank,
    ``t1t1`` bitwise phase 6's, structure PCs within 1e-3 of phase 11's.
61. A tiled checkpoint across the ranks through the CLI: rank 0 killed
    at its 7th block read with a checkpoint every 2 global steps; each
    rank wrote its own tile files (``checkpoint.bytes_written`` on both),
    no checksum sidecar is left, the manifest holds ``process_count`` 2,
    ``mesh_shape`` [2, 2], mode tile2d and per-rank cursors. The resumed
    ranks launch K1 on their 2 tiles for each global step after the
    cursors, and the tiles of the final checkpoint are bitwise phase
    6's.
62. K1 timed at the launch shapes of phases 58-61 (the 1252 x 1252 x
    4096-byte rectangular tile of a gathered global block, its 1252-row
    diagonal tile, the 1252 x 1252 x 1024-byte cross-rank ring shard),
    bitwise against its plain version and ``torch._int_mm`` x4, beside
    their bounds.
63. ``python -m spark_examples_tpu_torch lint`` and ``lint --list-rules``
    as subprocesses on the card's host, which has no jax: the port's
    graftlint suite over the package and this script must exit 0 with
    ``graftlint: clean``, and list its eight rules; the rule count and
    each run's seconds are printed.
64. ``bench_torch.py``'s configs in-process at full width and reduced
    depth (``bench_phase``): 2504 samples over 131,072 variants for the
    streamed (8 K1 launches at 4,096 bytes + 2 warm) and staged (1 + 1
    warm at 32,768 bytes) config 1, config 2 (3 passes: 3 + 1 warm) and
    config 5 (8 + 8, 4 + 4 warm); config 3 at its 10,000 x 4,096 (K2 1 +
    1 warm); config 4's tile rate and solve at N_eq 8,192 and the sketch
    at 2,500 (no K1). Each config's K1 count is read through
    ``kernel.packed_gram.launches`` (the streamed run resets the registry
    after its warm run: its timed launches) and the wrappers' own counts,
    and must equal the worked-out value; every structure check must
    exceed 3, the headline's keys must be the JAX bench's and
    ``sketch_ok`` and ``lint_ok`` hold. K1 is timed at the two new launch
    shapes beside their bounds.
65. ``bench_torch.py``'s subsystem rows in-process at reduced depth
    (``bench_rows_phase``): ``--kernels`` over 4 blocks of the cohort
    (K1 6 x (1 warm + 4)), ``--store`` at 2504 x 4,096 (K1 3: the direct
    VCF job, the via-store job, the model fit), ``--serve`` on a
    16,384-variant panel (K1 1: the fit), ``--fleet`` and
    ``--controller`` on the JAX bench's own panels (K1 3 and 2: the
    route fits on ``ArraySource`` panels stream packed; the controller
    under a burst of 1,000 QPS over 2 s, which one replica cannot
    absorb), the neighbors row at 256 samples (K1 8: the dense route's
    4 blocks and the panel fit's 4), ``--sketch-serve`` at 2,000 x
    16,384 in blocks of 4,096 (no K1: the corrected sketch and the
    projections; at least 2 shards a request). Every identity gate must
    hold (``fused_match`` for all six fused kernels, the store's PCoA
    and compaction, the served rows of serve, fleet and neighbors
    against the offline engine, clean drains, the sketch-serve rig never
    tripped, the controller's threads joined), K1's count by row must
    equal the worked-out value and K2's be 0; the speed gates
    (``kernel_fused_ok``, the hedge, ``store_ok``, ``controller_ok``)
    are printed beside the card line, not enforced.
66. Print the script's time, the ``kernels`` JSON line (K1 and K2), the
    card line, and as the last line ``{"ok": true, "device": {...}}``.

Each CLI run sets every kernel's launch count to 0 just before and reads
them just after. A ptxas report with spills fails phase 2.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_SAMPLES = 2504
N_VARIANTS = 100_000
BLOCK_VARIANTS = 8192
NUM_PC = 10
DEVICE = "cuda"
SEPARATION_MIN = 10.0
# The Bray-Curtis job (BASELINE config 3's shape: a 10k-sample table of
# 4,096 features).
BC_SAMPLES = 10_000
BC_FEATURES = 4096
BC_LEVELS = 256
BC_RAGGED = ((1, 1), (37, 301), (65, 130), (300, 1025), (257, 4097),
             (127, 128), (128, 129), (129, 131), (257, 128))
# FP32 lanes per SM (Hopper): the CUDA-core instruction rate is
# SMs x 128 x the SM clock.
FP32_LANES_PER_SM = 128
# H100 SXM published peaks (NVIDIA data sheet, dense): int8 tensor-core
# rate and HBM3 bandwidth, at the full 700 W power limit.
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES_S = 3.35e12
RAGGED_SHAPES = ((37, 21, 301), (1, 1, 1), (65, 130, 17), (64, 64, 16),
                 (200, 129, 33),
                 # K1's 64-sample tile and 64-byte chunk, each -1, 0, +1,
                 # and two tiles + 1.
                 (63, 63, 63), (64, 64, 64), (65, 65, 65), (129, 129, 63),
                 (129, 65, 65))
# The largest N on the dense route (pipelines/jobs.py): K1 is timed there.
LARGE_SAMPLES = 16_384
# Phase 12's raw-value table and phase 16's VCF width.
DENSE_VARIANTS = 16_384
VCF_VARIANTS = 4096
# The dataset store's chunk width (the JAX CLI's default) and phase 21's
# position range on the PLINK fileset's contig 1 (positions 1..V).
CHUNK_VARIANTS = 16_384
REFERENCE_RANGE = (30_001, 70_001)
# Phase 23: a checkpoint every 4 blocks; the source dies when asked for
# block 11, so generations stand at variants 32,768 and 65,536.
CKPT_EVERY_BLOCKS = 4
KILL_AT_BLOCK = 10
# The planted structure's principal coordinates (5 populations).
NUM_POP_PCS = 4
# Phase 26: the corrected run dies 6 blocks into its second pass.
SKETCH_KILL_IN_PASS1 = 6
# Phase 27: the width the exact route cannot hold on one card (its four
# int32 ibs leaves would take 160 GB), at a depth of two blocks in one
# chunk of the store (a block across two chunks would be decoded and
# re-packed on the host).
BIG_SAMPLES = 100_000
BIG_VARIANTS = 16_384
# Phases 29-30: the Quickstart cohort split into a 2,004-sample panel and
# 500 new samples; 10 panel samples planted among the new ones for
# cross-kinship (a duplicate's phi is 0.5; unrelated samples sit near 0).
PANEL_SAMPLES = 2004
PLANTED_COPIES = 10
PLANTED_MIN_PHI = 0.45
# Panel samples projected through an exact model land on their fitted
# coordinates: the top NUM_POP_PCS components within this fraction of
# max|coords| (f32 centering in another order than the fit's).
SELF_PROJECTION_RTOL = 1e-3


def k1_bounds(n: int, w: int, products) -> dict:
    """K1's least time for a symmetric launch over (n, w) packed bytes:
    each (L, L) product needs the n(n+1)/2 pairs i <= j, each other
    product all n^2, at 2 int8 operations per pair and variant; the bytes
    are the block read once and every output written once. The
    full-square bound counts n^2 pairs for every product (the work of
    a kernel that computes the whole square, and of the library
    yardstick)."""
    from spark_examples_tpu_torch.ops.genotype import PRODUCT_OPERANDS

    variants = 4 * w
    pairs = sum(n * (n + 1) / 2 if PRODUCT_OPERANDS[p][0] ==
                PRODUCT_OPERANDS[p][1] else n * n for p in products)
    ops = 2.0 * variants * pairs
    full_ops = 2.0 * variants * n * n * len(products)
    byte_count = 1.0 * n * w + 4.0 * n * n * len(products)
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    bytes_ms = byte_count / PEAK_BYTES_S * 1e3
    return {
        "ops": ops, "bytes": byte_count,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_full_ms": max(full_ops / PEAK_INT8_OPS * 1e3, bytes_ms),
    }


def kernel_identifiers(sass: str) -> list[str]:
    """The kernels' source names in a ``cuobjdump -sass`` listing: the
    innermost name of each (mangled) ``Function :`` symbol, which the
    profiler's demangled kernel names contain."""
    names = set()
    for sym in re.findall(r"Function : (\S+)", sass):
        if not sym.startswith("_Z"):
            names.add(sym)  # an extern "C" kernel
            continue
        nested = sym.startswith("_ZN")
        i = 3 if nested else 2
        if sym[i:i + 1] == "L":  # internal linkage
            i += 1
        parts = []
        while i < len(sym) and sym[i].isdigit():
            j = i
            while sym[j].isdigit():
                j += 1
            n = int(sym[i:j])
            parts.append(sym[j:j + n])
            i = j + n
            if not nested:
                break
        if parts:
            names.add(parts[-1])
    return sorted(names)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    mhz = float(out.stdout.strip().splitlines()[0].split()[0])
    return mhz * 1e6


def separation(coords: np.ndarray, pops: np.ndarray) -> float:
    """Mean between-centroid over mean within-population distance in
    PC1-2."""
    c2 = coords[:, :2]
    labels_u = np.unique(pops)
    cents = np.stack([c2[pops == k].mean(0) for k in labels_u])
    labels = np.searchsorted(labels_u, pops)
    within = float(np.mean(np.linalg.norm(c2 - cents[labels], axis=1)))
    between = float(np.mean([
        np.linalg.norm(cents[a] - cents[b])
        for a in range(len(cents)) for b in range(a + 1, len(cents))]))
    return between / within


def otu_table(rng, n: int, f: int) -> np.ndarray:
    """Integer OTU-like counts: floor(gamma(0.5, 40)), 60 % zeros."""
    x = rng.gamma(0.5, 40.0, size=(n, f)) * (rng.random((n, f)) > 0.6)
    return x.astype(np.int32).astype(np.float32)


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, timed
    with CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_job(cli_main, argv: list[str], counters: dict, output: str):
    """One job through the CLI's ``main`` with ``--timings`` and
    ``--output-path output``: every kernel's launch count set to 0 just
    before, read just after. Returns (launches by kernel, phase timings,
    the job's stdout, wall s)."""
    err, out = io.StringIO(), io.StringIO()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli_main(argv + ["--output-path", output, "--timings"])
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    if rc != 0:
        fail(f"{' '.join(argv)}: CLI returned {rc}")
    # The last JSON line: --telemetry-dir prints its export line after it.
    timings = json.loads(next(line for line in reversed(
        err.getvalue().strip().splitlines()) if line.startswith("{")))
    return launches, timings, out.getvalue(), wall


def run_cli(cli_main, argv: list[str], counters: dict, n_pc: int):
    """A coordinates job (pcoa, pca) through :func:`run_job`. Returns
    (launches by kernel, phase timings, coords from the TSV, wall s)."""
    with tempfile.TemporaryDirectory() as tmp:
        tsv = os.path.join(tmp, "coords.tsv")
        launches, timings, _, wall = run_job(cli_main, argv, counters, tsv)
        with open(tsv) as f:
            header = f.readline().rstrip("\n").split("\t")
            rows_ = [line.rstrip("\n").split("\t") for line in f]
    coords = np.asarray([r[1:] for r in rows_], dtype=np.float64)
    if len(header) != n_pc + 1:
        fail(f"{argv[0]}: TSV header {header}")
    if not np.isfinite(coords).all():
        fail(f"{' '.join(argv)}: non-finite coordinates")
    return launches, timings, coords, wall


def run_similarity_cli(cli_main, argv: list[str], counters: dict, n: int):
    """A similarity job through :func:`run_job`, its matrix saved as
    ``.npy``: (launches by kernel, phase timings, wall s). The matrix
    must be finite, (n, n) and symmetric."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "similarity.npy")
        launches, timings, _, wall = run_job(cli_main, argv, counters, path)
        sim = np.load(path)
    if sim.shape != (n, n) or not np.isfinite(sim).all():
        fail(f"{' '.join(argv)}: similarity {sim.shape}, finite "
             f"{bool(np.isfinite(sim).all())}")
    if not np.array_equal(sim, sim.T):
        fail(f"{' '.join(argv)}: similarity not symmetric")
    return launches, timings, wall


def phases_line(timings: dict, names) -> str:
    return ", ".join(f"{k} {timings[k]:.4f} s" for k in names if k in timings)


def quickstart_args(metric: str | None = None) -> list[str]:
    """The Quickstart cohort's flags (synthetic, 2504 x 100,000)."""
    argv = ["--n-samples", str(N_SAMPLES), "--n-variants", str(N_VARIANTS),
            "--block-variants", str(BLOCK_VARIANTS), "--device", DEVICE]
    return argv + (["--metric", metric] if metric else [])


def equal_accumulators(got: dict, want: dict) -> bool:
    """Same leaves, bitwise; ``want`` lies on the CPU."""
    import torch

    return got.keys() == want.keys() and all(
        torch.equal(got[k].cpu(), want[k]) for k in want)


def dense_and_file_phases(cli_main, launch_counters: dict, card: str, dev,
                          source, expected: int, quickstart_gram_s: float,
                          synthetic_acc: dict, tmp: str):
    """Phases 12-17: the dense transport, grm and the file sources
    (packed store, PLINK, VCF, QC + LD), each CLI job counted; the files
    go to ``tmp``. Returns the launches by kernel of each job, by path
    name, and what the dataset-store phases reuse (the packed store's
    gram phase, the PLINK fileset, phase 12's euclidean
    accumulators)."""
    import torch

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
    )
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.ingest.plink import PlinkSource, write_plink
    from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
    from spark_examples_tpu_torch.ingest.vcf import VcfSource, write_vcf
    from spark_examples_tpu_torch.ops import genotype
    from spark_examples_tpu_torch.pipelines import runner

    # -- 12. dense transport: the int8 library product, then the jobs ------
    # The dense-transport kernels: euclidean and dot.
    dense_metrics = tuple(m for m in kernels.gram_names()
                          if not kernels.get(m).pack_auto)
    rng = np.random.default_rng(3)
    table = rng.integers(0, 128, (N_SAMPLES, DENSE_VARIANTS)).astype(np.int8)
    table[rng.random(table.shape) < 0.1] = -1
    x = torch.from_numpy(table).to(dev)
    dense_ms = {}
    for metric in dense_metrics:
        pieces = kernels.get(metric).pieces
        lib = genotype.gram_products(x, pieces, dot=genotype.int_mm)
        plain = genotype.gram_products(x, pieces, dot=genotype.int_dot)
        for p in pieces:
            if not torch.equal(lib[p], plain[p]):
                fail(f"torch._int_mm lowering != int_dot for {metric}/{p} "
                     f"at {tuple(x.shape)}")
        dense_ms[metric] = (
            cuda_ms(lambda: genotype.gram_products(
                x, pieces, dot=genotype.int_mm), reps=10, warmup=2),
            cuda_ms(lambda: genotype.gram_products(
                x, pieces, dot=genotype.int_dot), reps=3, warmup=1))
    del x, lib, plain
    # Phase 12's euclidean accumulators, which phase 20 holds the dense
    # store route against.
    job = JobConfig(
        ingest=IngestConfig(n_samples=N_SAMPLES, n_variants=N_VARIANTS,
                            block_variants=BLOCK_VARIANTS),
        compute=ComputeConfig(metric="euclidean", device=DEVICE))
    euclidean_acc = {k: v.cpu() for k, v in runner.run_gram(
        job, SyntheticSource(n_samples=N_SAMPLES, n_variants=N_VARIANTS),
        PhaseTimer()).acc.items()}
    print(f"dense products at {table.shape} int8, values 0..127 [{card}]: "
          "torch._int_mm lowering bitwise equal to int_dot for "
          + "; ".join(f"{m} ({', '.join(kernels.get(m).pieces)}) "
                      f"{lib_ms:.4f} ms vs int_dot {plain_ms:.4f} ms"
                      for m, (lib_ms, plain_ms) in dense_ms.items()))
    dense_counts = {}
    for metric in dense_metrics:
        argv = ["similarity"] + quickstart_args(metric)
        counts_m, timings, wall = run_similarity_cli(
            cli_main, argv, launch_counters, N_SAMPLES)
        if counts_m["packed_gram"] != 0:
            fail(f"K1 launched {counts_m['packed_gram']} times on the dense "
                 f"{metric} job, expected 0")
        if timings["ingest_bytes"] != expected * N_SAMPLES * BLOCK_VARIANTS:
            fail(f"{metric}: {timings['ingest_bytes']} bytes shipped, not "
                 "the dense transport's")
        dense_counts[metric] = counts_m
        print(f"similarity {N_SAMPLES} x {N_VARIANTS} {metric}, dense "
              f"transport [{card}]: wall {wall:.3f} s; phases: "
              + phases_line(timings, ("ingest_setup", "gram", "finalize"))
              + f"; launches {counts_m}")

    # -- 13. grm -----------------------------------------------------------
    argv = ["pcoa"] + quickstart_args("grm") + ["--num-pc", str(NUM_PC)]
    grm_counts, timings, coords, wall = run_cli(cli_main, argv,
                                                launch_counters, NUM_PC)
    if grm_counts["packed_gram"] != 0:
        fail(f"K1 launched {grm_counts['packed_gram']} times on the grm "
             "job, expected 0")
    sep = separation(coords, source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"grm PC1-2 population separation {sep:.3f} < "
             f"{SEPARATION_MIN}")
    print(f"pcoa {N_SAMPLES} x {N_VARIANTS} grm (bf16), {NUM_PC} PCs "
          f"[{card}]: wall {wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "finalize", "eigh"))
          + f"; launches {grm_counts}; coords finite; PC1-2 separation "
          f"{sep:.2f} (min {SEPARATION_MIN})")
    grm = {}
    for precise in (False, True):
        job = JobConfig(
            ingest=IngestConfig(n_samples=N_SAMPLES, n_variants=N_VARIANTS,
                                block_variants=BLOCK_VARIANTS),
            compute=ComputeConfig(metric="grm", grm_precise=precise,
                                  device=DEVICE))
        t = PhaseTimer()
        g = runner.run_gram(job, SyntheticSource(n_samples=N_SAMPLES,
                                                 n_variants=N_VARIANTS), t)
        grm[precise] = (g.acc, t.phases["gram"])
    (bf, bf_s), (f32, f32_s) = grm[False], grm[True]
    if not torch.equal(bf["nvar"], f32["nvar"]):
        fail(f"grm nvar differs: bf16 {bf['nvar']} vs f32 {f32['nvar']}")
    if not all(bool(torch.isfinite(a["zz"]).all()) for a in (bf, f32)):
        fail("grm zz is not finite")
    grm_rel = float((bf["zz"] - f32["zz"]).abs().max()
                    / f32["zz"].abs().max())
    print(f"grm gram stage [{card}]: bf16 {bf_s:.4f} s, --grm-precise "
          f"{f32_s:.4f} s; nvar {float(f32['nvar']):.0f} equal; max |zz "
          f"bf16 - f32| / max |zz f32| = {grm_rel:.3g}")
    del grm, bf, f32, g

    # -- 14. packed store ----------------------------------------------
    store = os.path.join(tmp, "store")
    _, timings, out, pack_wall = run_job(
        cli_main, ["pack"] + quickstart_args(), launch_counters, store)
    print(f"pack [{card}]: {out.strip()}; wall {pack_wall:.3f} s")
    argv = ["pcoa", "--source", "packed", "--path", store,
            "--num-pc", str(NUM_PC), "--block-variants",
            str(BLOCK_VARIANTS), "--device", DEVICE]
    store_counts, timings, coords, wall = run_cli(
        cli_main, argv, launch_counters, NUM_PC)
    if store_counts["packed_gram"] != expected:
        fail(f"K1 launched {store_counts['packed_gram']} times on the "
             f"packed-store job, expected {expected}")
    sep = separation(coords, source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"packed-store PC1-2 separation {sep:.3f}")
    store_gram_s = timings["gram"]
    store_coords = coords
    job = JobConfig(
        ingest=IngestConfig(source="packed", path=store,
                            block_variants=BLOCK_VARIANTS),
        compute=ComputeConfig(metric="ibs", device=DEVICE))
    g = runner.run_gram(job, load_packed(store), PhaseTimer())
    if not equal_accumulators(g.acc, synthetic_acc):
        fail("packed-store accumulators differ from the synthetic "
             "run's")
    print(f"pcoa --source packed {N_SAMPLES} x {N_VARIANTS} ibs "
          f"[{card}]: wall {wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "finalize",
                                  "eigh"))
          + f"; gram {store_gram_s:.4f} s from the store vs "
          f"{quickstart_gram_s:.4f} s synthetic (phase 5); launches "
          f"{store_counts}; accumulators bitwise equal to phase 6's; "
          f"PC1-2 separation {sep:.2f}")

    # -- 15. PLINK ----------------------------------------------------
    cohort = np.concatenate(
        [b for b, _ in load_packed(store).blocks(16384)], axis=1)
    prefix = os.path.join(tmp, "cohort")
    t0 = time.perf_counter()
    write_plink(prefix, cohort, sample_ids=source.sample_ids)
    write_s = time.perf_counter() - t0
    bed_mb = os.path.getsize(prefix + ".bed") / 1e6
    argv = ["pcoa", "--source", "plink", "--path", prefix,
            "--num-pc", str(NUM_PC), "--block-variants",
            str(BLOCK_VARIANTS), "--device", DEVICE]
    plink_counts, timings, coords, wall = run_cli(
        cli_main, argv, launch_counters, NUM_PC)
    if plink_counts["packed_gram"] != expected:
        fail(f"K1 launched {plink_counts['packed_gram']} times on the "
             f"PLINK job, expected {expected}")
    sep = separation(coords, source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"PLINK PC1-2 separation {sep:.3f}")
    plink_gram_s = timings["gram"]
    job = JobConfig(
        ingest=IngestConfig(source="plink", path=prefix,
                            block_variants=BLOCK_VARIANTS),
        compute=ComputeConfig(metric="ibs", device=DEVICE))
    g = runner.run_gram(job, PlinkSource(prefix), PhaseTimer())
    if not equal_accumulators(g.acc, synthetic_acc):
        fail("PLINK accumulators differ from the synthetic run's")
    del g
    print(f"pcoa --source plink {N_SAMPLES} x {N_VARIANTS} ibs "
          f"[{card}]: .bed {bed_mb:.1f} MB written in {write_s:.3f} s; "
          f"wall {wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "finalize",
                                  "eigh"))
          + f"; launches {plink_counts}; accumulators bitwise equal to "
          f"phase 6's; PC1-2 separation {sep:.2f}")

    # -- 16. VCF -------------------------------------------------------
    vcf = os.path.join(tmp, "cohort.vcf")
    t0 = time.perf_counter()
    write_vcf(vcf, cohort[:, :VCF_VARIANTS], sample_ids=source.sample_ids)
    vcf_write_s = time.perf_counter() - t0
    want, _ = next(SyntheticSource(n_samples=N_SAMPLES,
                                   n_variants=N_VARIANTS).blocks(
                                       VCF_VARIANTS))
    t0 = time.perf_counter()
    parsed = list(VcfSource(vcf).blocks(BLOCK_VARIANTS))
    parse_s = time.perf_counter() - t0
    if len(parsed) != 1 or not np.array_equal(parsed[0][0], want):
        fail("VCF blocks differ from the synthetic source's")
    rate = N_SAMPLES * VCF_VARIANTS / parse_s
    argv = ["similarity", "--source", "vcf", "--path", vcf,
            "--block-variants", str(BLOCK_VARIANTS), "--device", DEVICE]
    vcf_counts, timings, wall = run_similarity_cli(
        cli_main, argv, launch_counters, N_SAMPLES)
    if vcf_counts["packed_gram"] != 1:
        fail(f"K1 launched {vcf_counts['packed_gram']} times on the VCF "
             "job, expected 1")
    print(f"VCF {N_SAMPLES} x {VCF_VARIANTS} [{card}]: "
          f"{os.path.getsize(vcf) / 1e6:.1f} MB written in "
          f"{vcf_write_s:.3f} s; parse {parse_s:.3f} s "
          f"({rate / 1e6:.3f} M genotypes/s), blocks bitwise equal to "
          f"the synthetic source's; similarity --source vcf wall "
          f"{wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "finalize"))
          + f"; launches {vcf_counts}")
    del cohort, parsed

    # -- 17. QC + LD pruning -------------------------------------------
    argv = ["pcoa", "--source", "plink", "--path", prefix, "--maf",
            "0.01", "--max-missing", "0.1", "--ld-prune-r2", "0.2",
            "--num-pc", str(NUM_PC), "--block-variants",
            str(BLOCK_VARIANTS), "--device", DEVICE]
    with tempfile.TemporaryDirectory() as tsv_dir:
        qc_counts, timings, out, wall = run_job(
            cli_main, argv, launch_counters,
            os.path.join(tsv_dir, "coords.tsv"))
        coords = np.loadtxt(os.path.join(tsv_dir, "coords.tsv"),
                            skiprows=1, usecols=range(1, NUM_PC + 1))
    kept = int(re.search(r"over (\d+) variants", out).group(1))
    if not 0 < kept <= N_VARIANTS or not np.isfinite(coords).all():
        fail(f"QC + LD job: kept {kept}, coords finite "
             f"{bool(np.isfinite(coords).all())}")
    if qc_counts["packed_gram"] != math.ceil(kept / BLOCK_VARIANTS):
        fail(f"K1 launched {qc_counts['packed_gram']} times on the QC + "
             f"LD job of {kept} variants")
    sep = separation(coords, source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"QC + LD PC1-2 separation {sep:.3f}")
    print(f"pcoa --source plink --maf 0.01 --max-missing 0.1 "
          f"--ld-prune-r2 0.2 [{card}]: kept {kept} of {N_VARIANTS} "
          f"variants; wall {wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "finalize",
                                  "eigh"))
          + f"; launches {qc_counts}; PC1-2 separation {sep:.2f}")

    paths = {f"similarity {m}": c for m, c in dense_counts.items()}
    paths.update({"pcoa grm": grm_counts,
                  "pcoa packed store": store_counts,
                  "pcoa plink": plink_counts,
                  "similarity vcf": vcf_counts,
                  "pcoa plink qc+ld": qc_counts})
    return paths, {"packed_store_gram_s": store_gram_s, "plink": prefix,
                   "euclidean_acc": euclidean_acc, "packed_store": store,
                   "vcf": vcf, "packed_store_coords": store_coords}


def tree_bytes(root: str) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def flip_byte(store: str, chunk: int) -> str:
    """Flip one bit of one byte in the middle of chunk ``chunk``'s file
    (same size, different content); returns the file's path."""
    with open(os.path.join(store, "manifest.json")) as f:
        digest = json.load(f)["chunks"][chunk][3]
    path = os.path.join(store, "chunks", f"{digest}.bin")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x10]))
    return path


def dataset_store_phases(cli_main, launch_counters: dict, card: str, source,
                         expected: int, synthetic_acc: dict, files: dict,
                         tmp: str) -> dict:
    """Phases 18-22: the content-addressed dataset store. Returns the
    launches by kernel of each CLI job, by path name."""
    import torch

    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
        ReferenceRange,
    )
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest.plink import PlinkSource
    from spark_examples_tpu_torch.pipelines import runner
    from spark_examples_tpu_torch.store import StoreCorruptError, StoreManifest

    def store_gram(path: str, metric: str = "ibs", auto_heal: bool = True,
                   **ingest) -> dict:
        """The gram stage of a job reading the store at ``path`` (the
        library route the CLI runs), accumulators on the CPU."""
        job = JobConfig(
            ingest=IngestConfig(source=f"store:{path}",
                                block_variants=BLOCK_VARIANTS, **ingest),
            compute=ComputeConfig(metric=metric, device=DEVICE))
        src = runner.build_source(job.ingest, DEVICE)
        src.inner.auto_heal = auto_heal
        try:
            g = runner.run_gram(job, src, PhaseTimer())
        finally:
            src.close()
        return {k: v.cpu() for k, v in g.acc.items()}

    paths = {}
    # -- 18. ingest the Quickstart cohort with each codec -----------------
    stores = {}
    ingest_lines = []
    for codec, workers in (("zlib", 4), ("raw", 4), ("zlib-dict", 4),
                           ("zlib", 1)):
        d = os.path.join(tmp, f"ds_{codec}_w{workers}")
        argv = (["ingest"] + quickstart_args() + [
            "--chunk-variants", str(CHUNK_VARIANTS), "--store-codec", codec,
            "--ingest-workers", str(workers)])
        counts, timings, out, wall = run_job(cli_main, argv, launch_counters,
                                             d)
        if any(counts.values()):
            fail(f"ingest launched kernels: {counts}")
        m = StoreManifest.load(d)
        n = m.n_samples
        raw_b = sum(c.payload_size(n) for c in m.chunks)
        stored_b = sum(c.disk_size(n) for c in m.chunks)
        if len(m.chunks) != math.ceil(N_VARIANTS / CHUNK_VARIANTS) or \
                m.n_variants != N_VARIANTS:
            fail(f"ingest {codec}: {len(m.chunks)} chunks, "
                 f"{m.n_variants} variants")
        stores[(codec, workers)] = d
        ingest_lines.append(
            f"{codec} ({workers} workers): compact {timings['compact']:.4f} "
            f"s, ingest_setup {timings['ingest_setup']:.4f} s, wall "
            f"{wall:.3f} s; {raw_b / 1e6:.1f} MB 2-bit -> "
            f"{stored_b / 1e6:.2f} MB stored, ratio {raw_b / stored_b:.4f}; "
            f"{len(m.chunks)} chunks")
    one, four = tree_bytes(stores[("zlib", 1)]), tree_bytes(
        stores[("zlib", 4)])
    if one != four:
        fail("the 1-worker and 4-worker zlib stores differ: "
             + ", ".join(sorted(k for k in set(one) | set(four)
                                if one.get(k) != four.get(k))[:5]))
    print(f"ingest {N_SAMPLES} x {N_VARIANTS}, chunks of {CHUNK_VARIANTS} "
          f"[{card}]: " + "; ".join(ingest_lines) + f"; the zlib stores of 1 "
          f"and 4 workers are identical file for file ({len(one)} files)")
    del one, four

    # -- 19. pcoa --source store:<dir> per codec ---------------------------
    # Each store phase 18 compacted with 4 workers, in its order.
    for codec in [c for c, workers in stores if workers == 4]:
        d = stores[(codec, 4)]
        argv = ["pcoa", "--source", f"store:{d}", "--num-pc", str(NUM_PC),
                "--block-variants", str(BLOCK_VARIANTS), "--device", DEVICE]
        counts, timings, coords, wall = run_cli(cli_main, argv,
                                                launch_counters, NUM_PC)
        if counts["packed_gram"] != expected:
            fail(f"K1 launched {counts['packed_gram']} times on pcoa "
                 f"--source store ({codec}), expected {expected}")
        sep = separation(coords, source.populations)
        if not sep >= SEPARATION_MIN:
            fail(f"store ({codec}) PC1-2 separation {sep:.3f}")
        if not equal_accumulators(store_gram(d), synthetic_acc):
            fail(f"store ({codec}) accumulators differ from phase 6's")
        paths[f"pcoa store {codec}"] = counts
        print(f"pcoa --source store ({codec}) {N_SAMPLES} x {N_VARIANTS} "
              f"ibs [{card}]: wall {wall:.3f} s; phases: "
              + phases_line(timings, ("ingest_setup", "gram", "finalize",
                                      "eigh"))
              + f"; gram {timings['gram']:.4f} s vs the packed store's "
              f"{files['packed_store_gram_s']:.4f} s (phase 14); launches "
              f"{counts}; accumulators bitwise equal to phase 6's; PC1-2 "
              f"separation {sep:.2f}")

    # -- 20. the dense route: euclidean from the store -----------------------
    d = stores[("zlib", 4)]
    argv = ["similarity", "--metric", "euclidean", "--source", f"store:{d}",
            "--block-variants", str(BLOCK_VARIANTS), "--device", DEVICE]
    counts, timings, wall = run_similarity_cli(cli_main, argv,
                                               launch_counters, N_SAMPLES)
    if counts["packed_gram"] != 0:
        fail(f"K1 launched {counts['packed_gram']} times on the dense "
             "store job, expected 0")
    if timings["ingest_bytes"] != expected * N_SAMPLES * BLOCK_VARIANTS:
        fail(f"dense store job shipped {timings['ingest_bytes']} bytes")
    if not equal_accumulators(store_gram(d, "euclidean"),
                              files["euclidean_acc"]):
        fail("euclidean accumulators from the store differ from phase 12's")
    paths["similarity euclidean store"] = counts
    print(f"similarity --metric euclidean --source store (zlib) [{card}]: "
          f"wall {wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "finalize"))
          + f"; launches {counts}; blocks decoded into the pinned slabs "
          "(decode_range_into); accumulators bitwise equal to phase 12's")

    # -- 21. a --references range job from the store's position index -------
    plink_ds = os.path.join(tmp, "ds_plink")
    _, timings, out, wall = run_job(
        cli_main, ["ingest", "--source", "plink", "--path", files["plink"],
                   "--chunk-variants", str(CHUNK_VARIANTS), "--device",
                   DEVICE], launch_counters, plink_ds)
    lo, hi = REFERENCE_RANGE
    ref = f"1:{lo}:{hi}"
    want_v = hi - lo  # PLINK positions are 1..V
    argv = ["pcoa", "--source", f"store:{plink_ds}", "--references", ref,
            "--num-pc", str(NUM_PC), "--block-variants", str(BLOCK_VARIANTS),
            "--device", DEVICE]
    with tempfile.TemporaryDirectory() as tsv_dir:
        counts, rtimings, rout, rwall = run_job(
            cli_main, argv, launch_counters,
            os.path.join(tsv_dir, "coords.tsv"))
    got_v = int(re.search(r"over (\d+) variants", rout).group(1))
    if got_v != want_v or counts["packed_gram"] != math.ceil(
            want_v / BLOCK_VARIANTS):
        fail(f"--references {ref}: {got_v} variants, launches {counts}")
    job = JobConfig(
        ingest=IngestConfig(source="plink", path=files["plink"],
                            block_variants=BLOCK_VARIANTS,
                            references=[ReferenceRange.parse(ref)]),
        compute=ComputeConfig(metric="ibs", device=DEVICE))
    want_acc = {k: v.cpu() for k, v in runner.run_gram(
        job, PlinkSource(files["plink"], references=(
            ReferenceRange.parse(ref),)), PhaseTimer()).acc.items()}
    if not equal_accumulators(
            store_gram(plink_ds, references=[ReferenceRange.parse(ref)]),
            want_acc):
        fail("the store's --references accumulators differ from PLINK's")
    paths["pcoa store references"] = counts
    print(f"ingest --source plink [{card}]: {out.strip()}; pcoa --source "
          f"store --references {ref} [{card}]: {got_v} variants from the "
          f"position index, wall {rwall:.3f} s; phases: "
          + phases_line(rtimings, ("ingest_setup", "gram", "finalize",
                                   "eigh"))
          + f"; launches {counts}; accumulators bitwise equal to "
          "--source plink --references")

    # -- 22. damage, then heal ---------------------------------------------
    zlib_d = stores[("zlib", 4)]
    flip_byte(zlib_d, 3)
    healed0 = telemetry.counter_value("store.healed")
    argv = ["pcoa", "--source", f"store:{zlib_d}", "--num-pc", str(NUM_PC),
            "--block-variants", str(BLOCK_VARIANTS), "--device", DEVICE]
    counts, timings, coords, wall = run_cli(cli_main, argv, launch_counters,
                                            NUM_PC)
    inline = telemetry.counter_value("store.healed") - healed0
    if inline != 1 or counts["packed_gram"] != expected or \
            os.path.exists(os.path.join(zlib_d, "quarantine.json")):
        fail(f"inline heal from origin: healed {inline}, launches {counts}")
    if not equal_accumulators(store_gram(zlib_d), synthetic_acc):
        fail("accumulators after the inline heal differ from phase 6's")
    paths["pcoa store healed inline"] = counts

    raw_d = stores[("raw", 4)]
    victim = os.path.join(tmp, "ds_raw_victim")
    shutil.copytree(raw_d, victim)
    flip_byte(victim, 2)
    try:
        store_gram(victim, auto_heal=False)
    except StoreCorruptError as e:
        cursor = e.cursor
    else:
        fail("a flipped byte read without auto-heal did not fail")
    if cursor != 2 * CHUNK_VARIANTS or not os.path.exists(
            os.path.join(victim, "quarantine.json")):
        fail(f"the failed read's cursor {cursor} / no quarantine ledger")
    reports = []
    for how, extra in (("replica", ["--replica", raw_d]), ("origin", [])):
        if how == "origin":
            flip_byte(victim, 4)
            extra = ["--verify-all"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["store", "heal", "--path", victim] + extra)
        report = json.loads(buf.getvalue().strip().splitlines()[0])
        hows = [h["how"].split(":")[0] for h in report["healed"]]
        if rc != 0 or report["failed"] or hows != [how]:
            fail(f"store heal ({how}): rc {rc}, report {report}")
        reports.append(f"{how}: {report['damaged']} damaged of "
                       f"{report['checked']} checked, healed {hows}")
    if tree_bytes(victim) != tree_bytes(raw_d):
        fail("the healed store's files differ from the raw store's")
    argv = ["pcoa", "--source", f"store:{victim}", "--num-pc", str(NUM_PC),
            "--block-variants", str(BLOCK_VARIANTS), "--device", DEVICE]
    hcounts, htimings, coords, hwall = run_cli(cli_main, argv,
                                               launch_counters, NUM_PC)
    if hcounts["packed_gram"] != expected or not equal_accumulators(
            store_gram(victim), synthetic_acc):
        fail(f"the healed store's job: launches {hcounts}, or accumulators "
             "differ from phase 6's")
    paths["pcoa store after heal"] = hcounts
    print(f"damage and heal [{card}]: a flipped byte in chunk 3 of the zlib "
          f"store healed inline from the origin during pcoa (wall "
          f"{wall:.3f} s, gram {timings['gram']:.4f} s, launches {counts}); "
          f"a flipped byte in a raw copy failed the read without auto-heal "
          f"(StoreCorruptError at cursor {cursor}, quarantined); store heal "
          + "; ".join(reports) + "; the healed store equals the raw store "
          f"file for file; its pcoa (wall {hwall:.3f} s, launches {hcounts}) "
          "bitwise equal to phase 6's accumulators")
    return paths


class DyingSource:
    """A source that raises once ``die_after`` blocks were yielded over
    all its passes: a preempted job, through the library. It streams
    its inner source's 2-bit bytes when that source has them."""

    def __init__(self, inner, die_after: int):
        self.inner, self.die_after, self.yielded = inner, die_after, 0
        if hasattr(inner, "packed_blocks"):
            self.packed_blocks = lambda bv, start_variant=0: self._guard(
                inner.packed_blocks(bv, start_variant))

    n_samples = property(lambda self: self.inner.n_samples)
    n_variants = property(lambda self: self.inner.n_variants)
    sample_ids = property(lambda self: self.inner.sample_ids)

    def _guard(self, items):
        for item in items:
            if self.yielded == self.die_after:
                raise RuntimeError("simulated preemption")
            self.yielded += 1
            yield item

    def blocks(self, block_variants: int, start_variant: int = 0):
        return self._guard(self.inner.blocks(block_variants, start_variant))


def manifest_cursor(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["next_variant"]


def same_columns(got: np.ndarray, want: np.ndarray, cols: int,
                 tol: float) -> float:
    """The largest per-column deviation, up to sign, over the first
    ``cols`` columns, relative to each column's largest entry; fails
    above ``tol``."""
    worst = 0.0
    for c in range(cols):
        w = want[:, c]
        s = 1.0 if float(got[:, c] @ w) >= 0 else -1.0
        worst = max(worst, float(np.abs(s * got[:, c] - w).max()
                                 / np.abs(w).max()))
    if not worst <= tol:
        fail(f"coordinates differ by {worst:.3g} of the column scale "
             f"(tolerance {tol})")
    return worst


def span_totals(names) -> dict:
    """{span: (count, seconds)} of the port's telemetry histograms."""
    from spark_examples_tpu_torch.core import telemetry

    hists = telemetry.metrics_snapshot()["histograms"]
    return {n: (hists.get(n, {}).get("count", 0),
                hists.get(n, {}).get("sum", 0.0)) for n in names}


def span_line(before: dict, after: dict) -> str:
    """The spans recorded between two :func:`span_totals`."""
    parts = []
    for n in after:
        c = after[n][0] - before[n][0]
        if c:
            parts.append(f"{n} {c} x, {after[n][1] - before[n][1]:.4f} s")
    return ", ".join(parts)


def relerr(got, want) -> np.ndarray:
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want) / np.maximum(
        np.abs(want), 1e-12)


def checkpoint_and_solver_phases(cli_main, launch_counters: dict, card: str,
                                 dev, source, expected: int,
                                 synthetic_acc: dict,
                                 quickstart_coords: np.ndarray, files: dict,
                                 tmp: str) -> dict:
    """Phases 23-27: checkpoint kill and resume, the matrix handoff, the
    sketch ladder and the 100,000-sample corrected run. Returns the
    launches by kernel of each run, by path name."""
    import gc

    import torch

    from spark_examples_tpu_torch.core.config import (
        SKETCH_RANK_DEFAULT,
        ComputeConfig,
        IngestConfig,
        JobConfig,
    )
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
    from spark_examples_tpu_torch.models.pcoa import fit_pcoa
    from spark_examples_tpu_torch.ops import distances
    from spark_examples_tpu_torch.pipelines import jobs, runner
    from spark_examples_tpu_torch.solvers import sketch

    paths = {}

    def counted(fn):
        """``fn()`` with every launch count set to 0 just before and
        read just after: (result, launches by kernel, wall s)."""
        for mod in launch_counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        return out, {k: m.launches for k, m in launch_counters.items()}, wall

    def quickstart_job(**compute) -> JobConfig:
        return JobConfig(
            ingest=IngestConfig(n_samples=N_SAMPLES, n_variants=N_VARIANTS,
                                block_variants=BLOCK_VARIANTS),
            compute=ComputeConfig(metric="ibs", device=DEVICE, **compute))

    # -- 23. checkpoint kill and resume -----------------------------------
    ck = os.path.join(tmp, "ck")
    killed = quickstart_job(checkpoint_dir=ck,
                            checkpoint_every_blocks=CKPT_EVERY_BLOCKS)
    ck_spans = ("checkpoint.save", "checkpoint.write", "checkpoint.rotate",
                "checkpoint.load", "checkpoint.verify")
    spans0 = span_totals(ck_spans)

    def kill():
        try:
            runner.run_gram(killed, DyingSource(SyntheticSource(
                n_samples=N_SAMPLES, n_variants=N_VARIANTS), KILL_AT_BLOCK),
                PhaseTimer())
        except RuntimeError as e:
            if "simulated preemption" not in str(e):
                raise
        else:
            fail("the dying source did not stop the gram stage")

    _, kill_counts, kill_wall = counted(kill)
    spans1 = span_totals(ck_spans)
    gens = (manifest_cursor(ck + ".old"), manifest_cursor(ck))
    want_gens = (CKPT_EVERY_BLOCKS * BLOCK_VARIANTS,
                 2 * CKPT_EVERY_BLOCKS * BLOCK_VARIANTS)
    if kill_counts["packed_gram"] != KILL_AT_BLOCK or gens != want_gens:
        fail(f"killed run: launches {kill_counts}, generations {gens}")
    lib_ck = os.path.join(tmp, "ck_lib")
    shutil.copytree(ck, lib_ck)
    shutil.copytree(ck + ".old", lib_ck + ".old")
    resume_job = quickstart_job(checkpoint_dir=lib_ck)
    resume_argv = (["pcoa"] + quickstart_args("ibs")
                   + ["--num-pc", str(NUM_PC), "--checkpoint-dir", ck])
    lines = []
    for label, want_launches in (("latest", 5), ("fallback", 9)):
        if label == "fallback":
            flip_file(os.path.join(ck, "yc.npy"))
            flip_file(os.path.join(lib_ck, "yc.npy"))
        counts, timings, coords, wall = run_cli(cli_main, resume_argv,
                                                launch_counters, NUM_PC)
        if counts["packed_gram"] != want_launches:
            fail(f"resume ({label}): K1 launched {counts['packed_gram']} "
                 f"times, expected {want_launches}")
        dev_cols = same_columns(coords, quickstart_coords, NUM_POP_PCS,
                                1e-4)
        g, lib_counts, lib_wall = counted(lambda: runner.run_gram(
            resume_job, SyntheticSource(n_samples=N_SAMPLES,
                                        n_variants=N_VARIANTS),
            PhaseTimer()))
        if lib_counts["packed_gram"] != want_launches or \
                not equal_accumulators(g.acc, synthetic_acc):
            fail(f"resume ({label}) through the library: launches "
                 f"{lib_counts}, or accumulators differ from phase 6's")
        del g
        paths[f"pcoa resumed ({label})"] = counts
        lines.append(
            f"{label}: wall {wall:.3f} s, "
            + phases_line(timings, ("gram", "finalize", "eigh"))
            + f", launches {counts}; coords within {dev_cols:.2g} of phase "
            f"5's (structure PCs); library resume {lib_wall:.3f} s, "
            f"{lib_counts['packed_gram']} launches, accumulators bitwise")
    if not os.path.isdir(ck + ".corrupt"):
        fail("the corrupt generation was not set aside")
    print(f"checkpoint kill and resume, ibs {N_SAMPLES} x {N_VARIANTS} "
          f"[{card}]: a wrapping source died when asked for block "
          f"{KILL_AT_BLOCK + 1} (library run_gram, every "
          f"{CKPT_EVERY_BLOCKS} blocks; {kill_counts['packed_gram']} "
          f"launches, wall {kill_wall:.3f} s; {span_line(spans0, spans1)}); "
          f"generations at variants {gens[0]} (.old) and {gens[1]}; "
          "reruns: " + "; ".join(lines) + "; the flipped generation set "
          f"aside as .corrupt; the four resumes' "
          f"{span_line(spans1, span_totals(ck_spans))}")

    # -- 24. similarity --output-path d.npy, then pcoa --matrix-path -------
    mat = os.path.join(tmp, "ibs_similarity.npy")
    s_counts, s_timings, _, s_wall = run_job(
        cli_main, ["similarity"] + quickstart_args("ibs"), launch_counters,
        mat)
    m_counts, m_timings, m_coords, m_wall = run_cli(
        cli_main, ["pcoa", "--matrix-path", mat, "--num-pc", str(NUM_PC),
                   "--device", DEVICE], launch_counters, NUM_PC)
    if s_counts["packed_gram"] != expected or m_counts["packed_gram"]:
        fail(f"similarity launches {s_counts}, pcoa --matrix-path "
             f"launches {m_counts}")
    # The handoff Gower-transforms the written similarity (JAX's rule):
    # for ibs that embeds sqrt(2 d), so the reference is the PCoA of
    # that distance from phase 6's accumulators, not phase 5's.
    acc = {k: v.to(dev) for k, v in synthetic_acc.items()}
    sim = distances.finalize(acc, "ibs")["similarity"]
    ref = fit_pcoa(distances.similarity_to_distance(sim), k=NUM_PC)
    ref_coords = ref.coords.cpu().numpy()
    del acc, sim, ref
    mat_err = same_columns(m_coords, ref_coords, NUM_POP_PCS, 1e-4)
    sep = separation(m_coords, source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"pcoa --matrix-path separation {sep:.3f}")
    paths["similarity ibs (to .npy)"] = s_counts
    paths["pcoa --matrix-path"] = m_counts
    print(f"similarity -> pcoa --matrix-path [{card}]: similarity wall "
          f"{s_wall:.3f} s ({phases_line(s_timings, ('gram', 'finalize'))}"
          f", launches {s_counts}); pcoa --matrix-path wall {m_wall:.3f} s "
          f"({phases_line(m_timings, ('eigh',))}, launches {m_counts}); "
          f"coords within {mat_err:.2g} of the PCoA of phase 6's Gower "
          f"distance (structure PCs); PC1-2 separation {sep:.2f}")

    # -- 25. the ladder: pcoa --metric grm at exact, sketch, corrected ----
    store = files["packed_store"]

    def ladder_job(solver: str, **compute) -> JobConfig:
        return JobConfig(
            ingest=IngestConfig(source="packed", path=store,
                                block_variants=BLOCK_VARIANTS),
            compute=ComputeConfig(metric="grm", num_pc=NUM_PC, solver=solver,
                                  device=DEVICE, **compute))

    # Each rung runs through the CLI; the job's full-precision output
    # (eigenvalues, proportions) is kept from the pcoa_job it calls.
    outputs = []
    cli_pcoa_job = jobs.pcoa_job

    def keeping_pcoa_job(*args, **kwargs):
        outputs.append(cli_pcoa_job(*args, **kwargs))
        return outputs[-1]

    ladder = {}
    ladder_lines = []
    jobs.pcoa_job = keeping_pcoa_job
    try:
        for name, solver, iters in (("exact", "exact", 0),
                                    ("sketch", "sketch", 0),
                                    ("corrected1", "corrected", 1),
                                    ("corrected3", "corrected", 3)):
            argv = ["pcoa", "--source", "packed", "--path", store,
                    "--metric", "grm", "--solver", solver, "--num-pc",
                    str(NUM_PC), "--block-variants", str(BLOCK_VARIANTS),
                    "--device", DEVICE]
            if iters:
                argv += ["--sketch-iters", str(iters)]
            counts, timings, _, wall = run_cli(cli_main, argv,
                                               launch_counters, NUM_PC)
            if solver != "exact" and counts["packed_gram"]:
                fail(f"the {name} rung launched K1: {counts}")
            ladder[name] = outputs.pop()
            paths[f"pcoa grm {name}"] = counts
            ladder_lines.append(
                f"{name}: wall {wall:.3f} s, "
                + phases_line(timings, ("gram", "finalize", "eigh"))
                + f", launches {counts}")
    finally:
        jobs.pcoa_job = cli_pcoa_job
    ev = ladder["exact"].eigenvalues
    rel = {k: relerr(ladder[k].eigenvalues, ev)
           for k in ("sketch", "corrected1", "corrected3")}
    prop = relerr(ladder["corrected3"].proportion[:4],
                  ladder["exact"].proportion[:4])
    checks = {
        "corrected(3) top-4 relerr < 1e-2": rel["corrected3"][:4].max() < 1e-2,
        "corrected(3) relerr < 0.15": rel["corrected3"].max() < 0.15,
        "sketch relerr < 0.5": rel["sketch"].max() < 0.5,
        "corrected(1) < sketch": rel["corrected1"].max()
        < rel["sketch"].max(),
        "corrected(3) <= 1.05 corrected(1)": rel["corrected3"].max()
        <= rel["corrected1"].max() * 1.05 + 1e-6,
        "proportions within 5 %": prop.max() < 0.05,
    }
    print(f"ladder, pcoa --metric grm from the packed store ({N_SAMPLES} x "
          f"{N_VARIANTS}, rank {SKETCH_RANK_DEFAULT}) [{card}]: "
          + "; ".join(ladder_lines) + "; max relerr of the "
          f"{NUM_PC} eigenvalues vs exact: sketch "
          f"{rel['sketch'].max():.4g}, corrected(1) "
          f"{rel['corrected1'].max():.4g}, corrected(3) "
          f"{rel['corrected3'].max():.4g} (top 4 "
          f"{rel['corrected3'][:4].max():.3g}); proportions (top 4) within "
          f"{prop.max():.3g}; " + ", ".join(
              f"{k}: {'ok' if v else 'FAILED'}" for k, v in checks.items()))
    if not all(checks.values()):
        fail("the ladder's accuracy contract: "
             + ", ".join(k for k, v in checks.items() if not v))

    # -- 26. corrected ibs and pca; a corrected-rung kill and resume -------
    for cmd, metric in (("pcoa", "ibs"), ("pca", None)):
        argv = [cmd, "--source", "packed", "--path", store, "--solver",
                "corrected", "--num-pc", str(NUM_PC), "--block-variants",
                str(BLOCK_VARIANTS), "--device", DEVICE]
        if metric:
            argv += ["--metric", metric]
        counts, timings, coords, wall = run_cli(cli_main, argv,
                                                launch_counters, NUM_PC)
        sep = separation(coords, source.populations)
        if counts["packed_gram"] or not sep >= SEPARATION_MIN:
            fail(f"{cmd} --solver corrected: launches {counts}, PC1-2 "
                 f"separation {sep:.3f}")
        paths[f"{cmd} {metric or 'shared-alt'} corrected"] = counts
        print(f"{cmd} --solver corrected{' --metric ' + metric if metric else ''}"
              f" from the packed store [{card}]: wall {wall:.3f} s; phases: "
              + phases_line(timings, ("ingest_setup", "gram", "eigh"))
              + f"; launches {counts}; PC1-2 separation {sep:.2f}")
    sk = os.path.join(tmp, "ck_sketch")
    per_pass = expected
    kill_at = per_pass + SKETCH_KILL_IN_PASS1
    killed = ladder_job("corrected", sketch_iters=1, checkpoint_dir=sk,
                        checkpoint_every_blocks=CKPT_EVERY_BLOCKS)

    def kill_sketch():
        try:
            jobs.pcoa_job(killed, source=DyingSource(load_packed(store),
                                                     kill_at))
        except RuntimeError as e:
            if "simulated preemption" not in str(e):
                raise
        else:
            fail("the dying source did not stop the corrected run")

    _, counts, kill_wall = counted(kill_sketch)
    cursor = manifest_cursor(sk)
    resumed, r_counts, r_wall = counted(lambda: jobs.pcoa_job(
        ladder_job("corrected", sketch_iters=1, checkpoint_dir=sk)))
    if counts["packed_gram"] or r_counts["packed_gram"]:
        fail(f"the corrected-rung kill and resume launched K1: {counts}, "
             f"{r_counts}")
    want = ladder["corrected1"]
    if not (np.array_equal(resumed.coords, want.coords)
            and np.array_equal(resumed.eigenvalues, want.eigenvalues)):
        fail("the resumed corrected run's coordinates differ from the "
             "uninterrupted run's")
    print(f"corrected-rung kill and resume, grm, sketch-iters 1 [{card}]: "
          f"the source died {SKETCH_KILL_IN_PASS1} blocks into pass 1 "
          f"(wall {kill_wall:.3f} s), the checkpoint held pass 1 at variant "
          f"{cursor}; the rerun (wall {r_wall:.3f} s, gram "
          f"{resumed.timer.phases['gram']:.4f} s) gave coordinates and "
          "eigenvalues bitwise equal to the uninterrupted run's (phase 25)")

    # -- 27. 100,000 samples: the width the exact route cannot hold --------
    big = os.path.join(tmp, "ds_100k")
    argv = ["ingest", "--n-samples", str(BIG_SAMPLES), "--n-variants",
            str(BIG_VARIANTS), "--block-variants", str(BLOCK_VARIANTS),
            "--chunk-variants", str(CHUNK_VARIANTS), "--store-codec", "raw",
            "--device", DEVICE]
    i_counts, i_timings, _, i_wall = run_job(cli_main, argv, launch_counters,
                                             big)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["pcoa", "--metric", "ibs", "--solver", "corrected",
            "--sketch-iters", "2", "--source", f"store:{big}", "--num-pc",
            str(NUM_PC), "--block-variants", str(BLOCK_VARIANTS), "--device",
            DEVICE]
    passes0 = span_totals(("solver.pass", "solver.solve"))
    counts, timings, coords, wall = run_cli(cli_main, argv, launch_counters,
                                            NUM_PC)
    peak = torch.cuda.max_memory_allocated()
    passes = span_line(passes0, span_totals(("solver.pass",
                                             "solver.solve")))
    nxn = sketch.nxn_bytes(BIG_SAMPLES, "ibs")
    sep = separation(coords, SyntheticSource(
        n_samples=BIG_SAMPLES, n_variants=BIG_VARIANTS).populations)
    print(f"pcoa --metric ibs --solver corrected --sketch-iters 2, "
          f"{BIG_SAMPLES} x {BIG_VARIANTS} from a raw store [{card}]: "
          f"ingest wall {i_wall:.3f} s (compact "
          f"{i_timings['compact']:.4f} s, launches {i_counts}); pcoa wall "
          f"{wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "eigh"))
          + f" ({passes}); launches {counts}; "
          "torch.cuda.max_memory_allocated() "
          f"{peak / 1e9:.3f} GB against sketch.nxn_bytes {nxn / 1e9:.1f} GB "
          f"(one N x N leaf {nxn / 4e9:.1f} GB); PC1-2 separation "
          f"{sep:.2f}")
    if counts["packed_gram"] or any(i_counts.values()):
        fail(f"the 100,000-sample run launched kernels: {counts}")
    if not peak < nxn / 4:
        fail(f"peak device memory {peak / 1e9:.3f} GB is not below one "
             f"N x N leaf ({nxn / 4e9:.1f} GB)")
    if coords.shape != (BIG_SAMPLES, NUM_PC) or not sep >= SEPARATION_MIN:
        fail(f"100,000-sample coords {coords.shape}, separation {sep:.3f}")
    paths["ingest 100k"] = i_counts
    paths["pcoa ibs corrected 100k"] = counts
    return paths


@contextlib.contextmanager
def python_codec():
    """Run the block with the native codec's loader state stubbed out,
    so every host loop takes its Python path (the tests' idiom); the
    loaded library is restored after."""
    from spark_examples_tpu_torch import native
    from spark_examples_tpu_torch.store import codec as codecmod

    saved = (native._lib, native._tried, codecmod._fallback_warned)
    native._lib, native._tried = None, True
    codecmod._fallback_warned = True  # the forced fallback is no news
    try:
        yield
    finally:
        native._lib, native._tried, codecmod._fallback_warned = saved


def nearest_centroid_hits(coords: np.ndarray, pops: np.ndarray,
                          fit: np.ndarray, fit_pops: np.ndarray) -> int:
    """How many rows of ``coords`` lie nearest, in the planted
    structure's NUM_POP_PCS components, to the centroid of their own
    population among the fitted panel's centroids."""
    d_pc = NUM_POP_PCS
    labels_u = np.unique(fit_pops)
    cents = np.stack([fit[fit_pops == k, :d_pc].mean(0) for k in labels_u])
    d = np.linalg.norm(coords[:, None, :d_pc] - cents[None], axis=2)
    return int((labels_u[d.argmin(axis=1)] == pops).sum())


def native_projection_parquet_phases(cli_main, launch_counters: dict,
                                     card: str, dev, source, expected: int,
                                     synthetic_acc: dict, files: dict,
                                     tmp: str) -> dict:
    """Phases 28-31: the native host codec, fit-then-project at the
    Quickstart width (exact pcoa, pca and the factorized model),
    cross-kinship, and the parquet source. Returns the launches by
    kernel of each CLI run, by path name."""
    import torch

    from spark_examples_tpu_torch import native
    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
        ReferenceRange,
    )
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest import bitpack
    from spark_examples_tpu_torch.ingest.packed import (
        load_packed,
        save_packed,
    )
    from spark_examples_tpu_torch.ingest.plink import PlinkSource
    from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
    from spark_examples_tpu_torch.ingest.vcf import VcfSource
    from spark_examples_tpu_torch.ops import genotype
    from spark_examples_tpu_torch.pipelines import project as P
    from spark_examples_tpu_torch.pipelines import runner
    from spark_examples_tpu_torch.pipelines.project import load_model

    paths = {}

    # -- 28. the native host codec -----------------------------------------
    lib = native.load()
    if lib is None:
        fail(f"the native codec did not build: {native.build_error}")
    lib_path = native.library_path()
    if lib_path.parent != native.BUILD_DIR or not lib_path.exists():
        fail(f"the native codec is not in the build directory: {lib_path}")
    missing = [e for e in native.ENTRIES if not hasattr(lib, e)]
    if missing:
        fail(f"the native codec lacks {missing}")
    print(f"native codec: {lib_path.relative_to(native.BUILD_DIR.parent)} "
          f"exports {', '.join(native.ENTRIES)}")

    vcf = files["vcf"]
    t0 = time.perf_counter()
    nat = list(VcfSource(vcf).blocks(BLOCK_VARIANTS))
    vcf_native_s = time.perf_counter() - t0
    with python_codec():
        t0 = time.perf_counter()
        py = list(VcfSource(vcf).blocks(BLOCK_VARIANTS))
        vcf_python_s = time.perf_counter() - t0
    if len(nat) != len(py) or not all(
            np.array_equal(a, b) for (a, _), (b, _) in zip(nat, py)):
        fail("the native VCF parse differs from the Python parse")
    genotypes = N_SAMPLES * sum(b.shape[1] for b, _ in nat)
    block = nat[0][0]
    del nat, py
    t0 = time.perf_counter()
    packed = bitpack.pack_dosages(block)
    unpacked = bitpack.unpack_dosages_np(packed)
    pack_native_s = time.perf_counter() - t0
    with python_codec():
        t0 = time.perf_counter()
        packed_py = bitpack.pack_dosages(block)
        unpacked_py = bitpack.unpack_dosages_np(packed_py)
        pack_python_s = time.perf_counter() - t0
    if not (np.array_equal(packed, packed_py)
            and np.array_equal(unpacked, unpacked_py)):
        fail("the native 2-bit pack/unpack differs from numpy's")
    print(f"native vs Python, host loops [{card}]: VCF parse of "
          f"{N_SAMPLES} x {genotypes // N_SAMPLES} ({genotypes} genotypes) "
          f"{vcf_native_s:.4f} s native ({genotypes / vcf_native_s / 1e6:.3f}"
          f" M genotypes/s) vs {vcf_python_s:.4f} s Python "
          f"({genotypes / vcf_python_s / 1e6:.3f} M/s), blocks identical; "
          f"pack + unpack of a {block.shape} block {pack_native_s:.4f} s "
          f"native vs {pack_python_s:.4f} s numpy, bytes identical")

    def store_gram(job) -> dict:
        src = runner.build_source(job.ingest, DEVICE)
        try:
            g = runner.run_gram(job, src, PhaseTimer())
        finally:
            src.close()
        return {k: v.cpu() for k, v in g.acc.items()}

    zlib_d = os.path.join(tmp, "ds_zlib_w4")
    plink_ds = os.path.join(tmp, "ds_plink")
    lo, hi = REFERENCE_RANGE
    ref = f"1:{lo}:{hi}"
    ref_acc = {k: v.cpu() for k, v in runner.run_gram(
        JobConfig(ingest=IngestConfig(block_variants=BLOCK_VARIANTS),
                  compute=ComputeConfig(metric="ibs", device=DEVICE)),
        PlinkSource(files["plink"], references=(ReferenceRange.parse(ref),)),
        PhaseTimer()).acc.items()}
    # (name, argv, ingest, metric, accumulators, K1 launches, whether the
    # route decodes chunks into dense dosages: the packed route ships
    # whole chunks' 2-bit bytes, inflated by Python's zlib either way, so
    # only the dense and range routes reach the native decode and count
    # a forced fallback).
    cases = (
        ("pcoa store zlib", ["pcoa", "--source", f"store:{zlib_d}",
                             "--num-pc", str(NUM_PC)],
         dict(source=f"store:{zlib_d}"), "ibs", synthetic_acc, expected,
         False),
        ("similarity euclidean store", [
            "similarity", "--metric", "euclidean", "--source",
            f"store:{zlib_d}"], dict(source=f"store:{zlib_d}"),
         "euclidean", files["euclidean_acc"], 0, True),
        ("pcoa store references", [
            "pcoa", "--source", f"store:{plink_ds}", "--references", ref,
            "--num-pc", str(NUM_PC)],
         dict(source=f"store:{plink_ds}",
              references=[ReferenceRange.parse(ref)]), "ibs", ref_acc,
         math.ceil((hi - lo) / BLOCK_VARIANTS), True),
    )
    lines = []
    for name, argv, ingest, metric, want, launches, decodes in cases:
        argv = argv + ["--block-variants", str(BLOCK_VARIANTS),
                       "--device", DEVICE]
        job = JobConfig(
            ingest=IngestConfig(block_variants=BLOCK_VARIANTS, **ingest),
            compute=ComputeConfig(metric=metric, device=DEVICE))
        grams = {}
        for how in ("native", "python"):
            telemetry.reset()
            ctx = python_codec() if how == "python" else \
                contextlib.nullcontext()
            with ctx, tempfile.TemporaryDirectory() as out_dir:
                out = os.path.join(out_dir, "out.npy" if argv[0] ==
                                   "similarity" else "out.tsv")
                counts, timings, _, _ = run_job(cli_main, argv,
                                                launch_counters, out)
                acc = store_gram(job)
            fallback = telemetry.counter_value("store.codec.fallback")
            if fallback != (1.0 if how == "python" and decodes else 0.0):
                fail(f"{name} ({how} codec): store.codec.fallback "
                     f"{fallback}")
            if counts["packed_gram"] != launches:
                fail(f"{name} ({how} codec): launches {counts}")
            if not equal_accumulators(acc, want):
                fail(f"{name} ({how} codec): accumulators differ from the "
                     "earlier phase's")
            grams[how] = timings["gram"]
            if how == "native":
                paths[f"{name} native"] = counts
        lines.append(f"{name}: gram {grams['native']:.4f} s native vs "
                     f"{grams['python']:.4f} s Python")
    print(f"store reads, native vs Python decode [{card}]: "
          + "; ".join(lines) + "; store.codec.fallback 0 on the native "
          "runs, 1 on the forced-Python runs of the decoding routes (the "
          "packed route inflates whole chunks with Python's zlib either "
          "way); accumulators bitwise equal to phases 6, 12 and 21")

    # -- 29. fit a panel, then project new samples -------------------------
    store = load_packed(files["packed_store"])
    cohort = np.concatenate(
        [b for b, _ in store.blocks(CHUNK_VARIANTS)], axis=1)
    ids = store.sample_ids
    pops = source.populations
    panel_d = os.path.join(tmp, "panel")
    new_d = os.path.join(tmp, "new")
    save_packed(panel_d, cohort[:PANEL_SAMPLES], ids[:PANEL_SAMPLES])
    save_packed(new_d, cohort[PANEL_SAMPLES:], ids[PANEL_SAMPLES:])
    panel_pops, new_pops = pops[:PANEL_SAMPLES], pops[PANEL_SAMPLES:]
    n_new = N_SAMPLES - PANEL_SAMPLES
    panel_args = ["--source", "packed", "--path", panel_d,
                  "--block-variants", str(BLOCK_VARIANTS), "--device",
                  DEVICE, "--num-pc", str(NUM_PC)]
    fits = (
        ("pcoa", ["pcoa", "--metric", "ibs"], expected, "pcoa"),
        ("pca", ["pca"], expected, "pca"),
        ("pcoa corrected", ["pcoa", "--metric", "ibs", "--solver",
                            "corrected", "--sketch-iters", "2"], 0,
         "factorized"),
    )
    proj_lines = []
    fitted = {}
    for name, fit_argv, fit_launches, kind in fits:
        model = os.path.join(tmp, f"{name.replace(' ', '_')}.npz")
        counts, timings, fit_coords, wall = run_cli(
            cli_main, fit_argv + panel_args + ["--save-model", model],
            launch_counters, NUM_PC)
        if counts["packed_gram"] != fit_launches:
            fail(f"{name} --save-model: launches {counts}, expected "
                 f"{fit_launches}")
        mdl = load_model(model)
        if mdl.kind != kind or mdl.n_ref != PANEL_SAMPLES:
            fail(f"{name} --save-model wrote kind {mdl.kind}, "
                 f"{mdl.n_ref} samples")
        paths[f"{name} --save-model"] = counts
        k = mdl.n_components
        results = {}
        for side, path in (("new", new_d), ("panel", panel_d)):
            kept = []  # the job's coordinates at full precision
            orig = keeping(P, "pcoa_project_job", kept)
            try:
                pcounts, ptimings, coords, pwall = run_cli(
                    cli_main, ["project", "--model", model, "--source",
                               "packed", "--path", path, "--ref-source",
                               "packed", "--ref-path", panel_d,
                               "--block-variants", str(BLOCK_VARIANTS),
                               "--device", DEVICE], launch_counters, k)
            finally:
                P.pcoa_project_job = orig
            if any(pcounts.values()):
                fail(f"project ({name} model, {side}): launches {pcounts}")
            results[side] = (coords, ptimings, pwall)
            paths[f"project {name} {side}"] = pcounts
            if side == "new":
                fitted[name] = {"model": model, "kind": kind,
                                "fit_coords": fit_coords[:, :k],
                                "new_coords": kept[-1].coords}
        new_coords, ptimings, pwall = results["new"]
        hits = nearest_centroid_hits(new_coords, new_pops, fit_coords[:, :k],
                                     panel_pops)
        if new_coords.shape != (n_new, k) or hits != n_new:
            fail(f"project ({name} model): shape {new_coords.shape}, "
                 f"{hits} of {n_new} held-out samples nearest their own "
                 "population's centroid")
        self_err = np.abs(results["panel"][0] - fit_coords[:, :k]).max(
            axis=0) / np.abs(fit_coords[:, :k]).max()
        if kind != "factorized" and not (
                self_err[:NUM_POP_PCS] <= SELF_PROJECTION_RTOL).all():
            fail(f"project ({name} model): panel samples land "
                 f"{self_err[:NUM_POP_PCS]} (of max|coords|) from their "
                 f"fitted coordinates, above {SELF_PROJECTION_RTOL}")
        proj_lines.append(
            f"{name} --save-model (wall {wall:.3f} s, gram "
            f"{timings['gram']:.4f} s, launches {counts}) -> {kind} model "
            f"of {k} components; project {n_new} new samples: wall "
            f"{pwall:.3f} s, "
            + phases_line(ptimings, ("ingest_setup", "gram", "eigh"))
            + f", 0 launches, {hits}/{n_new} nearest their own "
            f"population's centroid (PC1-{NUM_POP_PCS}); the panel projected onto its fit: "
            f"max |diff| / max|coords| per PC "
            + " ".join(f"{e:.2e}" for e in self_err)
            + (" (not gated: the corrected rung's basis is approximate)"
               if kind == "factorized" else
               f" (top {NUM_POP_PCS} within {SELF_PROJECTION_RTOL})"))
    print(f"fit {PANEL_SAMPLES} panel samples, project {n_new} new "
          f"[{card}]: " + "; ".join(proj_lines))

    # The cross products of one block, timed (int8 tensor cores through
    # torch._int_mm; the JAX package has no Pallas kernel here).
    bn = torch.from_numpy(cohort[PANEL_SAMPLES:, :BLOCK_VARIANTS]).to(dev)
    br = torch.from_numpy(cohort[:PANEL_SAMPLES, :BLOCK_VARIANTS]).to(dev)
    cross_lines = []
    for stats in (("m", "d1"), ("s",), ("hh", "opp", "hcn", "hcr")):
        got = genotype.cross_stats(bn, br, stats)
        want = genotype.cross_stats(bn.cpu(), br.cpu(), stats)
        if not all(torch.equal(got[s].cpu(), want[s]) for s in stats):
            fail(f"cross_stats {stats} on the card differ from the CPU's")
        ms = cuda_ms(lambda: genotype.cross_stats(bn, br, stats), reps=10,
                     warmup=2)
        terms = sum(len(genotype.CROSS_STATS[s]) for s in stats)
        ops = 2.0 * n_new * PANEL_SAMPLES * BLOCK_VARIANTS * terms
        cross_lines.append(
            f"{'+'.join(stats)} ({terms} int8 products) {ms:.4f} ms "
            f"({ops / (ms * 1e-3) / 1e12:.2f} TOP/s; bound "
            f"{ops / PEAK_INT8_OPS * 1e3:.4f} ms)")
    print(f"cross products per block ({n_new} x {PANEL_SAMPLES} x "
          f"{BLOCK_VARIANTS}) [{card}]: " + "; ".join(cross_lines)
          + "; bitwise equal to the CPU's")
    del bn, br

    # -- 30. cross-kinship with planted duplicates ---------------------------
    planted = np.arange(PLANTED_COPIES) * (PANEL_SAMPLES // PLANTED_COPIES)
    dup = cohort[PANEL_SAMPLES:].copy()
    dup[:PLANTED_COPIES] = cohort[planted]
    dup_d = os.path.join(tmp, "new_dup")
    save_packed(dup_d, dup, [f"DUP{i}" for i in range(n_new)])
    del dup
    files["projection"] = {"panel": panel_d, "new": new_d, "dup": dup_d,
                           "models": fitted, "planted": planted,
                           "panel_pops": panel_pops, "new_pops": new_pops}
    with tempfile.TemporaryDirectory() as out_dir:
        phi_path = os.path.join(out_dir, "phi.npy")
        ck_counts, ck_timings, ck_out, ck_wall = run_job(
            cli_main, ["cross-kinship", "--source", "packed", "--path",
                       dup_d, "--ref-source", "packed", "--ref-path",
                       panel_d, "--block-variants", str(BLOCK_VARIANTS),
                       "--device", DEVICE, "--min-phi",
                       str(PLANTED_MIN_PHI)], launch_counters, phi_path)
        phi = np.load(phi_path)
    hits = set(zip(*np.nonzero(phi >= PLANTED_MIN_PHI)))
    want_hits = {(i, int(planted[i])) for i in range(PLANTED_COPIES)}
    if phi.shape != (n_new, PANEL_SAMPLES) or hits != want_hits or any(
            ck_counts.values()):
        fail(f"cross-kinship: shape {phi.shape}, pairs with phi >= "
             f"{PLANTED_MIN_PHI} {sorted(hits)[:12]}, launches {ck_counts}")
    others = phi.copy()
    others[tuple(np.array(sorted(want_hits)).T)] = np.nan
    paths["cross-kinship"] = ck_counts
    print(f"cross-kinship {n_new} x {PANEL_SAMPLES} with {PLANTED_COPIES} "
          f"planted copies [{card}]: wall {ck_wall:.3f} s; phases: "
          + phases_line(ck_timings, ("gram", "finalize"))
          + f"; phi >= {PLANTED_MIN_PHI} on exactly the planted pairs "
          f"(min {min(phi[i, j] for i, j in want_hits):.4f}); max phi "
          f"elsewhere {np.nanmax(others):.4f}; launches {ck_counts}")
    del cohort, others, phi

    # -- 31. parquet -------------------------------------------------------
    try:
        import pyarrow
    except ImportError:
        print("parquet: pyarrow is absent on this machine")
        try:
            cli_main(["pcoa", "--source", "parquet", "--path", "x.parquet",
                      "--device", DEVICE])
        except ImportError as e:
            if "needs pyarrow" not in str(e):
                fail(f"--source parquet without pyarrow: {e}")
            print(f"parquet: the CLI refuses --source parquet: {e}")
        else:
            fail("--source parquet ran without pyarrow")
        return paths
    from spark_examples_tpu_torch.ingest.parquet import (
        ParquetSource,
        write_parquet,
    )

    want, _ = next(SyntheticSource(n_samples=N_SAMPLES,
                                   n_variants=N_VARIANTS).blocks(
                                       VCF_VARIANTS))
    pq_path = os.path.join(tmp, "cohort.parquet")
    t0 = time.perf_counter()
    write_parquet(pq_path, want, sample_ids=source.sample_ids,
                  row_group_rows=1024)
    write_s = time.perf_counter() - t0
    got = np.concatenate(
        [b for b, _ in ParquetSource(pq_path).blocks(BLOCK_VARIANTS)], axis=1)
    if not np.array_equal(got, want):
        fail("parquet blocks differ from the synthetic source's")
    pq_counts, pq_timings, pq_wall = run_similarity_cli(
        cli_main, ["similarity", "--source", "parquet", "--path", pq_path,
                   "--block-variants", str(BLOCK_VARIANTS), "--device",
                   DEVICE], launch_counters, N_SAMPLES)
    if pq_counts["packed_gram"] != 1:
        fail(f"similarity --source parquet: launches {pq_counts}")
    paths["similarity parquet"] = pq_counts
    print(f"parquet: pyarrow {pyarrow.__version__} is present; "
          f"{N_SAMPLES} x {VCF_VARIANTS} written in {write_s:.3f} s "
          f"({os.path.getsize(pq_path) / 1e6:.1f} MB), blocks bitwise equal "
          f"to the synthetic source's; similarity --source parquet [{card}]:"
          f" wall {pq_wall:.3f} s; phases: "
          + phases_line(pq_timings, ("ingest_setup", "gram", "finalize"))
          + f"; launches {pq_counts}")
    return paths


# The JAX package's CPU run of the neighbors job on the Quickstart cohort
# (the same genotypes, sample ids and block grid as phase 14's store),
# with its defaults (128 hashes, 32 bands, k 10, bucket cap 64):
#   JAX_PLATFORMS=cpu python -c "from spark_examples_tpu.cli.main import \
#     main; from spark_examples_tpu.core import telemetry; main(['neighbors',\
#     '--n-samples','2504','--n-variants','100000','--metric','ibs',\
#     '--output-path','nb.topk']); \
#     print(telemetry.counter_value('neighbors.candidate_pairs'))"
#   sha256sum nb.topk
JAX_CANDIDATE_PAIRS = 490220
JAX_TOPK_SHA256 = ("a4e1f43663fbfcdc46f2945ac75359de"
                   "923bb7918a15ec088512fb1c09757c35")
STREAM_REFRESH_BLOCKS = 4
# JAX's own tolerances for the streaming job against the dense one
# (tests/test_streaming.py), and for its snapshots against the final.
STREAM_EIG_RTOL, STREAM_EIG_ATOL = 1e-2, 1e-4
STREAM_COORD_RTOL, STREAM_COORD_ATOL = 1e-2, 1e-3
# The coverage job: 35 Mb of chr22 at 30x (7,000,000 reads of 150 bp);
# the SAM check on its first 1 Mb with 200,000 reads.
COVERAGE_RANGE = "chr22:16050000:51050000"
COVERAGE_READS = 7_000_000
SAM_RANGE = "chr22:16050000:17050000"
SAM_READS = 200_000
NEIGHBORS_KILL_AT_BLOCK = 10


def sha256_of(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def run_counted(cli_main, argv: list[str], counters: dict):
    """One CLI run without ``--timings`` (the ``coverage`` command has
    none): every kernel's launch count set to 0 just before, read just
    after. Returns (launches by kernel, the run's stdout, wall s)."""
    out = io.StringIO()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{' '.join(argv)}: CLI returned {rc}")
    return ({name: mod.launches for name, mod in counters.items()},
            out.getvalue(), wall)


def keeping(module, name: str, kept: list):
    """Replace ``module.name`` with a wrapper that appends each result to
    ``kept``; returns the original (restore it with setattr)."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        kept.append(fn(*args, **kwargs))
        return kept[-1]

    setattr(module, name, wrapper)
    return fn


def streaming_example_neighbors_phases(cli_main, launch_counters: dict,
                                       card: str, source, expected: int,
                                       synthetic_acc: dict, files: dict,
                                       tmp: str) -> dict:
    """Phases 32-35: streaming PCoA snapshots, the example tier
    (search-variants, sample-stats), coverage and the neighbors job, on
    phase 14's packed store. Returns the launches by kernel of each CLI
    run, by path name."""
    import torch

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
    )
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.ingest.reads import SyntheticReadsSource
    from spark_examples_tpu_torch.core.config import ReferenceRange
    from spark_examples_tpu_torch.neighbors import engine, load_result
    from spark_examples_tpu_torch.ops import distances, gram
    from spark_examples_tpu_torch.pipelines import coverage, jobs, streaming

    paths = {}
    store = files["packed_store"]
    phases_t0 = time.perf_counter()
    store_args = ["--source", "packed", "--path", store, "--block-variants",
                  str(BLOCK_VARIANTS), "--device", DEVICE]

    # -- 32. streaming PCoA snapshots ---------------------------------------
    kept: list = []
    original = keeping(streaming, "incremental_pcoa_job", kept)
    try:
        argv = (["pcoa"] + store_args
                + ["--metric", "ibs", "--num-pc", str(NUM_PC),
                   "--stream-refresh-blocks", str(STREAM_REFRESH_BLOCKS)])
        counts, timings, coords, wall = run_cli(cli_main, argv,
                                                launch_counters, NUM_PC)
    finally:
        streaming.incremental_pcoa_job = original
    out, snaps = kept.pop()
    dense = jobs.pcoa_job(JobConfig(
        ingest=IngestConfig(source="packed", path=store,
                            block_variants=BLOCK_VARIANTS),
        compute=ComputeConfig(metric="ibs", num_pc=NUM_PC, device=DEVICE)))
    want_snaps = [BLOCK_VARIANTS * STREAM_REFRESH_BLOCKS * i
                  for i in range(1, expected // STREAM_REFRESH_BLOCKS + 1)]
    final = out.eigenvalues[0]
    errs = [abs(s.eigenvalues[0] - final) / final for s in snaps]
    sep = separation(coords, source.populations)
    # The structure eigenvalues (one fewer than the populations) are held
    # to JAX's tolerance; the bulk ones converge only to a few percent in
    # the JAX package's streaming route too (1 warm step a refresh, 4
    # terminal steps: tests/test_torch_streaming.py), so every eigenvalue
    # is held to 1e-2 of the top one, the scale that moves coordinates.
    n_struct = len(np.unique(source.populations)) - 1
    eig_ok = np.allclose(out.eigenvalues[:n_struct],
                         dense.eigenvalues[:n_struct],
                         rtol=STREAM_EIG_RTOL, atol=STREAM_EIG_ATOL)
    bulk_ok = np.abs(out.eigenvalues - dense.eigenvalues).max() <= \
        STREAM_EIG_RTOL * dense.eigenvalues[0]
    coord_ok = np.allclose(np.abs(out.coords[:, :2]),
                           np.abs(dense.coords[:, :2]),
                           rtol=STREAM_COORD_RTOL, atol=STREAM_COORD_ATOL)
    checks = {
        f"K1 launches == {expected}": counts["packed_gram"] == expected,
        f"snapshots at {want_snaps}": [s.n_variants for s in snaps]
        == want_snaps,
        f"top {n_struct} eigenvalues within rtol 1e-2 of the dense job":
            eig_ok,
        "all within 1e-2 of the top eigenvalue": bulk_ok,
        "|coords| PC1-2 within rtol 1e-2, atol 1e-3": coord_ok,
        "first snapshot within 25 %": errs[0] < 0.25,
        "later snapshots within 10 %": all(e < 0.10 for e in errs[1:]),
        f"separation >= {SEPARATION_MIN}": sep >= SEPARATION_MIN,
    }
    paths["pcoa stream-refresh"] = counts
    eig_rel = np.abs(out.eigenvalues - dense.eigenvalues) / np.abs(
        dense.eigenvalues)
    print(f"streaming pcoa --stream-refresh-blocks {STREAM_REFRESH_BLOCKS} "
          f"from the packed store, ibs {N_SAMPLES} x {N_VARIANTS}, "
          f"{NUM_PC} PCs [{card}]: wall {wall:.3f} s; phases: "
          + phases_line(timings, ("ingest_setup", "gram", "stream_refresh",
                                  "stream_drain", "eigh"))
          + f"; gram {timings['gram']:.4f} s with {len(snaps)} refreshes vs "
          f"{files['packed_store_gram_s']:.4f} s without (phase 14); "
          f"launches {counts}; snapshots at "
          f"{[s.n_variants for s in snaps]}, top eigenvalue "
          + ", ".join(f"{s.eigenvalues[0]:.6g}" for s in snaps)
          + f" (final {final:.6g}; relerr "
          + ", ".join(f"{e:.3g}" for e in errs)
          + "); eigenvalues vs the dense job (phase 14's, rerun): relerr "
          + ", ".join(f"{e:.3g}" for e in eig_rel)
          + f"; PC1-2 separation {sep:.2f}; "
          + ", ".join(f"{k}: {'ok' if v else 'FAILED'}"
                      for k, v in checks.items()))
    if not all(checks.values()):
        fail("streaming pcoa: " + ", ".join(k for k, v in checks.items()
                                              if not v))
    del dense, out, snaps

    # -- 33. the example tier: search-variants and sample-stats --------------
    t0 = time.perf_counter()
    g = np.concatenate([b for b, _ in load_packed(store).blocks(
        BLOCK_VARIANTS)], axis=1)
    hom_ref, het, hom_alt, missing = ((g == v).sum(axis=0)
                                      for v in (0, 1, 2, -1))
    called = (g >= 0).sum(axis=1)
    s_het, s_hom = (g == 1).sum(axis=1), (g == 2).sum(axis=1)
    ref_s = time.perf_counter() - t0
    del g

    def af(h0, h1, h2):
        c = h0 + h1 + h2
        return (h1 + 2 * h2) / (2 * c) if c else 0.0

    def tsv_rows(path):
        with open(path) as f:
            return [line.rstrip("\n").split("\t") for line in f]

    lines = []
    with tempfile.TemporaryDirectory() as d:
        sv = os.path.join(d, "sv.tsv")
        sv_counts, sv_t, _, sv_wall = run_job(
            cli_main, ["search-variants"] + store_args, launch_counters, sv)
        rows = tsv_rows(sv)
        want = [[r[0], r[1], str(hom_ref[i]), str(het[i]), str(hom_alt[i]),
                 str(missing[i]),
                 f"{af(int(hom_ref[i]), int(het[i]), int(hom_alt[i])):.6f}"]
                for i, r in enumerate(rows[1:])]
        if len(rows) != N_VARIANTS + 1 or rows[1:] != want:
            fail("search-variants: the histogram TSV differs from NumPy's "
                 "counts of the unpacked cohort")
        picks = [0, N_VARIANTS // 8 + 3, N_VARIANTS // 2, 7 * N_VARIANTS // 9,
                 N_VARIANTS - 1]
        absent = max(int(r[1]) for r in rows[1:]) + 1000
        pos = [rows[1 + i][1] for i in picks] + [str(absent)]
        svp = os.path.join(d, "svp.tsv")
        svp_counts, _, _, svp_wall = run_job(
            cli_main, ["search-variants"] + store_args + ["--positions"]
            + pos, launch_counters, svp)
        if tsv_rows(svp) != [rows[0]] + [rows[1 + i] for i in picks]:
            fail("search-variants --positions: rows differ from the full "
                 "scan's at those positions")
        ss = os.path.join(d, "ss.tsv")
        ss_counts, ss_t, _, ss_wall = run_job(
            cli_main, ["sample-stats"] + store_args, launch_counters, ss)
        want_ss = [["sample", "n_called", "call_rate", "n_het", "het_rate",
                    "n_hom_alt"]] + [
            [sid, str(called[i]), f"{called[i] / N_VARIANTS:.6f}",
             str(s_het[i]),
             f"{(s_het[i] / called[i] if called[i] else 0.0):.6f}",
             str(s_hom[i])] for i, sid in enumerate(source.sample_ids)]
        if tsv_rows(ss) != want_ss:
            fail("sample-stats: the TSV differs from NumPy's counts")
    for name, c in (("search-variants", sv_counts),
                    ("search-variants --positions", svp_counts),
                    ("sample-stats", ss_counts)):
        if c["packed_gram"] or c["braycurtis"]:
            fail(f"{name} launched a kernel: {c}")
        paths[name] = c
    print(f"example tier from the packed store, {N_SAMPLES} x {N_VARIANTS} "
          f"[{card}]: search-variants full scan wall {sv_wall:.3f} s (scan "
          f"{sv_t['scan']:.4f} s), {N_VARIANTS} rows equal to NumPy's "
          f"counts; --positions (5 present, 1 absent) wall {svp_wall:.3f} s, "
          f"5 rows equal to the full scan's; sample-stats wall "
          f"{ss_wall:.3f} s (scan {ss_t['scan']:.4f} s), {N_SAMPLES} rows "
          f"equal to NumPy's; NumPy reference {ref_s:.3f} s; launches "
          f"{sv_counts}, {svp_counts}, {ss_counts}")

    # -- 34. coverage: 35 Mb at 30x, then a SAM file --------------------------
    kept = []
    original = keeping(coverage, "coverage", kept)
    try:
        cov_counts, cov_out, cov_wall = run_counted(
            cli_main, ["coverage", "--references", COVERAGE_RANGE,
                       "--reads-per-range", str(COVERAGE_READS),
                       "--device", DEVICE], launch_counters)
    finally:
        coverage.coverage = original
    (res,) = kept.pop()
    ref = ReferenceRange.parse(COVERAGE_RANGE)
    t0 = time.perf_counter()
    starts, lengths = (np.concatenate(x) for x in zip(
        *SyntheticReadsSource([ref], reads_per_range=COVERAGE_READS)
        .read_batches(ref, 1 << 20)))
    span = ref.end - ref.start
    s = np.clip(starts - ref.start, 0, span - 1)
    e = np.clip(starts + lengths - ref.start, 0, span)
    want_depth = np.cumsum(np.bincount(s, minlength=span + 1)
                           - np.bincount(e, minlength=span + 1))[:-1]
    oracle_s = time.perf_counter() - t0
    del starts, lengths, s, e
    if res.depth.shape != (span,) or res.n_reads != COVERAGE_READS or \
            not np.array_equal(res.depth.astype(np.int64), want_depth) or \
            not np.array_equal(res.depth, want_depth.astype(np.float32)):
        fail("coverage: the depth differs from NumPy's bincount/cumsum")
    mean_depth, max_depth = res.mean, int(res.depth.max())
    del res, want_depth
    sam_ref = ReferenceRange.parse(SAM_RANGE)
    sam = os.path.join(tmp, "reads.sam")
    t0 = time.perf_counter()
    with open(sam, "w") as f:
        f.write(f"@HD\tVN:1.6\n@SQ\tSN:{sam_ref.contig}\tLN:{sam_ref.end}\n")
        n = 0
        for st, ln in SyntheticReadsSource(
                [sam_ref], reads_per_range=SAM_READS).read_batches(sam_ref):
            f.writelines(
                f"r{n + i}\t0\t{sam_ref.contig}\t{a + 1}\t60\t{b}M\t*\t0\t0\t"
                f"{'A' * b}\t*\n" for i, (a, b) in enumerate(
                    zip(st.tolist(), ln.tolist())))
            n += len(st)
    sam_write_s = time.perf_counter() - t0
    for label, extra in (("synthetic", ["--reads-per-range",
                                        str(SAM_READS)]),
                         ("sam", ["--reads-source", "sam", "--path", sam])):
        keeping(coverage, "coverage", kept)
        try:
            c, _, _ = run_counted(cli_main, ["coverage", "--references",
                                             SAM_RANGE, "--device", DEVICE]
                                  + extra, launch_counters)
        finally:
            coverage.coverage = original
        if c["packed_gram"] or c["braycurtis"]:
            fail(f"coverage ({label}) launched a kernel: {c}")
    sam_res, syn_res = kept.pop()[0], kept.pop()[0]
    if sam_res.depth.tobytes() != syn_res.depth.tobytes() or \
            sam_res.n_reads != SAM_READS:
        fail("coverage: the SAM file's depth differs from its reads'")
    if cov_counts["packed_gram"] or cov_counts["braycurtis"]:
        fail(f"coverage launched a kernel: {cov_counts}")
    paths["coverage"] = cov_counts
    print(f"coverage {COVERAGE_RANGE} ({span / 1e6:.0f} Mb), "
          f"{COVERAGE_READS} synthetic reads of 150 bp [{card}]: wall "
          f"{cov_wall:.3f} s; mean depth {mean_depth:.2f}, max {max_depth}; "
          f"depth bitwise equal to NumPy's bincount/cumsum "
          f"({oracle_s:.3f} s); a SAM file of {SAM_READS} reads on "
          f"{SAM_RANGE} (written in {sam_write_s:.3f} s, "
          f"{os.path.getsize(sam) / 1e6:.1f} MB) gives the same depth as its "
          f"reads; launches {cov_counts}; {cov_out.strip().splitlines()[0]}")
    os.remove(sam)

    # -- 35. neighbors: MinHash pass, LSH, exact evaluation ------------------
    captured = []
    stream = engine._pair_stats_stream

    def keeping_stream(job, src, timer, pairs, stats):
        acc = stream(job, src, timer, pairs, stats)
        captured.append((pairs, acc))
        return acc

    nb = os.path.join(tmp, "nb.topk")
    telemetry.reset()
    engine._pair_stats_stream = keeping_stream
    try:
        nb_counts, nb_t, nb_out, nb_wall = run_job(
            cli_main, ["neighbors"] + store_args + ["--metric", "ibs"],
            launch_counters, nb)
    finally:
        engine._pair_stats_stream = stream
    n_cand = int(telemetry.counter_value("neighbors.candidate_pairs"))
    frac = telemetry.metrics_snapshot()["gauges"]["neighbors.filter_frac"][
        "last"]
    pairs, acc = captured.pop()
    sims = np.asarray(kernels.get("ibs").pair.sim(acc), np.float64)
    stats = gram.combine(synthetic_acc, "ibs")
    ii, jj = pairs[:, 0], pairs[:, 1]
    want_sims = kernels.get("ibs").pair.sim(
        {k: stats[k].numpy()[ii, jj].astype(np.int64) for k in ("m", "d1")})
    f32 = distances.finalize(synthetic_acc, "ibs")["similarity"].numpy()
    f32_err = float(np.abs(sims - f32[ii, jj]).max())
    digest = sha256_of(nb)
    res = load_result(nb, expect_kind="topk")
    checks = {
        "K1 launches == 0": nb_counts["packed_gram"] == 0,
        f"candidate pairs == {JAX_CANDIDATE_PAIRS} (JAX)":
            n_cand == len(pairs) == JAX_CANDIDATE_PAIRS,
        "top-k file sha256 == JAX's": digest == JAX_TOPK_SHA256,
        "evaluated sims bitwise == f64 finalize of phase 6's accumulators":
            sims.tobytes() == np.asarray(want_sims, np.float64).tobytes(),
        "within 1e-6 of phase 6's f32 similarity": f32_err <= 1e-6,
        "k 10": res.k == 10 and res.ids.shape == (N_SAMPLES, 10),
    }
    short_rows = int((res.ids < 0).any(axis=1).sum())
    del stats, f32, acc
    # A kill during the MinHash pass, then a resume through the CLI.
    ck = os.path.join(tmp, "ck_neighbors")
    killed = JobConfig(
        ingest=IngestConfig(source="packed", path=store,
                            block_variants=BLOCK_VARIANTS),
        compute=ComputeConfig(metric="ibs", device=DEVICE, checkpoint_dir=ck,
                              checkpoint_every_blocks=CKPT_EVERY_BLOCKS))
    for mod in launch_counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    try:
        engine.neighbors_job(killed, source=DyingSource(
            load_packed(store), NEIGHBORS_KILL_AT_BLOCK))
    except RuntimeError as err:
        if "simulated preemption" not in str(err):
            raise
    else:
        fail("the dying source did not stop the neighbors job")
    kill_wall = time.perf_counter() - t0
    gens = (manifest_cursor(ck + ".old"), manifest_cursor(ck))
    nb2 = os.path.join(tmp, "nb_resumed.topk")
    rs_counts, rs_t, _, rs_wall = run_job(
        cli_main, ["neighbors"] + store_args
        + ["--metric", "ibs", "--checkpoint-dir", ck], launch_counters, nb2)
    want_gens = (CKPT_EVERY_BLOCKS * BLOCK_VARIANTS,
                 2 * CKPT_EVERY_BLOCKS * BLOCK_VARIANTS)
    checks[f"killed: generations at {want_gens}"] = gens == want_gens
    checks["resumed file byte-identical"] = sha256_of(nb2) == digest
    checks["resume: K1 launches == 0"] = rs_counts["packed_gram"] == 0
    paths["neighbors"] = nb_counts
    paths["neighbors resumed"] = rs_counts
    print(f"neighbors --metric ibs from the packed store, {N_SAMPLES} x "
          f"{N_VARIANTS}, 128 hashes, 32 bands, k 10 [{card}]: wall "
          f"{nb_wall:.3f} s; phases: "
          + phases_line(nb_t, ("ingest_setup", "gram", "lsh",
                               "neighbors_eval", "write"))
          + f"; {n_cand} candidate pairs of {N_SAMPLES * (N_SAMPLES - 1) // 2}"
          f", filter_frac {frac:.6f}, "
          f"{int(telemetry.counter_value('neighbors.bucket_overflows'))} "
          f"bucket overflows; {short_rows} samples with fewer than 10 "
          f"candidates; neighbors_eval {nb_t['neighbors_eval']:.3f} s; "
          f"sha256 {digest}; evaluated sims vs phase 6's f32 similarity: max "
          f"|diff| {f32_err:.3g}; launches {nb_counts}; killed at block "
          f"{NEIGHBORS_KILL_AT_BLOCK + 1} in {kill_wall:.3f} s (generations "
          f"{gens}), resumed through the CLI in {rs_wall:.3f} s ("
          + phases_line(rs_t, ("gram", "lsh", "neighbors_eval"))
          + f", launches {rs_counts}); "
          + ", ".join(f"{k}: {'ok' if v else 'FAILED'}"
                      for k, v in checks.items()))
    if not all(checks.values()):
        fail("neighbors: " + ", ".join(k for k, v in checks.items() if not v))
    print(f"phases 32-35 took {time.perf_counter() - phases_t0:.1f} s "
          f"[{card}]")
    return paths


# Phase 38: the loadgen's clients x requests (each of the 500 new samples
# once) and the rows held bitwise against a single-sample CLI `project`.
LOADGEN_CLIENTS = 4
LOADGEN_REQUESTS = 125
SINGLE_ROWS = 16
# Phase 39: samples POSTed to the HTTP front, and its bind timeout.
HTTP_SAMPLES = 32
HTTP_BIND_TIMEOUT_S = 300
# Served coordinates against the 500-row offline `project` (another
# matrix shape, so another summation order): the tolerance the port
# holds between the packages' projections.
SERVE_RTOL = 1e-5
# The JAX package's CPU run of `neighbors --model` on phase 30's cohort
# against phase 29's panel (the same genotypes, ids and planted copies;
# the similarities depend only on the genotypes and the model's metric):
#   JAX_PLATFORMS=cpu python -c "import numpy as np; \
#     from spark_examples_tpu.ingest.synthetic import SyntheticSource; \
#     from spark_examples_tpu.ingest.packed import save_packed; \
#     s = SyntheticSource(n_samples=2504, n_variants=100000); \
#     g = np.concatenate([b for b, _ in s.blocks(16384)], axis=1); \
#     save_packed('panel', g[:2004], s.sample_ids[:2004]); \
#     d = g[2004:].copy(); d[:10] = g[np.arange(10) * 200]; \
#     save_packed('new_dup', d, [f'DUP{i}' for i in range(500)])"
#   JAX_PLATFORMS=cpu python -m spark_examples_tpu pcoa --source packed \
#     --path panel --metric ibs --num-pc 10 --block-variants 8192 \
#     --save-model m.npz
#   JAX_PLATFORMS=cpu python -m spark_examples_tpu neighbors --model m.npz \
#     --ref-source packed --ref-path panel --source packed --path new_dup \
#     --block-variants 8192 --neighbors-k 10 --output-path nb.topk
#   sha256sum nb.topk
JAX_MODEL_TOPK_SHA256 = ("65e3775a68e3100d214f8f6428d84ced"
                         "a3f4ae4713d2b798e0997143a87622f3")


def union_seconds(spans, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def http_json(url: str, body: bytes | None = None, headers=None,
              timeout: float = 60.0):
    """(parsed JSON or text, response headers) of one request."""
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
        hdrs = dict(r.headers)
    if hdrs.get("Content-Type", "").startswith("application/json"):
        return json.loads(raw), hdrs
    return raw.decode(), hdrs


def traced_gram_phase(cli_main, launch_counters: dict, card: str,
                      files: dict, tmp: str, k1_ms: float,
                      k1_names: list) -> dict:
    """Phase 37: the packed-store gram job with the telemetry export,
    then also under a torch.profiler capture. Returns the launches by
    kernel of each run, by path name."""
    from spark_examples_tpu_torch.core import telemetry

    paths = {}

    # -- 37. a traced gram job --------------------------------------------
    if not k1_names:
        fail("phase 37 needs K1's kernel names from its SASS (phase 2), "
             "and none were read")
    store = files["packed_store"]
    argv = ["pcoa", "--source", "packed", "--path", store, "--metric",
            "ibs", "--num-pc", str(NUM_PC), "--block-variants",
            str(BLOCK_VARIANTS), "--device", DEVICE]
    runs = {}
    for label, extra in (("telemetry", ["--telemetry-dir",
                                        os.path.join(tmp, "tel37a")]),
                         ("traced", ["--telemetry-dir",
                                     os.path.join(tmp, "tel37"),
                                     "--trace-dir",
                                     os.path.join(tmp, "prof37")])):
        telemetry.reset()
        try:
            runs[label] = run_cli(cli_main, argv + extra, launch_counters,
                                  NUM_PC)
        finally:
            telemetry.configure(dir=None)
            telemetry.reset()
        paths[f"pcoa --source packed, {label}"] = runs[label][0]
    counts, timings, coords, wall = runs["traced"]
    d = os.path.join(tmp, "tel37", "rank0")
    events = [json.loads(line) for line in open(os.path.join(
        d, "trace.jsonl"))]
    spans = [e["name"] for e in events if e["ph"] == "X"]
    metrics = json.load(open(os.path.join(d, "metrics.json")))
    hists, gauges = metrics["histograms"], metrics["gauges"]
    prof = json.load(open(os.path.join(tmp, "prof37", "trace_rank0.json")))
    pevents = [e for e in prof["traceEvents"] if e.get("ph") == "X"]
    windows = [e for e in pevents if e.get("cat") == "user_annotation"
               and e.get("name") == "phase.gram"]
    k1_events = [e for e in pevents if e.get("cat") == "kernel"
                 and any(n in e.get("name", "") for n in k1_names)]
    device_spans = [(e["ts"], e["ts"] + e["dur"]) for e in pevents
                    if e.get("cat") in ("kernel", "gpu_memcpy",
                                        "gpu_memset")]
    kernel_spans = [(e["ts"], e["ts"] + e["dur"]) for e in pevents
                    if e.get("cat") == "kernel"]
    n_blocks = -(-N_VARIANTS // BLOCK_VARIANTS)
    checks = {
        f"K1 launches == {n_blocks}": counts["packed_gram"] == n_blocks,
        "coords bitwise == phase 14's untraced run":
            np.array_equal(coords, files["packed_store_coords"]),
        "1 phase.gram span": spans.count("phase.gram") == 1,
        f"{n_blocks} gram.block spans": spans.count("gram.block") == n_blocks,
        "prefetch waits exported": all(
            hists.get(f"prefetch.{h}", {}).get("count") == n_blocks
            for h in ("get_wait_s", "put_wait_s", "stage_wait_s"))
            and hists.get("prefetch.transfer_wait_s", {}).get("count", 0) > 0
            and "prefetch.queue_depth" in gauges,
        "gram.lowering == 1 (fused)":
            gauges.get("gram.lowering", {}).get("last") == 1.0,
        f"{n_blocks} K1 kernel events in the profiler trace":
            len(k1_events) == n_blocks,
        "one phase.gram range in the profiler trace": len(windows) == 1,
    }
    if not all(checks.values()):
        fail("traced gram job: " + ", ".join(
            k for k, v in checks.items() if not v))
    w = windows[0]
    lo, hi = w["ts"], w["ts"] + w["dur"]
    busy = union_seconds(device_spans, lo, hi) / (hi - lo)
    kbusy = union_seconds(kernel_spans, lo, hi) / (hi - lo)
    k1_sum_ms = sum(e["dur"] for e in k1_events) / 1e3
    base_gram = files["packed_store_gram_s"]
    print(f"traced gram job: pcoa --source packed --telemetry-dir "
          f"--trace-dir, {N_SAMPLES} x {N_VARIANTS} ibs [{card}]: wall "
          f"{wall:.3f} s; gram {timings['gram']:.4f} s traced vs "
          f"{runs['telemetry'][1]['gram']:.4f} s with telemetry only and "
          f"{base_gram:.4f} s untraced (phase 14); launches {counts}; "
          f"{len(k1_events)} K1 events ({', '.join(k1_names)}) in the "
          f"torch.profiler trace, {k1_sum_ms:.4f} ms summed "
          f"({k1_sum_ms / len(k1_events):.4f} ms each; phase 4's CUDA "
          f"events: {k1_ms:.4f} ms); phase.gram window "
          f"{(hi - lo) / 1e3:.3f} ms: device busy {busy:.4f} (kernels "
          f"{kbusy:.4f}), idle {1.0 - busy:.4f}; gram.block p50/p95 "
          f"{hists['gram.block']['p50'] * 1e3:.3f} / "
          f"{hists['gram.block']['p95'] * 1e3:.3f} ms; prefetch get-wait "
          f"sum {hists['prefetch.get_wait_s']['sum']:.4f} s (stall "
          f"fraction "
          f"{telemetry.stall_fraction(metrics['phases'], hists['prefetch.get_wait_s']['sum']):.4f}), "
          f"transfer-wait sum {hists['prefetch.transfer_wait_s']['sum']:.4f}"
          f" s; trace.jsonl {len(events)} events, profiler trace "
          f"{os.path.getsize(os.path.join(tmp, 'prof37', 'trace_rank0.json'))}"
          f" bytes; " + ", ".join(f"{k}: ok" for k in checks))
    return paths


def serving_phases(cli_main, launch_counters: dict, card: str, dev,
                   files: dict, tmp: str) -> dict:
    """Phases 38-40: served projections in-process (the CLI loadgen,
    then ProjectionServer under three models), the HTTP front in a
    subprocess, and ``neighbors --model``. Returns the launches by kernel
    of each in-process run, by path name."""
    import concurrent.futures

    import torch

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.ingest.packed import (
        load_packed,
        save_packed,
    )
    from spark_examples_tpu_torch.neighbors import load_result
    from spark_examples_tpu_torch.pipelines import project as P
    from spark_examples_tpu_torch.serve import (
        ProjectionEngine,
        ProjectionServer,
    )

    paths = {}

    # -- 38. served projections, in-process -------------------------------
    proj = files["projection"]
    panel_d, new_d = proj["panel"], proj["new"]
    models = proj["models"]
    new_src = load_packed(new_d)
    new_rows = np.concatenate(
        [np.array(b) for b, _ in new_src.blocks(BLOCK_VARIANTS)], axis=1)
    new_ids = list(new_src.sample_ids)
    n_new = len(new_rows)
    pcoa_model = models["pcoa"]["model"]
    serve_common = ["--ref-source", "packed", "--ref-path", panel_d,
                    "--block-variants", str(BLOCK_VARIANTS), "--device",
                    DEVICE]
    telemetry.reset()
    lg_counts, lg_out, lg_wall = run_counted(
        cli_main, ["serve", "--model", pcoa_model, "--source", "packed",
                   "--path", new_d, "--loadgen", str(LOADGEN_CLIENTS),
                   "--loadgen-requests", str(LOADGEN_REQUESTS),
                   "--cache-entries", "0"] + serve_common, launch_counters)
    report = json.loads(lg_out.strip().splitlines()[-1])
    lat = telemetry.metrics_snapshot()["histograms"]["serve.latency_s"]
    rows_h = telemetry.metrics_snapshot()["histograms"]["serve.batch_rows"]
    paths["serve --loadgen"] = lg_counts
    lg_checks = {
        f"{n_new} answers": report["completed"] == n_new == lat["count"],
        "0 errors": report["errors"] == 0 and report["deadline_expired"] == 0,
        "0 sheds": report["shed"] == 0,
        "K1 launches == 0": lg_counts["packed_gram"] == 0,
    }
    if not all(lg_checks.values()):
        fail(f"serve --loadgen: {report}, launches {lg_counts}")
    print(f"serve --loadgen {LOADGEN_CLIENTS} x {LOADGEN_REQUESTS}, pcoa "
          f"model, {n_new} new samples against the {PANEL_SAMPLES}-sample "
          f"panel, max_batch 8 [{card}]: wall {lg_wall:.3f} s (staging "
          f"included); sustained {report['sustained_qps']} QPS over "
          f"{report['duration_s']} s; latency p50 / p95 / p99 "
          f"{lat['p50'] * 1e3:.3f} / {lat['p95'] * 1e3:.3f} / "
          f"{lat['p99'] * 1e3:.3f} ms (max {lat['max'] * 1e3:.3f}); "
          f"{report['server']['batches']} batches, "
          f"{rows_h['mean']:.2f} rows each; launches {lg_counts}; "
          + ", ".join(f"{k}: ok" for k in lg_checks))
    telemetry.reset()

    singles = np.linspace(0, n_new - 1, SINGLE_ROWS).astype(int)
    single_dirs = {}
    for i in singles:
        single_dirs[i] = os.path.join(tmp, f"single{i}")
        save_packed(single_dirs[i], new_rows[i:i + 1], [new_ids[i]])
    served = {}
    lines = []
    for name in ("pcoa", "pca", "pcoa corrected"):
        m = models[name]
        for mod in launch_counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        engine = ProjectionEngine(m["model"], load_packed(panel_d),
                                  block_variants=BLOCK_VARIANTS,
                                  max_batch=8, device=DEVICE)
        stage_s = time.perf_counter() - t0
        server = ProjectionServer(engine, max_queue=n_new,
                                  cache_entries=0).start()
        try:
            t0 = time.perf_counter()
            futs = [server.submit(q) for q in new_rows]
            rows = np.concatenate([f.result(timeout=600) for f in futs])
            serve_s = time.perf_counter() - t0
            batches = server.stats.snapshot()["batches"]
        finally:
            server.close()
        launches = {k: mod.launches for k, mod in launch_counters.items()}
        paths[f"ProjectionServer {name}"] = launches
        served[name] = rows
        want = m["new_coords"]
        rel = float(np.abs(rows - want).max() / np.abs(want).max())
        hits = nearest_centroid_hits(rows, proj["new_pops"],
                                     m["fit_coords"], proj["panel_pops"])
        bitwise = 0
        for i in singles:
            kept = []
            orig = keeping(P, "pcoa_project_job", kept)
            try:
                one_counts, _out, _w = run_counted(
                    cli_main, ["project", "--model", m["model"], "--source",
                               "packed", "--path", single_dirs[i]]
                    + serve_common, launch_counters)
            finally:
                P.pcoa_project_job = orig
            if any(one_counts.values()):
                fail(f"single-sample project ({name}): launches "
                     f"{one_counts}")
            bitwise += int(np.array_equal(kept[-1].coords, rows[i:i + 1]))
        ok = {
            "K1 launches == 0": not any(launches.values()),
            f"{n_new}/{n_new} nearest their population": hits == n_new,
            f"{SINGLE_ROWS} rows bitwise == single-sample CLI project":
                bitwise == SINGLE_ROWS,
            f"within {SERVE_RTOL} of max|coords| of phase 29's project":
                rel <= SERVE_RTOL,
        }
        if not all(ok.values()):
            fail(f"served {name}: hits {hits}, bitwise {bitwise}/"
                 f"{SINGLE_ROWS}, max |diff| / max|coords| {rel:.3g}, "
                 f"launches {launches}")
        lines.append(f"{name} ({m['kind']} model): staged in {stage_s:.3f} "
                     f"s, {n_new} rows in {serve_s:.3f} s ({batches} "
                     f"batches), max |diff| / max|coords| vs phase 29 "
                     f"{rel:.3g}, {bitwise}/{SINGLE_ROWS} rows bitwise")
    print(f"ProjectionServer over the card's engine [{card}]: "
          + "; ".join(lines) + f"; every new sample nearest its "
          "population's centroid; 0 K1 launches")
    files["served"] = served

    # -- 39. HTTP: the serve CLI as a process -------------------------------
    d2 = os.path.join(tmp, "tel39")
    port_file = os.path.join(tmp, "port39.json")
    log_out = open(os.path.join(tmp, "serve39.out"), "w")
    log_err = open(os.path.join(tmp, "serve39.err"), "w+")
    cmd = [sys.executable, "-m", "spark_examples_tpu_torch", "serve",
           "--model", pcoa_model, "--port", "0", "--port-file", port_file,
           "--telemetry-dir", d2] + serve_common
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=log_out, stderr=log_err)
    try:
        while not os.path.exists(port_file):
            if proc.poll() is not None:
                log_err.seek(0)
                fail(f"serve exited {proc.returncode} before binding: "
                     f"{log_err.read()[-2000:]}")
            if time.perf_counter() - t0 > HTTP_BIND_TIMEOUT_S:
                fail("serve did not bind within "
                     f"{HTTP_BIND_TIMEOUT_S} s")
            time.sleep(0.05)
        bind_s = time.perf_counter() - t0
        base = f"http://127.0.0.1:{json.load(open(port_file))['port']}"
        want_rows = served["pcoa"]

        def post(i):
            tid = f"chipsmoke{i:07d}"
            out, hdrs = http_json(
                f"{base}/project",
                json.dumps({"genotypes": new_rows[i].tolist()}).encode(),
                headers={"X-Trace-Id": tid}, timeout=120)
            return i, tid, out, hdrs

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(
                8, thread_name_prefix="chip-smoke-http") as pool:
            answers = list(pool.map(post, range(HTTP_SAMPLES)))
        http_s = time.perf_counter() - t0
        echoed = all(h.get("X-Trace-Id") == tid for _i, tid, _o, h in answers)
        same = all(np.array_equal(np.asarray(o["coords"], np.float32),
                                  want_rows[i:i + 1])
                   for i, _t, o, _h in answers)
        health, _ = http_json(f"{base}/healthz")
        ready, _ = http_json(f"{base}/readyz")
        stats, _ = http_json(f"{base}/stats")
        prom, _ = http_json(f"{base}/metrics")
        recent, _ = http_json(f"{base}/debug/requests")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log_out.close()
    log_err.seek(0)
    err_text = log_err.read()
    log_err.close()
    exported = json.load(open(os.path.join(d2, "rank0", "metrics.json")))
    http_checks = {
        "X-Trace-Id echoed": echoed,
        "answers bitwise == phase 38's rows": same,
        "/healthz healthy": health.get("status") == "healthy",
        "/readyz ready": ready.get("ready") is True,
        f"/stats completed == {HTTP_SAMPLES}":
            stats.get("completed") == HTTP_SAMPLES,
        "/metrics serve.* series":
            f"serve_requests_total {float(HTTP_SAMPLES)}" in prom
            and f"serve_latency_s_count {HTTP_SAMPLES}" in prom,
        "/debug/requests exemplars":
            len(recent.get("exemplars", [])) == HTTP_SAMPLES,
        "SIGTERM: drained, exit 0": rc == 0 and "draining..." in err_text,
        f"exported serve.latency_s count == {HTTP_SAMPLES}":
            exported["histograms"]["serve.latency_s"]["count"]
            == HTTP_SAMPLES
            and exported["counters"]["serve.requests"] == HTTP_SAMPLES,
    }
    if not all(http_checks.values()):
        fail("serve over HTTP: " + ", ".join(
            k for k, v in http_checks.items() if not v)
             + f"; stderr: {err_text[-2000:]}")
    elat = exported["histograms"]["serve.latency_s"]
    print(f"serve over HTTP (subprocess, --port 0) [{card}]: bound in "
          f"{bind_s:.3f} s; {HTTP_SAMPLES} POST /project from 8 threads in "
          f"{http_s:.3f} s; server latency p50 / p99 "
          f"{elat['p50'] * 1e3:.3f} / {elat['p99'] * 1e3:.3f} ms, "
          f"batch rows mean "
          f"{exported['histograms']['serve.batch_rows']['mean']:.2f}; "
          + ", ".join(f"{k}: ok" for k in http_checks))

    # -- 40. neighbors --model -------------------------------------------
    dup_d = proj["dup"]
    planted = proj["planted"]
    nb = os.path.join(tmp, "nb_model.topk")
    nb_counts, nb_t, _out, nb_wall = run_job(
        cli_main, ["neighbors", "--model", pcoa_model, "--source", "packed",
                   "--path", dup_d, "--neighbors-k", "10"] + serve_common,
        launch_counters, nb)
    paths["neighbors --model"] = nb_counts
    res = load_result(nb, expect_kind="topk")
    spec = kernels.get("ibs").pair
    acc = {k: torch.zeros((n_new, PANEL_SAMPLES), dtype=torch.int32,
                          device=dev) for k in spec.stats}
    for (bn, _mn), (br, _mr) in zip(
            load_packed(dup_d).blocks(BLOCK_VARIANTS),
            load_packed(panel_d).blocks(BLOCK_VARIANTS)):
        P.update_cross(acc, torch.from_numpy(np.array(bn)).to(dev),
                       torch.from_numpy(np.array(br)).to(dev))
    full = np.asarray(spec.sim({k: v.cpu().numpy().astype(np.int64)
                                for k, v in acc.items()}), np.float64)
    digest = sha256_of(nb)
    nb_checks = {
        "K1 launches == 0": nb_counts["packed_gram"] == 0,
        "planted copies' top-1 = panel twin at 1.0": all(
            res.ids[i, 0] == planted[i] and res.sims[i, 0] == 1.0
            for i in range(PLANTED_COPIES)),
        "sims bitwise == the ibs pair finalize of the cross stats":
            np.take_along_axis(full, res.ids.astype(np.int64), 1).tobytes()
            == res.sims.tobytes(),
        "sha256 == the JAX package's": digest == JAX_MODEL_TOPK_SHA256,
        "k 10": res.ids.shape == (n_new, 10),
    }
    if not all(nb_checks.values()):
        fail("neighbors --model: " + ", ".join(
            k for k, v in nb_checks.items() if not v) + f"; sha256 {digest}")
    print(f"neighbors --model (pcoa ibs), {n_new} queries with "
          f"{PLANTED_COPIES} planted copies against the {PANEL_SAMPLES}-"
          f"sample panel, k 10 [{card}]: wall {nb_wall:.3f} s; phases: "
          + phases_line(nb_t, ("stage", "neighbors_eval", "write"))
          + f"; sha256 {digest}; launches {nb_counts}; "
          + ", ".join(f"{k}: ok" for k in nb_checks))
    del acc, full
    return paths


# Phases 41-42: the supervised ibs job over phase 14's store, killed at
# phase 23's block (the 11th block read; checkpoints every 4 blocks),
# then stalled by a block read that sleeps far past the watchdog's
# --supervise-stall-timeout.
KILL_AFTER_READS = 10
SUPERVISED_KILL = f"ingest.block_read:kill:after={KILL_AFTER_READS}:max=1"
STALL_AFTER_READS = 6
STALL_DELAY_S = 120
STALL_TIMEOUT_S = 5
SUPERVISED_TIMEOUT_S = 600
# Phases 43-44: the fleet over phase 29's panel, one route per model of
# phase 38, a budget of 2.5 staged panels (serving all three evicts).
FLEET_ROUTES = (("pcoa", "pcoa", True), ("pca", "pca", False),
                ("factorized", "pcoa corrected", False))
FLEET_BUDGET_PANELS = 2.5
FLEET_SAMPLES = 16
FLEET_TOPK = 10
FLEET_LOADGEN_CLIENTS = 2
FLEET_LOADGEN_REQUESTS = 10
# The hedging runs of tests/test_fleet.py: 2 clients x 6 requests, fewer
# than the 20 completions after which the hedge delay becomes the
# rolling p95 (each request then hedges at the floor).
HEDGE_CLIENTS = 2
HEDGE_REQUESTS = 6
HEDGE_SLOW_LINGER_MS = 120.0
HEDGE_FLOOR_S = 0.02


def compute_apps() -> int:
    """The number of processes holding a context on the card. In this
    container ``nvidia-smi`` cannot map them to our pids (it reports
    pid 1 for each), so the supervised parent is checked by count."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return len([line for line in out.splitlines() if line.strip()])


def built_kernels() -> dict:
    from spark_examples_tpu_torch.ops import cuda_build

    return {p.name: p.stat().st_mtime_ns
            for p in cuda_build.BUILD_DIR.glob("*.so")}


def run_supervised(argv: list[str], fault_spec: str, tmp: str,
                   name: str) -> dict:
    """``argv`` (a CLI job) with ``--supervise`` as a subprocess, the
    fault armed through the environment, the card's compute processes
    counted every 0.25 s while it runs. Returns the parent's rc, stderr,
    wall, the counts seen and the supervisor ledger."""
    env = dict(os.environ, SPARK_EXAMPLES_TPU_FAULTS=fault_spec)
    err_path = os.path.join(tmp, f"{name}.err")
    before = compute_apps()
    counts = []
    with open(err_path, "w+") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_examples_tpu_torch", *argv,
             "--supervise"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.DEVNULL, stderr=err)
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > SUPERVISED_TIMEOUT_S:
                    fail(f"{name}: the supervised job ran past "
                         f"{SUPERVISED_TIMEOUT_S} s")
                counts.append(compute_apps())
                time.sleep(0.25)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        wall = time.perf_counter() - t0
        err.seek(0)
        text = err.read()
    return {"rc": proc.returncode, "stderr": text, "wall": wall,
            "apps_before": before, "apps": counts}


def stitched(cli_main, tel: str) -> tuple[dict, list[dict]]:
    """``telemetry stitch`` of ``tel`` through the CLI: (report, the
    stitched trace's events)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli_main(["telemetry", "stitch", "--path", tel])
    if rc != 0:
        fail(f"telemetry stitch --path {tel}: exit {rc}")
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    events = [json.loads(line) for line in open(report["output"])
              if line.strip()]
    return report, events


def attempt_counts(tel: str) -> tuple[dict, dict, dict]:
    """The ``metrics.json`` of attempts 0 and 1 under the telemetry
    directory ``tel``, and from each attempt's own: K1's launches
    (``kernel.packed_gram.launches``, counted where K1's wrapper
    launches it) and its ``gram.block`` spans."""
    metrics = {a: json.load(open(os.path.join(
        tel, f"attempt{a}", "rank0", "metrics.json"))) for a in (0, 1)}
    k1 = {a: int(m["counters"].get("kernel.packed_gram.launches", 0))
          for a, m in metrics.items()}
    blocks = {a: m["histograms"].get("gram.block", {}).get("count", 0)
              for a, m in metrics.items()}
    return metrics, k1, blocks


def attempt_paths(verdict: str, k1: dict, exact0: bool) -> dict:
    """The ``launches_by_path`` entries of one supervised job: each
    attempt's K1 launches as it exported them, attempt 0's named a
    lower bound unless it exported at its end. K2's wrapper exports no
    count, so a child's K2 launches are not listed."""
    first = ("attempt 0" if exact0
             else "attempt 0, at least (its last live flush)")
    return {f"similarity ibs --supervise, {verdict}: {first}":
            {"packed_gram": k1[0]},
            f"similarity ibs --supervise, {verdict}: attempt 1":
            {"packed_gram": k1[1]}}


def supervised_phases(cli_main, launch_counters: dict, card: str,
                      files: dict, tmp: str) -> dict:
    """Phases 41-42: a supervised ibs job killed at phase 23's block and
    one stalled, each restarted by the watchdog and resumed from its
    checkpoint to the uninterrupted run's bytes. Returns K1's launches
    in each attempt as that attempt's own ``metrics.json`` exports them
    (``kernel.packed_gram.launches``, counted where K1 launches):
    exact for an attempt that exported at its end (attempt 1; a child
    that died by TERM), a lower bound for one that died by
    ``os._exit`` or KILL, whose last export is its last live flush."""
    paths = {}
    argv = ["similarity", "--metric", "ibs", "--source", "packed", "--path",
            files["packed_store"], "--block-variants", str(BLOCK_VARIANTS),
            "--device", DEVICE]
    clean = os.path.join(tmp, "sup_clean.npy")
    clean_counts, _t, _o, clean_wall = run_job(cli_main, argv,
                                               launch_counters, clean)
    expected = math.ceil(N_VARIANTS / BLOCK_VARIANTS)
    if clean_counts["packed_gram"] != expected:
        fail(f"the unsupervised ibs job launched K1 "
             f"{clean_counts['packed_gram']} times, expected {expected}")
    want = open(clean, "rb").read()
    kernels_before = built_kernels()

    # -- 41. killed at the 11th block read ---------------------------------
    tel = os.path.join(tmp, "tel41")
    out = os.path.join(tmp, "sup41.npy")
    job = argv + ["--checkpoint-dir", os.path.join(tmp, "ck41"),
                  "--checkpoint-every-blocks", str(CKPT_EVERY_BLOCKS),
                  "--telemetry-dir", tel, "--telemetry-flush-s", "0.05",
                  "--output-path", out]
    run = run_supervised(job, SUPERVISED_KILL, tmp, "sup41")
    ledger = json.load(open(os.path.join(tel, "supervisor.json")))
    report, events = stitched(cli_main, tel)
    tracks = sorted(e["args"]["name"] for e in events
                    if e.get("name") == "process_name")
    metrics, k1, blocks = attempt_counts(tel)
    crash_t = ledger["incidents"][0]["t_unix"] if ledger["incidents"] else 0
    a1_first = min((e["ts"] for e in events if e.get("name") == "gram.block"
                    and e["pid"] == 10_000), default=None)
    epoch0 = min(m["meta"]["epoch_unix_s"] for m in metrics.values())
    restart_s = (epoch0 + a1_first / 1e6 - crash_t
                 if a1_first is not None else float("nan"))
    checks = {
        "rc 0": run["rc"] == 0,
        "attempt 0: crash: exit code 113":
            "supervisor: attempt 0: crash: exit code 113" in run["stderr"],
        ".npy bytes == the unsupervised run's": open(out, "rb").read()
        == want,
        "supervisor.json: 1 restart": ledger["restarts"] == 1
        and ledger["done"] and ledger["final_returncode"] == 0,
        "stitch: tracks attempt 0 rank 0, attempt 1 rank 0, supervisor":
            tracks == ["attempt 0 rank 0", "attempt 1 rank 0", "supervisor"],
        "stitch: 1 restart marker": report["restart_markers"] == 1
        and not report["mixed_run_ids"],
        "K1 ran in both attempts (their exported launches)":
            k1[0] >= 1 and k1[1] >= 1,
        "attempt 0 launched K1 at most once a block read before the kill":
            k1[0] <= KILL_AFTER_READS,
        "attempt 1: one K1 launch a gram.block": k1[1] == blocks[1],
        "attempt 1 resumed from a checkpoint generation":
            0 < blocks[1] < expected
            and (expected - blocks[1]) % CKPT_EVERY_BLOCKS == 0,
        "the parent held no context (never more than this script + 1 "
        "child on the card)": max(run["apps"], default=0)
        <= run["apps_before"] + 1,
        "the child was seen on the card": max(run["apps"], default=0)
        == run["apps_before"] + 1,
        "the kernels were loaded from _build/, not rebuilt":
            built_kernels() == kernels_before,
    }
    if not all(checks.values()):
        fail("supervised kill: " + ", ".join(
            k for k, v in checks.items() if not v)
             + f"; K1 {k1}; blocks {blocks}; tracks {tracks}; stderr "
             f"{run['stderr'][-2000:]}")
    paths.update(attempt_paths("killed", k1, exact0=False))
    print(f"supervised similarity ibs, killed at block read "
          f"{KILL_AFTER_READS + 1} [{card}]: wall {run['wall']:.3f} s "
          f"(unsupervised, in this process: {clean_wall:.3f} s); K1 "
          f"launches attempt 0 at least {k1[0]} (its last live flush "
          f"before os._exit; {blocks[0]} gram.block spans), attempt 1 "
          f"{k1[1]} from the checkpoint at {expected - blocks[1]} blocks "
          f"(phase 23's in-process kill: 5 from 8); restart "
          f"to attempt 1's first block {restart_s:.3f} s (child start, "
          f"CUDA context, kernels loaded from _build/); stitched "
          f"{report['events']} events; compute processes on the card "
          f"{run['apps_before']} before, at most {max(run['apps'])} during; "
          + ", ".join(f"{k}: ok" for k in checks))

    # -- 42. a stalled block read ---------------------------------------------
    tel = os.path.join(tmp, "tel42")
    out = os.path.join(tmp, "sup42.npy")
    job = argv + ["--checkpoint-dir", os.path.join(tmp, "ck42"),
                  "--checkpoint-every-blocks", str(CKPT_EVERY_BLOCKS),
                  "--telemetry-dir", tel, "--telemetry-flush-s", "0.05",
                  "--supervise-stall-timeout", str(STALL_TIMEOUT_S),
                  "--output-path", out]
    run = run_supervised(
        job, f"ingest.block_read:delay:delay={STALL_DELAY_S}:"
        f"after={STALL_AFTER_READS}:max=1", tmp, "sup42")
    ledger = json.load(open(os.path.join(tel, "supervisor.json")))
    incident = ledger["incidents"][0] if ledger["incidents"] else {}
    _metrics, k1, blocks = attempt_counts(tel)
    termed = incident.get("returncode") == -signal.SIGTERM
    checks = {
        "rc 0": run["rc"] == 0,
        "attempt 0: stall": "supervisor: attempt 0: stall:" in run["stderr"]
        and incident.get("kind") == "stall",
        "1 watchdog kill, 1 restart": ledger["watchdog_kills"] == 1
        and ledger["restarts"] == 1,
        "the child died by TERM or KILL": incident.get("returncode") in
        (-signal.SIGTERM, -signal.SIGKILL),
        ".npy bytes == the unsupervised run's": open(out, "rb").read()
        == want,
        "K1 ran in both attempts (their exported launches)":
            k1[0] >= 1 and k1[1] >= 1,
        "attempt 0 launched K1 at most once a block read before the stall":
            k1[0] <= STALL_AFTER_READS,
        "attempt 1: one K1 launch a gram.block": k1[1] == blocks[1],
        "attempt 1 resumed from a checkpoint generation":
            0 < blocks[1] < expected
            and (expected - blocks[1]) % CKPT_EVERY_BLOCKS == 0,
        "the parent held no context": max(run["apps"], default=0)
        <= run["apps_before"] + 1,
    }
    if not all(checks.values()):
        fail("supervised stall: " + ", ".join(
            k for k, v in checks.items() if not v)
             + f"; K1 {k1}; blocks {blocks}; incident {incident}; stderr "
             f"{run['stderr'][-2000:]}")
    paths.update(attempt_paths("stalled", k1, exact0=termed))
    print(f"supervised similarity ibs, block read {STALL_AFTER_READS + 1} "
          f"stalled {STALL_DELAY_S} s, --supervise-stall-timeout "
          f"{STALL_TIMEOUT_S} [{card}]: wall {run['wall']:.3f} s; verdict "
          f"{incident.get('kind')} ({incident.get('detail')}), child exit "
          f"{incident.get('returncode')}; K1 launches attempt 0 "
          + (f"{k1[0]} (its TERM export" if termed else
             f"at least {k1[0]} (its last live flush before KILL")
          + f"; {blocks[0]} gram.block spans), attempt 1 {k1[1]}; "
          + ", ".join(f"{k}: ok" for k in checks))
    return paths


def fleet_phases(cli_main, launch_counters: dict, card: str, files: dict,
                 tmp: str) -> dict:
    """Phases 43-44: the fleet over phase 29's panel in-process (rows
    bitwise phase 38's, again after a forced evict and restage; the CLI
    loadgen mix; hedging between two routers), then ``serve --fleet``
    over HTTP as a subprocess. Returns the launches by kernel of each
    in-process run."""
    import concurrent.futures

    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.core.config import (
        PRIORITY_CLASSES,
        IngestConfig,
        ServeConfig,
    )
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.serve import (
        FleetManifest,
        build_fleet,
        run_hedged_loadgen,
    )

    paths = {}
    proj = files["projection"]
    served = files["served"]
    new_src = load_packed(proj["new"])
    new_rows = np.concatenate(
        [np.array(b) for b, _ in new_src.blocks(BLOCK_VARIANTS)], axis=1)
    picks = np.linspace(0, len(new_rows) - 1, FLEET_SAMPLES).astype(int)
    panel_bytes = PANEL_SAMPLES * N_VARIANTS  # the pool's int8 charge
    budget = int(FLEET_BUDGET_PANELS * panel_bytes)
    doc = {"budget_mb": budget / 1e6, "block_variants": BLOCK_VARIANTS,
           "routes": [{"name": route,
                       "model": proj["models"][model]["model"],
                       "source": "packed", "path": proj["panel"],
                       **({"topk": True} if topk else {})}
                      for route, model, topk in FLEET_ROUTES]}
    manifest = os.path.join(tmp, "fleet.json")
    # graftlint: disable=atomic-write  # the fleet manifest is this run's input, written once into its scratch directory before any reader exists: no last-good copy to tear
    with open(manifest, "w") as f:
        json.dump(doc, f)

    def fleet_of(**cfg):
        return build_fleet(FleetManifest.parse(doc),
                           ServeConfig(cache_entries=0, **cfg),
                           ingest_defaults=IngestConfig(
                               block_variants=BLOCK_VARIANTS),
                           device=DEVICE)

    # -- 43. in-process -------------------------------------------------------
    telemetry.reset()
    for mod in launch_counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    fleet = fleet_of().start()
    build_s = time.perf_counter() - t0
    rows, topk, timings = {}, {}, {}
    try:
        for route, model, _topk in FLEET_ROUTES:
            t0 = time.perf_counter()
            futs = [fleet.submit(route, new_rows[i]) for i in picks]
            rows[route] = np.concatenate([f.result(timeout=600)
                                          for f in futs])
            timings[route] = time.perf_counter() - t0
            if fleet.pool.resident_bytes() > budget:
                fail(f"fleet pool over budget: "
                     f"{fleet.pool.resident_bytes()} > {budget}")
        charge = {r: fleet.routes[r].panel_bytes_hint for r in fleet.routes}
        for route, _m, has_topk in FLEET_ROUTES:
            if has_topk:
                topk[route] = [fleet.topk(route, new_rows[i], FLEET_TOPK,
                                          timeout=600) for i in picks]
        for route in fleet.routes:
            fleet.pool.evict(route)
        t0 = time.perf_counter()
        again = {route: np.concatenate([
            fleet.project(route, new_rows[i], timeout=600) for i in picks])
            for route, _m, _t in FLEET_ROUTES}
        restage_s = time.perf_counter() - t0
        evictions = telemetry.counter_value("fleet.evictions")
        restages = telemetry.counter_value("fleet.restage_total")
        resident = fleet.pool.resident_bytes()
    finally:
        fleet.close()
    launches = {k: mod.launches for k, mod in launch_counters.items()}
    paths["FleetRouter, 3 routes"] = launches
    checks = {
        f"{FLEET_SAMPLES} rows a route bitwise == phase 38's "
        "ProjectionServer rows": all(
            np.array_equal(rows[r], served[m][picks])
            for r, m, _t in FLEET_ROUTES),
        "again bitwise after a forced evict and restage": all(
            np.array_equal(again[r], rows[r]) for r in rows),
        "the pool charged each panel N_ref x V int8 bytes":
            set(charge.values()) == {panel_bytes},
        "fleet.evictions >= 1": evictions >= 1,
        "fleet.restage_total >= 1": restages >= 1,
        f"resident <= budget ({budget} B)": resident <= budget,
        "K1 launches == 0": not any(launches.values()),
    }
    if not all(checks.values()):
        fail("fleet in-process: " + ", ".join(
            k for k, v in checks.items() if not v)
             + f"; evictions {evictions}, restages {restages}")
    # Phase 47 serves these samples through process replicas.
    files["fleet"] = {"doc": doc, "rows": rows, "queries": new_rows[picks],
                      "budget": budget, "panel_bytes": panel_bytes}
    print(f"FleetRouter in-process, 3 routes over the {PANEL_SAMPLES}-"
          f"sample panel, budget {FLEET_BUDGET_PANELS} panels "
          f"({budget / 1e6:.1f} MB) [{card}]: built in {build_s:.3f} s; "
          f"{FLEET_SAMPLES} rows a route (staging included) "
          + ", ".join(f"{r} {timings[r]:.3f} s" for r in timings)
          + f"; after evicting all three, {3 * FLEET_SAMPLES} rows in "
          f"{restage_s:.3f} s; fleet.evictions {evictions:.0f}, "
          f"fleet.restage_total {restages:.0f}; "
          + ", ".join(f"{k}: ok" for k in checks))

    for mod in launch_counters.values():
        mod.launches = 0
    telemetry.reset()
    lg_counts, lg_out, lg_wall = run_counted(
        cli_main, ["serve", "--fleet", manifest, "--source", "packed",
                   "--path", proj["new"], "--block-variants",
                   str(BLOCK_VARIANTS), "--device", DEVICE,
                   "--cache-entries", "0", "--loadgen",
                   str(FLEET_LOADGEN_CLIENTS), "--loadgen-requests",
                   str(FLEET_LOADGEN_REQUESTS)], launch_counters)
    report = json.loads(lg_out.strip().splitlines()[-1])
    paths["serve --fleet --loadgen"] = lg_counts
    per_class = report["per_class"]
    n_req = (len(FLEET_ROUTES) * len(PRIORITY_CLASSES)
             * FLEET_LOADGEN_CLIENTS * FLEET_LOADGEN_REQUESTS)
    inter, batch = PRIORITY_CLASSES
    lg_checks = {
        f"{n_req} answers, 0 errors, 0 sheds": report["completed"] == n_req
        and report["errors"] == 0 and report["shed"] == 0,
        "interactive p99 <= batch p99":
            per_class[inter]["p99_s"] <= per_class[batch]["p99_s"],
        "K1 launches == 0": not any(lg_counts.values()),
    }
    if not all(lg_checks.values()):
        fail(f"serve --fleet --loadgen: {report}")
    print(f"serve --fleet --loadgen {FLEET_LOADGEN_CLIENTS} x "
          f"{FLEET_LOADGEN_REQUESTS} per route and class [{card}]: wall "
          f"{lg_wall:.3f} s; sustained {report['sustained_qps']} QPS over "
          f"{report['duration_s']} s; p50 / p99 interactive "
          f"{per_class[inter]['p50_s'] * 1e3:.3f} / "
          f"{per_class[inter]['p99_s'] * 1e3:.3f} ms, batch "
          f"{per_class[batch]['p50_s'] * 1e3:.3f} / "
          f"{per_class[batch]['p99_s'] * 1e3:.3f} ms; fleet.evictions "
          f"{telemetry.counter_value('fleet.evictions'):.0f}, "
          f"restage_total {telemetry.counter_value('fleet.restage_total'):.0f}; "
          + ", ".join(f"{k}: ok" for k in lg_checks))

    for mod in launch_counters.values():
        mod.launches = 0
    telemetry.reset()
    slow = fleet_of(max_linger_ms=HEDGE_SLOW_LINGER_MS).start()
    fast = fleet_of(max_linger_ms=0.0).start()
    try:
        pool = new_rows[picks]
        for router in (slow, fast):
            # Staged, and one request through each worker: its first
            # batch on its stream pays one-time costs the runs must not.
            router.warm_route("pcoa")
            router.project("pcoa", pool[0], timeout=600)
        unhedged = run_hedged_loadgen(
            [slow, slow], pool, clients=HEDGE_CLIENTS,
            requests_per_client=HEDGE_REQUESTS, route="pcoa",
            hedge_floor_s=600.0)
        hedged = run_hedged_loadgen(
            [slow, fast], pool, clients=HEDGE_CLIENTS,
            requests_per_client=HEDGE_REQUESTS, route="pcoa",
            hedge_floor_s=HEDGE_FLOOR_S)
    finally:
        slow.close()
        fast.close()
    hedge_counts = {k: mod.launches for k, mod in launch_counters.items()}
    paths["run_hedged_loadgen, 2 routers"] = hedge_counts
    h_checks = {
        "0 errors": unhedged["errors"] == 0 and hedged["errors"] == 0,
        "hedged p99 < unhedged p99": hedged["p99_s"] < unhedged["p99_s"],
        "hedges launched and won": hedged["hedge_launched"] > 0
        and hedged["hedge_wins"] > 0 and unhedged["hedge_launched"] == 0,
        "K1 launches == 0": not any(hedge_counts.values()),
    }
    if not all(h_checks.values()):
        fail(f"hedged loadgen: unhedged {unhedged}, hedged {hedged}")
    print(f"run_hedged_loadgen, {HEDGE_CLIENTS} x {HEDGE_REQUESTS}, primary "
          f"lingering {HEDGE_SLOW_LINGER_MS:.0f} ms [{card}]: p50 / p99 "
          f"unhedged {unhedged['p50_s'] * 1e3:.3f} / "
          f"{unhedged['p99_s'] * 1e3:.3f} ms, hedged "
          f"{hedged['p50_s'] * 1e3:.3f} / {hedged['p99_s'] * 1e3:.3f} ms; "
          f"hedge_launched {hedged['hedge_launched']}, hedge_wins "
          f"{hedged['hedge_wins']}, errors {hedged['errors']}; "
          + ", ".join(f"{k}: ok" for k in h_checks))

    # -- 44. the fleet HTTP front as a process ------------------------------
    port_file = os.path.join(tmp, "port44.json")
    log_err = open(os.path.join(tmp, "fleet44.err"), "w+")
    cmd = [sys.executable, "-m", "spark_examples_tpu_torch", "serve",
           "--fleet", manifest, "--port", "0", "--port-file", port_file,
           "--cache-entries", "0", "--block-variants", str(BLOCK_VARIANTS),
           "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.DEVNULL, stderr=log_err)
    try:
        while not os.path.exists(port_file):
            if proc.poll() is not None:
                log_err.seek(0)
                fail(f"serve --fleet exited {proc.returncode} before "
                     f"binding: {log_err.read()[-2000:]}")
            if time.perf_counter() - t0 > HTTP_BIND_TIMEOUT_S:
                fail(f"serve --fleet did not bind within "
                     f"{HTTP_BIND_TIMEOUT_S} s")
            time.sleep(0.05)
        bind_s = time.perf_counter() - t0
        base = f"http://127.0.0.1:{json.load(open(port_file))['port']}"

        def post(job):
            verb, route, j = job
            body = {"genotypes": new_rows[picks[j]].tolist()}
            if verb == "neighbors":
                body["k"] = FLEET_TOPK
            out, _h = http_json(f"{base}/{verb}/{route}",
                                json.dumps(body).encode(), timeout=600)
            return job, out

        jobs = ([("project", r, j) for r, _m, _t in FLEET_ROUTES
                 for j in range(FLEET_SAMPLES)]
                + [("neighbors", r, j) for r in topk
                   for j in range(FLEET_SAMPLES)])
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(
                8, thread_name_prefix="chip-smoke-http") as pool:
            answers = list(pool.map(post, jobs))
        http_s = time.perf_counter() - t0
        same_rows = all(
            np.array_equal(np.asarray(out["coords"], np.float32),
                           rows[route][j:j + 1])
            for (verb, route, j), out in answers if verb == "project")
        same_topk = all(
            out["neighbor_indices"] == topk[route][j][0].tolist()
            and out["similarities"] == topk[route][j][1].tolist()
            for (verb, route, j), out in answers if verb == "neighbors")
        prom, _ = http_json(f"{base}/metrics")
        routes, _ = http_json(f"{base}/routes")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    log_err.seek(0)
    err_text = log_err.read()
    log_err.close()
    http_checks = {
        "POST /project/<route> == the in-process rows": same_rows,
        "POST /neighbors/pcoa == the in-process top-k": same_topk,
        "/metrics carries fleet_pool_bytes": "fleet_pool_bytes" in prom,
        f"/routes: {FLEET_SAMPLES} completed a route": all(
            routes[r]["completed"] >= FLEET_SAMPLES for r in routes),
        "SIGTERM: drained, exit 0": rc == 0 and "draining..." in err_text,
    }
    if not all(http_checks.values()):
        fail("serve --fleet over HTTP: " + ", ".join(
            k for k, v in http_checks.items() if not v)
             + f"; stderr: {err_text[-2000:]}")
    print(f"serve --fleet over HTTP (subprocess, --port 0) [{card}]: bound "
          f"in {bind_s:.3f} s; {len(jobs)} POSTs from 8 threads in "
          f"{http_s:.3f} s; " + ", ".join(f"{k}: ok" for k in http_checks))
    return paths


# Phases 45-46: --backend cpu-reference (the host NumPy oracle, the
# measured stand-in for the Spark MLlib baseline) held against the device
# route. The Quickstart width, cut to 16,384 variants (2 blocks of 8192)
# so that the oracle's float64 host products stay within seconds; the
# Bray-Curtis table cut to 1,000 x 4,096 (scipy's pdist runs on one core).
BACKEND_VARIANTS = 16_384
BACKEND_BC_SAMPLES = 1000
BACKEND_BC_FEATURES = 4096
# f32 device finalize against the f64 host one (ibs d1 / 2m and the
# Bray-Curtis ratio of exact integer sums are within an f32 rounding).
BACKEND_DIST_ATOL = 1e-6
# The top NUM_POP_PCS coordinates per column up to sign, as a fraction of
# the column's largest entry: an f32 cuSOLVER eigh against a float64
# LAPACK one (the CPU rehearsal at these shapes gave 4.4e-5 at most).
BACKEND_COORD_TOL = 1e-3
BACKEND_EIG_RTOL = 1e-4
# Phase 47: the controller's wait for its children (process start, the
# card, lazy panel staging) and its knobs.
CONTROLLER_WAIT_S = 300
CONTROLLER_SLOS = [{"route": "*", "p99_ms": 60_000, "availability": 0.5}]


def host_cpu_line() -> str:
    """The host's CPU and the cores this process may use (what ``nproc``
    prints): the cpu-reference route runs there. From the first
    processor of ``/proc/cpuinfo``: its model name, and its vendor,
    family and model numbers (a virtualised host may report the name as
    unknown)."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    ident = ", ".join(f"{k} {fields[k]}" for k in
                      ("vendor_id", "cpu family", "model") if k in fields)
    return (f"{fields.get('model name', 'no model name')} ({ident}), "
            f"nproc {len(os.sched_getaffinity(0))}")


def backend_run(cli_main, argv: list[str], counters: dict, module,
                name: str, output: str):
    """One coordinates job through :func:`run_job`, keeping each result
    of ``module.name`` (a host oracle product, a device run's
    accumulators) that the job computes. Returns (launches by kernel,
    phase timings, coords, wall s, the kept results)."""
    kept: list = []
    original = keeping(module, name, kept)
    try:
        launches, timings, _, wall = run_job(cli_main, argv, counters,
                                             output)
    finally:
        setattr(module, name, original)
    with open(output) as f:
        f.readline()
        coords = np.asarray([line.rstrip("\n").split("\t")[1:]
                             for line in f], dtype=np.float64)
    if not np.isfinite(coords).all():
        fail(f"{' '.join(argv)}: non-finite coordinates")
    return launches, timings, coords, wall, kept


def backend_phases(cli_main, launch_counters: dict, card: str,
                   tmp: str) -> dict:
    """Phases 45-46: ``pcoa``/``pca --backend cpu-reference`` against the
    default route on one cohort (K1's int32 accumulators equal to the
    oracle's float64 products, distances, coordinates), ``--debug-nans``
    writing the same bytes, then Bray-Curtis against K2. Returns the
    launches by kernel of each CLI run."""
    import torch

    from spark_examples_tpu_torch.ops import distances, genotype
    from spark_examples_tpu_torch.pipelines import runner
    from spark_examples_tpu_torch.utils import oracle

    paths = {}
    host = host_cpu_line()
    blocks = math.ceil(BACKEND_VARIANTS / BLOCK_VARIANTS)
    cohort = ["--n-samples", str(N_SAMPLES), "--n-variants",
              str(BACKEND_VARIANTS), "--block-variants",
              str(BLOCK_VARIANTS), "--num-pc", str(NUM_PC), "--device",
              DEVICE]
    ibs = ("cc", "yc", "t1t1", "t2t2")

    # -- 45. pcoa ibs and pca: the host oracle against K1 ------------------
    runs = {}
    for command, metric in (("pcoa", "ibs"), ("pca", None)):
        argv = [command, *cohort] + (["--metric", metric] if metric else [])
        out_h = os.path.join(tmp, f"{command}45_host.tsv")
        out_d = os.path.join(tmp, f"{command}45_device.tsv")
        h = backend_run(cli_main, argv + ["--backend", "cpu-reference"],
                        launch_counters, oracle, "cpu_gram_products", out_h)
        d = backend_run(cli_main, argv, launch_counters, runner, "run_gram",
                        out_d)
        runs[command] = (d[3], out_d, argv)
        label = f"{command} {metric or 'shared-alt'} ({N_SAMPLES} x " \
                f"{BACKEND_VARIANTS})"
        paths[f"{label} cpu-reference"] = h[0]
        paths[label] = d[0]
        # The oracle's products, summed over its blocks, and K1's int32
        # accumulators of the device run, on the host.
        host_prod = {p: sum(b[p] for b in h[4]) for p in h[4][0]}
        dev_acc = d[4][0].acc
        acc_host = {p: v.cpu() for p, v in dev_acc.items()}
        exact = (host_prod.keys() == acc_host.keys() and all(
            np.array_equal(acc_host[p].numpy().astype(np.float64),
                           host_prod[p])
            and np.array_equal(acc_host[p].numpy(),
                               host_prod[p].astype(np.int32))
            for p in host_prod))
        checks = {
            "cpu-reference: K1 launches == 0, K2 == 0":
                not any(h[0].values()),
            f"default route: K1 launches == {blocks}":
                d[0]["packed_gram"] == blocks and d[0]["braycurtis"] == 0,
            "the default route ran K1": d[4][0].lowering == "fused",
            "K1's int32 accumulators == the oracle's float64 products "
            f"({', '.join(host_prod)}), exactly": exact,
        }
        if command == "pcoa":
            pieces = ("m", "d1")
            host_pieces = oracle.combine_products(host_prod, pieces)
            dev_pieces = genotype.combine_products(dev_acc, pieces)
            checks["the oracle's pieces m, d1 == K1's, exactly"] = all(
                np.array_equal(dev_pieces[k].cpu().numpy().astype(
                    np.float64), host_pieces[k]) for k in pieces)
            d_host = oracle.cpu_finalize(host_pieces, "ibs")["distance"]
            d_dev = distances.finalize(dev_acc, "ibs")["distance"]
            dist_err = float(np.abs(d_dev.cpu().numpy().astype(np.float64)
                                    - d_host).max())
            checks[f"distances within {BACKEND_DIST_ATOL}"] = (
                dist_err <= BACKEND_DIST_ATOL)
        coord_err = same_columns(d[2], h[2], NUM_POP_PCS, BACKEND_COORD_TOL)
        if not all(checks.values()):
            fail(f"{command} --backend cpu-reference vs the device route: "
                 + ", ".join(k for k, v in checks.items() if not v))
        del dev_acc, acc_host
        print(f"{command} {N_SAMPLES} x {BACKEND_VARIANTS} "
              f"{metric or 'shared-alt'}, cpu-reference vs default "
              f"[{card}; host {host}]: wall host {h[3]:.3f} s ("
              + phases_line(h[1], ("ingest_setup", "gram", "finalize",
                                   "eigh"))
              + f"), device {d[3]:.3f} s ("
              + phases_line(d[1], ("ingest_setup", "gram", "finalize",
                                   "eigh"))
              + f"); launches host {h[0]}, device {d[0]}; "
              + (f"max |d_host - d_device| {dist_err:.3g}; "
                 if command == "pcoa" else "")
              + f"top {NUM_POP_PCS} coordinates per column up to sign "
              f"within {coord_err:.3g} of the column scale (tolerance "
              f"{BACKEND_COORD_TOL}); " + ", ".join(f"{k}: ok"
                                                    for k in checks))
        del h, d

    # --debug-nans: the same job writes the same bytes (and still K1).
    wall, out_d, argv = runs["pcoa"]
    out_n = os.path.join(tmp, "pcoa45_debug_nans.tsv")
    nan_counts, nan_timings, _, nan_wall = run_job(
        cli_main, argv + ["--debug-nans"], launch_counters, out_n)
    paths[f"pcoa ibs --debug-nans ({N_SAMPLES} x {BACKEND_VARIANTS})"] = \
        nan_counts
    same = open(out_n, "rb").read() == open(out_d, "rb").read()
    if not same or nan_counts["packed_gram"] != blocks:
        fail(f"pcoa --debug-nans: same bytes {same}, launches {nan_counts}")
    print(f"pcoa --debug-nans [{card}]: coordinates byte for byte the "
          f"run without the flag; wall {nan_wall:.3f} s against "
          f"{wall:.3f} s (" + phases_line(
              nan_timings, ("gram", "finalize", "eigh"))
          + f"); launches {nan_counts}")

    # -- 46. Bray-Curtis: scipy against K2 ---------------------------------
    argv = ["pcoa", "--metric", "braycurtis", "--n-samples",
            str(BACKEND_BC_SAMPLES), "--n-variants",
            str(BACKEND_BC_FEATURES), "--num-pc", str(NUM_PC), "--device",
            DEVICE]
    from spark_examples_tpu_torch.ops import braycurtis_kernel

    h = backend_run(cli_main, argv + ["--backend", "cpu-reference"],
                    launch_counters, oracle, "cpu_braycurtis",
                    os.path.join(tmp, "bc46_host.tsv"))
    d = backend_run(cli_main, argv, launch_counters, braycurtis_kernel,
                    "braycurtis_kernel", os.path.join(tmp, "bc46_dev.tsv"))
    label = f"pcoa braycurtis ({BACKEND_BC_SAMPLES} x {BACKEND_BC_FEATURES})"
    paths[f"{label} cpu-reference"] = h[0]
    paths[label] = d[0]
    d_host, d_dev = h[4][0], d[4][0].cpu().numpy().astype(np.float64)
    bc_err = float(np.abs(d_dev - d_host).max())
    coord_err = same_columns(d[2], h[2], NUM_POP_PCS, BACKEND_COORD_TOL)
    checks = {
        "cpu-reference: K2 launches == 0, K1 == 0": not any(h[0].values()),
        "default route: K2 launches == 1":
            d[0]["braycurtis"] == 1 and d[0]["packed_gram"] == 0,
        f"distances within {BACKEND_DIST_ATOL}": bc_err <= BACKEND_DIST_ATOL,
    }
    if not all(checks.values()):
        fail(f"Bray-Curtis cpu-reference vs K2: {checks}, max |diff| "
             f"{bc_err}")
    print(f"pcoa braycurtis {BACKEND_BC_SAMPLES} x {BACKEND_BC_FEATURES}, "
          f"cpu-reference (scipy pdist) vs default (K2) [{card}; host "
          f"{host}]: wall host {h[3]:.3f} s (" + phases_line(
              h[1], ("ingest", "distance", "eigh"))
          + f"), device {d[3]:.3f} s (" + phases_line(
              d[1], ("ingest", "distance", "eigh"))
          + f"); launches host {h[0]}, device {d[0]}; max |d_host - "
          f"d_device| {bc_err:.3g}; top {NUM_POP_PCS} coordinates within "
          f"{coord_err:.3g} of the column scale; "
          + ", ".join(f"{k}: ok" for k in checks))
    del d, h
    torch.cuda.empty_cache()
    return paths


def controller_process(cfg_path: str) -> int:
    """Phase 47's controller process, started by :func:`controller_phase`
    as ``python -c "... chip_smoke.controller_process(cfg)"``: a
    ``FleetController`` over two ``ProcessReplica`` serve children on the
    card. It waits for both, checks their rows bitwise, SIGKILLs one,
    steps until the respawn answers bitwise again, and writes what it
    saw to ``cfg["result"]``. It never touches the card itself."""
    import concurrent.futures

    from spark_examples_tpu_torch.fleet import (
        ControllerConfig,
        FleetController,
        ProcessReplica,
    )
    from spark_examples_tpu_torch.serve import FleetManifest

    with open(cfg_path) as f:
        cfg = json.load(f)
    work = cfg["workdir"]
    manifest = FleetManifest.load(cfg["manifest"])
    routes = [r.name for r in manifest.routes]
    queries = np.load(cfg["queries"])
    want = dict(np.load(cfg["rows"]))
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spawned = []

    def factory(name, generation):
        r = ProcessReplica.serving(
            name, cfg["manifest"], cfg["device"], work, cfg["budget"],
            routes, env=env, generation=generation,
            extra_args=["--telemetry-dir", os.path.join(work, name),
                        "--telemetry-flush-s", "0.5", "--cache-entries",
                        "0", "--block-variants", str(BLOCK_VARIANTS)])
        spawned.append(r)
        return r

    ctrl = FleetController(
        factory, {r: cfg["panel_bytes"] for r in routes},
        ControllerConfig(
            min_replicas=2, max_replicas=2, stale_scrapes=5,
            startup_grace_s=CONTROLLER_WAIT_S, hang_heartbeat_s=120.0,
            backoff_initial_s=0.05, backoff_max_s=1.0,
            drain_timeout_s=60.0, slos=manifest.slos,
            ledger_path=os.path.join(work, "controller.json")))
    apps = []

    def step_until(cond, what: str) -> float:
        t0 = time.perf_counter()
        while True:
            ctrl.step()
            apps.append(compute_apps())
            if cond():
                return time.perf_counter() - t0
            if time.perf_counter() - t0 > CONTROLLER_WAIT_S:
                fail(f"controller: {what} not reached in "
                     f"{CONTROLLER_WAIT_S} s: "
                     + json.dumps(ctrl.describe(), default=str)[-3000:])
            time.sleep(0.2)

    def bitwise(replica) -> bool:
        base = f"http://127.0.0.1:{replica.port()}"

        def post(job):
            route, j = job
            out, _h = http_json(
                f"{base}/project/{route}",
                json.dumps({"genotypes": queries[j].tolist()}).encode(),
                timeout=600)
            return job, np.asarray(out["coords"], np.float32)

        jobs = [(r, j) for r in routes for j in range(len(queries))]
        with concurrent.futures.ThreadPoolExecutor(
                8, thread_name_prefix="chip-smoke-http") as pool:
            got = dict(pool.map(post, jobs))
        return all(np.array_equal(got[(r, j)], want[r][j:j + 1])
                   for r, j in jobs)

    res = {}
    try:
        t0 = time.perf_counter()
        ctrl.start()
        res["ready_s"] = step_until(lambda: ctrl.ready_count() == 2,
                                    "both replicas ready")
        res["rows_before"] = [bitwise(r) for r in ctrl.replicas()]
        victim = ctrl.replicas()[0]
        time.sleep(1.0)  # one live flush of the victim's ring
        t_kill = time.perf_counter()
        os.kill(victim.proc.pid, signal.SIGKILL)
        res["detect_s"] = step_until(lambda: any(
            d["action"] == "respawn" for d in ctrl.describe()["decisions"]),
            "a respawn decision")
        res["respawn_ready_s"] = step_until(
            lambda: ctrl.ready_count() == 2, "the respawned replica ready")
        respawned = [r for r in ctrl.replicas() if r.generation == 1]
        res["rows_after"] = [bitwise(r) for r in respawned]
        res["kill_to_bitwise_s"] = time.perf_counter() - t_kill
        res["wall_s"] = time.perf_counter() - t0
    finally:
        ctrl.close()
        for r in spawned:
            r.kill()
    desc = ctrl.describe()
    import torch

    res.update(
        incidents=[(i["who"], i["kind"]) for i in desc["incidents"]],
        decisions=[(d["who"], d["action"]) for d in desc["decisions"]],
        spawned=[r.argv for r in spawned],
        generations=[(r.name, r.generation) for r in spawned],
        rounds=desc["rounds"], apps_max=max(apps), apps_min=min(apps),
        cuda_initialized=torch.cuda.is_initialized())
    with open(cfg["result"], "w") as f:
        json.dump(res, f)
    return 0


def controller_phase(cli_main, launch_counters: dict, card: str,
                     files: dict, tmp: str) -> dict:
    """Phase 47: the fleet controller on the card, in a process of its
    own (:func:`controller_process`) over two ``ProcessReplica`` serve
    children of phase 43's manifest (an ``slos`` block added): both
    answer phase 43's rows bitwise, one is SIGKILLed and respawned and
    answers bitwise again; then the workdir through ``telemetry
    timeline`` and ``telemetry stitch --fleet``. Returns the launches by
    kernel of the phase in this process and K1's exported by the
    children."""
    from spark_examples_tpu_torch.core import telemetry

    fleet = files["fleet"]
    work = os.path.join(tmp, "fleet47")
    os.makedirs(work)
    manifest = os.path.join(tmp, "fleet47.json")
    # graftlint: disable=atomic-write  # the controller's manifest is this run's input, written once into its scratch directory before the controller starts: no last-good copy to tear
    with open(manifest, "w") as f:
        json.dump({**fleet["doc"], "slos": CONTROLLER_SLOS}, f)
    queries = os.path.join(tmp, "queries47.npy")
    np.save(queries, fleet["queries"])
    rows = os.path.join(tmp, "rows47.npz")
    np.savez(rows, **fleet["rows"])
    cfg = {"workdir": work, "manifest": manifest, "queries": queries,
           "rows": rows, "device": DEVICE, "budget": fleet["budget"],
           "panel_bytes": fleet["panel_bytes"],
           "result": os.path.join(tmp, "controller47.json")}
    cfg_path = os.path.join(tmp, "controller47_cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    for mod in launch_counters.values():
        mod.launches = 0
    apps_before = compute_apps()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
         "chip_smoke.controller_process(sys.argv[1]))", cfg_path],
        cwd=here, capture_output=True, text=True,
        timeout=4 * CONTROLLER_WAIT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"controller process exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    with open(cfg["result"]) as f:
        res = json.load(f)

    # The workdir through the CLI: the timeline and the fleet stitch.
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc_tl = cli_main(["telemetry", "timeline", "--path", work])
    timeline = json.loads(out.getvalue().strip().splitlines()[-1])
    timeline_rows = [line for line in err.getvalue().splitlines()
                     if " round " in line]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc_st = cli_main(["telemetry", "stitch", "--fleet", "--path", work])
    stitch = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(stitch["output"]) as f:
        events = [json.loads(line) for line in f if line.strip()]
    slot_blocks = {e["pid"] // 1_000_000 for e in events
                   if e.get("ph") != "M" and e["pid"] < 999_999_998}
    markers = [e for e in events if e.get("cat") == "controller"
               and e.get("ph") == "i"]
    launches = {k: mod.launches for k, mod in launch_counters.items()}
    # K1's launches in the children, as each generation exported them.
    child_k1 = 0
    for slot in ("replica-0", "replica-1"):
        for att in sorted(os.listdir(os.path.join(work, slot))):
            path = os.path.join(work, slot, att, "rank0", "metrics.json")
            if os.path.exists(path):
                with open(path) as f:
                    child_k1 += int(json.load(f)["counters"].get(
                        "kernel.packed_gram.launches", 0))
    devices = [argv[argv.index("--device") + 1] for argv in res["spawned"]]
    checks = {
        "both replicas answered phase 43's rows bitwise":
            res["rows_before"] == [True, True],
        "a crash incident, then a respawn decision":
            ["replica-0", "crash"] in res["incidents"]
            and ["replica-0", "respawn"] in res["decisions"],
        "the respawned replica answered bitwise": res["rows_after"] == [True],
        f"3 children spawned, each with --device {DEVICE}":
            len(devices) == 3 and set(devices) == {DEVICE},
        "controller.json holds the crash incident": any(
            i.get("kind") == "crash" for i in json.load(open(os.path.join(
                work, "controller.json")))["incidents"]),
        "telemetry timeline printed rows": rc_tl == 0 and len(
            timeline_rows) > 0 and timeline["rounds"] == res["rounds"],
        "telemetry stitch --fleet: one pid block per slot": rc_st == 0
            and stitch["slots"] == ["replica-0", "replica-1"]
            and slot_blocks == {0, 1},
        "telemetry stitch --fleet: a controller marker": len(markers) >= 1
            and stitch["incident_markers"] >= 1,
        "the controller holds no CUDA context (never more processes on "
        "the card than this script and two children)":
            not res["cuda_initialized"]
            and res["apps_max"] <= apps_before + 2,
        "K1 launches == 0 (here and in the children)":
            not any(launches.values()) and child_k1 == 0,
    }
    if not all(checks.values()):
        fail("fleet controller: " + ", ".join(
            k for k, v in checks.items() if not v) + f"; {res}")
    print(f"fleet controller over 2 process replicas (serve --fleet "
          f"--device {DEVICE}, 3 routes, slos) [{card}]: both ready in "
          f"{res['ready_s']:.3f} s; SIGKILL -> respawn decision in "
          f"{res['detect_s']:.3f} s, respawned replica ready "
          f"{res['respawn_ready_s']:.3f} s later, kill to bitwise rows "
          f"{res['kill_to_bitwise_s']:.3f} s; {res['rounds']} control "
          f"rounds; processes on the card {res['apps_min']}-"
          f"{res['apps_max']} (this script's {apps_before} before); "
          f"stitch {stitch['events']} events, {stitch['incident_markers']} "
          f"incident marker(s); timeline {timeline['rounds']} rounds, "
          f"{timeline['markers']} markers; controller process wall "
          f"{wall:.3f} s; "
          + ", ".join(f"{k}: ok" for k in checks))
    telemetry.reset()
    return {"fleet controller, 2 process replicas": launches,
            "fleet controller, the children (exported "
            "kernel.packed_gram.launches)":
            {"packed_gram": child_k1}}


# Phases 48-53: the device mesh on one card. A 2 x 2 mesh of four
# virtual slots on cuda:0 (each run inside virtual.virtual_slots(4)): the
# route and K1's tile launches, not scaling (the four slots share the
# card).
MESH_ARGS = ["--mesh-shape", "2x2"]
MESH_SLOTS = 4
# The tiled route's randomized solve against phase 14's dense one on the
# structure PCs (the JAX package's bound for the randomized solver above
# the bulk is ~3e-4 relative; the CPU rehearsal at 96 samples gave 2e-6).
MESH_COORD_TOL = 1e-3
# Phase 52: the ring job dies when asked for block 11 (checkpoints every
# 4 blocks: generations at 32,768 and 65,536 variants).
MESH_KILL_AT_BLOCK = 10


def k1_rect_bounds(nr: int, nc: int, w: int, products) -> dict:
    """K1's least time for a rectangular launch (rows and cols different
    samples): every product needs all nr x nc pairs, 2 int8 operations a
    pair and variant; the bytes are both operands read once and every
    output written once."""
    ops = 2.0 * 4 * w * nr * nc * len(products)
    byte_count = 1.0 * (nr + nc) * w + 4.0 * nr * nc * len(products)
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    bytes_ms = byte_count / PEAK_BYTES_S * 1e3
    return {"ops": ops, "bytes": byte_count,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def time_k1_shape(name: str, rows, cols, pieces, card: str) -> dict:
    """K1 at one launch shape (``cols`` None: the symmetric launch of
    ``rows`` against itself): bitwise against its plain version and
    ``torch._int_mm`` on the pre-decoded operands, each timed with CUDA
    events, beside its bound. Prints one line; returns the numbers."""
    import torch

    from spark_examples_tpu_torch.ingest import bitpack
    from spark_examples_tpu_torch.ops import genotype, packed_gram

    sym = cols is None
    cols_ = rows if sym else cols
    got = packed_gram.fused_tile_products(rows, cols_, pieces)
    want = packed_gram.fused_tile_products_plain(rows, cols_, pieces)
    if not all(torch.equal(got[p], want[p]) for p in pieces):
        fail(f"K1 != plain at the {name} shape {tuple(rows.shape)}")
    ms = cuda_ms(lambda: packed_gram.fused_tile_products(rows, cols_,
                                                         pieces),
                 reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: packed_gram.fused_tile_products_plain(
        rows, cols_, pieces), reps=3, warmup=1)
    ops_r = genotype.operands(bitpack.unpack_dosages(rows))
    ops_c = ops_r if sym else genotype.operands(
        bitpack.unpack_dosages(cols_))

    def rows8(x):
        # _int_mm wants both outer sizes multiples of 8: zero rows,
        # which add nothing, padded once outside the timed calls.
        return torch.nn.functional.pad(x, (0, 0, 0, -x.shape[0] % 8))

    pairs = [(rows8(ops_r[genotype.PRODUCT_OPERANDS[p][0]]).contiguous(),
              rows8(ops_c[genotype.PRODUCT_OPERANDS[p][1]]).t())
             for p in pieces]
    nr, nc = rows.shape[0], cols_.shape[0]
    for p, (a, b) in zip(pieces, pairs):
        if not torch.equal(torch._int_mm(a, b)[:nr, :nc], got[p]):
            fail(f"torch._int_mm disagrees with K1 at the {name} shape")
    lib_ms = cuda_ms(lambda: [torch._int_mm(a, b) for a, b in pairs],
                     reps=20, warmup=3)
    w = rows.shape[1]
    bound = (k1_bounds(nr, w, pieces) if sym
             else k1_rect_bounds(nr, nc, w, pieces))
    print(f"K1 at the {name} shape ({nr} x {nc} x {w} bytes, "
          f"{'symmetric' if sym else 'asymmetric'}, ibs) [{card}]: "
          f"{ms:.4f} ms/launch; bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}: {bound['ops']:.4g} int8 ops, "
          f"{bound['bytes']:.4g} bytes); plain {plain_ms:.4f} ms; "
          f"torch._int_mm x{len(pieces)} on pre-decoded operands (outer "
          f"sizes padded to multiples of 8) {lib_ms:.4f} ms; bitwise "
          "equal to both")
    return {"rows": nr, "cols": nc, "bytes": w, "symmetric": sym, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def mesh_phases(cli_main, launch_counters: dict, card: str, dev,
                synthetic_acc: dict, pca_coords: np.ndarray, files: dict,
                tmp: str) -> tuple[dict, dict]:
    """Phases 48-53: the tile2d gram route (gather, ring), variant mode,
    pca under tile2d, a tiled checkpoint killed and resumed, and project
    under a tile2d CrossPlan, each through the CLI on phase 14's packed
    store over 2 x 2 virtual slots of cuda:0; then K1 timed at the tile
    shapes those runs launch it at. Returns (the launches by kernel of
    each run, by path name; K1's tile-shape timings)."""
    import torch

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.core import telemetry, virtual
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
    )
    from spark_examples_tpu_torch.core.meshes import Tiled
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.ops import packed_gram
    from spark_examples_tpu_torch.pipelines import project as P
    from spark_examples_tpu_torch.pipelines import runner
    from spark_examples_tpu_torch.pipelines.project import load_model

    paths = {}
    store = files["packed_store"]
    blocks = math.ceil(N_VARIANTS / BLOCK_VARIANTS)
    counters = ("gram.fused_blocks", "gram.ring_steps")
    store_args = ["--source", "packed", "--path", store, "--block-variants",
                  str(BLOCK_VARIANTS), "--device", DEVICE, "--num-pc",
                  str(NUM_PC)]

    def host_acc(acc: dict) -> dict:
        return {k: (v.full("cpu") if isinstance(v, Tiled) else v.cpu())
                for k, v in acc.items()}

    def mesh_run(argv: list[str], n_pc: int = NUM_PC, module=runner,
                 name="run_gram"):
        """A CLI run on the mesh: (launches, counter deltas, timings,
        coords, wall, what ``module.name`` returned)."""
        before = {n: telemetry.counter_value(n) for n in counters}
        kept: list = []
        orig = keeping(module, name, kept)
        try:
            with virtual.virtual_slots(MESH_SLOTS):
                counts, timings, coords, wall = run_cli(
                    cli_main, argv + MESH_ARGS, launch_counters, n_pc)
        finally:
            setattr(module, name, orig)
        deltas = {n: int(telemetry.counter_value(n) - before[n])
                  for n in counters}
        return counts, deltas, timings, coords, wall, kept[-1]

    # -- 48-50. pcoa ibs under tile2d gather, tile2d ring and variant ------
    lines = []
    mesh_coords = {}
    for label, extra, per_block, steps, mode in (
            ("tile2d gather", ["--gram-mode", "tile2d",
                               "--tile2d-transport", "gather"],
             MESH_SLOTS, 0, "tile2d"),
            ("tile2d ring", ["--gram-mode", "tile2d",
                             "--tile2d-transport", "ring"],
             MESH_SLOTS * MESH_SLOTS, MESH_SLOTS, "tile2d"),
            ("variant", ["--gram-mode", "variant"], MESH_SLOTS, 0,
             "variant")):
        counts, deltas, timings, coords, wall, grun = mesh_run(
            ["pcoa", "--metric", "ibs"] + store_args + extra)
        want = {"gram.fused_blocks": blocks, "gram.ring_steps": steps * blocks}
        if (counts["packed_gram"] != per_block * blocks or deltas != want
                or grun.plan.mode != mode or grun.plan.mesh.shape != (2, 2)
                or not grun.plan.mesh.virtual):
            fail(f"pcoa {label}: K1 launches {counts}, counters {deltas} "
                 f"(want {per_block * blocks}, {want}), plan "
                 f"{grun.plan.mode} {grun.plan.mesh.describe()}")
        if mode == "tile2d" and not all(isinstance(v, Tiled)
                                        for v in grun.acc.values()):
            fail(f"pcoa {label}: the accumulators are not tiled")
        if not equal_accumulators(host_acc(grun.acc), synthetic_acc):
            fail(f"pcoa {label}: accumulators gathered from the slots differ "
                 "from phase 6's")
        del grun
        if mode == "variant":
            # The same accumulators, finalize and dense solve as phase 14.
            if not np.array_equal(coords, files["packed_store_coords"]):
                fail("pcoa variant: coordinates differ from phase 14's")
            err = 0.0
        else:
            err = same_columns(coords, files["packed_store_coords"],
                               NUM_POP_PCS, MESH_COORD_TOL)
        mesh_coords[label] = coords
        paths[f"pcoa ibs {label} (2x2 virtual slots)"] = counts
        lines.append(
            f"{label}: wall {wall:.3f} s, "
            + phases_line(timings, ("gram", "finalize", "eigh"))
            + f", K1 {counts['packed_gram']} launches, fused_blocks "
            f"{deltas['gram.fused_blocks']}, ring_steps "
            f"{deltas['gram.ring_steps']}; accumulators bitwise phase 6's; "
            + ("coordinates bitwise phase 14's" if mode == "variant" else
               f"structure PCs within {err:.2g} of phase 14's dense solve"))
    files["mesh_coords"] = mesh_coords
    print(f"pcoa ibs {N_SAMPLES} x {N_VARIANTS} from the packed store on a "
          f"2x2 mesh of {MESH_SLOTS} virtual slots on cuda:0 [{card}]: "
          + "; ".join(lines))

    # -- 51. pca under tile2d (the auto transport) -------------------------
    counts, deltas, timings, coords, wall, grun = mesh_run(
        ["pca"] + store_args + ["--gram-mode", "tile2d"])
    # auto resolves to the gather (one launch per tile a block).
    if (counts["packed_gram"] != MESH_SLOTS * blocks
            or deltas != {"gram.fused_blocks": blocks,
                          "gram.ring_steps": 0}
            or not torch.equal(grun.acc["t1t1"].full("cpu"),
                               synthetic_acc["t1t1"])):
        fail(f"pca tile2d: K1 launches {counts}, counters {deltas}, or "
             "t1t1 differs from phase 6's")
    del grun
    pca_err = same_columns(coords, pca_coords, NUM_POP_PCS, MESH_COORD_TOL)
    paths["pca tile2d (2x2 virtual slots)"] = counts
    print(f"pca tile2d on the 2x2 mesh [{card}]: wall {wall:.3f} s, "
          + phases_line(timings, ("gram", "finalize", "eigh"))
          + f", --tile2d-transport auto -> gather: K1 "
          f"{counts['packed_gram']} "
          f"launches, fused_blocks {deltas['gram.fused_blocks']}, "
          f"ring_steps {deltas['gram.ring_steps']}; t1t1 bitwise phase 6's; "
          f"structure PCs within {pca_err:.2g} of phase 11's dense pca "
          "(top-|lambda| randomized solve on the tiles)")

    # -- 52. a tiled checkpoint, killed and resumed ------------------------
    ck = os.path.join(tmp, "ck_mesh")
    job = JobConfig(
        ingest=IngestConfig(source="packed", path=store,
                            block_variants=BLOCK_VARIANTS),
        compute=ComputeConfig(metric="ibs", device=DEVICE,
                              gram_mode="tile2d", mesh_shape=(2, 2),
                              tile2d_transport="ring", checkpoint_dir=ck,
                              checkpoint_every_blocks=CKPT_EVERY_BLOCKS))
    for mod in launch_counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    with virtual.virtual_slots(MESH_SLOTS):
        try:
            runner.run_gram(job, DyingSource(load_packed(store),
                                             MESH_KILL_AT_BLOCK),
                            PhaseTimer())
        except RuntimeError as e:
            if "simulated preemption" not in str(e):
                raise
        else:
            fail("the dying source did not stop the tile2d ring job")
    kill_wall = time.perf_counter() - t0
    kill_launches = packed_gram.launches
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    tiles = sorted(f for f in os.listdir(ck) if ".t" in f)
    if (kill_launches != MESH_KILL_AT_BLOCK * MESH_SLOTS ** 2
            or manifest["mesh_shape"] != [2, 2]
            or manifest["mode"] != "tile2d"
            or set(manifest["layout"].values()) != {"tiles"}
            or len(tiles) != 4 * MESH_SLOTS
            or manifest["next_variant"] != 2 * CKPT_EVERY_BLOCKS
            * BLOCK_VARIANTS):
        keys = ("mesh_shape", "mode", "layout", "next_variant")
        fail(f"killed tile2d ring job: {kill_launches} launches, manifest "
             f"{ {k: manifest[k] for k in keys} }, {len(tiles)} tile files")
    left = blocks - 2 * CKPT_EVERY_BLOCKS
    counts, deltas, timings, coords, wall, grun = mesh_run(
        ["pcoa", "--metric", "ibs"] + store_args
        + ["--gram-mode", "tile2d", "--tile2d-transport", "ring",
           "--checkpoint-dir", ck])
    if (counts["packed_gram"] != left * MESH_SLOTS ** 2
            or not equal_accumulators(host_acc(grun.acc), synthetic_acc)
            or not np.array_equal(coords, mesh_coords["tile2d ring"])):
        fail(f"tile2d ring resume: K1 launches {counts} (want "
             f"{left * MESH_SLOTS ** 2}), or the accumulators or "
             "coordinates differ from the uninterrupted run's")
    del grun
    paths["pcoa ibs tile2d ring, killed (library)"] = {
        "packed_gram": kill_launches, "braycurtis": 0}
    paths["pcoa ibs tile2d ring, resumed"] = counts
    print(f"tiled checkpoint, kill and resume [{card}]: the ring job died "
          f"when asked for block {MESH_KILL_AT_BLOCK + 1} ({kill_launches} "
          f"K1 launches, wall {kill_wall:.3f} s); {len(tiles)} tile files "
          f"({tiles[0]} ...), manifest mesh {manifest['mesh_shape']} mode "
          f"{manifest['mode']} at variant {manifest['next_variant']}; the "
          f"CLI resumed with {counts['packed_gram']} launches ({left} "
          f"blocks x {MESH_SLOTS ** 2}), wall {wall:.3f} s; accumulators "
          "bitwise phase 6's, coordinates bitwise the uninterrupted ring "
          "run's")

    # -- 53. project under a tile2d CrossPlan ------------------------------
    proj = files["projection"]
    model = proj["models"]["pcoa"]
    k = load_model(model["model"]).n_components
    counts, deltas, timings, coords, wall, out = mesh_run(
        ["project", "--model", model["model"], "--source", "packed",
         "--path", proj["new"], "--ref-source", "packed", "--ref-path",
         proj["panel"], "--block-variants", str(BLOCK_VARIANTS), "--device",
         DEVICE, "--gram-mode", "tile2d"], n_pc=k, module=P,
        name="pcoa_project_job")
    if any(counts.values()) or not np.array_equal(out.coords,
                                                  model["new_coords"]):
        fail(f"project under a tile2d CrossPlan: launches {counts}, or the "
             "coordinates differ from phase 29's replicated run")
    paths["project pcoa new (tile2d CrossPlan)"] = counts
    print(f"project {N_SAMPLES - PANEL_SAMPLES} new samples under a tile2d "
          f"CrossPlan on the 2x2 mesh [{card}]: wall {wall:.3f} s, "
          + phases_line(timings, ("gram", "eigh"))
          + f", launches {counts}; coordinates bitwise phase 29's "
          "(int32 cross statistics tiled, then gathered)")

    # -- K1 at the tile shapes ---------------------------------------------
    ibs = kernels.get("ibs").pieces
    block, _ = next(load_packed(store).packed_blocks(BLOCK_VARIANTS))
    full = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    tn = N_SAMPLES // 2
    shard = full[:, :full.shape[1] // MESH_SLOTS].contiguous()
    shapes = (
        ("tile rectangular", full[:tn], full[tn:]),
        ("tile diagonal", full[:tn], None),
        ("ring shard rectangular", shard[:tn], shard[tn:]),
        ("variant shard", shard, None),
    )
    timings = {name: time_k1_shape(name, rows, cols, ibs, card)
               for name, rows, cols in shapes}
    return paths, timings


# Phases 54-57: jobs of two processes over torch.distributed on the one
# card this script pins: gloo with host staging (NCCL refuses two ranks on
# one GPU). Each rank is a `python -m spark_examples_tpu_torch` process
# started with the JAX package's environment names; a rank starts in
# 6-9 s on the card's host, so each phase is one or two two-rank runs.
MULTIHOST_TIMEOUT_S = 180
# Phase 55: rank 0 dies reading its 7th (last) block; checkpoints every 2
# global steps with a prefetch depth of 1, so a generation at step 2 or 4
# stands. Cut to the Quickstart store's 13 blocks: the cost is the ranks'
# start, not their blocks.
MULTIHOST_KILL_AFTER = 6
# Phase 56: rank 1 sleeps this long before each consensus round.
MULTIHOST_DELAY_S = 0.5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs: list[list[str]], tmp: str, name: str,
              env_extra: list[dict] | None = None,
              module: bool = True) -> list[dict]:
    """One process per argv, started together as the ranks of one job
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``): ``python -m spark_examples_tpu_torch <argv>``,
    or ``python <argv>`` when not ``module``. Output goes to files under
    ``tmp`` (a pipe could fill while another rank is waited on). A rank
    still running after ``MULTIHOST_TIMEOUT_S`` fails the phase, and
    every rank is killed. Returns each rank's rc, stdout, stderr, wall."""
    port = free_port()
    world = len(argvs)
    procs, files = [], []
    t0 = time.perf_counter()
    for r, argv in enumerate(argvs):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(r))
        env.pop("SPARK_EXAMPLES_TPU_FAULTS", None)
        env.update((env_extra or [{}] * world)[r])
        out = open(os.path.join(tmp, f"{name}.rank{r}.out"), "w+")
        err = open(os.path.join(tmp, f"{name}.rank{r}.err"), "w+")
        files.append((out, err))
        cmd = ([sys.executable, "-m", "spark_examples_tpu_torch", *argv]
               if module else [sys.executable, *argv])
        procs.append(subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=out, stderr=err))
    results = []
    try:
        for p in procs:
            left = MULTIHOST_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                fail(f"{name}: a rank ran past {MULTIHOST_TIMEOUT_S} s "
                     "(a collective hung)")
            results.append({"rc": p.returncode,
                            "wall": time.perf_counter() - t0})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for res, (out, err) in zip(results, files):
            out.seek(0)
            err.seek(0)
            res["stdout"], res["stderr"] = out.read(), err.read()
        for out, err in files:
            out.close()
            err.close()
    return results


def rank_metrics(tel: str, world: int = 2) -> list[dict]:
    """Each rank's exported ``metrics.json`` under ``tel``."""
    return [json.load(open(os.path.join(tel, f"rank{r}", "metrics.json")))
            for r in range(world)]


def pad_steps(tel: str, rank: int) -> int:
    """The ``gram.pad_step`` events of a rank's exported trace."""
    with open(os.path.join(tel, f"rank{rank}", "trace.jsonl")) as f:
        return sum(json.loads(line).get("name") == "gram.pad_step"
                   for line in f if line.strip())


def contract_rank(store: str) -> int:
    """One rank of phase 56's broken length claim, run as ``python -c
    "import chip_smoke; chip_smoke.contract_rank(store)"``: rank 1's
    window of the packed store claims one block more than it has; both
    ranks must leave the feeder in its terminal agreement round with the
    contract error. Prints one JSON line; exit 0 either way."""
    from spark_examples_tpu_torch.core import meshes
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.ingest.source import (
        WindowSource,
        window_for_process,
    )
    from spark_examples_tpu_torch.parallel import gram_sharded
    from spark_examples_tpu_torch.parallel import multihost as mh

    meshes.maybe_init_distributed(DEVICE)
    inner = load_packed(store)
    start, stop = window_for_process(inner.n_variants, BLOCK_VARIANTS,
                                     meshes.process_index(),
                                     meshes.process_count())
    src = WindowSource(inner, start, stop)
    if meshes.process_index() == 1:
        real = src

        class Lying:
            exact_n_variants = True
            n_samples = real.n_samples
            n_variants = real.n_variants + BLOCK_VARIANTS
            sample_ids = real.sample_ids
            packed_blocks = real.packed_blocks

            def blocks(self, bv, start_variant=0):
                return real.blocks(bv, start_variant)

        src = Lying()
    plan = gram_sharded.plan_for(
        meshes.make_mesh(meshes.default_devices(DEVICE)), inner.n_samples,
        "ibs", "variant", processes=meshes.process_count())
    t0 = time.perf_counter()
    outcome, steps = "completed", 0
    try:
        for _block, _meta in mh.stream_global_blocks(
                src, BLOCK_VARIANTS, 0, plan, pack=True):
            steps += 1
    except RuntimeError as e:
        outcome = ("contract" if "contract is broken" in str(e)
                   else f"wrong: {e}")
    print(json.dumps({"rank": meshes.process_index(), "outcome": outcome,
                      "steps": steps,
                      "seconds": time.perf_counter() - t0}))
    return 0


def multihost_phases(cli_main, card: str, synthetic_acc: dict,
                     files: dict, tmp: str) -> dict:
    """Phases 54-57: two ranks over gloo with host staging on the pinned
    card. Returns the K1 launches of each run, by path name (each rank
    exports its own ``kernel.packed_gram.launches``)."""
    import torch

    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
        ReferenceRange,
    )
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest.partitioned import PartitionedSource
    from spark_examples_tpu_torch.ingest.source import window_for_process
    from spark_examples_tpu_torch.ops import packed_gram
    from spark_examples_tpu_torch.pipelines import runner

    paths = {}
    store = files["packed_store"]
    blocks = math.ceil(N_VARIANTS / BLOCK_VARIANTS)
    windows = [window_for_process(N_VARIANTS, BLOCK_VARIANTS, r, 2)
               for r in range(2)]
    want_blocks = [math.ceil((b - a) / BLOCK_VARIANTS) for a, b in windows]
    steps = max(want_blocks)
    base = ["pcoa", "--gram-mode", "variant", "--source", "packed",
            "--path", store, "--block-variants", str(BLOCK_VARIANTS),
            "--metric", "ibs", "--num-pc", str(NUM_PC), "--device", DEVICE]

    def load_acc(ck: str) -> dict:
        with open(os.path.join(ck, "manifest.json")) as f:
            manifest = json.load(f)
        return manifest, {k: torch.from_numpy(np.load(
            os.path.join(ck, f"{k}.npy"))) for k in manifest["leaves"]}

    def tsv_coords(path: str) -> np.ndarray:
        with open(path) as f:
            f.readline()
            return np.asarray([line.rstrip("\n").split("\t")[1:]
                               for line in f], dtype=np.float64)

    def launches(metrics: list[dict]) -> list[int]:
        return [int(m["counters"].get("kernel.packed_gram.launches", 0))
                for m in metrics]

    # -- 54. pcoa --gram-mode variant, two ranks --------------------------
    tel, ck = os.path.join(tmp, "mh_tel"), os.path.join(tmp, "mh_ck")
    tsvs = [os.path.join(tmp, f"mh_coords{r}.tsv") for r in range(2)]
    res = run_ranks([base + ["--output-path", tsvs[r], "--telemetry-dir",
                             tel, "--checkpoint-dir", ck,
                             "--checkpoint-every-blocks", str(steps),
                             "--timings"] for r in range(2)],
                    tmp, "mh_pcoa")
    for r, rr in enumerate(res):
        if rr["rc"] != 0:
            fail(f"phase 54: rank {r} exit {rr['rc']}:\n"
                 f"{rr['stderr'][-3000:]}")
    backend = [re.search(r"^multihost: rank (\d) of 2, backend (\S+) on "
                         r"(\S+) \((.*)\)$", rr["stdout"], re.M)
               for rr in res]
    if not all(backend) or {b.group(2) for b in backend} != {"gloo-staged"}:
        fail("phase 54: the ranks did not report the gloo-staged backend: "
             f"{[rr['stdout'][:300] for rr in res]}")
    metrics = rank_metrics(tel)
    k1 = launches(metrics)
    fused = [int(m["counters"].get("gram.fused_blocks", 0))
             for m in metrics]
    waits = [m["histograms"].get("multihost.consensus", {})
             for m in metrics]
    rounds = [w.get("count", 0) for w in waits]
    fed = [int(m["counters"].get("multihost.shard_feed_bytes", 0))
           for m in metrics]
    pads = [pad_steps(tel, r) for r in range(2)]
    gram_s = [m["phases"].get("gram", 0.0) for m in metrics]
    reduce_s = [m["phases"].get("allreduce", 0.0) for m in metrics]
    manifest, acc = load_acc(ck)
    if k1 != want_blocks:
        fail(f"phase 54: K1 launched {k1} times by rank, expected "
             f"{want_blocks} (window_for_process: {windows})")
    if fused != [steps, steps] or rounds != [2, 2] \
            or pads != [steps - b for b in want_blocks]:
        fail(f"phase 54: gram.fused_blocks {fused}, consensus rounds "
             f"{rounds}, pad steps {pads}")
    width = BLOCK_VARIANTS // 4
    if fed != [b * N_SAMPLES * width for b in want_blocks]:
        fail(f"phase 54: shard_feed_bytes {fed}")
    # Each rank's cursor is local to its window: at the end, its length.
    cursors = {str(r): b - a for r, (a, b) in enumerate(windows)}
    if manifest["process_count"] != 2 or manifest["cursors"] != cursors:
        fail(f"phase 54: manifest {manifest['process_count']} processes, "
             f"cursors {manifest['cursors']} (want {cursors})")
    if not equal_accumulators(acc, synthetic_acc):
        fail("phase 54: the two ranks' reduced accumulators differ from "
             "phase 6's one-process run")
    coords = [tsv_coords(t) for t in tsvs if os.path.exists(t)]
    if len(coords) != 1:
        fail(f"phase 54: {len(coords)} coordinate files; rank 0 alone "
             "writes --output-path")
    if not np.array_equal(coords[0], files["packed_store_coords"]):
        err = same_columns(coords[0], files["packed_store_coords"],
                           NUM_POP_PCS, 1e-4)
        fail(f"phase 54: coordinates not bitwise phase 14's ({err:.3g} of "
             "the column scale)")
    paths["pcoa variant, 2 ranks gloo-staged: rank 0"] = {
        "packed_gram": k1[0]}
    paths["pcoa variant, 2 ranks gloo-staged: rank 1"] = {
        "packed_gram": k1[1]}
    print(f"pcoa --gram-mode variant, 2 ranks on one card [{card}]: backend "
          f"{backend[0].group(2)} on {backend[0].group(3)} "
          f"({backend[0].group(4)}); windows {windows}; K1 launches "
          f"{k1[0]} + {k1[1]}; gram.fused_blocks {fused}; consensus rounds "
          f"{rounds} (waits {waits[0].get('sum', 0.0):.4f} / "
          f"{waits[1].get('sum', 0.0):.4f} s, the first holding the other "
          f"rank's start); pad steps {pads}; shard_feed_bytes {fed} (sum "
          f"{sum(fed)}); gram phase by rank {gram_s[0]:.4f} / "
          f"{gram_s[1]:.4f} s (one process, phase 14: "
          f"{files['packed_store_gram_s']:.4f} s); the final all_reduce of "
          f"the four int32 leaves {reduce_s[0]:.4f} / {reduce_s[1]:.4f} s; "
          f"rank walls {res[0]['wall']:.2f} / {res[1]['wall']:.2f} s; "
          "reduced accumulators bitwise phase 6's, coordinates bitwise "
          "phase 14's, cursors " + json.dumps(manifest["cursors"]))

    # -- 55. killed at a block, resumed -----------------------------------
    ck, tel = os.path.join(tmp, "mh_kill_ck"), os.path.join(tmp, "mh_kill")
    kill = ["--checkpoint-dir", ck, "--checkpoint-every-blocks", "2",
            "--prefetch-blocks", "1"]
    spec = f"ingest.block_read:kill:after={MULTIHOST_KILL_AFTER}:max=1"
    res = run_ranks([base + kill] * 2, tmp, "mh_kill",
                    env_extra=[{"SPARK_EXAMPLES_TPU_FAULTS": spec}, {}])
    rcs = [rr["rc"] for rr in res]
    if rcs[0] != 113 or rcs[1] == 0:
        fail(f"phase 55: exit codes {rcs} (rank 0 killed with 113, rank 1 "
             f"failing on the lost peer):\n{res[1]['stderr'][-2000:]}")
    with open(os.path.join(ck, "manifest.json")) as f:
        killed = json.load(f)
    cur = [killed["cursors"][str(r)] for r in range(2)]
    left = [math.ceil((windows[r][1] - windows[r][0] - cur[r])
                      / BLOCK_VARIANTS) for r in range(2)]
    res = run_ranks([base + ["--checkpoint-dir", ck,
                             "--checkpoint-every-blocks", "1",
                             "--telemetry-dir", tel]] * 2, tmp, "mh_resume")
    for r, rr in enumerate(res):
        if rr["rc"] != 0:
            fail(f"phase 55: resumed rank {r} exit {rr['rc']}:\n"
                 f"{rr['stderr'][-3000:]}")
    rk1 = launches(rank_metrics(tel))
    manifest, acc = load_acc(ck)
    if rk1 != left or manifest["cursors"] != cursors:
        fail(f"phase 55: resumed from cursors {cur}: K1 {rk1} (want "
             f"{left}), final cursors {manifest['cursors']}")
    if not equal_accumulators(acc, synthetic_acc):
        fail("phase 55: the resumed accumulators differ from phase 6's")
    paths["pcoa variant, 2 ranks killed, resumed: rank 0"] = {
        "packed_gram": rk1[0]}
    paths["pcoa variant, 2 ranks killed, resumed: rank 1"] = {
        "packed_gram": rk1[1]}
    print(f"2 ranks, rank 0 killed at its block read "
          f"{MULTIHOST_KILL_AFTER + 1} [{card}]: exit codes {rcs}; the "
          f"checkpoint's cursors {cur}; resumed K1 launches {rk1[0]} + "
          f"{rk1[1]} (the blocks after each cursor); accumulators bitwise "
          "phase 6's")

    # -- 56. a straggling rank, then a broken length claim -----------------
    tsv = os.path.join(tmp, "mh_straggle.tsv")
    delay = f"multihost.consensus:delay:delay={MULTIHOST_DELAY_S}:max=0"
    tel = os.path.join(tmp, "mh_straggle")
    res = run_ranks([base + ["--output-path", tsv, "--telemetry-dir", tel]]
                    * 2, tmp, "mh_straggle",
                    env_extra=[{}, {"SPARK_EXAMPLES_TPU_FAULTS": delay}])
    for r, rr in enumerate(res):
        if rr["rc"] != 0:
            fail(f"phase 56: straggling rank {r} exit {rr['rc']}:\n"
                 f"{rr['stderr'][-3000:]}")
    metrics = rank_metrics(tel)
    wait = [m["histograms"].get("multihost.consensus", {}) for m in metrics]
    if not np.array_equal(tsv_coords(tsv), files["packed_store_coords"]):
        fail("phase 56: the straggled job's coordinates differ from "
             "phase 14's")
    if not wait[0].get("mean", 0.0) > wait[1].get("mean", 0.0):
        fail(f"phase 56: the consensus wait {wait} does not show on the "
             "rank that did not straggle")
    res = run_ranks([["-c", "import sys, chip_smoke; sys.exit("
                      "chip_smoke.contract_rank(sys.argv[1]))", store]] * 2,
                    tmp, "mh_contract", module=False)
    outs = []
    for r, rr in enumerate(res):
        if rr["rc"] != 0:
            fail(f"phase 56: contract rank {r} exit {rr['rc']}:\n"
                 f"{rr['stderr'][-3000:]}")
        outs.append(json.loads(rr["stdout"].strip().splitlines()[-1]))
    if [o["outcome"] for o in outs] != ["contract", "contract"]:
        fail(f"phase 56: the broken length claim gave {outs}")
    print(f"2 ranks, rank 1 delayed {MULTIHOST_DELAY_S} s before each "
          f"consensus round [{card}]: coordinates bitwise phase 14's; "
          f"consensus wait mean / p95 by rank "
          f"{wait[0].get('mean', 0) * 1e3:.1f} / "
          f"{wait[0].get('p95', 0) * 1e3:.1f} ms and "
          f"{wait[1].get('mean', 0) * 1e3:.1f} / "
          f"{wait[1].get('p95', 0) * 1e3:.1f} ms; rank walls "
          f"{res[0]['wall']:.2f} / {res[1]['wall']:.2f} s of the contract "
          f"run. A broken length claim on rank 1: both ranks raised the "
          f"contract error in the agreement round after {outs[0]['steps']} "
          f"/ {outs[1]['steps']} steps, {outs[0]['seconds']:.2f} / "
          f"{outs[1]['seconds']:.2f} s into the feed")

    # -- 57. --splits-per-contig 4 on a --references route ----------------
    lo, hi = REFERENCE_RANGE
    ref = [ReferenceRange.parse(f"1:{lo}:{hi}")]
    accs, k1s, walls = {}, {}, {}
    for splits in (1, 4):
        cfg = IngestConfig(source="plink", path=files["plink"],
                           references=ref, block_variants=BLOCK_VARIANTS,
                           splits_per_contig=splits)
        job = JobConfig(ingest=cfg, compute=ComputeConfig(metric="ibs",
                                                          device=DEVICE))
        src = runner.build_source(cfg, DEVICE)
        if splits > 1 and not isinstance(src.inner, PartitionedSource):
            fail(f"phase 57: --splits-per-contig {splits} built "
                 f"{type(src.inner).__name__}")
        packed_gram.launches = 0
        t0 = time.perf_counter()
        g = runner.run_gram(job, src, PhaseTimer())
        walls[splits] = time.perf_counter() - t0
        k1s[splits] = packed_gram.launches
        accs[splits] = {k: v.cpu() for k, v in g.acc.items()}
    if not equal_accumulators(accs[4], accs[1]):
        fail("phase 57: --splits-per-contig 4 accumulators differ from "
             "1 split's")
    paths["pcoa plink --references --splits-per-contig 4"] = {
        "packed_gram": k1s[4]}
    print(f"--source plink --references 1:{lo}:{hi} [{card}]: "
          f"--splits-per-contig 4 (4 concurrent range readers, "
          f"{k1s[4]} K1 launches: the block grid restarts per sub-range) "
          f"bitwise 1 split ({k1s[1]} launches); run_gram "
          f"{walls[4]:.3f} / {walls[1]:.3f} s")
    return paths


# Phases 58-62: tile2d across two ranks on the pinned card (gloo with
# host staging), two virtual slots a rank on a 2x2 mesh spanning both.
RANK_SLOTS = 2
RANK_MESH_ARGS = ["--virtual-devices", str(RANK_SLOTS), "--mesh-shape",
                  "2x2", "--gram-mode", "tile2d"]
# The two-rank coordinates are held bitwise to the one-process 2x2 run's
# (phase 48): the same tiles, the B @ Q blocks added in slot order, the
# subspace on rank 0, and Q row-major in every product on every rank
# (parallel/pcoa_sharded.py::tiled_matmul). Without that last, the
# second product's blocks on rank 1's slots differed in the last bits on
# an H100: rank 0 multiplied the QR's column-major Q, rank 1 its
# received row-major copy, and cuBLAS sums the two layouts in different
# orders (bitwise on the CPU either way).
RANK_JOBS = (("gather", ["pcoa", "--metric", "ibs", "--tile2d-transport",
                         "gather"]),
             ("ring", ["pcoa", "--metric", "ibs", "--tile2d-transport",
                       "ring"]),
             ("pca", ["pca"]))


def rank_store_args(store: str) -> list[str]:
    return ["--source", "packed", "--path", store, "--block-variants",
            str(BLOCK_VARIANTS), "--device", DEVICE, "--num-pc",
            str(NUM_PC)] + RANK_MESH_ARGS


def tile2d_rank(store: str, tmp: str) -> int:
    """One rank of phases 58-60, run as ``python -c "import sys,
    chip_smoke; sys.exit(chip_smoke.tile2d_rank(store, tmp))"``: the
    three jobs of ``RANK_JOBS`` through the CLI's ``main`` in one process
    (one rank pair's start for all three). For each, K1's launch count
    is set to 0 just before and read just after, beside the counters'
    deltas and the phase timings; this rank's tiles are saved under
    ``tmp`` as ``{job}.{leaf}.{slot}.npy``, and rank 0 writes
    ``{job}.tsv``. Prints one JSON line a job."""
    from spark_examples_tpu_torch.cli.main import main as cli_main
    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.ops import packed_gram
    from spark_examples_tpu_torch.pipelines import runner

    rank = int(os.environ["JAX_PROCESS_ID"])
    counters = ("gram.fused_blocks", "gram.ring_steps")
    for name, argv in RANK_JOBS:
        before = {n: telemetry.counter_value(n) for n in counters}
        kept: list = []
        orig = keeping(runner, "run_gram", kept)
        err = io.StringIO()
        packed_gram.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err):
                rc = cli_main(argv + rank_store_args(store) + [
                    "--output-path", os.path.join(tmp, f"{name}.tsv"),
                    "--timings"])
        finally:
            setattr(runner, "run_gram", orig)
        wall = time.perf_counter() - t0
        k1 = packed_gram.launches
        if rc != 0:
            print(err.getvalue()[-3000:], file=sys.stderr)
            return rc
        timings = json.loads(next(line for line in reversed(
            err.getvalue().strip().splitlines()) if line.startswith("{")))
        grun = kept[-1]
        for k, v in grun.acc.items():
            for s, t in v.local():
                np.save(os.path.join(tmp, f"{name}.{k}.{s}.npy"),
                        t.cpu().numpy())
        mesh = grun.plan.mesh
        print(json.dumps({
            "job": name, "rank": rank, "k1": k1, "wall": wall,
            "counters": {n: int(telemetry.counter_value(n) - before[n])
                         for n in counters},
            "timings": timings, "mesh": list(mesh.shape),
            "local": list(mesh.local_slots), "describe": mesh.describe(),
            "mesh_line": next((line for line in err.getvalue().splitlines()
                               if line.startswith("mesh: ")), "")}),
            flush=True)
        del grun, kept
    return 0


def tiles_from(tile_files, leaves, shape=(2, 2)) -> dict:
    """Whole int32 accumulators assembled from per-slot tile files:
    ``tile_files(leaf)`` lists ``(path, slot)`` of every slot's tile."""
    import torch

    tn, tm = N_SAMPLES // shape[0], N_SAMPLES // shape[1]
    out = {}
    for k in leaves:
        full = torch.zeros((N_SAMPLES, N_SAMPLES), dtype=torch.int32)
        for path, s in tile_files(k):
            i, j = divmod(s, shape[1])
            full[i * tn:(i + 1) * tn, j * tm:(j + 1) * tm] = \
                torch.from_numpy(np.load(path))
        out[k] = full
    return out


def tile2d_ranks_phases(cli_main, card: str, dev, synthetic_acc: dict,
                        pca_coords: np.ndarray, files: dict,
                        tmp: str) -> tuple[dict, dict]:
    """Phases 58-62: tile2d across two ranks on the pinned card. Returns
    (the K1 launches of each run by path name, each rank's own count;
    K1's timings at the new launch shapes)."""
    import torch

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.ingest.source import window_for_process

    paths = {}
    store = files["packed_store"]
    windows = [window_for_process(N_VARIANTS, BLOCK_VARIANTS, r, 2)
               for r in range(2)]
    want_blocks = [math.ceil((b - a) / BLOCK_VARIANTS) for a, b in windows]
    steps = max(want_blocks)
    ibs = kernels.get("ibs").pieces
    leaves = {"gather": ibs, "ring": ibs, "pca": ("t1t1",)}

    # -- 58-60. three jobs in one rank pair --------------------------------
    out = os.path.join(tmp, "t2d")
    os.makedirs(out)
    res = run_ranks([["-c", "import sys, chip_smoke; sys.exit(chip_smoke."
                      "tile2d_rank(sys.argv[1], sys.argv[2]))", store, out]]
                    * 2, tmp, "t2d_jobs", module=False)
    for r, rr in enumerate(res):
        if rr["rc"] != 0:
            fail(f"phases 58-60: rank {r} exit {rr['rc']}:\n"
                 f"{rr['stderr'][-3000:]}")
    rec = {}
    for rr in res:
        for line in rr["stdout"].splitlines():
            if line.startswith('{"job"'):
                o = json.loads(line)
                rec[o["job"], o["rank"]] = o
    if len(rec) != 2 * len(RANK_JOBS):
        fail(f"phases 58-60: job records {sorted(rec)}")
    want = {"gather": (RANK_SLOTS * steps, 0),
            "ring": (RANK_SLOTS * MESH_SLOTS * steps, MESH_SLOTS * steps),
            "pca": (RANK_SLOTS * steps, 0)}
    coords = {}
    for name, _argv in RANK_JOBS:
        k1_want, ring_want = want[name]
        by_rank = [rec[name, r] for r in range(2)]
        k1 = [o["k1"] for o in by_rank]
        fused = [o["counters"]["gram.fused_blocks"] for o in by_rank]
        ring = [o["counters"]["gram.ring_steps"] for o in by_rank]
        local = [o["local"] for o in by_rank]
        if (k1 != [k1_want] * 2 or fused != [steps] * 2
                or ring != [ring_want] * 2 or local != [[0, 1], [2, 3]]
                or {tuple(o["mesh"]) for o in by_rank} != {(2, 2)}):
            fail(f"phase {name}: K1 {k1} (want {k1_want} a rank), "
                 f"fused_blocks {fused}, ring_steps {ring} (want "
                 f"{ring_want}), local slots {local}")
        acc = tiles_from(lambda k: [(os.path.join(out, f"{name}.{k}.{s}.npy"),
                                     s) for s in range(MESH_SLOTS)],
                         leaves[name])
        if not equal_accumulators(
                acc, {k: synthetic_acc[k] for k in leaves[name]}):
            fail(f"phase {name}: the tiles of both ranks, assembled, "
                 "differ from phase 6's accumulators")
        tsv = os.path.join(out, f"{name}.tsv")
        with open(tsv) as f:
            f.readline()
            coords[name] = np.asarray([line.rstrip("\n").split("\t")[1:]
                                       for line in f], dtype=np.float64)
        paths[f"{'pca' if name == 'pca' else 'pcoa ibs'} tile2d "
              f"{'' if name == 'pca' else name + ' '}2 ranks x 2 slots: "
              "rank 0"] = {"packed_gram": k1[0]}
        paths[f"{'pca' if name == 'pca' else 'pcoa ibs'} tile2d "
              f"{'' if name == 'pca' else name + ' '}2 ranks x 2 slots: "
              "rank 1"] = {"packed_gram": k1[1]}
    # Coordinates: the gather run's against the one-process 2x2 run.
    if not np.array_equal(coords["gather"],
                          files["mesh_coords"]["tile2d gather"]):
        fail("phase 58: the two-rank coordinates differ from phase 48's")
    if not np.array_equal(coords["ring"], coords["gather"]):
        fail("phase 59: the ring's coordinates differ from the gather's")
    dense_err = same_columns(coords["gather"], files["packed_store_coords"],
                             NUM_POP_PCS, MESH_COORD_TOL)
    pca_err = same_columns(coords["pca"], pca_coords, NUM_POP_PCS,
                           MESH_COORD_TOL)

    def phases_by_rank(name):
        return "; ".join(
            f"rank {r}: wall {rec[name, r]['wall']:.3f} s, "
            + phases_line(rec[name, r]["timings"],
                          ("gram", "finalize", "eigh"))
            for r in range(2))

    print(f"pcoa --gram-mode tile2d --tile2d-transport gather, 2 ranks on "
          f"one card [{card}]: {rec['gather', 0]['mesh_line']}; windows "
          f"{windows}; K1 launches {rec['gather', 0]['k1']} + "
          f"{rec['gather', 1]['k1']} (2 tiles a rank x {steps} global "
          "steps, rank 1's pad slab contracted), gram.fused_blocks "
          f"{steps} / {steps}; {phases_by_rank('gather')}; the tiles of "
          "both ranks bitwise phase 6's; coordinates bitwise phase 48's "
          f"(one process, 2x2 gather); structure PCs within {dense_err:.2g}"
          " of phase 14's dense solve")
    print(f"pcoa --tile2d-transport ring, 2 ranks [{card}]: K1 launches "
          f"{rec['ring', 0]['k1']} + {rec['ring', 1]['k1']} "
          f"({RANK_SLOTS} tiles x {MESH_SLOTS} ring steps x {steps}, "
          f"1024-byte shards), gram.ring_steps "
          f"{rec['ring', 0]['counters']['gram.ring_steps']} / "
          f"{rec['ring', 1]['counters']['gram.ring_steps']}; "
          f"{phases_by_rank('ring')}; tiles bitwise phase 6's; coordinates "
          "bitwise the gather run's")
    print(f"pca --gram-mode tile2d, 2 ranks [{card}]: K1 launches "
          f"{rec['pca', 0]['k1']} + {rec['pca', 1]['k1']}; "
          f"{phases_by_rank('pca')}; t1t1 bitwise phase 6's; structure PCs "
          f"within {pca_err:.2g} of phase 11's dense pca")

    # -- 61. a tiled checkpoint across the ranks, killed and resumed -------
    ck = os.path.join(tmp, "t2d_ck")
    tel = os.path.join(tmp, "t2d_resume")
    base = (["pcoa", "--metric", "ibs", "--tile2d-transport", "gather"]
            + rank_store_args(store))
    spec = f"ingest.block_read:kill:after={MULTIHOST_KILL_AFTER}:max=1"
    res = run_ranks([base + ["--checkpoint-dir", ck,
                             "--checkpoint-every-blocks", "2",
                             "--prefetch-blocks", "1"]] * 2, tmp,
                    "t2d_kill", env_extra=[
                        {"SPARK_EXAMPLES_TPU_FAULTS": spec}, {}])
    rcs = [rr["rc"] for rr in res]
    if rcs[0] != 113 or rcs[1] == 0:
        fail(f"phase 61: exit codes {rcs} (rank 0 killed with 113, rank 1 "
             f"failing on the lost peer):\n{res[1]['stderr'][-2000:]}")
    with open(os.path.join(ck, "manifest.json")) as f:
        killed = json.load(f)
    listing = sorted(os.listdir(ck))
    tile_files = [f for f in listing if ".t" in f]
    if (killed["process_count"] != 2 or killed["mesh_shape"] != [2, 2]
            or killed["mode"] != "tile2d"
            or set(killed["layout"].values()) != {"tiles"}
            or len(tile_files) != len(ibs) * MESH_SLOTS
            or any(f.startswith("checksums.") for f in listing)
            or sorted(killed["cursors"]) != ["0", "1"]):
        keys = ("process_count", "mesh_shape", "mode", "cursors")
        fail(f"phase 61: killed manifest { {k: killed[k] for k in keys} }, "
             f"files {listing}")
    cur = [killed["cursors"][str(r)] for r in range(2)]
    left = max(math.ceil((windows[r][1] - windows[r][0] - cur[r])
                         / BLOCK_VARIANTS) for r in range(2))
    res = run_ranks([base + ["--checkpoint-dir", ck,
                             "--checkpoint-every-blocks", "1",
                             "--telemetry-dir", tel]] * 2, tmp,
                    "t2d_resume")
    for r, rr in enumerate(res):
        if rr["rc"] != 0:
            fail(f"phase 61: resumed rank {r} exit {rr['rc']}:\n"
                 f"{rr['stderr'][-3000:]}")
    metrics = rank_metrics(tel)
    rk1 = [int(m["counters"].get("kernel.packed_gram.launches", 0))
           for m in metrics]
    written = [int(m["counters"].get("checkpoint.bytes_written", 0))
               for m in metrics]
    tile_bytes = 4 * (N_SAMPLES // 2) ** 2
    with open(os.path.join(ck, "manifest.json")) as f:
        final = json.load(f)
    listing = sorted(os.listdir(ck))
    cursors = {str(r): b - a for r, (a, b) in enumerate(windows)}
    if (rk1 != [RANK_SLOTS * left] * 2
            or written != [left * len(ibs) * RANK_SLOTS * tile_bytes] * 2
            or final["cursors"] != cursors
            or any(f.startswith("checksums.") for f in listing)):
        fail(f"phase 61: resumed from cursors {cur}: K1 {rk1} (want "
             f"{RANK_SLOTS * left} a rank), checkpoint bytes written "
             f"{written}, final cursors {final['cursors']}, files "
             f"{listing}")
    tn = N_SAMPLES // 2
    acc = tiles_from(lambda k: [(os.path.join(ck, f"{k}.t{i * tn}_{j * tn}"
                                              ".npy"), 2 * i + j)
                                for i in range(2) for j in range(2)], ibs)
    if not equal_accumulators(acc, synthetic_acc):
        fail("phase 61: the resumed tiles differ from phase 6's")
    paths["pcoa ibs tile2d 2 ranks killed, resumed: rank 0"] = {
        "packed_gram": rk1[0]}
    paths["pcoa ibs tile2d 2 ranks killed, resumed: rank 1"] = {
        "packed_gram": rk1[1]}
    print(f"tiled checkpoint across 2 ranks [{card}]: rank 0 killed at its "
          f"block read {MULTIHOST_KILL_AFTER + 1}, exit codes {rcs}; "
          f"{len(tile_files)} tile files ({tile_files[0]} ...), no checksum "
          f"sidecar left, manifest process_count {killed['process_count']}"
          f", mesh_shape {killed['mesh_shape']}, mode {killed['mode']}, "
          f"cursors {cur}; resumed K1 launches {rk1[0]} + {rk1[1]} ("
          f"{RANK_SLOTS} tiles x {left} global steps after the cursors); "
          f"each rank wrote its own tiles (checkpoint bytes {written[0]} / "
          f"{written[1]}); the final checkpoint's tiles bitwise phase 6's")

    # -- 62. K1 at the new launch shapes -----------------------------------
    it = load_packed(store).packed_blocks(BLOCK_VARIANTS)
    packed = [b for _, (b, _m) in zip(range(steps + 1), it)]
    # Global step 1: rank 0's first block beside rank 1's (block 7).
    whole = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [packed[0], packed[steps]], axis=1))).to(dev)
    shard = whole[:, whole.shape[1] // 2:][:, :whole.shape[1] // MESH_SLOTS]
    shard = shard.contiguous()
    shapes = (
        ("gathered block, rectangular tile", whole[:tn], whole[tn:]),
        ("gathered block, diagonal tile", whole[:tn].contiguous(), None),
        ("cross-rank ring shard, rectangular", shard[:tn], shard[tn:]),
    )
    timings = {name: time_k1_shape(name, rows, cols, ibs, card)
               for name, rows, cols in shapes}
    return paths, timings


def flip_file(path: str) -> None:
    """Flip one bit of the last byte of a file (same size)."""
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0x10]))


# Phase 63: the rule ids of the port's graftlint suite (those of the JAX
# package's tools/graftlint).
LINT_RULES = 8


def lint_phase(card: str) -> None:
    """Phase 63: the ``lint`` verb, run as a user would, in subprocesses
    of an interpreter that cannot import jax here."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for name, args in (("lint", ["lint"]),
                       ("list-rules", ["lint", "--list-rules"])):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "spark_examples_tpu_torch", *args],
            cwd=here, capture_output=True, text=True, timeout=300)
        runs[name] = (res, time.perf_counter() - t0)
        if res.returncode != 0:
            fail(f"{' '.join(args)} exited {res.returncode}:\n"
                 f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
    lint, lint_s = runs["lint"]
    if "graftlint: clean" not in lint.stdout:
        fail(f"lint did not report clean:\n{lint.stdout[-4000:]}")
    listed, list_s = runs["list-rules"]
    rules = [line.split(":", 1)[0] for line in listed.stdout.splitlines()
             if line.strip()]
    if len(rules) != LINT_RULES:
        fail(f"lint --list-rules listed {len(rules)} rules, expected "
             f"{LINT_RULES}: {rules}")
    print(f"lint: graftlint: clean over the port and chip_smoke.py in "
          f"{lint_s:.1f} s; --list-rules {len(rules)} rules in "
          f"{list_s:.1f} s ({', '.join(rules)}) [{card}]")


# Phase 64: bench_torch.py's configs at full width, reduced depth.
BENCH_VARIANTS = 131_072
BENCH_PASSES = 3
BENCH_TILE_N = 8192
BENCH_SKETCH_N = 2500
BENCH_STREAM_WARM_BLOCKS = 4


def bench_phase(card: str, tmp: str) -> tuple[dict, dict]:
    """Phase 64: ``bench_torch``'s config functions, in this process, at
    2504 samples over 131,072 variants (configs 1, 2 and 5), config 3 at
    its own shape, config 4 at N_eq 8,192, the sketch at 2,500; K1 at
    the streamed and staged launch shapes. Returns the launches by path
    and K1's timings at the two shapes."""
    import torch

    import bench_torch as bt
    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.ops import braycurtis_kernel, packed_gram

    t_phase = time.perf_counter()
    syn = dict(bt.SYN, n_variants=BENCH_VARIANTS)
    store = bt.cohort_store(os.path.join(tmp, "bench_cache"), syn)
    blocks = BENCH_VARIANTS // bt.BLOCK
    staged_blocks = BENCH_VARIANTS // bt.STAGED_BLOCK
    counts, seconds = {}, {}

    def run(name, fn, *args, **kw):
        k1_0 = packed_gram.launches
        k2_0 = braycurtis_kernel.launches
        tel_0 = telemetry.counter_value("kernel.packed_gram.launches")
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        counts[name] = {
            "packed_gram": packed_gram.launches - k1_0,
            "braycurtis": braycurtis_kernel.launches - k2_0,
            "telemetry": telemetry.counter_value(
                "kernel.packed_gram.launches") - tel_0,
        }
        return out

    streamed = run("streamed", bt.streamed_run, store)
    # The streamed run resets the registry after its warm run: the
    # counter holds its timed launches.
    counts["streamed"]["telemetry"] = telemetry.counter_value(
        "kernel.packed_gram.launches")
    cohort = bt.StagedCohort(store)
    staged = run("staged", bt.staged_run, cohort)
    autosomes = run("autosomes", bt.measured_autosomes, cohort,
                    autosome_variants=BENCH_PASSES * BENCH_VARIANTS)
    del cohort
    base = run("cpu_baseline", bt.cpu_baseline, store,
               cache=os.path.join(tmp, "bench_cache"))
    tunnel = bt.measure_tunnel()
    configs = bt.config12_records(
        streamed, staged, autosomes, base, tunnel,
        autosome_variants=BENCH_PASSES * BENCH_VARIANTS)
    configs["config3"] = run("config3", bt.bench_braycurtis)
    configs["config4"] = run("config4", bt.bench_tile_rate,
                             n_eq=BENCH_TILE_N)
    configs["config4"]["solve"] = run("config4_solve", bt.bench_tile_solve,
                                      n_eq=BENCH_TILE_N)
    configs["config5"] = run("config5", bt.bench_streaming, store,
                             nv=BENCH_VARIANTS,
                             warm_blocks=BENCH_STREAM_WARM_BLOCKS, syn=syn)
    configs["sketch"] = run("sketch", bt.bench_sketch, n_sk=BENCH_SKETCH_N)
    torch.cuda.empty_cache()

    warm = BENCH_STREAM_WARM_BLOCKS
    expected = {
        "streamed": {"packed_gram": blocks + 2, "braycurtis": 0,
                     "telemetry": blocks},
        "staged": {"packed_gram": 2 * staged_blocks, "braycurtis": 0},
        "autosomes": {"packed_gram": (BENCH_PASSES + 1) * staged_blocks,
                      "braycurtis": 0},
        "cpu_baseline": {"packed_gram": 0, "braycurtis": 0},
        "config3": {"packed_gram": 0, "braycurtis": 2},
        "config4": {"packed_gram": 0, "braycurtis": 0},
        "config4_solve": {"packed_gram": 0, "braycurtis": 0},
        "config5": {"packed_gram": 2 * (blocks + warm), "braycurtis": 0},
        "sketch": {"packed_gram": 0, "braycurtis": 0},
    }
    for name, want in expected.items():
        want = {"telemetry": want["packed_gram"], **want}
        if counts[name] != want:
            fail(f"bench {name}: launches {counts[name]}, expected {want}")
    if configs["config3"]["pallas_vs_exact_maxerr"] != 0.0:
        fail("bench config3: K2 disagrees with the exact lowering on the "
             f"integer table ({configs['config3']['pallas_vs_exact_maxerr']})")
    seps = {name: bt.check_structure(coords, syn) for name, coords in (
        ("streamed", streamed["coords"]), ("staged", staged["coords"]),
        ("autosomes", autosomes["coords"]),
        ("streaming_pcoa", configs["config5"].pop("coords")))}
    for name, sep in seps.items():
        if not sep > 3.0:
            fail(f"bench {name}: structure separation {sep:.2f} <= 3")
    if any("error" in c for c in configs.values()):
        fail(f"bench: a config holds an error: {configs}")
    headline = bt.add_lint(bt.make_headline(streamed, staged, base, tunnel,
                                            configs))
    if set(headline) != set(bt.HEADLINE_KEYS):
        fail(f"bench headline keys {sorted(headline)} != "
             f"{sorted(bt.HEADLINE_KEYS)}")
    if not (headline["sketch_ok"] and headline["lint_ok"]):
        fail(f"bench headline gates: sketch_ok {headline['sketch_ok']}, "
             f"lint_ok {headline['lint_ok']}")

    rng = np.random.default_rng(64)
    ibs = kernels.get("ibs").pieces
    shapes = {}
    for name, w in (("bench streamed block", bt.BLOCK // 4),
                    ("bench staged block", bt.STAGED_BLOCK // 4)):
        rows = torch.from_numpy(rng.integers(
            0, 256, (bt.N_SAMPLES, w), dtype=np.uint8)).to(DEVICE)
        shapes[name] = time_k1_shape(name, rows, None, ibs, card)
        shapes[name]["bound_full_ms"] = k1_bounds(
            bt.N_SAMPLES, w, ibs)["bound_full_ms"]
    del rows
    c3, c4 = configs["config3"], configs["config4"]
    print(f"bench [{card}]: 2504 x {BENCH_VARIANTS}; streamed "
          f"{streamed['total_s']:.4f} s, staged {staged['total_s']:.4f} s "
          f"(gram {staged['gram_s']:.4f} s, "
          f"{staged['gram_tflops']:.1f} TOP/s), config2 "
          f"{BENCH_PASSES} passes gram "
          f"{autosomes['measured_chip_gram_s']} s, host baseline "
          f"{base['total_s']:.1f} s projected ({base['host_cpu']}); "
          f"config3 matmul {c3['matmul_s']} s, K2 {c3['pallas_s']} s, "
          f"exact 2500 {c3['exact_2500_s']} s; config4 at {BENCH_TILE_N} "
          f"{c4['tflops_per_chip']} TOP/s, solve "
          f"{c4['solve']['proxy_wall_s']} s; config5 "
          f"{configs['config5']['total_s']} s vs "
          f"{configs['config5']['plain_stream_s']} s plain; sketch "
          f"{configs['sketch']['sketch_s']} s (relerr "
          f"{configs['sketch']['relerr_vs_exact_2500']}); separations "
          + ", ".join(f"{k} {v:.1f}" for k, v in seps.items())
          + f"; launches {counts}; headline keys as bench.py's, sketch_ok "
          f"and lint_ok true; seconds "
          + json.dumps({k: round(v, 2) for k, v in seconds.items()})
          + f"; phase 64 took {time.perf_counter() - t_phase:.1f} s")
    paths = {f"bench {name}": {k: v for k, v in c.items()
                               if k != "telemetry"}
             for name, c in counts.items()}
    return paths, shapes


# Phase 65: bench_torch.py's subsystem rows at reduced depth.
ROWS_KERNEL_BLOCKS = 4
ROWS_STORE_VARIANTS = 4096
ROWS_SERVE_VARIANTS = 16_384
ROWS_NEIGHBORS_SAMPLES = 256
ROWS_SKETCH_SERVE = (2000, 16_384, 4096)  # samples, variants, block
# The controller's burst here: at the JAX bench's (20 QPS, bursts of 8x
# over 6 s) one replica on the card never queues and the controller never
# scales (the full row records that); this burst makes it scale, so the
# phase drives the spawn, the kill and the failovers on the card.
ROWS_CONTROLLER_BURST = {"duration_s": 2.0, "base_qps": 1000.0}


def bench_rows_phase(card: str, tmp: str) -> dict:
    """Phase 65: ``bench_torch``'s subsystem rows, in this process, at
    reduced depth (the phase 64 cohort, cached in ``tmp``, or made).
    Returns the K1 / K2 launches by row."""
    import torch

    import bench_torch as bt
    from spark_examples_tpu_torch.ops import braycurtis_kernel, packed_gram

    t_phase = time.perf_counter()
    store = bt.cohort_store(os.path.join(tmp, "bench_cache"),
                            dict(bt.SYN, n_variants=BENCH_VARIANTS))
    cache = os.path.join(tmp, "rows_cache")
    sk_n, sk_v, sk_block = ROWS_SKETCH_SERVE
    rows = {
        "kernels": (bt.bench_kernels, (store,),
                    {"n_variants": ROWS_KERNEL_BLOCKS * bt.BLOCK}),
        "store": (bt.bench_store, (store,),
                  {"n_variants": ROWS_STORE_VARIANTS, "cache": cache}),
        "serve": (bt.bench_serve, (store,),
                  {"n_variants": ROWS_SERVE_VARIANTS, "cache": cache}),
        "fleet": (bt.bench_fleet, (), {"cache": cache}),
        "controller": (bt.bench_controller, (),
                       {**ROWS_CONTROLLER_BURST, "cache": cache}),
        "neighbors": (bt.bench_neighbors, (),
                      {"n": ROWS_NEIGHBORS_SAMPLES, "cache": cache}),
        "sketch_serve": (bt.bench_sketch_serve, (),
                         {"n": sk_n, "nv": sk_v, "block": sk_block,
                          "cache": cache}),
    }
    # K1 by row: the fused column's 6 x (1 warm + blocks); one block for
    # each store job and the model fit (a fresh cache); the serve panel's
    # fit; the fleet's three route fits and the controller's two (packed
    # ArraySource streams); the neighbors row's dense route and panel fit
    # (4 blocks of 1,024 each). No K1 on the serving, sketch or
    # projection paths.
    want_k1 = {"kernels": 6 * (1 + ROWS_KERNEL_BLOCKS), "store": 3,
               "serve": 1, "fleet": 3, "controller": 2,
               "neighbors": 2 * (bt.NEIGHBORS_VARIANTS // 1024),
               "sketch_serve": 0}
    configs, counts, seconds = {}, {}, {}
    for name, (fn, args, kw) in rows.items():
        k1_0 = packed_gram.launches
        k2_0 = braycurtis_kernel.launches
        t0 = time.perf_counter()
        try:
            configs[name] = fn(*args, **kw)
        except Exception as e:
            fail(f"bench row {name}: {e!r}")
        seconds[name] = time.perf_counter() - t0
        counts[name] = {"packed_gram": packed_gram.launches - k1_0,
                        "braycurtis": braycurtis_kernel.launches - k2_0}
        torch.cuda.empty_cache()
    for name, c in counts.items():
        want = {"packed_gram": want_k1[name], "braycurtis": 0}
        if c != want or configs[name]["k1_launches"] != want_k1[name]:
            fail(f"bench row {name}: launches {c} (the row's own count "
                 f"{configs[name]['k1_launches']}), expected {want}")

    kr, sr, sv = configs["kernels"], configs["store"], configs["serve"]
    fl, ct, nb = configs["fleet"], configs["controller"], configs["neighbors"]
    sk = configs["sketch_serve"]
    unmatched = [k for k, r in kr["per_kernel"].items()
                 if "fused_match" in r and not r["fused_match"]]
    fused = [k for k, r in kr["per_kernel"].items() if "fused_match" in r]
    gates = {
        "kernels: fused_match for all six": not unmatched and len(fused) == 6,
        "store: pcoa_bit_identical": sr["pcoa_bit_identical"],
        "store: compaction byte-identical at 1 and 4 workers":
            sr["compact_deterministic_w4_vs_w1"],
        "serve: served == offline": sv["bit_identical_vs_offline"],
        "serve: clean drain": sv["clean_drain"],
        "fleet: served == offline": fl["bit_identical_vs_offline"],
        "fleet: clean drain": fl["clean_drain"],
        "fleet: pool under budget": fl["pool_under_budget"],
        "fleet: stores clean": fl["stores_clean"],
        "fleet: no errors": fl["mix"]["errors"] == 0
            and fl["hedge_errors"] == 0,
        "controller: threads joined": not ct["threads_left"],
        "controller: no errors": ct["loss_errors"] == 0,
        "neighbors: served == offline": nb["bit_identical_vs_offline"],
        "neighbors: ok": nb["ok"],
        "sketch-serve: ok (identity, rung, drain, shards, rig)": sk["ok"],
    }
    failed = [g for g, held in gates.items() if not held]
    if failed:
        fail(f"bench rows: gates failed {failed}; records "
             + json.dumps({k: {f: v for f, v in r.items()
                               if not isinstance(v, (dict, list))}
                           for k, r in configs.items()}))
    headline = bt.add_rows({}, configs)
    headline.update(bt.sketch_serve_headline(sk))
    speed = {k: headline[k] for k in (
        "kernel_fused_ok", "kernel_fused_min_speedup", "store_ok",
        "fleet_ok", "controller_ok", "controller_scale_up_s")}
    speed["hedged_p99_s"] = fl["hedge_hedged_p99_s"]
    speed["unhedged_p99_s"] = fl["hedge_unhedged_p99_s"]
    fused_speedups = {k: r["fused_speedup"]
                      for k, r in kr["per_kernel"].items()
                      if "fused_speedup" in r}
    print(f"bench rows [{card}]: headline "
          + json.dumps(headline)
          + "; fused speedup by kernel " + json.dumps(fused_speedups)
          + "; speed gates (recorded, not enforced) " + json.dumps(speed)
          + f"; launches {counts}; seconds "
          + json.dumps({k: round(v, 2) for k, v in seconds.items()})
          + f"; phase 65 took {time.perf_counter() - t_phase:.1f} s")
    return {f"bench --{name.replace('_', '-')}": c
            for name, c in counts.items()}


def main() -> int:
    # One card: with more visible, a job's default mesh would be every
    # card (``core/meshes.py::default_devices``) and phases 1-47 would
    # take the variant route; the mesh phases put their slots on it.
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible — this script runs "
              "only on an NVIDIA GPU", file=sys.stderr)
        return 1

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.cli.main import main as cli_main
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
    )
    from spark_examples_tpu_torch.core.profiling import PhaseTimer
    from spark_examples_tpu_torch.ingest import bitpack
    from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
    from spark_examples_tpu_torch.ops import cuda_build, distances, genotype
    from spark_examples_tpu_torch.ops import braycurtis_kernel, packed_gram
    from spark_examples_tpu_torch.pipelines import runner

    launch_counters = {"packed_gram": packed_gram,
                       "braycurtis": braycurtis_kernel}

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch.cuda.get_device_name(0) = {kind} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device(DEVICE)

    # -- 2. build ---------------------------------------------------------
    # The host codec (g++) builds in a thread beside the nvcc processes.
    from spark_examples_tpu_torch import native

    t0 = time.perf_counter()
    codec_s = {}

    def build_codec():
        native.load()
        codec_s["s"] = time.perf_counter() - t0

    codec_thread = threading.Thread(target=build_codec,
                                    name="chip-smoke-codec-build",
                                    daemon=True)
    codec_thread.start()
    reports = cuda_build.build_all()
    cuda_s = time.perf_counter() - t0
    codec_thread.join()
    if native.load() is None:
        fail(f"the native host codec did not build: {native.build_error}")
    print(f"build: {sorted(reports)} in {cuda_s:.1f} s; the native host "
          f"codec ({native.library_path().name}) in {codec_s['s']:.1f} s")
    for name, rep in reports.items():
        print(f"--- ptxas report, csrc/{name}.cu ---\n{rep.strip()}")
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", rep)]
        if not spills or any(spills):
            fail(f"csrc/{name}.cu: ptxas reports spills (or no report): "
                 f"{spills}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    k1_names = []  # K1's kernel identifiers, from its library's SASS
    if not os.path.exists(cuobjdump):
        print("sass: the CUDA toolkit has no cuobjdump; SASS not read")
    else:
        sass = {name: subprocess.run(
            [cuobjdump, "-sass", str(cuda_build._library_path(name))],
            check=True, capture_output=True, text=True, timeout=300).stdout
            for name in reports}
        k1_names = kernel_identifiers(sass["packed_gram"])
        imma = re.findall(r"\b(?:IMMA|IGMMA)[.\w]*", sass["packed_gram"])
        if not imma:
            fail("K1's SASS holds no int8 tensor-core instruction (IMMA or "
                 "IGMMA)")
        fadd = re.findall(r"\bFADD\b[^;]*;", sass["braycurtis"])
        fadd_abs = sum("|" in ins for ins in fadd)
        print(f"sass: K1 {len(imma)} int8 tensor-core instructions "
              f"({', '.join(sorted(set(imma)))}); K2 {len(fadd)} FADD, "
              f"{fadd_abs} of them with the |.| operand modifier")

    # -- 3. parity, bitwise ---------------------------------------------------
    rng = np.random.default_rng(0)
    cases = 0
    max_err = 0
    metrics = kernels.fused_names()
    for nr, nc, w in RAGGED_SHAPES:
        rows = torch.from_numpy(
            rng.integers(0, 256, (nr, w), dtype=np.uint8)).to(dev)
        cols = torch.from_numpy(
            rng.integers(0, 256, (nc, w), dtype=np.uint8)).to(dev)
        for metric in metrics:
            pieces = kernels.get(metric).pieces
            for r, c in ((rows, cols), (rows, rows)):
                got = packed_gram.fused_tile_products(r, c, pieces)
                want = packed_gram.fused_tile_products_plain(r, c, pieces)
                torch.cuda.synchronize()
                for p in pieces:
                    err = int((got[p].long() - want[p].long()).abs().max())
                    max_err = max(max_err, err)
                    if err:
                        fail(f"K1 != plain for {metric}/{p} at rows "
                             f"{tuple(r.shape)} cols {tuple(c.shape)}: "
                             f"max |diff| {err}")
                cases += 1
    source = SyntheticSource(n_samples=N_SAMPLES, n_variants=N_VARIANTS)
    block, _meta = next(source.blocks(BLOCK_VARIANTS))
    packed = torch.from_numpy(bitpack.pack_dosages(block)).to(dev)
    ibs = kernels.get("ibs").pieces
    got = packed_gram.fused_tile_products(packed, packed, ibs)
    want = packed_gram.fused_tile_products_plain(packed, packed, ibs)
    for p in ibs:
        if not torch.equal(got[p], want[p]):
            fail(f"K1 != plain at the main shape {tuple(packed.shape)}, "
                 f"product {p}")
    cases += 1
    print(f"parity: K1 == plain PyTorch bitwise in {cases} cases (six "
          f"product sets x {len(RAGGED_SHAPES)} ragged shapes x "
          "{asymmetric, symmetric}, plus the main shape "
          f"{tuple(packed.shape)} ibs); max |diff| {max_err}")

    # -- 4. timing at the main shape, then at N = 16,384 ------------------
    nr, w = packed.shape
    k1_ms = cuda_ms(
        lambda: packed_gram.fused_tile_products(packed, packed, ibs),
        reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: packed_gram.fused_tile_products_plain(
        packed, packed, ibs), reps=5, warmup=1)

    def int_mm_pairs(p8):
        ops = genotype.operands(bitpack.unpack_dosages(p8))
        return [(ops[genotype.PRODUCT_OPERANDS[p][0]].contiguous(),
                 ops[genotype.PRODUCT_OPERANDS[p][1]].t()) for p in ibs]

    pairs = int_mm_pairs(packed)
    lib = [torch._int_mm(a, b) for a, b in pairs]
    for p, got_lib in zip(ibs, lib):
        if not torch.equal(got_lib, got[p]):
            fail(f"torch._int_mm disagrees with K1 on {p} (yardstick "
                 "computes a different function)")
    library_ms = cuda_ms(lambda: [torch._int_mm(a, b) for a, b in pairs],
                         reps=20, warmup=3)
    k1_bound = k1_bounds(nr, w, ibs)
    print(f"K1 timing at ({nr}, {w}) uint8, ibs, symmetric [{card}]: "
          f"{k1_ms:.4f} ms/launch; bound {k1_bound['bound_ms']:.4f} ms "
          f"({k1_bound['bound_by']}: {k1_bound['ops']:.4g} int8 ops the "
          f"output needs, {k1_bound['bytes']:.4g} bytes); full-square bound "
          f"{k1_bound['bound_full_ms']:.4f} ms; plain {plain_ms:.4f} ms; "
          f"torch._int_mm x{len(ibs)} (full square) on pre-decoded int8 "
          f"operands {library_ms:.4f} ms; "
          f"{k1_bound['ops'] / (k1_ms * 1e-3) / 1e12:.2f} TOP/s achieved")
    del pairs, lib, got, want

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    big = torch.randint(0, 256, (LARGE_SAMPLES, w), dtype=torch.uint8,
                        device=dev, generator=gen)
    big_got = packed_gram.fused_tile_products(big, big, ibs)
    pairs = int_mm_pairs(big)
    for p, (a, b) in zip(ibs, pairs):
        if not torch.equal(torch._int_mm(a, b), big_got[p]):
            fail(f"K1 != torch._int_mm at ({LARGE_SAMPLES}, {w}), product "
                 f"{p}")
    del big_got
    k1_big_ms = cuda_ms(
        lambda: packed_gram.fused_tile_products(big, big, ibs),
        reps=5, warmup=1)
    library_big_ms = cuda_ms(
        lambda: [torch._int_mm(a, b) for a, b in pairs], reps=5, warmup=1)
    k1_big_bound = k1_bounds(LARGE_SAMPLES, w, ibs)
    print(f"K1 timing at ({LARGE_SAMPLES}, {w}) uint8, ibs, symmetric "
          f"[{card}]: {k1_big_ms:.4f} ms/launch; bitwise equal to "
          f"torch._int_mm x{len(ibs)}, which takes {library_big_ms:.4f} ms; "
          f"bound {k1_big_bound['bound_ms']:.4f} ms, full-square bound "
          f"{k1_big_bound['bound_full_ms']:.4f} ms; "
          f"{k1_big_bound['ops'] / (k1_big_ms * 1e-3) / 1e12:.2f} TOP/s "
          "achieved")
    del big, pairs

    # -- 5. the Quickstart job through the CLI ------------------------------
    expected = math.ceil(N_VARIANTS / BLOCK_VARIANTS)
    argv = ["pcoa", "--n-samples", str(N_SAMPLES), "--n-variants",
            str(N_VARIANTS), "--metric", "ibs", "--num-pc", str(NUM_PC),
            "--block-variants", str(BLOCK_VARIANTS), "--device", DEVICE]
    counts, timings, coords, wall = run_cli(cli_main, argv, launch_counters,
                                            NUM_PC)
    quickstart_gram_s = timings["gram"]
    quickstart_coords = coords
    launches = counts["packed_gram"]
    if launches != expected:
        fail(f"K1 launched {launches} times on the main path, "
             f"expected {expected}")
    if coords.shape != (N_SAMPLES, NUM_PC):
        fail(f"coords shape {coords.shape}, expected "
             f"({N_SAMPLES}, {NUM_PC})")
    sep = separation(coords, source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"PC1-2 population separation {sep:.3f} < {SEPARATION_MIN}")
    print(f"pcoa {N_SAMPLES} x {N_VARIANTS} ibs, {NUM_PC} PCs [{card}]: "
          f"wall {wall:.3f} s; phases: "
          + ", ".join(f"{k} {timings[k]:.4f} s"
                      for k in ("ingest_setup", "gram", "finalize", "eigh"))
          + f"; launches {counts}; coords finite; PC1-2 separation "
          f"{sep:.2f} (min {SEPARATION_MIN})")

    # -- 6. reference vs K1 lowering, bitwise -------------------------------
    accs, dists = {}, {}
    for lowering in ("reference", "auto"):
        job = JobConfig(
            ingest=IngestConfig(n_samples=N_SAMPLES, n_variants=N_VARIANTS,
                                block_variants=BLOCK_VARIANTS),
            compute=ComputeConfig(metric="ibs", gram_lowering=lowering,
                                  device=DEVICE))
        g = runner.run_gram(job, SyntheticSource(n_samples=N_SAMPLES,
                                                 n_variants=N_VARIANTS),
                            PhaseTimer())
        want_lowering = "reference" if lowering == "reference" else "fused"
        if g.lowering != want_lowering:
            fail(f"--gram-lowering {lowering} resolved to {g.lowering}")
        accs[lowering] = g.acc
        dists[lowering] = distances.finalize(g.acc, "ibs")["distance"]
    for leaf in accs["reference"]:
        if not torch.equal(accs["reference"][leaf], accs["auto"][leaf]):
            fail(f"accumulator {leaf} differs between lowerings")
    if not torch.equal(dists["reference"], dists["auto"]):
        fail("ibs distances differ between lowerings")
    print("lowerings: reference and K1 accumulators "
          f"({', '.join(accs['auto'])}) and ibs distances bitwise equal")
    synthetic_acc = {k: v.cpu() for k, v in accs["auto"].items()}
    del accs, dists, g

    # -- 7. K2 parity ------------------------------------------------------
    rng = np.random.default_rng(1)
    k2_cases = 0
    k2_err = 0.0
    shapes = BC_RAGGED + ((BC_SAMPLES, BC_FEATURES),)
    for n, f in shapes:
        x = torch.from_numpy(otu_table(rng, n, f)).to(dev)
        got = braycurtis_kernel.pairwise_manhattan_kernel(x)
        if (n, f) == (BC_SAMPLES, BC_FEATURES):
            # The plain version's one rep, timed here (phase 8 reports it).
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = distances.pairwise_manhattan(x)
            end.record()
            torch.cuda.synchronize()
            k2_plain_ms = start.elapsed_time(end)
            bc_table = x
        else:
            want = distances.pairwise_manhattan(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if n else 0.0
        k2_err = max(k2_err, err)
        if not torch.equal(got, want):
            fail(f"K2 != plain on the integer table {(n, f)}: max |diff| "
                 f"{err}")
        k2_cases += 1
    n, f = 300, 1025
    x = torch.from_numpy(
        rng.gamma(0.7, 3.0, (n, f)).astype(np.float32)).to(dev)
    got = braycurtis_kernel.pairwise_manhattan_kernel(x)
    want = distances.pairwise_manhattan(x)
    rtol = 2.0 * f * 2.0 ** -24
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    k2_float_err = float((got - want).abs().max())
    if not rel <= rtol:
        fail(f"K2 vs plain on the float table {(n, f)}: max relative "
             f"diff {rel:.3g} > rtol {rtol:.3g}")
    k2_cases += 1
    print(f"parity: K2 == plain PyTorch bitwise on {k2_cases - 1} integer "
          f"OTU-like tables {list(shapes)}; float table {(n, f)} max "
          f"relative diff {rel:.3g} (rtol {rtol:.3g}), max |diff| "
          f"{k2_float_err:.3g}")

    # -- 8. K2 timing at the job's shape -----------------------------------
    n, f = bc_table.shape
    k2_ms = cuda_ms(lambda: braycurtis_kernel.pairwise_manhattan_kernel(
        bc_table), reps=5, warmup=1)
    num = braycurtis_kernel.pairwise_manhattan_kernel(bc_table)
    lib = torch.cdist(bc_table, bc_table, p=1.0)
    torch.cuda.synchronize()
    if not torch.equal(lib, num):
        fail("torch.cdist(p=1) disagrees with K2 on the integer table: max "
             f"|diff| {float((lib - num).abs().max())}")
    k2_library_ms = cuda_ms(lambda: torch.cdist(bc_table, bc_table, p=1.0),
                            reps=3, warmup=1)
    del lib
    exact_bc = distances.bc_from_manhattan(num, bc_table.sum(dim=1))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    mm_bc = distances.braycurtis_matmul(bc_table, levels=BC_LEVELS)
    end.record()
    torch.cuda.synchronize()
    matmul_ms = start.elapsed_time(end)
    if not bool(torch.isfinite(mm_bc).all()):
        fail("the matmul lowering gave non-finite distances")
    mm_err = float((mm_bc - exact_bc).abs().max())
    del mm_bc, exact_bc, num
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instr_s = sms * FP32_LANES_PER_SM * clock
    # FADD + FADD|.| per (i, j, f) triple over the i <= j half the output
    # needs (the other half is its transpose); the full square beside it.
    k2_instr = 2.0 * n * (n + 1) / 2 * f
    k2_full_instr = 2.0 * n * n * f
    k2_bytes = 4.0 * n * f + 4.0 * n * n
    k2_ops_ms = k2_instr / instr_s * 1e3
    k2_bytes_ms = k2_bytes / PEAK_BYTES_S * 1e3
    k2_bound_ms = max(k2_ops_ms, k2_bytes_ms)
    k2_bound_by = "operations" if k2_ops_ms >= k2_bytes_ms else "bytes"
    k2_bound_full_ms = max(k2_full_instr / instr_s * 1e3, k2_bytes_ms)
    print(f"K2 timing at ({n}, {f}) f32 [{card}]: {k2_ms:.4f} ms/launch; "
          f"bound {k2_bound_ms:.4f} ms ({k2_bound_by}: {k2_instr:.4g} FP32 "
          f"instructions for i <= j; full square {k2_bound_full_ms:.4f} ms) "
          f"at {sms} SMs x {FP32_LANES_PER_SM} lanes x "
          f"{clock / 1e9:.3f} GHz = {instr_s:.4g}/s; {k2_bytes:.4g} bytes "
          f"-> {k2_bytes_ms:.4f} ms); plain {k2_plain_ms:.4f} ms (1 rep); "
          f"torch.cdist(p=1) (full square) {k2_library_ms:.4f} ms; "
          "matmul lowering "
          f"(levels {BC_LEVELS}) {matmul_ms:.4f} ms (1 rep, max |BC - "
          f"exact| {mm_err:.3g}); {k2_instr / (k2_ms * 1e-3) / 1e12:.2f} "
          "T instructions/s achieved")
    del bc_table

    # -- 9. the Bray-Curtis job through the CLI -----------------------------
    argv = ["pcoa", "--metric", "braycurtis", "--n-samples",
            str(BC_SAMPLES), "--n-variants", str(BC_FEATURES), "--num-pc",
            str(NUM_PC), "--device", DEVICE]
    bc_counts, timings, coords, wall = run_cli(cli_main, argv,
                                               launch_counters, NUM_PC)
    if bc_counts["braycurtis"] != 1:
        fail(f"K2 launched {bc_counts['braycurtis']} times on the "
             "Bray-Curtis job, expected 1")
    if coords.shape != (BC_SAMPLES, NUM_PC):
        fail(f"Bray-Curtis coords shape {coords.shape}, expected "
             f"({BC_SAMPLES}, {NUM_PC})")
    bc_source = SyntheticSource(n_samples=BC_SAMPLES, n_variants=BC_FEATURES)
    sep = separation(coords, bc_source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"Bray-Curtis PC1-2 population separation {sep:.3f} < "
             f"{SEPARATION_MIN}")
    print(f"pcoa {BC_SAMPLES} x {BC_FEATURES} braycurtis, {NUM_PC} PCs "
          f"[{card}]: wall {wall:.3f} s; phases: "
          + ", ".join(f"{k} {timings[k]:.4f} s"
                      for k in ("ingest_setup", "ingest", "distance", "eigh"))
          + f"; launches {bc_counts}; coords finite; PC1-2 separation "
          f"{sep:.2f} (min {SEPARATION_MIN})")

    # -- 10. exact vs fused Bray-Curtis lowering, bitwise -------------------
    bc_dists = {}
    # graftlint: disable=registry-literal  # the two lowerings phase 10 holds bitwise against each other, not an enumeration (matmul is quantised, auto resolves to fused)
    for method in ("exact", "fused"):
        job = JobConfig(
            ingest=IngestConfig(n_samples=BC_SAMPLES,
                                n_variants=BC_FEATURES),
            compute=ComputeConfig(metric="braycurtis",
                                  braycurtis_method=method, device=DEVICE))
        bc_dists[method] = runner.braycurtis_distance(
            job, SyntheticSource(n_samples=BC_SAMPLES,
                                 n_variants=BC_FEATURES), PhaseTimer())
    if not torch.equal(bc_dists["exact"], bc_dists["fused"]):
        diff = float((bc_dists["exact"] - bc_dists["fused"]).abs().max())
        fail(f"Bray-Curtis distances differ between lowerings: {diff}")
    print("lowerings: exact and K2 Bray-Curtis distances bitwise equal on "
          f"the job's {BC_SAMPLES} x {BC_FEATURES} table")
    del bc_dists

    # -- 11. the pca job through the CLI ------------------------------------
    argv = ["pca", "--n-samples", str(N_SAMPLES), "--n-variants",
            str(N_VARIANTS), "--num-pc", str(NUM_PC), "--block-variants",
            str(BLOCK_VARIANTS), "--device", DEVICE]
    pca_counts, timings, coords, wall = run_cli(cli_main, argv,
                                                launch_counters, NUM_PC)
    if pca_counts["packed_gram"] != expected:
        fail(f"K1 launched {pca_counts['packed_gram']} times on the pca "
             f"job, expected {expected}")
    if coords.shape != (N_SAMPLES, NUM_PC):
        fail(f"pca coords shape {coords.shape}")
    pca_coords = coords
    sep = separation(coords, source.populations)
    if not sep >= SEPARATION_MIN:
        fail(f"pca PC1-2 population separation {sep:.3f} < "
             f"{SEPARATION_MIN}")
    print(f"pca {N_SAMPLES} x {N_VARIANTS} shared-alt, {NUM_PC} PCs "
          f"[{card}]: wall {wall:.3f} s; phases: "
          + ", ".join(f"{k} {timings[k]:.4f} s"
                      for k in ("ingest_setup", "gram", "finalize", "eigh"))
          + f"; launches {pca_counts}; coords finite; PC1-2 separation "
          f"{sep:.2f} (min {SEPARATION_MIN})")

    with tempfile.TemporaryDirectory() as tmp:
        new_paths, files = dense_and_file_phases(
            cli_main, launch_counters, card, dev, source, expected,
            quickstart_gram_s, synthetic_acc, tmp)
        new_paths.update(dataset_store_phases(
            cli_main, launch_counters, card, source, expected,
            synthetic_acc, files, tmp))
        new_paths.update(checkpoint_and_solver_phases(
            cli_main, launch_counters, card, dev, source, expected,
            synthetic_acc, quickstart_coords, files, tmp))
        new_paths.update(native_projection_parquet_phases(
            cli_main, launch_counters, card, dev, source, expected,
            synthetic_acc, files, tmp))
        new_paths.update(streaming_example_neighbors_phases(
            cli_main, launch_counters, card, source, expected,
            synthetic_acc, files, tmp))
        phases_t0 = time.perf_counter()
        new_paths.update(traced_gram_phase(
            cli_main, launch_counters, card, files, tmp, k1_ms, k1_names))
        new_paths.update(serving_phases(
            cli_main, launch_counters, card, dev, files, tmp))
        print(f"phases 37-40 took {time.perf_counter() - phases_t0:.1f} s "
              f"[{card}]")
        phases_t0 = time.perf_counter()
        new_paths.update(supervised_phases(
            cli_main, launch_counters, card, files, tmp))
        new_paths.update(fleet_phases(
            cli_main, launch_counters, card, files, tmp))
        print(f"phases 41-44 took {time.perf_counter() - phases_t0:.1f} s "
              f"[{card}]")
        phases_t0 = time.perf_counter()
        new_paths.update(backend_phases(cli_main, launch_counters, card,
                                        tmp))
        new_paths.update(controller_phase(cli_main, launch_counters, card,
                                          files, tmp))
        print(f"phases 45-47 took {time.perf_counter() - phases_t0:.1f} s "
              f"[{card}]")
        phases_t0 = time.perf_counter()
        mesh_paths, tile_shapes = mesh_phases(
            cli_main, launch_counters, card, dev, synthetic_acc, pca_coords,
            files, tmp)
        new_paths.update(mesh_paths)
        print(f"phases 48-53 took {time.perf_counter() - phases_t0:.1f} s "
              f"[{card}]")
        phases_t0 = time.perf_counter()
        new_paths.update(multihost_phases(cli_main, card, synthetic_acc,
                                          files, tmp))
        print(f"phases 54-57 took {time.perf_counter() - phases_t0:.1f} s "
              f"[{card}]")
        phases_t0 = time.perf_counter()
        rank_paths, rank_shapes = tile2d_ranks_phases(
            cli_main, card, dev, synthetic_acc, pca_coords, files, tmp)
        new_paths.update(rank_paths)
        tile_shapes.update(rank_shapes)
        print(f"phases 58-62 took {time.perf_counter() - phases_t0:.1f} s "
              f"[{card}]")

    # -- 63. the lint verb ----------------------------------------------------
    lint_phase(card)

    # -- 64-65. the benchmark harness's configs and subsystem rows ----------
    with tempfile.TemporaryDirectory() as tmp:
        bench_paths, bench_shapes = bench_phase(card, tmp)
        bench_paths.update(bench_rows_phase(card, tmp))
    new_paths.update(bench_paths)
    tile_shapes.update(bench_shapes)

    # -- 66. summary --------------------------------------------------------
    print(f"chip_smoke: phases 1-65 took "
          f"{time.perf_counter() - script_t0:.1f} s [{card}]")
    print(json.dumps({"kernels": [{
        "name": "packed_gram",
        "route": "cuda",
        "source": "spark_examples_tpu_torch/csrc/packed_gram.cu",
        "replaces": "spark_examples_tpu/ops/pallas/packed_gram.py:118",
        "launches": launches,
        "launches_by_path": {"pcoa ibs": launches,
                             "pcoa braycurtis": bc_counts["packed_gram"],
                             "pca": pca_counts["packed_gram"],
                             **{path: c["packed_gram"]
                                for path, c in new_paths.items()}},
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound["bound_ms"],
        "bound_by": k1_bound["bound_by"],
        "library_ms": library_ms,
        "bound_full_ms": k1_bound["bound_full_ms"],
        f"ms_n{LARGE_SAMPLES}": k1_big_ms,
        f"library_ms_n{LARGE_SAMPLES}": library_big_ms,
        f"bound_ms_n{LARGE_SAMPLES}": k1_big_bound["bound_ms"],
        f"bound_full_ms_n{LARGE_SAMPLES}": k1_big_bound["bound_full_ms"],
        "tile_shapes": tile_shapes,
        "parity": "bitwise",
        "parity_cases": cases,
    }, {
        "name": "braycurtis",
        "route": "cuda",
        "source": "spark_examples_tpu_torch/csrc/braycurtis.cu",
        "replaces": "spark_examples_tpu/ops/pallas/braycurtis_kernel.py:47",
        "launches": bc_counts["braycurtis"],
        "launches_by_path": {"pcoa ibs": counts["braycurtis"],
                             "pcoa braycurtis": bc_counts["braycurtis"],
                             "pca": pca_counts["braycurtis"],
                             **{path: c["braycurtis"]
                                for path, c in new_paths.items()
                                if "braycurtis" in c}},
        "max_abs_err": max(k2_err, k2_float_err),
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms,
        "bound_by": k2_bound_by,
        "library_ms": k2_library_ms,
        "bound_full_ms": k2_bound_full_ms,
        "matmul_lowering_ms": matmul_ms,
        "parity": f"bitwise on integer tables; rtol {rtol:.3g} on a float "
                  "table",
        "parity_cases": k2_cases,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
