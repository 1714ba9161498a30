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
12. Print the ``kernels`` JSON line (K1 and K2), the card line, and as
    the last line ``{"ok": true, "device": {...}}``.

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
import subprocess
import sys
import tempfile
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


def run_cli(cli_main, argv: list[str], counters: dict, n_pc: int):
    """One job through the CLI's ``main`` with ``--timings``: every
    kernel's launch count set to 0 just before, read just after. Returns
    (launches by kernel, phase timings, coords from the TSV, wall s)."""
    with tempfile.TemporaryDirectory() as tmp:
        tsv = os.path.join(tmp, "coords.tsv")
        err = io.StringIO()
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main(argv + ["--output-path", tsv, "--timings"])
        wall = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in counters.items()}
        if rc != 0:
            fail(f"{argv[0]} CLI returned {rc}")
        timings = json.loads(err.getvalue().strip().splitlines()[-1])
        with open(tsv) as f:
            header = f.readline().rstrip("\n").split("\t")
            rows_ = [line.rstrip("\n").split("\t") for line in f]
    coords = np.asarray([r[1:] for r in rows_], dtype=np.float64)
    if len(header) != n_pc + 1:
        fail(f"{argv[0]}: TSV header {header}")
    if not np.isfinite(coords).all():
        fail(f"{' '.join(argv)}: non-finite coordinates")
    return launches, timings, coords, wall


def main() -> int:
    import torch

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
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    print(f"build: {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        print(f"--- ptxas report, csrc/{name}.cu ---\n{rep.strip()}")
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", rep)]
        if not spills or any(spills):
            fail(f"csrc/{name}.cu: ptxas reports spills (or no report): "
                 f"{spills}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        print("sass: the CUDA toolkit has no cuobjdump; SASS not read")
    else:
        sass = {name: subprocess.run(
            [cuobjdump, "-sass", str(cuda_build._library_path(name))],
            check=True, capture_output=True, text=True, timeout=300).stdout
            for name in reports}
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

    # -- 12. summary --------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "packed_gram",
        "route": "cuda",
        "source": "spark_examples_tpu_torch/csrc/packed_gram.cu",
        "replaces": "spark_examples_tpu/ops/pallas/packed_gram.py:118",
        "launches": launches,
        "launches_by_path": {"pcoa ibs": launches,
                             "pcoa braycurtis": bc_counts["packed_gram"],
                             "pca": pca_counts["packed_gram"]},
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
                             "pca": pca_counts["braycurtis"]},
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
