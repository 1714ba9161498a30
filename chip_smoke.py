#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught and ignored):

1. Refuse to run without a CUDA device; print the card's name and power
   limit (``nvidia-smi``) and ``torch.cuda.get_device_name(0)``.
2. Build every kernel of ``spark_examples_tpu_torch/csrc`` with nvcc
   (one process per source, started together) and print the ptxas
   report: registers, shared memory, spills.
3. Hold the packed-gram kernel (K1) against its plain PyTorch version on
   the card, bitwise: all six count kernels' product sets on ragged
   shapes, and the main shape (2504 samples x 2048 bytes, ibs).
4. Time K1 at the main shape with CUDA events, beside its bound, the
   plain version and one library yardstick (``torch._int_mm`` on the
   pre-decoded int8 operands).
5. Run the Quickstart job through the CLI's ``main``:
   ``pcoa --n-samples 2504 --n-variants 100000 --metric ibs --num-pc 10``,
   with K1's launch count set to 0 just before and read just after; it
   must be ceil(100000 / 8192) = 13. The coordinates must be finite and
   separate the planted populations in PC1-2 (between-centroid over
   within-population distance >= SEPARATION_MIN).
6. Run the same job's gram stage under ``--gram-lowering reference`` and
   under ``auto`` (K1) through the library: the int32 accumulators and
   the finalized distances must be bitwise equal.
7. Print the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
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
# H100 SXM published peaks (NVIDIA data sheet, dense): int8 tensor-core
# rate and HBM3 bandwidth, at the full 700 W power limit.
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES_S = 3.35e12
RAGGED_SHAPES = ((37, 21, 301), (1, 1, 1), (65, 130, 17), (64, 64, 16),
                 (200, 129, 33))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    from spark_examples_tpu_torch.ops import packed_gram
    from spark_examples_tpu_torch.pipelines import runner

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

    # -- 3. parity, bitwise ---------------------------------------------------
    rng = np.random.default_rng(0)
    cases = 0
    max_err = 0
    metrics = kernels.names()
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

    # -- 4. timing at the main shape -----------------------------------------
    nr, w = packed.shape
    k1_ms = cuda_ms(lambda: packed_gram.fused_tile_products(packed, packed,
                                                            ibs),
                    reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: packed_gram.fused_tile_products_plain(
        packed, packed, ibs), reps=5, warmup=1)
    ops = genotype.operands(bitpack.unpack_dosages(packed))
    pairs = [(ops[genotype.PRODUCT_OPERANDS[p][0]].contiguous(),
              ops[genotype.PRODUCT_OPERANDS[p][1]].t())
             for p in ibs]
    lib = [torch._int_mm(a, b) for a, b in pairs]
    for p, got_lib in zip(ibs, lib):
        if not torch.equal(got_lib, got[p]):
            fail(f"torch._int_mm disagrees with K1 on {p} (yardstick "
                 "computes a different function)")
    library_ms = cuda_ms(lambda: [torch._int_mm(a, b) for a, b in pairs],
                         reps=20, warmup=3)
    variants = 4 * w
    op_count = len(ibs) * 2.0 * nr * nr * variants
    byte_count = 2.0 * nr * w + len(ibs) * nr * nr * 4.0
    bound_ops_ms = op_count / PEAK_INT8_OPS * 1e3
    bound_bytes_ms = byte_count / PEAK_BYTES_S * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    print(f"K1 timing at ({nr}, {w}) x ({nr}, {w}) uint8, ibs [{card}]: "
          f"{k1_ms:.4f} ms/launch; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{op_count:.4g} int8 ops, {byte_count:.4g} bytes); plain "
          f"{plain_ms:.4f} ms; torch._int_mm x{len(ibs)} on pre-decoded "
          f"int8 operands {library_ms:.4f} ms; "
          f"{op_count / (k1_ms * 1e-3) / 1e12:.2f} TOP/s achieved")
    del ops, pairs, lib, got, want

    # -- 5. the Quickstart job through the CLI ------------------------------
    expected = math.ceil(N_VARIANTS / BLOCK_VARIANTS)
    with tempfile.TemporaryDirectory() as tmp:
        tsv = os.path.join(tmp, "coords.tsv")
        argv = ["pcoa", "--n-samples", str(N_SAMPLES), "--n-variants",
                str(N_VARIANTS), "--metric", "ibs", "--num-pc",
                str(NUM_PC), "--block-variants", str(BLOCK_VARIANTS),
                "--device", DEVICE, "--output-path", tsv, "--timings"]
        err = io.StringIO()
        packed_gram.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main(argv)
        wall = time.perf_counter() - t0
        launches = packed_gram.launches
        if rc != 0:
            fail(f"pcoa CLI returned {rc}")
        if launches != expected:
            fail(f"K1 launched {launches} times on the main path, "
                 f"expected {expected}")
        timings = json.loads(err.getvalue().strip().splitlines()[-1])
        with open(tsv) as f:
            header = f.readline().rstrip("\n").split("\t")
            rows_ = [line.rstrip("\n").split("\t") for line in f]
    coords = np.asarray([r[1:] for r in rows_], dtype=np.float64)
    if coords.shape != (N_SAMPLES, NUM_PC) or len(header) != NUM_PC + 1:
        fail(f"coords shape {coords.shape}, expected "
             f"({N_SAMPLES}, {NUM_PC})")
    if not np.isfinite(coords).all():
        fail("non-finite coordinates")
    pops = source.populations
    c2 = coords[:, :2]
    cents = np.stack([c2[pops == k].mean(0) for k in np.unique(pops)])
    labels = np.searchsorted(np.unique(pops), pops)
    within = float(np.mean(np.linalg.norm(c2 - cents[labels], axis=1)))
    between = float(np.mean([
        np.linalg.norm(cents[a] - cents[b])
        for a in range(len(cents)) for b in range(a + 1, len(cents))]))
    separation = between / within
    if not separation >= SEPARATION_MIN:
        fail(f"PC1-2 population separation {separation:.3f} < "
             f"{SEPARATION_MIN}")
    print(f"pcoa {N_SAMPLES} x {N_VARIANTS} ibs, {NUM_PC} PCs [{card}]: "
          f"wall {wall:.3f} s; phases: "
          + ", ".join(f"{k} {timings[k]:.4f} s"
                      for k in ("ingest_setup", "gram", "finalize", "eigh"))
          + f"; K1 launches {launches}; coords finite; PC1-2 separation "
          f"{separation:.2f} (min {SEPARATION_MIN})")

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

    print(json.dumps({"kernels": [{
        "name": "packed_gram",
        "route": "cuda",
        "source": "spark_examples_tpu_torch/csrc/packed_gram.cu",
        "replaces": "spark_examples_tpu/ops/pallas/packed_gram.py:118",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "parity": "bitwise",
        "parity_cases": cases,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
