"""A job of two processes with a card each, over NCCL: ``pcoa --metric
ibs`` from a packed store through the CLI, at the Quickstart width
(2504 x 100,000) and at 16,384 x 32,768 (blocks of 8192), against the
same job in one process on one card. The routes: ``--gram-mode
variant`` (per-rank partial sums, reduced at the end) and ``--gram-mode
tile2d`` over a (1, 2) mesh spanning the two ranks (one slot a rank,
the gather transport: each rank holds one N x N/2 tile of every leaf).
``--big`` adds one run past one card's memory: four ranks on four cards,
a (2, 2) tile2d mesh, ibs at 65,536 x 16,384 from a one-chunk raw
dataset store (four int32 leaves of 17.2 GB each would not fit one
card beside the distance; each card holds a quarter).

    python tests/multihost_reading.py [--reps 2] [--sizes 2504x100000] \\
        [--routes variant,tile2d] [--big]
    python tests/multihost_reading.py --device cpu --sizes 48x2000 \\
        --block-variants 512 --big --big-size 48x2048   # a dry run: gloo

Each rank is ``python -m spark_examples_tpu_torch`` started with
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``
and ``CUDA_VISIBLE_DEVICES=0,1``, so rank r takes card r. Runs go one
card, two ranks, two ranks, one card ... (``--reps`` of each), so a
drift shows. One JSON line per run: its wall, the gram / allreduce /
finalize / eigh phases and the consensus rounds' wait (each rank's from
its own telemetry; the first round holds the other rank's start), K1's
launches per rank, the backend the ranks report, and whether the
coordinates (and at the Quickstart width the reduced int32
accumulators, from the checkpoint at the last step) equal the one-card
run's bitwise. Then K1 timed at the ranks' block shape (N x 2048
bytes). The card line (``nvidia-smi`` name and power limit) first and
last. Not collected by pytest: a reading, not a test.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

RANKS = 2
# The structure PCs of the tiled randomized solve against the one-card
# run (a dense eigh at 2504, the randomized one at 16,384).
TILE2D_COORD_TOL = 1e-3
# The run past one card: 4 ranks on a (2, 2) mesh, one block a rank
# (one global step).
BIG_RANKS = 4
BIG_SIZE = "65536x16384"
BIG_TIMEOUT_S = 900


def rank_job(argv: list[str]) -> int:
    """One tile2d rank: ``argv`` through the CLI's ``main`` with
    ``--timings``; prints one JSON line with the rank, K1's launches, the
    phase timings, the wall and the peak device memory."""
    import torch

    from spark_examples_tpu_torch.cli.main import main as cli_main
    from spark_examples_tpu_torch.ops import packed_gram

    err = io.StringIO()
    packed_gram.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv + ["--timings"])
    wall = time.perf_counter() - t0
    if rc != 0:
        print(err.getvalue()[-3000:], file=sys.stderr)
        return rc
    timings = json.loads(next(line for line in reversed(
        err.getvalue().strip().splitlines()) if line.startswith("{")))
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    print(json.dumps({"rank": int(os.environ["JAX_PROCESS_ID"]),
                      "k1": packed_gram.launches, "wall": wall,
                      "timings": timings, "peak_bytes": peak}), flush=True)
    return 0


def run_rank_jobs(argvs, tmp: str, name: str, env: dict) -> list[dict]:
    """:func:`rank_job` on every rank; their JSON lines, in rank order."""
    res = cs.run_ranks([["tests/multihost_reading.py", "--rank-job",
                         json.dumps(a)] for a in argvs], tmp, name,
                       env_extra=[env] * len(argvs), module=False)
    for r, rr in enumerate(res):
        if rr["rc"] != 0:
            raise SystemExit(f"{name}: rank {r} exit {rr['rc']}:\n"
                             f"{rr['stderr'][-3000:]}")
    return [json.loads(rr["stdout"].strip().splitlines()[-1])
            for rr in res]


def tsv_coords(path: str) -> np.ndarray:
    with open(path) as f:
        f.readline()
        return np.asarray([line.rstrip("\n").split("\t")[1:]
                           for line in f], dtype=np.float64)


def big_run(args, tmp: str, card: str) -> None:
    """Four ranks, a (2, 2) tile2d mesh of one card each, ibs at
    ``--big-size`` (65,536 x 16,384) from a one-chunk raw store: past one
    card's memory. One JSON line."""
    from spark_examples_tpu_torch.cli.main import main as cli_main
    from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource

    big_n, big_v = map(int, args.big_size.lower().split("x"))
    store = os.path.join(tmp, "big")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(["ingest", "--n-samples", str(big_n),
                       "--n-variants", str(big_v), "--chunk-variants",
                       str(big_v), "--store-codec", "raw",
                       "--device", args.device, "--output-path", store])
    if rc != 0:
        raise SystemExit(f"ingest returned {rc}")
    ingest_s = time.perf_counter() - t0
    tsv = os.path.join(tmp, "big.tsv")
    argv = ["pcoa", "--metric", "ibs", "--source", f"store:{store}",
            "--block-variants", str(big_v // BIG_RANKS), "--device",
            args.device, "--num-pc", str(cs.NUM_PC), "--gram-mode", "tile2d",
            "--mesh-shape", "2x2", "--output-path", tsv]
    env = ({"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(BIG_RANKS)))}
           if args.device == "cuda" else {})
    cs.MULTIHOST_TIMEOUT_S = BIG_TIMEOUT_S
    outs = run_rank_jobs([argv] * BIG_RANKS, tmp, "big", env)
    coords = tsv_coords(tsv)
    pops = SyntheticSource(n_samples=big_n, n_variants=big_v).populations
    leaf = 4 * big_n * big_n
    print(json.dumps({
        "route": "tile2d 2x2 over 4 ranks", "n_samples": big_n,
        "n_variants": big_v, "ingest_s": ingest_s,
        "int32_leaf_bytes": leaf, "int32_leaves_bytes": 4 * leaf,
        "int32_tile_bytes_per_card": 4 * 4 * (big_n // 2) ** 2,
        "k1_launches": [o["k1"] for o in outs],
        "peak_bytes": [o["peak_bytes"] for o in outs],
        "wall_s": [o["wall"] for o in outs],
        "phases_s": [{k: o["timings"][k] for k in (
            "ingest_setup", "gram", "finalize", "eigh")
            if k in o["timings"]} for o in outs],
        "coords_finite": bool(np.isfinite(coords).all()),
        "pc12_separation": cs.separation(coords, pops),
        "card": card}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-job":
        return rank_job(json.loads(sys.argv[2]))
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="2504x100000,16384x32768",
                    help="comma-separated NxV cohorts")
    ap.add_argument("--routes", default="variant,tile2d",
                    help="comma-separated: variant, tile2d")
    ap.add_argument("--big", action="store_true",
                    help=f"add the {BIG_RANKS}-card tile2d run at "
                    "--big-size")
    ap.add_argument("--big-size", default=BIG_SIZE)
    ap.add_argument("--block-variants", type=int, default=cs.BLOCK_VARIANTS)
    args = ap.parse_args()
    routes = args.routes.split(",")

    import torch

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.cli.main import main as cli_main
    from spark_examples_tpu_torch.ingest.packed import load_packed, save_packed
    from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
    from spark_examples_tpu_torch.ops import (
        braycurtis_kernel,
        cuda_build,
        packed_gram,
    )
    from spark_examples_tpu_torch.pipelines import runner

    on_cuda = args.device == "cuda"
    card = cs.card_line() if on_cuda else "cpu (dry run)"
    print(f"card: {card}", flush=True)
    env = {}
    if on_cuda:
        if torch.cuda.device_count() < RANKS:
            print(f"needs {RANKS} visible cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        # Built once here, so the ranks find the libraries.
        cuda_build.build_all()
        env = {"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(RANKS)))}
    counters = {"packed_gram": packed_gram, "braycurtis": braycurtis_kernel}
    tmp = tempfile.mkdtemp()
    bv = args.block_variants
    for size in args.sizes.split(","):
        n, v = map(int, size.lower().split("x"))
        src = SyntheticSource(n_samples=n, n_variants=v)
        g = np.concatenate([b for b, _ in src.blocks(16384)], axis=1)
        store = os.path.join(tmp, f"store{n}")
        save_packed(store, g, src.sample_ids)
        del g
        # The dense eigh of a 16,384 x 16,384 matrix would outweigh the
        # gram phase: the randomized solve keeps the reading on it.
        solve = ["--eigh-mode", "randomized"] if n > 4096 else []
        base = ["pcoa", "--metric", "ibs", "--source", "packed", "--path",
                store, "--block-variants", str(bv), "--device", args.device,
                "--num-pc", str(cs.NUM_PC)] + solve
        steps = math.ceil(math.ceil(v / bv) / RANKS)
        check_acc = n <= 4096  # the checkpoint of 4 N x N int32 leaves
        want = {}
        for rep in range(args.reps):
            for route in (["one", *routes] if rep % 2 == 0
                          else [*routes[::-1], "one"]):
                run = f"{route}{n}_{rep}"
                tsv = os.path.join(tmp, f"{run}.tsv")
                ck = os.path.join(tmp, f"{run}_ck")
                row = {"route": route, "rep": rep, "n_samples": n,
                       "n_variants": v}
                if route == "one":
                    kept: list = []
                    orig = cs.keeping(runner, "run_gram", kept)
                    try:
                        counts, timings, _, wall = cs.run_job(
                            cli_main, base + ["--gram-mode", "replicated"],
                            counters, tsv)
                    finally:
                        runner.run_gram = orig
                    acc = {k: x.cpu() for k, x in kept[-1].acc.items()}
                    del kept
                    row.update(wall_s=wall, k1_launches=[
                        counts["packed_gram"]], phases_s={
                        k: timings[k] for k in ("gram", "finalize", "eigh")
                        if k in timings})
                elif route == "tile2d":
                    outs = run_rank_jobs(
                        [base + ["--gram-mode", "tile2d", "--mesh-shape",
                                 f"1x{RANKS}", "--tile2d-transport",
                                 "gather", "--output-path", tsv]
                         + (["--checkpoint-dir", ck,
                             "--checkpoint-every-blocks", str(steps)]
                            if check_acc else [])] * RANKS,
                        tmp, run, env)
                    row.update(
                        wall_s=max(o["wall"] for o in outs),
                        k1_launches=[o["k1"] for o in outs],
                        peak_bytes=[o["peak_bytes"] for o in outs],
                        phases_s=[{k: o["timings"][k] for k in (
                            "gram", "finalize", "eigh")
                            if k in o["timings"]} for o in outs])
                    acc = None
                    if check_acc:
                        half = n // RANKS
                        acc = {}
                        for k in ("cc", "yc", "t1t1", "t2t2"):
                            acc[k] = torch.cat([torch.from_numpy(np.load(
                                os.path.join(ck, f"{k}.t0_{j * half}.npy")))
                                for j in range(RANKS)], dim=1)
                else:
                    tel = os.path.join(tmp, f"{run}_tel")
                    extra = ["--output-path", tsv, "--telemetry-dir", tel,
                             "--gram-mode", "variant"]
                    if check_acc:
                        extra += ["--checkpoint-dir", ck,
                                  "--checkpoint-every-blocks", str(steps)]
                    res = cs.run_ranks([base + extra] * RANKS, tmp, run,
                                       env_extra=[env] * RANKS)
                    for r, rr in enumerate(res):
                        if rr["rc"] != 0:
                            print(rr["stderr"][-3000:], file=sys.stderr)
                            return 1
                    metrics = cs.rank_metrics(tel, RANKS)
                    row.update(
                        wall_s=max(rr["wall"] for rr in res),
                        backend=[rr["stdout"].splitlines()[0]
                                 for rr in res],
                        k1_launches=[int(m["counters"].get(
                            "kernel.packed_gram.launches", 0))
                            for m in metrics],
                        phases_s=[{k: m["phases"][k] for k in (
                            "gram", "allreduce", "finalize", "eigh")
                            if k in m["phases"]} for m in metrics],
                        # Inside the gram phase: the first round holds
                        # the other rank's start.
                        consensus_wait_s=[m["histograms"].get(
                            "multihost.consensus", {}).get("sum", 0.0)
                            for m in metrics])
                    acc = None
                    if check_acc:
                        with open(os.path.join(ck, "manifest.json")) as f:
                            leaves = json.load(f)["leaves"]
                        acc = {k: torch.from_numpy(np.load(os.path.join(
                            ck, f"{k}.npy"))) for k in leaves}
                with open(tsv) as f:
                    coords = f.read()
                if not want:
                    want.update(acc=acc, coords=coords)
                row["coords_bitwise_one_card"] = coords == want["coords"]
                if route == "tile2d":
                    row["structure_pcs_vs_one_card"] = cs.same_columns(
                        tsv_coords(tsv), np.asarray(
                            [line.split("\t")[1:] for line in
                             want["coords"].splitlines()[1:]], np.float64),
                        cs.NUM_POP_PCS, TILE2D_COORD_TOL)
                if check_acc:
                    row["acc_bitwise_one_card"] = cs.equal_accumulators(
                        acc, want["acc"])
                print(json.dumps(row), flush=True)
        if on_cuda:
            # K1 at the ranks' block shape: each launch contracts one
            # block of the rank's window, whatever the window.
            block, _ = next(load_packed(store).packed_blocks(bv))
            full = torch.from_numpy(np.ascontiguousarray(block)).to("cuda")
            ibs = kernels.get("ibs").pieces
            k1_ms = cs.cuda_ms(lambda: packed_gram.fused_tile_products(
                full, full, ibs), reps=5 if n > 4096 else 20, warmup=2)
            bound = cs.k1_bounds(n, full.shape[1], ibs)
            print(json.dumps({
                "n_samples": n, "k1_block": list(full.shape),
                "k1_ms": k1_ms, "k1_bound_ms": bound["bound_ms"],
                "k1_bound_by": bound["bound_by"],
                "int32_leaves_bytes": 4 * 4 * n * n}), flush=True)
            del full
            torch.cuda.empty_cache()
    if args.big:
        big_run(args, tmp, card)
    if on_cuda:
        print(f"card: {cs.card_line()}")
    print("MULTIHOST READING OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
