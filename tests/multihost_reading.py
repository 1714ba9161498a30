"""A job of two processes with a card each, over NCCL: ``pcoa --metric
ibs --gram-mode variant`` from a packed store through the CLI, at the
Quickstart width (2504 x 100,000) and at 16,384 x 32,768 (blocks of
8192), against the same job in one process on one card.

    python tests/multihost_reading.py [--reps 2] [--sizes 2504x100000]
    python tests/multihost_reading.py --device cpu \\
        --sizes 48x2000 --block-variants 512   # a dry run: gloo on the CPU

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
import json
import math
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

RANKS = 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="2504x100000,16384x32768",
                    help="comma-separated NxV cohorts")
    ap.add_argument("--block-variants", type=int, default=cs.BLOCK_VARIANTS)
    args = ap.parse_args()

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
            for route in (("one", "ranks") if rep % 2 == 0
                          else ("ranks", "one")):
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
    if on_cuda:
        print(f"card: {cs.card_line()}")
    print("MULTIHOST READING OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
