"""The mesh routes on a host of four cards: ``pcoa --metric ibs`` at the
Quickstart width (2504 x 100,000 from a packed store, 13 blocks of 8192)
through the CLI

- on one card (``--gram-mode replicated``),
- on every visible card under the default plan (``auto``: variant),
- under ``--gram-mode tile2d`` over a 2 x 2 mesh of four cards with
  ``--tile2d-transport gather``, ``ring`` and ``auto``;

then the two rates the ``auto`` transport rule weighs: one ring shard's
hop between two cards, and K1 at the ring shard's tile shape.

    python tests/mesh_reading.py [--reps 2] [--routes one,gather,ring]
    python tests/mesh_reading.py --device cpu --n-samples 48 \\
        --n-variants 2000 --block-variants 512   # a dry run, 4 virtual slots

Each route runs ``--reps`` times, in the order a b c ... c b a, so that a
drift shows. One JSON line per run: the route, wall seconds, the gram,
finalize and eigh phases, K1's launches, ``gram.ring_steps``, whether the
int32 accumulators equal the first route's (by default the one-card
run) bitwise, and the largest per-column deviation of the top 4
coordinates from its.
Then one JSON line with the hop and K1 times, and the card line
(``nvidia-smi`` name and power limit) first and last. Not collected by
pytest: a reading, not a test.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SLOTS = 4


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-samples", type=int, default=cs.N_SAMPLES)
    ap.add_argument("--n-variants", type=int, default=cs.N_VARIANTS)
    ap.add_argument("--block-variants", type=int, default=cs.BLOCK_VARIANTS)
    ap.add_argument("--routes", default="one,default,gather,ring,auto",
                    help="which routes, by key (the first is the "
                    "reference the others are held against)")
    ap.add_argument("--skip-rates", action="store_true",
                    help="leave out the hop and K1 timings")
    args = ap.parse_args()

    import torch

    from spark_examples_tpu_torch import kernels
    from spark_examples_tpu_torch.cli.main import main as cli_main
    from spark_examples_tpu_torch.core import telemetry, virtual
    from spark_examples_tpu_torch.core.meshes import Tiled
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
    if on_cuda:
        if torch.cuda.device_count() < SLOTS:
            print(f"needs {SLOTS} visible cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"packed_gram": packed_gram, "braycurtis": braycurtis_kernel}
    tmp = tempfile.mkdtemp()
    n, v, bv = args.n_samples, args.n_variants, args.block_variants
    src = SyntheticSource(n_samples=n, n_variants=v)
    g = np.concatenate([b for b, _ in src.blocks(16384)], axis=1)
    store = os.path.join(tmp, "store")
    save_packed(store, g, src.sample_ids)
    del g
    base = ["pcoa", "--metric", "ibs", "--source", "packed", "--path", store,
            "--block-variants", str(bv), "--device", args.device,
            "--num-pc", str(cs.NUM_PC)]
    mesh = ["--mesh-shape", "2x2"]
    known = {
        "one": ("one card (replicated)", ["--gram-mode", "replicated"]),
        "default": ("every card, default plan (auto)", []),
        "gather": ("tile2d gather 2x2", ["--gram-mode", "tile2d",
                                         "--tile2d-transport", "gather"]
                   + mesh),
        "ring": ("tile2d ring 2x2", ["--gram-mode", "tile2d",
                                     "--tile2d-transport", "ring"] + mesh),
        "auto": ("tile2d auto 2x2", ["--gram-mode", "tile2d"] + mesh),
    }
    routes = dict(known[k] for k in args.routes.split(","))

    def scope():
        # The dry run puts the four slots on the CPU.
        return (contextlib.nullcontext() if on_cuda
                else virtual.virtual_slots(SLOTS))

    want = {}
    for rep in range(args.reps):
        for name in (list(routes) if rep % 2 == 0
                     else list(reversed(routes))):
            kept: list = []
            orig = cs.keeping(runner, "run_gram", kept)
            before = telemetry.counter_value("gram.ring_steps")
            try:
                with scope():
                    counts, timings, coords, wall = cs.run_cli(
                        cli_main, base + routes[name], counters, cs.NUM_PC)
            finally:
                runner.run_gram = orig
            grun = kept[-1]
            acc = {k: (x.full("cpu") if isinstance(x, Tiled) else x.cpu())
                   for k, x in grun.acc.items()}
            if not want:  # the first run: the reference
                want["acc"], want["coords"] = acc, coords
            row = {
                "route": name, "rep": rep, "n_samples": n,
                "n_variants": v, "wall_s": wall,
                "plan": f"{grun.plan.mode} {grun.plan.mesh.describe()}",
                "phases_s": {k: timings[k] for k in ("gram", "finalize",
                                                     "eigh") if k in timings},
                "k1_launches": counts["packed_gram"],
                "ring_steps": int(telemetry.counter_value("gram.ring_steps")
                                  - before),
                "acc_bitwise_one_card": cs.equal_accumulators(acc,
                                                              want["acc"]),
                "coords_dev": cs.same_columns(coords, want["coords"],
                                              cs.NUM_POP_PCS, float("inf")),
            }
            del grun, kept, acc
            print(json.dumps(row), flush=True)

    if on_cuda and not args.skip_rates:
        # The ring's hop against one ring step's contraction, at this
        # width: a shard is a quarter of a block's packed bytes.
        block, _ = next(load_packed(store).packed_blocks(bv))
        full = torch.from_numpy(np.ascontiguousarray(block)).to("cuda:0")
        shard = full[:, :full.shape[1] // SLOTS].contiguous()
        tn = n // 2
        ibs = kernels.get("ibs").pieces
        rows, cols = shard[:tn].contiguous(), shard[tn:].contiguous()
        k1_ms = cs.cuda_ms(lambda: packed_gram.fused_tile_products(
            rows, cols, ibs), reps=50, warmup=5)

        def hop_ms(t, reps=50):
            for _ in range(5):
                t.to("cuda:1", non_blocking=True)
            for d in range(2):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            for _ in range(reps):
                t.to("cuda:1", non_blocking=True)
            for d in range(2):
                torch.cuda.synchronize(d)
            return (time.perf_counter() - t0) / reps * 1e3

        shard_hop = hop_ms(shard)
        block_hop = hop_ms(full)
        rect = cs.k1_rect_bounds(tn, tn, shard.shape[1], ibs)
        k1_rate = rect["ops"] / (k1_ms * 1e-3)
        link_rate = shard.numel() / (shard_hop * 1e-3)
        print(json.dumps({
            "ring_shard": list(shard.shape),
            "k1_ring_tile_ms": k1_ms, "k1_ring_tile_bound_ms":
            rect["bound_ms"], "k1_ops_per_s": k1_rate,
            "shard_hop_ms": shard_hop, "shard_bytes": shard.numel(),
            "block_hop_ms": block_hop, "block_bytes": full.numel(),
            "link_bytes_per_s_shard": link_rate,
            "link_bytes_per_s_block": full.numel() / (block_hop * 1e-3),
            "ops_per_byte_measured": k1_rate / link_rate,
            "p2p_0_1": torch.cuda.can_device_access_peer(0, 1),
        }), flush=True)
        print(f"card: {cs.card_line()}")
    print("MESH READING OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
