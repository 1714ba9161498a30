"""The hedged loadgen's p99 on the CPU: the JAX package's
``run_hedged_loadgen`` beside the port's, at the size of
tests/test_fleet.py's hedging case (2 clients x 6 requests) and at
2 x 12, where more than 20 completions make the hedge delay the
rolling p95 of the run's own latencies.

    python tests/hedge_reading.py [--reps 3] [--fast-linger-ms 0]

Each package fits one ibs PCoA route (12 samples x 256 variants, the
fleet tests' fixture) and serves it from two fleet routers, one that
holds every batch for a 120 ms linger and one that does not (or holds
it for ``--fast-linger-ms``, to give the fast leg a batch as long as a
full-width panel's on the card). Per
package, size and repetition: an unhedged run over the slow router
twice (a hedge floor past every request) and a hedged run over the slow
and the fast router (floor 20 ms). Prints one JSON line per run pair
with both p50/p99 in ms, the hedges launched and won, and the errors.
Not collected by pytest: a reading, not a test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, V, BV = 12, 256, 128
LINGER_MS = 120.0
FLOOR_S = 0.02
SIZES = ((2, 6), (2, 12))


def genotypes(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(n, V), dtype=np.int8)
    g[rng.random((n, V)) < 0.1] = -1
    return g


def route_files(base: str, pkg: str) -> dict:
    """A store and a fitted ibs PCoA model, written by ``pkg``'s own
    code (``jax`` or ``torch``)."""
    if pkg == "jax":
        from spark_examples_tpu.core.config import (
            ComputeConfig, IngestConfig, JobConfig)
        from spark_examples_tpu.ingest.source import ArraySource
        from spark_examples_tpu.pipelines.jobs import pcoa_job
        from spark_examples_tpu.store.writer import compact
        extra = {}
    else:
        from spark_examples_tpu_torch.core.config import (
            ComputeConfig, IngestConfig, JobConfig)
        from spark_examples_tpu_torch.ingest.source import ArraySource
        from spark_examples_tpu_torch.pipelines.jobs import pcoa_job
        from spark_examples_tpu_torch.store.writer import compact
        extra = {"device": "cpu"}
    g = genotypes(42, N)
    store = os.path.join(base, f"store_{pkg}")
    model = os.path.join(base, f"model_{pkg}.npz")
    compact(store, ArraySource(g), chunk_variants=64)
    pcoa_job(JobConfig(ingest=IngestConfig(block_variants=BV),
                       compute=ComputeConfig(metric="ibs", num_pc=3,
                                             **extra),
                       model_path=model), source=ArraySource(g))
    return {"routes": [{"name": "r-ibs", "model": model,
                        "source": f"store:{store}"}], "budget_mb": 1.0}


def routers(pkg: str, doc: dict, fast_linger_ms: float):
    if pkg == "jax":
        from spark_examples_tpu.core.config import IngestConfig, ServeConfig
        from spark_examples_tpu.serve import (
            FleetManifest, build_fleet, run_hedged_loadgen)
        extra = {}
    else:
        from spark_examples_tpu_torch.core.config import (
            IngestConfig, ServeConfig)
        from spark_examples_tpu_torch.serve import (
            FleetManifest, build_fleet, run_hedged_loadgen)
        extra = {"device": "cpu"}

    def fleet(linger_ms: float):
        return build_fleet(
            FleetManifest.parse(doc),
            ServeConfig(cache_entries=0, max_linger_ms=linger_ms),
            ingest_defaults=IngestConfig(block_variants=BV,
                                         readahead_chunks=0),
            **extra).start()

    return fleet(LINGER_MS), fleet(fast_linger_ms), run_hedged_loadgen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fast-linger-ms", type=float, default=0.0)
    args = ap.parse_args(argv)
    pool = genotypes(41, 32)
    with tempfile.TemporaryDirectory() as base:
        for pkg in ("jax", "torch"):
            slow, fast, hedged_loadgen = routers(
                pkg, route_files(base, pkg), args.fast_linger_ms)
            try:
                for clients, requests in SIZES:
                    for rep in range(args.reps):
                        plain = hedged_loadgen(
                            [slow, slow], pool, clients=clients,
                            requests_per_client=requests, route="r-ibs",
                            hedge_floor_s=600.0)
                        hedged = hedged_loadgen(
                            [slow, fast], pool, clients=clients,
                            requests_per_client=requests, route="r-ibs",
                            hedge_floor_s=FLOOR_S)
                        print(json.dumps({
                            "package": pkg,
                            "fast_linger_ms": args.fast_linger_ms,
                            "clients": clients,
                            "requests": requests, "rep": rep,
                            "unhedged_p50_ms": plain["p50_s"] * 1e3,
                            "unhedged_p99_ms": plain["p99_s"] * 1e3,
                            "hedged_p50_ms": hedged["p50_s"] * 1e3,
                            "hedged_p99_ms": hedged["p99_s"] * 1e3,
                            "hedge_launched": hedged["hedge_launched"],
                            "hedge_wins": hedged["hedge_wins"],
                            "errors": plain["errors"] + hedged["errors"],
                        }), flush=True)
            finally:
                slow.close()
                fast.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
