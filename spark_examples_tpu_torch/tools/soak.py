"""Chaos soak: a seeded randomized fault schedule over every subsystem.

The port's copy of the JAX package's ``tools/soak.py``, run against the
port (``spark_examples_tpu_torch``) on ``SoakConfig.device``: the card
by default, the CPU when a caller asks (the tests). The schedule, the
scenario tables and the invariants are the JAX harness's; the fault
sites are the port's 16 (``core/faults.py::SITES``).

Single-fault tests prove each recovery path once; the soak proves they
*compose*: N iterations, each arming one randomized fault spec
(site x kind x after/max/params drawn from a seeded RNG) against a real
job — the streamed gram pipeline over a store-backed source (retry,
readahead, heal, checkpoint sites) or the projection server (request
faults) — and checking the invariants after every round:

- **Bit-identity.** The round's result equals the clean baseline
  exactly (integer accumulations: there is no tolerance to hide
  behind). For serve ``io_error`` rounds, exactly the injected
  requests fail — explicitly, with the injected error — and every
  other response is bit-identical.
- **No deadlock.** The round completes inside a watchdog budget
  (supervised subprocess rounds inherit the real watchdog;
  in-process rounds are wall-clock-checked).
- **No leaks.** Every pool/worker thread the round started is gone
  again afterwards (readahead pools, serve workers, heartbeats), and
  the decode cache sits within its byte bound.
- **Consistent heal bookkeeping.** A round that corrupted a chunk on
  disk must leave the store healed: ``store.healed`` advanced and the
  quarantine ledger empty (the soak's store records its origin, so
  every corruption is repairable).

Any violation emits ONE repro line —
``SOAK-REPRO seed=<s> iter=<i> spec=<site:kind:...> job=<kind>`` —
which re-runs that exact round deterministically.

``include_kill`` adds supervised subprocess rounds: the same job run
via the CLI under ``--supervise`` with an injected ``kill`` at a
randomized block, restarting from checkpoints; the output file must
equal the clean run's bytes.

Entry points: ``run_soak`` (library), ``bench_torch.py --chaos-soak``
(25 fixed-seed iterations in the bench headline), ``python -m
spark_examples_tpu_torch.tools.soak`` (a thin CLI), and the tier-1
``soak``-marked smoke in tests/test_torch_soak.py (in-process scenarios
only, on the CPU).
"""

from __future__ import annotations

import gc
import json
import os
import random
import subprocess
import sys
import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np

from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.pipelines import runner
from spark_examples_tpu_torch.store import quarantine as qledger
from spark_examples_tpu_torch.store.heal import origin_from_ingest
from spark_examples_tpu_torch.store.writer import compact

# Thread-name prefixes the leak accounting covers: any of these still
# alive after a round (and a GC + settle window) is a leak. This table
# is also the port's graftlint thread-hygiene contract (the rule parses
# it from this file's source): every named thread of the port carries
# one of these prefixes or one of the rule's port-only families.
_SUSPECT_THREADS = ("store-readahead", "projection-serve-worker",
                    "fleet-serve-worker", "fleet-controller",
                    "supervisor-heartbeat", "telemetry-flusher",
                    "prefetch-producer", "partitioned-reader",
                    "projection-http", "live-telemetry-http",
                    "supervisor-live-proxy", "loadgen-client",
                    "fleet-metrics-http")

# The in-process schedule: (job, site, kind, param ranges). `after` is
# drawn per-round from its range so the fault lands at a different hit
# each time; `max` bounds fires under the job's retry budget so the
# documented contract is full recovery.
SCENARIOS: tuple = (
    ("gram", "ingest.block_read", "io_error",
     dict(after=(0, 6), max=(1, 2))),
    ("gram", "ingest.block_read", "delay",
     dict(after=(0, 6), max=(1, 3), delay=0.01)),
    ("gram", "store.read", "io_error", dict(after=(0, 3), max=(1, 2))),
    # On-disk corruption: the chunk is truncated against its content
    # address and must be HEALED from the recorded origin, in place,
    # with the stream completing bit-identically.
    ("gram", "store.read", "truncate", dict(after=(0, 3), max=(1, 1),
                                            keep=8)),
    ("gram", "store.readahead.decode", "io_error",
     dict(after=(0, 2), max=(1, 1))),
    # Same site, DENSE transport: the readahead warm runs the native
    # decode-to-slab entry (inflate + unpack of the compressed chunk
    # in one C call — store/codec.py), so the held-and-re-raised error
    # contract is proven on the native path, not just the Python one.
    ("gram-dense", "store.readahead.decode", "io_error",
     dict(after=(0, 2), max=(1, 1))),
    ("gram", "device.put", "delay", dict(after=(0, 6), max=(1, 2),
                                         delay=0.01)),
    ("gram", "multihost.consensus", "delay",
     dict(after=(0, 2), max=(1, 2), delay=0.01)),
    ("gram", "checkpoint.tile_write", "truncate",
     dict(after=(0, 7), max=(1, 1), keep=8)),
    # Neighbor rounds: the combined minhash+exact-eval job over the
    # store source; an io_error at the candidate-evaluation site is
    # recomputed wholesale inside the retry boundary, so the sparse
    # top-k must come out bit-identical to the clean baseline.
    ("neighbors", "neighbors.candidates", "io_error",
     dict(after=(0, 6), max=(1, 2))),
    ("serve", "serve.request", "io_error", dict(after=(0, 5), max=(1, 1))),
    ("serve", "serve.request", "delay", dict(after=(0, 5), max=(1, 2),
                                             delay=0.02)),
    # Fleet rounds: a 2-route fleet under a one-panel budget, so the
    # round-robin traffic churns LRU eviction + re-stage through the
    # fleet.stage site — an io_error fails exactly the requests
    # waiting on that stage (the rest stay bit-identical), a delay is
    # a slow cold tier (latency, never correctness).
    ("fleet", "fleet.stage", "io_error", dict(after=(0, 4), max=(1, 2))),
    ("fleet", "fleet.stage", "delay", dict(after=(0, 4), max=(1, 2),
                                           delay=0.01)),
    # Shard-staged fleet rounds: ONE route whose panel exceeds the pool
    # budget, so every request streams the panel as a multi-shard
    # sequence through the same fleet.stage site (after >= 1 lands the
    # fault MID-panel, between shards). An io_error fails exactly its
    # own request — explicitly — a delay is pure latency, and after the
    # armed window closes a full post-heal sweep must be bit-identical
    # to the warm-pool fleet baseline (sharding is an accounting
    # strategy, never an answer change).
    ("fleet-sharded", "fleet.stage", "io_error",
     dict(after=(1, 4), max=(1, 2))),
    ("fleet-sharded", "fleet.stage", "delay",
     dict(after=(1, 4), max=(1, 2), delay=0.01)),
    # Every gram round runs a periodic live-telemetry flusher; a flush
    # that fails must be absorbed (warned + counted) with the job —
    # and every published snapshot — intact.
    ("gram", "telemetry.flush", "io_error", dict(after=(0, 8), max=(1, 2))),
    # Controller rounds (fleet/controller.py): a 2-replica fleet under
    # the control loop, each round ALSO running the deterministic
    # chaos sequence (replica kill mid-hedged-burst -> respawn within
    # the backoff budget with zero admitted requests lost, then a
    # preemption storm draining every replica in turn) plus the armed
    # site: a scrape blackhole (last-good-marked-stale until the slot
    # is declared lost), a spawn-failure cascade (backoff, never a
    # spawn loop), or a stage failure while a respawned replica warms
    # its assigned panels. Bit-identity of served coordinates is
    # pinned across every recovery.
    ("controller", "controller.scrape", "io_error",
     dict(after=(0, 2), max=(1, 2))),
    ("controller", "controller.spawn", "io_error",
     dict(after=(0, 1), max=(1, 1))),
    ("controller", "fleet.stage", "io_error",
     dict(after=(0, 2), max=(1, 1))),
    # The flight tape under fire: the controller's timeline ring
    # (fleet/timeline.py) takes the armed trace.export fault on its
    # appends/compactions — an io_error is absorbed (counted, never
    # killing the control loop), a truncate tears the ring's tail
    # mid-line and read_timeline must still return every complete
    # record before it (the last-good-tape contract).
    ("controller", "trace.export", "io_error",
     dict(after=(0, 3), max=(1, 2))),
    ("controller", "trace.export", "truncate",
     dict(after=(0, 3), max=(1, 1), keep=8)),
)

KILL_SCENARIOS: tuple = (
    ("cli", "ingest.block_read", "kill", dict(after=(2, 6), max=(1, 1))),
    ("cli", "store.read", "kill", dict(after=(1, 3), max=(1, 1))),
    # Kill MID-FLUSH: the tmp+rename protocol must leave the last-good
    # snapshot readable (checked by _snapshots_readable after every
    # supervised round), and the restarted attempt completes
    # bit-identically.
    ("cli", "telemetry.flush", "kill", dict(after=(1, 4), max=(1, 1))),
)


@dataclass
class SoakConfig:
    workdir: str
    iterations: int = 25
    seed: int = 0
    include_kill: bool = True
    n_samples: int = 16
    n_variants: int = 1024
    chunk_variants: int = 256
    block_variants: int = 128
    round_budget_s: float = 60.0  # in-process deadlock watchdog
    kill_budget_s: float = 300.0  # supervised subprocess rounds
    device: str = "cuda"  # every job, engine, fleet and CLI round


@dataclass
class SoakReport:
    iterations: int = 0
    rounds: list = field(default_factory=list)
    violations: list = field(default_factory=list)
    healed: int = 0
    retries: int = 0
    restarts: int = 0
    faults_fired: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "iterations": self.iterations,
            "ok": self.ok,
            "violations": self.violations,
            "healed": self.healed,
            "retries": self.retries,
            "restarts": self.restarts,
            "faults_fired": self.faults_fired,
            "rounds": self.rounds,
        }


def _spec_str(site: str, kind: str, rng: random.Random,
              params: dict) -> str:
    """One randomized spec drawn from the scenario's ranges."""
    after = rng.randint(*params["after"])
    max_fires = rng.randint(*params["max"])
    spec = f"{site}:{kind}:after={after}:max={max_fires}"
    if "delay" in params:
        spec += f":delay={params['delay']}"
    if "keep" in params:
        spec += f":keep={params['keep']}"
    return spec


def _suspect_counts() -> dict[str, int]:
    counts: dict[str, int] = {}
    for t in threading.enumerate():
        if not t.is_alive():
            continue
        for prefix in _SUSPECT_THREADS:
            if t.name.startswith(prefix):
                counts[prefix] = counts.get(prefix, 0) + 1
    return counts


def _leaked_threads(baseline: dict[str, int],
                    settle_s: float = 5.0) -> list[str]:
    """Suspect-thread prefixes whose live count exceeds the fixture
    baseline after a settle window (pool threads wind down
    asynchronously after their executor is released — poll, don't
    snapshot). The baseline covers long-lived fixture plumbing (the
    serve engine's panel source); a round must not ADD to it."""
    deadline = time.monotonic() + settle_s
    while True:
        gc.collect()
        over = [f"{k} x{v} (baseline {baseline.get(k, 0)})"
                for k, v in _suspect_counts().items()
                if v > baseline.get(k, 0)]
        if not over or time.monotonic() > deadline:
            return over
        time.sleep(0.05)


class _Fixture:
    """Everything the rounds share: the origin-recorded store, the
    clean baselines, and (for serve rounds) a warmed engine."""

    def __init__(self, cfg: SoakConfig):
        self.cfg = cfg
        self.store_dir = os.path.join(cfg.workdir, "store")
        self.ingest_cfg = IngestConfig(
            source="synthetic", n_samples=cfg.n_samples,
            n_variants=cfg.n_variants, seed=7,
            block_variants=cfg.block_variants,
        )
        self.device = cfg.device
        src = runner.build_source(self.ingest_cfg, cfg.device)
        # Default codec (zlib): every store round in the soak exercises
        # compressed chunks — incl. truncate -> origin-heal, which must
        # re-compress byte-identically to clear the ledger.
        compact(self.store_dir, src, chunk_variants=cfg.chunk_variants,
                origin=origin_from_ingest(self.ingest_cfg,
                                          cfg.chunk_variants))
        # Clean gram baselines over the store transport (the exact jobs
        # the rounds run, no faults armed): packed (ibs) and dense
        # (dot — the transport whose readahead warms run the native
        # decode-to-slab entry).
        faults.disarm()
        self.baseline_sim = self._gram_job(None).similarity
        self.baseline_sim_dense = self._gram_job(None,
                                                 metric="dot").similarity
        # Clean neighbors baseline (minhash + LSH + exact sparse eval
        # over the same store transport the faulted rounds run).
        nb = self._neighbors_job()
        self.baseline_neighbors = (nb.ids.copy(), nb.sims.copy())
        # Serve fixture: model fit over the same panel + warmed engine.
        from spark_examples_tpu_torch.pipelines.jobs import pcoa_job
        from spark_examples_tpu_torch.serve import ProjectionEngine

        self.model_path = os.path.join(cfg.workdir, "model.npz")
        fit_job = JobConfig(
            ingest=IngestConfig(block_variants=cfg.block_variants),
            compute=ComputeConfig(metric="ibs", num_pc=3,
                                  device=cfg.device),
            model_path=self.model_path,
        )
        panel = runner.build_source(
            IngestConfig(source="store", path=self.store_dir,
                         block_variants=cfg.block_variants), cfg.device)
        pcoa_job(fit_job, source=panel)
        self._close_source(panel)
        # Panel staged without readahead: the engine keeps its source
        # (for restage), and a fixture-lifetime pool would sit in every
        # round's thread accounting.
        self.engine = ProjectionEngine(
            self.model_path,
            runner.build_source(
                IngestConfig(source="store", path=self.store_dir,
                             block_variants=cfg.block_variants,
                             readahead_chunks=0), cfg.device),
            block_variants=cfg.block_variants, max_batch=4,
            device=cfg.device)
        pool_rng = np.random.default_rng(11)
        self.query_pool = pool_rng.integers(
            0, 3, size=(6, cfg.n_variants)).astype(np.int8)
        self.baseline_coords = [
            self.engine.project_batch(q[None, :])
            for q in self.query_pool
        ]
        # Fleet fixture: a SECOND model (PCA) on the same store panel,
        # plus clean per-route baselines from an unfaulted fleet — the
        # fleet rounds churn eviction/re-stage between the two routes
        # under a one-panel budget.
        from spark_examples_tpu_torch.pipelines.jobs import variants_pca_job

        self.pca_model_path = os.path.join(cfg.workdir, "model_pca.npz")
        pca_panel = runner.build_source(
            IngestConfig(source="store", path=self.store_dir,
                         block_variants=cfg.block_variants), cfg.device)
        variants_pca_job(
            JobConfig(
                ingest=IngestConfig(block_variants=cfg.block_variants),
                compute=ComputeConfig(num_pc=3, device=cfg.device),
                model_path=self.pca_model_path,
            ),
            source=pca_panel)
        self._close_source(pca_panel)
        self.fleet_baseline: dict[str, list] = {}
        fleet = self.make_fleet()
        try:
            fleet.start()
            for route in ("ibs", "pca"):
                self.fleet_baseline[route] = [
                    fleet.project(route, q, timeout=60.0)
                    for q in self.query_pool
                ]
        finally:
            fleet.close()
        self.thread_baseline = _suspect_counts()

    def make_fleet(self):
        """A fresh 2-route fleet over the soak store: budget sized for
        ONE staged panel, so alternating-route traffic must evict and
        re-stage through fleet.stage every switch."""
        from spark_examples_tpu_torch.core.config import ServeConfig
        from spark_examples_tpu_torch.serve import FleetManifest, build_fleet

        panel_bytes = self.cfg.n_samples * self.cfg.n_variants
        manifest = FleetManifest.parse({
            "budget_mb": panel_bytes * 1.5 / 1e6,
            "routes": [
                {"name": "ibs", "model": self.model_path,
                 "source": f"store:{self.store_dir}"},
                {"name": "pca", "model": self.pca_model_path,
                 "source": f"store:{self.store_dir}"},
            ],
        })
        return build_fleet(
            manifest, ServeConfig(cache_entries=0),
            ingest_defaults=IngestConfig(
                block_variants=self.cfg.block_variants,
                readahead_chunks=2, store_cache_mb=4),
            device=self.device,
        )

    def make_sharded_fleet(self):
        """A fresh 1-route fleet whose panel EXCEEDS the pool budget
        (budget = 0.4 panels), so every request serves shard-staged:
        ~3 budget-sized shards streamed from the store per request
        through the fleet.stage site, transient pool charges only."""
        from spark_examples_tpu_torch.core.config import ServeConfig
        from spark_examples_tpu_torch.serve import FleetManifest, build_fleet

        panel_bytes = self.cfg.n_samples * self.cfg.n_variants
        manifest = FleetManifest.parse({
            "budget_mb": panel_bytes * 0.4 / 1e6,
            "routes": [
                {"name": "ibs", "model": self.model_path,
                 "source": f"store:{self.store_dir}"},
            ],
        })
        return build_fleet(
            manifest, ServeConfig(cache_entries=0),
            ingest_defaults=IngestConfig(
                block_variants=self.cfg.block_variants,
                readahead_chunks=2, store_cache_mb=4),
            device=self.device,
        )

    @staticmethod
    def _close_source(src) -> None:
        for obj in (src, getattr(src, "inner", None)):
            close = getattr(obj, "close", None)
            if close is not None:
                close()

    def _gram_job(self, ckpt_dir: str | None, metric: str = "ibs"):
        job = JobConfig(
            ingest=IngestConfig(
                source="store", path=self.store_dir,
                block_variants=self.cfg.block_variants,
                io_retries=3, io_retry_backoff_s=0.001,
                readahead_chunks=2, store_cache_mb=4,
            ),
            compute=ComputeConfig(
                metric=metric, checkpoint_dir=ckpt_dir,
                checkpoint_every_blocks=2 if ckpt_dir else 0,
                device=self.device,
            ),
        )
        src = runner.build_source(job.ingest, self.device)
        try:
            return runner.run_similarity(job, source=src)
        finally:
            self._close_source(src)

    def _neighbors_job(self):
        from spark_examples_tpu_torch.neighbors.engine import neighbors_job

        job = JobConfig(
            ingest=IngestConfig(
                source="store", path=self.store_dir,
                block_variants=self.cfg.block_variants,
                io_retries=3, io_retry_backoff_s=0.001,
                readahead_chunks=2, store_cache_mb=4,
            ),
            compute=ComputeConfig(metric="ibs", minhash_hashes=32,
                                  minhash_bands=8, neighbors_k=5,
                                  device=self.device),
        )
        src = runner.build_source(job.ingest, self.device)
        try:
            return neighbors_job(job, source=src)
        finally:
            self._close_source(src)

    def store_consistent(self) -> str | None:
        """Post-round store invariant: quarantine ledger empty and
        every chunk file byte-verifiable. A reason string on violation."""
        entries = qledger.load(self.store_dir)
        if entries:
            return (f"quarantine ledger not empty after the round "
                    f"({len(entries)} entries — heal should have "
                    "cleared them)")
        from spark_examples_tpu_torch.core import hashing
        from spark_examples_tpu_torch.store.manifest import StoreManifest

        manifest = StoreManifest.load(self.store_dir)
        for rec in manifest.chunks:
            path = os.path.join(self.store_dir, rec.filename())
            try:
                if hashing.sha256_file(path) != rec.digest:
                    return f"chunk {rec.digest[:16]}... corrupt on disk"
            except OSError as e:
                return f"chunk {rec.digest[:16]}... unreadable ({e})"
        return None


def _snapshots_readable(tel_dir: str) -> str | None:
    """Post-round live-snapshot invariant: every published
    metrics.json / live_trace.jsonl under the round's telemetry dir
    must parse — a flush that failed or a kill mid-write must have
    left the LAST-GOOD file, never a torn one. A reason on violation."""
    for root, _dirs, files in os.walk(tel_dir):
        for name in files:
            path = os.path.join(root, name)
            try:
                if name == "metrics.json":
                    with open(path) as f:
                        json.load(f)
                elif name.endswith(".jsonl"):
                    with open(path) as f:
                        for line in f:
                            if line.strip():
                                json.loads(line)
            except (OSError, ValueError) as e:
                return (f"published snapshot {os.path.relpath(path, tel_dir)}"
                        f" is not readable ({e}) — the atomic-write "
                        "contract is broken")
    return None


def _run_gram_round(fx: _Fixture, i: int, spec: str,
                    round_seed: int, metric: str = "ibs") -> list[str]:
    """One in-process gram round under `spec`, with the periodic
    live-telemetry flusher publishing snapshots throughout (the
    telemetry.flush site fires inside it); returns violations."""
    problems: list[str] = []
    ckpt = os.path.join(fx.cfg.workdir, f"ck{i}")
    tel = os.path.join(fx.cfg.workdir, f"ltel{i}")
    flusher = telemetry.PeriodicFlusher(tel, interval_s=0.02)
    with faults.armed([spec], seed=round_seed):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            flusher.start()
            try:
                res = fx._gram_job(ckpt, metric=metric)
            finally:
                flusher.stop()
    baseline = (fx.baseline_sim_dense if metric == "dot"
                else fx.baseline_sim)
    if not np.array_equal(res.similarity, baseline):
        problems.append("gram result differs from clean baseline")
    reason = _snapshots_readable(tel)
    if reason:
        problems.append(reason)
    return problems


def _run_neighbors_round(fx: _Fixture, spec: str,
                         round_seed: int) -> list[str]:
    """One in-process neighbors round under `spec`: the injected
    io_error in the candidate-evaluation loop is retried by recomputing
    the block wholesale, so the sparse top-k (ids AND similarities)
    must equal the clean baseline exactly."""
    problems: list[str] = []
    with faults.armed([spec], seed=round_seed):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res = fx._neighbors_job()
    ids0, sims0 = fx.baseline_neighbors
    if not np.array_equal(res.ids, ids0):
        problems.append("neighbor ids differ from clean baseline")
    if not np.array_equal(res.sims, sims0):
        problems.append("neighbor similarities differ from clean "
                        "baseline")
    return problems


def _run_serve_round(fx: _Fixture, spec: str,
                     round_seed: int) -> list[str]:
    """One in-process serve round: sequential queries through a fresh
    server over the shared engine. Injected io_errors must fail exactly
    their own request with the injected error; everything else must be
    bit-identical; the drain must be clean."""
    from spark_examples_tpu_torch.serve import ProjectionServer

    problems: list[str] = []
    server = ProjectionServer(fx.engine, cache_entries=0,
                              max_linger_s=0.001).start()
    injected = 0
    try:
        with faults.armed([spec], seed=round_seed) as inj:
            for qi, q in enumerate(fx.query_pool):
                try:
                    got = server.project(q, timeout=30.0)
                except faults.InjectedFault:
                    injected += 1
                    continue
                if not np.array_equal(got, fx.baseline_coords[qi]):
                    problems.append(
                        f"served coords for query {qi} differ from "
                        "baseline")
            fired = inj.fire_count("serve.request")
        if injected != (fired if "io_error" in spec else 0):
            problems.append(
                f"{injected} requests failed with the injected error "
                f"but {fired} io_error fault(s) fired")
        if not server.drain(timeout=30.0):
            problems.append("serve drain was not clean")
    finally:
        server.close()
    return problems


def _run_fleet_round(fx: _Fixture, spec: str,
                     round_seed: int) -> list[str]:
    """One in-process fleet round: a fresh 2-route fleet under a
    one-panel budget, alternating-route traffic so every route switch
    is an eviction + fleet.stage re-stage. Injected stage io_errors
    must fail exactly their own waiting request (explicitly — either
    the injected error, or PanelUnavailable if they tripped the route
    breaker); every other answer must be bit-identical to the clean
    fleet baseline; the drain must be clean."""
    from spark_examples_tpu_torch.serve import PanelUnavailable

    problems: list[str] = []
    fleet = fx.make_fleet()
    injected = 0
    try:
        fleet.start()
        with faults.armed([spec], seed=round_seed) as inj:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for _sweep in range(2):
                    for route in ("ibs", "pca"):
                        for qi, q in enumerate(fx.query_pool):
                            try:
                                got = fleet.project(route, q,
                                                    timeout=30.0)
                            except (faults.InjectedFault,
                                    PanelUnavailable):
                                injected += 1
                                continue
                            if not np.array_equal(
                                    got, fx.fleet_baseline[route][qi]):
                                problems.append(
                                    f"fleet coords for {route}[{qi}] "
                                    "differ from baseline")
            fired = inj.fire_count("fleet.stage")
        if "io_error" in spec and injected < fired:
            problems.append(
                f"{fired} fleet.stage io_error(s) fired but only "
                f"{injected} request(s) failed with the injected "
                "error — a stage failure was swallowed")
        if "delay" in spec and injected:
            problems.append(
                f"{injected} request(s) failed under a delay-only "
                "spec — a slow cold tier must cost latency, never "
                "correctness")
        if fleet.pool.resident_bytes() > fleet.pool.budget_bytes:
            problems.append("fleet pool over its configured budget")
        if not fleet.drain(timeout=30.0):
            problems.append("fleet drain was not clean")
    finally:
        fleet.close()
    return problems


def _run_sharded_fleet_round(fx: _Fixture, spec: str,
                             round_seed: int) -> list[str]:
    """One in-process shard-staged fleet round: a 1-route fleet whose
    panel exceeds the pool budget, so every request streams ~3 shards
    through the armed fleet.stage site — the fault lands MID-panel,
    between shards of a live request. Injected io_errors must fail
    exactly their own request (explicitly — the injected error, or
    PanelUnavailable if the route breaker tripped); delays are pure
    latency; and once the armed window closes, a full post-heal sweep
    must be bit-identical to the warm-pool fleet baseline, with the
    pool back to zero transient residency."""
    from spark_examples_tpu_torch.serve import PanelUnavailable

    problems: list[str] = []
    fleet = fx.make_sharded_fleet()
    injected = 0
    stages0 = telemetry.counter_value("fleet.shard_stages")
    try:
        fleet.start()
        with faults.armed([spec], seed=round_seed) as inj:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for _sweep in range(2):
                    for qi, q in enumerate(fx.query_pool):
                        try:
                            got = fleet.project("ibs", q, timeout=30.0)
                        except (faults.InjectedFault,
                                PanelUnavailable):
                            injected += 1
                            continue
                        if not np.array_equal(
                                got, fx.fleet_baseline["ibs"][qi]):
                            problems.append(
                                f"sharded fleet coords for [{qi}] "
                                "differ from the warm-pool baseline")
            fired = inj.fire_count("fleet.stage")
        if "io_error" in spec and injected < fired:
            problems.append(
                f"{fired} fleet.stage io_error(s) fired mid-panel but "
                f"only {injected} request(s) failed with the injected "
                "error — a shard-stage failure was swallowed")
        if "delay" in spec and injected:
            problems.append(
                f"{injected} request(s) failed under a delay-only "
                "spec — a slow shard stream must cost latency, never "
                "correctness")
        # Post-heal: the site is disarmed; every answer must come back
        # bit-identical (the breaker, if tripped, never wedges the
        # route past the armed window — failures here are violations).
        for qi, q in enumerate(fx.query_pool):
            try:
                got = fleet.project("ibs", q, timeout=30.0)
            except Exception as e:
                problems.append(
                    f"post-heal sharded request [{qi}] failed ({e!r}) "
                    "— the route did not heal after the fault window")
                continue
            if not np.array_equal(got, fx.fleet_baseline["ibs"][qi]):
                problems.append(
                    f"post-heal sharded coords for [{qi}] differ from "
                    "the warm-pool baseline")
        if telemetry.counter_value("fleet.shard_stages") - stages0 < 2:
            problems.append(
                "fewer than 2 shard stages observed — the round never "
                "actually served shard-staged")
        st = fleet.pool.stats()
        if st["transient_bytes"]:
            problems.append(
                f"{st['transient_bytes']} transient pool bytes still "
                "charged after the round — a shard charge leaked")
        if not fleet.drain(timeout=30.0):
            problems.append("sharded fleet drain was not clean")
    finally:
        fleet.close()
    return problems


def _make_controller(fx: _Fixture, ledger_path: str):
    """A 2-replica controller over LocalReplica fleets sharing the
    soak store as their cold tier — every replica can serve every
    route; the warm split comes from the controller's placement."""
    from spark_examples_tpu_torch.fleet import (
        ControllerConfig,
        FleetController,
        LocalReplica,
    )

    panel_bytes = fx.cfg.n_samples * fx.cfg.n_variants
    budget = int(panel_bytes * 1.5)

    def factory(name, generation):
        return LocalReplica(name, lambda: fx.make_fleet().start(),
                            budget_bytes=budget, generation=generation)

    cfg = ControllerConfig(
        min_replicas=2, max_replicas=3,
        idle_rounds=10_000,  # retire is not this round's subject
        stale_scrapes=2, hang_heartbeat_s=60.0,
        backoff_initial_s=0.01, backoff_max_s=0.5,
        flap_window_s=60.0, flap_max_respawns=20,
        drain_timeout_s=30.0, ledger_path=ledger_path,
    )
    return FleetController(factory, {"ibs": panel_bytes,
                                     "pca": panel_bytes}, cfg)


def _run_controller_round(fx: _Fixture, i: int, spec: str,
                          round_seed: int) -> list[str]:
    """One in-process controller round: the armed site (scrape
    blackhole / spawn cascade / stage failure) plus the deterministic
    chaos sequence every round runs — a replica kill mid-hedged-burst
    (zero admitted requests lost, respawn within the backoff budget)
    and a preemption storm — with served coordinates bit-identical to
    the clean fleet baseline after every recovery, and the atomic
    controller.json ledger readable with the story in it."""
    from spark_examples_tpu_torch.serve import (
        PanelUnavailable,
        run_hedged_loadgen,
    )

    problems: list[str] = []
    ledger = os.path.join(fx.cfg.workdir, f"controller{i}.json")
    ctrl = _make_controller(fx, ledger)
    heal_budget_s = 15.0  # >> the 0.5s backoff ceiling

    def _heal(why: str) -> bool:
        # Always step at least once: a freshly killed replica stays
        # "up" until a watch round notices the corpse.
        deadline = time.monotonic() + heal_budget_s
        while time.monotonic() < deadline:
            ctrl.step()
            reps = ctrl.replicas()
            if len(reps) >= 2 and all(r.alive() for r in reps):
                return True
            time.sleep(0.02)
        problems.append(
            f"controller did not heal back to 2 live replicas within "
            f"{heal_budget_s:.0f}s ({why}) — backoff budget blown "
            f"or flap breaker mis-tripped: "
            f"{[s.state for s in ctrl.slots]}")
        return False

    try:
        ctrl.start()
        with faults.armed([spec], seed=round_seed):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                # Watch rounds under the armed site: a blackholed
                # scrape serves last-good-marked-stale until the slot
                # is declared lost; spawn/stage failures must back
                # off and heal — never spawn-loop, never wedge.
                for _ in range(6):
                    ctrl.step()
                if not _heal("under the armed fault"):
                    return problems
                # Chaos 1: kill the primary mid-hedged-burst. The
                # hedge partner + ServerClosed failover must answer
                # every admitted request — a replica loss costs
                # latency, never an answer.
                routers = [r.router for r in ctrl.replicas()]
                box: dict = {}

                def _drive() -> None:
                    box["report"] = run_hedged_loadgen(
                        routers, fx.query_pool, clients=2,
                        requests_per_client=8, route="ibs",
                        hedge_floor_s=0.005, result_timeout_s=30.0,
                        seed=round_seed)

                driver = threading.Thread(
                    target=_drive, name="loadgen-client-driver",
                    daemon=True)
                driver.start()
                time.sleep(0.05)
                ctrl.replicas()[0].kill()
                driver.join(timeout=60.0)
                report = box.get("report")
                if report is None:
                    problems.append(
                        "hedged burst did not complete after the "
                        "replica kill (driver hung)")
                    return problems
                if report["errors"]:
                    # The armed site may land its fire on the
                    # survivor's serving path mid-burst (a stage fault
                    # opens the route breaker): those legs fail
                    # LOUDLY and attributably — the same explicit-
                    # failure tolerance as the bit-identity sweep
                    # below. Only silent losses (timeouts, swallowed
                    # legs) break the zero-loss contract.
                    injected = sum(
                        1 for r in report["error_records"]
                        if "InjectedFault" in r.get("error", "")
                        or "PanelUnavailable" in r.get("error", ""))
                    if report["errors"] > injected:
                        problems.append(
                            f"{report['errors'] - injected} request(s) "
                            f"lost to the replica kill (failovers="
                            f"{report['failovers']}, injected-fault "
                            f"errors={injected}) — the zero-loss "
                            "contract is broken")
                if not _heal("after the mid-burst kill"):
                    return problems
                # Chaos 2: preemption storm — every replica drained
                # and respawned in turn, gracefully.
                for slot_name in [r.name for r in ctrl.replicas()]:
                    if not ctrl.preempt(slot_name):
                        problems.append(
                            f"preempt({slot_name!r}) refused — slot "
                            "not up when the storm reached it")
                if not _heal("after the preemption storm"):
                    return problems
                # Bit-identity across every recovery: each surviving
                # replica serves both routes exactly as the clean
                # fleet baseline did (stage faults still armed fail
                # explicitly, like the fleet rounds).
                for replica in ctrl.replicas():
                    for route in ("ibs", "pca"):
                        for qi, q in enumerate(fx.query_pool):
                            try:
                                got = replica.router.project(
                                    route, q, timeout=30.0)
                            except (faults.InjectedFault,
                                    PanelUnavailable):
                                continue
                            if not np.array_equal(
                                    got, fx.fleet_baseline[route][qi]):
                                problems.append(
                                    f"{replica.name} served {route}"
                                    f"[{qi}] differs from the clean "
                                    "baseline after recovery")
        # Evidence: the atomic ledger must be readable and carry the
        # round's story.
        try:
            with open(ledger) as f:
                led = json.load(f)
        except (OSError, ValueError) as e:
            problems.append(f"controller ledger unreadable ({e}) — "
                            "the atomic-write contract is broken")
        else:
            acts = {d["action"] for d in led["decisions"]}
            kinds = {x["kind"] for x in led["incidents"]}
            if "respawn" not in acts or "preempt" not in acts:
                problems.append(
                    f"ledger is missing the round's decisions "
                    f"(actions={sorted(acts)})")
            if "crash" not in kinds:
                problems.append(
                    f"ledger has no crash incident for the mid-burst "
                    f"kill (kinds={sorted(kinds)})")
        # The timeline ring beside the ledger must stay readable even
        # when trace.export faults tore or failed appends: every
        # complete record before a torn tail survives, and the round's
        # story (control rounds + the crash marker) is on the tape.
        from spark_examples_tpu_torch.fleet.timeline import read_timeline
        tape = read_timeline(
            os.path.join(os.path.dirname(ledger) or ".",
                         "timeline.jsonl"))
        if not any(r.get("type") == "round" for r in tape):
            problems.append(
                "timeline ring has no round records after the round — "
                "the last-good-tape contract is broken")
        if not any(r.get("type") == "marker" and r.get("kind") == "crash"
                   for r in tape):
            problems.append(
                "timeline ring has no crash marker for the mid-burst "
                "kill")
    finally:
        ctrl.close()
    return problems


def _run_kill_round(fx: _Fixture, i: int, spec: str, round_seed: int,
                    baseline_tsv: bytes) -> tuple[list[str], int]:
    """One supervised subprocess round: the CLI job with an injected
    kill, restarted by --supervise, output bytes vs the clean run —
    with the periodic flusher live in every attempt, so a kill landing
    mid-flush (the telemetry.flush scenario) must still leave each
    attempt's last-good snapshot readable.
    Returns (violations, supervised restarts observed)."""
    cfg = fx.cfg
    out = os.path.join(cfg.workdir, f"kill{i}.tsv")
    ckpt = os.path.join(cfg.workdir, f"killck{i}")
    tel = os.path.join(cfg.workdir, f"killtel{i}")
    env = dict(
        os.environ,
        **{faults.ENV_SPECS: spec,
           faults.ENV_SEED: str(round_seed)},
    )
    cmd = _cli_gram_cmd(fx, out, ckpt, tel) + ["--supervise"]
    try:
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=cfg.kill_budget_s)
    except subprocess.TimeoutExpired:
        return [f"supervised round exceeded the {cfg.kill_budget_s:.0f}s "
                "watchdog budget (deadlock?)"], 0
    restarts = p.stderr.count("supervisor: attempt")
    if p.returncode != 0:
        return [f"supervised run exited {p.returncode}: "
                f"{p.stderr[-500:]}"], restarts
    problems = []
    reason = _snapshots_readable(tel)
    if reason:
        problems.append(reason)
    with open(out, "rb") as f:
        got = f.read()
    if got != baseline_tsv:
        problems.append("supervised kill-resume output differs from the "
                        "clean run's bytes")
    return problems, restarts


def _cli_gram_cmd(fx: _Fixture, out: str, ckpt: str,
                  tel: str | None = None) -> list[str]:
    cfg = fx.cfg
    cmd = [
        sys.executable, "-m", "spark_examples_tpu_torch", "similarity",
        "--source", f"store:{fx.store_dir}",
        "--block-variants", str(cfg.block_variants),
        "--metric", "ibs", "--io-retries", "3",
        "--checkpoint-dir", ckpt, "--checkpoint-every-blocks", "2",
        "--output-path", out, "--device", cfg.device,
    ]
    if tel is not None:
        cmd += ["--telemetry-dir", tel, "--telemetry-flush-s", "0.02"]
    return cmd


def run_soak(cfg: SoakConfig, scenarios: tuple | None = None) -> SoakReport:
    """The harness. Deterministic for a given (SoakConfig.seed,
    iterations, include_kill): the schedule, every spec's parameters,
    and every injector seed derive from one ``random.Random``.
    ``scenarios``: the table the schedule is drawn from, when not the
    whole one (``SCENARIOS``, plus ``KILL_SCENARIOS`` under
    ``include_kill``): a short run of chosen rounds."""
    os.makedirs(cfg.workdir, exist_ok=True)
    rng = random.Random(cfg.seed)
    report = SoakReport()
    fx = _Fixture(cfg)

    # Schedule: a seeded shuffle of the scenario table, repeated to
    # `iterations` — randomized order/params with guaranteed site
    # coverage once iterations >= the table size.
    if scenarios is not None:
        table = list(scenarios)
    else:
        table = list(SCENARIOS) + (list(KILL_SCENARIOS)
                                   if cfg.include_kill else [])
    schedule = []
    while len(schedule) < cfg.iterations:
        chunk = list(table)
        rng.shuffle(chunk)
        schedule.extend(chunk)
    schedule = schedule[:cfg.iterations]

    baseline_tsv = None
    if cfg.include_kill and any(j == "cli" for j, *_ in schedule):
        out = os.path.join(cfg.workdir, "clean.tsv")
        p = subprocess.run(
            _cli_gram_cmd(fx, out, os.path.join(cfg.workdir, "cleanck")),
            env={k: v for k, v in os.environ.items()
                 if k not in (faults.ENV_SPECS, faults.ENV_SEED)},
            capture_output=True, text=True, timeout=cfg.kill_budget_s,
        )
        if p.returncode != 0:
            raise RuntimeError(
                f"clean CLI baseline failed: {p.stderr[-500:]}")
        with open(out, "rb") as f:
            baseline_tsv = f.read()

    healed0 = telemetry.counter_value("store.healed")
    retries0 = telemetry.counter_value("ingest.retries")
    fired0 = telemetry.counter_value("faults.fired")

    for i, (jobkind, site, kind, params) in enumerate(schedule):
        round_seed = rng.randint(0, 2**31 - 1)
        spec = _spec_str(site, kind, rng, params)
        t0 = time.monotonic()
        try:
            if jobkind == "gram":
                problems = _run_gram_round(fx, i, spec, round_seed)
            elif jobkind == "gram-dense":
                problems = _run_gram_round(fx, i, spec, round_seed,
                                           metric="dot")
            elif jobkind == "neighbors":
                problems = _run_neighbors_round(fx, spec, round_seed)
            elif jobkind == "serve":
                problems = _run_serve_round(fx, spec, round_seed)
            elif jobkind == "fleet":
                problems = _run_fleet_round(fx, spec, round_seed)
            elif jobkind == "fleet-sharded":
                problems = _run_sharded_fleet_round(fx, spec, round_seed)
            elif jobkind == "controller":
                problems = _run_controller_round(fx, i, spec, round_seed)
            else:
                problems, restarts = _run_kill_round(
                    fx, i, spec, round_seed, baseline_tsv)
                report.restarts += restarts
        except BaseException as e:
            problems = [f"round raised {e!r}"]
        dt = time.monotonic() - t0
        if jobkind != "cli" and dt > cfg.round_budget_s:
            problems.append(
                f"round took {dt:.1f}s (> {cfg.round_budget_s:.0f}s "
                "budget — stall/deadlock)")
        leaks = _leaked_threads(fx.thread_baseline)
        if leaks:
            problems.append(f"leaked threads: {leaks}")
        reason = fx.store_consistent()
        if reason:
            problems.append(f"store bookkeeping: {reason}")
        report.rounds.append({
            "iter": i, "job": jobkind, "spec": spec,
            "seed": round_seed, "s": round(dt, 2),
            "ok": not problems,
        })
        for prob in problems:
            report.violations.append(
                f"SOAK-REPRO seed={cfg.seed} iter={i} spec={spec!r} "
                f"job={jobkind}: {prob}")
        report.iterations += 1
        if problems:
            break  # first violation stops the soak: the repro line is
            # the deliverable, and later rounds run on a possibly
            # damaged fixture
    report.healed = int(telemetry.counter_value("store.healed") - healed0)
    report.retries = int(telemetry.counter_value("ingest.retries")
                         - retries0)
    report.faults_fired = int(telemetry.counter_value("faults.fired")
                              - fired0)
    return report


def main(argv=None) -> int:  # pragma: no cover - thin CLI
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="chaos soak harness")
    ap.add_argument("--iterations", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="fixture dir (default: a fresh tmp dir, "
                    "removed on a clean soak, kept on violation so the "
                    "SOAK-REPRO line has its fixture)")
    ap.add_argument("--no-kill", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where every round runs (default: the card)")
    args = ap.parse_args(argv)
    own_workdir = args.workdir is None
    workdir = args.workdir or tempfile.mkdtemp(prefix="soak-")
    report = run_soak(SoakConfig(
        workdir=workdir, iterations=args.iterations, seed=args.seed,
        include_kill=not args.no_kill, device=args.device))
    print(json.dumps(report.to_json(), indent=1))
    if report.ok and own_workdir:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return 0 if report.ok else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
