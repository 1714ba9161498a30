"""Structured telemetry: metrics registry, spans, trace export and the
live plane.

The ported modules count what they do here: chunks verified, retries
absorbed, heals, the feed's waits, the gram loop's blocks, each served
request. Every name an instrumentation site uses must be declared in
:data:`NAMES` (entries ending in ``.*`` declare a family, like
``phase.*``); an undeclared name warns once and counts into
``telemetry.unknown_names`` instead of raising mid-job.
``tests/test_torch_telemetry_names.py`` lints the call sites.

- **Metrics registry**: counters (monotonic float sums), gauges
  (last/min/max) and streaming log-bucket histograms (2^(1/8) per
  bucket, no sample retention) with exact count/sum/min/max. Always on.
- **Spans** (:func:`span`, :func:`begin`, :func:`span_at`,
  :func:`traced`) time an interval into a same-named histogram of
  seconds and, while tracing is configured, into a Chrome trace event
  (keys ``name, cat, ph, ts, dur, pid, tid, args``: the JAX package's,
  so one stitcher reads either package's exports).
- **Events** (:func:`event`) are instant markers; the newest
  :data:`EVENT_RING` stay readable in-process (:func:`events`) whether
  or not tracing is on.
- **Request trace context** (:func:`trace_scope`, :func:`should_sample`
  — crc32 of the trace id against the rate, the JAX package's decision
  for the same id) and the slowest-K request exemplars.
- **Exporter** (:func:`export`): ``<dir>/rank<k>/{trace.jsonl,
  metrics.json}``, ``requests.json`` and a ``summary.txt``, every file
  written through tmp + rename. :class:`PeriodicFlusher` republishes
  ``metrics.json`` and a rolling ``live_trace.jsonl`` every ``flush_s``
  seconds (the ``telemetry.flush`` fault site fires inside each flush).
- :func:`derive_throughputs`, :func:`effective_gram_time` and
  :func:`stall_fraction`: the one formula the PhaseTimer report, the
  exporter and the summary share.

The HTTP surfaces over this module live in ``core/live.py``.
"""

from __future__ import annotations

import contextvars
import functools
import heapq
import json
import math
import os
import sys
import threading
import time
import uuid
import warnings
import zlib
from collections import deque
from contextlib import contextmanager

# The names the ported modules emit (kind, meaning). Spans double as
# duration histograms under the same name (seconds).
NAMES: dict[str, tuple[str, str]] = {
    # -- spans ------------------------------------------------------------
    "store.compact": (
        "span",
        "one compaction pass of the content-addressed store: source "
        "stream -> packed sha256-named chunk files + manifest",
    ),
    "store.chunk_read": (
        "span",
        "one chunk through the store read path: fault site + mmap + "
        "first-touch digest verify + decode (or decode-cache hit)",
    ),
    "store.heal": (
        "span",
        "one in-place chunk repair: verified copy from a replica dir, "
        "else re-compaction of the chunk's origin span",
    ),
    "checkpoint.save": ("span", "one checkpoint save (write + rotate)"),
    "checkpoint.write": (
        "span", "one checkpoint data file (hash-tee + np.save)"),
    "checkpoint.verify": (
        "span", "sha256 re-hash of a generation's files on load"),
    "checkpoint.rotate": ("span", "atomic generation rotation"),
    "checkpoint.load": (
        "span", "one checkpoint load (verify + fall back + place)"),
    "solver.pass": (
        "span",
        "one streamed pass of the sketch solver (solvers/): the range "
        "sketch Y = B@Q folded block by block over the whole cohort — "
        "pass 0 against the random probes, later passes the corrected "
        "rung's subspace-iteration power steps",
    ),
    "solver.solve": (
        "span",
        "the sketch solver's terminal solve: Nystrom eigenpairs "
        "(single-pass rung) or Rayleigh Ritz pairs (corrected) from the "
        "(N, rank) sketch state — never an N x N eigh",
    ),
    # -- counters ---------------------------------------------------------
    "checkpoint.fallback": (
        "counter",
        "loads that resumed from the .old generation (latest corrupt or "
        "missing), promoted back to the latest slot",
    ),
    "checkpoint.bytes_written": (
        "counter", "checkpoint data bytes written"),
    "solver.passes": (
        "counter",
        "streamed sketch-solver passes completed (1 for the sketch "
        "rung, 1 + --sketch-iters for corrected; each is one full "
        "variant pass over the cohort)",
    ),
    "ingest.retries": (
        "counter", "transient-IO retries absorbed by RetryingSource"),
    "ingest.reopens": (
        "counter", "inner-source rebuilds (reopen factory) before retries"),
    "ingest.corrupt_blocks": (
        "counter", "corrupt blocks failed fast (never retried)"),
    "ingest.exhausted": (
        "counter", "retry budgets exhausted (job-killing incidents)"),
    "ingest.backoff_s": ("counter", "seconds slept in retry backoff"),
    "ingest.parallel_shards": (
        "counter",
        "shards dispatched to the parallel ingest engine's worker pool "
        "(VCF byte ranges / exact-source block stripes)",
    ),
    "faults.fired": (
        "counter", "fault-injection specs fired (all sites)"),
    "store.readahead.scheduled": (
        "counter", "chunk warms submitted to the store readahead pool"),
    "store.readahead.hits": (
        "counter",
        "consumer chunk reads served by a completed (or awaited) "
        "background warm instead of an inline cold decode",
    ),
    "store.readahead.errors": (
        "counter",
        "warms that failed in a pool worker (each re-raised in the "
        "consumer when its cursor reaches the chunk)",
    ),
    "store.codec.raw_bytes": (
        "counter",
        "packed payload bytes produced by compaction before chunk "
        "compression; raw_bytes / stored_bytes is the compression ratio",
    ),
    "store.codec.stored_bytes": (
        "counter", "chunk bytes after compression (what is hashed and "
        "written)"),
    "store.codec.fallback": (
        "counter",
        "the native decode entry (store_decode_chunk) was unavailable and "
        "the Python chunk decode was selected (counted once per process: "
        "a selection flag, not a rate)",
    ),
    "store.compact_bytes": (
        "counter",
        "chunk bytes written by the compaction writer (a chunk "
        "deduplicated by content address counts once, when written)",
    ),
    "store.compact_chunks": (
        "counter", "chunks the compaction writer emitted (deduplicated "
        "ones included)"),
    "store.cache_hits": (
        "counter", "store reads answered from the decode cache"),
    "store.cache_misses": (
        "counter", "store reads that mapped and decoded a chunk"),
    "store.chunks_verified": (
        "counter", "chunk digests re-hashed on first touch per reader"),
    "store.verify_failures": (
        "counter", "chunks whose bytes failed a size, digest or decode "
        "check (healed ones included)"),
    "store.quarantined": (
        "counter", "corrupt chunks recorded in quarantine.json after "
        "every heal route failed"),
    "store.healed": (
        "counter", "corrupt chunks repaired in place (replica copy or "
        "origin re-compaction, digest-verified)"),
    "telemetry.unknown_names": (
        "counter", "instrumentation calls naming an undeclared metric"),
    "neighbors.candidate_pairs": (
        "counter",
        "candidate pairs emitted by LSH banding (after per-band bucket "
        "caps and i<j dedup): the pairs that pay exact evaluation "
        "instead of the full N(N-1)/2",
    ),
    "neighbors.bucket_overflows": (
        "counter",
        "samples dropped from over-cap LSH band buckets "
        "(--minhash-bucket-cap), truncated deterministically",
    ),
    "neighbors.evaluated_pairs": (
        "counter",
        "candidate pairs whose exact per-pair statistics were "
        "accumulated by the streamed evaluation pass (equals "
        "neighbors.candidate_pairs on a clean run)",
    ),
    # -- gauges -----------------------------------------------------------
    "solver.rung": (
        "gauge",
        "the accuracy-ladder rung this job's eigensolve ran "
        "(0 sketch, 1 corrected, 2 exact)",
    ),
    "solver.rank": (
        "gauge",
        "sketch probe columns actually used (--sketch-rank clamped to "
        "N) — the r of the (N, r) solver state",
    ),
    "solver.state_bytes": (
        "gauge",
        "sketch-solver state residency (the (N, r) f32 leaves and the "
        "(N,) vectors); compare solver.nxn_bytes_avoided",
    ),
    "solver.nxn_bytes_avoided": (
        "gauge",
        "bytes of N x N accumulator the exact route would have "
        "allocated for this cohort and metric",
    ),
    "solver.dual": (
        "gauge",
        "1 when the job streamed a ratio metric's dual (numerator + "
        "pair-count denominator) sketches, 0 for a single factor",
    ),
    "solver.dual_den_defect": (
        "gauge",
        "measured rank-1 residual of the ratio denominator from the "
        "pass-0 dual sketches — 0 means the scaled operator is exact",
    ),
    "neighbors.filter_frac": (
        "gauge",
        "fraction of all N(N-1)/2 pairs the LSH filter avoided "
        "evaluating exactly (1 - candidates/all); higher is better",
    ),
    "store.cache_bytes": (
        "gauge", "decoded bytes resident in the store's decode cache"),
    "store.readahead.depth": (
        "gauge", "the readahead pool's live, cadence-adaptive depth"),
    "store.readahead.in_flight": (
        "gauge", "chunk warms pending in the readahead pool"),
    # -- histograms -------------------------------------------------------
    "ingest.reassembly_wait_s": (
        "histogram",
        "consumer wait per in-order result at the parallel ingest "
        "engine's reassembly buffer",
    ),
    "store.readahead.wait_s": (
        "histogram",
        "consumer wait for an in-flight warm of the chunk its cursor "
        "just reached",
    ),
    # -- instant events ---------------------------------------------------
    "stream.snapshot": (
        "event",
        "streaming incremental-PCoA snapshot dispatched (args: "
        "n_variants, blocks_done)",
    ),
    # -- the gram loop, the feed, the live plane and serving -------------
    "phase.*": (
        "span",
        "one PhaseTimer phase (gram/eigh/finalize/...) — wall-clock of the "
        "named pipeline stage; also mirrored as a counter of summed seconds",
    ),
    "gram.block": (
        "span",
        "one block period of the streamed gram loop: producer/queue wait + "
        "host->device transfer + update dispatch + hooks + checkpoint",
    ),
    "multihost.consensus": (
        "span",
        "one control-plane allgather round (step-count / has-data / "
        "terminal agreement) — the wait is the per-rank straggler metric: "
        "a fast rank burns its skew here",
    ),
    "multihost.shard_feed_bytes": (
        "counter",
        "bytes THIS process fed into the mesh as its own variant-shard "
        "slabs (padding steps feed none) — summed across hosts, the "
        "aggregate-ingest number that scales with host count under the "
        "shard-aware feed",
    ),
    "gram.pad_step": (
        "event",
        "a loop step whose block carried no variant of this process's "
        "stream (an all-MISSING padding slab) — deliberately NOT a "
        "gram.block sample, so padding cannot skew the block percentiles",
    ),
    "gram.lowering": (
        "gauge",
        "count-family contraction lowering the gram job resolved to: 1 = "
        "the fused packed CUDA kernel (decode + mask + contract in one "
        "pass), 0 = the reference unpack-then-contract path — the auto "
        "choice made observable (--gram-lowering)",
    ),
    "gram.fused_blocks": (
        "counter",
        "block updates through the fused packed lowering, one per block "
        "whatever the number of tiles (the JAX package's meaning); on "
        "CUDA each runs the packed CUDA kernel (csrc/packed_gram.cu) once "
        "per tile — nonzero proves the fused kernel, not the plain "
        "unpack-then-contract path, is the one contracting (pairs with "
        "gram.lowering)",
    ),
    "gram.ring_steps": (
        "counter",
        "tile2d ring-transport shard rotations dispatched (n_devices per "
        "block update) — nonzero proves the ring schedule, not the bulk "
        "gather, is the one running",
    ),
    "gram_flops": ("counter", "FLOPs credited to the gram accumulation"),
    "ingest_bytes": ("counter", "bytes actually shipped host->device"),
    "eigh_flops": ("counter", "FLOPs credited to the eigensolve"),
    "prefetch.queue_depth": (
        "gauge",
        "prefetch queue occupancy sampled at each consumer get (max == "
        "configured depth means the producer is ahead; 0 means the card "
        "is starved)",
    ),
    "prefetch.transfers_in_flight": (
        "gauge",
        "host->device transfers dispatched ahead of the yielded block "
        "in the K-deep feed (bounded by the transfer ring depth)",
    ),
    "prefetch.put_wait_s": (
        "histogram",
        "producer-thread wait per block for queue space (large => "
        "consumer/device is the bottleneck)",
    ),
    "prefetch.get_wait_s": (
        "histogram",
        "consumer wait per block for the producer (large => ingest is the "
        "bottleneck; sum/gram time = the stall fraction)",
    ),
    "prefetch.stage_wait_s": (
        "histogram",
        "producer wait per block for a free pinned staging slab (large => "
        "the transfer/compute side of the ring is the bottleneck and "
        "every slab is in flight)",
    ),
    "prefetch.transfer_wait_s": (
        "histogram",
        "residual wait at block retire time for its host->device "
        "transfer to complete before the staging slab rotates back — "
        "~0 when the K-deep pipeline hides the transfer entirely",
    ),
    "fault": ("event", "a fault-injection spec fired (args: site, kind)"),
    "telemetry.dropped_events": (
        "counter", "trace events dropped past MAX_EVENTS"),
    "live.flush": (
        "span",
        "one periodic live-telemetry flush: the telemetry.flush fault "
        "site + atomic metrics.json rewrite + rolling live_trace.jsonl "
        "ring rewrite (tmp+rename both, so a kill mid-flush leaves the "
        "last-good snapshot readable)",
    ),
    "live.flushes": (
        "counter",
        "periodic live-telemetry snapshots published by the background "
        "flusher (atomic metrics.json + rolling live_trace.jsonl every "
        "flush_s seconds)",
    ),
    "live.flush_errors": (
        "counter",
        "periodic flushes that failed (unwritable dir, full disk, "
        "injected telemetry.flush fault) — warned once and absorbed; "
        "the flusher must never be able to kill the job it reports on",
    ),
    "live.requests": (
        "counter",
        "live-introspection HTTP requests answered by this process "
        "(/metrics, /debug/telemetry, /healthz on the --live-port "
        "sidecar or the serve front)",
    ),
    "trace.request": (
        "span",
        "one sampled request's admission-to-response wall at the HTTP "
        "front (args: trace_id, route, class, status) — the root of the "
        "per-request waterfall",
    ),
    "trace.sampled": (
        "counter",
        "requests granted detailed per-request tracing by the "
        "--trace-sample rate (deterministic on trace_id)",
    ),
    "trace.export_errors": (
        "counter",
        "slowest-request exemplar (requests.json) writes that failed "
        "(unwritable dir, injected trace.export fault) — absorbed; the "
        "last-good exemplar file stays readable (tmp+rename)",
    ),
    "trace.exemplars": (
        "gauge",
        "occupancy of the slowest-K request exemplar ring keyed by "
        "trace_id (GET /debug/requests serves it; bounded at "
        "TRACE_EXEMPLARS)",
    ),
    "serve.assemble": (
        "span",
        "one micro-batch assembly in the projection server: dequeue sweep "
        "(fault site, cancellation, deadline expiry) + stack of the live "
        "queries",
    ),
    "serve.device_step": (
        "span",
        "one padded micro-batch through the device: cross-stat "
        "accumulation against the staged reference blocks + per-row "
        "finalize",
    ),
    "serve.drain": (
        "span",
        "graceful server drain: admission closed, wall-clock until every "
        "in-flight request resolved and the worker joined",
    ),
    "serve.requests": (
        "counter",
        "requests admitted into the projection server's bounded queue "
        "(cache hits answered at submit are counted separately)",
    ),
    "serve.shed": (
        "counter",
        "requests rejected with ServerOverloaded at admission — the "
        "bounded queue was full (explicit load-shedding, not latency)",
    ),
    "serve.cache_hits": (
        "counter",
        "requests answered from the LRU result cache by genotype digest "
        "(no queue, no device work)",
    ),
    "serve.cache_misses": (
        "counter", "requests that missed the result cache"),
    "serve.deadline_expired": (
        "counter",
        "admitted requests dropped at batch assembly because their "
        "deadline had already passed (answered with DeadlineExceeded)",
    ),
    "serve.cancelled": (
        "counter",
        "admitted requests cancelled by the client before batch pickup",
    ),
    "serve.errors": (
        "counter",
        "admitted requests answered with a processing error (including "
        "injected serve.request faults)",
    ),
    "serve.worker_restarts": (
        "counter",
        "projection-server batching-worker recoveries: an unexpected "
        "worker-loop failure or thread death was caught and the worker "
        "restarted WITHOUT dropping admitted requests (health degrades "
        "for the cooloff window)",
    ),
    "serve.breaker_open": (
        "counter",
        "store-read circuit-breaker trips in the serve panel path: "
        "repeated staging failures opened the breaker and the server "
        "entered cached-panel-only mode (still serving, degraded)",
    ),
    "serve.drain_abandoned": (
        "counter",
        "admitted requests still queued when the SIGTERM drain budget "
        "(--drain-timeout-s) expired — failed loudly with ServerClosed, "
        "never dropped",
    ),
    "serve.in_flight": (
        "gauge",
        "admitted-but-unanswered requests in the projection server "
        "(queued + in the current batch); max is the realized backlog",
    ),
    "serve.health": (
        "gauge",
        "the serving health state machine as a number (0 healthy, "
        "1 degraded, 2 draining) — published on every transition; "
        "/healthz reports the same state as a string",
    ),
    "serve.enqueue_wait_s": (
        "histogram",
        "per admitted request: wall-clock from admission to batch pickup "
        "(large => the device step or linger window is the bottleneck)",
    ),
    "serve.latency_s": (
        "histogram",
        "per served request: submit to completed result, cache hits "
        "included — the client-visible latency whose p50/p99 the loadgen "
        "reports",
    ),
    "serve.batch_rows": (
        "histogram",
        "live (non-padding) queries per executed micro-batch: mean near "
        "max_batch means coalescing is working; 1 means linger is too "
        "short for the offered load",
    ),
    # -- supervision and fleet serving ---------------------------------
    "supervisor.restarts": (
        "counter",
        "supervised-child restarts (crash, injected kill, or watchdog "
        "hang/stall kill) — each resumes from the latest verified "
        "checkpoint; a clean supervised run counts 0",
    ),
    "supervisor.stalls": (
        "counter",
        "watchdog interventions: heartbeats stopped arriving or "
        "arrived with frozen progress past the stall budget, and the "
        "child was killed for restart",
    ),
    "supervisor.heartbeats": (
        "counter",
        "heartbeat files written by this supervised child (the "
        "liveness/progress signal core/supervisor.py's watchdog reads)",
    ),
    "live.proxy_requests": (
        "counter",
        "scrapes answered by a supervisor parent's live proxy on "
        "behalf of its supervised child (the endpoint that stays up "
        "across child restarts)",
    ),
    "live.proxy_stale": (
        "counter",
        "proxy answers served from the last-good cached child "
        "snapshot because the child was down (mid-restart) or "
        "unreachable — the scrape succeeds, marked stale, instead of "
        "erroring during the exact window an operator most wants data",
    ),
    "fleet.stage": (
        "span",
        "one reference panel staged (or re-staged after an LRU "
        "eviction) into the fleet serving warm pool through the store "
        "read path (serve/pool.py) — the cold-start cost the pool's "
        "budget trades against panel residency",
    ),
    "fleet.restage_total": (
        "counter",
        "panel stages of a route that had been staged before and was "
        "LRU-evicted from the warm pool — each is a cold start paid to "
        "the HBM budget (a climbing rate under steady traffic means "
        "the budget is too small for the working set)",
    ),
    "fleet.evictions": (
        "counter",
        "panels LRU-evicted from the fleet warm pool to fit a newly "
        "staged route under the configured budget (the panel re-stages "
        "on demand through the store — nothing is lost, only warmth)",
    ),
    "fleet.shard_stages": (
        "counter",
        "shards staged while serving a panel that exceeds the pool "
        "budget (serve/router.py _sharded_blocks): each is one "
        "budget-sized slice of the panel streamed from the store, "
        "charged transiently against the pool, and dropped after its "
        "blocks are consumed — the request count times the shard "
        "count, since over-budget panels cannot be kept warm",
    ),
    "fleet.cache_namespace_evictions": (
        "counter",
        "result-cache entries reclaimed because their route was "
        "unloaded (the cache is namespaced by model fingerprint; an "
        "unloaded route's namespace is evicted whole, so cache bytes "
        "stay flat across load/unload cycles)",
    ),
    "fleet.hedge_launched": (
        "counter",
        "hedge requests the loadgen client sent to a second replica "
        "after the p95-derived hedge delay passed without a primary "
        "answer (serve/loadgen.py run_hedged_loadgen)",
    ),
    "fleet.hedge_wins": (
        "counter",
        "hedged requests whose SECOND replica answered first (the "
        "primary was the straggler; the loser future is cancelled) — "
        "hedge_wins / hedge_launched is the tail-latency relief rate",
    ),
    "fleet.failovers": (
        "counter",
        "hedged-client re-admissions after a replica loss: a request "
        "refused or failed with ServerClosed (kill, preemption, drain) "
        "is re-sent to the hedge partner instead of erroring — the "
        "zero-lost-admitted-requests contract exercised (latency paid, "
        "answer kept)",
    ),
    "fleet.routes": (
        "gauge",
        "routes currently loaded in the fleet server (each = one "
        "(model, panel) pair addressable by name)",
    ),
    "fleet.pool_bytes": (
        "gauge",
        "staged panel bytes resident in the fleet warm pool (dense "
        "device-resident blocks); bounded by the configured "
        "--fleet-budget-mb via LRU eviction",
    ),
    "fleet.pool_pressure": (
        "gauge",
        "resident / budget of the fleet warm pool (1.0 = at budget; "
        "sustained ~1.0 with climbing fleet.restage_total means the "
        "working set does not fit and cold starts are being paid)",
    ),
    "fleet.panel_over_budget_x": (
        "gauge",
        "panel bytes / pool budget of the last shard-staged route "
        "served (>1.0 by construction): how many budgets' worth of "
        "panel each request streams through — ceil of it is the shard "
        "count per request; raise --fleet-budget-mb above it to serve "
        "the route warm instead",
    ),
    "fleet.route.*": (
        "gauge",
        "per-route autoscale signals, one gauge per "
        "fleet.route.<name>.<signal>: queue_depth (admitted waiting), "
        "p99_s (served latency), shed_rate (shed / offered), staged "
        "(1 = panel warm in the pool) — the series an autoscaler "
        "scales replica counts on (GET /metrics)",
    ),
    "serve.priority.preemptions": (
        "counter",
        "dequeues where an interactive request jumped ahead of an "
        "older batch-class request waiting in admission — the priority "
        "contract (interactive before batch) actually exercised",
    ),
    "serve.priority.shed_interactive": (
        "counter",
        "interactive-class requests shed at admission (the "
        "--queue-interactive threshold; nonzero means even the "
        "protected class is past capacity — scale out)",
    ),
    "serve.priority.shed_batch": (
        "counter",
        "batch-class requests shed at admission (the --queue-batch "
        "threshold) — expected first under overload, while the "
        "interactive class keeps admitting",
    ),
    "serve.priority.depth_interactive": (
        "gauge",
        "interactive-class admission queue depth (published at every "
        "put/take; pinned at the --queue-interactive bound means the "
        "protected class itself is saturated)",
    ),
    "serve.priority.depth_batch": (
        "gauge",
        "batch-class admission queue depth — deep-and-draining is the "
        "designed steady state under mixed load (backfill absorbs the "
        "slack the interactive class leaves)",
    ),
    "trace.queue": (
        "span",
        "one sampled request's admission-to-batch-pickup wait inside "
        "the router (args: trace_id, route, class) — the per-request "
        "leg of serve.enqueue_wait_s, placed on the waterfall",
    ),
    "trace.compute": (
        "span",
        "the device-step wall attributed to one sampled request of the "
        "executed micro-batch (args: trace_id, rows, cold_start, "
        "stage_s — stage_s > 0 is the cold-start cost this request "
        "paid waiting on a panel re-stage)",
    ),
    "trace.hedge": (
        "event",
        "hedge resolution for a traced request: both legs share one "
        "trace_id with distinct span ids; args record the winning leg "
        "(primary/hedge) and whether the loser was cancelled",
    ),
    "neighbors.requests": (
        "counter",
        "top-k neighbor requests answered by the serving layer (the "
        "/neighbors endpoint and the in-process fleet.topk path)",
    ),
    "controller.step": (
        "span",
        "one fleet-controller control round (fleet/controller.py): "
        "watch every replica slot (crash/hang/stale-scrape "
        "classification), run the autoscale rules, publish gauges, and "
        "rewrite the atomic controller.json incident ledger",
    ),
    "controller.spawn": (
        "span",
        "one replica spawned by the fleet controller (bootstrap, "
        "respawn after a loss, scale-up, or preemption respawn) "
        "including its warm-set staging — the time-to-ready cost the "
        "scale-up bench measures (args: slot, reason)",
    ),
    "controller.scrapes": (
        "counter",
        "successful replica /metrics (or in-process stats) scrapes by "
        "the fleet controller — the denominator against "
        "controller.scrape_stale for scrape-path health",
    ),
    "controller.scrape_stale": (
        "counter",
        "controller scrape attempts that failed (blackholed endpoint, "
        "parse error, injected controller.scrape fault): the slot "
        "keeps acting on its last-good snapshot marked stale until "
        "stale_scrapes consecutive failures declare the replica lost",
    ),
    "controller.respawns": (
        "counter",
        "replicas respawned by the controller after a loss (crash/"
        "hang/stale) or preemption — each lands after the slot's "
        "bounded exponential backoff, and too many inside the flap "
        "window park the slot instead",
    ),
    "controller.scale_ups": (
        "counter",
        "replicas added by the autoscale rule: sustained interactive "
        "queue depth per ready replica (or worst-route p99) over "
        "pressure_rounds consecutive control rounds",
    ),
    "controller.retires": (
        "counter",
        "replicas retired by the autoscale rule after idle_rounds "
        "consecutive all-idle rounds — SIGTERM drain within "
        "--drain-timeout-s, hedging covers the window",
    ),
    "controller.preemptions": (
        "counter",
        "graceful preemptions handled (preempt(): drain within budget "
        "+ immediate respawn, no backoff — the platform's fault, not "
        "the replica's)",
    ),
    "controller.incidents": (
        "counter",
        "incidents appended to the controller's atomic controller.json "
        "ledger (crash/hang/stale losses, spawn failures, flap-breaker "
        "trips, dirty drains, placement overflow)",
    ),
    "controller.ledger_rotations": (
        "counter",
        "full-ledger generations rotated to controller.json.old "
        "(atomic tmp+rename) before the bounded incident/decision "
        "deques started dropping their oldest entries — history is "
        "archived, never silently discarded",
    ),
    "controller.replicas": (
        "gauge",
        "replica slots currently up under the fleet controller "
        "(spawned and not lost/retired/parked) — the autoscale loop's "
        "actuated value, between min_replicas and max_replicas",
    ),
    "controller.ready": (
        "gauge",
        "up replicas whose latest fresh scrape reported ready (worker "
        "alive, not draining, warm set staged — the /readyz rule); "
        "ready < replicas marks a warmup or degradation window",
    ),
    "controller.flap_breaker_open": (
        "gauge",
        "replica slots parked by the flap breaker (more than "
        "flap_max_respawns respawns inside flap_window_s): a crash-"
        "looping slot stops burning spawns until an operator "
        "reset_flap_breaker() — nonzero demands attention",
    ),
    "timeline.rounds": (
        "counter",
        "control rounds persisted into the fleet timeline ring "
        "(fleet/timeline.py timeline.jsonl — one line per scrape round "
        "with every slot's ReplicaSnapshot folded in)",
    ),
    "timeline.markers": (
        "counter",
        "replica lifecycle incidents (crash/respawn/preempt/park/"
        "scale) aligned onto the fleet timeline as markers",
    ),
    "timeline.compactions": (
        "counter",
        "timeline ring compactions: the append-only timeline.jsonl hit "
        "its size bound and was atomically rewritten (tmp+rename) with "
        "only the newest rounds kept",
    ),
    "timeline.write_errors": (
        "counter",
        "timeline appends/compactions that failed (full disk, injected "
        "trace.export fault) — absorbed, the controller keeps stepping "
        "and the last-good timeline stays readable",
    ),
    "timeline.bytes": (
        "gauge",
        "current byte size of the fleet timeline ring file (bounded by "
        "max_bytes via compaction)",
    ),
    "timeline.fleet_p99_s": (
        "gauge",
        "fleet-wide served p99 folded across every fresh replica "
        "snapshot this round (Histogram.merge over per-slot series; "
        "served as fleet_timeline_fleet_p99_s on GET /fleet/metrics)",
    ),
    "timeline.fleet_queue_depth": (
        "gauge",
        "fleet-wide interactive+batch admission queue depth summed "
        "across every fresh replica snapshot this round",
    ),
    "timeline.fleet_shed_rate": (
        "gauge",
        "worst per-replica shed rate across the fleet this round (the "
        "load-shedding hot spot, not the average)",
    ),
    "timeline.route.*": (
        "gauge",
        "cross-replica folded per-route series, one gauge per "
        "timeline.route.<name>.<signal>: p99_s (max across replicas), "
        "queue_depth (sum), staged (replicas holding the panel warm) — "
        "the fleet-wide view GET /fleet/metrics serves",
    ),
    "slo.breaches": (
        "counter",
        "SLO burn-rate breaches recorded by the controller's evaluator "
        "(fast AND slow windows both burning): each lands as a ledger "
        "incident and registers scale-up pressure in the same round",
    ),
    "slo.ok": (
        "gauge",
        "1 while no declared SLO is breaching, 0 while any objective's "
        "fast+slow burn windows are both over budget",
    ),
    "slo.*": (
        "gauge",
        "per-objective burn-rate gauges, one per "
        "slo.<route>.<class>.<window>: fast_burn / slow_burn (observed "
        "violation fraction over the window divided by the objective's "
        "error budget; >= 1.0 means the budget is burning at alert "
        "rate) and breach (1 while both windows burn)",
    ),
}

# Names only the port has: what a hand-written CUDA kernel's wrapper
# counts where it launches, so a job run as a subprocess exports its
# kernels' launches in metrics.json. Kept apart from NAMES, which holds
# the JAX package's names only.
PORT_NAMES: dict[str, tuple[str, str]] = {
    "kernel.packed_gram.launches": (
        "counter",
        "launches of the packed CUDA kernel (csrc/packed_gram.cu), "
        "counted where its wrapper launches it (ops/packed_gram.py): one "
        "a block on one device, one per tile a block under a tile2d "
        "gather plan, one per slot a block under a variant plan, D per "
        "tile a block under the ring transport",
    ),
    "multihost.backend": (
        "gauge",
        "the collective backend of a job of several processes, chosen up "
        "front by rule (core/meshes.py::backend_rule): 0 gloo (--device "
        "cpu), 1 gloo with device tensors staged through the host (ranks "
        "sharing a card), 2 nccl (a card per rank)",
    ),
}

_FAMILIES = tuple(n[:-1] for n in NAMES if n.endswith(".*"))  # "phase."

KINDS = ("span", "event", "counter", "gauge", "histogram")

# Trace events buffered for export (a counter takes the overflow).
MAX_EVENTS = 500_000
# Events kept for :func:`events` (oldest dropped first).
EVENT_RING = 4096
# The rolling ring the live surfaces expose.
RECENT_EVENTS = 256
# Slowest-K request exemplar ring size.
TRACE_EXEMPLARS = 32

HIST_LO = 1e-9
HIST_GROWTH = 2.0 ** 0.125
_HIST_BUCKETS = 1 + 8 * 47 + 1  # underflow + 47 octaves + overflow
_LOG_G = math.log(HIST_GROWTH)

# Job identity: a run id shared by every attempt of one job and the
# attempt ordinal, pinned through the environment by a supervising
# parent (the JAX package's variable names, so either package's parent
# arms the other's child).
ENV_RUN_ID = "SPARK_EXAMPLES_TPU_RUN_ID"
ENV_ATTEMPT = "SPARK_EXAMPLES_TPU_ATTEMPT"
ENV_TRACE_SAMPLE = "SPARK_EXAMPLES_TPU_TRACE_SAMPLE"


def is_declared(name: str) -> bool:
    """True when ``name`` is in the registry (exact or family match)."""
    return name in NAMES or name in PORT_NAMES or name.startswith(_FAMILIES)


class Histogram:
    """Fixed log-bucket streaming histogram; quantiles clamp into
    [min, max], so a constant histogram reports them exactly."""

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets = [0] * _HIST_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        if v <= HIST_LO:
            i = 0
        else:
            i = min(1 + int(math.log(v / HIST_LO) / _LOG_G), _HIST_BUCKETS - 1)
        self.buckets[i] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this histogram (same bucket grid)."""
        if other.count:
            for i, n in enumerate(other.buckets):
                self.buckets[i] += n
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self

    @staticmethod
    def _bounds(i: int) -> tuple[float, float]:
        if i == 0:
            return 0.0, HIST_LO
        return HIST_LO * HIST_GROWTH ** (i - 1), HIST_LO * HIST_GROWTH ** i

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 1]) read off the bucket grid."""
        if self.count == 0:
            return 0.0
        target = max(q * self.count, 1e-12)
        seen = 0
        for i, n in enumerate(self.buckets):
            if not n:
                continue
            seen += n
            if seen >= target:
                lo, hi = self._bounds(i)
                mid = math.sqrt(lo * hi) if lo > 0 else hi / 2.0
                return min(max(mid, self.min), self.max)
        return self.max

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


# Process-wide state under one lock: sites record from the main thread,
# the feed's producer, readahead workers, the serving worker and HTTP
# handler threads. Reentrant, because the SIGTERM crash flush runs
# export() on the main thread at any bytecode boundary, possibly inside
# a `with _lock:` of a count().
_lock = threading.RLock()
_T0 = time.perf_counter()  # trace timestamp epoch
_START_UNIX = time.time()

_counters: dict[str, float] = {}
_gauges: dict[str, dict] = {}
_hists: dict[str, Histogram] = {}
_warned_names: set[str] = set()
_ring: deque = deque(maxlen=EVENT_RING)  # :func:`events`
_events: list[dict] = []  # trace events, while tracing is configured
_exemplars: list[tuple[float, int, dict]] = []  # min-heap on total_s
_exemplar_seq = 0

_dir: str | None = None
_trace = False
_flusher: "PeriodicFlusher | None" = None
_run_id: str | None = None


def _env_trace_sample() -> float:
    try:
        v = float(os.environ.get(ENV_TRACE_SAMPLE, "") or 1.0)
    except ValueError:
        return 1.0
    return min(max(v, 0.0), 1.0)


_trace_sample = _env_trace_sample()


def run_id() -> str:
    """The stable job id stamped into exported events and metrics: the
    environment's when a parent pinned one, else a fresh token (minted
    once, under the lock)."""
    global _run_id
    with _lock:
        if _run_id is None:
            _run_id = (os.environ.get(ENV_RUN_ID, "").strip()
                       or uuid.uuid4().hex[:12])
        return _run_id


def attempt() -> int:
    """This process's attempt ordinal (0 unsupervised / first child)."""
    try:
        return int(os.environ.get(ENV_ATTEMPT, "0") or 0)
    except ValueError:
        return 0


def identity() -> dict:
    """{run_id, attempt, rank}: the stitch keys, in one place."""
    rank, _ = _rank()
    return {"run_id": run_id(), "attempt": attempt(), "rank": rank}


def _check_name(name: str) -> None:
    if is_declared(name):
        return
    with _lock:
        _counters["telemetry.unknown_names"] = (
            _counters.get("telemetry.unknown_names", 0.0) + 1.0)
        if name in _warned_names:
            return
        _warned_names.add(name)
    warnings.warn(
        f"telemetry name {name!r} is not declared in telemetry.NAMES "
        "or PORT_NAMES — "
        "declare it (the registry keeps metric names from forking on "
        "typos)",
        RuntimeWarning,
        stacklevel=3,
    )


def configure(dir: str | None = None, trace_events: bool = True,
              flush_s: float = 0.0,
              trace_sample: float | None = None) -> None:
    """Set where :func:`export` writes and whether spans buffer trace
    events (``trace_events=False`` keeps ``metrics.json`` and writes an
    events-free ``trace.jsonl``). ``flush_s > 0`` starts the
    :class:`PeriodicFlusher`. A directory also installs the crash flush
    (an ``atexit`` hook and, from the main thread over the default
    disposition, a SIGTERM handler that exports, then re-delivers the
    signal). ``dir=None`` turns export and event buffering off."""
    global _dir, _trace
    with _lock:
        _dir = dir
        _trace = bool(trace_events) and dir is not None
    if trace_sample is not None:
        set_trace_sample(trace_sample)
        os.environ[ENV_TRACE_SAMPLE] = repr(_trace_sample)
    if dir is not None:
        _install_crash_flush()
    if flush_s and flush_s > 0 and dir is not None:
        start_periodic_flush(flush_s, dir=dir)
    else:
        stop_periodic_flush()


_atexit_installed = False
_sigterm_installed = False


def _crash_flush() -> None:
    """Export for an abnormal exit: never raises, never prints."""
    try:
        export()
    except BaseException:
        pass


def _install_crash_flush() -> None:
    # Two latches: signal handlers can only be set from the main thread,
    # so a configure() from a worker thread installs only the atexit half.
    global _atexit_installed, _sigterm_installed
    if not _atexit_installed:
        _atexit_installed = True
        import atexit

        atexit.register(_crash_flush)
    if _sigterm_installed:
        return
    try:
        import signal

        if threading.current_thread() is not threading.main_thread():
            return
        _sigterm_installed = True
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            _crash_flush()
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        # Only over the default disposition: a handler installed first
        # (or later, as serve's drain) keeps its meaning.
        if prev in (signal.SIG_DFL, None):
            signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass


def reset() -> None:
    """Zero every counter, gauge and histogram and drop the buffered
    events and exemplars (the configuration survives)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _warned_names.clear()
        _ring.clear()
        _events.clear()
        _exemplars.clear()


def count(name: str, n: float = 1.0) -> float:
    """Add ``n`` to counter ``name``; returns the new total."""
    _check_name(name)
    with _lock:
        total = _counters.get(name, 0.0) + n
        _counters[name] = total
    return total


def counter_value(name: str) -> float:
    with _lock:
        return _counters.get(name, 0.0)


def histogram_sum(name: str) -> float:
    """Sum of every value observed into histogram ``name`` (0.0 when
    never observed)."""
    with _lock:
        h = _hists.get(name)
        return h.sum if h is not None else 0.0


def gauge_set(name: str, value: float) -> None:
    _check_name(name)
    v = float(value)
    with _lock:
        g = _gauges.get(name)
        if g is None:
            _gauges[name] = {"last": v, "min": v, "max": v, "n": 1}
        else:
            g["last"] = v
            g["n"] += 1
            g["min"] = min(g["min"], v)
            g["max"] = max(g["max"], v)


def _record(name: str, value: float) -> None:
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram()
        h.record(value)


def observe(name: str, value: float) -> None:
    """Record ``value`` into histogram ``name``."""
    _check_name(name)
    _record(name, value)


def _append_event(ev: dict) -> None:
    with _lock:
        if len(_events) >= MAX_EVENTS:
            _counters["telemetry.dropped_events"] = (
                _counters.get("telemetry.dropped_events", 0.0) + 1.0)
            return
        _events.append(ev)


def event(name: str, cat: str = "misc", **attrs) -> None:
    """Record an instant event ``name`` with its attributes: always into
    the in-process ring, and onto the trace timeline (a thread-scoped
    ``ph: "i"`` event, the ambient request ids stamped in) while tracing
    is configured."""
    _check_name(name)
    now = time.perf_counter()
    with _lock:
        _ring.append({"name": name, "cat": cat, "t": now,
                      "args": dict(attrs)})
    if not _trace:
        return
    ctx = _TRACE_CTX.get()
    if ctx is not None:
        attrs = {**ctx, **attrs}
    _append_event({"name": name, "cat": cat, "ph": "i", "s": "t",
                   "ts": (now - _T0) * 1e6, "tid": threading.get_ident(),
                   "args": attrs})


def events(name: str | None = None) -> list[dict]:
    """The recorded events (of ``name`` only, when given), oldest
    first."""
    with _lock:
        return [dict(e) for e in _ring if name is None or e["name"] == name]


# -- request trace context ---------------------------------------------------
# A trace id is minted at HTTP admission (or taken from X-Trace-Id) and
# rides a contextvar, so spans and events opened under trace_scope carry
# it. Sampling is deterministic on the id.

_TRACE_CTX: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "spark_examples_tpu_torch_trace_ctx", default=None)


def new_trace_id() -> str:
    """A fresh 16-hex request id."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """A fresh 8-hex span id."""
    return uuid.uuid4().hex[:8]


def current_trace() -> dict | None:
    """The ambient {trace_id, span_id} of this task, or None."""
    return _TRACE_CTX.get()


@contextmanager
def trace_scope(trace_id: str | None = None, span_id: str | None = None):
    """Bind a request trace context for the block; yields it."""
    ctx = {"trace_id": trace_id or new_trace_id(),
           "span_id": span_id or new_span_id()}
    token = _TRACE_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _TRACE_CTX.reset(token)


def set_trace_sample(rate: float) -> None:
    """Set the process-wide request-tracing sample rate, clamped to
    [0, 1] (``--trace-sample``)."""
    global _trace_sample
    _trace_sample = min(max(float(rate), 0.0), 1.0)


def trace_sample() -> float:
    return _trace_sample


def should_sample(trace_id: str) -> bool:
    """Deterministic per-request sampling: crc32(trace_id) against the
    rate, so every thread and process that sees one id agrees."""
    rate = _trace_sample
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) < rate * 2**32


def record_request_exemplar(trace_id: str, total_s: float,
                            phases: dict, **attrs) -> None:
    """Keep this request in the slowest-K exemplar ring if it is slow
    enough (a min-heap on total latency)."""
    global _exemplar_seq
    rec = {"trace_id": trace_id, "total_s": total_s,
           "phases": dict(phases), "t_unix": time.time(), **attrs}
    with _lock:
        _exemplar_seq += 1
        if len(_exemplars) < TRACE_EXEMPLARS:
            heapq.heappush(_exemplars, (total_s, _exemplar_seq, rec))
        elif total_s > _exemplars[0][0]:
            heapq.heapreplace(_exemplars, (total_s, _exemplar_seq, rec))
        else:
            return
        n = len(_exemplars)
    gauge_set("trace.exemplars", float(n))


def request_exemplars() -> list[dict]:
    """The exemplar ring, slowest first."""
    with _lock:
        items = sorted(_exemplars, key=lambda e: (-e[0], e[1]))
    return [dict(rec) for _t, _s, rec in items]


# -- spans ---------------------------------------------------------------------


def _span_event(name, cat, t0, dur, tid, attrs) -> None:
    _append_event({"name": name, "cat": cat, "ph": "X",
                   "ts": (t0 - _T0) * 1e6, "dur": dur * 1e6, "tid": tid,
                   "args": attrs})


def span_at(name: str, t0: float, dur: float, cat: str = "trace",
            tid: int | None = None, **attrs) -> None:
    """Record an already-measured interval (``perf_counter`` start and
    seconds) as a completed span."""
    _check_name(name)
    _record(name, dur)
    if _trace:
        _span_event(name, cat, t0, dur,
                    threading.get_ident() if tid is None else tid, attrs)


class SpanHandle:
    """An open span: :meth:`end` records it (histogram + trace event),
    :meth:`cancel` drops it. Loop bodies use handles to time a whole
    block period, producer wait included."""

    __slots__ = ("name", "cat", "t0", "tid", "trace", "_open")

    def __init__(self, name: str, cat: str):
        self.name = name
        self.cat = cat
        self.t0 = time.perf_counter()
        self.tid = threading.get_ident()
        # Captured at open: the span may end on another thread.
        self.trace = _TRACE_CTX.get()
        self._open = True

    def end(self, **attrs) -> float:
        if not self._open:
            return 0.0
        self._open = False
        dur = time.perf_counter() - self.t0
        _record(self.name, dur)
        if _trace:
            if self.trace is not None:
                attrs = {**self.trace, **attrs}
            _span_event(self.name, self.cat, self.t0, dur, self.tid, attrs)
        return dur

    def cancel(self) -> None:
        self._open = False


def begin(name: str, cat: str = "misc") -> SpanHandle:
    _check_name(name)
    return SpanHandle(name, cat)


@contextmanager
def span(name: str, cat: str = "misc", **attrs):
    """``with telemetry.span("store.heal"):`` times the block into the
    histogram ``name`` (seconds) and, while tracing, the timeline."""
    sp = begin(name, cat)
    try:
        yield sp
    finally:
        sp.end(**attrs)


def traced(name: str, cat: str = "misc"):
    """Decorator form of :func:`span` for whole-function spans."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, cat=cat):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# -- derived metrics: the one formula --------------------------------------


def effective_gram_time(phases: dict) -> float:
    """The gram phase minus the streaming refreshes dispatched inside
    it (``stream_refresh``): the denominator every throughput and stall
    fraction shares."""
    return max(phases.get("gram", 0.0) - phases.get("stream_refresh", 0.0),
               0.0)


def stall_fraction(phases: dict, get_wait_sum: float) -> float:
    """Share of the effective gram phase the consumer waited on the
    feed's producer."""
    gram_t = effective_gram_time(phases)
    return get_wait_sum / gram_t if gram_t else 0.0


def derive_throughputs(phases: dict, counters: dict) -> dict:
    """Derived throughput metrics where the raw counters exist."""
    rep: dict[str, float] = {}
    gram_t = effective_gram_time(phases)
    if "gram_flops" in counters and gram_t:
        rep["gram_gflops_per_s"] = counters["gram_flops"] / gram_t / 1e9
    # Bytes are shipped inside an "ingest" phase where one exists, else
    # inside the gram loop.
    stream_t = phases.get("ingest") or gram_t
    if "ingest_bytes" in counters and stream_t:
        rep["ingest_mb_per_s"] = counters["ingest_bytes"] / stream_t / 1e6
    if "eigh_flops" in counters and phases.get("eigh"):
        rep["eigh_gflops_per_s"] = counters["eigh_flops"] / phases["eigh"] / 1e9
    return rep


def _split_counters() -> tuple[dict, dict]:
    """(phases, plain counters) from the registry."""
    with _lock:
        counters = dict(_counters)
    phases = {k[len("phase."):]: v for k, v in counters.items()
              if k.startswith("phase.")}
    plain = {k: v for k, v in counters.items() if not k.startswith("phase.")}
    return phases, plain


def digest() -> dict:
    """The compact headline: block-time p50/p95, the feed's stall
    fraction, retries, the consensus wait's p95."""
    phases, counters = _split_counters()
    with _lock:
        block = _hists.get("gram.block")
        stall = _hists.get("prefetch.get_wait_s")
        consensus = _hists.get("multihost.consensus")
        block = block.summary() if block else {"count": 0}
        stall_sum = stall.sum if stall else 0.0
        consensus_p95 = consensus.quantile(0.95) if consensus else 0.0
    return {
        "block_p50_s": round(block.get("p50", 0.0), 6),
        "block_p95_s": round(block.get("p95", 0.0), 6),
        "blocks": block.get("count", 0),
        "prefetch_stall_frac": round(stall_fraction(phases, stall_sum), 4),
        "ingest_retries": int(counters.get("ingest.retries", 0.0)),
        "consensus_wait_p95_s": round(consensus_p95, 6),
    }


def _rank() -> tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1). torch is not imported for the question."""
    dist_mod = sys.modules.get("torch.distributed")
    if dist_mod is None:
        return 0, 1
    try:
        if dist_mod.is_available() and dist_mod.is_initialized():
            return dist_mod.get_rank(), dist_mod.get_world_size()
    except (RuntimeError, ValueError):
        pass
    return 0, 1


def metrics_snapshot() -> dict:
    """The metrics.json payload: counters, phases, gauges, histogram
    summaries and the derived throughputs, copied."""
    phases, counters = _split_counters()
    with _lock:
        gauges = {k: dict(v) for k, v in _gauges.items()}
        hists = {k: h.summary() for k, h in _hists.items()}
    return {
        "counters": counters,
        "phases": phases,
        "gauges": gauges,
        "histograms": hists,
        "derived": derive_throughputs(phases, counters),
    }


def recent_events(n: int = RECENT_EVENTS) -> list[dict]:
    """The newest ``n`` buffered trace events, the flusher's own
    ``live.flush`` spans left out (a quiet stretch would otherwise fill
    the ring with them)."""
    if n <= 0:
        return []
    out: list[dict] = []
    with _lock:
        for ev in reversed(_events):
            if ev.get("name") == "live.flush":
                continue
            out.append(dict(ev))
            if len(out) >= n:
                break
    out.reverse()
    return out


def live_snapshot(recent: int = RECENT_EVENTS) -> dict:
    """The in-flight payload ``/debug/telemetry`` serves: the metrics
    snapshot, the recent trace events and the job's identity."""
    snap = metrics_snapshot()
    snap["recent_events"] = recent_events(recent)
    snap["meta"] = _meta(len(snap["recent_events"]))
    return snap


def _meta(events_n: int) -> dict:
    rank, n_proc = _rank()
    now_unix, now_perf = time.time(), time.perf_counter()
    return {
        "rank": rank,
        "process_count": n_proc,
        "run_id": run_id(),
        "attempt": attempt(),
        "trace_events": events_n,
        "wrote_unix_s": now_unix,
        # Wall clock at trace ts=0: places this process's events on one
        # timeline with other processes'.
        "epoch_unix_s": now_unix - (now_perf - _T0),
        "uptime_s": now_perf - _T0,
    }


def _atomic_write(path: str, text: str) -> None:
    """tmp + rename: a reader, or a kill mid-write, sees the previous
    complete file or the new one, never a torn one."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _atomic_write_lines(path: str, lines) -> None:
    """Same atomicity, streamed line by line (no joined copy)."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        for line in lines:
            f.write(line)
            f.write("\n")
    os.replace(tmp, path)


def _rank_dir(base: str) -> str:
    """``<base>/rank<r>``, or ``<base>/attempt<a>/rank<r>`` when a parent
    pinned an attempt ordinal."""
    rank, _ = _rank()
    if os.environ.get(ENV_ATTEMPT, "").strip():
        return os.path.join(base, f"attempt{attempt()}", f"rank{rank}")
    return os.path.join(base, f"rank{rank}")


def _export_exemplars(d: str) -> None:
    """``requests.json``: the slowest-K exemplar ring, written
    atomically; a failed write (the ``trace.export`` fault site fires
    here) counts ``trace.export_errors`` and leaves the last good file."""
    from spark_examples_tpu_torch.core import faults  # imports this module

    ex = request_exemplars()
    if not ex:
        return
    path = os.path.join(d, "requests.json")
    try:
        faults.fire("trace.export", path=path)
        _atomic_write(path, json.dumps(
            {"exemplars": ex, "trace_sample": _trace_sample,
             "meta": _meta(0)}, indent=1, sort_keys=True, default=str))
    except OSError:
        count("trace.export_errors")


class PeriodicFlusher:
    """Daemon thread republishing ``metrics.json`` and a rolling
    ``live_trace.jsonl`` every ``interval_s`` seconds, atomically. A
    failed flush warns once, counts ``live.flush_errors`` and the
    flusher carries on."""

    def __init__(self, base: str, interval_s: float):
        self.base = base
        self.interval_s = max(0.01, float(interval_s))
        self._stop = threading.Event()
        self._warned = False
        self._thread: threading.Thread | None = None

    def start(self) -> "PeriodicFlusher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="telemetry-flusher", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()
        self.flush()  # the tail, so stop() loses nothing

    def flush(self) -> None:
        from spark_examples_tpu_torch.core import faults  # imports this

        d = _rank_dir(self.base)
        try:
            with span("live.flush", cat="live"):
                os.makedirs(d, exist_ok=True)
                metrics_path = os.path.join(d, "metrics.json")
                faults.fire("telemetry.flush", path=metrics_path)
                snap = metrics_snapshot()
                snap["meta"] = _meta(len(_events))
                _atomic_write(metrics_path,
                              json.dumps(snap, indent=1, sort_keys=True,
                                         default=str))
                rank = snap["meta"]["rank"]
                _atomic_write_lines(
                    os.path.join(d, "live_trace.jsonl"),
                    (json.dumps({**ev, "pid": rank}, default=str)
                     for ev in recent_events()))
                _export_exemplars(d)
            count("live.flushes")
        except Exception as e:
            count("live.flush_errors")
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"periodic telemetry flush to {d!r} failed ({e!r}) — "
                    "the job continues; live snapshots may be stale "
                    "until writes recover",
                    RuntimeWarning, stacklevel=2,
                )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def start_periodic_flush(interval_s: float,
                         dir: str | None = None) -> PeriodicFlusher | None:
    """Start (or retarget) the module's flusher; None when no directory
    is configured."""
    global _flusher
    base = dir or _dir
    if not base:
        return None
    stop_periodic_flush()
    _flusher = PeriodicFlusher(base, interval_s).start()
    return _flusher


def stop_periodic_flush() -> None:
    """Stop the flusher (one final flush included)."""
    global _flusher
    f = _flusher
    _flusher = None
    if f is not None:
        f.stop()


def export(dir: str | None = None) -> str | None:
    """Write ``rank<k>/{trace.jsonl,metrics.json}`` (and
    ``requests.json``) under ``dir`` or the configured directory, plus
    ``summary.txt`` on rank 0. Returns this rank's directory, or None
    when nothing is configured or the write failed (it warns: telemetry
    never fails the job it describes)."""
    base = dir or _dir
    if not base:
        return None
    try:
        return _export(base)
    except OSError as e:
        warnings.warn(f"telemetry export to {base} failed: {e}",
                      RuntimeWarning, stacklevel=2)
        return None


def _export(base: str) -> str:
    rank, n_proc = _rank()
    d = _rank_dir(base)
    os.makedirs(d, exist_ok=True)
    rid, att = run_id(), attempt()
    with _lock:
        evs = sorted(_events, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    track = f"rank {rank}" if not att else f"attempt {att} rank {rank}"

    def _trace_lines():
        yield json.dumps({"name": "process_name", "ph": "M", "pid": rank,
                          "tid": 0, "ts": 0, "args": {"name": track}})
        for ev in evs:
            yield json.dumps(
                {**ev, "pid": rank,
                 "args": {**ev.get("args", {}), "run_id": rid,
                          "attempt": att}},
                default=str)

    _atomic_write_lines(os.path.join(d, "trace.jsonl"), _trace_lines())
    snap = metrics_snapshot()
    snap["meta"] = _meta(len(evs))
    _atomic_write(os.path.join(d, "metrics.json"),
                  json.dumps(snap, indent=1, sort_keys=True, default=str))
    _export_exemplars(d)
    if rank == 0:
        try:
            _write_summary(os.path.dirname(d), n_proc)
        except OSError as e:
            warnings.warn(f"telemetry summary not written: {e}",
                          RuntimeWarning, stacklevel=2)
    return d


def _write_summary(base: str, n_proc: int) -> None:
    """A per-rank table at ``base``: gram throughput, ingest rate, block
    p50/p95, stall fraction, retries, and the consensus wait's mean and
    p95 (a fast rank waits for a straggler there). Peer files older
    than this process are ignored as a previous run's."""
    rows = []
    stale = 0
    for rank in range(n_proc):
        try:
            with open(os.path.join(base, f"rank{rank}",
                                   "metrics.json")) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        if (rank != 0 and m.get("meta", {}).get("wrote_unix_s", 0.0)
                < _START_UNIX - 5.0):
            stale += 1
            continue
        hists = m.get("histograms", {})
        block = hists.get("gram.block", {})
        stall = hists.get("prefetch.get_wait_s", {})
        wait = hists.get("multihost.consensus", {})
        derived = m.get("derived", {})
        rows.append({
            "rank": rank,
            "gram_gflops": derived.get("gram_gflops_per_s", 0.0),
            "ingest_mb_s": derived.get("ingest_mb_per_s", 0.0),
            "block_p50_ms": block.get("p50", 0.0) * 1e3,
            "block_p95_ms": block.get("p95", 0.0) * 1e3,
            "stall_frac": stall_fraction(m.get("phases", {}),
                                         stall.get("sum", 0.0)),
            "retries": int(m.get("counters", {}).get("ingest.retries", 0)),
            "wait_mean_ms": wait.get("mean", 0.0) * 1e3,
            "wait_p95_ms": wait.get("p95", 0.0) * 1e3,
        })
    cols = ("rank", "gram_gflops", "ingest_mb_s", "block_p50_ms",
            "block_p95_ms", "stall_frac", "retries", "wait_mean_ms",
            "wait_p95_ms")
    lines = ["\t".join(cols)]
    for r in rows:
        lines.append("\t".join(
            str(r[c]) if c in ("rank", "retries")
            else f"{r[c]:.3f}" if c == "stall_frac"
            else f"{r[c]:.2f}"
            for c in cols
        ))
    if len(rows) < n_proc:
        note = (f"note: {n_proc - len(rows)} rank(s) had not exported "
                "when rank 0 wrote this summary")
        if stale:
            note += (f" ({stale} stale file(s) from a previous run in "
                     "this directory were ignored)")
        lines.append(note)
    with open(os.path.join(base, "summary.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
