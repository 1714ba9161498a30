"""In-process metrics registry: counters, gauges, histograms and spans.

The dataset store, the retrying ingest and the fault harness count what
they do here: chunks verified, cache hits, retries absorbed, heals,
readahead depth. Every name an instrumentation site uses must be
declared in :data:`NAMES`; an undeclared name warns once and counts into
``telemetry.unknown_names`` instead of raising mid-job.

- **Counters** are monotonic float sums, **gauges** keep last/min/max,
  and **histograms** are streaming log-bucket histograms (2^(1/8) per
  bucket, no sample retention) with exact count/sum/min/max.
- **Spans** (:func:`span`, :func:`traced`) time a block of code into a
  same-named histogram of seconds.
- **Events** (:func:`event`) are instant markers with attributes, kept
  in a bounded in-process ring (:func:`events`) in the order emitted.

This is the JAX package's registry (``core/telemetry.py``) without its
trace files, exporter, live plane and trace context. The port's
``core/profiling.py::PhaseTimer`` keeps the job phases.
"""

from __future__ import annotations

import functools
import math
import threading
import time
import warnings
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
}

# Events kept for :func:`events` (oldest dropped first).
EVENT_RING = 4096

HIST_LO = 1e-9
HIST_GROWTH = 2.0 ** 0.125
_HIST_BUCKETS = 1 + 8 * 47 + 1  # underflow + 47 octaves + overflow
_LOG_G = math.log(HIST_GROWTH)


def is_declared(name: str) -> bool:
    """True when ``name`` is in the registry."""
    return name in NAMES


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
# the feed's producer, readahead workers and the compaction pools.
_lock = threading.RLock()
_counters: dict[str, float] = {}
_gauges: dict[str, dict] = {}
_hists: dict[str, Histogram] = {}
_warned_names: set[str] = set()
_events: deque = deque(maxlen=EVENT_RING)


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
        f"telemetry name {name!r} is not declared in telemetry.NAMES — "
        "declare it (the registry keeps metric names from forking on "
        "typos)",
        RuntimeWarning,
        stacklevel=3,
    )


def reset() -> None:
    """Zero every counter, gauge and histogram."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _warned_names.clear()
        _events.clear()


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


def observe(name: str, value: float) -> None:
    """Record ``value`` into histogram ``name``."""
    _check_name(name)
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram()
        h.record(value)


@contextmanager
def span(name: str):
    """``with telemetry.span("store.heal"):`` times the block into the
    histogram ``name`` (seconds)."""
    _check_name(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe(name, time.perf_counter() - t0)


def event(name: str, cat: str = "misc", **attrs) -> None:
    """Record an instant event ``name`` with its attributes."""
    _check_name(name)
    with _lock:
        _events.append({"name": name, "cat": cat,
                        "t": time.perf_counter(), "args": dict(attrs)})


def events(name: str | None = None) -> list[dict]:
    """The recorded events (of ``name`` only, when given), oldest
    first."""
    with _lock:
        return [dict(e) for e in _events if name is None or e["name"] == name]


def traced(name: str):
    """Decorator form of :func:`span` for whole-function spans."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def metrics_snapshot() -> dict:
    """Counters, gauges and histogram summaries, copied."""
    with _lock:
        return {
            "counters": dict(_counters),
            "gauges": {k: dict(v) for k, v in _gauges.items()},
            "histograms": {k: h.summary() for k, h in _hists.items()},
        }
