"""Background readahead for the store read path: decode ahead of the
cursor so the store-cold tier runs at store-hit throughput.

Cold store reads pay mmap + first-touch sha256 verify + 2-bit decode
per chunk, serialized on the consumer thread while the card (or the
next pipeline stage) waits. The readahead pool moves that work off the
critical path: as the streaming loops (``StoreSource.blocks`` /
``packed_blocks`` / range sources) advance, the next ``depth`` chunks
are decoded+verified by a small worker pool into the existing
:class:`~spark_examples_tpu_torch.store.cache.DecodeCache`, so by the time
the cursor arrives the read is a cache hit. sha256 and the NumPy
unpack both release the GIL, so warming genuinely overlaps consumer
work (and other warms).

Error contract — workers never swallow and never crash a thread
silently: an exception raised while warming chunk ``i`` (an injected
``store.read`` fault, a real flaky read, a digest mismatch) is held and
**re-raised in the consumer thread when the cursor reaches chunk i** —
in order, with the chunk's own resume cursor — so it flows through the
exact same retry/fail-fast boundary (`ingest/resilient.py`) a
synchronous read would: transient ``IOError`` s get retried/reopened,
:class:`~spark_examples_tpu_torch.store.manifest.StoreCorruptError` fails
fast with the quarantine recorded.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from spark_examples_tpu_torch.core import faults, telemetry

# Decode workers per pool: enough to overlap verify+decode with the
# consumer, few enough that a fleet of open stores doesn't breed
# threads. Depth (how far ahead to warm) is the operator's knob
# (--readahead-chunks, adaptively raised toward --readahead-chunks-max
# below); this is plumbing width, not policy.
MAX_WORKERS = 4

# Cadence/latency EWMA smoothing: ~4 samples of memory — fast enough
# to follow a phase change (compute-heavy stretch ends, consumer
# speeds up), slow enough that one hiccup does not saw the depth.
_EWMA_ALPHA = 0.25


class ReadaheadPool:
    """A bounded chunk-warming pool for one store reader, with
    cadence-adaptive depth.

    ``schedule(key, fn)`` submits ``fn`` (the decode/verify of one
    chunk) unless that key is already scheduled; ``consume(key)`` is
    called by the consumer on a cache miss — it waits out an in-flight
    warm of the same chunk (double-decoding would double-fire the
    ``store.read`` fault site and waste the work) and returns its
    value, re-raising the worker's exception if it failed. Keys never
    scheduled return None and the caller decodes inline. Keys are
    ``(transport, chunk_index)`` tuples: the dense and packed
    transports warm different artifacts (a cached decode vs a verified
    payload) and must never collide on a bare index.

    **Adaptive depth.** ``depth`` (how far ahead the reader schedules)
    breathes with the measured feed, driven by two signals. Ground
    truth first: a ``consume()`` that actually had to block on an
    unfinished warm means the window is too shallow, and the next
    retire deepens it by one (the EWMA ratio is distorted exactly
    then — a starved consumer's measured retire interval absorbs the
    decode wait, which would otherwise suppress deepening when it is
    most needed). Wait-free rounds settle toward the EWMA target: the
    consumer's PER-CHUNK retire cadence (``note_retire`` receives the
    cursor's chunk index, so the interval normalizes whatever the
    block grid — blocks finer than a chunk accumulate until a chunk
    boundary is crossed, coarser blocks divide by the chunks they
    retired) against the per-chunk warm latency (timed around every
    worker body); the target is the latency/cadence ratio plus one,
    clamped to [floor, max_depth], stepped down at most one per retire
    so the window breathes instead of sawing. A compute-bound consumer
    keeps the window — and the host RAM it pins — at the floor.
    ``max_depth <= floor`` disables adaptation (the pre-adaptive fixed
    behavior). The live depth is exported as the
    ``store.readahead.depth`` gauge: pinned at the ceiling really
    does mean the feed is decode/disk-bound (the consumer keeps
    arriving before the warms finish).
    """

    def __init__(self, depth: int, workers: int | None = None,
                 max_depth: int = 0):
        self.floor = max(1, int(depth))
        self.max_depth = max(self.floor, int(max_depth))
        self._depth = self.floor
        self._ex = ThreadPoolExecutor(
            max_workers=workers or min(self.max_depth, MAX_WORKERS),
            thread_name_prefix="store-readahead",
        )
        self._futures: dict[tuple, Future] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._retire_ewma: float | None = None
        self._decode_ewma: float | None = None
        self._last_retire: float | None = None
        self._last_idx: int | None = None
        self._waited = False
        telemetry.gauge_set("store.readahead.depth", float(self._depth))

    @property
    def depth(self) -> int:
        """The current (possibly adapted) scheduling depth."""
        return self._depth

    @staticmethod
    def _ewma(old: float | None, sample: float) -> float:
        if old is None:
            return sample
        return old + _EWMA_ALPHA * (sample - old)

    @staticmethod
    def _target_depth(decode_s: float | None, retire_s: float | None,
                      floor: int, max_depth: int) -> int:
        """Pure policy: chunks the consumer retires per decode latency,
        plus one of slack, clamped — split out so the adaptation curve
        is unit-testable without threads or clocks."""
        if decode_s is None or retire_s is None:
            return floor
        target = 1 + math.ceil(decode_s / max(retire_s, 1e-9))
        return max(floor, min(max_depth, target))

    def note_retire(self, chunk_idx: int | None = None) -> None:
        """Consumer-cadence sample: called once per consumed block (the
        reader's ``_schedule_ahead``), with the cursor's chunk index so
        the interval normalizes to per-CHUNK cadence whatever the block
        grid. Re-targets the depth (see the class docstring)."""
        now = time.perf_counter()
        with self._lock:
            advance = 1
            if chunk_idx is not None:
                advance = (0 if self._last_idx is None
                           else max(chunk_idx - self._last_idx, 0))
                self._last_idx = chunk_idx
            if self._last_retire is None:
                self._last_retire = now
            elif advance > 0:
                self._retire_ewma = self._ewma(
                    self._retire_ewma, (now - self._last_retire) / advance)
                self._last_retire = now
            waited, self._waited = self._waited, False
            if self.max_depth <= self.floor:
                return
            if waited:
                new = min(self.max_depth, self._depth + 1)
            else:
                tgt = self._target_depth(self._decode_ewma,
                                         self._retire_ewma,
                                         self.floor, self.max_depth)
                new = tgt if tgt > self._depth else max(tgt, self._depth - 1)
            changed = new != self._depth
            self._depth = new
        if changed:
            telemetry.gauge_set("store.readahead.depth", float(new))

    def _warm(self, fn):
        """The worker body: the chaos site fires FIRST so an armed spec
        fails/stalls the warm inside the pool thread — proving the
        held-and-re-raised-at-the-cursor error contract (and that a
        worker death can never leak past `consume` silently). The whole
        body is timed into the decode-latency EWMA — an injected delay
        is indistinguishable from a slow disk, which is the point."""
        t0 = time.perf_counter()
        try:
            faults.fire("store.readahead.decode")
            return fn()
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._decode_ewma = self._ewma(self._decode_ewma, dt)

    def schedule(self, key: tuple, fn) -> None:
        with self._lock:
            if self._closed or key in self._futures:
                return
            if len(self._futures) >= 2 * self.depth:
                # Backstop against a consumer that skips chunks (range
                # queries): never hold more than 2x depth of warmed-but-
                # unconsumed chunks alive.
                return
            self._futures[key] = self._ex.submit(self._warm, fn)
            telemetry.gauge_set("store.readahead.in_flight",
                                float(len(self._futures)))
        telemetry.count("store.readahead.scheduled")

    def consume(self, key: tuple):
        """The consumer's rendezvous for one warm: the warmed value,
        the worker's re-raised exception, or None (never scheduled)."""
        with self._lock:
            fut = self._futures.pop(key, None)
            telemetry.gauge_set("store.readahead.in_flight",
                                float(len(self._futures)))
        if fut is None:
            return None
        if not fut.done():
            # The consumer is about to block on an unfinished warm —
            # ground truth that the window is too shallow; the next
            # retire deepens it (see the class docstring).
            with self._lock:
                self._waited = True
        t0 = time.perf_counter()
        try:
            value = fut.result()
        except BaseException:
            telemetry.count("store.readahead.errors")
            raise
        finally:
            telemetry.observe("store.readahead.wait_s",
                              time.perf_counter() - t0)
        telemetry.count("store.readahead.hits")
        return value

    def close(self) -> None:
        """Cancel pending warms and join the workers: no pool thread
        outlives the reader (a running warm finishes first)."""
        with self._lock:
            self._closed = True
            self._futures.clear()
        self._ex.shutdown(wait=True, cancel_futures=True)
