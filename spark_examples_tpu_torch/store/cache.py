"""Tier 2 of the store read path: a bounded host-RAM decode cache.

The read path is tiered — disk (mmap of the stored chunk file, the
cold tier the OS page cache sits under) → this cache (the chunk's
DECODED form: the dense int8 decode at ~4x the packed bytes, or — for
compressed chunks on the packed transport — the inflated 2-bit
payload) → the consumer. Decoding is the per-read cost the packed +
compressed format trades disk/IO for; jobs that pass over the cohort
more than once (repeated jobs over one open store, repeated range
queries) pay it once per chunk instead of once per read, bounded
by ``max_bytes`` so a 40M-variant store cannot eat the host.

Accounting charges each entry at its **decoded** (in-RAM ndarray)
size, never the on-disk chunk size: once chunks compress ~4x, a bound
derived from stored bytes would admit ~4x the RAM it claims to — the
``--store-cache-mb`` knob bounds what the host actually holds.

Every get/put is accounted (``store.cache_hits`` / ``store.cache_misses``
counters, ``store.cache_bytes`` gauge, core/telemetry.py) so the hit
rate is stated, not guessed. The JAX package's ``store/cache.py`` is the
spec.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from spark_examples_tpu_torch.core import telemetry


class DecodeCache:
    """Thread-safe byte-bounded LRU of decoded chunks.

    Keys are ``(form, chunk_ordinal)`` tuples — ``("dense", i)`` for
    int8 decodes, ``("packed", i)`` for inflated 2-bit payloads: the
    two decoded forms of one chunk are distinct entries that must
    never collide on a bare ordinal. Values are frozen (read-only) so
    a cached chunk handed to two consumers can never be mutated under
    either, and charged at ``value.nbytes`` — the decoded in-RAM size.
    ``max_bytes=0`` disables storage entirely (every get misses — the
    knob's documented "no cache" setting). A single value larger than
    the bound is not stored (storing it would immediately evict
    everything else for a chunk that can never be joined by a second
    one).
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max(0, int(max_bytes))
        self._data: OrderedDict = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._lock = threading.Lock()

    def peek(self, key) -> np.ndarray | None:
        """``get`` without accounting or LRU promotion — the readahead
        pool's "already resident?" probe (a background warmer consulting
        the cache must not inflate the consumer-facing hit/miss stats
        or reorder the eviction queue)."""
        with self._lock:
            return self._data.get(key)

    def get(self, key) -> np.ndarray | None:
        with self._lock:
            value = self._data.get(key)
            if value is not None:
                self._data.move_to_end(key)
                self._hits += 1
            else:
                self._misses += 1
        if value is not None:
            telemetry.count("store.cache_hits")
        else:
            telemetry.count("store.cache_misses")
        return value

    def put(self, key, value: np.ndarray) -> None:
        if self.max_bytes == 0 or value.nbytes > self.max_bytes:
            return
        frozen = np.asarray(value)
        frozen.setflags(write=False)
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._data[key] = frozen
            self._bytes += frozen.nbytes
            while self._bytes > self.max_bytes:
                _, dropped = self._data.popitem(last=False)
                self._bytes -= dropped.nbytes
                self._evictions += 1
            nbytes = self._bytes
        telemetry.gauge_set("store.cache_bytes", float(nbytes))

    def stats(self) -> dict:
        """Accounting snapshot (hits/misses/evictions/resident bytes)."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "bytes": self._bytes,
                "entries": len(self._data),
                "max_bytes": self.max_bytes,
            }
