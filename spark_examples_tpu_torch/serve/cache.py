"""LRU result cache of the projection server.

Keyed by a digest of the query genotypes, under the serving model's
content fingerprint as an explicit **namespace**: a hot-reloaded model
never serves a stale result, and a namespace can be evicted whole.
Values are the final (1, k) coordinate rows, tiny next to the cross
statistics a miss costs.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from spark_examples_tpu_torch.core.hashing import array_digest


def _nbytes(value) -> int:
    if isinstance(value, tuple):
        return sum(v.nbytes for v in value)
    return value.nbytes


def genotype_digest(genotypes: np.ndarray, namespace: str = "") -> str:
    """Content digest of one query's genotypes (shape and dtype folded
    in; ``namespace`` optionally folded into the digest itself)."""
    return array_digest(genotypes, namespace=namespace)


class ResultCache:
    """Thread-safe bounded LRU keyed by ``(namespace, digest)``. Stored
    arrays are copied in and marked read-only; capacity 0 stores
    nothing (every get misses)."""

    def __init__(self, capacity: int):
        self.capacity = max(0, int(capacity))
        self._data: OrderedDict[tuple[str, str], np.ndarray] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key: str, namespace: str = "") -> np.ndarray | None:
        with self._lock:
            value = self._data.get((namespace, key))
            if value is not None:
                self._data.move_to_end((namespace, key))
            return value

    def put(self, key: str, value, namespace: str = "") -> None:
        if self.capacity == 0:
            return
        # A real copy: freezing an alias would make the caller's result
        # read-only. A tuple of arrays stays a tuple (its dtypes kept).
        if isinstance(value, tuple):
            frozen = tuple(np.array(v) for v in value)
            for v in frozen:
                v.setflags(write=False)
        else:
            frozen = np.array(value)
            frozen.setflags(write=False)
        with self._lock:
            old = self._data.get((namespace, key))
            if old is not None:
                self._bytes -= _nbytes(old)
            self._data[(namespace, key)] = frozen
            self._bytes += _nbytes(frozen)
            self._data.move_to_end((namespace, key))
            while len(self._data) > self.capacity:
                _, evicted = self._data.popitem(last=False)
                self._bytes -= _nbytes(evicted)

    def evict_namespace(self, namespace: str) -> int:
        """Drop every entry of ``namespace``; returns the count."""
        with self._lock:
            doomed = [k for k in self._data if k[0] == namespace]
            for k in doomed:
                self._bytes -= _nbytes(self._data.pop(k))
            return len(doomed)

    def stats(self) -> dict:
        """Entries, bytes and namespaces held."""
        with self._lock:
            return {
                "entries": len(self._data),
                "bytes": int(self._bytes),
                "namespaces": len({k[0] for k in self._data}),
            }

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0
