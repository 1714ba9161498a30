"""Content-hashing helpers: one sha256 vocabulary for the port.

The dataset store names every chunk by the digest of its stored bytes,
verifies reads against that name, and fingerprints the cohort and the
position index in its manifest. The encodings are the JAX package's
(``spark_examples_tpu/core/hashing.py``), so a digest written by either
package verifies in the other.
"""

from __future__ import annotations

import hashlib

import numpy as np


def sha256_bytes(data) -> str:
    """Hex sha256 of a bytes-like object (bytes, memoryview, buffer):
    a store chunk's content address."""
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, chunk_bytes: int = 1 << 20) -> str:
    """Hex sha256 of a file, streamed (never the whole file in RAM)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_bytes), b""):
            h.update(chunk)
    return h.hexdigest()


class TeeHashWriter:
    """File wrapper hashing every byte as it is written, so a writer
    never re-reads what it just wrote to checksum it."""

    def __init__(self, f):
        self._f = f
        self.sha256 = hashlib.sha256()

    def write(self, data):
        self.sha256.update(data)
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


def array_digest(arr: np.ndarray, namespace: str = "") -> str:
    """Content digest of one array, dtype and shape folded in so two
    buffers with the same bytes but different views cannot collide;
    ``namespace`` prefixes a caller-chosen scope (the serving cache's
    model fingerprint)."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(f"{namespace}|{a.dtype.str}|{a.shape}|".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def sample_hash(sample_ids: list[str]) -> str:
    """Short (16-hex) cohort fingerprint over the ordered sample ids."""
    h = hashlib.sha256("\n".join(sample_ids).encode()).hexdigest()
    return h[:16]
