"""LSH banding: MinHash signatures -> deterministic candidate pairs.

The signature's k hash columns are split into ``bands`` bands of
``k // bands`` rows each (``--minhash-hashes`` must be a multiple of
``--minhash-bands`` — config validation enforces it). Two samples
become a candidate pair when ANY band of their signatures matches
exactly — the standard S-curve: with r rows per band the match
probability of a pair at Jaccard similarity s is ``1 - (1 - s^r)^b``,
steep around ``(1/b)^(1/r)``.

Everything here is host NumPy over the already-materialized (N, k)
signature array — candidate generation is O(N * bands) hashing plus the
pair fan-out, noise next to the streamed passes on either side of it.

Determinism is a contract, not an accident: buckets keep their members
in sample-index order, over-cap buckets truncate to the FIRST
``bucket_cap`` members (the rest are counted, never silently lost —
``neighbors.bucket_overflows``), and the returned pairs are the sorted
unique ``i < j`` list. Two runs over the same signatures produce
byte-identical candidate sets, which is what lets a killed and resumed
job reproduce the whole neighbors file byte for byte.

A copy of the JAX package's ``neighbors/lsh.py`` (host-only NumPy).
"""

from __future__ import annotations

import numpy as np


def candidate_pairs(sig: np.ndarray, bands: int,
                    bucket_cap: int) -> tuple[np.ndarray, int, int]:
    """(N, k) uint32 signatures -> ``(pairs, n_overflow, n_buckets)``:
    the sorted unique (P, 2) int64 ``i < j`` candidate list, the number
    of samples dropped from over-cap buckets, and the number of
    non-singleton buckets seen (telemetry color).

    ``bucket_cap`` bounds the worst case: a degenerate band (e.g. a
    cohort slab of near-identical samples, or all-0xFFFFFFFF signatures
    from carrier-free samples) would otherwise fan out O(N^2) pairs and
    defeat the filter. Truncation keeps the first ``bucket_cap``
    members by sample index — deterministic, and biased toward no one
    in particular since sample order carries no similarity signal.
    """
    sig = np.ascontiguousarray(sig, dtype=np.uint32)
    n, k = sig.shape
    if bands < 1 or k % bands:
        raise ValueError(
            f"signature length {k} is not a multiple of {bands} bands")
    rows = k // bands
    pairs: set[tuple[int, int]] = set()
    n_overflow = 0
    n_buckets = 0
    for band in range(bands):
        sl = sig[:, band * rows:(band + 1) * rows]
        buckets: dict[bytes, list[int]] = {}
        for i in range(n):
            buckets.setdefault(sl[i].tobytes(), []).append(i)
        for members in buckets.values():
            if len(members) < 2:
                continue
            n_buckets += 1
            if len(members) > bucket_cap:
                n_overflow += len(members) - bucket_cap
                members = members[:bucket_cap]
            for x in range(len(members) - 1):
                mi = members[x]
                for mj in members[x + 1:]:
                    pairs.add((mi, mj))
    if not pairs:
        return np.zeros((0, 2), np.int64), n_overflow, n_buckets
    out = np.array(sorted(pairs), dtype=np.int64)
    return out, n_overflow, n_buckets


def filter_fraction(n_candidates: int, n_samples: int) -> float:
    """Share of all N(N-1)/2 pairs the filter AVOIDED evaluating — the
    headline ``neighbors.filter_frac`` gauge (1.0 = evaluated nothing,
    0.0 = the filter degenerated to all-pairs)."""
    total = n_samples * (n_samples - 1) // 2
    if total <= 0:
        return 1.0
    return 1.0 - min(n_candidates, total) / total
