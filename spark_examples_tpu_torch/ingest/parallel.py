"""Parallel ingest engine: multi-worker parse/pack with ordered reassembly.

Work is sharded (by byte range for VCF text, by block ordinal for
random-access sources), run by a bounded thread pool, and reassembled in
submission order, so the emitted stream (blocks, metadata, positions,
resume cursors) is the serial stream's, byte for byte. The JAX
package's ``ingest/parallel.py`` is the spec.

- :func:`parallel_map_ordered` — a bounded ThreadPoolExecutor whose
  results are yielded strictly in input order. A worker's exception
  surfaces at the consumer on its turn, never out of order and never
  silently.
- :func:`parallel_blocks` — ``source.blocks(bv)`` in parallel where the
  source allows it: plain (seekable, not gzip) VCF files shard by byte
  range through the same record parser the serial path runs
  (``vcf.parse_record_lines``); sources claiming ``exact_n_variants``
  (synthetic, array and single-contig packed or dataset stores) shard
  by block ordinal through their own resume cursors. Everything else
  streams serially.
- ``store/writer.py::compact(..., workers=N)`` wires both: stage A is
  this module's parallel parse, stage B packs, compresses, hashes and
  writes each chunk in a second ordered pool.

Faults: a shard worker crossing the ``ingest.block_read`` site (or
raising a real transient ``IOError``) retries its whole shard under the
wrapping :class:`~spark_examples_tpu_torch.ingest.resilient.RetryPolicy`
(a shard parse is idempotent), and an exhausted budget surfaces as
:class:`~spark_examples_tpu_torch.ingest.resilient.IngestExhaustedError`
carrying the in-order resume cursor, stamped at the reassembly point
where that cursor is known. Fail-fast errors (``StoreCorruptError``,
``CorruptBlockError``) propagate unchanged with their own cursors.
"""

from __future__ import annotations

import os
import random
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from spark_examples_tpu_torch import native
from spark_examples_tpu_torch.core import faults, telemetry

# Byte-range shards target this much raw VCF text each: small enough
# that inflight shards bound host RAM (a shard's dense columns are
# ~text/4 bytes), large enough that per-shard overhead (thread dispatch,
# file open/seek) is noise against the parse.
VCF_SHARD_BYTES = 32 << 20

MAX_WORKERS = 256  # sanity ceiling, mirrored by the config validation


def parallel_map_ordered(items, fn, workers: int, inflight: int | None = None,
                         name: str = "ingest-worker"):
    """Yield ``fn(item)`` for every item, in input order, computed by a
    bounded worker pool.

    The ordered reassembly buffer of the parallel ingest engine: up to
    ``inflight`` tasks run/wait at once (bounding memory for streams of
    large blocks), results are yielded strictly in submission order, and
    a worker exception re-raises at the consumer on that item's turn —
    after every in-order predecessor was delivered, so downstream resume
    cursors are exact. Items are pulled from ``items`` lazily in the
    consumer thread (keep item production cheap; put the work in ``fn``).
    ``workers <= 1`` degrades to a plain in-thread map.
    """
    workers = max(1, int(workers))
    if workers == 1:
        for item in items:
            yield fn(item)
        return
    inflight = max(workers + 2, int(inflight or 0))
    pending: deque = deque()
    ex = ThreadPoolExecutor(max_workers=workers, thread_name_prefix=name)
    try:
        it = iter(items)
        exhausted = False
        while True:
            while not exhausted and len(pending) < inflight:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(ex.submit(fn, item))
            if not pending:
                return
            fut = pending.popleft()
            t0 = time.perf_counter()
            value = fut.result()  # re-raises the worker's exception
            telemetry.observe("ingest.reassembly_wait_s",
                              time.perf_counter() - t0)
            yield value
    finally:
        for fut in pending:
            fut.cancel()
        ex.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# VCF byte-range sharding.


def vcf_byte_shards(path: str, target_bytes: int | None = None,
                    max_shards: int | None = None) -> list[tuple[int, int]]:
    """Split a plain (non-gzip) VCF into record-aligned byte ranges.

    The first range starts at the first data line (header skipped);
    every boundary is advanced to the next line start, so each record
    line belongs to exactly one shard and concatenating shard parses in
    range order reproduces the file's record order exactly.
    ``target_bytes`` defaults to the module's :data:`VCF_SHARD_BYTES`
    (read at call time, so tests and tuning can adjust it).
    """
    if target_bytes is None:
        target_bytes = VCF_SHARD_BYTES
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        data_start = 0
        for line in f:
            if not line.startswith(b"#"):
                break
            data_start += len(line)
        span = size - data_start
        if span <= 0:
            return []
        n = max(1, -(-span // max(1, int(target_bytes))))
        if max_shards:
            n = min(n, int(max_shards))
        if n == 1:
            return [(data_start, size)]
        step = -(-span // n)
        bounds = [data_start]
        for k in range(1, n):
            target = min(data_start + k * step, size)
            if target <= bounds[-1]:
                continue
            f.seek(target)
            f.readline()  # discard the partial line; next one starts clean
            b = f.tell()
            if bounds[-1] < b < size:
                bounds.append(b)
        bounds.append(size)
    return list(zip(bounds[:-1], bounds[1:]))


def _parse_vcf_shard(path, lo, hi, n_samples, in_range, policy, seed):
    """One shard's records, grouped into per-contig-run pieces.

    Runs in a pool worker. Crosses the ``ingest.block_read`` fault site
    once per attempt and retries the WHOLE shard under ``policy`` on
    transient IO errors — a shard parse has no side effects, so the
    retry is bit-identical to an unfailed read. Returns
    ``[(cols, positions, contig), ...]`` pieces ready for ``rechunk``.

    Deliberately NOT RetryingSource._stream: that loop's extra
    machinery — reopen factories (for object-held memmaps; a shard
    opens its path fresh every attempt), per-block budget resets (a
    shard is one idempotent unit with no partial progress), cursor
    tracking (stamped at the reassembly point instead, where the
    in-order cursor exists) — has no referent here. The two share the
    RetryPolicy (budget/backoff/jitter) and the retry telemetry names,
    which is the contract that must stay in sync.
    """
    from spark_examples_tpu_torch.ingest.resilient import IngestExhaustedError

    rng = random.Random(seed)
    retries_left = policy.max_retries if policy is not None else 0
    retry_on = policy.retry_on if policy is not None else ()
    while True:
        try:
            faults.fire("ingest.block_read")
            return _parse_vcf_range(path, lo, hi, n_samples, in_range)
        except retry_on as e:
            if retries_left <= 0:
                telemetry.count("ingest.exhausted")
                # cursor -1: the reassembly layer stamps the in-order
                # variant cursor (unknowable inside one shard).
                raise IngestExhaustedError(
                    f"parallel ingest shard (bytes [{lo}, {hi}) of "
                    f"{path}) failed after {policy.max_retries} retries: "
                    f"{e!r}", -1,
                ) from e
            attempt = policy.max_retries - retries_left
            retries_left -= 1
            delay = policy.sleep_s(attempt, rng)
            telemetry.count("ingest.retries")
            telemetry.count("ingest.backoff_s", delay)
            warnings.warn(
                f"transient ingest error in parallel shard "
                f"[{lo}, {hi}) of {path} ({e!r}); retrying in "
                f"{delay * 1e3:.0f} ms ({retries_left} retries left)",
                RuntimeWarning, stacklevel=2,
            )
            time.sleep(delay)


def _parse_vcf_range(path, lo, hi, n_samples, in_range):
    """The record-aligned range [lo, hi) as per-contig-run pieces.

    The hot loop is the native batch parser (one GIL-released C call
    over the whole shard, which is what lets the shard worker threads
    scale); the serial stream's Python record parser is the
    byte-identical fallback and handles the input the C parser punts on.
    """
    with open(path, "rb") as f:
        f.seek(lo)
        buf = f.read(hi - lo)
    parsed = native.vcf_parse_block(buf, n_samples)
    if parsed is None:
        return _parse_vcf_range_py(buf, path, n_samples, in_range)
    rows, positions, contigs, n_short = parsed
    if n_short:
        warnings.warn(
            f"{path}: {n_short} record(s) in bytes [{lo}, {hi}) have "
            f"fewer than {n_samples} sample columns — skipping; the file "
            "may be truncated or malformed",
            RuntimeWarning, stacklevel=3,
        )
    if in_range is not None:
        keep = np.fromiter(
            (in_range(c, int(p))
             for c, p in zip(contigs, positions.tolist())),
            dtype=bool, count=len(contigs),
        )
        if not keep.all():
            rows = rows[keep]
            positions = positions[keep]
            contigs = [c for c, k in zip(contigs, keep.tolist()) if k]
    pieces = []
    a = 0
    for b in range(1, len(contigs) + 1):
        if b == len(contigs) or contigs[b] != contigs[a]:
            pieces.append((
                np.ascontiguousarray(rows[a:b].T),
                np.ascontiguousarray(positions[a:b]),
                contigs[a],
            ))
            a = b
    return pieces


def _parse_vcf_range_py(buf, path, n_samples, in_range):
    """One shard's bytes through ``vcf.parse_record_lines``, grouped
    into ``(cols, positions, contig)`` pieces at contig changes."""
    import io

    from spark_examples_tpu_torch.ingest.vcf import parse_record_lines

    pieces = []
    cols: list[np.ndarray] = []
    positions: list[int] = []
    contig: str | None = None

    def flush():
        if cols:
            pieces.append((
                np.stack(cols, axis=1),
                np.asarray(positions, np.int64),
                contig,
            ))
        cols.clear()
        positions.clear()

    rng_check = in_range if in_range is not None else (lambda c, p: True)
    for c, pos, col in parse_record_lines(
        io.BytesIO(buf), n_samples, rng_check, path
    ):
        if cols and c != contig:
            flush()
        contig = c
        cols.append(col)
        positions.append(pos)
    flush()
    return pieces


# ---------------------------------------------------------------------------
# Capability dispatch.


def _unwrap_retrying(source):
    """(inner, policy, seed) — see through a RetryingSource so the
    parallel path can honor the SAME retry contract inside workers."""
    from spark_examples_tpu_torch.ingest.resilient import RetryingSource

    if isinstance(source, RetryingSource):
        return source.inner, source.policy, source.seed
    return source, None, 0


def _vcf_shardable(source):
    """The VcfSource (possibly retry-wrapped) iff byte-range sharding
    applies: a plain seekable file (gzip streams cannot seek)."""
    from spark_examples_tpu_torch.ingest.vcf import VcfSource

    inner, policy, seed = _unwrap_retrying(source)
    if isinstance(inner, VcfSource) and not inner.path.endswith(".gz"):
        return inner, policy, seed
    return None


def parallel_blocks(source, block_variants: int, workers: int,
                    start_variant: int = 0) -> Iterator:
    """``source.blocks(block_variants)`` with the parse fanned out over
    ``workers`` threads — bit-identical stream, parallel production.

    Dispatch (first capability wins):

    - **VCF byte-range** — plain-file VcfSource (retry-wrapped or not):
      record-aligned byte shards through the shared record parser, then
      ``rechunk`` reassembles the in-order pieces into exactly the
      serial block grid (contig flushes included).
    - **block stripes** — sources claiming ``exact_n_variants`` (O(1)
      block-aligned resume, no mid-stream flushes, concurrency-safe
      reads): one pool task per block ordinal via ``blocks(bv, k*bv)``.
    - **serial fallback** — everything else (gzip VCF, chained/filtered
      streams, multi-contig stores): the source's own stream, unchanged.

    Resume (``start_variant > 0``) always takes the serial path: resume
    streams the tail of an interrupted job, where cursor semantics are
    source-specific and the win from parallelism is marginal.
    """
    workers = max(1, int(workers))
    if workers == 1 or start_variant > 0:
        yield from source.blocks(block_variants, start_variant)
        return

    vcf = _vcf_shardable(source)
    if vcf is not None:
        inner, policy, seed = vcf
        shards = vcf_byte_shards(inner.path)
        if len(shards) > 1:
            yield from _parallel_vcf_blocks(
                inner, shards, block_variants, workers, policy, seed
            )
            return
        # One shard = nothing to fan out; stream through the ORIGINAL
        # (possibly retry-wrapped) source, not the unwrapped inner.
        yield from source.blocks(block_variants, 0)
        return

    if getattr(source, "exact_n_variants", False):
        yield from _striped_blocks(source, block_variants, workers)
        return

    yield from source.blocks(block_variants, 0)


def _parallel_vcf_blocks(src, shards, block_variants, workers, policy, seed):
    from spark_examples_tpu_torch.ingest.source import rechunk

    n = src.n_samples  # header read once, in the consumer thread
    # None = no region filter (the common case) — the shard parser then
    # skips the per-record Python range check entirely.
    in_range = src._in_range if src.references else None

    def parse(shard_k):
        k, (lo, hi) = shard_k
        telemetry.count("ingest.parallel_shards")
        return _parse_vcf_shard(
            src.path, lo, hi, n, in_range, policy, seed + k
        )

    delivered = 0
    try:
        def pieces():
            for shard_pieces in parallel_map_ordered(
                enumerate(shards), parse, workers, name="vcf-parse"
            ):
                yield from shard_pieces

        for block, meta in rechunk(pieces(), block_variants):
            yield block, meta
            delivered = meta.stop
        # A full parse counted every record — cache it like the serial
        # stream does, so a later .n_variants needs no re-parse.
        src._n_variants = delivered
    except BaseException as e:
        if getattr(e, "cursor", None) == -1:
            e.cursor = delivered
            e.args = (f"{e.args[0]} — {delivered} variants were already "
                      f"delivered in order; resume from "
                      f"start_variant={delivered}",) + e.args[2:]
        raise


def _striped_blocks(source, block_variants, workers):
    """One pool task per block ordinal over an exact-length source —
    the stripe shard mode (random-access resume makes ``blocks(bv,
    k*bv)`` O(1), and exactness guarantees the grid is plain ceil
    division with no mid-stream flushes)."""
    v = source.n_variants
    n_blocks = -(-v // block_variants)
    if n_blocks <= 1:
        yield from source.blocks(block_variants, 0)
        return

    import dataclasses

    def read(k):
        telemetry.count("ingest.parallel_shards")
        it = source.blocks(block_variants, k * block_variants)
        try:
            block, meta = next(iter(it))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        # Re-index over the OUTPUT grid: an exact source's k-th block IS
        # ordinal k, and a retry wrapper's per-call re-indexing (every
        # stripe call starts a fresh stream at index 0) must not leak
        # into the reassembled metadata.
        return block, dataclasses.replace(meta, index=k)

    yield from parallel_map_ordered(
        range(n_blocks), read, workers, name="block-stripe"
    )


__all__ = [
    "parallel_blocks",
    "parallel_map_ordered",
    "vcf_byte_shards",
    "VCF_SHARD_BYTES",
    "MAX_WORKERS",
]
