"""Pipelined host->device block feed.

A producer thread builds each host block (source read, ragged-tail
padding, 2-bit packing) into a bounded queue; the consumer copies it to
the device and yields it. A source that stores 2-bit bytes ships them
as they are on the packed transport: no host unpack or repack. On a
CUDA target a source that holds those bytes (``packed_views``: the
packed store in memory or mapped, a dataset store's chunks) hands the
producer each block as a view, which the producer gathers straight into
its pinned slab, padding a ragged tail: that gather is the block's one
host copy. Otherwise the source's own copy (``packed_blocks``) or its
host re-pack is copied into the slab. On the dense transport a dataset
store decodes each block straight into the feed's buffer
(``block_spans`` + ``decode_range_into``), with no intermediate block.
On a CUDA target the host blocks live in a ring of reusable **pinned**
slabs, and each copy is ``non_blocking`` on a side stream into a ring
of device buffers, so block k+1's copy overlaps block k's update; the
compute stream waits on the copy's event before it touches the block.
A slab is recycled only after its copy's event has completed, and that
wait lags :data:`TRANSFER_DEPTH` blocks behind the yield. A device
buffer is rewritten only after the compute stream has passed the event
it recorded when the consumer pulled the :data:`HOLD_PULLS`-th block
after the one it held, so a feed faster than the card holds at most
``prefetch + TRANSFER_DEPTH`` blocks on the card, and the host then
waits on the card in the slab's retire. Pinning happens only for CUDA
targets (a CPU-only torch refuses ``pin_memory``); CPU targets get a
fresh host buffer per block, wrapped without a copy.

Ragged final blocks are padded to the full width with MISSING (dense) or
0xFF (packed: four missing codes per byte), which contribute zero to
every gram product and keep one block shape for the whole stream.

Per-stage telemetry, under the JAX package's names:
``prefetch.stage_wait_s`` (the producer waits for a free slab),
``prefetch.put_wait_s`` (it waits for queue space),
``prefetch.get_wait_s`` (the consumer waits for a block: its sum over
the gram phase is the stall fraction), ``prefetch.queue_depth`` sampled
before each get, ``prefetch.transfers_in_flight`` and
``prefetch.transfer_wait_s`` (a retired slab's residual copy wait). The
``device.put`` fault site fires before each block's copy to the device,
``prefetch.transfer_wait`` before a slab's copy is waited out.

The port's own spans and counters time the feed's stages: ``feed.read``
(the producer's host work for a block: the source's slicing, copy or
decode into the feed's buffer), ``feed.pin`` (the producer's copy into
the pinned slab: for a view, the gather), ``feed.copy`` (the
host-to-device copy, in device seconds: an event pair on the copy
stream, read when the slab retires), ``feed.gathered_blocks`` (blocks
whose one host copy was the gather into a slab) and
``prefetch.device_ring_waits`` (copies issued while the card still held
their device buffer).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.dtypes import GENOTYPE_DTYPE, MISSING
from spark_examples_tpu_torch.core.profiling import device_span
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest.source import BlockMeta, GenotypeSource

_END = object()

# A byte of four missing codes (0b11_11_11_11).
PACKED_MISSING = 0xFF

# How many blocks a slab's recycling lags behind its yield.
TRANSFER_DEPTH = 2

# A yielded device block stays valid until the consumer pulls the
# HOLD_PULLS-th block after it: its work on the block is enqueued by
# then (the multihost feed pulls one block ahead of the one it yields).
HOLD_PULLS = 2

# Threads that copy a block's rows into its pinned slab, in GATHER_BANDS
# row bands a thread. np.copyto releases the GIL, and a strided gather
# gains from more copies in flight: a (15,708, 4,096 B) view of a
# 262,144-B-wide array took 16 ms on one thread of an H100 machine's
# host, 5 ms on four.
GATHER_THREADS = 4
GATHER_BANDS = 4


def pad_block(block: np.ndarray, block_variants: int) -> np.ndarray:
    """Right-pad a ragged block to ``block_variants`` with MISSING."""
    n, v = block.shape
    if v == block_variants:
        return block
    out = np.full((n, block_variants), MISSING, dtype=GENOTYPE_DTYPE)
    out[:, :v] = block
    return out


def pad_packed(packed: np.ndarray, width_bytes: int) -> np.ndarray:
    """Right-pad a ragged 2-bit packed block to ``width_bytes`` columns
    with four-missing bytes."""
    n, w = packed.shape
    if w == width_bytes:
        return packed
    out = np.full((n, width_bytes), PACKED_MISSING, dtype=np.uint8)
    out[:, :w] = packed
    return out


def fill_slab(out: np.ndarray, host: np.ndarray, pad: int,
              pool: ThreadPoolExecutor) -> None:
    """Copy the host block ``host`` (a view or an array) into the leading
    columns of the staging slab ``out`` in row bands over ``pool``, and
    write ``pad`` over the rest: a reused slab holds the last block's
    bytes there."""
    w = host.shape[1]
    cuts = np.linspace(0, len(out), GATHER_THREADS * GATHER_BANDS + 1,
                       dtype=int)

    def band(lo_hi):
        lo, hi = lo_hi
        np.copyto(out[lo:hi, :w], host[lo:hi])
        if w < out.shape[1]:
            out[lo:hi, w:] = pad

    # list() waits for every band and raises the first band's error.
    list(pool.map(band, zip(cuts[:-1], cuts[1:])))


def padded_width(block_variants: int, pack: bool = False, *,
                 pad_multiple: int = 1) -> int:
    """The column width every streamed block is padded to — bytes when
    ``pack``, variants otherwise — rounded up to a multiple of
    ``pad_multiple`` (the plan's variant shards, ``GramPlan.block_shards``:
    every shard then gets the same width; missing calls and 0xFF bytes
    add nothing to any product)."""
    grid = pad_multiple * (bitpack.VARIANTS_PER_BYTE if pack else 1)
    width = -(-block_variants // grid) * grid
    return width // bitpack.VARIANTS_PER_BYTE if pack else width


class _Slab:
    """One pinned staging buffer plus its way home."""

    __slots__ = ("tensor", "array", "_free")

    def __init__(self, shape, dtype: torch.dtype, free: queue.Queue):
        self.tensor = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.array = self.tensor.numpy()
        self._free = free

    def release(self) -> None:
        self._free.put(self)


class _PinnedRing:
    """Pool of reusable pinned slabs, allocated lazily up to ``n_slots``.
    The producer blocks in :meth:`acquire` while every slab is in flight,
    which is the feed's backpressure over the copy stage."""

    def __init__(self, n_slots: int, shape, dtype: torch.dtype):
        self._shape, self._dtype = shape, dtype
        self._free: queue.Queue = queue.Queue()
        self._allocated = 0
        self._n_slots = n_slots

    def acquire(self, stop: threading.Event) -> _Slab | None:
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                slab = self._free.get_nowait()
            except queue.Empty:
                slab = None
                if self._allocated < self._n_slots:  # producer thread only
                    self._allocated += 1
                    slab = _Slab(self._shape, self._dtype, self._free)
                else:
                    try:
                        slab = self._free.get(timeout=0.1)
                    except queue.Empty:
                        continue
            telemetry.observe("prefetch.stage_wait_s",
                              time.perf_counter() - t0)
            return slab
        return None


class _DeviceRing:
    """The device buffers a CUDA feed's blocks land in, used in turn and
    allocated on the first lap. Block k's buffer is rewritten for block
    k + ``size`` only after the compute stream passes the event it
    recorded when the consumer pulled block k + :data:`HOLD_PULLS` (the
    copy stream waits on it), so at most ``size`` (> HOLD_PULLS) blocks
    are alive on the card however far the host runs ahead."""

    def __init__(self, size: int, shape, dtype: torch.dtype, device,
                 copy_stream):
        self._size, self._shape, self._dtype = size, shape, dtype
        self._device, self._copy_stream = device, copy_stream
        self._bufs: list[torch.Tensor] = []
        self._released: list = [None] * size
        self._pulls = 0

    def next(self, compute_stream) -> torch.Tensor:
        """The buffer for the block the consumer pulls now, with the copy
        stream made to wait until the card is done with its last block."""
        k = self._pulls
        self._pulls += 1
        if k >= HOLD_PULLS:
            # The consumer's work on block k - HOLD_PULLS is enqueued.
            j = (k - HOLD_PULLS) % self._size
            if self._released[j] is None:
                self._released[j] = torch.cuda.Event()
            self._released[j].record(compute_stream)
        i = k % self._size
        if i == len(self._bufs):
            # Allocated on the copy stream, which writes it first: memory
            # the compute stream freed may still be in its queue's use.
            with torch.cuda.stream(self._copy_stream):
                self._bufs.append(torch.empty(
                    self._shape, dtype=self._dtype, device=self._device))
        else:
            released = self._released[i]
            if not released.query():
                telemetry.count("prefetch.device_ring_waits")
            self._copy_stream.wait_event(released)
        buf = self._bufs[i]
        # Read on the compute stream: its memory returns to the pool only
        # once that stream's work, too, is done.
        buf.record_stream(compute_stream)
        return buf


def _host_blocks(source, block_variants, start_variant, pack, stats,
                 width, views):
    """``(host array, meta, view)``. With ``views`` (the producer gathers
    into its slab) and a source that offers them, ``packed_views``' items:
    the source's own 2-bit bytes, ragged at the tail, ``view`` True where
    they are a view of its storage. Otherwise at the padded ``width`` and
    never a view: the source's own 2-bit bytes when it has them and
    blocks fall on byte boundaries, else its int8 blocks, packed on the
    host for the packed transport. On the dense transport
    ``stats["max_value"]`` tracks the largest value streamed (the
    value-scaled int32 budget reads it)."""
    aligned = pack and block_variants % bitpack.VARIANTS_PER_BYTE == 0
    if aligned and views and hasattr(source, "packed_views"):
        yield from source.packed_views(block_variants, start_variant)
        return
    if aligned and hasattr(source, "packed_blocks"):
        for pblock, meta in source.packed_blocks(block_variants,
                                                 start_variant):
            yield pad_packed(pblock, width), meta, False
        return
    for block, meta in source.blocks(block_variants, start_variant):
        if pack:
            yield bitpack.pack_dosages(pad_block(
                block, width * bitpack.VARIANTS_PER_BYTE)), meta, False
            continue
        if stats is not None and block.size:
            stats["max_value"] = max(stats.get("max_value", 0),
                                     int(block.max()))
        yield pad_block(block, width), meta, False


def decode_direct(source, pack: bool) -> bool:
    """True when the dense feed drives the source's own decode into its
    buffers: a dataset store (or a range or retry wrapper of one) on the
    dense transport."""
    return (not pack and hasattr(source, "decode_range_into")
            and hasattr(source, "block_spans"))


def _produce(source, block_variants, start_variant, prefetch, pack, ring,
             stats, width):
    """Run the producer thread; yields ``(host array, slab | None, meta)``
    at the padded ``width``."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item, measure: bool = True) -> bool:
        # The sentinels' waits (the final put waits for the consumer to
        # drain the whole queue) are not block waits.
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                if measure:
                    telemetry.observe("prefetch.put_wait_s",
                                      time.perf_counter() - t0)
                return True
            except queue.Full:
                continue
        return False

    def direct():
        """The store's dense drive: each block decoded straight into the
        pinned slab (CUDA) or a fresh MISSING-filled buffer the consumer
        owns (CPU), with no intermediate block."""
        if stats is not None:
            # Store payloads are 2-bit dosages; a resumed job keeps the
            # largest value of the blocks before its cursor.
            stats["max_value"] = max(stats.get("max_value", 0), 2)
        for lo, hi, meta in source.block_spans(block_variants,
                                               start_variant):
            slab = None
            if ring is not None:
                slab = ring.acquire(stop)
                if slab is None:
                    return
                host = slab.array
            else:
                host = np.full((source.n_samples, width), MISSING,
                               GENOTYPE_DTYPE)
            with telemetry.span("feed.read", cat="feed"):
                source.decode_range_into(lo, hi, host)
            if slab is not None and hi - lo < width:
                host[:, hi - lo:] = MISSING
            if not put((host, slab, meta)):
                return
        put(_END, measure=False)

    def produce():
        try:
            if decode_direct(source, pack):
                direct()
                return
            # Each read span is begun before the next block is asked for
            # and ended when it arrives: the source's own work.
            read = telemetry.begin("feed.read", cat="feed")
            pad = PACKED_MISSING if pack else MISSING
            # The gather's threads end with the producer's, and count
            # with them (their names extend the producer's).
            gather = (ThreadPoolExecutor(
                GATHER_THREADS, thread_name_prefix="prefetch-producer-gather")
                if ring is not None else None)
            try:
                for host, meta, view in _host_blocks(
                        source, block_variants, start_variant, pack, stats,
                        width, views=ring is not None):
                    read.end()
                    slab = None
                    if ring is not None:
                        slab = ring.acquire(stop)
                        if slab is None:
                            return
                        with telemetry.span("feed.pin", cat="feed"):
                            fill_slab(slab.array, host, pad, gather)
                        if view:
                            telemetry.count("feed.gathered_blocks")
                        host = slab.array
                    if not put((host, slab, meta)):
                        return
                    read = telemetry.begin("feed.read", cat="feed")
            finally:
                read.cancel()  # the last saw only the source's end
                if gather is not None:
                    gather.shutdown()
            put(_END, measure=False)
        except BaseException as e:  # propagate into the consumer
            put(e, measure=False)

    t = threading.Thread(target=produce, name="prefetch-producer",
                         daemon=True)
    t.start()
    try:
        while True:
            telemetry.gauge_set("prefetch.queue_depth", q.qsize())
            t0 = time.perf_counter()
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            telemetry.observe("prefetch.get_wait_s",
                              time.perf_counter() - t0)
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)


def stream_to_device(
    source: GenotypeSource,
    block_variants: int,
    device: torch.device,
    start_variant: int = 0,
    prefetch: int = 2,
    pack: bool = False,
    stats: dict | None = None,
    pad_multiple: int = 1,
) -> Iterator[tuple[torch.Tensor, BlockMeta]]:
    """Yield device-resident, shape-stable (N, padded_width) blocks:
    uint8 packed codes when ``pack``, int8 values otherwise; the width a
    multiple of ``pad_multiple`` (the plan's variant shards). ``stats``:
    a dict the producer updates in place (``max_value`` on the dense
    transport). Errors in the producer propagate to the consumer;
    abandoning the generator stops the producer. On a CUDA target a
    block's buffer is reused: enqueue the work that reads it before
    pulling the :data:`HOLD_PULLS`-th block after it, and copy what must
    outlive that."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    width = padded_width(block_variants, pack=pack,
                         pad_multiple=pad_multiple)
    ring = None
    if cuda:
        dtype = torch.uint8 if pack else torch.int8
        ring = _PinnedRing(prefetch + TRANSFER_DEPTH + 2,
                           (source.n_samples, width), dtype)
        copy_stream = torch.cuda.Stream(device)
        device_ring = _DeviceRing(max(1, prefetch) + TRANSFER_DEPTH,
                                  (source.n_samples, width), dtype, device,
                                  copy_stream)
    # (copy event, slab) pairs whose copies may still be in flight.
    pending: deque = deque()
    producer = _produce(source, block_variants, start_variant,
                        max(1, prefetch), pack, ring, stats, width)
    try:
        for host, slab, meta in producer:
            faults.fire("device.put")
            if not cuda:
                if not host.flags.writeable:
                    # A store's read-only mapping or cached payload: the
                    # tensor gets its own bytes.
                    host = host.copy()
                yield torch.from_numpy(host), meta
                continue
            compute_stream = torch.cuda.current_stream(device)
            # Taken before the copy's start event: the span then times
            # the copy, not the wait for a free buffer.
            block = device_ring.next(compute_stream)
            with torch.cuda.stream(copy_stream):
                with device_span("feed.copy", device, copy_stream,
                                 waited=True) as copy:
                    block.copy_(slab.tensor, non_blocking=True)
            # The copy's end event: the compute stream waits on it, and
            # the slab retires once it has completed.
            compute_stream.wait_event(copy.end)
            pending.append((copy, slab))
            telemetry.gauge_set("prefetch.transfers_in_flight",
                                float(len(pending)))
            if len(pending) > TRANSFER_DEPTH:
                copy, old = pending.popleft()
                faults.fire("prefetch.transfer_wait")
                t0 = time.perf_counter()
                _retire(copy)
                telemetry.observe("prefetch.transfer_wait_s",
                                  time.perf_counter() - t0)
                old.release()
            yield block, meta
    finally:
        # Stop the producer first, then retire the in-flight copies.
        producer.close()
        while pending:
            copy, slab = pending.popleft()
            _retire(copy)
            slab.release()


def _retire(copy) -> None:
    """Wait out a block's copy and record its device time."""
    copy.end.synchronize()
    copy.resolve()
