"""Partitioned, concurrent host-side ingest (``--splits-per-contig``).

The reference split each contig into sub-ranges and streamed them
concurrently, one partition each. Here
:func:`~spark_examples_tpu_torch.ingest.source.partition_ranges` decides
the split, and :class:`PartitionedSource` reads the parts with a bounded
pool of reader threads while the consumer drains blocks in strict part
order: the emitted stream (blocks, metadata, resume cursors) is
bit-identical to a :class:`~spark_examples_tpu_torch.ingest.source.ChainSource`
over the same parts, so the accumulation order, and with it the int32
sums and checkpoint parity, is unchanged.

Read-ahead, not reordering: later parts parse while earlier ones are
consumed and while the card computes (gzip, numpy and the native codec
release the interpreter lock; pure-Python parsing time-slices).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from dataclasses import dataclass, field

from spark_examples_tpu_torch.ingest.source import close_source

_END = object()


@dataclass
class PartitionedSource:
    """Order-preserving concurrent reader over per-range sources.

    ``parts``: one source per genomic sub-range. ``max_workers`` parts
    read ahead at once; each buffers at most ``buffer_blocks`` blocks
    (memory bound: workers x buffer x block bytes).
    """

    parts: list
    max_workers: int = 4
    buffer_blocks: int = 4
    _counts: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self.parts:
            raise ValueError("PartitionedSource needs >= 1 part")
        ns = {p.n_samples for p in self.parts}
        if len(ns) != 1:
            raise ValueError(f"sources disagree on n_samples: {ns}")

    @property
    def n_samples(self) -> int:
        return self.parts[0].n_samples

    @property
    def n_variants(self) -> int:
        return sum(self._count(k) for k in range(len(self.parts)))

    @property
    def sample_ids(self) -> list[str]:
        return self.parts[0].sample_ids

    def _count(self, k: int) -> int:
        """Variant count of part k (cached: a VCF part pre-scans once)."""
        if k not in self._counts:
            self._counts[k] = self.parts[k].n_variants
        return self._counts[k]

    def blocks(self, block_variants: int, start_variant: int = 0):
        # Locate the resume point. A part is counted only when the cursor
        # might lie in it: a fresh stream starts at once and learns the
        # counts from the stream itself.
        first_part, local_start, offset = 0, start_variant, 0
        while local_start > 0:
            if first_part >= len(self.parts):
                return  # cursor at or past the end
            pv = self._count(first_part)
            if local_start < pv:
                break
            local_start -= pv
            offset += pv
            first_part += 1
        if first_part >= len(self.parts):
            return

        active = list(range(first_part, len(self.parts)))
        queues = {k: queue.Queue(maxsize=self.buffer_blocks) for k in active}
        stop = threading.Event()
        sem = threading.BoundedSemaphore(max(1, self.max_workers))

        def put(k: int, item) -> bool:
            while not stop.is_set():
                try:
                    queues[k].put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def read_part(k: int, part_start: int):
            try:
                for item in self.parts[k].blocks(block_variants, part_start):
                    if not put(k, item):
                        return
                put(k, _END)
            except BaseException as e:  # propagate into the consumer
                put(k, e)
            finally:
                sem.release()

        threads: list[threading.Thread] = []

        def maybe_launch():
            # Parts start in order while worker slots are free; a
            # finished reader releases its slot for a later part.
            while len(threads) < len(active) and sem.acquire(blocking=False):
                k = active[len(threads)]
                t = threading.Thread(
                    target=read_part,
                    args=(k, local_start if k == first_part else 0),
                    name=f"partitioned-reader-{k}",
                    daemon=True,
                )
                threads.append(t)
                t.start()

        idx = 0
        try:
            maybe_launch()
            for k in active:
                last_local_stop = 0
                while True:
                    item = queues[k].get()
                    if item is _END:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    block, meta = item
                    yield block, dataclasses.replace(
                        meta, index=idx, start=meta.start + offset,
                        stop=meta.stop + offset)
                    idx += 1
                    last_local_stop = meta.stop
                    maybe_launch()
                # A drained part's last block ends at the part's variant
                # count (streams run to the part's end whatever the
                # start cursor); only a part that emitted nothing needs
                # an explicit count.
                if last_local_stop > 0:
                    self._counts.setdefault(k, last_local_stop)
                    offset += last_local_stop
                else:
                    offset += self._count(k)
                maybe_launch()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)

    def close(self) -> None:
        for part in self.parts:
            close_source(part)
