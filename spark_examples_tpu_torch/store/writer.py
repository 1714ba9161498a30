"""Compaction: stream any GenotypeSource ONCE into the block store.

The ETL tier of the catalog (the reference's "load the cohort into the
BigQuery table once" job shape): every block the source yields becomes
one 2-bit-packed, entropy-coded chunk file named by the sha256 of its
STORED bytes, and the manifest — written last, atomically — records
the variant/contig/position index plus the per-chunk codec geometry
over them. Because the name IS the content:

- a re-run over identical data rewrites nothing (chunk writes are
  skipped when the address already exists — dedupe for free);
- a partially-written chunk can never be mistaken for a good one
  (files land via tmp + rename, and the reader re-hashes against the
  address on first touch anyway);
- a crashed compaction leaves no manifest, so the store simply does
  not exist yet — re-running is always safe.

Compression (store/codec.py) sits between the 2-bit pack and the hash:
the content address covers the stored (compressed) bytes, so all of
the above — and replica healing, quarantine bookkeeping, `store heal`
re-verification — hold for compressed chunks unchanged. The codec is
byte-deterministic by contract, so compaction at any worker count, a
killed-and-resumed compaction, and an origin heal all reproduce
identical stored bytes.

Chunks inherit the source's "blocks never span a contig" contract
(``source.blocks`` flushes at contig boundaries), so every catalog row
has an exact contig and the store can answer range queries without
touching data. That same contract is what makes the optional per-contig
preset dictionary (``--store-codec zlib-dict``) well-defined: the first
chunk of each contig trains the dictionary (a pure function of its
packed payload), every later chunk of the contig compresses against it,
and the dictionary itself lands content-addressed under ``dicts/``.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from spark_examples_tpu_torch.core import hashing, telemetry
from spark_examples_tpu_torch.store import codec as codecmod
from spark_examples_tpu_torch.store.manifest import (
    CHUNK_DIR,
    POSITIONS_NAME,
    ChunkRecord,
    StoreManifest,
)


class _DictBook:
    """Per-contig dictionary rendezvous for the compaction pool.

    The trainer (the worker holding a contig's FIRST chunk — tagged by
    the serial feed, so the claim is unambiguous) derives the
    dictionary from its own packed payload, writes it content-addressed
    under ``dicts/``, and publishes; every other worker of that contig
    waits on the publication before compressing. Deadlock-free by
    construction: the trainer's task is always submitted (and therefore
    scheduled, FIFO) before any waiter of the same contig, and trainers
    never wait on anything. The timeout is a belt for a crashed trainer
    — its error also surfaces at the ordered consumer, first.
    """

    TIMEOUT_S = 300.0

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self._entries: dict[str | None, tuple[threading.Event,
                                              list]] = {}

    def _entry(self, contig):
        with self._lock:
            e = self._entries.get(contig)
            if e is None:
                e = self._entries[contig] = (threading.Event(), [])
            return e

    def train_and_publish(self, contig, raw: bytes) -> tuple[str, bytes]:
        zdict = codecmod.train_dict(raw)
        digest = hashing.sha256_bytes(zdict)
        path = codecmod.dict_path(self.root, digest)
        try:
            fresh = os.path.getsize(path) != len(zdict)
        except OSError:
            fresh = True
        if fresh:
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(zdict)
            os.replace(tmp, path)
        event, slot = self._entry(contig)
        slot.append(("ok", digest, zdict))
        event.set()
        return digest, zdict

    def poison(self, contig) -> None:
        """The trainer died before publishing: release its waiters with
        a marker instead of leaving them parked until the timeout (the
        trainer's own error, being earliest, still surfaces first at
        the ordered consumer)."""
        event, slot = self._entry(contig)
        if not slot:
            slot.append(("dead",))
        event.set()

    def wait(self, contig) -> tuple[str, bytes]:
        event, slot = self._entry(contig)
        if not event.wait(self.TIMEOUT_S) or not slot:
            raise RuntimeError(
                f"compaction dictionary for contig {contig!r} was never "
                "published — the trainer worker died; its error follows "
                "at the ordered consumer"
            )
        entry = slot[0]
        if entry[0] != "ok":
            raise RuntimeError(
                f"compaction dictionary trainer for contig {contig!r} "
                "failed — its error follows at the ordered consumer"
            )
        return entry[1], entry[2]


def _write_chunk(path: str, block: np.ndarray, base_codec: str,
                 book: "_DictBook | None",
                 first_of_contig: bool, contig) -> tuple[str, int, int,
                                                         str | None]:
    """Pack + compress + hash + (dedupe-aware) write one chunk; returns
    (digest, raw_size, stored_size, dict_digest). Runs in a pool worker
    under ``workers > 1`` — the numpy 2-bit pack, the deflate, sha256
    over the stored bytes and the file write all release the GIL, which
    is what makes stage B scale."""
    from spark_examples_tpu_torch.ingest import bitpack

    dict_digest = zdict = None
    try:
        packed = bitpack.pack_dosages(np.ascontiguousarray(block))
        raw = packed.tobytes()
        if book is not None and first_of_contig:
            dict_digest, zdict = book.train_and_publish(contig, raw)
    except BaseException:
        if book is not None and first_of_contig:
            book.poison(contig)
        raise
    if book is not None and not first_of_contig:
        dict_digest, zdict = book.wait(contig)
    data = codecmod.compress(base_codec, raw, zdict)
    digest = hashing.sha256_bytes(data)
    fname = os.path.join(path, CHUNK_DIR, f"{digest}.bin")
    # Dedupe by content address — but a wrong-SIZED file under the
    # right name is a truncated write (or a quarantined chunk), and
    # re-running the compaction must heal it, not trust the name.
    # Same-size bit rot is the read path's job (first-touch digest
    # verify); healing it means deleting the quarantined file and
    # re-running this compaction.
    try:
        fresh = os.path.getsize(fname) != len(data)
    except OSError:
        fresh = True
    if fresh:
        tmp = fname + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, fname)
        telemetry.count("store.compact_bytes", float(len(data)))
    telemetry.count("store.compact_chunks")
    telemetry.count("store.codec.raw_bytes", float(len(raw)))
    telemetry.count("store.codec.stored_bytes", float(len(data)))
    return digest, len(raw), len(data), dict_digest


def _tag_first_of_contig(block_iter):
    """(block, meta) -> (block, meta, first_of_contig), computed in the
    single serial feed so every worker agrees on which chunk trains a
    contig's dictionary."""
    seen: set = set()
    for block, meta in block_iter:
        first = meta.contig not in seen
        seen.add(meta.contig)
        yield block, meta, first


@telemetry.traced("store.compact")
def compact(path: str, source, chunk_variants: int = 16384,
            workers: int = 1, origin: dict | None = None,
            codec: str | None = None) -> StoreManifest:
    """Stream ``source`` into a content-addressed store at ``path``.

    ``chunk_variants`` is the catalog granularity: the unit of range
    addressing, integrity verification, and decode caching. It must be
    divisible by 4 so full chunks stay byte-aligned on the 2-bit grid
    (which is what lets the reader hand out zero-copy packed slices of
    raw-codec chunks). Returns the committed manifest.

    ``workers > 1`` runs the parallel ingest engine (ingest/parallel.py)
    under the SAME output contract — byte-identical chunks and manifest:
    stage A fans the parse out where the source allows it (VCF byte
    ranges, exact-source block stripes), stage B packs + compresses +
    hashes + writes each chunk in a second bounded pool, both
    reassembled in order. The serial ``workers=1`` path below is the
    semantic reference.

    ``origin`` (an IngestConfig-shaped dict — build one with
    ``store.heal.origin_from_ingest``) is recorded in the manifest as
    the store's self-healing recipe: a later corrupt chunk can be
    re-compacted from the origin source in place (re-compressed with
    the chunk's recorded codec + dictionary) and verified against its
    content address (store/heal.py). None disables healing-from-origin
    for this store (replica healing still works).

    ``codec`` names the chunk payload codec (config.STORE_CODEC_SPECS;
    default "zlib"): "raw" writes the v1-era uncompressed payload,
    "zlib" deflates each chunk, "zlib-dict" additionally trains a
    shared preset dictionary per contig during this same single pass.
    """
    from spark_examples_tpu_torch.ingest import bitpack

    if chunk_variants <= 0 or chunk_variants % bitpack.VARIANTS_PER_BYTE:
        raise ValueError(
            f"chunk_variants must be a positive multiple of "
            f"{bitpack.VARIANTS_PER_BYTE}, got {chunk_variants}"
        )
    workers = int(workers)
    if workers < 1:
        raise ValueError(f"compact workers must be >= 1, got {workers}")
    base_codec, with_dict = codecmod.parse_spec(
        codec or codecmod.DEFAULT_SPEC)
    n = source.n_samples
    os.makedirs(os.path.join(path, CHUNK_DIR), exist_ok=True)
    book = None
    if with_dict:
        os.makedirs(os.path.join(path, codecmod.DICT_DIR), exist_ok=True)
        book = _DictBook(path)

    if workers > 1:
        from spark_examples_tpu_torch.ingest.parallel import (
            parallel_blocks, parallel_map_ordered,
        )

        block_iter = _tag_first_of_contig(
            parallel_blocks(source, chunk_variants, workers))

        def emit(item):
            block, meta, first = item
            return meta, _write_chunk(path, block, base_codec, book,
                                      first, meta.contig)

        emitted = parallel_map_ordered(block_iter, emit, workers,
                                       name="compact-chunk")
    else:
        emitted = (
            (meta, _write_chunk(path, block, base_codec, book, first,
                                meta.contig))
            for block, meta, first in _tag_first_of_contig(
                source.blocks(chunk_variants))
        )

    records: list[ChunkRecord] = []
    chunk_positions: list[np.ndarray | None] = []
    written = 0  # variants consumed from the stream
    for meta, (digest, raw_size, stored_size, dict_digest) in emitted:
        if meta.start != written:
            raise ValueError(
                f"non-contiguous block stream: expected start {written}, "
                f"got {meta.start}"
            )
        pos_lo = pos_hi = -1
        if meta.positions is not None and len(meta.positions):
            chunk_positions.append(np.asarray(meta.positions, np.int64))
            pos_lo = int(meta.positions[0])
            pos_hi = int(meta.positions[-1])
        else:
            chunk_positions.append(None)
        records.append(ChunkRecord(
            start=meta.start, stop=meta.stop, contig=meta.contig,
            digest=digest, pos_lo=pos_lo, pos_hi=pos_hi,
            codec=base_codec, raw_size=raw_size,
            stored_size=stored_size, dict_digest=dict_digest,
        ))
        written = meta.stop
    # The declared count is consulted AFTER the stream: a completed full
    # pass caches it on parse-counting sources (VcfSource), so the
    # compaction never pays the serial pre-scan pass the reader would
    # otherwise run up front — a pure serial term the parallel engine
    # could not have absorbed.
    v = source.n_variants
    if written != v:
        raise ValueError(
            f"source stream ended at {written} of {v} declared variants"
        )
    if not records:
        raise ValueError("source yielded no variants — nothing to compact")

    positions = np.full(v, -1, np.int64)
    for rec, cp in zip(records, chunk_positions):
        if cp is not None:
            positions[rec.start:rec.stop] = cp
    has_positions = bool((positions >= 0).all())
    positions_digest = None
    if has_positions:
        pos_path = os.path.join(path, POSITIONS_NAME)
        tmp = pos_path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            tee = hashing.TeeHashWriter(f)
            np.save(tee, positions)
        os.replace(tmp, pos_path)
        positions_digest = tee.sha256.hexdigest()

    manifest = StoreManifest(
        n_samples=n,
        n_variants=v,
        chunk_variants=chunk_variants,
        sample_hash=hashing.sample_hash(source.sample_ids),
        chunks=records,
        sample_ids=list(source.sample_ids),
        has_positions=has_positions,
        positions_digest=positions_digest,
        origin=origin,
    )
    manifest.save(path)  # the commit point
    return manifest
