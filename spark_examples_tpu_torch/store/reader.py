"""StoreSource: the catalog as a GenotypeSource, with verified reads.

The read path is tiered:

1. **disk** — each chunk file is ``np.memmap``-ed read-only (the packed
   bytes of a raw-codec chunk page in on demand and ship zero-copy; a
   compressed chunk's stored bytes are inflated by the decode below);
2. **decode cache** — decoded chunks in bounded host RAM with hit/miss
   accounting (store/cache.py), charged at their DECODED size: dense
   int8 decodes under ``("dense", idx)`` keys, and — for compressed
   chunks on the packed transport — inflated 2-bit payloads under
   ``("packed", idx)``;
3. the consumer: ``blocks`` / ``packed_views`` / ``packed_blocks``
   re-grid chunks into any requested block width (never spanning a
   contig), ``range_source`` answers contig/variant/position range
   queries off the catalog, and cursors resume deterministically — the
   drop-in contract every job surface (the runner's jobs) already
   assumes.

Decoding (store/codec.py ``decode_into``, one native call where the
library is built) inflates and 2-bit unpacks into the destination
buffer: a fresh cache entry, a ``read_range``
output, or (through ``decode_range_into`` / ``block_spans``, the feed's
direct drive) a reusable staging slab.

**Integrity**: a chunk's filename is the sha256 of its STORED bytes.
On first touch per reader the file is re-hashed against the address
(``store.read`` fault site fires first, so the chaos harness can
corrupt or fail the read deterministically) — corrupt compressed bytes
are caught exactly where corrupt raw bytes are. A mismatch, a wrong
size, or undecodable stored bytes first attempt an in-place **heal**
(store/heal.py): a verified copy from a peer replica directory, else a
re-compaction (and re-compression) of the chunk's origin span when the
manifest records one — degradation instead of fail-fast. Only when no
route repairs it is the chunk quarantined — recorded in
``<store>/quarantine.json`` (atomic, idempotent — store/quarantine.py),
counted, and raised as :class:`StoreCorruptError` naming the resume
cursor. Corruption is damage, not weather: the retry layer
(ingest/resilient.py) retries transient ``IOError`` s around this path
but never a quarantined chunk.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import replace as _dc_replace

import numpy as np

from spark_examples_tpu_torch.core import faults, hashing, telemetry
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest.source import BlockMeta
from spark_examples_tpu_torch.store import codec as codecmod
from spark_examples_tpu_torch.store import quarantine as qledger
from spark_examples_tpu_torch.store.cache import DecodeCache
from spark_examples_tpu_torch.store.heal import HealError, heal_chunk, recover_dict
from spark_examples_tpu_torch.store.manifest import (
    ChunkRecord,
    StoreCorruptError,
    StoreManifest,
)

DEFAULT_CACHE_BYTES = 256 << 20  # 256 MB of decoded chunks
DEFAULT_READAHEAD_MAX = 16


def open_store(path: str, cache_bytes: int = DEFAULT_CACHE_BYTES,
               verify: bool = True,
               readahead_chunks: int = 0,
               readahead_chunks_max: int = DEFAULT_READAHEAD_MAX,
               replicas=(), auto_heal: bool = True,
               device: str = "cuda") -> "StoreSource":
    """Open a compacted store (manifest load + lazy chunk mapping).

    ``readahead_chunks > 0`` arms the background readahead pool
    (store/readahead.py): the streaming loops warm chunks ahead of the
    cursor into the decode cache, so the store-cold tier (mmap +
    first-touch verify + decode) overlaps consumption instead of
    serializing in front of it. ``readahead_chunks`` is the depth
    FLOOR; ``readahead_chunks_max`` (when > floor) lets the pool adapt
    the depth to the measured consumer cadence vs decode latency —
    deep when the consumer outruns the decode, shallow when it does
    not (exported as the ``store.readahead.depth`` gauge).

    ``replicas`` names peer store directories holding content-addressed
    copies of the chunks; together with ``auto_heal`` (default on) a
    chunk that fails its digest verify is repaired in place — from a
    replica, else by re-compacting its origin span when the manifest
    records one — instead of failing the read (store/heal.py).
    ``device``: where an origin rebuilt for such a heal runs (the job's
    ``--device``).
    """
    return StoreSource(path, StoreManifest.load(path),
                       cache_bytes=cache_bytes, verify=verify,
                       readahead_chunks=readahead_chunks,
                       readahead_chunks_max=readahead_chunks_max,
                       replicas=replicas, auto_heal=auto_heal,
                       device=device)


class StoreSource:
    """A compacted store as a streaming genotype source (see module
    docstring). Construct via :func:`open_store`."""

    def __init__(self, root: str, manifest: StoreManifest,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 verify: bool = True, readahead_chunks: int = 0,
                 readahead_chunks_max: int = DEFAULT_READAHEAD_MAX,
                 replicas=(), auto_heal: bool = True,
                 device: str = "cuda"):
        self.root = root
        self.manifest = manifest
        self.verify = bool(verify)
        self.replicas = tuple(replicas)
        self.auto_heal = bool(auto_heal)
        self.device = device
        self.cache = DecodeCache(cache_bytes)
        self._verified: set[int] = set()
        self._positions: np.ndarray | None = None
        self._dicts: dict[str, bytes] = {}
        self._ra = None
        if readahead_chunks:
            if readahead_chunks < 0:
                raise ValueError(
                    f"readahead_chunks must be >= 0, got {readahead_chunks}"
                )
            from spark_examples_tpu_torch.store.readahead import ReadaheadPool

            self._ra = ReadaheadPool(readahead_chunks,
                                     max_depth=readahead_chunks_max)

    def close(self) -> None:
        """Stop the readahead pool (idempotent; streams already yielded
        stay valid — the pool only warms the cache)."""
        if self._ra is not None:
            self._ra.close()
            self._ra = None

    # -- GenotypeSource metadata -------------------------------------------

    @property
    def n_samples(self) -> int:
        return self.manifest.n_samples

    @property
    def n_variants(self) -> int:
        return self.manifest.n_variants

    @property
    def sample_ids(self) -> list[str]:
        if self.manifest.sample_ids is not None:
            return self.manifest.sample_ids
        return [f"S{i:06d}" for i in range(self.n_samples)]

    @property
    def exact_n_variants(self) -> bool:
        """Same claim shape as Packed2BitSource: a single-contig store
        streams exactly ceil(V/bv) blocks on both transports; a multi-
        contig store's blocks flush at chromosome runs, so it declines."""
        return len(self.manifest.contig_runs) <= 1

    @property
    def positions(self) -> np.ndarray | None:
        """Per-variant positions (mmap), digest-verified on first load."""
        if not self.manifest.has_positions:
            return None
        if self._positions is None:
            pos_path = os.path.join(self.root, "positions.npy")
            want = self.manifest.positions_digest
            if self.verify and want is not None:
                got = hashing.sha256_file(pos_path)
                if got != want:
                    raise StoreCorruptError(
                        f"store positions file {pos_path!r} does not "
                        f"match its manifest digest (truncated or "
                        "corrupt) — re-compact the store", 0,
                    )
            self._positions = np.load(pos_path, mmap_mode="r")
        return self._positions

    # -- chunk access (the tiered read path) -------------------------------

    def _chunk_path(self, rec: ChunkRecord) -> str:
        return os.path.join(self.root, rec.filename())

    def _handle_damage(self, idx: int, rec: ChunkRecord, reason: str,
                       healed: bool) -> None:
        """A chunk failed a size/existence/digest/decode check: try an
        in-place heal first (replica copy, else origin re-compaction —
        store/heal.py), and only quarantine + fail when no route
        repairs it. Returns (with the file repaired and the chunk's
        first-touch verification reset) so the caller can retry its
        read ONCE; ``healed`` guards that retry — a chunk that fails
        again right after a successful heal is damage the heal cannot
        fix (e.g. a fault spec re-corrupting every read), and must
        fail rather than loop."""
        telemetry.count("store.verify_failures")
        if self.auto_heal and not healed and (
            self.replicas or self.manifest.origin is not None
        ):
            try:
                how = heal_chunk(self.root, self.manifest, rec,
                                 replicas=self.replicas,
                                 device=self.device)
            except HealError as e:
                reason = f"{reason}; heal failed ({e})"
            else:
                warnings.warn(
                    f"store: chunk {idx} ({rec.digest[:16]}...) was "
                    f"corrupt ({reason}) and healed in place from "
                    f"{how} — the stream continues",
                    RuntimeWarning, stacklevel=5,
                )
                self._verified.discard(idx)
                return
        self._quarantine(idx, rec, reason)

    def _quarantine(self, idx: int, rec: ChunkRecord, reason: str):
        """Record a corrupt chunk and fail fast with the cursor named.

        The file is left in place (the operator may be able to recover
        it — e.g. re-copy from a replica; content addressing means a
        recovered chunk needs no manifest surgery), but its address is
        appended to quarantine.json (atomically and idempotently —
        store/quarantine.py) so post-mortem tooling sees every incident
        even after the process dies."""
        telemetry.count("store.quarantined")
        qledger.record(self.root, {
            "chunk": idx, "digest": rec.digest,
            "file": rec.filename(), "start": rec.start,
            "stop": rec.stop, "reason": reason,
        })
        raise StoreCorruptError(
            f"store chunk {idx} ({rec.filename()}, variants "
            f"[{rec.start}, {rec.stop})) is corrupt: {reason} — the "
            "chunk is quarantined (see quarantine.json), not retried "
            "and not skipped; recover the file (its name is its "
            "expected sha256 — restore it from a replica, or delete it "
            "and re-run the compaction over the original source) and "
            f"resume from start_variant={rec.start}",
            rec.start,
        )

    def _stored_bytes(self, idx: int, _healed: bool = False) -> np.ndarray:
        """The chunk file's STORED bytes (1-D uint8 mmap), size-checked
        against the catalog and (first touch) sha256-verified against
        the content address. Damage routes through
        :meth:`_handle_damage` — one heal attempt, then quarantine +
        fail."""
        rec = self.manifest.chunks[idx]
        path = self._chunk_path(rec)
        # Chaos site BEFORE the mapping: an armed truncate corrupts the
        # file relative to its content address (exactly what a torn
        # replica copy looks like); an io_error exercises the retry
        # boundary wrapping this source.
        faults.fire("store.read", path=path)
        want = rec.disk_size(self.n_samples)
        try:
            size = os.path.getsize(path)
        except FileNotFoundError:
            # A cataloged chunk that does not exist is damage (a lost
            # replica copy, a deleted quarantined file), not weather —
            # letting it escape as raw OSError would burn the retry
            # layer's whole reopen budget re-missing the same file and
            # end with no recovery guidance. Other OSErrors (EIO, a
            # flapping mount) stay retryable.
            self._handle_damage(idx, rec, "chunk file missing", _healed)
            return self._stored_bytes(idx, _healed=True)
        if size != want:
            # Wrong on-disk size for the catalog row = truncation (the
            # check the raw mmap shape used to provide, kept explicit
            # now that compressed sizes are per-chunk).
            self._handle_damage(
                idx, rec, f"file is {size} bytes, catalog says {want}",
                _healed)
            return self._stored_bytes(idx, _healed=True)
        m = np.memmap(path, dtype=np.uint8, mode="r")
        if self.verify and idx not in self._verified:
            got = hashing.sha256_bytes(m)
            telemetry.count("store.chunks_verified")
            if got != rec.digest:
                # Release the mapping before a heal rewrites the file.
                del m
                self._handle_damage(
                    idx, rec, f"sha256 {got[:16]}... does not match the "
                    "content address (bit rot or a torn write)", _healed)
                return self._stored_bytes(idx, _healed=True)
            self._verified.add(idx)
        return m

    def _dict_bytes(self, rec: ChunkRecord) -> bytes | None:
        """The chunk's shared preset dictionary (dicts/<digest>.zdict),
        digest-verified on first load per reader and cached. A missing
        or corrupt dictionary file is store damage: recovered through
        the same replica/origin routes as a chunk (store/heal.py
        recover_dict), else failed fast with the chunk's cursor."""
        dd = rec.dict_digest
        if dd is None:
            return None
        cached = self._dicts.get(dd)
        if cached is not None:
            return cached
        path = codecmod.dict_path(self.root, dd)
        data = None
        try:
            with open(path, "rb") as f:
                data = f.read()
            if hashing.sha256_bytes(data) != dd:
                data = None
        except OSError:
            data = None
        if data is None:
            if not self.auto_heal:
                # Same contract as chunks: with healing disabled,
                # damage fails fast instead of quietly rewriting store
                # files the caller said not to touch.
                raise StoreCorruptError(
                    f"store dictionary {path!r} is missing or corrupt "
                    "(healing disabled) — restore the file from a "
                    "replica or run `store heal`, then resume from "
                    f"start_variant={rec.start}",
                    rec.start,
                )
            try:
                data = recover_dict(self.root, self.manifest, dd,
                                    replicas=self.replicas,
                                    device=self.device)
            except HealError as e:
                raise StoreCorruptError(
                    f"store dictionary {path!r} is missing or corrupt "
                    f"and could not be recovered ({e}) — every chunk "
                    "compressed against it is unreadable; restore the "
                    "file from a replica or re-run `store heal`, then "
                    f"resume from start_variant={rec.start}",
                    rec.start,
                ) from e
        self._dicts[dd] = data
        return data

    def _decode_span_into(self, idx: int, v0: int, v1: int,
                          out: np.ndarray, col_off: int,
                          _healed: bool = False) -> None:
        """Decode variants [v0, v1) of chunk ``idx`` into ``out`` at
        ``col_off`` — the native (or fallback) decode with the same
        one-heal-then-quarantine damage contract as the byte reads."""
        rec = self.manifest.chunks[idx]
        m = self._stored_bytes(idx, _healed)
        try:
            codecmod.decode_into(
                m, rec.codec, self._dict_bytes(rec), self.n_samples,
                bitpack.packed_width(rec.width), v0, v1, out, col_off,
            )
        except codecmod.StoreDecodeError as e:
            # Undecodable stored bytes behave exactly like a digest
            # mismatch (they can only diverge when verification is
            # off or the damage landed mid-read).
            del m
            self._handle_damage(idx, rec, str(e), _healed)
            self._decode_span_into(idx, v0, v1, out, col_off,
                                   _healed=True)

    def _decode_chunk(self, idx: int) -> np.ndarray:
        """Unconditional map+verify+decode of one chunk into the cache —
        the cold tier's actual work, shared by the consumer path and the
        readahead workers (who run it off the critical path)."""
        rec = self.manifest.chunks[idx]
        with telemetry.span("store.chunk_read"):
            dense = np.empty((self.n_samples, rec.width), np.int8)
            self._decode_span_into(idx, 0, rec.width, dense, 0)
        self.cache.put(("dense", idx), dense)
        return dense

    def _decompress_payload(self, idx: int,
                            _healed: bool = False) -> np.ndarray:
        """Inflate a compressed chunk's 2-bit payload into host RAM
        (and the decode cache — charged at its DECODED size): the
        packed transport's unit for non-raw chunks."""
        rec = self.manifest.chunks[idx]
        m = self._stored_bytes(idx, _healed)
        try:
            payload = codecmod.decompress(
                rec.codec, m, rec.payload_size(self.n_samples),
                self._dict_bytes(rec))
        except codecmod.StoreDecodeError as e:
            del m
            self._handle_damage(idx, rec, str(e), _healed)
            return self._decompress_payload(idx, _healed=True)
        arr = np.frombuffer(payload, np.uint8).reshape(
            self.n_samples, bitpack.packed_width(rec.width))
        self.cache.put(("packed", idx), arr)
        return arr

    def _payload(self, idx: int) -> np.ndarray:
        """The chunk's packed 2-bit payload, (n, w_bytes) uint8: the
        verified mmap itself for raw chunks (zero-copy), the cached
        inflate for compressed ones."""
        rec = self.manifest.chunks[idx]
        if rec.codec == codecmod.RAW:
            return self._stored_bytes(idx).reshape(
                self.n_samples, bitpack.packed_width(rec.width))
        cached = self.cache.get(("packed", idx))
        if cached is not None:
            return cached
        return self._decompress_payload(idx)

    def _warm_payload(self, idx: int) -> np.ndarray:
        """Readahead worker body, packed transport: verify (raw) or
        inflate-and-cache (compressed) unless already resident (peek —
        a background warmer must not touch the consumer-facing hit/miss
        accounting)."""
        rec = self.manifest.chunks[idx]
        if rec.codec == codecmod.RAW:
            return self._stored_bytes(idx).reshape(
                self.n_samples, bitpack.packed_width(rec.width))
        cached = self.cache.peek(("packed", idx))
        if cached is not None:
            return cached
        return self._decompress_payload(idx)

    def _warm_dense(self, idx: int) -> np.ndarray:
        """Readahead worker body, dense transport: decode unless
        already resident (peek, for the same accounting reason)."""
        cached = self.cache.peek(("dense", idx))
        if cached is not None:
            return cached
        return self._decode_chunk(idx)

    def _schedule_ahead(self, last_idx: int, packed: bool = False) -> None:
        """Warm the chunks after ``last_idx`` in the background, to the
        pool's (possibly cadence-adapted) current depth.

        Called once per consumed block, which is also the pool's
        consumer-cadence sample (``note_retire``). Dense transport
        warms full decodes into the cache; the packed transport's cold
        cost is the first-touch digest verify plus (for compressed
        chunks) the inflate, so it warms the payload instead. Errors
        raised by a warm are delivered to the consumer when its cursor
        reaches the failed chunk (ReadaheadPool.consume), in order."""
        if self._ra is None:
            return
        self._ra.note_retire(last_idx)
        n_chunks = len(self.manifest.chunks)
        for j in range(last_idx + 1,
                       min(last_idx + 1 + self._ra.depth, n_chunks)):
            rec = self.manifest.chunks[j]
            if packed:
                if rec.codec == codecmod.RAW:
                    if j in self._verified:
                        continue
                elif self.cache.peek(("packed", j)) is not None:
                    continue
                self._ra.schedule(("packed", j),
                                  lambda j=j: self._warm_payload(j))
            else:
                if self.cache.peek(("dense", j)) is not None:
                    continue
                self._ra.schedule(("dense", j),
                                  lambda j=j: self._warm_dense(j))

    def _chunk_dense(self, idx: int) -> np.ndarray:
        """Dense int8 decode of one chunk, through the decode cache and
        (when armed) the readahead rendezvous."""
        cached = self.cache.get(("dense", idx))
        if cached is not None:
            return cached
        if self._ra is not None:
            got = self._ra.consume(("dense", idx))  # re-raises a failed warm
            if got is not None:
                return got
        return self._decode_chunk(idx)

    def read_range(self, lo: int, hi: int) -> np.ndarray:
        """Dense (N, hi-lo) int8 slice of the global variant order —
        the random-access primitive range queries and tests build on."""
        if not 0 <= lo <= hi <= self.n_variants:
            raise ValueError(
                f"variant range [{lo}, {hi}) out of bounds for a "
                f"{self.n_variants}-variant store"
            )
        parts = [
            self._chunk_dense(i)[:, max(lo - rec.start, 0):hi - rec.start]
            for i, rec in self.manifest.chunks_for_range(lo, hi)
        ]
        if not parts:
            return np.empty((self.n_samples, 0), np.int8)
        out = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        return np.ascontiguousarray(out)

    def decode_range_into(self, lo: int, hi: int, out: np.ndarray,
                          col_off: int = 0) -> None:
        """Decode global variants [lo, hi) into ``out[:, col_off:...]``
        — the zero-copy drive the prefetch staging ring uses
        (ingest/prefetch.py): cached/warmed chunks are block-copied,
        everything else decodes STRAIGHT into the destination slab
        through the native entry, with no intermediate dense buffer."""
        if not 0 <= lo <= hi <= self.n_variants:
            raise ValueError(
                f"variant range [{lo}, {hi}) out of bounds for a "
                f"{self.n_variants}-variant store"
            )
        for i, rec in self.manifest.chunks_for_range(lo, hi):
            a, b = max(lo, rec.start), min(hi, rec.stop)
            dst = col_off + (a - lo)
            cached = self.cache.get(("dense", i))
            if cached is None and self._ra is not None:
                cached = self._ra.consume(("dense", i))  # re-raises
            if cached is None and rec.codec != codecmod.RAW and (
                    a > rec.start or b < rec.stop):
                # A PARTIAL span of a cold compressed chunk: the
                # decode always inflates the whole payload, so decoding
                # straight to the slab here would re-pay the full
                # inflate for every covering block (2x+ whenever the
                # block grid is finer than the chunk grid). Decode once
                # into the cache and block-copy instead — the
                # zero-intermediate path is reserved for spans that
                # cover the chunk, and for raw chunks (whose partial
                # unpack reads only the span's bytes off the mmap).
                cached = self._decode_chunk(i)
            if cached is not None:
                np.copyto(out[:, dst:dst + (b - a)],
                          cached[:, a - rec.start:b - rec.start])
                continue
            with telemetry.span("store.chunk_read"):
                self._decode_span_into(i, a - rec.start, b - rec.start,
                                       out, dst)

    # -- streaming transports ----------------------------------------------

    def _grid(self, block_variants: int):
        """(idx, lo, hi, contig) for every block of the store's grid:
        per-contig-segment, restarting at each run boundary (the same
        geometry VCF/PLINK streams produce, so contigs stay exact)."""
        bounds = self.manifest.segment_bounds()
        runs = self.manifest.contig_runs
        idx = 0
        for s in range(len(bounds) - 1):
            contig = runs[s][0]
            for lo in range(bounds[s], bounds[s + 1], block_variants):
                hi = min(lo + block_variants, bounds[s + 1])
                yield idx, lo, hi, contig
                idx += 1

    def _meta(self, idx, lo, hi, contig) -> BlockMeta:
        pos = self.positions
        return BlockMeta(idx, lo, hi, contig,
                         pos[lo:hi] if pos is not None else None)

    def block_spans(self, block_variants: int, start_variant: int = 0):
        """(lo, hi, meta) for every dense-grid block — the decode-free
        twin of :meth:`blocks` that lets a caller owning the
        destination buffers (the prefetch staging ring) drive
        :meth:`decode_range_into` itself. Same grid, same resume
        semantics, same readahead scheduling."""
        for idx, lo, hi, contig in self._grid(block_variants):
            if lo < start_variant:
                continue
            covering = self.manifest.chunks_for_range(lo, hi)
            if covering:
                self._schedule_ahead(covering[-1][0])
            yield lo, hi, self._meta(idx, lo, hi, contig)

    def blocks(self, block_variants: int, start_variant: int = 0):
        """Dense blocks at any width; resume skips blocks starting
        before the cursor (ceil-align for mid-block cursors, exact for
        self-produced stops — the contract every geometry here keeps)."""
        for lo, hi, meta in self.block_spans(block_variants, start_variant):
            yield self.read_range(lo, hi), meta

    def packed_views(self, block_variants: int, start_variant: int = 0):
        """``(bytes, meta, view)``: 2-bit packed blocks for the packed
        transport. A view (``view`` True, no copy) when a block falls
        inside one chunk on the byte grid (the common case: bv dividing
        chunk_variants): of the verified mmap for a raw-codec chunk, of
        the cached inflated payload for a compressed one; re-packed from
        the dense decode otherwise (``view`` False) — same bytes
        semantics every way (tail pad codes are MISSING, free to every
        gram piece)."""
        if block_variants % bitpack.VARIANTS_PER_BYTE:
            raise ValueError(
                f"packed_blocks needs block_variants divisible by "
                f"{bitpack.VARIANTS_PER_BYTE}, got {block_variants}"
            )
        vpb = bitpack.VARIANTS_PER_BYTE
        for idx, lo, hi, contig in self._grid(block_variants):
            if lo < start_variant:
                continue
            covering = self.manifest.chunks_for_range(lo, hi)
            if covering:
                self._schedule_ahead(covering[-1][0], packed=True)
            if len(covering) == 1 and (lo - covering[0][1].start) % vpb == 0:
                i, rec = covering[0]
                if self._ra is not None:
                    warmed = self._ra.consume(("packed", i))  # re-raises
                    raw = (warmed if warmed is not None
                           else self._payload(i))
                else:
                    raw = self._payload(i)
                b0 = (lo - rec.start) // vpb
                b1 = bitpack.packed_width(hi - rec.start)
                yield raw[:, b0:b1], self._meta(idx, lo, hi, contig), True
            else:
                yield (bitpack.pack_dosages(self.read_range(lo, hi)),
                       self._meta(idx, lo, hi, contig), False)

    def packed_blocks(self, block_variants: int, start_variant: int = 0):
        """2-bit packed blocks, each a contiguous array the caller owns
        (:meth:`packed_views` with its views copied)."""
        for pblock, meta, _ in self.packed_views(block_variants,
                                                 start_variant):
            yield np.ascontiguousarray(pblock), meta

    # -- range queries (the catalog's partitioner surface) -----------------

    def variant_range(self, lo: int, hi: int) -> "StoreRangeSource":
        """A GenotypeSource over global variants [lo, hi) — arbitrary
        bounds, chunk- and block-grid independent."""
        return StoreRangeSource(self, lo, hi)

    def contig_source(self, contig: str) -> "StoreRangeSource":
        lo, hi = self.manifest.contig_span(contig)
        return StoreRangeSource(self, lo, hi)

    def position_span(self, contig: str, start: int, end: int) -> tuple[int, int]:
        """Global variant range covering positions [start, end) on
        ``contig`` — the reference's ``searchVariants`` range semantics,
        answered from the catalog + position index without touching a
        single chunk. Empty span when nothing matches."""
        lo, hi = self.manifest.contig_span(contig)
        if hi <= lo:
            return 0, 0
        pos = self.positions
        if pos is None:
            raise ValueError(
                "this store was compacted from a source without "
                "positions — position-range queries need them; "
                "variant_range/contig_source still work"
            )
        seg = pos[lo:hi]
        a = lo + int(np.searchsorted(seg, start, side="left"))
        b = lo + int(np.searchsorted(seg, end, side="left"))
        return a, b

    def restrict(self, references) -> object:
        """The ``--references CONTIG:START:END`` filter over the store:
        one range source per reference, chained in order — the catalog
        analog of the reference fork's genomic-range partitioners."""
        from spark_examples_tpu_torch.ingest.source import ChainSource, EmptyShare

        parts = []
        for ref in references:
            lo, hi = self.position_span(ref.contig, ref.start, ref.end)
            if hi > lo:
                parts.append(StoreRangeSource(self, lo, hi))
        if not parts:
            return EmptyShare(self)
        if len(parts) == 1:
            return parts[0]
        return ChainSource(parts)


class StoreRangeSource:
    """A contiguous global-variant window [lo, hi) of a store, with
    LOCAL indexing — the unit a range query returns. Unlike
    ``WindowSource`` it accepts arbitrary (unaligned) bounds: the store
    decodes at chunk granularity anyway, so re-gridding from ``lo`` is
    free. Blocks still never span a contig run."""

    def __init__(self, store: StoreSource, lo: int, hi: int):
        if not 0 <= lo <= hi <= store.n_variants:
            raise ValueError(
                f"range [{lo}, {hi}) out of bounds for a "
                f"{store.n_variants}-variant store"
            )
        self.store = store
        self.lo = lo
        self.hi = hi

    @property
    def n_samples(self) -> int:
        return self.store.n_samples

    @property
    def n_variants(self) -> int:
        return self.hi - self.lo

    def close(self) -> None:
        self.store.close()

    @property
    def sample_ids(self) -> list[str]:
        return self.store.sample_ids

    @property
    def exact_n_variants(self) -> bool:
        bounds = self.store.manifest.segment_bounds()
        inner = [b for b in bounds if self.lo < b < self.hi]
        return not inner

    def _grid(self, block_variants: int):
        """(idx, lo, hi, contig) over the window's own block grid
        (GLOBAL lo/hi, never spanning a contig run) — shared by
        :meth:`blocks` and :meth:`block_spans`."""
        bounds = self.store.manifest.segment_bounds()
        runs = self.store.manifest.contig_runs
        idx = 0
        for s in range(len(bounds) - 1):
            seg_lo = max(bounds[s], self.lo)
            seg_hi = min(bounds[s + 1], self.hi)
            if seg_hi <= seg_lo:
                continue
            for lo in range(seg_lo, seg_hi, block_variants):
                hi = min(lo + block_variants, seg_hi)
                yield idx, lo, hi, runs[s][0]
                idx += 1

    def blocks(self, block_variants: int, start_variant: int = 0):
        for lo, hi, meta in self.block_spans(block_variants, start_variant):
            yield self.store.read_range(self.lo + lo, self.lo + hi), meta

    def block_spans(self, block_variants: int, start_variant: int = 0):
        """The column-window read path: (lo, hi, meta) in the window's
        LOCAL coordinates, the decode-free twin of :meth:`blocks` that
        lets a caller owning destination buffers (the prefetch staging
        ring) drive :meth:`decode_range_into` itself, with no
        intermediate dense block and no post-decode slicing. Same grid, same resume semantics, same readahead scheduling as
        the full-store span path."""
        for idx, lo, hi, contig in self._grid(block_variants):
            local_lo = lo - self.lo
            if local_lo < start_variant:
                continue
            covering = self.store.manifest.chunks_for_range(lo, hi)
            if covering:
                self.store._schedule_ahead(covering[-1][0])
            meta = self.store._meta(idx, lo, hi, contig)
            yield local_lo, hi - self.lo, _dc_replace(
                meta, start=local_lo, stop=hi - self.lo,
            )

    def decode_range_into(self, lo: int, hi: int, out: np.ndarray,
                          col_off: int = 0) -> None:
        """Decode LOCAL window variants [lo, hi) into ``out`` — the
        window offset applied, then straight through the store's
        decode-to-slab entry."""
        if not 0 <= lo <= hi <= self.n_variants:
            raise ValueError(
                f"variant range [{lo}, {hi}) out of bounds for a "
                f"{self.n_variants}-variant window"
            )
        self.store.decode_range_into(self.lo + lo, self.lo + hi, out,
                                     col_off)
