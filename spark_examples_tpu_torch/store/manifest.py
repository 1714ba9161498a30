"""The store catalog: one JSON manifest describing every chunk.

Which variants exist, in what order, on which contig, at which
positions, and (chunk files being content-addressed) exactly which bytes
hold them. The compaction writer writes it last (tmp + rename), so a
store either has a complete manifest or does not exist.

Layout on disk (the JAX package's ``store/manifest.py``, byte for
byte)::

    <store>/
      manifest.json        the catalog (this module)
      chunks/<sha256>.bin  stored chunk bytes (raw 2-bit rows or deflate)
      dicts/<sha256>.zdict per-contig preset dictionaries (zlib-dict)
      positions.npy        optional per-variant int64 positions
      quarantine.json      reader-appended record of corrupt chunks

Every way a manifest can be unusable (missing, truncated, pre-
versioning, from a newer build, a required field absent, an unknown
codec) raises a :class:`StoreFormatError` naming the cause.
"""

from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass, field

from spark_examples_tpu_torch.core.sidecar import load_versioned_sidecar
from spark_examples_tpu_torch.ingest import bitpack

# Bump when a field is added/renamed/re-semanticized. Version 2 added
# the optional ``origin`` record (how the store was compacted — the
# self-healing recipe); version-1 manifests load fine with origin=None.
# Version 3 added per-chunk payload codecs (store/codec.py): chunk
# rows grew codec / raw_size / stored_size / dict_digest columns, and
# the content address became the sha256 of the STORED (possibly
# compressed) bytes — which for v1/v2 rows (codec "raw") is the same
# bytes it always was, so older stores read back untouched. load()
# refuses files from NEWER builds, files without a version, and chunk
# rows naming a codec this build does not know, rather than guessing.
STORE_SCHEMA_VERSION = 3

MANIFEST_NAME = "manifest.json"
CHUNK_DIR = "chunks"
POSITIONS_NAME = "positions.npy"
QUARANTINE_NAME = "quarantine.json"

_REQUIRED = ("schema_version", "n_samples", "n_variants",
             "chunk_variants", "sample_hash", "chunks")


class StoreFormatError(ValueError):
    """A store/manifest that cannot be safely interpreted: missing or
    truncated manifest, pre-versioning or future schema, or a required
    field absent — always with the offending cause named."""


class StoreCorruptError(ValueError):
    """A chunk whose bytes no longer match their content address (or a
    truncated chunk file). Carries the resume cursor (``.cursor``, the
    chunk's first global variant) so a job can restart there once the
    chunk is recovered. A ValueError on purpose: the retry
    layer (ingest/resilient.py) treats it as damage, not weather — it
    is never retried and never silently skipped."""

    def __init__(self, msg: str, cursor: int = 0):
        super().__init__(msg)
        self.cursor = cursor


@dataclass(frozen=True)
class ChunkRecord:
    """One chunk's catalog row: where its variants sit in the global
    order (``[start, stop)``), which contig they belong to (chunks never
    span one), the position range they cover (-1 when the source carried
    none), the sha256 content address of its STORED bytes, and how the
    stored bytes encode the packed payload: ``codec`` (store/codec.py),
    ``raw_size`` (packed payload bytes — redundant with the geometry,
    recorded as a decode cross-check), ``stored_size`` (on-disk bytes;
    the truncation check compression took away from the mmap shape),
    and ``dict_digest`` (the shared preset dictionary, when one was
    trained). v1/v2 rows load as codec "raw" with sizes derived from
    the geometry — stored bytes == packed payload, as always."""

    start: int
    stop: int
    contig: str | None
    digest: str
    pos_lo: int = -1
    pos_hi: int = -1
    codec: str = "raw"
    raw_size: int = -1       # -1 = derive from geometry (v1/v2 rows)
    stored_size: int = -1    # -1 = raw_size (uncompressed)
    dict_digest: str | None = None

    @property
    def width(self) -> int:
        return self.stop - self.start

    def n_bytes(self, n_samples: int) -> int:
        """Packed payload bytes (the decoded-from-disk size)."""
        return n_samples * bitpack.packed_width(self.width)

    def payload_size(self, n_samples: int) -> int:
        return self.raw_size if self.raw_size >= 0 else self.n_bytes(n_samples)

    def disk_size(self, n_samples: int) -> int:
        """Expected on-disk size of the stored chunk file."""
        if self.stored_size >= 0:
            return self.stored_size
        return self.payload_size(n_samples)

    def filename(self) -> str:
        return os.path.join(CHUNK_DIR, f"{self.digest}.bin")


@dataclass
class StoreManifest:
    n_samples: int
    n_variants: int
    chunk_variants: int
    sample_hash: str
    chunks: list[ChunkRecord]
    sample_ids: list[str] | None = None
    has_positions: bool = False
    positions_digest: str | None = None
    # How this store was compacted (an IngestConfig-shaped dict — see
    # store/heal.py): with it, a corrupt chunk can be re-compacted from
    # the origin source IN PLACE (content addressing makes the repair
    # verifiable: the rebuilt bytes must hash to the chunk's name).
    # None (and every version-1 manifest) means "no healing recipe".
    origin: dict | None = None
    schema_version: int = STORE_SCHEMA_VERSION
    # Derived indexes (built once in __post_init__, not serialized).
    _starts: list[int] = field(default_factory=list, repr=False)
    _runs: list[tuple[str | None, int]] = field(default_factory=list,
                                                repr=False)

    def __post_init__(self):
        self._starts = [c.start for c in self.chunks]
        self._runs = []
        for c in self.chunks:
            if not self._runs or self._runs[-1][0] != c.contig:
                self._runs.append((c.contig, c.start))

    # -- catalog queries ---------------------------------------------------

    @property
    def contig_runs(self) -> list[tuple[str | None, int]]:
        """[(contig, first_variant), ...] in stream order — run i spans
        [start_i, start_{i+1})."""
        return list(self._runs)

    def segment_bounds(self) -> list[int]:
        """Variant boundaries dense blocks must not cross (the "blocks
        never span a contig" contract every file source keeps)."""
        return [s for _c, s in self._runs] + [self.n_variants]

    def contig_span(self, contig: str) -> tuple[int, int]:
        """Global variant range [lo, hi) of ``contig`` (empty (0, 0)
        when the store has no such contig — the same "filter matched
        nothing" semantics as the VCF region filter)."""
        bounds = self.segment_bounds()
        for i, (c, s) in enumerate(self._runs):
            if c == contig:
                return s, bounds[i + 1]
        return 0, 0

    def chunks_for_range(self, lo: int, hi: int) -> list[tuple[int, ChunkRecord]]:
        """(index, record) of every chunk overlapping variants [lo, hi),
        by bisection over the catalog — a range query touches only the
        chunks that hold it, never the whole store."""
        if hi <= lo:
            return []
        i = bisect.bisect_right(self._starts, lo) - 1
        i = max(i, 0)
        out = []
        while i < len(self.chunks) and self.chunks[i].start < hi:
            if self.chunks[i].stop > lo:
                out.append((i, self.chunks[i]))
            i += 1
        return out

    # -- (de)serialization -------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "n_samples": self.n_samples,
            "n_variants": self.n_variants,
            "chunk_variants": self.chunk_variants,
            "sample_hash": self.sample_hash,
            "sample_ids": self.sample_ids,
            "has_positions": self.has_positions,
            "positions_digest": self.positions_digest,
            "origin": self.origin,
            "chunks": [
                [c.start, c.stop, c.contig, c.digest, c.pos_lo, c.pos_hi,
                 c.codec, c.raw_size, c.stored_size, c.dict_digest]
                for c in self.chunks
            ],
        }

    def save(self, root: str) -> None:
        """Atomic write — the manifest landing IS the store's commit."""
        path = os.path.join(root, MANIFEST_NAME)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, root: str) -> "StoreManifest":
        path = os.path.join(root, MANIFEST_NAME)
        raw = load_versioned_sidecar(
            path,
            current_version=STORE_SCHEMA_VERSION,
            required=_REQUIRED,
            error_cls=StoreFormatError,
            noun="store manifest",
            missing_msg=(
                f"{root!r} is not a dataset store: no {MANIFEST_NAME} "
                "(compact one with `ingest --output-path <dir>`; a "
                "missing manifest after a crash means the compaction "
                "never committed — re-run it)"
            ),
            repair="re-run the compaction",
        )
        version = raw["schema_version"]
        try:
            chunks = []
            for row in raw["chunks"]:
                if len(row) == 6:  # v1/v2 rows: stored bytes == payload
                    s, t, c, d, pl, ph = row
                    chunks.append(ChunkRecord(int(s), int(t), c, d,
                                              int(pl), int(ph)))
                else:
                    s, t, c, d, pl, ph, codec, rs, ss, dd = row
                    chunks.append(ChunkRecord(
                        int(s), int(t), c, d, int(pl), int(ph),
                        codec=str(codec), raw_size=int(rs),
                        stored_size=int(ss), dict_digest=dd,
                    ))
        except (TypeError, ValueError) as e:
            raise StoreFormatError(
                f"store manifest {path!r}: malformed chunk record ({e})"
            ) from None
        # Unknown-codec rejection belongs HERE, not at first read: a
        # store written by a newer build with a codec this build cannot
        # inflate must fail like a future schema — loudly, up front —
        # never as a mid-stream decode error at chunk 40 000.
        from spark_examples_tpu_torch.store.codec import CODECS

        for i, c in enumerate(chunks):
            if c.codec not in CODECS:
                raise StoreFormatError(
                    f"store manifest {path!r}: chunk {i} uses unknown "
                    f"codec {c.codec!r} (this build decodes "
                    f"{' / '.join(CODECS)}) — the store was written by "
                    "a newer build; upgrade, or re-compact with a "
                    "supported --store-codec"
                )
        return cls(
            n_samples=int(raw["n_samples"]),
            n_variants=int(raw["n_variants"]),
            chunk_variants=int(raw["chunk_variants"]),
            sample_hash=raw["sample_hash"],
            chunks=chunks,
            sample_ids=raw.get("sample_ids"),
            has_positions=bool(raw.get("has_positions", False)),
            positions_digest=raw.get("positions_digest"),
            origin=raw.get("origin"),
            schema_version=version,
        )
