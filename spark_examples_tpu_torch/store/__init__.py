"""Content-addressed genotype block store — the ingest-once catalog.

The reference fork's answer to "parse once, query forever" was a
BigQuery variant table fronted by genomic-range partitioners; every
job after the initial load read columnar slices, never the source
files. This package (the JAX package's ``store/``, the same files on
disk byte for byte) is its successor: ``compact`` streams
any :class:`~spark_examples_tpu_torch.ingest.source.GenotypeSource` ONCE
into 2-bit-packed chunk files whose names ARE their sha256 content
digests, plus a JSON manifest (the catalog: schema version, sample
ids, per-chunk variant/contig/position index, digests). ``open_store``
returns a :class:`~spark_examples_tpu_torch.store.reader.StoreSource` that
drops into every job surface unchanged — mmap zero-copy reads, a
bounded host-RAM decode cache, contig/position range queries, resume
cursors, and read-time digest verification with corrupt-chunk
quarantine (provable under the ``store.read`` fault site).
"""

from spark_examples_tpu_torch.store.cache import DecodeCache  # noqa: F401
from spark_examples_tpu_torch.store.codec import (  # noqa: F401
    StoreDecodeError,
)
# NOTE: the heal FUNCTION stays addressed as store.heal.heal — binding
# it here would shadow the submodule under the same attribute name.
from spark_examples_tpu_torch.store.heal import (  # noqa: F401
    HealError,
    heal_chunk,
    origin_from_ingest,
    recover_dict,
)
from spark_examples_tpu_torch.store.manifest import (  # noqa: F401
    STORE_SCHEMA_VERSION,
    ChunkRecord,
    StoreCorruptError,
    StoreFormatError,
    StoreManifest,
)
from spark_examples_tpu_torch.store.reader import (  # noqa: F401
    StoreRangeSource,
    StoreSource,
    open_store,
)
from spark_examples_tpu_torch.store.writer import compact  # noqa: F401
