"""Chunk payload codecs: entropy coding between the 2-bit pack and disk.

Genotype dosages are low-entropy (long runs of homozygous-reference
codes), so a per-chunk deflate pass shrinks the 2-bit payload further.
The content address stays the sha256 of the *stored* bytes, so dedupe,
quarantine, replica heal and ``store heal`` work unchanged on
compressed chunks.

Codecs (per chunk, recorded in the manifest's v3 rows), the JAX
package's ``store/codec.py`` byte for byte:

- ``raw``  — the stored bytes are the packed payload (v1/v2 stores and
  ``--store-codec raw``); reads stay zero-copy.
- ``zlib`` — per-chunk deflate at a fixed level, window, memory level
  and strategy: compression must be byte-deterministic so compaction at
  any worker count, re-compaction and origin healing reproduce the same
  stored bytes. With ``--store-codec zlib-dict`` a preset dictionary,
  trained from the first chunk of each contig, is shared by that
  contig's chunks and stored as ``dicts/<sha256>.zdict``.

Decoding (:func:`decode_into`) is one GIL-released native call from
the stored bytes to dense dosages in the caller's buffer
(``native/codec.cpp::store_decode_chunk``: inflate + 2-bit unpack), and
Python's ``zlib`` with the numpy unpack where the library is missing or
stale: bit-identical, slower, and loud (one ``RuntimeWarning`` and the
``store.codec.fallback`` counter). Corrupt stored bytes that get past a
disabled verify raise :class:`StoreDecodeError`, which the reader
handles like a digest mismatch (heal, else quarantine).
"""

from __future__ import annotations

import os
import threading
import warnings
import zlib

import numpy as np

from spark_examples_tpu_torch import native
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.config import STORE_CODEC_SPECS
from spark_examples_tpu_torch.ingest import bitpack

RAW = "raw"
ZLIB = "zlib"
#: Codecs a chunk record may name; a manifest naming another is refused
#: at load time (store/manifest.py).
CODECS = (RAW, ZLIB)
# Codec ids of the native decode entry.
CODEC_IDS = {RAW: 0, ZLIB: 1}
#: --store-codec spellings ("zlib-dict" = zlib + per-contig dictionary).
SPECS = STORE_CODEC_SPECS
DEFAULT_SPEC = ZLIB

# The deflate parameters are part of the codec's identity: stored bytes
# must be reproducible bit for bit by a later re-compaction.
ZLIB_LEVEL = 6
_ZLIB_WBITS = 15
_ZLIB_MEMLEVEL = 8
_ZLIB_STRATEGY = zlib.Z_DEFAULT_STRATEGY

# zlib's window is 32 KiB: a longer preset dictionary is ignored past it.
DICT_MAX_BYTES = 32768
DICT_DIR = "dicts"


class StoreDecodeError(ValueError):
    """Stored chunk bytes that cannot be decoded (inflate failure or a
    size that contradicts the catalog). The reader treats it exactly
    like a digest mismatch."""


def parse_spec(spec: str) -> tuple[str, bool]:
    """``--store-codec`` spelling -> (base codec, train per-contig
    dictionary)."""
    if spec == "zlib-dict":
        return ZLIB, True
    if spec in CODECS:
        return spec, False
    raise ValueError(
        f"bad ingest config: store_codec={spec!r} — expected one of "
        f"{' | '.join(SPECS)} (raw = no compression, zlib = per-chunk "
        "deflate, zlib-dict = deflate with a per-contig dictionary "
        "trained during compaction)"
    )


def train_dict(raw: bytes) -> bytes:
    """The preset dictionary of a contig: the trailing 32 KiB of its
    first chunk's packed payload (deflate favours matches near the
    dictionary's end). A pure function of the bytes, so a re-compaction
    or an origin heal derives the same dictionary."""
    return bytes(raw[-DICT_MAX_BYTES:])


def dict_path(root: str, digest: str) -> str:
    return os.path.join(root, DICT_DIR, f"{digest}.zdict")


def compress(codec: str, raw: bytes, zdict: bytes | None = None) -> bytes:
    """Packed payload -> stored bytes (identity for ``raw``)."""
    if codec == RAW:
        return raw
    if codec == ZLIB:
        args = (ZLIB_LEVEL, zlib.DEFLATED, _ZLIB_WBITS, _ZLIB_MEMLEVEL,
                _ZLIB_STRATEGY)
        c = zlib.compressobj(*args, zdict) if zdict else \
            zlib.compressobj(*args)
        return c.compress(raw) + c.flush()
    raise ValueError(f"unknown store codec {codec!r}")


def decompress(codec: str, stored, raw_size: int,
               zdict: bytes | None = None) -> bytes:
    """Stored bytes -> packed payload, size-checked against the
    catalog."""
    if codec == RAW:
        data = bytes(stored)
        if len(data) != raw_size:
            raise StoreDecodeError(
                f"raw chunk payload is {len(data)} bytes, catalog says "
                f"{raw_size}"
            )
        return data
    if codec == ZLIB:
        d = (zlib.decompressobj(_ZLIB_WBITS, zdict=zdict) if zdict
             else zlib.decompressobj(_ZLIB_WBITS))
        try:
            out = d.decompress(bytes(stored), raw_size + 1)
            out += d.flush()
        except zlib.error as e:
            raise StoreDecodeError(
                f"zlib inflate failed ({e}) — stored bytes are not a "
                "valid deflate stream for this chunk"
            ) from None
        if len(out) != raw_size or not d.eof:
            raise StoreDecodeError(
                f"zlib chunk decompressed to {len(out)} bytes "
                f"(eof={d.eof}), catalog says {raw_size}"
            )
        return out
    raise ValueError(f"unknown store codec {codec!r}")


_fallback_lock = threading.Lock()
_fallback_warned = False


def _note_fallback() -> None:
    """The Python decode was selected because the native entry is
    unavailable: count ``store.codec.fallback`` once per process (a
    selection flag, not a rate) and warn once, except under
    ``SPARK_TPU_NO_NATIVE``, where the fallback is asked for."""
    global _fallback_warned
    with _fallback_lock:
        # Check-then-count under the lock: the readahead workers' first
        # decodes arrive here together.
        if telemetry.counter_value("store.codec.fallback") == 0:
            telemetry.count("store.codec.fallback")
        if os.environ.get("SPARK_TPU_NO_NATIVE") or _fallback_warned:
            return
        _fallback_warned = True
    warnings.warn(
        "store: native decode-to-slab entry (store_decode_chunk) is "
        "unavailable — a stale native build or no g++; store reads run "
        "the pure-Python decode path (bit-identical, measurably slower). "
        f"Rebuild the native library to restore the fast path "
        f"({native.build_error or 'no build error recorded'}).",
        RuntimeWarning, stacklevel=3,
    )


def native_decode_available() -> bool:
    return native.has_store_decode()


_NATIVE_ERRORS = {
    1: "native decode: unknown codec id",
    2: "native decode: zlib inflate failed — stored bytes are not a "
       "valid deflate stream for this chunk",
    3: "native decode: decompressed size contradicts the catalog "
       "geometry",
    4: "native decode: payload buffer allocation failed",
}


def decode_into(stored, codec: str, zdict: bytes | None, n: int,
                w_bytes: int, v0: int, v1: int, out: np.ndarray,
                col_off: int = 0) -> None:
    """Decode variants ``[v0, v1)`` of one stored chunk into
    ``out[:, col_off : col_off + (v1 - v0)]``.

    ``stored`` is the chunk file's bytes (the verified mmap); ``n`` x
    ``w_bytes`` is the packed payload's geometry from the catalog;
    ``out`` is C-contiguous int8 (a decode-cache entry, a ``read_range``
    result or a feed slab). Native when available, Python otherwise,
    bit-identical either way. Raises :class:`StoreDecodeError` on
    undecodable bytes."""
    if codec == RAW and len(stored) != n * w_bytes:
        raise StoreDecodeError(
            f"raw chunk payload is {len(stored)} bytes, catalog says "
            f"{n * w_bytes}"
        )
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown store codec {codec!r}")
    rc = native.store_decode_chunk(stored, CODEC_IDS[codec], zdict, n,
                                   w_bytes, v0, v1, out, col_off)
    if rc is None:
        _note_fallback()
        _decode_into_py(stored, codec, zdict, n, w_bytes, v0, v1, out,
                        col_off)
    elif rc:
        raise StoreDecodeError(_NATIVE_ERRORS.get(
            rc, f"native decode failed (rc={rc})"))


def _decode_into_py(stored, codec, zdict, n, w_bytes, v0, v1, out,
                    col_off) -> None:
    """The Python decode: a raw chunk unpacks only the bytes covering
    the span."""
    if codec == RAW:
        payload = np.asarray(stored, np.uint8).reshape(n, w_bytes)
    else:
        payload = np.frombuffer(
            decompress(codec, stored, n * w_bytes, zdict),
            np.uint8).reshape(n, w_bytes)
    vpb = bitpack.VARIANTS_PER_BYTE
    b0, b1 = v0 // vpb, -(-v1 // vpb)
    dense = bitpack.unpack_dosages_np(payload[:, b0:b1])
    lo = v0 - b0 * vpb
    out[:, col_off:col_off + (v1 - v0)] = dense[:, lo:lo + (v1 - v0)]
