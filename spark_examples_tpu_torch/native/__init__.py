"""The native host codec: ``codec.cpp`` built with g++ at first use and
loaded with ctypes.

The library holds the host loops that feed the device (2-bit pack and
unpack, the store's chunk decode, the VCF GT parse), each one
GIL-released C call. It only speeds things up: every entry has a Python
fallback in its caller that gives byte-identical results, and the tests
pin native == Python on the same inputs.

Loading policy (the JAX package's ``native/__init__.py``):

- The library is built into ``spark_examples_tpu_torch/_build/`` (ignored
  by git), never beside the source. Its file name carries a tag of the
  host's ISA (the flags ``-march=native`` resolves to, so a library built
  on a wider CPU is never loaded on a narrower one) and of the source's
  hash (a cached build of an older source never loads).
- A failed build, a library that does not load or one that lacks a
  mandatory entry leaves :func:`load` returning None, and every caller
  takes its Python path; :data:`build_error` says why. The store's decode
  degrades loudly (one ``RuntimeWarning`` and the
  ``store.codec.fallback`` counter, ``store/codec.py``).
- ``SPARK_TPU_NO_NATIVE=1`` forces the Python paths (the tests pin
  native == Python with it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "codec.cpp"
BUILD_DIR = _DIR.parent / "_build"
# The five entries the port calls; a library missing one of the first
# four is not used at all, one missing store_decode_chunk (a stale build)
# only loses the store's fast decode.
ENTRIES = ("pack_dosages_i8", "unpack_dosages_u8", "vcf_parse_gt",
           "vcf_parse_block", "store_decode_chunk")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: Why the library is unavailable (compiler output or load error), or
#: None.
build_error: str | None = None


def _host_tag() -> str:
    """ISA fingerprint + source hash: the cache key of a built library."""
    src = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:8]
    try:
        out = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            capture_output=True, timeout=30,
        ).stdout
    except (subprocess.SubprocessError, OSError):
        return f"portable-{src}"
    return f"{hashlib.sha1(out).hexdigest()[:12]}-{src}"


def library_path() -> Path:
    """Where this host's build of the library lives (or will)."""
    return BUILD_DIR / f"libsparkcodec-{_host_tag()}.so"


def _build(lib_path: Path, march_native: bool) -> bool:
    """Compile ``codec.cpp`` into ``lib_path``. ``-lz``: the store's
    decode inflates with the libz that Python's ``zlib`` wraps, so both
    paths accept the same streams. ``-Wl,--no-undefined`` fails the build
    instead of publishing a library that cannot load."""
    global build_error
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-Wl,--no-undefined",
           str(SOURCE), "-lz"]
    if march_native:
        cmd.insert(1, "-march=native")
    # One temporary per process: concurrent builds (test workers)
    # must not write into a path another process has just published.
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            build_error = (f"g++ exit {res.returncode}: "
                           f"{res.stderr.strip()[-2000:]}")
            return False
        os.replace(tmp, lib_path)  # atomic publish
        return True
    except (subprocess.SubprocessError, OSError) as e:
        build_error = f"g++ could not run: {e}"
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every entry; AttributeError when one of
    the four mandatory entries is missing."""
    i64 = ctypes.c_int64
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.pack_dosages_i8.argtypes = [i8p, i64, i64, u8p]
    lib.pack_dosages_i8.restype = ctypes.c_int
    lib.unpack_dosages_u8.argtypes = [u8p, i64, i64, i8p]
    lib.unpack_dosages_u8.restype = None
    lib.vcf_parse_gt.argtypes = [ctypes.c_char_p, i64, i64, i64, i8p, i64]
    lib.vcf_parse_gt.restype = i64
    lib.vcf_parse_block.argtypes = [
        ctypes.c_char_p, i64, i64, i64, i8p, i64p, i64p, i64p,
        ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.vcf_parse_block.restype = i64
    try:
        # Raw pointers: the caller hands an interior pointer (buffer base
        # + column offset) and a row stride, which ndpointer cannot say.
        lib.store_decode_chunk.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_int32, ctypes.c_char_p,
            i64, i64, i64, i64, i64, ctypes.c_void_p, i64,
        ]
        lib.store_decode_chunk.restype = ctypes.c_int
    except AttributeError:
        pass  # a stale build: has_store_decode() says so


def load() -> ctypes.CDLL | None:
    """The library, building it first if needed; None when unavailable
    (or under ``SPARK_TPU_NO_NATIVE``). Threads that ask while another
    builds wait for its result: the feed's producers and the store's
    readahead workers all reach here at a job's first block."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _load_locked()
            _tried = True
        return _lib


def _load_locked() -> ctypes.CDLL | None:
    global build_error
    if os.environ.get("SPARK_TPU_NO_NATIVE"):
        return None
    tag = _host_tag()
    path = BUILD_DIR / f"libsparkcodec-{tag}.so"
    native_isa = not tag.startswith("portable")
    # The tag hashes the source, so an existing file is current.
    if not path.exists() and not _build(path, native_isa):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        # A cached library that no longer loads: rebuild it once.
        path.unlink(missing_ok=True)
        if not _build(path, native_isa):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            build_error = f"built library does not load: {e}"
            return None
    try:
        _declare(lib)
    except AttributeError as e:
        build_error = f"library lacks a mandatory entry: {e}"
        return None
    return lib


def pack_dosages(g: np.ndarray) -> np.ndarray | None:
    """Native 2-bit pack of an (N, V) int8 matrix; None when the library
    is unavailable or ``g`` is not int8 (an int8 view of a wider type
    would wrap; the caller's Python path validates it). Raises on values
    outside [-1, 2]."""
    lib = load()
    if lib is None or g.dtype != np.int8:
        return None
    g = np.ascontiguousarray(g)
    n, v = g.shape
    out = np.empty((n, -(-v // 4)), np.uint8)
    if lib.pack_dosages_i8(g, n, v, out):
        raise ValueError(
            "dosage values out of 2-bit range [-1, 2] "
            "(pack_dosages is for genotype dosages only)"
        )
    return out


def unpack_dosages(packed: np.ndarray) -> np.ndarray | None:
    """Native (N, W) uint8 -> (N, 4 W) int8 unpack; None when
    unavailable."""
    lib = load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    n, w = packed.shape
    out = np.empty((n, 4 * w), np.int8)
    lib.unpack_dosages_u8(packed, n, w, out)
    return out


def vcf_parse_gt(line: bytes, gt_index: int, n_samples: int,
                 out: np.ndarray) -> bool:
    """Parse one VCF record's sample GT columns into ``out`` (int8,
    ``n_samples``). False when the library is unavailable or the record
    is short (the caller takes its Python parser)."""
    lib = load()
    if lib is None:
        return False
    return lib.vcf_parse_gt(line, len(line), 9, gt_index, out,
                            n_samples) == n_samples


def has_store_decode() -> bool:
    """Whether the loaded library exports the store's decode entry
    (False also when there is no library)."""
    lib = load()
    return lib is not None and hasattr(lib, "store_decode_chunk")


def store_decode_chunk(stored, codec_id: int, zdict: bytes | None, n: int,
                       w_bytes: int, v0: int, v1: int, out: np.ndarray,
                       col_off: int = 0) -> int | None:
    """Decode variants ``[v0, v1)`` of one stored chunk into
    ``out[:, col_off : col_off + (v1 - v0)]`` in one GIL-released call
    (inflate when compressed, then the 2-bit unpack, no intermediate
    buffers). ``stored``: any uint8 buffer of the chunk file's bytes;
    ``out``: writable C-contiguous int8. Returns the C return code (0 =
    ok), or None when the library or the entry is unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "store_decode_chunk"):
        return None
    if not isinstance(stored, np.ndarray):
        stored = np.frombuffer(stored, np.uint8)  # bytes, mmap
    stored = np.ascontiguousarray(stored, np.uint8)
    if (out.dtype != np.int8 or out.ndim != 2
            or not out.flags["C_CONTIGUOUS"]
            or not out.flags["WRITEABLE"]
            or not 0 <= col_off <= out.shape[1] - (v1 - v0)
            or out.shape[0] < n):
        raise ValueError(
            "store_decode_chunk needs a writable C-contiguous int8 "
            f"(>= {n}, >= {col_off + (v1 - v0)}) output, got "
            f"{out.dtype} {out.shape} col_off={col_off}"
        )
    return lib.store_decode_chunk(
        ctypes.c_void_p(stored.ctypes.data), stored.size,
        int(codec_id), zdict or None, len(zdict) if zdict else 0,
        n, w_bytes, v0, v1,
        ctypes.c_void_p(out.ctypes.data + col_off), out.strides[0],
    )


def vcf_parse_block(buf: bytes, n_samples: int):
    """Parse every VCF data line of ``buf`` in one GIL-released call:
    ``(dosages (r, n_samples) int8, positions (r,) int64, contigs,
    n_short)`` for the ``r`` accepted records, in file order, with the
    skip rules of ``ingest/vcf.py::parse_record_lines``. None when the
    library is unavailable or the buffer holds input the C parser punts
    on (a POS that is not an integer): the caller takes the Python
    parser, which raises the serial parse's error."""
    lib = load()
    if lib is None:
        return None
    # An accepted record spans at least n_samples + 9 bytes (its tabs),
    # so a shard of short junk lines cannot size a huge allocation; the
    # C side punts if the bound ever proves too small.
    max_records = min(buf.count(b"\n") + 1,
                      len(buf) // max(1, n_samples + 9) + 1)
    out = np.empty((max_records, n_samples), np.int8)
    pos = np.empty(max_records, np.int64)
    coff = np.empty(max_records, np.int64)
    clen = np.empty(max_records, np.int64)
    n_short = ctypes.c_int64(0)
    n_reject = ctypes.c_int64(0)
    r = lib.vcf_parse_block(
        buf, len(buf), n_samples, max_records, out, pos, coff, clen,
        ctypes.byref(n_short), ctypes.byref(n_reject),
    )
    if n_reject.value:
        return None
    contigs = [buf[o:o + w].decode()
               for o, w in zip(coff[:r].tolist(), clen[:r].tolist())]
    return out[:r], pos[:r], contigs, int(n_short.value)
