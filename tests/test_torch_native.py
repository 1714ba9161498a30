"""The port's native host codec (spark_examples_tpu_torch/native) on the
CPU: native == the port's Python paths byte for byte, and the port's
native == the JAX package's native on the same inputs, for the 2-bit
pack and unpack, the GT parse, the VCF block parse and the store's
chunk decode; where the library is built; the loud fallback of a stale
library; and the port's counterparts of the JAX package's native-only
cases (tests/test_native.py, tests/test_store_codec.py)."""

import os
import threading
import warnings

import numpy as np
import pytest

from spark_examples_tpu import native as jnative
from spark_examples_tpu.ingest.parallel import (
    _parse_vcf_range as j_parse_vcf_range,
)
from spark_examples_tpu.ingest.vcf import VcfSource as JVcfSource
from spark_examples_tpu_torch import native
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import IngestConfig
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest import parallel as tparallel
from spark_examples_tpu_torch.ingest.resilient import (
    RetryingSource,
    RetryPolicy,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ingest.vcf import VcfSource, _dosage, write_vcf
from spark_examples_tpu_torch.pipelines.runner import build_source
from spark_examples_tpu_torch.store import compact, open_store
from spark_examples_tpu_torch.store import codec as codecmod

from conftest import random_genotypes


@pytest.fixture
def lib():
    """The port's library; the cases that need it fail (not skip) when
    it did not build: g++ and zlib are part of the toolchain here."""
    got = native.load()
    assert got is not None, native.build_error
    return got


def _force_python(monkeypatch):
    """Pin the Python paths without a rebuild: stub the loader state."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def _materialize(source, bv):
    return np.concatenate([b for b, _ in source.blocks(bv)], axis=1)


def _py_pack(g):
    """The numpy reference of the 2-bit pack."""
    n, v = g.shape
    codes = np.where(g < 0, 3, g).astype(np.uint8)
    pad = -v % 4
    if pad:
        codes = np.concatenate([codes, np.full((n, pad), 3, np.uint8)],
                               axis=1)
    c = codes.reshape(n, -1, 4)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


# ------------------------------------------------------------- the build

def test_library_is_built_into_the_build_dir(lib):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    assert native.BUILD_DIR.parent.name == "spark_examples_tpu_torch"
    assert path.exists()
    assert not list(native.SOURCE.parent.glob("*.so"))
    for entry in native.ENTRIES:
        assert hasattr(lib, entry), entry


def test_concurrent_first_load_waits_for_the_build(monkeypatch, lib):
    """Threads asking while another loads get the library, not None (the
    feed's producers and readahead workers arrive together)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    got = []
    barrier = threading.Barrier(8)

    def ask():
        barrier.wait()
        got.append(native.load())

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is not None for g in got)


def test_no_native_switch_forces_the_python_paths(monkeypatch, tmp_path):
    """SPARK_TPU_NO_NATIVE=1: no library, reads stay right, the
    fallback is counted once and, being asked for, does not warn."""
    g = random_genotypes(np.random.default_rng(4), 12, 300)
    d = str(tmp_path / "s")
    compact(d, ArraySource(g), chunk_variants=64, codec="zlib")
    monkeypatch.setenv("SPARK_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(codecmod, "_fallback_warned", False)
    telemetry.reset()
    assert native.load() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        st = open_store(d)
        got = _materialize(st, 50)
        st.close()
    np.testing.assert_array_equal(got, g)
    assert telemetry.counter_value("store.codec.fallback") == 1.0
    np.testing.assert_array_equal(bitpack.pack_dosages(g), _py_pack(g))


# ------------------------------------------------------- pack and unpack

@pytest.mark.parametrize("v", [1, 3, 4, 7, 64, 257])
def test_pack_native_python_and_jax_native_agree(lib, v, monkeypatch):
    g = random_genotypes(np.random.default_rng(v), 11, v, missing_rate=0.2)
    got = native.pack_dosages(g)
    np.testing.assert_array_equal(got, _py_pack(g))
    np.testing.assert_array_equal(got, jnative.pack_dosages(g))
    np.testing.assert_array_equal(bitpack.pack_dosages(g), got)
    _force_python(monkeypatch)
    np.testing.assert_array_equal(bitpack.pack_dosages(g), got)


def test_pack_rejects_out_of_domain_and_declines_wide_dtypes(lib):
    for bad in ([[0, 3]], [[-2, 0]]):
        with pytest.raises(ValueError, match="2-bit range"):
            native.pack_dosages(np.array(bad, np.int8))
        with pytest.raises(ValueError, match="2-bit range"):
            bitpack.pack_dosages(np.array(bad, np.int8))
    # int32 must take the numpy path (which checks the wide domain), not
    # an int8 reinterpretation.
    assert native.pack_dosages(np.array([[0, 1]], np.int32)) is None
    with pytest.raises(ValueError, match="2-bit range"):
        bitpack.pack_dosages(np.array([[0, 300]], np.int32))


@pytest.mark.parametrize("v", [200, 257])
def test_unpack_native_python_and_jax_native_agree(lib, v, monkeypatch):
    g = random_genotypes(np.random.default_rng(9), 9, v, missing_rate=0.3)
    p = bitpack.pack_dosages(g)
    out = native.unpack_dosages(p)
    np.testing.assert_array_equal(out[:, :v], g)
    assert (out[:, v:] == -1).all()
    np.testing.assert_array_equal(out, jnative.unpack_dosages(p))
    _force_python(monkeypatch)
    np.testing.assert_array_equal(bitpack.unpack_dosages_np(p), out)


# ------------------------------------------------------------- GT parse

GT_CASES = [
    b"0/0", b"0/1", b"1/1", b"1/2", b"2/2", b"./.", b".",
    b"0|1", b"1|1", b"./1", b"1/.", b"0/0/1", b"1/1/1", b"", b"0",
]


def test_gt_parse_every_edge_case_matches_python_and_jax(lib):
    """One record with every GT edge case, extra FORMAT subfields and GT
    not first."""
    n = len(GT_CASES)
    samples = b"\t".join(b"9:" + gt + b":PASS" for gt in GT_CASES)
    line = b"chr1\t100\trs1\tA\tC\t.\tPASS\t.\tDP:GT:FT\t" + samples
    out = np.empty(n, np.int8)
    assert native.vcf_parse_gt(line, 1, n, out)
    want = [_dosage(gt.decode()) for gt in GT_CASES]
    np.testing.assert_array_equal(out, np.asarray(want, np.int8))
    jout = np.empty(n, np.int8)
    assert jnative.vcf_parse_gt(line, 1, n, jout)
    np.testing.assert_array_equal(out, jout)


def test_gt_subfields_shorter_than_format(lib):
    """FORMAT DP:GT with a bare '5' sample column: GT absent, missing."""
    line = b"chr1\t1\t.\tA\tC\t.\t.\t.\tDP:GT\t5\t7:0/1"
    out = np.empty(2, np.int8)
    assert native.vcf_parse_gt(line, 1, 2, out)
    np.testing.assert_array_equal(out, np.array([-1, 1], np.int8))


def test_gt_parse_short_record(lib):
    out = np.empty(5, np.int8)
    line = b"chr1\t1\t.\tA\tC\t.\t.\t.\tGT\t0/1\t1/1"
    assert not native.vcf_parse_gt(line, 0, 5, out)


def test_vcf_crlf_line_endings_both_parsers(lib, tmp_path, monkeypatch):
    g = random_genotypes(np.random.default_rng(5), 5, 40, missing_rate=0.2)
    lf, crlf = str(tmp_path / "lf.vcf"), str(tmp_path / "crlf.vcf")
    write_vcf(lf, g)
    with open(lf, "rb") as f:
        body = f.read().replace(b"\n", b"\r\n")
    with open(crlf, "wb") as f:
        f.write(body)
    np.testing.assert_array_equal(_materialize(VcfSource(crlf), 16), g)
    _force_python(monkeypatch)
    np.testing.assert_array_equal(_materialize(VcfSource(crlf), 16), g)


def test_truncated_vcf_warns_on_the_native_path(lib, tmp_path):
    g = random_genotypes(np.random.default_rng(6), 6, 10, missing_rate=0.0)
    path = str(tmp_path / "t.vcf")
    write_vcf(path, g)
    with open(path) as f:
        lines = f.read().splitlines()
    lines[-1] = "\t".join(lines[-1].split("\t")[:-3])
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.warns(RuntimeWarning, match="truncated or malformed"):
        out = _materialize(VcfSource(path), 4)
    np.testing.assert_array_equal(out, g[:, :9])


def test_vcf_source_native_python_and_jax_agree(lib, tmp_path,
                                                monkeypatch):
    g = random_genotypes(np.random.default_rng(7), 13, 300,
                         missing_rate=0.15)
    path = str(tmp_path / "c.vcf")
    write_vcf(path, g)
    got = _materialize(VcfSource(path), 77)
    np.testing.assert_array_equal(got, g)
    np.testing.assert_array_equal(
        got, np.concatenate([b for b, _ in JVcfSource(path).blocks(77)],
                            axis=1))
    _force_python(monkeypatch)
    np.testing.assert_array_equal(_materialize(VcfSource(path), 77), got)


# ------------------------------------------------------ VCF block parse

def _multi_contig_vcf(tmp_path):
    g = random_genotypes(np.random.default_rng(8), 9, 120,
                         missing_rate=0.1)
    path = str(tmp_path / "m.vcf")
    write_vcf(path, g[:, :70], contig="chr1", start_pos=100)
    with open(path, "a") as f:
        second = str(tmp_path / "second.vcf")
        write_vcf(second, g[:, 70:], contig="chr2", start_pos=5)
        with open(second) as s:
            f.writelines(x for x in s if not x.startswith("#"))
    return path, g


@pytest.mark.parametrize("in_range", [None, "chr1-tail"])
def test_block_parse_native_python_and_jax_agree(lib, tmp_path, in_range):
    path, g = _multi_contig_vcf(tmp_path)
    size = os.path.getsize(path)
    check = (None if in_range is None
             else (lambda c, p: c == "chr1" and p >= 140))
    got = tparallel._parse_vcf_range(path, 0, size, 9, check)
    with open(path, "rb") as f:
        py = tparallel._parse_vcf_range_py(f.read(), path, 9, check)
    jx = j_parse_vcf_range(path, 0, size, 9, check)
    assert [p[2] for p in got] == [p[2] for p in py] == [p[2] for p in jx]
    for a, b, c in zip(got, py, jx):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[0], c[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], c[1])
    if in_range is None:
        np.testing.assert_array_equal(
            np.concatenate([p[0] for p in got], axis=1), g)


def test_block_parse_punts_a_bad_pos_to_the_python_parser(lib):
    buf = b"chr1\tx12\t.\tA\tC\t.\t.\t.\tGT\t0/1\n"
    assert native.vcf_parse_block(buf, 1) is None
    with pytest.raises(ValueError):
        tparallel._parse_vcf_range_py(buf, "p.vcf", 1, None)


# ----------------------------------------------------------- store decode

@pytest.mark.parametrize("codec,with_dict", [("raw", False),
                                             ("zlib", False),
                                             ("zlib", True)])
@pytest.mark.parametrize("v0,v1", [(0, 400), (1, 399), (3, 5), (397, 400)])
def test_store_decode_native_python_and_jax_native_agree(
        lib, codec, with_dict, v0, v1, monkeypatch):
    g = random_genotypes(np.random.default_rng(11), 9, 400)
    raw = bitpack.pack_dosages(g).tobytes()
    zdict = codecmod.train_dict(raw[:150]) if with_dict else None
    stored = np.frombuffer(codecmod.compress(codec, raw, zdict), np.uint8)
    outs = []
    for _ in range(2):
        out = np.full((9, v1 - v0 + 4), 5, np.int8)
        codecmod.decode_into(stored, codec, zdict, 9, 100, v0, v1, out,
                             col_off=2)
        outs.append(out)
        _force_python(monkeypatch)
        monkeypatch.setattr(codecmod, "_fallback_warned", True)
    np.testing.assert_array_equal(outs[0][:, 2:2 + v1 - v0], g[:, v0:v1])
    np.testing.assert_array_equal(outs[0], outs[1])
    jout = np.full((9, v1 - v0 + 4), 5, np.int8)
    assert jnative.store_decode_chunk(
        stored, codecmod.CODEC_IDS[codec], zdict, 9, 100, v0, v1, jout,
        col_off=2) == 0
    np.testing.assert_array_equal(outs[0], jout)


@pytest.mark.parametrize("damage", ["flip", "short", "garbage"])
def test_native_decode_refuses_damaged_streams(lib, damage):
    raw = bitpack.pack_dosages(
        random_genotypes(np.random.default_rng(3), 16, 400)).tobytes()
    stored = bytearray(codecmod.compress("zlib", raw))
    if damage == "flip":
        stored[len(stored) // 2] ^= 0xFF
    elif damage == "short":
        stored = stored[:-4]
    else:
        stored = bytearray(np.random.default_rng(9).bytes(len(stored)))
    out = np.empty((16, 400), np.int8)
    with pytest.raises(codecmod.StoreDecodeError, match="native decode"):
        codecmod.decode_into(bytes(stored), "zlib", None, 16, 100, 0, 400,
                             out)


# ----- the JAX package's native-only store cases (test_store_codec.py)

@pytest.fixture
def zstore(tmp_path):
    cfg = IngestConfig(source="synthetic", n_samples=48, n_variants=2048,
                       seed=2)
    d = str(tmp_path / "z")
    compact(d, build_source(cfg, "cpu"), chunk_variants=512, codec="zlib")
    return d, _materialize(build_source(cfg, "cpu"), 512)


def test_readahead_decode_fault_on_native_dense_path(lib, zstore):
    """store.readahead.decode armed while the dense warms run the native
    decode over compressed chunks: the worker's error is held, re-raised
    at the consumer's cursor, and the retry boundary recovers
    bit-identically."""
    assert codecmod.native_decode_available()
    d, want = zstore
    errors0 = telemetry.counter_value("store.readahead.errors")
    with faults.armed(["store.readahead.decode:io_error:after=1:max=1"]):
        rs = RetryingSource(
            open_store(d, readahead_chunks=2),
            policy=RetryPolicy(max_retries=2, backoff_s=0.001),
            reopen=lambda: open_store(d, readahead_chunks=2))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = _materialize(rs, 64)
        rs.close()
    np.testing.assert_array_equal(got, want)
    assert telemetry.counter_value("store.readahead.errors") == errors0 + 1


def test_packaged_library_exports_decode_symbol(lib):
    """A built library must export the decode entry: a stale one missing
    it would run the slow path unnoticed."""
    assert native.has_store_decode()
    assert codecmod.native_decode_available()


def test_stale_binary_selects_python_fallback_loudly(lib, tmp_path,
                                                     monkeypatch):
    """A library without the decode entry: reads stay right through the
    Python path, ``store.codec.fallback`` counts once per process, and
    one warning fires."""
    g = random_genotypes(np.random.default_rng(12), 16, 200)
    d = str(tmp_path / "s")
    compact(d, ArraySource(g), chunk_variants=32, codec="zlib")

    class _Stale:  # an old build: every entry except the decode
        def __getattr__(self, name):
            if name == "store_decode_chunk":
                raise AttributeError(name)
            return getattr(lib, name)

    monkeypatch.setattr(native, "_lib", _Stale())
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(codecmod, "_fallback_warned", False)
    telemetry.reset()
    assert not native.has_store_decode()
    with pytest.warns(RuntimeWarning, match="decode-to-slab"):
        st = open_store(d)
        got = _materialize(st, 32)
        st.close()
    np.testing.assert_array_equal(got, g)
    assert telemetry.counter_value("store.codec.fallback") == 1.0
    st = open_store(d)
    _materialize(st, 32)
    st.close()
    assert telemetry.counter_value("store.codec.fallback") == 1.0


@pytest.mark.parametrize("spec", ["raw", "zlib", "zlib-dict"])
def test_python_fallback_bit_identical_to_native(lib, tmp_path, spec,
                                                 monkeypatch):
    src = SyntheticSource(n_samples=11, n_variants=333, seed=3)
    d = str(tmp_path / "s")
    compact(d, src, chunk_variants=64, codec=spec)
    st = open_store(d)
    native_out = _materialize(st, 50)
    st.close()
    _force_python(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        st = open_store(d)
        python_out = _materialize(st, 50)
        st.close()
    np.testing.assert_array_equal(native_out, python_out)
