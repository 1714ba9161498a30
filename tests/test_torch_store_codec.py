"""The port's chunk codecs (store/codec.py) and the compressed store,
on the CPU: the deflate parameters and every stored byte equal to the
JAX package's, round trips on both transports, v1/v2 manifests,
mixed-codec stores, damage to compressed chunks and dictionaries, the
dense feed's decode straight into its buffer (retry-wrapped too), the
adaptive readahead depth, and the cache's accounting — the JAX cases of
tests/test_store_codec.py. Its native decode-to-slab cases are in
tests/test_torch_native.py."""

import json
import os
import threading
import time
import warnings
import zlib

import numpy as np
import pytest
import torch

from spark_examples_tpu.store import codec as jcodec
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import faults, hashing, telemetry
from spark_examples_tpu_torch.core.config import IngestConfig
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest import prefetch as tprefetch
from spark_examples_tpu_torch.ingest.resilient import (
    RetryingSource,
    RetryPolicy,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ingest.vcf import VcfSource, write_vcf
from spark_examples_tpu_torch.pipelines.runner import build_source
from spark_examples_tpu_torch.store import (
    StoreCorruptError,
    StoreFormatError,
    compact,
    open_store,
    origin_from_ingest,
)
from spark_examples_tpu_torch.store import codec as codecmod
from spark_examples_tpu_torch.store import readahead as ra_mod
from spark_examples_tpu_torch.store.manifest import StoreManifest
from spark_examples_tpu_torch.store.readahead import ReadaheadPool

from conftest import random_genotypes

CPU = torch.device("cpu")


def _materialize(source, bv, start=0):
    blocks = [b for b, _ in source.blocks(bv, start)]
    return np.concatenate(blocks, axis=1) if blocks else None


def _materialize_packed(source, bv):
    return np.concatenate(
        [bitpack.unpack_dosages_np(pb)[:, :m.stop - m.start]
         for pb, m in source.packed_blocks(bv)], axis=1)


@pytest.fixture
def zstore(tmp_path):
    """A zlib store with its origin recorded (synthetic, 48 x 2048,
    chunks of 512)."""
    cfg = IngestConfig(source="synthetic", n_samples=48, n_variants=2048,
                       seed=2)
    d = str(tmp_path / "z")
    compact(d, build_source(cfg, "cpu"), chunk_variants=512, codec="zlib",
            origin=origin_from_ingest(cfg, 512))
    return d, _materialize(build_source(cfg, "cpu"), 512)


# ------------------------------------------------- codec bytes against JAX

def test_codec_constants_match_jax():
    assert (codecmod.ZLIB_LEVEL, codecmod._ZLIB_WBITS,
            codecmod._ZLIB_MEMLEVEL, codecmod._ZLIB_STRATEGY,
            codecmod.DICT_MAX_BYTES, codecmod.DICT_DIR) == \
        (jcodec.ZLIB_LEVEL, jcodec._ZLIB_WBITS, jcodec._ZLIB_MEMLEVEL,
         zlib.Z_DEFAULT_STRATEGY, jcodec.DICT_MAX_BYTES, jcodec.DICT_DIR)
    assert codecmod.CODECS == jcodec.CODECS
    assert codecmod.SPECS == jcodec.SPECS


@pytest.mark.parametrize("size", [1, 1000, 40_000, 200_000])
@pytest.mark.parametrize("with_dict", [False, True])
def test_compress_writes_the_jax_bytes(size, with_dict):
    rng = np.random.default_rng(size)
    g = random_genotypes(rng, 8, size * 4 // 8 + 1, 0.05)
    raw = bitpack.pack_dosages(g).tobytes()
    zdict = codecmod.train_dict(raw) if with_dict else None
    if with_dict:
        assert zdict == jcodec.train_dict(raw)
    got = codecmod.compress("zlib", raw, zdict)
    assert got == jcodec.compress("zlib", raw, zdict)
    assert codecmod.decompress("zlib", got, len(raw), zdict) == raw
    assert jcodec.decompress("zlib", got, len(raw), zdict) == raw
    assert codecmod.compress("raw", raw) == raw


@pytest.mark.parametrize("bad", ["lz77", "zlib-dct", ""])
def test_parse_spec_matches_jax(bad):
    assert [codecmod.parse_spec(s) for s in codecmod.SPECS] == \
        [jcodec.parse_spec(s) for s in jcodec.SPECS]
    with pytest.raises(ValueError) as got:
        codecmod.parse_spec(bad)
    with pytest.raises(ValueError) as want:
        jcodec.parse_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("damage", ["flip", "short", "garbage"])
def test_undecodable_bytes_raise_decode_error(damage):
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
    with pytest.raises(codecmod.StoreDecodeError):
        codecmod.decode_into(bytes(stored), "zlib", None, 16, 100, 0, 400,
                             out)
    with pytest.raises(codecmod.StoreDecodeError, match="catalog says"):
        codecmod.decode_into(raw[:-1], "raw", None, 16, 100, 0, 400, out)


@pytest.mark.parametrize("v0,v1", [(0, 400), (1, 399), (3, 5), (100, 101),
                                   (397, 400)])
@pytest.mark.parametrize("codec", ["raw", "zlib"])
def test_decode_into_spans(v0, v1, codec):
    g = random_genotypes(np.random.default_rng(7), 9, 400)
    raw = bitpack.pack_dosages(g).tobytes()
    stored = codecmod.compress(codec, raw)
    out = np.full((9, v1 - v0 + 4), 5, np.int8)
    codecmod.decode_into(np.frombuffer(stored, np.uint8), codec, None, 9,
                         100, v0, v1, out, col_off=2)
    np.testing.assert_array_equal(out[:, 2:2 + v1 - v0], g[:, v0:v1])
    assert (out[:, :2] == 5).all() and (out[:, 2 + v1 - v0:] == 5).all()


# ------------------------------------------------------------ round trips

@pytest.mark.parametrize("spec", ["zlib", "zlib-dict"])
def test_compressed_roundtrip_synthetic_both_transports(tmp_path, spec):
    src = SyntheticSource(n_samples=13, n_variants=501, seed=11)
    raw_dir, cmp_dir = str(tmp_path / "raw"), str(tmp_path / "cmp")
    compact(raw_dir, src, chunk_variants=64, codec="raw")
    m = compact(cmp_dir, src, chunk_variants=64, codec=spec)
    assert all(c.codec == "zlib" for c in m.chunks)
    assert all((c.dict_digest is not None) == (spec == "zlib-dict")
               for c in m.chunks)
    want = _materialize(src, 64)
    for bv in (32, 64, 100, 501):
        np.testing.assert_array_equal(
            _materialize(open_store(cmp_dir), bv), want)
    for bv in (32, 64, 256):
        np.testing.assert_array_equal(
            _materialize_packed(open_store(cmp_dir), bv), want)
    np.testing.assert_array_equal(_materialize(open_store(raw_dir), 64),
                                  want)


@pytest.mark.parametrize("spec", ["zlib", "zlib-dict"])
def test_compressed_roundtrip_vcf_multi_contig(tmp_path, spec):
    rng = np.random.default_rng(4)
    g1, g2 = random_genotypes(rng, 7, 23), random_genotypes(rng, 7, 10)
    p1, p2 = str(tmp_path / "a.vcf"), str(tmp_path / "b.vcf")
    write_vcf(p1, g1, contig="chr1", start_pos=100)
    write_vcf(p2, g2, contig="chr2", start_pos=500)
    header = [ln for ln in open(p1) if ln.startswith("#")]
    records = [ln for p in (p1, p2) for ln in open(p)
               if not ln.startswith("#")]
    multi = str(tmp_path / "multi.vcf")
    open(multi, "w").writelines(header + records)
    d = str(tmp_path / "s")
    m = compact(d, VcfSource(multi), chunk_variants=8, codec=spec)
    want = np.concatenate([g1, g2], axis=1)
    np.testing.assert_array_equal(_materialize(open_store(d), 16), want)
    np.testing.assert_array_equal(_materialize_packed(open_store(d), 16),
                                  want)
    metas = [meta for _, meta in open_store(d).blocks(16)]
    assert [(x.start, x.stop, x.contig) for x in metas] == \
        [(0, 16, "chr1"), (16, 23, "chr1"), (23, 33, "chr2")]
    assert not open_store(d).exact_n_variants
    if spec == "zlib-dict":
        by_contig = {}
        for c in m.chunks:
            by_contig.setdefault(c.contig, set()).add(c.dict_digest)
        assert all(len(s) == 1 for s in by_contig.values())
        assert by_contig["chr1"] != by_contig["chr2"]


def test_low_entropy_chunks_compress(tmp_path):
    rng = np.random.default_rng(5)
    maf = rng.uniform(0.001, 0.12, size=4096)
    g = (rng.random((64, 4096)) < maf).astype(np.int8) + (
        rng.random((64, 4096)) < maf).astype(np.int8)
    d = str(tmp_path / "s")
    m = compact(d, ArraySource(g), chunk_variants=1024, codec="zlib")
    n = m.n_samples
    raw_b = sum(c.payload_size(n) for c in m.chunks)
    stored_b = sum(c.disk_size(n) for c in m.chunks)
    assert stored_b < raw_b / 1.5
    for c in m.chunks:
        assert os.path.getsize(os.path.join(d, c.filename())) == \
            c.stored_size
        assert c.raw_size == c.n_bytes(n)


def _downgrade_manifest(d, version):
    path = os.path.join(d, "manifest.json")
    m = json.load(open(path))
    m["schema_version"] = version
    m["chunks"] = [row[:6] for row in m["chunks"]]
    if version < 2:
        m.pop("origin", None)
    json.dump(m, open(path, "w"))


@pytest.mark.parametrize("version", [1, 2])
def test_v1_v2_store_reads_untouched(tmp_path, genotypes, version):
    d = str(tmp_path / "s")
    compact(d, ArraySource(genotypes), chunk_variants=32, codec="raw")
    before = sorted(os.listdir(os.path.join(d, "chunks")))
    _downgrade_manifest(d, version)
    st = open_store(d)
    assert st.manifest.schema_version == version
    assert all(c.codec == "raw" and c.stored_size == -1
               for c in st.manifest.chunks)
    np.testing.assert_array_equal(_materialize(st, 32), genotypes)
    np.testing.assert_array_equal(_materialize_packed(open_store(d), 32),
                                  genotypes)
    assert sorted(os.listdir(os.path.join(d, "chunks"))) == before


def test_unknown_codec_rejected_at_load(tmp_path, genotypes):
    d = str(tmp_path / "s")
    compact(d, ArraySource(genotypes), chunk_variants=32, codec="zlib")
    path = os.path.join(d, "manifest.json")
    m = json.load(open(path))
    m["chunks"][1][6] = "lz99"
    json.dump(m, open(path, "w"))
    with pytest.raises(StoreFormatError, match="unknown codec 'lz99'"):
        open_store(d)


def test_mixed_codec_chunks_in_one_store(tmp_path, genotypes):
    d = str(tmp_path / "s")
    m = compact(d, ArraySource(genotypes), chunk_variants=32, codec="zlib")
    rec = m.chunks[2]
    payload = zlib.decompress(open(os.path.join(d, rec.filename()),
                                   "rb").read())
    new_digest = hashing.sha256_bytes(payload)
    with open(os.path.join(d, "chunks", f"{new_digest}.bin"), "wb") as f:
        f.write(payload)
    path = os.path.join(d, "manifest.json")
    raw = json.load(open(path))
    row = raw["chunks"][2]
    assert row[3] == rec.digest
    row[3], row[6], row[8] = new_digest, "raw", len(payload)
    json.dump(raw, open(path, "w"))
    st = open_store(d)
    assert [c.codec for c in st.manifest.chunks].count("raw") == 1
    np.testing.assert_array_equal(_materialize(st, 32), genotypes)
    np.testing.assert_array_equal(_materialize_packed(open_store(d), 32),
                                  genotypes)


# ---------------------------------------------------------------- damage

def test_corrupt_compressed_chunk_quarantined(tmp_path, genotypes):
    d = str(tmp_path / "s")
    m = compact(d, ArraySource(genotypes), chunk_variants=32, codec="zlib")
    victim = os.path.join(d, m.chunks[2].filename())
    raw = bytearray(open(victim, "rb").read())
    raw[5] ^= 0x10
    open(victim, "wb").write(bytes(raw))
    before = telemetry.counter_value("store.quarantined")
    with pytest.raises(StoreCorruptError, match="content address") as e:
        _materialize(open_store(d), 32)
    assert e.value.cursor == 64
    q = json.load(open(os.path.join(d, "quarantine.json")))
    assert len(q) == 1 and q[0]["start"] == 64
    assert telemetry.counter_value("store.quarantined") == before + 1
    # verify off: the bytes no longer inflate, and still fail loudly.
    os.remove(os.path.join(d, "quarantine.json"))
    with pytest.raises(StoreCorruptError):
        _materialize(open_store(d, verify=False), 32)


def test_truncated_compressed_chunk_caught_by_size(tmp_path, genotypes):
    d = str(tmp_path / "s")
    m = compact(d, ArraySource(genotypes), chunk_variants=32, codec="zlib")
    with open(os.path.join(d, m.chunks[0].filename()), "r+b") as f:
        f.truncate(max(m.chunks[0].stored_size - 3, 1))
    with pytest.raises(StoreCorruptError, match="catalog says"):
        open_store(d).read_range(0, 8)


def test_bitflip_raw_codec_verify_off_reads_damage(tmp_path, genotypes):
    d = str(tmp_path / "raw")
    m = compact(d, ArraySource(genotypes), chunk_variants=32, codec="raw")
    victim = os.path.join(d, m.chunks[0].filename())
    raw = bytearray(open(victim, "rb").read())
    raw[7] ^= 0x40
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(StoreCorruptError, match="content address"):
        open_store(d).read_range(0, 8)
    open_store(d, verify=False).read_range(0, 8)  # documented: unchecked


def test_compressed_chunk_heals_from_origin_byte_identically(zstore):
    d, want = zstore
    rec = StoreManifest.load(d).chunks[1]
    victim = os.path.join(d, rec.filename())
    original = open(victim, "rb").read()
    raw = bytearray(original)
    raw[7] ^= 0x40
    open(victim, "wb").write(bytes(raw))
    healed0 = telemetry.counter_value("store.healed")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = _materialize(open_store(d, device="cpu"), 512)
    np.testing.assert_array_equal(got, want)
    assert telemetry.counter_value("store.healed") == healed0 + 1
    assert open(victim, "rb").read() == original
    assert not os.path.exists(os.path.join(d, "quarantine.json"))


def test_store_heal_cli_repairs_compressed_store(zstore, capsys):
    d, want = zstore
    victim = os.path.join(d, StoreManifest.load(d).chunks[0].filename())
    original = open(victim, "rb").read()
    open(victim, "wb").write(original[:-2])
    assert tmain(["store", "heal", "--path", d, "--verify-all",
                  "--device", "cpu"]) == 0
    capsys.readouterr()
    assert open(victim, "rb").read() == original
    np.testing.assert_array_equal(_materialize(open_store(d), 512), want)


def test_dict_file_recovered_from_origin(tmp_path):
    cfg = IngestConfig(source="synthetic", n_samples=16, n_variants=384,
                       seed=2)
    d = str(tmp_path / "s")
    compact(d, build_source(cfg, "cpu"), chunk_variants=64,
            codec="zlib-dict", origin=origin_from_ingest(cfg, 64))
    want = _materialize(build_source(cfg, "cpu"), 64)
    dd = StoreManifest.load(d).chunks[0].dict_digest
    os.remove(codecmod.dict_path(d, dd))
    np.testing.assert_array_equal(
        _materialize(open_store(d, device="cpu"), 64), want)
    assert hashing.sha256_file(codecmod.dict_path(d, dd)) == dd


def test_dict_missing_without_origin_fails_fast(tmp_path, genotypes):
    d = str(tmp_path / "s")
    m = compact(d, ArraySource(genotypes), chunk_variants=32,
                codec="zlib-dict")
    os.remove(codecmod.dict_path(d, m.chunks[0].dict_digest))
    with pytest.raises(StoreCorruptError, match="dictionary"):
        _materialize(open_store(d), 32)


def test_injected_io_error_recovers_on_compressed_store(zstore):
    d, want = zstore
    with faults.armed(["store.read:io_error:after=2:max=2"]) as inj:
        rs = RetryingSource(
            open_store(d), policy=RetryPolicy(max_retries=2, backoff_s=0.001),
            reopen=lambda: open_store(d))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = _materialize(rs, 512)
        assert inj.fire_count("store.read") == 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("readahead", [0, 2])
def test_readahead_decode_fault_rides_the_retry_boundary(zstore, readahead):
    """store.readahead.decode armed while the dense warms run: the
    worker's error is held, re-raised at the consumer's cursor, and the
    retry boundary recovers bit-identically (no readahead: no warm, no
    fire)."""
    d, want = zstore
    errors0 = telemetry.counter_value("store.readahead.errors")
    with faults.armed(["store.readahead.decode:io_error:after=1:max=1"]):
        rs = RetryingSource(
            open_store(d, readahead_chunks=readahead),
            policy=RetryPolicy(max_retries=2, backoff_s=0.001),
            reopen=lambda: open_store(d, readahead_chunks=readahead))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = _materialize(rs, 512)
        rs.close()
    np.testing.assert_array_equal(got, want)
    assert telemetry.counter_value("store.readahead.errors") == \
        errors0 + (1 if readahead else 0)


def test_compressed_compaction_deterministic_across_workers(tmp_path):
    d1, d4 = str(tmp_path / "w1"), str(tmp_path / "w4")
    compact(d1, SyntheticSource(n_samples=24, n_variants=700, seed=9),
            chunk_variants=64, workers=1, codec="zlib-dict")
    compact(d4, SyntheticSource(n_samples=24, n_variants=700, seed=9),
            chunk_variants=64, workers=4, codec="zlib-dict")
    for sub in ("", "chunks", "dicts"):
        names = sorted(os.listdir(os.path.join(d1, sub)))
        assert names == sorted(os.listdir(os.path.join(d4, sub)))
        for name in names:
            p1, p4 = os.path.join(d1, sub, name), os.path.join(d4, sub, name)
            if os.path.isfile(p1):
                assert open(p1, "rb").read() == open(p4, "rb").read()


def test_recompaction_dedupes_compressed_chunks(tmp_path, genotypes):
    d = str(tmp_path / "s")
    compact(d, ArraySource(genotypes), chunk_variants=32, codec="zlib")
    files = sorted(os.listdir(os.path.join(d, "chunks")))
    compact(d, ArraySource(genotypes), chunk_variants=32, codec="zlib")
    assert sorted(os.listdir(os.path.join(d, "chunks"))) == files


# ------------------------------------- the dense feed's decode into its buffer

def test_decode_range_into_matches_read_range(zstore):
    d, want = zstore
    st = open_store(d)
    out = np.full((st.n_samples, 700), 7, np.int8)
    st.decode_range_into(300, 995, out, col_off=5)
    np.testing.assert_array_equal(out[:, 5:700], want[:, 300:995])
    assert (out[:, :5] == 7).all()


@pytest.mark.parametrize("wrapped", [False, True])
def test_dense_feed_decodes_the_store_into_its_buffer(zstore, wrapped,
                                                      monkeypatch):
    """The dense transport drives block_spans + decode_range_into (never
    the store's own blocks()), also through the retry boundary, and
    recovers an injected IO error mid-span: blocks equal the plain
    stream's, ragged tail padded with MISSING."""
    d, want = zstore
    src = open_store(d)
    if wrapped:
        src = RetryingSource(
            src, policy=RetryPolicy(max_retries=2, backoff_s=0.001),
            reopen=lambda: open_store(d))
    assert tprefetch.decode_direct(src, pack=False)
    assert not tprefetch.decode_direct(src, pack=True)

    def no_blocks(*a, **k):
        raise AssertionError("the direct drive must not call blocks()")

    inner = src.inner if wrapped else src
    monkeypatch.setattr(inner, "blocks", no_blocks)
    spec = ["store.read:io_error:after=2:max=2"] if wrapped else []
    stats = {}
    with faults.armed(spec) as inj, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = [(b.numpy().copy(), m) for b, m in tprefetch.stream_to_device(
            src, 300, CPU, pack=False, stats=stats)]
        assert inj.fire_count("store.read") == (2 if wrapped else 0)
    assert stats["max_value"] == 2
    assert [m.start for _, m in got] == list(range(0, 2048, 300))
    for b, m in got:
        np.testing.assert_array_equal(
            b, tprefetch.pad_block(want[:, m.start:m.stop], 300))


# ---------------------------------------------------- adaptive readahead

def test_adaptive_depth_policy_curve():
    t = ReadaheadPool._target_depth
    assert t(None, None, 2, 16) == 2
    assert t(0.001, 0.1, 2, 16) == 2
    assert t(0.1, 0.01, 2, 16) == 11
    assert t(10.0, 0.001, 2, 16) == 16
    assert t(0.0, 0.1, 1, 8) == 1


def test_adaptive_pool_deepens_and_settles(monkeypatch):
    pool = ReadaheadPool(2, max_depth=16)
    try:
        pool._decode_ewma = 0.05
        t = [0.0]

        def fast():
            t[0] += 0.001
            return t[0]

        monkeypatch.setattr(ra_mod.time, "perf_counter", fast)
        pool.note_retire()
        pool.note_retire()
        assert pool.depth == 16
        monkeypatch.setattr(ra_mod.time, "perf_counter",
                            lambda: t.__setitem__(0, t[0] + 1.0) or t[0])
        for _ in range(40):
            pool.note_retire()
        assert pool.depth == 2
        assert telemetry.metrics_snapshot()["gauges"][
            "store.readahead.depth"]["last"] == 2.0
    finally:
        pool.close()


def test_adaptive_depth_normalizes_block_grid_to_chunks(monkeypatch):
    pool = ReadaheadPool(2, max_depth=16)
    try:
        t = [0.0]
        monkeypatch.setattr(ra_mod.time, "perf_counter", lambda: t[0])
        pool.note_retire(3)
        t[0] += 0.004
        pool.note_retire(7)
        assert pool._retire_ewma == pytest.approx(0.001)
        t[0] += 0.004
        pool.note_retire(7)
        assert pool._retire_ewma == pytest.approx(0.001)
        t[0] += 0.004
        pool.note_retire(8)
        assert pool._retire_ewma == pytest.approx(
            0.001 + 0.25 * (0.008 - 0.001))
    finally:
        pool.close()


def test_consumer_wait_deepens_window():
    pool = ReadaheadPool(2, max_depth=16)
    try:
        ev = threading.Event()
        pool.schedule(("dense", 0), ev.wait)
        got = [None]
        th = threading.Thread(
            target=lambda: got.__setitem__(0, pool.consume(("dense", 0))))
        th.start()
        time.sleep(0.02)
        ev.set()
        th.join()
        assert got[0] is True
        pool._decode_ewma = 0.0001
        pool._retire_ewma = 1.0
        pool.note_retire()
        assert pool.depth == 3
        pool.note_retire()
        assert pool.depth == 2
    finally:
        pool.close()


def test_fixed_depth_when_max_disabled():
    pool = ReadaheadPool(3, max_depth=0)
    try:
        pool._decode_ewma = 10.0
        pool._retire_ewma = 0.001
        pool.note_retire()
        assert pool.depth == 3
    finally:
        pool.close()


def test_store_close_joins_the_readahead_threads(tmp_path):
    """No pool thread outlives the reader: close() joins them."""
    d = str(tmp_path / "s")
    compact(d, SyntheticSource(n_samples=8, n_variants=2048, seed=1),
            chunk_variants=64, codec="zlib")
    others = set(threading.enumerate())

    def pool_threads():
        return [t for t in threading.enumerate()
                if t not in others and t.name.startswith("store-readahead")]

    st = open_store(d, readahead_chunks=2, readahead_chunks_max=8)
    _materialize(st, 64)
    assert 2 <= st._ra.depth <= 8
    assert pool_threads()
    st.close()
    assert not pool_threads()


def test_cache_charges_decoded_not_stored_bytes(tmp_path):
    src = SyntheticSource(n_samples=64, n_variants=1024, seed=5)
    d = str(tmp_path / "s")
    m = compact(d, src, chunk_variants=256, codec="zlib")
    n = m.n_samples
    stored_b = sum(c.disk_size(n) for c in m.chunks)
    st = open_store(d)
    _materialize_packed(st, 256)
    payload_b = sum(c.payload_size(n) for c in m.chunks)
    assert st.cache.stats()["bytes"] == payload_b > stored_b
    _materialize(st, 256)
    assert st.cache.stats()["bytes"] == payload_b + n * m.n_variants


# ------------------------------------------------------ knobs and the CLI

@pytest.mark.parametrize("kw,match", [
    (dict(store_codec="lzma"), "--store-codec='lzma'"),
    (dict(readahead_chunks=8, readahead_chunks_max=4),
     "--readahead-chunks-max"),
    (dict(readahead_chunks_max=-1), "--readahead-chunks-max"),
    (dict(ingest_workers=0), "--ingest-workers"),
    (dict(io_retries=-1), "--io-retries"),
    (dict(store_cache_mb=-1), "--store-cache-mb"),
    (dict(io_retry_backoff_s=-0.5), "--io-retry-backoff"),
])
def test_store_knobs_validated_at_config_time(kw, match):
    with pytest.raises(ValueError, match=match):
        IngestConfig(**kw)
    IngestConfig(readahead_chunks=8, readahead_chunks_max=0)


@pytest.mark.parametrize("argv", [
    ["ingest", "--store-codec", "lzma", "--output-path", "s"],
    ["pcoa", "--readahead-chunks", "8", "--readahead-chunks-max", "4"],
    ["ingest", "--n-samples", "4", "--n-variants", "8"],
    ["store", "mend", "--path", "s"],
    ["pcoa", "--source", "store:"],
    ["pcoa", "--source", "vcf:cohort.vcf"],
])
def test_bad_store_flags_are_usage_errors(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tmain(argv + (["--device", "cpu"] if argv[0] != "store" else []))
    assert e.value.code == 2
    capsys.readouterr()


def test_ingest_cli_reports_ratio_and_write_rate(tmp_path, capsys):
    store = str(tmp_path / "store")
    assert tmain(["ingest", "--device", "cpu", "--n-samples", "12",
                  "--n-variants", "512", "--chunk-variants", "128",
                  "--output-path", store, "--timings"]) == 0
    cap = capsys.readouterr()
    assert "x zlib" in cap.out and "MB/s written" in cap.out
    assert "MB stored" in cap.out
    assert "compact" in json.loads(cap.err.strip().splitlines()[-1])
    assert all(c.codec == "zlib" for c in StoreManifest.load(store).chunks)
