"""The PyTorch port's content-addressed dataset store against the JAX
package's, on the CPU, in one process.

- ``compact`` of the same synthetic, VCF (three contigs, positions) and
  packed source, by each package's own ``build_source``, writes the
  same directory tree byte for byte (chunks, dictionaries, positions,
  manifest with its origin) for raw / zlib / zlib-dict and 1 or 3
  workers.
- Each package reads the other's store: ``blocks``, ``packed_blocks``,
  ``read_range``, ``positions``, ``restrict``, ``contig_source`` and
  ``position_span`` agree.
- pcoa, similarity and pca read from a store give int32 accumulators
  bitwise equal to JAX's run on the same store and to the port's own
  synthetic run; coordinates agree within the tolerances of
  tests/test_torch_pipeline.py.
- The port's own store cases (range queries at chunk edges, resume,
  dedupe, the decode cache, manifest format errors) as in
  tests/test_store.py.
"""

import inspect
import json
import os

import numpy as np
import pytest

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core.profiling import PhaseTimer as JPhaseTimer
from spark_examples_tpu.ingest import packed as jpacked
from spark_examples_tpu.ingest import parallel as jparallel
from spark_examples_tpu.ingest import vcf as jvcf
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu import store as jstore
from spark_examples_tpu_torch import store as tstore
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest import parallel as tparallel
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.pipelines import jobs as tjobs
from spark_examples_tpu_torch.pipelines import runner as trunner

from conftest import random_genotypes

N = 64
CONTIGS = (("chr1", 1200, 1000), ("chr2", 1000, 50_000),
           ("chr3", 800, 7_000))
V = sum(v for _, v, _ in CONTIGS)
CHUNK = 1024
SYN_V = 3000
CODECS = ("raw", "zlib", "zlib-dict")


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        assert ta[rel] == tb[rel], rel


@pytest.fixture(scope="module")
def cohort():
    return random_genotypes(np.random.default_rng(51), N, V, 0.1)


@pytest.fixture(scope="module")
def files(tmp_path_factory, cohort):
    """The cohort as a three-contig VCF and a packed store, written by
    the JAX package's writers."""
    d = tmp_path_factory.mktemp("store_files")
    vcf = str(d / "cohort.vcf")
    lo, parts = 0, []
    for contig, v, start in CONTIGS:
        part = str(d / f"{contig}.vcf")
        jvcf.write_vcf(part, cohort[:, lo:lo + v], contig=contig,
                       start_pos=start)
        parts.append(part)
        lo += v
    with open(vcf, "w") as out:
        for i, part in enumerate(parts):
            with open(part) as f:
                out.writelines(line for line in f
                               if i == 0 or not line.startswith("#"))
    packed = str(d / "packed")
    jpacked.save_packed(packed, cohort, contig="chr9",
                        positions=np.arange(V, dtype=np.int64) * 3 + 11)
    return {"vcf": vcf, "packed": packed}


def ingest_configs(source, files, **kw):
    """(JAX IngestConfig, port IngestConfig) for the same stream."""
    if source == "synthetic":
        kw.update(n_samples=N, n_variants=SYN_V, seed=5)
    else:
        kw.update(source=source, path=files[source])
    return jconfig.IngestConfig(**kw), tconfig.IngestConfig(**kw)


def compact_both(tmp_path, source, files, codec, workers, monkeypatch):
    """Compact the same source with each package; returns the two store
    directories."""
    # Small VCF shards, so several workers really split the file.
    monkeypatch.setattr(jparallel, "VCF_SHARD_BYTES", 40_000)
    monkeypatch.setattr(tparallel, "VCF_SHARD_BYTES", 40_000)
    jcfg, tcfg = ingest_configs(source, files)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.compact(jdir, jrunner.build_source(jcfg), chunk_variants=CHUNK,
                   workers=workers, codec=codec,
                   origin=jstore.origin_from_ingest(jcfg, CHUNK))
    tstore.compact(tdir, trunner.build_source(tcfg, "cpu"),
                   chunk_variants=CHUNK, workers=workers, codec=codec,
                   origin=tstore.origin_from_ingest(tcfg, CHUNK))
    return jdir, tdir


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("source", ["synthetic", "vcf", "packed"])
def test_compact_writes_the_jax_directory_byte_for_byte(
        tmp_path, files, monkeypatch, source, codec, workers):
    jdir, tdir = compact_both(tmp_path, source, files, codec, workers,
                              monkeypatch)
    assert_same_tree(jdir, tdir)
    m = tstore.StoreManifest.load(tdir)
    assert m.origin["source"] == source
    assert os.path.exists(os.path.join(tdir, "dicts")) == \
        (codec == "zlib-dict")
    if source == "vcf":
        assert [c.contig for c in m.chunks].count("chr2") == 1
        assert m.has_positions


def test_parallel_compaction_matches_serial_file_for_file(
        tmp_path, files, monkeypatch):
    monkeypatch.setattr(tparallel, "VCF_SHARD_BYTES", 40_000)
    _, tcfg = ingest_configs("vcf", files)
    dirs = []
    for workers in (1, 4):
        d = str(tmp_path / f"w{workers}")
        tstore.compact(d, trunner.build_source(tcfg, "cpu"),
                       chunk_variants=512, workers=workers,
                       codec="zlib-dict",
                       origin=tstore.origin_from_ingest(tcfg, 512))
        dirs.append(d)
    assert_same_tree(*dirs)


@pytest.fixture(scope="module", params=CODECS)
def both_stores(request, tmp_path_factory, files):
    """(JAX-written, port-written) stores of the VCF cohort."""
    codec = request.param
    d = tmp_path_factory.mktemp(f"both_{codec}")
    jcfg, tcfg = ingest_configs("vcf", files)
    jdir, tdir = str(d / "jax"), str(d / "port")
    jstore.compact(jdir, jrunner.build_source(jcfg), chunk_variants=CHUNK,
                   codec=codec, origin=jstore.origin_from_ingest(jcfg, CHUNK))
    tstore.compact(tdir, trunner.build_source(tcfg, "cpu"),
                   chunk_variants=CHUNK, codec=codec,
                   origin=tstore.origin_from_ingest(tcfg, CHUNK))
    return jdir, tdir


def assert_same_stream(got, want):
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gb.dtype == wb.dtype
        np.testing.assert_array_equal(gb, wb)
        assert (gm.index, gm.start, gm.stop, gm.contig) == \
            (wm.index, wm.start, wm.stop, wm.contig)
        np.testing.assert_array_equal(gm.positions, wm.positions)


@pytest.mark.parametrize("reader", ["port reads jax", "jax reads port"])
def test_each_package_reads_the_others_store(both_stores, cohort, reader):
    jdir, tdir = both_stores
    path = jdir if reader == "port reads jax" else tdir
    t, j = tstore.open_store(path), jstore.open_store(path)
    assert t.sample_ids == j.sample_ids and t.n_variants == V
    for bv in (500, 1024, 2048):
        assert_same_stream(list(t.blocks(bv)), list(j.blocks(bv)))
    for bv in (512, 1024):
        assert_same_stream(list(t.packed_blocks(bv)),
                           list(j.packed_blocks(bv)))
    for lo, hi in ((0, 1024), (1023, 1025), (1199, 1201), (700, 2900),
                   (V - 5, V), (5, 5)):
        got = t.read_range(lo, hi)
        np.testing.assert_array_equal(got, j.read_range(lo, hi))
        np.testing.assert_array_equal(got, cohort[:, lo:hi])
    np.testing.assert_array_equal(t.positions, j.positions)
    JRange, TRange = jconfig.ReferenceRange, tconfig.ReferenceRange
    refs = [("chr1", 1100, 1400), ("chr3", 7_100, 7_500)]
    assert_same_stream(
        list(t.restrict([TRange(*r) for r in refs]).blocks(128)),
        list(j.restrict([JRange(*r) for r in refs]).blocks(128)))
    assert t.position_span("chr2", 50_100, 50_900) == \
        j.position_span("chr2", 50_100, 50_900) == (1300, 2100)
    assert_same_stream(list(t.contig_source("chr3").blocks(300)),
                       list(j.contig_source("chr3").blocks(300)))
    empty = t.restrict([TRange("chrX", 0, 10)])
    assert empty.n_variants == 0 and list(empty.blocks(64)) == []
    t.close()


def _jobs(path, metric, bv=512, refs=(), **ingest):
    j = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(
            source=f"store:{path}", block_variants=bv,
            references=[jconfig.ReferenceRange.parse(r) for r in refs],
            **ingest),
        compute=jconfig.ComputeConfig(metric=metric, num_pc=4))
    t = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(
            source=f"store:{path}", block_variants=bv,
            references=[tconfig.ReferenceRange.parse(r) for r in refs],
            **ingest),
        compute=tconfig.ComputeConfig(metric=metric, num_pc=4,
                                      device="cpu"))
    return j, t


def _assert_coords_agree(jout, tout, k):
    """Eigenvalues within 1e-4 of lambda_1; coordinate columns with an
    eigengap above 2 % of lambda_1 agree up to sign within 2e-3 of their
    scale (tests/test_torch_pipeline.py's tolerances)."""
    jv, tv = np.asarray(jout.eigenvalues), tout.eigenvalues
    np.testing.assert_allclose(tv, jv, atol=1e-4 * jv[0])
    gaps = np.diff(jv)
    for c in range(k):
        left = abs(gaps[c - 1]) if c > 0 else np.inf
        right = abs(gaps[c]) if c < k - 1 else np.inf
        if min(left, right) <= 0.02 * jv[0]:
            continue
        jc, tc = np.asarray(jout.coords)[:, c], tout.coords[:, c]
        s = np.sign(np.dot(jc, tc)) or 1.0
        np.testing.assert_allclose(s * tc, jc, atol=2e-3 * np.abs(jc).max())
    assert tout.sample_ids == list(jout.sample_ids)


@pytest.mark.parametrize("metric", ["ibs", "euclidean", "king"])
def test_store_accumulators_match_jax_on_the_same_store(both_stores,
                                                        metric):
    """ibs and king ride the packed transport (raw chunks zero-copy,
    compressed ones from the cached inflate); euclidean the dense one
    (decode straight into the feed's buffer)."""
    jdir, _ = both_stores
    jjob, tjob = _jobs(jdir, metric, readahead_chunks=0)
    jg = jrunner.run_gram(jjob, jrunner.build_source(jjob.ingest),
                          JPhaseTimer())
    tsrc = trunner.build_source(tjob.ingest, "cpu")
    tg = trunner.run_gram(tjob, tsrc, PhaseTimer())
    assert tg.n_variants == jg.n_variants == V
    for leaf in jg.acc:
        np.testing.assert_array_equal(tg.acc[leaf].numpy(),
                                      np.asarray(jg.acc[leaf]),
                                      err_msg=leaf)


def test_store_jobs_match_jax_and_the_synthetic_run(tmp_path):
    """pcoa / similarity / pca from a store compacted from the synthetic
    source: accumulators bitwise equal to the port's synthetic run and
    JAX's store run; coordinates agree with JAX's."""
    src = SyntheticSource(n_samples=N, n_variants=SYN_V, seed=2)
    d = str(tmp_path / "s")
    tstore.compact(d, src, chunk_variants=CHUNK)
    jjob, tjob = _jobs(d, "ibs")
    syn = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(n_samples=N, n_variants=SYN_V, seed=2,
                                    block_variants=512),
        compute=tjob.compute)
    g_syn = trunner.run_gram(syn, trunner.build_source(syn.ingest, "cpu"),
                             PhaseTimer())
    g_st = trunner.run_gram(tjob, trunner.build_source(tjob.ingest, "cpu"),
                            PhaseTimer())
    for leaf in g_syn.acc:
        np.testing.assert_array_equal(g_st.acc[leaf].numpy(),
                                      g_syn.acc[leaf].numpy())
    tout, jout = tjobs.pcoa_job(tjob), jjobs.pcoa_job(jjob)
    assert tout.n_variants == SYN_V
    _assert_coords_agree(jout, tout, 4)
    np.testing.assert_array_equal(tout.coords,
                                  tjobs.pcoa_job(syn).coords)
    got = tjobs.similarity_matrix_job(tjob)
    want = jrunner.run_similarity(jjob)
    np.testing.assert_array_equal(got.similarity, want.similarity)
    pjob = tjob.replace(compute=tconfig.ComputeConfig(num_pc=4,
                                                      device="cpu"))
    out = tjobs.variants_pca_job(pjob)
    assert out.coords.shape == (N, 4) and np.isfinite(out.coords).all()


def test_references_job_reads_only_the_range(both_stores, cohort):
    """``--references`` on a store is answered from its position index:
    the job streams exactly the variants of the ranges, as JAX's."""
    jdir, _ = both_stores
    refs = ["chr1:1100:1400", "chr2:50000:50500"]
    jjob, tjob = _jobs(jdir, "ibs", refs=refs)
    tg = trunner.run_gram(tjob, trunner.build_source(tjob.ingest, "cpu"),
                          PhaseTimer())
    jg = jrunner.run_gram(jjob, jrunner.build_source(jjob.ingest),
                          JPhaseTimer())
    assert tg.n_variants == jg.n_variants == 300 + 500
    for leaf in jg.acc:
        np.testing.assert_array_equal(tg.acc[leaf].numpy(),
                                      np.asarray(jg.acc[leaf]))


def test_cli_ingest_then_pcoa_from_the_store(tmp_path, files, capsys):
    """`ingest` then `pcoa --source store:<dir>` through the port's CLI:
    the summary line as JAX's, the store JAX's, and the coordinates the
    straight-from-VCF run's."""
    from spark_examples_tpu.cli.main import main as jmain

    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    argv = ["ingest", "--source", "vcf", "--path", files["vcf"],
            "--chunk-variants", "512", "--ingest-workers", "2"]
    assert tmain(argv + ["--device", "cpu", "--output-path", tdir]) == 0
    out = capsys.readouterr().out
    assert "content-addressed chunks" in out and "x zlib)" in out
    assert f"--source store:{tdir}" in out
    assert jmain(argv + ["--output-path", jdir]) == 0
    capsys.readouterr()
    m_t = json.load(open(os.path.join(tdir, "manifest.json")))
    m_j = json.load(open(os.path.join(jdir, "manifest.json")))
    assert m_t.pop("origin")["path"] == m_j.pop("origin")["path"]
    assert m_t == m_j
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    assert tmain(["pcoa", "--device", "cpu", "--source", f"store:{tdir}",
                  "--num-pc", "3", "--block-variants", "256",
                  "--output-path", a]) == 0
    assert tmain(["pcoa", "--device", "cpu", "--source", "vcf", "--path",
                  files["vcf"], "--num-pc", "3", "--block-variants", "256",
                  "--output-path", b]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(np.loadtxt(a, skiprows=1, usecols=(1, 2)),
                                  np.loadtxt(b, skiprows=1, usecols=(1, 2)))


# ------------------------------------------------ the port's own store cases

def _materialize(source, bv, start=0):
    blocks = [b for b, _ in source.blocks(bv, start)]
    return np.concatenate(blocks, axis=1) if blocks else None


def _materialize_packed(source, bv, start=0):
    return np.concatenate(
        [bitpack.unpack_dosages_np(pb)[:, :m.stop - m.start]
         for pb, m in source.packed_blocks(bv, start)], axis=1)


@pytest.fixture
def small_store(tmp_path, genotypes):
    """A store over the shared 37 x 211 cohort, chunk width 32 (a
    ragged tail chunk included)."""
    src = ArraySource(genotypes, contig="chr9",
                      positions=np.arange(1000, 1211, dtype=np.int64))
    d = str(tmp_path / "store")
    tstore.compact(d, src, chunk_variants=32)
    return d


@pytest.mark.parametrize("bv", [32, 64, 100, 256, 501, 1024])
def test_roundtrip_bit_identity_synthetic(tmp_path, bv):
    src = SyntheticSource(n_samples=13, n_variants=501, seed=11)
    d = str(tmp_path / "s")
    m = tstore.compact(d, src, chunk_variants=64)
    assert m.n_variants == 501 and len(m.chunks) == 8
    st = tstore.open_store(d)
    want = _materialize(src, 64)
    np.testing.assert_array_equal(_materialize(st, bv), want)
    if bv % 4 == 0:
        np.testing.assert_array_equal(_materialize_packed(st, bv), want)
    assert st.exact_n_variants


def test_compaction_dedupes_identical_chunks(tmp_path):
    g = np.zeros((5, 96), np.int8)
    d = str(tmp_path / "s")
    m = tstore.compact(d, ArraySource(g), chunk_variants=32)
    assert len(m.chunks) == 3 and len({c.digest for c in m.chunks}) == 1
    assert len(os.listdir(os.path.join(d, "chunks"))) == 1
    np.testing.assert_array_equal(_materialize(tstore.open_store(d), 40), g)


def test_recompaction_heals_wrong_sized_chunk(tmp_path, genotypes):
    src = ArraySource(genotypes)
    d = str(tmp_path / "s")
    m = tstore.compact(d, src, chunk_variants=64)
    with open(os.path.join(d, m.chunks[1].filename()), "r+b") as f:
        f.truncate(5)
    tstore.compact(d, src, chunk_variants=64)
    np.testing.assert_array_equal(_materialize(tstore.open_store(d), 64),
                                  genotypes)


@pytest.mark.parametrize("lo,hi", [(0, 32), (31, 33), (32, 64), (15, 97),
                                   (96, 211), (210, 211), (207, 211),
                                   (0, 211), (64, 64)])
def test_range_queries_at_chunk_boundaries(small_store, genotypes, lo, hi):
    st = tstore.open_store(small_store)
    np.testing.assert_array_equal(st.read_range(lo, hi), genotypes[:, lo:hi])
    rs = st.variant_range(lo, hi)
    assert rs.n_variants == hi - lo
    if hi > lo:
        np.testing.assert_array_equal(_materialize(rs, 13),
                                      genotypes[:, lo:hi])
        out = np.full((st.n_samples, hi - lo + 3), 9, np.int8)
        st.decode_range_into(lo, hi, out, col_off=2)
        np.testing.assert_array_equal(out[:, 2:2 + hi - lo],
                                      genotypes[:, lo:hi])
        assert (out[:, :2] == 9).all() and (out[:, -1] == 9).all()
    with pytest.raises(ValueError, match="out of bounds"):
        st.read_range(0, 212)


def test_resume_cursors(small_store):
    st = tstore.open_store(small_store)
    full = list(st.blocks(48))
    cursor = full[2][1].stop
    resumed = list(st.blocks(48, start_variant=cursor))
    assert [m.start for _, m in resumed] == [m.start for _, m in full[3:]]
    for (a, _), (b, _) in zip(resumed, full[3:]):
        np.testing.assert_array_equal(a, b)
    pk = list(st.packed_blocks(48, start_variant=cursor))
    assert [m.start for _, m in pk] == [m.start for _, m in full[3:]]
    rs = st.variant_range(31, 180)
    rfull = list(rs.blocks(40))
    rres = list(rs.blocks(40, start_variant=rfull[1][1].stop))
    np.testing.assert_array_equal(rres[0][0], rfull[2][0])


def test_decode_cache_accounting_and_eviction(small_store, genotypes):
    st = tstore.open_store(small_store)
    _materialize(st, 32)
    s1 = st.cache.stats()
    assert s1["misses"] == 7 and s1["entries"] == 7
    _materialize(st, 32)
    s2 = st.cache.stats()
    assert s2["misses"] == 7 and s2["hits"] >= 7
    assert s2["bytes"] == genotypes.nbytes
    small = tstore.open_store(small_store, cache_bytes=2500)
    for _ in range(2):
        np.testing.assert_array_equal(_materialize(small, 32), genotypes)
    s = small.cache.stats()
    assert s["evictions"] > 0 and s["bytes"] <= 2500
    none = tstore.open_store(small_store, cache_bytes=0)
    np.testing.assert_array_equal(_materialize(none, 32), genotypes)
    assert none.cache.stats()["entries"] == 0


@pytest.mark.parametrize("how,match", [
    ("missing", "not a dataset store"),
    ("no_version", "pre-versioning"),
    ("future", "newer than this build"),
    ("no_chunks", "chunks"),
    ("truncated", "unreadable"),
    ("bad_codec", "unknown codec"),
])
def test_manifest_format_errors_match_jax(small_store, how, match):
    path = os.path.join(small_store, "manifest.json")
    m = json.load(open(path))
    if how == "missing":
        os.remove(path)
    elif how == "truncated":
        raw = open(path).read()
        open(path, "w").write(raw[:len(raw) // 2])
    else:
        if how == "no_version":
            del m["schema_version"]
        elif how == "future":
            m["schema_version"] = 99
        elif how == "no_chunks":
            del m["chunks"]
        else:
            m["chunks"][0][6] = "lz77"
        json.dump(m, open(path, "w"))
    with pytest.raises(tstore.StoreFormatError, match=match) as got:
        tstore.open_store(small_store)
    with pytest.raises(jstore.StoreFormatError) as want:
        jstore.open_store(small_store)
    assert str(got.value) == str(want.value)


def test_store_exports_match_jax():
    def exports(pkg):
        return sorted(n for n, v in vars(pkg).items()
                      if not n.startswith("_") and not inspect.ismodule(v))

    assert exports(tstore) == exports(jstore)


def test_range_source_spans_match_blocks(small_store):
    """block_spans + decode_range_into (local coordinates) of a range
    source reproduce its blocks(), and the feed's dense drive of that
    range equals the padded blocks."""
    store = tstore.open_store(small_store)
    rng_src = store.variant_range(48, 176)
    spans = list(rng_src.block_spans(40))
    via_blocks = list(rng_src.blocks(40))
    assert len(spans) == len(via_blocks)
    for (lo, hi, meta), (blk, bmeta) in zip(spans, via_blocks):
        assert (meta.start, meta.stop) == (bmeta.start, bmeta.stop)
        out = np.full((store.n_samples, hi - lo), -9, np.int8)
        rng_src.decode_range_into(lo, hi, out)
        np.testing.assert_array_equal(out, blk)
    with pytest.raises(ValueError, match="out of bounds"):
        rng_src.decode_range_into(0, 1000,
                                  np.empty((store.n_samples, 1000), np.int8))


@pytest.mark.parametrize("damage", ["truncate", "missing"])
def test_damage_is_not_retried(small_store, damage):
    """Damage is not weather: a truncated or missing chunk behind the
    retry boundary quarantines and fails with the cursor, spending none
    of the retry budget."""
    from spark_examples_tpu_torch.core import faults, telemetry
    from spark_examples_tpu_torch.ingest.resilient import (
        RetryingSource,
        RetryPolicy,
    )

    st = tstore.open_store(small_store)
    if damage == "missing":
        os.remove(os.path.join(small_store, st.manifest.chunks[3].filename()))
        spec, cursor = [], 96
    else:
        spec, cursor = ["store.read:truncate:after=1:keep=4"], 32
    before = telemetry.counter_value("ingest.retries")
    rs = RetryingSource(tstore.open_store(small_store),
                        policy=RetryPolicy(max_retries=3, backoff_s=0.001),
                        reopen=lambda: tstore.open_store(small_store))
    with faults.armed(spec), pytest.raises(tstore.StoreCorruptError) as e:
        _materialize(rs, 32)
    assert e.value.cursor == cursor
    assert f"start_variant={cursor}" in str(e.value)
    assert telemetry.counter_value("ingest.retries") == before
    q = json.load(open(os.path.join(small_store, "quarantine.json")))
    assert [x["start"] for x in q] == [cursor]


def test_transient_io_error_recovered_bit_identically(small_store,
                                                      genotypes):
    from spark_examples_tpu_torch.core import faults, telemetry
    from spark_examples_tpu_torch.ingest.resilient import (
        RetryingSource,
        RetryPolicy,
    )

    before = telemetry.counter_value("ingest.retries")
    with faults.armed(["store.read:io_error:after=3:max=2"]) as inj:
        rs = RetryingSource(tstore.open_store(small_store),
                            policy=RetryPolicy(max_retries=2,
                                               backoff_s=0.001),
                            reopen=lambda: tstore.open_store(small_store))
        with pytest.warns(RuntimeWarning, match="transient ingest error"):
            got = _materialize(rs, 32)
        assert inj.fire_count("store.read") == 2
    np.testing.assert_array_equal(got, genotypes)
    assert telemetry.counter_value("ingest.retries") == before + 2
