"""The port's parallel and retrying ingest, its fault harness and its
metrics registry, on the CPU, against the JAX package's where both
run: ``parallel_map_ordered`` keeps order and raises a worker's error
on its turn; ``vcf_byte_shards`` and ``parallel_blocks`` equal JAX's
and the serial stream; ``RetryingSource`` under injected ``io_error``
yields the same blocks as a clean read (and as JAX's under the same
spec), and when exhausted its error carries the cursor; a parallel
compaction's worker faults are retried or surface with the in-order
cursor; the store's readahead workers hold their errors for the
consumer."""

import gzip
import os
import shutil
import threading
import warnings

import numpy as np
import pytest

from spark_examples_tpu.core import faults as jfaults
from spark_examples_tpu.ingest import parallel as jparallel
from spark_examples_tpu.ingest import resilient as jresilient
from spark_examples_tpu.ingest import vcf as jvcf
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest import parallel as tparallel
from spark_examples_tpu_torch.ingest.packed import save_packed
from spark_examples_tpu_torch.ingest.parallel import (
    parallel_blocks,
    parallel_map_ordered,
    vcf_byte_shards,
)
from spark_examples_tpu_torch.ingest.plink import write_plink
from spark_examples_tpu_torch.ingest.resilient import (
    CorruptBlockError,
    IngestExhaustedError,
    RetryingSource,
    RetryPolicy,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ingest.vcf import VcfSource
from spark_examples_tpu_torch.pipelines import runner
from spark_examples_tpu_torch.store import (
    StoreCorruptError,
    compact,
    open_store,
)

from conftest import random_genotypes

FAST = RetryPolicy(max_retries=3, backoff_s=0.001)


def _metas(stream):
    return [(m.index, m.start, m.stop, m.contig) for _, m in stream]


def _materialize(source, bv, start=0):
    return np.concatenate([b for b, _ in source.blocks(bv, start)], axis=1)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture
def multi_vcf(tmp_path, monkeypatch):
    """A two-contig VCF (chr1 x 530 + chr2 x 190, 48 samples) with small
    forced shards, in both packages."""
    rng = np.random.default_rng(21)
    g1, g2 = random_genotypes(rng, 48, 530), random_genotypes(rng, 48, 190)
    p1, p2 = str(tmp_path / "a.vcf"), str(tmp_path / "b.vcf")
    jvcf.write_vcf(p1, g1, contig="chr1", start_pos=100)
    jvcf.write_vcf(p2, g2, contig="chr2", start_pos=5000)
    header = [ln for ln in open(p1) if ln.startswith("#")]
    records = [ln for p in (p1, p2) for ln in open(p)
               if not ln.startswith("#")]
    multi = str(tmp_path / "multi.vcf")
    open(multi, "w").writelines(header + records)
    monkeypatch.setattr(tparallel, "VCF_SHARD_BYTES", 8192)
    monkeypatch.setattr(jparallel, "VCF_SHARD_BYTES", 8192)
    return multi, np.concatenate([g1, g2], axis=1)


# ------------------------------------------------ the ordered reassembly

@pytest.mark.parametrize("workers", [1, 2, 5, 16])
def test_parallel_map_ordered_preserves_order(workers):
    out = list(parallel_map_ordered(range(64), lambda x: x * x, workers))
    assert out == [x * x for x in range(64)]


@pytest.mark.parametrize("workers", [1, 4])
def test_parallel_map_ordered_raises_in_order(workers):
    seen = []

    def fn(x):
        if x == 7:
            raise RuntimeError("worker died")
        return x

    with pytest.raises(RuntimeError, match="worker died"):
        for v in parallel_map_ordered(range(32), fn, workers):
            seen.append(v)
    assert seen == list(range(7))


def test_parallel_map_ordered_leaves_no_thread_running():
    gate = threading.Event()

    def fn(x):
        if x == 3:
            raise ValueError("bad")
        gate.wait(0.05)
        return x

    with pytest.raises(ValueError):
        list(parallel_map_ordered(range(40), fn, 4, name="leak-check"))
    for t in threading.enumerate():
        if t.name.startswith("leak-check"):
            t.join(timeout=5)
    assert not any(t.name.startswith("leak-check") and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------------- parallel parse

def test_vcf_byte_shards_match_jax(multi_vcf):
    path, _ = multi_vcf
    for target in (512, 4096, 10**6):
        shards = vcf_byte_shards(path, target_bytes=target)
        assert shards == jparallel.vcf_byte_shards(path, target_bytes=target)
        for (a, b), (c, _) in zip(shards, shards[1:]):
            assert b == c and b > a
        assert shards[-1][1] == os.path.getsize(path)
    assert len(vcf_byte_shards(path, target_bytes=512, max_shards=3)) == 3


@pytest.mark.parametrize("bv", [16, 100, 512])
def test_parallel_vcf_blocks_equal_serial_and_jax(multi_vcf, bv):
    path, want = multi_vcf
    serial = list(VcfSource(path).blocks(bv))
    par = list(parallel_blocks(VcfSource(path), bv, 4))
    jpar = list(jparallel.parallel_blocks(jvcf.VcfSource(path), bv, 4))
    assert _metas(serial) == _metas(par) == _metas(jpar)
    for (a, ma), (b, mb), (c, mc) in zip(serial, par, jpar):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(ma.positions, mb.positions)
        np.testing.assert_array_equal(mb.positions, mc.positions)
    np.testing.assert_array_equal(
        np.concatenate([b for b, _ in par], axis=1), want)


@pytest.mark.parametrize("make", ["synthetic", "array", "packed", "store"])
def test_parallel_blocks_stripe_mode_equals_serial(make, tmp_path):
    g = random_genotypes(np.random.default_rng(2), 9, 700)
    if make == "synthetic":
        src = SyntheticSource(n_samples=9, n_variants=700, seed=3)
    elif make == "array":
        src = ArraySource(g)
    elif make == "packed":
        save_packed(str(tmp_path / "p"), g)
        src = runner.build_source(IngestConfig(source="packed",
                                               path=str(tmp_path / "p")))
    else:
        compact(str(tmp_path / "s"), ArraySource(g), chunk_variants=128)
        src = runner.build_source(IngestConfig(
            source="store", path=str(tmp_path / "s")), "cpu")
    assert src.exact_n_variants
    before = telemetry.counter_value("ingest.parallel_shards")
    serial, par = list(src.blocks(64)), list(parallel_blocks(src, 64, 4))
    assert telemetry.counter_value("ingest.parallel_shards") == before + 11
    assert _metas(serial) == _metas(par)
    for (a, _), (b, _) in zip(serial, par):
        np.testing.assert_array_equal(a, b)


def test_parallel_blocks_serial_fallback(multi_vcf, tmp_path):
    """gzip cannot seek, and a multi-contig store makes no exact claim:
    both stream serially, unchanged."""
    path, want = multi_vcf
    gz = str(tmp_path / "m.vcf.gz")
    with open(path, "rb") as f_in, gzip.open(gz, "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    before = telemetry.counter_value("ingest.parallel_shards")
    got = np.concatenate(
        [b for b, _ in parallel_blocks(VcfSource(gz), 16, 4)], axis=1)
    np.testing.assert_array_equal(got, want)
    compact(str(tmp_path / "s"), VcfSource(path), chunk_variants=128)
    st = open_store(str(tmp_path / "s"))
    assert not st.exact_n_variants
    assert _metas(parallel_blocks(st, 100, 4)) == _metas(st.blocks(100))
    assert telemetry.counter_value("ingest.parallel_shards") == before


def test_compact_parallel_recovers_injected_worker_fault(multi_vcf,
                                                         tmp_path):
    path, _ = multi_vcf
    clean, faulty = str(tmp_path / "clean"), str(tmp_path / "faulty")
    compact(clean, VcfSource(path), chunk_variants=64, workers=4)
    src = RetryingSource(VcfSource(path), policy=FAST)
    with faults.armed(["ingest.block_read:io_error:after=1:max=2"]) as inj, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        compact(faulty, src, chunk_variants=64, workers=4)
        assert inj.fire_count("ingest.block_read") == 2
    assert _tree(clean) == _tree(faulty)


def test_compact_parallel_exhaustion_names_inorder_cursor(multi_vcf,
                                                          tmp_path):
    path, _ = multi_vcf
    d = str(tmp_path / "dead")
    src = RetryingSource(VcfSource(path),
                         policy=RetryPolicy(max_retries=1, backoff_s=0.001))
    with faults.armed(["ingest.block_read:io_error:after=3:max=0"]), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(IngestExhaustedError) as ei:
            compact(d, src, chunk_variants=64, workers=4)
    assert ei.value.cursor >= 0 and ei.value.cursor % 64 == 0
    assert f"start_variant={ei.value.cursor}" in str(ei.value)
    assert not os.path.exists(os.path.join(d, "manifest.json"))


def test_compact_rejects_bad_arguments(tmp_path, genotypes):
    for kw, match in ((dict(workers=0), "workers"),
                      (dict(chunk_variants=30), "multiple of 4"),
                      (dict(codec="lz77"), "store_codec")):
        with pytest.raises(ValueError, match=match):
            compact(str(tmp_path / "s"), ArraySource(genotypes), **kw)


# -------------------------------------------------------- fault harness

def test_spec_parse_and_sites():
    s = faults.FaultSpec.parse("ingest.block_read:io_error:p=0.5:after=3:max=2")
    assert (s.site, s.kind, s.probability, s.after, s.max_fires) == \
        ("ingest.block_read", "io_error", 0.5, 3, 2)
    j = jfaults.FaultSpec.parse("ingest.block_read:io_error:p=0.5:after=3:"
                                "max=2")
    assert (s.delay_s, s.keep_bytes) == (j.delay_s, j.keep_bytes)
    assert set(faults.SITES) <= set(jfaults.SITES)
    assert faults.KINDS == jfaults.KINDS
    for bad, match in (("nonsite:io_error", "unknown fault site"),
                       ("store.read:explode", "unknown fault kind"),
                       ("store.read:delay:frequency=2", "valid keys"),
                       ("store.read", "expected site:kind")):
        with pytest.raises(ValueError, match=match):
            faults.FaultSpec.parse(bad)


def test_injector_after_and_max_are_deterministic():
    with faults.armed(["store.read:io_error:after=2:max=2"]) as inj:
        fired = []
        for _ in range(6):
            try:
                faults.fire("store.read")
                fired.append(False)
            except faults.InjectedFault:
                fired.append(True)
        assert fired == [False, False, True, True, False, False]
        assert inj.fire_count("store.read") == 2
        assert inj.hit_count("store.read") == 6
    assert faults.fire_count("store.read") == 0
    faults.fire("store.read")  # disarmed: a no-op


def test_env_arming_and_delay(monkeypatch):
    monkeypatch.setenv(faults.ENV_SPECS,
                       "store.read:delay:delay=0.001:max=1;"
                       "ingest.block_read:io_error")
    inj = faults.from_env()
    try:
        assert [s.kind for s in inj.specs] == ["delay", "io_error"]
        faults.fire("store.read")
        with pytest.raises(faults.InjectedFault):
            faults.fire("ingest.block_read")
    finally:
        faults.disarm()
    monkeypatch.delenv(faults.ENV_SPECS)
    assert faults.from_env() is None


def test_truncate_needs_a_path(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"0123456789")
    with faults.armed(["store.read:truncate:keep=3:max=2"]):
        faults.fire("store.read", path=str(p))
        with pytest.raises(ValueError, match="no file path"):
            faults.fire("store.read")
    assert p.read_bytes() == b"012"


# ------------------------------------------------------- retrying source

def test_retry_transient_io_error_matches_clean_and_jax():
    g = random_genotypes(np.random.default_rng(5), 12, 700)
    clean = list(ArraySource(g).blocks(128))
    spec = ["ingest.block_read:io_error:after=2:max=2"]
    with faults.armed(spec) as inj:
        with pytest.warns(RuntimeWarning, match="transient ingest error"):
            got = [(b.copy(), m) for b, m in
                   RetryingSource(ArraySource(g), policy=FAST).blocks(128)]
        assert inj.fire_count("ingest.block_read") == 2
    with jfaults.armed(spec):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = list(jresilient.RetryingSource(
                JArraySource(g), policy=jresilient.RetryPolicy(
                    max_retries=3, backoff_s=0.001)).blocks(128))
    assert _metas(got) == _metas(clean) == _metas(want)
    for (a, _), (b, _), (c, _) in zip(got, clean, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_retry_exhaustion_names_cursor():
    g = random_genotypes(np.random.default_rng(6), 8, 512)
    src = RetryingSource(ArraySource(g),
                         policy=RetryPolicy(max_retries=1, backoff_s=0.001))
    before = telemetry.counter_value("ingest.exhausted")
    with faults.armed(["ingest.block_read:io_error:after=2:max=0"]):
        with pytest.raises(IngestExhaustedError, match="cursor 256") as ei:
            with pytest.warns(RuntimeWarning):
                list(src.blocks(128))
    assert ei.value.cursor == 256
    assert "start_variant=256" in str(ei.value)
    assert telemetry.counter_value("ingest.exhausted") == before + 1


def test_retry_budget_resets_on_progress():
    g = random_genotypes(np.random.default_rng(7), 8, 1024)
    src = RetryingSource(ArraySource(g),
                         policy=RetryPolicy(max_retries=1, backoff_s=0.001))
    specs = [f"ingest.block_read:io_error:after={a}:max=1"
             for a in (1, 4, 7, 10)]
    with faults.armed(specs) as inj:
        with pytest.warns(RuntimeWarning):
            got = list(src.blocks(128))
        assert inj.fire_count("ingest.block_read") == 4
    np.testing.assert_array_equal(
        np.concatenate([b for b, _ in got], axis=1), g)


def test_reopen_rebuilds_and_closes_the_old_source():
    g = random_genotypes(np.random.default_rng(8), 8, 512)
    closed = []

    class DeadMapping(ArraySource):
        def blocks(self, block_variants, start_variant=0):
            raise IOError("stale mapping")
            yield  # pragma: no cover

        def close(self):
            closed.append(self)

    src = RetryingSource(DeadMapping(g), policy=FAST,
                         reopen=lambda: ArraySource(g))
    with pytest.warns(RuntimeWarning, match="transient ingest error"):
        got = _materialize(src, 128)
    np.testing.assert_array_equal(got, g)
    assert len(closed) == 1


def test_reopen_failure_consumes_retry_budget():
    g = random_genotypes(np.random.default_rng(9), 8, 512)

    class DeadMapping(ArraySource):
        def blocks(self, block_variants, start_variant=0):
            raise IOError("stale mapping")
            yield  # pragma: no cover

    def always_dead():
        raise IOError("mount still down")

    src = RetryingSource(DeadMapping(g),
                         policy=RetryPolicy(max_retries=2, backoff_s=0.001),
                         reopen=always_dead)
    with pytest.raises(IngestExhaustedError, match="cursor 0"):
        with pytest.warns(RuntimeWarning):
            list(src.blocks(128))


def test_corrupt_block_fails_fast_with_cursor():
    g = random_genotypes(np.random.default_rng(10), 10, 512)

    class Corrupting(ArraySource):
        def blocks(self, bv, start_variant=0):
            for b, m in super().blocks(bv, start_variant):
                yield (b[:-1] if m.start == 256 else b), m

    with pytest.raises(CorruptBlockError, match="cursor 256") as ei:
        list(RetryingSource(Corrupting(g), policy=FAST).blocks(128))
    assert ei.value.cursor == 256


@pytest.mark.parametrize("source", ["vcf", "plink", "packed", "store"])
def test_build_source_wraps_file_sources(tmp_path, source):
    g = random_genotypes(np.random.default_rng(11), 8, 256, 0.0)
    path = str(tmp_path / "in")
    if source == "vcf":
        path += ".vcf"
        jvcf.write_vcf(path, g)
    elif source == "plink":
        write_plink(path, g)
    elif source == "packed":
        save_packed(path, g)
    else:
        compact(path, ArraySource(g), chunk_variants=64)
    src = runner.build_source(IngestConfig(source=source, path=path),
                              "cpu")
    assert isinstance(src, RetryingSource)
    assert (src.reopen is not None) == (source in ("packed", "store"))
    assert hasattr(src, "packed_blocks") == (source in ("packed", "store"))
    np.testing.assert_array_equal(_materialize(src, 100), g)
    bare = runner.build_source(
        IngestConfig(source=source, path=path, io_retries=0), "cpu")
    assert not isinstance(bare, RetryingSource)
    syn = runner.build_source(IngestConfig(n_samples=8, n_variants=64),
                              "cpu")
    assert not isinstance(syn, RetryingSource)


@pytest.mark.parametrize("metric", ["ibs", "euclidean"])
def test_store_job_under_injected_faults_is_bit_exact(tmp_path, metric):
    """A similarity job from a store (readahead on) whose chunk reads
    fail twice and whose readahead warm fails once matches the clean
    run bitwise, on the packed (ibs) and dense (euclidean) transports."""
    g = random_genotypes(np.random.default_rng(12), 16, 1024)
    d = str(tmp_path / "s")
    compact(d, ArraySource(g), chunk_variants=128)
    job = JobConfig(
        ingest=IngestConfig(source=f"store:{d}", block_variants=128,
                            io_retry_backoff_s=0.001),
        compute=ComputeConfig(metric=metric, device="cpu"))
    others = set(threading.enumerate())
    clean = runner.run_similarity(job)
    with faults.armed(["store.read:io_error:after=3:max=2",
                       "store.readahead.decode:io_error:after=2:max=1"]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            chaotic = runner.run_similarity(job)
    np.testing.assert_array_equal(chaotic.similarity, clean.similarity)
    # Threads of this process's other stores (the JAX package's readers
    # are never closed) are not this job's.
    assert not [t for t in threading.enumerate()
                if t not in others and t.name.startswith("store-readahead")]


# ---------------------------------------------------------- readahead

@pytest.fixture
def store_dir(tmp_path, genotypes):
    src = ArraySource(genotypes, contig="chr9",
                      positions=np.arange(1000, 1211, dtype=np.int64))
    d = str(tmp_path / "store")
    compact(d, src, chunk_variants=32)
    return d


@pytest.mark.parametrize("bv", [16, 32, 50, 128])
def test_readahead_stream_bit_identical(store_dir, genotypes, bv):
    ra = open_store(store_dir, readahead_chunks=3)
    try:
        np.testing.assert_array_equal(_materialize(ra, bv), genotypes)
        if bv % 4 == 0:
            cols = [bitpack.unpack_dosages_np(pb)[:, :m.stop - m.start]
                    for pb, m in ra.packed_blocks(bv)]
            np.testing.assert_array_equal(np.concatenate(cols, axis=1),
                                          genotypes)
    finally:
        ra.close()
    assert telemetry.counter_value("store.readahead.scheduled") > 0


def test_readahead_worker_ioerror_rides_retry_boundary(store_dir,
                                                       genotypes):
    src = RetryingSource(
        open_store(store_dir, readahead_chunks=3), policy=FAST,
        reopen=lambda: open_store(store_dir, readahead_chunks=3))
    with faults.armed(["store.read:io_error:after=2:max=2"]), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = _materialize(src, 32)
    src.close()
    np.testing.assert_array_equal(got, genotypes)


def test_readahead_worker_corruption_fails_fast_with_cursor(store_dir):
    st = open_store(store_dir, readahead_chunks=3)
    try:
        with faults.armed(["store.read:truncate:after=3:max=1:keep=4"]):
            with pytest.raises(StoreCorruptError) as ei:
                _materialize(st, 32)
        assert ei.value.cursor % 32 == 0
        assert os.path.exists(os.path.join(store_dir, "quarantine.json"))
    finally:
        st.close()


# ----------------------------------------------------- metrics registry

def test_registry_counts_gauges_histograms_and_spans():
    telemetry.reset()
    assert telemetry.count("store.healed", 2.0) == 2.0
    telemetry.gauge_set("store.cache_bytes", 5)
    telemetry.gauge_set("store.cache_bytes", 3)
    telemetry.observe("store.readahead.wait_s", 0.25)
    with telemetry.span("store.heal"):
        pass

    @telemetry.traced("store.compact")
    def f():
        return 7

    assert f() == 7
    snap = telemetry.metrics_snapshot()
    assert snap["gauges"]["store.cache_bytes"] == \
        {"last": 3.0, "min": 3.0, "max": 5.0, "n": 2}
    assert telemetry.histogram_sum("store.readahead.wait_s") == 0.25
    assert snap["histograms"]["store.readahead.wait_s"]["p50"] == 0.25
    assert snap["histograms"]["store.heal"]["count"] >= 1
    assert snap["histograms"]["store.compact"]["count"] >= 1


def test_undeclared_name_warns_once_and_counts():
    telemetry.reset()
    with pytest.warns(RuntimeWarning, match="not declared"):
        telemetry.count("store.typo")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        telemetry.count("store.typo")
    assert telemetry.counter_value("telemetry.unknown_names") == 2.0
    telemetry.reset()
    assert telemetry.metrics_snapshot() == \
        {"counters": {}, "phases": {}, "gauges": {}, "histograms": {},
         "derived": {}}


def test_names_are_declared_in_jax_too():
    from spark_examples_tpu.core import telemetry as jtelemetry

    assert all(jtelemetry.is_declared(n) for n in telemetry.NAMES)
