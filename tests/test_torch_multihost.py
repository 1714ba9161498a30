"""The multi-process ingest pieces of the port against the JAX package's,
in one process on the CPU:

- ``partition_ranges``, ``window_for_process`` and ``WindowSource``
  (dense, packed and store-decode transports) equal to JAX's;
- ``PartitionedSource`` (``--splits-per-contig``) bitwise JAX's and a
  ``ChainSource`` over the same parts: blocks, metadata and resume
  cursors, on a two-contig VCF and on PLINK with references;
- the consensus feeder on one rank against JAX's
  ``test_stream_global_blocks_double_buffer_and_feed_bytes``: order,
  content and ``multihost.shard_feed_bytes``;
- ``--splits-per-contig 4`` job accumulators bitwise the one-split run
  and JAX's, and the flag's bounds;
- the collectives' one-process identities and ``plan_for`` across ranks.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import meshes as jmeshes
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu.core.profiling import PhaseTimer as JTimer
from spark_examples_tpu.ingest import packed as jpacked
from spark_examples_tpu.ingest import plink as jplink
from spark_examples_tpu.ingest import source as jsource
from spark_examples_tpu.ingest import vcf as jvcf
from spark_examples_tpu.ingest.partitioned import (
    PartitionedSource as JPartitioned,
)
from spark_examples_tpu.parallel import gram_sharded as jgs
from spark_examples_tpu.parallel import multihost as jmh
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch import store as tstore
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import meshes, telemetry
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest import packed as tpacked
from spark_examples_tpu_torch.ingest import plink as tplink
from spark_examples_tpu_torch.ingest import source as tsource
from spark_examples_tpu_torch.ingest import vcf as tvcf
from spark_examples_tpu_torch.ingest.partitioned import PartitionedSource
from spark_examples_tpu_torch.parallel import gram_sharded as gs
from spark_examples_tpu_torch.parallel import multihost as mh
from spark_examples_tpu_torch.pipelines import runner

from conftest import random_genotypes


def assert_same_stream(got, want):
    """Two (block, BlockMeta) lists: equal blocks, every meta field."""
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert np.asarray(gb).dtype == np.asarray(wb).dtype
        np.testing.assert_array_equal(np.asarray(gb), np.asarray(wb))
        assert (gm.index, gm.start, gm.stop, gm.contig) == \
            (wm.index, wm.start, wm.stop, wm.contig)
        if wm.positions is None:
            assert gm.positions is None
        else:
            np.testing.assert_array_equal(gm.positions, wm.positions)


@pytest.fixture(scope="module")
def cohort():
    return random_genotypes(np.random.default_rng(41), 13, 300, 0.15)


# ------------------------------------------------- ranges and windows

@pytest.mark.parametrize("splits", [1, 2, 3, 4, 7, 1000])
def test_partition_ranges_matches_jax(splits):
    specs = ["chr1:100:1000", "chr2:5:6", "chr3:0:999", "chrX:10:11"]
    got = tsource.partition_ranges(
        [tconfig.ReferenceRange.parse(s) for s in specs], splits)
    want = jsource.partition_ranges(
        [jconfig.ReferenceRange.parse(s) for s in specs], splits)
    assert [str(r) for r in got] == [str(r) for r in want]
    assert all(isinstance(r, tconfig.ReferenceRange) for r in got)


@pytest.mark.parametrize("v,bv,p", [(1280, 256, 2), (100_000, 8192, 2),
                                    (1000, 128, 3), (300, 64, 8),
                                    (0, 64, 2), (64, 64, 4)])
def test_window_for_process_matches_jax(v, bv, p):
    got = [tsource.window_for_process(v, bv, i, p) for i in range(p)]
    want = [jsource.window_for_process(v, bv, i, p) for i in range(p)]
    assert got == want
    # Contiguous, covering every variant once.
    assert got[0][0] == 0 and got[-1][1] == v
    for (_, stop), (start, _) in zip(got, got[1:]):
        assert stop == start


@pytest.mark.parametrize("bv", [64, 100])
def test_window_source_matches_jax(cohort, bv):
    pos = np.arange(cohort.shape[1], dtype=np.int64) * 3 + 7
    t_in = tsource.ArraySource(cohort, contig="chr9", positions=pos)
    j_in = jsource.ArraySource(cohort, contig="chr9", positions=pos)
    for p in range(3):
        start, stop = tsource.window_for_process(cohort.shape[1], bv, p, 3)
        t = tsource.WindowSource(t_in, start, stop)
        j = jsource.WindowSource(j_in, start, stop)
        assert (t.n_variants, t.exact_n_variants) == (j.n_variants, True)
        assert_same_stream(list(t.blocks(bv)), list(j.blocks(bv)))
        assert_same_stream(list(t.blocks(bv, bv)), list(j.blocks(bv, bv)))
    with pytest.raises(ValueError, match="not aligned"):
        list(tsource.WindowSource(t_in, bv + 1, 300).blocks(bv))
    with pytest.raises(ValueError, match="out of range"):
        tsource.WindowSource(t_in, 0, 301)


def test_window_source_forwards_the_packed_transport(tmp_path, cohort):
    path = str(tmp_path / "st")
    jpacked.save_packed(path, cohort)
    t_in, j_in = tpacked.load_packed(path), jpacked.load_packed(path)
    t = tsource.WindowSource(t_in, 128, 300)
    j = jsource.WindowSource(j_in, 128, 300)
    assert hasattr(t, "packed_blocks") and hasattr(j, "packed_blocks")
    assert_same_stream(list(t.packed_blocks(64)),
                       list(j.packed_blocks(64)))
    assert not hasattr(tsource.WindowSource(
        tsource.ArraySource(cohort), 0, 64), "packed_blocks")


def test_window_source_forwards_the_store_decode(tmp_path, cohort):
    d = str(tmp_path / "ds")
    tstore.compact(d, tsource.ArraySource(cohort), chunk_variants=64)
    src = tstore.open_store(d, device="cpu")
    try:
        w = tsource.WindowSource(src, 128, 300)
        spans = list(w.block_spans(64))
        assert [(lo, hi) for lo, hi, _ in spans] == [(0, 64), (64, 128),
                                                     (128, 172)]
        out = np.full((13, 172), -1, np.int8)
        w.decode_range_into(0, 172, out)
        np.testing.assert_array_equal(out, cohort[:, 128:300])
        with pytest.raises(ValueError, match="out of bounds"):
            w.decode_range_into(0, 173, np.empty((13, 173), np.int8))
        np.testing.assert_array_equal(
            np.concatenate([b for b, _ in w.blocks(64)], axis=1),
            cohort[:, 128:300])
    finally:
        src.close()


# --------------------------------------------------- PartitionedSource

def _two_contig_vcf(path, g):
    a, b = str(path) + ".a", str(path) + ".b"
    jvcf.write_vcf(a, g[:, :120], contig="chr21", start_pos=100)
    jvcf.write_vcf(b, g[:, 120:], contig="chr22", start_pos=5000)
    with open(path, "w") as out, open(a) as fa, open(b) as fb:
        out.write(fa.read())
        out.writelines(line for line in fb if not line.startswith("#"))


def _parts(kind, path, specs, splits):
    tcls = {"vcf": tvcf.VcfSource, "plink": tplink.PlinkSource}[kind]
    jcls = {"vcf": jvcf.VcfSource, "plink": jplink.PlinkSource}[kind]
    t = [tcls(path, references=(r,)) for r in tsource.partition_ranges(
        [tconfig.ReferenceRange.parse(s) for s in specs], splits)]
    j = [jcls(path, references=(r,)) for r in jsource.partition_ranges(
        [jconfig.ReferenceRange.parse(s) for s in specs], splits)]
    return t, j


@pytest.fixture(scope="module")
def files(tmp_path_factory, cohort):
    d = tmp_path_factory.mktemp("partitioned")
    vcf = str(d / "c.vcf")
    _two_contig_vcf(vcf, cohort)
    prefix = str(d / "cohort")
    jplink.write_plink(prefix, cohort, chroms=["1"] * 130 + ["2"] * 170,
                       positions=np.concatenate([np.arange(130) * 10 + 5,
                                                 np.arange(170) * 7 + 1]))
    return {"vcf": (vcf, ["chr21:0:1000", "chr22:4000:6000"]),
            "plink": (prefix, ["1:100:1300", "2:0:1200"])}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("kind", ["vcf", "plink"])
def test_partitioned_source_matches_jax_and_chain(files, kind, splits,
                                                  workers):
    path, specs = files[kind]
    t_parts, j_parts = _parts(kind, path, specs, splits)
    t = PartitionedSource(t_parts, max_workers=workers, buffer_blocks=2)
    j = JPartitioned(j_parts, max_workers=workers, buffer_blocks=2)
    chain = tsource.ChainSource(_parts(kind, path, specs, splits)[0])
    assert t.n_samples == j.n_samples and t.sample_ids == j.sample_ids
    for bv in (16, 50):
        got = list(t.blocks(bv))
        assert_same_stream(got, list(j.blocks(bv)))
        assert_same_stream(got, list(chain.blocks(bv)))
        # Resume at every cursor the stream itself produced.
        for _, meta in got[::3]:
            assert_same_stream(list(t.blocks(bv, meta.stop)),
                               list(j.blocks(bv, meta.stop)))
            assert_same_stream(list(t.blocks(bv, meta.stop)),
                               list(chain.blocks(bv, meta.stop)))
    assert t.n_variants == j.n_variants == chain.n_variants > 0
    assert list(t.blocks(16, t.n_variants)) == []


def test_partitioned_source_raises_a_part_s_error():
    class Broken(tsource.ArraySource):
        def blocks(self, bv, start=0):
            yield from super().blocks(bv, start)
            raise OSError("disk gone")

    g = np.zeros((4, 40), np.int8)
    src = PartitionedSource([tsource.ArraySource(g), Broken(g)])
    with pytest.raises(OSError, match="disk gone"):
        list(src.blocks(16))
    with pytest.raises(ValueError, match=">= 1 part"):
        PartitionedSource([])
    with pytest.raises(ValueError, match="disagree on n_samples"):
        PartitionedSource([tsource.ArraySource(g),
                           tsource.ArraySource(np.zeros((5, 4), np.int8))])


@pytest.mark.parametrize("kind", ["vcf", "plink"])
def test_splits_per_contig_job_bitwise_one_split_and_jax(files, kind):
    path, specs = files[kind]
    refs = [tconfig.ReferenceRange.parse(s) for s in specs]
    accs = {}
    for splits in (1, 4):
        cfg = tconfig.IngestConfig(source=kind, path=path, references=refs,
                                   block_variants=32,
                                   splits_per_contig=splits)
        src = runner.build_source(cfg, "cpu")
        if splits > 1:
            assert isinstance(src.inner, PartitionedSource)
            assert len(src.inner.parts) == 4 * len(specs)
        job = tconfig.JobConfig(ingest=cfg, compute=tconfig.ComputeConfig(
            metric="ibs", device="cpu"))
        accs[splits] = runner.run_gram(job, src, PhaseTimer()).acc
    jcfg = jconfig.IngestConfig(
        source=kind, path=path, block_variants=32, splits_per_contig=4,
        references=[jconfig.ReferenceRange.parse(s) for s in specs])
    jjob = jconfig.JobConfig(ingest=jcfg,
                             compute=jconfig.ComputeConfig(metric="ibs"))
    want = jrunner.run_gram(jjob, jrunner.build_source(jcfg), JTimer()).acc
    for k, v in want.items():
        assert torch.equal(accs[4][k], accs[1][k]), k
        np.testing.assert_array_equal(accs[4][k].numpy(), np.asarray(v), k)


def test_splits_per_contig_flag_and_bounds(files, tmp_path, capsys):
    path, specs = files["plink"]
    base = ["pcoa", "--device", "cpu", "--source", "plink", "--path", path,
            "--block-variants", "32", "--num-pc", "2"]
    refs = [a for s in specs for a in ("--references", s)]
    outs = []
    for splits in ("1", "4"):
        out = str(tmp_path / f"c{splits}.tsv")
        assert tmain(base + refs + ["--splits-per-contig", splits,
                                    "--output-path", out]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1]
    for bad in (0, 65537):
        with pytest.raises(ValueError, match="--splits-per-contig"):
            tconfig.IngestConfig(splits_per_contig=bad)
        with pytest.raises(ValueError, match="splits_per_contig"):
            jconfig.IngestConfig(splits_per_contig=bad)
    assert tconfig.IngestConfig(splits_per_contig=65536).splits_per_contig \
        == jconfig.IngestConfig(splits_per_contig=65536).splits_per_contig


# ------------------------------------------------- the consensus feeder

def test_stream_global_blocks_on_one_rank_matches_jax(genotypes):
    """One rank: the feeder streams the source's blocks in order, in
    full, counting every real slab's bytes (JAX's
    test_stream_global_blocks_double_buffer_and_feed_bytes)."""
    plan = gs.GramPlan(meshes.make_mesh(["cpu"]), "variant")
    src = tsource.ArraySource(genotypes)  # 37 x 211
    before = telemetry.counter_value("multihost.shard_feed_bytes")
    stats = {}
    got = list(mh.stream_global_blocks(src, 64, 0, plan, pack=False,
                                       stats=stats))
    fed = telemetry.counter_value("multihost.shard_feed_bytes") - before

    jplan = jgs.GramPlan(jmeshes.make_mesh(), "variant")
    jbefore = jtelemetry.counter_value("multihost.shard_feed_bytes")
    want = list(jmh.stream_global_blocks(jsource.ArraySource(genotypes), 64,
                                         0, jplan, pack=False))
    jfed = jtelemetry.counter_value("multihost.shard_feed_bytes") - jbefore
    assert len(got) == len(want) == 4
    assert fed == jfed == 4 * genotypes.shape[0] * 64
    assert stats["consensus_rounds"] == 2  # the count and the terminal
    for (b, m), (jb, jm) in zip(got, want):
        assert (m.index, m.start, m.stop) == (jm.index, jm.start, jm.stop)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    whole = np.concatenate([b.numpy()[:, :m.stop - m.start]
                            for b, m in got], axis=1)
    np.testing.assert_array_equal(whole, genotypes)


def test_stream_global_blocks_packed_and_resumed(genotypes):
    from spark_examples_tpu_torch.ingest import bitpack

    plan = gs.GramPlan(meshes.make_mesh(["cpu"]), "variant")
    got = list(mh.stream_global_blocks(tsource.ArraySource(genotypes), 64,
                                       128, plan, pack=True))
    assert [m.start for _, m in got] == [128, 192]
    assert all(b.dtype == torch.uint8 and b.shape[1] == 16 for b, _ in got)
    np.testing.assert_array_equal(
        bitpack.unpack_dosages(got[0][0]).numpy(), genotypes[:, 128:192])


# ------------------------------------------ collectives and plans, 1 rank

def test_collectives_are_identities_on_one_process():
    assert not mh.is_multihost()
    np.testing.assert_array_equal(mh.allgather(np.int64(7)), [7])
    assert mh.allgather(np.arange(3)).shape == (1, 3)
    t = torch.arange(4, dtype=torch.int32)
    assert mh.allreduce_sum(t) is t
    acc = {"b": torch.ones(2), "a": torch.zeros(2)}
    view = mh.ReducedView(acc)
    assert sorted(view) == ["a", "b"] and len(view) == 2
    assert torch.equal(view["b"], acc["b"])
    assert mh.fetch_replicated(torch.ones(2)).tolist() == [1.0, 1.0]


# 23,172 samples: ibs's four int32 N x N leaves pass the 8 GiB budget.
@pytest.mark.parametrize("mode,want,n", [
    ("auto", "variant", 24), ("variant", "variant", 24),
    ("replicated", "replicated", 24), ("tile2d", "tile2d", 24),
    ("auto", "tile2d", 23_172)],
    ids=["auto-variant", "variant-variant", "replicated-replicated",
         "tile2d-tile2d", "auto-tile2d"])
def test_plan_for_across_ranks(mode, want, n):
    """Across two ranks of one slot each: auto counts both slots; tile2d
    (forced, or auto past the budget, as JAX's process-spanning mesh)
    tiles over a (1, 2) mesh that spans the ranks, this rank owning slot
    0; variant and replicated run on the rank's own slot."""
    mesh = meshes.make_mesh(["cpu"])
    plan = gs.plan_for(mesh, n, "ibs", mode, processes=2)
    assert (plan.mode, plan.processes, plan.block_shards) == (want, 2, 1)
    assert plan.mesh_shape == (1, 2)
    if want == "tile2d":
        assert plan.tiled and plan.mesh.spans_processes
        assert (plan.mesh.owners, plan.mesh.local_slots) == ((0, 1), (0,))
        assert plan.mesh.devices == (torch.device("cpu"), None)
    else:
        assert plan.mesh.size == 1 and not plan.mesh.owners
    assert gs.plan_for(mesh, n, "ibs").mode == "replicated"


def test_no_group_without_the_coordinator(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert meshes.maybe_init_distributed("cpu") is None
    assert (meshes.process_index(), meshes.process_count()) == (0, 1)


@pytest.mark.parametrize("env,match", [
    ({"JAX_NUM_PROCESSES": "2"}, "JAX_PROCESS_ID is not set"),
    ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "2"}, "outside a job"),
])
def test_a_partial_launch_is_refused(monkeypatch, env, match):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        meshes.maybe_init_distributed("cpu")
    assert meshes.distributed() is None


def test_cuda_without_a_card_fails_before_any_collective(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshes.maybe_init_distributed("cuda")
    assert meshes.distributed() is None
