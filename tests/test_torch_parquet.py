"""The port's parquet source (ingest/parquet.py) against the JAX
package's on the CPU: blocks bitwise equal on files written by either
package's ``write_parquet``, NULL dosages as missing, row groups pruned
by their statistics under ``--references``, a ``--source parquet`` job
whose int32 accumulators equal JAX's, and the friendly error when
pyarrow is missing."""

import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core.profiling import PhaseTimer as JPhaseTimer
from spark_examples_tpu.ingest.parquet import ParquetSource as JParquetSource
from spark_examples_tpu.ingest.parquet import write_parquet as j_write_parquet
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
    ReferenceRange,
)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest import parquet as tparquet
from spark_examples_tpu_torch.ingest.parquet import (
    ParquetSource,
    write_parquet,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.pipelines import runner as trunner
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job

from conftest import random_genotypes


def _blocks(src, bv, start=0):
    return list(src.blocks(bv, start))


def _same_blocks(got, want):
    assert len(got) == len(want)
    for (b, m), (jb, jm) in zip(got, want):
        np.testing.assert_array_equal(b, jb)
        assert b.dtype == jb.dtype
        assert (m.start, m.stop, m.contig) == (jm.start, jm.stop, jm.contig)
        if jm.positions is None:
            assert m.positions is None
        else:
            np.testing.assert_array_equal(m.positions, jm.positions)


def test_parquet_roundtrip(tmp_path, genotypes):
    """A wide parquet variant table round-trips exactly, streams in
    steady blocks, resumes mid-stream and reports an exact length from
    the file's metadata alone."""
    path = str(tmp_path / "cohort.parquet")
    write_parquet(path, genotypes, row_group_rows=64)
    src = ParquetSource(path)
    n, v = genotypes.shape
    assert src.n_samples == n
    assert src.exact_n_variants
    assert src.n_variants == v
    got = np.concatenate([b for b, _ in src.blocks(50)], axis=1)
    np.testing.assert_array_equal(got, genotypes)
    metas = [m for _, m in src.blocks(50)]
    assert [m.start for m in metas] == list(range(0, v, 50))
    assert metas[0].contig == "chr22"
    assert metas[0].positions is not None
    tail = np.concatenate([b for b, _ in src.blocks(50, metas[1].stop)],
                          axis=1)
    np.testing.assert_array_equal(tail, genotypes[:, metas[1].stop:])


def test_parquet_region_filter_and_job(tmp_path, rng):
    g = random_genotypes(rng, n=12, v=300, missing_rate=0.05)
    path = str(tmp_path / "cohort.parquet")
    write_parquet(path, g, contig="chr1", start_pos=100, row_group_rows=128)
    half = ParquetSource(path,
                         references=[ReferenceRange("chr1", 100, 250)])
    assert not half.exact_n_variants  # filtered: the count needs a scan
    assert half.n_variants == 150
    got = np.concatenate([b for b, _ in half.blocks(64)], axis=1)
    np.testing.assert_array_equal(got, g[:, :150])

    # The job surface takes source="parquet" end to end.
    job = JobConfig(
        ingest=IngestConfig(source="parquet", path=path, block_variants=64),
        compute=ComputeConfig(metric="ibs", num_pc=3, device="cpu"))
    out = pcoa_job(job)
    want = pcoa_job(
        JobConfig(ingest=IngestConfig(block_variants=64),
                  compute=ComputeConfig(metric="ibs", num_pc=3,
                                        device="cpu")),
        source=ArraySource(g))
    np.testing.assert_allclose(np.abs(out.coords), np.abs(want.coords),
                               atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("refs", [None, [("chr1", 150, 260),
                                         ("chr1", 400, 430)]])
def test_blocks_bitwise_equal_to_jax_on_either_package_s_file(
        tmp_path, rng, writer, refs):
    g = random_genotypes(rng, n=10, v=500, missing_rate=0.1)
    path = str(tmp_path / "c.parquet")
    (j_write_parquet if writer == "jax" else write_parquet)(
        path, g, contig="chr1", start_pos=100, row_group_rows=96)
    t_refs = [ReferenceRange(*r) for r in refs or ()]
    j_refs = [jconfig.ReferenceRange(*r) for r in refs or ()]
    src, jsrc = ParquetSource(path, t_refs), JParquetSource(path, j_refs)
    assert src.sample_ids == jsrc.sample_ids
    assert src.n_variants == jsrc.n_variants
    assert src.exact_n_variants == jsrc.exact_n_variants
    _same_blocks(_blocks(src, 64), _blocks(jsrc, 64))
    _same_blocks(_blocks(src, 64, 128), _blocks(jsrc, 64, 128))


def test_files_written_by_either_package_are_identical_tables(tmp_path,
                                                              rng):
    g = random_genotypes(rng, n=7, v=90, missing_rate=0.2)
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    j_write_parquet(a, g, row_group_rows=32)
    write_parquet(b, g, row_group_rows=32)
    assert pq.read_table(a).equals(pq.read_table(b))
    assert pq.ParquetFile(a).metadata.num_row_groups == \
        pq.ParquetFile(b).metadata.num_row_groups


def test_null_dosages_read_as_missing(tmp_path):
    """Arrow NULLs in a dosage column are -1 (missing), not the 0 an
    unchecked cast gives; a NULL in the contig column makes the source
    decline the exact block count; a NULL position is an error."""
    cols = {
        "contig": pa.array(["chr1", "chr1", None, "chr1"]),
        "position": pa.array(np.arange(4, dtype=np.int64)),
        "A": pa.array([0, None, 2, 1], type=pa.int8()),
        "B": pa.array([None, None, 1, 0], type=pa.int8()),
    }
    path = str(tmp_path / "n.parquet")
    pq.write_table(pa.table(cols), path)
    src, jsrc = ParquetSource(path), JParquetSource(path)
    got = np.concatenate([b for b, _ in src.blocks(8)], axis=1)
    np.testing.assert_array_equal(
        got, np.array([[0, -1, 2, 1], [-1, -1, 1, 0]], np.int8))
    assert not src.exact_n_variants and not jsrc.exact_n_variants
    _same_blocks(_blocks(src, 8), _blocks(jsrc, 8))
    assert [m.contig for _, m in src.blocks(8)] == ["chr1", None, "chr1"]
    cols["position"] = pa.array([0, None, 2, 3], type=pa.int64())
    bad = str(tmp_path / "bad.parquet")
    pq.write_table(pa.table(cols), bad)
    with pytest.raises(ValueError, match="NULL"):
        list(ParquetSource(bad).blocks(8))


def test_parquet_multi_contig_blocks_never_span(tmp_path, rng):
    g = random_genotypes(rng, n=6, v=100, missing_rate=0.0)
    contigs = ["chr1"] * 37 + ["chr2"] * 63
    cols = {"contig": pa.array(contigs),
            "position": pa.array(np.arange(100, dtype=np.int64))}
    for i in range(6):
        cols[f"S{i}"] = pa.array(np.asarray(g[i], np.int8))
    path = str(tmp_path / "mc.parquet")
    pq.write_table(pa.table(cols), path, row_group_size=40)
    src = ParquetSource(path)
    assert not src.exact_n_variants
    blocks = list(src.blocks(25))
    assert all(m.contig in ("chr1", "chr2") for _, m in blocks)
    assert 37 in [m.stop for _, m in blocks]
    np.testing.assert_array_equal(
        np.concatenate([b for b, _ in blocks], axis=1), g)
    _same_blocks(blocks, _blocks(JParquetSource(path), 25))


def test_row_groups_outside_the_ranges_are_never_read(tmp_path, rng,
                                                      monkeypatch):
    """Under --references the statistics prune row groups: only the
    groups that can overlap a range are read, and only groups whose mask
    keeps a row decode their sample columns."""
    g = random_genotypes(rng, n=5, v=1000, missing_rate=0.0)
    path = str(tmp_path / "rg.parquet")
    write_parquet(path, g, contig="chr1", start_pos=0, row_group_rows=100)
    reads = []
    real = pq.ParquetFile.read_row_group

    def counting(self, i, columns=None, **kw):
        reads.append((i, tuple(columns or ())))
        return real(self, i, columns=columns, **kw)

    monkeypatch.setattr(pq.ParquetFile, "read_row_group", counting)
    src = ParquetSource(path, references=[ReferenceRange("chr1", 250, 420)])
    got = np.concatenate([b for b, _ in src.blocks(64)], axis=1)
    np.testing.assert_array_equal(got, g[:, 250:420])
    assert sorted({i for i, _ in reads}) == [2, 3, 4]
    sample_reads = {i for i, cols in reads if "S000000" in cols}
    assert sample_reads == {2, 3, 4}
    reads.clear()
    assert ParquetSource(
        path, references=[ReferenceRange("chr2", 0, 10)]).n_variants == 0
    assert reads == []  # the contig statistics miss every group


def test_parquet_job_accumulators_bitwise_equal_to_jax(tmp_path, rng):
    g = random_genotypes(rng, n=24, v=700, missing_rate=0.1)
    path = str(tmp_path / "c.parquet")
    write_parquet(path, g, row_group_rows=200)
    tjob = JobConfig(
        ingest=IngestConfig(source="parquet", path=path, block_variants=128),
        compute=ComputeConfig(metric="ibs", device="cpu"))
    jjob = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(source="parquet", path=path,
                                    block_variants=128),
        compute=jconfig.ComputeConfig(metric="ibs"))
    tsrc = trunner.build_source(tjob.ingest, "cpu")
    tg = trunner.run_gram(tjob, tsrc, PhaseTimer())
    jg = jrunner.run_gram(jjob, jrunner.build_source(jjob.ingest),
                          JPhaseTimer())
    assert tg.n_variants == jg.n_variants == 700
    for leaf in tg.acc:
        np.testing.assert_array_equal(tg.acc[leaf].numpy(),
                                      np.asarray(jg.acc[leaf]))


def test_parquet_cli(tmp_path, rng, capsys):
    g = random_genotypes(rng, n=16, v=400, missing_rate=0.05)
    path = str(tmp_path / "c.parquet")
    write_parquet(path, g, row_group_rows=128)
    out = str(tmp_path / "c.tsv")
    assert tmain(["pcoa", "--device", "cpu", "--source", "parquet",
                  "--path", path, "--block-variants", "128", "--num-pc",
                  "3", "--output-path", out]) == 0
    assert "16 samples x 3 components over 400 variants" in \
        capsys.readouterr().out


def test_friendly_error_without_pyarrow(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="needs pyarrow") as err:
        tparquet._pyarrow()
    assert "packed store" in str(err.value)
    with pytest.raises(ImportError, match="needs pyarrow"):
        ParquetSource("any.parquet").sample_ids
