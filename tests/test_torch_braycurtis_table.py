"""Bray-Curtis PCoA over a count table (``ingest/table.py``) against the
benchmark's plain reference (``benchmark/reference/braycurtis_ref.py``),
on the CPU.

A seeded rarefied table drawn by the benchmark's own community model
(``benchmark/community.py``): 301 samples in four environments over
3,001 sOTUs at a depth of 1,000 reads, so counts pass 127 and int8
wraps them. The program's job is ``pcoa_job`` under the Bray-Curtis
cell's mix (``benchmark/traffic/table-memory.json``) with the table as
its source, judged by ``compare.judge`` under the cell's limits; the
reference's exact numerator is held against float64 ``torch.cdist``;
three planted faults each push a reading over a limit; a gram metric
over a count table is refused before any work; and the table's
counters read what they count.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.community import Community
from benchmark.reference import braycurtis_ref
from benchmark.reference.braycurtis_ref import Reference, dense_table
from benchmark.reference.compare import judge
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.config import ComputeConfig, JobConfig
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ingest.table import (
    CountTableSource,
    DosageTable,
    check_source,
    count_table,
)
from spark_examples_tpu_torch.ops import distances
from spark_examples_tpu_torch.pipelines import jobs

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
CELL = json.loads((BENCH / "workloads" /
                   "emp-10k.braycurtis-memory.json").read_text())
LIMITS = CELL["limits"]
MIX = json.loads((BENCH / "traffic" / "table-memory.json").read_text())
K = int(MIX["num_pc"])
N_FEATURES = 3001
SEED = 2**33 + 27


def _config(**kw):
    cfg = json.loads((BENCH / "configs" / "emp-10k.json").read_text())
    cfg.update(name="emp-tiny", n_samples=301, n_features=N_FEATURES,
               depth=1000, pool_features=800,
               groups={"soil": 76, "gut": 75, "water": 75, "plant": 75})
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def table():
    return Community(_config(), SEED, torch.device("cpu")).csr()


@pytest.fixture(scope="module")
def reference(table):
    return Reference(*table, N_FEATURES, K, "cpu")


def _job(**kw) -> JobConfig:
    compute = dict(metric=MIX["metric"],
                   braycurtis_method=MIX["braycurtis_method"], num_pc=K,
                   solver=MIX["solver"], eigh_mode=MIX["eigh_mode"],
                   device="cpu")
    compute.update(kw)
    return JobConfig(compute=ComputeConfig(**compute))


def _readings(reference, out):
    # The host oracle's eigenvalues come reversed, a view.
    return judge(reference, np.ascontiguousarray(out.coords),
                 np.ascontiguousarray(out.eigenvalues))


def test_the_table_is_rarefied_and_wide_enough_to_wrap_int8(table):
    indptr, indices, counts = table
    sums = np.add.reduceat(counts, indptr[:-1])
    assert (sums == 1000).all()
    assert counts.max() > 127
    assert np.all(np.diff(indptr) > 0)


@pytest.mark.parametrize("backend", ["jax-tpu", "cpu-reference"])
def test_job_over_a_count_table_matches_the_reference(table, reference,
                                                      backend):
    src = CountTableSource(*table, N_FEATURES)
    out = jobs.pcoa_job(_job(backend=backend), source=src)
    assert out.coords.shape == (301, K)
    readings = _readings(reference, out)
    assert all(readings[k] <= LIMITS[k] / 10 for k in LIMITS), readings


@pytest.mark.parametrize("band", [64, 4096, braycurtis_ref.BAND_COLUMNS])
def test_reference_numerator_equals_float64_cdist(table, band, monkeypatch):
    monkeypatch.setattr(braycurtis_ref, "BAND_COLUMNS", band)
    indptr, indices, counts = table
    x = dense_table(indptr, indices, counts, N_FEATURES, "cpu")
    got = braycurtis_ref.manhattan(indptr, indices, counts, N_FEATURES,
                                   "cpu")
    mins = braycurtis_ref.min_sums(indptr, indices, counts, N_FEATURES,
                                   "cpu", band=band)
    want = torch.cdist(x, x, p=1)
    assert got.dtype == torch.float64
    assert torch.equal(got, want)
    t = x.sum(dim=1)
    off = ~torch.eye(len(t), dtype=torch.bool)
    assert torch.equal((t[:, None] + t[None, :] - 2 * mins)[off], want[off])


def test_reference_numerator_on_ties_and_empty_rows():
    """A feature whose largest count two samples share, a feature one
    sample alone holds, and a row with no counts."""
    x = np.array([[5, 0, 3, 0], [5, 2, 0, 0], [0, 0, 0, 0],
                  [1, 7, 3, 9]], dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum((x > 0).sum(1))])
    indices = np.nonzero(x)[1]
    counts = x[x > 0]
    got = braycurtis_ref.manhattan(indptr, indices, counts, 4, "cpu")
    xt = torch.from_numpy(x).double()
    assert torch.equal(got, torch.cdist(xt, xt, p=1))
    ref = Reference(indptr, indices, counts, 4, 2, "cpu")
    assert torch.isfinite(ref.b).all()


def _int8_route(table, reference):
    """The same counts through the int8 genotype route: past 127 they
    wrap."""
    x = dense_table(*table, N_FEATURES, "cpu").numpy()
    src = ArraySource(x.astype(np.int64).astype(np.int8))
    return jobs.pcoa_job(_job(), source=src)


def _dropped_band(table, reference, monkeypatch):
    """A band of 256 features lost between the host and the table."""
    orig = CountTableSource.dense

    def dense(self, device):
        out = orig(self, device)
        out[:, 1000:1256] = 0
        return out

    monkeypatch.setattr(CountTableSource, "dense", dense)
    return jobs.pcoa_job(_job(), source=CountTableSource(*table, N_FEATURES))


def _totals_off_by_one(table, reference, monkeypatch):
    """Every row total one read high in the denominator."""
    orig = distances.bc_from_manhattan
    monkeypatch.setattr(distances, "bc_from_manhattan",
                        lambda num, totals: orig(num, totals + 1))
    return jobs.pcoa_job(_job(), source=CountTableSource(*table, N_FEATURES))


@pytest.mark.parametrize("fault", ["int8_route", "dropped_band",
                                   "totals_off_by_one"])
def test_planted_fault_reads_over_a_limit(table, reference, monkeypatch,
                                          fault):
    if fault == "int8_route":
        out = _int8_route(table, reference)
    elif fault == "dropped_band":
        out = _dropped_band(table, reference, monkeypatch)
    else:
        out = _totals_off_by_one(table, reference, monkeypatch)
    readings = _readings(reference, out)
    assert any(readings[k] > LIMITS[k] for k in LIMITS), readings


@pytest.mark.parametrize("metric", ["ibs", "grm", "euclidean", "jaccard"])
def test_a_gram_metric_over_a_count_table_is_refused_before_any_work(
        table, metric):
    telemetry.reset()
    src = CountTableSource(*table, N_FEATURES)
    with pytest.raises(ValueError, match="braycurtis"):
        jobs.pcoa_job(_job(metric=metric), source=src)
    with pytest.raises(ValueError, match="braycurtis"):
        jobs.similarity_matrix_job(_job(metric=metric), source=src)
    assert telemetry.counter_value("table.nnz") == 0
    assert telemetry.counter_value("table.upload_bytes") == 0


def test_pca_over_a_count_table_is_refused(table):
    with pytest.raises(ValueError, match="braycurtis"):
        jobs.variants_pca_job(_job(metric=None),
                              source=CountTableSource(*table, N_FEATURES))


def test_a_count_table_streams_no_blocks(table):
    with pytest.raises(ValueError, match="braycurtis"):
        CountTableSource(*table, N_FEATURES).blocks(512)


def test_table_counters_read_what_they_count(table):
    indptr, indices, counts = table
    src = CountTableSource(indptr, indices, counts, N_FEATURES)
    telemetry.reset()
    jobs.pcoa_job(_job(), source=src)
    jobs.pcoa_job(_job(), source=src)
    nbytes = indptr.nbytes + indices.astype(np.int32).nbytes + \
        counts.astype(np.int32).nbytes
    assert telemetry.counter_value("table.nnz") == 2 * len(indices)
    assert telemetry.counter_value("table.upload_bytes") == 2 * nbytes
    snap = telemetry.metrics_snapshot()["histograms"]
    assert snap["table.upload"]["count"] == 2
    # The CPU runs the plain lowering: K2 counts nothing there.
    assert telemetry.counter_value("kernel.braycurtis.launches") == 0
    telemetry.reset()


def test_dense_is_the_csr_table_and_keeps_big_counts(table):
    src = CountTableSource(*table, N_FEATURES)
    got = src.dense("cpu")
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got.double(),
                       dense_table(*table, N_FEATURES, "cpu"))
    assert float(got.max()) == float(table[2].max()) > 127
    assert src.n_samples == 301 and src.n_variants == N_FEATURES
    assert src.sample_ids[0] == "S000000"


def test_a_count_table_is_read_as_it_is(table):
    src = CountTableSource(*table, N_FEATURES)
    assert count_table(src, 512) is src


@pytest.mark.parametrize("block_variants", [7, 64, 5000])
def test_a_genotype_source_is_read_as_its_dosage_matrix(block_variants):
    """The one table seam reads a genotype source block by block, with
    missing as absence, whatever the block width."""
    rng = np.random.default_rng(5)
    g = rng.integers(-1, 3, (23, 301)).astype(np.int8)
    dosage = count_table(ArraySource(g), block_variants)
    assert isinstance(dosage, DosageTable)
    got = dosage.dense("cpu")
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(np.maximum(g, 0)).float())


@pytest.mark.parametrize("metric", ["ibs", "grm", "braycurtis"])
def test_a_genotype_source_passes_the_count_table_check(metric):
    check_source(ArraySource(np.zeros((3, 4), np.int8)), metric)


@pytest.mark.parametrize("bad,match", [
    (dict(indptr=[0, 2, 1]), "CSR"),
    (dict(indptr=[1, 2, 3]), "CSR"),
    (dict(indices=[0, 5, 1]), "outside"),
    (dict(counts=[1, -2, 3]), "nonnegative"),
    (dict(counts=[1.0, 2.0, 3.0]), "integers"),
    (dict(counts=[1, 2]), "CSR"),
    (dict(ids=["a"]), "sample ids"),
])
def test_a_malformed_table_is_refused(bad, match):
    args = dict(indptr=[0, 2, 3], indices=[0, 2, 1], counts=[1, 2, 3],
                ids=None)
    args.update(bad)
    with pytest.raises((ValueError, TypeError), match=match):
        CountTableSource(args["indptr"], args["indices"], args["counts"], 3,
                         ids=args["ids"])


def test_same_seed_same_table_and_rows_sum_to_the_depth():
    a = Community(_config(), 7, torch.device("cpu")).csr()
    b = Community(_config(), 7, torch.device("cpu")).csr()
    c = Community(_config(), 8, torch.device("cpu")).csr()
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    for indptr, _, counts in (a, c):
        assert (np.add.reduceat(counts, indptr[:-1]) == 1000).all()
