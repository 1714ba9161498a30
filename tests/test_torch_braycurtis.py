"""The PyTorch port's Bray-Curtis path against the JAX package, on the
CPU: the Manhattan numerator (the CUDA kernel's plain version), the
Bray-Curtis lowerings, the table route of ``run_similarity`` and
``pcoa_job``, the CLI and its validation.

On a table of integer counts every partial sum below 2^24 is exact in f32
in any order, so numerators, row totals and the IEEE division are held
bitwise there; float tables are held within a stated rtol.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu import kernels as jkernels
from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.ingest import SyntheticSource as JSyntheticSource
from spark_examples_tpu.ops import distances as jdistances
from spark_examples_tpu.ops.pallas.braycurtis_kernel import (
    pairwise_manhattan_pallas,
)
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu.utils import oracle
from spark_examples_tpu_torch import kernels as tkernels
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ops import braycurtis_kernel as tkernel
from spark_examples_tpu_torch.ops import distances as tdistances
from spark_examples_tpu_torch.pipelines import jobs as tjobs
from spark_examples_tpu_torch.pipelines import runner as trunner

N, V, BV, K = 40, 1500, 512, 4


def otu_table(seed, n, f, zero_row=False):
    """Integer OTU-like counts, sparse and overdispersed (the JAX
    package's ``otu`` fixture, ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.5, 40.0, size=(n, f)) * (rng.random((n, f)) > 0.6)
    x = x.astype(np.int32).astype(np.float32)
    if zero_row:
        x[n // 2] = 0.0
    return x


@pytest.mark.parametrize("n,f", [(70, 600), (37, 301), (1, 1), (5, 1025)])
def test_pairwise_manhattan_bitwise_on_integer_tables(n, f):
    """Integer tables with ragged N and F and a zero-total row: the
    port's numerator equals both JAX lowerings (the Pallas kernel in
    interpret mode, the tiled XLA one) bitwise."""
    x = otu_table(n * 31 + f, n, f, zero_row=n > 2)
    got = tdistances.pairwise_manhattan(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_array_equal(
        got, np.asarray(pairwise_manhattan_pallas(x, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jdistances.pairwise_manhattan(x)))


def test_pairwise_manhattan_float_table_within_rtol():
    """Non-integer entries: each side sums in its own order, so the
    numerators agree within rtol 1e-5 (a few f32 ulps over 700 terms)."""
    x = np.random.default_rng(5).gamma(0.7, 3.0, (45, 700)).astype(np.float32)
    got = tdistances.pairwise_manhattan(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(pairwise_manhattan_pallas(x, interpret=True)),
        rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jdistances.pairwise_manhattan(x)), rtol=1e-5)


@pytest.mark.parametrize("row_tile,feat_tile", [(128, 128), (16, 64)])
def test_braycurtis_and_bc_from_manhattan_bitwise(row_tile, feat_tile):
    x = otu_table(11, 50, 333, zero_row=True)
    got = tdistances.braycurtis(torch.from_numpy(x), row_tile=row_tile,
                                feat_tile=feat_tile).numpy()
    want = np.asarray(jdistances.braycurtis(x, row_tile=row_tile,
                                            feat_tile=feat_tile))
    np.testing.assert_array_equal(got, want)
    assert got[25, 25] == 0.0 and (got[25] == want[25]).all()
    num = np.abs(x[:, None, :] - x[None, :, :]).sum(-1).astype(np.float32)
    totals = x.sum(axis=1)
    np.testing.assert_array_equal(
        tdistances.bc_from_manhattan(torch.from_numpy(num),
                                     torch.from_numpy(totals)).numpy(),
        np.asarray(jdistances.bc_from_manhattan(num, totals)))


@pytest.mark.parametrize("levels,tol", [(64, 2e-2), (256, 6e-3)])
def test_braycurtis_matmul_within_the_quantisation_bound(levels, tol):
    """The threshold lowering: within the JAX package's quantisation
    bounds of the exact oracle (``tests/test_kernels.py``), and within
    1e-5 of the JAX lowering (same bf16 weights, f32 sums in another
    order)."""
    x = otu_table(1234, 70, 600)
    got = tdistances.braycurtis_matmul(torch.from_numpy(x),
                                       levels=levels).numpy()
    want = oracle.cpu_braycurtis(x)
    assert np.abs(got - want).max() < tol
    np.testing.assert_allclose(
        got, np.asarray(jdistances.braycurtis_matmul(x, levels=levels)),
        atol=1e-5)


def test_braycurtis_matmul_exact_for_binary_and_rejects_zero_levels():
    """0/1 data lies on the threshold grid: with f32 weights the lowering
    is the oracle within rtol 1e-4 (f32 rounding of the sums)."""
    x = (np.random.default_rng(4).random((40, 300)) > 0.5).astype(np.float32)
    got = tdistances.braycurtis_matmul(torch.from_numpy(x), levels=16,
                                       precise=True).numpy()
    np.testing.assert_allclose(got, oracle.cpu_braycurtis(x), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="levels must be >= 1"):
        tdistances.braycurtis_matmul(torch.from_numpy(x), levels=0)


def test_kernel_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing; it refuses what the kernel would not take."""
    x = otu_table(3, 33, 129, zero_row=True)
    before = tkernel.launches
    num = tkernel.pairwise_manhattan_kernel(torch.from_numpy(x))
    bc = tkernel.braycurtis_kernel(torch.from_numpy(x))
    assert tkernel.launches == before
    np.testing.assert_array_equal(
        num.numpy(), tdistances.pairwise_manhattan(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(bc.numpy(), np.asarray(
        jdistances.braycurtis(x)))
    with pytest.raises(ValueError, match="2-D"):
        tkernel.pairwise_manhattan_kernel(torch.zeros(3))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tkernel.pairwise_manhattan_kernel(x)


def _jobs(**compute):
    j = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV),
        compute=jconfig.ComputeConfig(metric="braycurtis", num_pc=K))
    t = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV),
        compute=tconfig.ComputeConfig(metric="braycurtis", num_pc=K,
                                      device="cpu", **compute))
    return j, t


def test_run_similarity_braycurtis_bitwise_equal_to_jax():
    """The same SyntheticSource seed through both table routes: the
    dosage table's Bray-Curtis distances and similarities are bitwise
    equal (integer table)."""
    jjob, tjob = _jobs()
    got = trunner.run_similarity(tjob, SyntheticSource(n_samples=N,
                                                       n_variants=V))
    want = jrunner.run_similarity(jjob, JSyntheticSource(n_samples=N,
                                                         n_variants=V))
    assert got.metric == want.metric == "braycurtis"
    assert got.n_variants == want.n_variants == V
    assert got.distance.dtype == np.float32
    np.testing.assert_array_equal(got.distance, want.distance)
    np.testing.assert_array_equal(got.similarity, want.similarity)
    assert {"ingest", "distance"} <= set(got.timer.phases)


def test_pcoa_job_braycurtis_matches_jax():
    """pcoa over the table route: eigenvalues within 1e-4 of lambda_1 and
    well-separated columns (eigengap > 2% of lambda_1) within 2e-3 of
    the column's scale up to sign, as the IBS slice's test states."""
    jjob, tjob = _jobs()
    jout = jjobs.pcoa_job(jjob, source=JSyntheticSource(n_samples=N,
                                                        n_variants=V))
    tout = tjobs.pcoa_job(tjob, source=SyntheticSource(n_samples=N,
                                                       n_variants=V))
    assert tout.n_variants == V and tout.coords.shape == (N, K)
    assert {"ingest", "distance", "eigh"} <= set(tout.timer.phases)
    jv, tv = np.asarray(jout.eigenvalues), tout.eigenvalues
    np.testing.assert_allclose(tv, jv, atol=1e-4 * jv[0])
    gaps = np.diff(jv)
    checked = 0
    for j in range(K):
        left = abs(gaps[j - 1]) if j > 0 else np.inf
        right = abs(gaps[j]) if j < K - 1 else np.inf
        if min(left, right) <= 0.02 * jv[0]:
            continue
        jc, tc = np.asarray(jout.coords)[:, j], tout.coords[:, j]
        s = np.sign(np.dot(jc, tc)) or 1.0
        np.testing.assert_allclose(s * tc, jc, atol=2e-3 * np.abs(jc).max(),
                                   err_msg=f"pc{j + 1}")
        checked += 1
    assert checked >= 1
    np.testing.assert_allclose(tout.proportion, np.asarray(jout.proportion),
                               atol=1e-5)


def test_matmul_method_through_the_runner_matches_jax():
    """``--braycurtis-method matmul`` with 8 levels: within 1e-5 of the
    JAX lowering on the same table (dosages 0-2 lie on the grid)."""
    jjob, tjob = _jobs(braycurtis_method="matmul", braycurtis_levels=8)
    jjob = jjob.replace(compute=jconfig.ComputeConfig(
        metric="braycurtis", braycurtis_method="matmul",
        braycurtis_levels=8))
    got = trunner.run_similarity(tjob, SyntheticSource(n_samples=N,
                                                       n_variants=V))
    want = jrunner.run_similarity(jjob, JSyntheticSource(n_samples=N,
                                                         n_variants=V))
    np.testing.assert_allclose(got.distance, want.distance, atol=1e-5)


def test_registry_registers_braycurtis_as_the_jax_table_kernel():
    t, j = tkernels.get("braycurtis"), jkernels.get("braycurtis")
    assert t.family == j.family == "table"
    assert (t.pieces, t.stats) == ((), ())
    assert t.table_runner is not None and t.finalize is None
    assert t.flops(37, 211) == j.flops(37, 211)
    assert "braycurtis" in tkernels.finalizable_names()
    assert "braycurtis" not in tkernels.fused_names()
    with pytest.raises(ValueError, match="table-family"):
        tdistances.finalize({}, "braycurtis")


def test_method_resolution_and_fused_on_cpu_raises():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tdistances.resolve_braycurtis_method("auto", cpu) == "exact"
    assert tdistances.resolve_braycurtis_method("auto", cuda) == "fused"
    assert tdistances.resolve_braycurtis_method("matmul", cpu) == "matmul"
    with pytest.raises(ValueError, match="--braycurtis-method fused"):
        tdistances.resolve_braycurtis_method("fused", cpu)
    with pytest.raises(ValueError, match="--braycurtis-method fused"):
        tmain(["pcoa", "--device", "cpu", "--metric", "braycurtis",
               "--braycurtis-method", "fused", "--n-samples", "8",
               "--n-variants", "64"])


def test_pcoa_braycurtis_cli(tmp_path, capsys):
    out = tmp_path / "bc.tsv"
    rc = tmain(["pcoa", "--device", "cpu", "--metric", "braycurtis",
                "--n-samples", "24", "--n-variants", "600",
                "--block-variants", "256", "--num-pc", "3",
                "--output-path", str(out), "--timings"])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "sample\tpc1\tpc2\tpc3" and len(lines) == 25
    captured = capsys.readouterr()
    assert "24 samples x 3 components" in captured.out
    for phase in ('"ingest"', '"distance"', '"eigh"'):
        assert phase in captured.err


@pytest.mark.parametrize("argv,match", [
    (["--braycurtis-method", "pallas"], "invalid choice"),
    (["--braycurtis-levels", "0"], "--braycurtis-levels"),
])
def test_bad_braycurtis_flags_are_usage_errors(argv, match, capsys):
    with pytest.raises(SystemExit):
        tmain(["pcoa", "--device", "cpu", "--metric", "braycurtis"] + argv)
    assert match in capsys.readouterr().err
