"""The PyTorch port's count finalizes and the ``pca`` job against the JAX
package, on the CPU.

Finalizes run the same elementwise IEEE f32 operations on the same
integer statistics, so they are held bitwise. ``fit_pca`` and the pca
job go through two eigensolvers, so eigenpairs are held within the
tolerances each test states, eigenvectors per column up to sign.
"""

import warnings

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.ingest import SyntheticSource as JSyntheticSource
from spark_examples_tpu.models import pca as jpca
from spark_examples_tpu.ops import distances as jdistances
from spark_examples_tpu.ops import gram as jgram
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu_torch import kernels as tkernels
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.models import pca as tpca
from spark_examples_tpu_torch.ops import distances as tdistances
from spark_examples_tpu_torch.ops import gram as tgram
from spark_examples_tpu_torch.pipelines import jobs as tjobs

from conftest import random_genotypes

N, V, BV, K = 48, 6000, 1024, 4


def _genotypes_with_edge_rows(seed):
    """Random dosages plus rows that drive every finalize's guarded
    branch: an all-missing sample (no complete pair: ibs2 / pc-invariant
    m = 0, jaccard empty union), an all-hom-ref sample (no het: king's
    zero denominator, no carrier) and an all-hom-alt one."""
    g = random_genotypes(np.random.default_rng(seed), 29, 173, 0.15)
    g[3] = -1
    g[7] = 0
    g[11] = 2
    return g


@pytest.mark.parametrize("metric", tkernels.fused_names())
def test_finalize_bitwise_equal_to_jax(metric):
    """The same int32 accumulators (from the JAX update) through both
    finalizes: similarity and distance bitwise equal."""
    g = _genotypes_with_edge_rows(sum(metric.encode()))
    acc = jgram.update(jgram.init(g.shape[0], metric), g, metric)
    acc_np = {k: np.asarray(v) for k, v in acc.items()}
    got = tdistances.finalize(tgram.from_jax_state(acc_np, "cpu"), metric)
    want = jdistances.finalize(acc, metric)
    for field in ("similarity", "distance"):
        g_, w_ = got[field].numpy(), np.asarray(want[field])
        assert g_.dtype == w_.dtype == np.float32, field
        np.testing.assert_array_equal(g_, w_, err_msg=f"{metric}/{field}")


@pytest.mark.parametrize(
    "metric", [m for m in tkernels.fused_names() if m != "ibs"])
def test_port_accumulators_then_finalize_match_jax(metric):
    """End to end on the port's side (its own update, then finalize)
    against the JAX package's: bitwise (ibs is covered by the slice-1
    tests)."""
    g = _genotypes_with_edge_rows(17)
    tacc = tgram.update(tgram.init(g.shape[0], metric, "cpu"),
                        torch.from_numpy(g), metric)
    jacc = jgram.update(jgram.init(g.shape[0], metric), g, metric)
    got = tdistances.finalize(tacc, metric)["distance"].numpy()
    want = np.asarray(jdistances.finalize(jacc, metric)["distance"])
    np.testing.assert_array_equal(got, want)


def _assert_eigpairs_match(tv, tc, jv, jc, k):
    """Eigenvalues within 1e-4 of |lambda_1|; columns whose eigengap to
    both neighbours exceeds 2% of |lambda_1| within 2e-3 of the column's
    scale, up to sign."""
    scale = abs(jv[0])
    np.testing.assert_allclose(tv, jv, atol=1e-4 * scale)
    gaps = np.abs(np.diff(np.abs(jv)))
    checked = 0
    for j in range(k):
        left = gaps[j - 1] if j > 0 else np.inf
        right = gaps[j] if j < k - 1 else np.inf
        if min(left, right) <= 0.02 * scale:
            continue
        s = np.sign(np.dot(jc[:, j], tc[:, j])) or 1.0
        np.testing.assert_allclose(s * tc[:, j], jc[:, j],
                                   atol=2e-3 * np.abs(jc[:, j]).max(),
                                   err_msg=f"pc{j + 1}")
        checked += 1
    assert checked >= 1


def test_fit_pca_matches_jax():
    """A symmetric similarity with an indefinite centered spectrum: both
    order by descending |lambda|."""
    rng = np.random.default_rng(8)
    q, _ = np.linalg.qr(rng.standard_normal((50, 50)))
    vals = np.concatenate([[30.0, -18.0, 9.0, -4.0],
                           rng.uniform(-0.3, 0.3, 46)])
    s = ((q * vals) @ q.T).astype(np.float32)
    s = (s + s.T) / 2
    got = tpca.fit_pca(torch.from_numpy(s), k=4)
    want = jpca.fit_pca(s, k=4)
    _assert_eigpairs_match(got.eigenvalues.numpy(), got.coords.numpy(),
                           np.asarray(want.eigenvalues),
                           np.asarray(want.coords), 4)
    assert got.eigenvalues.numpy()[1] < 0  # signed, ordered by |lambda|


def _pca_jobs(metric="shared-alt"):
    j = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV),
        compute=jconfig.ComputeConfig(metric="shared-alt", num_pc=K))
    t = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV),
        compute=tconfig.ComputeConfig(metric=metric, num_pc=K,
                                      device="cpu"))
    return j, t


def test_variants_pca_job_matches_jax():
    jjob, tjob = _pca_jobs()
    jout = jjobs.variants_pca_job(jjob, source=JSyntheticSource(
        n_samples=N, n_variants=V))
    tout = tjobs.variants_pca_job(tjob, source=SyntheticSource(
        n_samples=N, n_variants=V))
    assert tout.n_variants == jout.n_variants == V
    assert tout.coords.shape == (N, K) and np.isfinite(tout.coords).all()
    assert tout.sample_ids == jout.sample_ids
    assert {"gram", "finalize", "eigh"} <= set(tout.timer.phases)
    _assert_eigpairs_match(tout.eigenvalues, tout.coords,
                           np.asarray(jout.eigenvalues),
                           np.asarray(jout.coords), K)


def test_variants_pca_job_warns_on_another_metric_and_uses_shared_alt():
    _, tjob = _pca_jobs(metric="ibs")
    src = SyntheticSource(n_samples=12, n_variants=300)
    with pytest.warns(UserWarning, match="always uses 'shared-alt'"):
        warned = tjobs.variants_pca_job(tjob, source=src)
    _, silent_job = _pca_jobs(metric=None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        silent = tjobs.variants_pca_job(silent_job, source=src)
    np.testing.assert_array_equal(warned.coords, silent.coords)


def test_pca_cli_writes_the_coords_tsv(tmp_path, capsys):
    out = tmp_path / "pca.tsv"
    rc = tmain(["pca", "--device", "cpu", "--n-samples", "20",
                "--n-variants", "900", "--block-variants", "256",
                "--num-pc", "3", "--output-path", str(out), "--timings"])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "sample\tpc1\tpc2\tpc3" and len(lines) == 21
    captured = capsys.readouterr()
    assert "20 samples x 3 components" in captured.out
    assert '"gram"' in captured.err and '"eigh"' in captured.err


@pytest.mark.parametrize("argv,match", [
    (["pca", "--metric", "ibs"], "shared-alt similarity by definition"),
    (["pcoa", "--save-model", "m.npz", "--solver", "sketch", "--metric",
      "grm"], "--save-model"),
    (["pcoa", "--solver", "corrected", "--sketch-iters", "0"],
     "--sketch-iters=0"),
    (["pcoa", "--gram-mode", "tile2d", "--mesh-shape", "2by2"],
     "--mesh-shape"),
    (["pcoa", "--metric", "bogus"], "invalid choice"),
])
def test_unported_and_bad_flags_are_usage_errors(argv, match, capsys):
    with pytest.raises(SystemExit):
        tmain(argv + ["--device", "cpu"])
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("kw,match", [
    (dict(solver="corrected", metric="king"),
     "--solver corrected does not support --metric king"),
    (dict(solver="bogus"), "--solver"),
    (dict(tile2d_transport="mesh"), "--tile2d-transport"),
    (dict(braycurtis_method="pallas"), "--braycurtis-method"),
    (dict(braycurtis_levels=0), "--braycurtis-levels"),
])
def test_compute_config_refuses_unported_options(kw, match):
    with pytest.raises(ValueError, match=match):
        tconfig.ComputeConfig(**kw)


def test_every_registered_metric_is_runnable_and_fused_names_match():
    from spark_examples_tpu import kernels as jkernels

    assert set(tkernels.finalizable_names()) == set(tkernels.names())
    assert set(tkernels.fused_names()) == set(jkernels.fused_names())
    for name in tkernels.names():
        tconfig.ComputeConfig(metric=name)
