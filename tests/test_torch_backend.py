"""``--backend cpu-reference`` and ``--debug-nans`` on the port, on the
CPU.

- The port's host oracle route against the JAX package's
  ``--backend cpu-reference`` on the same synthetic cohort, through the
  jobs and through both CLIs: float64 NumPy on both sides, so the
  similarity, distance, coordinates, eigenvalues and the written files
  are held bitwise.
- The port's host route against its own device route under
  ``--device cpu``: raw counts exact, distances within 1e-6 (f32 against
  f64 finalize), coordinates per column up to sign within the tolerance
  each test states (an f32 torch eigensolve against a float64 LAPACK
  one).
- JAX's refusals (the sketch rungs, streaming), reproduced with JAX's
  text, and no path of the default backend reaching the oracle.
- ``--debug-nans``: a NaN injected at a phase boundary raises
  ``FloatingPointError`` naming the phase; a clean run writes the bytes
  of a run without the flag.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.cli.main import main as jmain
from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch import kernels as tkernels
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import profiling
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.models.pcoa import fit_pcoa
from spark_examples_tpu_torch.pipelines import jobs as tjobs
from spark_examples_tpu_torch.pipelines import runner as trunner
from spark_examples_tpu_torch.pipelines import streaming as tstreaming
from spark_examples_tpu_torch.utils import oracle as toracle

N, V, BV, K = 40, 2000, 512, 4
COHORT = dict(n_samples=N, n_variants=V, block_variants=BV, seed=5,
              n_populations=3)
ARGV = ["--n-samples", str(N), "--n-variants", str(V), "--block-variants",
        str(BV), "--seed", "5", "--n-populations", "3", "--num-pc", str(K)]


def _jobs(**compute):
    """The same job for both packages: (JAX JobConfig, port JobConfig on
    --device cpu)."""
    j = jconfig.JobConfig(ingest=jconfig.IngestConfig(**COHORT),
                          compute=jconfig.ComputeConfig(num_pc=K, **compute))
    t = tconfig.JobConfig(ingest=tconfig.IngestConfig(**COHORT),
                          compute=tconfig.ComputeConfig(num_pc=K,
                                                        device="cpu",
                                                        **compute))
    return j, t


def _assert_columns_up_to_sign(got, want, atol, cols=K):
    for c in range(cols):
        a, b = got[:, c], want[:, c]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(sign * a, b, atol=atol, err_msg=f"pc{c}")


@pytest.fixture(autouse=True)
def _debug_nans_off():
    yield
    profiling.set_debug_nans(False)


# ------------------------------------------------ port against JAX, bitwise

@pytest.mark.parametrize("metric", ["ibs", "king", "jaccard", "grm",
                                    "braycurtis", "euclidean"])
def test_similarity_cpu_reference_bitwise_equal_to_jax(metric):
    j, t = _jobs(metric=metric, backend="cpu-reference")
    want = jrunner.run_similarity(j)
    got = trunner.run_similarity(t)
    assert got.sample_ids == want.sample_ids
    assert got.n_variants == want.n_variants
    for field in ("similarity", "distance"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("metric", ["ibs", "braycurtis", "grm"])
def test_pcoa_cpu_reference_bitwise_equal_to_jax(metric):
    j, t = _jobs(metric=metric, backend="cpu-reference")
    want = jjobs.pcoa_job(j)
    got = tjobs.pcoa_job(t)
    assert got.sample_ids == want.sample_ids
    np.testing.assert_array_equal(got.coords, np.asarray(want.coords))
    np.testing.assert_array_equal(got.eigenvalues,
                                  np.asarray(want.eigenvalues))
    np.testing.assert_array_equal(got.proportion, np.asarray(want.proportion))
    assert "eigh" in got.timer.phases


def test_pca_cpu_reference_bitwise_equal_to_jax():
    j, t = _jobs(backend="cpu-reference")
    want = jjobs.variants_pca_job(j)
    got = tjobs.variants_pca_job(t)
    np.testing.assert_array_equal(got.coords, np.asarray(want.coords))
    np.testing.assert_array_equal(got.eigenvalues,
                                  np.asarray(want.eigenvalues))


@pytest.mark.parametrize("command,metric", [("pcoa", "ibs"),
                                            ("pcoa", "braycurtis"),
                                            ("pcoa", "grm"),
                                            ("pca", None)])
def test_cli_cpu_reference_writes_jax_s_bytes(tmp_path, capsys, command,
                                              metric):
    """Both CLIs with --backend cpu-reference: the coordinates TSV and the
    saved model hold the same bytes / arrays."""
    argv = [command, *ARGV, "--backend", "cpu-reference"]
    if metric:
        argv += ["--metric", metric]
    paths = {}
    for name, main, extra in (("jax", jmain, []),
                              ("port", tmain, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.tsv")
        model = str(tmp_path / f"{name}.npz")
        save = ["--save-model", model] if metric != "braycurtis" else []
        assert main(argv + extra + save + ["--output-path", out]) == 0
        paths[name] = (out, model if save else None)
    capsys.readouterr()
    with open(paths["jax"][0], "rb") as a, open(paths["port"][0], "rb") as b:
        assert a.read() == b.read()
    if paths["jax"][1]:
        ja, ta = np.load(paths["jax"][1]), np.load(paths["port"][1])
        assert sorted(ja.files) == sorted(ta.files)
        for key in ja.files:
            np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


def test_cli_similarity_then_matrix_path_cpu_reference(tmp_path, capsys):
    """similarity -> pcoa --matrix-path under --backend cpu-reference: the
    persisted similarity is Gower-transformed in f32 as the JAX route
    does, and the coordinates file is JAX's, byte for byte."""
    outs = {}
    for name, main, extra in (("jax", jmain, []),
                              ("port", tmain, ["--device", "cpu"])):
        npy = str(tmp_path / f"{name}_sim.npy")
        tsv = str(tmp_path / f"{name}_c.tsv")
        assert main(["similarity", *ARGV, "--backend", "cpu-reference",
                     *extra, "--output-path", npy]) == 0
        assert main(["pcoa", "--matrix-path", npy, "--num-pc", str(K),
                     "--backend", "cpu-reference", *extra,
                     "--output-path", tsv]) == 0
        outs[name] = (np.load(npy), open(tsv, "rb").read())
    capsys.readouterr()
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert outs["port"][1] == outs["jax"][1]


# ------------------------------------- host route against the device route

@pytest.mark.parametrize("metric", ["ibs", "shared-alt", "king"])
def test_oracle_counts_equal_the_device_accumulators(metric):
    """The oracle's float64 raw products equal the device route's int32
    accumulators exactly, after a cast (the check phase 45 of
    chip_smoke.py makes against K1 on the card)."""
    _, t = _jobs(metric=metric)
    src = SyntheticSource(**{k: v for k, v in COHORT.items()
                             if k != "block_variants"})
    grun = trunner.run_gram(t, src, profiling.PhaseTimer())
    g = np.concatenate([b for b, _ in src.blocks(BV)], axis=1)
    want = toracle.cpu_gram_products(g, tkernels.get(metric).pieces)
    for leaf, acc in grun.acc.items():
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), want[leaf].astype(np.int32))
        assert np.array_equal(acc.numpy().astype(np.float64), want[leaf])


@pytest.mark.parametrize("metric", ["ibs", "jaccard", "braycurtis"])
def test_cpu_reference_against_the_device_route(metric):
    """Distances within 1e-6 (f32 against f64), coordinates per column up
    to sign within 1e-4 of max|coords|."""
    _, dev = _jobs(metric=metric)
    _, host = _jobs(metric=metric, backend="cpu-reference")
    d_dev = trunner.run_similarity(dev).distance
    d_host = trunner.run_similarity(host).distance
    assert d_dev.dtype == np.float32 and d_host.dtype == np.float64
    np.testing.assert_allclose(d_dev, d_host, rtol=0, atol=1e-6)
    c_dev = tjobs.pcoa_job(dev).coords
    c_host = tjobs.pcoa_job(host).coords
    _assert_columns_up_to_sign(c_dev, c_host,
                               atol=1e-4 * np.abs(c_host).max())


def test_pca_cpu_reference_against_the_device_route():
    """The MLlib covariance route against the device's one eigh of the
    centered similarity: eigenvalues within 1e-5 relative, projections
    per column up to sign within 1e-4 of max|coords|."""
    _, dev = _jobs()
    _, host = _jobs(backend="cpu-reference")
    a, b = tjobs.variants_pca_job(dev), tjobs.variants_pca_job(host)
    np.testing.assert_allclose(a.eigenvalues, b.eigenvalues, rtol=1e-5)
    _assert_columns_up_to_sign(a.coords, b.coords,
                               atol=1e-4 * np.abs(b.coords).max())


def test_default_backend_never_reaches_the_oracle(monkeypatch):
    """No path of the default backend drops to the host oracle: with every
    oracle entry point booby-trapped, similarity, pcoa (gram and table
    kernels, --matrix-path) and pca still run."""
    def trap(*a, **k):
        raise AssertionError("the default backend reached the oracle")

    for name in ("cpu_gram_products", "cpu_finalize", "cpu_braycurtis",
                 "pcoa", "pca_mllib_route", "gower_f32", "naive_grm",
                 "combine_products"):
        monkeypatch.setattr(toracle, name, trap)
    for metric in ("ibs", "grm", "braycurtis"):
        _, t = _jobs(metric=metric)
        trunner.run_similarity(t)
        tjobs.pcoa_job(t)
    _, t = _jobs()
    tjobs.variants_pca_job(t)


# --------------------------------------------------------- the refusals

def test_config_rejects_an_unknown_backend_with_jax_s_text():
    with pytest.raises(ValueError) as want:
        jconfig.ComputeConfig(backend="spark-mllib")
    with pytest.raises(ValueError) as got:
        tconfig.ComputeConfig(backend="spark-mllib")
    assert str(got.value) == str(want.value)
    assert tconfig.BACKENDS == jconfig.BACKENDS
    assert tconfig.ComputeConfig().backend == "jax-tpu"


@pytest.mark.parametrize("kind,solver", [("pcoa", "sketch"),
                                         ("pcoa", "corrected"),
                                         ("pca", "corrected")])
def test_sketch_rungs_refused_on_cpu_reference(kind, solver):
    """JAX's refusal (solvers/driver.py), same class and text."""
    metric = "grm" if kind == "pcoa" else None
    j, t = _jobs(metric=metric, backend="cpu-reference", solver=solver)
    run = {"pcoa": (jjobs.pcoa_job, tjobs.pcoa_job),
           "pca": (jjobs.variants_pca_job, tjobs.variants_pca_job)}[kind]
    with pytest.raises(ValueError) as want:
        run[0](j)
    with pytest.raises(ValueError) as got:
        run[1](t)
    assert str(got.value) == str(want.value)
    assert "CPU oracle implements the dense reference route only" in str(
        got.value)


def test_streaming_refused_on_cpu_reference():
    from spark_examples_tpu.pipelines import streaming as jstreaming

    j, t = _jobs(backend="cpu-reference", stream_refresh_blocks=2)
    with pytest.raises(ValueError) as want:
        jstreaming.incremental_pcoa_job(j)
    with pytest.raises(ValueError) as got:
        tstreaming.incremental_pcoa_job(t)
    assert str(got.value) == str(want.value)


def test_cpu_reference_still_resolves_the_device(capsys):
    """An explicit host backend is not a fallback: --device cuda without
    a card fails as it does on the device route."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for argv in (["pcoa", *ARGV], ["pca", *ARGV],
                 ["pcoa", *ARGV, "--metric", "braycurtis"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain(argv + ["--backend", "cpu-reference", "--device", "cuda"])


def test_cli_backend_flag_choices(capsys):
    with pytest.raises(SystemExit) as err:
        tmain(["pcoa", "--backend", "spark-mllib", "--device", "cpu"])
    assert err.value.code == 2
    assert "invalid choice: 'spark-mllib'" in capsys.readouterr().err


# --------------------------------------------------------- --debug-nans

def _nan_at_finalize(monkeypatch, metric="ibs"):
    """Register a copy of ``metric`` whose finalize plants a NaN."""
    kern = tkernels.get(metric)

    def finalize(stats):
        out = kern.finalize(stats)
        out["distance"][0, 1] = float("nan")
        return out

    monkeypatch.setitem(tkernels._REGISTRY, metric,
                        dataclasses.replace(kern, finalize=finalize))


def test_debug_nans_raises_naming_the_finalize_phase(monkeypatch, tmp_path,
                                                     capsys):
    _nan_at_finalize(monkeypatch)
    out = str(tmp_path / "c.tsv")
    argv = ["pcoa", *ARGV, "--device", "cpu", "--output-path", out]
    with pytest.raises(FloatingPointError, match="NaN in the finalize"):
        tmain(argv + ["--debug-nans"])
    assert not os.path.exists(out)
    assert not profiling._DEBUG_NANS  # the flag ends with its job
    # Without the flag the NaN flows on, as it does in the JAX package
    # without jax_debug_nans.
    assert tmain(argv) == 0
    assert "nan" in open(out).read()
    capsys.readouterr()


def test_debug_nans_names_each_checked_phase(monkeypatch):
    profiling.set_debug_nans(True)
    d = torch.rand(6, 6)
    d = d + d.T
    d.fill_diagonal_(0.0)
    bad = d.clone()
    bad[1, 2] = float("nan")
    with pytest.raises(FloatingPointError, match="centering"):
        fit_pcoa(bad, k=2)
    fit_pcoa(d, k=2)  # clean: passes
    # An inf is not a NaN: jax_debug_nans lets it through too.
    profiling.check_nans("eigh", torch.tensor([float("inf"), 1.0]))
    with pytest.raises(FloatingPointError, match="sketch"):
        profiling.check_nans("sketch", np.array([np.nan]))
    with pytest.raises(FloatingPointError, match="distance"):
        profiling.check_nans("distance", {"d": torch.tensor([np.nan])})


def test_debug_nans_off_checks_nothing(monkeypatch):
    """Off, the check returns before looking at a tensor: no device
    synchronisation is added to the default route."""
    def boom(*a, **k):
        raise AssertionError("isnan evaluated with --debug-nans off")

    monkeypatch.setattr(torch, "isnan", boom)
    monkeypatch.setattr(np, "isnan", boom)
    profiling.check_nans("finalize", torch.tensor([float("nan")]),
                         np.array([np.nan]))


@pytest.mark.parametrize("command,extra", [
    ("pcoa", []), ("pca", []), ("pcoa", ["--metric", "braycurtis"]),
    ("pcoa", ["--solver", "corrected", "--sketch-rank", "8"])])
def test_debug_nans_clean_run_writes_the_same_bytes(tmp_path, capsys,
                                                    command, extra):
    outs = []
    for flag in ([], ["--debug-nans"]):
        out = str(tmp_path / f"c{len(flag)}.tsv")
        assert tmain([command, *ARGV, "--device", "cpu", *extra, *flag,
                      "--output-path", out]) == 0
        outs.append(open(out, "rb").read())
    capsys.readouterr()
    assert outs[0] == outs[1]
