"""Fit a panel, then project new samples: the port's ``--save-model``,
``project``, ``cross-kinship`` and factorized models against the JAX
package, on the CPU.

- The JAX package's projection cases (tests/test_projection.py), its
  factorized-model cases (tests/test_factorized.py) and its cross
  kinship cases (tests/test_kinship.py), run on the port.
- The cross-framework contracts: int32 cross accumulators bitwise equal
  to JAX's ``cross_stats`` for every CROSS_STATS entry; a model saved by
  either package loads in the other with the same digest and projects to
  coordinates within 1e-5 of max|coords| of JAX's; the streamed query
  denominator and the kinship bitwise.
"""

import dataclasses
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core.profiling import PhaseTimer as JPhaseTimer
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.ops import genotype as jgenotype
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import project as jproject
from spark_examples_tpu.utils import oracle
from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.models.factorized import FactorizedModel
from spark_examples_tpu_torch.ops import genotype as tgenotype
from spark_examples_tpu_torch.pipelines import io as tio
from spark_examples_tpu_torch.pipelines import project as tproject
from spark_examples_tpu_torch.pipelines.jobs import (
    pcoa_job,
    variants_pca_job,
)
from spark_examples_tpu_torch.pipelines.project import (
    SCHEMA_VERSION,
    ModelFormatError,
    cross_kinship_job,
    load_model,
    pcoa_project_job,
)

from conftest import random_genotypes

def _cohort(rng, n, v, pops=3):
    labels = rng.integers(0, pops, n)
    p = (0.05 + 0.9 * rng.random((pops, v)))[labels]
    g = ((rng.random((n, v)) < p).astype(np.int8)
         + (rng.random((n, v)) < p).astype(np.int8))
    return g, labels


def _job(bv, model_path=None, **compute):
    compute.setdefault("metric", "ibs")
    return JobConfig(ingest=IngestConfig(block_variants=bv),
                     compute=ComputeConfig(device="cpu", **compute),
                     model_path=model_path)


def _jjob(bv, model_path=None, **compute):
    compute.setdefault("metric", "ibs")
    return jconfig.JobConfig(ingest=jconfig.IngestConfig(block_variants=bv),
                             compute=jconfig.ComputeConfig(**compute),
                             model_path=model_path)


def _started_threads(before):
    return [t for t in threading.enumerate()
            if t not in before and t.is_alive()]


# ------------------------------------------ JAX's projection cases

def test_project_training_samples_is_exact(rng, tmp_path):
    """B V = V diag(lambda): the panel's own samples project onto their
    fitted coordinates."""
    g = random_genotypes(rng, n=20, v=500, missing_rate=0.1)
    model = str(tmp_path / "m.npz")
    job = _job(128, model, num_pc=5)
    fitted = pcoa_job(job, source=ArraySource(g))
    out = pcoa_project_job(job.replace(model_path=None), model_path=model,
                           source_new=ArraySource(g),
                           source_ref=ArraySource(g))
    k = out.coords.shape[1]  # lambda <= 0 components dropped
    np.testing.assert_allclose(out.coords, fitted.coords[:, :k], atol=1e-3)


def test_project_places_heldout_by_ancestry(rng, tmp_path):
    g, labels = _cohort(rng, n=90, v=4000)
    ref, new, lr, ln = g[:60], g[60:], labels[:60], labels[60:]
    model = str(tmp_path / "m.npz")
    job = _job(512, model, num_pc=4)
    fitted = pcoa_job(job, source=ArraySource(ref))
    out = pcoa_project_job(job.replace(model_path=None), model_path=model,
                           source_new=ArraySource(new),
                           source_ref=ArraySource(ref))
    cents = np.stack([fitted.coords[lr == c, :2].mean(0) for c in range(3)])
    for i in range(len(ln)):
        d = np.linalg.norm(out.coords[i, :2] - cents, axis=1)
        assert d.argmin() == ln[i]


def test_project_rejects_mismatched_streams(rng, tmp_path):
    g = random_genotypes(rng, n=10, v=256)
    model = str(tmp_path / "m.npz")
    job = _job(64, model, num_pc=3)
    pcoa_job(job, source=ArraySource(g))
    job = job.replace(model_path=None)
    with pytest.raises(ValueError, match="diverged|ended first"):
        pcoa_project_job(job, model_path=model,
                         source_new=ArraySource(g[:, :200]),
                         source_ref=ArraySource(g))
    with pytest.raises(ValueError, match="fitted on"):
        pcoa_project_job(job, model_path=model, source_new=ArraySource(g),
                         source_ref=ArraySource(g[:6]))
    with pytest.raises(ValueError, match="fitted on"):
        pcoa_project_job(
            job, model_path=model, source_new=ArraySource(g),
            source_ref=ArraySource(g, ids=[f"OTHER{i}" for i in range(10)]))


@pytest.mark.parametrize("case", ["shorter", "diverged", "positions"])
def test_stream_errors_leave_no_feed_thread_behind(rng, tmp_path, case):
    """The lockstep zip raises JAX's error and both feeds' producer
    threads end (only threads this test started are counted)."""
    g = random_genotypes(rng, n=10, v=256)
    model = str(tmp_path / "m.npz")
    job = _job(64, model, num_pc=3)
    pcoa_job(job, source=ArraySource(g))
    new = {"shorter": ArraySource(g[:, :192]),
           "diverged": ArraySource(g[:, :200]),
           "positions": ArraySource(g, positions=np.arange(256) + 7)}[case]
    ref = ArraySource(g, positions=np.arange(256))
    before = set(threading.enumerate())
    match = {"shorter": "ended first", "diverged": "diverged",
             "positions": "positions differ"}[case]
    with pytest.raises(ValueError, match=match):
        pcoa_project_job(job.replace(model_path=None), model_path=model,
                         source_new=new, source_ref=ref)
    for t in _started_threads(before):
        t.join(timeout=10)
    assert not _started_threads(before)


def test_pca_project_training_samples_is_exact(rng, tmp_path):
    g = random_genotypes(rng, n=20, v=500, missing_rate=0.1)
    model = str(tmp_path / "m.npz")
    job = _job(128, model, num_pc=4, metric=None)
    fitted = variants_pca_job(job, source=ArraySource(g))
    out = pcoa_project_job(job.replace(model_path=None), model_path=model,
                           source_new=ArraySource(g),
                           source_ref=ArraySource(g))
    k = out.coords.shape[1]
    np.testing.assert_allclose(out.coords, fitted.coords[:, :k], atol=2e-2)


def test_pca_project_places_heldout_by_ancestry(rng, tmp_path):
    g, labels = _cohort(rng, n=90, v=4000)
    ref, new, lr, ln = g[:60], g[60:], labels[:60], labels[60:]
    model = str(tmp_path / "m.npz")
    job = _job(512, model, num_pc=3, metric=None)
    fitted = variants_pca_job(job, source=ArraySource(ref))
    out = pcoa_project_job(job.replace(model_path=None), model_path=model,
                           source_new=ArraySource(new),
                           source_ref=ArraySource(ref))
    cents = np.stack([fitted.coords[lr == c, :2].mean(0) for c in range(3)])
    for i in range(len(ln)):
        d = np.linalg.norm(out.coords[i, :2] - cents, axis=1)
        assert d.argmin() == ln[i]


def test_shared_alt_pcoa_model_is_rejected_up_front(rng, tmp_path,
                                                    monkeypatch):
    """A shared-alt PCoA model is valid to fit but not projectable; the
    gate keys on (kind, metric) and fails before anything streams."""
    g = random_genotypes(rng, n=10, v=256)
    model = str(tmp_path / "m.npz")
    job = _job(64, model, num_pc=3, metric="shared-alt")
    pcoa_job(job, source=ArraySource(g))

    def no_stream(*a, **k):
        raise AssertionError("streamed before the gate")

    monkeypatch.setattr(tproject, "_accumulate_cross", no_stream)
    with pytest.raises(ValueError, match="not.*projectable"):
        pcoa_project_job(job.replace(model_path=None), model_path=model,
                         source_new=ArraySource(g),
                         source_ref=ArraySource(g))


def test_qc_pack_fit_project_chain(rng, tmp_path, capsys):
    """pack --maf into a filtered store, fit on it, project from the same
    store: the self-projection reproduces the fitted coordinates."""
    from spark_examples_tpu_torch.ingest.vcf import write_vcf

    g = random_genotypes(rng, n=12, v=500, missing_rate=0.2)
    vcf = str(tmp_path / "c.vcf")
    write_vcf(vcf, g)
    store, model = str(tmp_path / "store"), str(tmp_path / "m.npz")
    fit_tsv, proj_tsv = str(tmp_path / "f.tsv"), str(tmp_path / "p.tsv")
    assert tmain(["pack", "--device", "cpu", "--source", "vcf", "--path",
                  vcf, "--maf", "0.1", "--max-missing", "0.2",
                  "--output-path", store, "--block-variants", "64"]) == 0
    assert tmain(["pcoa", "--device", "cpu", "--source", "packed", "--path",
                  store, "--num-pc", "3", "--block-variants", "64",
                  "--save-model", model, "--output-path", fit_tsv]) == 0
    assert tmain(["project", "--device", "cpu", "--source", "packed",
                  "--path", store, "--ref-source", "packed", "--ref-path",
                  store, "--model", model, "--block-variants", "64",
                  "--output-path", proj_tsv]) == 0
    fit = np.loadtxt(fit_tsv, skiprows=1, usecols=(1, 2, 3))
    proj = np.loadtxt(proj_tsv, skiprows=1, usecols=(1, 2, 3))
    np.testing.assert_allclose(proj, fit, atol=5e-3)
    capsys.readouterr()


def test_project_cli_flow(rng, tmp_path, capsys):
    """pcoa --save-model then project, through the CLI, from PLINK."""
    from spark_examples_tpu_torch.ingest.plink import write_plink

    g, _ = _cohort(rng, n=40, v=1500)
    refp, newp = str(tmp_path / "ref"), str(tmp_path / "new")
    write_plink(refp, g[:30])
    write_plink(newp, g[30:])
    model, coords = str(tmp_path / "m.npz"), str(tmp_path / "proj.tsv")
    assert tmain(["pcoa", "--device", "cpu", "--source", "plink", "--path",
                  refp, "--block-variants", "256", "--num-pc", "3",
                  "--save-model", model]) == 0
    assert tmain(["project", "--device", "cpu", "--source", "plink",
                  "--path", newp, "--ref-source", "plink", "--ref-path",
                  refp, "--block-variants", "256", "--model", model,
                  "--output-path", coords]) == 0
    got = np.loadtxt(coords, skiprows=1, usecols=(1, 2, 3))
    assert got.shape == (10, 3)
    assert "10 samples x 3 components" in capsys.readouterr().out


def test_allele_flip_detected(rng, tmp_path):
    """REF/ALT swapped in one cohort (g -> 2 - g) warns; concordant
    cohorts stay silent."""
    g = random_genotypes(rng, n=16, v=600, missing_rate=0.05)
    model = str(tmp_path / "m.npz")
    job = _job(128, model, num_pc=3)
    pcoa_job(job, source=ArraySource(g))
    job = job.replace(model_path=None)
    flipped = np.where(g >= 0, 2 - g, -1).astype(np.int8)
    with pytest.warns(RuntimeWarning, match="allele-frequency"):
        pcoa_project_job(job, model_path=model,
                         source_new=ArraySource(flipped),
                         source_ref=ArraySource(g))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pcoa_project_job(job, model_path=model, source_new=ArraySource(g),
                         source_ref=ArraySource(g))
    assert not [x for x in w if "allele-frequency" in str(x.message)]


def test_single_sample_projection_does_not_warn(rng, tmp_path):
    """A one-sample cohort's AFs are noisy (r tops out near 0.3-0.5):
    only a negative correlation (a true flip) warns at that size."""
    g, _ = _cohort(rng, n=40, v=3000)
    ref, one = g[:39], g[39:]
    model = str(tmp_path / "m.npz")
    job = _job(512, model, num_pc=3)
    pcoa_job(job, source=ArraySource(ref))
    job = job.replace(model_path=None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = pcoa_project_job(job, model_path=model,
                               source_new=ArraySource(one),
                               source_ref=ArraySource(ref))
    assert not [x for x in w if "allele-frequency" in str(x.message)]
    assert out.coords.shape == (1, 3)
    flipped = np.where(one >= 0, 2 - one, -1).astype(np.int8)
    with pytest.warns(RuntimeWarning, match="swapped"):
        pcoa_project_job(job, model_path=model,
                         source_new=ArraySource(flipped),
                         source_ref=ArraySource(ref))


def test_model_schema_version_and_friendly_errors(rng, tmp_path):
    """Saved models carry schema_version; load_model refuses pre-
    versioning, future, truncated and field-missing files with an error
    naming the cause, never a raw KeyError or BadZipFile."""
    g = random_genotypes(rng, n=10, v=256)
    model = str(tmp_path / "m.npz")
    job = _job(64, model, num_pc=3)
    pcoa_job(job, source=ArraySource(g))
    with np.load(model) as mdl:
        assert int(mdl["schema_version"]) == SCHEMA_VERSION
        payload = {k: mdl[k] for k in mdl.files}
    loaded = load_model(model)
    assert loaded.kind == "pcoa" and loaded.metric == "ibs"
    assert loaded.n_ref == 10
    assert loaded.digest() == load_model(model).digest()

    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, **{k: v for k, v in payload.items()
                        if k != "schema_version"})
    with pytest.raises(ModelFormatError, match="schema_version"):
        load_model(legacy)
    broken = str(tmp_path / "broken.npz")
    np.savez(broken, **{k: v for k, v in payload.items()
                        if k != "d2_colmean"})
    with pytest.raises(ModelFormatError, match="d2_colmean"):
        load_model(broken)
    future = str(tmp_path / "future.npz")
    np.savez(future, **{**payload,
                        "schema_version": np.int64(SCHEMA_VERSION + 1)})
    with pytest.raises(ModelFormatError, match="newer"):
        load_model(future)
    unknown = str(tmp_path / "unknown.npz")
    np.savez(unknown, **{**payload, "kind": np.asarray("umap")})
    with pytest.raises(ModelFormatError, match="unknown kind"):
        load_model(unknown)
    trunc = str(tmp_path / "trunc.npz")
    raw = open(model, "rb").read()
    with open(trunc, "wb") as f:
        f.write(raw[: len(raw) // 3])
    with pytest.raises(ModelFormatError, match="truncated or corrupt"):
        load_model(trunc)
    with pytest.raises(ModelFormatError):
        pcoa_project_job(job.replace(model_path=None), model_path=trunc,
                         source_new=ArraySource(g),
                         source_ref=ArraySource(g))
    pca_model = str(tmp_path / "pca.npz")
    variants_pca_job(_job(64, pca_model, num_pc=3, metric=None),
                     source=ArraySource(g))
    assert load_model(pca_model).kind == "pca"


# --------------------------------------------- the CLI's refusals

@pytest.mark.parametrize("argv,match", [
    (["project", "--model", "m.npz", "--maf", "0.1", "--ref-path", "r"],
     "cannot apply during project"),
    (["project", "--model", "m.npz"], "project requires --ref-path"),
    (["cross-kinship", "--ld-prune-r2", "0.2", "--ref-path", "r"],
     "cannot apply during cross-kinship"),
    (["cross-kinship"], "cross-kinship requires --ref-path"),
    (["pcoa", "--save-model", "m.npz", "--solver", "sketch"],
     "--save-model with --metric ibs"),
    (["pcoa", "--save-model", "m.npz", "--solver", "corrected",
      "--metric", "dot"], "no factorized projection path"),
])
def test_cross_and_save_model_refusals_are_usage_errors(argv, match,
                                                        capsys):
    with pytest.raises(SystemExit):
        tmain(argv[:1] + ["--device", "cpu"] + argv[1:])
    assert match in capsys.readouterr().err


def test_pcoa_fit_of_a_pca_family_sketch_is_refused_at_run_time(rng,
                                                                tmp_path):
    g = random_genotypes(rng, n=12, v=256)
    job = _job(64, str(tmp_path / "m.npz"), num_pc=3, metric="shared-alt",
               solver="sketch", sketch_rank=8)
    with pytest.raises(ValueError, match="a pcoa fit of --metric "
                       "shared-alt serves the Gower geometry"):
        pcoa_job(job, source=ArraySource(g))


def test_cross_kinship_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tmain(["cross-kinship", "--n-samples", "4", "--n-variants", "64",
               "--ref-source", "synthetic"])


def test_project_on_cuda_without_a_card_raises(monkeypatch, rng, tmp_path):
    g = random_genotypes(rng, n=8, v=128)
    model = str(tmp_path / "m.npz")
    pcoa_job(_job(64, model, num_pc=2), source=ArraySource(g))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        pcoa_project_job(JobConfig(ingest=IngestConfig(block_variants=64)),
                         model_path=model, source_new=ArraySource(g),
                         source_ref=ArraySource(g))


# ------------------------------------------- JAX's factorized cases

N, V_F, BV_F, K_F, RANK, ITERS = 48, 1024, 256, 4, 24, 2


@pytest.fixture(scope="module")
def factorized(tmp_path_factory):
    """A corrected-rung dual (pcoa/ibs) model and a corrected-rung
    pca-family model, each fitted by both packages on one panel."""
    base = tmp_path_factory.mktemp("factorized")
    g, labels = _cohort(np.random.default_rng(19), N + 12, V_F)
    out = {"g": g[:N], "labels": labels[:N], "new": g[N:],
           "new_labels": labels[N:]}
    g = g[:N]
    for kind, metric in (("pcoa", "ibs"), ("pcoa", "jaccard"),
                         ("pca", None)):
        key = f"{kind}-{metric}"
        sketch = dict(num_pc=K_F, solver="corrected", sketch_rank=RANK,
                      sketch_iters=ITERS, metric=metric)
        tpath, jpath = str(base / f"t-{key}.npz"), str(base / f"j-{key}.npz")
        tjob = _job(BV_F, tpath, **sketch)
        jjob = _jjob(BV_F, jpath, **sketch)
        if kind == "pca":
            out[key, "fit"] = variants_pca_job(tjob, source=ArraySource(g))
            jjobs.variants_pca_job(jjob, source=JArraySource(g))
        else:
            out[key, "fit"] = pcoa_job(tjob, source=ArraySource(g))
            jjobs.pcoa_job(jjob, source=JArraySource(g))
        out[key] = (tpath, jpath)
    return out


def test_roundtrip_and_digest_carries_rung(factorized):
    big = load_model(factorized["pcoa-ibs"][0])
    assert isinstance(big, FactorizedModel)
    assert (big.kind, big.family, big.metric) == ("factorized", "pcoa",
                                                  "ibs")
    assert (big.solver, big.rank) == ("corrected", RANK)
    assert big.n_ref == N and len(big.sample_ids) == N
    assert big.scale is not None and big.scale.shape == (N,)
    assert big.colmean.shape == (N,)
    assert big.eigvecs.shape[1] == big.eigvals.shape[0] <= K_F
    warm = load_model(factorized["pca-None"][0])
    assert (warm.kind, warm.family) == ("factorized", "pca")
    assert warm.scale is None
    d = big.digest()
    assert len(d) == 16 and set(d) <= set("0123456789abcdef")
    assert dataclasses.replace(big, solver="sketch").digest() != d
    assert dataclasses.replace(big, rank=RANK + 8).digest() != d
    assert dataclasses.replace(big, seed=big.seed + 1).digest() != d
    assert load_model(factorized["pcoa-ibs"][0]).digest() == d


def test_factorized_format_error_ladder(factorized, tmp_path):
    with np.load(factorized["pcoa-ibs"][0], allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    bad = str(tmp_path / "family.npz")
    np.savez(bad, **{**payload, "family": np.asarray("zca")})
    with pytest.raises(ModelFormatError, match="unknown factorized family"):
        load_model(bad)
    for field in ("colmean", "scale"):
        bad = str(tmp_path / f"no-{field}.npz")
        np.savez(bad, **{k: v for k, v in payload.items() if k != field})
        with pytest.raises(ModelFormatError,
                           match=rf"missing required field\(s\).*{field}"):
            load_model(bad)


def test_pca_sketch_rung_is_savable(factorized, tmp_path):
    model = str(tmp_path / "sketch.npz")
    variants_pca_job(_job(BV_F, model, num_pc=K_F, metric=None,
                          solver="sketch", sketch_rank=RANK),
                     source=ArraySource(factorized["g"]))
    mdl = load_model(model)
    assert (mdl.kind, mdl.family, mdl.solver) == ("factorized", "pca",
                                                  "sketch")
    assert mdl.digest() != load_model(factorized["pca-None"][0]).digest()


@pytest.mark.parametrize("key", ["pcoa-ibs", "pcoa-jaccard", "pca-None"])
def test_factorized_projection_places_heldout_by_ancestry(factorized, key):
    """Held-out samples projected through a factorized model land
    nearest their own population's centroid of the fitted panel."""
    tpath, _ = factorized[key]
    out = pcoa_project_job(_job(BV_F), model_path=tpath,
                           source_new=ArraySource(factorized["new"]),
                           source_ref=ArraySource(factorized["g"]))
    fit, lr = factorized[key, "fit"].coords, factorized["labels"]
    cents = np.stack([fit[lr == c, :2].mean(0) for c in range(3)])
    for row, label in zip(out.coords, factorized["new_labels"]):
        assert np.linalg.norm(row[:2] - cents, axis=1).argmin() == label


# ------------------------------------------ JAX's cross-kinship cases

def test_cross_kinship_matches_symmetric_blocks(rng):
    """Cross phi between A and B equals the off-diagonal block of the
    symmetric KING matrix over [A; B]."""
    g = random_genotypes(rng, n=20, v=600, missing_rate=0.1)
    a, b = g[:8], g[8:]
    res = cross_kinship_job(_job(128), source_new=ArraySource(a),
                            source_ref=ArraySource(b))
    np.testing.assert_allclose(res.similarity, oracle.naive_king(g)[:8, 8:],
                               atol=1e-6)
    np.testing.assert_array_equal(res.distance,
                                  np.maximum(0.5 - res.similarity, 0.0))


def test_cross_kinship_finds_planted_duplicates_and_relatives(rng):
    v = 20_000
    p = rng.uniform(0.2, 0.8, v)
    al = (rng.random((6, v)) < p).astype(np.int8)
    bl = (rng.random((6, v)) < p).astype(np.int8)
    panel = al + bl
    child = (np.where(rng.random(v) < 0.5, al[0], bl[0])
             + np.where(rng.random(v) < 0.5, al[1], bl[1])).astype(np.int8)
    new = np.stack([panel[2].copy(), child,
                    ((rng.random(v) < p).astype(np.int8)
                     + (rng.random(v) < p).astype(np.int8))])
    phi = cross_kinship_job(_job(4096), source_new=ArraySource(new),
                            source_ref=ArraySource(panel)).similarity
    assert abs(phi[0, 2] - 0.5) < 0.02
    assert abs(phi[1, 0] - 0.25) < 0.03
    assert abs(phi[1, 1] - 0.25) < 0.03
    assert abs(phi[2, 3]) < 0.03


def test_cross_matrix_rejected_by_square_reader(tmp_path):
    path = str(tmp_path / "x.tsv")
    tio.write_matrix(path, ["a", "b"], np.zeros((2, 3)), kind="similarity",
                     col_ids=["r0", "r1", "r2"])
    with pytest.raises(ValueError, match="rectangular"):
        tio.read_matrix(path)


def test_cross_kinship_cli_writes_the_rectangle(rng, tmp_path, capsys):
    from spark_examples_tpu_torch.ingest.plink import write_plink

    g = random_genotypes(rng, n=14, v=800, missing_rate=0.05)
    refp, newp = str(tmp_path / "ref"), str(tmp_path / "new")
    write_plink(refp, g[:10])
    write_plink(newp, np.concatenate([g[10:], g[3:4]]))
    out = str(tmp_path / "phi.tsv")
    assert tmain(["cross-kinship", "--device", "cpu", "--source", "plink",
                  "--path", newp, "--ref-source", "plink", "--ref-path",
                  refp, "--block-variants", "256", "--output-path",
                  out]) == 0
    text = capsys.readouterr().out
    assert "cross-kinship 5x10 over 800 variants; 1 pairs" in text
    with open(out) as f:
        header = f.readline().rstrip("\n").split("\t")
    assert len(header) == 11


# ---------------------------------------- cross-framework contracts

@pytest.mark.parametrize("stat", sorted(tgenotype.CROSS_STATS))
@pytest.mark.parametrize("a", [1, 7])
def test_cross_stats_bitwise_equal_to_jax(stat, a):
    rng = np.random.default_rng(len(stat) * 10 + a)
    bn = random_genotypes(rng, a, 333, missing_rate=0.2)
    br = random_genotypes(rng, 9, 333, missing_rate=0.2)
    got = tgenotype.cross_stats(torch.from_numpy(bn), torch.from_numpy(br),
                                (stat,))[stat]
    want = jgenotype.cross_stats(jnp.asarray(bn), jnp.asarray(br),
                                 (stat,))[stat]
    assert got.dtype == torch.int32 and got.shape == (a, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cross_stats_table_is_jax_s():
    assert tgenotype.CROSS_STATS == jgenotype.CROSS_STATS
    assert tproject.PROJECTABLE == jproject.PROJECTABLE


@pytest.mark.parametrize("metric", ["ibs", "jaccard"])
def test_accumulate_cross_and_query_denominator_bitwise(rng, metric):
    """The lockstep pass: int32 accumulators and the f32 query
    denominator diagonal bitwise equal to JAX's over several ragged
    blocks."""
    g_new = random_genotypes(rng, n=5, v=700, missing_rate=0.1)
    g_ref = random_genotypes(rng, n=11, v=700, missing_rate=0.1)
    stats = kernels.get(metric).cross.stats
    acc, nv, qden = tproject._accumulate_cross(
        _job(256), ArraySource(g_new), ArraySource(g_ref), stats,
        PhaseTimer(), den_metric=metric)
    jacc, jnv, jqden = jproject._accumulate_cross(
        _jjob(256), JArraySource(g_new), JArraySource(g_ref), stats,
        JPhaseTimer(), den_metric=metric)
    assert nv == jnv == 700
    for k in stats:
        np.testing.assert_array_equal(acc[k].numpy(), np.asarray(jacc[k]))
    np.testing.assert_array_equal(qden.numpy(), np.asarray(jqden))


def test_cross_kinship_bitwise_equal_to_jax(rng):
    g = random_genotypes(rng, n=17, v=900, missing_rate=0.1)
    got = cross_kinship_job(_job(256), ArraySource(g[:6]),
                            ArraySource(g[6:]))
    want = jproject.cross_kinship_job(_jjob(256), JArraySource(g[:6]),
                                      JArraySource(g[6:]))
    np.testing.assert_array_equal(got.similarity, want.similarity)
    assert got.n_variants == want.n_variants


@pytest.fixture(scope="module")
def exact_models(tmp_path_factory):
    """pcoa (ibs, jaccard) and pca models, each fitted by both packages
    on one panel, plus a held-out cohort."""
    base = tmp_path_factory.mktemp("exact_models")
    g, labels = _cohort(np.random.default_rng(5), 56, 1536)
    g[np.random.default_rng(6).random(g.shape) < 0.05] = -1
    out = {"ref": g[:44], "new": g[44:]}
    for kind, metric in (("pcoa", "ibs"), ("pcoa", "jaccard"),
                         ("pca", None)):
        key = f"{kind}-{metric}"
        tpath, jpath = str(base / f"t-{key}.npz"), str(base / f"j-{key}.npz")
        if kind == "pca":
            variants_pca_job(_job(512, tpath, num_pc=5, metric=None),
                             source=ArraySource(out["ref"]))
            jjobs.variants_pca_job(_jjob(512, jpath, num_pc=5, metric=None),
                                   source=JArraySource(out["ref"]))
        else:
            pcoa_job(_job(512, tpath, num_pc=5, metric=metric),
                     source=ArraySource(out["ref"]))
            jjobs.pcoa_job(_jjob(512, jpath, num_pc=5, metric=metric),
                           source=JArraySource(out["ref"]))
        out[key] = (tpath, jpath)
    return out


MODEL_KEYS = ["pcoa-ibs", "pcoa-jaccard", "pca-None"]


@pytest.mark.parametrize("key", MODEL_KEYS)
@pytest.mark.parametrize("writer", [0, 1], ids=["port-file", "jax-file"])
def test_models_cross_load_with_the_same_digest(exact_models, factorized,
                                                key, writer):
    for models in (exact_models, factorized):
        path = models[key][writer]
        t, j = load_model(path), jproject.load_model(path)
        assert t.digest() == j.digest()
        assert (t.kind, t.metric, t.solver) == (j.kind, j.metric, j.solver)
        assert t.sample_ids == j.sample_ids
        assert getattr(t, "family", None) == getattr(j, "family", None)


@pytest.mark.parametrize("key", MODEL_KEYS)
def test_saved_fields_have_jax_s_dtypes(exact_models, factorized, key):
    for models in (exact_models, factorized):
        tpath, jpath = models[key]
        with np.load(tpath, allow_pickle=False) as t, \
                np.load(jpath, allow_pickle=False) as j:
            assert sorted(t.files) == sorted(j.files)
            for name in j.files:
                assert t[name].dtype == j[name].dtype, name
                assert t[name].shape == j[name].shape, name
                if j[name].dtype.kind == "U" or name == "sample_ids":
                    np.testing.assert_array_equal(t[name], j[name])


@pytest.mark.parametrize("key", MODEL_KEYS)
@pytest.mark.parametrize("writer", [0, 1], ids=["port-file", "jax-file"])
@pytest.mark.parametrize("family", ["exact", "factorized"])
def test_both_packages_project_one_model_file_alike(exact_models,
                                                    factorized, key,
                                                    writer, family):
    """The same model file projected by both packages: coordinates within
    1e-5 of max|coords| (the eigenvectors come from the file, so no sign
    ambiguity)."""
    if family == "exact":
        models, ref, new = exact_models, exact_models["ref"], \
            exact_models["new"]
    else:
        models, ref, new = factorized, factorized["g"], factorized["new"]
    path = models[key][writer]
    bv = 512 if family == "exact" else BV_F
    got = pcoa_project_job(_job(bv), model_path=path,
                           source_new=ArraySource(new),
                           source_ref=ArraySource(ref)).coords
    want = jproject.pcoa_project_job(_jjob(bv), model_path=path,
                                     source_new=JArraySource(new),
                                     source_ref=JArraySource(ref)).coords
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
