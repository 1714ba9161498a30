"""``pcoa --matrix-path``: the similarity -> PCoA two-job handoff, the
port against the JAX package on the CPU.

The JAX package's ``similarity`` job writes the matrix as ``.npy`` and as
TSV, with its ``.meta.json`` sidecar and without it. The port's
``read_matrix`` reads the same ids, matrix and kind, and its
``pcoa_job(matrix_path=...)`` gives JAX's PCoA for every
``matrix_kind``: eigenvalues within 1e-4 of the largest |lambda| (f32
centering and two eigensolvers; a similarity read as distances has a
top eigenvalue near 0 and a negative spectrum), coordinates per column
up to sign within 2e-3 of the column's scale where the column's
eigengap to both neighbours exceeds 2 % of that |lambda| (closer pairs
may rotate into each other). A column whose eigenvalue is within the
eigenvalue tolerance of 0 or below has coordinates sqrt(max(lambda, 0))
at rounding level in both packages: it is held to that bound instead.
The two refusals are JAX's.
"""

import json
import os

import numpy as np
import pytest

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.pipelines import io as jio
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.pipelines import io as tio
from spark_examples_tpu_torch.pipelines import jobs as tjobs

N, V, BV, K = 40, 1200, 256, 4


def _jjob(**kw):
    return jconfig.JobConfig(
        ingest=jconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV, seed=9),
        compute=jconfig.ComputeConfig(metric="ibs", num_pc=K), **kw)


def _tjob(**kw):
    compute = kw.pop("compute", {})
    return tconfig.JobConfig(
        ingest=tconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV, seed=9),
        compute=tconfig.ComputeConfig(metric="ibs", num_pc=K, device="cpu",
                                      **compute), **kw)


def _agree(got, want):
    jv, tv = np.asarray(want.eigenvalues), np.asarray(got.eigenvalues)
    top = np.abs(jv).max()
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4 * top)
    gaps = np.diff(jv)
    for j in range(K):
        jc, tc = np.asarray(want.coords)[:, j], got.coords[:, j]
        if jv[j] <= 1e-4 * top:
            assert np.abs(tc).max() <= np.sqrt(2e-4 * top), f"pc{j + 1}"
            continue
        left = abs(gaps[j - 1]) if j > 0 else np.inf
        right = abs(gaps[j]) if j < K - 1 else np.inf
        if min(left, right) <= 0.02 * top:
            continue
        s = np.sign(np.dot(jc, tc)) or 1.0
        np.testing.assert_allclose(s * tc, jc,
                                   atol=2e-3 * np.abs(jc).max(),
                                   err_msg=f"pc{j + 1}")
    assert got.sample_ids == want.sample_ids
    assert got.coords.shape == (N, K) and got.n_variants == 0
    # A similarity read as distances has a total inertia <= 0: the share
    # of it is undefined (clamped division) in both packages.
    if (np.asarray(want.proportion) <= 1.0).all():
        np.testing.assert_allclose(got.proportion, want.proportion,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def jax_matrices(tmp_path_factory):
    """JAX's similarity job, written once as .npy and as TSV."""
    root = tmp_path_factory.mktemp("mats")
    out = {}
    for fmt in ("npy", "tsv"):
        path = str(root / f"sim.{fmt}")
        jjobs.similarity_matrix_job(_jjob(output_path=path))
        out[fmt] = path
    return out


@pytest.mark.parametrize("sidecar", [True, False])
@pytest.mark.parametrize("fmt", ["npy", "tsv"])
def test_read_matrix_matches_jax(jax_matrices, tmp_path, fmt, sidecar):
    path = _maybe_without_sidecar(jax_matrices[fmt], tmp_path, sidecar)
    ids, m, kind = tio.read_matrix(path)
    jids, jm, jkind = jio.read_matrix(path)
    assert ids == jids and kind == jkind
    assert kind == ("similarity" if sidecar else None)
    np.testing.assert_array_equal(m, jm)
    assert m.dtype == jm.dtype


def _maybe_without_sidecar(path, tmp_path, sidecar):
    if sidecar:
        return path
    bare = str(tmp_path / os.path.basename(path))
    with open(path, "rb") as src, open(bare, "wb") as dst:
        dst.write(src.read())
    return bare


@pytest.mark.parametrize("kind", ["auto", "distance", "similarity"])
@pytest.mark.parametrize("sidecar", [True, False])
@pytest.mark.parametrize("fmt", ["npy", "tsv"])
def test_pcoa_from_matrix_matches_jax(jax_matrices, tmp_path, fmt, sidecar,
                                      kind):
    path = _maybe_without_sidecar(jax_matrices[fmt], tmp_path, sidecar)
    got = tjobs.pcoa_job(_tjob(), matrix_path=path, matrix_kind=kind)
    want = jjobs.pcoa_job(_jjob(), matrix_path=path, matrix_kind=kind)
    _agree(got, want)


def test_port_similarity_then_pcoa_matrix_path_cli(tmp_path, capsys):
    """The port's two jobs through the CLI, against JAX's pcoa of the
    port's own file."""
    mat, coords = str(tmp_path / "d.npy"), str(tmp_path / "c.tsv")
    flags = ["--device", "cpu", "--n-samples", str(N), "--n-variants",
             str(V), "--block-variants", str(BV), "--seed", "9",
             "--num-pc", str(K)]
    assert tmain(["similarity", "--output-path", mat] + flags) == 0
    assert json.load(open(mat + ".meta.json"))["kind"] == "similarity"
    assert tmain(["pcoa", "--matrix-path", mat, "--output-path", coords]
                 + flags) == 0
    assert f"{N} samples x {K} components over 0 variants" in \
        capsys.readouterr().out
    rows = [line.split("\t") for line in open(coords).read().splitlines()]
    got = np.asarray([r[1:] for r in rows[1:]], np.float64)
    want = jjobs.pcoa_job(_jjob(), matrix_path=mat)
    jc = np.asarray(want.coords)
    for j in range(2):
        s = np.sign(np.dot(jc[:, j], got[:, j])) or 1.0
        np.testing.assert_allclose(s * got[:, j], jc[:, j],
                                   atol=2e-3 * np.abs(jc[:, j]).max())


def test_the_two_refusals_are_jax_s(jax_matrices):
    path = jax_matrices["npy"]
    sketch = _tjob(compute={"solver": "corrected", "sketch_rank": 16})
    with pytest.raises(ValueError, match="consume it with --solver exact"):
        tjobs.pcoa_job(sketch, matrix_path=path)
    with pytest.raises(ValueError, match="consume it with --solver exact"):
        jjobs.pcoa_job(_jjob().replace(compute=jconfig.ComputeConfig(
            metric="ibs", num_pc=K, solver="corrected", sketch_rank=16)),
            matrix_path=path)
    # --save-model with --matrix-path is refused by the matrix route.
    job = _tjob()
    job.model_path = "m.npz"
    with pytest.raises(ValueError, match="--save-model cannot be combined"):
        tjobs.pcoa_job(job, matrix_path=path)
    with pytest.raises(ValueError, match="matrix_kind must be"):
        tjobs.pcoa_job(_tjob(), matrix_path=path, matrix_kind="kinship")


def test_rectangular_and_ragged_matrices_are_refused(tmp_path):
    rect = str(tmp_path / "x.npy")
    jio.write_matrix(rect, ["a", "b"], np.zeros((2, 3), np.float32),
                     kind="similarity", col_ids=["c", "d", "e"])
    with pytest.raises(ValueError, match="rectangular cross-cohort"):
        tio.read_matrix(rect)
    ragged = tmp_path / "r.tsv"
    ragged.write_text("sample\ta\tb\na\t1\t2\n")
    with pytest.raises(ValueError, match="1x2"):
        tio.read_matrix(str(ragged))
    with pytest.raises(SystemExit):
        tmain(["pcoa", "--device", "cpu", "--matrix-path", rect,
               "--matrix-kind", "kinship"])
