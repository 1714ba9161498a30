"""The port's tiled finalize -> center -> eigensolve route, the tile2d
``pcoa``/``pca`` jobs and ``project`` under a tile2d ``CrossPlan``,
against the JAX package on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices, the port on 8
virtual CPU slots, at the (2, 4) and (4, 2) mesh shapes. The port's
probes come from a CPU ``torch.Generator``; every comparison with a JAX
solve patches JAX's ``jax.random.key(0)`` probes into
``pcoa_sharded.default_probes``.

Tolerances: eigenvalues within rtol 1e-4 of JAX's and coordinates per
column up to sign within 1e-4 of the column's largest entry (the f32
products, QR and eigh run in another order: the float64 centering means
and XLA's f32 reductions differ in the last bits, which the power
iteration carries); the dense-route comparisons are JAX's own
(tests/test_parallel.py). Integer cross statistics are exact, so a
tiled cross pass projects bitwise the replicated one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import meshes as jmeshes
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.ops import eigh as jeigh
from spark_examples_tpu.parallel import gram_sharded as jgs
from spark_examples_tpu.parallel import pcoa_sharded as jps
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import project as jproject
from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import meshes, virtual
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.models.pca import fit_pca
from spark_examples_tpu_torch.models.pcoa import fit_pcoa
from spark_examples_tpu_torch.ops import distances, eigh, gram
from spark_examples_tpu_torch.ops.centering import gower_center
from spark_examples_tpu_torch.parallel import gram_sharded as gs
from spark_examples_tpu_torch.parallel import pcoa_sharded as ps
from spark_examples_tpu_torch.pipelines import jobs, project

from conftest import random_genotypes

SHAPES = [(2, 4), (4, 2)]
EIG_RTOL = 1e-4
COORD_TOL = 1e-4


def _mesh(shape=(2, 4)):
    return meshes.make_mesh(virtual.virtual_devices(8, "cpu"), shape)


def _jax_probes(n, p):
    return torch.from_numpy(np.array(
        jeigh.init_probes(jax.random.key(0), n, p, jnp.float32)))


@pytest.fixture
def jax_probes(monkeypatch):
    monkeypatch.setattr(ps, "default_probes", _jax_probes)


def _same_columns(got, want, tol=COORD_TOL):
    """Per column up to sign, within ``tol`` of the column scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    for c in range(want.shape[1]):
        sign = 1.0 if got[:, c] @ want[:, c] >= 0 else -1.0
        scale = np.abs(want[:, c]).max()
        err = np.abs(sign * got[:, c] - want[:, c]).max() / scale
        assert err <= tol, (c, err)


def _accumulate(shape, metric, g, block):
    """The same blocks into the port's and JAX's tile2d accumulators."""
    plan = gs.GramPlan(_mesh(shape), "tile2d")
    jplan = jgs.GramPlan(jmeshes.make_mesh(shape=shape), "tile2d")
    acc = gs.init_sharded(plan, g.shape[0], metric)
    jacc = jgs.init_sharded(jplan, g.shape[0], metric)
    update, jupdate = (gs.make_update(plan, metric),
                       jgs.make_update(jplan, metric))
    for s in range(0, g.shape[1], block):
        acc = update(acc, torch.from_numpy(g[:, s:s + block].copy()))
        jacc = jupdate(jacc, g[:, s:s + block])
    return plan, acc, jplan, jacc


# ------------------------------------------------------------- the solver

@pytest.mark.parametrize("select", ["top", "abs"])
def test_randomized_eigh_select_matches_jax(rng, select):
    """``select="abs"`` keeps the largest-|lambda| pairs (the PCA
    ordering), ``top`` the largest values, in both packages; the same
    probes give the same pairs. The spectrum has a dominant negative
    pair, so the two orderings differ."""
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    lam = np.concatenate([[10.0, 8.0, -12.0, -9.0],
                          rng.uniform(-0.5, 0.5, 36)])
    b = ((q * lam) @ q.T).astype(np.float32)
    probes = _jax_probes(40, 2 + 32)
    vals, vecs = eigh.randomized_eigh(torch.from_numpy(b), 2, probes=probes,
                                      select=select)
    jvals, jvecs = jeigh.randomized_eigh(jnp.asarray(b), 2,
                                         jax.random.key(0), select=select)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals),
                               rtol=EIG_RTOL)
    _same_columns(vecs.numpy(), np.asarray(jvecs))
    want = [-12.0, 10.0] if select == "abs" else [10.0, 8.0]
    np.testing.assert_allclose(vals.numpy(), want, rtol=1e-4)
    with pytest.raises(ValueError, match="unknown select"):
        eigh.subspace_iterate(torch.from_numpy(b), probes, 2, 1, "bottom")


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_pcoa_solve_matches_jax(rng, shape):
    g = random_genotypes(rng, n=64, v=480, missing_rate=0.1)
    plan, acc, jplan, jacc = _accumulate(shape, "ibs", g, 96)
    res = ps.pcoa_coords_sharded(plan, acc, "ibs", k=4,
                                 probes=_jax_probes(64, 36))
    jres = jps.pcoa_coords_sharded(jplan, jacc, "ibs", k=4)
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.asarray(jres.eigenvalues), rtol=EIG_RTOL)
    np.testing.assert_allclose(res.proportion_explained.numpy(),
                               np.asarray(jres.proportion_explained),
                               rtol=EIG_RTOL)
    _same_columns(res.coords.numpy(), np.asarray(jres.coords))


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_pca_solve_matches_jax(rng, shape):
    g = random_genotypes(rng, n=64, v=600, missing_rate=0.1)
    plan, acc, jplan, jacc = _accumulate(shape, "shared-alt", g, 120)
    res = ps.pca_coords_sharded(plan, acc, "shared-alt", k=3, iters=12,
                                probes=_jax_probes(64, 35))
    jres = jps.pca_coords_sharded(jplan, jacc, "shared-alt", k=3, iters=12)
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.asarray(jres.eigenvalues), rtol=EIG_RTOL)
    _same_columns(res.coords.numpy(), np.asarray(jres.coords))


def test_sharded_solve_tracks_the_port_s_dense_route(rng):
    """JAX's own contract (tests/test_parallel.py) on the port: the tiled
    route against the dense randomized route with the same probes, and
    the randomized solve against the exact dense eigh, and the tiled
    PCA's eigenvalues against ``fit_pca``'s dense ones."""
    g = random_genotypes(rng, n=64, v=480, missing_rate=0.1)
    plan, acc, _, _ = _accumulate((2, 4), "ibs", g, 96)
    probes = eigh.init_probes(64, 36, torch.Generator().manual_seed(3))
    res = ps.pcoa_coords_sharded(plan, acc, "ibs", k=4, probes=probes)
    dense = gram.init(64, "ibs", "cpu")
    gram.update(dense, torch.from_numpy(g), "ibs")
    dist = distances.finalize(dense, "ibs")["distance"]
    ref = fit_pcoa(dist, k=4, method="randomized", probes=probes)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(res.coords.abs(), ref.coords.abs(),
                               rtol=1e-2, atol=1e-3)
    exact = fit_pcoa(dist, k=4, method="dense")
    np.testing.assert_allclose(res.eigenvalues, exact.eigenvalues,
                               rtol=1e-2, atol=1e-3)
    plan, acc, _, _ = _accumulate((4, 2), "shared-alt", g, 96)
    pres = ps.pca_coords_sharded(plan, acc, "shared-alt", k=3, iters=12)
    dense = gram.init(64, "shared-alt", "cpu")
    gram.update(dense, torch.from_numpy(g), "shared-alt")
    sim = distances.finalize(dense, "shared-alt")["similarity"]
    np.testing.assert_allclose(pres.eigenvalues,
                               fit_pca(sim, k=3).eigenvalues, rtol=5e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_centering_matches_dense(rng, shape):
    g = random_genotypes(rng, n=24, v=200, missing_rate=0.1)
    plan, acc, _, _ = _accumulate(shape, "shared-alt", g, 100)
    dense = gram.init(24, "shared-alt", "cpu")
    gram.update(dense, torch.from_numpy(g), "shared-alt")
    fin = distances.finalize(dense, "shared-alt")
    fin_tiles = ps.finalize_tiles(plan, acc, "shared-alt",
                                  ("distance", "similarity"))
    dist = fin_tiles["distance"]
    np.testing.assert_allclose(ps.gower_center_tiles(dist).full("cpu"),
                               gower_center(fin["distance"]), rtol=1e-5,
                               atol=1e-4)
    sim = fin_tiles["similarity"]
    c = fin["similarity"] - fin["similarity"].mean(1, keepdim=True) \
        - fin["similarity"].mean(0, keepdim=True) + fin["similarity"].mean()
    np.testing.assert_allclose(ps.center_sym_tiles(sim).full("cpu"),
                               0.5 * (c + c.T), rtol=1e-5, atol=1e-4)
    b = ps.gower_center_tiles(dist)
    q = torch.randn(24, 5, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(ps.tiled_matmul(b, q), b.full("cpu") @ q,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", kernels.gram_names())
def test_kernel_declares_what_a_tile_reads(metric):
    """A dry run of the finalize on (2, 2) zeros reads of the mirrored
    block exactly the leaves the kernel declares (``Kernel.transposed``),
    and forms the Gower distance exactly when it says so
    (``Kernel.gower``): the tiled route fetches only those."""
    acc = gram.init(2, metric, "cpu")
    read, gower = set(), []

    class Mirror(dict):
        def __getitem__(self, k):
            read.add(k)
            return acc[k]

    mirror = Mirror()

    class Reads(kernels.Frame):
        def t_product(self, name):
            return mirror[name]

        def t(self, stats, name):
            return gram.combine(mirror, metric, acc.__getitem__)[name]

        def gower(self, sim):
            gower.append(metric)
            return sim

    distances.finalize(acc, metric, Reads())
    kern = kernels.get(metric)
    assert read == set(kern.transposed)
    assert bool(gower) == kern.gower


def test_assert_tiled_rejects_a_whole_leaf():
    plan = gs.GramPlan(_mesh(), "tile2d")
    with pytest.raises(AssertionError, match="full-size leaf"):
        ps.assert_tiled(torch.zeros((16, 16)), plan, "test")
    bad = meshes.Tiled(plan.mesh, (16, 16), [torch.zeros((16, 16))] * 8)
    with pytest.raises(AssertionError, match="full-size leaf"):
        ps.assert_tiled(bad, plan, "test")
    ps.assert_tiled(meshes.Tiled.zeros(plan.mesh, (16, 16), torch.float32),
                    plan, "test")


# ---------------------------------------------------------------- the jobs

def _jobs(mode, shape=(2, 4), **compute):
    kw = dict(gram_mode=mode, mesh_shape=shape, num_pc=3)
    kw.update(compute)
    ing = dict(source="synthetic", n_samples=48, n_variants=1500,
               block_variants=512, seed=9)
    return (tconfig.JobConfig(ingest=tconfig.IngestConfig(**ing),
                              compute=tconfig.ComputeConfig(device="cpu",
                                                            **kw)),
            jconfig.JobConfig(ingest=jconfig.IngestConfig(**ing),
                              compute=jconfig.ComputeConfig(**kw)))


@pytest.mark.parametrize("shape", SHAPES)
def test_pcoa_job_tile2d_matches_jax(jax_probes, shape):
    tjob, jjob = _jobs("tile2d", shape, metric="ibs", eigh_mode="randomized")
    with virtual.virtual_slots(8):
        ours = jobs.pcoa_job(tjob)
    theirs = jjobs.pcoa_job(jjob)
    np.testing.assert_allclose(ours.eigenvalues, theirs.eigenvalues,
                               rtol=EIG_RTOL)
    _same_columns(ours.coords, theirs.coords)
    assert "eigh" in ours.timer.phases and "gram" in ours.timer.phases


@pytest.mark.parametrize("shape", SHAPES)
def test_pca_job_tile2d_matches_jax(jax_probes, shape):
    tjob, jjob = _jobs("tile2d", shape)
    with virtual.virtual_slots(8):
        ours = jobs.variants_pca_job(tjob)
    theirs = jjobs.variants_pca_job(jjob)
    np.testing.assert_allclose(ours.eigenvalues, theirs.eigenvalues,
                               rtol=EIG_RTOL)
    _same_columns(ours.coords, theirs.coords)


def test_pcoa_job_tile2d_matches_the_variant_route():
    """JAX's test_pcoa_job_tile2d_route_matches_variant_route, on the
    port: the tiled randomized solve against the variant plan's dense
    randomized route."""
    with virtual.virtual_slots(8):
        tiled = jobs.pcoa_job(_jobs("tile2d", metric="ibs",
                                    eigh_mode="randomized")[0])
        dense = jobs.pcoa_job(_jobs("variant", metric="ibs",
                                    eigh_mode="randomized")[0])
    np.testing.assert_allclose(tiled.eigenvalues, dense.eigenvalues,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.abs(tiled.coords), np.abs(dense.coords),
                               rtol=1e-2, atol=1e-3)


def test_tile2d_dense_eigh_takes_the_gathered_route():
    """Dense eigh needs the materialized matrix: under tile2d the job
    takes the similarity route (tiles gathered), as the JAX package's
    falls back to its host route, and equals the variant plan's dense
    route."""
    with virtual.virtual_slots(8):
        tiled = jobs.pcoa_job(_jobs("tile2d", metric="ibs",
                                    eigh_mode="dense")[0])
        dense = jobs.pcoa_job(_jobs("variant", metric="ibs",
                                    eigh_mode="dense")[0])
    np.testing.assert_array_equal(tiled.eigenvalues, dense.eigenvalues)
    np.testing.assert_array_equal(tiled.coords, dense.coords)


@pytest.mark.parametrize("kind", ["pcoa", "pca"])
def test_save_model_on_tile2d_raises_before_streaming(tmp_path, kind):
    class Unread(ArraySource):
        def blocks(self, *a, **kw):
            raise AssertionError("streamed before the refusal")

        packed_blocks = blocks

    tjob, _ = _jobs("tile2d", metric="ibs" if kind == "pcoa" else None)
    tjob = tjob.replace(model_path=str(tmp_path / "m.npz"))
    src = Unread(random_genotypes(np.random.default_rng(0), 48, 64))
    run = jobs.pcoa_job if kind == "pcoa" else jobs.variants_pca_job
    with virtual.virtual_slots(8), pytest.raises(
            ValueError, match="gram_mode=variant"):
        run(tjob, source=src)


def test_streaming_pcoa_runs_on_tiles():
    """``--stream-refresh-blocks`` under tile2d refreshes on the tiles
    and ends within JAX's streaming tolerances of the variant plan's
    run."""
    from spark_examples_tpu_torch.pipelines.streaming import (
        incremental_pcoa_job,
    )

    outs = {}
    for mode in ("tile2d", "variant"):
        job = _jobs(mode, metric="ibs", stream_refresh_blocks=1)[0]
        with virtual.virtual_slots(8):
            outs[mode], snaps = incremental_pcoa_job(job)
        assert [s.n_variants for s in snaps] == [512, 1024, 1500]
    np.testing.assert_allclose(outs["tile2d"].eigenvalues,
                               outs["variant"].eigenvalues, rtol=1e-3,
                               atol=1e-4)


# ------------------------------------------------------ the cross plan

def test_cross_plan_choice_matches_jax():
    mesh, jmesh = _mesh(), jmeshes.make_mesh(shape=(2, 4))
    for a, n_ref, n_stats, mode in ((10, 40, 2, "auto"), (10, 40, 2,
                                                          "tile2d"),
                                    (60_000, 60_000, 2, "auto"),
                                    (8, 40, 2, "variant")):
        assert (project.cross_plan_for(mesh, a, n_ref, n_stats, mode).mode
                == jproject.cross_plan_for(jmesh, a, n_ref, n_stats,
                                           mode).mode)
    for args in ((9, 40, 2, "tile2d"), (10, 38, 2, "tile2d")):
        with pytest.raises(ValueError) as ours:
            project.cross_plan_for(mesh, *args)
        with pytest.raises(ValueError) as theirs:
            jproject.cross_plan_for(jmesh, *args)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("model", ["pcoa", "pca"])
def test_project_under_tile2d_cross_plan(rng, tmp_path, model):
    """The tile2d cross pass projects bitwise the replicated one, and
    within 1e-5 of max|coords| of JAX's projection under its tile2d
    cross plan; cross-kinship too, bitwise."""
    g = random_genotypes(rng, n=58, v=900, missing_rate=0.05)
    ref, new = g[:48], g[48:]
    path = str(tmp_path / "m.npz")
    fit = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=256),
        compute=tconfig.ComputeConfig(device="cpu", num_pc=3,
                                      metric="ibs" if model == "pcoa"
                                      else None),
        model_path=path)
    (jobs.pcoa_job if model == "pcoa" else jobs.variants_pca_job)(
        fit, source=ArraySource(ref))
    outs = {}
    for mode in ("replicated", "tile2d"):
        job = fit.replace(model_path=None, compute=tconfig.ComputeConfig(
            device="cpu", gram_mode=mode))
        with virtual.virtual_slots(8):
            outs[mode] = project.pcoa_project_job(
                job, path, ArraySource(new), ArraySource(ref))
            if model == "pcoa":
                outs[mode + "-king"] = project.cross_kinship_job(
                    job, ArraySource(new), ArraySource(ref))
    np.testing.assert_array_equal(outs["tile2d"].coords,
                                  outs["replicated"].coords)
    if model == "pcoa":
        np.testing.assert_array_equal(outs["tile2d-king"].similarity,
                                      outs["replicated-king"].similarity)
    jjob = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(block_variants=256),
        compute=jconfig.ComputeConfig(gram_mode="tile2d"))
    theirs = jproject.pcoa_project_job(jjob, path, JArraySource(new),
                                       JArraySource(ref))
    scale = np.abs(theirs.coords).max()
    np.testing.assert_allclose(outs["tile2d"].coords, theirs.coords,
                               atol=1e-5 * scale, rtol=0)
