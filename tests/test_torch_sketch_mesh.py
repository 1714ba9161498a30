"""The sketch ladder over the mesh: the port's ``solvers/`` under a plan
of several slots against the JAX package's under a plan of the same
shape, on the CPU.

The port's slots are ``core/virtual.py`` slots of the CPU; JAX's are the
first four of its eight virtual CPU devices (``tests/conftest.py``),
shaped by the same ``--mesh-shape``. JAX's ``sketch_plan`` builds its
mesh over every device, and a (2, 2) mesh of eight devices is refused
there, so the JAX side's plan is built over four devices by patching
``sketch_plan`` for the test's duration (the JAX package is unchanged).

Tolerances (those of ``tests/test_torch_solvers.py``): the state is f32
and the port sums the slots' partials in slot order where XLA psums, so
nothing is bitwise across the packages or against one slot. Eigenvalues
agree within 1e-5 relative and coordinates within 5e-4 of the column's
largest entry, per column up to sign; the solve stages' orthonormal
bases within 1e-4. Within the port a kill and resume on the mesh is
bitwise.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import meshes as jmeshes
from spark_examples_tpu.parallel.gram_sharded import GramPlan as JPlan
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.solvers import driver as jdriver
from spark_examples_tpu.solvers import sketch as jsketch
from spark_examples_tpu.solvers import solve as jsolve
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import meshes, virtual
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.parallel import gram_sharded
from spark_examples_tpu_torch.parallel.gram_sharded import GramPlan
from spark_examples_tpu_torch.pipelines import jobs
from spark_examples_tpu_torch.solvers import driver, sketch, solve

N, V, BV = 96, 4096, 512
K = 6
RANK = 24
EIG_RTOL = 1e-5
COORD_TOL = 5e-4
BASIS_TOL = 1e-4
SHAPES = [(2, 2), (1, 4)]

# Every rung a metric runs: a factor metric (grm; shared-alt through the
# pca job) and a dual one (ibs; jaccard, whose numerator is not PSD, runs
# the corrected rung only).
CASES = [("grm", "sketch"), ("grm", "corrected"), (None, "sketch"),
         (None, "corrected"), ("ibs", "sketch"), ("ibs", "corrected"),
         ("jaccard", "corrected")]


def _relerr(got, want):
    return np.abs(np.asarray(got) - want) / np.maximum(np.abs(want), 1e-12)


def _same_columns(got, want, tol=COORD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    for c in range(want.shape[1]):
        w = want[:, c]
        s = 1.0 if got[:, c] @ w >= 0 else -1.0
        err = np.abs(s * got[:, c] - w).max() / np.abs(w).max()
        assert err < tol, (c, err)


def _tjob(metric, solver, shape, **kw):
    return tconfig.JobConfig(
        ingest=tconfig.IngestConfig(source="synthetic", n_samples=N,
                                    n_variants=V, block_variants=BV, seed=3),
        compute=tconfig.ComputeConfig(
            metric=metric, num_pc=K, solver=solver, sketch_rank=RANK,
            sketch_iters=2, device="cpu", mesh_shape=shape, **kw),
    )


def _jjob(metric, solver, shape):
    return jconfig.JobConfig(
        ingest=jconfig.IngestConfig(source="synthetic", n_samples=N,
                                    n_variants=V, block_variants=BV, seed=3),
        compute=jconfig.ComputeConfig(
            metric=metric, num_pc=K, solver=solver, sketch_rank=RANK,
            sketch_iters=2, mesh_shape=shape),
    )


def _jplan(shape):
    return JPlan(jmeshes.make_mesh(jax.devices()[:4], shape), "variant")


def _tplan(shape):
    return GramPlan(meshes.make_mesh(virtual.virtual_devices(4, "cpu"),
                                     shape), "variant")


@pytest.fixture
def jax_probes(monkeypatch):
    """The port's probes replaced by JAX's for one test."""
    monkeypatch.setattr(sketch, "probes", lambda n, r, seed: torch.from_numpy(
        np.array(jsketch.probes(n, r, seed))))


@pytest.fixture
def jax_on_four(monkeypatch):
    """JAX's sketch plan over its first four devices, shaped as asked."""
    monkeypatch.setattr(jdriver, "sketch_plan",
                        lambda job: _jplan(job.compute.mesh_shape))


def _run(job_fn, job):
    with virtual.virtual_slots(4):
        return job_fn(job)


def _job_fns(metric):
    if metric is None:
        return jobs.variants_pca_job, jjobs.variants_pca_job
    return jobs.pcoa_job, jjobs.pcoa_job


# ------------------------------------------------ whole jobs against JAX

@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("metric,solver", CASES)
def test_mesh_job_matches_jax_on_the_same_mesh(jax_probes, jax_on_four,
                                               metric, solver, shape):
    port_fn, jax_fn = _job_fns(metric)
    got = _run(port_fn, _tjob(metric, solver, shape))
    want = jax_fn(_jjob(metric, solver, shape))
    assert _relerr(got.eigenvalues, np.asarray(want.eigenvalues)).max() \
        < EIG_RTOL
    _same_columns(got.coords, np.asarray(want.coords))
    assert got.n_variants == want.n_variants == V


@pytest.mark.parametrize("metric", ["grm", "ibs"])
def test_mesh_job_is_the_one_slot_job_within_rounding(metric):
    one = jobs.pcoa_job(_tjob(metric, "corrected", None))
    mesh = _run(jobs.pcoa_job, _tjob(metric, "corrected", (2, 2)))
    assert _relerr(mesh.eigenvalues, one.eigenvalues).max() < EIG_RTOL
    _same_columns(mesh.coords, one.coords)


# ---------------------------------------------------- the plan is seen

def test_sketch_plan_is_the_job_s_mesh():
    with virtual.virtual_slots(4):
        plan = driver.sketch_plan(_tjob("grm", "corrected", (2, 2)))
    assert (plan.mode, plan.mesh.shape, plan.mesh.size) == \
        ("variant", (2, 2), 4)
    assert driver.sketch_plan(_tjob("grm", "corrected", None)).mode == \
        "replicated"
    with virtual.virtual_slots(4):
        plan = driver.sketch_plan(_tjob("grm", "corrected", (1, 4)))
    assert plan.mesh.shape == (1, 4) and plan.block_shards == 4


@pytest.mark.parametrize("metric", ["grm", "ibs"])
def test_a_mesh_shape_sketch_job_runs_on_its_slots(tmp_path, monkeypatch,
                                                   metric):
    """The CLI job of ROADMAP Queue 3's fault: every block is split over
    the four slots and every solve is split by rows over them."""
    shards, rows = [], []
    real_shards, real_rows = gram_sharded._shards, meshes.rows_flat

    def spy_shards(plan, block):
        out = real_shards(plan, block)
        shards.append(len(out))
        return out

    def spy_rows(mesh, n):
        rows.append((mesh.size, n))
        return real_rows(mesh, n)

    monkeypatch.setattr(gram_sharded, "_shards", spy_shards)
    monkeypatch.setattr(meshes, "rows_flat", spy_rows)
    out = str(tmp_path / "c.tsv")
    assert tmain(["pcoa", "--device", "cpu", "--virtual-devices", "4",
                  "--mesh-shape", "2x2", "--solver", "corrected",
                  "--sketch-rank", "16", "--sketch-iters", "2", "--metric",
                  metric, "--n-samples", "64", "--n-variants", "4096",
                  "--block-variants", "512", "--num-pc", "4",
                  "--output-path", out]) == 0
    # Three passes of eight blocks, each split four ways.
    assert shards == [4] * 24
    assert rows and all(r == (4, 64) for r in rows)


# ------------------------------------------------- block updates and pads

def _block(seed, n=N, v=300):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(n, v), dtype=np.int8)
    g[rng.random((n, v)) < 0.1] = -1
    return g


def _close(got: dict, want: dict):
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("metric", ["grm", "shared-alt"])
def test_factor_update_on_slots_sums_the_one_slot_update(metric, packed):
    """A 300-variant block over four slots: 75 variants a slot (unpacked)
    or 19 bytes a slot with a pad byte (packed): the pad adds nothing."""
    from spark_examples_tpu_torch.ingest.bitpack import pack_dosages

    g = _block(4)
    block = torch.from_numpy(pack_dosages(g) if packed else g)
    one = sketch.make_update(metric, packed=packed)
    split = sketch.make_update(metric, packed=packed, plan=_tplan((2, 2)))
    fresh = sketch.init_state(N, RANK, 5, "cpu")
    want = one({k: v.clone() for k, v in fresh.items()}, block)
    got = split({k: v.clone() for k, v in fresh.items()}, block)
    _close(got, want)
    assert float(got["nvar"]) == float(want["nvar"])


@pytest.mark.parametrize("with_den", [True, False])
@pytest.mark.parametrize("metric", ["ibs", "jaccard"])
def test_dual_update_on_slots_sums_the_one_slot_update(metric, with_den):
    from spark_examples_tpu_torch.ingest.bitpack import pack_dosages

    block = torch.from_numpy(pack_dosages(_block(5)))
    fresh = sketch.init_dual_state(N, RANK, 6, "cpu")
    fresh["scale"] = 1.0 + torch.rand(N, generator=torch.Generator()
                                      .manual_seed(1))
    one = sketch.make_dual_update(metric, packed=True, with_den=with_den)
    split = sketch.make_dual_update(metric, packed=True, with_den=with_den,
                                    plan=_tplan((1, 4)))
    want = one({k: v.clone() for k, v in fresh.items()}, block)
    got = split({k: v.clone() for k, v in fresh.items()}, block)
    _close(got, want)


def test_plan_state_lives_on_the_home_slot():
    plan = _tplan((2, 2))
    for state in (sketch.init_state(N, RANK, 0, plan=plan),
                  sketch.init_dual_state(N, RANK, 0, plan=plan)):
        assert {v.device for v in state.values()} == {plan.mesh.home}


# ----------------------------------------------------------- the solve

def _pass_y(seed=0):
    state = sketch.init_state(N, RANK, seed, "cpu")
    upd = sketch.make_update("grm")
    for block, _ in SyntheticSource(n_samples=N, n_variants=V,
                                    seed=3).blocks(BV):
        state = upd(state, torch.from_numpy(block))
    yb, _ = sketch.finalize_pass(state["y"], state["trace"], state["nvar"],
                                 is_grm=True)
    return yb, state["qc"]


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_solve_stages_on_a_plan_match_jax_on_a_plan(shape):
    yb, qc = _pass_y()
    tp, jp = _tplan(shape), _jplan(shape)
    y, qcn = yb.numpy(), qc.numpy()
    q = solve.orthonormalize(yb, tp)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(RANK), atol=1e-5)
    _same_columns(q.numpy(), np.asarray(jsolve.orthonormalize(
        jnp.asarray(y), jp)), tol=BASIS_TOL)
    for got, want in (
        (solve.nystrom_eigs(yb, qc, K, tp),
         jsolve.nystrom_eigs(jnp.asarray(y), jnp.asarray(qcn), K, jp)),
        (solve.nystrom_eigs_scaled(yb, qc, 2.0 * yb, K, tp),
         jsolve.nystrom_eigs_scaled(jnp.asarray(y), jnp.asarray(qcn),
                                    2.0 * jnp.asarray(y), K, jp)),
        (solve.rayleigh_eigs(yb, q, K, tp),
         jsolve.rayleigh_eigs(jnp.asarray(y), jnp.asarray(q.numpy()), K,
                              jp)),
    ):
        assert _relerr(got[0].numpy(), np.asarray(want[0])).max() < EIG_RTOL
        _same_columns(got[1].numpy(), np.asarray(want[1]))


def test_solve_on_uneven_rows_matches_one_slot():
    """90 rows over four slots: 23, 23, 23 and 21."""
    yb, qc = _pass_y()
    yb, qc = yb[:90].contiguous(), qc[:90].contiguous()
    plan = _tplan((2, 2))
    assert [sl.stop - sl.start for sl in meshes.rows_flat(plan.mesh, 90)] \
        == [23, 23, 23, 21]
    _same_columns(solve.orthonormalize(yb, plan).numpy(),
                  solve.orthonormalize(yb).numpy(), tol=BASIS_TOL)
    got, want = solve.nystrom_eigs(yb, qc, K, plan), solve.nystrom_eigs(
        yb, qc, K)
    assert _relerr(got[0].numpy(), want[0].numpy()).max() < EIG_RTOL
    _same_columns(got[1].numpy(), want[1].numpy())


def test_rows_flat_covers_every_row_once():
    for n_slots, shape in ((4, (2, 2)), (8, (2, 4)), (3, (1, 3))):
        mesh = meshes.make_mesh(virtual.virtual_devices(n_slots, "cpu"),
                                shape)
        for n in (0, 1, 7, 64, 90, 101):
            spans = meshes.rows_flat(mesh, n)
            assert len(spans) == n_slots
            got = [i for sl in spans for i in range(n)[sl]]
            assert got == list(range(n))


def test_stage_runtimes_measures_all_stages():
    """Twin of tests/test_solvers.py::test_stage_runtimes_measures_all_
    stages: every stage is measured and positive, on a plan and on
    None."""
    plan = GramPlan(meshes.make_mesh(virtual.virtual_devices(8, "cpu")),
                    "tile2d")
    for p in (None, plan):
        times = solve.stage_runtimes(256, 16, p, k=4, repeats=1,
                                     device="cpu")
        assert set(times) == {"cholqr2_s", "nystrom_s", "rayleigh_s"}
        assert all(v > 0 for v in times.values()), times


# ------------------------------------------------------- kill and resume

def _dying(n_blocks):
    class Dying(SyntheticSource):
        served = 0

        def blocks(self, block_variants, start=0):
            for item in super().blocks(block_variants, start):
                if Dying.served >= n_blocks:
                    raise RuntimeError("simulated preemption")
                Dying.served += 1
                yield item

    return Dying(n_samples=N, n_variants=V, seed=3)


@pytest.mark.parametrize("metric", ["grm", "ibs"])
def test_kill_and_resume_on_the_mesh_is_bitwise(tmp_path, metric):
    """8 blocks a pass on 2 x 2 slots; the source dies after 12, 4 blocks
    into pass 1, with a checkpoint every 2 blocks: the rerun resumes
    pass 1 at variant 2048 and ends on the uninterrupted run's
    coordinates, bit for bit."""
    d = str(tmp_path / "ck")
    clean = _run(jobs.pcoa_job, _tjob(metric, "corrected", (2, 2)))
    job = _tjob(metric, "corrected", (2, 2), checkpoint_dir=d,
                checkpoint_every_blocks=2)
    with virtual.virtual_slots(4):
        with pytest.raises(RuntimeError, match="preemption"):
            jobs.pcoa_job(job, source=_dying(12))
    leaves = (sketch.DUAL_STATE_LEAVES if metric == "ibs"
              else sketch.STATE_LEAVES)
    acc, cursor, _ = ckpt.load(d, f"solver:{metric}", clean.sample_ids,
                               leaves=list(leaves) + ["passno"])
    assert (int(acc["passno"]), cursor) == (1, 4 * BV)
    resumed = _run(jobs.pcoa_job, job)
    np.testing.assert_array_equal(resumed.coords, clean.coords)
    np.testing.assert_array_equal(resumed.eigenvalues, clean.eigenvalues)
