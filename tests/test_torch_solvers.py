"""The port's sketch solver (spark_examples_tpu_torch/solvers) against
the JAX package's, on the CPU.

Tolerances: the sketch state is f32 and each product sums its terms in
another order in XLA and in PyTorch, so nothing here is bitwise across
the packages. Block updates agree within 1e-5 of the largest entry;
the solve stages and whole jobs (on the same probes) within 1e-5
relative on the eigenvalues and 5e-4 of the column's largest entry on
the coordinates, per column up to sign (measured: about 1e-6 and 5e-5
at these shapes). Within the port a kill and resume is bitwise.

The port draws its probes from ``torch.Generator("cpu")``, not from
``jax.random``, so the tests that compare with JAX inject JAX's probes
by patching the port's ``probes`` for the test's duration.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.ingest import SyntheticSource as JSynthetic
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.solvers import sketch as jsketch
from spark_examples_tpu.solvers import solve as jsolve
from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.ingest.bitpack import pack_dosages
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ops import distances, gram
from spark_examples_tpu_torch.pipelines import jobs, runner
from spark_examples_tpu_torch.solvers import sketch, solve

N, V, BV = 96, 4096, 512
K = 6
RANK = 40
EIG_RTOL = 1e-5
COORD_TOL = 5e-4

FACTOR = ("shared-alt", "euclidean", "dot", "grm")
DUAL = ("ibs", "jaccard")


def _relerr(got, want):
    return np.abs(np.asarray(got) - want) / np.maximum(np.abs(want), 1e-12)


def _same_columns(got, want, tol=COORD_TOL):
    """Every column within ``tol`` of the column's largest entry, up to
    sign."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    for c in range(want.shape[1]):
        w = want[:, c]
        s = 1.0 if got[:, c] @ w >= 0 else -1.0
        err = np.abs(s * got[:, c] - w).max() / np.abs(w).max()
        assert err < tol, (c, err)


def _tjob(metric, solver, **kw):
    kw.setdefault("sketch_rank", RANK)
    return tconfig.JobConfig(
        ingest=tconfig.IngestConfig(source="synthetic", n_samples=N,
                                    n_variants=V, block_variants=BV, seed=3),
        compute=tconfig.ComputeConfig(metric=metric, num_pc=K, solver=solver,
                                      device="cpu", **kw),
    )


def _jjob(metric, solver, **kw):
    kw.setdefault("sketch_rank", RANK)
    return jconfig.JobConfig(
        ingest=jconfig.IngestConfig(source="synthetic", n_samples=N,
                                    n_variants=V, block_variants=BV, seed=3),
        compute=jconfig.ComputeConfig(metric=metric, num_pc=K,
                                      solver=solver, **kw),
    )


@pytest.fixture
def jax_probes(monkeypatch):
    """The port's probes replaced by JAX's for one test."""
    monkeypatch.setattr(sketch, "probes", lambda n, r, seed: torch.from_numpy(
        np.array(jsketch.probes(n, r, seed))))


def _block(seed=4, n=N, v=300):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(n, v), dtype=np.int8)
    g[rng.random((n, v)) < 0.1] = -1
    return g


# ------------------------------------------------------ block by block

@pytest.mark.parametrize("metric", FACTOR)
def test_factor_update_matches_jax(metric):
    rng = np.random.default_rng(1)
    start = {"y": rng.standard_normal((N, 8)).astype(np.float32),
             "qc": rng.standard_normal((N, 8)).astype(np.float32),
             "trace": np.float32(2.5), "nvar": np.float32(3.0),
             "cm": rng.standard_normal(N).astype(np.float32)}
    g = _block()
    want = {k: np.asarray(v) for k, v in jsketch._update_impl(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(g),
        metric, packed=False, grm_precise=True).items()}
    got = sketch.update({k: torch.from_numpy(np.array(v))
                         for k, v in start.items()},
                        torch.from_numpy(g), metric, precise=True)
    a, _ = kernels.get(metric).sketch.features(torch.from_numpy(g), True)
    a = np.abs(a.numpy().astype(np.float64))
    # grm's z differs from JAX's by up to 2 ulp (torch.rsqrt against
    # XLA's; ROADMAP Queue 3), and its column sums over samples cancel:
    # its leaves are held against the same sums taken over |terms|.
    scale = {"y": a @ (a.T @ np.abs(start["qc"])), "cm": a @ a.sum(0),
             "trace": (a * a).sum(), "nvar": 0.0}
    for k in sketch.STATE_LEAVES:
        w = want[k]
        atol = 1e-5 * max(np.abs(w).max(), 1.0)
        if metric == "grm" and k in scale:
            atol = np.maximum(atol, 1e-6 * scale[k])
        assert (np.abs(got[k].numpy() - w) <= atol).all(), k


@pytest.mark.parametrize("with_den", [True, False])
@pytest.mark.parametrize("metric", DUAL)
def test_dual_update_matches_jax(metric, with_den):
    rng = np.random.default_rng(2)
    start = {k: rng.standard_normal((N, 8)).astype(np.float32)
             for k in ("y", "yd", "q", "qc")}
    start.update({k: rng.standard_normal(N).astype(np.float32)
                  for k in ("d", "cm")})
    start["scale"] = (1.0 + rng.random(N)).astype(np.float32)
    g = _block(5)
    packed = torch.from_numpy(pack_dosages(g))
    want = {k: np.asarray(v) for k, v in jsketch._dual_update_impl(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(g),
        metric, packed=False, with_den=with_den).items()}
    got = sketch.dual_update({k: torch.from_numpy(np.array(v))
                              for k, v in start.items()},
                             packed, metric, packed=True, with_den=with_den)
    for k in sketch.DUAL_STATE_LEAVES:
        w = want[k]
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def _pass_state(metric="grm"):
    """The port's factor state after one pass over the test cohort."""
    state = sketch.init_state(N, RANK, 0, "cpu")
    upd = sketch.make_update(metric)
    for block, _ in SyntheticSource(n_samples=N, n_variants=V,
                                    seed=3).blocks(BV):
        state = upd(state, torch.from_numpy(block))
    return state


def test_solve_stages_match_jax():
    state = _pass_state()
    yb, tr = sketch.finalize_pass(state["y"], state["trace"], state["nvar"],
                                  is_grm=True)
    jyb, jtr = jsketch.finalize_pass(jnp.asarray(state["y"].numpy()),
                                     jnp.asarray(state["trace"].numpy()),
                                     jnp.asarray(state["nvar"].numpy()),
                                     is_grm=True)
    np.testing.assert_allclose(yb.numpy(), np.asarray(jyb), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jyb).max()))
    assert abs(float(tr) - float(jtr)) <= 1e-6 * abs(float(jtr))
    y, qc = yb.numpy(), state["qc"].numpy()
    q = solve.orthonormalize(torch.from_numpy(y))
    np.testing.assert_allclose(q.T @ q, np.eye(RANK), atol=1e-5)
    _same_columns(q.numpy(), np.asarray(jsolve.orthonormalize(jnp.asarray(y))),
                  tol=1e-4)
    for got, want in (
        (solve.nystrom_eigs(torch.from_numpy(y), torch.from_numpy(qc), K),
         jsolve.nystrom_eigs(jnp.asarray(y), jnp.asarray(qc), K)),
        (solve.nystrom_eigs_scaled(torch.from_numpy(y), torch.from_numpy(qc),
                                   2.0 * torch.from_numpy(y), K),
         jsolve.nystrom_eigs_scaled(jnp.asarray(y), jnp.asarray(qc),
                                    2.0 * jnp.asarray(y), K)),
        (solve.rayleigh_eigs(torch.from_numpy(y), q, K),
         jsolve.rayleigh_eigs(jnp.asarray(y), jnp.asarray(q.numpy()), K)),
    ):
        assert _relerr(got[0].numpy(), np.asarray(want[0])).max() < EIG_RTOL
        _same_columns(got[1].numpy(), np.asarray(want[1]))


def test_centering_stats_match_jax():
    state = _pass_state("shared-alt")
    host = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    got, want = sketch.factor_centering(state), jsketch.factor_centering(host)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    rng = np.random.default_rng(3)
    dual = {"cm": torch.from_numpy(rng.random(N).astype(np.float32)),
            "scale": torch.from_numpy(1 + rng.random(N).astype(np.float32)),
            "d": torch.from_numpy(rng.random(N).astype(np.float32))}
    got = sketch.dual_centering(dual)
    want = jsketch.dual_centering({k: jnp.asarray(v.numpy())
                                   for k, v in dual.items()})
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_byte_and_flop_helpers_match_jax():
    for metric in FACTOR + DUAL:
        assert sketch.nxn_bytes(N, metric) == jsketch.nxn_bytes(N, metric)
    assert sketch.state_bytes(N, RANK) == jsketch.state_bytes(N, RANK)
    assert sketch.dual_state_bytes(N, 200) == jsketch.dual_state_bytes(N, 200)
    assert sketch.flops_per_block(N, BV, RANK) == \
        jsketch.flops_per_block(N, BV, RANK)
    for metric in DUAL:
        for wd in (True, False):
            assert sketch.dual_flops_per_block(N, BV, RANK, metric, wd) == \
                jsketch.dual_flops_per_block(N, BV, RANK, metric, wd)


# ------------------------------------------------ whole jobs against JAX

@pytest.mark.parametrize("metric", ["ibs", "grm", None])
@pytest.mark.parametrize("solver,iters", [("sketch", 2), ("corrected", 2)])
def test_job_matches_jax_on_the_same_probes(jax_probes, metric, solver,
                                            iters):
    """pcoa ibs (dual), pcoa grm (factor) and the pca job (``None``)."""
    if metric is None:
        got = jobs.variants_pca_job(_tjob(None, solver, sketch_iters=iters))
        want = jjobs.variants_pca_job(_jjob(None, solver,
                                            sketch_iters=iters))
    else:
        got = jobs.pcoa_job(_tjob(metric, solver, sketch_iters=iters))
        want = jjobs.pcoa_job(_jjob(metric, solver, sketch_iters=iters))
    assert _relerr(got.eigenvalues, np.asarray(want.eigenvalues)).max() \
        < EIG_RTOL
    _same_columns(got.coords, np.asarray(want.coords))
    if want.proportion is None:
        assert got.proportion is None
    else:
        np.testing.assert_allclose(got.proportion, want.proportion,
                                   rtol=EIG_RTOL)
    assert got.n_variants == want.n_variants == V


# --------------------------------------------- the port's own probes

@pytest.fixture(scope="module")
def grm_ladder():
    """Exact and every sketch rung on one cohort, computed once."""
    return {
        "exact": jobs.pcoa_job(_tjob("grm", "exact")),
        "sketch": jobs.pcoa_job(_tjob("grm", "sketch")),
        "corrected1": jobs.pcoa_job(_tjob("grm", "corrected",
                                          sketch_iters=1)),
        "corrected3": jobs.pcoa_job(_tjob("grm", "corrected",
                                          sketch_iters=3)),
    }


def test_sketch_accuracy_vs_exact_dense(grm_ladder):
    """The JAX package's accuracy contract (tests/test_solvers.py): the
    corrected rung's structure eigenvalues within 1e-2 of the exact
    route, the whole top-k within 0.15, the single pass within 0.5."""
    ev = np.asarray(grm_ladder["exact"].eigenvalues)
    assert ev[0] > 2.0 * ev[K - 1]
    rel_c = _relerr(grm_ladder["corrected3"].eigenvalues, ev)
    assert rel_c[:4].max() < 1e-2, rel_c
    assert rel_c.max() < 0.15, rel_c
    rel_s = _relerr(grm_ladder["sketch"].eigenvalues, ev)
    assert rel_s.max() < 0.5, rel_s
    sk = grm_ladder["sketch"]
    assert (np.diff(sk.eigenvalues) <= 1e-6).all()
    assert (sk.eigenvalues >= 0).all()
    assert sk.coords.shape == (N, K)


def test_ladder_monotonicity(grm_ladder):
    ev = np.asarray(grm_ladder["exact"].eigenvalues)
    r_sketch = _relerr(grm_ladder["sketch"].eigenvalues, ev).max()
    r_c1 = _relerr(grm_ladder["corrected1"].eigenvalues, ev).max()
    r_c3 = _relerr(grm_ladder["corrected3"].eigenvalues, ev).max()
    assert r_c1 < r_sketch, (r_c1, r_sketch)
    assert r_c3 <= r_c1 * 1.05 + 1e-6, (r_c3, r_c1)


def test_proportion_explained_tracks_exact(grm_ladder):
    want = grm_ladder["exact"].proportion
    got = grm_ladder["corrected3"].proportion
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:4], want[:4], rtol=0.05)


def test_pca_sketch_matches_exact_structure():
    exact = jobs.variants_pca_job(_tjob(None, "exact"))
    got = jobs.variants_pca_job(_tjob(None, "corrected", sketch_iters=3))
    rel = _relerr(got.eigenvalues, exact.eigenvalues)
    assert rel[:4].max() < 1e-2, rel
    np.testing.assert_allclose(np.linalg.norm(got.coords, axis=0),
                               np.abs(got.eigenvalues), rtol=1e-4)


def test_seeded_determinism_and_probes():
    a = jobs.pcoa_job(_tjob("shared-alt", "sketch", sketch_seed=7))
    b = jobs.pcoa_job(_tjob("shared-alt", "sketch", sketch_seed=7))
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.eigenvalues, b.eigenvalues)
    c = jobs.pcoa_job(_tjob("shared-alt", "sketch", sketch_seed=8))
    assert not np.array_equal(a.coords, c.coords)
    p = sketch.probes(N, 500, 7)
    assert p.shape == (N, N) and p.dtype == torch.float32
    assert torch.equal(p, sketch.probes(N, 500, 7))


def test_no_nxn_on_the_sketch_path(monkeypatch):
    """Every N x N allocation site of the exact route is rigged to fail;
    the sketch job completes, and the gauges record what it avoided."""
    def boom(*a, **k):
        raise AssertionError("N x N allocated on the sketch path")

    monkeypatch.setattr(gram, "init", boom)
    monkeypatch.setattr(runner, "run_gram", boom)
    monkeypatch.setattr(distances, "finalize", boom)
    telemetry.reset()
    out = jobs.pcoa_job(_tjob("dot", "sketch"))
    assert out.coords.shape == (N, K)
    snap = telemetry.metrics_snapshot()
    gauges = snap["gauges"]
    assert gauges["solver.state_bytes"]["last"] == (2 * N * RANK + N) * 4
    assert gauges["solver.nxn_bytes_avoided"]["last"] == 4 * N * N
    assert gauges["solver.rung"]["last"] == 0.0
    assert snap["counters"]["solver.passes"] == 1.0


@pytest.mark.parametrize("metric", ["ibs2", "king", "pc-invariant",
                                    "braycurtis"])
def test_unsketchable_metrics_are_refused_with_jax_message(metric):
    from spark_examples_tpu import kernels as jkernels

    for solver in ("sketch", "corrected"):
        with pytest.raises(ValueError) as e:
            tconfig.ComputeConfig(metric=metric, solver=solver)
        assert str(e.value) == ("bad compute config: "
                                + jkernels.unsketchable_metric_error(
                                    metric, solver))
        with pytest.raises(ValueError, match="--solver exact"):
            kernels.check_sketchable(metric, solver)
    assert set(kernels.factor_sketch_names()) == set(FACTOR)
    assert set(kernels.dual_sketch_names()) == set(DUAL)


@pytest.mark.parametrize("kw,match", [
    (dict(solver="sketch", sketch_rank=4), "--sketch-rank=4 < --num-pc"),
    (dict(solver="corrected", sketch_iters=0), "--sketch-iters=0"),
    (dict(sketch_rank=0), "--sketch-rank"),
    (dict(sketch_iters=-1), "--sketch-iters"),
    (dict(sketch_seed=2 ** 64), "--sketch-seed"),
    (dict(checkpoint_every_blocks=-1), "--checkpoint-every-blocks"),
    (dict(solver="fast"), "--solver"),
])
def test_knob_validation_names_the_flag(kw, match):
    with pytest.raises(ValueError, match=match):
        tconfig.ComputeConfig(num_pc=10, **kw)


def test_cli_runs_the_ladder_and_refuses_bad_knobs(tmp_path, capsys):
    out = tmp_path / "c.tsv"
    argv = ["--device", "cpu", "--n-samples", "40", "--n-variants", "1024",
            "--block-variants", "256", "--num-pc", "3", "--sketch-rank",
            "12"]
    assert tmain(["pcoa", "--solver", "corrected", "--sketch-iters", "1",
                  "--output-path", str(out)] + argv) == 0
    assert out.read_text().splitlines()[0] == "sample\tpc1\tpc2\tpc3"
    assert tmain(["pca", "--solver", "sketch"] + argv) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        tmain(["pcoa", "--solver", "sketch", "--metric", "king"] + argv)
    assert "--solver sketch does not support --metric king" in \
        capsys.readouterr().err


# -------------------------------------------------------- kill and resume

def _dying_synthetic(base, die_after: int):
    """A synthetic source that raises once ``die_after`` blocks were
    yielded over all its passes."""
    class Dying(base):
        yielded = 0

        def blocks(self, bv, start_variant=0):
            for item in super().blocks(bv, start_variant):
                if type(self).yielded == die_after:
                    raise RuntimeError("simulated preemption")
                type(self).yielded += 1
                yield item

    return Dying(n_samples=N, n_variants=V, seed=3)


@pytest.mark.parametrize("metric", ["grm", "ibs"])
def test_kill_mid_pass_one_resumes_bitwise(tmp_path, metric):
    """8 blocks a pass; the source dies after 12, 4 blocks into pass 1,
    with a checkpoint every 2 blocks: the rerun resumes pass 1 at
    variant 2048 and ends on the uninterrupted run's coordinates."""
    d = str(tmp_path / "ck")
    clean = jobs.pcoa_job(_tjob(metric, "corrected", sketch_iters=2))
    job = _tjob(metric, "corrected", sketch_iters=2, checkpoint_dir=d,
                checkpoint_every_blocks=2)
    with pytest.raises(RuntimeError, match="preemption"):
        jobs.pcoa_job(job, source=_dying_synthetic(SyntheticSource, 12))
    acc, cursor, _ = ckpt.load(d, f"solver:{metric}",
                               clean.sample_ids,
                               leaves=list((sketch.DUAL_STATE_LEAVES
                                            if metric == "ibs"
                                            else sketch.STATE_LEAVES))
                               + ["passno"])
    assert (int(acc["passno"]), cursor) == (1, 4 * BV)
    resumed = jobs.pcoa_job(job)
    np.testing.assert_array_equal(resumed.coords, clean.coords)
    np.testing.assert_array_equal(resumed.eigenvalues, clean.eigenvalues)
    # Another seed is another subspace: that checkpoint is refused.
    other = _tjob(metric, "corrected", sketch_iters=2, checkpoint_dir=d,
                  sketch_seed=1)
    with pytest.raises(ValueError, match="--sketch-seed"):
        jobs.pcoa_job(other)


@pytest.mark.parametrize("metric", ["grm", "ibs"])
def test_jax_sketch_checkpoint_resumes_in_the_port(tmp_path, metric):
    """JAX dies 4 blocks into pass 0; the port resumes from JAX's state
    (its ``qc`` included: no probe is redrawn) and ends within the stated
    tolerance of JAX's uninterrupted run."""
    d = str(tmp_path / "ck")
    jjob = _jjob(metric, "corrected", sketch_iters=2, checkpoint_dir=d,
                 checkpoint_every_blocks=2)
    with pytest.raises(RuntimeError, match="preemption"):
        jjobs.pcoa_job(jjob, source=_dying_synthetic(JSynthetic, 4))
    want = jjobs.pcoa_job(_jjob(metric, "corrected", sketch_iters=2))
    got = jobs.pcoa_job(_tjob(metric, "corrected", sketch_iters=2,
                              checkpoint_dir=d))
    assert _relerr(got.eigenvalues, np.asarray(want.eigenvalues)).max() \
        < EIG_RTOL
    _same_columns(got.coords, np.asarray(want.coords))
