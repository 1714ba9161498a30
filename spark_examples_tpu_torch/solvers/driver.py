"""The sketch-solver job driver: streamed passes, then the solve.

:func:`run_sketch_solve` is what ``pipelines/jobs.py`` calls for
``--solver sketch|corrected`` (the JAX package's ``solvers/driver.py``):

- stream 1 + ``--sketch-iters`` passes (corrected) or 1 pass (sketch)
  over the cohort through :func:`pipelines.runner.run_pass` (the loop,
  feed, cursor and checkpoint cadence of the gram route) under
  :func:`sketch_plan`: on one slot ``replicated``, on more ``variant``
  (each block split over the slots, the state replicated on the home
  device), and the solve's (N, r) blocks split by rows over the slots;
- between passes of the corrected rung, orthonormalize the sketch
  (shifted CholeskyQR2) and iterate: subspace iteration whose every
  B @ Q product is a streamed pass;
- the terminal solve: Nystrom (sketch) or Rayleigh (corrected).

Checkpoint/resume: the state is saved through ``core/checkpoint.py``
with the ``passno`` cursor as one more leaf, under the metric tag
``solver:<metric>`` (never confused with a gram checkpoint), and with
the rung, kind, rank, iterations and seed as the manifest's ``extra``
record (plus ``dual`` for ratio metrics): a resume under other probe
settings is refused. ``qc`` is a checkpointed leaf, so a resume never
redraws the probes, and a killed job resumes bit-identically.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import meshes, telemetry
from spark_examples_tpu_torch.core.config import SOLVER_RUNG_ID, JobConfig
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.core.profiling import PhaseTimer, hard_sync
from spark_examples_tpu_torch.ops.eigh import coords_from_eigpairs
from spark_examples_tpu_torch.parallel.gram_sharded import GramPlan
from spark_examples_tpu_torch.pipelines import runner
from spark_examples_tpu_torch.solvers import sketch, solve

_CKPT_LEAVES = sketch.STATE_LEAVES + ("passno",)
_DUAL_CKPT_LEAVES = sketch.DUAL_STATE_LEAVES + ("passno",)


@dataclass
class SketchSolveResult:
    """Host-resident eigenpairs and coordinates, and the provenance a
    saved model records."""

    sample_ids: list[str]
    eigenvalues: np.ndarray  # (k,) descending
    coords: np.ndarray  # (N, k)
    proportion: np.ndarray | None  # PCoA, factor sketch only
    n_variants: int
    rung: str
    rank: int
    passes: int
    # The factorized model's payload, filled only when the job saves one
    # (--save-model): the raw Ritz basis and the streamed centering
    # statistics, and for dual metrics the denominator scale diagonal
    # and its floor.
    eigvecs: np.ndarray | None = None
    colmean: np.ndarray | None = None
    grand: float | None = None
    scale: np.ndarray | None = None
    scale_floor: float = 0.0
    seed: int = 0


def _gauges(cfg, rank: int, dual: bool, state_bytes: int,
            nxn_bytes: int) -> None:
    """What this run holds beside what the exact route would hold."""
    telemetry.gauge_set("solver.rung", SOLVER_RUNG_ID[cfg.solver])
    telemetry.gauge_set("solver.rank", float(rank))
    telemetry.gauge_set("solver.dual", 1.0 if dual else 0.0)
    telemetry.gauge_set("solver.dual_den_defect", 0.0)  # set after pass 0
    telemetry.gauge_set("solver.state_bytes", float(state_bytes))
    telemetry.gauge_set("solver.nxn_bytes_avoided", float(nxn_bytes))


class _Checkpoints:
    """The solver's checkpoint record: metric tag, leaves and extras."""

    def __init__(self, job: JobConfig, source, metric: str, leaves,
                 extra: dict):
        self.cfg = job.compute
        self.bv = job.ingest.block_variants
        self.sample_ids = source.sample_ids
        self.tag = f"solver:{metric}"
        self.leaves = list(leaves)
        self.extra = extra
        self.every = bool(self.cfg.checkpoint_dir
                          and self.cfg.checkpoint_every_blocks)

    def save(self, state: dict, cursor: int, pass_idx: int) -> None:
        acc = dict(state)
        acc["passno"] = np.int64(pass_idx)
        ckpt.save(self.cfg.checkpoint_dir, acc, cursor, self.tag, self.bv,
                  self.sample_ids, extra=self.extra)

    def callback(self, pass_idx: int):
        """The pass's save hook, or None when the job saves nothing."""
        if not self.every:
            return None
        return lambda state, cursor: self.save(state, cursor, pass_idx)

    def load(self, device):
        """(state, pass, cursor) from the checkpoint, or None."""
        if not self.cfg.checkpoint_dir:
            return None
        restored = ckpt.load(self.cfg.checkpoint_dir, self.tag,
                             self.sample_ids, block_variants=self.bv,
                             leaves=self.leaves, expect_extra=self.extra,
                             device=device)
        if restored is None:
            return None
        acc, cursor, _stats = restored
        return acc, int(acc.pop("passno")), cursor


def sketch_plan(job: JobConfig) -> GramPlan:
    """The sketch's distribution plan: the job's mesh (the default slots
    of ``--device``, under ``--virtual-devices`` when asked, shaped by
    ``--mesh-shape``: the gram route's ``meshes.job_mesh``), blocks split
    by variant over it as the gram route's variant mode splits them, the
    state replicated. ``replicated`` on one slot, ``variant`` on more;
    never tile2d: there is no N x N accumulator to tile."""
    device = resolve_device(job.compute.device)
    mesh = meshes.job_mesh(device, job.compute.mesh_shape)
    return GramPlan(mesh, "replicated" if mesh.size == 1 else "variant")


def run_sketch_solve(job: JobConfig, source, timer: PhaseTimer,
                     kind: str) -> SketchSolveResult:
    """The sketch or corrected solve of a pcoa or pca job, dispatched on
    the kernel's declared streamability: a factor sketch below, a dual
    sketch (ibs, jaccard) in :func:`_run_dual_solve`."""
    cfg = job.compute
    metric = "shared-alt" if kind == "pca" else (cfg.metric or "ibs")
    kernels.check_sketchable(metric, cfg.solver)
    if cfg.backend == "cpu-reference":
        raise ValueError(
            "--solver sketch/corrected runs on the jax backend; the CPU "
            "oracle implements the dense reference route only"
        )
    if job.model_path:
        # The config checked what it could; the job also knows its kind,
        # so a pcoa fit of a pca-family metric is refused here.
        kernels.check_factorized_savable(metric, cfg.solver, kind)
    meshes.maybe_init_distributed(cfg.device)
    if meshes.process_count() > 1:
        raise ValueError(
            "--solver sketch/corrected is single-process for now (the "
            "state psums span the local mesh); run multi-host jobs with "
            "--solver exact"
        )
    plan = sketch_plan(job)
    if isinstance(kernels.get(metric).sketch, kernels.DualSketch):
        return _run_dual_solve(job, source, timer, kind, metric, plan)
    spec = kernels.get(metric).sketch
    n = source.n_samples
    rank = min(cfg.sketch_rank, n)
    passes = 1 + (cfg.sketch_iters if cfg.solver == "corrected" else 0)
    packed = kernels.streams_packed(metric, cfg.pack_stream)
    update = sketch.make_update(metric, packed=packed,
                                precise=cfg.grm_precise, plan=plan)
    _gauges(cfg, rank, False, sketch.state_bytes(n, rank),
            sketch.nxn_bytes(n, metric))
    ck = _Checkpoints(job, source, metric, _CKPT_LEAVES, {
        "solver": cfg.solver, "kind": kind, "rank": int(rank),
        "iters": int(cfg.sketch_iters), "seed": int(cfg.sketch_seed)})

    restored = ck.load(plan.mesh.home)
    if restored is not None:
        state, start_pass, start_variant = restored
    else:
        state = sketch.init_state(n, rank, cfg.sketch_seed, plan=plan)
        start_pass = start_variant = 0

    n_variants = 0
    yb = tr = None
    for pass_idx in range(start_pass, passes):
        with telemetry.span("solver.pass"):
            state, n_variants = runner.run_pass(
                job, source, timer, plan.mesh.home, update, state,
                start_variant if pass_idx == start_pass else 0, packed,
                block_flops=lambda v: sketch.flops_per_block(n, v, rank),
                save_cb=ck.callback(pass_idx),
                pad_multiple=plan.block_shards,
            )
        telemetry.count("solver.passes")
        yb, tr = sketch.finalize_pass(state["y"], state["trace"],
                                      state["nvar"], is_grm=spec.uses_nvar)
        if pass_idx + 1 < passes:
            # The next pass tracks the orthonormalized range of this one
            # (a right multiplication: still centered, so it is the J q
            # the update streams against).
            state = sketch.reset_for_pass(
                state, solve.orthonormalize(yb, plan), plan)
            if ck.every:
                ck.save(state, 0, pass_idx + 1)

    with timer.phase("eigh"), telemetry.span("solver.solve"):
        if cfg.solver == "sketch":
            vals, vecs = solve.nystrom_eigs(yb, state["qc"], cfg.num_pc,
                                            plan)
        else:
            vals, vecs = solve.rayleigh_eigs(yb, state["qc"], cfg.num_pc,
                                             plan)
        vals, vecs, tr = hard_sync((vals, vecs, tr))

    vals_np = vals.cpu().numpy()
    if kind == "pca":
        # The pca job's convention: coords = C v = lambda v (B is PSD
        # for every sketchable metric, so top == top-|lambda|).
        coords = (vecs * vals[None, :]).cpu().numpy()
        prop = None
    else:
        coords = coords_from_eigpairs(vals, vecs).cpu().numpy()
        prop = np.maximum(vals_np, 0.0) / max(float(tr), 1e-30)
    colmean = grand = None
    if job.model_path:
        # The streamed column mass, finalized into the centering
        # statistics the factorized model persists.
        colmean, grand = sketch.factor_centering(state)
    return SketchSolveResult(
        sample_ids=source.sample_ids, eigenvalues=vals_np, coords=coords,
        proportion=prop, n_variants=n_variants, rung=cfg.solver,
        rank=int(rank), passes=passes,
        eigvecs=vecs.cpu().numpy() if job.model_path else None,
        colmean=colmean, grand=grand, seed=int(cfg.sketch_seed))


def _run_dual_solve(job: JobConfig, source, timer: PhaseTimer, kind: str,
                    metric: str, plan: GramPlan) -> SketchSolveResult:
    """The dual-sketch solve of a ratio metric (similarity NUM ⊘ DEN):
    pass 0 streams both sketches and the exact denominator diagonal;
    the rank-1 scale follows, and the solve targets
    ``B = J diag(1/a) NUM diag(1/a) J``. Corrected-rung passes are power
    steps of B ending in a Rayleigh solve; the single-pass rung (PSD
    numerators only) solves from the scaled Nystrom factorization.

    B embeds the Gower geometry of the similarity. For jaccard that is
    the exact route's distance; for ibs, whose distance is ``d1 / 2m``
    itself, the sketch embeds the monotone ``sqrt(2 dist)`` geometry
    (same ordering, same structure). No proportion-explained: the scaled
    operator's total inertia cannot stream before the scale exists.
    """
    cfg = job.compute
    n = source.n_samples
    rank = min(cfg.sketch_rank, n)
    passes = 1 + (cfg.sketch_iters if cfg.solver == "corrected" else 0)
    packed = kernels.streams_packed(metric, cfg.pack_stream)
    updates = {with_den: sketch.make_dual_update(metric, packed=packed,
                                                 with_den=with_den,
                                                 plan=plan)
               for with_den in (True, False)}
    _gauges(cfg, rank, True, sketch.dual_state_bytes(n, rank),
            sketch.nxn_bytes(n, metric))
    ck = _Checkpoints(job, source, metric, _DUAL_CKPT_LEAVES, {
        "solver": cfg.solver, "kind": kind, "rank": int(rank),
        "iters": int(cfg.sketch_iters), "seed": int(cfg.sketch_seed),
        "dual": True})

    restored = ck.load(plan.mesh.home)
    if restored is not None:
        state, start_pass, start_variant = restored
    else:
        state = sketch.init_dual_state(n, rank, cfg.sketch_seed, plan=plan)
        start_pass = start_variant = 0

    n_variants = 0
    by = None
    for pass_idx in range(start_pass, passes):
        with_den = pass_idx == 0
        with telemetry.span("solver.pass"):
            state, n_variants = runner.run_pass(
                job, source, timer, plan.mesh.home, updates[with_den], state,
                start_variant if pass_idx == start_pass else 0, packed,
                block_flops=lambda v, _wd=with_den: (
                    sketch.dual_flops_per_block(n, v, rank, metric,
                                                with_den=_wd)),
                save_cb=ck.callback(pass_idx),
                pad_multiple=plan.block_shards,
            )
        telemetry.count("solver.passes")
        if pass_idx == 0:
            state = dict(state)
            state["scale"], defect = sketch.dual_scale(state, plan)
            telemetry.gauge_set("solver.dual_den_defect", float(defect))
        by = sketch.dual_apply(state)
        if pass_idx + 1 < passes:
            # Power step on B: orthonormalize the scaled, centered range
            # and fold the scale into the next pass's streamed probes.
            state = sketch.reset_dual_pass(
                state, solve.orthonormalize(by, plan), plan)
            if ck.every:
                ck.save(state, 0, pass_idx + 1)

    with timer.phase("eigh"), telemetry.span("solver.solve"):
        if cfg.solver == "sketch":
            vals, vecs = solve.nystrom_eigs_scaled(
                state["y"], state["qc"], by, cfg.num_pc, plan)
        else:
            vals, vecs = solve.rayleigh_eigs(by, state["q"], cfg.num_pc,
                                             plan)
        vals, vecs = hard_sync((vals, vecs))

    coords = coords_from_eigpairs(vals, vecs).cpu().numpy()
    save = bool(job.model_path) and cfg.solver == "corrected"
    colmean = grand = scale = None
    floor = 0.0
    if save:
        # The dual column mass streams only in the scaled power passes
        # (the scale does not exist during pass 0), so only the
        # corrected rung persists a model; the config and job gates
        # already refuse the others.
        colmean, grand, floor = sketch.dual_centering(state)
        scale = state["scale"].cpu().numpy().astype(np.float64)
    return SketchSolveResult(
        sample_ids=source.sample_ids, eigenvalues=vals.cpu().numpy(),
        coords=coords, proportion=None, n_variants=n_variants,
        rung=cfg.solver, rank=int(rank), passes=passes,
        eigvecs=vecs.cpu().numpy() if save else None, colmean=colmean,
        grand=grand, scale=scale, scale_floor=floor,
        seed=int(cfg.sketch_seed))
