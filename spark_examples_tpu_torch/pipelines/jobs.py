"""Job entrypoints:

- :func:`similarity_matrix_job` — stream cohort -> persist N x N matrix.
- :func:`pcoa_job` — cohort -> distance -> double-center -> eig ->
  coords, on the device (only the (N, k) coordinates come back to the
  host); under a tile2d plan every N x N stage stays tiled over the mesh
  (``parallel/pcoa_sharded.py``) and the eigensolve is randomized. Count
  and float kernels (the dosage metrics, euclidean, dot, grm) stream
  through the gram accumulators; table kernels (braycurtis)
  materialise the table and lower it. Or from a persisted matrix
  (``--matrix-path``: the similarity job's output, the two-job handoff).
- :func:`variants_pca_job` — the flagship job: shared-alt similarity
  -> centered PCA, on the device.

``--backend cpu-reference`` runs both coordinates jobs on the host
oracle (``utils/oracle.py``): the similarity job's float64 route, then
the oracle's classical MDS (pcoa) or the MLlib covariance route (pca).
The sketch rungs, like streaming, run on the device route only, and say
so.

Both coordinates jobs take the sketch rungs of the accuracy ladder
(``--solver sketch|corrected``, ``solvers/``): streamed (N, rank) state
and a Nystrom or Rayleigh solve, no N x N anywhere. With
``--save-model`` they persist the fitted embedding for ``project``
(``pipelines/project.py``): the exact model from the dense matrix, the
factorized model (``models/factorized.py``) from a sketch rung.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.config import (
    EIGH_ITERS_DEFAULT,
    SOLVER_RUNG_ID,
    JobConfig,
)
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.core.profiling import (
    PhaseTimer,
    check_nans,
    hard_sync,
)
from spark_examples_tpu_torch.models.pca import fit_pca
from spark_examples_tpu_torch.models.pcoa import fit_pcoa
from spark_examples_tpu_torch.ops.distances import similarity_to_distance
from spark_examples_tpu_torch.ops.eigh import eigh_flops
from spark_examples_tpu_torch.pipelines import io as pio
from spark_examples_tpu_torch.pipelines import runner
from spark_examples_tpu_torch.utils import oracle


@dataclass
class CoordsOutput:
    sample_ids: list[str]
    coords: np.ndarray
    eigenvalues: np.ndarray
    timer: PhaseTimer
    n_variants: int = 0
    # Fraction of TOTAL inertia per component (trace-based).
    proportion: np.ndarray | None = None


def similarity_matrix_job(job: JobConfig, source=None
                          ) -> runner.SimilarityResult:
    result = runner.run_similarity(job, source=source)
    if job.output_path:
        pio.write_matrix(job.output_path, result.sample_ids,
                         result.similarity, kind="similarity")
    return result


def pcoa_job(job: JobConfig, source=None, matrix_path: str | None = None,
             matrix_kind: str = "auto") -> CoordsOutput:
    """Cohort -> PCoA coordinates: gram accumulators -> finalize (or a
    table kernel's runner) -> center -> eigh -> coords, without the N x N
    matrix leaving the device. With ``matrix_path``, from a persisted
    matrix instead (the two-job handoff): ``matrix_kind`` says whether
    it holds distances or similarities (similarities are
    Gower-transformed first); ``auto`` trusts the file's sidecar and
    falls back to distance."""
    cfg = job.compute
    if matrix_path is not None:
        return _pcoa_from_matrix(job, matrix_path, matrix_kind)
    metric = cfg.metric or "ibs"
    timer = PhaseTimer()
    table = kernels.get(metric).table_runner
    with runner.job_source(job, source, timer) as source:
        if cfg.solver != "exact":
            return _sketch_route(job, source, timer, kind="pcoa")
        if cfg.backend == "cpu-reference":
            return _pcoa_host(job, source, timer)
        if table is not None:
            dist = table(job, source, timer)
            sample_ids, n_variants = source.sample_ids, source.n_variants
        else:
            plan = runner.plan_for_job(job, source)
            if plan.mode == "tile2d" and cfg.eigh_mode == "dense":
                # Dense eigh needs the materialized matrix.
                return _pcoa_gathered(job, source, timer)
            if plan.mode == "tile2d" and job.model_path:
                # Fail BEFORE streaming: discovering this after a long
                # accumulation would discard all of it.
                raise ValueError(
                    "--save-model needs the dense distance matrix for the "
                    "projection centering statistics; the tile2d plan "
                    "never materializes it — fit the model with "
                    "gram_mode=variant"
                )
            grun = runner.run_gram(job, source, timer, plan=plan)
            if plan.mode == "tile2d":
                return _pcoa_tiled(job, grun, timer)
            sample_ids, n_variants = grun.sample_ids, grun.n_variants
    if table is None:
        with timer.phase("finalize"):
            dist = hard_sync(runner.finalize_field(grun.acc, metric,
                                                   "distance"))
    method = _eigh_method(cfg.eigh_mode, dist.shape[0])
    with timer.phase("eigh"):
        res = hard_sync(fit_pcoa(dist, k=cfg.num_pc, method=method,
                                 iters=cfg.eigh_iters,
                                 oversample=cfg.eigh_oversample))
    coords = res.coords.cpu().numpy()
    vals = res.eigenvalues.cpu().numpy()
    _maybe_save_model(job, dist, coords, vals, sample_ids)
    return _emit_coords(job, sample_ids, coords, vals, timer, n_variants,
                        method=method, eigh_iters=cfg.eigh_iters,
                        proportion=res.proportion_explained.cpu().numpy())


def _pcoa_tiled(job: JobConfig, grun, timer) -> CoordsOutput:
    """The tile2d route: finalize, center and the randomized eigensolve
    with every N x N stage tiled (``parallel/pcoa_sharded.py``)."""
    from spark_examples_tpu_torch.parallel.pcoa_sharded import (
        pcoa_coords_sharded,
    )

    cfg = job.compute
    res = pcoa_coords_sharded(grun.plan, grun.acc, grun.metric,
                              k=cfg.num_pc, oversample=cfg.eigh_oversample,
                              iters=cfg.eigh_iters, timer=timer)
    return _emit_coords(job, grun.sample_ids, res.coords.cpu().numpy(),
                        res.eigenvalues.cpu().numpy(), timer,
                        grun.n_variants, method="randomized",
                        eigh_iters=cfg.eigh_iters,
                        proportion=res.proportion_explained.cpu().numpy())


def _pcoa_gathered(job: JobConfig, source, timer) -> CoordsOutput:
    """Dense eigh under a tile2d plan: the similarity job's route (tiles
    finalized, then gathered on the host), then the dense solve on slot
    0's device."""
    cfg = job.compute
    sim = runner.run_similarity(job, source=source)
    sim.timer.phases.update(timer.phases)  # ingest_setup
    timer = sim.timer
    dist = torch.from_numpy(sim.distance).to(resolve_device(cfg.device))
    method = _eigh_method(cfg.eigh_mode, dist.shape[0])
    with timer.phase("eigh"):
        res = hard_sync(fit_pcoa(dist, k=cfg.num_pc, method=method,
                                 iters=cfg.eigh_iters,
                                 oversample=cfg.eigh_oversample))
    coords = res.coords.cpu().numpy()
    vals = res.eigenvalues.cpu().numpy()
    _maybe_save_model(job, sim.distance, coords, vals, sim.sample_ids)
    return _emit_coords(job, sim.sample_ids, coords, vals, timer,
                        sim.n_variants, method=method,
                        eigh_iters=cfg.eigh_iters,
                        proportion=res.proportion_explained.cpu().numpy())


def _host(matrix) -> np.ndarray:
    """A device tensor, or the host oracle's array, as a host array."""
    if isinstance(matrix, np.ndarray):
        return matrix
    return matrix.cpu().numpy()


def _maybe_save_model(job: JobConfig, dist, coords, vals,
                      sample_ids) -> None:
    """Persist the fitted PCoA embedding when the job asks for it; the
    (N, N) distance comes to the host only then."""
    if not job.model_path:
        return
    from spark_examples_tpu_torch.pipelines.project import save_model

    save_model(job.model_path, coords, vals, _host(dist),
               sample_ids, job.compute.metric or "ibs",
               solver=job.compute.solver)


def _maybe_save_pca_model(job: JobConfig, sim, coords, vals,
                          sample_ids) -> None:
    """Persist the fitted PCA embedding when the job asks for it."""
    if not job.model_path:
        return
    from spark_examples_tpu_torch.pipelines.project import save_pca_model

    save_pca_model(job.model_path, coords, vals, _host(sim),
                   sample_ids, solver=job.compute.solver)


def _pcoa_host(job: JobConfig, source, timer) -> CoordsOutput:
    """``--backend cpu-reference``: the oracle's host similarity job,
    then its float64 classical MDS (``oracle.pcoa``); nothing touches
    the device."""
    sim = runner.run_similarity(job, source=source)
    sim.timer.phases.update(timer.phases)  # ingest_setup
    with sim.timer.phase("eigh"):
        coords, vals, prop = oracle.pcoa(sim.distance, k=job.compute.num_pc)
    _maybe_save_model(job, sim.distance, coords, vals, sim.sample_ids)
    return _emit_coords(job, sim.sample_ids, coords, vals, sim.timer,
                        sim.n_variants, method="dense",
                        eigh_iters=job.compute.eigh_iters, proportion=prop)


def _maybe_save_factorized_model(job: JobConfig, kind: str, res) -> None:
    """Persist a sketch-rung fit as a factorized model when the job asks
    for it (the config and the solver driver checked that the rung and
    metric can; ``res`` carries the basis and the streamed centering
    statistics)."""
    if not job.model_path:
        return
    from spark_examples_tpu_torch.models.factorized import (
        save_factorized_model,
    )

    metric = ("shared-alt" if kind == "pca"
              else (job.compute.metric or "ibs"))
    save_factorized_model(
        job.model_path,
        family="pca" if kind == "pca" else "pcoa",
        metric=metric,
        eigenvectors=res.eigvecs,
        eigenvalues=res.eigenvalues,
        colmean=res.colmean,
        grand=res.grand,
        sample_ids=res.sample_ids,
        solver=res.rung,
        rank=res.rank,
        seed=res.seed,
        scale=res.scale,
        scale_floor=res.scale_floor,
    )


def _pcoa_from_matrix(job: JobConfig, matrix_path: str,
                      matrix_kind: str) -> CoordsOutput:
    """PCoA of a persisted square matrix, on the job's device."""
    cfg = job.compute
    if job.model_path:
        raise ValueError(
            "--save-model cannot be combined with --matrix-path: the "
            "persisted matrix does not record which metric built it, "
            "and a model stamped with the wrong metric would project "
            "silently wrong coordinates — fit the model from a cohort "
            "stream instead"
        )
    if cfg.solver != "exact":
        raise ValueError(
            "--solver sketch/corrected streams the cohort to avoid "
            "materializing N x N; a persisted --matrix-path IS the "
            "materialized matrix — consume it with --solver exact"
        )
    device = resolve_device(cfg.device)
    sample_ids, m, file_kind = pio.read_matrix(matrix_path)
    kind = matrix_kind if matrix_kind != "auto" else (file_kind or "distance")
    if kind not in ("distance", "similarity"):
        raise ValueError(
            f"matrix_kind must be distance|similarity, got {kind!r}")
    if cfg.backend == "cpu-reference":
        timer = PhaseTimer()
        dist = m if kind == "distance" else oracle.gower_f32(m)
        with timer.phase("eigh"):
            coords, vals, prop = oracle.pcoa(dist, k=cfg.num_pc)
        return _emit_coords(job, sample_ids, coords, vals, timer, 0,
                            method="dense", eigh_iters=cfg.eigh_iters,
                            proportion=prop)
    mat = torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(device)
    dist = mat if kind == "distance" else similarity_to_distance(mat)
    timer = PhaseTimer()
    method = _eigh_method(cfg.eigh_mode, dist.shape[0])
    with timer.phase("eigh"):
        res = hard_sync(fit_pcoa(dist, k=cfg.num_pc, method=method,
                                 iters=cfg.eigh_iters,
                                 oversample=cfg.eigh_oversample))
    return _emit_coords(job, sample_ids, res.coords.cpu().numpy(),
                        res.eigenvalues.cpu().numpy(), timer, 0,
                        method=method, eigh_iters=cfg.eigh_iters,
                        proportion=res.proportion_explained.cpu().numpy())


def _sketch_route(job: JobConfig, source, timer, kind: str) -> CoordsOutput:
    """The sketch and corrected rungs: streamed passes and a Nystrom or
    Rayleigh solve (solvers/). ``method="sketch"`` gives the output tail
    the solve stage's operation credit (the passes' products were
    credited to ``gram_flops`` as they streamed)."""
    from spark_examples_tpu_torch.solvers import run_sketch_solve

    res = run_sketch_solve(job, source, timer, kind=kind)
    check_nans("sketch", res)
    _maybe_save_factorized_model(job, kind, res)
    return _emit_coords(job, res.sample_ids, res.coords, res.eigenvalues,
                        timer, res.n_variants, method="sketch",
                        eigh_iters=res.passes, proportion=res.proportion)


def variants_pca_job(job: JobConfig, source=None) -> CoordsOutput:
    """The flagship job: shared-alt similarity -> centered PCA, the
    exact dense route on the device (only the (N, k) projections come
    back to the host).

    The metric is fixed by the job's definition (shared alt-carrier
    counts); a config naming another metric is warned about, not
    silently overridden (the CLI rejects it outright). ``metric=None``
    means "the job's choice" and is silent.
    """
    if job.compute.metric not in (None, "shared-alt"):
        warnings.warn(
            f"variants_pca_job ignores compute.metric={job.compute.metric!r} "
            "and always uses 'shared-alt'",
            UserWarning,
            stacklevel=2,
        )
    job = job.replace(
        compute=dataclasses.replace(job.compute, metric="shared-alt"))
    timer = PhaseTimer()
    with runner.job_source(job, source, timer) as source:
        if job.compute.backend == "cpu-reference":
            return _pca_host(job, source, timer)
        if job.compute.solver != "exact":
            return _sketch_route(job, source, timer, kind="pca")
        plan = runner.plan_for_job(job, source)
        if plan.mode == "tile2d" and job.model_path:
            # Fail BEFORE streaming (projection needs the dense
            # similarity's centering statistics).
            raise ValueError(
                "--save-model needs the dense similarity matrix for "
                "the projection centering statistics; fit the model "
                "with gram_mode=variant"
            )
        grun = runner.run_gram(job, source, timer, plan=plan)
        if plan.mode == "tile2d":
            # Similarity -> center -> top-|lambda| eig, all tiled.
            from spark_examples_tpu_torch.parallel.pcoa_sharded import (
                pca_coords_sharded,
            )

            iters = job.compute.eigh_iters
            res = pca_coords_sharded(
                plan, grun.acc, "shared-alt", k=job.compute.num_pc,
                oversample=job.compute.eigh_oversample, iters=iters,
                timer=timer)
            return _emit_coords(job, grun.sample_ids,
                                res.coords.cpu().numpy(),
                                res.eigenvalues.cpu().numpy(), timer,
                                grun.n_variants, method="randomized",
                                eigh_iters=iters)
    with timer.phase("finalize"):
        sim = hard_sync(runner.finalize_field(grun.acc, "shared-alt",
                                              "similarity"))
    with timer.phase("eigh"):
        res = hard_sync(fit_pca(sim, k=job.compute.num_pc))
    coords = res.coords.cpu().numpy()
    vals = res.eigenvalues.cpu().numpy()
    _maybe_save_pca_model(job, sim, coords, vals, grun.sample_ids)
    return _emit_coords(job, grun.sample_ids, coords, vals, timer,
                        grun.n_variants, method="dense")


def _pca_host(job: JobConfig, source, timer) -> CoordsOutput:
    """``--backend cpu-reference``: the oracle's shared-alt similarity,
    then the reference's MLlib route (center, column covariance,
    eigenvectors, projections) with its signed matrix eigenvalues."""
    if job.compute.solver != "exact":
        raise ValueError(
            "--solver sketch/corrected runs on the jax backend; the CPU "
            "oracle implements the dense reference route only"
        )
    sim = runner.run_similarity(job, source=source)
    sim.timer.phases.update(timer.phases)  # ingest_setup
    with sim.timer.phase("eigh"):
        coords, vals = oracle.pca_mllib_route(
            sim.similarity, k=job.compute.num_pc, return_values=True)
    _maybe_save_pca_model(job, sim.similarity, coords, vals,
                          sim.sample_ids)
    return _emit_coords(job, sim.sample_ids, coords, vals, sim.timer,
                        sim.n_variants, method="dense")


def _emit_coords(job: JobConfig, sample_ids, coords, vals, timer,
                 n_variants: int, method: str,
                 eigh_iters: int = EIGH_ITERS_DEFAULT,
                 proportion=None) -> CoordsOutput:
    """Shared output tail: solver-matched operation credit, the ladder
    rung gauge, result assembly, optional TSV persistence. The sketch's
    probe width is ``--sketch-rank``, so its oversample is rank - k and
    ``eigh_iters`` carries its pass count."""
    cfg = job.compute
    oversample = (cfg.sketch_rank - cfg.num_pc if method == "sketch"
                  else cfg.eigh_oversample)
    timer.add("eigh_flops", eigh_flops(len(sample_ids), method=method,
                                       k=cfg.num_pc, oversample=oversample,
                                       iters=eigh_iters))
    telemetry.gauge_set("solver.rung", float(SOLVER_RUNG_ID[cfg.solver]))
    out = CoordsOutput(sample_ids, coords, vals, timer, n_variants,
                       proportion=proportion)
    if job.output_path:
        pio.write_coords_tsv(job.output_path, sample_ids, out.coords)
    return out


def _eigh_method(eigh_mode: str, n: int) -> str:
    if eigh_mode == "auto":
        return "randomized" if n > 16384 else "dense"
    return {"dense": "dense", "randomized": "randomized"}[eigh_mode]
