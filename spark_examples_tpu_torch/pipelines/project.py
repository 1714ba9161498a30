"""Fit a panel once, then place new samples into its coordinates.

Refitting on panel + new samples would move every axis; the workflow
users run is to fit a reference panel (``pcoa|pca --save-model``) and
project new cohorts into the same space (``project``):

1. ``--save-model`` persists the embedding: eigenvectors V, eigenvalues
   lambda and the centering statistics the projection needs (the
   panel's D^2 column and grand means for PCoA, the similarity's for
   PCA): :func:`save_model`, :func:`save_pca_model`, one ``.npz``. A
   sketch-rung fit saves a factorized model (``models/factorized.py``).
2. ``project`` streams the NEW cohort against the PANEL's genotypes
   (same variants), accumulating the (A, N_ref) cross statistics as
   int8 contractions (``ops/genotype.py::cross_stats``), finalizes the
   kernel's squared cross distance and applies Gower's out-of-sample
   formula on the device:

       b_a = -1/2 (d2_a - mean(d2_a) - colmean_ref + grand_ref)
       y_a = b_a V diag(lambda)^(-1/2)

   Projecting the panel's own samples reproduces their fitted
   coordinates (B V = V diag(lambda)).

``cross-kinship`` runs the same lockstep cross pass for the KING-robust
kinship between two cohorts.

Projectability is a kernel capability: a kernel declaring a
:class:`~spark_examples_tpu_torch.kernels.CrossSpec` (ibs, jaccard)
projects as a PCoA model with no change here; a pca model projects its
centered shared-alt similarity row onto V.

The two cohorts stream in lockstep through the feed. Under a
:class:`CrossPlan` the cross accumulators are whole (A, N_ref) tensors
on slot 0's device (``replicated``; ``--gram-mode variant`` maps to
this, as in the JAX package), or tiled over the mesh (``tile2d``: new
rows over ``i``, reference columns over ``j``, each slot contracting its
own row slices of both blocks, with no collective); the projection then
gathers them on slot 0. The cross products are ``torch._int_mm`` on the
card under either plan (the JAX package's are ``jnp.dot``). The saved
archives are the JAX package's (``pipelines/project.py``), field for
field and dtype for dtype, so either package loads and projects the
other's models.
"""

from __future__ import annotations

import hashlib
import warnings
import zipfile
from contextlib import closing
from dataclasses import dataclass

import numpy as np
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import meshes
from spark_examples_tpu_torch.core.config import JobConfig
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.core.profiling import PhaseTimer, hard_sync
from spark_examples_tpu_torch.ingest.prefetch import stream_to_device
from spark_examples_tpu_torch.ops import genotype
from spark_examples_tpu_torch.pipelines import io as pio
from spark_examples_tpu_torch.pipelines import runner as R
from spark_examples_tpu_torch.pipelines.jobs import CoordsOutput
from spark_examples_tpu_torch.solvers.sketch import ieee_f32

# (model kind, metric) -> the cross statistics to stream. Keyed on both:
# a shared-alt PCoA model is valid to fit but not projectable. The pcoa
# rows come from the registry (any kernel with a CrossSpec).
PROJECTABLE = {
    **{("pcoa", k.name): k.cross.stats
       for k in (kernels.get(n) for n in kernels.names())
       if k.cross is not None},
    ("pca", "shared-alt"): ("s",),
}

# Saved-model schema version (the JAX package's): bump when a field is
# added, renamed or changes meaning. load_model refuses a file it cannot
# interpret with an error naming the cause.
SCHEMA_VERSION = 2

# Required archive members per model kind (beyond schema_version).
_MODEL_KEYS = {
    "pcoa": ("kind", "metric", "eigvecs", "eigvals", "d2_colmean",
             "d2_grand", "sample_ids"),
    "pca": ("kind", "metric", "eigvecs", "eigvals", "s_colmean",
            "s_grand", "sample_ids"),
}


class ModelFormatError(ValueError):
    """A saved model that cannot be interpreted safely: a truncated or
    corrupt archive, a file without a schema version or from a newer
    build, or one missing a required field, always named."""


@dataclass(frozen=True)
class ProjectionModel:
    """A loaded, validated exact-rung model. ``colmean``/``grand`` are the
    kind's centering statistics (the panel's D^2 means for PCoA, the
    similarity's for PCA); arrays are float64 as persisted and cast to
    f32 on the device."""

    kind: str
    metric: str
    eigvecs: np.ndarray
    eigvals: np.ndarray
    colmean: np.ndarray
    grand: float
    sample_ids: list[str]
    schema_version: int = SCHEMA_VERSION
    # The ladder rung that fitted the eigenpairs; absent in older files,
    # which were all exact.
    solver: str = "exact"

    @property
    def n_ref(self) -> int:
        return int(self.eigvecs.shape[0])

    @property
    def n_components(self) -> int:
        return int(self.eigvecs.shape[1])

    def digest(self) -> str:
        """Content fingerprint (the JAX package's, so both packages give
        one model file the same digest)."""
        h = hashlib.sha256()
        h.update(
            f"{self.kind}:{self.metric}:{self.schema_version}".encode()
        )
        for a in (self.eigvecs, self.eigvals, self.colmean):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.float64(self.grand).tobytes())
        return h.hexdigest()[:16]


def load_model(path: str):
    """Load and validate a saved model (a :class:`ProjectionModel`, or a
    ``FactorizedModel`` for ``kind="factorized"``). Every failure is a
    :class:`ModelFormatError` naming its cause: an unreadable or
    truncated archive, no ``schema_version`` (a pre-versioning file), a
    newer schema, an unknown ``kind`` or a missing field. A raw
    ``KeyError`` or ``BadZipFile`` never escapes."""
    try:
        npz = np.load(path, allow_pickle=False)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise ModelFormatError(
            f"model file {path!r} is not a readable .npz archive "
            f"({e}) — truncated or corrupt? refit with "
            "pcoa/pca --save-model"
        ) from None
    try:
        with npz as mdl:
            names = set(mdl.files)
            if "schema_version" not in names:
                raise ModelFormatError(
                    f"model file {path!r} has no 'schema_version' field "
                    "— written by a pre-versioning build; refit it with "
                    "pcoa/pca --save-model to upgrade"
                )
            version = int(mdl["schema_version"])
            if version > SCHEMA_VERSION:
                raise ModelFormatError(
                    f"model file {path!r} has schema_version {version}, "
                    f"newer than this build understands "
                    f"({SCHEMA_VERSION}) — upgrade the code or refit"
                )
            if "kind" not in names:
                raise ModelFormatError(
                    f"model file {path!r} is missing the 'kind' field"
                )
            kind = str(mdl["kind"])
            if kind == "factorized":
                # Imported here: models/factorized.py imports this
                # module's ModelFormatError at its top.
                from spark_examples_tpu_torch.models import factorized

                return factorized.parse_factorized(mdl, path, version)
            if kind not in _MODEL_KEYS:
                raise ModelFormatError(
                    f"model file {path!r} has unknown kind {kind!r} "
                    f"(supported: {sorted(_MODEL_KEYS)})"
                )
            missing = [k for k in _MODEL_KEYS[kind] if k not in names]
            if missing:
                raise ModelFormatError(
                    f"model file {path!r} (kind={kind!r}, "
                    f"schema_version {version}) is missing required "
                    f"field(s) {missing} — truncated save or a file "
                    "from an incompatible build; refit with "
                    "pcoa/pca --save-model"
                )
            cm, gr = (("s_colmean", "s_grand") if kind == "pca"
                      else ("d2_colmean", "d2_grand"))
            return ProjectionModel(
                kind=kind,
                metric=str(mdl["metric"]),
                eigvecs=np.asarray(mdl["eigvecs"], np.float64),
                eigvals=np.asarray(mdl["eigvals"], np.float64),
                colmean=np.asarray(mdl[cm], np.float64),
                grand=float(mdl[gr]),
                sample_ids=[str(s) for s in mdl["sample_ids"]],
                schema_version=version,
                solver=(str(mdl["solver"]) if "solver" in names
                        else "exact"),
            )
    except (ValueError, OSError, zipfile.BadZipFile) as e:
        # Member reads of a truncated but openable archive fail here.
        if isinstance(e, ModelFormatError):
            raise
        raise ModelFormatError(
            f"model file {path!r} could not be decoded ({e}) — "
            "truncated or corrupt? refit with pcoa/pca --save-model"
        ) from None


def check_projectable(model) -> tuple[str, ...]:
    """The (kind, metric) gate: the cross statistics to stream, or a
    ValueError before any streaming."""
    if getattr(model, "kind", None) == "factorized":
        from spark_examples_tpu_torch.models import factorized

        return factorized.check_factorized_projectable(model)
    stats = PROJECTABLE.get((model.kind, model.metric))
    if stats is None:
        raise ValueError(
            f"model (kind={model.kind!r}, metric={model.metric!r}) is "
            f"not projectable (supported: {sorted(PROJECTABLE)})"
        )
    return stats


def check_reference_panel(model, source_ref) -> None:
    """Refuse a reference source that is not the panel the model was
    fitted on: cross statistics against other genotypes would project
    silently wrong coordinates."""
    if model.sample_ids != list(source_ref.sample_ids):
        raise ValueError(
            "reference source sample ids do not match the panel the "
            f"model was fitted on ({source_ref.n_samples} vs "
            f"{len(model.sample_ids)} samples"
            + (
                "; ids differ"
                if source_ref.n_samples == len(model.sample_ids)
                else ""
            )
            + ") — cross-distances against the wrong genotypes "
            "would project silently wrong coordinates"
        )


def save_model(path: str, coords: np.ndarray, eigenvalues: np.ndarray,
               distance: np.ndarray, sample_ids: list[str], metric: str,
               solver: str = "exact") -> None:
    """Persist a fitted PCoA embedding. ``coords`` = V sqrt(lambda) (the
    job's output), so V is recovered by dividing sqrt(lambda) out;
    components with lambda <= 0 are dropped (their V carries no metric
    information)."""
    vals = np.asarray(eigenvalues, np.float64)
    keep = vals > 0
    v = np.asarray(coords, np.float64)[:, keep] / np.sqrt(vals[keep])
    d2 = np.asarray(distance, np.float64) ** 2
    np.savez(
        path,
        schema_version=np.int64(SCHEMA_VERSION),
        kind=np.asarray("pcoa"),
        eigvecs=v,
        eigvals=vals[keep],
        d2_colmean=d2.mean(axis=0),
        d2_grand=np.float64(d2.mean()),
        sample_ids=np.asarray(sample_ids),
        metric=np.asarray(metric),
        solver=np.asarray(solver),
    )


def save_pca_model(path: str, coords: np.ndarray, eigenvalues: np.ndarray,
                   similarity: np.ndarray, sample_ids: list[str],
                   solver: str = "exact") -> None:
    """Persist a fitted PCA embedding. ``coords`` = V lambda (C v =
    lambda v), so V is recovered by dividing lambda out; zero eigenvalues
    are dropped. A new row is centered with the panel similarity's
    column and grand means."""
    vals = np.asarray(eigenvalues, np.float64)
    keep = np.abs(vals) > 1e-12
    v = np.asarray(coords, np.float64)[:, keep] / vals[keep]
    s = np.asarray(similarity, np.float64)
    np.savez(
        path,
        schema_version=np.int64(SCHEMA_VERSION),
        kind=np.asarray("pca"),
        eigvecs=v,
        eigvals=vals[keep],
        s_colmean=s.mean(axis=0),
        s_grand=np.float64(s.mean()),
        sample_ids=np.asarray(sample_ids),
        metric=np.asarray("shared-alt"),
        solver=np.asarray(solver),
    )


def _af_moments(bn: torch.Tensor, br: torch.Tensor) -> torch.Tensor:
    """One block's sufficient statistics of the two cohorts' allele-
    frequency correlation over variants called in both: (count, Sx, Sy,
    Sxy, Sxx, Syy). Small per block; the caller sums the blocks in f64
    on the host, where an f32 running sum would erode the variance
    terms' cancellation at depth."""
    x, cx, _, _ = genotype.af_stats(bn)
    y, cy, _, _ = genotype.af_stats(br)
    both = ((cx > 0) & (cy > 0)).to(torch.float32)
    x = x * both
    y = y * both
    return torch.stack([both.sum(), x.sum(), y.sum(), (x * y).sum(),
                        (x * x).sum(), (y * y).sum()])


def _check_af_concordance(moments: np.ndarray, a: int, n_ref: int) -> None:
    """Warn when the cohorts' allele frequencies disagree: REF/ALT coding
    swapped in one cohort (dosage g becomes 2 - g) corrupts projection
    and kinship without an error anywhere.

    Two regimes, since a small cohort's AF estimates are noisy (a single
    sample tops out near r ~ 0.3-0.5 even with identical coding):

    - r strongly negative: noise only attenuates toward 0, so this is an
      allele flip at any cohort size;
    - r merely low: meaningful only when both cohorts have >= 20
      samples; then r < 0.5 means a variant-order or coding mismatch.
    """
    n, sx, sy, sxy, sxx, syy = (float(v) for v in moments)
    if n < 20:
        return  # too few shared variants to judge
    vx = sxx - sx * sx / n
    vy = syy - sy * sy / n
    if vx <= 0 or vy <= 0:
        return  # a cohort with constant AF carries no signal
    r = (sxy - sx * sy / n) / np.sqrt(vx * vy)
    flip = r < -0.2
    low = r < 0.5 and min(a, n_ref) >= 20
    if flip or low:
        warnings.warn(
            f"cross-cohort allele-frequency correlation is {r:.3f} "
            "(expected ~1 for the same variant set with the same "
            "REF/ALT coding)"
            + (
                " — negative correlation means one cohort's alleles "
                "are swapped (dosage 2-g)"
                if flip
                else " — likely a variant-order or coding mismatch"
            )
            + "; results will be wrong until the cohorts are harmonized",
            RuntimeWarning,
            stacklevel=3,
        )


def _den_diag(qden: torch.Tensor, block: torch.Tensor,
              metric: str) -> torch.Tensor:
    """Add one block's query side of a dual-sketch metric's denominator
    diagonal: the kernel's ``den_terms`` of each row against itself.
    Integer-valued terms, so the f32 running sum is exact up to 2^24,
    far above any per-sample total of a panel."""
    spec = kernels.get(metric).sketch
    ops = spec.operands(block)
    for left, right, w in spec.den_terms:
        qden = qden + w * (ops[left] * ops[right]).sum(dim=1)
    return qden


def update_cross(acc: dict, bn: torch.Tensor, br: torch.Tensor) -> dict:
    """Add one block's cross statistics (the keys of ``acc``) of the new
    rows ``bn`` against the reference rows ``br`` into ``acc``, in
    place, and return it: the offline lockstep pass and the serving
    engine both run this. Integer sums, so any block partition and any
    padding of ``bn`` with extra rows leave each row's totals
    unchanged."""
    upd = genotype.cross_stats(bn, br, tuple(acc))
    for k in acc:
        acc[k].add_(upd[k])
    return acc


@dataclass(frozen=True)
class CrossPlan:
    """Distribution plan of the (A, N_ref) cross accumulation:
    ``replicated`` (whole leaves on slot 0) or ``tile2d`` (NEW-cohort
    rows over mesh axis ``i``, REFERENCE columns over ``j``; each slot
    takes the new block's rows over ``i`` and the reference block's rows
    over ``j`` and contracts them into its own tile, collective-free)."""

    mesh: meshes.Mesh
    mode: str  # replicated | tile2d


def cross_plan_for(mesh: meshes.Mesh, a: int, n_ref: int, n_stats: int,
                   mode: str = "auto") -> CrossPlan:
    """Pick (or validate) a cross-accumulation mode: ``auto`` tiles when
    the accumulators would pass the per-device budget and both sample
    axes divide by their mesh axis; ``variant`` has no cross analogue and
    runs replicated, as in the JAX package. A job spanning processes
    (``torch.distributed`` with more than one rank) runs replicated, and
    asking it for tile2d is refused, as in the JAX package."""
    from spark_examples_tpu_torch.parallel.gram_sharded import _ACC_BUDGET

    n_i, n_j = mesh.shape
    divisible = a % n_i == 0 and n_ref % n_j == 0
    multihost = meshes.process_count() > 1
    if mode == "tile2d" and multihost:
        raise ValueError(
            "the tile2d cross plan is single-host; multi-host cross "
            "jobs run replicated (per-process accumulation, additive "
            "merge) — use --gram-mode replicated (or auto), or run on "
            "one host to tile across its chips"
        )
    if mode == "variant":
        mode = "replicated"
    if mode == "auto":
        acc_bytes = 4 * a * n_ref * max(1, n_stats)
        mode = ("tile2d" if not multihost and mesh.size > 1 and divisible
                and acc_bytes > _ACC_BUDGET else "replicated")
    if mode == "tile2d" and not divisible:
        raise ValueError(
            f"cross tile2d needs ({a}, {n_ref}) divisible by the mesh "
            f"{mesh.shape}"
        )
    # graftlint: disable=registry-literal  # the cross plan's OWN two-mode set, not the gram-mode registry: variant mode has no cross analogue (a cross block is consumed once, never accumulated variant-sharded)
    if mode not in ("replicated", "tile2d"):
        raise ValueError(f"unknown cross mode {mode!r}")
    return CrossPlan(mesh, mode)


def _update_cross_tiled(plan: CrossPlan, acc: dict, bn: torch.Tensor,
                        br: torch.Tensor) -> None:
    """Each slot's (rows_i of bn, rows_j of br) cross statistics into its
    own tile, on its own device."""
    mesh = plan.mesh
    for s, (rn, rr, dev) in enumerate(zip(meshes.rows_i(mesh, bn.shape[0]),
                                          meshes.rows_j(mesh, br.shape[0]),
                                          mesh.devices)):
        upd = genotype.cross_stats(bn[rn].to(dev), br[rr].to(dev),
                                   tuple(acc))
        for k in acc:
            acc[k].tiles[s].add_(upd[k])


def _accumulate_cross(job: JobConfig, source_new, source_ref,
                      stats: tuple[str, ...], timer: PhaseTimer,
                      den_metric: str | None = None,
                      plan: CrossPlan | None = None):
    """Stream both cohorts in lockstep and accumulate the cross
    statistics: the engine of projection and cross-kinship. A stream
    that ends first, blocks that cover other variants, or positions that
    differ are errors, never a silent prefix; both feeds are closed
    (their producer threads stopped) however the loop ends.
    ``den_metric``: also fold that dual metric's query denominator
    diagonal into the pass. ``plan``: the :class:`CrossPlan` (the job's
    mesh and ``--gram-mode`` by default); a tile2d plan's accumulators
    are tiled while they stream, then gathered on slot 0. Returns
    (accumulators, n_variants, qden or None)."""
    from spark_examples_tpu_torch.parallel import multihost as mh

    multihost = mh.is_multihost()
    device = resolve_device(job.compute.device)
    a, n_ref = source_new.n_samples, source_ref.n_samples
    bv = job.ingest.block_variants
    depth = job.ingest.prefetch_blocks
    if plan is None:
        mesh = meshes.make_mesh(meshes.default_devices(device),
                                shape=job.compute.mesh_shape)
        plan = cross_plan_for(mesh, a, n_ref, len(stats),
                              job.compute.gram_mode)
    if multihost and plan.mode == "tile2d":
        # cross_plan_for refuses this; only a hand-built CrossPlan gets
        # here, and it would merge tiles no rank owns.
        raise ValueError(
            "the tile2d cross plan is single-host; multi-host cross "
            "jobs run replicated"
        )
    device = plan.mesh.home
    tiled = plan.mode == "tile2d" and plan.mesh.size > 1
    if tiled:
        # Each tile allocated on its own slot's device.
        acc = {k: meshes.Tiled.zeros(plan.mesh, (a, n_ref), torch.int32)
               for k in stats}
    else:
        acc = {k: torch.zeros((a, n_ref), dtype=torch.int32, device=device)
               for k in stats}
    qden = (torch.zeros((a,), dtype=torch.float32, device=device)
            if den_metric is not None else None)
    moment_blocks = []
    n_variants = 0
    n_matmuls = sum(len(genotype.CROSS_STATS[s]) for s in stats)
    with timer.phase("gram"), \
            closing(stream_to_device(source_new, bv, device,
                                     prefetch=depth)) as it_new, \
            closing(stream_to_device(source_ref, bv, device,
                                     prefetch=depth)) as it_ref:
        while True:
            nxt_new = next(it_new, None)
            nxt_ref = next(it_ref, None)
            if (nxt_new is None) != (nxt_ref is None):
                short = "new" if nxt_new is None else "reference"
                raise ValueError(
                    f"the {short} cohort stream ended first — both "
                    "cohorts must carry the same variant set (a silent "
                    "prefix-zip would compute statistics on partial "
                    "data)"
                )
            if nxt_new is None:
                break
            (bn, mn), (br, mr) = nxt_new, nxt_ref
            if (mn.start, mn.stop) != (mr.start, mr.stop):
                raise ValueError(
                    "new/reference streams diverged: new block "
                    f"[{mn.start}, {mn.stop}) vs ref [{mr.start}, "
                    f"{mr.stop}) — both cohorts must carry the same "
                    "variants (same sites, same order)"
                )
            if (
                mn.positions is not None
                and mr.positions is not None
                and not np.array_equal(mn.positions, mr.positions)
            ):
                raise ValueError(
                    f"new/reference positions differ in block "
                    f"[{mn.start}, {mn.stop}) — not the same variant set"
                )
            if tiled:
                _update_cross_tiled(plan, acc, bn, br)
            else:
                update_cross(acc, bn, br)
            if qden is not None:
                qden = _den_diag(qden, bn, den_metric)
            moment_blocks.append(_af_moments(bn, br))
            timer.add("gram_flops",
                      2.0 * a * n_ref * (mn.stop - mn.start) * n_matmuls)
            timer.add("ingest_bytes", bn.numel() + br.numel())
            n_variants = mn.stop
        acc = hard_sync(acc)
    if tiled:
        from spark_examples_tpu_torch.parallel.pcoa_sharded import (
            assert_tiled,
        )

        for k, v in acc.items():
            assert_tiled(v, plan, f"cross accumulator {k!r}")
        # The projection and kinship finalizes read whole rows.
        acc = {k: v.full(device) for k, v in acc.items()}
    # One stacked fetch, then the f64 host reduction.
    moments = (
        torch.stack(moment_blocks).cpu().numpy().astype(np.float64)
        .sum(axis=0)
        if moment_blocks else np.zeros(6, np.float64)
    )
    if multihost:
        # Every statistic is a sum over variants and each rank streamed
        # its own partition: one additive merge gives the one-process
        # result (integer sums exactly; qden's integer-valued f32 sums
        # too, far below 2^24). A rank with an empty partition carries
        # zeros and still joins. The f64 moments ride the control plane.
        acc = mh.reduce_acc(acc, inplace=True)
        if qden is not None:
            qden = mh.allreduce_sum(qden, inplace=True)
        n_variants = int(mh.allgather(np.int64(n_variants)).sum())
        moments = mh.allgather(moments).sum(axis=0)
    if moments[0] > 0:
        _check_af_concordance(moments, a, n_ref)
    return acc, n_variants, qden


def _cross_phi(hh, opp, hcn, hcr) -> torch.Tensor:
    """KING-robust kinship between cohorts (the symmetric 'king'
    finalize with both het counts over pairwise-complete variants). No
    diagonal to pin: rows and columns are different samples, and a phi
    near 0.5 is the finding (one individual in both cohorts)."""
    den = (hcn + hcr).to(torch.float32)
    num = (hh - 2 * opp).to(torch.float32)
    return torch.where(den > 0, num / den, 0.0)


def cross_kinship_job(job: JobConfig, source_new, source_ref):
    """(A, N_ref) KING-robust kinship between two cohorts, the
    cross-dataset QC screen: phi ~ 0.5 flags one individual in both
    cohorts, ~0.25 first-degree relatives, ~0 the unrelated. Both
    cohorts stream once; only the phi matrix comes to the host. The
    sources belong to the caller."""
    timer = PhaseTimer()
    acc, n_variants, _ = _accumulate_cross(
        job, source_new, source_ref, ("hh", "opp", "hcn", "hcr"), timer)
    R._check_int32_budget("king", n_variants, 2)
    with timer.phase("finalize"):
        phi = hard_sync(_cross_phi(acc["hh"], acc["opp"], acc["hcn"],
                                   acc["hcr"])).cpu().numpy()
    # Every rank holds the merged statistics; rank 0 owns the file.
    if job.output_path and meshes.process_index() == 0:
        pio.write_matrix(job.output_path, source_new.sample_ids, phi,
                         kind="similarity",
                         col_ids=source_ref.sample_ids)
    return R.SimilarityResult(
        similarity=phi,
        distance=np.maximum(0.5 - phi, 0.0),
        sample_ids=source_new.sample_ids,
        metric="king",
        timer=timer,
        n_variants=n_variants,
    )


@ieee_f32()
def _project(acc, d2_colmean, d2_grand, eigvecs, eigvals, metric: str):
    """Gower out-of-sample projection: the kernel's cross squared
    distance (``CrossSpec.d2``), centered with the panel's statistics,
    then ``b @ V / sqrt(lambda)``, all in f32 in the JAX package's
    order."""
    d2 = kernels.get(metric).cross.d2(acc)
    b = -0.5 * (
        d2
        - d2.mean(dim=1, keepdim=True)
        - d2_colmean[None, :]
        + d2_grand
    )
    return (b @ eigvecs) / torch.sqrt(eigvals)[None, :]


@ieee_f32()
def _project_pca(s, s_colmean, s_grand, eigvecs):
    """PCA out-of-sample: center the cross similarity row with the
    panel's column and grand means, then project onto V; a panel row
    gives c_row V = lambda v_row, its fitted coordinates."""
    sf = s.to(torch.float32)
    c = sf - sf.mean(dim=1, keepdim=True) - s_colmean[None, :] + s_grand
    return c @ eigvecs


@ieee_f32()
def _project_factorized_dual(acc, qden, scale, scale_floor, colmean,
                             grand, eigvecs, eigvals, metric: str):
    """Factorized pcoa-family projection: the cross numerator scaled by
    both denominator diagonals is the scaled similarity s~ (self-
    similarity 1), whose Gower centering is ``s~ - rowmean - colmean +
    grand``; then ``(b @ V) / sqrt(lambda)``. The query scale takes the
    floor the fit gave the panel's."""
    num = kernels.get(metric).cross.num(acc)
    aq = torch.clamp(torch.sqrt(torch.clamp(qden, min=0.0)),
                     min=scale_floor)
    s = num / (aq[:, None] * scale[None, :])
    b = s - s.mean(dim=1, keepdim=True) - colmean[None, :] + grand
    return (b @ eigvecs) / torch.sqrt(eigvals)[None, :]


def pcoa_project_job(job: JobConfig, model_path: str, source_new,
                     source_ref) -> CoordsOutput:
    """Project ``source_new``'s samples into a fitted panel's space.

    Both sources must stream the same variants in the same order (both
    cohorts genotyped at the panel's sites); block spans and, where
    known, positions are checked as the streams are zipped. The model
    and the panel are checked before anything streams. The sources
    belong to the caller."""
    model = load_model(model_path)
    stats = check_projectable(model)
    check_reference_panel(model, source_ref)
    device = resolve_device(job.compute.device)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    eigvecs, eigvals = f32(model.eigvecs), f32(model.eigvals)
    colmean, grand = f32(model.colmean), f32(model.grand)
    metric = model.metric
    # Factorized models project by family: pca through the exact pca
    # formula, pcoa with the query denominator folded into the pass.
    family = getattr(model, "family", model.kind)
    needs_qden = model.kind == "factorized" and family == "pcoa"

    timer = PhaseTimer()
    acc, n_variants, qden = _accumulate_cross(
        job, source_new, source_ref, stats, timer,
        den_metric=metric if needs_qden else None)
    R._check_int32_budget(metric, n_variants, 2)
    # Finalize, center and project on the device; only the (A, k)
    # coordinates come home.
    with timer.phase("eigh"):
        if family == "pca":
            coords = _project_pca(acc["s"], colmean, grand, eigvecs)
        elif needs_qden:
            coords = _project_factorized_dual(
                acc, qden, f32(model.scale), f32(model.scale_floor),
                colmean, grand, eigvecs, eigvals, metric)
        else:
            coords = _project(acc, colmean, grand, eigvecs, eigvals,
                              metric)
        coords = hard_sync(coords).cpu().numpy()
    out = CoordsOutput(source_new.sample_ids, coords,
                       eigvals.cpu().numpy(), timer, n_variants)
    if job.output_path and meshes.process_index() == 0:
        pio.write_coords_tsv(job.output_path, out.sample_ids, out.coords)
    return out
