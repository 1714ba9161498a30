"""The factorized model: a sketch-rung fit saved so that new samples
project against its rank-k basis, with no N x N anywhere.

The exact routes save models whose centering statistics come from the
materialized N x N matrix, which the sketch rungs never build. The
factorized model persists instead the basis, the eigenvalues and the
centering statistics the sketch solver streams in its variant pass
(``solvers/sketch.py``'s ``cm`` leaf), and a query projects as an (A, k)
product. One ``kind="factorized"`` archive, two families:

- ``family="pca"``: pca-family factor metrics (shared-alt). The model
  holds V, lambda and the similarity's column/grand means; projection is
  the exact pca model's formula (``pipelines/project.py::_project_pca``).
- ``family="pcoa"``: ratio (dual-sketch) metrics on the corrected rung.
  The model also holds the denominator's rank-1 scale diagonal ``a`` and
  its floor, so a query row's scaled similarity ``NUM_qj / (a_q a_j)``
  (self-similarity 1) Gower-centers with the stored means and projects
  as ``(b @ V) / sqrt(lambda)``.

:meth:`FactorizedModel.digest` hashes the rung, the sketch rank and the
probe seed beside the arrays: two fits that differ only in rung never
share a digest. The archive is the JAX package's
(``models/factorized.py``), field for field, so either package loads
the other's models.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.pipelines.project import (
    SCHEMA_VERSION,
    ModelFormatError,
)

FAMILIES = ("pca", "pcoa")

# Required archive members (beyond schema_version); the pcoa family
# additionally persists the denominator scale diagonal and its floor.
_REQUIRED = ("kind", "family", "metric", "eigvecs", "eigvals",
             "colmean", "grand", "sample_ids", "solver", "rank", "seed")
_REQUIRED_PCOA = ("scale", "scale_floor")


@dataclass(frozen=True)
class FactorizedModel:
    """A loaded, validated factorized model: what the factorized
    projection (pipelines/project.py) needs. Arrays are float64 as
    persisted; the projection casts them to f32 on the device, as for
    the dense ProjectionModel.
    """

    kind: str      # always "factorized"
    family: str    # "pca" | "pcoa" (which projection formula applies)
    metric: str
    eigvecs: np.ndarray   # (N, k) basis
    eigvals: np.ndarray   # (k,)
    colmean: np.ndarray   # (N,) streamed centering column means
    grand: float
    sample_ids: list[str]
    solver: str    # accuracy-ladder rung that fitted the basis
    rank: int      # sketch rank (probe columns)
    seed: int      # probe RNG seed
    scale: np.ndarray | None = None  # (N,) denominator diag a; pcoa only
    scale_floor: float = 0.0
    schema_version: int = SCHEMA_VERSION

    @property
    def n_ref(self) -> int:
        return int(self.eigvecs.shape[0])

    @property
    def n_components(self) -> int:
        return int(self.eigvecs.shape[1])

    def digest(self) -> str:
        """Content fingerprint. Unlike the dense model's digest, the
        rung's provenance (solver, rank, seed) is hashed too: a refit at
        another rank is another model even where the arrays agree at
        this precision."""
        h = hashlib.sha256()
        h.update(
            f"{self.kind}:{self.family}:{self.metric}:{self.solver}:"
            f"{self.rank}:{self.seed}:{self.schema_version}".encode()
        )
        for a in (self.eigvecs, self.eigvals, self.colmean):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.float64(self.grand).tobytes())
        if self.scale is not None:
            h.update(np.ascontiguousarray(self.scale).tobytes())
            h.update(np.float64(self.scale_floor).tobytes())
        return h.hexdigest()[:16]


def save_factorized_model(
    path: str,
    *,
    family: str,
    metric: str,
    eigenvectors: np.ndarray,
    eigenvalues: np.ndarray,
    colmean: np.ndarray,
    grand: float,
    sample_ids: list[str],
    solver: str,
    rank: int,
    seed: int,
    scale: np.ndarray | None = None,
    scale_floor: float = 0.0,
) -> None:
    """Persist a sketch-rung fit as a factorized model.

    ``eigenvectors`` is the RAW basis V (the sketch drivers hold it
    directly — no coords/lambda recovery division). Components are
    dropped by the same keep rules the dense savers apply: pca keeps
    ``|lambda| > 1e-12``, pcoa keeps ``lambda > 0`` (negative-inertia
    axes carry no metric information and sqrt(lambda) is undefined).
    """
    if family not in FAMILIES:
        raise ValueError(
            f"factorized model family must be one of {FAMILIES}, "
            f"got {family!r}"
        )
    vals = np.asarray(eigenvalues, np.float64)
    vecs = np.asarray(eigenvectors, np.float64)
    keep = (np.abs(vals) > 1e-12) if family == "pca" else (vals > 0)
    payload = dict(
        schema_version=np.int64(SCHEMA_VERSION),
        kind=np.asarray("factorized"),
        family=np.asarray(family),
        metric=np.asarray(metric),
        eigvecs=vecs[:, keep],
        eigvals=vals[keep],
        colmean=np.asarray(colmean, np.float64),
        grand=np.float64(grand),
        sample_ids=np.asarray(sample_ids),
        solver=np.asarray(solver),
        rank=np.int64(rank),
        seed=np.int64(seed),
    )
    if family == "pcoa":
        if scale is None:
            raise ValueError(
                "a pcoa-family factorized model needs the denominator "
                "scale diagonal (scale=) — the fit's state['scale']"
            )
        payload["scale"] = np.asarray(scale, np.float64)
        payload["scale_floor"] = np.float64(scale_floor)
    np.savez(path, **payload)


def parse_factorized(mdl, path: str, version: int) -> FactorizedModel:
    """Decode an open ``kind="factorized"`` npz into a validated
    :class:`FactorizedModel` — called by ``project.load_model``'s kind
    dispatch with the archive already open and schema-gated, so only
    the factorized-specific rungs of the error ladder live here."""
    names = set(mdl.files)
    family = str(mdl["family"]) if "family" in names else None
    if family is not None and family not in FAMILIES:
        raise ModelFormatError(
            f"model file {path!r} has unknown factorized family "
            f"{family!r} (supported: {FAMILIES})"
        )
    required = _REQUIRED + (_REQUIRED_PCOA if family == "pcoa" else ())
    missing = [k for k in required if k not in names]
    if missing:
        raise ModelFormatError(
            f"model file {path!r} (kind='factorized', schema_version "
            f"{version}) is missing required field(s) {missing} — "
            "truncated save or a file from an incompatible build; "
            "refit with --save-model on the sketch ladder"
        )
    pcoa = family == "pcoa"
    return FactorizedModel(
        kind="factorized",
        family=family,
        metric=str(mdl["metric"]),
        eigvecs=np.asarray(mdl["eigvecs"], np.float64),
        eigvals=np.asarray(mdl["eigvals"], np.float64),
        colmean=np.asarray(mdl["colmean"], np.float64),
        grand=float(mdl["grand"]),
        sample_ids=[str(s) for s in mdl["sample_ids"]],
        solver=str(mdl["solver"]),
        rank=int(mdl["rank"]),
        seed=int(mdl["seed"]),
        scale=np.asarray(mdl["scale"], np.float64) if pcoa else None,
        scale_floor=float(mdl["scale_floor"]) if pcoa else 0.0,
        schema_version=version,
    )


def check_factorized_projectable(model: FactorizedModel) -> tuple[str, ...]:
    """The factorized half of ``project.check_projectable``: which
    cross statistics to stream for this model, or a ValueError naming
    why it cannot project. Registry-derived, like the dense table."""
    kern = kernels.maybe_get(model.metric)
    if model.family == "pca":
        spec = kern.sketch if kern is not None else None
        if not (isinstance(spec, kernels.FactorSketch) and spec.pca_family):
            raise ValueError(
                f"factorized pca model of metric {model.metric!r} is "
                "not projectable: the metric is not a pca-family "
                "factor kernel"
            )
        # The similarity cross statistic — same row as the dense
        # PROJECTABLE table's ("pca", "shared-alt") entry.
        return ("s",)
    if (kern is None or kern.cross is None or kern.cross.num is None):
        raise ValueError(
            f"factorized pcoa model of metric {model.metric!r} is not "
            "projectable: the metric declares no cross numerator "
            f"(savable sketch metrics: "
            f"{' | '.join(kernels.factorized_savable_names())})"
        )
    return kern.cross.stats
