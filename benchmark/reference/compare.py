"""The comparison that decides ``correct`` for a PCoA job, and its
control.

A job returns the top-k eigenvalues ``lam`` and the coordinates
``X = V diag(sqrt(lam))`` of the centered matrix; its distance matrix
never leaves the device. So the job is judged by whether ``(lam, V)``
are the top-k eigenpairs of the reference's ``B``, which the reference
builds from the cohort's bytes without the program. A fault anywhere on
the path (counts, finalize, centering, eigensolve, the coordinates'
scaling) moves at least one of three numbers, each relative to the
reference's largest eigenvalue ``lam_1`` where it has a scale:

- ``eig_gap``: ``max_k |lam_k - lam_ref_k| / lam_ref_1``;
- ``resid``: ``max_k ||B v_k - lam_k v_k|| / lam_ref_1``, with
  ``v_k = X_k / sqrt(lam_k)``: each pair is an eigenpair of ``B``;
  well posed where eigenvalues lie close together, where ``v_k`` itself
  is not;
- ``orth``: ``max |V^T V - I|``: the columns are orthonormal, so the
  coordinates carry the right scale.

The control is the reference put in the program's place one precision
below the configuration's float32: distances, squares and centering in
bfloat16 (the eigensolve of that matrix in float32, which
``torch.linalg.eigh`` needs), the outputs rounded to bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.pcoa_ref import gower_center, ibs_distance

NAMES = ("eig_gap", "resid", "orth")


def judge(ref, coords: np.ndarray, vals: np.ndarray) -> dict[str, float]:
    """The three numbers of one job's output against ``ref``
    (:class:`~benchmark.reference.pcoa_ref.Reference`); ``inf`` for an
    output of the wrong shape or with a non-finite entry."""
    n, k = ref.b.shape[0], ref.vals.shape[0]
    coords, vals = np.asarray(coords), np.asarray(vals)
    if (coords.shape != (n, k) or vals.shape != (k,)
            or not (np.isfinite(coords).all() and np.isfinite(vals).all())):
        return {name: math.inf for name in NAMES}
    dev = ref.b.device
    lam = torch.as_tensor(vals, dtype=torch.float64, device=dev)
    x = torch.as_tensor(coords, dtype=torch.float64, device=dev)
    scale = ref.vals[0]
    v = x / torch.sqrt(lam.clamp(min=torch.finfo(torch.float64).tiny))
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    out = {
        "eig_gap": (lam - ref.vals).abs().max() / scale,
        "resid": (ref.b @ v - v * lam).norm(dim=0).max() / scale,
        "orth": (v.T @ v - eye).abs().max(),
    }
    return {name: float(val) for name, val in out.items()}


def control_outputs(ref) -> tuple[np.ndarray, np.ndarray]:
    """The control's ``(coords, vals)``: the reference's counts finalized,
    squared and centered in bfloat16."""
    k = ref.vals.shape[0]
    d = ibs_distance(ref.d1, ref.m, torch.float32).to(torch.bfloat16)
    b = gower_center(d)
    del d
    vals, vecs = torch.linalg.eigh(b.float())
    del b
    vals, vecs = vals.flip(0)[:k], vecs.flip(1)[:, :k]
    coords = vecs * torch.sqrt(vals.clamp(min=0.0))
    return (coords.to(torch.bfloat16).double().cpu().numpy(),
            vals.to(torch.bfloat16).double().cpu().numpy())
