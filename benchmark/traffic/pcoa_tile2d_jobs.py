"""Whole IBS PCoA jobs of the port over a tile2d mesh, back to back,
over one cohort: ``pcoa_jobs``'s closed loop with one caller, each job
told its route so that it cannot change silently, and judged against
the tiled reference (``reference/pcoa_ref_tiled.py``).

Mix parameters: those of ``pcoa_jobs`` and ``gram_mode``,
``mesh_shape``, ``tile2d_transport``, ``eigh_iters`` and
``eigh_oversample`` (the job's ``--gram-mode`` and so on). On ``cuda``
the mesh's slots are the run's visible cards, one a slot; on the CPU
the same mesh runs over as many virtual slots of the one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

from benchmark.reference.compare import NAMES, judge
from benchmark.reference.pcoa_ref_tiled import TiledReference, devices_for
from benchmark.traffic import pcoa_jobs
from spark_examples_tpu_torch.core import virtual

ROUTE_KEYS = ("gram_mode", "tile2d_transport", "eigh_iters",
              "eigh_oversample")


class Traffic(pcoa_jobs.Traffic):
    """``pcoa_jobs.Traffic`` with the mix's route in every job and the
    tiled reference in :meth:`check`."""

    def _scope(self):
        if self.device == "cuda":
            return contextlib.nullcontext()
        return virtual.virtual_slots(math.prod(self.mix["mesh_shape"]))

    def _run_one(self) -> pcoa_jobs.Job:
        compute = self.job.compute
        route = {k: self.mix[k] for k in ROUTE_KEYS}
        route["mesh_shape"] = tuple(self.mix["mesh_shape"])
        if any(getattr(compute, k) != v for k, v in route.items()):
            self.job = self.job.replace(
                compute=dataclasses.replace(compute, **route))
        with self._scope():
            return super()._run_one()

    def check(self, window: pcoa_jobs.Window) -> dict[str, float]:
        """Every job's worst reading of each number against the tiled
        reference, built after the program's state is freed."""
        pcoa_jobs._empty_cache()
        return worst(TiledReference(self.packed, int(self.mix["num_pc"]),
                                    devices_for(self.device)), window.jobs)


def worst(ref, jobs) -> dict[str, float]:
    """The largest of each of ``compare.judge``'s numbers over ``jobs``
    against ``ref``."""
    out = {name: 0.0 for name in NAMES}
    for job in jobs:
        for name, val in judge(ref, job.coords, job.vals).items():
            out[name] = max(out[name], val)
    return out
