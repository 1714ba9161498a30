"""Whole IBS PCoA jobs of the port, back to back, over one cohort: a
closed loop with one caller, as a pipeline or a notebook reruns a
cohort.

Each job is ``spark_examples_tpu_torch.pipelines.jobs.pcoa_job`` (the
``pcoa`` verb's entry) under the mix's ``JobConfig`` and ends with its
coordinates on the host. The mix's ``feed`` says where the cohort lives:

- ``store``: a 2-bit packed store written once in set-up under the
  run's temporary directory; each job opens it (``--source packed``);
- ``memory``: the packed cohort in host memory, handed to every job as
  its ``source``.

Mix parameters: ``feed``, ``block_variants``, ``prefetch_blocks``,
``metric``, ``num_pc``, ``solver``, ``eigh_mode`` and ``device`` (the
job's ``--device``).
"""

from __future__ import annotations

import shutil
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.cohort import Cohort
from benchmark.reference.compare import NAMES, judge
from benchmark.reference.pcoa_ref import Reference
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.ingest.packed import Packed2BitSource
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job

FEEDS = ("store", "memory")


@dataclass
class Job:
    phases: dict
    coords: np.ndarray
    vals: np.ndarray
    wall_s: float


@dataclass
class Window:
    jobs: list[Job] = field(default_factory=list)
    seconds: float = 0.0
    failed: int = 0
    error: str | None = None

    @property
    def attempted(self) -> int:
        return len(self.jobs) + self.failed


class Traffic:
    """One run's cohort and jobs: ``setup`` (cohort, store, one warm
    job), ``run_window``, then ``check`` against the reference and
    ``close``."""

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        if mix["feed"] not in FEEDS:
            raise ValueError(f"feed must be one of {FEEDS}, got "
                             f"{mix['feed']!r}")
        self.config, self.mix, self.seed = config, mix, seed
        self.device = device
        # The first card makes the cohort and runs the reference.
        self.home = torch.device("cuda", 0) if device == "cuda" else \
            torch.device(device)
        self.packed: np.ndarray | None = None
        self._source = None
        self._dir: str | None = None

    def setup(self) -> None:
        cfg, mix = self.config, self.mix
        cohort = Cohort(cfg, self.seed, self.home)
        ingest = dict(block_variants=int(mix["block_variants"]),
                      prefetch_blocks=int(mix["prefetch_blocks"]))
        if mix["feed"] == "store":
            self._dir = tempfile.mkdtemp(prefix="pcoabench-")
            self.packed = cohort.write_store(self._dir)
            ingest.update(source="packed", path=self._dir)
        else:
            self.packed = cohort.to_host()
            self.packed.flags.writeable = False
            self._source = Packed2BitSource(
                packed=self.packed, v=cohort.n_variants,
                ids=cohort.sample_ids, contig=cfg.get("contig"))
        del cohort
        self.job = JobConfig(
            ingest=IngestConfig(**ingest),
            compute=ComputeConfig(metric=mix["metric"],
                                  num_pc=int(mix["num_pc"]),
                                  solver=mix["solver"],
                                  eigh_mode=mix["eigh_mode"],
                                  device=self.device))
        _empty_cache()
        self._run_one()  # warms every shape the window's jobs use

    def _run_one(self) -> Job:
        t0 = time.perf_counter()
        out = pcoa_job(self.job, source=self._source)
        return Job(dict(out.timer.phases), out.coords, out.eigenvalues,
                   time.perf_counter() - t0)

    def run_window(self, seconds: float) -> Window:
        """Whole jobs until the first that ends after ``seconds``; a job
        that raises ends the window."""
        win = Window()
        t0 = time.perf_counter()
        while True:
            try:
                win.jobs.append(self._run_one())
            except Exception as e:  # the run reports it, not correct
                win.failed += 1
                win.error = f"{type(e).__name__}: {e}"
                break
            if time.perf_counter() - t0 >= seconds:
                break
        win.seconds = time.perf_counter() - t0
        return win

    def check(self, window: Window) -> dict[str, float]:
        """Every job's worst reading of each number against the
        reference, built after the program's state is freed."""
        _empty_cache()
        ref = Reference(self.packed, int(self.mix["num_pc"]), self.home)
        worst = {name: 0.0 for name in NAMES}
        for job in window.jobs:
            for name, val in judge(ref, job.coords, job.vals).items():
                worst[name] = max(worst[name], val)
        return worst

    def close(self) -> None:
        self._source = None
        self.packed = None
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


def _empty_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
