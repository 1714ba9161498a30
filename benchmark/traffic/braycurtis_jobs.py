"""Whole Bray-Curtis PCoA jobs of the port, back to back, over one count
table: a closed loop with one caller, as a microbiome analysis reruns
a study's table.

Each job is ``spark_examples_tpu_torch.pipelines.jobs.pcoa_job`` under
the mix's ``JobConfig`` with the table as its ``source``, a
``CountTableSource`` holding the table as CSR in host memory (the only
``feed`` this generator has, ``memory``), and ends with its coordinates
on the host. The table is the configuration's, drawn on the card from
the seed (``benchmark/community.py``); the reference reads the same CSR
arrays the jobs read.

Mix parameters: ``feed``, ``metric``, ``braycurtis_method``, ``num_pc``,
``solver``, ``eigh_mode`` and ``device`` (the job's ``--device``).
"""

from __future__ import annotations

from benchmark.community import Community
from benchmark.reference.braycurtis_ref import Reference
from benchmark.reference.compare import NAMES, judge
from benchmark.traffic import pcoa_jobs
from spark_examples_tpu_torch.core.config import ComputeConfig, JobConfig
from spark_examples_tpu_torch.ingest.table import CountTableSource


class Traffic(pcoa_jobs.Traffic):
    """One run's table and jobs: ``setup`` (the table, one warm job),
    ``run_window``, then ``check`` against the reference and
    ``close``."""

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        if mix["feed"] != "memory":
            raise ValueError(f"a count table is fed from memory, got "
                             f"feed {mix['feed']!r}")
        super().__init__(config, mix, seed, device)

    def setup(self) -> None:
        cfg, mix = self.config, self.mix
        community = Community(cfg, self.seed, self.home)
        indptr, indices, counts = community.csr()
        self._source = CountTableSource(
            indptr, indices, counts, int(cfg["n_features"]),
            ids=community.sample_ids)
        del community
        self.job = JobConfig(
            compute=ComputeConfig(metric=mix["metric"],
                                  braycurtis_method=mix["braycurtis_method"],
                                  num_pc=int(mix["num_pc"]),
                                  solver=mix["solver"],
                                  eigh_mode=mix["eigh_mode"],
                                  device=self.device))
        pcoa_jobs._empty_cache()
        self._run_one()  # warms every shape the window's jobs use

    def check(self, window) -> dict[str, float]:
        """Every job's worst reading of each number against the
        reference, built from the source's CSR arrays after the
        program's state is freed."""
        pcoa_jobs._empty_cache()
        src = self._source
        ref = Reference(src.indptr, src.indices, src.counts,
                        src.n_features, int(self.mix["num_pc"]), self.home)
        worst = {name: 0.0 for name in NAMES}
        for job in window.jobs:
            for name, val in judge(ref, job.coords, job.vals).items():
                worst[name] = max(worst[name], val)
        return worst

