"""The benchmark of ``spark_examples_tpu_torch`` on NVIDIA H100 cards.

``benchmark/run.py`` runs one cell of ``BENCHMARK.json``: it makes the
cell's cohort from the seed, warms the job's shapes, runs whole jobs of
the program for the window, reads the cell's metrics and judges the
jobs' outputs against the plain reference in ``benchmark/reference/``.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by name:

- ``configs/<config>.json``: the cohort (samples, variants, groups,
  drift, missing calls) with its source, cuts and assumptions;
- ``traffic/<traffic>.json``: a mix's parameters, read by the
  generator it names (``traffic/<generator>.py``);
- ``workloads/<cell>.json``: the cell (configuration, traffic, chips,
  why) and the limits of its output comparison;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``,
  None where it finds nothing to read (the run leaves the metric out).

Nothing here imports ``jax`` or the JAX package.
"""
