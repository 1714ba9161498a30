"""Streaming sketch solver: PCoA/PCA at 100k+ samples, no N x N.

The accuracy ladder (``--solver``, ``core.config.SOLVER_LADDER``):

- ``sketch``    — one streamed pass folds a low-rank range sketch
                  ``Y = B @ Omega`` into (N, rank) state; single-pass
                  Nystrom eigenpairs. O(N * rank) solver memory.
- ``corrected`` — ``sketch`` plus ``--sketch-iters`` extra streamed
                  passes (subspace-iteration power steps) and a
                  Rayleigh solve.
- ``exact``     — the dense route (materialized N x N, dense or
                  randomized eigh); it never reaches this package.

Modules: :mod:`~spark_examples_tpu_torch.solvers.sketch` (the streamed
state and its block update), :mod:`~spark_examples_tpu_torch.solvers.solve`
(CholeskyQR2, Nystrom and Rayleigh solves),
:mod:`~spark_examples_tpu_torch.solvers.driver` (passes, checkpoints,
the ladder: what ``pipelines/jobs.py`` calls).
"""

from spark_examples_tpu_torch.solvers.driver import (
    SketchSolveResult,
    run_sketch_solve,
)

__all__ = ["SketchSolveResult", "run_sketch_solve"]
