"""Importing this package registers every analyzer with the engine.

One module per invariant family, as in ``tools/graftlint/rules``; each
rule's docstring names the historical regression it distills and, where
the port checks another form of it, what that form is."""

from spark_examples_tpu_torch.tools.graftlint.rules import (  # noqa: F401
    atomic_write,
    donation,
    jax_purity,
    locks,
    names,
    registry_literal,
    threads,
)
