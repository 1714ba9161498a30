"""Sparse nearest neighbors: a streamed MinHash pass on the device, LSH
candidate filtering and exact top-k evaluation on the host (engine.py
tells the three stages). The output formats and the LSH math are
host-only; torch is imported by the stages that need it.
"""

from spark_examples_tpu_torch.neighbors.output import (  # noqa: F401
    NeighborFormatError,
    PairsResult,
    TopKResult,
    load_result,
    save_result,
)
