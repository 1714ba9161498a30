"""The mesh routes: the sharded gram accumulation (``gram_sharded``) and
the tile2d finalize, centering and eigensolve (``pcoa_sharded``)."""

from spark_examples_tpu_torch.parallel.gram_sharded import (  # noqa: F401
    GramPlan,
    init_sharded,
    make_update,
    plan_for,
)
