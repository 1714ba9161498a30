"""Host-side utilities: the NumPy oracle (``--backend cpu-reference``)."""

from spark_examples_tpu_torch.utils import oracle  # noqa: F401
