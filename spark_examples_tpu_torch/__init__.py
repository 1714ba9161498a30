"""PyTorch/CUDA port of spark_examples_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout module for module, so the
counterpart of ``spark_examples_tpu/ops/gram.py`` is
``spark_examples_tpu_torch/ops/gram.py``. It imports ``torch`` and
numpy only: nothing of JAX and nothing of the JAX package, which stays
the reference that the tests hold this package against.

Entry point: ``python -m spark_examples_tpu_torch {pcoa,pca,similarity,pack}``.
Every entry point runs on the CUDA device unless the caller asks for the
CPU (``--device cpu`` / ``device="cpu"``).
"""

__version__ = "0.1.0"
