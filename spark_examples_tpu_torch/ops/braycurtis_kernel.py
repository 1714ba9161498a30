"""The pairwise Manhattan contraction behind Bray-Curtis: (N, F) f32 in,
(N, N) f32 ``sum_f |x_i - x_j|`` out.

Counterpart of ``spark_examples_tpu/ops/pallas/braycurtis_kernel.py``.

- :func:`pairwise_manhattan_kernel` is the wrapper the Bray-Curtis job
  calls. For a CUDA tensor it launches the hand-written kernel
  ``csrc/braycurtis.cu`` (built at first use, see ``ops/cuda_build.py``)
  or raises; for a CPU tensor, and only for that, it runs the plain
  version, ``ops.distances.pairwise_manhattan``.
- :func:`braycurtis_kernel` divides the numerator by the row-total sums
  (``ops.distances.bc_from_manhattan``).

``launches`` counts the CUDA kernel's launches (one per call on a CUDA
tensor), so a run can show that its main path went through the kernel;
each launch also counts ``kernel.braycurtis.launches`` in the telemetry,
so a job run as a subprocess exports it, and is timed on the card by
the device span ``kernel.braycurtis.launch`` (read at the next
barrier).
"""

from __future__ import annotations

import ctypes

import torch

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.profiling import device_span
from spark_examples_tpu_torch.ops import distances

# ``braycurtis_manhattan``'s parameters before its stream: x, out, n, f.
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)

launches = 0


def _check_input(x) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x)}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (samples, features), got shape "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise TypeError(f"x must be float32 on CUDA, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")


def _launch(x: torch.Tensor) -> torch.Tensor:
    global launches
    n, f = x.shape
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    from spark_examples_tpu_torch.ops import cuda_build

    with device_span("kernel.braycurtis.launch", x.device):
        cuda_build.launch("braycurtis", "braycurtis_manhattan", _ARGTYPES,
                          x.device, (x.data_ptr(), out.data_ptr(), n, f),
                          "braycurtis Manhattan kernel",
                          f"at x {tuple(x.shape)}")
    launches += 1
    telemetry.count("kernel.braycurtis.launches")
    return out


def pairwise_manhattan_kernel(x: torch.Tensor) -> torch.Tensor:
    """``(N, F) -> (N, N) sum_f |x_i - x_j|`` in f32: the CUDA kernel for
    a CUDA tensor (float32, contiguous), the plain version for a CPU
    tensor."""
    _check_input(x)
    if x.device.type == "cpu":
        return distances.pairwise_manhattan(x)
    return _launch(x)


def braycurtis_kernel(x: torch.Tensor) -> torch.Tensor:
    """Bray-Curtis through :func:`pairwise_manhattan_kernel` (see
    ``ops.distances.braycurtis`` for the metric and its conventions)."""
    num = pairwise_manhattan_kernel(x)
    return distances.bc_from_manhattan(num, x.to(torch.float32).sum(dim=1))
