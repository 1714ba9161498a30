"""Coverage: per-base read depth over genomic ranges (the reads example
tier).

Each batch of reads becomes a difference array on the job's device: +1
at every read start and -1 one past its end, scattered with
``index_add_`` into an f32 array with a sentinel slot for ends past the
range. Per-base depth is one ``cumsum``. The values are small integers
(exact in f32 while depth < 2^24), so the scatter order and the scan's
summation order cannot change them: the depth equals the JAX package's
bit for bit, on either device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_examples_tpu_torch.core.config import ReferenceRange
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.ingest.reads import ReadsSource


def diff_accumulate(diff: torch.Tensor, starts: np.ndarray,
                    lengths: np.ndarray, offset: int) -> torch.Tensor:
    """Scatter one batch's +1/-1 read boundaries into ``diff`` (span + 1
    slots, f32, in place): starts clip into ``[0, span)``, exclusive
    ends into ``[0, span]`` (index ``span`` is the sentinel)."""
    span = diff.shape[0] - 1
    s = torch.from_numpy(np.asarray(starts, np.int64)).to(diff.device)
    ln = torch.from_numpy(np.asarray(lengths, np.int64)).to(diff.device)
    e = torch.clamp(s + ln - offset, 0, span)
    s = torch.clamp(s - offset, 0, span - 1)
    diff.index_add_(0, s, torch.ones(s.shape, dtype=diff.dtype,
                                     device=diff.device))
    diff.index_add_(0, e, torch.full(e.shape, -1.0, dtype=diff.dtype,
                                     device=diff.device))
    return diff


def depth_from_diff(diff: torch.Tensor) -> torch.Tensor:
    """Per-base depth: the inclusive scan of the difference array
    without its sentinel slot."""
    return torch.cumsum(diff[:-1], dim=0)


@dataclass
class CoverageResult:
    reference: ReferenceRange
    depth: np.ndarray  # per-base coverage (f32), len = range span
    n_reads: int

    @property
    def mean(self) -> float:
        return float(self.depth.mean()) if self.depth.size else 0.0

    def histogram(self, max_depth: int = 100) -> np.ndarray:
        return np.bincount(
            np.minimum(self.depth.astype(np.int64), max_depth),
            minlength=max_depth + 1,
        )


def coverage(source: ReadsSource, batch: int = 262144,
             device: str = "cuda") -> list[CoverageResult]:
    """Per-base coverage for every range of the source, on ``device``."""
    dev = resolve_device(device)
    out = []
    for ref in source.ranges():
        span = ref.end - ref.start
        diff = torch.zeros(span + 1, dtype=torch.float32, device=dev)
        n_reads = 0
        for starts, lengths in source.read_batches(ref, batch):
            diff_accumulate(diff, starts, lengths, ref.start)
            n_reads += len(starts)
        depth = depth_from_diff(diff).cpu().numpy()
        out.append(CoverageResult(ref, depth, n_reads))
    return out
