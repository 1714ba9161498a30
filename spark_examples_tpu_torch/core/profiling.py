"""Per-phase wall-clock timing.

PyTorch returns from a CUDA call before the device has finished it, so
a phase that ends without a barrier times the enqueue, not the work.
:func:`hard_sync` is that barrier; the job routes call it on whatever a
phase produced before the phase closes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field

import torch


def _tensors(tree):
    """Every tensor inside a (nested) dict / list / tuple / dataclass."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def hard_sync(tree):
    """A real completion barrier: ``torch.cuda.synchronize()`` on each
    CUDA device holding a tensor of ``tree``, a no-op for CPU tensors
    (CPU ops have finished when they return). Returns its argument."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


@dataclass
class PhaseTimer:
    """Accumulates named phase durations (seconds) and counters."""

    phases: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt

    def add(self, counter: str, amount: float) -> None:
        self.counters[counter] = self.counters.get(counter, 0.0) + amount

    def report(self) -> dict:
        rep: dict[str, float] = dict(self.phases)
        rep.update(self.counters)
        gram_s = self.phases.get("gram", 0.0)
        if gram_s > 0:
            rep["gram_gflops"] = self.counters.get("gram_flops", 0.0) / gram_s / 1e9
            rep["ingest_mb_s"] = (self.counters.get("ingest_bytes", 0.0)
                                  / gram_s / 1e6)
        eigh_s = self.phases.get("eigh", 0.0)
        if eigh_s > 0:
            rep["eigh_gflops"] = self.counters.get("eigh_flops", 0.0) / eigh_s / 1e9
        return rep
