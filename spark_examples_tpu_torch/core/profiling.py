"""Per-phase wall-clock timing and the profiler capture.

PyTorch returns from a CUDA call before the device has finished it, so
a phase that ends without a barrier times the enqueue, not the work.
:func:`hard_sync` is that barrier; the job routes call it on whatever a
phase produced before the phase closes.

:class:`PhaseTimer` mirrors every phase into the telemetry registry (a
``phase.<name>`` span on the trace timeline and a counter of summed
seconds) and every counter it adds, and reports its derived throughputs
through :func:`telemetry.derive_throughputs`, the formula the exported
``metrics.json`` uses too. :func:`trace` (``--trace-dir``) captures a
``torch.profiler`` trace of a whole job, in which each phase is a named
range (``phase.<name>``). :func:`check_nans` is ``--debug-nans``: a NaN
check at the job's phase boundaries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.meshes import Tiled


def _tensors(tree):
    """Every tensor inside a (nested) dict / list / tuple / dataclass,
    every tile of a tiled leaf this process holds included."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Tiled):
        yield from (t for _, t in tree.local())
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
    CUDA device holding a tensor (or a tile) of ``tree``, so every slot
    of a mesh has finished; a no-op for CPU tensors
    (CPU ops have finished when they return). Returns its argument."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


# --debug-nans (set by the CLI): PyTorch has no counterpart of
# jax_debug_nans, which traps the first NaN-producing primitive, so the
# port checks what each phase produced instead.
_DEBUG_NANS = False


def set_debug_nans(on: bool) -> None:
    global _DEBUG_NANS
    _DEBUG_NANS = bool(on)


def check_nans(phase: str, *trees) -> None:
    """With ``--debug-nans``, raise ``FloatingPointError`` naming
    ``phase`` when a floating tensor or array in ``trees`` holds a NaN
    (NaN only, as ``jax_debug_nans``: an inf passes). The phases checked
    are finalize, distance, centering, eigh, the sketch outputs and a
    served batch. Off, it returns at once: no device synchronisation."""
    if not _DEBUG_NANS:
        return
    for tree in trees:
        if isinstance(tree, np.ndarray):
            arrays = [tree]
        elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            arrays = [getattr(tree, f.name) for f in dataclasses.fields(tree)
                      if isinstance(getattr(tree, f.name), np.ndarray)]
        else:
            arrays = []
        bad = [t for t in _tensors(tree)
               if t.is_floating_point() and bool(torch.isnan(t).any())]
        bad += [a for a in arrays if np.issubdtype(a.dtype, np.floating)
                and bool(np.isnan(a).any())]
        if bad:
            raise FloatingPointError(
                f"--debug-nans: NaN in the {phase} output "
                f"{tuple(bad[0].shape)} {bad[0].dtype}")


# Registry counter -> report key of the resilience incidents a report
# carries, as the delta since the timer was made (the registry is
# process-wide; an earlier job's retries are not this one's).
_INCIDENT_COUNTERS = (
    ("ingest.retries", "ingest_retries"),
    ("ingest.reopens", "ingest_reopens"),
    ("ingest.corrupt_blocks", "ingest_corrupt_blocks"),
)


@dataclass
class PhaseTimer:
    """Accumulates named phase durations (seconds) and counters, both
    mirrored into the telemetry registry."""

    phases: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    incident_base: dict[str, float] = field(default_factory=dict,
                                            repr=False, compare=False)

    def __post_init__(self):
        if not self.incident_base:
            self.incident_base = {name: telemetry.counter_value(name)
                                  for name, _ in _INCIDENT_COUNTERS}

    @contextlib.contextmanager
    def phase(self, name: str):
        sp = telemetry.begin("phase." + name, cat="phase")
        try:
            # Also a named range in a --trace-dir capture, where the card's
            # kernels can be set against the phase's window.
            with torch.profiler.record_function("phase." + name):
                yield
        finally:
            dt = sp.end()
            self.phases[name] = self.phases.get(name, 0.0) + dt
            telemetry.count("phase." + name, dt)

    def add(self, counter: str, amount: float) -> None:
        self.counters[counter] = self.counters.get(counter, 0.0) + amount
        telemetry.count(counter, amount)

    def report(self) -> dict:
        """Phases, counters, the derived throughputs and the incidents
        since the timer was made."""
        rep: dict[str, float] = dict(self.phases)
        rep.update(self.counters)
        rep.update(telemetry.derive_throughputs(self.phases, self.counters))
        for cname, key in _INCIDENT_COUNTERS:
            v = telemetry.counter_value(cname) - self.incident_base.get(
                cname, 0.0)
            if v > 0:
                rep[key] = v
        return rep


def kernel_events(prof) -> list:
    """The device-kernel events of a finished ``torch.profiler``
    capture (what CUPTI recorded on the card)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


@contextlib.contextmanager
def trace(logdir: str | None, device: str = "cpu"):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    as a Chrome trace (``trace_rank<r>.json``; loads in Perfetto or
    ``chrome://tracing``). Host activity always; the card's kernels too
    when ``device`` is ``cuda`` (a missing card raises). A CUDA capture
    that recorded no device kernel means CUPTI did not trace the card,
    and raises rather than leave an untraced job looking traced. Yields
    the profiler (None when ``logdir`` is unset)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from spark_examples_tpu_torch.core.device import resolve_device

    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if cuda and not kernel_events(prof):
        raise RuntimeError(
            "--trace-dir: the torch.profiler capture holds no CUDA kernel "
            "event — CUPTI did not trace the card, so the trace would "
            "show host activity only"
        )
    rank, _ = telemetry._rank()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_rank{rank}.json"))
