"""Per-phase wall-clock timing, device-timed spans and the profiler
capture.

PyTorch returns from a CUDA call before the device has finished it, so
a phase that ends without a barrier times the enqueue, not the work.
:func:`hard_sync` is that barrier; the job routes call it on whatever a
phase produced before the phase closes.

:class:`PhaseTimer` mirrors every phase into the telemetry registry (a
``phase.<name>`` span on the trace timeline and a counter of summed
seconds) and every counter it adds, and reports its derived throughputs
through :func:`telemetry.derive_throughputs`, the formula the exported
``metrics.json`` uses too.

This module installs the telemetry's profiler mirror: while a
``torch.profiler`` capture runs, every telemetry span (a phase, a gram
block, the feed's stages, a device span) is also a profiler range of
its own name on its own thread, on the clock of the card's kernels and
copies in the same capture. With no capture running a span checks one
flag and opens no range.

:func:`device_span` times work on a CUDA stream with a pair of
timing-enabled events from a reused pool and never synchronises: the
pair is read into the histogram of its name, in seconds, only where
its end event has been waited out anyway: after a :func:`hard_sync`
barrier, or by a caller that waits on that event itself (the feed's
copy, when its slab retires). :class:`StreamGaps` measures, the same
way, how long a stream idles between marked stretches of work, and
:class:`CardSkew` how far the cards of a mesh drift apart in a block.
Off the card the first two time the host; the skew needs two cards.
:func:`check_at_barrier` leaves a library's status word on the card
(cuSOLVER's ``devInfo``) to the same barrier, which raises on a nonzero
one.

:func:`trace` (``--trace-dir``) captures a ``torch.profiler`` trace of a
whole job, every thread's ranges included. :func:`check_nans` is
``--debug-nans``: a NaN check at the job's phase boundaries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.meshes import Tiled


def _capture_running() -> bool:
    """True while a ``torch.profiler`` capture runs, read on any thread
    (a process-wide flag torch sets when a capture starts)."""
    return _autograd_profiler._is_profiler_enabled


def _open_range(name: str):
    rng = torch.profiler.record_function(name)
    rng.__enter__()
    return rng


telemetry.set_profiler_mirror(_capture_running, _open_range)


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
    if devices:
        indices = {d.index for d in devices}
        resolve_device_spans(indices)
        _check_statuses(indices)
    return tree


# Pending device spans (their end events may still be ahead of the
# card) and the reused timing events, per device index. A span whose
# caller waits on its end event is the caller's, and never pending.
_DEVICE_LOCK = threading.Lock()
_PENDING: dict = {}  # an ordered set of _DeviceSpan
_EVENT_POOL: dict[int, list] = {}
# Status words a library wrote on the card (cuSOLVER's devInfo), each
# (device index, int32 tensor, what wrote it), read at the next barrier.
_STATUSES: list = []
# Past this many pending spans (a path with no barrier), the ones whose
# end has already completed are resolved where the next one is added.
PENDING_MAX = 4096


def _cuda_index(device) -> int:
    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _take_events(index: int, n: int) -> list:
    with _DEVICE_LOCK:
        pool = _EVENT_POOL.setdefault(index, [])
        taken = [pool.pop() for _ in range(min(n, len(pool)))]
    return taken + [torch.cuda.Event(enable_timing=True)
                    for _ in range(n - len(taken))]


def _give_events(index: int, events) -> None:
    with _DEVICE_LOCK:
        _EVENT_POOL.setdefault(index, []).extend(events)


class _DeviceSpan:
    """A recorded event pair on a CUDA stream, waiting to be read."""

    __slots__ = ("name", "t0", "tid", "index", "start", "end")

    def __init__(self, name, t0, tid, index, start, end):
        self.name, self.t0, self.tid, self.index = name, t0, tid, index
        self.start, self.end = start, end

    def resolve(self) -> None:
        """Record the pair's device seconds into the histogram of its
        name; the caller knows the end event has completed. Only the
        first call records."""
        with _DEVICE_LOCK:
            if self.start is None:
                return
            start, end, self.start, self.end = self.start, self.end, None, None
            _PENDING.pop(self, None)
        telemetry.span_at(self.name, self.t0, start.elapsed_time(end) / 1e3,
                          cat="device", tid=self.tid)
        _give_events(self.index, (start, end))


def _resolve_completed(spans) -> None:
    """Resolve those of the pending ``spans`` whose end event has
    completed (a poll: nothing waits); the rest stay pending."""
    for d in spans:
        end = d.end
        if end is not None and end.query():
            d.resolve()


def resolve_device_spans(indices) -> None:
    """Resolve the pending device spans on the CUDA devices ``indices``,
    just synchronised (a span another thread recorded after the barrier
    waits for the next one)."""
    with _DEVICE_LOCK:
        due = [d for d in _PENDING if d.index in indices]
    _resolve_completed(due)


def check_at_barrier(status: torch.Tensor, what: str) -> None:
    """Check a library's status words on the card, an int32 tensor whose
    every element is 0 on success, at its device's next :func:`hard_sync`,
    which waits anyway: a nonzero one raises there. Off the card they are
    checked at once."""
    if status.device.type != "cuda":
        _raise_on_status(status, what)
        return
    with _DEVICE_LOCK:
        _STATUSES.append((_cuda_index(status.device), status, what))


def _check_statuses(indices) -> None:
    """Read the status words pending on the CUDA devices ``indices``,
    just synchronised; a nonzero one raises."""
    with _DEVICE_LOCK:
        due = [s for s in _STATUSES if s[0] in indices]
        _STATUSES[:] = [s for s in _STATUSES if s[0] not in indices]
    for _, status, what in due:
        _raise_on_status(status, what)


def _raise_on_status(status: torch.Tensor, what: str) -> None:
    words = status.reshape(-1).cpu()
    bad = words.nonzero().flatten()
    if bad.numel():
        raise RuntimeError(f"{what} failed on {status.device}: status "
                           f"{int(words[bad[0]])}")


@contextlib.contextmanager
def device_span(name: str, device, stream=None, waited: bool = False):
    """Time the block's work on a CUDA device: a timing-enabled event
    pair recorded on ``stream`` (the device's current stream by default),
    so nothing waits. By default the pair is left pending and a later
    :func:`hard_sync` of the device records its seconds into the
    histogram ``name``. With ``waited`` the caller waits on the yielded
    pair's ``end`` event itself and then calls its ``resolve()``; no
    barrier reads such a pair, so its events stay the caller's. Yields
    the pair (None off the card, where the block's host interval is
    recorded instead). It is a span like any other: the profiler mirror
    covers its host interval."""
    device = torch.device(device)
    if device.type != "cuda":
        with telemetry.span(name, cat="device"):
            yield None
        return
    index = _cuda_index(device)
    if stream is None:
        stream = torch.cuda.current_stream(index)
    sp = telemetry.begin(name, cat="device")
    ds = _DeviceSpan(name, sp.t0, sp.tid, index, *_take_events(index, 2))
    ds.start.record(stream)
    try:
        yield ds
    finally:
        ds.end.record(stream)
        sp.cancel()  # the histogram takes the device seconds instead
        if not waited:
            with _DEVICE_LOCK:
                _PENDING[ds] = None
                due = list(_PENDING) if len(_PENDING) > PENDING_MAX else []
            _resolve_completed(due)


class StreamGaps:
    """How long a CUDA device's current stream idles between stretches
    of work, each stretch between two calls of :meth:`mark`: from the
    object's making to the first stretch, and between consecutive
    stretches. Each mark is an event recorded on the stream, read in
    :meth:`count` after a barrier the caller already makes. Off the card
    it does nothing."""

    def __init__(self, device):
        device = torch.device(device)
        self._marks = None
        if device.type == "cuda":
            self._index = _cuda_index(device)
            self._stream = torch.cuda.current_stream(self._index)
            self._marks = []
            self.mark()

    def mark(self) -> None:
        """Call before and after each stretch of work."""
        if self._marks is None:
            return
        ev = _take_events(self._index, 1)[0]
        ev.record(self._stream)
        self._marks.append(ev)

    def count(self, name: str) -> None:
        """Add the idle seconds to counter ``name``; the stream has
        completed every mark (the caller has synchronised)."""
        if self._marks is None:
            return
        marks, self._marks = self._marks, None
        # (making, before 1), (after 1, before 2), ...: the last mark
        # ends the last stretch.
        idle = sum(a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2]))
        telemetry.count(name, idle / 1e3)
        _give_events(self._index, marks)


class CardSkew:
    """How far the cards of a mesh drift apart, block by block: each
    card's device time from its first to its last mark in a block (an
    event on its current stream), the slowest card's less the
    fastest's, summed over the blocks. The events are read in
    :meth:`count` after a barrier the caller already makes. With fewer
    than two cards (virtual slots, or off the card) it does nothing."""

    def __init__(self, devices):
        cards = {torch.device(d) for d in devices}
        self._on = (len(cards) > 1
                    and all(d.type == "cuda" for d in cards))
        self._blocks: list[dict] = []

    def next_block(self) -> None:
        """Call before each block's first mark."""
        if self._on:
            self._blocks.append({})

    def mark(self, device) -> None:
        """Call before and after each stretch of a block's work on
        ``device``."""
        if not self._on:
            return
        index = _cuda_index(device)
        ev = _take_events(index, 1)[0]
        ev.record(torch.cuda.current_stream(index))
        self._blocks[-1].setdefault(index, []).append(ev)

    def count(self, name: str) -> None:
        """Add the summed skew, in seconds, to counter ``name``; every
        card has completed every mark (the caller has synchronised)."""
        if not self._on:
            return
        blocks, self._blocks = self._blocks, []
        skew = 0.0
        for block in blocks:
            spans = [evs[0].elapsed_time(evs[-1]) for evs in block.values()]
            if spans:
                skew += max(spans) - min(spans)
            for index, evs in block.items():
                _give_events(index, evs)
        telemetry.count(name, skew / 1e3)


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


def _all_threads():
    """The capture option that records the ranges of every thread (the
    feed's producer's too); without it a capture records only the thread
    that started it."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


@contextlib.contextmanager
def trace(logdir: str | None, device: str = "cpu"):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    as a Chrome trace (``trace_rank<r>.json``; loads in Perfetto or
    ``chrome://tracing``). Host activity of every thread always; the
    card's kernels too when ``device`` is ``cuda`` (a missing card
    raises). A CUDA capture that recorded no device kernel means CUPTI
    did not trace the card, and raises rather than leave an untraced job
    looking traced. Yields the profiler (None when ``logdir`` is
    unset)."""
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
    with profile(activities=activities,
                 experimental_config=_all_threads()) as prof:
        yield prof
    if cuda and not kernel_events(prof):
        raise RuntimeError(
            "--trace-dir: the torch.profiler capture holds no CUDA kernel "
            "event — CUPTI did not trace the card, so the trace would "
            "show host activity only"
        )
    rank, _ = telemetry._rank()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_rank{rank}.json"))
