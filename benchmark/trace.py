"""The device trace of a run's window: ``torch.profiler`` (CUPTI on the
card) over the window, reduced to what the per-layer readers and the
result's ``breakdown`` need.

The capture is exported as a Chrome trace into the run's temporary
directory, read back and deleted. Device activity is every ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` event; the program's phases are its
``phase.<name>`` ranges (``core/profiling.py::PhaseTimer``), each ended
by a device synchronise, so a kernel that starts inside a phase's range
is that phase's work.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
# Kernel names are C++ templates; the breakdown keeps their heads.
NAME_CHARS = 160


@contextlib.contextmanager
def capture(enabled: bool, cuda: bool):
    """Profile the block when ``enabled``; the holder's ``events`` are
    the trace's complete events once the block has closed."""
    holder = {"events": None, "seconds": {}}
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    fd, path = tempfile.mkstemp(prefix="pcoabench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        t3 = time.perf_counter()
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder["events"] = [e for e in raw if e.get("ph") == "X"]
    # Where the trace's own cost goes, for the run's log.
    holder["seconds"] = {"stop": t2 - t1, "export": t3 - t2,
                         "read": time.perf_counter() - t3}


def _union(intervals):
    """Merged, sorted ``[start, end]`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _enclosing(ranges, starts, t):
    """The name of the range in ``ranges`` (sorted by start, none
    nested: a job's phases follow one another) holding ``t``, or
    None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= ranges[i][1]:
        return ranges[i][2]
    return None


def summarize(events: list[dict], n_devices: int) -> dict:
    """``busy_s`` (the union of device activity a card, averaged over
    ``n_devices``), the kernels' seconds inside each phase
    (``phase_kernel_s``), the costliest device operations and the
    device's idle time by the phase the host was in (``idle_by``)."""
    phases = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("phase."):])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("phase."))
    starts = [p[0] for p in phases]
    per_dev = defaultdict(list)
    by_op = defaultdict(float)
    phase_kernel = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        dev = (e.get("args") or {}).get("device", 0)
        per_dev[dev].append((e["ts"], e["ts"] + e["dur"]))
        by_op[e["name"][:NAME_CHARS]] += e["dur"] * 1e-6
        if e["cat"] == "kernel":
            ph = _enclosing(phases, starts, e["ts"])
            if ph is not None:
                phase_kernel[ph] += e["dur"] * 1e-6
    busy = 0.0
    idle_by = defaultdict(float)
    for ivs in per_dev.values():
        merged = _union(ivs)
        busy += sum(e - s for s, e in merged) * 1e-6
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            label = _enclosing(phases, starts, 0.5 * (e0 + s1))
            idle_by["phase." + label if label else "between_phases"] += (
                (s1 - e0) * 1e-6)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle_by.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / max(1, n_devices),
        "phase_kernel_s": dict(phase_kernel),
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in gaps],
        "device_events": sum(len(v) for v in per_dev.values()),
    }

