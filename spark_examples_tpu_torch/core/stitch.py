"""Restart- and rank-stitched traces: one Perfetto session per job.

A supervised job (core/supervisor.py) shatters into per-attempt,
per-rank telemetry exports — ``<dir>/attempt<a>/rank<r>/trace.jsonl``
(unsupervised runs write ``<dir>/rank<r>/``). Each file is loadable on
its own, but the thing an operator debugs is the *logical job*: attempt
0 streamed six blocks, got killed, attempt 1 resumed from the
checkpoint — on one timeline, with the restart visible.

:func:`stitch` merges every attempt/rank export under a telemetry
directory into one Chrome-trace JSONL:

- **One global timeline.** Every export's ``metrics.json`` meta records
  ``epoch_unix_s`` — the wall-clock instant at that process's trace
  ``ts=0`` — so each attempt's perf-counter-relative events shift onto
  a shared wall-clock axis (earliest attempt = t0). No clock collective
  is needed; sub-second host clock skew is noise at restart timescales.
- **One track per (attempt, rank).** Events keep their thread tracks
  within a remapped pid (``attempt*10000 + rank``), named
  ``attempt <a> rank <r>`` and sorted in attempt order.
- **Restart-incident markers.** The supervisor parent's incident ledger
  (``supervisor.json``, written next to the attempt dirs) becomes
  global instant events on a dedicated ``supervisor`` track — the crash
  / hang / stall verdict and detail sit exactly where the timeline
  breaks.
- **Identity checked.** Every export's ``run_id`` must agree (the
  supervisor pins one run_id across attempts); mixed run_ids are
  reported, not silently merged — two unrelated jobs in one directory
  is a layout mistake, not a session.

Exposed as the ``telemetry stitch`` CLI verb (cli/main.py). The export
layout and event keys are the JAX package's, so this stitcher reads
either package's directories and the JAX package's reads this one's.
:func:`stitch_fleet` (``telemetry stitch --fleet``) does the same for a
fleet controller's workdir: one pid block per replica slot, the
controller ledger's incidents as markers on a ``controller`` track.
"""

from __future__ import annotations

import json
import os
import re

from spark_examples_tpu_torch.core import telemetry

SUPERVISOR_LEDGER = "supervisor.json"
CONTROLLER_LEDGER = "controller.json"

# pid remap: attempts land far apart so rank tracks can't collide
# (rank counts are bounded by pod size, nowhere near 10k).
_ATTEMPT_STRIDE = 10_000
# Fleet mode: one pid block per replica slot, far above any
# slot-internal attempt*stride+rank remap.
_SLOT_STRIDE = 1_000_000
_SUPERVISOR_PID = 999_999_999
_CONTROLLER_PID = 999_999_998

_RANK_RE = re.compile(r"^rank(\d+)$")
_ATTEMPT_RE = re.compile(r"^attempt(\d+)$")


class StitchError(RuntimeError):
    """Nothing stitchable under the directory (wrong path, or a job
    that never exported)."""


def _iter_exports(base: str):
    """Yield (attempt, rank, rank_dir) for every export under base.
    ``attempt`` is None for the flat unsupervised layout (resolved from
    the export's own meta later, defaulting to 0)."""
    try:
        entries = sorted(os.listdir(base))
    except OSError as e:
        raise StitchError(f"cannot read telemetry dir {base!r}: {e}") from e
    for entry in entries:
        full = os.path.join(base, entry)
        if not os.path.isdir(full):
            continue
        m = _RANK_RE.match(entry)
        if m:
            yield None, int(m.group(1)), full
            continue
        m = _ATTEMPT_RE.match(entry)
        if m:
            att = int(m.group(1))
            for sub in sorted(os.listdir(full)):
                rm = _RANK_RE.match(sub)
                if rm and os.path.isdir(os.path.join(full, sub)):
                    yield att, int(rm.group(1)), os.path.join(full, sub)


def _load_export(rank_dir: str) -> tuple[dict, list[dict]]:
    """(meta, events) for one rank export; missing/torn files degrade
    to empty rather than failing the whole stitch — a crashed attempt
    may have a trace but no metrics (or vice versa), and partial
    visibility beats none.

    A killed attempt never reached its exit-time export, so its
    ``trace.jsonl`` is absent — but the periodic flusher's last
    ``live_trace.jsonl`` ring survives the kill (tmp+rename), and
    those recent events are exactly the "what was it doing when it
    died" evidence; fall back to them."""
    meta: dict = {}
    try:
        with open(os.path.join(rank_dir, "metrics.json")) as f:
            meta = json.load(f).get("meta", {}) or {}
    except (OSError, ValueError):
        pass
    events: list[dict] = []
    for name in ("trace.jsonl", "live_trace.jsonl"):
        try:
            with open(os.path.join(rank_dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a killed writer
                    if ev.get("ph") != "M":  # re-emit our own metadata
                        events.append(ev)
        except OSError:
            continue
        if events:
            break  # the full trace supersedes the ring
    return meta, events


def stitch(base: str, output: str | None = None) -> dict:
    """Merge every attempt/rank export under ``base`` into one
    Perfetto-loadable trace; returns the stitch report (attempts,
    ranks, event/marker counts, run ids, output path)."""
    exports = []
    for att, rank, rank_dir in _iter_exports(base):
        meta, events = _load_export(rank_dir)
        if att is None:
            att = int(meta.get("attempt", 0) or 0)
        exports.append((att, rank, meta, events))
    if not exports:
        raise StitchError(
            f"no rank<k>/ or attempt<a>/rank<k>/ exports under {base!r} "
            "— is this a --telemetry-dir?")
    exports.sort(key=lambda e: (e[0], e[1]))

    run_ids = sorted({m.get("run_id") for _a, _r, m, _e in exports
                      if m.get("run_id")})
    epochs = [m.get("epoch_unix_s") for _a, _r, m, _e in exports
              if isinstance(m.get("epoch_unix_s"), (int, float))]
    # Fallback for exports with no meta at all: align their ts=0 to the
    # earliest known epoch (best-effort; they still land on the track).
    epoch0 = min(epochs) if epochs else 0.0

    markers = _ledger_markers(base, epoch0)
    counted = [0]

    # Serialized lines stream straight into the atomic tmp file — a
    # near-MAX_EVENTS multi-attempt stitch never holds the whole merged
    # trace a second time as a list-of-strings plus a joined blob.
    def _lines():
        for att, rank, meta, events in exports:
            pid = att * _ATTEMPT_STRIDE + rank
            shift_us = (float(meta.get("epoch_unix_s", epoch0))
                        - epoch0) * 1e6
            yield json.dumps({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "ts": 0, "args": {"name": f"attempt {att} rank {rank}"}})
            yield json.dumps({
                "name": "process_sort_index", "ph": "M", "pid": pid,
                "tid": 0, "ts": 0, "args": {"sort_index": pid}})
            for ev in events:
                ev = dict(ev)
                ev["pid"] = pid
                ev["ts"] = float(ev.get("ts", 0.0)) + shift_us
                counted[0] += 1
                yield json.dumps(ev, default=str)
        if markers:
            yield json.dumps({
                "name": "process_name", "ph": "M", "pid": _SUPERVISOR_PID,
                "tid": 0, "ts": 0, "args": {"name": "supervisor"}})
            for m in markers:
                yield json.dumps(m, default=str)

    out_path = output or os.path.join(base, "stitched_trace.jsonl")
    telemetry._atomic_write_lines(out_path, _lines())
    total_events = counted[0]
    return {
        "output": out_path,
        "attempts": sorted({a for a, _r, _m, _e in exports}),
        "ranks": sorted({r for _a, r, _m, _e in exports}),
        "events": total_events,
        "restart_markers": len(markers),
        "run_ids": run_ids,
        "mixed_run_ids": len(run_ids) > 1,
    }


def stitch_fleet(base: str, output: str | None = None) -> dict:
    """Fleet mode: merge EVERY replica slot's attempt/rank exports
    under ``base/<slot>/`` onto one Perfetto timeline — one pid block
    per slot — with the controller ledger's incidents (current
    generation plus the rotated ``controller.json.old``) as global
    markers on a dedicated ``controller`` track.

    This is the whole-fleet waterfall view: a request hedged across
    two replicas shows both legs (same ``trace_id`` in the span args,
    distinct span ids), and a kill/respawn incident marker sits at the
    wall-clock instant the surviving leg's spans route around it."""
    slots = []
    try:
        entries = sorted(os.listdir(base))
    except OSError as e:
        raise StitchError(f"cannot read fleet dir {base!r}: {e}") from e
    for entry in entries:
        full = os.path.join(base, entry)
        if not os.path.isdir(full):
            continue
        exports = []
        try:
            for att, rank, rank_dir in _iter_exports(full):
                meta, events = _load_export(rank_dir)
                if att is None:
                    att = int(meta.get("attempt", 0) or 0)
                exports.append((att, rank, meta, events))
        except StitchError:
            continue
        if exports:
            exports.sort(key=lambda e: (e[0], e[1]))
            slots.append((entry, exports))
    if not slots:
        raise StitchError(
            f"no <slot>/rank<k> or <slot>/attempt<a>/rank<k> exports "
            f"under {base!r} — is this a fleet workdir?")

    run_ids = sorted({m.get("run_id")
                      for _slot, exports in slots
                      for _a, _r, m, _e in exports if m.get("run_id")})
    epochs = [m.get("epoch_unix_s")
              for _slot, exports in slots
              for _a, _r, m, _e in exports
              if isinstance(m.get("epoch_unix_s"), (int, float))]
    epoch0 = min(epochs) if epochs else 0.0

    markers = _controller_markers(base, epoch0)
    counted = [0]

    def _lines():
        for slot_idx, (slot, exports) in enumerate(slots):
            for att, rank, meta, events in exports:
                pid = (slot_idx * _SLOT_STRIDE
                       + att * _ATTEMPT_STRIDE + rank)
                shift_us = (float(meta.get("epoch_unix_s", epoch0))
                            - epoch0) * 1e6
                yield json.dumps({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "ts": 0,
                    "args": {"name":
                             f"{slot} attempt {att} rank {rank}"}})
                yield json.dumps({
                    "name": "process_sort_index", "ph": "M", "pid": pid,
                    "tid": 0, "ts": 0, "args": {"sort_index": pid}})
                for ev in events:
                    ev = dict(ev)
                    ev["pid"] = pid
                    ev["ts"] = float(ev.get("ts", 0.0)) + shift_us
                    counted[0] += 1
                    yield json.dumps(ev, default=str)
        if markers:
            yield json.dumps({
                "name": "process_name", "ph": "M",
                "pid": _CONTROLLER_PID, "tid": 0, "ts": 0,
                "args": {"name": "controller"}})
            for m in markers:
                yield json.dumps(m, default=str)

    out_path = output or os.path.join(base, "stitched_fleet_trace.jsonl")
    telemetry._atomic_write_lines(out_path, _lines())
    return {
        "output": out_path,
        "slots": [slot for slot, _e in slots],
        "events": counted[0],
        "incident_markers": len(markers),
        "run_ids": run_ids,
        "mixed_run_ids": len(run_ids) > 1,
    }


def _controller_markers(base: str, epoch0: float) -> list[dict]:
    """Controller ledger incidents (current + rotated ``.old``
    generation, deduplicated) -> global markers on the controller
    track."""
    incidents: list[dict] = []
    seen: set[tuple] = set()
    for name in (CONTROLLER_LEDGER + ".old", CONTROLLER_LEDGER):
        try:
            with open(os.path.join(base, name)) as f:
                ledger = json.load(f)
        except (OSError, ValueError):
            continue
        for inc in ledger.get("incidents", []):
            key = (inc.get("t_unix"), inc.get("who"), inc.get("kind"),
                   inc.get("detail"))
            if key in seen:
                continue
            seen.add(key)
            incidents.append(inc)
    markers = []
    for inc in incidents:
        ts = max(0.0, (float(inc.get("t_unix", epoch0)) - epoch0) * 1e6)
        kind = inc.get("kind", "incident")
        markers.append({
            "name": f"incident: {kind}",
            "cat": "controller",
            "ph": "i",
            "s": "g",
            "ts": ts,
            "pid": _CONTROLLER_PID,
            "tid": 0,
            "args": {k: inc.get(k)
                     for k in ("round", "who", "kind", "detail")},
        })
    markers.sort(key=lambda m: m["ts"])
    return markers


def _ledger_markers(base: str, epoch0: float) -> list[dict]:
    """Supervisor incidents -> global instant events on their own track."""
    try:
        with open(os.path.join(base, SUPERVISOR_LEDGER)) as f:
            ledger = json.load(f)
    except (OSError, ValueError):
        return []
    markers = []
    for inc in ledger.get("incidents", []):
        ts = max(0.0, (float(inc.get("t_unix", epoch0)) - epoch0) * 1e6)
        kind = inc.get("kind", "incident")
        markers.append({
            "name": f"restart: {kind}",
            "cat": "supervisor",
            "ph": "i",
            "s": "g",  # global scope: the full-height timeline marker
            "ts": ts,
            "pid": _SUPERVISOR_PID,
            "tid": 0,
            "args": {k: inc.get(k) for k in
                     ("attempt", "kind", "detail", "returncode")},
        })
    return markers
