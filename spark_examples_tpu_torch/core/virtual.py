"""Virtual slots: a mesh of ``n`` slots over ONE physical device.

The JAX package gives its tests (and its multi-chip dry run) eight
virtual CPU devices through an XLA flag (``force_virtual_cpu``), so the
mesh, sharding and collective code paths run multi-"device" in one
process. This is the port's counterpart: ``n`` mesh slots that all name
the same ``torch.device``. Every slot then holds its own tiles and runs
its own kernel launches, exactly as it would on a card of its own.

The setting is scoped, never process-wide: :func:`virtual_slots` is a
context manager (a ``ContextVar`` underneath), and
:func:`virtual_devices` gives an explicit device list for
``meshes.make_mesh(devices=...)``. The CLI's ``--virtual-devices N``
wraps its job in :func:`virtual_slots`.

A mesh of virtual slots shows the route (its tiles, transports and
per-tile launches), never scaling: every slot shares one device's
memory and compute. ``meshes.Mesh.describe`` says so.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

import torch

_SLOTS: ContextVar[tuple[int, str | None] | None] = ContextVar(
    "spark_examples_tpu_torch_virtual_slots", default=None)


def virtual_devices(n: int, device) -> list[torch.device]:
    """``n`` slots that all name ``device`` (a ``torch.device`` or a
    name such as ``"cuda:0"`` or ``"cpu"``)."""
    if not (isinstance(n, int) and n >= 1):
        raise ValueError(f"virtual slots: expected a count >= 1, got {n!r}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return [device] * n


@contextmanager
def virtual_slots(n: int, device: str | None = None):
    """Inside the block, a job's default mesh is ``n`` slots over one
    device: ``device`` when given, else the job's own ``--device`` (its
    first card on ``cuda``). Restored on exit."""
    virtual_devices(n, device or "cpu")  # validates n
    token = _SLOTS.set((n, device))
    try:
        yield
    finally:
        _SLOTS.reset(token)


def current() -> tuple[int, str | None] | None:
    """The active ``(n, device)`` scope, or None."""
    return _SLOTS.get()
