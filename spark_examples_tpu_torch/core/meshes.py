"""The device mesh: a ``(p_i, p_j)`` grid of slots, each a ``torch.device``.

Counterpart of the JAX package's ``core/meshes.py``. One process drives
every slot of its mesh, as JAX's ``make_mesh(jax.devices())`` does; the
collectives are explicit tensor moves (``parallel/gram_sharded.py``).

Mesh axes: ``("i", "j")``. The N x N accumulator is tiled with rows
over ``i`` and columns over ``j`` (:class:`Tiled`); the variant axis of a
streamed block is split over the flattened ``(i, j)`` slot list, i-major
(:func:`variants_flat`).

A slot is a ``torch.device``: on ``--device cuda`` the default mesh is
every visible card, ``cuda:0..n-1``; on one card that is ``(1, 1)``.
``core/virtual.py`` puts ``n`` slots on one physical device.

The JAX layouts (``replicated``, ``tile2d``, ``rows_i``, ``rows_j``,
``variants_flat``) are slot -> slice maps here: lists indexed by the flat
slot number.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from spark_examples_tpu_torch.core import virtual

AXIS_I = "i"  # sample-row axis of the N x N accumulator
AXIS_J = "j"  # sample-column axis of the N x N accumulator


@dataclass(frozen=True)
class Mesh:
    """``devices`` flattened i-major: slot ``s`` is ``(s // p_j, s % p_j)``."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]

    axis_names = (AXIS_I, AXIS_J)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Slot 0's device: where replicated state and the feed land."""
        return self.devices[0]

    def coords(self, s: int) -> tuple[int, int]:
        return divmod(s, self.shape[1])

    def slot(self, i: int, j: int) -> int:
        return i * self.shape[1] + j

    @property
    def physical(self) -> tuple[torch.device, ...]:
        """The distinct devices behind the slots, in slot order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def virtual(self) -> bool:
        return len(self.physical) < self.size

    def describe(self) -> str:
        i, j = self.shape
        phys = ", ".join(str(d) for d in self.physical)
        if self.virtual:
            return (f"{i}x{j} mesh of {self.size} virtual slots on "
                    f"{len(self.physical)} physical device(s) ({phys}): the "
                    "route, not scaling")
        return f"{i}x{j} mesh over {self.size} device(s) ({phys})"


def _factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization of a device count into (i, j)."""
    best = (1, n)
    for i in range(1, int(math.isqrt(n)) + 1):
        if n % i == 0:
            best = (i, n // i)
    return best


def default_devices(device) -> list[torch.device]:
    """The slots a job on ``device`` gets by default: the active
    ``virtual.virtual_slots`` scope, else every visible card for
    ``cuda`` (a named card alone for ``cuda:k``), else ``device``."""
    device = torch.device(device)
    scope = virtual.current()
    if scope is not None:
        n, dev = scope
        if dev is not None and torch.device(dev).type != device.type:
            raise ValueError(
                f"virtual slots on {dev} but the job runs on {device}: "
                "give the slots the job's --device"
            )
        return virtual.virtual_devices(n, dev if dev is not None else device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [device]


def make_mesh(devices: Sequence[torch.device],
              shape: tuple[int, int] | None = None) -> Mesh:
    """The framework's 2-D ``(i, j)`` mesh over ``devices``. ``shape``
    defaults to a near-square factorization of the device count (8 ->
    (2, 4)); a single device gives ``(1, 1)``."""
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = _factor_2d(n)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(
            f"mesh shape {shape} != device count {n} (--virtual-devices "
            "N puts N slots on one device)")
    return Mesh(devices, shape)


def ring_perm(mesh: Mesh) -> tuple[tuple[int, int], ...]:
    """Source -> destination pairs rotating one hop around the flattened
    slot ring: the shard on slot ``s`` moves to slot ``s - 1`` (mod D),
    so after ``D - 1`` hops every slot has held every shard once."""
    n = mesh.size
    return tuple((s, (s - 1) % n) for s in range(n))


def _spans(total: int, parts: int) -> list[slice]:
    step = total // parts
    return [slice(k * step, (k + 1) * step) for k in range(parts)]


def replicated(mesh: Mesh) -> list[slice]:
    """Every slot holds the whole array."""
    return [slice(None)] * mesh.size


def tile2d(mesh: Mesh, n: int, m: int | None = None
           ) -> list[tuple[slice, slice]]:
    """The (n, m) accumulator's tile per slot: rows over i, cols over j."""
    rows = _spans(n, mesh.shape[0])
    cols = _spans(n if m is None else m, mesh.shape[1])
    return [(rows[i], cols[j])
            for i, j in map(mesh.coords, range(mesh.size))]


def rows_i(mesh: Mesh, n: int) -> list[slice]:
    """An (n, v) block's sample rows per slot, split over i."""
    rows = _spans(n, mesh.shape[0])
    return [rows[mesh.coords(s)[0]] for s in range(mesh.size)]


def rows_j(mesh: Mesh, n: int) -> list[slice]:
    """An (n, v) block's sample rows per slot, split over j."""
    rows = _spans(n, mesh.shape[1])
    return [rows[mesh.coords(s)[1]] for s in range(mesh.size)]


def variants_flat(mesh: Mesh, width: int) -> list[slice]:
    """An (n, width) block's variant columns per slot, split over the
    flattened (i, j) slot list (i major)."""
    return _spans(width, mesh.size)


class Tiled:
    """An (n, m) leaf held as one tile per slot, never whole on any
    device: slot ``(i, j)`` holds rows ``[i tn, (i+1) tn)`` and columns
    ``[j tm, (j+1) tm)`` on its own device (the JAX package's
    ``P("i", "j")`` sharding). Each tile is its own tensor, also when
    slots share a device, so an in-place update of one never reaches
    another."""

    __slots__ = ("mesh", "shape", "tiles")

    def __init__(self, mesh: Mesh, shape, tiles):
        self.mesh = mesh
        self.shape = (int(shape[0]), int(shape[1]))
        self.tiles = list(tiles)
        if len(self.tiles) != mesh.size:
            raise ValueError(f"{len(self.tiles)} tiles for a mesh of "
                             f"{mesh.size} slots")

    @classmethod
    def zeros(cls, mesh: Mesh, shape, dtype) -> "Tiled":
        tn, tm = shape[0] // mesh.shape[0], shape[1] // mesh.shape[1]
        return cls(mesh, shape, [
            torch.zeros((tn, tm), dtype=dtype, device=d)
            for d in mesh.devices])

    @classmethod
    def from_full(cls, mesh: Mesh, full: torch.Tensor) -> "Tiled":
        """Tiles copied out of a whole (n, m) tensor, each onto its
        slot's device."""
        return cls(mesh, full.shape, [
            full[r, c].to(d, copy=True).contiguous()
            for (r, c), d in zip(tile2d(mesh, *full.shape), mesh.devices)])

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles[0].dtype

    @property
    def tile_shape(self) -> tuple[int, int]:
        return (self.shape[0] // self.mesh.shape[0],
                self.shape[1] // self.mesh.shape[1])

    def spans(self, s: int) -> tuple[int, int, int, int]:
        """Slot ``s``'s tile as global ``(row0, row1, col0, col1)``."""
        i, j = self.mesh.coords(s)
        tn, tm = self.tile_shape
        return i * tn, (i + 1) * tn, j * tm, (j + 1) * tm

    def map(self, fn) -> "Tiled":
        """``fn(tile, s)`` on every slot, as a new Tiled."""
        return Tiled(self.mesh, self.shape,
                     [fn(t, s) for s, t in enumerate(self.tiles)])

    def region(self, r0: int, r1: int, c0: int, c1: int,
               device) -> torch.Tensor:
        """The global sub-block ``[r0:r1, c0:c1]`` assembled on
        ``device`` from the tiles that hold it (what a slot needs of
        another's tiles, e.g. the mirrored block of a transpose)."""
        tn, tm = self.tile_shape
        bands = []
        for i in range(r0 // tn, -(-r1 // tn)):
            lo, hi = max(r0, i * tn), min(r1, (i + 1) * tn)
            pieces = []
            for j in range(c0 // tm, -(-c1 // tm)):
                a, b = max(c0, j * tm), min(c1, (j + 1) * tm)
                t = self.tiles[self.mesh.slot(i, j)]
                pieces.append(t[lo - i * tn:hi - i * tn,
                                a - j * tm:b - j * tm].to(device))
            bands.append(pieces[0] if len(pieces) == 1
                         else torch.cat(pieces, dim=1))
        return bands[0] if len(bands) == 1 else torch.cat(bands, dim=0)

    def diagonal_spans(self):
        """The global diagonal of a square leaf in stretches that each
        lie in one tile: ``(slot, local rows, local cols)``, in order."""
        n = self.shape[0]
        tn, tm = self.tile_shape
        g = 0
        while g < n:
            i, j = g // tn, g // tm
            end = min(n, (i + 1) * tn, (j + 1) * tm)
            yield (self.mesh.slot(i, j), slice(g - i * tn, end - i * tn),
                   slice(g - j * tm, end - j * tm))
            g = end

    def diagonal(self, device) -> torch.Tensor:
        """The global diagonal (square leaves), gathered on ``device``."""
        return torch.cat([torch.diagonal(self.tiles[s][r, c]).to(device)
                          for s, r, c in self.diagonal_spans()])

    def full(self, device) -> torch.Tensor:
        """The whole leaf gathered on ``device`` (a host or a device
        that can hold it: the similarity job's output, a test)."""
        return self.region(0, self.shape[0], 0, self.shape[1], device)
