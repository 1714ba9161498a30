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

A job of several processes (:func:`maybe_init_distributed`, over
``torch.distributed``) gives each rank slots of its own: its one card
(or the CPU, or the ``core/virtual.py`` slots on it), never every
visible card. The ranks are started the way the JAX package's are, with
the same environment names: ``JAX_COORDINATOR_ADDRESS`` (``host:port``
of rank 0's store), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. The
job's mesh (:func:`job_mesh`) then spans the ranks, as JAX's
``make_mesh(jax.devices())`` does: every rank's slots, rank-major, each
slot recording the rank that owns it (:func:`process_mesh`); a rank
holds only its own slots' tiles.

The JAX layouts (``replicated``, ``tile2d``, ``rows_i``, ``rows_j``,
``rows_flat``, ``variants_flat``) are slot -> slice maps here: lists indexed by the flat
slot number.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Sequence

import torch

from spark_examples_tpu_torch.core import virtual

AXIS_I = "i"  # sample-row axis of the N x N accumulator
AXIS_J = "j"  # sample-column axis of the N x N accumulator


@dataclass(frozen=True)
class Mesh:
    """``devices`` flattened i-major: slot ``s`` is ``(s // p_j, s % p_j)``.

    A mesh that spans the ranks of a job (:func:`process_mesh`) lists
    every rank's slots: ``owners[s]`` is the rank that owns slot ``s``,
    ``rank`` this process's, and ``devices[s]`` is None where another
    rank owns the slot. ``owners`` empty: every slot is this process's."""

    devices: tuple[torch.device | None, ...]
    shape: tuple[int, int]
    owners: tuple[int, ...] = ()
    rank: int = 0

    axis_names = (AXIS_I, AXIS_J)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_slots(self) -> tuple[int, ...]:
        """This process's slots, in slot order."""
        if not self.owners:
            return tuple(range(self.size))
        return self.slots_of(self.rank)

    def slots_of(self, rank: int) -> tuple[int, ...]:
        """The slots ``rank`` owns, in slot order."""
        if not self.owners:
            return self.local_slots if rank == self.rank else ()
        return tuple(s for s, r in enumerate(self.owners) if r == rank)

    def owner(self, s: int) -> int:
        return self.owners[s] if self.owners else self.rank

    def is_local(self, s: int) -> bool:
        return self.owner(s) == self.rank

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners)) > 1

    @property
    def processes(self) -> int:
        return len(set(self.owners)) if self.owners else 1

    @property
    def home(self) -> torch.device:
        """This process's first slot's device (slot 0's on one process):
        where replicated state and the feed land."""
        return self.devices[self.local_slots[0]]

    def coords(self, s: int) -> tuple[int, int]:
        return divmod(s, self.shape[1])

    def slot(self, i: int, j: int) -> int:
        return i * self.shape[1] + j

    @property
    def physical(self) -> tuple[torch.device, ...]:
        """The distinct devices behind this process's slots, in slot
        order."""
        return tuple(dict.fromkeys(self.devices[s] for s in self.local_slots))

    @property
    def virtual(self) -> bool:
        return len(self.physical) < len(self.local_slots)

    def describe(self) -> str:
        i, j = self.shape
        phys = ", ".join(str(d) for d in self.physical)
        if self.spans_processes:
            slots = self.local_slots
            kind = " virtual" if self.virtual else ""
            return (f"{i}x{j} mesh over {self.processes} processes of "
                    f"{len(slots)}{kind} slot(s) each, rank-major; this "
                    f"rank ({self.rank}) holds slots {slots[0]}-{slots[-1]} "
                    f"on {phys}")
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


@dataclass(frozen=True)
class Distributed:
    """This process's place in a job of several: its ``rank`` of
    ``world``, the collective ``backend`` (``nccl`` or ``gloo``), whether
    device tensors are staged through the host for gloo (``staged``:
    ranks that share a card), its own ``device``, and ``control``, the
    gloo group that carries the control-plane values (step counts, ok
    flags, cursors, votes) as host tensors."""

    rank: int
    world: int
    backend: str
    staged: bool
    device: torch.device
    control: object
    reason: str

    @property
    def name(self) -> str:
        """``nccl``, ``gloo`` or ``gloo-staged``: the reported choice."""
        return "gloo-staged" if self.staged else self.backend


# The one process group of this process (torch.distributed's own state
# is process-wide too).
_distributed: Distributed | None = None


def backend_rule(device: torch.device, world: int, n_cards: int,
                 local_world: int | None = None) -> tuple[str, bool, str]:
    """``(backend, staged, reason)`` for a job of ``world`` ranks on
    ``device``, decided up front by rule, never by a failed attempt:
    ``gloo`` on the CPU; ``nccl`` when every rank on a host has a card of
    its own; ``gloo`` with host staging when ranks share a card (NCCL
    refuses two ranks on one GPU)."""
    if device.type != "cuda":
        return "gloo", False, "--device cpu"
    local = world if local_world is None else local_world
    if n_cards >= local:
        return "nccl", False, f"{local} rank(s) on {n_cards} card(s)"
    return "gloo", True, (f"{local} ranks share {n_cards} card(s); NCCL "
                          "refuses two ranks on one GPU")


def maybe_init_distributed(device="cuda") -> Distributed | None:
    """Join the job's process group when launched as one of several
    processes (``JAX_COORDINATOR_ADDRESS`` set), else None. Idempotent.

    Called before the job touches its device: ``--device cuda`` without
    a card raises here on every rank, before any collective. The backend
    follows :func:`backend_rule`, is printed on stdout and set as the
    ``multihost.backend`` gauge; a failed NCCL start is an error, never
    a retry on gloo. A rank on ``cuda`` takes its own card,
    ``cuda:(LOCAL_RANK or rank % device_count)``, and makes it current."""
    global _distributed
    if _distributed is not None:
        return _distributed
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return None
    from spark_examples_tpu_torch.core import telemetry
    from spark_examples_tpu_torch.core.device import resolve_device

    device = resolve_device(torch.device(device).type)
    missing = [k for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
               if not os.environ.get(k)]
    if missing:
        raise ValueError(
            f"JAX_COORDINATOR_ADDRESS={addr} names a job of several "
            f"processes, but {' and '.join(missing)} is not set: give "
            "every rank the job's process count and its own index")
    world = int(os.environ["JAX_NUM_PROCESSES"])
    rank = int(os.environ["JAX_PROCESS_ID"])
    if not 0 <= rank < world:
        raise ValueError(f"JAX_PROCESS_ID={rank} outside a job of "
                         f"JAX_NUM_PROCESSES={world}")
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend, staged, reason = backend_rule(
        device, world, n_cards,
        int(local_world) if local_world else None)
    if device.type == "cuda":
        local_rank = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local_rank) if local_rank
                              else rank % n_cards)
        torch.cuda.set_device(device)
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
    if backend == "nccl":
        # NCCL builds its communicator at the first collective: one here
        # makes a failed start raise now, not after the stream, and keeps
        # its set-up out of the job's first timed reduction.
        dist.all_reduce(torch.zeros(1, device=device))
        torch.cuda.synchronize(device)
    # Control-plane values ride gloo on the host: NCCL would put each on
    # the card and add a sync per round.
    control = (dist.new_group(backend="gloo") if backend == "nccl"
               else dist.group.WORLD)
    _distributed = Distributed(rank, world, backend, staged, device,
                               control, reason)
    import atexit

    atexit.register(_leave)
    telemetry.joined_job(rank, world)
    telemetry.gauge_set("multihost.backend",
                        {"gloo": 0.0, "gloo-staged": 1.0,
                         "nccl": 2.0}[_distributed.name])
    print(f"multihost: rank {rank} of {world}, backend "
          f"{_distributed.name} on {device} ({reason})", flush=True)
    return _distributed


def _leave() -> None:
    """Tear the job's gloo groups down at exit, while the interpreter is
    whole. Left to the interpreter's own teardown, a gloo group's threads
    can be destroyed still joinable, which aborts the process
    (``std::terminate``, exit -6) after its work is done: about one
    two-rank job in ten on a loaded host. Under NCCL only the gloo
    control group goes here; NCCL's own teardown stays torch's, as a
    graceful NCCL shutdown could wait on a collective a dead peer left
    open."""
    global _distributed
    d, _distributed = _distributed, None  # the port's last references
    if d is None:
        return
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    if d.backend == "nccl":
        dist.destroy_process_group(d.control)
    else:
        dist.destroy_process_group()


def distributed() -> Distributed | None:
    """This process's group, when it joined one."""
    return _distributed


def process_index() -> int:
    return _distributed.rank if _distributed is not None else 0


def process_count() -> int:
    return _distributed.world if _distributed is not None else 1


def default_devices(device) -> list[torch.device]:
    """The slots a job on ``device`` gets by default: the active
    ``virtual.virtual_slots`` scope, else every visible card for
    ``cuda`` (a named card alone for ``cuda:k``; a rank of a job of
    several processes its own card), else ``device``."""
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
        if _distributed is not None:
            return [_distributed.device]
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [device]


def job_mesh(device, shape: tuple[int, int] | None = None) -> Mesh:
    """The mesh a job on ``device`` runs over: its default slots
    (:func:`default_devices`) shaped by ``--mesh-shape``; in a job of
    several processes, every rank's slots (:func:`process_mesh`), the
    shape applying to the job's whole slot count."""
    local = default_devices(device)
    if process_count() > 1:
        return process_mesh(local, process_count(), process_index(), shape)
    return make_mesh(local, shape)


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


def process_mesh(local: Sequence[torch.device], world: int, rank: int,
                 shape: tuple[int, int] | None = None) -> Mesh:
    """The mesh of a job of ``world`` ranks with ``len(local)`` slots
    each, as this ``rank`` sees it: global slots rank-major (rank ``r``'s
    ``L`` slots are ``r L .. r L + L - 1``, the JAX package's
    ``jax.devices()`` order), ``local`` placed at this rank's, None at the
    others'. ``shape`` covers the ``world x L`` slots (default:
    near-square). Every rank must have the same slot count."""
    local = tuple(torch.device(d) for d in local)
    per = len(local)
    if per == 0:
        raise ValueError("a mesh needs at least one device")
    if world == 1:
        return make_mesh(local, shape)
    n = world * per
    if shape is None:
        shape = _factor_2d(n)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(
            f"mesh shape {shape} != the job's slot count {n} ({world} "
            f"processes x {per} slot(s) each): --mesh-shape covers every "
            "rank's slots")
    devices = tuple(local[s - rank * per] if s // per == rank else None
                    for s in range(n))
    return Mesh(devices, shape, tuple(s // per for s in range(n)), rank)


def local_mesh(mesh: Mesh) -> Mesh:
    """This process's slots of ``mesh`` as a mesh of their own (a rank's
    mesh under the variant and replicated plans, which sum per-rank
    partials instead of tiling across ranks)."""
    if not mesh.owners:
        return mesh
    return make_mesh([mesh.devices[s] for s in mesh.local_slots])


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


def rows_flat(mesh: Mesh, n: int) -> list[slice]:
    """An (n, r) skinny solver block's sample rows per slot, split over
    the flattened slot list, i-major (JAX's ``P((i, j), None)``): the
    sketch solve's layout, where every r x r contraction is a local
    product per slot summed over the slots. ``ceil(n / D)`` rows a slot;
    where D does not divide n the last slots hold fewer (or none)."""
    step = -(-n // mesh.size)
    return [slice(min(k * step, n), min((k + 1) * step, n))
            for k in range(mesh.size)]


def variants_flat(mesh: Mesh, width: int) -> list[slice]:
    """An (n, width) block's variant columns per slot of this process,
    split over its slots in slot order (i major): the whole block over
    every slot on one process; across ranks a rank's slab over its own
    slots, which are the global block's shards ``r L .. r L + L - 1``."""
    return _spans(width, len(mesh.local_slots))


class Tiled:
    """An (n, m) leaf held as one tile per slot, never whole on any
    device: slot ``(i, j)`` holds rows ``[i tn, (i+1) tn)`` and columns
    ``[j tm, (j+1) tm)`` on its own device (the JAX package's
    ``P("i", "j")`` sharding). Each tile is its own tensor, also when
    slots share a device, so an in-place update of one never reaches
    another. On a mesh that spans processes a rank holds only its own
    slots' tiles (``tiles[s]`` is None at another rank's slot); what it
    needs of the others' comes through ``parallel/multihost.py``."""

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
            None if d is None else torch.zeros((tn, tm), dtype=dtype,
                                               device=d)
            for d in mesh.devices])

    @classmethod
    def from_full(cls, mesh: Mesh, full: torch.Tensor) -> "Tiled":
        """Tiles copied out of a whole (n, m) tensor, each onto its
        slot's device (this process's slots only)."""
        return cls(mesh, full.shape, [
            None if d is None else full[r, c].to(d, copy=True).contiguous()
            for (r, c), d in zip(tile2d(mesh, *full.shape), mesh.devices)])

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles[self.mesh.local_slots[0]].dtype

    def local(self):
        """``(slot, tile)`` of this process's slots, in slot order."""
        return [(s, self.tiles[s]) for s in self.mesh.local_slots]

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
        """``fn(tile, s)`` on this process's slots, as a new Tiled."""
        return Tiled(self.mesh, self.shape,
                     [None if t is None else fn(t, s)
                      for s, t in enumerate(self.tiles)])

    def region_pieces(self, r0: int, r1: int, c0: int, c1: int):
        """The tiles holding the global sub-block ``[r0:r1, c0:c1]``, as
        bands of ``(slot, local rows, local cols)``: row bands top to
        bottom, each a list of pieces left to right."""
        tn, tm = self.tile_shape
        bands = []
        for i in range(r0 // tn, -(-r1 // tn)):
            lo, hi = max(r0, i * tn), min(r1, (i + 1) * tn)
            band = []
            for j in range(c0 // tm, -(-c1 // tm)):
                a, b = max(c0, j * tm), min(c1, (j + 1) * tm)
                band.append((self.mesh.slot(i, j),
                             slice(lo - i * tn, hi - i * tn),
                             slice(a - j * tm, b - j * tm)))
            bands.append(band)
        return bands

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

    def full(self, device) -> torch.Tensor:
        """The whole leaf gathered on ``device`` (a host or a device
        that can hold it: the similarity job's output, a test). Every
        tile must be this process's (``multihost.regions`` assembles
        blocks across ranks)."""
        n, m = self.shape
        return assemble([[self.tiles[s][r, c].to(device) for s, r, c in band]
                         for band in self.region_pieces(0, n, 0, m)])


def assemble(bands: list[list[torch.Tensor]]) -> torch.Tensor:
    """Row bands of pieces (left to right) joined into one block."""
    rows = [b[0] if len(b) == 1 else torch.cat(b, dim=1) for b in bands]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
