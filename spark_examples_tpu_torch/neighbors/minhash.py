"""Streamed MinHash signatures over variant carrier sets.

Each sample's "document" is the set of variants where it carries an
alternate allele (``G >= 1``). A k-permutation MinHash sketches that set
into a fixed (N, k) signature whose per-column collision probability is
the Jaccard similarity of the carrier sets, which the LSH banding stage
(lsh.py) exploits.

The permutations are the multiply-add family over the uint32 ring,
``h_i(j) = a_i * j + b_i (mod 2**32)`` with odd ``a_i``, both drawn from
``--minhash-seed`` (:func:`hash_params`, identical to the JAX package's)
and recomputed on resume, never checkpointed. ``j`` is the variant's
global stream index (the state's ``nvar`` cursor plus the in-block
offset), so a resumed run hashes every variant to the same values as an
uninterrupted one. Padding columns (all missing) carry no alt call and
update nothing, but they do consume index slots, as in the JAX package:
the index stream is fixed by ``--block-variants``.

PyTorch has no uint32 arithmetic, so the state lives on the device as
int64 holding values in [0, 2^32): the product ``a_i * j`` is split at
16 bits of ``a_i`` so that no intermediate leaves int64, and each sum is
masked to 32 bits, which is the uint32 result exactly. The state crosses
to uint32 at the boundaries: the checkpoint's ``sig`` (N, k) and
``nvar`` (a scalar) leaves, which the JAX package writes as uint32, and
the returned signatures.
"""

from __future__ import annotations

import numpy as np
import torch

# Checkpointable accumulator leaves (core/checkpoint.py saves them like
# any sketch state; hashes/bands/seed ride in the manifest's extra).
STATE_LEAVES = ("nvar", "sig")

MASK32 = 0xFFFFFFFF

# Live bytes of the (hashes, N, v) int64 candidate tensor one chunk of
# the hash loop may hold; the chunk shrinks to one hash when even that
# exceeds it.
CHUNK_BYTES = 256 << 20


def hash_params(hashes: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic ``(a, b)`` uint32 multiply-add coefficients of the k
    permutations, ``a`` forced odd (a unit of the uint32 ring, so each
    h_i is a bijection on variant indices)."""
    rng = np.random.default_rng(np.uint64(seed & 0xFFFFFFFFFFFFFFFF))
    a = rng.integers(0, 1 << 32, size=hashes, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 1 << 32, size=hashes, dtype=np.uint32)
    return a, b


def init_state(n: int, hashes: int, device) -> dict:
    """Fresh signature state: all-ones signatures (the identity of the
    running min) and a zero variant cursor, int64 on ``device``."""
    return {
        "nvar": torch.zeros((), dtype=torch.int64, device=device),
        "sig": torch.full((n, hashes), MASK32, dtype=torch.int64,
                          device=device),
    }


def hash_values(a: torch.Tensor, b: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """(c,) coefficients x (v,) indices -> (c, v) ``a * idx + b mod
    2^32`` as int64: ``a = a_hi 2^16 + a_lo``, so ``a * idx mod 2^32 =
    ((a_hi idx mod 2^16) << 16) + a_lo idx (mod 2^32)``, every term
    below 2^49."""
    a_hi = (a >> 16)[:, None]
    a_lo = (a & 0xFFFF)[:, None]
    i = idx[None, :]
    return ((((a_hi * i) & 0xFFFF) << 16) + a_lo * i + b[:, None]) & MASK32


def update(state: dict, block: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> dict:
    """One (N, v) int8 block into the signatures: for every hash i,
    ``sig[:, i] = min(sig[:, i], min over carried variants of h_i(j))``.
    The hash loop runs in chunks sized by :data:`CHUNK_BYTES`, so no
    (N, k, v) tensor is ever live."""
    carriers = block >= 1  # (N, v); missing (-1) and padding are inert
    n, v = carriers.shape
    k = a.shape[0]
    idx = (state["nvar"] + torch.arange(v, dtype=torch.int64,
                                        device=block.device)) & MASK32
    step = max(1, min(k, CHUNK_BYTES // max(1, 8 * n * v)))
    sig = state["sig"]
    umax = torch.tensor(MASK32, dtype=torch.int64, device=block.device)
    for lo in range(0, k, step):
        h = hash_values(a[lo:lo + step], b[lo:lo + step], idx)  # (c, v)
        cand = torch.where(carriers[None, :, :], h[:, None, :], umax)
        mins = cand.amin(dim=2).T  # (N, c)
        sig[:, lo:lo + step] = torch.minimum(sig[:, lo:lo + step], mins)
    return {"nvar": (state["nvar"] + v) & MASK32, "sig": sig}


def make_update(hashes: int, seed: int, device):
    """``(state, block) -> state`` with the seed's coefficients placed on
    ``device`` once."""
    a_np, b_np = hash_params(hashes, seed)
    a = torch.from_numpy(a_np.astype(np.int64)).to(device)
    b = torch.from_numpy(b_np.astype(np.int64)).to(device)

    def _update(state, block):
        return update(state, block, a, b)

    return _update


def to_checkpoint(state: dict) -> dict:
    """The device state as the JAX package's uint32 leaves: ``nvar`` a
    0-d array, ``sig`` (N, k)."""
    return {k: np.asarray(v.cpu().numpy(), dtype=np.uint32)
            for k, v in state.items()}


def from_checkpoint(leaves: dict, device) -> dict:
    """uint32 leaves (as the checkpoint loads them) -> the int64 device
    state."""
    return {
        k: torch.from_numpy(np.asarray(
            v.numpy() if isinstance(v, torch.Tensor) else v,
            dtype=np.int64)).to(device)
        for k, v in leaves.items()
    }


def signatures(state: dict) -> np.ndarray:
    """The (N, k) uint32 signatures on the host."""
    return state["sig"].cpu().numpy().astype(np.uint32)


def state_bytes(n: int, hashes: int) -> int:
    """Signature-state residency as the JAX package counts it: one
    (N, k) uint32 leaf (the port holds it as int64, twice that)."""
    return n * hashes * 4
