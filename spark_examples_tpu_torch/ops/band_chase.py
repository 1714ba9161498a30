"""Band to tridiagonal by bulge chasing, the second stage of the subset
solve's reduction, and the way back for its eigenvectors.

The input is the symmetric matrix left by the first stage
(``ops/eigh.py::dense_to_band``) in the solve's working copy ``a``
(n, n), read as cuSOLVER reads it: column-major, so ``A(i, j)`` is
``a[j, i]``. Its lower band of width b (``A(i, j)`` for 0 <= i - j <= b)
is the banded matrix; the first stage's reflectors lie below it. The
strict upper triangle of ``A`` (``a``'s strict lower) is free.

- :func:`chase`: copies the band into a compact ``(n, 2b)`` buffer
  (``band[j, d] = A(j + d, j)``: the band and room for the bulge), then
  runs sweep s = 0 .. n - 1: its first reflector annihilates column s
  below its first subdiagonal, and the bulge that makes is chased down
  the band b rows a step, each step one reflector (LAPACK ``sb2st``'s
  column-wise scheme). T's diagonal, off-diagonal and a status (0, or
  nonzero for a non-finite T or a stalled chase) go into ``tri`` (2n
  float32, the status as the last slot's int32). Sweep s's reflectors
  tile rows s + 1 .. n - 1, b rows each, so with the unit head of each
  left implicit they fill exactly the n - 1 - s slots of ``a[n - 1 - s,
  :n - 1 - s]``: reflector j's tau at slot ``j * b``, its tail after it.
- :func:`apply_q2`: ``C := Q2 C`` for the k columns ``c`` (k, n), from
  the last sweep to the first.

For a CUDA ``a`` both launch the hand-written kernels of
``csrc/band_chase.cu`` (built at first use by ``ops/cuda_build.py``) or
raise; for a CPU ``a``, and only for that, the plain numpy versions
:func:`chase_plain` and :func:`apply_q2_plain` run the same arithmetic
in the same storage. ``launches`` counts the CUDA launches of the chase,
``q2_launches`` those of the back-transform.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spark_examples_tpu_torch.core.profiling import check_at_barrier

# The widest band the kernel takes (MAX_B in csrc/band_chase.cu), and
# the columns a back-transform block takes (Q2_COLS there).
MAX_BAND = 64
Q2_COLS = 8
# ``band_chase``'s parameters before its stream: a, n, b, band, work,
# tri; ``band_apply_q2``'s: a, n, b, c, k, work.
_CHASE_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
_Q2_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)

launches = 0
q2_launches = 0


def _check(a: torch.Tensor, b: int) -> int:
    n = a.shape[0]
    if (a.dtype != torch.float32 or a.ndim != 2 or a.shape[1] != n
            or not a.is_contiguous()):
        raise ValueError("expected a contiguous square float32 matrix, got "
                         f"{a.dtype} {tuple(a.shape)}")
    if not 2 <= b <= MAX_BAND:
        raise ValueError(f"band width {b} outside [2, {MAX_BAND}]")
    return n


def chase(a: torch.Tensor, b: int, tri: torch.Tensor) -> None:
    """Reduce the band of width ``b`` held in ``a`` to T: d into
    ``tri[:n]``, e into ``tri[n:2n - 1]``, the status into the last slot
    (int32), the reflectors into ``a``'s strict lower triangle."""
    global launches
    n = _check(a, b)
    if a.device.type == "cpu":
        chase_plain(a, b, tri)
        return
    from spark_examples_tpu_torch.ops import cuda_build

    band = torch.empty((n, 2 * b), dtype=torch.float32, device=a.device)
    work = torch.empty(n + 1, dtype=torch.int32, device=a.device)
    cuda_build.launch("band_chase", "band_chase", _CHASE_ARGTYPES, a.device,
                      (a.data_ptr(), n, b, band.data_ptr(), work.data_ptr(),
                       tri.data_ptr()),
                      "band chase kernel", f"at n {n}, b {b}")
    launches += 1


def apply_q2(a: torch.Tensor, b: int, c: torch.Tensor) -> None:
    """``C := Q2 C`` in place for the columns ``c`` (k, n) contiguous, Q2
    the reflectors :func:`chase` left in ``a``. On the card its status
    (a stalled pipeline) is read at the next barrier."""
    global q2_launches
    n = _check(a, b)
    k = c.shape[0]
    if (c.shape != (k, n) or c.dtype != torch.float32
            or not c.is_contiguous()):
        raise ValueError(f"expected contiguous float32 (k, {n}) columns, "
                         f"got {c.dtype} {tuple(c.shape)}")
    if a.device.type == "cpu":
        apply_q2_plain(a, b, c)
        return
    from spark_examples_tpu_torch.ops import cuda_build

    blocks = (n - 2) // b + 1 if n >= 2 else 0
    work = torch.empty(2 + blocks * -(-k // Q2_COLS), dtype=torch.int32,
                       device=a.device)
    cuda_build.launch("band_chase", "band_apply_q2", _Q2_ARGTYPES, a.device,
                      (a.data_ptr(), n, b, c.data_ptr(), k, work.data_ptr()),
                      "band back-transform kernel", f"at n {n}, b {b}, k {k}")
    q2_launches += 1
    check_at_barrier(work[1:2], "band_apply_q2")


def _householder(x: np.ndarray) -> tuple[float, float, np.ndarray]:
    """LAPACK ``larfg`` on ``x`` (float32): (beta, tau, v), ``v[0] = 1``,
    with ``(I - tau v v^T) x = beta e_1``; tau 0 where x's tail is 0."""
    v = np.zeros_like(x)
    v[0] = 1.0
    alpha = x[0]
    xnorm2 = np.float32(np.dot(x[1:], x[1:]))
    if xnorm2 == 0:
        return alpha, np.float32(0.0), v
    beta = -np.copysign(np.sqrt(alpha * alpha + xnorm2), alpha)
    v[1:] = x[1:] / (alpha - beta)
    return beta, (beta - alpha) / beta, v


def band_of(a: np.ndarray, b: int) -> np.ndarray:
    """The compact band of ``A`` (``a`` read column-major): (n, 2b),
    ``band[j, d] = A(j + d, j)`` for d <= b, zeros past it."""
    n = a.shape[0]
    band = np.zeros((n, 2 * b), a.dtype)
    for d in range(min(b, n - 1) + 1):
        band[:n - d, d] = np.diagonal(a, d)
    return band


def chase_plain(a: torch.Tensor, b: int, tri: torch.Tensor) -> None:
    """:func:`chase` in numpy, float32, a step at a time."""
    am = a.numpy()
    n = am.shape[0]
    band = band_of(am, b)
    flat = band.reshape(-1)
    ld = 2 * b
    rr, cc = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    d_off = cc * ld + rr - cc           # D(r, c), r >= c
    o_off = cc * ld + b + rr - cc       # O(r, c): rows below a full block
    for s in range(n - 2):
        store = am[n - 1 - s, :n - 1 - s]
        v = tau = None
        for j, st in enumerate(range(s + 1, n, b)):
            ed = min(st + b, n) - 1
            size = ed - st + 1
            if j == 0:
                col = band[s, 1:size + 1]
                beta, tau, v = _householder(col.copy())
                col[0], col[1:] = beta, 0.0
            store[j * b] = tau
            store[j * b + 1:j * b + size] = v[1:]
            lower = np.tril(np.ones((size, size), bool))
            idx = st * ld + d_off[:size, :size]
            blk = np.where(lower, flat[idx], 0.0).astype(np.float32)
            blk = blk + np.tril(blk, -1).T
            w = tau * (blk @ v)
            w += np.float32(-0.5) * tau * np.dot(w, v) * v
            blk -= np.outer(v, w) + np.outer(w, v)
            flat[idx[lower]] = blk[lower]
            if ed == n - 1:
                break
            rows = min(ed + b, n - 1) - ed
            idx = st * ld + o_off[:rows, :size]
            off = flat[idx]
            off -= tau * np.outer(off @ v, v)
            beta, tau, v = _householder(off[:, 0].copy())
            off[0, 0], off[1:, 0] = beta, 0.0
            off[:, 1:] -= np.outer(v, tau * (v @ off[:, 1:]))
            flat[idx] = off
    if n >= 2:
        am[1, 0] = 0.0  # sweep n - 2: one slot, no reflector
    out = tri.numpy()
    out[:n] = band[:, 0]
    out[n:2 * n - 1] = band[:n - 1, 1]
    finite = np.isfinite(out[:2 * n - 1]).all()
    tri[-1:].view(torch.int32).fill_(0 if finite else 1)


def apply_q2_plain(a: torch.Tensor, b: int, c: torch.Tensor) -> None:
    """:func:`apply_q2` in numpy, float32: sweeps last to first, each
    sweep's reflectors (disjoint rows) in any order."""
    am = a.numpy()
    n = am.shape[0]
    x = c.numpy().T
    for s in range(n - 3, -1, -1):
        store = am[n - 1 - s, :n - 1 - s]
        for j0 in range(0, n - 1 - s, b):
            tau = store[j0]
            if tau == 0:
                continue
            size = min(b, n - 1 - s - j0)
            v = np.empty(size, np.float32)
            v[0] = 1.0
            v[1:] = store[j0 + 1:j0 + size]
            r0 = s + 1 + j0
            blk = x[r0:r0 + size]
            blk -= np.outer(v, tau * (v @ blk))
