"""cuSOLVER's dense symmetric routines, called through ``ctypes`` on the
library that torch's CUDA build loads.

- :func:`sytrd`: the Householder reduction of a symmetric matrix to
  tridiagonal form, ``T = Q^T A Q`` (``cusolverDnSsytrd``), in place.
- :func:`ormtr`: ``C := Q C`` for a block of columns, ``Q`` the
  reduction's reflectors (``cusolverDnSormtr``).
- :func:`geqrf`: the QR factorisation of a column-major panel in place
  (``cusolverDnSgeqrf``).
- :func:`call`: any other entry point, its ``argtypes`` set by the
  caller on the :func:`library`.

Matrices are float32 tensors on the card, contiguous: cuSOLVER reads a
row-major ``(n, n)`` tensor as its transpose, which is the same matrix
for a symmetric one, and a ``(k, n)`` tensor as ``n x k`` columns. Each
call runs on the device's current stream through one handle a device
(made at the device's first call, kept for the process), allocates its
workspace with ``torch.empty`` on the card, so the caching allocator
counts it, and writes cuSOLVER's ``devInfo`` into an int32 tensor the
caller gives and reads where it already waits. A call the library
refuses (a nonzero ``cusolverStatus_t``) raises at once.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

# cublasFillMode_t, cublasSideMode_t and cublasOperation_t values.
LOWER = 0
LEFT = 0
NO_TRANS = 0

_STATUS_NAMES = {
    1: "NOT_INITIALIZED", 2: "ALLOC_FAILED", 3: "INVALID_VALUE",
    4: "ARCH_MISMATCH", 5: "MAPPING_ERROR", 6: "EXECUTION_FAILED",
    7: "INTERNAL_ERROR", 8: "MATRIX_TYPE_NOT_SUPPORTED", 9: "NOT_SUPPORTED",
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "cusolverDnCreate": (ctypes.POINTER(ctypes.c_void_p),),
    "cusolverDnSetStream": (_P, _P),
    # handle, uplo, n, A, lda, d, e, tau, (lwork | work, lwork, devInfo)
    "cusolverDnSsytrd_bufferSize": (_P, _I, _I, _P, _I, _P, _P, _P, _IP),
    "cusolverDnSsytrd": (_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _P),
    # handle, side, uplo, trans, m, n, A, lda, tau, C, ldc,
    # (lwork | work, lwork, devInfo)
    "cusolverDnSormtr_bufferSize": (_P, _I, _I, _I, _I, _I, _P, _I, _P,
                                    _P, _I, _IP),
    "cusolverDnSormtr": (_P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P,
                         _I, _P),
    # handle, m, n, A, lda, (lwork | tau, work, lwork, devInfo)
    "cusolverDnSgeqrf_bufferSize": (_P, _I, _I, _P, _I, _IP),
    "cusolverDnSgeqrf": (_P, _I, _I, _P, _I, _P, _P, _I, _P),
}

_lock = threading.Lock()
_library: list = []  # [(ctypes.CDLL, its path)] once loaded
_handles: dict[int, ctypes.c_void_p] = {}


def _candidates():
    """Where the library may be: the copy this process has loaded
    already (torch's CUDA build links it), else the loader's search."""
    try:
        with open("/proc/self/maps") as maps:
            for line in maps:
                path = line.split()[-1]
                if os.path.basename(path).startswith("libcusolver.so"):
                    yield path
    except OSError:
        pass
    yield "libcusolver.so.11"


def library() -> tuple[ctypes.CDLL, str]:
    """The loaded cuSOLVER library and its path, every entry point's
    ``argtypes`` set; raises where none loads. (Threads that load it at
    once get the same library: the loader hands out one copy.)"""
    if _library:
        return _library[0]
    tried = []
    for path in _candidates():
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            tried.append(f"{path}: {exc}")
            continue
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        with _lock:
            if not _library:
                _library.append((lib, path))
            return _library[0]
    raise RuntimeError("cuSOLVER not found: " + "; ".join(tried))


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(
            f"{what} failed: cusolverStatus {status} "
            f"({_STATUS_NAMES.get(status, 'unknown')})")


def _handle(lib, index: int) -> ctypes.c_void_p:
    handle = _handles.get(index)
    if handle is None:
        handle = ctypes.c_void_p()
        _check(lib.cusolverDnCreate(ctypes.byref(handle)), "cusolverDnCreate")
        _handles[index] = handle
    return handle


def call(device, name: str, *args) -> None:
    """``name(handle, *args)`` with ``device`` current and the handle on
    its current stream; calls into one handle take turns."""
    lib, _ = library()
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    with torch.cuda.device(index):
        with _lock:
            handle = _handle(lib, index)
            _check(lib.cusolverDnSetStream(handle, stream),
                   "cusolverDnSetStream")
            _check(getattr(lib, name)(handle, *args), name)


def _square(a: torch.Tensor) -> int:
    if (a.dtype != torch.float32 or a.device.type != "cuda" or a.ndim != 2
            or a.shape[0] != a.shape[1] or not a.is_contiguous()):
        raise ValueError(
            "expected a contiguous square float32 CUDA matrix, got "
            f"{a.dtype} {tuple(a.shape)} on {a.device}")
    return a.shape[0]


def _workspace(device, lwork: ctypes.c_int) -> torch.Tensor:
    return torch.empty(max(lwork.value, 1), dtype=torch.float32,
                       device=device)


def sytrd(a: torch.Tensor, d: torch.Tensor, e: torch.Tensor,
          tau: torch.Tensor, info: torch.Tensor) -> None:
    """Reduce symmetric ``a`` (n, n) in place to ``T = Q^T a Q``: its
    diagonal into ``d`` (n,), its off-diagonal into ``e`` (n - 1,), the
    reflectors into ``a``'s strict lower triangle (column-major) and
    ``tau`` (n - 1,); ``devInfo`` into the int32 ``info``."""
    n = _square(a)
    ptrs = (a.data_ptr(), n, d.data_ptr(), e.data_ptr(), tau.data_ptr())
    lwork = ctypes.c_int()
    call(a.device, "cusolverDnSsytrd_bufferSize", LOWER, n, *ptrs,
         ctypes.byref(lwork))
    work = _workspace(a.device, lwork)
    call(a.device, "cusolverDnSsytrd", LOWER, n, *ptrs, work.data_ptr(),
         lwork.value, info.data_ptr())


def ormtr(a: torch.Tensor, tau: torch.Tensor, c: torch.Tensor,
          info: torch.Tensor) -> None:
    """``C := Q C`` in place, ``Q`` the reflectors :func:`sytrd` left in
    ``a`` and ``tau``, ``C`` the ``n x k`` columns of the contiguous
    ``c`` (k, n); ``devInfo`` into the int32 ``info``."""
    n = _square(a)
    k = c.shape[0]
    if c.shape != (k, n) or c.dtype != a.dtype or not c.is_contiguous():
        raise ValueError(f"expected contiguous float32 (k, {n}) columns, "
                         f"got {c.dtype} {tuple(c.shape)}")
    ptrs = (LEFT, LOWER, NO_TRANS, n, k, a.data_ptr(), n, tau.data_ptr(),
            c.data_ptr(), n)
    lwork = ctypes.c_int()
    call(a.device, "cusolverDnSormtr_bufferSize", *ptrs, ctypes.byref(lwork))
    work = _workspace(a.device, lwork)
    call(a.device, "cusolverDnSormtr", *ptrs, work.data_ptr(), lwork.value,
         info.data_ptr())



def geqrf(a: torch.Tensor, tau: torch.Tensor, info: torch.Tensor) -> None:
    """QR of the column-major ``a`` (m, w) in place (strides ``(1,
    lda)``: a column block of a contiguous matrix's transpose): R on and
    above its diagonal, the reflectors below it, their ``min(m, w)``
    taus into ``tau``; ``devInfo`` into the int32 ``info``."""
    m, w = a.shape
    lda = a.stride(1)
    if (a.dtype != torch.float32 or a.device.type != "cuda"
            or a.stride(0) != 1 or lda < max(1, m)):
        raise ValueError(
            "expected a column-major float32 CUDA panel, got "
            f"{a.dtype} {tuple(a.shape)} strides {a.stride()} on {a.device}")
    ptrs = (m, w, a.data_ptr(), lda)
    lwork = ctypes.c_int()
    call(a.device, "cusolverDnSgeqrf_bufferSize", *ptrs, ctypes.byref(lwork))
    work = _workspace(a.device, lwork)
    call(a.device, "cusolverDnSgeqrf", *ptrs, tau.data_ptr(), work.data_ptr(),
         lwork.value, info.data_ptr())
