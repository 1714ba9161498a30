"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. The build happens at
first use, into ``spark_examples_tpu_torch/_build/`` (ignored by git),
from the ``.cu`` sources in the package and nothing else; the library's
file name carries a hash of its source, so an edited source rebuilds.
A failed build raises: there is no fallback to the plain version.
Processes that build at once (the ranks of one job) take turns under an
advisory lock on ``_build/.lock``: the first builds, the others find the
library (the kernel releases a dead holder's lock). :func:`launch` is
the one way a wrapper calls a library's entry point.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# (source name, entry point) -> (the entry, the library's error string),
# their argtypes set.
_entries: dict[tuple[str, str], tuple] = {}
# source name -> the compiler's report (ptxas: registers, shared memory,
# spills) from the build this process ran or found.
reports: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin — the CUDA "
        "toolkit is needed to build the package's kernels"
    )


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    lib = _library_path(name)
    if lib.exists():
        log = lib.with_suffix(".log")
        reports[name] = log.read_text() if log.exists() else ""
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(name: str, started) -> None:
    proc, tmp, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu (exit {proc.returncode}):"
            f"\n{out}"
        )
    lib.with_suffix(".log").write_text(out)
    os.replace(tmp, lib)
    reports[name] = out


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Build every listed source (default: all of ``csrc/*.cu``), one
    nvcc per source, all started together. Returns the reports."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # The lock file is opened before the thread lock is taken, so no file
    # I/O waits inside the critical section; the flock (the processes'
    # turn) and the thread lock (this process's threads) are then held
    # across the builds.
    with open(BUILD_DIR / ".lock", "w") as lock:
        with _lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            started = {n: _start_build(n) for n in names}
            for n, s in started.items():
                if s is not None:
                    _finish_build(n, s)
    return {n: reports.get(n, "") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]


def launch(name: str, entry: str, argtypes: tuple, device, args: tuple,
           kernel: str, context: str) -> None:
    """Call ``entry`` of ``csrc/<name>.cu``'s library: ``entry(*args,
    stream)``, ``stream`` the current stream of ``device`` (every entry
    point's last parameter), with ``device`` current. The library is
    loaded and the entry's ``argtypes`` (its parameters before the
    stream) set at the first call. A nonzero return raises
    ``RuntimeError("<kernel> launch failed: CUDA error <rc> (<text>)
    <context>")``, the text from the library's ``<name>_error_string``."""
    fns = _entries.get((name, entry))
    if fns is None:
        lib = load(name)
        fn = getattr(lib, entry)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        error_string = getattr(lib, f"{name}_error_string")
        error_string.argtypes = [ctypes.c_int]
        error_string.restype = ctypes.c_char_p
        fns = _entries[(name, entry)] = (fn, error_string)
    fn, error_string = fns
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {rc} "
            f"({error_string(rc).decode()}) {context}"
        )
