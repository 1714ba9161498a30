"""The top-k eigensolve on one card: the full solve against the subset
solves, at the sizes the dense route meets.

    python3 -m tools.eigh_probe [--sizes 2504,10000,15708] [--k 10] \
        [--out probe.jsonl]

For each size N it draws a PCoA-class matrix on the card (N samples in
groups with drifted centroids over 2N features, column-centered, ``B =
X X^T`` in float64: a few group axes over a Marchenko-Pastur bulk, whose
edge holds the k-th eigenvalue), takes its top-k eigenvalues in float64
as the reference, and solves its float32 copy three ways:

- ``full``: ``torch.linalg.eigh`` (cuSOLVER ``syevd``), then the top k;
- ``syevdx``: ``cusolverDnSsyevdx`` over the index range ``N-k+1..N``;
- ``subset``: ``ops/eigh.py::subset_eigh``, the reduction on the card,
  the tridiagonal's top k on the host, k vectors transformed back.

Each is timed by the host clock between synchronisations (a warm-up,
then ``--reps`` runs), traced once under ``torch.profiler`` (the card's
busy share of the solve and its costliest kernels), its peak of
allocated memory read, and judged by ``benchmark/reference/compare.py``
(``eig_gap``, ``resid``, ``orth`` against the float64 matrix). One JSON
line a (size, route) goes to stdout, and is appended to ``--out`` where
given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
import types
from pathlib import Path

import torch

from benchmark.reference.compare import judge
from benchmark.trace import capture, summarize
from spark_examples_tpu_torch.ops import cusolver
from spark_examples_tpu_torch.ops import eigh as eigh_ops

def cohort_matrix(n: int, groups: int, seed: int, device) -> torch.Tensor:
    """``B = X_c X_c^T / p`` in float64: n samples in ``groups`` groups
    of random sizes, each row its group's centroid (0.3 per feature)
    plus unit noise, over p = 2n features, columns centered."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = 2 * n
    label = torch.randint(groups, (n,), generator=g, device=device)
    centroids = 0.3 * torch.randn((groups, p), generator=g, device=device,
                                  dtype=torch.float64)
    x = centroids[label] + torch.randn((n, p), generator=g, device=device,
                                       dtype=torch.float64)
    x -= x.mean(dim=0)
    b = x @ x.T / p
    return 0.5 * (b + b.T)


def full_top_k(b, k):
    vals, vecs = torch.linalg.eigh(b)
    return vals.flip(0)[:k], vecs.flip(1)[:, :k]


# cusolverEigMode_t CUSOLVER_EIG_MODE_VECTOR, cusolverEigRange_t
# CUSOLVER_EIG_RANGE_I; handle, jobz, range, uplo, n, A, lda, vl, vu,
# il, iu, meig, W, then lwork, or work, lwork and devInfo.
_SYEVDX_HEAD = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p)
_SYEVDX = {
    "cusolverDnSsyevdx_bufferSize": (*_SYEVDX_HEAD,
                                     ctypes.POINTER(ctypes.c_int)),
    "cusolverDnSsyevdx": (*_SYEVDX_HEAD, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p),
}


def syevdx_top_k(b, k):
    """``cusolverDnSsyevdx`` over the indices ``N-k+1..N`` (ascending),
    its vectors in the first k columns of its column-major copy."""
    lib, _ = cusolver.library()
    for name, argtypes in _SYEVDX.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = (ctypes.c_void_p, *argtypes), ctypes.c_int
    n = b.shape[0]
    a = b.clone(memory_format=torch.contiguous_format)
    w = torch.empty(n, dtype=torch.float32, device=b.device)
    info = torch.empty(1, dtype=torch.int32, device=b.device)
    found, lwork = ctypes.c_int(), ctypes.c_int()
    head = (1, 1002, cusolver.LOWER, n, a.data_ptr(), n, 0.0, 0.0,
            n - k + 1, n, ctypes.byref(found), w.data_ptr())
    cusolver.call(b.device, "cusolverDnSsyevdx_bufferSize", *head,
                  ctypes.byref(lwork))
    work = torch.empty(max(lwork.value, 1), dtype=torch.float32,
                       device=b.device)
    cusolver.call(b.device, "cusolverDnSsyevdx", *head, work.data_ptr(),
                  lwork.value, info.data_ptr())
    if found.value != k or int(info.item()) != 0:
        raise RuntimeError(f"syevdx found {found.value} of {k}, "
                           f"info {info.item()}")
    return w[:k].flip(0), a[:k].flip(0).T


ROUTES = {"full": full_top_k, "subset": eigh_ops.subset_eigh,
          "syevdx": syevdx_top_k}


def host_seconds(fn):
    """``fn`` wrapped to add its host seconds to the wrapper's ``spent``."""
    def wrapper(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            wrapper.spent += time.perf_counter() - t0
    wrapper.spent = 0.0
    return wrapper


def probe(n: int, k: int, reps: int, seed: int, device) -> list[dict]:
    b64 = cohort_matrix(n, 7 if n > 5000 else 5, seed, device)
    t0 = time.perf_counter()
    ref_vals = torch.linalg.eigvalsh(b64).flip(0)[:k]
    torch.cuda.synchronize()
    ref = types.SimpleNamespace(b=b64, vals=ref_vals)
    b = b64.float()
    print(f"# n {n}: reference eigvalsh {time.perf_counter() - t0:.2f} s, "
          f"lam_1..{k + 1} / lam_1 = "
          f"{[round(float(v / ref_vals[0]), 6) for v in ref_vals]}",
          flush=True)
    rows = []
    for route, fn in ROUTES.items():
        try:
            fn(b, k)  # warm: the library, its handle, the workspace sizes
        except RuntimeError as exc:  # a route the library refuses
            rows.append({"n": n, "k": k, "route": route, "error": str(exc)})
            print(json.dumps(rows[-1]), flush=True)
            continue
        torch.cuda.synchronize()
        walls = []
        original = eigh_ops.tridiagonal_top_k
        tri = eigh_ops.tridiagonal_top_k = host_seconds(original)
        try:
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                vals, vecs = fn(b, k)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with capture(True, True) as trace:
                with torch.profiler.record_function("phase.solve"):
                    vals, vecs = fn(b, k)
                    torch.cuda.synchronize()
        finally:
            eigh_ops.tridiagonal_top_k = original
        peak = torch.cuda.max_memory_allocated() - base
        window = [e for e in trace["events"] if e["name"] == "phase.solve"]
        summary = summarize(trace["events"], 1)
        window_s = window[0]["dur"] * 1e-6
        coords = vecs * torch.sqrt(vals.clamp(min=0.0))
        readings = judge(ref, coords.double().cpu().numpy(),
                         vals.double().cpu().numpy())
        row = {
            "n": n, "k": k, "route": route,
            "wall_s": sorted(walls), "traced_window_s": window_s,
            "busy_s": summary["busy_s"],
            "idle_frac": 1.0 - summary["busy_s"] / window_s,
            "host_tridiagonal_s": tri.spent / (reps + 1),
            "peak_extra_bytes": peak,
            **readings,
            "top_ops": [[name[:90], round(s, 6)]
                        for name, s in summary["device_ops"][:8]],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        del vals, vecs, coords
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default="2504,10000,15708")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=2600000001)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    with open("/proc/self/maps") as maps:
        loaded = sorted({line.split()[-1] for line in maps
                         if "libcusolver.so" in line})
    print(f"# cuSOLVER loaded before its first call: {loaded}", flush=True)
    _, lib_path = cusolver.library()
    print(f"# {torch.cuda.get_device_name(0)}; {smi.strip()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; cuSOLVER "
          f"{lib_path}", flush=True)
    for n in (int(s) for s in args.sizes.split(",")):
        rows = probe(n, args.k, args.reps, args.seed + n, device)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as out:
                out.writelines(json.dumps(row) + "\n" for row in rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
