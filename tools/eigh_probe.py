"""The top-k eigensolve on one card: the full solve against the subset
solves, at the sizes the dense route meets.

    python3 -m tools.eigh_probe [--sizes 2504,10000,15708] [--k 10,32] \
        [--routes full,subset,twostage] [--out probe.jsonl]

For each size N it draws a PCoA-class matrix on the card (N samples in
groups with drifted centroids over 2N features, column-centered, ``B =
X X^T`` in float64: a few group axes over a Marchenko-Pastur bulk, whose
edge holds the k-th eigenvalue), takes its top-k eigenvalues in float64
as the reference, and solves its float32 copy four ways, for each k:

- ``full``: ``torch.linalg.eigh`` (cuSOLVER ``syevd``), then the top k;
- ``syevdx``: ``cusolverDnSsyevdx`` over the index range ``N-k+1..N``;
- ``subset``: ``ops/eigh.py::subset_eigh`` held to one stage:
  cuSOLVER's reduction (``sytrd``), the tridiagonal's top k on the
  host, k vectors back through ``ormtr``;
- ``twostage``: ``subset_eigh`` held to two stages (dense to band, then
  the band chase at ``BAND_WIDTH``), the same host step, k vectors back
  through both stages; its stages also timed one by one between
  synchronisations (``stages_s``: band, chase, host, back).

Each is timed by the host clock between synchronisations (a warm-up,
then ``--reps`` runs), traced once under ``torch.profiler`` (the card's
busy share of the solve and its costliest kernels), its peak of
allocated memory read, and judged by ``benchmark/reference/compare.py``
(``eig_gap``, ``resid``, ``orth`` against the float64 matrix). One JSON
line a (size, k, route) goes to stdout, and is appended to ``--out`` where
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


def twostage_stages(b, k):
    """``subset_eigh``'s steps one by one, each ended by a
    synchronisation: the host seconds of the band, the chase, the host
    step (T's copy and its top k) and the back-transform."""
    from spark_examples_tpu_torch.ops import band_chase

    n = b.shape[0]
    width = eigh_ops.BAND_WIDTH
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    a = b.clone(memory_format=torch.contiguous_format)
    tri = torch.empty(2 * n, dtype=torch.float32, device=b.device)
    tees = eigh_ops.dense_to_band(a, width)
    mark()
    band_chase.chase(a, width, tri)
    mark()
    host = tri.cpu()
    _, vecs = eigh_ops.tridiagonal_top_k(host[:n].double().numpy(),
                                         host[n:-1].double().numpy(), k)
    mark()
    cols = torch.from_numpy(vecs.T.astype("float32")).to(b.device)
    band_chase.apply_q2(a, width, cols)
    eigh_ops.apply_q1(a, width, tees, cols)
    mark()
    return dict(zip(("band", "chase", "host", "back"),
                    (round(t1 - t0, 6) for t0, t1 in zip(marks, marks[1:]))))


ROUTES = {"full": full_top_k, "syevdx": syevdx_top_k,
          "subset": eigh_ops.subset_eigh, "twostage": eigh_ops.subset_eigh}


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


def probe(n: int, ks: list[int], reps: int, seed: int, device,
          routes) -> list[dict]:
    b64 = cohort_matrix(n, 7 if n > 5000 else 5, seed, device)
    t0 = time.perf_counter()
    all_vals = torch.linalg.eigvalsh(b64).flip(0)
    torch.cuda.synchronize()
    b = b64.float()
    top = all_vals[:max(ks)]
    print(f"# n {n}: reference eigvalsh {time.perf_counter() - t0:.2f} s, "
          f"lam_1..{max(ks)} / lam_1 = "
          f"{[round(float(v / top[0]), 6) for v in top]}", flush=True)
    rows = []
    rule = eigh_ops.TWO_STAGE_FROM
    for k in ks:
        ref = types.SimpleNamespace(b=b64, vals=all_vals[:k])
        for route in routes:
            try:
                # The subset solve held to one stage or to two.
                eigh_ops.TWO_STAGE_FROM = 0 if route == "twostage" else n + 1
                rows.append(_solve_row(n, k, reps, ref, b, route,
                                       ROUTES[route]))
            except RuntimeError as exc:  # a route the library refuses
                rows.append({"n": n, "k": k, "route": route,
                             "error": str(exc)})
            finally:
                eigh_ops.TWO_STAGE_FROM = rule
            print(json.dumps(rows[-1]), flush=True)
    return rows


def _solve_row(n, k, reps, ref, b, route, fn) -> dict:
    """One route's row: its walls, trace, peak, readings (and, on the
    two-stage route, its stages)."""
    fn(b, k)  # warm: the library, its handle, the workspace sizes
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
    stages = [twostage_stages(b, k) for _ in range(reps)] \
        if route == "twostage" else None
    window = [e for e in trace["events"] if e["name"] == "phase.solve"]
    summary = summarize(trace["events"], 1)
    window_s = window[0]["dur"] * 1e-6
    coords = vecs * torch.sqrt(vals.clamp(min=0.0))
    readings = judge(ref, coords.double().cpu().numpy(),
                     vals.double().cpu().numpy())
    return {
        "n": n, "k": k, "route": route,
        "band": eigh_ops.BAND_WIDTH if route == "twostage" else None,
        "wall_s": sorted(walls), "stages_s": stages,
        "traced_window_s": window_s, "busy_s": summary["busy_s"],
        "idle_frac": 1.0 - summary["busy_s"] / window_s,
        "host_tridiagonal_s": tri.spent / (reps + 1),
        "peak_extra_bytes": peak,
        **readings,
        "top_ops": [[name[:90], round(s, 6)]
                    for name, s in summary["device_ops"][:8]],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default="2504,10000,15708")
    parser.add_argument("--k", default="10")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=2600000001)
    parser.add_argument("--routes", default=",".join(ROUTES))
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
        rows = probe(n, [int(k) for k in args.k.split(",")], args.reps,
                     args.seed + n, device, args.routes.split(","))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as out:
                out.writelines(json.dumps(row) + "\n" for row in rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
