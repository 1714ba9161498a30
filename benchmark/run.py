"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error). Without CUDA, with fewer cards
than the cell asks for, or with the JAX stack or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout, so only the
# first run in a checkout compiles (the port builds its own kernels into
# its package's ``_build/``).
CACHE = ROOT / ".pcoabench_cache"


def _process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux
    ``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    t_start = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The checkout's root in place of this script's directory, whose
    # modules would otherwise shadow top-level names (``trace``).
    sys.path[0] = str(ROOT)
    from benchmark.harness import Spec, forbidden_modules, run_cell

    spec = Spec(ROOT)
    chips = int(spec.cell(args.workload)["chips"])
    os.environ.setdefault("CUDA_VISIBLE_DEVICES",
                          ",".join(str(i) for i in range(chips)))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        c["value"] = _finite(c["value"])
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
