"""Run a job of several port processes on localhost, for the tests.

Each rank is ``python -c <worker>`` with the JAX package's environment
names (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``), so it joins ``torch.distributed`` the way a user's
job does. The worker source gets a prelude defining ``RANK`` and
``emit(**values)``, which prints one JSON line carrying the rank and
the JAX modules the rank has loaded (the import boundary, checked in the
rank itself). Not collected: the test files import it.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import json as _json, os as _os, sys as _sys
RANK = int(_os.environ["JAX_PROCESS_ID"])


def emit(**values):
    values["process"] = RANK
    values["foreign"] = sorted(
        m for m in _sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "spark_examples_tpu"))
    print(_json.dumps(values), flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int,
             extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env.update(
        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
        JAX_NUM_PROCESSES=str(world),
        JAX_PROCESS_ID=str(rank),
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    env.update(extra or {})
    return env


def _once(worker: str, world: int, extra_env, timeout: float):
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", PRELUDE + worker],
        env=rank_env(r, world, port, extra_env), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    results = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail("a rank timed out (a collective hung)")
            results.append((p.returncode, out, err))
    finally:
        for q in procs:  # reap the others on any way out
            if q.poll() is None:
                q.kill()
                q.wait(timeout=10)
    if any(rc != 0 for rc, _, _ in results):
        # gloo's TCP transport has a rare preamble race under load,
        # unrelated to the code under test: retried once, by its text.
        for rc, _, err in results:
            if rc != 0 and "gloo::EnforceNotMet" in err:
                return None, err[-2000:]
        rc, _, err = next(r for r in results if r[0] != 0)
        pytest.fail(f"rank failed (rc={rc}):\n{err[-3000:]}")
    outs = [json.loads(out.strip().splitlines()[-1])
            for _, out, _ in results]
    assert sorted(o["process"] for o in outs) == list(range(world))
    for o, (_, out, _) in zip(outs, results):
        assert o["foreign"] == [], o["foreign"]  # the import boundary
        o["stdout"] = out
    return outs, None


def run_ranks(worker: str, world: int = 2, extra_env: dict | None = None,
              timeout: float = 240.0) -> list[dict]:
    """Every rank's ``emit`` record (plus its ``stdout``), in rank
    order; fails the test when a rank fails or outlives ``timeout``."""
    err = None
    for _ in range(2):
        outs, err = _once(worker, world, extra_env, timeout)
        if outs is not None:
            return outs
    pytest.fail(f"gloo transport race persisted across a retry:\n{err}")
