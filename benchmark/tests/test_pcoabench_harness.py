"""The harness end to end on the CPU, with the program's plain versions,
on the tiny cells of ``conftest.py``; and the faults a cell can have,
planted under the timed path, each turning ``correct`` false."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import Spec, forbidden_modules, run_cell
from conftest import ADDED_METRIC, ROOT, TINY_CELLS


def _run(root, cell, trace=False, seed=2**33 + 5):
    return run_cell(Spec(root), cell, seed, 0.3, trace, time.time(),
                    device="cpu", log=lambda msg: None)


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_end_to_end(tiny_root, cell, trace):
    res = _run(tiny_root, cell, trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"eig_gap", "resid", "orth"}
    names = set(res["metrics"])
    if not trace:
        # No card: no device memory peak to read.
        assert names == {"pcoa_job_s", "setup_s"}
        assert 0 < res["metrics"]["pcoa_job_s"]["value"] < 0.3 + 5
        return
    # The CPU has no device trace: the trace's readers find nothing.
    expected = {"gram_s", "feed_wait_frac", "finalize_s", "eigh_s"}
    if cell == "tiny.store":
        expected.add(ADDED_METRIC)  # only a job opening a store has it
    assert names == expected
    assert 0 <= res["metrics"]["feed_wait_frac"]["value"] <= 1
    assert "breakdown" in res


def test_same_seed_same_outputs(tiny_root):
    a, b = (_run(tiny_root, "tiny.memory", seed=7) for _ in range(2))
    assert a["checks"] == b["checks"]


def _half_blocks(orig):
    def packed_blocks(self, *args, **kwargs):
        for i, item in enumerate(orig(self, *args, **kwargs)):
            if i % 2 == 0:
                yield item
    return packed_blocks


def _one_coordinate_altered(orig):
    def coords_from_eigpairs(vals, vecs):
        out = orig(vals, vecs).clone()
        out[3, 0] *= 1.1
        return out
    return coords_from_eigpairs


FAULTS = {
    # The gram step returns its state unchanged.
    "state_unchanged": ("spark_examples_tpu_torch.parallel.gram_sharded",
                        "make_update",
                        lambda orig: (lambda *a, **k: lambda acc, blk: acc)),
    # Half of each job's blocks left out.
    "half_the_blocks": ("spark_examples_tpu_torch.ingest.packed",
                        "Packed2BitSource.packed_blocks", _half_blocks),
    # One coordinate altered where the job produces it.
    "answer_altered": ("spark_examples_tpu_torch.models.pcoa",
                       "coords_from_eigpairs", _one_coordinate_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_correct(tiny_root, monkeypatch, fault):
    import importlib

    module, attr, make = FAULTS[fault]
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    res = _run(tiny_root, "tiny.memory")
    assert not res["correct"], res["checks"]


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for a host without one")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gnomad2g-15708.chr22-memory", "--seed", "1", "--seconds",
         "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_names():
    mods = ["spark_examples_tpu_torch.ops", "numpy", "jaxtyping"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["spark_examples_tpu.core"]) == [
        "spark_examples_tpu"]
    assert forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]


def test_cell_file_must_agree(tiny_root):
    path = tiny_root / "benchmark" / "workloads" / "tiny.memory.json"
    path.write_text(path.read_text().replace('"chips": 1', '"chips": 4'))
    with pytest.raises(ValueError, match="chips"):
        Spec(tiny_root).cell("tiny.memory")
