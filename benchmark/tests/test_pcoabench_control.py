"""The control (the reference one precision below float32) has to come
out not correct: on the CPU at a size a test run holds, and on the card
at each cell's own size (marked ``gpu``; the chip's run of
``python3 -m benchmark.reference.control`` is the same code)."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import Spec
from benchmark.reference.control import control_readings
from conftest import ROOT, TINY_CELLS

CELLS = [w["name"] for w in Spec(ROOT).bench["workloads"]]


@pytest.mark.parametrize("seed", [1, 2**33 + 3])
def test_control_fails_at_test_size(tiny_root, seed):
    out = control_readings(Spec(tiny_root), TINY_CELLS[1], seed, "cpu")
    assert out["control_not_correct"], out


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    for seed in (11, 12, 13):
        out = control_readings(Spec(ROOT), cell, seed,
                               torch.device("cuda", 0))
        assert out["control_not_correct"], out
