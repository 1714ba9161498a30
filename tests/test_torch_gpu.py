"""Tests of the PyTorch port that need an NVIDIA GPU.

They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card each skips, deciding inside the ``cuda_device`` fixture.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ops import gram, packed_gram
from spark_examples_tpu_torch.pipelines import runner


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the packed-gram CUDA kernel has "
                    "no CPU mode")
    return torch.device("cuda")


def _random_packed(rng, n, w, device):
    return torch.from_numpy(
        rng.integers(0, 256, (n, w), dtype=np.uint8)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", kernels.names())
@pytest.mark.parametrize("nr,nc,w", [(37, 21, 301), (1, 1, 1),
                                     (130, 65, 17)])
def test_cuda_kernel_matches_plain_bitwise(cuda_device, metric, nr, nc, w):
    rng = np.random.default_rng(nr * 7 + nc * 3 + w)
    rows = _random_packed(rng, nr, w, cuda_device)
    cols = _random_packed(rng, nc, w, cuda_device)
    pieces = kernels.get(metric).pieces
    before = packed_gram.launches
    got = packed_gram.fused_tile_products(rows, cols, pieces)
    assert packed_gram.launches == before + 1
    want = packed_gram.fused_tile_products_plain(rows, cols, pieces)
    torch.cuda.synchronize()
    for p in pieces:
        assert got[p].dtype == torch.int32
        assert torch.equal(got[p], want[p]), f"{metric}/{p}"


@pytest.mark.gpu
def test_auto_lowering_runs_the_kernel_on_cuda(cuda_device):
    assert gram.resolve_gram_lowering("auto", True, cuda_device) == "fused"
    job = JobConfig(
        ingest=IngestConfig(n_samples=70, n_variants=3000,
                            block_variants=1024),
        compute=ComputeConfig(metric="ibs", device="cuda"))
    src = SyntheticSource(n_samples=70, n_variants=3000)
    before = packed_gram.launches
    fused = runner.run_gram(job, src, PhaseTimer())
    assert fused.lowering == "fused"
    assert packed_gram.launches == before + 3
    ref = runner.run_gram(
        job.replace(compute=ComputeConfig(metric="ibs", device="cuda",
                                          gram_lowering="reference")),
        src, PhaseTimer())
    for leaf in fused.acc:
        assert torch.equal(fused.acc[leaf], ref.acc[leaf]), leaf
