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
from spark_examples_tpu_torch.ops import (
    braycurtis_kernel,
    distances,
    gram,
    packed_gram,
)
from spark_examples_tpu_torch.pipelines import jobs, runner


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _random_packed(rng, n, w, device):
    return torch.from_numpy(
        rng.integers(0, 256, (n, w), dtype=np.uint8)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", kernels.fused_names())
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


_T = packed_gram.TILE
_C = packed_gram.CHUNK_BYTES


@pytest.mark.gpu
@pytest.mark.parametrize("metric", kernels.fused_names())
@pytest.mark.parametrize("n", [_T - 1, _T, _T + 1, 2 * _T + 1])
@pytest.mark.parametrize("w", [_C - 1, _C, _C + 1])
def test_symmetric_and_asymmetric_launches_at_tile_edges(cuda_device, metric,
                                                         n, w):
    """One tensor on both sides takes the I <= J tiles and mirrors them;
    a copy of it, and a column set of another size, take the full grid.
    All three are bitwise the plain version."""
    rng = np.random.default_rng(n * 1000 + w)
    rows = _random_packed(rng, n, w, cuda_device)
    cols = _random_packed(rng, n // 2 + 3, w, cuda_device)
    pieces = kernels.get(metric).pieces
    before = packed_gram.launches
    sym = packed_gram.fused_tile_products(rows, rows, pieces)
    full = packed_gram.fused_tile_products(rows, rows.clone(), pieces)
    asym = packed_gram.fused_tile_products(rows, cols, pieces)
    assert packed_gram.launches == before + 3
    want_sym = packed_gram.fused_tile_products_plain(rows, rows, pieces)
    want_asym = packed_gram.fused_tile_products_plain(rows, cols, pieces)
    torch.cuda.synchronize()
    for p in pieces:
        assert torch.equal(sym[p], want_sym[p]), f"symmetric {metric}/{p}"
        assert torch.equal(full[p], want_sym[p]), f"full grid {metric}/{p}"
        assert torch.equal(asym[p], want_asym[p]), f"asymmetric {metric}/{p}"


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_cuda_kernel_on_an_unaligned_block(cuda_device, symmetric):
    """A block that starts one byte into its buffer takes the byte-load
    staging; the result is the same."""
    rng = np.random.default_rng(11)
    n, w = 2 * _T + 5, 2 * _C
    buf = _random_packed(rng, n * w + 1, 1, cuda_device).view(-1)
    rows = buf[1:].view(n, w)
    assert rows.data_ptr() % 16 == 1
    cols = rows if symmetric else _random_packed(rng, 70, w, cuda_device)
    pieces = kernels.get("pc-invariant").pieces
    before = packed_gram.launches
    got = packed_gram.fused_tile_products(rows, cols, pieces)
    assert packed_gram.launches == before + 1
    want = packed_gram.fused_tile_products_plain(rows, cols, pieces)
    torch.cuda.synchronize()
    for p in pieces:
        assert torch.equal(got[p], want[p]), p


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


def _otu(seed, n, f):
    """Integer OTU-like counts with a zero-total row: every partial sum
    is exact in f32, so kernel and plain version agree bitwise."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.5, 40.0, size=(n, f)) * (rng.random((n, f)) > 0.6)
    x = x.astype(np.int32).astype(np.float32)
    x[n // 2] = 0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("n,f", [(1, 1), (37, 301), (65, 130), (300, 1025)])
def test_manhattan_kernel_matches_plain_bitwise(cuda_device, n, f):
    x = torch.from_numpy(_otu(n * 13 + f, n, f)).to(cuda_device)
    before = braycurtis_kernel.launches
    got = braycurtis_kernel.pairwise_manhattan_kernel(x)
    assert braycurtis_kernel.launches == before + 1
    want = distances.pairwise_manhattan(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (n, n)
    assert torch.equal(got, want)
    assert torch.equal(braycurtis_kernel.braycurtis_kernel(x),
                       distances.braycurtis(x))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [127, 128, 129, 257])
@pytest.mark.parametrize("f", [128, 129, 131])
def test_manhattan_kernel_at_tile_edges(cuda_device, n, f):
    """N around the 128-sample tile, F % 4 in {0, 1, 3} (the last two take
    the 4-byte staging): bitwise the plain version, both triangles."""
    x = torch.from_numpy(_otu(n * 7 + f, n, f)).to(cuda_device)
    before = braycurtis_kernel.launches
    got = braycurtis_kernel.pairwise_manhattan_kernel(x)
    assert braycurtis_kernel.launches == before + 1
    want = distances.pairwise_manhattan(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, got.T)


@pytest.mark.gpu
def test_manhattan_kernel_on_an_unaligned_table(cuda_device):
    n, f = 200, 64
    buf = torch.from_numpy(_otu(3, n * f + 1, 1)).to(cuda_device).view(-1)
    x = buf[1:].view(n, f)
    assert x.data_ptr() % 16 == 4
    before = braycurtis_kernel.launches
    got = braycurtis_kernel.pairwise_manhattan_kernel(x)
    assert braycurtis_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, distances.pairwise_manhattan(x))


@pytest.mark.gpu
def test_auto_runs_the_manhattan_kernel_once_per_braycurtis_job(cuda_device):
    assert distances.resolve_braycurtis_method("auto", cuda_device) == "fused"
    job = JobConfig(
        ingest=IngestConfig(n_samples=90, n_variants=700,
                            block_variants=256),
        compute=ComputeConfig(metric="braycurtis", num_pc=3, device="cuda"))
    before = braycurtis_kernel.launches
    out = jobs.pcoa_job(job, source=SyntheticSource(n_samples=90,
                                                    n_variants=700))
    assert braycurtis_kernel.launches == before + 1
    assert out.coords.shape == (90, 3) and np.isfinite(out.coords).all()
    exact = runner.braycurtis_distance(
        job.replace(compute=ComputeConfig(metric="braycurtis", device="cuda",
                                          braycurtis_method="exact")),
        SyntheticSource(n_samples=90, n_variants=700), PhaseTimer())
    fused = runner.braycurtis_distance(
        job, SyntheticSource(n_samples=90, n_variants=700), PhaseTimer())
    assert torch.equal(exact, fused)
