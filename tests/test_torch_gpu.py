"""Tests of the PyTorch port that need an NVIDIA GPU.

They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card each skips, deciding inside the ``cuda_device`` fixture.
"""

import os

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest import ldprune
from spark_examples_tpu_torch.ingest.packed import load_packed, save_packed
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.ops import (
    braycurtis_kernel,
    distances,
    genotype,
    gram,
    packed_gram,
)
from spark_examples_tpu_torch.pipelines import jobs, runner
from spark_examples_tpu_torch.store import compact


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
    counted = telemetry.counter_value("gram.fused_blocks")
    launched = telemetry.counter_value("kernel.packed_gram.launches")
    got = packed_gram.fused_tile_products(rows, cols, pieces)
    assert packed_gram.launches == before + 1
    assert telemetry.counter_value("kernel.packed_gram.launches") \
        == launched + 1
    # gram.fused_blocks counts block updates (the JAX meaning), not
    # launches: a launch outside an update adds none.
    assert telemetry.counter_value("gram.fused_blocks") == counted
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


def _assert_launch_matches_plain(rows, cols, products):
    before = packed_gram.launches
    got = packed_gram.fused_tile_products(rows, cols, products)
    assert packed_gram.launches == before + 1
    want = packed_gram.fused_tile_products_plain(rows, cols, products)
    torch.cuda.synchronize()
    for p in products:
        assert torch.equal(got[p], want[p]), p


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_persistent_blocks_walk_more_tiles_than_they_are(cuda_device,
                                                         symmetric):
    """More (sweep, tile) items than blocks: each block walks many, and
    every tile of every sweep lands once."""
    n = 20 * _T + 3
    rng = np.random.default_rng(20)
    rows = _random_packed(rng, n, 2 * _C, cuda_device)
    cols = rows if symmetric else _random_packed(rng, 17 * _T + 5, 2 * _C,
                                                 cuda_device)
    pieces = kernels.get("ibs").pieces
    plan = packed_gram.launch_plan(
        n, cols.shape[0], symmetric,
        len(packed_gram.contraction_plan(pieces, symmetric)),
        torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert plan["items"] > 2 * plan["grid"]
    _assert_launch_matches_plain(rows, cols, pieces)


@pytest.mark.gpu
def test_rectangular_launch_of_whole_tiles(cuda_device):
    """nr != nc, both multiples of the tile: the full grid, no ragged
    edge (the tiled route's off-diagonal launches)."""
    rng = np.random.default_rng(35)
    rows = _random_packed(rng, 3 * _T, 4 * _C, cuda_device)
    cols = _random_packed(rng, 5 * _T, 4 * _C, cuda_device)
    _assert_launch_matches_plain(rows, cols, kernels.get("ibs").pieces)


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_single_contraction_plan(cuda_device, symmetric):
    """shared-alt's one product, t1t1: every sweep holds one
    contraction."""
    rng = np.random.default_rng(1)
    rows = _random_packed(rng, 2 * _T + 1, 3 * _C, cuda_device)
    cols = rows if symmetric else _random_packed(rng, _T + 9, 3 * _C,
                                                 cuda_device)
    pieces = kernels.get("shared-alt").pieces
    assert pieces == ("t1t1",)
    _assert_launch_matches_plain(rows, cols, pieces)


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_seven_product_plan(cuda_device, symmetric):
    """Every 2-bit product at once: 7 contractions asymmetric, 11
    symmetric (four sweeps, six), the last sweep holding one."""
    seven = ("cc", "t1c", "t2c", "yc", "t1t1", "t1t2", "t2t2")
    assert len(seven) == packed_gram.MAX_PRODUCTS
    assert len(packed_gram.contraction_plan(seven, symmetric)) == (
        11 if symmetric else 7)
    rng = np.random.default_rng(7)
    rows = _random_packed(rng, _T + 37, 2 * _C + 16, cuda_device)
    cols = rows if symmetric else _random_packed(rng, 2 * _T + 1,
                                                 2 * _C + 16, cuda_device)
    _assert_launch_matches_plain(rows, cols, seven)


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("w", [3 * _C + 7, 3 * _C + 16])
def test_width_whose_tail_ends_inside_a_stage(cuda_device, symmetric, w):
    """The last stage holds fewer than CHUNK_BYTES bytes: a ragged byte
    tail (byte loads) and a whole 16-byte chunk (cp.async) followed by
    one the producer never copies. Whatever shared memory holds past w
    is masked."""
    rng = np.random.default_rng(w)
    rows = _random_packed(rng, _T + 5, w, cuda_device)
    cols = rows if symmetric else _random_packed(rng, 2 * _T - 3, w,
                                                 cuda_device)
    _assert_launch_matches_plain(rows, cols, kernels.get("ibs").pieces)


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


def _raw_table(seed, n, v):
    """Raw values 0..127 with 10 % missing; column 0 all 127 (qh = 126)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 128, (n, v)).astype(np.int8)
    x[rng.random((n, v)) < 0.1] = -1
    x[:, 0] = 127
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("n", [17, 24, 2504])
@pytest.mark.parametrize("v", [1, 13, 1000])
def test_int_mm_lowering_matches_int_dot_bitwise(cuda_device, n, v):
    """The dense products through torch._int_mm (rows and the inner axis
    padded with zero operands) equal the plain float64 contraction, for
    euclidean's and dot's product sets."""
    block = torch.from_numpy(_raw_table(n * 7 + v, n, v)).to(cuda_device)
    for metric in ("euclidean", "dot"):
        pieces = kernels.get(metric).pieces
        lib = genotype.gram_products(block, pieces, dot=genotype.int_mm)
        plain = genotype.gram_products(block, pieces, dot=genotype.int_dot)
        torch.cuda.synchronize()
        for p in pieces:
            assert lib[p].dtype == torch.int32
            assert torch.equal(lib[p], plain[p]), f"{metric}/{p}"


@pytest.mark.gpu
def test_dense_job_on_cuda_matches_its_cpu_run(cuda_device):
    table = _raw_table(3, 70, 2000)
    accs = {}
    for device in ("cuda", "cpu"):
        job = JobConfig(
            ingest=IngestConfig(block_variants=512),
            compute=ComputeConfig(metric="euclidean", device=device))
        before = packed_gram.launches
        g = runner.run_gram(job, ArraySource(table), PhaseTimer())
        assert packed_gram.launches == before  # dense: K1 never runs
        accs[device] = g.acc
    for leaf in accs["cpu"]:
        assert torch.equal(accs["cuda"][leaf].cpu(), accs["cpu"][leaf]), leaf


@pytest.mark.gpu
def test_packed_store_stream_through_k1_matches_the_reference(cuda_device,
                                                              tmp_path):
    """A packed store's bytes stream to the card as stored and K1
    contracts them: bitwise the reference lowering's accumulators."""
    src = SyntheticSource(n_samples=90, n_variants=3000, seed=4)
    g = np.concatenate([b for b, _ in src.blocks(4096)], axis=1)
    save_packed(str(tmp_path / "store"), g)
    accs = {}
    for lowering in ("auto", "reference"):
        job = JobConfig(
            ingest=IngestConfig(block_variants=1024),
            compute=ComputeConfig(metric="king", device="cuda",
                                  gram_lowering=lowering))
        before = packed_gram.launches
        run = runner.run_gram(job, load_packed(str(tmp_path / "store")),
                              PhaseTimer())
        assert packed_gram.launches - before == (3 if lowering == "auto"
                                                 else 0)
        accs[lowering] = run.acc
    for leaf in accs["auto"]:
        assert torch.equal(accs["auto"][leaf], accs["reference"][leaf]), leaf


# Samples at K1's 64-sample tile edges; chunk widths that put block
# boundaries inside a chunk, on it, and across a ragged tail chunk.
STORE_EDGES = [(63, 512, 256), (64, 1024, 1024), (65, 640, 256),
               (129, 2048, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["raw", "zlib", "zlib-dict"])
@pytest.mark.parametrize("readahead", [0, 2])
@pytest.mark.parametrize("n,chunk,bv", STORE_EDGES)
def test_dataset_store_feeds_k1_like_the_packed_store(cuda_device, tmp_path,
                                                      codec, readahead, n,
                                                      chunk, bv):
    """A dataset store's blocks (raw chunks zero-copy, compressed ones
    from the inflated payload, readahead off and at its default) reach
    K1 on the card: one launch per block, accumulators bitwise the
    packed store's, and no readahead thread outlives the job."""
    import threading

    others = set(threading.enumerate())
    src = SyntheticSource(n_samples=n, n_variants=3000, seed=n)
    g = np.concatenate([b for b, _ in src.blocks(4096)], axis=1)
    save_packed(str(tmp_path / "packed"), g)
    compact(str(tmp_path / "ds"), ArraySource(g), chunk_variants=chunk,
            codec=codec)
    accs = {}
    for source in ("packed", "store"):
        job = JobConfig(
            ingest=IngestConfig(source=source,
                                path=str(tmp_path / {"packed": "packed",
                                                     "store": "ds"}[source]),
                                block_variants=bv,
                                readahead_chunks=readahead),
            compute=ComputeConfig(metric="ibs", device="cuda"))
        timer = PhaseTimer()
        before = packed_gram.launches
        with runner.job_source(job, None, timer) as s:
            run = runner.run_gram(job, s, timer)
        assert run.lowering == "fused"
        assert packed_gram.launches - before == -(-3000 // bv)
        accs[source] = run.acc
    for leaf in accs["packed"]:
        assert torch.equal(accs["store"][leaf], accs["packed"][leaf]), leaf
    assert not [t for t in threading.enumerate()
                if t not in others and t.name.startswith("store-readahead")]


@pytest.mark.gpu
@pytest.mark.parametrize("readahead", [0, 2])
def test_dataset_store_dense_feed_on_cuda(cuda_device, tmp_path, readahead):
    """euclidean reads a store on the dense transport: each block decoded
    straight into a pinned slab; accumulators equal the CPU run's."""
    src = SyntheticSource(n_samples=70, n_variants=2500, seed=9)
    compact(str(tmp_path / "ds"), src, chunk_variants=1024)
    accs = {}
    for device in ("cuda", "cpu"):
        job = JobConfig(
            ingest=IngestConfig(source=f"store:{tmp_path / 'ds'}",
                                block_variants=600,
                                readahead_chunks=readahead),
            compute=ComputeConfig(metric="euclidean", device=device))
        before = packed_gram.launches
        res = jobs.similarity_matrix_job(job)
        assert packed_gram.launches == before
        accs[device] = res.similarity
    np.testing.assert_array_equal(accs["cuda"], accs["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("precise", [False, True])
def test_grm_on_cuda_matches_its_cpu_run(cuda_device, precise):
    """zz within 1e-5 of max|zz| (the f32 order tolerance of
    tests/test_torch_grm.py), nvar equal."""
    rng = np.random.default_rng(8)
    blocks = []
    for _ in range(3):
        b = rng.integers(0, 3, (100, 700)).astype(np.int8)
        b[rng.random(b.shape) < 0.1] = -1
        blocks.append(b)
    accs = {}
    for device in ("cuda", "cpu"):
        acc = gram.init(100, "grm", device)
        for b in blocks:
            gram.update(acc, torch.from_numpy(b).to(device), "grm", precise)
        accs[device] = {k: v.cpu() for k, v in acc.items()}
    assert torch.equal(accs["cuda"]["nvar"], accs["cpu"]["nvar"])
    scale = float(accs["cpu"]["zz"].abs().max())
    err = float((accs["cuda"]["zz"] - accs["cpu"]["zz"]).abs().max())
    assert err <= 1e-5 * scale, err / scale


@pytest.mark.gpu
def test_ld_window_r2_on_cuda_matches_its_cpu_run(cuda_device):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 3, (300, 80)).astype(np.int8)
    x[:, 1::2] = x[:, ::2]  # planted LD
    x[rng.random(x.shape) < 0.05] = -1
    got = ldprune._window_r2(torch.from_numpy(x).to(cuda_device)).cpu()
    want = ldprune._window_r2(torch.from_numpy(x))
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["shared-alt", "euclidean", "dot", "grm",
                                    "ibs", "jaccard"])
def test_sketch_update_on_cuda_matches_its_cpu_run(cuda_device, metric):
    """Three blocks through the sketch update on the card and on the CPU
    from one state: each leaf within 1e-5 of its largest entry (f32 sums
    in another order; TF32 is off inside the update), and the card's
    TF32 setting is left as it was."""
    from spark_examples_tpu_torch.solvers import sketch

    rng = np.random.default_rng(12)
    blocks = []
    for _ in range(3):
        b = rng.integers(0, 3, (300, 512)).astype(np.int8)
        b[rng.random(b.shape) < 0.1] = -1
        blocks.append(b)
    dual = isinstance(kernels.get(metric).sketch, kernels.DualSketch)
    init = sketch.init_dual_state if dual else sketch.init_state
    states = {}
    before = torch.backends.cuda.matmul.allow_tf32
    for device in ("cuda", "cpu"):
        state = init(300, 32, 5, device)
        upd = (sketch.make_dual_update(metric) if dual
               else sketch.make_update(metric))
        for b in blocks:
            state = upd(state, torch.from_numpy(b).to(device))
        states[device] = {k: v.cpu() for k, v in state.items()}
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert torch.equal(states["cuda"]["qc"], states["cpu"]["qc"])
    for k, want in states["cpu"].items():
        scale = max(float(want.abs().max()), 1.0)
        err = float((states["cuda"][k] - want).abs().max())
        assert err <= 1e-5 * scale, (k, err / scale)


@pytest.mark.gpu
def test_checkpoint_saved_from_cuda_loads_on_the_cpu(cuda_device, tmp_path):
    """Leaves saved from card tensors are the files the CPU copies give,
    and load back on the CPU bitwise."""
    from spark_examples_tpu_torch.core import checkpoint as ckpt

    rng = np.random.default_rng(3)
    host = {"cc": torch.from_numpy(rng.integers(0, 99, (40, 40),
                                                dtype=np.int32)),
            "nvar": torch.tensor(7.0),
            "y": torch.from_numpy(rng.standard_normal((40, 8),
                                                      dtype=np.float32))}
    ids = [f"S{i:06d}" for i in range(40)]
    card, cpu = str(tmp_path / "card"), str(tmp_path / "cpu")
    ckpt.save(card, {k: v.to(cuda_device) for k, v in host.items()}, 512,
              "t", 256, ids)
    ckpt.save(cpu, host, 512, "t", 256, ids)
    for k in host:
        with open(f"{card}/{k}.npy", "rb") as a, \
                open(f"{cpu}/{k}.npy", "rb") as b:
            assert a.read() == b.read(), k
    acc, cursor, _ = ckpt.load(card, "t", ids, leaves=list(host))
    assert cursor == 512
    for k, v in host.items():
        assert acc[k].device.type == "cpu" and torch.equal(acc[k], v)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,solver", [("grm", "corrected"),
                                           ("ibs", "corrected"),
                                           ("shared-alt", "sketch")])
def test_sketch_job_on_cuda_matches_its_cpu_run(cuda_device, metric, solver):
    """The same seed draws the same probes on both devices, so the job's
    eigenvalues agree within 1e-4 relative (f32 sums in another order
    through every pass)."""
    out = {}
    for device in ("cuda", "cpu"):
        job = JobConfig(
            ingest=IngestConfig(n_samples=300, n_variants=4096,
                                block_variants=1024, seed=2),
            compute=ComputeConfig(metric=metric, num_pc=4, solver=solver,
                                  sketch_rank=24, device=device))
        out[device] = jobs.pcoa_job(job)
    rel = (np.abs(out["cuda"].eigenvalues - out["cpu"].eigenvalues)
           / np.abs(out["cpu"].eigenvalues))
    assert rel.max() <= 1e-4, rel
    assert np.isfinite(out["cuda"].coords).all()


@pytest.mark.gpu
@pytest.mark.parametrize("stat", sorted(genotype.CROSS_STATS))
@pytest.mark.parametrize("a", [1, 7, 33])
def test_cross_stats_on_cuda_bitwise_equal_to_the_cpu(cuda_device, stat, a):
    """The cross products on the card (``torch._int_mm``, rows padded to
    its minimum, a single new sample included) equal the CPU's exact
    ``int_dot`` bit for bit."""
    rng = np.random.default_rng(a * 31 + len(stat))
    bn = rng.integers(-1, 3, (a, 1000), dtype=np.int8)
    br = rng.integers(-1, 3, (45, 1000), dtype=np.int8)
    want = genotype.cross_stats(torch.from_numpy(bn), torch.from_numpy(br),
                                (stat,))[stat]
    got = genotype.cross_stats(torch.from_numpy(bn).to(cuda_device),
                               torch.from_numpy(br).to(cuda_device),
                               (stat,))[stat]
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_native_codec_is_built_on_the_card_s_host(cuda_device):
    """The host codec builds on the machine that holds the card (g++ and
    zlib), into the package's _build directory, with all five entries."""
    from spark_examples_tpu_torch import native

    lib = native.load()
    assert lib is not None, native.build_error
    assert native.library_path().parent == native.BUILD_DIR
    for entry in native.ENTRIES:
        assert hasattr(lib, entry), entry


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pcoa", "pca"])
def test_project_on_cuda_matches_its_cpu_run(cuda_device, tmp_path, kind):
    """One model file projected on the card and on the CPU: the int32
    cross accumulators are bitwise equal, so the coordinates agree
    within f32 rounding (1e-5 of max|coords|)."""
    from spark_examples_tpu_torch.pipelines.project import pcoa_project_job

    panel = SyntheticSource(n_samples=120, n_variants=3000, seed=4)
    new = SyntheticSource(n_samples=9, n_variants=3000, seed=4)
    model = str(tmp_path / "m.npz")
    fit = JobConfig(ingest=IngestConfig(block_variants=1024),
                    compute=ComputeConfig(num_pc=4, device="cpu"),
                    model_path=model)
    (jobs.pcoa_job if kind == "pcoa" else jobs.variants_pca_job)(
        fit, source=panel)
    out = {}
    for device in ("cuda", "cpu"):
        job = JobConfig(ingest=IngestConfig(block_variants=1024),
                        compute=ComputeConfig(device=device))
        out[device] = pcoa_project_job(job, model, new, panel).coords
    scale = np.abs(out["cpu"]).max()
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-5 * scale


def _dosages(rng, n, v, missing=0.1):
    g = rng.integers(0, 3, (n, v)).astype(np.int8)
    g[rng.random(g.shape) < missing] = -1
    return g


@pytest.mark.gpu
def test_example_counts_on_cuda_bitwise_equal_to_the_cpu(cuda_device):
    """The per-variant histogram and the per-sample counts of a ragged
    cohort, reduced on the card and on the CPU: equal integers."""
    from spark_examples_tpu_torch.pipelines import examples

    g = _dosages(np.random.default_rng(21), 2504, 3001)
    src = ArraySource(g)
    b = torch.from_numpy(g)
    assert torch.equal(examples.block_histogram(b.to(cuda_device)).cpu(),
                       examples.block_histogram(b))
    assert torch.equal(
        examples.block_sample_counts(b.to(cuda_device)).cpu(),
        examples.block_sample_counts(b))
    for fn, args in ((examples.genotype_histogram, (1024, {5, 2999, 77})),
                     (examples.genotype_histogram, (1024,)),
                     (examples.sample_stats, (1024,))):
        got = fn(src, *args, device="cuda")
        want = fn(src, *args, device="cpu")
        assert [vars(x) for x in got] == [vars(x) for x in want]


@pytest.mark.gpu
def test_coverage_on_cuda_bitwise_equal_to_the_cpu(cuda_device):
    """The f32 difference-array scatter-add and scan on the card equal
    the CPU's bit for bit (integer depths, exact in any order)."""
    from spark_examples_tpu_torch.core.config import ReferenceRange
    from spark_examples_tpu_torch.ingest.reads import SyntheticReadsSource
    from spark_examples_tpu_torch.pipelines.coverage import coverage

    src = SyntheticReadsSource([ReferenceRange("chr22", 16_050_000,
                                               16_550_000),
                                ReferenceRange("chr1", 0, 300)],
                               reads_per_range=200_000, seed=3)
    got = coverage(src, batch=65536, device="cuda")
    want = coverage(src, batch=65536, device="cpu")
    for r, w in zip(got, want):
        assert r.depth.tobytes() == w.depth.tobytes()
        assert r.n_reads == w.n_reads


@pytest.mark.gpu
def test_minhash_update_on_cuda_bitwise_equal_to_the_cpu(cuda_device):
    """Three blocks through the int64-masked MinHash update on the card
    and on the CPU, the hash loop chunked on both: equal signatures."""
    from spark_examples_tpu_torch.neighbors import minhash

    rng = np.random.default_rng(22)
    blocks = [_dosages(rng, 700, 1024) for _ in range(3)]
    sigs = {}
    for device in ("cuda", "cpu"):
        upd = minhash.make_update(128, 3, device)
        state = minhash.init_state(700, 128, device)
        for b in blocks:
            state = upd(state, torch.from_numpy(b).to(device))
        assert int(state["nvar"]) == 3072
        sigs[device] = minhash.signatures(state)
    assert np.array_equal(sigs["cuda"], sigs["cpu"])


@pytest.mark.gpu
def test_neighbors_job_on_cuda_matches_its_cpu_run(cuda_device, tmp_path):
    """The whole neighbors job, the MinHash pass on the card: the same
    file bytes as the CPU run (the evaluation is host integer work)."""
    from spark_examples_tpu_torch.neighbors import save_result
    from spark_examples_tpu_torch.neighbors.engine import neighbors_job

    src = SyntheticSource(n_samples=200, n_variants=5000, seed=9)
    data = {}
    for device in ("cuda", "cpu"):
        job = JobConfig(ingest=IngestConfig(block_variants=1024),
                        compute=ComputeConfig(device=device,
                                              minhash_hashes=64,
                                              minhash_bands=16))
        path = str(tmp_path / f"{device}.topk")
        save_result(path, neighbors_job(job, source=src))
        data[device] = open(path, "rb").read()
    assert data["cuda"] == data["cpu"]


@pytest.mark.gpu
def test_streaming_refresh_on_cuda_matches_its_cpu_run(cuda_device):
    """The streaming job on the card and on the CPU from the same probes:
    the snapshots' cursors equal, every eigenvalue within 1e-4 relative
    and every |coord| within 1e-4 of max|coords| (f32 finalize,
    centering, QR and eigh in another order; TF32 off in the refresh),
    and the card's TF32 setting left as it was."""
    from spark_examples_tpu_torch.pipelines.streaming import (
        incremental_pcoa_job,
    )

    src = SyntheticSource(n_samples=600, n_variants=16384, seed=2)
    before = torch.backends.cuda.matmul.allow_tf32
    runs = {}
    for device in ("cuda", "cpu"):
        job = JobConfig(ingest=IngestConfig(block_variants=1024),
                        compute=ComputeConfig(num_pc=4, device=device,
                                              stream_refresh_blocks=4))
        runs[device] = incremental_pcoa_job(job, source=src)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    (out, snaps), (cout, csnaps) = runs["cuda"], runs["cpu"]
    assert [s.n_variants for s in snaps] == [s.n_variants for s in csnaps]
    pairs = [(out.eigenvalues, out.coords, cout.eigenvalues, cout.coords)]
    pairs += [(s.eigenvalues, s.coords, c.eigenvalues, c.coords)
              for s, c in zip(snaps, csnaps)]
    for vals, coords, cvals, ccoords in pairs:
        assert np.abs(vals - cvals).max() <= 1e-4 * np.abs(cvals).max()
        scale = np.abs(ccoords).max()
        assert np.abs(np.abs(coords) - np.abs(ccoords)).max() <= 1e-4 * scale


def _fitted_panel(tmp_path, kind, n=120, v=3000):
    panel = SyntheticSource(n_samples=n, n_variants=v, seed=4)
    model = str(tmp_path / f"{kind}.npz")
    metric = None if kind == "pca" else "ibs"
    solver = "corrected" if kind == "factorized" else "exact"
    fit = JobConfig(ingest=IngestConfig(block_variants=1024),
                    compute=ComputeConfig(num_pc=4, device="cpu",
                                          metric=metric, solver=solver,
                                          sketch_rank=16),
                    model_path=model)
    (jobs.variants_pca_job if kind == "pca" else jobs.pcoa_job)(
        fit, source=panel)
    return panel, model


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pcoa", "pca", "factorized"])
def test_served_rows_on_cuda_match_the_cpu_and_offline(cuda_device, tmp_path,
                                                       kind):
    """One model served on the card and on the CPU: the padded batch's
    int32 cross statistics bitwise equal, the rows within 1e-5 of
    max|coords|; each card row bitwise the card's offline single-query
    project (the same finalize at the same shape)."""
    from spark_examples_tpu_torch.pipelines.project import pcoa_project_job
    from spark_examples_tpu_torch.serve import ProjectionEngine
    from spark_examples_tpu_torch.serve import engine as E

    panel, model = _fitted_panel(tmp_path, kind)
    queries = np.concatenate(
        [b for b, _ in SyntheticSource(n_samples=5, n_variants=3000,
                                       seed=8).blocks(1024)], axis=1)
    engines = {d: ProjectionEngine(model, panel, block_variants=1024,
                                   max_batch=8, device=d)
               for d in ("cuda", "cpu")}
    g, _b = E._padded_batch(queries, 8, 3000)
    accs = {d: E._cross_batch(e._ctx, e._ref_blocks, g, e.stats)[0]
            for d, e in engines.items()}
    for k in accs["cpu"]:
        assert torch.equal(accs["cuda"][k].cpu(), accs["cpu"][k])
    rows = {d: e.project_batch(queries) for d, e in engines.items()}
    scale = np.abs(rows["cpu"]).max()
    assert np.abs(rows["cuda"] - rows["cpu"]).max() <= 1e-5 * scale
    job = JobConfig(ingest=IngestConfig(block_variants=1024),
                    compute=ComputeConfig(device="cuda"))
    for i in range(len(queries)):
        want = pcoa_project_job(job, model, ArraySource(queries[i:i + 1]),
                                panel).coords
        assert np.array_equal(rows["cuda"][i:i + 1], want), i


@pytest.mark.gpu
def test_serving_worker_runs_on_the_engine_s_stream(cuda_device, tmp_path):
    """Every batch runs on the worker thread with the engine's device
    and CUDA stream current, a worker restarted at admission too; the
    handler threads pass numpy arrays only."""
    import threading

    from spark_examples_tpu_torch.serve import (
        ProjectionEngine,
        ProjectionServer,
    )

    panel, model = _fitted_panel(tmp_path, "pcoa")
    engine = ProjectionEngine(model, panel, block_variants=1024,
                              max_batch=4)
    seen = []
    real = engine.project_batch

    def recording(genotypes):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream(cuda_device) == engine.stream,
                     torch.cuda.current_device()))
        return real(genotypes)

    engine.project_batch = recording
    queries = np.concatenate(
        [b for b, _ in SyntheticSource(n_samples=12, n_variants=3000,
                                       seed=9).blocks(1024)], axis=1)
    server = ProjectionServer(engine, cache_entries=0).start()
    try:
        want = real(queries[:4])
        futs = []
        threads = [threading.Thread(
            target=lambda i=i: futs.append(server.submit(queries[i])))
            for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for f in futs:
            assert isinstance(f.result(timeout=60), np.ndarray)
        server._stop.set()
        server._worker.join(timeout=10)
        server._stop.clear()
        with pytest.warns(RuntimeWarning, match="found dead at admission"):
            got = server.project(queries[0], timeout=60)
        assert np.array_equal(got, want[:1])
    finally:
        server.close()
    assert len(seen) >= 4
    assert all(name == "projection-serve-worker" and on_stream
               and dev == engine.device.index
               for name, on_stream, dev in seen), seen


@pytest.mark.gpu
def test_cuda_feed_fires_the_transfer_wait_site(cuda_device):
    from spark_examples_tpu_torch.core import faults, telemetry
    from spark_examples_tpu_torch.ingest.prefetch import (
        TRANSFER_DEPTH,
        stream_to_device,
    )

    src = SyntheticSource(n_samples=64, n_variants=4096, seed=1)
    telemetry.reset()
    with faults.armed(["prefetch.transfer_wait:delay:delay=0.001:max=0"]) \
            as inj:
        blocks = [(b.cpu(), m) for b, m in
                  stream_to_device(src, 512, cuda_device)]
        assert inj.fire_count("prefetch.transfer_wait") == \
            len(blocks) - TRANSFER_DEPTH
    hists = telemetry.metrics_snapshot()["histograms"]
    assert hists["prefetch.transfer_wait_s"]["count"] == \
        len(blocks) - TRANSFER_DEPTH
    assert hists["prefetch.stage_wait_s"]["count"] == len(blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("paced_by", ["card", "host"])
def test_cuda_feed_holds_its_blocks_in_a_device_ring(cuda_device, paced_by):
    """A feed faster than the card (each update slowed on the compute
    stream) keeps at most its ring of prefetch + TRANSFER_DEPTH device
    buffers and waits on the card there (``prefetch.device_ring_waits``);
    a feed slower than the card (each block's copy held back on the
    host) never waits. The update reads every block's bytes either way,
    each gathered from the source's view (``feed.gathered_blocks``),
    though its scratch, freed on the compute stream while that stream
    still has work queued on it, is block-sized like a ring buffer."""
    import contextlib

    from spark_examples_tpu_torch.core import faults
    from spark_examples_tpu_torch.ingest.bitpack import pack_dosages
    from spark_examples_tpu_torch.ingest.packed import Packed2BitSource
    from spark_examples_tpu_torch.ingest.prefetch import (
        TRANSFER_DEPTH,
        pad_block,
        padded_width,
        stream_to_device,
    )

    n, bv, n_blocks, prefetch = 1024, 8192, 24, 2
    g = np.random.default_rng(7).integers(
        -1, 3, (n, bv * n_blocks - 100), dtype=np.int8)  # a ragged tail
    src = Packed2BitSource(pack_dosages(g), g.shape[1])
    w = padded_width(bv, pack=True)
    seen = torch.empty((n_blocks, n, w), dtype=torch.uint8,
                       device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    telemetry.reset()
    slow_host = (faults.armed(["device.put:delay:delay=0.01:max=0"])
                 if paced_by == "host" else contextlib.nullcontext())
    buffers = set()
    with slow_host:
        for i, (block, _) in enumerate(stream_to_device(
                src, bv, cuda_device, prefetch=prefetch, pack=True)):
            scratch = torch.empty_like(block)
            if paced_by == "card":
                torch.cuda._sleep(20_000_000)  # ~10 ms of the card
            scratch.copy_(block)
            seen[i].copy_(scratch)
            del scratch
            buffers.add(block.data_ptr())
    torch.cuda.synchronize()
    ring = prefetch + TRANSFER_DEPTH
    assert len(buffers) <= ring
    # The ring and one scratch.
    assert torch.cuda.max_memory_allocated() - base <= (ring + 1) * n * w
    want = np.stack([pack_dosages(pad_block(g[:, i * bv:(i + 1) * bv], bv))
                     for i in range(n_blocks)])
    np.testing.assert_array_equal(seen.cpu().numpy(), want)
    assert telemetry.counter_value("feed.gathered_blocks") == n_blocks
    waits = telemetry.counter_value("prefetch.device_ring_waits")
    if paced_by == "card":
        assert waits > 0
    else:
        assert waits == 0


@pytest.mark.gpu
def test_trace_dir_captures_the_card_s_kernels(cuda_device, tmp_path):
    import json
    import os

    from spark_examples_tpu_torch.core import profiling

    x = torch.ones(256, 256, device=cuda_device)
    with profiling.trace(str(tmp_path), "cuda") as prof:
        (x @ x).sum().item()
    assert profiling.kernel_events(prof)
    trace = json.load(open(os.path.join(tmp_path, "trace_rank0.json")))
    assert any(e.get("cat") == "kernel" for e in trace["traceEvents"])


def _fleet_routes(tmp_path):
    """Three fitted routes over dataset stores — pcoa ibs (with the topk
    capability), pca and pcoa jaccard — as a manifest document, with
    each route's panel source and model."""
    routes = []
    for i, (kind, metric) in enumerate((("pcoa", "ibs"), ("pca", None),
                                        ("pcoa", "jaccard"))):
        panel = SyntheticSource(n_samples=96, n_variants=3000, seed=20 + i)
        model = str(tmp_path / f"fleet{i}.npz")
        fit = JobConfig(ingest=IngestConfig(block_variants=1024),
                        compute=ComputeConfig(num_pc=4, device="cpu",
                                              metric=metric),
                        model_path=model)
        (jobs.variants_pca_job if kind == "pca" else jobs.pcoa_job)(
            fit, source=panel)
        store = str(tmp_path / f"fleet_store{i}")
        compact(store, panel, chunk_variants=1024)
        routes.append({"name": f"r{i}", "model": model,
                       "source": f"store:{store}",
                       **({"topk": True} if i == 0 else {})})
    return {"routes": routes}


def _fleet(doc, device, budget_bytes=None, **cfg):
    from spark_examples_tpu_torch.core.config import ServeConfig
    from spark_examples_tpu_torch.serve import FleetManifest, build_fleet

    if budget_bytes is not None:
        doc = {**doc, "budget_mb": budget_bytes / 1e6}
    return build_fleet(FleetManifest.parse(doc),
                       ServeConfig(cache_entries=0, **cfg),
                       ingest_defaults=IngestConfig(block_variants=1024),
                       device=device)


def _store_source(spec: str):
    from spark_examples_tpu_torch.store import open_store

    return open_store(spec.split(":", 1)[1], readahead_chunks=0,
                      device="cuda")


@pytest.mark.gpu
def test_fleet_rows_on_cuda_match_the_cpu(cuda_device, tmp_path):
    """One manifest served on the card and on the CPU: every route's
    padded-batch int32 cross statistics bitwise equal, the rows within
    1e-5 of max|coords|, the topk route's neighbor ids equal; each card
    row bitwise the card's single-model server's."""
    from spark_examples_tpu_torch.serve import (
        ProjectionEngine,
        ProjectionServer,
    )
    from spark_examples_tpu_torch.serve import engine as E

    doc = _fleet_routes(tmp_path)
    fleets = {d: _fleet(doc, d) for d in ("cuda", "cpu")}
    queries = np.concatenate(
        [b for b, _ in SyntheticSource(n_samples=5, n_variants=3000,
                                       seed=8).blocks(1024)], axis=1)
    try:
        g, _b = E._padded_batch(queries, 8, 3000)
        for name in fleets["cpu"].routes:
            accs = {}
            for d, fleet in fleets.items():
                route = fleet.routes[name]
                with E.on_stream(fleet.stream):
                    panel = fleet.pool.acquire(name, route.stage)
                    accs[d] = E._cross_batch(route.ctx, panel.blocks, g,
                                             route.ctx.stats)[0]
            for k in accs["cpu"]:
                assert torch.equal(accs["cuda"][k].cpu(), accs["cpu"][k])
        for fleet in fleets.values():
            fleet.start()
        for spec in doc["routes"]:
            name = spec["name"]
            rows = {d: np.concatenate([f.project(name, q, timeout=120)
                                       for q in queries])
                    for d, f in fleets.items()}
            scale = np.abs(rows["cpu"]).max()
            assert np.abs(rows["cuda"] - rows["cpu"]).max() <= 1e-5 * scale
            engine = ProjectionEngine(spec["model"],
                                      _store_source(spec["source"]),
                                      block_variants=1024, max_batch=8)
            with ProjectionServer(engine, cache_entries=0) as single:
                want = np.concatenate([single.project(q, timeout=120)
                                       for q in queries])
            assert np.array_equal(rows["cuda"], want), name
        for q in queries:
            ids = {d: f.topk("r0", q, 5, timeout=120)[0]
                   for d, f in fleets.items()}
            assert np.array_equal(ids["cuda"], ids["cpu"])
    finally:
        for fleet in fleets.values():
            fleet.close()


@pytest.mark.gpu
def test_fleet_worker_runs_on_the_fleet_s_stream(cuda_device, tmp_path,
                                                 monkeypatch):
    """Every fleet batch runs on the fleet worker with the router's
    device and CUDA stream current, and its panels are staged there;
    an admin warm from another thread stages on the same stream."""
    import threading

    from spark_examples_tpu_torch.serve import engine as E

    seen = []
    for fn in ("batch_coords", "stage_blocks"):
        real = getattr(E, fn)

        def recording(*a, _real=real, _fn=fn, **k):
            seen.append((_fn, threading.current_thread().name,
                         torch.cuda.current_stream() == fleet.stream))
            return _real(*a, **k)

        monkeypatch.setattr(E, fn, recording)
    fleet = _fleet(_fleet_routes(tmp_path), "cuda")
    assert fleet.stream is not None and fleet.device.index is not None
    queries = np.concatenate(
        [b for b, _ in SyntheticSource(n_samples=6, n_variants=3000,
                                       seed=9).blocks(1024)], axis=1)
    try:
        fleet.warm_route("r2")
        fleet.start()
        for i, q in enumerate(queries):
            fleet.project(f"r{i % 3}", q, timeout=120)
    finally:
        fleet.close()
    assert [s for s in seen if s[0] == "stage_blocks"][0][1:] == \
        ("MainThread", True)
    work = [s for s in seen if s[1] != "MainThread"]
    assert len([s for s in work if s[0] == "batch_coords"]) == 6
    assert all(name == "fleet-serve-worker" and on_stream
               for _fn, name, on_stream in work), work


@pytest.mark.gpu
def test_fleet_eviction_and_restage_under_traffic_bitwise(cuda_device,
                                                          tmp_path):
    """A pool that holds one panel and a half, three routes under
    concurrent traffic: panels are evicted and re-staged while batches
    run, and every answer stays bitwise equal to the route's answer
    from a pool that never evicts."""
    import concurrent.futures

    from spark_examples_tpu_torch.core import telemetry

    doc = _fleet_routes(tmp_path)
    queries = np.concatenate(
        [b for b, _ in SyntheticSource(n_samples=24, n_variants=3000,
                                       seed=10).blocks(1024)], axis=1)
    warm = _fleet(doc, "cuda").start()
    try:
        want = {(i, f"r{i % 3}"): warm.project(f"r{i % 3}", q, timeout=120)
                for i, q in enumerate(queries)}
    finally:
        warm.close()
    telemetry.reset()
    fleet = _fleet(doc, "cuda", budget_bytes=int(96 * 3000 * 1.5),
                   max_linger_ms=1.0).start()
    try:
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            got = dict(zip(want, pool.map(
                lambda key: fleet.project(key[1], queries[key[0]],
                                          timeout=120), want)))
        assert fleet.pool.resident_bytes() <= int(96 * 3000 * 1.5)
    finally:
        fleet.close()
    assert telemetry.counter_value("fleet.evictions") >= 1
    assert telemetry.counter_value("fleet.restage_total") >= 1
    for key, rows in want.items():
        assert np.array_equal(got[key], rows), key


def _tile2d_update(plan, metric, g, block, transport):
    from spark_examples_tpu_torch.ingest import bitpack
    from spark_examples_tpu_torch.parallel import gram_sharded

    acc = gram_sharded.init_sharded(plan, g.shape[0], metric)
    update = gram_sharded.make_update(plan, metric, packed=True,
                                      transport=transport, lowering="fused")
    for s in range(0, g.shape[1], block):
        blk = torch.from_numpy(bitpack.pack_dosages(g[:, s:s + block]))
        acc = update(acc, blk.to(plan.mesh.home))
    for dev in plan.mesh.physical:
        torch.cuda.synchronize(dev)
    return {k: (v.full("cpu") if plan.tiled else v.cpu())
            for k, v in acc.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("transport", ["gather", "ring"])
def test_tile2d_update_on_virtual_slots_of_cuda0(cuda_device, transport):
    """A 2 x 2 mesh of four virtual slots on cuda:0: K1 runs once per
    tile a block under gather (symmetric on the diagonal tiles,
    rectangular off it) and four times per tile under ring, on shards a
    quarter of the (ragged, padded) block wide; the int32 accumulators
    are bitwise the single-device update's, and gram.fused_blocks grows
    by one a block."""
    from spark_examples_tpu_torch.core import meshes, virtual
    from spark_examples_tpu_torch.parallel import gram_sharded

    rng = np.random.default_rng(5)
    g = rng.integers(0, 3, (96, 1400)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -1
    mesh = meshes.make_mesh(virtual.virtual_devices(4, "cuda:0"), (2, 2))
    plan = gram_sharded.GramPlan(mesh, "tile2d")
    before = packed_gram.launches
    counted = telemetry.counter_value("gram.fused_blocks")
    launched = telemetry.counter_value("kernel.packed_gram.launches")
    got = _tile2d_update(plan, "ibs", g, 512, transport)
    blocks = 3
    per_block = 4 if transport == "gather" else 16
    assert packed_gram.launches - before == blocks * per_block
    assert (telemetry.counter_value("kernel.packed_gram.launches")
            - launched == blocks * per_block)
    assert telemetry.counter_value("gram.fused_blocks") - counted == blocks
    want = gram.init(96, "ibs", "cpu")
    gram.update(want, torch.from_numpy(g), "ibs")
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_tiled_product_is_the_same_for_either_layout_of_q(cuda_device):
    """The tiled ``B @ Q`` gives the same bits for a QR's column-major Q
    and for its row-major copy (what a peer rank receives): on the card
    cuBLAS sums the two layouts in different orders, so the product
    takes Q row-major on every slot."""
    from spark_examples_tpu_torch.core import meshes, virtual
    from spark_examples_tpu_torch.core.meshes import Tiled
    from spark_examples_tpu_torch.parallel import pcoa_sharded

    gen = torch.Generator("cpu").manual_seed(1)
    b = torch.randn((2504, 2504), generator=gen)
    b = (b + b.T).to(cuda_device)
    q, _ = torch.linalg.qr(torch.randn((2504, 20), generator=gen)
                           .to(cuda_device))
    assert not q.is_contiguous()  # the QR's Q is column-major
    mesh = meshes.make_mesh(virtual.virtual_devices(4, "cuda:0"), (2, 2))
    tiled = Tiled.from_full(mesh, b)
    assert torch.equal(pcoa_sharded.tiled_matmul(tiled, q),
                       pcoa_sharded.tiled_matmul(tiled, q.contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,transport", [("tile2d", "gather"),
                                            ("tile2d", "ring"),
                                            ("variant", "gather")])
def test_mesh_update_over_distinct_cards(cuda_device, mode, transport):
    """A mesh over distinct cards (2 x 2 over four, 1 x 2 over two):
    each slot's tiles or partials live on its own card, the shards cross
    between cards, and the result is the single-device update's,
    bitwise."""
    from spark_examples_tpu_torch.core import meshes
    from spark_examples_tpu_torch.parallel import gram_sharded

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two visible NVIDIA GPUs for a mesh over "
                    "distinct cards")
    shape = (2, 2) if cards >= 4 else (1, 2)
    rng = np.random.default_rng(6)
    g = rng.integers(0, 3, (64, 1400)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -1
    mesh = meshes.make_mesh([torch.device("cuda", k)
                             for k in range(shape[0] * shape[1])], shape)
    assert not mesh.virtual
    plan = gram_sharded.GramPlan(mesh, mode)
    got = _tile2d_update(plan, "ibs", g, 512, transport)
    want = gram.init(64, "ibs", "cpu")
    gram.update(want, torch.from_numpy(g), "ibs")
    for k in want:
        assert torch.equal(got[k], want[k]), k


_RANKS_ON_CUDA = r"""
import dataclasses
import torch
from spark_examples_tpu_torch.core import meshes
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ops import packed_gram
from spark_examples_tpu_torch.pipelines import runner

job = JobConfig(
    ingest=IngestConfig(source="synthetic", n_samples=96, n_variants=4000,
                        block_variants=512, seed=3),
    compute=ComputeConfig(metric="ibs", gram_mode="variant",
                          device="cuda"))
src = runner.build_source(job.ingest, "cuda")
g = runner.run_gram(job, src, PhaseTimer())
launches = packed_gram.launches
# The same ranks through the plain lowering: K1's sums held against it.
plain = runner.run_gram(job.replace(compute=dataclasses.replace(
    job.compute, gram_lowering="reference")), runner.build_source(
    job.ingest, "cuda"), PhaseTimer())
d = meshes.distributed()
emit(backend=d.name, device=str(d.device), lowering=g.lowering,
     launches=launches, local=int(src.n_variants),
     n_variants=g.n_variants, plain_lowering=plain.lowering,
     plain_equal=all(torch.equal(g.acc[k], plain.acc[k]) for k in g.acc),
     acc={k: v.cpu().tolist() for k, v in g.acc.items()})
"""


def _one_process_run(device):
    job = JobConfig(
        ingest=IngestConfig(source="synthetic", n_samples=96,
                            n_variants=4000, block_variants=512, seed=3),
        compute=ComputeConfig(metric="ibs", gram_mode="replicated",
                              device="cuda"))
    g = runner.run_gram(job, SyntheticSource(n_samples=96, n_variants=4000,
                                             seed=3), PhaseTimer())
    assert g.lowering == "fused"
    return {k: v.cpu() for k, v in g.acc.items()}


def _check_ranks(outs, backend, want):
    # 8 blocks of 512 over two ranks: windows of 4 blocks each, one K1
    # launch a block on each rank.
    assert sorted(o["local"] for o in outs) == [1952, 2048]
    for o in outs:
        assert (o["backend"], o["lowering"]) == (backend, "fused"), o
        assert o["launches"] == 4 and o["n_variants"] == 4000, o
        assert o["plain_lowering"] == "reference" and o["plain_equal"], o
        for k, v in want.items():
            assert torch.equal(torch.tensor(o["acc"][k], dtype=v.dtype),
                               v), k


@pytest.mark.gpu
def test_two_ranks_share_one_card_over_gloo_staged(cuda_device):
    """Two ranks on one card: gloo with host staging (NCCL refuses two
    ranks on one GPU); K1 runs on each rank, its sums bitwise the same
    ranks' plain lowering, and the summed accumulators bitwise the
    one-process fused run."""
    from torch_ranks import run_ranks

    want = _one_process_run(cuda_device)
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    outs = run_ranks(_RANKS_ON_CUDA,
                     extra_env={"CUDA_VISIBLE_DEVICES": first})
    _check_ranks(outs, "gloo-staged", want)
    assert {o["device"] for o in outs} == {"cuda:0"}


@pytest.mark.gpu
def test_two_ranks_on_two_cards_over_nccl(cuda_device):
    """A card per rank: NCCL, each rank on its own card, bitwise the
    one-process fused run."""
    from torch_ranks import run_ranks

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two visible NVIDIA GPUs for a rank per card")
    want = _one_process_run(cuda_device)
    outs = run_ranks(_RANKS_ON_CUDA)
    _check_ranks(outs, "nccl", want)
    assert [o["device"] for o in outs] == ["cuda:0", "cuda:1"]


_TILE2D_RANKS_ON_CUDA = r"""
import contextlib, os
from spark_examples_tpu_torch.core import meshes, virtual
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ops import packed_gram
from spark_examples_tpu_torch.parallel import pcoa_sharded
from spark_examples_tpu_torch.pipelines import runner

slots = int(os.environ["SLOTS"])
shape = tuple(int(x) for x in os.environ["SHAPE"].split("x"))
ing = IngestConfig(source="synthetic", n_samples=96, n_variants=4000,
                   block_variants=512, seed=3)
out = {}
scope = virtual.virtual_slots(slots) if slots > 1 else contextlib.nullcontext()
with scope:
    for transport in ("gather", "ring"):
        for lowering in ("auto", "reference"):
            job = JobConfig(ingest=ing, compute=ComputeConfig(
                metric="ibs", gram_mode="tile2d", mesh_shape=shape,
                tile2d_transport=transport, gram_lowering=lowering,
                device="cuda"))
            packed_gram.launches = 0
            g = runner.run_gram(job, runner.build_source(ing, "cuda"),
                                PhaseTimer())
            out[f"{transport}-{lowering}"] = {
                "lowering": g.lowering, "launches": packed_gram.launches,
                "tiles": {k: {str(s): t.cpu().tolist() for s, t in v.local()}
                          for k, v in g.acc.items()}}
    res = pcoa_sharded.pcoa_coords_sharded(g.plan, g.acc, "ibs", k=3)
d = meshes.distributed()
emit(backend=d.name, device=str(d.device), out=out,
     coords=res.coords.cpu().tolist())
"""


def _check_tile2d_ranks(outs, backend, want, shape, slots):
    """8 blocks of 512 over two ranks: 4 global steps; each rank holds
    its own slots' tiles of the global sums, K1 launching on each of its
    tiles a step (gather) or each ring step (ring)."""
    tn, tm = 96 // shape[0], 96 // shape[1]
    d = shape[0] * shape[1]
    for o in outs:
        assert o["backend"] == backend, o["backend"]
        for run, got in o["out"].items():
            transport, lowering = run.split("-")
            fused = lowering == "auto"
            assert got["lowering"] == ("fused" if fused else "reference")
            per_step = slots * (d if transport == "ring" else 1)
            assert got["launches"] == (4 * per_step if fused else 0), run
            for k, v in want.items():
                assert sorted(got["tiles"][k]) == [
                    str(o["process"] * slots + l) for l in range(slots)]
                for s, tile in got["tiles"][k].items():
                    i, j = divmod(int(s), shape[1])
                    assert torch.equal(
                        torch.tensor(tile, dtype=v.dtype),
                        v[i * tn:(i + 1) * tn, j * tm:(j + 1) * tm]), (run, k)
        assert np.isfinite(np.asarray(o["coords"])).all()
    # Rank 0's solve, broadcast: both ranks hold the same coordinates.
    assert outs[0]["coords"] == outs[1]["coords"]


@pytest.mark.gpu
def test_tile2d_two_ranks_share_one_card_over_gloo_staged(cuda_device):
    """tile2d across two ranks on one card, two virtual slots each on a
    2x2 mesh spanning both: gather and ring, K1 and the plain lowering,
    each rank's tiles bitwise the one-process run's."""
    from torch_ranks import run_ranks

    want = _one_process_run(cuda_device)
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    outs = run_ranks(_TILE2D_RANKS_ON_CUDA, extra_env={
        "CUDA_VISIBLE_DEVICES": first, "SLOTS": "2", "SHAPE": "2x2"})
    _check_tile2d_ranks(outs, "gloo-staged", want, (2, 2), 2)


@pytest.mark.gpu
def test_tile2d_two_ranks_on_two_cards_over_nccl(cuda_device):
    """A card per rank, a (1, 2) mesh: the slabs all-gathered and the
    ring shards hopping over NCCL, the mirrored blocks point to point."""
    from torch_ranks import run_ranks

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two visible NVIDIA GPUs for a rank per card")
    want = _one_process_run(cuda_device)
    outs = run_ranks(_TILE2D_RANKS_ON_CUDA,
                     extra_env={"SLOTS": "1", "SHAPE": "1x2"})
    _check_tile2d_ranks(outs, "nccl", want, (1, 2), 1)


@pytest.mark.gpu
def test_bench_braycurtis_launches_k2_warm_then_timed(cuda_device):
    """bench_torch's config 3 at a small shape: K2 runs twice (one warm
    launch, one timed) and agrees with the exact lowering bitwise on the
    integer table drawn on the card."""
    import bench_torch as bt

    before = braycurtis_kernel.launches
    out = bt.bench_braycurtis(n=600, f=257, exact_n=300)
    assert braycurtis_kernel.launches - before == 2
    assert out["k2_launches"] == 2
    assert out["pallas_vs_exact_maxerr"] == 0.0
    assert out["matmul_vs_exact_maxerr"] < 0.05
    assert {"matmul_s", "pallas_s", "exact_2500_s",
            "exact_est_full_s"} <= set(out)


@pytest.mark.gpu
def test_bench_staged_run_launches_k1_per_staged_block(cuda_device,
                                                       tmp_path):
    """bench_torch's staged config 1 at a small shape: one K1 launch per
    staged block for the warm pass and one per block for the timed pass,
    through the symmetric path (one contiguous block-major view on both
    sides); three passes give accumulators bitwise equal to the CPU
    reference lowering over the same store."""
    import bench_torch as bt

    syn = dict(bt.SYN, n_samples=300, n_variants=4 * 8192)
    store = bt.cohort_store(str(tmp_path), syn)
    cohort = bt.StagedCohort(store, block=8192, k=4)
    assert cohort.lowering == "fused" and cohort.n_blocks == 4
    before = packed_gram.launches
    tel = telemetry.counter_value("kernel.packed_gram.launches")
    staged = bt.staged_run(cohort)
    assert packed_gram.launches - before == 2 * 4
    assert telemetry.counter_value("kernel.packed_gram.launches") - tel \
        == 2 * 4
    assert staged["k1_launches"] == 8
    assert bt.check_structure(staged["coords"], syn) > 3.0
    acc, _ = cohort.accumulate_passes(3)
    ref = bt.StagedCohort(store, block=8192, k=4, device="cpu")
    want, _ = ref.accumulate_passes(3)
    for k in want:
        assert torch.equal(acc[k].cpu(), want[k]), k


def _cell_like_job(n=512, v=8 * 4096):
    """A small IBS PCoA job fed as the benchmark's memory cell is: a
    packed cohort in host memory, blocks of 4,096 variants."""
    from spark_examples_tpu_torch.ingest.bitpack import pack_dosages
    from spark_examples_tpu_torch.ingest.packed import Packed2BitSource

    syn = SyntheticSource(n_samples=n, n_variants=v, seed=3)
    g = np.concatenate([b for b, _ in syn.blocks(v)], axis=1)
    src = Packed2BitSource(packed=pack_dosages(g), v=v)
    job = JobConfig(ingest=IngestConfig(block_variants=4096),
                    compute=ComputeConfig(metric="ibs", num_pc=4,
                                          device="cuda"))
    return job, src, v // 4096


@pytest.mark.gpu
def test_device_spans_add_no_synchronisation_to_a_job(cuda_device,
                                                       monkeypatch):
    """A job with its device spans and its gap counter waits on the card
    no more often than one without them: the same device-wide
    synchronisations (its phases' barriers), no more event waits. Every
    span is read: one copy and one K1 launch a block, one solve, and the
    compute stream's gaps inside the gram phase."""
    import contextlib

    from spark_examples_tpu_torch.core import profiling
    from spark_examples_tpu_torch.ingest import prefetch
    from spark_examples_tpu_torch.ops import eigh as eigh_ops

    job, src, n_blocks = _cell_like_job()
    jobs.pcoa_job(job, source=src)  # builds K1, warms cuSOLVER
    waits = []

    def counted(fn, kind):
        def wrapper(*args, **kwargs):
            waits.append(kind)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted(torch.cuda.synchronize, "device"))
    for cls in (torch.cuda.Event, torch.cuda.Stream):
        monkeypatch.setattr(cls, "synchronize",
                            counted(cls.synchronize, cls.__name__))

    def run():
        waits.clear()
        telemetry.reset()
        out = jobs.pcoa_job(job, source=src)
        return list(waits), out

    timed, out = run()
    snap = telemetry.metrics_snapshot()
    hists, counters = snap["histograms"], snap["counters"]
    launches = counters["kernel.packed_gram.launches"]
    assert hists["feed.copy"]["count"] == n_blocks
    assert hists["kernel.packed_gram.launch"]["count"] == launches > 0
    assert hists["eigh.solve"]["count"] == 1
    assert hists["eigh.solve"]["sum"] <= out.timer.phases["eigh"]
    assert 0 <= counters["gram.device_gap_s"] <= out.timer.phases["gram"]

    class Untimed:  # the copy's plain event, as the feed had it
        def __init__(self):
            self.end = torch.cuda.Event()

        def resolve(self):
            pass

    @contextlib.contextmanager
    def untimed(name, device, stream=None, waited=False):
        span = Untimed()
        yield span
        span.end.record(stream or torch.cuda.current_stream(device))

    class NoGaps:
        def __init__(self, device):
            pass

        def mark(self):
            pass

        def count(self, name):
            pass

    for mod in (prefetch, packed_gram, eigh_ops):
        monkeypatch.setattr(mod, "device_span", untimed)
    monkeypatch.setattr(runner, "StreamGaps", NoGaps)
    plain, _ = run()
    assert "kernel.packed_gram.launch" not in \
        telemetry.metrics_snapshot()["histograms"]
    assert timed.count("device") == plain.count("device") > 0
    for kind in ("Event", "Stream"):
        assert timed.count(kind) <= plain.count(kind), kind


@pytest.mark.gpu
def test_a_full_pending_set_leaves_a_waited_span_alone(cuda_device,
                                                       monkeypatch):
    """Past ``PENDING_MAX`` a new span polls the pending ones, and a
    barrier reads them; neither touches a span whose caller waits on its
    end event, as the feed's copy does, so the caller's event is still
    there to wait on and resolve."""
    from spark_examples_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "PENDING_MAX", 0)
    telemetry.reset()
    x = torch.ones(1 << 20, device=cuda_device)
    with profiling.device_span("feed.copy", cuda_device,
                               waited=True) as copy:
        y = x * 2
    profiling.hard_sync(y)
    with profiling.device_span("eigh.solve", cuda_device):
        y = y * 2
    assert copy.end is not None
    torch.cuda.current_stream(cuda_device).wait_event(copy.end)
    copy.end.synchronize()
    copy.resolve()
    profiling.hard_sync(y)
    hists = telemetry.metrics_snapshot()["histograms"]
    assert hists["feed.copy"]["count"] == 1
    assert hists["eigh.solve"]["count"] == 1


@pytest.mark.gpu
def test_a_job_past_the_pending_cap_reads_every_span(cuda_device,
                                                     monkeypatch):
    """A job whose gram phase holds more device spans than
    ``PENDING_MAX`` (a cap of 2 against its 8 blocks) runs to its end
    and still reads one copy and one K1 launch a block and one solve."""
    from spark_examples_tpu_torch.core import profiling

    job, src, n_blocks = _cell_like_job()
    jobs.pcoa_job(job, source=src)  # builds K1, warms cuSOLVER
    monkeypatch.setattr(profiling, "PENDING_MAX", 2)
    telemetry.reset()
    out = jobs.pcoa_job(job, source=src)
    snap = telemetry.metrics_snapshot()
    hists, counters = snap["histograms"], snap["counters"]
    assert hists["feed.copy"]["count"] == n_blocks
    assert hists["kernel.packed_gram.launch"]["count"] == \
        counters["kernel.packed_gram.launches"] > 0
    assert hists["eigh.solve"]["count"] == 1
    assert out.coords.shape[0] == 512 and np.isfinite(out.coords).all()


@pytest.mark.gpu
def test_k1_launch_span_agrees_with_events_around_its_launches(cuda_device):
    """At the benchmark cell's launch shape, (15,708, 4,096 B), the
    ``kernel.packed_gram.launch`` spans read K1's time a launch within
    5 % of one event pair around ten back-to-back launches."""
    from spark_examples_tpu_torch.core import profiling

    rng = np.random.default_rng(15708)
    x = _random_packed(rng, 15708, 4096, cuda_device)
    pieces = kernels.get("ibs").pieces
    for _ in range(2):
        out = packed_gram.fused_tile_products(x, x, pieces)
    profiling.hard_sync(x)
    telemetry.reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    n = 10
    start.record()
    for _ in range(n):
        out = packed_gram.fused_tile_products(x, x, pieces)
    end.record()
    profiling.hard_sync(out)
    hist = telemetry.metrics_snapshot()["histograms"][
        "kernel.packed_gram.launch"]
    assert hist["count"] == n
    assert hist["sum"] * 1e3 / n == pytest.approx(
        start.elapsed_time(end) / n, rel=0.05)


@pytest.mark.gpu
def test_trace_dir_holds_every_span_on_the_card(cuda_device, tmp_path):
    """``--trace-dir``'s capture on the card: the card's kernels, each
    phase once, and the spans as ranges, the feed producer's reads and
    pins on its own thread."""
    import json
    import os

    from spark_examples_tpu_torch.core import profiling

    job, src, n_blocks = _cell_like_job()
    jobs.pcoa_job(job, source=src)
    with profiling.trace(str(tmp_path), "cuda"):
        jobs.pcoa_job(job, source=src)
    events = [e for e in json.load(open(os.path.join(
        tmp_path, "trace_rank0.json")))["traceEvents"] if e.get("ph") == "X"]
    assert any(e.get("cat") == "kernel" for e in events)
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ranges]
    for phase in ("phase.gram", "phase.finalize", "phase.eigh"):
        assert names.count(phase) == 1, phase
    for name in ("feed.copy", "kernel.packed_gram.launch"):
        assert names.count(name) == n_blocks, name
    assert names.count("eigh.solve") == 1
    job_tid = {e["tid"] for e in ranges if e["name"] == "phase.gram"}
    for name in ("feed.read", "feed.pin"):
        tids = {e["tid"] for e in ranges if e["name"] == name}
        assert tids and not tids & job_tid, name


def _planted_on_card(n, vals, seed, device):
    """Symmetric float32 ``Q diag(vals) Q^T`` on the card, ``Q`` the
    Q factor of a seeded Gaussian (n, n) in float64."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, n), generator=g, dtype=torch.float64, device=device)
    q, _ = torch.linalg.qr(x)
    lam = torch.as_tensor(vals, dtype=torch.float64, device=device)
    b = (q * lam) @ q.T
    return (0.5 * (b + b.T)).float()


def _spectrum(n, top, seed, gap=None):
    """``top`` over a bulk in [0, 1]; with ``gap`` the bulk's largest two
    lie ``gap`` apart at 1.0."""
    bulk = np.random.default_rng(seed).uniform(0.0, 1.0, n - len(top))
    if gap is not None:
        bulk[:2] = [1.0, 1.0 - gap]
    return np.concatenate([top, bulk])


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,top,gap", [
    (600, 10, [100.0 - 9.0 * i for i in range(10)], None),  # separated
    (601, 10, [100.0 - 9.0 * i for i in range(9)], 1e-4),   # cluster at k
    (600, 1, [100.0, 50.0], None),                          # k = 1
    (601, 12, [100.0, 60.0, 30.0], 1e-6),                    # odd n, bulk
])
def test_subset_eigh_matches_the_full_solve(cuda_device, n, k, top, gap):
    """The subset solve (cuSOLVER's reduction, the tridiagonal's top k
    on the host, k vectors back through ``ormtr``) against
    ``torch.linalg.eigh`` of the same matrix on the card: eigenvalues
    within 1e-5 of lambda_1; each pair's residual and the columns'
    orthogonality under 1e-5 (relative to lambda_1); each column equal to
    the full solve's up to sign where its gaps exceed 1e-2 of lambda_1.
    The reduction's status is read with T, ``ormtr``'s at the barrier."""
    from spark_examples_tpu_torch.core import profiling
    from spark_examples_tpu_torch.ops import eigh as eigh_ops

    lam = _spectrum(n, top, seed=n + k, gap=gap)
    b = _planted_on_card(n, lam, seed=n * k, device=cuda_device)
    vals, vecs = eigh_ops.subset_eigh(b, k)
    profiling.hard_sync((vals, vecs))
    assert not profiling._STATUSES
    assert vals.device == vecs.device == b.device
    assert vals.shape == (k,) and vecs.shape == (n, k)
    full_vals, full_vecs = torch.linalg.eigh(b)
    full_vals, full_vecs = full_vals.flip(0)[:k], full_vecs.flip(1)[:, :k]
    scale = float(full_vals[0])
    assert float((vals - full_vals).abs().max()) <= 1e-5 * scale
    assert bool((vals[:-1] >= vals[1:]).all())
    v, b64 = vecs.double(), b.double()
    resid = (b64 @ v - v * vals.double()).norm(dim=0)
    assert float(resid.max()) <= 1e-5 * scale
    eye = torch.eye(k, dtype=torch.float64, device=b.device)
    assert float((v.T @ v - eye).abs().max()) <= 1e-5
    spectrum = np.sort(lam)[::-1]
    for j in range(k):
        gaps = np.abs(np.delete(spectrum, j) - spectrum[j])
        if gaps.min() > 1e-2 * spectrum[0]:
            s = torch.sign(vecs[:, j] @ full_vecs[:, j])
            assert float((s * vecs[:, j] - full_vecs[:, j]).abs().max()) \
                <= 1e-4, j


@pytest.mark.gpu
def test_top_k_eigh_on_the_card_counts_its_subset_solves(cuda_device):
    """``top_k_eigh`` on the card takes the subset solve where
    ``subset_route`` says so (one ``eigh.subset_solves``, one
    ``eigh.solve`` span), and the full solve, the same numbers as
    ``torch.linalg.eigh``'s top k, where k reaches N or N is too small
    for k."""
    from spark_examples_tpu_torch.core import profiling
    from spark_examples_tpu_torch.ops import eigh as eigh_ops

    n = 3584
    lam = _spectrum(n, [100.0 - 9.0 * i for i in range(10)], seed=5)
    b = _planted_on_card(n, lam, seed=6, device=cuda_device)
    telemetry.reset()
    vals, vecs = eigh_ops.top_k_eigh(b, 10)
    profiling.hard_sync(vecs)
    snap = telemetry.metrics_snapshot()
    assert snap["counters"]["eigh.subset_solves"] == 1
    assert snap["histograms"]["eigh.solve"]["count"] == 1
    want = torch.linalg.eigvalsh(b).flip(0)[:10]
    assert float((vals - want).abs().max()) <= 1e-5 * float(want[0])
    for m, k in ((b, 32), (b[:8, :8].contiguous(), 8),
                 (b[:3072, :3072].contiguous(), 10)):
        assert not eigh_ops.subset_route(m.device, m.shape[0], k)
        vals, vecs = eigh_ops.top_k_eigh(m, k)
        full_vals, full_vecs = torch.linalg.eigh(m)
        assert torch.equal(vals, full_vals.flip(0)[:k])
        assert torch.equal(vecs, full_vecs.flip(1)[:, :k])
    profiling.hard_sync(vecs)
    assert telemetry.counter_value("eigh.subset_solves") == 1


@pytest.mark.gpu
def test_a_failed_status_on_the_card_raises_at_the_barrier(cuda_device):
    """A library's status word left nonzero on the card raises at its
    device's next barrier, and only there; a zero one passes."""
    from spark_examples_tpu_torch.core import profiling

    ok = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    bad = torch.full((1,), 7, dtype=torch.int32, device=cuda_device)
    profiling.check_at_barrier(ok, "a zero status")
    profiling.hard_sync(ok)
    profiling.check_at_barrier(bad, "cusolverDnSormtr")
    with pytest.raises(RuntimeError, match="cusolverDnSormtr.*status 7"):
        profiling.hard_sync(bad)
    assert not profiling._STATUSES
    # A word a panel: an early panel's failure before later zeros.
    panels = torch.tensor([0, -3, 0, 0], dtype=torch.int32,
                          device=cuda_device)
    profiling.check_at_barrier(panels, "cusolverDnSgeqrf")
    with pytest.raises(RuntimeError, match="cusolverDnSgeqrf.*status -3"):
        profiling.hard_sync(panels)
    assert not profiling._STATUSES


@pytest.mark.gpu
def test_the_subset_solve_adds_no_synchronisation_to_a_job(cuda_device,
                                                           monkeypatch):
    """A job whose eigensolve takes the subset route (its reach lowered to
    the job's N) waits on the card as often as with the full solve: the
    same device-wide synchronisations and event and stream waits. It
    counts one subset solve, and its eigenvalues agree with the job's
    CPU run within 1e-5 of lambda_1. (The full solve on the card reads
    this 512-sample matrix's eigenvalues ~1.4e-4 of lambda_1 high, which
    its float64 eigenvalues show; the subset solve reads them within
    2e-7.)"""
    from spark_examples_tpu_torch.ops import eigh as eigh_ops

    job, src, _ = _cell_like_job()
    jobs.pcoa_job(job, source=src)  # builds K1, warms cuSOLVER
    waits = []

    def counted(fn, kind):
        def wrapper(*args, **kwargs):
            waits.append(kind)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted(torch.cuda.synchronize, "device"))
    for cls in (torch.cuda.Event, torch.cuda.Stream):
        monkeypatch.setattr(cls, "synchronize",
                            counted(cls.synchronize, cls.__name__))

    def run(n2_per_pair):
        monkeypatch.setattr(eigh_ops, "SUBSET_N2_PER_PAIR", n2_per_pair)
        jobs.pcoa_job(job, source=src)  # warms the route
        waits.clear()
        telemetry.reset()
        out = jobs.pcoa_job(job, source=src)
        return (list(waits), telemetry.counter_value("eigh.subset_solves"),
                out.eigenvalues)

    full, full_solves, _ = run(float("inf"))
    subset, subset_solves, subset_vals = run(0.0)
    assert (full_solves, subset_solves) == (0, 1)
    for kind in ("device", "Event", "Stream"):
        assert subset.count(kind) == full.count(kind), kind
    job.compute.device = "cpu"
    want = jobs.pcoa_job(job, source=src).eigenvalues
    np.testing.assert_allclose(subset_vals, want, rtol=0,
                               atol=1e-5 * want[0])




@pytest.mark.gpu
def test_the_two_stage_solve_adds_no_synchronisation_to_a_job(cuda_device,
                                                              monkeypatch):
    """The same job with the subset solve's two-stage reduction (its
    reach lowered to the job's N): its streams join by events, so it
    waits on the card as often as the full solve, and it counts one
    ``eigh.two_stage_solves``."""
    from spark_examples_tpu_torch.ops import eigh as eigh_ops

    monkeypatch.setattr(eigh_ops, "TWO_STAGE_FROM", 0)
    test_the_subset_solve_adds_no_synchronisation_to_a_job(cuda_device,
                                                           monkeypatch)
    assert telemetry.counter_value("eigh.two_stage_solves") == 1

@pytest.mark.gpu
@pytest.mark.parametrize("n", [512, 1031, 2048])
def test_band_chase_matches_its_plain_counterpart(cuda_device, n):
    """The chase kernel (csrc/band_chase.cu) against its plain numpy
    counterpart on the same symmetric band, at the solve's band width
    (``ops/eigh.py::BAND_WIDTH``): status 0; T's spectrum within 2e-6
    of the band's norm of the band's float64 spectrum, on both sides;
    the first entries of T, which depend on few steps, within 1e-5 of
    each other; the kernel's reflectors rebuild the band, ``Q2 T
    Q2^T``, within 1e-5, and ``Q2`` is orthogonal within 1e-5; each
    kernel launches once."""
    from scipy.linalg import eig_banded

    from spark_examples_tpu_torch.ops import band_chase
    from spark_examples_tpu_torch.ops.eigh import BAND_WIDTH as width

    rng = np.random.default_rng(n + width)
    x = rng.standard_normal((n, n)).astype(np.float32)
    a = np.ascontiguousarray(x + x.T)
    band = band_chase.band_of(a, width)[:, :width + 1]
    dense = np.zeros((n, n))
    for d in range(width + 1):
        dense += np.diag(band[:n - d, d].astype(np.float64), -d)
    dense = np.tril(dense) + np.tril(dense, -1).T
    norm = np.abs(dense).sum(axis=0).max()
    want = eig_banded(band.T.astype(np.float64), lower=True,
                      eigvals_only=True)
    got_a = torch.from_numpy(a).to(cuda_device)
    tri = torch.empty(2 * n, dtype=torch.float32, device=cuda_device)
    before = band_chase.launches
    band_chase.chase(got_a, width, tri)
    torch.cuda.synchronize()
    assert band_chase.launches == before + 1
    plain_a = torch.from_numpy(a.copy())
    plain = torch.empty(2 * n, dtype=torch.float32)
    band_chase.chase(plain_a, width, plain)
    for t in (tri.cpu(), plain):
        assert int(t[-1:].view(torch.int32)) == 0
        d, e = t[:n].double().numpy(), t[n:-1].double().numpy()
        spec = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1)
                                  + np.diag(e, -1))
        assert np.abs(spec - want).max() <= 2e-6 * norm
    head = tri.cpu()[:8].numpy(), plain[:8].numpy()
    np.testing.assert_allclose(np.abs(head[0]), np.abs(head[1]), rtol=0,
                               atol=1e-5 * norm)
    q2 = torch.eye(n, dtype=torch.float32, device=cuda_device)
    before = band_chase.q2_launches
    band_chase.apply_q2(got_a, width, q2)
    assert band_chase.q2_launches == before + 1
    q = q2.double().cpu().numpy().T
    t = tri.cpu().double().numpy()
    tmat = np.diag(t[:n]) + np.diag(t[n:-1], 1) + np.diag(t[n:-1], -1)
    assert np.abs(q @ tmat @ q.T - dense).max() <= 1e-5 * norm
    assert np.abs(q.T @ q - np.eye(n)).max() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n", [10000, 15708])
def test_two_stage_solve_at_the_cells_sizes(cuda_device, n):
    """The subset solve at the one-card cells' sizes on a PCoA-class
    matrix (samples in groups over a noise bulk, ``B = X X^T / p`` in
    float64, ``tools/eigh_probe.py``'s cohort): its float32 top 10
    against float64 ``eigvalsh`` within the cells' limits, 3e-5 of
    lambda_1 for ``eig_gap`` and ``resid`` and 3e-5 for ``orth``; one
    ``eigh.two_stage_solves`` and one ``eigh.band`` and ``eigh.chase``
    span a solve, inside ``eigh.solve``."""
    from spark_examples_tpu_torch.core import profiling
    from spark_examples_tpu_torch.ops import eigh as eigh_ops
    from tools.eigh_probe import cohort_matrix

    b64 = cohort_matrix(n, 7, seed=n, device=cuda_device)
    want = torch.linalg.eigvalsh(b64).flip(0)[:10]
    b = b64.float()
    telemetry.reset()
    vals, vecs = eigh_ops.top_k_eigh(b, 10)
    profiling.hard_sync((vals, vecs))
    snap = telemetry.metrics_snapshot()
    assert snap["counters"]["eigh.two_stage_solves"] == 1
    hists = snap["histograms"]
    for name in ("eigh.solve", "eigh.band", "eigh.chase"):
        assert hists[name]["count"] == 1, name
    assert hists["eigh.band"]["sum"] + hists["eigh.chase"]["sum"] \
        <= hists["eigh.solve"]["sum"]
    scale = float(want[0])
    lam, v = vals.double(), vecs.double()
    assert float((lam - want).abs().max()) <= 3e-5 * scale
    assert float((b64 @ v - v * lam).norm(dim=0).max()) <= 3e-5 * scale
    eye = torch.eye(10, dtype=torch.float64, device=cuda_device)
    assert float((v.T @ v - eye).abs().max()) <= 3e-5

def _sotu_table(seed, n, f, depth=5000, richness=(100, 2000)):
    """A rarefied count table as CSR: each row ``depth`` reads over a few
    hundred to a few thousand features of ``f``, heavy-tailed."""
    rng = np.random.default_rng(seed)
    indptr, indices, counts = [0], [], []
    for _ in range(n):
        k = int(rng.integers(*richness))
        feats = np.sort(rng.choice(f, size=k, replace=False))
        c = rng.multinomial(depth, rng.dirichlet(np.full(k, 0.1)))
        keep = c > 0
        indices.append(feats[keep])
        counts.append(c[keep])
        indptr.append(indptr[-1] + int(keep.sum()))
    return (np.array(indptr), np.concatenate(indices).astype(np.int32),
            np.concatenate(counts).astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [300, 384])
def test_k2_at_the_cell_width_equals_the_exact_numerator(cuda_device, n):
    """K2 on a band of rows at the Bray-Curtis cell's 262,144 features
    (N F past 2^26; the cell's 10,000 rows take it past 2^31): bitwise
    the reference's exact integer numerator, both triangles."""
    from benchmark.reference.braycurtis_ref import manhattan

    from spark_examples_tpu_torch.ingest.table import CountTableSource

    f = 262_144
    indptr, indices, counts = _sotu_table(n, n, f)
    x = CountTableSource(indptr, indices, counts, f).dense(cuda_device)
    before = telemetry.counter_value("kernel.braycurtis.launches")
    got = braycurtis_kernel.pairwise_manhattan_kernel(x)
    assert telemetry.counter_value("kernel.braycurtis.launches") == \
        before + 1
    want = manhattan(indptr, indices, counts, f, cuda_device)
    torch.cuda.synchronize()
    assert counts.max() > 256
    assert torch.equal(got.double(), want)


@pytest.mark.gpu
def test_count_table_densified_on_the_card_equals_the_host_csr(
        cuda_device):
    from spark_examples_tpu_torch.ingest.table import CountTableSource

    n, f = 257, 40_001
    indptr, indices, counts = _sotu_table(3, n, f)
    src = CountTableSource(indptr, indices, counts, f)
    want = np.zeros((n, f), np.float32)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        want[i, indices[lo:hi]] = counts[lo:hi]
    for _ in range(2):  # the second upload reuses the pinned arrays
        got = src.dense(cuda_device)
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), want)
    assert np.array_equal(src.dense("cpu").numpy(), want)


@pytest.mark.gpu
def test_a_braycurtis_job_over_a_count_table_launches_k2_once(cuda_device):
    """One K2 launch and one table upload a job, each with its device
    span; the job judged against the plain reference under the
    Bray-Curtis cell's limits, and its CPU run beside it."""
    import json
    import pathlib

    from benchmark.reference.braycurtis_ref import Reference
    from benchmark.reference.compare import judge

    from spark_examples_tpu_torch.ingest.table import CountTableSource

    n, f = 600, 20_000
    indptr, indices, counts = _sotu_table(11, n, f, depth=2000)
    src = CountTableSource(indptr, indices, counts, f)
    job = JobConfig(compute=ComputeConfig(metric="braycurtis", num_pc=6,
                                          device="cuda"))
    jobs.pcoa_job(job, source=src)  # builds K2, warms cuSOLVER
    telemetry.reset()
    before = braycurtis_kernel.launches
    out = jobs.pcoa_job(job, source=src)
    assert braycurtis_kernel.launches == before + 1
    assert telemetry.counter_value("kernel.braycurtis.launches") == 1
    assert telemetry.counter_value("table.nnz") == len(indices)
    for span in ("kernel.braycurtis.launch", "table.upload"):
        assert telemetry.histogram_sum(span) > 0, span
    limits = json.loads((pathlib.Path(__file__).resolve().parents[1]
                         / "benchmark" / "workloads"
                         / "emp-10k.braycurtis-memory.json").read_text())[
                             "limits"]
    ref = Reference(indptr, indices, counts, f, 6, cuda_device)
    readings = judge(ref, out.coords, out.eigenvalues)
    assert all(readings[k] <= limits[k] for k in limits), readings
    job.compute.device = "cpu"
    cpu = jobs.pcoa_job(job, source=src)
    np.testing.assert_allclose(out.eigenvalues, cpu.eigenvalues, rtol=0,
                               atol=1e-5 * cpu.eigenvalues[0])
    telemetry.reset()
