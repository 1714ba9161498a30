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
