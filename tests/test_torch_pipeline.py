"""The PyTorch port's slice as a whole against the JAX package, on the
CPU: the same SyntheticSource seed through both ``pcoa_job`` routes, the
CLI, the feed, its error cases, and the import boundary."""

import ast
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core.profiling import PhaseTimer as JPhaseTimer
from spark_examples_tpu.ingest import SyntheticSource as JSyntheticSource
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core.profiling import PhaseTimer, hard_sync
from spark_examples_tpu_torch.ingest import prefetch as tprefetch
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.pipelines import jobs as tjobs
from spark_examples_tpu_torch.pipelines import runner as trunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, V, BV, K = 48, 4096, 512, 4


def _jobs(num_pc=K, output_path=None):
    j = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV),
        compute=jconfig.ComputeConfig(metric="ibs", num_pc=num_pc))
    t = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(n_samples=N, n_variants=V,
                                    block_variants=BV),
        compute=tconfig.ComputeConfig(metric="ibs", num_pc=num_pc,
                                      device="cpu"),
        output_path=output_path)
    return j, t


@pytest.fixture(scope="module")
def slice_runs():
    jjob, tjob = _jobs()
    jg = jrunner.run_gram(jjob, JSyntheticSource(n_samples=N, n_variants=V),
                          JPhaseTimer())
    tg = trunner.run_gram(tjob, SyntheticSource(n_samples=N, n_variants=V),
                          PhaseTimer())
    jout = jjobs.pcoa_job(jjob, source=JSyntheticSource(n_samples=N,
                                                        n_variants=V))
    tout = tjobs.pcoa_job(tjob, source=SyntheticSource(n_samples=N,
                                                       n_variants=V))
    return jg, tg, jout, tout


def test_slice_int32_accumulators_are_bitwise_equal(slice_runs):
    jg, tg, _, _ = slice_runs
    assert tg.lowering == "reference"
    assert tg.n_variants == jg.n_variants == V
    for leaf in ("cc", "yc", "t1t1", "t2t2"):
        np.testing.assert_array_equal(tg.acc[leaf].numpy(),
                                      np.asarray(jg.acc[leaf]), err_msg=leaf)


def test_slice_eigenpairs_agree_with_jax(slice_runs):
    """Eigenvalues agree within 1e-4 of lambda_1 (f32 centering and two
    eigensolvers); coordinates agree per column up to sign, within 2e-3
    of the column's scale, for columns whose eigengap to both neighbours
    exceeds 2% of lambda_1 (closer pairs may rotate into each other)."""
    _, _, jout, tout = slice_runs
    jv, tv = np.asarray(jout.eigenvalues), tout.eigenvalues
    np.testing.assert_allclose(tv, jv, atol=1e-4 * jv[0])
    gaps = np.diff(jv)
    checked = 0
    for j in range(K):
        left = abs(gaps[j - 1]) if j > 0 else np.inf
        right = abs(gaps[j]) if j < K - 1 else np.inf
        if min(left, right) <= 0.02 * jv[0]:
            continue
        jc, tc = np.asarray(jout.coords)[:, j], tout.coords[:, j]
        s = np.sign(np.dot(jc, tc)) or 1.0
        scale = np.abs(jc).max()
        np.testing.assert_allclose(s * tc, jc, atol=2e-3 * scale,
                                   err_msg=f"pc{j + 1}")
        checked += 1
    assert checked >= 1
    assert np.isfinite(tout.coords).all()
    assert tout.coords.shape == (N, K)


def test_pcoa_cli_writes_the_coords_tsv(tmp_path, capsys):
    out = tmp_path / "coords.tsv"
    rc = tmain(["pcoa", "--device", "cpu", "--n-samples", "24",
                "--n-variants", "600", "--block-variants", "256",
                "--num-pc", "3", "--output-path", str(out), "--timings"])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "sample\tpc1\tpc2\tpc3"
    assert len(lines) == 25
    captured = capsys.readouterr()
    assert "24 samples x 3 components" in captured.out
    assert '"gram"' in captured.err and '"eigh"' in captured.err


def test_similarity_job_matches_jax(tmp_path):
    jjob, tjob = _jobs(output_path=str(tmp_path / "sim.tsv"))
    src_kw = dict(n_samples=N, n_variants=V)
    got = tjobs.similarity_matrix_job(tjob, SyntheticSource(**src_kw))
    want = jrunner.run_similarity(jjob, JSyntheticSource(**src_kw))
    np.testing.assert_array_equal(got.similarity, want.similarity)
    np.testing.assert_array_equal(got.distance, want.distance)
    assert (tmp_path / "sim.tsv.meta.json").exists()


def test_similarity_cli(tmp_path, capsys):
    rc = tmain(["similarity", "--device", "cpu", "--n-samples", "10",
                "--n-variants", "300", "--output-path",
                str(tmp_path / "m.npy")])
    assert rc == 0
    assert np.load(tmp_path / "m.npy").shape == (10, 10)
    assert "similarity[ibs] 10x10 over 300 variants" in capsys.readouterr().out


def test_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tmain(["pcoa", "--n-samples", "8", "--n-variants", "64"])


def test_fused_lowering_on_cpu_raises_naming_the_flag():
    with pytest.raises(ValueError, match="--gram-lowering fused"):
        tmain(["pcoa", "--device", "cpu", "--gram-lowering", "fused",
               "--n-samples", "8", "--n-variants", "64"])


@pytest.mark.parametrize("argv,match", [
    (["--metric", "bogus"], "invalid choice"),
    (["--block-variants", "0"], "block_variants"),
])
def test_bad_flags_are_usage_errors(argv, match, capsys):
    with pytest.raises(SystemExit):
        tmain(["pcoa", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("kw,match", [
    (dict(solver="sketch", sketch_rank=4), "--sketch-rank=4 < --num-pc"),
    (dict(metric="bogus"), "registered kernels"),
    (dict(pack_stream="zip"), "pack_stream"),
    (dict(device="tpu"), "--device"),
    (dict(braycurtis_method="pallas"), "--braycurtis-method"),
])
def test_compute_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tconfig.ComputeConfig(**kw)


def test_unported_source_and_checkpoints_are_refused(tmp_path):
    # parquet is ported: it needs its --path like every file source.
    with pytest.raises(ValueError, match="parquet source requires --path"):
        trunner.build_source(tconfig.IngestConfig(source="parquet"))
    # The dataset store is ported: it is opened, not refused.
    with pytest.raises(ValueError, match="requires --path"):
        trunner.build_source(tconfig.IngestConfig(source="store"))
    with pytest.raises(ValueError, match="not a dataset store"):
        trunner.build_source(tconfig.IngestConfig(source="store:some/dir"))
    # Checkpoints are ported, the tiled layout too; a tiled one is
    # refused under a plan with another tile grid (this job's is one
    # slot, replicated).
    _, tjob = _jobs()
    ck = str(tmp_path / "ck")
    tjob.compute.checkpoint_dir = ck
    tjob.compute.checkpoint_every_blocks = 1
    src = SyntheticSource(n_samples=4, n_variants=8)
    trunner.run_gram(tjob, src, PhaseTimer())
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    manifest.update(mesh_shape=[2, 4], mode="tile2d")
    manifest["layout"]["cc"] = "tiles"
    with open(os.path.join(ck, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="resume must keep the tile grid"):
        trunner.run_gram(tjob, src, PhaseTimer())


@pytest.mark.parametrize("pack", [False, True])
def test_feed_pads_the_ragged_tail_and_keeps_one_shape(pack):
    src = SyntheticSource(n_samples=6, n_variants=1000, seed=2)
    got = list(tprefetch.stream_to_device(src, 384, torch.device("cpu"),
                                          pack=pack))
    width = tprefetch.padded_width(384, pack=pack)
    assert [m.stop for _, m in got] == [384, 768, 1000]
    assert all(b.shape == (6, width) for b, _ in got)
    tail = got[-1][0].numpy()
    if pack:
        assert (tail[:, (1000 - 768) // 4:] == 0xFF).all()
    else:
        assert (tail[:, 1000 - 768:] == -1).all()
        np.testing.assert_array_equal(
            tail[:, :1000 - 768], list(src.blocks(384))[-1][0])


def test_feed_propagates_producer_errors_and_stops_on_abandon():
    class Broken(SyntheticSource):
        def blocks(self, bv, start_variant=0):
            yield from super().blocks(bv, start_variant)
            raise OSError("disk went away")

    src = Broken(n_samples=4, n_variants=100)
    with pytest.raises(OSError, match="disk went away"):
        list(tprefetch.stream_to_device(src, 40, torch.device("cpu")))
    it = tprefetch.stream_to_device(
        SyntheticSource(n_samples=4, n_variants=10_000), 40,
        torch.device("cpu"), prefetch=1)
    next(it)
    it.close()
    assert not any(t.name == "prefetch-producer" and t.is_alive()
                   for t in threading.enumerate())


def test_hard_sync_returns_its_argument_and_timer_reports():
    tree = {"a": torch.zeros(2), "b": [torch.ones(1)]}
    assert hard_sync(tree) is tree
    t = PhaseTimer()
    with t.phase("gram"):
        pass
    t.add("gram_flops", 1e9)
    rep = t.report()
    assert rep["gram_flops"] == 1e9 and "gram_gflops_per_s" in rep


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port (and chip_smoke.py) in a fresh
    interpreter: neither jax nor spark_examples_tpu may be loaded. The
    store, telemetry, faults, hashing, sidecar, parallel and resilient
    modules must be among them, and since the fit-then-project slice the
    native codec, the parquet source, projection and the factorized
    model, and since the streaming/neighbors slice streaming PCoA, the
    example tier, coverage, the reads sources and the neighbors
    package, and the serve package and the live telemetry plane, and
    since the supervision/fleet slice the supervisor, the stitcher and
    the fleet's pool, router and manifest, and since the fleet-control
    slice the fleet controller package and the host oracle, and since
    the benchmark slice the trend gate and ``bench_torch.py`` (which
    import neither ``tools`` either), and since the mesh-sketch slice
    the chaos soak (``tools.soak``) and the sketch over the mesh."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import spark_examples_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.') if not m.name.endswith('__main__')]\n"
        "need = ['store', 'store.cache', 'store.codec', 'store.heal', "
        "'store.manifest', 'store.quarantine', 'store.readahead', "
        "'store.reader', 'store.writer', 'core.telemetry', 'core.faults', "
        "'core.hashing', 'core.sidecar', 'ingest.parallel', "
        "'ingest.resilient', 'core.checkpoint', 'solvers.sketch', "
        "'solvers.solve', 'solvers.driver', 'native', 'ingest.parquet', "
        "'pipelines.project', 'models.factorized', 'pipelines.streaming', "
        "'pipelines.examples', 'pipelines.coverage', 'ingest.reads', "
        "'neighbors', 'neighbors.engine', 'neighbors.minhash', "
        "'neighbors.lsh', 'neighbors.output', 'serve', 'serve.cache', "
        "'serve.health', 'serve.engine', 'serve.server', 'serve.http', "
        "'serve.loadgen', 'core.live', 'core.profiling', "
        "'core.supervisor', 'core.stitch', 'serve.pool', 'serve.router', "
        "'serve.fleet', 'fleet', 'fleet.controller', 'fleet.replica', "
        "'fleet.placement', 'fleet.slo', 'fleet.timeline', "
        "'utils.oracle', 'tools.trend', 'tools.soak']\n"
        "missing = [m for m in need if p.__name__ + '.' + m not in names]\n"
        "assert not missing, missing\n"
        "for n in names: importlib.import_module(n)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_imported')\n"
        "runpy.run_path('bench_torch.py', run_name='bench_torch_imported')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'spark_examples_tpu' or m.startswith('spark_examples_tpu.') "
        "or m == 'tools' or m.startswith('tools.'))\n"
        "assert len(names) >= 20, names\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout
    # Statically too, so imports inside functions (chip_smoke's main)
    # are covered.
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "bench_torch.py")] + [
        os.path.join(d, f)
        for d, _, fs in os.walk(os.path.join(REPO, "spark_examples_tpu_torch"))
        for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib",
                                               "spark_examples_tpu",
                                               "tools"), \
                    f"{path}:{node.lineno} imports {m}"


# -------------------------------------------------- file-source jobs

FN, FV, FBV, FK = 32, 1200, 256, 3


@pytest.fixture(scope="module")
def cohort_files(tmp_path_factory):
    """One synthetic cohort written as a PLINK fileset, a VCF and a
    packed store by the JAX package's writers."""
    from spark_examples_tpu.ingest import packed as jpacked
    from spark_examples_tpu.ingest import plink as jplink
    from spark_examples_tpu.ingest import vcf as jvcf

    d = tmp_path_factory.mktemp("cohort")
    src = JSyntheticSource(n_samples=FN, n_variants=FV, seed=3)
    g = np.concatenate([b for b, _ in src.blocks(4096)], axis=1)
    jplink.write_plink(str(d / "c"), g, sample_ids=src.sample_ids)
    jvcf.write_vcf(str(d / "c.vcf.gz"), g, sample_ids=src.sample_ids)
    jpacked.save_packed(str(d / "store"), g, sample_ids=src.sample_ids)
    return {"plink": str(d / "c"), "vcf": str(d / "c.vcf.gz"),
            "packed": str(d / "store"), "genotypes": g}


def _file_jobs(source, path, metric, **ingest):
    j = jconfig.JobConfig(
        ingest=jconfig.IngestConfig(source=source, path=path,
                                    block_variants=FBV, **ingest),
        compute=jconfig.ComputeConfig(metric=metric, num_pc=FK))
    t = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(source=source, path=path,
                                    block_variants=FBV, **ingest),
        compute=tconfig.ComputeConfig(metric=metric, num_pc=FK,
                                      device="cpu"))
    return j, t


def _assert_coords_agree(jout, tout, k):
    """Eigenvalues within 1e-4 of lambda_1; coordinate columns with an
    eigengap above 2 % of lambda_1 agree up to sign within 2e-3 of their
    scale (the tolerances of test_slice_eigenpairs_agree_with_jax)."""
    jv, tv = np.asarray(jout.eigenvalues), tout.eigenvalues
    np.testing.assert_allclose(tv, jv, atol=1e-4 * jv[0])
    gaps = np.diff(jv)
    checked = 0
    for c in range(k):
        left = abs(gaps[c - 1]) if c > 0 else np.inf
        right = abs(gaps[c]) if c < k - 1 else np.inf
        if min(left, right) <= 0.02 * jv[0]:
            continue
        jc, tc = np.asarray(jout.coords)[:, c], tout.coords[:, c]
        s = np.sign(np.dot(jc, tc)) or 1.0
        np.testing.assert_allclose(s * tc, jc,
                                   atol=2e-3 * np.abs(jc).max(),
                                   err_msg=f"pc{c + 1}")
        checked += 1
    assert checked >= 1
    assert tout.sample_ids == list(jout.sample_ids)


@pytest.mark.parametrize("source", ["plink", "vcf", "packed"])
@pytest.mark.parametrize("metric", ["euclidean", "grm", "ibs"])
def test_pcoa_from_cohort_files_matches_jax(cohort_files, source, metric):
    """pcoa read from each file source, with a dense-transport kernel
    (euclidean: accumulators bitwise), the float kernel (grm: zz within
    the 1e-5 * max|zz| of tests/test_torch_grm.py, nvar equal) and a
    packed one (ibs, the packed store's bytes streamed as stored)."""
    jjob, tjob = _file_jobs(source, cohort_files[source], metric)
    jg = jrunner.run_gram(jjob, jrunner.build_source(jjob.ingest),
                          JPhaseTimer())
    tg = trunner.run_gram(tjob, trunner.build_source(tjob.ingest, "cpu"),
                          PhaseTimer())
    assert tg.n_variants == jg.n_variants == FV
    for leaf in jg.acc:
        want = np.asarray(jg.acc[leaf])
        if metric == "grm" and leaf == "zz":
            np.testing.assert_allclose(tg.acc[leaf].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(tg.acc[leaf].numpy(), want,
                                          err_msg=leaf)
    tout = tjobs.pcoa_job(tjob)
    jout = jjobs.pcoa_job(jjob)
    assert tout.n_variants == FV and tout.coords.shape == (FN, FK)
    _assert_coords_agree(jout, tout, FK)


def test_qc_and_ld_pruned_pcoa_from_plink_matches_jax(cohort_files):
    kw = dict(maf=0.05, max_missing=0.02, ld_r2=0.2, ld_window=64)
    jjob, tjob = _file_jobs("plink", cohort_files["plink"], "ibs", **kw)
    tsrc = trunner.build_source(tjob.ingest, "cpu")
    jsrc = jrunner.build_source(jjob.ingest)
    assert type(tsrc).__name__ == type(jsrc).__name__ == "LdPruneSource"
    assert type(tsrc.inner).__name__ == "FilteredSource"
    kept_t = np.concatenate([m.positions for _, m in tsrc.blocks(FBV)])
    kept_j = np.concatenate([m.positions for _, m in jsrc.blocks(FBV)])
    np.testing.assert_array_equal(kept_t, kept_j)
    assert 0 < kept_t.size < FV
    tout = tjobs.pcoa_job(tjob)
    jout = jjobs.pcoa_job(jjob)
    assert tout.n_variants == jout.n_variants == kept_t.size
    _assert_coords_agree(jout, tout, FK)


def test_pca_and_similarity_read_the_file_sources(cohort_files):
    jjob, tjob = _file_jobs("vcf", cohort_files["vcf"], "king")
    got = tjobs.similarity_matrix_job(tjob)
    want = jrunner.run_similarity(jjob)
    np.testing.assert_array_equal(got.similarity, want.similarity)
    np.testing.assert_array_equal(got.distance, want.distance)
    _, pjob = _file_jobs("packed", cohort_files["packed"], None)
    out = tjobs.variants_pca_job(pjob)
    assert out.coords.shape == (FN, FK) and np.isfinite(out.coords).all()


def test_pack_cli_then_pcoa_from_the_store(cohort_files, tmp_path, capsys):
    """``pack`` a PLINK fileset through the port's CLI; the store holds
    the bytes the JAX package's pack_source writes, and a pcoa from it
    equals the pcoa from the fileset."""
    from spark_examples_tpu.ingest import packed as jpacked
    from spark_examples_tpu.ingest import plink as jplink

    store = str(tmp_path / "store")
    rc = tmain(["pack", "--device", "cpu", "--source", "plink", "--path",
                cohort_files["plink"], "--block-variants", "300",
                "--output-path", store])
    assert rc == 0
    assert f"packed {FN} samples x {FV} variants" in capsys.readouterr().out
    jstore = str(tmp_path / "jstore")
    jpacked.pack_source(jstore, jplink.PlinkSource(cohort_files["plink"]),
                        300)
    for f in sorted(os.listdir(jstore)):
        with open(os.path.join(store, f), "rb") as a, \
                open(os.path.join(jstore, f), "rb") as b:
            assert a.read() == b.read(), f
    outs = {}
    for source, path in (("packed", store), ("plink",
                                             cohort_files["plink"])):
        out = tmp_path / f"{source}.tsv"
        assert tmain(["pcoa", "--device", "cpu", "--source", source,
                      "--path", path, "--block-variants", "256",
                      "--num-pc", "3", "--output-path", str(out)]) == 0
        outs[source] = out.read_text()
    assert outs["packed"] == outs["plink"]


@pytest.mark.parametrize("argv,match", [
    (["pack", "--source", "synthetic"], "--output-path"),
    (["pcoa", "--source", "vcf"], "requires --path"),
    (["pcoa", "--source", "parquet"], "requires --path"),
    (["pcoa", "--source", "store:st"], "not a dataset store"),
    (["pcoa", "--source", "csv"], "invalid source"),
    (["pcoa", "--references", "chr1:9:3"], "end must be > start"),
    (["pcoa", "--ld-window", "1"], "--ld-window"),
    (["pcoa", "--maf", "0.7"], "--maf"),
])
def test_file_source_flags_are_checked(argv, match, capsys):
    with pytest.raises((SystemExit, ValueError)) as err:
        tmain(argv[:1] + ["--device", "cpu"] + argv[1:])
    text = capsys.readouterr().err + str(err.value)
    assert match in text
