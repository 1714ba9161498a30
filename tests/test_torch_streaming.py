"""Streaming incremental PCoA (``pcoa --stream-refresh-blocks``) against
the JAX package's, on the CPU.

- With the JAX package's probes patched into the port's seam
  (``streaming.probes``), the snapshot count and cursors are equal, and
  the eigenvalues and |coords| of every snapshot and of the final solve
  agree within ``EIG_RTOL`` and ``COORD_ATOL``. Measured on these
  cohorts: at most 5.5e-7 relative on the eigenvalues and 9e-7 absolute
  on |coords| (max |coords| ~0.12): f32 reductions in another order.
- With the port's own probes, the JAX package's tolerances against the
  port's dense ``pcoa_job`` apply (its ``tests/test_streaming.py``).
- With 10 PCs on 5 populations, the bulk eigenvalues converge only to
  a few percent in both packages, within 1e-2 of the top eigenvalue.
- The refusals, the probe clamp for N < k + 32, the CLI's two
  ``parser.error``s, the ``on_block`` hook, the reuse of the last
  refresh's centered matrix, and the ``stream.snapshot`` events.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.ops.eigh import init_probes as jinit_probes
from spark_examples_tpu.pipelines import streaming as jstreaming
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.pipelines import jobs, runner, streaming

EIG_RTOL = 1e-5
COORD_ATOL = 1e-5


def _ingest(mod, n=48, v=4096, seed=11):
    return mod.IngestConfig(source="synthetic", n_samples=n, n_variants=v,
                            block_variants=256, seed=seed, n_populations=3)


def _tjob(n=48, v=4096, seed=11, metric="ibs", num_pc=4, **kw):
    return tconfig.JobConfig(
        ingest=_ingest(tconfig, n, v, seed),
        compute=tconfig.ComputeConfig(metric=metric, num_pc=num_pc,
                                      device="cpu", **kw))


def _jjob(n=48, v=4096, seed=11, metric="ibs", num_pc=4, **kw):
    return jconfig.JobConfig(
        ingest=_ingest(jconfig, n, v, seed),
        compute=jconfig.ComputeConfig(metric=metric, num_pc=num_pc, **kw))


@pytest.fixture
def jax_probes(monkeypatch):
    import jax

    def probes(n, p, device):
        q = np.array(jinit_probes(jax.random.key(0), n, p))
        return torch.from_numpy(q).to(device)

    monkeypatch.setattr(streaming, "probes", probes)


@pytest.mark.parametrize("refresh,metric,shape", [
    (4, "ibs", (48, 4096, 11)), (3, "ibs", (40, 3000, 5)),
    (2, "king", (36, 2048, 2))])
def test_with_jax_probes_matches_jax(jax_probes, refresh, metric, shape):
    n, v, seed = shape
    out, snaps = streaming.incremental_pcoa_job(
        _tjob(n, v, seed, metric, stream_refresh_blocks=refresh))
    jout, jsnaps = jstreaming.incremental_pcoa_job(
        _jjob(n, v, seed, metric, stream_refresh_blocks=refresh))
    assert [s.n_variants for s in snaps] == [s.n_variants for s in jsnaps]
    assert len(snaps) == (-(-v // 256)) // refresh
    pairs = [(out.eigenvalues, out.coords, jout.eigenvalues, jout.coords)]
    pairs += [(s.eigenvalues, s.coords, np.asarray(js.eigenvalues),
               np.asarray(js.coords)) for s, js in zip(snaps, jsnaps)]
    for vals, coords, jvals, jcoords in pairs:
        assert isinstance(vals, np.ndarray) and vals.shape == (4,)
        np.testing.assert_allclose(vals, jvals, rtol=EIG_RTOL)
        np.testing.assert_allclose(np.abs(coords), np.abs(jcoords),
                                   atol=COORD_ATOL, rtol=0)
    assert out.n_variants == jout.n_variants == v
    assert out.sample_ids == list(jout.sample_ids)


def test_incremental_matches_full_recompute():
    out, snapshots = streaming.incremental_pcoa_job(
        _tjob(stream_refresh_blocks=4))
    # 4096 / 256 = 16 blocks -> refreshes at blocks 4, 8, 12, 16.
    assert [s.n_variants for s in snapshots] == [1024, 2048, 3072, 4096]
    for name in ("stream_refresh", "stream_drain", "gram", "eigh"):
        assert name in out.timer.phases
    full = jobs.pcoa_job(_tjob(eigh_mode="dense"))
    np.testing.assert_allclose(out.eigenvalues, full.eigenvalues,
                               rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(np.abs(out.coords[:, :2]),
                               np.abs(full.coords[:, :2]),
                               rtol=1e-2, atol=1e-3)


def test_snapshots_track_final_solution():
    out, snapshots = streaming.incremental_pcoa_job(
        _tjob(stream_refresh_blocks=2))
    assert len(snapshots) == 8
    final = out.eigenvalues[0]
    errs = [abs(s.eigenvalues[0] - final) / final for s in snapshots]
    assert errs[0] < 0.25
    assert all(e < 0.10 for e in errs[1:])
    assert errs[-1] < 0.02


def test_small_cohort_probe_clamp():
    """N < num_pc + oversample: the probe block is clamped to (N, N)."""
    job = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(n_samples=20, n_variants=1024,
                                    block_variants=256, seed=3),
        compute=tconfig.ComputeConfig(metric="ibs", num_pc=10, device="cpu",
                                      stream_refresh_blocks=2))
    out, snapshots = streaming.incremental_pcoa_job(job)
    assert out.coords.shape == (20, 10)
    assert len(snapshots) == 2
    assert streaming.probes(20, 42, "cpu").shape == (20, 20)


@pytest.mark.parametrize("kw,match", [
    (dict(stream_refresh_blocks=0), "stream_refresh_blocks"),
    (dict(stream_refresh_blocks=2, metric="braycurtis"), "braycurtis"),
    (dict(stream_refresh_blocks=2, eigh_mode="dense"), "dense"),
    (dict(stream_refresh_blocks=2, solver="corrected"), "--solver"),
    (dict(stream_refresh_blocks=2, solver="sketch"), "--solver"),
])
def test_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        streaming.incremental_pcoa_job(_tjob(**kw))


def test_refresh_reuses_the_last_centered_matrix(monkeypatch):
    calls = []
    center = streaming._center
    monkeypatch.setattr(streaming, "_center",
                        lambda acc, m: calls.append(1) or center(acc, m))
    streaming.incremental_pcoa_job(_tjob(stream_refresh_blocks=4))
    assert len(calls) == 4  # 4 refreshes; the terminal solve reuses B
    calls.clear()
    _, snaps = streaming.incremental_pcoa_job(_tjob(stream_refresh_blocks=5))
    assert len(snaps) == 3 and len(calls) == 4  # 3 refreshes + terminal


def test_snapshot_events_are_recorded():
    telemetry.reset()
    try:
        streaming.incremental_pcoa_job(_tjob(v=2048, stream_refresh_blocks=4))
        ev = telemetry.events("stream.snapshot")
        assert [e["args"] for e in ev] == [
            {"n_variants": 1024, "blocks_done": 4},
            {"n_variants": 2048, "blocks_done": 8}]
        assert all(e["cat"] == "stream" for e in ev)
    finally:
        telemetry.reset()


def test_run_gram_on_block_hook_sees_every_block():
    seen = []

    def hook(acc, blocks_done, meta):
        seen.append((blocks_done, meta.stop, int(acc["cc"].sum())))

    job = _tjob(v=1000)
    g = runner.run_gram(job, SyntheticSource(n_samples=48, n_variants=1000,
                                             seed=11, n_populations=3),
                        PhaseTimer(), on_block=hook)
    assert [s[:2] for s in seen] == [(1, 256), (2, 512), (3, 768), (4, 1000)]
    assert seen[-1][2] == int(g.acc["cc"].sum())
    assert seen[0][2] < seen[-1][2]  # the hook ran between updates


def test_cli_stream_refresh(tmp_path, capsys):
    from spark_examples_tpu_torch.cli.main import main as tmain

    path = str(tmp_path / "c.tsv")
    argv = ["pcoa", "--device", "cpu", "--n-samples", "48", "--n-variants",
            "4096", "--block-variants", "256", "--seed", "11",
            "--n-populations", "3", "--num-pc", "4"]
    assert tmain(argv + ["--stream-refresh-blocks", "4",
                         "--output-path", path]) == 0
    out = capsys.readouterr().out
    assert out.count("snapshot@") == 4
    assert "snapshot@4096 variants: top eigenvalue" in out
    want, _ = streaming.incremental_pcoa_job(_tjob(stream_refresh_blocks=4))
    with open(path) as f:
        rows = [line.split("\t") for line in f.read().splitlines()[1:]]
    assert [r[0] for r in rows] == want.sample_ids
    for name, flag in (("--matrix-path", "x.npy"),
                       ("--save-model", "m.npz")):
        with pytest.raises(SystemExit):
            tmain(argv + ["--stream-refresh-blocks", "2", name, flag])
        err = capsys.readouterr().err
        assert name in err and "stream" in err


def test_bulk_eigenvalues_converge_to_a_few_percent_as_in_jax():
    """With more PCs than structure axes (5 populations, 10 PCs), the
    4 structure eigenvalues of the streaming route match the dense
    solve's, but the 6 bulk ones converge only to a few percent: one
    warm power step per refresh and 4 terminal steps, in the JAX
    package's route as in the port's. Relative to the top eigenvalue
    (the scale that moves coordinates) both stay within 1e-2, the bound
    the card's smoke run holds the Quickstart job to."""
    n, v = 300, 20000

    def tjob(**kw):
        return tconfig.JobConfig(
            ingest=tconfig.IngestConfig(n_samples=n, n_variants=v,
                                        block_variants=2048),
            compute=tconfig.ComputeConfig(metric="ibs", num_pc=10,
                                          device="cpu", **kw))

    def jjob(**kw):
        return jconfig.JobConfig(
            ingest=jconfig.IngestConfig(source="synthetic", n_samples=n,
                                        n_variants=v, block_variants=2048),
            compute=jconfig.ComputeConfig(metric="ibs", num_pc=10, **kw))

    from spark_examples_tpu.pipelines import jobs as jjobs

    runs = {
        "jax": (jstreaming.incremental_pcoa_job(
            jjob(stream_refresh_blocks=4))[0].eigenvalues,
            jjobs.pcoa_job(jjob(eigh_mode="dense")).eigenvalues),
        "port": (streaming.incremental_pcoa_job(
            tjob(stream_refresh_blocks=4))[0].eigenvalues,
            jobs.pcoa_job(tjob(eigh_mode="dense")).eigenvalues),
    }
    for name, (got, dense) in runs.items():
        got, dense = np.asarray(got), np.asarray(dense)
        rel = np.abs(got - dense) / dense
        assert rel[:4].max() < 1e-5, (name, rel)
        assert rel[4:].min() > 1e-2, (name, rel)  # bulk: a few percent
        assert np.abs(got - dense).max() < 1e-2 * dense[0], (name, rel)


def test_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = tconfig.JobConfig(ingest=_ingest(tconfig),
                            compute=tconfig.ComputeConfig(
                                stream_refresh_blocks=2))
    with pytest.raises(RuntimeError, match="--device cuda"):
        streaming.incremental_pcoa_job(job)
