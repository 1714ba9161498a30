"""The port's checkpoints against the JAX package's, on the CPU.

- The same accumulators saved by both packages, under the same (2, 4)
  variant plan (the JAX tests run on 8 virtual devices, the port on 8
  virtual CPU slots), give byte-identical leaf files, equal sha256
  values and equal manifests.
- A job killed after four blocks (``checkpoint_every_blocks=2``) and
  resumed by the other package ends with int32 accumulators bitwise
  equal to an uninterrupted JAX run, both ways, for ibs (packed
  transport) and dot (dense transport: ``stream_stats`` travels with
  the checkpoint, so the resumed int32 guard sees the whole stream's
  largest value).
- Integrity: a flipped byte falls back to ``.old`` (the corrupt
  generation promoted aside), two corrupt generations raise, an armed
  ``checkpoint.tile_write`` truncation is caught on load, and a
  checkpoint of another block grid, metric, cohort, leaf set, ``extra``
  record, process count or another tile grid is refused by name.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import checkpoint as jckpt
from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core.profiling import PhaseTimer as JPhaseTimer
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import faults, meshes, telemetry, virtual
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.parallel import gram_sharded
from spark_examples_tpu_torch.pipelines import runner

N, V, BV = 16, 1024, 128
DIE_AT = 4  # blocks a dying source yields before it raises


def _cohort(metric: str) -> np.ndarray:
    """Dosages for the dosage metrics; for dot, raw values up to 120 that
    appear only in the first two blocks, so the largest value of the
    stream lies before any resume cursor."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 3, size=(N, V), dtype=np.int8)
    g[rng.random((N, V)) < 0.1] = -1
    if metric == "dot":
        g[:, : 2 * BV] = rng.integers(0, 121, size=(N, 2 * BV),
                                      dtype=np.int8)
    return g


def _dying(base):
    class Dying(base):
        def blocks(self, bv, start_variant=0):
            for i, item in enumerate(super().blocks(bv, start_variant)):
                if i == DIE_AT:
                    raise RuntimeError("simulated preemption")
                yield item

    return Dying


def _jjob(metric, ckpt_dir=None):
    return jconfig.JobConfig(
        ingest=jconfig.IngestConfig(block_variants=BV),
        compute=jconfig.ComputeConfig(metric=metric,
                                      checkpoint_dir=ckpt_dir,
                                      checkpoint_every_blocks=2))


def _tjob(metric, ckpt_dir=None):
    return tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=BV),
        compute=tconfig.ComputeConfig(metric=metric, device="cpu",
                                      checkpoint_dir=ckpt_dir,
                                      checkpoint_every_blocks=2))


def _jax_clean(metric, g):
    run = jrunner.run_gram(_jjob(metric), JArraySource(g), JPhaseTimer())
    return {k: np.asarray(v) for k, v in run.acc.items()}


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".npy")}


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------------------ layout, byte for byte

@pytest.mark.parametrize("metric", ["ibs", "dot", "grm"])
def test_gram_checkpoint_files_equal_jax_byte_for_byte(tmp_path, metric):
    """JAX's own checkpoint of a killed job, then the port's save of the
    same accumulators (read back from JAX's files) at the same cursor."""
    g = _cohort(metric)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.raises(RuntimeError, match="preemption"):
        jrunner.run_gram(_jjob(metric, jdir), _dying(JArraySource)(g),
                         JPhaseTimer())
    want = _manifest(jdir)
    acc = {k: torch.from_numpy(np.load(os.path.join(jdir, f"{k}.npy")))
           for k in want["leaves"]}
    # JAX ran under its auto plan on 8 virtual devices: the port's plan
    # on 8 virtual CPU slots is the same (2, 4) variant plan.
    plan = gram_sharded.plan_for(
        meshes.make_mesh(virtual.virtual_devices(8, "cpu")), N, metric)
    ckpt.save(tdir, acc, want["next_variant"], metric, BV,
              ArraySource(g).sample_ids, stream_stats=want["stream_stats"],
              plan=plan)
    got = _manifest(tdir)
    assert _files(tdir) == _files(jdir)
    assert got["sha256"] == want["sha256"]
    assert (want["mesh_shape"], want["mode"]) == ([2, 4], "variant")
    assert got == want
    if metric == "dot":
        assert got["stream_stats"] == {"max_value": 120}


def test_sketch_state_files_equal_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(5)
    state = {"y": rng.standard_normal((N, 8)).astype(np.float32),
             "qc": rng.standard_normal((N, 8)).astype(np.float32),
             "trace": np.float32(3.5), "nvar": np.float32(7.0),
             "cm": rng.standard_normal(N).astype(np.float32),
             "passno": np.int64(1)}
    extra = {"solver": "corrected", "kind": "pcoa", "rank": 8, "iters": 2,
             "seed": 3}
    ids = [f"S{i:06d}" for i in range(N)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jdir, state, 256, "solver:grm", BV, ids, extra=extra)
    ckpt.save(tdir, {k: torch.from_numpy(np.asarray(v))
                     for k, v in state.items()},
              256, "solver:grm", BV, ids, extra=extra)
    assert _files(tdir) == _files(jdir)
    assert _manifest(tdir) == _manifest(jdir)


# ---------------------------------------------- cross-framework resume, bitwise

@pytest.mark.parametrize("metric", ["ibs", "dot"])
def test_jax_checkpoint_resumes_in_the_port_bitwise(tmp_path, metric,
                                                    monkeypatch):
    g = _cohort(metric)
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="preemption"):
        jrunner.run_gram(_jjob(metric, d), _dying(JArraySource)(g),
                         JPhaseTimer())
    assert _manifest(d)["next_variant"] == DIE_AT * BV
    seen = {}
    guard = runner._check_int32_budget

    def spy(metric_, n_variants, max_value=2):
        seen["max_value"] = max_value
        return guard(metric_, n_variants, max_value)

    monkeypatch.setattr(runner, "_check_int32_budget", spy)
    got = runner.run_gram(_tjob(metric, d), ArraySource(g), PhaseTimer())
    want = _jax_clean(metric, g)
    assert got.acc.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got.acc[k].numpy(), want[k])
    assert got.n_variants == V
    if metric == "dot":
        assert seen["max_value"] == int(g.max()) == 120


@pytest.mark.parametrize("metric", ["ibs", "dot"])
def test_port_checkpoint_resumes_in_jax_bitwise(tmp_path, metric):
    g = _cohort(metric)
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="preemption"):
        runner.run_gram(_tjob(metric, d), _dying(ArraySource)(g),
                        PhaseTimer())
    manifest = _manifest(d)
    assert manifest["next_variant"] == DIE_AT * BV
    assert os.path.isdir(d + ".old")
    if metric == "dot":
        assert manifest["stream_stats"] == {"max_value": 120}
    got = jrunner.run_gram(_jjob(metric, d), JArraySource(g), JPhaseTimer())
    want = _jax_clean(metric, g)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got.acc[k]), want[k])


def test_resume_only_without_a_cadence_saves_nothing(tmp_path):
    """``checkpoint_every_blocks=0`` resumes from what it finds and
    leaves the checkpoint as it was."""
    g = _cohort("ibs")
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="preemption"):
        runner.run_gram(_tjob("ibs", d), _dying(ArraySource)(g),
                        PhaseTimer())
    before = _files(d)
    job = _tjob("ibs", d)
    job.compute.checkpoint_every_blocks = 0
    got = runner.run_gram(job, ArraySource(g), PhaseTimer())
    want = _jax_clean("ibs", g)
    for k in want:
        np.testing.assert_array_equal(got.acc[k].numpy(), want[k])
    assert _files(d) == before


# ------------------------------------------------------------------ integrity

def _two_generations(tmp_path):
    """A checkpoint dir holding .old (cursor 256) and latest (512)."""
    d = str(tmp_path / "ck")
    ids = [f"S{i:06d}" for i in range(N)]
    for cursor in (256, 512):
        acc = {k: torch.full((N, N), cursor, dtype=torch.int32)
               for k in ("cc", "yc", "t1t1", "t2t2")}
        ckpt.save(d, acc, cursor, "ibs", BV, ids)
    return d, ids


def _flip(path):
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0x10
    open(path, "wb").write(bytes(raw))


def test_flipped_byte_falls_back_to_old_and_promotes_it(tmp_path):
    d, ids = _two_generations(tmp_path)
    _flip(os.path.join(d, "yc.npy"))
    before = telemetry.counter_value("checkpoint.fallback")
    with pytest.warns(RuntimeWarning, match="falling back"):
        acc, cursor, _ = ckpt.load(d, "ibs", ids, block_variants=BV)
    assert cursor == 256 and int(acc["cc"][0, 0]) == 256
    assert telemetry.counter_value("checkpoint.fallback") == before + 1
    # The good generation is the latest again; the corrupt one aside.
    assert _manifest(d)["next_variant"] == 256
    assert not os.path.exists(d + ".old")
    assert _manifest(d + ".corrupt")["next_variant"] == 512


def test_both_generations_corrupt_raise(tmp_path):
    d, ids = _two_generations(tmp_path)
    _flip(os.path.join(d, "cc.npy"))
    _flip(os.path.join(d + ".old", "t2t2.npy"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="sha256"):
        ckpt.load(d, "ibs", ids)


def test_armed_tile_write_truncation_is_caught_on_load(tmp_path):
    d, ids = _two_generations(tmp_path)
    acc = {k: torch.zeros((N, N), dtype=torch.int32)
           for k in ("cc", "yc", "t1t1", "t2t2")}
    with faults.armed(["checkpoint.tile_write:truncate:after=2:keep=8"]):
        ckpt.save(d, acc, 768, "ibs", BV, ids)
    assert os.path.getsize(os.path.join(d, "t1t1.npy")) == 8
    with pytest.warns(RuntimeWarning, match="t1t1.npy: sha256 mismatch"):
        _, cursor, _ = ckpt.load(d, "ibs", ids)
    assert cursor == 512
    # Alone, the truncated generation is corrupt beyond repair.
    solo = str(tmp_path / "solo")
    with faults.armed(["checkpoint.tile_write:truncate:keep=8"]):
        ckpt.save(solo, acc, 128, "ibs", BV, ids)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load(solo, "ibs", ids)


def test_armed_tile_read_error_falls_back(tmp_path):
    d, ids = _two_generations(tmp_path)
    with faults.armed(["checkpoint.tile_read:io_error"]):
        with pytest.warns(RuntimeWarning, match="unreadable"):
            _, cursor, _ = ckpt.load(d, "ibs", ids)
    assert cursor == 256


def _edit_manifest(d, **kw):
    path = os.path.join(d, "manifest.json")
    m = _manifest(d)
    m.update(kw)
    with open(path, "w") as f:
        json.dump(m, f)


@pytest.mark.parametrize("case,match", [
    ("block_variants", "--block-variants"),
    ("metric", "metric 'ibs', job wants 'dot'"),
    ("cohort", "different cohort"),
    ("leaves", "accumulator leaves"),
    ("extra", "--sketch-seed"),
    ("processes", "process counts"),
    ("tiles", "resume must keep the tile grid"),
])
def test_incompatible_checkpoints_are_refused(tmp_path, case, match):
    d, ids = _two_generations(tmp_path)
    shutil.rmtree(d + ".old")
    kw = dict(metric="ibs", sample_ids=ids, block_variants=BV)
    if case == "block_variants":
        kw["block_variants"] = 2 * BV
    elif case == "metric":
        kw["metric"] = "dot"
    elif case == "cohort":
        kw["sample_ids"] = ids[::-1]
    elif case == "leaves":
        kw["leaves"] = ["y", "qc"]
    elif case == "extra":
        kw["expect_extra"] = {"seed": 1}
    elif case == "processes":
        _edit_manifest(d, process_count=2)
    else:
        _edit_manifest(d, layout={"cc": "tiles"}, mesh_shape=[2, 4],
                       mode="tile2d")
    with pytest.raises(ValueError, match=match):
        ckpt.load(d, **kw)


def test_no_checkpoint_loads_none(tmp_path):
    assert ckpt.load(str(tmp_path / "none"), "ibs", ["a"]) is None
