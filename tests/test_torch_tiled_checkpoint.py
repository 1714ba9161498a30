"""The tiled checkpoint layout against the JAX package's, on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices, the port on 8
virtual CPU slots, at the same mesh shapes.

- A tile2d plan's N x N leaves are one file per tile,
  ``{leaf}.t{row0}_{col0}.npy``; scalar leaves (grm's ``nvar``) whole.
  The port's files are byte for byte JAX's for the same accumulators,
  its manifest equal in every key, and each package loads the other's
  tiled checkpoint under the same plan.
- Resuming under another mesh or mode is refused with JAX's message; a
  whole-leaf checkpoint resumes under a tile2d plan (re-tiled).
- Killed tile2d jobs resume bitwise: the port's ring job (JAX's
  ``test_ring_run_gram_checkpoint_resumes_bit_identical``), and across
  the packages both ways.
- The ``checkpoint.tile_write`` / ``tile_read`` fault sites fire on
  tiles, and a one-slot plan's manifest records ``[1, 1]`` and
  ``"replicated"``, as JAX's does.
"""

import json
import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import checkpoint as jckpt
from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import meshes as jmeshes
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.parallel import gram_sharded as jgs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import faults, meshes, virtual
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.parallel import gram_sharded as gs
from spark_examples_tpu_torch.pipelines import runner

from conftest import random_genotypes

N, V, BV = 16, 1024, 128
SHAPES = [(2, 4), (4, 2)]


def _plans(shape, mode="tile2d"):
    return (gs.GramPlan(meshes.make_mesh(virtual.virtual_devices(8, "cpu"),
                                         shape), mode),
            jgs.GramPlan(jmeshes.make_mesh(shape=shape), mode))


def _ids(n=N):
    return [f"S{i:06d}" for i in range(n)]


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".npy")}


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _host(v):
    return (v.full("cpu") if isinstance(v, meshes.Tiled) else v).numpy()


def _accumulate(plan, jplan, metric, g):
    acc = gs.init_sharded(plan, g.shape[0], metric)
    jacc = jgs.init_sharded(jplan, g.shape[0], metric)
    update = gs.make_update(plan, metric)
    jupdate = jgs.make_update(jplan, metric)
    for s in range(0, g.shape[1], BV):
        acc = update(acc, torch.from_numpy(g[:, s:s + BV].copy()))
        jacc = jupdate(jacc, g[:, s:s + BV])
    return acc, jacc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["ibs", "grm"])
def test_port_tiled_files_are_jax_s_and_load_both_ways(rng, tmp_path,
                                                       shape, metric):
    g = random_genotypes(rng, N, 512)
    plan, jplan = _plans(shape)
    acc, jacc = _accumulate(plan, jplan, metric, g)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save(tdir, acc, 512, metric, BV, _ids(), plan=plan)
    jckpt.save(jdir, jacc, 512, metric, BV, _ids(), plan=jplan)
    got, want = _manifest(tdir), _manifest(jdir)
    assert sorted(_files(tdir)) == sorted(_files(jdir))
    if metric != "grm":  # grm's f32 tiles agree within tolerance only
        assert _files(tdir) == _files(jdir)
        assert got == want
    else:
        got.pop("sha256"), want.pop("sha256")
        assert got == want
    tiled = [k for k, lay in want["layout"].items() if lay == "tiles"]
    assert tiled and all(f"{k}.t0_0.npy" in _files(tdir) for k in tiled)
    assert want["mesh_shape"] == list(shape) and want["mode"] == "tile2d"
    # Each package loads the other's tiles under the same plan.
    jback, jcursor, _ = jckpt.load(tdir, metric, _ids(), BV, plan=jplan)
    back, cursor, _ = ckpt.load(jdir, metric, _ids(), BV, plan=plan)
    assert cursor == jcursor == 512
    for k in acc:
        if metric == "grm":
            np.testing.assert_allclose(np.asarray(jback[k]), _host(acc[k]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(_host(back[k]), np.asarray(jacc[k]),
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(np.asarray(jback[k]),
                                          _host(acc[k]))
            np.testing.assert_array_equal(_host(back[k]),
                                          np.asarray(jacc[k]))
        assert isinstance(back[k], meshes.Tiled) == (k != "nvar")


@pytest.mark.parametrize("other", [((4, 2), "tile2d"), ((2, 4), "variant"),
                                   (None, None)])
def test_tiled_checkpoint_under_another_grid_is_refused_as_jax(
        rng, tmp_path, other):
    g = random_genotypes(rng, N, 256)
    plan, jplan = _plans((2, 4))
    acc, _ = _accumulate(plan, jplan, "ibs", g)
    d = str(tmp_path / "ck")
    ckpt.save(d, acc, 256, "ibs", BV, _ids(), plan=plan)
    shape, mode = other
    oplan, ojplan = _plans(shape, mode) if shape else (None, None)
    with pytest.raises(ValueError) as ours:
        ckpt.load(d, "ibs", _ids(), BV, plan=oplan)
    with pytest.raises(ValueError) as theirs:
        jckpt.load(d, "ibs", _ids(), BV, plan=ojplan)
    assert str(ours.value) == str(theirs.value)
    assert "resume must keep the tile grid" in str(ours.value)


def test_whole_leaf_checkpoint_resumes_under_tile2d(rng, tmp_path):
    """A variant plan's checkpoint holds whole leaves, which load under
    any plan: under tile2d each is split onto the slots, as JAX places a
    full leaf under its tiled sharding."""
    g = random_genotypes(rng, N, 256)
    vplan, _ = _plans((2, 4), "variant")
    tplan, _ = _plans((2, 4), "tile2d")
    acc = gs.init_sharded(vplan, N, "ibs")
    gs.make_update(vplan, "ibs")(acc, torch.from_numpy(g))
    d = str(tmp_path / "ck")
    ckpt.save(d, acc, 256, "ibs", BV, _ids(), plan=vplan)
    assert set(_manifest(d)["layout"].values()) == {"full"}
    back, _, _ = ckpt.load(d, "ibs", _ids(), BV, plan=tplan)
    for k in acc:
        assert isinstance(back[k], meshes.Tiled)
        np.testing.assert_array_equal(back[k].full("cpu"), acc[k])


def _job(transport, ckpt_dir=None, shape=(2, 4), tmod=tconfig):
    kw = dict(metric="ibs", gram_mode="tile2d", tile2d_transport=transport,
              mesh_shape=shape, checkpoint_dir=ckpt_dir,
              checkpoint_every_blocks=2 if ckpt_dir else 0)
    if tmod is tconfig:
        kw["device"] = "cpu"
    return tmod.JobConfig(ingest=tmod.IngestConfig(block_variants=BV),
                          compute=tmod.ComputeConfig(**kw))


def _dying(base):
    class Dying(base):
        def blocks(self, bv, start_variant=0):
            for b, m in super().blocks(bv, start_variant):
                if m.start >= 5 * BV:
                    raise RuntimeError("simulated preemption")
                yield b, m

    return Dying


def test_ring_run_gram_checkpoint_resumes_bit_identical(rng, tmp_path):
    """JAX's kill/resume row for the ring transport, on the port: a ring
    job killed mid-stream resumes from its tiled checkpoint to the same
    similarity as the uninterrupted ring run, and both equal the gather
    transport bitwise."""
    g = random_genotypes(rng, N, V, missing_rate=0.1)
    d = str(tmp_path / "ck")
    with virtual.virtual_slots(8):
        with pytest.raises(RuntimeError, match="preemption"):
            runner.run_similarity(_job("ring", d),
                                  source=_dying(ArraySource)(g))
        assert "cc.t0_0.npy" in _files(d)
        resumed = runner.run_similarity(_job("ring", d),
                                        source=ArraySource(g))
        ring = runner.run_similarity(_job("ring"), source=ArraySource(g))
        gather = runner.run_similarity(_job("gather"),
                                       source=ArraySource(g))
    np.testing.assert_array_equal(resumed.similarity, ring.similarity)
    np.testing.assert_array_equal(resumed.similarity, gather.similarity)


@pytest.mark.parametrize("killed_by", ["port", "jax"])
def test_killed_tile2d_job_resumes_in_the_other_package(rng, tmp_path,
                                                        killed_by):
    g = random_genotypes(rng, N, V, missing_rate=0.1)
    d = str(tmp_path / "ck")
    with virtual.virtual_slots(8):
        if killed_by == "port":
            with pytest.raises(RuntimeError, match="preemption"):
                runner.run_gram(_job("ring", d), _dying(ArraySource)(g),
                                PhaseTimer())
            out = jrunner.run_similarity(_job("ring", d, tmod=jconfig),
                                         source=JArraySource(g))
        else:
            with pytest.raises(RuntimeError, match="preemption"):
                jrunner.run_gram(_job("gather", d, tmod=jconfig),
                                 _dying(JArraySource)(g),
                                 jrunner.PhaseTimer())
            out = runner.run_similarity(_job("gather", d),
                                        source=ArraySource(g))
        clean = runner.run_similarity(_job("gather"), source=ArraySource(g))
    assert _manifest(d)["layout"]["cc"] == "tiles"
    np.testing.assert_array_equal(out.similarity, clean.similarity)


def test_fault_sites_fire_on_tiles(rng, tmp_path):
    g = random_genotypes(rng, N, 256)
    plan, jplan = _plans((2, 4))
    acc, _ = _accumulate(plan, jplan, "ibs", g)
    d = str(tmp_path / "ck")
    ckpt.save(d, acc, 128, "ibs", BV, _ids(), plan=plan)
    with faults.armed(["checkpoint.tile_write:truncate:after=5:max=1:"
                       "keep=8"]):
        ckpt.save(d, acc, 256, "ibs", BV, _ids(), plan=plan)
    sizes = [os.path.getsize(os.path.join(d, f)) for f in _files(d)]
    assert sorted(sizes)[0] == 8 and len(sizes) == 4 * 8
    with pytest.warns(RuntimeWarning, match="sha256 mismatch"):
        _, cursor, _ = ckpt.load(d, "ibs", _ids(), BV, plan=plan)
    assert cursor == 128
    with faults.armed(["checkpoint.tile_read:io_error:max=1"]):
        with pytest.raises(ckpt.CheckpointCorruptError, match="unreadable"):
            ckpt.load(d, "ibs", _ids(), BV, plan=plan)


def test_one_slot_manifest_records_the_replicated_plan(rng, tmp_path):
    """As the JAX runner always passes its plan, a one-device job's
    manifest records ``[1, 1]`` and ``"replicated"``, whole leaves."""
    g = random_genotypes(rng, N, 512)
    d = str(tmp_path / "ck")
    job = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=BV),
        compute=tconfig.ComputeConfig(metric="ibs", device="cpu",
                                      checkpoint_dir=d,
                                      checkpoint_every_blocks=2))
    runner.run_gram(job, ArraySource(g), PhaseTimer())
    m = _manifest(d)
    assert (m["mesh_shape"], m["mode"]) == ([1, 1], "replicated")
    assert set(m["layout"].values()) == {"full"}
