"""The port's device mesh and sharded gram accumulation against the JAX
package's, on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices; the port on 8
virtual CPU slots (``core/virtual.py``), at the same ``(2, 4)`` and
``(4, 2)`` mesh shapes and on the same seeded numpy inputs. JAX runs its
``reference`` lowering (its ``fused`` Pallas body in interpret mode in
one small case); the port's ``fused`` lowering runs K1's plain version
on CPU tensors.

- Layouts, ring permutation, plans, transports and every error message.
- int32 accumulators bitwise JAX's for the count family under variant
  and tile2d (gather and ring, packed and dense, both lowerings); ring
  bitwise the gather; grm within the tolerance of
  ``tests/test_parallel.py`` (rtol 1e-5, atol 1e-5; 1e-4 on ``zz``
  between transports, where the f32 tile sums come in another order).
- The tiled finalize bitwise JAX's finalize for every gram metric.
- ``gram.fused_blocks`` and ``gram.ring_steps`` as JAX counts them.
"""

import jax
import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import meshes as jmeshes
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.ops import distances as jdistances
from spark_examples_tpu.parallel import gram_sharded as jgs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import meshes, telemetry, virtual
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.ops import packed_gram
from spark_examples_tpu_torch.parallel import gram_sharded as gs
from spark_examples_tpu_torch.parallel import pcoa_sharded as ps
from spark_examples_tpu_torch.pipelines import runner

from conftest import random_genotypes

SHAPES = [(2, 4), (4, 2)]


def _mesh(shape=(2, 4)):
    return meshes.make_mesh(virtual.virtual_devices(8, "cpu"), shape)


def _jmesh(shape=(2, 4)):
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jmeshes.make_mesh(shape=shape)


def _host(v):
    return (v.full("cpu") if isinstance(v, meshes.Tiled) else v).numpy()


def _stream(plan, jplan, metric, g, block, packed=False, transport="gather",
            lowering="reference", jlowering="reference"):
    """The same blocks through both packages' updates: (port acc, JAX
    acc) as numpy."""
    acc = gs.init_sharded(plan, g.shape[0], metric)
    update = gs.make_update(plan, metric, packed=packed,
                            transport=transport, lowering=lowering)
    jacc = jgs.init_sharded(jplan, g.shape[0], metric)
    jupdate = jgs.make_update(jplan, metric, packed=packed,
                              transport=transport, lowering=jlowering)
    for s in range(0, g.shape[1], block):
        blk = g[:, s:s + block]
        if packed:
            blk = bitpack.pack_dosages(blk)
        acc = update(acc, torch.from_numpy(np.ascontiguousarray(blk)))
        jacc = jupdate(jacc, blk)
    return ({k: _host(v) for k, v in acc.items()},
            {k: np.asarray(v) for k, v in jacc.items()})


# ------------------------------------------------------------- the mesh

def test_mesh_autofactor_and_shape_check_match_jax():
    mesh = _mesh(None)
    assert mesh.shape == _jmesh(None).devices.shape == (2, 4)
    assert mesh.axis_names == _jmesh(None).axis_names == ("i", "j")
    with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) != device "
                       r"count 8"):
        meshes.make_mesh(virtual.virtual_devices(8, "cpu"), (3, 3))
    with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) != device "
                       r"count 8"):
        jmeshes.make_mesh(shape=(3, 3))
    one = meshes.make_mesh([torch.device("cpu")])
    assert one.shape == (1, 1) and not one.virtual


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_perm_and_layouts_match_jax_shardings(shape):
    mesh, jmesh = _mesh(shape), _jmesh(shape)
    assert meshes.ring_perm(mesh) == jmeshes.ring_perm(jmesh)
    n, w = 16, 64
    jdevs = list(jmesh.devices.flat)

    def jmap(sharding, shp):
        idx = sharding.devices_indices_map(shp)
        return [idx[d] for d in jdevs]

    tiles = [(r, c) for r, c in meshes.tile2d(mesh, n)]
    want = jmap(jmeshes.tile2d(jmesh), (n, n))
    for (r, c), (jr, jc) in zip(tiles, want):
        assert (r.start, r.stop, c.start, c.stop) == (
            jr.start, jr.stop, jc.start, jc.stop)
    for ours, theirs in ((meshes.rows_i(mesh, n), jmeshes.rows_i(jmesh)),
                         (meshes.rows_j(mesh, n), jmeshes.rows_j(jmesh))):
        for sl, (jr, _) in zip(ours, jmap(theirs, (n, w))):
            assert (sl.start, sl.stop) == (jr.start, jr.stop)
    for sl, (_, jc) in zip(meshes.variants_flat(mesh, w),
                           jmap(jmeshes.variants_flat(jmesh), (n, w))):
        assert (sl.start, sl.stop) == (jc.start, jc.stop)
    assert all(sl == slice(None) for sl in meshes.replicated(mesh))


def test_virtual_slots_are_scoped_and_say_so():
    cpu = torch.device("cpu")
    assert meshes.default_devices(cpu) == [cpu]
    with virtual.virtual_slots(4):
        assert meshes.default_devices(cpu) == [cpu] * 4
        with virtual.virtual_slots(2):
            assert len(meshes.default_devices(cpu)) == 2
        mesh = meshes.make_mesh(meshes.default_devices(cpu))
        assert mesh.virtual and mesh.shape == (2, 2)
        assert "4 virtual slots on 1 physical device" in mesh.describe()
        assert "not scaling" in mesh.describe()
    assert meshes.default_devices(cpu) == [cpu]
    with virtual.virtual_slots(2, "cuda:0"), \
            pytest.raises(ValueError, match="give the slots the job's"):
        meshes.default_devices(cpu)
    with pytest.raises(ValueError, match="count >= 1"):
        virtual.virtual_devices(0, "cpu")


def test_tiles_never_alias_on_virtual_slots(rng):
    """Virtual slots share one device, never a tensor: an update of one
    tile leaves the others alone, and the update never writes the block
    it was given (the gather's copies are read only)."""
    plan = gs.GramPlan(_mesh(), "tile2d")
    acc = gs.init_sharded(plan, 16, "ibs")
    ptrs = {t.data_ptr() for v in acc.values() for t in v.tiles}
    assert len(ptrs) == 4 * 8
    acc["cc"].tiles[0].add_(1)
    assert all(int(t.abs().sum()) == 0 for t in acc["cc"].tiles[1:])
    g = random_genotypes(rng, 16, 64)
    blk = torch.from_numpy(bitpack.pack_dosages(g))
    before = blk.clone()
    for transport in ("gather", "ring"):
        gs.make_update(plan, "ibs", packed=True, transport=transport)(
            acc, blk)
        assert torch.equal(blk, before)


# ---------------------------------------------------------------- plans

def test_plan_auto_selection_matches_jax():
    mesh, jmesh = _mesh(), _jmesh()
    for n, metric in ((100, "ibs"), (80_000, "ibs"), (30_000, "grm"),
                      (60_000, "grm")):
        assert (gs.plan_for(mesh, n, metric).mode
                == jgs.plan_for(jmesh, n, metric).mode), (n, metric)
    assert gs.plan_for(mesh, 100, "ibs").mode == "variant"
    assert gs.plan_for(mesh, 80_000, "ibs").mode == "tile2d"
    one = meshes.make_mesh([torch.device("cpu")])
    assert gs.plan_for(one, 100, "ibs").mode == "replicated"
    assert gs.GramPlan(mesh, "tile2d").block_shards == 8
    assert gs.GramPlan(one, "replicated").block_shards == 1


@pytest.mark.parametrize("n", [10, 7])
def test_tile_divisibility_error_is_jax_s(n):
    with pytest.raises(ValueError) as ours:
        gs.plan_for(_mesh(), n, "ibs", "tile2d")
    with pytest.raises(ValueError) as theirs:
        jgs.plan_for(_jmesh(), n, "ibs", "tile2d")
    assert str(ours.value) == str(theirs.value)
    assert "--mesh-shape" in str(ours.value)
    with pytest.raises(ValueError, match="phantom sample"):
        gs.init_sharded(gs.GramPlan(_mesh(), "tile2d"), n, "ibs")
    with pytest.raises(ValueError, match="unknown gram mode"):
        gs.plan_for(_mesh(), 8, "ibs", "diagonal")


def test_transport_auto_resolution_matches_jax():
    """Where the JAX package's ``auto`` picks gather, so does the
    port's; where JAX's v5e rule picks ring, the port's ``auto`` stays
    gather (a difference by design: the ring lost to the gather on H100
    cards, and no crossover is measured). A forced transport passes
    through, and plans that are not tiled have none."""
    distinct = meshes.make_mesh([torch.device("cpu", k) for k in range(8)],
                                (2, 4))
    jplan = jgs.GramPlan(_jmesh(), "tile2d")
    theirs = {args: jgs.resolve_transport(jplan, *args) for args in (
        ("ibs", 76_000, 4096, True), ("ibs", 32, 64, False),
        ("grm", 2504, 8192, True), ("shared-alt", 2504, 8192, True))}
    assert theirs[("ibs", 32, 64, False)] == "gather"
    assert theirs[("ibs", 76_000, 4096, True)] == "ring"
    for mesh in (distinct, _mesh()):
        plan = gs.GramPlan(mesh, "tile2d")
        assert gs.resolve_transport(plan, "auto") == "gather"
        for forced in ("gather", "ring"):
            assert gs.resolve_transport(plan, forced) == forced
    for mode in ("variant", "replicated"):
        plan = gs.GramPlan(_mesh(), mode)
        assert gs.resolve_transport(plan, "ring") == "gather"
        assert jgs.resolve_transport(jgs.GramPlan(_jmesh(), mode), "ibs",
                                     76_000, 4096, True) == "gather"


def test_ring_divisibility_validated_with_flags_named():
    plan, jplan = gs.GramPlan(_mesh(), "tile2d"), jgs.GramPlan(_jmesh(),
                                                               "tile2d")
    for width, packed in ((60, False), (7, True)):
        with pytest.raises(ValueError) as ours:
            gs.check_ring_divisible(width, plan, packed)
        with pytest.raises(ValueError) as theirs:
            jgs.check_ring_divisible(width, jplan, packed)
        assert str(ours.value) == str(theirs.value)
        assert "--tile2d-transport ring" in str(ours.value)
        assert "--block-variants" in str(ours.value)
    gs.check_ring_divisible(64, plan, packed=False)
    with pytest.raises(ValueError, match=r"--tile2d-transport"):
        tconfig.ComputeConfig(tile2d_transport="mesh")
    with pytest.raises(ValueError, match=r"--mesh-shape"):
        tconfig.ComputeConfig(mesh_shape=(2, 0))
    assert tconfig.ComputeConfig(mesh_shape=[2, 4]).mesh_shape == (2, 4)


def test_make_update_validates_like_jax():
    """make_update takes the RESOLVED lowering, and a fused request on a
    dense stream names --pack-stream, as JAX's does; an unknown layout
    or transport, or replicated blocks under a variant plan, are refused
    with JAX's words."""
    plan = gs.GramPlan(_mesh(), "tile2d")
    for kw, match in ((dict(packed=True, lowering="auto"),
                       "unresolved gram lowering"),
                      (dict(packed=False, lowering="fused"),
                       "pack.stream"),
                      (dict(transport="mesh"), "unknown tile2d transport"),
                      (dict(block_layout="diagonal"),
                       "unknown block_layout")):
        with pytest.raises(ValueError, match=match):
            gs.make_update(plan, "ibs", **kw)
        with pytest.raises(ValueError, match=match):
            jgs.make_update(jgs.GramPlan(_jmesh(), "tile2d"), "ibs", **kw)
    vplan = gs.GramPlan(_mesh(), "variant")
    with pytest.raises(ValueError, match="redundantly"):
        gs.make_update(vplan, "ibs", block_layout="replicated")


def test_variant_mode_runs_fused_where_jax_refuses(rng):
    """A difference by design: the JAX package refuses ``fused`` on a
    multi-device variant plan (XLA cannot split one pallas_call across
    chips); the port's SPMD is explicit, so each slot runs K1 on its own
    shard. Its accumulators are bitwise JAX's reference ones."""
    jplan = jgs.GramPlan(_jmesh(), "variant")
    with pytest.raises(ValueError, match="cannot split a pallas_call"):
        jgs.make_update(jplan, "ibs", packed=True, lowering="fused")
    g = random_genotypes(rng, 24, 320)
    ours, theirs = _stream(gs.GramPlan(_mesh(), "variant"), jplan, "ibs", g,
                           160, packed=True, lowering="fused")
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# ---------------------------------------------------------- accumulators

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["variant", "tile2d", "replicated"])
@pytest.mark.parametrize("metric", ["ibs", "shared-alt", "grm"])
def test_sharded_modes_match_jax(rng, shape, mode, metric):
    g = random_genotypes(rng, 32, 512, missing_rate=0.12)
    ours, theirs = _stream(gs.GramPlan(_mesh(shape), mode),
                           jgs.GramPlan(_jmesh(shape), mode), metric, g, 64)
    for k in theirs:
        if metric == "grm":
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# The fused lowering decodes the 2-bit packed stream (count family only).
RING_CASES = [(metric, packed, lowering)
              for metric in ("ibs", "ibs2", "king", "jaccard", "grm")
              for packed, lowering in ((False, "reference"),
                                       (True, "reference"), (True, "fused"))
              if not (metric == "grm" and lowering == "fused")]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric,packed,lowering", RING_CASES)
def test_ring_matches_gather_and_jax(rng, shape, metric, packed, lowering):
    """The ring transport's accumulators are bitwise the gather's for
    every int32 kernel (allclose for grm's f32), and both are JAX's
    gather transport (reference lowering), over a ragged final block
    that pads to the shard grid."""
    g = random_genotypes(rng, 32, 288, missing_rate=0.12)
    plan, jplan = gs.GramPlan(_mesh(shape), "tile2d"), jgs.GramPlan(
        _jmesh(shape), "tile2d")
    accs = {}
    for t in ("gather", "ring"):
        accs[t], want = _stream(plan, jplan, metric, g, 96, packed=packed,
                                transport=t, lowering=lowering)
    for k in want:
        for t in ("gather", "ring"):
            if metric == "grm" and k == "zz":
                np.testing.assert_allclose(accs[t][k], want[k], rtol=1e-5,
                                           atol=1e-4, err_msg=f"{t}/{k}")
            else:
                np.testing.assert_array_equal(accs[t][k], want[k],
                                              err_msg=f"{t}/{k}")
        if metric != "grm":
            np.testing.assert_array_equal(accs["ring"][k],
                                          accs["gather"][k])


def test_ring_hops_follow_ring_perm(rng, monkeypatch):
    """The ring takes its hops from ``meshes.ring_perm``: the update asks
    it for the mesh's schedule, and a schedule rotating the other way
    still hands every slot every shard once (bitwise the gather)."""
    asked = []
    forward = meshes.ring_perm

    def backward(mesh):
        asked.append(mesh.shape)
        return tuple((dst, src) for src, dst in forward(mesh))

    g = random_genotypes(rng, 16, 256, missing_rate=0.1)
    plan = gs.GramPlan(_mesh(), "tile2d")
    want, _ = _stream(plan, jgs.GramPlan(_jmesh(), "tile2d"), "ibs", g,
                      128, transport="gather")
    monkeypatch.setattr(meshes, "ring_perm", backward)
    acc = gs.init_sharded(plan, 16, "ibs")
    update = gs.make_update(plan, "ibs", transport="ring")
    assert asked == [(2, 4)]
    for s in range(0, 256, 128):
        acc = update(acc, torch.from_numpy(np.ascontiguousarray(
            g[:, s:s + 128])))
    for k in want:
        np.testing.assert_array_equal(_host(acc[k]), want[k], err_msg=k)


def test_fused_ring_matches_jax_interpret_and_counts_as_jax(rng):
    """One small case against JAX's fused Pallas body (interpret mode):
    ibs, packed, tile2d ring on (2, 4). The accumulators are bitwise;
    ``gram.fused_blocks`` grows by one a block in both packages (not by
    the port's 8 x 8 = 64 tile launches a block) and ``gram.ring_steps``
    by 8 a block. On CPU tensors the port runs K1's plain version, so
    K1 itself is never launched."""
    g = random_genotypes(rng, 16, 128, missing_rate=0.1)
    before = {n: (telemetry.counter_value(n), jtelemetry.counter_value(n))
              for n in ("gram.fused_blocks", "gram.ring_steps")}
    launches = packed_gram.launches
    ours, theirs = _stream(gs.GramPlan(_mesh(), "tile2d"),
                           jgs.GramPlan(_jmesh(), "tile2d"), "ibs", g, 64,
                           packed=True, transport="ring", lowering="fused",
                           jlowering="fused")
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    for name, want in (("gram.fused_blocks", 2), ("gram.ring_steps", 16)):
        ours_d = telemetry.counter_value(name) - before[name][0]
        theirs_d = jtelemetry.counter_value(name) - before[name][1]
        assert ours_d == theirs_d == want, name
    assert packed_gram.launches == launches


@pytest.mark.parametrize("metric", ["ibs", "grm"])
def test_replicated_block_layout_matches_jax(rng, metric):
    g = random_genotypes(rng, 32, 256, missing_rate=0.1)
    plan, jplan = gs.GramPlan(_mesh(), "tile2d"), jgs.GramPlan(_jmesh(),
                                                               "tile2d")
    acc = gs.init_sharded(plan, 32, metric)
    jacc = jgs.init_sharded(jplan, 32, metric)
    update = gs.make_update(plan, metric, block_layout="replicated")
    jupdate = jgs.make_update(jplan, metric, block_layout="replicated")
    for s in range(0, 256, 64):
        acc = update(acc, torch.from_numpy(g[:, s:s + 64].copy()))
        jacc = jupdate(jacc, g[:, s:s + 64])
    for k in acc:
        np.testing.assert_allclose(_host(acc[k]), np.asarray(jacc[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# -------------------------------------------------------------- finalize

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", kernels.gram_names())
def test_tiled_finalize_is_jax_s_finalize(rng, shape, metric):
    """Every gram kernel's finalize, tile by tile (transposes from the
    mirrored tiles, KING's pinned diagonal, the Gower diagonal), against
    JAX's finalize of the same accumulators: bitwise for the int32
    family, and within 1e-5 for grm (rsqrt differs by up to 2 ulp)."""
    g = random_genotypes(rng, 24, 192, missing_rate=0.1)
    if metric in ("euclidean", "dot"):
        g = np.where(g >= 0, rng.integers(0, 120, g.shape), -1).astype(
            np.int8)
    plan, jplan = gs.GramPlan(_mesh(shape), "tile2d"), jgs.GramPlan(
        _jmesh(shape), "tile2d")
    acc = gs.init_sharded(plan, 24, metric)
    update = gs.make_update(plan, metric)
    jacc = jgs.init_sharded(jplan, 24, metric)
    jupdate = jgs.make_update(jplan, metric)
    for s in range(0, 192, 64):
        acc = update(acc, torch.from_numpy(g[:, s:s + 64].copy()))
        jacc = jupdate(jacc, g[:, s:s + 64])
    want = jdistances.finalize(jacc, metric)
    fields = ("similarity", "distance")
    tiles = ps.finalize_tiles(plan, acc, metric, fields)
    assert set(tiles) == set(fields)
    for field in fields:
        got = tiles[field]
        ps.assert_tiled(got, plan, field)
        if metric == "grm":
            np.testing.assert_allclose(_host(got), np.asarray(want[field]),
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(_host(got),
                                          np.asarray(want[field]))


# ----------------------------------------------------- the job and the CLI

def _jobs(mode, transport="auto", shape=None, metric="ibs", ckpt=None):
    kw = dict(metric=metric, gram_mode=mode, tile2d_transport=transport,
              mesh_shape=shape, checkpoint_dir=ckpt,
              checkpoint_every_blocks=2 if ckpt else 0)
    return (tconfig.JobConfig(
                ingest=tconfig.IngestConfig(block_variants=128),
                compute=tconfig.ComputeConfig(device="cpu", **kw)),
            jconfig.JobConfig(
                ingest=jconfig.IngestConfig(block_variants=128),
                compute=jconfig.ComputeConfig(**kw)))


@pytest.mark.parametrize("mode,transport", [("variant", "auto"),
                                            ("tile2d", "gather"),
                                            ("tile2d", "ring")])
def test_similarity_job_and_counters_match_jax(rng, mode, transport):
    """``run_similarity`` under each plan: the port's similarity bitwise
    JAX's, and ``gram.ring_steps`` grown as JAX's grows."""
    g = random_genotypes(rng, 16, 1000, missing_rate=0.1)
    tjob, jjob = _jobs(mode, transport, shape=(4, 2))
    before = (telemetry.counter_value("gram.ring_steps"),
              jtelemetry.counter_value("gram.ring_steps"))
    with virtual.virtual_slots(8):
        ours = runner.run_similarity(tjob, source=ArraySource(g))
    theirs = jrunner.run_similarity(jjob, source=JArraySource(g))
    np.testing.assert_array_equal(ours.similarity, theirs.similarity)
    np.testing.assert_array_equal(ours.distance, theirs.distance)
    steps = (telemetry.counter_value("gram.ring_steps") - before[0],
             jtelemetry.counter_value("gram.ring_steps") - before[1])
    assert steps[0] == steps[1] == (8 * 8 if transport == "ring" else 0)


def test_cli_tile2d_similarity_equals_jax_cli(tmp_path, capsys):
    """``similarity --gram-mode tile2d --mesh-shape 4x2`` through both
    CLIs (the port's on ``--virtual-devices 8``): the same .npy bytes of
    values, and the port says its mesh is virtual."""
    from spark_examples_tpu.cli.main import main as jmain

    args = ["similarity", "--n-samples", "24", "--n-variants", "700",
            "--block-variants", "128", "--gram-mode", "tile2d",
            "--mesh-shape", "4x2", "--tile2d-transport", "ring"]
    tout, jout = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
    assert tmain(args + ["--device", "cpu", "--virtual-devices", "8",
                         "--output-path", tout]) == 0
    assert "mesh: 4x2 mesh of 8 virtual slots" in capsys.readouterr().err
    assert jmain(args + ["--output-path", jout]) == 0
    np.testing.assert_array_equal(np.load(tout), np.load(jout))
    with pytest.raises(SystemExit):
        tmain(args + ["--device", "cpu", "--mesh-shape", "4"])
    assert "expected IxJ" in capsys.readouterr().err


def test_one_slot_keeps_the_replicated_route(rng):
    """No mesh flag on one device: the plan is replicated, the
    accumulators whole tensors on that device, as before the mesh."""
    g = random_genotypes(rng, 12, 300)
    tjob, _ = _jobs("auto")
    grun = runner.run_gram(tjob, ArraySource(g), runner.PhaseTimer())
    assert grun.plan.mode == "replicated" and grun.plan.mesh.size == 1
    assert all(isinstance(v, torch.Tensor) for v in grun.acc.values())
