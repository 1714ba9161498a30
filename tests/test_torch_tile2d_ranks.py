"""tile2d across the ranks of a job of two port processes (gloo on
localhost, ``--device cpu``), against the JAX package's single-process
runs and the port's one-process tiled runs, computed in this test
process.

Each rank has two virtual slots on a (2, 2) mesh (rank 0 holds tiles
(0, 0) and (0, 1), rank 1 tiles (1, 0) and (1, 1)), or one slot on a
(1, 2) mesh, where every mirrored block spans both ranks. The cohort is
the JAX package's two-process one (24 samples, 1280 variants, blocks of
256: rank windows 768 + 512, so rank 1 feeds one all-MISSING slab).

- int32 tiles bitwise JAX's whole accumulators under gather and ring,
  for ibs and shared-alt; grm within 1e-5 of max|zz|;
- finalized tiles bitwise the port's one-process 2 x 2 tiled finalize;
- ``pcoa_job``, ``variants_pca_job`` and the streaming refresh against
  JAX's single-process tile2d runs (JAX's probes patched in: the
  tolerance of JAX's ``test_two_process_pcoa_job_end_to_end``) and the
  port's one-process tiled runs;
- the multi-process tiled checkpoint: per-rank tile files, sidecars
  merged and removed, killed and resumed bitwise, a corrupt tile on rank
  1 only taking both ranks to ``.old``, a missing sidecar aborting both;
- the refusals: a sample count the global mesh cannot tile, and the
  routes that need the whole matrix (``similarity``, ``--eigh-mode
  dense``), refused on every rank before the stream.

Every rank reports the JAX modules it loaded: none
(``torch_ranks.run_ranks``).
"""

import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.core.config import (
    ComputeConfig as JCompute,
    IngestConfig as JIngest,
    JobConfig as JJob,
)
from spark_examples_tpu.core.profiling import PhaseTimer as JTimer
from spark_examples_tpu.ingest.synthetic import SyntheticSource as JSynth
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu.pipelines import streaming as jstreaming
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import virtual
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.parallel import pcoa_sharded as ps
from spark_examples_tpu_torch.pipelines import jobs, runner, streaming

from torch_ranks import run_ranks

N, V, BV, K = 24, 1280, 256, 3
MESHES = {"2x2": ((2, 2), 2), "1x2": ((1, 2), 1)}
# JAX's tolerance for two-process coordinates against one process
# (tests/test_distributed.py::test_two_process_pcoa_job_end_to_end).
COORD_TOL = 1e-3
# The port's ranks are held bitwise to its one-process tiled run: the
# same tiles, the B @ Q blocks added in slot order, the subspace on rank
# 0 alone, Q row-major in every product on every rank.

_PRELUDE = r"""
import json, os
import numpy as np
import torch
from spark_examples_tpu_torch.core import checkpoint as ckpt, meshes, virtual
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.core.meshes import Tiled
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.parallel import multihost as mh
from spark_examples_tpu_torch.parallel import pcoa_sharded as ps
from spark_examples_tpu_torch.pipelines import jobs, runner, streaming

ing = IngestConfig(source="synthetic", n_samples=24, n_variants=1280,
                   block_variants=256, seed=5)
JAX_PROBES = np.load(os.environ["PROBES"])


def _probes(n, p, device="cpu"):
    assert n == JAX_PROBES.shape[0], (n, p)
    return torch.from_numpy(JAX_PROBES).to(device)


ps.default_probes = _probes
streaming.probes = _probes


def job(shape, **kw):
    kw.setdefault("gram_mode", "tile2d")
    return JobConfig(ingest=ing, compute=ComputeConfig(
        device="cpu", mesh_shape=shape, **kw))


def tiles(acc):
    return {k: ({str(s): t.tolist() for s, t in v.local()}
                if isinstance(v, Tiled) else v.tolist())
            for k, v in acc.items()}
"""

_TILES = _PRELUDE + r"""
out = {"acc": {}, "final": {}}
for label, shape, slots in (("2x2", (2, 2), 2), ("1x2", (1, 2), 1)):
    with virtual.virtual_slots(slots):
        for transport in ("gather", "ring"):
            for metric in ("ibs", "shared-alt", "grm"):
                g = runner.run_gram(
                    job(shape, metric=metric, tile2d_transport=transport),
                    runner.build_source(ing, "cpu"), PhaseTimer())
                for v in g.acc.values():
                    if isinstance(v, Tiled):
                        ps.assert_tiled(v, g.plan, "accumulator")
                out["acc"][f"{label}-{transport}-{metric}"] = {
                    "acc": tiles(g.acc), "n_variants": g.n_variants,
                    "mode": g.plan.mode, "mesh": list(g.plan.mesh.shape),
                    "local": list(g.plan.mesh.local_slots),
                    "phases": sorted(g.timer.phases)}
                if transport == "gather":
                    out["final"][f"{label}-{metric}"] = tiles(ps.finalize_tiles(
                        g.plan, g.acc, metric, ("distance", "similarity")))
with virtual.virtual_slots(2):
    pcoa = jobs.pcoa_job(job((2, 2), metric="ibs", eigh_mode="randomized",
                             num_pc=3))
    pca = jobs.variants_pca_job(job((2, 2), num_pc=3))
    snap_out, snaps = streaming.incremental_pcoa_job(
        job((2, 2), metric="ibs", num_pc=3, stream_refresh_blocks=2))
    refused = {}
    for name, fn in (
            ("similarity", lambda: jobs.similarity_matrix_job(
                job((2, 2), metric="ibs"))),
            ("dense", lambda: jobs.pcoa_job(job((2, 2), metric="ibs",
                                                eigh_mode="dense"))),
            ("indivisible", lambda: runner.plan_for_job(
                job((2, 2), metric="ibs"), type("S", (), {"n_samples": 25})()))):
        try:
            fn()
            refused[name] = "ran"
        except ValueError as e:
            refused[name] = str(e)
    # Failures in the sharded solve: inside a product on rank 1 alone (its
    # tiles cannot multiply Q), then on rank 0 between products.
    from spark_examples_tpu_torch.ops.eigh import randomized_eigh

    mesh = meshes.job_mesh("cpu", (2, 2))
    b = Tiled.zeros(mesh, (24, 24), torch.float32)
    if mesh.rank == 1:
        b = Tiled(mesh, b.shape, [None if t is None else t[:, :5]
                                  for t in b.tiles])
    q = torch.ones((24, 4))

    def rank0_fails(op):
        op(q)
        raise ArithmeticError("a solve step failed")

    solve_failed = {}
    for name, bb, fn in (
            ("product", b, lambda op: randomized_eigh(op, 2, probes=q)),
            ("rank0", Tiled.zeros(mesh, (24, 24), torch.float32),
             lambda op: rank0_fails(op) if mesh.rank == 0 else None)):
        try:
            ps.solve_on_rank0(bb, fn)
            solve_failed[name] = "ran"
        except Exception as e:
            solve_failed[name] = f"{type(e).__name__}: {e}"
import torch.distributed as dist

# The exit hook, called early: it tears the group down (a no-op at exit).
meshes._leave()
emit(**out, pcoa=pcoa.coords.tolist(), pcoa_vals=pcoa.eigenvalues.tolist(),
     pca=pca.coords.tolist(), stream=snap_out.coords.tolist(),
     snapshots=[[s.n_variants, np.asarray(s.coords).tolist()] for s in snaps],
     stream_variants=snap_out.n_variants, refused=refused,
     solve_failed=solve_failed,
     left=[meshes.distributed() is None, dist.is_initialized()])
"""


def _jax_probes():
    import jax

    from spark_examples_tpu.ops import eigh as jeigh

    return np.asarray(jeigh.init_probes(jax.random.key(0), N, K + 32))


@pytest.fixture(scope="module")
def probes_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("probes") / "probes.npy"
    np.save(path, _jax_probes())
    return str(path)


@pytest.fixture(scope="module")
def tile_ranks(probes_file):
    return run_ranks(_TILES, extra_env={"PROBES": probes_file})


def _jjob(**kw):
    return JJob(ingest=JIngest(source="synthetic", n_samples=N,
                               n_variants=V, block_variants=BV, seed=5),
                compute=JCompute(**kw))


def _jax_acc(metric):
    g = jrunner.run_gram(_jjob(metric=metric),
                         JSynth(n_samples=N, n_variants=V, seed=5), JTimer())
    return {k: np.asarray(v) for k, v in g.acc.items()}


def _spans(shape, s):
    tn, tm = N // shape[0], N // shape[1]
    i, j = divmod(s, shape[1])
    return slice(i * tn, (i + 1) * tn), slice(j * tm, (j + 1) * tm)


def _tjob(shape=(2, 2), **kw):
    kw.setdefault("gram_mode", "tile2d")
    return JobConfig(ingest=IngestConfig(source="synthetic", n_samples=N,
                                         n_variants=V, block_variants=BV,
                                         seed=5),
                     compute=ComputeConfig(device="cpu", mesh_shape=shape,
                                           **kw))


@pytest.mark.parametrize("metric", ["ibs", "shared-alt", "grm"])
@pytest.mark.parametrize("transport", ["gather", "ring"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tiles_across_ranks_are_jax_s_accumulators(tile_ranks, mesh,
                                                   transport, metric):
    """Each rank holds its own slots' tiles of the global sums: int32
    bitwise JAX's single-process accumulators, grm within its pinned
    1e-5 of max|zz| (its per-chunk f32 products sum in another order),
    its kept-variant count exact on every rank."""
    shape, slots = MESHES[mesh]
    want = _jax_acc(metric)
    held = set()
    for o in tile_ranks:
        got = o["acc"][f"{mesh}-{transport}-{metric}"]
        assert got["mode"] == "tile2d" and got["mesh"] == list(shape)
        assert got["n_variants"] == V
        # Rank-major slots, and no allreduce phase: nothing summed.
        assert got["local"] == [o["process"] * slots + l
                                for l in range(slots)]
        assert "allreduce" not in got["phases"]
        for k, v in want.items():
            if v.ndim == 0:
                assert float(got["acc"][k]) == float(v), k
                continue
            assert sorted(got["acc"][k]) == [str(s) for s in got["local"]]
            for s, tile in got["acc"][k].items():
                held.add(int(s))
                rows, cols = _spans(shape, int(s))
                if metric == "grm":
                    err = np.max(np.abs(np.asarray(tile) - v[rows, cols]))
                    assert err <= 1e-5 * np.max(np.abs(v)), (k, s, err)
                else:
                    np.testing.assert_array_equal(np.asarray(tile),
                                                  v[rows, cols], f"{k} {s}")
    assert held == set(range(shape[0] * shape[1]))


@pytest.mark.parametrize("metric", ["ibs", "shared-alt", "grm"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_finalized_tiles_are_the_one_process_tiled_run_s(tile_ranks, mesh,
                                                        metric):
    """The finalize across ranks (mirrored blocks point to point, the
    similarity's diagonal from the ranks that hold it) is bitwise the
    port's one-process tiled finalize on the same mesh shape."""
    shape, _slots = MESHES[mesh]
    with virtual.virtual_slots(shape[0] * shape[1]):
        g = runner.run_gram(_tjob(shape, metric=metric),
                            SyntheticSource(n_samples=N, n_variants=V,
                                            seed=5), PhaseTimer())
        want = ps.finalize_tiles(g.plan, g.acc, metric,
                                 ("distance", "similarity"))
    for o in tile_ranks:
        got = o["final"][f"{mesh}-{metric}"]
        for field in ("distance", "similarity"):
            for s, tile in got[field].items():
                if metric == "grm":
                    # Its accumulators differ from the one-process run's
                    # by f32 summation order (above).
                    np.testing.assert_allclose(
                        np.asarray(tile), want[field].tiles[int(s)].numpy(),
                        rtol=1e-4, atol=1e-4)
                else:
                    np.testing.assert_array_equal(
                        np.asarray(tile, np.float32),
                        want[field].tiles[int(s)].numpy(), f"{field} {s}")


def _patch_probes(monkeypatch):
    probes = torch.from_numpy(_jax_probes().copy())
    monkeypatch.setattr(ps, "default_probes", lambda n, p: probes)
    monkeypatch.setattr(streaming, "probes",
                        lambda n, p, device: probes.to(device))


def _close(got, want, tol):
    got, want = np.abs(np.asarray(got)), np.abs(np.asarray(want))
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err < tol, err
    return err


def test_pcoa_job_across_ranks_matches_jax(tile_ranks, monkeypatch):
    """JAX's ``test_two_process_pcoa_job_end_to_end[tile2d]``: the
    coordinates within 1e-3 of JAX's single-process tile2d job, and
    bitwise the port's one-process tiled run."""
    want = jjobs.pcoa_job(_jjob(gram_mode="tile2d", eigh_mode="randomized",
                                num_pc=K, metric="ibs")).coords
    _patch_probes(monkeypatch)
    with virtual.virtual_slots(4):
        mine = jobs.pcoa_job(_tjob(metric="ibs", eigh_mode="randomized",
                                   num_pc=K))
    for o in tile_ranks:
        _close(o["pcoa"], want, COORD_TOL)
        np.testing.assert_array_equal(o["pcoa"], mine.coords)
        np.testing.assert_array_equal(o["pcoa_vals"], mine.eigenvalues)
    # Rank 0's solve, broadcast: the ranks hold the same bits.
    assert tile_ranks[0]["pcoa"] == tile_ranks[1]["pcoa"]


def test_pca_job_across_ranks_matches_jax(tile_ranks, monkeypatch):
    want = jjobs.variants_pca_job(_jjob(gram_mode="tile2d",
                                        num_pc=K)).coords
    _patch_probes(monkeypatch)
    with virtual.virtual_slots(4):
        mine = jobs.variants_pca_job(_tjob(num_pc=K))
    for o in tile_ranks:
        scale = float(np.max(np.abs(want)))
        _close(np.asarray(o["pca"]) / scale, np.asarray(want) / scale,
               COORD_TOL)
        np.testing.assert_array_equal(o["pca"], mine.coords)
    assert tile_ranks[0]["pca"] == tile_ranks[1]["pca"]


def test_streaming_refresh_across_ranks_matches_jax(tile_ranks,
                                                     monkeypatch):
    """JAX's ``test_two_process_incremental_pcoa[tile2d]``: three global
    steps give one refresh, at step 2, on every rank (rank 1 at its
    cursor 512 of its window, rank 0 at 512 of its own), and the final
    coordinates agree with the single-process run."""
    job = _jjob(gram_mode="tile2d", num_pc=K, metric="ibs",
                stream_refresh_blocks=2)
    want, _ = jstreaming.incremental_pcoa_job(job)
    for o in tile_ranks:
        assert o["stream_variants"] == V
        assert [s[0] for s in o["snapshots"]] == [512]
        assert np.isfinite(np.asarray(o["snapshots"][0][1])).all()
        _close(o["stream"], want.coords, COORD_TOL)
    assert tile_ranks[0]["stream"] == tile_ranks[1]["stream"]


def test_the_process_group_is_torn_down_before_the_interpreter_exits(
        tile_ranks):
    """``meshes._leave`` (registered at exit by ``maybe_init_distributed``)
    destroys the group and drops the port's reference to it: left to the
    interpreter's teardown, its threads can abort the process after the
    work is done."""
    for o in tile_ranks:
        assert o["left"] == [True, False], o["left"]


@pytest.mark.parametrize("route,words", [
    ("similarity", "spans 2 processes"),
    ("dense", "spans 2 processes"),
    ("indivisible", "cannot tile N=25 samples over the (2, 2) mesh"),
])
def test_refused_on_every_rank_before_the_stream(tile_ranks, route, words):
    """The routes that need the whole N x N (JAX's ``fetch_replicated``
    raises on a process-spanning tiled matrix after the stream; the port
    refuses before it), and a sample count the global mesh cannot tile."""
    for o in tile_ranks:
        assert words in o["refused"][route], o["refused"][route]


@pytest.mark.parametrize("where,words", [
    ("product", ["failed on rank(s) [1]",
                 "mat1 and mat2 shapes cannot be multiplied"]),
    ("rank0", ["ArithmeticError: a solve step failed",
               "the sharded eigensolve failed on rank 0: ArithmeticError"]),
])
def test_a_failure_in_the_sharded_solve_raises_on_every_rank(tile_ranks,
                                                            where, words):
    """A product that fails on one rank is voted before its gather, so
    every rank raises in that round (the failed rank its own error); a
    failure on rank 0 between products is sent to the ranks serving it.
    No rank is left waiting, and the ranks go on in step."""
    for o, want in zip(tile_ranks, words):
        assert want in o["solve_failed"][where], o["solve_failed"][where]


_CKPT = _PRELUDE + r"""
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource

ck = os.environ["CKPT_DIR"]
kw = dict(metric="ibs", tile2d_transport=os.environ["TRANSPORT"],
          checkpoint_dir=ck, checkpoint_every_blocks=1)


def bomb(acc, blocks_done, meta):
    if blocks_done == 2:  # the same global step on both ranks
        raise RuntimeError("simulated preemption")


with virtual.virtual_slots(2):
    died = False
    try:
        runner.run_gram(job((2, 2), **kw), runner.build_source(ing, "cpu"),
                        PhaseTimer(), on_block=bomb)
    except RuntimeError as e:
        died = "preemption" in str(e)
    manifest = json.load(open(os.path.join(ck, "manifest.json")))
    files = sorted(os.listdir(ck))
    g = runner.run_gram(job((2, 2), **kw), runner.build_source(ing, "cpu"),
                        PhaseTimer())
    acc = tiles(g.acc)
    final = json.load(open(os.path.join(ck, "manifest.json")))
    ids = SyntheticSource(n_samples=24, n_variants=8, seed=5).sample_ids
    # A corrupt tile of rank 1's, in the latest generation only: rank 1
    # alone fails its verification, and both ranks take .old.
    mh.allgather(np.int32(1))
    if RANK == 1:
        path = os.path.join(ck, "yc.t12_0.npy")
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            b = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x10]))
    mh.allgather(np.int32(1))
    _acc, cursor, _ = ckpt.load(ck, "ibs", ids, block_variants=256,
                                plan=g.plan)
    # A sidecar that never lands: rank 0's merge fails loudly, and the
    # vote takes rank 1 down with it.
    if RANK == 1:
        ckpt._write_sidecar = lambda tmp, rank, sums: None
    try:
        ckpt.save(ck + "_b", g.acc, 7, "ibs", 256, ids, plan=g.plan)
        sidecar = "saved"
    except RuntimeError as e:
        sidecar = str(e)
emit(died=died, manifest=manifest, files=files, acc=acc, final=final,
     fallback_cursor=cursor, sidecar=sidecar)
"""


@pytest.mark.parametrize("transport", ["gather", "ring"])
def test_tiled_checkpoint_across_ranks(tmp_path, probes_file, transport):
    """JAX's ``test_two_process_checkpoint_resume[tile2d]``, and the
    multi-process tiled layout: each rank writes its own tile files, the
    sidecars are merged by rank 0 and removed, the manifest holds the
    global mesh and per-rank cursors; the resume is bitwise JAX's whole
    accumulators; a corrupt tile of rank 1 takes both ranks to ``.old``;
    a missing sidecar aborts both; a one-process job is refused it."""
    ck = str(tmp_path / "ck")
    outs = run_ranks(_CKPT, extra_env={"CKPT_DIR": ck, "PROBES": probes_file,
                                       "TRANSPORT": transport})
    want = _jax_acc("ibs")
    tiles = {f"{k}.t{r0}_{c0}.npy" for k in want
             for r0 in (0, 12) for c0 in (0, 12)}
    for o in outs:
        assert o["died"]
        m = o["manifest"]
        assert (m["process_count"], m["mesh_shape"], m["mode"]) == \
            (2, [2, 2], "tile2d")
        assert set(m["layout"].values()) == {"tiles"}
        # Both ranks checkpointed after global step 1.
        assert m["cursors"] == {"0": 256, "1": 256}
        assert set(m["sha256"]) == tiles
        assert sorted(o["files"]) == sorted(tiles | {"manifest.json"})
        assert o["final"]["cursors"] == {"0": 768, "1": 512}
        for k, v in want.items():
            for s, tile in o["acc"][k].items():
                rows, cols = _spans((2, 2), int(s))
                np.testing.assert_array_equal(np.asarray(tile),
                                              v[rows, cols], f"{k} {s}")
        # The fallback generation is the checkpoint of global step 2.
        assert o["fallback_cursor"] == 512
    assert os.path.isdir(ck + ".corrupt")  # the latest, set aside
    assert "checksum sidecar from process 1 is missing" in \
        outs[0]["sidecar"]
    assert "sidecar merge or rotation failed" in outs[1]["sidecar"]
    # A one-process job is refused the two-process tiled checkpoint.
    ids = SyntheticSource(n_samples=N, n_variants=8, seed=5).sample_ids
    with virtual.virtual_slots(4):
        plan = runner.plan_for_job(_tjob(metric="ibs"),
                                   SyntheticSource(n_samples=N,
                                                   n_variants=8, seed=5))
        with pytest.raises(ValueError, match="do not transfer"):
            ckpt.load(ck, "ibs", ids, block_variants=BV, plan=plan)
