"""Two-process port jobs that carry state across the stream or across
cohorts, against the JAX package's single-process runs (gloo on
localhost, ``--device cpu``; ``tests/test_torch_distributed.py`` has the
feeder and the plain jobs):

- checkpoint and resume under the variant plan: both ranks die at the
  same global step, the manifest holds JAX's fields with a cursor per
  rank, the saved leaves are JAX's accumulators over exactly the
  variants those cursors cover, the resume is bitwise JAX's whole-cohort
  accumulators, and a one-process job is refused the checkpoint;
- the generation agreement on load: a corrupt latest generation, or one
  rank unable to read it, takes both ranks to ``.old``; every
  generation corrupt aborts both in the vote;
- the streaming PCoA's refresh on the global step count (one snapshot
  at 1280 variants / 256 a block / every 2 steps) and its coordinates;
- cross-kinship and projection: per-rank (A, N_ref) partials merged into
  the single-process result exactly;
- the telemetry export at exit: each rank's metrics stay in its own
  directory after the group is torn down, whichever rank exits last.
"""

import json
import os

import numpy as np
import pytest

from spark_examples_tpu.core.config import (
    ComputeConfig as JCompute,
    IngestConfig as JIngest,
    JobConfig as JJob,
)
from spark_examples_tpu.ingest.synthetic import SyntheticSource as JSynth
from spark_examples_tpu.ops import gram as jgram
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import project as jproject
from spark_examples_tpu.pipelines.streaming import (
    incremental_pcoa_job as jincremental,
)
from spark_examples_tpu.utils import oracle as joracle
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource

from torch_ranks import run_ranks

N, V, BV = 24, 1280, 256

_CKPT = r"""
import json, os
import numpy as np
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.pipelines import runner

ck = os.environ["CKPT_DIR"]
job = JobConfig(
    ingest=IngestConfig(source="synthetic", n_samples=24, n_variants=1280,
                        block_variants=256, seed=5),
    compute=ComputeConfig(gram_mode="variant", metric="ibs", device="cpu",
                          checkpoint_dir=ck, checkpoint_every_blocks=1))


def bomb(acc, blocks_done, meta):
    if blocks_done == 2:  # the same global step on both ranks
        raise RuntimeError("simulated preemption")


died = False
try:
    runner.run_gram(job, runner.build_source(job.ingest, "cpu"),
                    PhaseTimer(), on_block=bomb)
except RuntimeError as e:
    died = "preemption" in str(e)
manifest = json.load(open(os.path.join(ck, "manifest.json")))
saved = {k: np.load(os.path.join(ck, f"{k}.npy")).tolist()
         for k in manifest["leaves"]}
g = runner.run_gram(job, runner.build_source(job.ingest, "cpu"),
                    PhaseTimer())
emit(died=died, manifest=manifest, saved=saved, n_variants=g.n_variants,
     mode=g.plan.mode, acc={k: v.tolist() for k, v in g.acc.items()})
"""


def _cohort(n=N, seed=5):
    src = JSynth(n_samples=n, n_variants=V, seed=seed)
    return np.concatenate([b for b, _ in src.blocks(BV)], axis=1)


def _products(g) -> dict:
    want = joracle.cpu_gram_products(g, jgram.PIECES_FOR_METRIC["ibs"])
    return {k: np.asarray(v, np.int64) for k, v in want.items()}


def test_checkpoint_resume_variant(tmp_path):
    ck = str(tmp_path / "ck")
    outs = run_ranks(_CKPT, extra_env={"CKPT_DIR": ck})
    g = _cohort()
    whole = _products(g)
    for o in outs:
        assert o["died"], o
        m = o["manifest"]
        assert m["process_count"] == 2 and m["mode"] == "variant"
        # Both ranks saved after global step 1: one block each.
        assert m["cursors"] == {"0": 256, "1": 256}, m
        assert m["next_variant"] == 256
        assert m["layout"] == {k: "full" for k in m["leaves"]}
        # The saved leaves cover exactly the cursors' variants: rank 0's
        # window starts at 0, rank 1's at 768.
        covered = _products(np.concatenate([g[:, :256], g[:, 768:1024]],
                                           axis=1))
        for k, v in covered.items():
            np.testing.assert_array_equal(np.asarray(o["saved"][k]), v, k)
        assert o["n_variants"] == V and o["mode"] == "variant"
        for k, v in whole.items():
            np.testing.assert_array_equal(np.asarray(o["acc"][k]), v, k)
    # A one-process job is refused the two-process checkpoint.
    ids = SyntheticSource(n_samples=N, n_variants=V, seed=5).sample_ids
    with pytest.raises(ValueError, match="do not transfer"):
        ckpt.load(ck, "ibs", ids, block_variants=BV)
    keys = json.load(open(os.path.join(ck, "manifest.json")))
    jkeys = {"next_variant", "cursors", "metric", "block_variants",
             "sample_hash", "n_samples", "leaves", "layout", "mesh_shape",
             "mode", "process_count", "stream_stats", "extra", "sha256"}
    assert set(keys) == jkeys


_STREAM = r"""
import numpy as np
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.pipelines.runner import build_source
from spark_examples_tpu_torch.pipelines.streaming import (
    incremental_pcoa_job)

job = JobConfig(
    ingest=IngestConfig(source="synthetic", n_samples=24, n_variants=1280,
                        block_variants=256, seed=5),
    compute=ComputeConfig(gram_mode="variant", num_pc=3, metric="ibs",
                          stream_refresh_blocks=2, device="cpu"))
out, snaps = incremental_pcoa_job(job, source=build_source(job.ingest,
                                                           "cpu"))
emit(n_variants=int(out.n_variants), snapshots=len(snaps),
     snap_variants=[s.n_variants for s in snaps],
     finite=all(bool(np.isfinite(s.coords).all()) for s in snaps),
     coords=np.abs(out.coords).tolist())
"""


def test_incremental_pcoa_variant():
    outs = run_ranks(_STREAM)
    ref, _ = jincremental(JJob(
        ingest=JIngest(source="synthetic", n_samples=N, n_variants=V,
                       block_variants=BV, seed=5),
        compute=JCompute(gram_mode="variant", num_pc=3, metric="ibs",
                         stream_refresh_blocks=2)))
    want = np.abs(ref.coords)
    for o in outs:
        assert o["n_variants"] == V, o
        # 3 global steps (windows of 3 and 2 blocks) -> one refresh, at
        # step 2, stamped with each rank's own cursor.
        assert o["snapshots"] == 1 and o["finite"], o
        assert o["snap_variants"] == [512], o
        got = np.asarray(o["coords"])
        assert float(np.max(np.abs(got - want))) < 1e-3, o


_CROSS = r"""
import os
import numpy as np
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.pipelines import project
from spark_examples_tpu_torch.pipelines.runner import build_source

ing = IngestConfig(source="synthetic", n_samples=8, n_variants=1280,
                   block_variants=256, seed=5)
src_new, src_ref = build_source(ing, "cpu"), build_source(ing, "cpu")
job = JobConfig(ingest=ing, compute=ComputeConfig(metric="king",
                                                  device="cpu"),
                output_path=os.environ["OUT"] + f".rank{RANK}")
res = project.cross_kinship_job(job, src_new, src_ref)
panel = IngestConfig(source="synthetic", n_samples=16, n_variants=1280,
                     block_variants=256, seed=5)
new = IngestConfig(source="synthetic", n_samples=8, n_variants=1280,
                   block_variants=256, seed=9)
proj = project.pcoa_project_job(
    JobConfig(ingest=new, compute=ComputeConfig(device="cpu")),
    os.environ["MODEL"], build_source(new, "cpu"),
    build_source(panel, "cpu"))
emit(local_variants=int(src_new.n_variants), n_variants=int(res.n_variants),
     phi=np.asarray(res.similarity).tolist(),
     proj=np.asarray(proj.coords).tolist(), proj_variants=proj.n_variants,
     wrote=os.path.exists(job.output_path))
"""


def test_cross_kinship_and_projection_match_single(tmp_path):
    model = str(tmp_path / "m.npz")
    panel = JJob(ingest=JIngest(source="synthetic", n_samples=16,
                                n_variants=V, block_variants=BV, seed=5),
                 compute=JCompute(metric="ibs", num_pc=3),
                 model_path=model)
    jjobs.pcoa_job(panel)
    outs = run_ranks(_CROSS, extra_env={"MODEL": model,
                                        "OUT": str(tmp_path / "phi.tsv")})
    job = JJob(ingest=JIngest(block_variants=BV),
               compute=JCompute(metric="king"))
    want = jproject.cross_kinship_job(
        job, JSynth(n_samples=8, n_variants=V, seed=5),
        JSynth(n_samples=8, n_variants=V, seed=5)).similarity
    proj = jproject.pcoa_project_job(
        JJob(ingest=JIngest(block_variants=BV), compute=JCompute()), model,
        JSynth(n_samples=8, n_variants=V, seed=9),
        JSynth(n_samples=16, n_variants=V, seed=5)).coords
    assert sorted(o["local_variants"] for o in outs) == [512, 768]
    for o in outs:
        assert o["n_variants"] == V and o["proj_variants"] == V, o
        np.testing.assert_array_equal(np.asarray(o["phi"]), want)
        np.testing.assert_allclose(np.asarray(o["proj"]), proj, rtol=1e-5,
                                   atol=1e-5)
        assert o["wrote"] == (o["process"] == 0)  # rank 0 owns the file
    assert (np.diag(want) > 0.45).all()


_AGREE = r"""
import os
import numpy as np
from spark_examples_tpu_torch.core import checkpoint as ckpt, faults, meshes
from spark_examples_tpu_torch.ingest.source import ArraySource

meshes.maybe_init_distributed("cpu")
if RANK == 1 and os.environ.get("FAULT"):
    faults.arm([os.environ["FAULT"]])
ids = ArraySource(np.zeros((8, 64), np.int8)).sample_ids
try:
    acc, cursor, _ = ckpt.load(os.environ["CKPT_DIR"], "ibs", ids,
                               block_variants=32)
    emit(outcome="loaded", cursor=cursor, cc=int(acc["cc"].sum()))
except ckpt.CheckpointCorruptError as e:
    emit(outcome="corrupt", message=str(e))
"""


def _two_generations(path):
    """Two generations of a two-process checkpoint: ``.old`` at cursors
    32 (cc all ones), the latest at 64 (cc all twos)."""
    import torch

    ids = [f"S{i:06d}" for i in range(8)]
    for fill, cursor in ((1, 32), (2, 64)):
        acc = {k: torch.full((8, 8), fill, dtype=torch.int32)
               for k in ("cc", "t1t1", "t2t2", "yc")}
        ckpt.save(path, acc, cursor, "ibs", 32, ids)
        mpath = os.path.join(path, "manifest.json")
        m = json.load(open(mpath))
        m.update(process_count=2, cursors={"0": cursor, "1": cursor})
        json.dump(m, open(mpath, "w"))


def _flip(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))


@pytest.mark.parametrize("case", ["latest_corrupt", "one_rank_cannot_read",
                                  "all_corrupt"])
def test_ranks_agree_on_one_generation(tmp_path, case):
    """The generation agreement on load: a corrupt latest generation
    takes both ranks to ``.old`` (promoted back, the corrupt one set
    aside); a rank that cannot read the latest takes the other with it;
    every generation corrupt aborts both ranks in the vote, none left in
    a collective."""
    ck = str(tmp_path / "ck")
    _two_generations(ck)
    env = {"CKPT_DIR": ck}
    if case in ("latest_corrupt", "all_corrupt"):
        _flip(os.path.join(ck, "cc.npy"))
    if case == "all_corrupt":
        _flip(os.path.join(ck + ".old", "cc.npy"))
    if case == "one_rank_cannot_read":
        env["FAULT"] = "checkpoint.tile_read:io_error:max=1"
    outs = run_ranks(_AGREE, extra_env=env, timeout=120)
    if case == "all_corrupt":
        assert [o["outcome"] for o in outs] == ["corrupt"] * 2, outs
        return
    for o in outs:
        assert (o["outcome"], o["cursor"], o["cc"]) == ("loaded", 32, 64), o
    # Rank 0 promoted .old back to the latest slot.
    assert json.load(open(os.path.join(ck, "manifest.json")))[
        "cursors"] == {"0": 32, "1": 32}
    assert os.path.exists(ck + ".corrupt") and not os.path.exists(
        ck + ".old")


_EXIT_EXPORT = r"""
import os, time
from spark_examples_tpu_torch.core import meshes, telemetry

# The CLI's order: the telemetry directory (and its exit flush) first,
# then the group (and its exit teardown, which runs before the flush).
telemetry.configure(dir=os.environ["TEL_DIR"])
meshes.maybe_init_distributed("cpu")
telemetry.count("gram.fused_blocks", RANK + 1)
emit(exported=telemetry.export())
if RANK == 1:
    time.sleep(2.0)  # rank 1's exit flush lands after rank 0's
"""


def test_exit_export_keeps_each_rank_s_directory(tmp_path):
    """The exit flush runs after ``meshes._leave`` destroyed the group;
    it still writes under the rank the process was, so a rank that exits
    last does not overwrite rank 0's ``metrics.json`` with its own."""
    tel = str(tmp_path / "tel")
    outs = run_ranks(_EXIT_EXPORT, extra_env={"TEL_DIR": tel}, timeout=120)
    for r, o in enumerate(outs):
        assert o["exported"] == os.path.join(tel, f"rank{r}"), o
        with open(os.path.join(tel, f"rank{r}", "metrics.json")) as f:
            m = json.load(f)
        assert m["counters"]["gram.fused_blocks"] == r + 1, (r, m["counters"])
        assert (m["meta"]["rank"], m["meta"]["process_count"]) == (r, 2), m["meta"]
