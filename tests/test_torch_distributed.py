"""Jobs of two port processes over ``torch.distributed`` (gloo on
localhost, ``--device cpu``) against the JAX package's single-process
runs, computed in this test process on conftest's CPU devices.

The counterparts of ``tests/test_distributed.py``'s variant cases: the
gram accumulators bitwise (pcoa's ibs, pca's shared-alt, a dense
similarity), ``pcoa_job`` end to end (rank windows [512, 768] of 1280
variants, coordinates within 1e-3), the feeder's consensus amortization,
a broken length claim aborting both ranks in the agreement round, a
straggling rank absorbed, and the refusals (the tile2d cross plan,
process counts that differ) beside the tile2d plan and the tiled
multi-process checkpoint that now run (``tests/test_torch_tile2d_ranks.py``
has the route itself). Every rank
reports the JAX modules it loaded: none (``torch_ranks.run_ranks``).
The checkpoint, streaming and cross-cohort cases are in
``tests/test_torch_distributed_jobs.py``.
"""

import numpy as np
import pytest

from spark_examples_tpu.core.config import (
    ComputeConfig as JCompute,
    IngestConfig as JIngest,
    JobConfig as JJob,
)
from spark_examples_tpu.core.profiling import PhaseTimer as JTimer
from spark_examples_tpu.ingest.synthetic import SyntheticSource as JSynth
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import meshes
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource

from torch_ranks import run_ranks

N, V, BV = 24, 1280, 256

_JOB = r"""
import numpy as np
from spark_examples_tpu_torch.core import meshes, telemetry
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.pipelines import jobs, runner

ing = IngestConfig(source="synthetic", n_samples=24, n_variants=1280,
                   block_variants=256, seed=5)


def job(**kw):
    return JobConfig(ingest=ing, compute=ComputeConfig(device="cpu", **kw))


src = runner.build_source(ing, "cpu")  # joins the group, windows the source
out = jobs.pcoa_job(job(gram_mode="variant", eigh_mode="randomized",
                        num_pc=3, metric="ibs"), source=src)
accs = {}
for metric, mode in (("ibs", "variant"), ("shared-alt", "replicated"),
                     ("dot", "auto")):
    g = runner.run_gram(job(metric=metric, gram_mode=mode),
                        runner.build_source(ing, "cpu"), PhaseTimer())
    accs[metric] = {"mode": g.plan.mode, "n_variants": g.n_variants,
                    "acc": {k: v.tolist() for k, v in g.acc.items()}}
pca = jobs.variants_pca_job(job(num_pc=3), source=runner.build_source(
    ing, "cpu"))
sim = jobs.similarity_matrix_job(job(metric="ibs"))
bc = runner.run_similarity(job(metric="braycurtis"))
d = meshes.distributed()
emit(local_n_variants=int(src.n_variants), n_variants=int(out.n_variants),
     coords=np.abs(out.coords).tolist(), accs=accs,
     pca=np.abs(pca.coords).tolist(), similarity=sim.similarity.tolist(),
     braycurtis=bc.distance.tolist(), bc_variants=bc.n_variants,
     backend=d.name, world=d.world,
     gauge=telemetry.metrics_snapshot()["gauges"]["multihost.backend"])
"""


def _jjob(**kw):
    return JJob(ingest=JIngest(source="synthetic", n_samples=N,
                               n_variants=V, block_variants=BV, seed=5),
                compute=JCompute(**kw))


@pytest.fixture(scope="module")
def job_ranks():
    return run_ranks(_JOB)


def test_pcoa_job_end_to_end_matches_jax(job_ranks):
    want = np.abs(jjobs.pcoa_job(_jjob(gram_mode="variant",
                                       eigh_mode="randomized", num_pc=3,
                                       metric="ibs")).coords)
    # Partitioned, not replicated: each rank read only its window.
    assert sorted(o["local_n_variants"] for o in job_ranks) == [512, 768]
    for o in job_ranks:
        assert o["n_variants"] == V  # the global total, allgathered
        got = np.asarray(o["coords"])
        assert got.shape == want.shape
        assert float(np.max(np.abs(got - want))) < 1e-3


@pytest.mark.parametrize("metric", ["ibs", "shared-alt", "dot"])
def test_two_rank_accumulators_bitwise_jax(job_ranks, metric):
    g = jrunner.run_gram(_jjob(metric=metric), JSynth(n_samples=N,
                                                      n_variants=V, seed=5),
                         JTimer())
    want = {k: np.asarray(v) for k, v in g.acc.items()}
    for o in job_ranks:
        got = o["accs"][metric]
        assert got["n_variants"] == V
        assert sorted(got["acc"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got["acc"][k]), v, k)
    modes = {o["accs"][metric]["mode"] for o in job_ranks}
    # auto counts every rank's slot, as JAX's process-spanning mesh does.
    assert modes == {"replicated" if metric == "shared-alt" else "variant"}


def test_pca_and_similarity_match_jax(job_ranks):
    pca = np.abs(jjobs.variants_pca_job(_jjob(num_pc=3)).coords)
    sim = jjobs.similarity_matrix_job(_jjob(metric="ibs")).similarity
    for o in job_ranks:
        assert float(np.max(np.abs(np.asarray(o["pca"]) - pca))) < 1e-3
        np.testing.assert_array_equal(np.asarray(o["similarity"]),
                                      np.asarray(sim))


def test_braycurtis_is_per_rank_as_in_jax(job_ranks):
    """The table route reads ``source.blocks()``, the rank's own window,
    and merges nothing across ranks, as JAX's: each rank's distances are
    JAX's over that window alone."""
    from spark_examples_tpu.ingest.source import WindowSource

    for o in job_ranks:
        start, stop = ((0, 768), (768, 1280))[o["process"]]
        want = jrunner._run_braycurtis(
            _jjob(metric="braycurtis"),
            WindowSource(JSynth(n_samples=N, n_variants=V, seed=5), start,
                         stop), JTimer())
        assert o["bc_variants"] == stop - start
        np.testing.assert_allclose(np.asarray(o["braycurtis"]),
                                   np.asarray(want.distance), rtol=1e-6,
                                   atol=1e-6)


def test_backend_rule_gives_gloo_on_the_cpu_and_reports_it(job_ranks):
    for o in job_ranks:
        assert (o["backend"], o["world"]) == ("gloo", 2)
        assert o["gauge"]["last"] == 0.0
        assert (f"multihost: rank {o['process']} of 2, backend gloo on cpu"
                in o["stdout"])


@pytest.mark.parametrize("device,world,cards,local,want", [
    ("cpu", 2, 0, None, ("gloo", False)),
    ("cuda", 2, 2, None, ("nccl", False)),
    ("cuda", 4, 8, None, ("nccl", False)),
    ("cuda", 2, 1, None, ("gloo", True)),
    ("cuda", 8, 4, 4, ("nccl", False)),
    ("cuda", 8, 4, 8, ("gloo", True)),
])
def test_backend_rule(device, world, cards, local, want):
    import torch

    backend, staged, reason = meshes.backend_rule(
        torch.device(device), world, cards, local)
    assert (backend, staged) == want
    assert reason


_FEEDER = r"""
import numpy as np
from spark_examples_tpu_torch.core import meshes
from spark_examples_tpu_torch.ingest.source import (
    WindowSource, window_for_process)
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.parallel import gram_sharded, multihost as mh

meshes.maybe_init_distributed("cpu")
N, V, BV = 16, 16384, 128  # 128 blocks globally, 64 per rank
start, stop = window_for_process(V, BV, meshes.process_index(),
                                 meshes.process_count())
src = WindowSource(SyntheticSource(n_samples=N, n_variants=V, seed=11),
                   start, stop)
plan = gram_sharded.plan_for(meshes.make_mesh(["cpu"]), N, "ibs",
                             "variant", processes=2)


class HiddenLength:
    # The same partition without exact_n_variants: the group fallback.
    def __init__(self, inner):
        self._inner = inner

    n_samples = property(lambda self: self._inner.n_samples)
    n_variants = property(lambda self: self._inner.n_variants)
    sample_ids = property(lambda self: self._inner.sample_ids)

    def blocks(self, bv, start=0):
        return self._inner.blocks(bv, start)


def drain(source):
    stats = {}
    n_blocks = n_real = width = 0
    total = 0
    for block, meta in mh.stream_global_blocks(
            source, BV, 0, plan, pack=False, stats=stats,
            consensus_every=8):
        n_blocks += 1
        n_real += meta is not None
        width += block.shape[1]
        total += int(block.to(int).clamp(min=0).sum())
    return {"rounds": stats.get("consensus_rounds", 0),
            "blocks": n_blocks, "real": n_real, "width": width,
            "total": total}


exact = drain(src)
fallback = drain(HiddenLength(src))
s0, s1 = window_for_process(1280, BV, meshes.process_index(),
                            meshes.process_count())
partial = drain(HiddenLength(WindowSource(
    SyntheticSource(n_samples=N, n_variants=1280, seed=11), s0, s1)))
emit(exact=exact, fallback=fallback, partial=partial)
"""


def test_feeder_consensus_amortization():
    for o in run_ranks(_FEEDER):
        # Exact lengths: one upfront count round, one terminal round.
        assert o["exact"]["rounds"] == 2, o
        assert o["exact"]["blocks"] == o["exact"]["real"] == 64, o
        # Fallback: the count probe, ceil(64 / 8) has-data rounds, and
        # the round that finds every rank drained.
        assert o["fallback"]["rounds"] == 1 + 64 // 8 + 1, o
        assert o["fallback"]["blocks"] == 64, o
        for key in ("width", "total"):
            assert o["fallback"][key] == o["exact"][key], (key, o)
        # A group that outlives the data pads to its boundary: 5 real
        # steps -> 8 yielded, 3 rounds (probe, group, terminal).
        assert (o["partial"]["blocks"], o["partial"]["real"],
                o["partial"]["rounds"]) == (8, 5, 3), o


_CONTRACT = r"""
from spark_examples_tpu_torch.core import meshes
from spark_examples_tpu_torch.ingest.source import (
    WindowSource, window_for_process)
from spark_examples_tpu_torch.ingest.synthetic import SyntheticSource
from spark_examples_tpu_torch.parallel import gram_sharded, multihost as mh

meshes.maybe_init_distributed("cpu")
N, V, BV = 16, 1024, 128
start, stop = window_for_process(V, BV, meshes.process_index(),
                                 meshes.process_count())
src = WindowSource(SyntheticSource(n_samples=N, n_variants=V, seed=3),
                   start, stop)
if RANK == 1:
    inner = src

    class Lying:
        exact_n_variants = True
        n_samples = inner.n_samples
        n_variants = inner.n_variants + BV  # claims a block it lacks
        sample_ids = inner.sample_ids

        def blocks(self, bv, start=0):
            return inner.blocks(bv, start)

    src = Lying()
plan = gram_sharded.plan_for(meshes.make_mesh(["cpu"]), N, "ibs",
                             "variant", processes=2)
outcome = "completed"
try:
    for _ in mh.stream_global_blocks(src, BV, 0, plan, pack=False):
        pass
except RuntimeError as e:
    outcome = "contract" if "contract is broken" in str(e) else f"wrong: {e}"
emit(outcome=outcome)
"""


def test_contract_violation_aborts_both_ranks():
    # Both ranks, the honest one too, fail in the agreement round
    # (within the harness's timeout: nobody is left in a collective).
    outs = run_ranks(_CONTRACT, timeout=120)
    assert [o["outcome"] for o in outs] == ["contract", "contract"], outs


_STRAGGLER = r"""
import os
import numpy as np
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.parallel import multihost as mh
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job
from spark_examples_tpu_torch.pipelines.runner import build_source

job = JobConfig(
    ingest=IngestConfig(source="synthetic", n_samples=24, n_variants=1280,
                        block_variants=256, seed=5),
    compute=ComputeConfig(gram_mode="variant", eigh_mode="randomized",
                          num_pc=3, metric="ibs", device="cpu"))
src = build_source(job.ingest, "cpu")
telemetry.configure(dir=os.environ["TEL"])
if RANK == 1:  # only one rank straggles
    faults.arm(["multihost.consensus:delay:delay=0.1:max=0"])
out = pcoa_job(job, source=src)
digest = telemetry.digest()
# Rank 1 exports first, so rank 0's per-rank summary finds both.
if RANK == 1:
    telemetry.export()
mh.allgather(np.int32(1))
if RANK == 0:
    telemetry.export()
emit(fires=faults.fire_count("multihost.consensus"),
     coords=np.abs(out.coords).tolist(), digest=digest)
"""


def test_straggler_delay_is_absorbed(tmp_path):
    want = np.abs(jjobs.pcoa_job(_jjob(gram_mode="variant",
                                       eigh_mode="randomized", num_pc=3,
                                       metric="ibs")).coords)
    outs = run_ranks(_STRAGGLER, extra_env={"TEL": str(tmp_path)})
    for o in outs:
        if o["process"] == 1:
            assert o["fires"] >= 2, o  # the upfront and terminal rounds
        got = np.asarray(o["coords"])
        assert float(np.max(np.abs(got - want))) < 1e-3, o
    # The wait shows on the rank that did not straggle.
    assert outs[0]["digest"]["consensus_wait_p95_s"] > 0.02, outs[0]
    lines = open(tmp_path / "summary.txt").read().splitlines()
    cols = lines[0].split("\t")
    assert cols[-2:] == ["wait_mean_ms", "wait_p95_ms"]
    rows = {int(r.split("\t")[0]): dict(zip(cols, r.split("\t")))
            for r in lines[1:]}
    assert sorted(rows) == [0, 1]
    assert float(rows[0]["wait_mean_ms"]) > 20.0
    assert float(rows[0]["wait_mean_ms"]) > float(rows[1]["wait_mean_ms"])


_REFUSALS = r"""
import os
import numpy as np
from spark_examples_tpu_torch.core import checkpoint as ckpt, meshes, virtual
from spark_examples_tpu_torch.core.config import (
    ComputeConfig, IngestConfig, JobConfig)
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.pipelines import runner
from spark_examples_tpu_torch.pipelines.project import _accumulate_cross

meshes.maybe_init_distributed("cpu")
g = np.zeros((8, 64), np.int8)
out = {}


def outcome(fn, words):
    try:
        fn()
        return "ran"
    except ValueError as e:
        return "refused" if words in str(e) else f"wrong: {e}"


def job(**kw):
    return JobConfig(ingest=IngestConfig(block_variants=32),
                     compute=ComputeConfig(metric="ibs", gram_mode="tile2d",
                                           device="cpu", **kw))


out["cross"] = outcome(lambda: _accumulate_cross(
    job(), ArraySource(g), ArraySource(g), ("m", "d1"), PhaseTimer()),
    "single-host")
plan = runner.plan_for_job(job(), ArraySource(g))
out["gram"] = [plan.mode, list(plan.mesh.shape),
               list(plan.mesh.local_slots)]
ids = ArraySource(g).sample_ids
with virtual.virtual_slots(2):
    tplan = runner.plan_for_job(job(mesh_shape=(2, 2)), ArraySource(g))
    acc, cursor, _ = ckpt.load(os.environ["TILED_CKPT"], "ibs", ids,
                               block_variants=32, plan=tplan)
out["tiled_ckpt"] = [cursor, [s for s, _ in acc["cc"].local()]]
out["one_process_ckpt"] = outcome(lambda: ckpt.load(
    os.environ["ONE_PROCESS_CKPT"], "ibs", ids, block_variants=32),
    "do not transfer")
emit(**out)
"""


def test_refusals_across_ranks(tmp_path):
    """Across ranks: the tile2d cross plan and a one-process checkpoint
    are refused on both ranks, and a one-process job is refused a
    checkpoint of two (the other direction). tile2d itself runs: the
    gram plan tiles over a (1, 2) mesh spanning the ranks, and a tiled
    checkpoint of two processes loads each rank's own tiles."""
    import json

    import torch

    from spark_examples_tpu_torch.core import virtual
    from spark_examples_tpu_torch.ingest.source import ArraySource
    from spark_examples_tpu_torch.parallel import gram_sharded as gs

    ids = ArraySource(np.zeros((8, 64), np.int8)).sample_ids
    plan = gs.GramPlan(meshes.make_mesh(virtual.virtual_devices(4, "cpu"),
                                        (2, 2)), "tile2d")
    acc = gs.init_sharded(plan, 8, "ibs")
    tiled, whole = str(tmp_path / "tiled"), str(tmp_path / "whole")
    ckpt.save(tiled, acc, 32, "ibs", 32, ids, plan=plan)
    manifest = json.load(open(f"{tiled}/manifest.json"))
    manifest.update(process_count=2, cursors={"0": 32, "1": 32})
    json.dump(manifest, open(f"{tiled}/manifest.json", "w"))
    ckpt.save(whole, {k: torch.zeros((8, 8), dtype=torch.int32)
                      for k in ("cc", "t1t1", "t2t2", "yc")},
              32, "ibs", 32, ids)
    outs = run_ranks(_REFUSALS, extra_env={"TILED_CKPT": tiled,
                                           "ONE_PROCESS_CKPT": whole})
    for o in outs:
        r = o["process"]
        assert (o["cross"], o["one_process_ckpt"]) == ("refused",) * 2, o
        assert o["gram"] == ["tile2d", [1, 2], [r]], o
        assert o["tiled_ckpt"] == [32, [2 * r, 2 * r + 1]], o
    with pytest.raises(ValueError, match="do not transfer"):
        ckpt.load(tiled, "ibs", ids, block_variants=32, plan=plan)


_NO_CARD = r"""
from spark_examples_tpu_torch.core import meshes
from spark_examples_tpu_torch.core.config import IngestConfig
from spark_examples_tpu_torch.pipelines import runner

try:
    runner.build_source(IngestConfig(n_samples=8, n_variants=64), "cuda")
    outcome = "ran"
except RuntimeError as e:
    outcome = "refused" if "no CUDA device" in str(e) else f"wrong: {e}"
emit(outcome=outcome, joined=meshes.distributed() is not None)
"""


def test_cuda_without_a_card_fails_on_every_rank_before_any_collective():
    """No card visible: each rank raises before it joins the group (no
    rank waits for a peer, none carries on on the CPU)."""
    outs = run_ranks(_NO_CARD, extra_env={"CUDA_VISIBLE_DEVICES": ""},
                     timeout=120)
    assert [(o["outcome"], o["joined"]) for o in outs] == \
        [("refused", False)] * 2, outs


def test_one_rank_window_source_is_the_whole_cohort():
    """A one-process job builds the raw source (no window, no group)."""
    from spark_examples_tpu_torch.core.config import IngestConfig
    from spark_examples_tpu_torch.pipelines import runner

    src = runner.build_source(IngestConfig(source="synthetic", n_samples=N,
                                           n_variants=V, seed=5), "cpu")
    assert isinstance(src, SyntheticSource) and src.n_variants == V
    assert meshes.distributed() is None and meshes.process_count() == 1
