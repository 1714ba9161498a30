"""The port's neighbors job against the JAX package's, on the CPU.

- MinHash: ``hash_params`` identical; the int64-masked hash family equal
  to uint32 arithmetic; signatures bitwise equal to JAX's across two
  block partitions (and across the update's hash chunking).
- LSH: ``candidate_pairs`` and ``filter_fraction`` identical.
- Exact evaluation: the packed bit-plane pair statistics equal JAX's
  int64 einsum for every cross statistic; the pair similarities are
  bitwise equal to JAX's and to a float64 finalize of the port's own
  dense int32 statistics, and within 1e-6 of the port's f32 dense
  finalize (the JAX package's own tolerance for that comparison), for
  ibs, king and jaccard.
- Files: ``save_result`` files are byte-equal across the packages in
  both directions, for topk and pairs; each package loads the other's;
  ``load_result``'s error ladder.
- Checkpoints: a minhash checkpoint written by either package resumes
  in the other to bitwise-equal signatures, and the leaf files are
  byte-identical.
- Faults: the ``neighbors.candidates`` site retries to an identical
  result and fails once its budget is spent.
- CLI: cohort-mode files byte-equal to the JAX CLI's; bad knobs refused
  by name.
"""

import json
import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core.profiling import PhaseTimer as JPhaseTimer
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.neighbors import engine as jengine
from spark_examples_tpu.neighbors import lsh as jlsh
from spark_examples_tpu.neighbors import minhash as jminhash
from spark_examples_tpu.neighbors import output as joutput
from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import config as tconfig
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.neighbors import (
    NeighborFormatError,
    PairsResult,
    TopKResult,
    load_result,
    save_result,
)
from spark_examples_tpu_torch.neighbors import engine, lsh
from spark_examples_tpu_torch.neighbors import minhash as M
from spark_examples_tpu_torch.neighbors import output as toutput
from spark_examples_tpu_torch.ops import distances, genotype, gram


def _cohort(seed, n, v, missing=0.1):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(n, v), dtype=np.int8)
    g[rng.random((n, v)) < missing] = -1
    return g


def family_cohort(seed, families=6, size=8, v=1500, carrier_rate=0.08,
                  mutation_rate=0.03):
    """Planted relatives: founder carrier sets cloned into families with
    a few percent of entries resampled, so LSH proposes a real subset
    of the pairs."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(families):
        founder = (rng.random(v) < carrier_rate).astype(np.int8) * (
            1 + (rng.random(v) < 0.3).astype(np.int8))
        for _ in range(size):
            g = founder.copy()
            mut = rng.random(v) < mutation_rate
            g[mut] = (rng.random(mut.sum()) < carrier_rate) * (
                1 + (rng.random(mut.sum()) < 0.3)).astype(np.int8)
            rows.append(g)
    g = np.asarray(rows, np.int8)
    g[rng.random(g.shape) < 0.02] = -1
    return g


def _tjob(bv=256, **compute):
    compute.setdefault("metric", "ibs")
    return tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=bv),
        compute=tconfig.ComputeConfig(device="cpu", **compute))


def _jjob(bv=256, **compute):
    compute.setdefault("metric", "ibs")
    return jconfig.JobConfig(
        ingest=jconfig.IngestConfig(block_variants=bv),
        compute=jconfig.ComputeConfig(**compute))


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


# ------------------------------------------------------------- MinHash


@pytest.mark.parametrize("hashes,seed", [(128, 0), (32, 7), (5, -3),
                                         (64, 2 ** 40 + 11)])
def test_hash_params_identical_to_jax(hashes, seed):
    a, b = M.hash_params(hashes, seed)
    ja, jb = jminhash.hash_params(hashes, seed)
    assert a.dtype == ja.dtype == np.uint32
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    assert (a & 1).all()


def test_hash_values_equal_uint32_arithmetic():
    """The int64 split-product equals wrapping uint32 multiply-add."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, 64, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 1 << 32, 64, dtype=np.uint32)
    idx = np.concatenate([rng.integers(0, 1 << 32, 500, dtype=np.uint32),
                          np.array([0, 1, 0xFFFFFFFF, 0xFFFFFFFE],
                                   np.uint32)])
    got = M.hash_values(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy(b.astype(np.int64)),
                        torch.from_numpy(idx.astype(np.int64))).numpy()
    with np.errstate(over="ignore"):
        want = a[:, None] * idx[None, :] + b[:, None]
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _jax_signatures(g, bv, hashes=32, seed=0):
    sig, nv = jengine.minhash_signatures(
        _jjob(bv, minhash_hashes=hashes, minhash_bands=8, minhash_seed=seed),
        JArraySource(g), JPhaseTimer())
    return np.asarray(sig), nv


@pytest.mark.parametrize("bv", [64, 256])
def test_signatures_bitwise_equal_jax_across_block_partitions(bv):
    """Block widths are multiples of 8, where the 8 virtual devices of
    the JAX tests (tests/conftest.py) pad no block but the last (a
    padded block shifts the global index of every variant after it)."""
    g = _cohort(5, 12, 700)
    want, want_nv = _jax_signatures(g, bv, seed=9)
    sig, nv = engine.minhash_signatures(
        _tjob(bv, minhash_hashes=32, minhash_bands=8, minhash_seed=9),
        ArraySource(g), PhaseTimer())
    assert sig.dtype == np.uint32 and sig.shape == (12, 32)
    assert nv == want_nv == 700
    np.testing.assert_array_equal(sig, want)
    # The block partition does not move any real variant's index.
    other, _ = _jax_signatures(g, 700, seed=9)
    np.testing.assert_array_equal(sig, other)


def test_update_hash_chunking_is_invisible(monkeypatch):
    g = torch.from_numpy(_cohort(6, 9, 300))
    upd = M.make_update(16, 4, "cpu")
    whole = upd(M.init_state(9, 16, "cpu"), g)
    monkeypatch.setattr(M, "CHUNK_BYTES", 1)  # one hash per step
    steps = upd(M.init_state(9, 16, "cpu"), g)
    assert torch.equal(whole["sig"], steps["sig"])
    assert int(whole["nvar"]) == int(steps["nvar"]) == 300


def test_state_bytes_and_leaves_match_jax():
    assert M.STATE_LEAVES == jminhash.STATE_LEAVES
    assert M.state_bytes(2504, 128) == jminhash.state_bytes(2504, 128)


# ----------------------------------------------------------------- LSH


@pytest.mark.parametrize("bands,cap", [(8, 64), (4, 3), (32, 2)])
def test_candidate_pairs_identical_to_jax(bands, cap):
    rng = np.random.default_rng(bands * 10 + cap)
    # Few distinct values so that bands collide and buckets overflow.
    sig = rng.integers(0, 3, size=(40, 32)).astype(np.uint32)
    got = lsh.candidate_pairs(sig, bands, cap)
    want = jlsh.candidate_pairs(sig, bands, cap)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.int64
    assert got[1:] == want[1:]
    for n in (0, 1, 40):
        assert lsh.filter_fraction(len(got[0]), n) == \
            jlsh.filter_fraction(len(want[0]), n)
    with pytest.raises(ValueError, match="multiple"):
        lsh.candidate_pairs(sig, 5, cap)


# ----------------------------------------------------- exact evaluation


@pytest.mark.parametrize("lookup", [False, True])
@pytest.mark.parametrize("v", [1, 63, 64, 333])
def test_bit_plane_pair_stats_equal_jax_einsum(monkeypatch, v, lookup):
    """Both set-bit counts (numpy's ufunc and the byte lookup table
    taken without it) give JAX's integers."""
    if lookup:
        monkeypatch.setattr(engine, "_BITCOUNT", None)
    g = _cohort(v, 15, v, missing=0.2)
    pairs = np.array([(i, j) for i in range(15) for j in range(i + 1, 15)],
                     np.int64)
    ii, jj = pairs[:, 0].copy(), pairs[:, 1].copy()
    stats = tuple(genotype.CROSS_STATS)
    got = engine._block_pair_stats(g, ii, jj, stats)
    want = jengine._block_pair_stats(g, ii, jj, stats)
    for s in stats:
        assert got[s].dtype == np.int64
        np.testing.assert_array_equal(got[s], want[s], err_msg=s)


def _dense_stats(g, metric):
    """The port's dense int32 statistics of one cohort, as int64: the
    same integer products the gram path accumulates, with the
    per-pair orientations spelled out."""
    acc = gram.update(gram.init(len(g), metric, "cpu"), torch.from_numpy(g),
                      metric)
    st = {k: v.numpy().astype(np.int64)
          for k, v in gram.combine(acc, metric).items()}
    if metric == "king":
        st["hcn"], st["hcr"] = st["hc"], st["hc"].T
    if metric == "jaccard":
        st["sn"], st["sr"] = st["sc"], st["sc"].T
    return st


@pytest.mark.parametrize("metric", ["ibs", "king", "jaccard"])
def test_pair_sims_bitwise_equal_jax_and_dense(metric):
    g = _cohort(17, 24, 700)
    kw = dict(metric=metric, minhash_hashes=32, minhash_bands=32,
              neighbors_output="pairs")
    res = engine.neighbors_job(_tjob(**kw), source=ArraySource(g))
    want = jengine.neighbors_job(_jjob(**kw), source=JArraySource(g))
    assert isinstance(res, PairsResult) and len(res.pairs)
    np.testing.assert_array_equal(res.pairs, want.pairs)
    assert res.sims.dtype == np.float64
    assert res.sims.tobytes() == np.asarray(want.sims).tobytes()
    # A float64 finalize of the port's dense statistics, bit for bit.
    dense = _dense_stats(g, metric)
    ii, jj = res.pairs[:, 0], res.pairs[:, 1]
    oracle = kernels.get(metric).pair.sim(
        {s: dense[s][ii, jj] for s in kernels.get(metric).pair.stats})
    assert res.sims.tobytes() == np.asarray(oracle, np.float64).tobytes()
    # ... and the port's f32 dense finalize to its output precision.
    acc = gram.update(gram.init(len(g), metric, "cpu"), torch.from_numpy(g),
                      metric)
    f32 = distances.finalize(acc, metric)["similarity"].numpy()
    np.testing.assert_allclose(res.sims, f32[ii, jj], rtol=1e-6, atol=1e-6)


def test_topk_reductions_equal_jax():
    rng = np.random.default_rng(8)
    sims = np.round(rng.random((5, 9)), 1)  # ties
    for k in (1, 4, 20):
        got, want = engine.topk_rows(sims, k), jengine.topk_rows(sims, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    pairs = np.array([(0, 1), (0, 2), (1, 2), (2, 4)], np.int64)
    psims = np.array([0.5, 0.5, 0.9, 0.1])
    got = engine.topk_from_pairs(pairs, psims, 6, 2)
    want = jengine.topk_from_pairs(pairs, psims, 6, 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0][3] == -1).all() and (got[0][5] == -1).all()


def test_topk_job_equals_jax_on_planted_families():
    g = family_cohort(21)
    kw = dict(minhash_hashes=64, minhash_bands=16, neighbors_k=5)
    res = engine.neighbors_job(_tjob(**kw), source=ArraySource(g))
    want = jengine.neighbors_job(_jjob(**kw), source=JArraySource(g))
    assert isinstance(res, TopKResult)
    np.testing.assert_array_equal(res.ids, want.ids)
    assert res.sims.tobytes() == np.asarray(want.sims).tobytes()
    pairs = telemetry.counter_value("neighbors.candidate_pairs")
    n = len(g)
    assert 0 < pairs < n * (n - 1) / 2
    assert telemetry.counter_value("neighbors.evaluated_pairs") == pairs
    snap = telemetry.metrics_snapshot()
    assert snap["gauges"]["neighbors.filter_frac"]["last"] == \
        jlsh.filter_fraction(int(pairs), n)
    # Each sample's nearest neighbors are its family.
    fam = np.arange(n) // 8
    assert (fam[res.ids[:, :5]] == fam[:, None]).mean() > 0.9


def test_metric_without_pair_finalize_is_rejected():
    g = _cohort(2, 8, 256)
    with pytest.raises(ValueError, match="pairwise finalize"):
        engine.neighbors_job(_tjob(metric="euclidean"), source=ArraySource(g))
    assert kernels.pairable_names() == ("ibs", "king", "jaccard")


# --------------------------------------------------------------- files


def _topk(mod):
    return mod.TopKResult(
        ids=np.array([[1, 2], [0, -1]], np.int32),
        sims=np.array([[0.9, 0.5], [0.9, 0.0]], np.float64),
        sample_ids=("a", "b"), metric="ibs", k=2, n_variants=77)


def _pairs(mod):
    return mod.PairsResult(
        pairs=np.array([[0, 1], [1, 2]], np.int64),
        sims=np.array([0.25, 0.75]),
        sample_ids=("a", "b", "c"), metric="jaccard", n_variants=5)


@pytest.mark.parametrize("make", [_topk, _pairs])
def test_files_byte_equal_across_packages_both_ways(tmp_path, make):
    tpath, jpath = str(tmp_path / "port.nb"), str(tmp_path / "jax.nb")
    save_result(tpath, make(toutput))
    joutput.save_result(jpath, make(joutput))
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        assert ft.read() == fj.read()
    kind = make(toutput).kind
    got = load_result(jpath, expect_kind=kind)  # the port reads JAX's
    back = joutput.load_result(tpath, expect_kind=kind)  # and vice versa
    for name in ("sims", "ids" if kind == "topk" else "pairs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(back, name))
    assert got.sample_ids == back.sample_ids and got.k == back.k
    assert not [p for p in os.listdir(tmp_path) if "tmp" in p]


def test_format_error_ladder(tmp_path):
    path = str(tmp_path / "r.topk")
    save_result(path, _topk(toutput))
    with open(path, "rb") as f:
        header, payload = f.read().split(b"\n", 1)
    doc = json.loads(header)

    def write(doc2, body=payload, name="bad"):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(json.dumps(doc2).encode() + b"\n" + body)
        return p

    with pytest.raises(NeighborFormatError, match="cannot read"):
        load_result(str(tmp_path / "missing"))
    with pytest.raises(NeighborFormatError, match="unparseable header"):
        load_result(_raw(tmp_path, b"\xff\xfe\n"))
    with pytest.raises(NeighborFormatError, match="format tag"):
        load_result(write(dict(doc, format="something-else")))
    with pytest.raises(NeighborFormatError, match="schema_version"):
        load_result(write(dict(doc, schema_version=99)))
    with pytest.raises(NeighborFormatError, match="missing field"):
        load_result(write({k: v for k, v in doc.items() if k != "k"}))
    with pytest.raises(NeighborFormatError, match="unknown neighbors"):
        load_result(write(dict(doc, kind="heap")))
    with pytest.raises(NeighborFormatError,
                       match="--neighbors-output pairs"):
        load_result(path, expect_kind="pairs")
    bad_arrays = [dict(a, dtype="<f4") for a in doc["arrays"]]
    with pytest.raises(NeighborFormatError, match="schema drift"):
        load_result(write(dict(doc, arrays=bad_arrays)))
    with pytest.raises(NeighborFormatError, match="truncated"):
        load_result(write(doc, body=payload[:-4]))
    with pytest.raises(NeighborFormatError, match="trailing"):
        load_result(write(doc, body=payload + b"xx"))


def _raw(tmp_path, data: bytes) -> str:
    p = str(tmp_path / "raw")
    with open(p, "wb") as f:
        f.write(data)
    return p


# --------------------------------------------------------- checkpoints


class _Dying(ArraySource):
    def blocks(self, bv, start_variant=0):
        for i, item in enumerate(super().blocks(bv, start_variant)):
            if i == 5:
                raise RuntimeError("simulated preemption")
            yield item


class _JDying(JArraySource):
    def blocks(self, bv, start_variant=0):
        for i, item in enumerate(super().blocks(bv, start_variant)):
            if i == 5:
                raise RuntimeError("simulated preemption")
            yield item


def _ck(**kw):
    return dict(minhash_hashes=32, minhash_bands=8, minhash_seed=5, **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_minhash_checkpoint_resumes_across_packages(tmp_path, writer):
    g = _cohort(31, 14, 1000)
    clean, _ = _jax_signatures(g, 128, seed=5)
    d = str(tmp_path / "ck")
    tjob = _tjob(128, checkpoint_dir=d, checkpoint_every_blocks=2, **_ck())
    jjob = _jjob(128, checkpoint_dir=d, checkpoint_every_blocks=2, **_ck())
    with pytest.raises(RuntimeError, match="preemption"):
        if writer == "jax":
            jengine.minhash_signatures(jjob, _JDying(g), JPhaseTimer())
        else:
            engine.minhash_signatures(tjob, _Dying(g), PhaseTimer())
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["metric"] == engine.METRIC_TAG == jengine.METRIC_TAG
    assert man["next_variant"] == 512
    assert man["extra"] == {"solver": "minhash", "hashes": 32, "bands": 8,
                            "seed": 5}
    for leaf in M.STATE_LEAVES:
        assert np.load(os.path.join(d, f"{leaf}.npy")).dtype == np.uint32
    if writer == "jax":
        sig, nv = engine.minhash_signatures(tjob, ArraySource(g),
                                            PhaseTimer())
    else:
        sig, nv = jengine.minhash_signatures(jjob, JArraySource(g),
                                             JPhaseTimer())
    assert nv == 1000
    np.testing.assert_array_equal(np.asarray(sig), clean)


def test_minhash_checkpoint_leaf_files_equal_jax(tmp_path):
    g = _cohort(32, 10, 800)
    files = {}
    for who in ("jax", "port"):
        d = str(tmp_path / who)
        with pytest.raises(RuntimeError, match="preemption"):
            if who == "jax":
                jengine.minhash_signatures(
                    _jjob(128, checkpoint_dir=d, checkpoint_every_blocks=2,
                          **_ck()), _JDying(g), JPhaseTimer())
            else:
                engine.minhash_signatures(
                    _tjob(128, checkpoint_dir=d, checkpoint_every_blocks=2,
                          **_ck()), _Dying(g), PhaseTimer())
        files[who] = {f: open(os.path.join(d, f), "rb").read()
                      for f in os.listdir(d) if f.endswith(".npy")}
    assert files["port"] == files["jax"]


def test_minhash_checkpoint_of_another_seed_is_refused(tmp_path):
    g = _cohort(33, 10, 800)
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="preemption"):
        engine.minhash_signatures(
            _tjob(128, checkpoint_dir=d, checkpoint_every_blocks=2, **_ck()),
            _Dying(g), PhaseTimer())
    kw = _ck()
    kw["minhash_seed"] = 6
    with pytest.raises(ValueError, match="settings"):
        engine.minhash_signatures(_tjob(128, checkpoint_dir=d, **kw),
                                  ArraySource(g), PhaseTimer())


# -------------------------------------------------------------- faults


def test_candidates_io_error_recovers_bit_identically():
    g = _cohort(40, 20, 768)
    job = _tjob(minhash_hashes=32, minhash_bands=16, neighbors_k=5)
    clean = engine.neighbors_job(job, source=ArraySource(g))
    with faults.armed(["neighbors.candidates:io_error:after=1:max=2"]):
        with pytest.warns(RuntimeWarning, match="recomputing"):
            faulted = engine.neighbors_job(job, source=ArraySource(g))
        assert faults.fire_count("neighbors.candidates") == 2
    np.testing.assert_array_equal(faulted.ids, clean.ids)
    assert faulted.sims.tobytes() == clean.sims.tobytes()


def test_candidates_io_error_exhausts_budget():
    g = _cohort(41, 12, 512)
    job = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=256, io_retries=1,
                                    io_retry_backoff_s=0.0),
        compute=tconfig.ComputeConfig(metric="ibs", device="cpu",
                                      minhash_hashes=32, minhash_bands=16))
    with faults.armed(["neighbors.candidates:io_error:max=0"]):
        with pytest.warns(RuntimeWarning, match="attempt 1/1"):
            with pytest.raises(IOError):
                engine.neighbors_job(job, source=ArraySource(g))


# ----------------------------------------------------------------- CLI


@pytest.mark.parametrize("output", ["topk", "pairs"])
def test_cli_cohort_file_byte_equal_jax_cli(tmp_path, capsys, output):
    from spark_examples_tpu.cli.main import main as jmain
    from spark_examples_tpu_torch.cli.main import main as tmain

    argv = ["neighbors", "--n-samples", "40", "--n-variants", "2000",
            "--block-variants", "512", "--metric", "ibs",
            "--minhash-hashes", "32", "--minhash-bands", "8",
            "--neighbors-k", "4", "--neighbors-output", output]
    tpath, jpath = str(tmp_path / "t.nb"), str(tmp_path / "j.nb")
    assert jmain(argv + ["--output-path", jpath]) == 0
    jout = capsys.readouterr().out
    assert tmain(argv + ["--device", "cpu", "--output-path", tpath]) == 0
    tout = capsys.readouterr().out
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        assert ft.read() == fj.read()
    assert tout.replace(tpath, "X") == jout.replace(jpath, "X")


def test_cli_rejects_bad_knobs_by_name(capsys):
    from spark_examples_tpu_torch.cli.main import main as tmain

    with pytest.raises(SystemExit):
        tmain(["neighbors", "--device", "cpu", "--minhash-hashes", "10",
               "--minhash-bands", "3"])
    err = capsys.readouterr().err
    assert "--minhash-hashes=10" in err and "--minhash-bands=3" in err
    for kw, flag in ((dict(neighbors_output="csv"), "--neighbors-output"),
                     (dict(neighbors_k=0), "--neighbors-k"),
                     (dict(minhash_bucket_cap=0), "--minhash-bucket-cap")):
        with pytest.raises(ValueError, match=flag):
            tconfig.ComputeConfig(**kw)
    with pytest.raises(SystemExit):
        tmain(["neighbors", "--device", "cpu", "--model", "m.npz"])
    assert "neighbors --model requires --ref-path" in \
        capsys.readouterr().err


def test_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=256),
        compute=tconfig.ComputeConfig(metric="ibs"))
    with pytest.raises(RuntimeError, match="--device cuda"):
        engine.neighbors_job(job, source=ArraySource(_cohort(3, 8, 300)))


# ------------------------------------------------- neighbors --model

def _panel_and_queries(tmp_path, seed=13, n=30, q=11, v=700):
    """A packed panel store, a packed query store holding two panel
    samples among random ones, and the panel's ids."""
    from spark_examples_tpu_torch.ingest.packed import save_packed

    panel = _cohort(seed, n, v)
    queries = _cohort(seed + 1, q, v)
    queries[2], queries[7] = panel[5], panel[19]
    save_packed(str(tmp_path / "panel"), panel)
    save_packed(str(tmp_path / "queries"), queries,
                [f"Q{i}" for i in range(q)])
    return panel, queries


@pytest.mark.parametrize("metric", ["ibs", "jaccard"])
def test_cli_model_mode_file_byte_equal_jax_cli(tmp_path, capsys, metric):
    from spark_examples_tpu.cli.main import main as jmain
    from spark_examples_tpu_torch.cli.main import main as tmain

    _panel_and_queries(tmp_path)
    model = str(tmp_path / "m.npz")
    assert tmain(["pcoa", "--device", "cpu", "--source", "packed",
                  "--path", str(tmp_path / "panel"), "--metric", metric,
                  "--num-pc", "3", "--block-variants", "256",
                  "--save-model", model]) == 0
    capsys.readouterr()
    argv = ["neighbors", "--model", model, "--ref-source", "packed",
            "--ref-path", str(tmp_path / "panel"), "--source", "packed",
            "--path", str(tmp_path / "queries"), "--block-variants", "128",
            "--neighbors-k", "4"]
    tpath, jpath = str(tmp_path / "t.nb"), str(tmp_path / "j.nb")
    assert jmain(argv + ["--output-path", jpath]) == 0
    jout = capsys.readouterr().out
    assert tmain(argv + ["--device", "cpu", "--output-path", tpath]) == 0
    tout = capsys.readouterr().out
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        assert ft.read() == fj.read()
    assert tout.replace(tpath, "X") == jout.replace(jpath, "X")
    res = load_result(tpath)
    assert res.ids[2, 0] == 5 and res.sims[2, 0] == 1.0
    assert res.ids[7, 0] == 19 and res.sims[7, 0] == 1.0
    assert res.sample_ids[0] == "Q0" and res.ids.shape == (11, 4)


def test_model_mode_sims_are_the_pair_finalize_of_cross_stats(tmp_path):
    """Every top-k similarity is bitwise the metric's pair finalize of
    the query-vs-panel int32 cross statistics."""
    from spark_examples_tpu_torch.pipelines.project import load_model
    from spark_examples_tpu_torch.serve import engine as E

    panel, queries = _panel_and_queries(tmp_path)
    model = str(tmp_path / "m.npz")
    from spark_examples_tpu_torch.pipelines.jobs import pcoa_job

    pcoa_job(tconfig.JobConfig(
        ingest=tconfig.IngestConfig(block_variants=256),
        compute=tconfig.ComputeConfig(metric="ibs", num_pc=3,
                                      device="cpu"),
        model_path=model), source=ArraySource(panel))
    ctx = E.ModelContext(load_model(model), "cpu")
    blocks, v, _ = E.stage_blocks(ArraySource(panel), 200, "cpu")
    ids, sims = E.batch_topk(ctx, blocks, queries[:5], 8, v, 30)
    spec = kernels.get("ibs").pair
    acc = genotype.cross_stats(torch.from_numpy(queries[:5]),
                               torch.from_numpy(panel), spec.stats)
    full = spec.sim({k: t.numpy().astype(np.int64) for k, t in acc.items()})
    np.testing.assert_array_equal(sims, np.take_along_axis(full, ids, 1))


def test_cli_model_mode_refuses_pca_models_like_jax(tmp_path, capsys):
    from spark_examples_tpu.cli.main import main as jmain
    from spark_examples_tpu_torch.cli.main import main as tmain

    _panel_and_queries(tmp_path)
    model = str(tmp_path / "pca.npz")
    assert tmain(["pca", "--device", "cpu", "--source", "packed",
                  "--path", str(tmp_path / "panel"), "--num-pc", "3",
                  "--block-variants", "256", "--save-model", model]) == 0
    capsys.readouterr()
    argv = ["neighbors", "--model", model, "--ref-source", "packed",
            "--ref-path", str(tmp_path / "panel"), "--source", "packed",
            "--path", str(tmp_path / "queries")]
    errs = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        with pytest.raises(SystemExit):
            main(argv + extra)
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert "topk serving needs a metric-bearing (pcoa) model" in errs[1]
    assert errs[0].split("error: ")[1] == errs[1].split("error: ")[1]
    with pytest.raises(SystemExit):
        tmain(argv + ["--device", "cpu", "--maf", "0.1"])
    assert "cannot apply during query-vs-panel neighbors" in \
        capsys.readouterr().err


def test_model_mode_on_cuda_without_a_card_raises(monkeypatch, tmp_path):
    from spark_examples_tpu_torch.cli.main import main as tmain

    _panel_and_queries(tmp_path)
    model = str(tmp_path / "m.npz")
    assert tmain(["pcoa", "--device", "cpu", "--source", "packed",
                  "--path", str(tmp_path / "panel"), "--num-pc", "3",
                  "--block-variants", "256", "--save-model", model]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tmain(["neighbors", "--model", model, "--ref-path",
               str(tmp_path / "panel"), "--source", "packed", "--path",
               str(tmp_path / "queries")])
