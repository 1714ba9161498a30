"""The benchmark harness's subsystem rows (``bench_torch.py --kernels
--store --serve --fleet --controller --neighbors --neighbors-only
--sketch-serve``) on the CPU, at tiny shapes: each row's record carries
the JAX bench's keys and its CPU gate holds; each flag's headline keys
are those ``bench.py``'s ``main`` writes; the data the JAX bench draws
inline is drawn the same; the kernel sweep's similarities and the store
row's compactions equal the JAX package's; the sketch-serve rig raises on
a dense job; each flag reaches its row.

``bench.py`` is never imported: its functions are read from its source
(``ast``) and, where a draw is compared, its own statements are run under
numpy alone.
"""

import ast
import json
import os
import textwrap
import time

import numpy as np
import pytest
import torch

import bench_torch as bt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Wide enough that each kernel's MB/s and GFLOP/s stay above the 0.1 the
# records round to when the host is loaded.
SYN = dict(bt.SYN, n_samples=128, n_variants=16 * 1024)
BLOCK = 1024
K = 4
# grm's tolerance against the JAX package (tests/test_torch_grm.py).
ZZ_RTOL = 1e-5

# The rows at tiny shapes on the CPU. The controller's burst is heavier
# than the JAX bench's (a replica on the CPU at this panel absorbs 160
# QPS, and the scale-up needs queue pressure).
ROWS = {
    "kernels": lambda store, cache: bt.bench_kernels(
        store, n_variants=16 * BLOCK, block=BLOCK, device="cpu"),
    "store": lambda store, cache: bt.bench_store(
        store, n_variants=2048, chunk=256, block=BLOCK, k=K, device="cpu",
        cache=cache),
    "serve": lambda store, cache: bt.bench_serve(
        store, n_variants=4096, block=BLOCK, k=K, clients=2,
        requests_per_client=4, device="cpu", cache=cache),
    "fleet": lambda store, cache: bt.bench_fleet(
        n=32, nv=1024, block=512, device="cpu", cache=cache),
    "controller": lambda store, cache: bt.bench_controller(
        n=64, nv=1024, block=512, duration_s=2.0, base_qps=400.0,
        device="cpu", cache=cache),
    "neighbors": lambda store, cache: bt.bench_neighbors(
        n=256, nv=1024, device="cpu", cache=cache),
    "sketch_serve": lambda store, cache: bt.bench_sketch_serve(
        n=200, nv=2048, block=512, k=K, requests=3, device="cpu",
        cache=cache),
}
# Each flag and the row it runs.
FLAG_ROWS = {"--kernels": "kernels", "--store": "store", "--serve": "serve",
             "--fleet": "fleet", "--controller": "controller",
             "--neighbors": "neighbors", "--neighbors-only": "neighbors",
             "--sketch-serve": "sketch_serve"}
# The JAX bench's function of each row.
JAX_FUNCS = {"kernels": "bench_kernels", "store": "bench_store",
             "serve": "bench_serve", "fleet": "bench_fleet",
             "controller": "bench_controller",
             "neighbors": "bench_neighbors",
             "sketch_serve": "bench_sketch_serve"}


# ------------------------------------------------------ bench.py's source

@pytest.fixture(scope="module")
def bench_src():
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    return src, ast.parse(src)


def jax_func(bench_src, name) -> ast.FunctionDef:
    return next(n for n in bench_src[1].body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def jax_statement(bench_src, func, first, last=None) -> str:
    """The source of ``bench.py``'s ``func`` from the statement starting
    with ``first`` through the first one from there starting with
    ``last`` (``first``'s alone by default), dedented."""
    src, _ = bench_src
    stmts = sorted((n for n in ast.walk(jax_func(bench_src, func))
                    if isinstance(n, ast.stmt)), key=lambda n: n.lineno)

    def seg(n):
        return ast.get_source_segment(src, n)

    i = next(i for i, n in enumerate(stmts) if seg(n).startswith(first))
    j = next(j for j in range(i, len(stmts))
             if seg(stmts[j]).startswith(last or first))
    lines = src.splitlines()[stmts[i].lineno - 1:stmts[j].end_lineno]
    return textwrap.dedent("\n".join(lines))


def run_jax(code: str, **names) -> dict:
    ns = {"np": np, **names}
    exec(code, ns)  # noqa: S102 — bench.py's own statements, numpy only
    return ns


def jax_record_keys(bench_src, row) -> tuple[set, set]:
    """(the record's keys, the kernel sweep's per-kernel row keys) of the
    JAX row: the string keys of its ``return {...}``, ``out = {...}`` and
    ``row = {...}`` / ``row.update({...})`` literals and of its
    ``out[...] = ...`` stores."""
    fn = jax_func(bench_src, JAX_FUNCS[row])
    top, per = set(), set()

    def keys(d):
        return {k.value for k in d.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}

    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            top |= keys(node.value)
        target = None
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = (node.targets[0] if isinstance(node, ast.Assign)
                      else node.target)
            if isinstance(target, ast.Name) and isinstance(node.value,
                                                           ast.Dict):
                if target.id == "out":
                    top |= keys(node.value)
                elif target.id == "row":
                    per |= keys(node.value)
            if (isinstance(target, ast.Subscript)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "out"
                    and isinstance(target.slice, ast.Constant)):
                top.add(target.slice.value)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "row"):
            per |= keys(node.args[0])
    return top, per


def jax_headline_keys(bench_src, flag) -> set:
    """The headline keys ``bench.py``'s ``main`` writes for ``flag``: the
    ``headline[...]`` stores under ``if "<row>" in configs`` (f-string
    keys expanded over their loop's names), or a standalone mode's
    ``headline = {...}`` under ``if "<flag>" in sys.argv``."""
    main = jax_func(bench_src, "main")

    def tested(node, text):
        return (isinstance(node, ast.If)
                and isinstance(node.test, (ast.BoolOp, ast.Compare))
                and any(isinstance(c, ast.Constant) and c.value == text
                        for c in ast.walk(node.test)))

    if flag in ("--neighbors-only", "--sketch-serve"):
        block = next(n for n in main.body if tested(n, flag))
        first = next(n for n in block.body if isinstance(n, ast.Assign)
                     and getattr(n.targets[0], "id", None) == "headline")
        return {k.value for k in first.value.keys}
    block = next(n for n in main.body
                 if tested(n, FLAG_ROWS[flag])
                 and isinstance(n.test, ast.BoolOp))
    out = set()

    def collect(node, loop):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.For) and isinstance(child.iter,
                                                         ast.Tuple):
                names = [e.value for e in child.iter.elts]
                collect(child, (child.target.id, names))
                continue
            if (isinstance(child, ast.Subscript)
                    and isinstance(child.ctx, ast.Store)
                    and isinstance(child.value, ast.Name)
                    and child.value.id == "headline"):
                key = child.slice
                if isinstance(key, ast.Constant):
                    out.add(key.value)
                elif isinstance(key, ast.JoinedStr):
                    var, names = loop
                    for v in names:
                        out.add("".join(
                            p.value if isinstance(p, ast.Constant) else v
                            for p in key.values))
            collect(child, loop)

    collect(block, None)
    return out


# ------------------------------------------------------------- the rows

@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache_torch"))


@pytest.fixture(scope="module")
def store(cache):
    return bt.cohort_store(cache, SYN)


@pytest.fixture(scope="module")
def records(store, cache):
    return {}


def row_record(records, store, cache, row):
    """The row's record, run once a module. On one intra-op thread: the
    test workers share the host's cores, and torch's CPU pools spinning
    against each other slow a gram phase a thousandfold, so that rates
    round to the 0.0 the sweep's gate refuses."""
    if row not in records:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            records[row] = ROWS[row](store, cache)
        finally:
            torch.set_num_threads(threads)
    return records[row]


CPU_GATES = {
    "kernels": ("kernel_sweep_ok", "kernel_fused_ok"),
    "store": ("store_ok",),
    "serve": ("serve_ok",),
    "fleet": ("fleet_ok", "slo_fast_burn_ok"),
    "controller": ("controller_ok",),
    "neighbors": ("neighbors_ok",),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_row_record_has_jax_keys_and_its_cpu_gate_holds(
        row, records, store, cache, bench_src):
    rec = row_record(records, store, cache, row)
    top, per = jax_record_keys(bench_src, row)
    assert top and top <= set(rec), top - set(rec)
    if row == "kernels":
        import spark_examples_tpu_torch.kernels as kreg

        assert set(rec["per_kernel"]) == set(kreg.gram_names())
        for name, r in rec["per_kernel"].items():
            want = per if name in kreg.fused_names() else {
                k for k in per if not k.startswith("fused_")}
            assert set(r) == want, name
        assert rec["device"] == "cpu"
    # No kernel launches on the CPU: every wrapper ran its plain version.
    assert rec["k1_launches"] == 0
    if row == "sketch_serve":
        assert bt.sketch_serve_headline(rec)["sketch_serve_ok"]
        assert rec["shard_stages"] >= 2 * 3
        return
    headline = bt.add_rows({}, {row: rec})
    for gate in CPU_GATES[row]:
        assert headline[gate] is True, (gate, rec)


@pytest.mark.parametrize("flag", sorted(FLAG_ROWS))
def test_flag_headline_keys_are_the_jax_bench_s(flag, records, store, cache,
                                                bench_src):
    row = FLAG_ROWS[flag]
    rec = row_record(records, store, cache, row)
    if flag == "--neighbors-only":
        got = bt.neighbors_headline(rec)
    elif flag == "--sketch-serve":
        got = bt.sketch_serve_headline(rec)
    else:
        got = bt.add_rows({}, {row: rec})
    assert set(got) == jax_headline_keys(bench_src, flag)


def test_a_row_holding_an_error_adds_no_headline_key():
    assert bt.add_rows({}, {name: {"error": "RuntimeError()"}
                            for name in JAX_FUNCS}) == {}


def test_the_fused_gate_asks_speed_on_the_card_only(records, store, cache):
    rec = row_record(records, store, cache, "kernels")
    slow = {**rec, "per_kernel": {
        k: ({**r, "fused_speedup": 0.5} if "fused_speedup" in r else r)
        for k, r in rec["per_kernel"].items()}}
    assert bt.add_rows({}, {"kernels": slow})["kernel_fused_ok"]
    on_card = bt.add_rows({}, {"kernels": {**slow, "device": "cuda"}})
    assert on_card["kernel_fused_ok"] is False
    assert on_card["kernel_fused_min_speedup"] == 0.5


# ----------------------------------------------- the JAX bench's own draws

@pytest.mark.parametrize("shape", [(32, 256), (1024, 4096)],
                         ids=["tiny", "jax"])
def test_neighbors_cohort_is_the_jax_bench_s(shape, bench_src):
    src, _ = bench_src
    n, v = shape
    ns = run_jax(ast.get_source_segment(
        src, jax_func(bench_src, "_neighbors_cohort")),
        NEIGHBORS_SAMPLES=n, NEIGHBORS_VARIANTS=v)
    want = ns["_neighbors_cohort"]()
    got = bt._neighbors_cohort(n, v)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if shape == (1024, 4096):
        assert np.array_equal(bt._neighbors_cohort(), want)


def _store_draws(bench_src):
    # bench.py:2106-2110
    n, nv = 24, 300
    ns = run_jax(jax_statement(bench_src, "bench_store",
                               "rng = np.random.default_rng(0xFEED)",
                               "g[rng.random((N_SAMPLES, nv))"),
                 N_SAMPLES=n, nv=nv)
    return [ns["g"]], [bt.sfs_genotypes(n, nv)]


def _serve_draws(bench_src):
    # bench.py:1399-1403 (the pool's size is the JAX bench's 8 x 32 + 1)
    nv = 40
    ns = run_jax(jax_statement(bench_src, "bench_serve", "n_queries = ",
                               "queries = np.where("), nv=nv)
    return [ns["queries"]], [bt.serve_queries(8 * 32 + 1, nv)]


def _fleet_panel_draws(bench_src):
    # bench.py:1494-1496, route i of three
    n, nv = 12, 50
    code = jax_statement(bench_src, "bench_fleet",
                         "rng = np.random.default_rng(21 + i)",
                         "g = np.where(")
    want = [run_jax(code, i=i, n=n, nv=nv)["g"] for i in range(3)]
    return want, bt.fleet_panels(n, nv)


def _fleet_query_draws(bench_src):
    # bench.py:1521 and 1524-1525 (one probe a route), 1535-1541 (pools)
    nv = 30
    names = [r[0] for r in bt.FLEET_ROUTES]
    ns = run_jax(jax_statement(bench_src, "bench_fleet",
                               "probe_rng = np.random.default_rng(5)"),
                 nv=nv, panels=dict.fromkeys(names))
    probe = jax_statement(bench_src, "bench_fleet",
                          "q = np.where(probe_rng")
    want = []
    for _ in names:
        exec(probe, ns)  # noqa: S102
        want.append(ns["q"])
    exec(jax_statement(bench_src, "bench_fleet",  # noqa: S102
                       "pool_rng = np.random.default_rng(9)", "pools = {"),
         ns)
    probes, pools = bt.fleet_queries(names, nv)
    assert list(pools) == list(ns["pools"])
    return want + list(ns["pools"].values()), probes + list(pools.values())


def _controller_draws(bench_src):
    # bench.py:1903-1905 (the panel) and 1954-1956 (the pool)
    n, nv = 10, 70
    ns = run_jax(jax_statement(bench_src, "bench_controller",
                               "rng = np.random.default_rng(31)",
                               "g = np.where("), n=n, nv=nv)
    exec(jax_statement(bench_src, "bench_controller",  # noqa: S102
                       "pool_rng = np.random.default_rng(17)",
                       "pool = np.where("), ns)
    return [ns["g"], ns["pool"]], list(bt.controller_queries(n, nv))


def _neighbors_query_draws(bench_src):
    # bench.py:1773-1778
    nv = 33
    ns = run_jax(jax_statement(bench_src, "bench_neighbors",
                               "qrng = np.random.default_rng(7)",
                               "queries = np.where("),
                 nv=nv, n_clients=4, per_client=24)
    got = bt.genotype_draw(np.random.default_rng(7), (4 * 24, nv), 0.02)
    return [ns["queries"]], [got]


def _sketch_serve_draws(bench_src):
    # bench.py:853-856
    nv = 64
    ns = run_jax(jax_statement(bench_src, "bench_sketch_serve",
                               "q_rng = np.random.default_rng(5)",
                               "queries = np.where("),
                 REQUESTS=12, V_SV=nv)
    return [ns["queries"]], [bt.sketch_serve_queries(12, nv)]


@pytest.mark.parametrize("draws", [
    _store_draws, _serve_draws, _fleet_panel_draws, _fleet_query_draws,
    _controller_draws, _neighbors_query_draws, _sketch_serve_draws,
], ids=["store_sfs", "serve_queries", "fleet_panels", "fleet_queries",
        "controller", "neighbors_queries", "sketch_serve_queries"])
def test_inline_draws_are_the_jax_bench_s(draws, bench_src):
    want, got = draws(bench_src)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == np.int8 and w.dtype == np.int8
        assert np.array_equal(g, w)


# ---------------------------------------- the JAX package on the same data

@pytest.mark.parametrize("name", [
    "ibs", "ibs2", "shared-alt", "king", "jaccard", "pc-invariant",
    "euclidean", "dot", "grm"])
def test_kernel_sweep_similarity_matches_the_jax_package(name, store):
    """The sweep's per-kernel job (the reference lowering) against the
    JAX package's ``run_similarity`` on the same packed slice: bitwise
    for the count and dense kernels, grm within its tolerance."""
    from spark_examples_tpu.core import config as jconfig
    from spark_examples_tpu.ingest.packed import load_packed as jload
    from spark_examples_tpu.pipelines import runner as jrunner
    from spark_examples_tpu_torch import kernels as kreg

    assert name in kreg.gram_names()
    n, v = 48, 2 * BLOCK
    got = bt.kernel_similarity(name, "reference",
                               bt._slice_packed(store, v, n), BLOCK, "cpu")
    full = jload(store)
    jsrc = type(full)(packed=np.ascontiguousarray(full.packed[:n, :v // 4]),
                      v=v, ids=full.ids[:n])
    want = jrunner.run_similarity(jconfig.JobConfig(
        ingest=jconfig.IngestConfig(source="packed", block_variants=BLOCK),
        compute=jconfig.ComputeConfig(metric=name,
                                      gram_lowering="reference")),
        source=jsrc)
    assert got.sample_ids == list(want.sample_ids)
    w = np.asarray(want.similarity)
    if name == "grm":
        scale = np.abs(w).max()
        np.testing.assert_allclose(got.similarity, w, rtol=0,
                                   atol=ZZ_RTOL * scale)
    else:
        assert np.array_equal(got.similarity, w)
    if name in kreg.fused_names():
        fused = bt.kernel_similarity(name, "fused",
                                     bt._slice_packed(store, v, n), BLOCK,
                                     "cpu")
        assert np.array_equal(fused.similarity, got.similarity)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("workers", [1, 4])
def test_store_row_compaction_is_the_jax_package_s(workers, tmp_path, store):
    """The store row's compaction (its VCF of SFS-realistic genotypes, its
    chunk grid, 1 and 4 workers) against the JAX package's ``compact`` of
    the same VCF: the same files, byte for byte."""
    from spark_examples_tpu import store as jstore
    from spark_examples_tpu.ingest.vcf import VcfSource as JVcfSource
    from spark_examples_tpu_torch import store as tstore
    from spark_examples_tpu_torch.ingest.packed import load_packed
    from spark_examples_tpu_torch.ingest.vcf import VcfSource, write_vcf

    ids = load_packed(store).sample_ids
    vcf = str(tmp_path / "sfs.vcf")
    write_vcf(vcf, bt.sfs_genotypes(len(ids), 1024), sample_ids=ids)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.compact(jdir, JVcfSource(vcf), chunk_variants=256,
                   workers=workers)
    tstore.compact(tdir, VcfSource(vcf), chunk_variants=256,
                   workers=workers)
    jt, tt = _tree(jdir), _tree(tdir)
    assert sorted(jt) == sorted(tt)
    for rel in jt:
        assert jt[rel] == tt[rel], rel


# ------------------------------------------------- the rig and the link

@pytest.mark.parametrize("job", ["similarity", "pcoa", "pca"])
def test_sketch_serve_rig_raises_on_a_dense_job(job):
    """Every dense job reaches a rigged site through its module's
    attribute (no caller holds its own reference), and the rig comes
    off on exit."""
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig, IngestConfig, JobConfig,
    )
    from spark_examples_tpu_torch.ingest.source import ArraySource
    from spark_examples_tpu_torch.pipelines import jobs

    g = np.random.default_rng(3).integers(0, 3, (16, 512)).astype(np.int8)
    cfg = JobConfig(ingest=IngestConfig(block_variants=256),
                    compute=ComputeConfig(num_pc=2, device="cpu"))
    run = {"similarity": jobs.similarity_matrix_job, "pcoa": jobs.pcoa_job,
           "pca": jobs.variants_pca_job}[job]
    with bt.dense_rigged():
        with pytest.raises(AssertionError, match="N x N allocated"):
            run(cfg, source=ArraySource(g))
    run(cfg, source=ArraySource(g))  # unrigged again


def test_link_model_meters_the_readahead_workers_too(tmp_path):
    """The token bucket replaces ``_stored_bytes`` on the instance after
    the store is opened with its readahead pool: a pass over the store
    takes at least its stored bytes over the link's rate, which it could
    not if a worker read through a method taken before the patch."""
    from spark_examples_tpu_torch.ingest.source import ArraySource
    from spark_examples_tpu_torch.store import compact, open_store

    g = np.random.default_rng(8).integers(0, 3, (32, 4096)).astype(np.int8)
    d = str(tmp_path / "store")
    manifest = compact(d, ArraySource(g), chunk_variants=256, codec="raw")
    stored = sum(c.disk_size(32) for c in manifest.chunks)
    rate_mb_s = stored / 0.4 / 1e6  # an ideal pass of 0.4 s
    st = open_store(d, readahead_chunks=4, readahead_chunks_max=16,
                    device="cpu")
    bt._metered_link(st, rate_mb_s)
    t0 = time.perf_counter()
    for _ in st.blocks(256):
        pass
    took = time.perf_counter() - t0
    st.close()
    assert took >= 0.4 * 0.9


# ------------------------------------------------------------- the wiring

@pytest.mark.parametrize("flag", sorted(FLAG_ROWS))
def test_ported_flags_reach_their_row(flag, records, store, cache,
                                      monkeypatch, tmp_path, capsys):
    """Each ported flag runs its row (replaced here by a stub returning
    the row's CPU record) after the default sweep (stubbed too), and its
    keys reach the headline, the last stdout line, and the history with
    the card."""
    row = FLAG_ROWS[flag]
    rec = row_record(records, store, cache, row)
    calls = []

    def stub(*args, **kw):
        calls.append(args)
        return rec

    monkeypatch.setattr(bt, JAX_FUNCS[row], stub)
    monkeypatch.setattr(bt, "default_sweep", lambda args: (
        "STORE", {"metric": "ibs_pcoa_chip_2504x1M"}, {}))
    monkeypatch.setattr(bt, "DEVICE", "cpu")
    monkeypatch.setattr(bt, "card_meta", lambda: {
        "backend": "cuda", "device": "stub", "card": "stub card, 1.00 W"})
    hist = tmp_path / "hist.jsonl"
    monkeypatch.setattr(bt, "HISTORY_PATH", str(hist))
    monkeypatch.setattr(bt, "DETAIL_PATH", str(tmp_path / "detail.json"))
    assert bt.main([flag]) == 0
    assert len(calls) == 1
    if row in ("serve", "store", "kernels"):
        assert calls[0] == ("STORE",)
    lines = capsys.readouterr().out.strip().splitlines()
    headline = json.loads(lines[-1])
    full = json.loads(lines[-2])
    if flag == "--neighbors-only":
        assert headline == bt.neighbors_headline(rec)
    elif flag == "--sketch-serve":
        assert headline == bt.sketch_serve_headline(rec)
    else:
        assert headline == bt.add_rows(
            {"metric": "ibs_pcoa_chip_2504x1M"}, {row: rec})
        assert full["configs"][row] == json.loads(json.dumps(rec))
    (entry,) = [json.loads(x) for x in hist.read_text().splitlines()]
    assert entry["run"]["card"] == "stub card, 1.00 W"
    assert entry["run"]["argv"] == [flag]


@pytest.mark.parametrize("row", sorted(ROWS))
def test_rows_run_on_the_card_unless_asked(row, store, tmp_path):
    """``device`` defaults to cuda: without a card each row raises,
    naming the missing device, before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    fn = getattr(bt, JAX_FUNCS[row])
    args = (store,) if row in ("serve", "store", "kernels") else ()
    kw = {} if row == "kernels" else {"cache": str(tmp_path / "c")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args, **kw)
    assert not os.path.exists(tmp_path / "c")
