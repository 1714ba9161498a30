"""``bench_torch.py``'s multichip row and chaos runs on the CPU, at tiny
shapes: the row's tile2d accumulators against the JAX package's
``gram_sharded`` tile2d on the same blocks (bitwise: int32 sums), the
ring bitwise the gather, the record's and the headline's keys against
``bench.py``'s (read from its source: ``bench.py`` is never imported
here, as at import it points JAX's compilation cache into the repo), the
choice of floor, the child's one JSON line, the history record, the K1
launch count worked out for the card, and ``--chaos`` bitwise the clean
streamed run.
"""

import ast
import json
import os
import subprocess

import jax
import numpy as np
import pytest

from spark_examples_tpu.core import meshes as jmeshes
from spark_examples_tpu.parallel import gram_sharded as jgs
from spark_examples_tpu_torch.core import meshes, telemetry, virtual
from spark_examples_tpu_torch.parallel import gram_sharded

import bench_torch as bt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (64, 256, 2)  # samples, variants a block, blocks
SOLVE = (256, 8)


def _bench_py_dict_keys(func: str) -> set[str]:
    """The constant keys of the dict a ``bench.py`` function returns."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


@pytest.fixture(scope="module")
def mc():
    return bt._multichip_measure("cpu", SHAPE, SOLVE)


def test_ring_is_bitwise_the_gather(mc):
    assert mc["ring_identical"] is True
    assert mc["transport_auto"] == "gather"
    assert (mc["slots"], mc["n_slots"], mc["mesh"]) == ("virtual", 8, [2, 4])
    # Three passes (one warm, two timed) of two blocks, eight steps each.
    assert mc["ring_steps"] == 3 * 2 * 8
    # The CPU runs the reference lowering: K1 launches only on the card.
    assert mc["lowering"] == "reference"
    assert mc["k1_launches"] == {"d1": 0, "gather": 0, "ring": 0}
    assert 0.0 <= mc["overlap_frac"] <= 1.0
    assert set(mc["solve_n100k"]["mesh"]) == {"cholqr2_s", "nystrom_s",
                                              "rayleigh_s"}


def test_record_has_every_key_of_jax_s(mc):
    assert _bench_py_dict_keys("_multichip_measure") <= set(mc)


def test_headline_keys_are_jax_s(mc):
    assert set(bt._multichip_headline(mc)) == \
        _bench_py_dict_keys("_multichip_headline")
    assert bt._multichip_headline(mc)["metric"] == "multichip_ibs_gram"


@pytest.mark.parametrize("transport", ["gather", "ring"])
def test_tile2d_accumulators_are_jax_s_bitwise(transport):
    """The row's blocks through the port's tile2d on 8 virtual CPU slots
    and through JAX's on its 8 CPU devices, both (2, 4)."""
    n = SHAPE[0]
    blocks = bt.multichip_blocks(*SHAPE)
    plan = gram_sharded.GramPlan(
        meshes.make_mesh(virtual.virtual_devices(8, "cpu")), "tile2d")
    upd = gram_sharded.make_update(plan, "ibs", packed=True,
                                   transport=transport)
    acc = gram_sharded.init_sharded(plan, n, "ibs")
    for b in blocks:
        acc = upd(acc, b)
    jplan = jgs.GramPlan(jmeshes.make_mesh(jax.devices()[:8], (2, 4)),
                         "tile2d")
    jupd = jgs.make_update(jplan, "ibs", packed=True, transport=transport)
    jacc = jgs.init_sharded(jplan, n, "ibs")
    for b in blocks:
        jacc = jupd(jacc, b.numpy())
    for k, v in jacc.items():
        got = acc[k].full("cpu").numpy() if isinstance(
            acc[k], meshes.Tiled) else acc[k].numpy()
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_the_draw_is_jax_s():
    from spark_examples_tpu_torch.ingest import bitpack

    rng = np.random.default_rng(11)
    g = rng.integers(0, 3, size=(64, 512), dtype=np.int8)
    g[rng.random(g.shape) < 0.01] = -1
    blocks = bt.multichip_blocks(*SHAPE)
    assert [tuple(b.shape) for b in blocks] == [(64, 64), (64, 64)]
    for b, s in zip(blocks, (0, 256)):
        np.testing.assert_array_equal(
            b.numpy(), bitpack.pack_dosages(g[:, s:s + 256]))


@pytest.mark.parametrize("slots,scaling,identical,ok", [
    ("virtual", 0.9, True, True),
    ("virtual", 0.8, True, False),
    ("cards", 0.9, True, False),
    ("cards", 1.2, True, True),
    ("cards", 1.2, False, False),
])
def test_the_floor_is_chosen_by_the_slots(mc, slots, scaling, identical, ok):
    rec = dict(mc, slots=slots, scaling_d8_vs_d1=scaling,
               ring_identical=identical)
    assert bt._multichip_headline(rec)["multichip_ok"] is ok
    assert bt.MULTICHIP_FLOOR == {"cards": 1.0, "virtual": 0.85}


def test_k1_launches_worked_out_for_the_card():
    """(1 warm + 2 timed) passes of 4 blocks on 8 slots: 12 on one slot,
    96 under gather (8 tiles), 768 under ring (8 tiles x 8 steps)."""
    got = bt.multichip_k1_launches(bt.MULTICHIP_SLOTS,
                                   bt.MULTICHIP_CARD[2])
    assert got == {"d1": 12, "gather": 96, "ring": 768}
    assert sum(got.values()) == 876


def test_gather_probe_runs_the_transport_s_all_gather():
    plan = gram_sharded.GramPlan(
        meshes.make_mesh(virtual.virtual_devices(4, "cpu")), "tile2d")
    block = bt.multichip_blocks(16, 60, 1)[0]  # 15 bytes: padded to 16
    probe = gram_sharded.make_gather_probe(plan, 16, 15, packed=True)
    copies = probe(block)
    assert list(copies) == list(plan.mesh.physical)
    (whole,) = copies.values()
    assert tuple(whole.shape) == (16, 16)
    np.testing.assert_array_equal(whole[:, :15].numpy(), block.numpy())
    assert (whole[:, 15] == 0xFF).all()
    with pytest.raises(ValueError, match="gather probe"):
        probe(block[:8])


def test_new_names_are_declared():
    assert telemetry.NAMES["gram.gather_wait_s"][0] == "histogram"
    assert telemetry.NAMES["gram.overlap_frac"][0] == "gauge"


def test_multichip_child_prints_one_json_line(monkeypatch, capsys):
    """The child measures on the bench's device at that device's shapes
    (here the CPU's, cut to the tiny ones) and prints one JSON line."""
    monkeypatch.setattr(bt, "DEVICE", "cpu")
    monkeypatch.setattr(bt, "MULTICHIP_CPU", SHAPE)
    monkeypatch.setattr(bt, "MULTICHIP_SOLVE", SOLVE)
    assert bt.main(["--multichip-child"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ring_identical"] is True and rec["slots"] == "virtual"
    assert (rec["n_samples"], rec["block_variants"], rec["n_blocks"]) == \
        SHAPE
    assert (rec["solve_n100k"]["n"], rec["solve_n100k"]["rank"]) == SOLVE


def test_bench_multichip_runs_the_child_with_no_other_flag(monkeypatch):
    """With fewer than two cards the row is the child's one JSON line,
    run as ``bench_torch.py --multichip-child`` and nothing more."""
    seen = []

    def run(cmd, **kw):
        seen.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, 0, '{"slots": "virtual"}\n',
                                           "log line\n")

    monkeypatch.setattr(bt.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bt.subprocess, "run", run)
    assert bt.bench_multichip() == {"slots": "virtual"}
    ((cmd, kw),) = seen
    assert cmd[1:] == [os.path.join(REPO, "bench_torch.py"),
                       "--multichip-child"]
    assert kw["cwd"] == REPO

    def failed(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 3, "", "boom")

    monkeypatch.setattr(bt.subprocess, "run", failed)
    with pytest.raises(RuntimeError, match="rc=3"):
        bt.bench_multichip()


def _stub_run(monkeypatch, tmp_path):
    monkeypatch.setattr(bt, "DEVICE", "cpu")
    monkeypatch.setattr(bt, "card_meta", lambda: {
        "backend": "cuda", "device": "stub", "card": "stub card, 1.00 W"})
    hist = tmp_path / "hist.jsonl"
    monkeypatch.setattr(bt, "HISTORY_PATH", str(hist))
    monkeypatch.setattr(bt, "DETAIL_PATH", str(tmp_path / "detail.json"))
    return hist


@pytest.mark.parametrize("scaling,rc", [(0.95, 0), (0.5, 1)])
def test_multichip_only_records_its_headline(mc, monkeypatch, tmp_path,
                                             capsys, scaling, rc):
    rec = dict(mc, scaling_d8_vs_d1=scaling)
    monkeypatch.setattr(bt, "bench_multichip", lambda: rec)
    hist = _stub_run(monkeypatch, tmp_path)
    assert bt.main(["--multichip-only"]) == rc
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == bt._multichip_headline(rec)
    assert json.loads(lines[-2])["configs"]["multichip"]["slots"] == \
        "virtual"
    (entry,) = [json.loads(x) for x in hist.read_text().splitlines()]
    assert entry["run"]["card"] == "stub card, 1.00 W"
    assert entry["metrics"]["multichip_ok"] is (rc == 0)


def test_multichip_and_chaos_ride_the_sweep(mc, monkeypatch, tmp_path,
                                            capsys):
    coords = np.arange(6.0).reshape(3, 2)
    calls = []
    monkeypatch.setattr(bt, "default_sweep", lambda args: (
        "STORE", {"metric": "ibs_pcoa_chip_2504x1M"},
        {"_streamed_coords": coords}))
    monkeypatch.setattr(bt, "bench_multichip", lambda: mc)

    def chaos(store, want):
        calls.append((store, want))
        return {"coords_bit_identical": True}

    soak = {"ok": True, "iterations": 25, "healed": 2, "faults_fired": 30,
            "violations": [], "retries": 4, "restarts": 3}
    monkeypatch.setattr(bt, "chaos_streamed", chaos)
    monkeypatch.setattr(bt, "bench_chaos_soak", lambda: soak)
    _stub_run(monkeypatch, tmp_path)
    assert bt.main(["--chaos", "--chaos-soak", "--multichip"]) == 0
    assert calls[0][0] == "STORE" and calls[0][1] is coords
    lines = capsys.readouterr().out.strip().splitlines()
    head = json.loads(lines[-1])
    assert head["metric"] == "ibs_pcoa_chip_2504x1M"
    for k, v in bt._multichip_headline(mc).items():
        if k != "metric":
            assert head[k] == v
    assert {k: head[k] for k in head if k.startswith("chaos")} == {
        "chaos_ok": True, "chaos_soak_ok": True,
        "chaos_soak_iterations": 25, "chaos_soak_healed": 2,
        "chaos_soak_faults_fired": 30}
    assert "_streamed_coords" not in json.loads(lines[-2])["configs"]


def test_chaos_headline_keys_are_jax_s():
    soak = {"ok": False, "iterations": 4, "healed": 0, "faults_fired": 3,
            "violations": ["SOAK-REPRO seed=1 iter=3 spec='s' job=gram: x"]}
    head = bt.chaos_headline({"chaos": {"coords_bit_identical": False},
                              "chaos_soak": soak})
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    jax_keys = set(__import__("re").findall(r'headline\["(chaos[a-z_]*)"\]',
                                            src))
    assert set(head) == jax_keys
    assert head["chaos_soak_repro"].startswith("SOAK-REPRO")
    assert bt.chaos_headline({"chaos_soak": {"error": "x"}}) == {}


def test_chaos_run_is_bitwise_the_clean_run(tmp_path):
    syn = dict(bt.SYN, n_samples=48, n_variants=4096)
    store = bt.cohort_store(str(tmp_path), syn)
    clean = bt.streamed_run(store, block=512, k=3, device="cpu",
                            warm_blocks=1)
    got = bt.chaos_streamed(store, clean["coords"], block=512, k=3,
                            device="cpu")
    assert got["coords_bit_identical"] is True
    assert got["coords_max_abs_diff"] == 0.0
    assert got["fires"]["ingest.block_read"] == 2
    assert got["specs"] == list(bt.CHAOS_SPECS)


def test_chaos_soak_row_is_clean_and_removes_its_workdir(tmp_path):
    rec = bt.bench_chaos_soak(cache=str(tmp_path), device="cpu",
                              iterations=3, include_kill=False)
    assert rec["ok"] and rec["iterations"] == 3
    assert not os.path.exists(tmp_path / "chaos_soak")
    assert bt.CHAOS_SOAK == dict(iterations=25, seed=20260803,
                                 include_kill=True)
