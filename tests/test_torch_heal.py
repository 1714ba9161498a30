"""The port's store damage handling against the JAX package's, on the
CPU: a flipped byte, a truncated chunk (on disk or through the
``store.read`` fault site) and a missing chunk give the same quarantine
ledger and the same ``store heal`` report as JAX, and after the heal the
store's bytes are equal. Then the port's own self-healing cases
(tests/test_heal.py): origin re-compaction and replica copy inline on a
read, the offline ``store heal`` verb, and the atomic ledger."""

import json
import os
import shutil
import threading
import warnings

import numpy as np
import pytest

from spark_examples_tpu import store as jstore
from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import faults as jfaults
from spark_examples_tpu.pipelines import runner as jrunner
from spark_examples_tpu.store import heal as jheal
from spark_examples_tpu_torch.cli.main import main as tmain
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import IngestConfig
from spark_examples_tpu_torch.core.hashing import sha256_file
from spark_examples_tpu_torch.pipelines import runner
from spark_examples_tpu_torch.store import quarantine as qledger
from spark_examples_tpu_torch.store.heal import (
    HealError,
    build_origin_source,
    heal,
    heal_chunk,
    origin_from_ingest,
)
from spark_examples_tpu_torch.store.manifest import (
    StoreCorruptError,
    StoreManifest,
)
from spark_examples_tpu_torch.store.reader import open_store
from spark_examples_tpu_torch.store.writer import compact

N, V, CHUNK = 48, 2048, 512


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture
def origin_cfg():
    return IngestConfig(source="synthetic", n_samples=N, n_variants=V,
                        seed=3, block_variants=CHUNK)


@pytest.fixture
def healable_store(tmp_path, origin_cfg):
    """A store compacted with its origin recorded."""
    store = str(tmp_path / "store")
    compact(store, runner.build_source(origin_cfg, "cpu"),
            chunk_variants=CHUNK,
            origin=origin_from_ingest(origin_cfg, CHUNK))
    return store


def _clean(store):
    return open_store(store).read_range(0, V).copy()


def _truncate_chunk(store, idx, keep=5):
    m = StoreManifest.load(store)
    with open(os.path.join(store, m.chunks[idx].filename()), "r+b") as f:
        f.truncate(keep)
    return m.chunks[idx]


def _damage(store, idx, how):
    rec = StoreManifest.load(store).chunks[idx]
    path = os.path.join(store, rec.filename())
    if how == "missing":
        os.remove(path)
    elif how == "truncate":
        _truncate_chunk(store, idx)
    else:
        raw = bytearray(open(path, "rb").read())
        raw[7] ^= 0x40
        open(path, "wb").write(bytes(raw))


# ------------------------------------------------------ against the JAX package

@pytest.fixture(params=["raw", "zlib", "zlib-dict"])
def twin_stores(request, tmp_path):
    """Two copies of one JAX-compacted store with its origin: one for
    each package to damage, read and heal."""
    kw = dict(source="synthetic", n_samples=N, n_variants=V, seed=3,
              block_variants=CHUNK)
    jcfg = jconfig.IngestConfig(**kw)
    base = str(tmp_path / "base")
    jstore.compact(base, jrunner.build_source(jcfg), chunk_variants=CHUNK,
                   codec=request.param,
                   origin=jstore.origin_from_ingest(jcfg, CHUNK))
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(base, a)
    shutil.copytree(base, b)
    return base, a, b


@pytest.mark.parametrize("how", ["truncate", "bitflip", "missing"])
def test_damage_gives_jax_ledger_report_and_bytes(twin_stores, how):
    base, tdir, jdir = twin_stores
    for d in (tdir, jdir):
        _damage(d, 2, how)
    with pytest.raises(StoreCorruptError) as got:
        open_store(tdir, auto_heal=False).read_range(0, V)
    with pytest.raises(jstore.StoreCorruptError) as want:
        jstore.open_store(jdir, auto_heal=False).read_range(0, V)
    # JAX's message also names its checkpoints, which the port lacks.
    assert str(want.value).startswith(str(got.value))
    assert got.value.cursor == want.value.cursor == 2 * CHUNK
    assert tree(tdir)["quarantine.json"] == tree(jdir)["quarantine.json"]
    assert heal(tdir, device="cpu") == jheal.heal(jdir)
    assert tree(tdir) == tree(jdir) == tree(base)


def test_fault_site_truncate_gives_jax_ledger(twin_stores):
    """The ``store.read`` truncate spec (after=2: the third chunk read)
    quarantines the same chunk with the same ledger in both packages."""
    base, tdir, jdir = twin_stores
    spec = ["store.read:truncate:after=2:keep=4"]
    with faults.armed(spec), pytest.raises(StoreCorruptError) as got:
        for _ in open_store(tdir, auto_heal=False).blocks(CHUNK):
            pass
    with jfaults.armed(spec), pytest.raises(jstore.StoreCorruptError):
        for _ in jstore.open_store(jdir, auto_heal=False).blocks(CHUNK):
            pass
    assert got.value.cursor == 2 * CHUNK
    assert "start_variant=1024" in str(got.value)
    assert tree(tdir)["quarantine.json"] == tree(jdir)["quarantine.json"]
    report = heal(tdir, verify_all=True, device="cpu")
    assert report == jheal.heal(jdir, verify_all=True)
    assert [h["how"] for h in report["healed"]] == ["origin"]
    assert tree(tdir) == tree(jdir) == tree(base)


def test_heal_from_a_jax_replica(twin_stores):
    base, tdir, jdir = twin_stores
    _damage(tdir, 1, "bitflip")
    want = jstore.open_store(jdir).read_range(0, V)
    with pytest.warns(RuntimeWarning, match="healed in place from replica"):
        got = open_store(tdir, replicas=(jdir,)).read_range(0, V)
    np.testing.assert_array_equal(got, want)
    assert tree(tdir) == tree(base)


# ------------------------------------------------- the port's own heal cases

def test_origin_roundtrip_and_absolute_path(origin_cfg):
    rec = origin_from_ingest(origin_cfg, CHUNK)
    assert rec["source"] == "synthetic" and rec["chunk_variants"] == CHUNK
    assert rec == jstore.origin_from_ingest(
        jconfig.IngestConfig(source="synthetic", n_samples=N, n_variants=V,
                             seed=3, block_variants=CHUNK), CHUNK)
    assert list(rec) == list(jstore.origin_from_ingest(
        jconfig.IngestConfig(), CHUNK))
    src = build_origin_source(rec, "cpu")
    assert (src.n_samples, src.n_variants) == (N, V)
    rel = origin_from_ingest(IngestConfig(source="packed",
                                          path="rel/cohort"), CHUNK)
    assert os.path.isabs(rel["path"])
    assert rel["path"].endswith(os.path.join("rel", "cohort"))


def test_origin_source_runs_on_the_device_it_is_given(origin_cfg,
                                                      monkeypatch):
    """No probe for a card: the origin is rebuilt on the caller's device
    (LD pruning's r^2 runs there), even where a card is visible, and the
    default (cuda) fails without one instead of moving to the CPU."""
    import torch

    rec = origin_from_ingest(
        IngestConfig(source="synthetic", n_samples=N, n_variants=V, seed=3,
                     ld_r2=0.5), CHUNK)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        src = build_origin_source(rec, "cpu")
    assert src.device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cuda"):
            build_origin_source(rec)


def test_store_heal_device_defaults_to_cuda(healable_store):
    """``store heal`` takes ``--device`` like every job; an origin heal
    without a card fails through the device check."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the refusal needs a host without a card")
    _truncate_chunk(healable_store, 2)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tmain(["store", "heal", "--path", healable_store, "--verify-all"])
    with pytest.raises(RuntimeError, match="--device cuda"):
        open_store(healable_store).read_range(0, V)


def test_corrupt_chunk_heals_from_origin_in_stream(healable_store):
    want = _clean(healable_store)
    _truncate_chunk(healable_store, 1)
    before = telemetry.counter_value("store.healed")
    with pytest.warns(RuntimeWarning, match="healed in place from origin"):
        got = open_store(healable_store, device="cpu").read_range(0, V)
    np.testing.assert_array_equal(got, want)
    assert telemetry.counter_value("store.healed") == before + 1
    assert qledger.load(healable_store) == []
    rec = StoreManifest.load(healable_store).chunks[1]
    assert sha256_file(
        os.path.join(healable_store, rec.filename())) == rec.digest


def test_injected_truncate_heals_under_fault_harness(healable_store):
    want = _clean(healable_store)
    with faults.armed(["store.read:truncate:after=2:max=1:keep=4"]):
        with pytest.warns(RuntimeWarning, match="healed in place"):
            got = open_store(healable_store, device="cpu").read_range(0, V)
    np.testing.assert_array_equal(got, want)


def test_missing_chunk_heals_from_replica(healable_store, tmp_path):
    want = _clean(healable_store)
    replica = str(tmp_path / "replica")
    shutil.copytree(healable_store, replica)
    rec = StoreManifest.load(healable_store).chunks[2]
    os.remove(os.path.join(healable_store, rec.filename()))
    with pytest.warns(RuntimeWarning, match="healed in place from replica"):
        got = open_store(healable_store,
                         replicas=(replica,)).read_range(0, V)
    np.testing.assert_array_equal(got, want)


def test_store_replicas_threaded_through_config(healable_store, tmp_path):
    want = _clean(healable_store)
    replica = str(tmp_path / "rep")
    shutil.copytree(healable_store, replica)
    _truncate_chunk(healable_store, 1)
    cfg = IngestConfig(source="store", path=healable_store,
                       block_variants=CHUNK, store_replicas=[replica])
    src = runner.build_source(cfg, "cpu")
    with pytest.warns(RuntimeWarning, match="healed in place from replica"):
        got = np.concatenate([b for b, _ in src.blocks(CHUNK)], axis=1)
    src.close()
    np.testing.assert_array_equal(got, want)


def test_no_route_quarantines(tmp_path, origin_cfg):
    store = str(tmp_path / "plain")
    compact(store, runner.build_source(origin_cfg, "cpu"),
            chunk_variants=CHUNK)
    assert StoreManifest.load(store).origin is None
    _truncate_chunk(store, 1)
    with pytest.raises(StoreCorruptError, match="resume"):
        open_store(store).read_range(0, V)
    assert len(qledger.load(store)) == 1


def test_changed_origin_refuses_wrong_bytes(healable_store):
    path = os.path.join(healable_store, "manifest.json")
    raw = json.load(open(path))
    raw["origin"]["seed"] = 999
    with open(path, "w") as f:
        json.dump(raw, f)
    _truncate_chunk(healable_store, 0)
    with pytest.raises(StoreCorruptError, match="heal failed"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            open_store(healable_store, device="cpu").read_range(0, V)
    assert len(qledger.load(healable_store)) == 1


def test_heal_chunk_no_route_raises(healable_store):
    m = StoreManifest.load(healable_store)
    m.origin = None
    with pytest.raises(HealError, match="no replica"):
        heal_chunk(healable_store, m, m.chunks[0])


def test_heal_verb_repairs_ledger_and_verify_all(healable_store):
    want = _clean(healable_store)
    _truncate_chunk(healable_store, 1)
    with pytest.raises(StoreCorruptError):
        open_store(healable_store, auto_heal=False).read_range(0, V)
    assert len(qledger.load(healable_store)) == 1
    _truncate_chunk(healable_store, 3)
    report = heal(healable_store, verify_all=True, device="cpu")
    assert report["damaged"] == 2 and not report["failed"]
    assert sorted(h["how"] for h in report["healed"]) == ["origin", "origin"]
    assert qledger.load(healable_store) == []
    np.testing.assert_array_equal(_clean(healable_store), want)


def test_heal_verifies_bytes_before_trusting_ledger(healable_store):
    rec = StoreManifest.load(healable_store).chunks[1]
    path = os.path.join(healable_store, rec.filename())
    good = open(path, "rb").read()
    _truncate_chunk(healable_store, 1)
    with pytest.raises(StoreCorruptError):
        open_store(healable_store, auto_heal=False).read_range(0, V)
    with open(path, "wb") as f:
        f.write(good)
    report = heal(healable_store)
    assert report["failed"] == [] and report["damaged"] == 0
    assert [h["how"] for h in report["healed"]] == ["already-intact"]
    assert qledger.load(healable_store) == []


def test_heal_clears_stale_ledger_entries(healable_store):
    qledger.record(healable_store, {"digest": "gone" * 16, "chunk": 0})
    report = heal(healable_store)
    assert report["stale_cleared"] == 1 and report["damaged"] == 0
    assert qledger.load(healable_store) == []


def test_store_heal_cli(healable_store, capsys):
    _truncate_chunk(healable_store, 2)
    with pytest.raises(StoreCorruptError):
        open_store(healable_store, auto_heal=False).read_range(0, V)
    assert tmain(["store", "heal", "--path", healable_store,
                  "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert report["healed"] and not report["failed"]
    np.testing.assert_array_equal(
        _clean(healable_store), open_store(healable_store).read_range(0, V))


def test_store_heal_cli_replica_and_unhealable(tmp_path, origin_cfg,
                                               capsys):
    store = str(tmp_path / "plain")
    compact(store, runner.build_source(origin_cfg, "cpu"),
            chunk_variants=CHUNK)
    replica = str(tmp_path / "rep")
    shutil.copytree(store, replica)
    _truncate_chunk(store, 0)
    with pytest.raises(StoreCorruptError):
        open_store(store).read_range(0, V)
    assert tmain(["store", "heal", "--path", store]) == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert report["failed"] and "no replica" in report["failed"][0]["error"]
    assert tmain(["store", "heal", "--path", store, "--replica",
                  replica]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert report["healed"][0]["how"] == f"replica:{replica}"


def test_quarantine_record_is_idempotent_and_atomic(tmp_path):
    root = str(tmp_path)
    entry = {"digest": "d1", "chunk": 0, "reason": "x"}
    assert qledger.record(root, entry) is True
    assert qledger.record(root, entry) is False
    assert qledger.record(root, {"digest": "d2"}) is True
    assert {e["digest"] for e in qledger.load(root)} == {"d1", "d2"}
    assert qledger.remove(root, "d1") is True
    assert qledger.remove(root, "d1") is False
    assert qledger.remove(root, "d2") is True
    assert not os.path.exists(os.path.join(root, "quarantine.json"))


def test_quarantine_concurrent_writers_lose_nothing(tmp_path):
    root = str(tmp_path)
    threads = [threading.Thread(target=qledger.record,
                                args=(root, {"digest": f"d{i % 4}"}))
               for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(e["digest"] for e in qledger.load(root)) == \
        ["d0", "d1", "d2", "d3"]


def test_v1_manifest_loads_without_origin(tmp_path, origin_cfg):
    store = str(tmp_path / "v1")
    compact(store, runner.build_source(origin_cfg, "cpu"),
            chunk_variants=CHUNK)
    path = os.path.join(store, "manifest.json")
    raw = json.load(open(path))
    raw["schema_version"] = 1
    del raw["origin"]
    with open(path, "w") as f:
        json.dump(raw, f)
    m = StoreManifest.load(store)
    assert m.origin is None and m.schema_version == 1
    assert open_store(store).read_range(0, 10).shape == (N, 10)
