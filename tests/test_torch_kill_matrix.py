"""Kill-resume byte-identity matrix of the port's CLI: {streaming gram,
streaming sketch solve, sketch-saved model, MinHash neighbors, store
compaction, serve hot-reload} x 3 seeded kill points each (the JAX
package's tests/test_kill_matrix.py rows), every run supervised
(core/supervisor.py), so the kill -> restart -> resume cycle is the
production path, and every resumed output compared byte for byte with
the port's uninterrupted run; the gram row also with the JAX CLI's
uninterrupted output.

Every child runs ``python -m spark_examples_tpu_torch ... --device
cpu``: the JAX CLI has no ``--device`` flag and would exit 2 (a usage
error the supervisor does not retry), so a pass proves the port's child
ran.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from spark_examples_tpu_torch.core import faults, supervisor

from conftest import random_genotypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAM_KILL_POINTS = (1, 3, 5)     # ingest.block_read hit the kill lands on
COMPACT_KILL_POINTS = (0, 1, 2)
SERVE_KILL_POINTS = (0, 2, 4)    # serve.request hit
SKETCH_KILL_POINTS = (1, 4, 9)   # pass 0 early, pass 0 late, pass 1
NEIGHBORS_KILL_POINTS = (1, 4, 9)  # minhash early/late, exact-eval pass

PORT = [sys.executable, "-m", "spark_examples_tpu_torch"]
CPU = ["--device", "cpu"]


def _env(**extra):
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    env.update(extra)
    return env


def _clean(argv: list[str]) -> None:
    """The uninterrupted run, in this process through the CLI's main."""
    from spark_examples_tpu_torch.cli.main import main

    assert main(argv) == 0


def _supervised(argv: list[str], kill_spec: str) -> str:
    """``argv`` (a port CLI command) under ``--supervise`` with the kill
    armed through the environment; returns the parent's stderr."""
    p = subprocess.run(PORT + argv + ["--supervise"],
                       env=_env(**{faults.ENV_SPECS: kill_spec}),
                       capture_output=True, text=True, timeout=420)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "supervisor: attempt 0: crash: exit code 113" in p.stderr
    return p.stderr


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def packed_store(tmp_path_factory):
    """One 16 x 1024 packed cohort shared by every matrix surface."""
    from spark_examples_tpu_torch.ingest.packed import save_packed

    rng = np.random.default_rng(1234)
    g = np.abs(random_genotypes(rng, 16, 1024, missing_rate=0.1))
    store = str(tmp_path_factory.mktemp("cohort") / "packed")
    save_packed(store, g)
    return store


# ------------------------------------------------------- streaming gram


def _gram_cmd(store, out, ckpt):
    return ["similarity", "--source", "packed", "--path", store,
            "--block-variants", "128", "--metric", "ibs",
            "--checkpoint-dir", ckpt, "--checkpoint-every-blocks", "2",
            "--output-path", out] + CPU


@pytest.fixture(scope="module")
def gram_clean(packed_store, tmp_path_factory):
    d = tmp_path_factory.mktemp("gram_clean")
    out = str(d / "clean.tsv")
    _clean(_gram_cmd(packed_store, out, str(d / "ck")))
    jout = str(d / "jax.tsv")
    p = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu", "similarity",
         "--source", "packed", "--path", packed_store,
         "--block-variants", "128", "--metric", "ibs",
         "--output-path", jout],
        env=_env(), capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    return _read(out), _read(jout)


@pytest.mark.parametrize("kill_after", GRAM_KILL_POINTS)
def test_gram_kill_resume_bit_identical(packed_store, gram_clean,
                                        tmp_path, kill_after):
    """Supervised streaming-gram run killed at the Nth block read: the
    supervisor restarts it, the checkpoint resumes it, and the output
    bytes equal the port's uninterrupted run's and the JAX CLI's."""
    out = str(tmp_path / "sim.tsv")
    _supervised(_gram_cmd(packed_store, out, str(tmp_path / "ck")),
                f"ingest.block_read:kill:after={kill_after}:max=1")
    clean, jax_clean = gram_clean
    assert _read(out) == clean
    assert _read(out) == jax_clean


# -------------------------------------------------- streaming sketch solve


def _sketch_cmd(store, out, ckpt):
    return ["pcoa", "--source", "packed", "--path", store,
            "--block-variants", "128", "--metric", "grm",
            "--solver", "corrected", "--sketch-rank", "12",
            "--sketch-iters", "1", "--num-pc", "3",
            "--checkpoint-dir", ckpt, "--checkpoint-every-blocks", "2",
            "--output-path", out] + CPU


@pytest.fixture(scope="module")
def sketch_clean(packed_store, tmp_path_factory):
    d = tmp_path_factory.mktemp("sketch_clean")
    out = str(d / "clean.tsv")
    _clean(_sketch_cmd(packed_store, out, str(d / "ck")))
    return _read(out)


@pytest.mark.parametrize("kill_after", SKETCH_KILL_POINTS)
def test_sketch_kill_resume_bit_identical(packed_store, sketch_clean,
                                          tmp_path, kill_after):
    """Supervised corrected-rung run (2 streamed passes of 8 blocks)
    killed mid pass 0, late in pass 0 or inside the power pass resumes
    from the checkpointed (N, r) sketch state to the same coordinate
    bytes."""
    out = str(tmp_path / "coords.tsv")
    _supervised(_sketch_cmd(packed_store, out, str(tmp_path / "ck")),
                f"ingest.block_read:kill:after={kill_after}:max=1")
    assert _read(out) == sketch_clean


# --------------------------------------- sketch-saved model artifact


def _model_cmd(store, out, model, ckpt):
    return ["pcoa", "--source", "packed", "--path", store,
            "--block-variants", "128", "--metric", "ibs",
            "--solver", "corrected", "--sketch-rank", "12",
            "--sketch-iters", "1", "--num-pc", "3",
            "--save-model", model,
            "--checkpoint-dir", ckpt, "--checkpoint-every-blocks", "2",
            "--output-path", out] + CPU


@pytest.fixture(scope="module")
def model_clean(packed_store, tmp_path_factory):
    d = tmp_path_factory.mktemp("model_clean")
    out, model = str(d / "clean.tsv"), str(d / "clean_model.npz")
    _clean(_model_cmd(packed_store, out, model, str(d / "ck")))
    return _read(model), _read(out)


@pytest.mark.parametrize("kill_after", SKETCH_KILL_POINTS)
def test_saved_model_kill_resume_byte_identical(packed_store, model_clean,
                                                tmp_path, kill_after):
    """Supervised --save-model corrected run killed at the Nth block
    read: the saved factorized model's .npz bytes and the coordinates
    equal the uninterrupted run's."""
    out = str(tmp_path / "coords.tsv")
    model = str(tmp_path / "model.npz")
    _supervised(_model_cmd(packed_store, out, model, str(tmp_path / "ck")),
                f"ingest.block_read:kill:after={kill_after}:max=1")
    want_model, want_coords = model_clean
    assert _read(model) == want_model
    assert _read(out) == want_coords


# ------------------------------------------------- minhash neighbors job


def _neighbors_cmd(store, out, ckpt):
    return ["neighbors", "--source", "packed", "--path", store,
            "--block-variants", "128", "--metric", "ibs",
            "--minhash-hashes", "32", "--minhash-bands", "8",
            "--neighbors-k", "5",
            "--checkpoint-dir", ckpt, "--checkpoint-every-blocks", "2",
            "--output-path", out] + CPU


@pytest.fixture(scope="module")
def neighbors_clean(packed_store, tmp_path_factory):
    d = tmp_path_factory.mktemp("neighbors_clean")
    out = str(d / "clean.topk")
    _clean(_neighbors_cmd(packed_store, out, str(d / "ck")))
    return _read(out)


@pytest.mark.parametrize("kill_after", NEIGHBORS_KILL_POINTS)
def test_neighbors_kill_resume_bit_identical(packed_store, neighbors_clean,
                                             tmp_path, kill_after):
    """Supervised MinHash + exact-evaluation neighbors run killed early
    or late in the signature pass (resumed from its solver:minhash
    checkpoint) or inside the candidate evaluation (re-run) writes a
    top-k file byte-identical to the uninterrupted run's."""
    out = str(tmp_path / "sim.topk")
    _supervised(_neighbors_cmd(packed_store, out, str(tmp_path / "ck")),
                f"ingest.block_read:kill:after={kill_after}:max=1")
    assert _read(out) == neighbors_clean


# ------------------------------------------------------ store compaction


def _ingest_cmd(src_store, out_store):
    return ["ingest", "--source", "packed", "--path", src_store,
            "--block-variants", "128", "--chunk-variants", "256",
            "--ingest-workers", "2", "--output-path", out_store] + CPU


@pytest.fixture(scope="module")
def compact_clean(packed_store, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("compact_clean") / "store")
    _clean(_ingest_cmd(packed_store, out))
    return (_read(os.path.join(out, "manifest.json")),
            sorted(os.listdir(os.path.join(out, "chunks"))))


@pytest.mark.parametrize("kill_after", COMPACT_KILL_POINTS)
def test_compact_kill_resume_byte_identical(packed_store, compact_clean,
                                            tmp_path, kill_after):
    """Supervised compaction killed mid-stream: the crashed attempt
    leaves chunks but no manifest (the commit point), the restart
    re-compacts idempotently, and manifest and chunk set equal a clean
    compaction's."""
    out = str(tmp_path / "store")
    _supervised(_ingest_cmd(packed_store, out),
                f"ingest.block_read:kill:after={kill_after}:max=1")
    want_manifest, want_chunks = compact_clean
    assert _read(os.path.join(out, "manifest.json")) == want_manifest
    assert sorted(os.listdir(os.path.join(out, "chunks"))) == want_chunks


# ------------------------------------------------------ serve hot-reload


_SERVE_SCRIPT = r"""
import sys
import numpy as np
from spark_examples_tpu_torch.ingest.packed import load_packed
from spark_examples_tpu_torch.serve import ProjectionEngine, ProjectionServer

model3, model5, panel, out = sys.argv[1:5]
engine = ProjectionEngine(model3, load_packed(panel), block_variants=128,
                          max_batch=2, device="cpu")
server = ProjectionServer(engine, cache_entries=0).start()
rng = np.random.default_rng(5)
queries = rng.integers(0, 3, size=(3, engine.n_variants)).astype(np.int8)
before = [server.project(q, timeout=60) for q in queries]
server.reload_model(model5)   # the hot-reload under test
after = [server.project(q, timeout=60) for q in queries]
assert server.drain(timeout=60)
server.close()
np.savez(out, before=np.concatenate(before), after=np.concatenate(after))
"""


@pytest.fixture(scope="module")
def serve_models(packed_store, tmp_path_factory):
    """Two models on the same panel (k=3 and k=5) fitted once, plus the
    clean (uninterrupted) serve-reload-serve outputs."""
    from spark_examples_tpu_torch.core.config import (
        ComputeConfig,
        IngestConfig,
        JobConfig,
    )
    from spark_examples_tpu_torch.pipelines.jobs import pcoa_job

    d = tmp_path_factory.mktemp("serve_models")
    models = {}
    for k in (3, 5):
        models[k] = str(d / f"m{k}.npz")
        pcoa_job(JobConfig(
            ingest=IngestConfig(source="packed", path=packed_store,
                                block_variants=128),
            compute=ComputeConfig(metric="ibs", num_pc=k, device="cpu"),
            model_path=models[k],
        ))
    clean_out = str(d / "clean.npz")
    p = subprocess.run(
        [sys.executable, "-c", _SERVE_SCRIPT, models[3], models[5],
         packed_store, clean_out],
        env=_env(), capture_output=True, text=True, timeout=240,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    return models, np.load(clean_out)


@pytest.mark.parametrize("kill_after", SERVE_KILL_POINTS)
def test_serve_hot_reload_kill_resume_bit_identical(
        packed_store, serve_models, tmp_path, kill_after):
    """The serving process killed at the Nth admitted request — before,
    during or after the hot-reload — then restarted by the supervisor:
    the restarted server produces coordinates bit-identical to the
    uninterrupted run."""
    models, clean = serve_models
    out = str(tmp_path / "coords.npz")
    env = _env(**{
        faults.ENV_SPECS: f"serve.request:kill:after={kill_after}:max=1",
    })
    run = supervisor.supervise(
        [sys.executable, "-c", _SERVE_SCRIPT, models[3], models[5],
         packed_store, out],
        policy=supervisor.SupervisorPolicy(max_restarts=2,
                                           startup_timeout_s=240.0),
        env=env, heartbeat_path=str(tmp_path / "hb"),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    assert run.ok, run.incidents
    assert run.restarts == 1  # the kill really happened, once
    assert "exit code 113" in run.incidents[0]
    got = np.load(out)
    np.testing.assert_array_equal(got["before"], clean["before"])
    np.testing.assert_array_equal(got["after"], clean["after"])
