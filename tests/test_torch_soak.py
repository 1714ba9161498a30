"""The port's chaos soak (``spark_examples_tpu_torch/tools/soak.py``), the
twin of tests/test_soak.py, on the CPU: the fixed-seed tier-1 smoke and
the determinism check, the full 25-iteration soak behind ``slow``, the
readahead worker's single-site tests, and the soak's tables against the
JAX harness's (the scenario tables name the same sites, kinds and
ranges; the thread table is the port's lint contract)."""

import os
import sys

import numpy as np
import pytest

from spark_examples_tpu_torch.core import faults
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.tools import soak
from spark_examples_tpu_torch.tools.graftlint.rules import threads
from spark_examples_tpu_torch.tools.soak import (
    KILL_SCENARIOS,
    SCENARIOS,
    SoakConfig,
    run_soak,
)
from tests.conftest import random_genotypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # tools/ is repo tooling, not an installed pkg

from tools import soak as jsoak  # noqa: E402


@pytest.mark.soak
def test_chaos_soak_smoke(tmp_path):
    """One seeded-shuffled pass over the whole in-process scenario table
    on the CPU, every invariant checked every round."""
    report = run_soak(SoakConfig(
        workdir=str(tmp_path), iterations=len(SCENARIOS), seed=7,
        include_kill=False, round_budget_s=120.0, device="cpu",
    ))
    assert report.ok, "\n".join(report.violations)
    assert report.iterations == len(SCENARIOS)
    sites_run = {r["spec"].split(":")[0] for r in report.rounds}
    assert sites_run == {site for _j, site, _k, _p in SCENARIOS}
    assert report.faults_fired > 0
    assert report.healed >= 1
    assert report.retries >= 1


@pytest.mark.soak
def test_chaos_soak_schedule_is_deterministic(tmp_path):
    """Same seed -> same schedule, specs and injector seeds (the repro
    line's contract), and the JAX harness's for the same seed."""
    r1 = run_soak(SoakConfig(workdir=str(tmp_path / "a"), iterations=3,
                             seed=41, include_kill=False, device="cpu"))
    r2 = run_soak(SoakConfig(workdir=str(tmp_path / "b"), iterations=3,
                             seed=41, include_kill=False, device="cpu"))
    got = [(r["spec"], r["seed"]) for r in r1.rounds]
    assert got == [(r["spec"], r["seed"]) for r in r2.rounds]
    assert r1.ok and r2.ok, r1.violations + r2.violations


@pytest.mark.slow
@pytest.mark.soak
def test_chaos_soak_full(tmp_path):
    """The acceptance soak: 25 fixed-seed iterations over every site,
    supervised kill-resume rounds through the port's CLI included."""
    report = run_soak(SoakConfig(
        workdir=str(tmp_path), iterations=25, seed=20260803,
        include_kill=True, device="cpu",
    ))
    assert report.ok, "\n".join(report.violations)
    assert report.iterations == 25
    assert report.healed >= 1
    assert report.restarts >= 1


def test_scenario_tables_are_the_jax_harness_s():
    assert SCENARIOS == jsoak.SCENARIOS
    assert KILL_SCENARIOS == jsoak.KILL_SCENARIOS
    sites = {site for _j, site, _k, _p in SCENARIOS + KILL_SCENARIOS}
    assert sites <= set(faults.SITES)
    kinds = {kind for _j, _s, kind, _p in SCENARIOS + KILL_SCENARIOS}
    assert kinds <= set(faults.KINDS)


def test_soak_config_runs_on_the_card_unless_asked():
    assert SoakConfig(workdir="w").device == "cuda"
    fields = set(SoakConfig.__dataclass_fields__)
    assert fields == set(jsoak.SoakConfig.__dataclass_fields__) | {"device"}


def test_thread_table_is_the_soak_s_and_the_lint_reads_it():
    assert soak._SUSPECT_THREADS == jsoak._SUSPECT_THREADS
    assert threads.soak_thread_prefixes() == soak._SUSPECT_THREADS
    assert threads.THREAD_FAMILIES == (soak._SUSPECT_THREADS
                                       + threads.PORT_FAMILIES)


def test_spec_draws_match_the_jax_harness():
    import random

    for job, site, kind, params in SCENARIOS + KILL_SCENARIOS:
        a, b = random.Random(5), random.Random(5)
        assert soak._spec_str(site, kind, a, params) == \
            jsoak._spec_str(site, kind, b, params), (job, site, kind)


def test_kill_round_runs_the_port_s_cli_on_its_device(tmp_path):
    class Fx:
        store_dir = str(tmp_path / "store")
        cfg = SoakConfig(workdir=str(tmp_path), device="cpu")

    cmd = soak._cli_gram_cmd(Fx, "o.tsv", "ck", "tel")
    assert cmd[1:4] == ["-m", "spark_examples_tpu_torch", "similarity"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "jax" not in " ".join(cmd).replace("spark_examples", "")


def test_report_json_has_the_jax_keys():
    r = soak.SoakReport(iterations=2, healed=1)
    assert set(r.to_json()) == set(jsoak.SoakReport().to_json())
    assert r.ok
    r.violations.append("SOAK-REPRO seed=0 iter=1 spec='x' job=gram: y")
    assert not r.ok


# ------------------------------------------------ single-site twins


def _store(tmp_path, rng):
    from spark_examples_tpu_torch.store.writer import compact

    g = np.abs(random_genotypes(rng, 8, 512, missing_rate=0.1))
    store = str(tmp_path / "st")
    compact(store, ArraySource(g), chunk_variants=128)
    return g, store


def test_readahead_worker_decode_fault_delivered_in_order(tmp_path, rng):
    """store.readahead.decode: an io_error in the background warm worker
    is held and re-raised at the consumer's cursor, and an unfaulted
    re-read is bit-identical."""
    from spark_examples_tpu_torch.core.config import IngestConfig
    from spark_examples_tpu_torch.pipelines import runner

    _g, store = _store(tmp_path, rng)
    cfg = IngestConfig(source="store", path=store, block_variants=128,
                       readahead_chunks=2, io_retries=0)
    clean = [b.copy() for b, _ in runner.build_source(cfg, "cpu")
             .blocks(128)]
    with faults.armed(["store.readahead.decode:io_error:after=1:max=1"]) \
            as inj:
        src = runner.build_source(cfg, "cpu")
        with pytest.raises(faults.InjectedFault):
            list(src.blocks(128))
        assert inj.fire_count("store.readahead.decode") == 1
        src.close()
    got = [b.copy() for b, _ in runner.build_source(cfg, "cpu").blocks(128)]
    for gb, cb in zip(got, clean):
        np.testing.assert_array_equal(gb, cb)


def test_readahead_worker_fault_recovers_through_retry(tmp_path, rng):
    """Same site inside the retry boundary: the held worker error rides
    reopen-and-seek and the stream completes bit-identically."""
    from spark_examples_tpu_torch.core.config import IngestConfig
    from spark_examples_tpu_torch.pipelines import runner

    g, store = _store(tmp_path, rng)
    cfg = IngestConfig(source="store", path=store, block_variants=128,
                       readahead_chunks=2, io_retries=3,
                       io_retry_backoff_s=0.001)
    with faults.armed(["store.readahead.decode:io_error:after=1:max=1"]):
        src = runner.build_source(cfg, "cpu")
        with pytest.warns(RuntimeWarning, match="transient ingest error"):
            got = np.concatenate([b for b, _ in src.blocks(128)], axis=1)
    np.testing.assert_array_equal(got, g)
