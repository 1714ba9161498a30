"""The port's supervisor (core/supervisor.py): heartbeat writer, the
watchdog's crash / hang / stall verdicts, restart semantics, the
``supervisor.heartbeat`` fault site and the CLI glue, case for case the
JAX package's tests/test_supervisor.py; then against the JAX package:
the flag strip on a table of argvs, the child command (the port's own
module, never the JAX package's), and the ``supervisor.json`` incident
ledger's keys for one incident schedule.

The children are tiny torch-free scripts, so these run in seconds; the
CLI's kill-and-resume runs live in tests/test_torch_kill_matrix.py.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from spark_examples_tpu.core import supervisor as jsupervisor
from spark_examples_tpu_torch.core import faults, supervisor, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAST = supervisor.SupervisorPolicy(
    max_restarts=2, heartbeat_timeout_s=1.0, stall_timeout_s=1.0,
    stall_blocks=0.0, startup_timeout_s=5.0, poll_s=0.02, grace_s=1.0,
)


def _env(**extra):
    env = dict(
        os.environ,
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        # Fast beats: the watchdog budgets here are sub-second.
        **{supervisor.ENV_HEARTBEAT_INTERVAL: "0.1"},
    )
    env.update(extra)
    return env


def _run(script: str, policy=FAST, tmp_path=None, **kw):
    hb = str(tmp_path / "hb.json") if tmp_path is not None else None
    return supervisor.supervise(
        [sys.executable, "-c", script], policy=policy,
        heartbeat_path=hb, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, **kw)


def _crash_once(marker, code=17) -> str:
    return (
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        f"    open(m, 'w').close(); os._exit({code})\n"
        "sys.exit(0)\n"
    )


# --------------------------------------------------------------- child side


def test_heartbeat_writer_and_progress_token(tmp_path):
    telemetry.reset()
    hb = str(tmp_path / "beat.json")
    w = supervisor.HeartbeatWriter(hb, interval_s=0.05).start()
    try:
        payload = json.load(open(hb))
        assert payload["pid"] == os.getpid()
        p0 = payload["progress"]
        telemetry.count("faults.fired")  # any instrumented work
        deadline = time.time() + 5
        while time.time() < deadline:
            if json.load(open(hb))["progress"] > p0:
                break
            time.sleep(0.02)
        assert json.load(open(hb))["progress"] > p0
        assert telemetry.counter_value("supervisor.heartbeats") >= 1
    finally:
        w.stop()
    telemetry.reset()


def test_heartbeat_payload_keys_and_token_exclusions_are_jax_s():
    """The payload carries JAX's keys, and the self-reporting names
    (supervisor.*, live.*, telemetry.*) never move the token."""
    telemetry.reset()
    payload = supervisor.heartbeat_payload()
    jpayload = jsupervisor.heartbeat_payload()
    assert set(payload) == set(jpayload)
    t0 = supervisor.progress_token()
    telemetry.count("supervisor.heartbeats")
    telemetry.count("live.requests")
    assert supervisor.progress_token() == t0
    telemetry.observe("serve.latency_s", 0.01)
    assert supervisor.progress_token() == t0 + 1
    assert supervisor._TOKEN_EXCLUDE == jsupervisor._TOKEN_EXCLUDE
    telemetry.reset()


def test_maybe_start_heartbeat_from_env(tmp_path):
    assert supervisor.maybe_start_heartbeat({}) is None
    hb = str(tmp_path / "env.json")
    w = supervisor.maybe_start_heartbeat({supervisor.ENV_HEARTBEAT: hb})
    try:
        assert w is not None and os.path.exists(hb)
    finally:
        w.stop()


def test_heartbeat_write_failure_is_tolerated(tmp_path):
    """An injected io_error at the supervisor.heartbeat site fails one
    write with a warning — the writer (and the job it reports on)
    keeps running."""
    hb = str(tmp_path / "faulty.json")
    with faults.armed(["supervisor.heartbeat:io_error:after=0:max=1"]):
        with pytest.warns(RuntimeWarning, match="heartbeat write"):
            w = supervisor.HeartbeatWriter(hb, interval_s=0.02).start()
        try:
            deadline = time.time() + 5
            while time.time() < deadline and not os.path.exists(hb):
                time.sleep(0.02)
            assert os.path.exists(hb)  # later beats landed
        finally:
            w.stop()


# ------------------------------------------------------------- parent side


def test_clean_child_passes_through(tmp_path):
    run = _run("import sys; sys.exit(0)", tmp_path=tmp_path)
    assert run.ok and run.restarts == 0 and run.incidents == []


def test_crash_restarts_until_success(tmp_path):
    """Child crashes on the first attempt (marker file tracks attempts),
    succeeds on the second — the supervisor hides the crash."""
    with pytest.warns(RuntimeWarning, match="child crash"):
        run = _run(_crash_once(tmp_path / "attempt"), tmp_path=tmp_path)
    assert run.ok and run.restarts == 1
    assert "exit code 17" in run.incidents[0]


def test_usage_error_exit_is_not_retried(tmp_path):
    """Exit code 2 (argparse usage error) fails identically every
    attempt — reported once, the restart budget untouched."""
    run = _run("import sys; sys.exit(2)", tmp_path=tmp_path)
    assert not run.ok and run.returncode == 2 and run.restarts == 0
    assert "non-retryable" in run.incidents[-1]


def test_restart_budget_exhausts_with_last_code(tmp_path):
    with pytest.warns(RuntimeWarning):
        run = _run("import sys; sys.exit(9)", tmp_path=tmp_path)
    assert not run.ok and run.returncode == 9
    assert run.restarts == FAST.max_restarts
    assert "budget" in run.incidents[-1]


def test_hang_without_heartbeat_is_killed(tmp_path):
    """A child that never heartbeats and never exits is killed at the
    startup budget and restarted; the restart completes."""
    marker = tmp_path / "attempt"
    script = (
        "import os, sys, time\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close(); time.sleep(600)\n"
        "sys.exit(0)\n"
    )
    policy = supervisor.SupervisorPolicy(
        max_restarts=1, startup_timeout_s=1.0, poll_s=0.02, grace_s=0.5)
    with pytest.warns(RuntimeWarning, match="child hang"):
        run = _run(script, policy=policy, tmp_path=tmp_path)
    assert run.ok and run.watchdog_kills == 1 and run.restarts == 1
    assert "startup budget" in run.incidents[0]


def test_stall_frozen_progress_is_killed(tmp_path):
    """Heartbeats keep arriving but the progress token never moves:
    the watchdog calls it a stall (naming the queue gauges) and
    restarts."""
    marker = tmp_path / "attempt"
    script = (
        "import os, sys, time\n"
        "from spark_examples_tpu_torch.core import supervisor\n"
        "w = supervisor.maybe_start_heartbeat()\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close(); time.sleep(600)\n"
        "w.stop(); sys.exit(0)\n"
    )
    with pytest.warns(RuntimeWarning, match="child stall"):
        run = _run(script, env=_env(), tmp_path=tmp_path)
    assert run.ok and run.watchdog_kills == 1 and run.restarts == 1
    assert "progress frozen" in run.incidents[0]
    assert "prefetch_queue_depth" in run.incidents[0]


def test_stalled_heartbeat_thread_is_a_hang(tmp_path):
    """The supervisor.heartbeat fault site end to end: a delay spec
    freezes the child's heartbeat thread, the watchdog kills at the
    heartbeat budget, and the restarted child (faults stripped) runs
    clean."""
    script = (
        "import sys, time\n"
        "from spark_examples_tpu_torch.core import supervisor\n"
        "w = supervisor.maybe_start_heartbeat()\n"
        "time.sleep(2.5)\n"
        "sys.exit(0)\n"
    )
    env = _env(**{
        faults.ENV_SPECS: "supervisor.heartbeat:delay:delay=600:max=1",
    })
    policy = supervisor.SupervisorPolicy(
        max_restarts=1, heartbeat_timeout_s=0.8, stall_timeout_s=30.0,
        startup_timeout_s=5.0, poll_s=0.02, grace_s=0.5)
    with pytest.warns(RuntimeWarning, match="hang"):
        run = _run(script, policy=policy, env=env, tmp_path=tmp_path)
    assert run.ok and run.watchdog_kills == 1
    assert run.restarts == 1


def test_idle_server_is_not_stall_killed(tmp_path):
    """A serving child reporting zero in-flight requests is IDLE, not
    stalled: its frozen token is left alone."""
    script = (
        "import sys, time\n"
        "from spark_examples_tpu_torch.core import supervisor, telemetry\n"
        "telemetry.gauge_set('serve.in_flight', 0)\n"
        "w = supervisor.maybe_start_heartbeat()\n"
        "time.sleep(2.5)\n"
        "w.stop(); sys.exit(0)\n"
    )
    run = _run(script, env=_env(), tmp_path=tmp_path)
    assert run.ok and run.watchdog_kills == 0 and run.restarts == 0


def test_kill_exit_code_counts_as_crash(tmp_path):
    """The fault harness's os._exit(113) is an ordinary crash to the
    supervisor (restart + resume), distinguishable in incidents."""
    with pytest.warns(RuntimeWarning, match="exit code 113"):
        run = _run(_crash_once(tmp_path / "attempt", 113),
                   tmp_path=tmp_path)
    assert run.ok and run.restarts == 1


def test_restart_strips_faults_and_pins_identity(tmp_path):
    """Attempt 0 sees the fault schedule, attempt 1 does not; both get
    one run id and their attempt ordinal."""
    seen = tmp_path / "seen"
    script = (
        "import json, os, sys\n"
        f"p = {str(seen)!r}\n"
        "rows = json.load(open(p)) if os.path.exists(p) else []\n"
        "rows.append({k: os.environ.get(k) for k in ("
        f"{faults.ENV_SPECS!r}, {faults.ENV_SEED!r}, "
        f"{telemetry.ENV_RUN_ID!r}, {telemetry.ENV_ATTEMPT!r})}})\n"
        "json.dump(rows, open(p, 'w'))\n"
        "sys.exit(5 if len(rows) == 1 else 0)\n"
    )
    env = _env(**{faults.ENV_SPECS: "store.read:delay:max=1",
                  faults.ENV_SEED: "4"})
    with pytest.warns(RuntimeWarning, match="exit code 5"):
        run = _run(script, env=env, tmp_path=tmp_path)
    assert run.ok
    rows = json.load(open(seen))
    assert rows[0][faults.ENV_SPECS] == "store.read:delay:max=1"
    assert rows[1][faults.ENV_SPECS] is None
    assert rows[1][faults.ENV_SEED] is None
    assert rows[0][telemetry.ENV_RUN_ID] == rows[1][telemetry.ENV_RUN_ID]
    assert [r[telemetry.ENV_ATTEMPT] for r in rows] == ["0", "1"]


# ------------------------------------------------------------------ CLI glue


def test_strip_supervise_flags():
    argv = ["similarity", "--supervise", "--metric", "ibs",
            "--supervise-max-restarts", "5",
            "--supervise-stall-timeout=9.5", "--output-path", "o.tsv"]
    assert supervisor.strip_supervise_flags(argv) == [
        "similarity", "--metric", "ibs", "--output-path", "o.tsv"]


STRIP_TABLE = [
    [],
    ["pcoa"],
    ["pcoa", "--supervise"],
    ["pcoa", "--supervise", "--live-port", "0", "--telemetry-dir", "t"],
    ["pcoa", "--live-port=9100", "--supervise"],
    ["serve", "--model", "m.npz", "--supervise-max-restarts=2",
     "--port", "0"],
    ["similarity", "--supervise-stall-timeout", "5", "--supervise",
     "--output-path", "o.npy", "--device", "cpu"],
    ["ingest", "--supervise-max-restarts"],  # a value flag at the end
]


@pytest.mark.parametrize("argv", STRIP_TABLE,
                         ids=[" ".join(a) or "empty" for a in STRIP_TABLE])
def test_strip_supervise_flags_equals_jax_s(argv):
    assert supervisor.strip_supervise_flags(argv) == \
        jsupervisor.strip_supervise_flags(argv)


def test_child_command_names_the_port():
    """The child re-invokes THIS package's CLI: a copy that kept the JAX
    package's module name would supervise the JAX job instead."""
    cmd = supervisor.child_command(["pcoa", "--supervise", "--device",
                                    "cpu"])
    assert cmd == [sys.executable, "-m", "spark_examples_tpu_torch",
                   "pcoa", "--device", "cpu"]


def test_supervise_cli_runs_the_port_child(monkeypatch, tmp_path):
    """``supervise_cli`` hands ``supervise`` the port's child command
    and the parent's policy knobs."""
    got = {}

    def fake(cmd, policy, **kw):
        got.update(cmd=cmd, policy=policy, **kw)
        return supervisor.SupervisedRun(returncode=0)

    monkeypatch.setattr(supervisor, "supervise", fake)
    rc = supervisor.supervise_cli(
        ["similarity", "--supervise", "--device", "cpu"], max_restarts=4,
        stall_timeout_s=7.0, telemetry_dir=str(tmp_path))
    assert rc == 0
    assert got["cmd"][1:3] == ["-m", "spark_examples_tpu_torch"]
    assert got["policy"].max_restarts == 4
    assert got["policy"].stall_timeout_s == 7.0
    assert got["telemetry_dir"] == str(tmp_path)


def test_cli_validates_in_the_parent(tmp_path, capsys):
    """A bad flag is a usage error in the parent (no child spawned), and
    a missing card fails through resolve_device before any spawn."""
    import torch

    from spark_examples_tpu_torch.cli.main import main

    with pytest.raises(SystemExit):
        main(["similarity", "--device", "cpu", "--supervise",
              "--block-variants", "0"])
    assert "block_variants=0" in capsys.readouterr().err
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        mp.setattr(supervisor, "supervise", lambda *a, **k: pytest.fail(
            "a child was spawned"))
        with pytest.raises(RuntimeError, match="--device cuda"):
            main(["similarity", "--supervise"])


def test_supervisor_ledger_keys_equal_jax_s(tmp_path):
    """One incident schedule (crash once, then succeed) under both
    packages' supervisors: the same supervisor.json keys, incident keys
    and verdicts."""
    docs = []
    for mod, name in ((supervisor, "port"), (jsupervisor, "jax")):
        tel = tmp_path / name
        with pytest.warns(RuntimeWarning, match="exit code 113"):
            run = mod.supervise(
                [sys.executable, "-c", _crash_once(tmp_path / f"m{name}",
                                                   113)],
                policy=mod.SupervisorPolicy(
                    max_restarts=2, startup_timeout_s=5.0, poll_s=0.02,
                    grace_s=1.0),
                heartbeat_path=str(tmp_path / f"{name}.hb"),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                telemetry_dir=str(tel))
        assert run.ok and run.restarts == 1
        docs.append(json.load(open(tel / "supervisor.json")))
    ours, theirs = docs
    assert set(ours) == set(theirs)
    assert [set(i) for i in ours["incidents"]] == \
        [set(i) for i in theirs["incidents"]]
    for key in ("restarts", "watchdog_kills", "final_returncode", "done"):
        assert ours[key] == theirs[key]
    assert [(i["attempt"], i["kind"], i["detail"], i["returncode"])
            for i in ours["incidents"]] == \
        [(i["attempt"], i["kind"], i["detail"], i["returncode"])
         for i in theirs["incidents"]]


def test_environment_names_are_jax_s():
    assert supervisor.ENV_HEARTBEAT == jsupervisor.ENV_HEARTBEAT
    assert supervisor.ENV_HEARTBEAT_INTERVAL == \
        jsupervisor.ENV_HEARTBEAT_INTERVAL
    assert supervisor.SUPERVISE_FLAGS == jsupervisor.SUPERVISE_FLAGS
