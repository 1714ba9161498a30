"""The port's single-job stitcher (core/stitch.py) and ``telemetry
stitch``: the JAX package's stitch cases (tests/test_live.py) on the
port, then layout compatibility in both directions: the JAX package's
stitcher over a directory a supervised port job wrote, and the port's
over one a supervised JAX job wrote, each giving the same event count,
tracks and restart markers as the other package's stitcher.
"""

import json
import os
import subprocess
import sys

import pytest

from spark_examples_tpu.core import stitch as jstitch
from spark_examples_tpu_torch.core import faults, stitch, supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_attempt(base, att, rank, epoch, run_id, events):
    d = os.path.join(base, f"attempt{att}", f"rank{rank}")
    os.makedirs(d)
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump({"counters": {}, "meta": {
            "rank": rank, "attempt": att, "run_id": run_id,
            "epoch_unix_s": epoch}}, f)
    with open(os.path.join(d, "trace.jsonl"), "w") as f:
        f.write(json.dumps({"name": "process_name", "ph": "M",
                            "pid": rank, "ts": 0, "args": {}}) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def test_stitch_merges_attempts_on_one_timeline(tmp_path):
    base = str(tmp_path / "tel")
    ev = {"name": "gram.block", "cat": "gram", "ph": "X", "dur": 5.0,
          "tid": 1, "args": {}}
    _write_attempt(base, 0, 0, 1000.0, "rid1", [{**ev, "ts": 10.0}])
    _write_attempt(base, 1, 0, 1002.5, "rid1", [{**ev, "ts": 10.0}])
    with open(os.path.join(base, "supervisor.json"), "w") as f:
        json.dump({"run_id": "rid1", "restarts": 1, "incidents": [
            {"attempt": 0, "kind": "crash", "detail": "exit code 113",
             "returncode": 113, "t_unix": 1002.0}]}, f)
    report = stitch.stitch(base)
    assert report["attempts"] == [0, 1]
    assert report["events"] == 2
    assert report["restart_markers"] == 1
    assert report["run_ids"] == ["rid1"] and not report["mixed_run_ids"]
    lines = [json.loads(line)
             for line in open(report["output"]) if line.strip()]
    spans = [e for e in lines if e.get("name") == "gram.block"]
    # attempt 1's identical local ts lands 2.5 s later on the global
    # timeline, on its own pid track
    assert spans[0]["ts"] == 10.0 and spans[1]["ts"] == 2.5e6 + 10.0
    assert spans[0]["pid"] != spans[1]["pid"]
    marker = next(e for e in lines if e["name"] == "restart: crash")
    assert marker["ph"] == "i" and marker["s"] == "g"
    assert marker["ts"] == pytest.approx(2.0e6)
    names = {e["args"].get("name") for e in lines if e.get("ph") == "M"}
    assert {"attempt 0 rank 0", "attempt 1 rank 0",
            "supervisor"} <= names
    # The same files through the JAX package's stitcher: the same lines.
    jreport = jstitch.stitch(base, output=str(tmp_path / "j.jsonl"))
    assert open(jreport["output"]).read() == open(report["output"]).read()


def test_stitch_flags_mixed_run_ids_and_flat_layout(tmp_path):
    base = str(tmp_path / "tel")
    os.makedirs(os.path.join(base, "rank0"))
    with open(os.path.join(base, "rank0", "metrics.json"), "w") as f:
        json.dump({"meta": {"rank": 0, "attempt": 0, "run_id": "a",
                            "epoch_unix_s": 5.0}}, f)
    with open(os.path.join(base, "rank0", "trace.jsonl"), "w") as f:
        f.write(json.dumps({"name": "gram.block", "ph": "X", "ts": 1.0,
                            "dur": 1.0, "tid": 0, "args": {}}) + "\n")
    _write_attempt(base, 1, 0, 6.0, "b", [])
    report = stitch.stitch(base)
    assert report["mixed_run_ids"] and report["run_ids"] == ["a", "b"]
    assert report["events"] == 1


def test_stitch_rejects_emptiness(tmp_path):
    with pytest.raises(stitch.StitchError):
        stitch.stitch(str(tmp_path))
    with pytest.raises(stitch.StitchError, match="cannot read"):
        stitch.stitch(str(tmp_path / "absent"))


def test_stitch_falls_back_to_live_ring_for_killed_attempt(tmp_path):
    """A killed attempt has no exit-time trace.jsonl; its periodic
    live_trace.jsonl ring must still appear in the session trace, a
    torn last line skipped."""
    base = str(tmp_path / "tel")
    d = os.path.join(base, "attempt0", "rank0")
    os.makedirs(d)
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump({"meta": {"rank": 0, "attempt": 0, "run_id": "r",
                            "epoch_unix_s": 0.0}}, f)
    with open(os.path.join(d, "live_trace.jsonl"), "w") as f:
        f.write(json.dumps({"name": "gram.block", "ph": "X", "ts": 3.0,
                            "dur": 1.0, "tid": 0, "args": {}}) + "\n")
        f.write('{"name": "gram.bl')
    report = stitch.stitch(base)
    assert report["events"] == 1


def test_cli_stitch_and_refusals(tmp_path, capsys):
    """``telemetry stitch`` prints the report; ``timeline`` on a
    directory without a controller tape and ``stitch --fleet`` on one
    without slot exports say so and exit 1; an empty directory exits
    1."""
    from spark_examples_tpu_torch.cli.main import main

    base = str(tmp_path / "tel")
    _write_attempt(base, 0, 0, 1.0, "r", [{"name": "gram.block", "ph": "X",
                                           "ts": 1.0, "dur": 1.0,
                                           "tid": 0, "args": {}}])
    out = str(tmp_path / "s.jsonl")
    assert main(["telemetry", "stitch", "--path", base,
                 "--output", out]) == 0
    cap = capsys.readouterr()
    report = json.loads(cap.out.strip().splitlines()[-1])
    assert report["output"] == out and report["events"] == 1
    assert "1 events from 1 attempt(s)" in cap.err
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for argv, match in ((["telemetry", "timeline", "--path", base],
                         "telemetry timeline: no readable records"),
                        (["telemetry", "stitch", "--fleet", "--path", empty],
                         "is this a fleet workdir?")):
        assert main(argv) == 1
        assert match in capsys.readouterr().err
    assert main(["telemetry", "stitch", "--path", str(tmp_path)]) == 1


# ----------------------------------------------- across the two packages


def _supervised_run(module: str, tmp_path) -> str:
    """A supervised similarity job of ``module``'s CLI, killed at its
    4th host->device transfer and restarted; returns its telemetry
    directory (attempt0 from the live ring, attempt1 from the export,
    the parent's supervisor.json)."""
    tel = str(tmp_path / "tel")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        **{supervisor.ENV_HEARTBEAT_INTERVAL: "0.1",
           faults.ENV_SPECS: ("device.put:kill:after=3;"
                              "device.put:delay:delay=0.05:max=0")})
    cmd = [sys.executable, "-m", module, "similarity",
           "--n-samples", "16", "--n-variants", "1024",
           "--block-variants", "128",
           "--checkpoint-dir", str(tmp_path / "ck"),
           "--checkpoint-every-blocks", "2",
           "--telemetry-dir", tel, "--telemetry-flush-s", "0.05",
           "--supervise", "--output-path", str(tmp_path / "out.npy")]
    if module == "spark_examples_tpu_torch":
        cmd[4:4] = ["--device", "cpu"]
    p = subprocess.run(cmd, env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "supervisor: attempt 0: crash: exit code 113" in p.stderr
    return tel


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    return {module: _supervised_run(module, tmp_path_factory.mktemp(module))
            for module in ("spark_examples_tpu_torch", "spark_examples_tpu")}


def _tracks(path: str) -> tuple[list, list, int]:
    lines = [json.loads(line) for line in open(path) if line.strip()]
    names = sorted(e["args"]["name"] for e in lines
                   if e.get("name") == "process_name")
    markers = sorted(e["name"] for e in lines if e.get("ph") == "i"
                     and e.get("cat") == "supervisor")
    blocks = len({e["pid"] for e in lines if e.get("name") == "gram.block"})
    return names, markers, blocks


@pytest.mark.parametrize("writer", ["spark_examples_tpu_torch",
                                    "spark_examples_tpu"])
def test_both_stitchers_read_either_package_s_supervised_dir(
        written, writer, tmp_path):
    """Port-written and JAX-written supervised directories: the port's
    stitcher and the JAX package's give the same report (event count,
    attempts, ranks, restart markers, run id) and the same tracks."""
    base = written[writer]
    ours = stitch.stitch(base, output=str(tmp_path / "ours.jsonl"))
    theirs = jstitch.stitch(base, output=str(tmp_path / "theirs.jsonl"))
    for key in ("events", "attempts", "ranks", "restart_markers",
                "run_ids", "mixed_run_ids"):
        assert ours[key] == theirs[key], key
    assert ours["attempts"] == [0, 1]
    assert ours["restart_markers"] == 1
    assert len(ours["run_ids"]) == 1
    names, markers, blocks = _tracks(ours["output"])
    assert (names, markers, blocks) == _tracks(theirs["output"])
    assert names == ["attempt 0 rank 0", "attempt 1 rank 0", "supervisor"]
    assert markers == ["restart: crash"]
    assert blocks == 2  # gram.block spans from both attempts
