"""The port's live plane (core/live.py and the periodic flusher) against
the JAX package's, on the CPU.

- ``prometheus_text`` of one snapshot byte-identical to JAX's, and of
  identical recordings in the two registries.
- The ``--live-port`` sidecar's endpoints on port 0, its port and
  announce files, and the env arming being opt-in.
- ``live_snapshot`` identity and the recent-event ring; the flusher's
  atomic, monotonic snapshots under concurrent writers; a hard kill
  between flushes leaves the last snapshot readable.
- The ``--supervise`` parent's ``SupervisorLiveProxy``: it follows the
  child's sidecar and answers stale from the last good body while the
  child is down, its ``supervisor_*`` series byte-identical to JAX's for
  the same state; and the acceptance run: a supervised job killed and
  restarted stays scrapeable through the proxy, and ``telemetry
  stitch`` merges both attempts with a restart marker.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from spark_examples_tpu.core import live as jlive
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu_torch.core import faults, live, supervisor, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for t in (telemetry, jtelemetry):
        t.reset()
    yield
    telemetry.stop_periodic_flush()
    for t in (telemetry, jtelemetry):
        t.configure(dir=None)
        t.reset()


def _get(url: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _record(t) -> None:
    t.count("faults.fired", 3)
    t.count("serve.requests")
    t.count("phase.gram", 1.5)
    t.count("phase.eigh", 0.25)
    t.gauge_set("serve.in_flight", 2)
    t.gauge_set("serve.in_flight", 0)
    for v in (0.25, 0.001, 0.03, 7.5):
        t.observe("serve.latency_s", v)
    t.observe("prefetch.get_wait_s", 0.0)


META = {"run_id": 'r"un\\1', "attempt": 2, "rank": 0, "uptime_s": 12.3456}


def test_prometheus_text_of_one_snapshot_is_jax_s():
    _record(jtelemetry)
    snap = jtelemetry.metrics_snapshot()
    snap["meta"] = META
    assert live.prometheus_text(snap) == jlive.prometheus_text(snap)


def test_prometheus_text_of_identical_recordings_is_jax_s():
    _record(telemetry)
    _record(jtelemetry)
    snap, jsnap = telemetry.metrics_snapshot(), jtelemetry.metrics_snapshot()
    assert snap == jsnap
    snap["meta"] = jsnap["meta"] = META
    text = live.prometheus_text(snap)
    assert text == jlive.prometheus_text(jsnap)
    assert "# TYPE faults_fired_total counter\nfaults_fired_total 3.0" in text
    assert 'phase_seconds_total{phase="gram"} 1.5' in text
    assert "serve_in_flight 0.0\nserve_in_flight_min 0.0\n" \
        "serve_in_flight_max 2.0" in text
    assert 'serve_latency_s{quantile="0.99"}' in text
    assert "serve_latency_s_count 4" in text
    assert 'telemetry_info{run_id="r\\"un\\\\1",attempt="2",rank="0"} 1' \
        in text
    assert text.endswith("\n")


def test_prometheus_text_defaults_to_the_live_registry():
    telemetry.count("faults.fired")
    text = live.prometheus_text()
    assert "faults_fired_total 1.0" in text
    assert f'run_id="{telemetry.run_id()}"' in text


def test_sidecar_endpoints_and_port_files(tmp_path):
    telemetry.count("faults.fired")
    port_file = tmp_path / "port"
    announce = tmp_path / "announce"
    server = live.maybe_start_live(environ={
        live.ENV_PORT: "0",
        live.ENV_PORT_FILE: str(port_file),
        live.ENV_ANNOUNCE: str(announce),
    })
    assert server is not None
    try:
        assert int(port_file.read_text()) == server.port
        assert announce.read_text() == f"127.0.0.1:{server.port}"
        base = f"http://127.0.0.1:{server.port}"
        assert b"faults_fired_total" in _get(f"{base}/metrics")
        debug = json.loads(_get(f"{base}/debug/telemetry"))
        assert debug["counters"]["faults.fired"] == 1
        assert debug["meta"]["run_id"] == telemetry.run_id()
        health = json.loads(_get(f"{base}/healthz"))
        assert health["ok"] and health["run_id"] and health["rank"] == 0
        assert health["pid"] == os.getpid()
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{base}/nope")
        assert err.value.code == 404
        assert telemetry.counter_value("live.requests") == 3
    finally:
        server.shutdown()


def test_live_port_flag_binds_without_env():
    server = live.maybe_start_live(port=0, environ={})
    try:
        assert server.port > 0
        assert b"telemetry_info" in _get(
            f"http://127.0.0.1:{server.port}/metrics")
    finally:
        server.shutdown()


def test_maybe_start_live_is_opt_in():
    assert live.maybe_start_live(environ={}) is None


def test_live_snapshot_carries_identity_and_recent_events(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=True)
    telemetry.count("faults.fired")
    for _ in range(3):
        with telemetry.span("checkpoint.save", cat="checkpoint"):
            pass
    snap = telemetry.live_snapshot(recent=2)
    assert snap["counters"]["faults.fired"] == 1
    assert snap["histograms"]["checkpoint.save"]["count"] == 3
    assert len(snap["recent_events"]) == 2
    assert snap["meta"]["run_id"] and snap["meta"]["attempt"] == 0
    assert snap["meta"]["epoch_unix_s"] <= snap["meta"]["wrote_unix_s"]
    assert set(snap) == set(jtelemetry.live_snapshot())


def test_recent_events_ring_excludes_the_flushers_own_spans(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=True)
    with telemetry.span("checkpoint.save", cat="checkpoint"):
        pass
    flusher = telemetry.PeriodicFlusher(str(tmp_path), interval_s=0.01)
    for _ in range(5):
        flusher.flush()
    flusher.stop()
    names = [e["name"] for e in telemetry.recent_events()]
    assert names == ["checkpoint.save"]
    assert telemetry.metrics_snapshot()["histograms"]["live.flush"][
        "count"] >= 5


def test_periodic_flusher_publishes_atomic_monotonic_snapshots(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=True)
    stop = threading.Event()
    wrote = [0] * 4

    def hammer(i):
        while not stop.is_set():
            telemetry.observe("serve.latency_s", 0.001)
            wrote[i] += 1

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    telemetry.start_periodic_flush(0.005)
    path = tmp_path / "rank0" / "metrics.json"
    last_count = -1
    reads = 0
    deadline = time.time() + 3.0
    try:
        while time.time() < deadline and reads < 40:
            try:
                with open(path) as f:
                    snap = json.load(f)
            except OSError:
                continue  # the first flush has not landed
            h = snap["histograms"].get("serve.latency_s", {"count": 0})
            assert h["count"] >= last_count, "non-monotonic export"
            if h["count"]:
                assert h["min"] <= h["p50"] <= h["max"]
            last_count = h["count"]
            reads += 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    telemetry.stop_periodic_flush()
    assert reads >= 10 and last_count > 0
    with open(path) as f:
        final = json.load(f)
    assert final["histograms"]["serve.latency_s"]["count"] == sum(wrote)
    assert final["counters"]["live.flushes"] >= 1
    with open(tmp_path / "rank0" / "live_trace.jsonl") as f:
        ring = [json.loads(line) for line in f if line.strip()]
    assert len(ring) <= telemetry.RECENT_EVENTS


def test_kill_between_flushes_leaves_the_last_snapshot_readable(tmp_path):
    script = (
        "import os, time\n"
        "from spark_examples_tpu_torch.core import telemetry\n"
        f"telemetry.configure(dir={str(tmp_path / 'tel')!r}, "
        "trace_events=True, flush_s=0.01)\n"
        "for i in range(50):\n"
        "    telemetry.count('faults.fired')\n"
        "    with telemetry.span('store.heal'):\n"
        "        time.sleep(0.005)\n"
        "os._exit(113)\n"
    )
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 113, p.stderr
    with open(tmp_path / "tel" / "rank0" / "metrics.json") as f:
        snap = json.load(f)
    assert snap["counters"]["faults.fired"] > 0
    with open(tmp_path / "tel" / "rank0" / "live_trace.jsonl") as f:
        assert all(json.loads(line)["name"] == "store.heal"
                   for line in f if line.strip())


def test_sigterm_exports_what_was_collected(tmp_path):
    """The crash flush: a configured process killed by SIGTERM exports
    its metrics and still dies by the signal."""
    script = (
        "import os, signal\n"
        "from spark_examples_tpu_torch.core import telemetry\n"
        f"telemetry.configure(dir={str(tmp_path / 'tel')!r})\n"
        "telemetry.count('faults.fired', 4)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
    )
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == -15, p.stderr
    with open(tmp_path / "tel" / "rank0" / "metrics.json") as f:
        assert json.load(f)["counters"]["faults.fired"] == 4


def test_cli_live_port_sidecar_runs_for_the_job(capsys):
    """``--live-port 0`` binds the sidecar for the job's life, announces
    it on stderr and shuts it down when the job ends."""
    from spark_examples_tpu_torch.cli.main import main

    before = set(threading.enumerate())
    assert main(["pcoa", "--device", "cpu", "--n-samples", "12",
                 "--n-variants", "300", "--block-variants", "128",
                 "--num-pc", "2", "--live-port", "0"]) == 0
    err = capsys.readouterr().err
    assert "live telemetry on http://127.0.0.1:" in err
    left = [t for t in threading.enumerate()
            if t not in before and t.name == "live-telemetry-http"
            and t.is_alive()]
    assert not left


# ---------------------------------------------------------------------- proxy


def test_proxy_follows_child_and_serves_stale_when_down(tmp_path):
    """The proxy answers from the live child when it is up, and from
    the last-good cache (marked stale, supervisor series appended)
    when it is down — the scrape that lands mid-restart succeeds."""
    telemetry.count("faults.fired")
    port_file = tmp_path / "child.port"
    child = live.LiveTelemetryServer(port=0, port_file=str(port_file))
    child.serve_in_thread()
    state = {"run_id": "testrun", "attempt": 0, "restarts": 0,
             "watchdog_kills": 0}
    proxy = live.SupervisorLiveProxy(
        "127.0.0.1", 0, str(port_file), lambda: dict(state))
    proxy.serve_in_thread()
    base = f"http://127.0.0.1:{proxy.port}"
    try:
        body = _get(f"{base}/metrics").decode()
        assert "faults_fired_total" in body  # the child's series
        assert "supervisor_restarts 0" in body
        assert "supervisor_scrape_stale 0" in body
        debug = json.loads(_get(f"{base}/debug/telemetry"))
        assert debug["stale"] is False
        assert debug["child"]["counters"]["faults.fired"] == 1

        child.shutdown()  # the restart window
        state["restarts"] = 1
        state["attempt"] = 1
        body = _get(f"{base}/metrics").decode()
        assert "faults_fired_total" in body  # last-good cache
        assert "supervisor_scrape_stale 1" in body
        assert "supervisor_restarts 1" in body
        assert "supervisor_child_up 0" in body
        debug = json.loads(_get(f"{base}/debug/telemetry"))
        assert debug["stale"] is True
        assert debug["supervisor"]["restarts"] == 1
        health = json.loads(_get(f"{base}/healthz"))
        assert health["ok"] and health["child_up"] is False
        assert telemetry.counter_value("live.proxy_stale") >= 2
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{base}/nope")
        assert err.value.code == 404
    finally:
        proxy.shutdown()
        child.shutdown()


@pytest.mark.parametrize("child_up,stale", [(True, False), (False, True)])
def test_proxy_supervisor_series_are_jax_s(tmp_path, child_up, stale):
    """The parent's own series, for one state, byte-identical to the
    JAX package's proxy's (a run id that needs escaping included)."""
    state = {"run_id": 'r"id\\1', "attempt": 2, "restarts": 2,
             "watchdog_kills": 1}
    ours = live.SupervisorLiveProxy(
        "127.0.0.1", 0, str(tmp_path / "p"), lambda: state).serve_in_thread()
    theirs = jlive.SupervisorLiveProxy(
        "127.0.0.1", 0, str(tmp_path / "p"), lambda: state).serve_in_thread()
    try:
        assert ours._supervisor_lines(state, child_up, stale) == \
            theirs._supervisor_lines(state, child_up, stale)
    finally:
        ours.shutdown()
        theirs.shutdown()


def test_proxy_announces_its_endpoint(tmp_path):
    announce = tmp_path / "announce"
    proxy = live.SupervisorLiveProxy(
        "127.0.0.1", 0, str(tmp_path / "child.port"), dict,
        announce_path=str(announce)).serve_in_thread()
    try:
        assert announce.read_text() == f"127.0.0.1:{proxy.port}"
    finally:
        proxy.shutdown()


def _cli_env(**extra):
    env = dict(
        os.environ,
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        **{supervisor.ENV_HEARTBEAT_INTERVAL: "0.1"},
    )
    env.update(extra)
    return env


def test_supervised_kill_restart_proxy_and_stitch(tmp_path):
    """The acceptance run: a supervised job is killed mid-run by an
    injected fault and restarted; the parent's /metrics proxy answers
    before, during and after the restart (the restart visible in the
    supervisor series), and `telemetry stitch` yields one trace
    spanning both attempts with a restart marker."""
    tel = str(tmp_path / "tel")
    announce = tmp_path / "announce"
    env = _cli_env(**{
        # kill at the 4th host->device transfer; a per-block delay
        # widens the scrape window (stripped, like the kill, on the
        # restarted attempt)
        faults.ENV_SPECS: ("device.put:kill:after=3;"
                           "device.put:delay:delay=0.05:max=0"),
        live.ENV_ANNOUNCE: str(announce),
    })
    cmd = [
        sys.executable, "-m", "spark_examples_tpu_torch", "similarity",
        "--device", "cpu", "--n-samples", "16", "--n-variants", "2048",
        "--block-variants", "128",
        "--checkpoint-dir", str(tmp_path / "ck"),
        "--checkpoint-every-blocks", "2",
        "--telemetry-dir", tel, "--telemetry-flush-s", "0.05",
        "--live-port", "0", "--supervise",
        "--output-path", str(tmp_path / "out.npy"),
    ]
    proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        base = None
        deadline = time.time() + 60
        while base is None and time.time() < deadline:
            try:
                base = "http://" + announce.read_text().strip()
            except OSError:
                time.sleep(0.05)
        assert base, "proxy never announced its endpoint"
        scrapes = restart_seen = child_metric_seen = 0
        while proc.poll() is None and time.time() - deadline < 240:
            try:
                body = _get(f"{base}/metrics", timeout=2).decode()
            except Exception:
                time.sleep(0.05)
                continue  # transient socket teardown, keep polling
            scrapes += 1
            if "supervisor_restarts 1" in body:
                restart_seen += 1
            if "gram_block" in body:
                child_metric_seen += 1
            time.sleep(0.05)
        _, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-2000:]
    assert "supervisor: attempt 0: crash: exit code 113" in stderr
    assert scrapes >= 5
    assert restart_seen >= 1, "restart never visible on /metrics"
    assert child_metric_seen >= 1, "child series never proxied"
    p = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch", "telemetry",
         "stitch", "--path", tel],
        env=_cli_env(), capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    report = json.loads(p.stdout)
    assert report["attempts"] == [0, 1]
    assert report["restart_markers"] == 1
    assert not report["mixed_run_ids"]
    lines = [json.loads(line)
             for line in open(report["output"]) if line.strip()]
    pids = {e["pid"] for e in lines if e.get("name") == "gram.block"}
    assert len(pids) == 2, "blocks from both attempts on their tracks"
    assert any(e.get("cat") == "supervisor" for e in lines)
