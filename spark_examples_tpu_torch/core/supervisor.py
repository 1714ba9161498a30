"""Supervised crash-resumable jobs: the restart layer over checkpoints.

Point resilience already exists — retries absorb flaky IO, checkpoints
survive kills, the store heals its chunks — but nothing *supervised* a
job: a crashed process stayed crashed, and a hung one (a stuck mount, a
dead device feed) hung forever. This module is the supervision layer:

- **Child side** (:class:`HeartbeatWriter`): a daemon thread writes a
  small JSON heartbeat (wall-clock, pid, a monotonic *progress token*
  derived from the telemetry registry, the current block-time p95 and
  the prefetch/readahead queue gauges) atomically every interval.
  Armed from the environment (:data:`ENV_HEARTBEAT`) by the CLI, so
  any supervised invocation reports liveness with zero flags.
- **Parent side** (:func:`supervise`): runs the job command as a child
  process and watches the heartbeat. A nonzero exit is a **crash**; a
  heartbeat that stops arriving is a **hang**; heartbeats that keep
  arriving with a frozen progress token past the stall budget are a
  **stall** (the queue-gauge snapshot rides into the incident message
  so the operator sees *which* stage starved). Hangs and stalls are
  killed (TERM, then KILL after a grace); every incident restarts the
  child — which resumes from the latest sha256-verified checkpoint
  (core/checkpoint.py), so the supervised result is bit-identical to
  an uninterrupted run by the same argument that makes checkpoint
  resume exact.

The stall budget adapts to the job's own telemetry: the child reports
its ``gram.block`` p95 in each heartbeat, and the watchdog requires
``stall_blocks`` block-periods of silence (never less than
``stall_timeout_s``) before calling a frozen token a stall — a config
streaming 10 s blocks is not killed on a 30 s quiet patch.

Injected fault schedules (:mod:`core.faults`, via the environment)
describe ONE incident: restarted children run with the fault variables
stripped, exactly like a preempted production job whose replacement
does not get re-preempted at the same block. Pass
``strip_faults_on_restart=False`` to soak restarts under sustained
fault schedules instead.

Wired as ``--supervise`` on the CLI: the parent re-invokes the same
command (flag stripped) as ``python -m spark_examples_tpu_torch`` under
the watchdog and exits with the final child's code. The parent holds no
device: it dispatches before any job work and never creates a CUDA
context. The heartbeat thread reads the telemetry registry only, never
the card: a synchronise there would wait behind a long kernel and turn
healthy progress into a "hang".

The environment names, the heartbeat payload and ``supervisor.json``
are the JAX package's, so either package's parent watches the other's
child and one stitcher reads both.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
import warnings
from dataclasses import dataclass, field

from spark_examples_tpu_torch.core import faults, telemetry

ENV_HEARTBEAT = "SPARK_EXAMPLES_TPU_HEARTBEAT"
ENV_HEARTBEAT_INTERVAL = "SPARK_EXAMPLES_TPU_HEARTBEAT_INTERVAL"

DEFAULT_INTERVAL_S = 0.5


# ---------------------------------------------------------------------------
# Child side: the heartbeat.


# Name prefixes that advance WITHOUT the job making progress and must
# therefore never feed the progress token: the supervisor's own
# heartbeat counter, the live plane's flusher/scrape counters (a
# periodic flush or an operator polling /metrics every few seconds
# would otherwise make a stalled job look alive forever), and the
# telemetry layer's own bookkeeping — once the trace buffer fills,
# every flusher span bumps telemetry.dropped_events on pure
# wall-clock, which would defeat the stall detector on exactly the
# long runs it exists for.
_TOKEN_EXCLUDE = ("supervisor.", "live.", "telemetry.")


def _token_from(snap: dict) -> float:
    """The progress token: the sum of every telemetry counter plus
    every histogram's sample count — EXCLUDING the self-reporting
    names above, which advance on wall-clock, not work."""
    total = sum(v for k, v in snap["counters"].items()
                if not k.startswith(_TOKEN_EXCLUDE))
    total += sum(snap["phases"].values())
    total += sum(h.get("count", 0) for k, h in snap["histograms"].items()
                 if not k.startswith(_TOKEN_EXCLUDE))
    return float(total)


def progress_token() -> float:
    """A number that moves iff the process is doing work. Any
    instrumented forward motion — a block streamed, a chunk decoded, a
    request served, a checkpoint written — advances it; an idle or
    deadlocked process freezes it."""
    return _token_from(telemetry.metrics_snapshot())


def heartbeat_payload() -> dict:
    """What one heartbeat says: liveness, progress, and the signals the
    watchdog's incident messages diagnose stalls with."""
    snap = telemetry.metrics_snapshot()
    hists = snap["histograms"]
    gauges = snap["gauges"]
    token = _token_from(snap)
    return {
        "t": time.time(),
        "pid": os.getpid(),
        # run_id/attempt/rank: the same stitch identity every trace
        # event carries, so a heartbeat is attributable to its attempt.
        **telemetry.identity(),
        "progress": float(token),
        "blocks": hists.get("gram.block", {}).get("count", 0),
        "block_p95_s": hists.get("gram.block", {}).get("p95", 0.0),
        "prefetch_queue_depth": gauges.get(
            "prefetch.queue_depth", {}).get("last"),
        "readahead_in_flight": gauges.get(
            "store.readahead.in_flight", {}).get("last"),
        # Serving processes are legitimately quiet between requests: a
        # frozen token with ZERO admitted-but-unanswered requests is
        # idle, not stalled (absent for batch jobs, where frozen
        # progress really is a stall).
        "in_flight": gauges.get("serve.in_flight", {}).get("last"),
    }


class HeartbeatWriter:
    """Daemon thread writing the heartbeat file atomically every
    ``interval_s``. A failed write warns once and keeps going (the
    heartbeat must never be able to kill the job it reports on); the
    ``supervisor.heartbeat`` fault site fires before each write so the
    chaos harness can freeze or fail it deterministically."""

    def __init__(self, path: str, interval_s: float = DEFAULT_INTERVAL_S):
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._warned = False
        self._thread: threading.Thread | None = None

    def start(self) -> "HeartbeatWriter":
        if self._thread is not None:
            return self
        self._beat()  # first beat synchronously: liveness from t=0
        self._thread = threading.Thread(
            target=self._run, name="supervisor-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _beat(self) -> None:
        try:
            faults.fire("supervisor.heartbeat", path=self.path)
            tmp = self.path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(heartbeat_payload(), f)
            os.replace(tmp, self.path)
            telemetry.count("supervisor.heartbeats")
        except BaseException as e:
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"supervisor heartbeat write to {self.path!r} failed "
                    f"({e!r}) — the job continues; a silent watchdog "
                    "kill+restart may follow if writes keep failing",
                    RuntimeWarning, stacklevel=2,
                )

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def maybe_start_heartbeat(environ=None) -> HeartbeatWriter | None:
    """Child-side arming: start a writer iff :data:`ENV_HEARTBEAT` is
    set (the supervisor parent sets it). The CLI calls this once per
    invocation; unsupervised runs pay nothing."""
    env = os.environ if environ is None else environ
    path = env.get(ENV_HEARTBEAT, "").strip()
    if not path:
        return None
    interval = float(env.get(ENV_HEARTBEAT_INTERVAL, DEFAULT_INTERVAL_S))
    return HeartbeatWriter(path, interval_s=interval).start()


# ---------------------------------------------------------------------------
# Parent side: the watchdog.


@dataclass(frozen=True)
class SupervisorPolicy:
    """When the watchdog intervenes and how often it forgives."""

    max_restarts: int = 3
    # No heartbeat file updated for this long (after the first one
    # landed) = the child is hung (deadlock, stuck syscall, frozen
    # heartbeat thread — indistinguishable from outside, all killable).
    heartbeat_timeout_s: float = 15.0
    # Heartbeats fresh but the progress token frozen for this long =
    # a stall. Adaptive floor: at least `stall_blocks` of the child's
    # own reported block p95, so slow-block configs aren't killed for
    # working slowly.
    stall_timeout_s: float = 60.0
    stall_blocks: float = 50.0
    # Before the FIRST heartbeat (interpreter + torch + device init).
    startup_timeout_s: float = 300.0
    poll_s: float = 0.1
    grace_s: float = 5.0  # TERM -> KILL escalation
    # Exit codes that mean "this command will fail identically every
    # time" — restarting a usage error (argparse exits 2) just pays
    # max_restarts interpreter+torch startups to print the same message.
    non_retryable_exits: tuple = (2,)


@dataclass
class SupervisedRun:
    """What happened across the whole supervised lifetime."""

    returncode: int
    restarts: int = 0
    watchdog_kills: int = 0
    incidents: list[str] = field(default_factory=list)
    # The parent proxy's scrape URL when --live-port was asked for
    # (stays answering across child restarts); None otherwise.
    live_endpoint: str | None = None

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def _kill_child(proc: subprocess.Popen, grace_s: float) -> None:
    """TERM (drain/flush handlers get their shot), then KILL."""
    try:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30.0)
    except OSError:
        pass  # already gone


def _read_heartbeat(path: str) -> tuple[float, dict] | None:
    """(file mtime, payload) or None when absent/torn. mtime, not the
    payload's clock, decides freshness — a child with a skewed clock
    must not look hung."""
    try:
        mtime = os.stat(path).st_mtime
        with open(path) as f:
            return mtime, json.load(f)
    except (OSError, ValueError):
        return None


def supervise(cmd: list[str], policy: SupervisorPolicy = SupervisorPolicy(),
              env: dict | None = None, cwd: str | None = None,
              heartbeat_path: str | None = None,
              strip_faults_on_restart: bool = True,
              stdout=None, stderr=None,
              live_port: int | None = None,
              live_host: str = "127.0.0.1",
              telemetry_dir: str | None = None) -> SupervisedRun:
    """Run ``cmd`` as a supervised child until it exits 0, restarting
    on crash, hang, or stall up to ``policy.max_restarts`` times.

    The child's environment gets :data:`ENV_HEARTBEAT` pointed at a
    private file (``heartbeat_path`` or ``<tmp>/supervisor-<pid>.hb``);
    the CLI's :func:`maybe_start_heartbeat` picks it up. Restarted
    children run with the fault-injection variables stripped by default
    (an injected schedule is one incident — see module docstring).

    Every child shares one ``run_id`` and gets its attempt ordinal
    (:data:`telemetry.ENV_RUN_ID` / :data:`telemetry.ENV_ATTEMPT`), so
    per-attempt telemetry exports stitch back into one session trace
    (core/stitch.py). With ``telemetry_dir`` set, the parent writes its
    incident ledger (``supervisor.json``) there — the restart markers
    of the stitched trace. With ``live_port`` set, the parent runs a
    :class:`~spark_examples_tpu_torch.core.live.SupervisorLiveProxy` on that
    port: children bind ephemeral ``--live-port`` sidecars (armed via
    the environment) and the parent's endpoint stays scrapeable across
    restarts, serving the last-good snapshot while a child is down.

    Returns the final :class:`SupervisedRun`; ``returncode`` is the
    last child's exit code (0 on success, the last failure when the
    restart budget ran out).
    """
    base_env = dict(os.environ if env is None else env)
    hb_path = heartbeat_path or os.path.join(
        base_env.get("TMPDIR", "/tmp"), f"supervisor-{os.getpid()}.hb")
    rid = base_env.get(telemetry.ENV_RUN_ID, "").strip() \
        or uuid.uuid4().hex[:12]
    run = SupervisedRun(returncode=1)
    ledger: list[dict] = []
    state = {"attempt": 0}

    def _write_ledger(final: bool = False) -> None:
        # Best-effort, atomic, after every incident — a parent that
        # dies mid-job still leaves the incidents recorded so far.
        if not telemetry_dir:
            return
        try:
            os.makedirs(telemetry_dir, exist_ok=True)
            telemetry._atomic_write(
                os.path.join(telemetry_dir, "supervisor.json"),
                json.dumps({
                    "run_id": rid,
                    "incidents": ledger,
                    "restarts": run.restarts,
                    "watchdog_kills": run.watchdog_kills,
                    "final_returncode": run.returncode if final else None,
                    "done": final,
                }, indent=1))
        except OSError:
            pass

    proxy = None
    port_file = None
    if live_port is not None:
        from spark_examples_tpu_torch.core import live as live_mod

        port_file = hb_path + ".liveport"

        def _proxy_state() -> dict:
            return {"run_id": rid, "attempt": state["attempt"],
                    "restarts": run.restarts,
                    "watchdog_kills": run.watchdog_kills}

        proxy = live_mod.SupervisorLiveProxy(
            live_host, live_port, port_file, _proxy_state,
            announce_path=base_env.get(live_mod.ENV_ANNOUNCE, "").strip()
            or None,
        ).serve_in_thread()
        run.live_endpoint = f"http://{proxy.host}:{proxy.port}"
        # Announced HERE, before the first child spawns: this (not the
        # children's private ephemeral sidecars) is the endpoint that
        # survives restarts, and supervise() blocks until the job is
        # over — a caller printing run.live_endpoint afterwards would
        # tell the operator about a socket that is already closed.
        print(
            f"supervisor: live telemetry on {run.live_endpoint} "
            "(GET /metrics, /debug/telemetry, /healthz; proxied to "
            "the supervised child, stays up across restarts)",
            file=sys.stderr,
        )

    attempt = 0
    try:
        while True:
            state["attempt"] = attempt
            child_env = dict(base_env)
            child_env[ENV_HEARTBEAT] = hb_path
            child_env[telemetry.ENV_RUN_ID] = rid
            child_env[telemetry.ENV_ATTEMPT] = str(attempt)
            if attempt > 0 and strip_faults_on_restart:
                child_env.pop(faults.ENV_SPECS, None)
                child_env.pop(faults.ENV_SEED, None)
            stale = [hb_path]  # stale liveness must not carry over
            if port_file is not None:
                from spark_examples_tpu_torch.core import live as live_mod

                child_env[live_mod.ENV_PORT] = "0"
                child_env[live_mod.ENV_PORT_FILE] = port_file
                # The announce file names the PARENT's endpoint; a
                # child re-announcing its private port would point
                # scrapers at a socket that dies on the next restart.
                child_env.pop(live_mod.ENV_ANNOUNCE, None)
                stale.append(port_file)
            for path in stale:
                try:
                    os.remove(path)
                except OSError:
                    pass
            spawned = time.time()
            proc = subprocess.Popen(cmd, env=child_env, cwd=cwd,
                                    stdout=stdout, stderr=stderr)
            incident = _watch(proc, hb_path, policy, spawned)
            if incident is None:  # clean exit
                run.returncode = 0
                return run
            kind, detail, rc = incident
            run.returncode = rc
            run.incidents.append(f"attempt {attempt}: {kind}: {detail}")
            ledger.append({"attempt": attempt, "kind": kind,
                           "detail": detail, "returncode": rc,
                           "t_unix": time.time()})
            if kind in ("hang", "stall"):
                run.watchdog_kills += 1
                telemetry.count("supervisor.stalls")
            if kind == "crash" and rc in policy.non_retryable_exits:
                run.incidents.append(
                    f"exit code {rc} is non-retryable (a usage/config "
                    "error fails identically every attempt) — not "
                    "restarting")
                return run
            if attempt >= policy.max_restarts:
                run.incidents.append(
                    f"restart budget ({policy.max_restarts}) exhausted")
                return run
            attempt += 1
            run.restarts += 1
            _write_ledger()
            telemetry.count("supervisor.restarts")
            warnings.warn(
                f"supervisor: child {kind} ({detail}); restarting "
                f"({policy.max_restarts - attempt + 1} restarts left) — "
                "resuming from the latest checkpoint",
                RuntimeWarning, stacklevel=2,
            )
    finally:
        _write_ledger(final=True)
        if proxy is not None:
            proxy.shutdown()


def _watch(proc: subprocess.Popen, hb_path: str,
           policy: SupervisorPolicy,
           spawned: float) -> tuple[str, str, int] | None:
    """One child's lifetime. None = clean exit; else (kind, detail,
    returncode) where kind is crash | hang | stall."""
    last_mtime = None
    last_progress = None
    progress_t = time.time()
    while True:
        rc = proc.poll()
        if rc is not None:
            if rc == 0:
                return None
            return ("crash", f"exit code {rc}", rc)
        now = time.time()
        hb = _read_heartbeat(hb_path)
        if hb is None:
            if now - spawned > policy.startup_timeout_s:
                _kill_child(proc, policy.grace_s)
                return ("hang",
                        f"no heartbeat within the "
                        f"{policy.startup_timeout_s:.0f}s startup budget",
                        proc.returncode or 1)
            time.sleep(policy.poll_s)
            continue
        mtime, payload = hb
        if mtime != last_mtime:
            last_mtime = mtime
        elif now - mtime > policy.heartbeat_timeout_s:
            _kill_child(proc, policy.grace_s)
            return ("hang",
                    f"heartbeat silent for {now - mtime:.1f}s "
                    f"(budget {policy.heartbeat_timeout_s:.0f}s)",
                    proc.returncode or 1)
        progress = payload.get("progress")
        if progress != last_progress:
            last_progress = progress
            progress_t = now
        elif payload.get("in_flight") == 0:
            # A serving child reporting zero in-flight requests is
            # IDLE: a frozen token is waiting for traffic, not a
            # deadlock — an idle server must never be stall-killed.
            # (Batch jobs never report the key; frozen progress there
            # stays a stall.)
            progress_t = now
        else:
            # Per-phase deadline derived from the child's own telemetry:
            # at least stall_blocks block-periods at its reported p95.
            budget = max(policy.stall_timeout_s,
                         policy.stall_blocks
                         * float(payload.get("block_p95_s") or 0.0))
            if now - progress_t > budget:
                _kill_child(proc, policy.grace_s)
                queues = (
                    f"prefetch_queue_depth="
                    f"{payload.get('prefetch_queue_depth')}, "
                    f"readahead_in_flight="
                    f"{payload.get('readahead_in_flight')}"
                )
                return ("stall",
                        f"heartbeats alive but progress frozen at "
                        f"{progress} for {now - progress_t:.1f}s "
                        f"(budget {budget:.1f}s; {queues})",
                        proc.returncode or 1)
        time.sleep(policy.poll_s)


# ---------------------------------------------------------------------------
# CLI glue.

SUPERVISE_FLAGS = ("--supervise", "--supervise-max-restarts",
                   "--supervise-stall-timeout")
# Value-taking flags the PARENT owns: stripped from the child argv.
# --live-port binds the parent's proxy; children get ephemeral sidecar
# ports through the environment instead (two processes cannot share
# the one public port).
_VALUE_FLAGS = SUPERVISE_FLAGS[1:] + ("--live-port",)


def strip_supervise_flags(argv: list[str]) -> list[str]:
    """The child's argv: the parent's, minus the supervision flags
    (value-taking flags lose their value token too)."""
    out: list[str] = []
    skip = False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == "--supervise":
            continue
        if tok.split("=", 1)[0] in _VALUE_FLAGS:
            skip = "=" not in tok
            continue
        out.append(tok)
    return out


# The package the child re-invokes: this one's CLI, never the JAX
# package's (which shares every flag and would pass a test that only
# checks exit codes).
CHILD_MODULE = "spark_examples_tpu_torch"


def child_command(argv: list[str]) -> list[str]:
    """The supervised child's command line for the parent's ``argv``."""
    return [sys.executable, "-m", CHILD_MODULE,
            *strip_supervise_flags(argv)]


def supervise_cli(argv: list[str], max_restarts: int,
                  stall_timeout_s: float,
                  live_port: int | None = None,
                  live_host: str = "127.0.0.1",
                  telemetry_dir: str | None = None) -> int:
    """The ``--supervise`` entrypoint: re-invoke this CLI (flag
    stripped) under the watchdog; exit with the final child's code."""
    policy = SupervisorPolicy(max_restarts=max_restarts,
                              stall_timeout_s=stall_timeout_s)
    cmd = child_command(argv)
    run = supervise(cmd, policy=policy, live_port=live_port,
                    live_host=live_host, telemetry_dir=telemetry_dir)
    for line in run.incidents:
        print(f"supervisor: {line}", file=sys.stderr)
    if run.restarts:
        print(f"supervisor: job completed after {run.restarts} "
              f"restart(s)", file=sys.stderr)
    return run.returncode
