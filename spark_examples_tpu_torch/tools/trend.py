"""Noise-aware perf-regression tracking over the port's bench headline
history: the port's copy of the JAX package's ``tools/trend.py``
(stdlib only), reading and writing its own history.

A perf regression only surfaces mechanically if every run's headline is
recorded and the next one is held against it. Three pieces:

- **Substrate.** :func:`append_history` appends one run's headline to
  the append-only ``BENCH_TORCH_HISTORY.jsonl`` — one JSON object per
  line, ``{"t_unix", "run": {git sha, argv, backend, device...},
  "metrics": {...}}``. ``bench_torch.py`` appends every run
  unconditionally. :func:`ingest_bench_files` backfills it from saved
  headline JSON files of the port's own runs; the JAX package's
  ``BENCH_HISTORY.jsonl`` and its ``BENCH_r*.json`` round records are
  TPU numbers and are never read (an archived round file is refused).
- **Direction registry.** Every headline metric has a *better*
  direction — throughput up, latency down, relerr down, ``*_ok`` stays
  true. :func:`metric_direction` resolves it from an explicit map plus
  suffix rules; metrics with no known direction (free-form strings,
  environment numbers like the dev tunnel rate) are not gated.
- **Noise band.** A metric's recent history (trailing window) gives a
  median and a MAD; the candidate regresses only when it is worse than
  ``median ± max(mad_k·1.4826·MAD, rel_floor·|median|)`` in the bad
  direction. Run-to-run jitter (the MAD) widens the band per metric, so
  a noisy metric needs a big move to fire while a stable one is gated
  tightly — and the relative floor keeps a zero-MAD history from
  flagging 1% wiggles.

Wired as ``bench_torch.py --trend`` (check + append + nonzero exit on
regression) and runnable standalone::

    python -m spark_examples_tpu_torch.tools.trend check
    python -m spark_examples_tpu_torch.tools.trend check --candidate headline.json
    python -m spark_examples_tpu_torch.tools.trend ingest headline.json

Exit codes: 0 clean, 1 regression, 2 usage.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HISTORY_FILE = "BENCH_TORCH_HISTORY.jsonl"
# Backend tag of the port's card runs (the JAX package's is "tpu").
BACKEND = "cuda"

# Defaults of the noise band. mad_k=4 on a consistency-scaled MAD
# (1.4826·MAD estimates sigma for normal noise) keeps ordinary jitter
# quiet; rel_floor guarantees a ±5% dead zone even on a constant
# history (MAD 0), so sub-noise wiggles can never fire.
WINDOW = 8
MAD_K = 4.0
REL_FLOOR = 0.05
MIN_HISTORY = 3

HIGHER_IS_BETTER = +1
LOWER_IS_BETTER = -1
BOOL_MUST_HOLD = 0

# Explicit directions first — names whose suffix rules would guess
# wrong, plus the cross-round headline anchors. None = tracked in the
# history but never gated (environment numbers that measure the dev
# tunnel / session, not the code).
_EXPLICIT: dict[str, int | None] = {
    "value": LOWER_IS_BETTER,  # headline seconds
    "vs_baseline": HIGHER_IS_BETTER,
    "streamed_vs_baseline": HIGHER_IS_BETTER,
    # serve_vcf_s - serve_store_s: the cold-start time SAVED by staging
    # from the store — a gain, despite the "_s" suffix.
    "store_serve_cold_start_delta_s": HIGHER_IS_BETTER,
    "tunnel_mb_s": None,  # session link rate: environment, not code
    "store_link_mb_s": None,  # the SIMULATED link rate: a knob, not a result
    # measured link-bound wall / ideal link wall: 1.0 = decode fully
    # hidden behind the link, the feed-saturation contract.
    "store_link_decode_overhead": LOWER_IS_BETTER,
    "cpu_baseline_s": None,  # the oracle's speed is not ours to gate
    # graftlint finding count (bench headline): 0 on a clean tree; any
    # rise is a regression regardless of perf. The companion lint_ok
    # boolean rides the *_ok must-hold gate.
    "lint_findings": LOWER_IS_BETTER,
    "chaos_soak_iterations": None,
    "chaos_soak_healed": None,
    "chaos_soak_faults_fired": None,
    # Fleet bench (bench --fleet): the route count is workload shape,
    # the eviction count is the budget-forced churn the bench INTENDS
    # (a "regression" to fewer evictions would just mean the mix
    # changed), and the hedge win fraction measures the injected-delay
    # demo's asymmetry, not code quality — the p99s/QPS/ok gate
    # through the ordinary suffix rules.
    "fleet_routes": None,
    "fleet_evictions": None,
    "fleet_hedge_win_frac": None,
    # Controller bench (bench --controller): the shed fraction has no
    # suffix rule ("_rate" is ambiguous between throughput and loss) —
    # here it is dropped requests, so it must go DOWN; the final
    # replica count is the workload's equilibrium, not a quality axis.
    # scale_up_s / p99_loss_s gate through the "_s" suffix rule and
    # controller_ok through the *_ok must-hold gate.
    "controller_burst_shed_rate": LOWER_IS_BETTER,
    "controller_replicas": None,
    # Tracing tax (bench --fleet): traced-vs-untraced loadgen wall
    # overhead as a fraction — "_frac" has no suffix rule, and this
    # one must go DOWN (the flight recorder budget: <= 2% is the PR
    # gate). slo_fast_burn_ok rides the *_ok must-hold gate.
    "trace_overhead_frac": LOWER_IS_BETTER,
    # Neighbor engine (bench --neighbors): recall@k has no suffix rule
    # and must go UP (lost relatives are the failure mode), as must
    # the fraction of pairs the LSH filter avoided evaluating — the
    # "_frac" here is a gain, unlike the stall/overhead fractions.
    # neighbors_sparse_speedup_vs_dense rides the "_vs_" rule,
    # neighbors_p99_ms the "_ms" suffix, neighbors_ok the *_ok gate.
    "neighbors_recall_at_k": HIGHER_IS_BETTER,
    "neighbors_filter_frac": HIGHER_IS_BETTER,
    # Servable sketch models (bench --sketch-serve): how many budgets'
    # worth of panel the shard-staged route streams per request is a
    # workload DESCRIPTOR (set by cohort size vs configured budget),
    # not a quality axis — tracked, never gated. stage_s/p99_ms ride
    # the time suffixes, sketch_serve_ok the *_ok must-hold gate.
    "sketch_serve_panel_over_budget_x": None,
    # Fused packed gram lowering (bench --kernels): the worst
    # per-kernel fused-vs-reference gram speedup. "speedup" alone
    # matches no suffix rule, and this one must go UP — the whole
    # point of decoding the 2-bit codes in-register is beating the
    # unpack-then-matmul reference. kernel_fused_ok (parity + column
    # presence, plus chip-only speedup floor) rides the *_ok gate.
    "kernel_fused_min_speedup": HIGHER_IS_BETTER,
}

# (match kind, token, direction) — first hit wins, checked in order:
# throughput tokens before the bare "_s" time suffix ("_mb_s" ends
# with "_s" too), relerr before "_vs_" ("relerr_vs_exact" is an error,
# not a speedup ratio), stall/compression rules before the generic
# suffixes (a feed-stall FRACTION must go down, a compression RATIO
# up — store PR contract). The kernel-sweep metrics
# (kernel_<name>_mb_s / kernel_<name>_gflops / kernel_sweep_min_gflops
# from bench --kernels) ride the _mb_s and flops throughput rules,
# kernel_sweep_ok the *_ok gate — pinned by tests/test_trend.py.
_RULES: tuple[tuple[str, str, int], ...] = (
    ("contains", "relerr", LOWER_IS_BETTER),
    ("contains", "stall_frac", LOWER_IS_BETTER),
    # 1 - gather_wait/compute of the measured multi-chip gram (bench
    # --multichip): more of the block collective hidden behind the MXU
    # is strictly better — and it must outrank the generic "_frac"-less
    # suffix rules below (multichip_overlap_frac has no other token).
    ("contains", "overlap_frac", HIGHER_IS_BETTER),
    ("contains", "compress_ratio", HIGHER_IS_BETTER),
    ("contains", "_mb_s", HIGHER_IS_BETTER),
    ("contains", "qps", HIGHER_IS_BETTER),
    ("contains", "flops", HIGHER_IS_BETTER),
    ("contains", "_vs_", HIGHER_IS_BETTER),
    ("contains", "scaling", HIGHER_IS_BETTER),
    ("contains", "separation", HIGHER_IS_BETTER),
    ("suffix", "_peak_mb", LOWER_IS_BETTER),
    ("suffix", "_bytes", LOWER_IS_BETTER),
    ("suffix", "_ms", LOWER_IS_BETTER),
    ("suffix", "_s", LOWER_IS_BETTER),
)


def metric_direction(name: str) -> int | None:
    """+1 higher-is-better, -1 lower-is-better, 0 boolean gate, None =
    untracked."""
    if name in _EXPLICIT:
        return _EXPLICIT[name]
    if name.endswith("_ok"):
        return BOOL_MUST_HOLD
    for kind, token, direction in _RULES:
        if kind == "suffix" and name.endswith(token):
            return direction
        if kind == "contains" and token in name:
            return direction
    return None


def _scalar_metrics(headline: dict) -> dict:
    """The gateable subset of a headline: top-level ints/floats/bools
    (strings, nested dicts like the telemetry digest, and repro lines
    stay in the raw record but are not trended)."""
    out = {}
    for k, v in headline.items():
        if isinstance(v, bool):
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = float(v)
    return out


# ---------------------------------------------------------------------------
# Substrate: the append-only history.


def load_history(path: str) -> list[dict]:
    """Parse the JSONL history; torn/garbage lines are skipped (the
    file is append-only across crashes — a half-written tail must not
    invalidate years of records)."""
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and isinstance(
                        rec.get("metrics"), dict):
                    records.append(rec)
    except OSError:
        pass
    return records


def run_metadata(extra: dict | None = None) -> dict:
    """Who/where/what produced this run: git sha, platform, python —
    the provenance a regression hunt needs first."""
    meta = {
        "platform": sys.platform,
        "python": ".".join(map(str, sys.version_info[:3])),
    }
    try:
        meta["git_sha"] = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        meta["git_sha"] = None
    if extra:
        meta.update(extra)
    return meta


def append_history(path: str, headline: dict,
                   run_meta: dict | None = None) -> dict:
    """Append one run's headline to the history; returns the record."""
    record = {
        "t_unix": time.time(),
        "run": run_metadata(run_meta),
        "metrics": _scalar_metrics(headline),
    }
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")
    return record


def _is_round_file(path: str) -> bool:
    """The JAX package's archived round records (``BENCH_r*.json``):
    TPU numbers, never history of the port."""
    name = os.path.basename(path)
    return name.startswith("BENCH_r") and name.endswith(".json")


def ingest_bench_files(paths: list[str],
                       backend: str = BACKEND) -> list[dict]:
    """Backfill records from saved headline JSON of the port's runs (a
    bare headline, or a record whose ``parsed`` field holds one). They
    are tagged ``backend="cuda"`` by default — the backend tag is what
    keeps a CPU bench run from gating against (or polluting) the card's
    history (see :func:`check_trend`). The JAX package's archived
    ``BENCH_r*.json`` rounds ran on a TPU: a ValueError names them."""
    rounds = [p for p in paths if _is_round_file(p)]
    if rounds:
        raise ValueError(
            f"{', '.join(sorted(rounds))}: the JAX package's archived "
            "rounds are TPU numbers and never enter the port's history")
    records = []
    for p in sorted(paths):
        with open(p) as f:
            doc = json.load(f)
        headline = doc.get("parsed", doc)
        if not isinstance(headline, dict):
            continue
        metrics = _scalar_metrics(headline)
        if not metrics:
            continue
        records.append({
            "t_unix": os.path.getmtime(p),
            "run": {"source": os.path.basename(p),
                    "round": doc.get("n"),
                    "backend": backend},
            "metrics": metrics,
        })
    return records


# ---------------------------------------------------------------------------
# The check.


def check_trend(history: list[dict], candidate: dict,
                window: int = WINDOW, mad_k: float = MAD_K,
                rel_floor: float = REL_FLOOR,
                min_history: int = MIN_HISTORY,
                backend: str | None = None) -> dict:
    """Gate ``candidate`` (a metrics dict or a history record) against
    the trailing ``window`` of ``history``. Returns the report:
    ``ok`` (False iff any regression), ``regressions`` /
    ``improvements`` / ``skipped`` per-metric details.

    ``backend`` (e.g. ``"cuda"``) restricts the history window to runs
    recorded with the same ``run.backend`` — seconds on a CPU dev box
    and seconds on the card are different quantities, and comparing
    across them would both fire spurious regressions and widen the
    MAD band enough to mask real ones. None = no filtering (fixture
    histories and same-environment workflows)."""
    if backend is not None:
        history = [h for h in history
                   if h.get("run", {}).get("backend") == backend]
    cand = candidate.get("metrics", candidate)
    report: dict = {"checked": 0, "regressions": [], "improvements": [],
                    "skipped": []}
    for name in sorted(cand):
        direction = metric_direction(name)
        value = cand[name]
        if direction is None or not isinstance(value, (bool, int, float)):
            report["skipped"].append({"metric": name, "why": "untracked"})
            continue
        series = [h["metrics"][name] for h in history
                  if name in h.get("metrics", {})][-window:]
        if direction == BOOL_MUST_HOLD:
            report["checked"] += 1
            if not value and any(series):
                report["regressions"].append({
                    "metric": name, "candidate": value,
                    "why": "boolean gate was previously true",
                })
            continue
        if len(series) < min_history:
            report["skipped"].append({
                "metric": name,
                "why": f"history too short ({len(series)} < "
                       f"{min_history})",
            })
            continue
        med = statistics.median(series)
        mad = statistics.median(abs(x - med) for x in series)
        band = max(mad_k * 1.4826 * mad, rel_floor * abs(med))
        delta = float(value) - med
        report["checked"] += 1
        entry = {
            "metric": name,
            "candidate": float(value),
            "median": med,
            "band": round(band, 6),
            "delta": round(delta, 6),
            "direction": ("higher_is_better" if direction > 0
                          else "lower_is_better"),
            "window": len(series),
        }
        # Direction-aware: only a move PAST the band edge in the bad
        # direction regresses; the same move the other way is an
        # improvement (reported, never fatal).
        if delta * direction < -band:
            report["regressions"].append(entry)
        elif delta * direction > band:
            report["improvements"].append(entry)
    report["ok"] = not report["regressions"]
    return report


def check_and_count(history_path: str, candidate: dict | None = None,
                    backend: str | None = None, **kw) -> dict:
    """bench_torch.py's entry: check the candidate (default: the history's
    last record) against the records before it, mirroring the verdict
    into the ``trend.*`` telemetry counters. When the candidate is a
    history record carrying ``run.backend`` and no explicit
    ``backend`` is given, the window filters to that backend."""
    history = load_history(history_path)
    if candidate is None:
        if not history:
            return {"ok": True, "checked": 0, "regressions": [],
                    "improvements": [], "skipped": [],
                    "note": "empty history"}
        candidate, history = history[-1], history[:-1]
    if backend is None:
        backend = candidate.get("run", {}).get("backend") \
            if isinstance(candidate.get("run"), dict) else None
    report = check_trend(history, candidate, backend=backend, **kw)
    try:
        from spark_examples_tpu_torch.core import telemetry

        telemetry.count("trend.metrics_checked", report["checked"])
        if report["regressions"]:
            telemetry.count("trend.regressions",
                            len(report["regressions"]))
    except ImportError:
        pass  # the checker must run even without the package on path
    return report


def regression_lines(report: dict) -> list[str]:
    """Human-readable one-liners for a report's regressions — THE
    shared rendering, so bench_torch.py's gate and this module's CLI cannot
    drift apart on wording."""
    return [
        f"trend: REGRESSION {r['metric']}: {r.get('candidate')} vs "
        f"median {r.get('median')} (band ±{r.get('band', 0)}, "
        f"window {r.get('window', 0)})"
        for r in report.get("regressions", [])
    ]


# ---------------------------------------------------------------------------
# CLI.


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="noise-aware bench trend tracking")
    sub = ap.add_subparsers(dest="verb", required=True)
    p_in = sub.add_parser("ingest", help="backfill history from saved "
                          "headline files of the port's runs")
    p_in.add_argument("files", nargs="+")
    p_in.add_argument("--history", default=HISTORY_FILE)
    p_in.add_argument("--backend", default=BACKEND,
                      help="run.backend tag stamped on the ingested "
                      "records (default cuda — the card's runs); pass "
                      "cpu when backfilling CPU headlines so they never "
                      "gate the card's history")
    p_ck = sub.add_parser("check", help="gate the newest record (or "
                          "--candidate) against the trailing history")
    p_ck.add_argument("--history", default=HISTORY_FILE)
    p_ck.add_argument("--candidate", default=None,
                      help="headline JSON file to gate (default: the "
                      "history's own last record)")
    p_ck.add_argument("--window", type=int, default=WINDOW)
    p_ck.add_argument("--mad-k", type=float, default=MAD_K)
    p_ck.add_argument("--rel-floor", type=float, default=REL_FLOOR)
    p_ck.add_argument("--backend", default=None,
                      help="gate only against history runs recorded "
                      "with this run.backend (e.g. cuda); default: the "
                      "candidate record's own backend when it has one")
    args = ap.parse_args(argv)

    if args.verb == "ingest":
        try:
            records = ingest_bench_files(args.files, backend=args.backend)
        except ValueError as e:
            ap.error(str(e))
        with open(args.history, "a") as f:
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        print(f"ingested {len(records)} record(s) -> {args.history}")
        return 0

    candidate = None
    if args.candidate:
        with open(args.candidate) as f:
            doc = json.load(f)
        candidate = doc.get("parsed", doc)
    report = check_and_count(args.history, candidate,
                             backend=args.backend,
                             window=args.window, mad_k=args.mad_k,
                             rel_floor=args.rel_floor)
    print(json.dumps(report, sort_keys=True))
    for line in regression_lines(report):
        print(line, file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
