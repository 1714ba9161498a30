"""The port's trend gate (``spark_examples_tpu_torch/tools/trend.py``):
the twins of tests/test_trend.py against the port's module, its
direction map held against the JAX package's ``tools/trend.py`` (stdlib
only) for every headline key of both benches, and the port's own
history file — card (``cuda``) and CPU records only, gated by backend.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from spark_examples_tpu_torch.tools import trend
from tools import trend as jtrend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hist(name, values):
    return [{"t_unix": 1000.0 + i, "run": {"round": i},
             "metrics": {name: v}} for i, v in enumerate(values)]


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch.tools.trend",
         *args], capture_output=True, text=True, timeout=60, cwd=REPO)


# ------------------------------------------------------------------ directions


def test_metric_directions_resolve_sensibly():
    d = trend.metric_direction
    assert d("value") == trend.LOWER_IS_BETTER  # headline seconds
    assert d("streamed_s") == trend.LOWER_IS_BETTER
    assert d("serve_p99_ms") == trend.LOWER_IS_BETTER
    assert d("sketch_relerr_vs_exact_2500") == trend.LOWER_IS_BETTER
    assert d("sketch_peak_mb") == trend.LOWER_IS_BETTER
    assert d("serve_sustained_qps") == trend.HIGHER_IS_BETTER
    assert d("gram_tflops_staged") == trend.HIGHER_IS_BETTER
    assert d("ingest_mb_s_packed") == trend.HIGHER_IS_BETTER
    assert d("store_hit_vs_cold_parse") == trend.HIGHER_IS_BETTER
    assert d("store_compact_scaling_w4_vs_w1") == trend.HIGHER_IS_BETTER
    assert d("vs_baseline") == trend.HIGHER_IS_BETTER
    assert d("store_ok") == trend.BOOL_MUST_HOLD
    assert d("tunnel_mb_s") is None  # environment, never gated
    assert d("cpu_baseline_s") is None  # the host oracle's speed
    assert d("metric") is None  # free-form string name
    assert d("kernel_fused_min_speedup") == trend.HIGHER_IS_BETTER
    assert d("multichip_overlap_frac") == trend.HIGHER_IS_BETTER
    assert d("fleet_routes") is None
    assert d("lint_ok") == trend.BOOL_MUST_HOLD
    assert d("lint_findings") == trend.LOWER_IS_BETTER
    assert d("controller_burst_shed_rate") == trend.LOWER_IS_BETTER
    assert d("trace_overhead_frac") == trend.LOWER_IS_BETTER
    assert d("neighbors_recall_at_k") == trend.HIGHER_IS_BETTER
    assert d("sketch_serve_panel_over_budget_x") is None
    assert d("trend_ok") == trend.BOOL_MUST_HOLD


def _bench_headline_keys() -> set:
    """Every headline key bench.py can print (read from its source, never
    imported): the dict literals assigned to ``headline`` or returned by
    ``_multichip_headline``, and each ``headline["..."] = ...``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "headline"
                and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name)
              and node.value.id == "headline"
              and isinstance(node.ctx, ast.Store)):
            sl = node.slice
            if isinstance(sl, ast.Constant):
                keys.add(sl.value)
            elif isinstance(sl, ast.JoinedStr):  # kernel_{kname}_...
                for kname in ("jaccard", "king"):
                    keys.add("".join(
                        v.value if isinstance(v, ast.Constant) else kname
                        for v in sl.values))
        elif (isinstance(node, ast.FunctionDef)
              and node.name == "_multichip_headline"):
            ret = next(n for n in ast.walk(node) if isinstance(n, ast.Return))
            keys |= {k.value for k in ret.value.keys}
    return keys


def test_directions_are_the_jax_gate_s_for_every_headline_key():
    import bench_torch

    keys = _bench_headline_keys()
    assert len(keys) > 60, sorted(keys)
    keys |= set(bench_torch.HEADLINE_KEYS) | set(bench_torch.TREND_KEYS)
    for name in sorted(keys):
        assert trend.metric_direction(name) == jtrend.metric_direction(
            name), name


def test_band_constants_and_rules_are_the_jax_gate_s():
    assert (trend.WINDOW, trend.MAD_K, trend.REL_FLOOR, trend.MIN_HISTORY) \
        == (jtrend.WINDOW, jtrend.MAD_K, jtrend.REL_FLOOR, jtrend.MIN_HISTORY)
    assert trend._EXPLICIT == jtrend._EXPLICIT
    assert trend._RULES == jtrend._RULES
    assert trend.HISTORY_FILE == "BENCH_TORCH_HISTORY.jsonl"
    assert jtrend.HISTORY_FILE != trend.HISTORY_FILE


# ------------------------------------------------------------------ the band


def test_twenty_percent_regression_is_flagged_and_noise_is_not():
    history = _hist("streamed_s", [1.00, 1.02, 0.99, 1.01, 0.98, 1.00])
    bad = trend.check_trend(history, {"streamed_s": 1.20})
    assert not bad["ok"]
    assert bad["regressions"][0]["metric"] == "streamed_s"
    quiet = trend.check_trend(history, {"streamed_s": 1.02})
    assert quiet["ok"] and not quiet["regressions"]
    better = trend.check_trend(history, {"streamed_s": 0.80})
    assert better["ok"]
    assert better["improvements"][0]["metric"] == "streamed_s"


def test_direction_awareness_for_throughput():
    history = _hist("gram_tflops_staged", [100, 102, 99, 101, 98, 100])
    drop = trend.check_trend(history, {"gram_tflops_staged": 80.0})
    assert not drop["ok"]
    rise = trend.check_trend(history, {"gram_tflops_staged": 120.0})
    assert rise["ok"] and rise["improvements"]


def test_noisy_metric_gets_a_wider_band():
    noisy = _hist("streamed_s", [1.0, 1.8, 0.9, 1.7, 1.1, 1.6])
    r = trend.check_trend(noisy, {"streamed_s": 2.0})
    assert r["ok"], r["regressions"]
    stable = _hist("streamed_s", [1.0, 1.01, 0.99, 1.0, 1.0, 1.01])
    r2 = trend.check_trend(stable, {"streamed_s": 2.0})
    assert not r2["ok"]


def test_boolean_gate_and_short_history():
    history = _hist("sketch_ok", [True, True, True])
    assert not trend.check_trend(history, {"sketch_ok": False})["ok"]
    assert trend.check_trend(history, {"sketch_ok": True})["ok"]
    short = _hist("streamed_s", [1.0, 1.0])
    r = trend.check_trend(short, {"streamed_s": 9.0})
    assert r["ok"]
    assert any("history too short" in s["why"] for s in r["skipped"])


def test_a_history_of_one_skips_numbers_and_holds_booleans():
    """What ``bench_torch.py --trend`` meets on its second run: one
    record before it — every number skipped (MIN_HISTORY not met), the
    ``*_ok`` gates held."""
    one = [{"t_unix": 1.0, "run": {"backend": "cuda"},
            "metrics": {"value": 0.2, "lint_ok": True, "sketch_ok": True}}]
    r = trend.check_trend(one, {"value": 9.0, "lint_ok": True,
                                "sketch_ok": True}, backend="cuda")
    assert r["ok"] and r["checked"] == 2
    assert any(s["metric"] == "value" and "history too short" in s["why"]
               for s in r["skipped"])
    assert not trend.check_trend(one, {"lint_ok": False},
                                 backend="cuda")["ok"]


def test_backend_filter_keeps_environments_apart():
    card = [{"t_unix": float(i), "run": {"backend": "cuda"},
             "metrics": {"streamed_s": v}}
            for i, v in enumerate([1.0, 1.01, 0.99, 1.0])]
    cpu_value = 400.0
    cand = {"run": {"backend": "cpu"}, "metrics": {"streamed_s": cpu_value}}
    r = trend.check_trend(card, cand, backend="cpu")
    assert r["ok"] and any("history too short" in s["why"]
                           for s in r["skipped"])
    mixed = card + [{"t_unix": 9.0, "run": {"backend": "cpu"},
                     "metrics": {"streamed_s": cpu_value}}]
    bad_card = trend.check_trend(mixed, {"streamed_s": 1.2},
                                 backend="cuda")
    assert not bad_card["ok"]


def test_check_and_count_defaults_to_candidate_backend(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    with open(path, "w") as f:
        for i, v in enumerate([1.0, 1.0, 1.0, 1.0]):
            f.write(json.dumps({"t_unix": float(i),
                                "run": {"backend": "cuda"},
                                "metrics": {"streamed_s": v}}) + "\n")
        f.write(json.dumps({"t_unix": 9.0, "run": {"backend": "cpu"},
                            "metrics": {"streamed_s": 400.0}}) + "\n")
    report = trend.check_and_count(path)
    assert report["ok"]


def test_new_and_untracked_metrics_never_gate():
    history = _hist("streamed_s", [1.0] * 5)
    r = trend.check_trend(history, {"brand_new_s": 5.0,
                                    "tunnel_mb_s": 3.0,
                                    "note_string": "hi"})
    assert r["ok"]


# ---------------------------------------------------------------- substrate


def test_append_load_round_trip_and_torn_tail(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    rec = trend.append_history(path, {"streamed_s": 1.5, "sketch_ok": True,
                                      "metric": "a_string",
                                      "telemetry": {"blocks": 64}},
                               run_meta={"argv": ["--trend"],
                                         "backend": "cuda"})
    assert rec["metrics"] == {"streamed_s": 1.5, "sketch_ok": True}
    assert rec["run"]["argv"] == ["--trend"]
    assert rec["run"]["backend"] == "cuda"
    assert "platform" in rec["run"] and "git_sha" in rec["run"]
    with open(path, "a") as f:
        f.write('{"torn": ')
    loaded = trend.load_history(path)
    assert len(loaded) == 1 and loaded[0]["metrics"]["streamed_s"] == 1.5


def test_ingest_takes_headlines_and_refuses_the_jax_rounds(tmp_path):
    """Saved headlines of the port's runs backfill the history, tagged
    cuda; the JAX package's archived rounds are TPU numbers and are
    refused, naming the file."""
    head = tmp_path / "headline.json"
    head.write_text(json.dumps({"value": 0.2, "streamed_s": 1.0,
                                "metric": "ibs_pcoa_chip_2504x1M"}))
    records = trend.ingest_bench_files([str(head)])
    assert len(records) == 1
    assert records[0]["run"]["backend"] == "cuda"
    assert records[0]["metrics"] == {"value": 0.2, "streamed_s": 1.0}
    jax_round = os.path.join(REPO, "BENCH_r02.json")
    with pytest.raises(ValueError, match="BENCH_r02.json"):
        trend.ingest_bench_files([str(head), jax_round])


def test_the_port_s_history_holds_card_and_cpu_records_only():
    """BENCH_TORCH_HISTORY.jsonl holds the port's own runs: backends
    ``cuda`` (each naming its card and power limit) and ``cpu`` only,
    never the JAX package's TPU records; its newest record passes the
    gate against its own backend's past."""
    path = os.path.join(REPO, trend.HISTORY_FILE)
    history = trend.load_history(path)
    assert history, "the port's history holds no record"
    backends = {h["run"].get("backend") for h in history}
    assert backends <= {"cuda", "cpu"}, backends
    # The default headline's keys and those of the ported rows (each
    # flag's keys as bench.py's main writes them).
    from test_torch_bench_rows import FLAG_ROWS, jax_headline_keys

    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    keys = set(__import__("bench_torch").HEADLINE_KEYS) | {"trend_ok"}
    for flag in FLAG_ROWS:
        keys |= jax_headline_keys((src, ast.parse(src)), flag)
    for h in history:
        if h["run"]["backend"] == "cuda":
            assert " W" in h["run"]["card"], h["run"]
            assert set(h["metrics"]) <= keys, set(h["metrics"]) - keys
    report = trend.check_and_count(path)
    assert report["ok"], report["regressions"]


def test_the_gate_filters_a_mixed_history_by_backend(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    for i, v in enumerate([0.20, 0.21, 0.20, 0.19]):
        trend.append_history(path, {"value": v},
                             run_meta={"backend": "cuda"})
    trend.append_history(path, {"value": 40.0}, run_meta={"backend": "cpu"})
    # The card's candidate ignores the CPU record; the CPU candidate has
    # no CPU past.
    assert not trend.check_and_count(path, {"value": 0.3},
                                     backend="cuda")["ok"]
    assert trend.check_and_count(path, {"value": 0.2},
                                 backend="cuda")["ok"]
    assert trend.check_and_count(path)["ok"]  # newest: the CPU record


# ----------------------------------------------------------------------- CLI


def test_cli_check_exits_nonzero_on_regression(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    with open(path, "w") as f:
        for rec in _hist("streamed_s", [1.0, 1.01, 0.99, 1.02, 1.0]):
            f.write(json.dumps(rec) + "\n")
    cand = tmp_path / "cand.json"

    def run(value):
        cand.write_text(json.dumps({"streamed_s": value}))
        return _run_cli("check", "--history", path, "--candidate",
                        str(cand))

    ok = run(1.0)
    assert ok.returncode == 0, ok.stderr
    bad = run(1.2)
    assert bad.returncode == 1
    assert "REGRESSION streamed_s" in bad.stderr
    report = json.loads(bad.stdout)
    assert report["regressions"][0]["direction"] == "lower_is_better"


def test_cli_ingest_appends_and_refuses_rounds(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    heads = []
    for i in range(2):
        head = tmp_path / f"h{i}.json"
        head.write_text(json.dumps({"value": 0.2 + i / 100}))
        heads.append(str(head))
    p = _run_cli("ingest", "--history", path, *heads)
    assert p.returncode == 0, p.stderr
    assert len(trend.load_history(path)) == 2
    bad = _run_cli("ingest", "--history", path,
                   os.path.join(REPO, "BENCH_r03.json"))
    assert bad.returncode == 2
    assert "BENCH_r03.json" in bad.stderr
    assert len(trend.load_history(path)) == 2


def test_cli_usage_error_exits_2():
    assert _run_cli().returncode == 2
    assert _run_cli("bogus-verb").returncode == 2


# ------------------------------------------------------------- telemetry tie


def test_check_and_count_mirrors_into_telemetry(tmp_path):
    from spark_examples_tpu_torch.core import telemetry

    telemetry.reset()
    path = str(tmp_path / "hist.jsonl")
    with open(path, "w") as f:
        for rec in _hist("streamed_s", [1.0, 1.0, 1.0, 1.0]):
            f.write(json.dumps(rec) + "\n")
    report = trend.check_and_count(path, {"streamed_s": 2.0})
    assert not report["ok"]
    assert telemetry.counter_value("trend.metrics_checked") == 1
    assert telemetry.counter_value("trend.regressions") == 1
    telemetry.reset()


def test_trend_names_are_declared_as_the_jax_package_s():
    from spark_examples_tpu.core import telemetry as jtelemetry
    from spark_examples_tpu_torch.core import telemetry

    for name in ("trend.metrics_checked", "trend.regressions"):
        assert telemetry.NAMES[name][0] == jtelemetry.NAMES[name][0]
        assert name not in telemetry.PORT_NAMES
