"""The names lint of tests/test_telemetry_names.py, walking the port.

Every metric name a telemetry call site in ``spark_examples_tpu_torch/``
passes must be declared in ``telemetry.NAMES`` (a literal, or a literal
prefix of a declared ``.*`` family); every site ``faults.fire`` is
called with must be in ``faults.SITES``, every declared site must be
fired somewhere in the port and armed by at least one port test
(a ``site:kind`` spec string under tests/test_torch_*.py). The
registry is well formed and every entry is declared in the JAX
package's registry too.
"""

import ast
import pathlib
import re

from spark_examples_tpu.core import faults as jfaults
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu_torch.core import faults, telemetry

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "spark_examples_tpu_torch"

# telemetry functions whose first argument is a metric name.
_NAMED = {"count", "observe", "gauge_set", "span", "begin", "span_at",
          "event", "traced"}


def _calls(module: str, funcs: set[str]):
    """(path, line, first argument node) of every ``<module>.<func>(...)``
    call in the port's sources."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in funcs
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == module and node.args):
                yield path, node.lineno, node.args[0]


def _where(path, line) -> str:
    return f"{path.relative_to(REPO)}:{line}"


def test_every_used_name_is_declared():
    undeclared, dynamic, seen = [], [], 0
    for path, line, arg in _calls("telemetry", _NAMED):
        seen += 1
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if not telemetry.is_declared(arg.value):
                undeclared.append(f"{_where(path, line)}: {arg.value!r}")
        elif (isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add)
              and isinstance(arg.left, ast.Constant)
              and isinstance(arg.left.value, str)):
            # "phase." + name: the literal prefix must be a family.
            if arg.left.value + "*" not in telemetry.NAMES:
                undeclared.append(
                    f"{_where(path, line)}: {arg.left.value!r} + ...")
        elif isinstance(arg, ast.JoinedStr):
            dynamic.append(_where(path, line))
        # A bare variable (PhaseTimer.add's counter) is checked at run
        # time: an undeclared name warns and counts.
    assert seen > 40, seen
    assert not undeclared, (
        "telemetry names used but not declared in telemetry.NAMES: "
        + "; ".join(undeclared))
    assert not dynamic, ("telemetry call sites must not pass f-string "
                         "names: " + "; ".join(dynamic))


def test_every_fault_site_is_declared_and_fired():
    fired, bad = set(), []
    for path, line, arg in _calls("faults", {"fire"}):
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            fired.add(arg.value)
            if arg.value not in faults.SITES:
                bad.append(f"{_where(path, line)}: {arg.value!r}")
        else:
            bad.append(f"{_where(path, line)}: not a literal site")
    assert not bad, "undeclared or dynamic fault sites: " + "; ".join(bad)
    assert fired == set(faults.SITES), (
        "declared fault sites never fired in the port: "
        f"{set(faults.SITES) - fired}")


def test_every_fault_site_is_armed_by_a_port_test():
    constants = set()
    for path in REPO.glob("tests/test_torch_*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                constants.add(node.value)
    unarmed = [site for site in faults.SITES
               if not any(f"{site}:{kind}" in s for s in constants
                          for kind in faults.KINDS)]
    assert not unarmed, ("fault sites never armed by a port test: "
                         + ", ".join(unarmed))


def test_sites_and_names_are_the_jax_package_s():
    assert set(faults.SITES) <= set(jfaults.SITES)
    assert faults.KINDS == jfaults.KINDS
    assert all(jtelemetry.is_declared(n) for n in telemetry.NAMES)
    assert telemetry.KINDS == jtelemetry.KINDS


def test_registry_is_well_formed():
    assert telemetry.NAMES
    for name, (kind, desc) in telemetry.NAMES.items():
        assert kind in telemetry.KINDS, (name, kind)
        assert isinstance(desc, str) and len(desc) > 10, name
        assert re.fullmatch(r"[a-z0-9_.]+(\.\*)?", name), name
        if name.endswith(".*"):
            assert len(name) > 2, name
        if kind == "span" and not name.endswith(".*"):
            assert jtelemetry.NAMES[name][0] == "span", name


def test_port_only_names_are_apart_from_jax_s():
    """``PORT_NAMES`` holds what only the port counts (its CUDA kernels'
    launches, the collective backend of a job of several processes):
    well formed, declared here, unknown to the JAX package and never in
    ``NAMES``."""
    assert {"kernel.packed_gram.launches",
            "multihost.backend"} <= set(telemetry.PORT_NAMES)
    assert telemetry.PORT_NAMES["multihost.backend"][0] == "gauge"
    for name, (kind, desc) in telemetry.PORT_NAMES.items():
        assert kind in telemetry.KINDS, (name, kind)
        assert isinstance(desc, str) and len(desc) > 10, name
        assert re.fullmatch(r"[a-z0-9_.]+", name), name
        assert telemetry.is_declared(name), name
        assert name not in telemetry.NAMES, name
        assert not jtelemetry.is_declared(name), name


SLICE_NAMES = (
    "supervisor.restarts", "supervisor.stalls", "supervisor.heartbeats",
    "live.proxy_requests", "live.proxy_stale", "fleet.stage",
    "fleet.restage_total", "fleet.evictions", "fleet.shard_stages",
    "fleet.cache_namespace_evictions", "fleet.hedge_launched",
    "fleet.hedge_wins", "fleet.failovers", "fleet.routes",
    "fleet.pool_bytes", "fleet.pool_pressure", "fleet.panel_over_budget_x",
    "fleet.route.*", "serve.priority.preemptions",
    "serve.priority.shed_interactive", "serve.priority.shed_batch",
    "serve.priority.depth_interactive", "serve.priority.depth_batch",
    "trace.queue", "trace.compute", "trace.hedge", "neighbors.requests",
)


def test_supervision_and_fleet_names_are_jax_s():
    """The supervision, live-proxy, fleet and priority names the slice's
    modules emit: declared with the JAX package's kind and help text,
    and the supervision/fleet fault sites beside the earlier eleven (with
    the fleet controller's two and the multi-host consensus, all 16 of
    JAX's)."""
    for name in SLICE_NAMES:
        assert telemetry.NAMES[name] == jtelemetry.NAMES[name], name
    assert telemetry.is_declared("fleet.route.r-ibs.queue_depth")
    assert {"supervisor.heartbeat", "fleet.stage"} <= set(faults.SITES)
    assert len(faults.SITES) == 16


CONTROLLER_NAMES = (
    "controller.step", "controller.spawn", "controller.scrapes",
    "controller.scrape_stale", "controller.respawns",
    "controller.scale_ups", "controller.retires", "controller.preemptions",
    "controller.incidents", "controller.ledger_rotations",
    "controller.replicas", "controller.ready",
    "controller.flap_breaker_open", "timeline.rounds", "timeline.markers",
    "timeline.compactions", "timeline.write_errors", "timeline.bytes",
    "timeline.fleet_p99_s", "timeline.fleet_queue_depth",
    "timeline.fleet_shed_rate", "timeline.route.*", "slo.breaches",
    "slo.ok", "slo.*",
)


def test_controller_timeline_and_slo_names_are_jax_s():
    """The fleet controller's, its timeline's and its SLO evaluator's
    names: every one the JAX package declares under those prefixes,
    with its kind and help text; the per-route and per-objective
    families resolve; the controller's two fault sites are declared and
    no JAX site is missing."""
    for name in CONTROLLER_NAMES:
        assert telemetry.NAMES[name] == jtelemetry.NAMES[name], name
    jax_names = {n for n in jtelemetry.NAMES
                 if n.split(".")[0] in ("controller", "timeline", "slo")}
    assert jax_names == set(CONTROLLER_NAMES)
    assert telemetry.is_declared("timeline.route.r-ibs.p99_s")
    assert telemetry.is_declared("slo.fleet.fast_burn")
    assert {"controller.scrape", "controller.spawn"} <= set(faults.SITES)
    assert set(jfaults.SITES) - set(faults.SITES) == set()


def test_multihost_names_and_digest_are_jax_s():
    """The consensus span and the shard-feed counter carry JAX's kind and
    help text, and the digest JAX's keys (``consensus_wait_p95_s`` with
    them)."""
    for name in ("multihost.consensus", "multihost.shard_feed_bytes",
                 "gram.pad_step"):
        assert telemetry.NAMES[name][0] == jtelemetry.NAMES[name][0], name
    for name in ("multihost.consensus", "multihost.shard_feed_bytes"):
        assert telemetry.NAMES[name] == jtelemetry.NAMES[name], name
    assert set(telemetry.digest()) == set(jtelemetry.digest())
