"""telemetry-name / fault-site — canonical-name discipline, on the AST.

Historical contract: every telemetry name used at a call site must be
declared in the telemetry registry (a typo silently forks a metric
series), and every ``faults.fire`` site must be declared in
``faults.SITES`` (an undeclared site is unarm-able from the env grammar
— a recovery path the chaos harness can never reach). Regex lints
enforced this for single-line literal call sites only; these AST rules
also see through

- **aliasing**: ``from spark_examples_tpu_torch.core import telemetry
  as t`` (and ``import spark_examples_tpu_torch.core.telemetry as tm``),
- **concatenation**: ``telemetry.count("store." + "healed")`` and
  module-level ``NAME = "..."`` constants,
- **multi-line calls**: the regexes anchored on one line.

The JAX suite's logic over the port's registries: a name is declared
when ``telemetry.is_declared`` says so (``NAMES``, the port's own
``PORT_NAMES`` and the ``family.*`` entries), and ``span_at`` sites are
checked beside the JAX suite's APIs. Genuinely dynamic names (a
variable argument, e.g. ``PhaseTimer``'s ``"phase." + name``) remain
the runtime registry check's job — but an f-string at a call site is a
finding (literal sites must stay literal), and fault SITES must be
static strings outright.

The fault-site rule's finalize (full-tree runs only) also reports
**dead registry entries**: a declared site nothing fires is a
documented injection point the harness can't hit.
"""

from __future__ import annotations

import ast

from spark_examples_tpu_torch.tools.graftlint.engine import (
    PACKAGE,
    Context,
    Finding,
    Rule,
    SourceFile,
    register,
)
from spark_examples_tpu_torch.tools.graftlint.astutil import (
    DYNAMIC,
    call_roots,
    dotted,
    fold_string,
    module_string_env,
)

TELEMETRY_MOD = PACKAGE + ".core.telemetry"
FAULTS_MOD = PACKAGE + ".core.faults"
TELEMETRY_APIS = ("count", "observe", "gauge_set", "event", "begin",
                  "span", "span_at", "traced", "counter_value")


def _has_fstring_hole(node: ast.AST) -> bool:
    return any(isinstance(n, ast.FormattedValue)
               for n in ast.walk(node))


def _api_calls(src: SourceFile, module: str, apis):
    roots = call_roots(src.tree, module)
    if not roots:
        return
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d is None or "." not in d:
            continue
        root, _, leaf = d.rpartition(".")
        if root in roots and leaf in apis:
            yield node, leaf


@register
class TelemetryNameRule(Rule):
    id = "telemetry-name"
    invariant = ("every telemetry name at a call site is declared in "
                 "the port's telemetry registry (NAMES, PORT_NAMES); "
                 "literal sites stay literal")
    hint = ("add the name to telemetry.NAMES (core/telemetry.py; "
            "PORT_NAMES for a name only the port emits) — or "
            "for a dynamic family, declare the 'family.*' entry and "
            "pass the dynamic part as attrs, not an f-string")

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        env = None
        for call, api in _api_calls(src, TELEMETRY_MOD, TELEMETRY_APIS):
            if not call.args:
                continue
            if env is None:
                env = module_string_env(src.tree)
            name_expr = call.args[0]
            folded = fold_string(name_expr, env)
            if isinstance(folded, str):
                if not ctx.telemetry().is_declared(folded):
                    yield self.finding(
                        src, name_expr,
                        f"telemetry.{api}({folded!r}): name not "
                        "declared in the telemetry registry — an "
                        "undeclared name forks a metric series nobody "
                        "joins back",
                        name=folded, api=api, dynamic=False)
            elif folded is DYNAMIC and _has_fstring_hole(name_expr):
                yield self.finding(
                    src, name_expr,
                    f"telemetry.{api}(f\"...\"): an f-string name "
                    "cannot be statically checked — literal sites must "
                    "stay literal (use attrs for the dynamic part)",
                    api=api, dynamic=True)


@register
class FaultSiteRule(Rule):
    id = "fault-site"
    invariant = ("every faults.fire site is a literal declared in "
                 "faults.SITES, and every declared site is fired "
                 "somewhere")
    hint = ("declare the site in faults.SITES (core/faults.py) so "
            "specs can arm it; sites must be static strings — the "
            "harness docs and chaos specs reference them by grep")

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        env = None
        fired = ctx.data.setdefault("fired_fault_sites", set())
        for call, _api in _api_calls(src, FAULTS_MOD, ("fire",)):
            if not call.args:
                continue
            if env is None:
                env = module_string_env(src.tree)
            site_expr = call.args[0]
            folded = fold_string(site_expr, env)
            if isinstance(folded, str):
                fired.add(folded)
                if folded not in ctx.faults().SITES:
                    yield self.finding(
                        src, site_expr,
                        f"faults.fire({folded!r}): site not declared "
                        "in faults.SITES — an undeclared site is "
                        "unarm-able from the env grammar",
                        site=folded, dynamic=False)
            else:
                yield self.finding(
                    src, site_expr,
                    "faults.fire with a non-literal site — sites must "
                    "be greppable constants for the harness's docs and "
                    "specs to reference",
                    dynamic=True)

    def finalize(self, ctx: Context):
        fired = ctx.data.get("fired_fault_sites", set())
        dead = sorted(set(ctx.faults().SITES) - fired)
        if not dead:
            return
        # Anchor at the SITES assignment in core/faults.py.
        src = next((f for f in ctx.files
                    if f.module == FAULTS_MOD), None)
        path, line, col = FAULTS_MOD.replace(".", "/") + ".py", 1, 1
        if src is not None:
            path = src.rel
            if src.tree is not None:
                for node in src.tree.body:
                    if isinstance(node, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id == "SITES"
                            for t in node.targets):
                        line, col = node.lineno, node.col_offset + 1
                        break
        yield Finding(
            path=path, line=line, col=col, rule=self.id,
            message=f"declared fault sites never fired in code: {dead} "
                    "— a dead registry entry documents an injection "
                    "point the harness can't hit",
            hint="fire the site in the recovery path it documents, or "
                 "drop the registry entry",
            data={"dead": dead})
