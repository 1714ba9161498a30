"""registry-literal — hand-enumerated registry values drift.

Historical bug: the CLI shipped with a hard-coded ``--metric``
``choices`` list, so a freshly registered kernel (Jaccard) was
unreachable from the command line until a verify drive noticed. The
same failure mode exists for every enum family that has a single
source of truth: a literal collection re-listing its members goes
silently stale the day the registry grows.

The rule flags any list/tuple/set literal of >= 2 distinct strings
drawn entirely from one registry family — the port's kernel names (the
live ``spark_examples_tpu_torch.kernels`` registry) or one of the nine
enum tuples of ``spark_examples_tpu_torch.core.config`` (solver ladder,
store codecs, tile2d transports, gram modes, eigh modes, braycurtis
methods, backends, pack streams, priority classes) — anywhere outside
the family's defining module. Consumers must derive from the registry
(``list(kernels.names())``, ``config.SOLVER_LADDER``, ...). The JAX
suite's logic, over the port's registries.
"""

from __future__ import annotations

import ast

from spark_examples_tpu_torch.tools.graftlint.engine import (
    PACKAGE,
    Context,
    Rule,
    SourceFile,
    register,
)

KERNELS_MOD = PACKAGE + ".kernels"


@register
class RegistryLiteralRule(Rule):
    id = "registry-literal"
    invariant = ("enum collections are derived from their registry "
                 "(kernels.names(), core.config's enum tuples), never "
                 "re-listed as literals")
    hint = ("derive from the registry: list(kernels.names()), "
            "config.SOLVER_LADDER, config.STORE_CODEC_SPECS, "
            "config.TILE2D_TRANSPORTS, ...")

    def _families(self, ctx: Context):
        fams = [("kernel", ctx.kernel_names(), KERNELS_MOD)]
        for label, (values, mod) in ctx.config_enums().items():
            fams.append((label, frozenset(values), mod))
        return fams

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        families = self._families(ctx)
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.List, ast.Tuple, ast.Set)):
                continue
            if len(node.elts) < 2:
                continue
            values = [e.value for e in node.elts
                      if isinstance(e, ast.Constant)
                      and isinstance(e.value, str)]
            if len(values) != len(node.elts):
                continue  # a non-string element: not an enum listing
            distinct = set(values)
            if len(distinct) < 2:
                continue
            for label, members, defining in families:
                if distinct <= members:
                    if src.module and (
                            src.module == defining
                            or src.module.startswith(defining + ".")):
                        break  # the registry defining itself
                    yield self.finding(
                        src, node,
                        f"literal collection of {label} registry values "
                        f"{sorted(distinct)} outside {defining} — it "
                        "goes stale when the registry grows (the "
                        "unreachable-Jaccard class)",
                        family=label, values=sorted(distinct))
                    break
