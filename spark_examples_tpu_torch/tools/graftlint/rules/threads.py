"""thread-hygiene — threads the leak accounting can see.

Historical contract: the chaos soak's per-round leak accounting compares
live threads against a baseline BY NAME PREFIX. A ``threading.Thread``
created without ``daemon=`` blocks interpreter exit on a crash path, and
one without a ``name`` (or with a prefix the accounting table does not
cover) is a leak the accounting structurally cannot see.

Checks every ``threading.Thread(...)`` call (and
``ThreadPoolExecutor``'s ``thread_name_prefix``): ``daemon=`` must be
explicit, ``name=`` must be present, and a statically-known name prefix
must be covered by :data:`THREAD_FAMILIES`: the port's soak harness's
``_SUSPECT_THREADS`` (parsed from the AST of
``spark_examples_tpu_torch/tools/soak.py``, no import, so the rule loads
no torch), as the JAX suite parses its table from ``tools/soak.py``,
then the families only the port names (:data:`PORT_FAMILIES`). Dynamic
prefixes (``thread_name_prefix=name``) are left to review.
"""

from __future__ import annotations

import ast
import pathlib

from spark_examples_tpu_torch.tools.graftlint.engine import (
    Context,
    Rule,
    SourceFile,
    register,
)
from spark_examples_tpu_torch.tools.graftlint.astutil import (
    dotted,
    import_aliases,
)

_SOAK = pathlib.Path(__file__).resolve().parents[2] / "soak.py"


def soak_thread_prefixes(path: pathlib.Path = _SOAK) -> tuple[str, ...]:
    """The soak harness's ``_SUSPECT_THREADS`` table, read from its
    source."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name)
                        and t.id == "_SUSPECT_THREADS"
                        for t in node.targets)):
            return tuple(ast.literal_eval(node.value))
    raise ValueError(f"{path} has no _SUSPECT_THREADS table")


# Thread families only the port names: its pooled workers and the chip
# smoke's build thread.
PORT_FAMILIES = ("vcf-parse", "block-stripe", "compact-chunk",
                 "neighbors-eval", "chip-smoke")
# Thread-name prefixes of the port's long-lived and pooled thread
# families: the soak harness's table, then the port's own.
THREAD_FAMILIES = soak_thread_prefixes() + PORT_FAMILIES


def _static_prefix(expr: ast.AST) -> str | None:
    """The statically-known leading part of a thread name: a literal,
    or an f-string's leading constant fragment. None = fully dynamic."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr) and expr.values:
        head = expr.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value
    return None


@register
class ThreadHygieneRule(Rule):
    id = "thread-hygiene"
    invariant = ("threads carry daemon= and a name whose prefix the "
                 "port's thread table (THREAD_FAMILIES) covers")
    hint = ("pass daemon= and name='<prefix>-...' where <prefix> is in "
            "THREAD_FAMILIES (tools/graftlint/rules/threads.py; extend "
            "the table for a new thread family)")

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        thread_names = {"threading.Thread"} | import_aliases(
            src.tree, "threading.Thread")
        pool_names = {"concurrent.futures.ThreadPoolExecutor",
                      "futures.ThreadPoolExecutor"} | import_aliases(
            src.tree, "concurrent.futures.ThreadPoolExecutor")
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in thread_names:
                yield from self._check_thread(src, node)
            elif d in pool_names:
                yield from self._check_pool(src, node)

    def _check_thread(self, src, call: ast.Call):
        kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}
        if "daemon" not in kwargs:
            yield self.finding(
                src, call,
                "threading.Thread without daemon= — an implicit "
                "non-daemon thread blocks interpreter exit on every "
                "crash path")
        if "name" not in kwargs:
            yield self.finding(
                src, call,
                "threading.Thread without name= — the leak accounting "
                "tracks threads by name prefix; an anonymous thread is a "
                "leak it cannot see")
            return
        yield from self._check_prefix(src, kwargs["name"], "thread name")

    def _check_pool(self, src, call: ast.Call):
        kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}
        if "thread_name_prefix" not in kwargs:
            yield self.finding(
                src, call,
                "ThreadPoolExecutor without thread_name_prefix= — its "
                "anonymous workers are invisible to the leak "
                "accounting")
            return
        yield from self._check_prefix(src, kwargs["thread_name_prefix"],
                                      "thread_name_prefix")

    def _check_prefix(self, src, name_expr, what):
        prefix = _static_prefix(name_expr)
        if prefix is None:
            return  # fully dynamic: review-time, not lint-time
        if not prefix.startswith(THREAD_FAMILIES):
            yield self.finding(
                src, name_expr,
                f"{what} {prefix!r} is outside the leak accounting "
                "(THREAD_FAMILIES covers none of it)")
