"""atomic-write — durable artifacts must land via tmp + rename.

Historical bug: telemetry's ``metrics.json`` / trace exports were
written in place; a kill mid-write left a torn, unparseable snapshot
exactly when the post-mortem needed it. The repo-wide discipline since:
every durable artifact (manifest, checkpoint, heartbeat, quarantine
ledger, telemetry snapshot, supervisor incident ledger, history) is
written to a tmp name and published with one atomic ``os.replace``.
The JAX suite's logic, unchanged, over the port's modules.

The rule flags ``open(path, "w"/"wb")`` and ``Path.write_text/_bytes``
where the path expression's source text names a durable-artifact token
but not a tmp staging name, and the enclosing function performs no
``os.replace``/``os.rename`` (i.e. it is not itself the atomic-publish
helper).
"""

from __future__ import annotations

import ast

from spark_examples_tpu_torch.tools.graftlint.engine import (
    Context,
    Rule,
    SourceFile,
    register,
)
from spark_examples_tpu_torch.tools.graftlint.astutil import dotted

_DURABLE_TOKENS = ("manifest", "checkpoint", "heartbeat", "quarantine",
                   "metrics", "trace", "supervisor", "history",
                   "ledger", "snapshot", "telemetry")


def _scope_calls(scope: ast.AST):
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _write_mode(call: ast.Call) -> bool:
    """open(...) in a truncating write mode."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    return (isinstance(mode, ast.Constant)
            and isinstance(mode.value, str)
            and mode.value.startswith("w"))


@register
class AtomicWriteRule(Rule):
    id = "atomic-write"
    invariant = ("durable artifacts are published tmp + os.replace, "
                 "never written in place")
    hint = ("write to a tmp sibling and os.replace() it into place "
            "(see core/telemetry.py _atomic_write, store/writer.py), so "
            "a kill mid-write leaves the last-good file readable")

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        scopes = [src.tree] + [
            n for n in ast.walk(src.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            calls = list(_scope_calls(scope))
            atomic_scope = any(
                dotted(c.func) in ("os.replace", "os.rename")
                for c in calls)
            if atomic_scope:
                # The scope stages a tmp file and publishes atomically;
                # its raw writes are the staging half of the protocol.
                continue
            for call in calls:
                d = dotted(call.func)
                path_expr = None
                via = None
                if d == "open" and call.args and _write_mode(call):
                    path_expr, via = call.args[0], "open(..., 'w')"
                elif isinstance(call.func, ast.Attribute) and \
                        call.func.attr in ("write_text", "write_bytes"):
                    path_expr = call.func.value
                    via = f".{call.func.attr}()"
                if path_expr is None:
                    continue
                text = src.segment(path_expr).lower()
                if "tmp" in text:
                    continue
                token = next((t for t in _DURABLE_TOKENS if t in text),
                             None)
                if token is None:
                    continue
                yield self.finding(
                    src, call,
                    f"raw {via} to a durable artifact path "
                    f"({src.segment(path_expr)!r} names {token!r}) — a "
                    "kill mid-write tears it (the torn-snapshot class)",
                    token=token)
