"""blocking-under-lock — slow or re-entrant-hostile work inside a lock.

Historical bug: the SIGTERM drain path flushed telemetry while the
module lock was already held by the thread the signal interrupted — the
flush needed the same lock and the process deadlocked inside its own
shutdown handler. The general class: file I/O, sleeps, subprocess or
socket calls, or device work lexically inside a ``with <lock>:`` body
(or between ``lock.acquire()``/``lock.release()``) turns every other
contender — including signal handlers and watchdog threads — into a
hostage of that call's latency or failure.

The port's form of "device work": where the JAX suite names jax
dispatch (``jax.*``/``jnp.*`` calls, ``device_put``,
``block_until_ready``), this rule names ``torch.*`` calls and the
tensor methods that wait for the card (``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``, ``.synchronize()``).

Lexical and deliberately shallow: a call that *leads to* I/O through
another function is not flagged (that function's own lock usage is).
Deliberate short-critical-section writes carry a reasoned suppression.
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


_LOCK_WORDS = frozenset(("lock", "locks", "rlock", "mutex"))


def _lock_named(identifier: str) -> bool:
    """'lock' as a whole underscore-separated word — self._lock, _LOCK,
    stats.lock, _lock_for, _locks_guard — but NOT the substring inside
    this codebase's 'block*' vocabulary (block_reader, blocks, ...)."""
    return any(part in _LOCK_WORDS
               for part in identifier.lower().split("_"))


def _is_lockish(expr: ast.AST) -> bool:
    """The with-item / receiver smells like a lock."""
    if isinstance(expr, ast.Call):
        return _is_lockish(expr.func)
    if isinstance(expr, ast.Attribute):
        return _lock_named(expr.attr)
    if isinstance(expr, ast.Name):
        return _lock_named(expr.id)
    return False


_BLOCKING_PREFIXES = ("subprocess.", "socket.", "shutil.")
_BLOCKING_EXACT = ("time.sleep", "os.fsync", "open")
# Tensor methods that wait for the card (a device-to-host copy or a
# synchronize) beside the file and socket ones.
_BLOCKING_METHODS = ("write_text", "read_text", "write_bytes",
                     "read_bytes", "recv", "send", "sendall", "accept",
                     "connect", "item", "cpu", "tolist", "numpy",
                     "synchronize")


def _blocking_reason(call: ast.Call) -> str | None:
    d = dotted(call.func)
    if d:
        if d in _BLOCKING_EXACT:
            return f"{d}()"
        for p in _BLOCKING_PREFIXES:
            if d.startswith(p):
                return f"{d}()"
        if d.startswith("torch."):
            return f"torch call {d}()"
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in _BLOCKING_METHODS:
        return f".{call.func.attr}()"
    return None


def _calls_in(node: ast.AST, *, skip_nested_defs: bool = True):
    """Calls lexically under ``node``, excluding nested function/lambda
    bodies (deferred execution does not run under the lock)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if skip_nested_defs and isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


@register
class BlockingUnderLockRule(Rule):
    id = "blocking-under-lock"
    invariant = ("no file I/O, sleeps, subprocess/socket calls, torch.* "
                 "calls or tensor methods that wait for the card (.item, "
                 ".cpu, .tolist, .numpy, .synchronize) inside a lock's "
                 "critical section")
    hint = ("move the blocking work outside the critical section "
            "(snapshot under the lock, write after releasing), or "
            "suppress with the reason the section must stay atomic")

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        seen: set[int] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.With) and any(
                    _is_lockish(item.context_expr)
                    for item in node.items):
                lock_txt = src.segment(node.items[0].context_expr)
                for call in _calls_in(node):
                    if id(call) in seen:
                        continue
                    reason = _blocking_reason(call)
                    if reason:
                        seen.add(id(call))
                        yield self.finding(
                            src, call,
                            f"{reason} inside `with {lock_txt}:` — "
                            "every contender (including signal/"
                            "shutdown paths) blocks on this call (the "
                            "SIGTERM-flush deadlock class)",
                            op=reason)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Module)):
                yield from self._acquire_release(src, node, seen)

    def _acquire_release(self, src: SourceFile, scope: ast.AST,
                         seen: set[int]):
        """Explicit acquire()/release() pairs on a lock-named receiver:
        blocking calls positioned between them are inside the critical
        section (try/finally shapes included — the scan is positional,
        matching how the code actually executes on the happy path)."""
        calls = sorted(
            _calls_in(scope),
            key=lambda c: (c.lineno, c.col_offset))
        open_at: dict[str, tuple[int, int]] = {}
        regions: list[tuple[str, tuple[int, int], tuple[int, int]]] = []
        for c in calls:
            if isinstance(c.func, ast.Attribute) and _is_lockish(
                    c.func.value):
                recv = src.segment(c.func.value)
                if c.func.attr == "acquire":
                    open_at[recv] = (c.lineno, c.col_offset)
                elif c.func.attr == "release" and recv in open_at:
                    regions.append((recv, open_at.pop(recv),
                                    (c.lineno, c.col_offset)))
        for c in calls:
            if id(c) in seen:
                continue
            reason = _blocking_reason(c)
            if not reason:
                continue
            pos = (c.lineno, c.col_offset)
            for recv, lo, hi in regions:
                if lo < pos < hi:
                    seen.add(id(c))
                    yield self.finding(
                        src, c,
                        f"{reason} between {recv}.acquire() (line "
                        f"{lo[0]}) and {recv}.release() (line {hi[0]}) "
                        "— the critical section spans this blocking "
                        "call (the SIGTERM-flush deadlock class)",
                        op=reason)
                    break
