"""donation-safety — the in-place accumulator contract of ``ops/gram.py``.

Historical bug: the sharded PCoA finalize donated jit buffers XLA could
never alias, and a donation that DID take effect on a buffer the caller
still read would have returned garbage silently. The port has no jit
donation; its counterpart is the contract of ``ops/gram.py``: the
gram updaters (``update``, ``update_packed``, ``update_fused``,
``grm_update``, ``grm_tile_update``, and the updaters
``gram.impl_for`` returns) add each block into the caller's
accumulators **in place** (``add_``) and return the same dict. Two
lexical checks, function-scope, follow from it:

- **lost update**: an updater given a temporary accumulator (a fresh
  ``init()``, a comprehension of clones, any expression that is not a
  name, attribute or subscript — a shallow ``dict(acc)`` /
  ``acc.copy()`` / ``{**acc}`` shares the caller's tensors and is no
  temporary) whose result is dropped: the block's work lands in an
  object nobody holds.
- **stale view**: a name bound to a view of an accumulator
  (``acc["cc"]``, a slice or ``.view``/``.T``/``.numpy()`` of one, or a
  shallow copy of the dict) before an updater updates that accumulator,
  and read after it in a statement that also reads the accumulator —
  the compare-old-with-new shape, which silently compares the updated
  value with itself (the PyTorch form of read-after-donate). A view read
  on its own after the update is taken to want the updated value, and
  a ``.clone()`` is a snapshot, not a view.
"""

from __future__ import annotations

import ast

from spark_examples_tpu_torch.tools.graftlint.astutil import (
    call_roots,
    dotted,
    import_aliases,
    walk_scopes,
)
from spark_examples_tpu_torch.tools.graftlint.engine import (
    PACKAGE,
    Context,
    Rule,
    SourceFile,
    register,
)

GRAM_MOD = PACKAGE + ".ops.gram"
UPDATERS = ("update", "update_packed", "update_fused", "grm_update",
            "grm_tile_update")
# A factory whose result is an in-place updater (acc, block, ...).
_FACTORIES = ("impl_for",)
# Methods that return a view of (or share memory with) their receiver.
_VIEW_METHODS = ("view", "view_as", "reshape", "t", "transpose",
                 "narrow", "diagonal", "detach", "numpy", "get",
                 "squeeze", "unsqueeze", "flatten", "expand", "permute",
                 "as_strided", "select", "contiguous")
_VIEW_ATTRS = ("T", "mT", "data")


def _updater_names(tree: ast.Module, module: str | None):
    """Dotted callee names that are in-place updaters in this file,
    and the local factory names (``gram.impl_for``) whose results are."""
    roots = call_roots(tree, GRAM_MOD)
    updaters, factories = set(), set()
    for leaf in UPDATERS:
        updaters |= {f"{r}.{leaf}" for r in roots}
        updaters |= import_aliases(tree, f"{GRAM_MOD}.{leaf}")
        if module == GRAM_MOD:
            updaters.add(leaf)
    for leaf in _FACTORIES:
        factories |= {f"{r}.{leaf}" for r in roots}
        factories |= import_aliases(tree, f"{GRAM_MOD}.{leaf}")
        if module == GRAM_MOD:
            factories.add(leaf)
    return updaters, factories


def _is_shallow_copy(expr: ast.AST) -> bool:
    """``dict(x)``, ``x.copy()``, ``{**x}``: a new dict holding the same
    tensors — in-place updates through it reach the original."""
    if isinstance(expr, ast.Call):
        if dotted(expr.func) == "dict" and len(expr.args) == 1:
            return True
        if isinstance(expr.func, ast.Attribute) and \
                expr.func.attr == "copy" and not expr.args:
            return True
    return isinstance(expr, ast.Dict) and bool(expr.keys) and all(
        k is None for k in expr.keys)


def _view_root(expr: ast.AST) -> str | None:
    """The accumulator name ``expr`` is a view of (or shares tensors
    with), else None: subscripts, view methods and attributes down to
    a plain name, or a shallow copy of one."""
    if _is_shallow_copy(expr):
        inner = expr.args[0] if isinstance(expr, ast.Call) and \
            dotted(expr.func) == "dict" else (
                expr.func.value if isinstance(expr, ast.Call)
                else expr.values[0])
        return inner.id if isinstance(inner, ast.Name) else None
    seen_view = False
    while True:
        if isinstance(expr, ast.Subscript):
            expr, seen_view = expr.value, True
        elif isinstance(expr, ast.Attribute) and expr.attr in _VIEW_ATTRS:
            expr, seen_view = expr.value, True
        elif isinstance(expr, ast.Call) and isinstance(
                expr.func, ast.Attribute) and \
                expr.func.attr in _VIEW_METHODS:
            expr, seen_view = expr.func.value, True
        else:
            break
    if seen_view and isinstance(expr, ast.Name):
        return expr.id
    return None


def _scope_nodes(scope: ast.AST):
    """All nodes lexically in this scope, excluding nested function
    bodies (they run at another time, against other bindings)."""
    stack = [scope]
    first = True
    while stack:
        node = stack.pop()
        if not first and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        first = False
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _pos(node: ast.AST) -> tuple[int, int]:
    return (node.lineno, node.col_offset)


def _end(node: ast.AST) -> tuple[int, int]:
    return (getattr(node, "end_lineno", node.lineno),
            getattr(node, "end_col_offset", 0))


@register
class DonationSafetyRule(Rule):
    id = "donation-safety"
    invariant = ("the gram updaters' in-place accumulators: never a "
                 "dropped temporary, and no view bound before an update "
                 "compared with the accumulator after it")
    hint = ("pass the accumulator you keep (acc = update(acc, ...)), "
            "and snapshot with .clone() before the update where the "
            "older value is needed — the updaters add_ in place")

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        updaters, factories = _updater_names(src.tree, src.module)
        if not updaters and not factories:
            return
        for scope, _body in walk_scopes(src.tree):
            yield from self._check_scope(src, scope, updaters, factories)

    def _check_scope(self, src: SourceFile, scope: ast.AST,
                     updaters: set, factories: set):
        nodes = list(_scope_nodes(scope))
        local = set()  # names bound to a factory's updater in this scope
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name) and \
                    isinstance(n.value, ast.Call) and \
                    dotted(n.value.func) in factories:
                local.add(n.targets[0].id)
        calls = [n for n in nodes if isinstance(n, ast.Call)
                 and (dotted(n.func) in updaters
                      or (isinstance(n.func, ast.Name)
                          and n.func.id in local))]
        if not calls:
            return
        dropped = {id(n.value) for n in nodes if isinstance(n, ast.Expr)}
        parent = {id(c): n for n in nodes for c in ast.iter_child_nodes(n)}
        # (bound at, view name, accumulator name) of each view binding
        views: list[tuple[tuple[int, int], str, str]] = []
        stores: list[tuple[tuple[int, int], str]] = []
        loads: list[ast.Name] = []
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                acc = _view_root(n.value)
                if acc is not None:
                    views.append((_end(n), n.targets[0].id, acc))
            if isinstance(n, ast.Name):
                if isinstance(n.ctx, ast.Load):
                    loads.append(n)
                elif isinstance(n.ctx, ast.Store):
                    stores.append((_pos(n), n.id))

        reported: set[int] = set()
        for call in calls:
            callee = dotted(call.func)
            acc_arg = call.args[0] if call.args else next(
                (kw.value for kw in call.keywords if kw.arg == "acc"), None)
            if acc_arg is None:
                continue
            if id(call) in dropped and not isinstance(
                    acc_arg, (ast.Name, ast.Attribute, ast.Subscript)) \
                    and not _is_shallow_copy(acc_arg):
                yield self.finding(
                    src, acc_arg,
                    f"{callee}() adds into a temporary accumulator and "
                    "its result is dropped — the block's work is lost "
                    "(the updaters add_ in place into the dict they are "
                    "given)",
                    kind="lost-update", callee=callee)
            if not isinstance(acc_arg, ast.Name):
                continue
            for load in self._stale_views(call, acc_arg.id, views, stores,
                                          loads, parent):
                if id(load) in reported:
                    continue
                reported.add(id(load))
                yield self.finding(
                    src, load,
                    f"{load.id!r} is a view of {acc_arg.id!r} bound "
                    f"before {callee}() updated it in place (line "
                    f"{call.lineno}) and is compared with it here as if "
                    "it held the older value — it holds the updated one",
                    kind="stale-view", callee=callee)

    @staticmethod
    def _stale_views(call, acc, views, stores, loads, parent):
        """First reads, after ``call``, of views of ``acc`` bound before
        it, in a statement that also reads ``acc``."""
        start, end = _pos(call), _end(call)
        for bound_at, name, root in views:
            if root != acc or bound_at > start:
                continue
            later = sorted((_pos(n), i, n) for i, n in enumerate(loads)
                           if n.id == name and _pos(n) > end)
            if not later:
                continue
            first_at, _i, first = later[0]
            if any(nm == name and bound_at < p < first_at
                   for p, nm in stores):
                continue  # rebound before the read: not the old view
            stmt = first
            while stmt is not None and not isinstance(stmt, ast.stmt):
                stmt = parent.get(id(stmt))
            if stmt is None:
                continue
            header = [c for c in ast.iter_child_nodes(stmt)
                      if not isinstance(c, (ast.stmt, ast.excepthandler))]
            if any(isinstance(n, ast.Name) and n.id == acc
                   and isinstance(n.ctx, ast.Load)
                   for c in header for n in ast.walk(c)):
                yield first
