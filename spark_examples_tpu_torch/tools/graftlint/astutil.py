"""Shared AST helpers for the port's graftlint rules (a copy of
``tools/graftlint/astutil.py``): dotted-name rendering,
static string folding, and import-alias tracking — the pieces that let
AST rules see through the aliasing/concatenation/multi-line shapes the
old regex lints missed."""

from __future__ import annotations

import ast


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


DYNAMIC = object()  # sentinel: expression has a runtime-dependent part


def fold_string(node: ast.AST, env: dict[str, str] | None = None):
    """Statically evaluate a string expression.

    Returns the folded ``str``, ``DYNAMIC`` when any part is runtime-
    dependent (f-string holes, calls, unknown names), or ``None`` when
    the expression is not string-shaped at all. ``env`` maps plain
    names to known constant strings (module-level ``NAME = "..."``
    aliases)."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, str) else None
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                return DYNAMIC
        return "".join(parts)  # f-string with no holes
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = fold_string(node.left, env)
        right = fold_string(node.right, env)
        if left is None or right is None:
            return None
        if left is DYNAMIC or right is DYNAMIC:
            return DYNAMIC
        return left + right
    if isinstance(node, ast.Name) and env is not None:
        if node.id in env:
            return env[node.id]
        return DYNAMIC
    if isinstance(node, (ast.Name, ast.Attribute, ast.Call,
                         ast.Subscript)):
        return DYNAMIC
    return None


def module_string_env(tree: ast.Module) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` bindings (single-target,
    assigned exactly once) — the alias table ``fold_string`` resolves
    plain names against."""
    env: dict[str, str] = {}
    seen: set[str] = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            name = node.targets[0].id
            if name in seen:
                env.pop(name, None)
            else:
                env[name] = node.value.value
                seen.add(name)
    return env


def import_nodes(tree: ast.Module) -> list[ast.AST]:
    """Every import statement of the file, at any scope (walked once per
    tree: several rules ask for aliases of several modules)."""
    found = getattr(tree, "_graftlint_imports", None)
    if found is None:
        found = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.Import, ast.ImportFrom))]
        tree._graftlint_imports = found
    return found


def import_aliases(tree: ast.Module, module: str) -> set[str]:
    """Local names bound to ``module`` (a dotted path) by any import
    form: ``import a.b.c as x``, ``from a.b import c [as x]``. The
    bare ``import a.b.c`` (no alias) binds the root ``a`` — attribute
    chains through it are matched by callers via :func:`dotted`."""
    names: set[str] = set()
    parent, _, leaf = module.rpartition(".")
    for node in import_nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module and a.asname:
                    names.add(a.asname)
        elif node.level == 0 and node.module == parent:
            for a in node.names:
                if a.name == leaf:
                    names.add(a.asname or a.name)
    return names


def call_roots(tree: ast.Module, module: str) -> set[str]:
    """All dotted prefixes through which ``module``'s attributes are
    reachable in this file: the import aliases plus the full dotted
    path when ``import a.b.c`` appears bare."""
    roots = set(import_aliases(tree, module))
    for node in import_nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module and not a.asname:
                    roots.add(module)
    return roots


def walk_scopes(tree: ast.Module):
    """Yield (scope_node, body) for the module and every function —
    the unit of the linear read-after-call analyses."""
    yield tree, tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body
