"""jax-import-purity — the port imports nothing of JAX, and its
device-free modules set up no CUDA context at import, transitively.

Historical contract: the supervised-CLI parent must never hold a device
— it imports ``cli.main``'s module surface (config, kernels, supervisor,
faults, telemetry) BEFORE re-invoking the child, and an import-time
device runtime anywhere in that closure silently puts a device (and
its memory) into the watchdog process. The same purity is what lets
config-time validation and the kernel registry run in the parent, in
the fleet controller and in graftlint itself.

The port's rule has two halves:

(a) **The import boundary.** No import statement, at any scope, in the
    port's package or ``chip_smoke.py`` names ``jax``, ``jaxlib``,
    ``spark_examples_tpu`` or ``tools`` as its first component (the
    JAX package is the reference the port is tested against, never a
    dependency; ``spark_examples_tpu_torch`` is a different name).
(b) **No CUDA context in the device-free closure.** ``import torch``
    creates no context and is allowed. The rule walks the module-level
    import graph (function bodies are lazy by construction and
    excluded; ``if TYPE_CHECKING:`` and ``if __name__ == "__main__":``
    blocks too) from each contract root and reports code that runs at
    import time and sets up CUDA: a ``torch.cuda.*`` call other than
    the queries that create no context (``is_available``,
    ``device_count``, ``is_initialized``, ``get_arch_list``), a
    ``.cuda()`` call, a ``device="cuda..."`` argument or a
    ``.to("cuda...")``, and ``ops.cuda_build.load``/``build_all``.
    Decorators and default values of module-level functions count:
    they run at import. A contract module's own site is reported where
    it stands; a site reached through imports is reported at the import
    that begins the chain.

Fixtures claim a contract identity with ``# graftlint: module=...``.
"""

from __future__ import annotations

import ast

from spark_examples_tpu_torch.tools.graftlint.astutil import (
    call_roots,
    dotted,
    import_aliases,
    import_nodes,
)
from spark_examples_tpu_torch.tools.graftlint.engine import (
    PACKAGE,
    Context,
    Rule,
    SourceFile,
    register,
)

# Module paths that must import without setting up CUDA: the kernel
# registry (config + CLI parent consume it), config-time validation,
# the fault registry, the supervisor parent path, the CLI module surface
# the parent imports before any child exists, and the fleet controller
# (it supervises serve children that own the card).
CONTRACT = tuple(PACKAGE + "." + m for m in (
    "kernels",
    "core.config",
    "core.faults",
    "core.telemetry",
    "core.supervisor",
    "cli.main",
    "fleet.controller",
))

# First components no import in the port may name.
FORBIDDEN_ROOTS = ("jax", "jaxlib", "spark_examples_tpu", "tools")
# The files the import boundary covers: the package and the smoke run.
_BOUNDARY = (PACKAGE, "chip_smoke")

CUDA_BUILD_MOD = PACKAGE + ".ops.cuda_build"
_BUILD_CALLS = ("load", "build_all")
# torch.cuda queries that answer without creating a context.
_CONTEXT_FREE = ("is_available", "device_count", "is_initialized",
                 "get_arch_list")


def _skipped_if(node: ast.If) -> bool:
    """``if TYPE_CHECKING:`` and ``if __name__ == "__main__":`` bodies
    do not run when the module is imported."""
    t = node.test
    name = t.attr if isinstance(t, ast.Attribute) else (
        t.id if isinstance(t, ast.Name) else "")
    if name == "TYPE_CHECKING":
        return True
    return (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
            and t.left.id == "__name__" and len(t.comparators) == 1
            and isinstance(t.comparators[0], ast.Constant)
            and t.comparators[0].value == "__main__")


def _import_time_nodes(tree: ast.Module):
    """Every node that executes when the module is imported: the module
    body, class bodies, module-level try/if/with/for, and the
    decorators and default values of functions defined there — but not
    function bodies or lambdas."""
    stack: list[ast.AST] = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(d for d in node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.If) and _skipped_if(node):
            stack.extend(node.orelse)
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _module_level_imports(tree: ast.Module):
    """(node, dotted targets) for imports that execute at import time."""
    for node in _import_time_nodes(tree):
        if isinstance(node, ast.Import):
            yield node, [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level or not node.module:
                continue  # the repo uses absolute imports throughout
            if node.module == "__future__":
                continue
            # `from a.b import c` is module a.b.c when c is a module,
            # else an attribute of a.b — try both.
            yield node, [f"{node.module}.{a.name}" for a in node.names] \
                + [node.module]


def _is_cuda_device(expr: ast.AST) -> bool:
    """A ``"cuda"``/``"cuda:N"`` literal or ``torch.device("cuda...")``."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":", 1)[0] == "cuda"
    if isinstance(expr, ast.Call) and dotted(expr.func) == "torch.device":
        return bool(expr.args) and _is_cuda_device(expr.args[0])
    return False


def _cuda_sites(tree: ast.Module, module: str | None):
    """(node, what) for each import-time site that sets up CUDA."""
    cuda_roots = {"torch.cuda"} | import_aliases(tree, "torch.cuda")
    build_roots = call_roots(tree, CUDA_BUILD_MOD)
    build_names = set()
    for leaf in _BUILD_CALLS:
        build_names |= import_aliases(tree, f"{CUDA_BUILD_MOD}.{leaf}")
        if module == CUDA_BUILD_MOD:
            build_names.add(leaf)
    for node in _import_time_nodes(tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func) or ""
        root, _, leaf = d.rpartition(".")
        if root in cuda_roots and leaf not in _CONTEXT_FREE:
            yield node, f"{d}()"
        elif (root in build_roots and leaf in _BUILD_CALLS) or \
                d in build_names:
            yield node, f"{d}() (an nvcc build and a CUDA library load)"
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "cuda":
            yield node, ".cuda()"
        elif any(kw.arg == "device" and _is_cuda_device(kw.value)
                 for kw in node.keywords):
            yield node, f"{d or 'a call'}(device=<cuda>)"
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "to" and node.args and \
                _is_cuda_device(node.args[0]):
            yield node, ".to(<cuda>)"


def _ancestors(dotted_name: str):
    parts = dotted_name.split(".")
    for i in range(1, len(parts)):
        yield ".".join(parts[:i])


def _in(module: str | None, roots) -> bool:
    return module is not None and any(
        module == r or module.startswith(r + ".") for r in roots)


@register
class JaxImportPurityRule(Rule):
    id = "jax-import-purity"
    invariant = ("the port and chip_smoke.py import no jax, jaxlib, "
                 "spark_examples_tpu or tools at any scope; kernels/, "
                 "core/config, core/faults, core/telemetry, "
                 "core/supervisor, cli/main and fleet/controller set up "
                 "no CUDA context at import, transitively")
    hint = ("keep the port self-contained (its own copy of what it "
            "needs), and move CUDA set-up inside the function that needs "
            "it — the supervised parent, the fleet controller and "
            "config-time validation must run device-free")

    def _chain(self, ctx: Context, dotted_name: str, cache: dict,
               visiting: set) -> list[str] | None:
        """The module chain from ``dotted_name`` to an import-time CUDA
        site (its last element names the site), or None. Only
        package-internal modules are walked; external deps are leaves."""
        if dotted_name.split(".", 1)[0] != PACKAGE:
            return None
        if dotted_name in cache:
            return cache[dotted_name]
        if dotted_name in visiting:
            return None  # import cycle: resolved by the other branch
        path = ctx.module_file(dotted_name)
        if path is None:
            return None
        try:
            tree = ast.parse(path.read_text())
        except (OSError, SyntaxError):
            cache[dotted_name] = None
            return None
        site = next(_cuda_sites(tree, dotted_name), None)
        if site is not None:
            node, what = site
            cache[dotted_name] = [f"{dotted_name}:{node.lineno} {what}"]
            return cache[dotted_name]
        visiting.add(dotted_name)
        chain = None
        for _node, targets in _module_level_imports(tree):
            for target in targets:
                sub = self._resolve(ctx, target, cache, visiting)
                if sub:
                    chain = [dotted_name] + sub
                    break
            if chain:
                break
        visiting.discard(dotted_name)
        cache[dotted_name] = chain
        return chain

    def _resolve(self, ctx: Context, target: str, cache, visiting):
        """Chain for an import target, including the ancestor package
        __init__ executions a dotted import implies."""
        for anc in _ancestors(target):
            if ctx.module_file(anc) is not None:
                sub = self._chain(ctx, anc, cache, visiting)
                if sub:
                    return sub
        if target.split(".", 1)[0] == PACKAGE and \
                ctx.module_file(target) is None:
            return None  # `from mod import attr` where attr is no module
        return self._chain(ctx, target, cache, visiting)

    def check(self, src: SourceFile, ctx: Context):
        if src.tree is None:
            return
        if _in(src.module, _BOUNDARY):
            yield from self._boundary(src)
        if _in(src.module, CONTRACT):
            yield from self._closure(src, ctx)

    def _boundary(self, src: SourceFile):
        for node in import_nodes(src.tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif not node.level:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names
                   if n.split(".", 1)[0] in FORBIDDEN_ROOTS]
            if bad:
                yield self.finding(
                    src, node,
                    f"import of {bad[0]!r} in the port — the port "
                    "imports nothing of JAX, of the JAX package or of "
                    "its tools, at any scope (the machine with the card "
                    "has no jax)",
                    kind="boundary", module=bad[0])

    def _closure(self, src: SourceFile, ctx: Context):
        for node, what in _cuda_sites(src.tree, src.module):
            yield self.finding(
                src, node,
                f"{what} at import time sets up CUDA — {src.module} is "
                "contractually device-free at import (the supervised "
                "parent / fleet controller / config-time path must "
                "never hold a context)",
                kind="closure", chain=[])
        cache = ctx.data.setdefault("cuda_purity_cache", {})
        for node, targets in _module_level_imports(src.tree):
            for target in targets:
                chain = self._resolve(ctx, target, cache, set())
                if chain:
                    arrow = " -> ".join([src.module] + chain)
                    yield self.finding(
                        src, node,
                        f"module-level import reaches CUDA set-up "
                        f"({arrow}) — {src.module} is contractually "
                        "device-free at import (the supervised parent / "
                        "fleet controller / config-time path must never "
                        "hold a context)",
                        kind="closure", chain=chain)
                    break
