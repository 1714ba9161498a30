"""The graftlint engine: files, findings, suppressions, rule registry.

The port's copy of ``tools/graftlint/engine.py``, reading the port's
registries. Design contract (tests/test_torch_graftlint.py pins it, and
holds it against the JAX package's suite on that suite's fixtures):

- A **Finding** is ``file:line:col`` (line 1-based as in ``ast``, col
  1-based — ``ast.col_offset + 1``, the gcc/clang editor convention),
  a rule id, a one-line message, and the rule's fix hint. ``data``
  carries rule-specific structured fields (e.g. the undeclared
  telemetry name) so downstream tests/tools need not re-parse messages.
- **Suppression** is the inline comment
  ``# graftlint: disable=<rule>[,<rule>...]  # <reason>`` — on the
  finding's own line, or standing alone on the line directly above it.
  The reason (a second ``#`` chunk) is REQUIRED: a reasonless disable
  still suppresses (so the fix is to add the reason, not to face a
  double report) but emits a ``suppression-reason`` finding of its own,
  which is not itself suppressible.
- Fixture files may carry ``# graftlint: module=<dotted>`` to claim a
  module identity (the jax-import-purity rule checks contracts keyed by
  module path; fixtures live outside the package). A file at the root
  of the repo is the module of its stem (``chip_smoke.py`` is
  ``chip_smoke``).
- ``run()`` with no paths walks the port's production tree —
  ``spark_examples_tpu_torch/``, ``chip_smoke.py`` and
  ``bench_torch.py`` — never
  ``tests/`` (tests legitimately write bad patterns on purpose). Repo-
  level checks that only make sense over the full tree (e.g. dead
  fault-site registry entries) run only in that mode.
"""

from __future__ import annotations

import ast
import io
import json
import pathlib
import re
import tokenize
from dataclasses import dataclass, field

REPO = pathlib.Path(__file__).resolve().parents[3]
PACKAGE = "spark_examples_tpu_torch"
# The port's root files in the suite's default targets, as the JAX
# suite lints bench.py: the smoke run and the port's benchmark harness.
SMOKE = "chip_smoke.py"
BENCH = "bench_torch.py"

_SUPPRESS = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,-]+)\s*(?:#\s*(\S.*))?$"
)
_MODULE_PRAGMA = re.compile(r"#\s*graftlint:\s*module=([A-Za-z0-9_.]+)")


@dataclass(frozen=True)
class Finding:
    """One violation at a precise location."""

    path: str  # repo-relative posix path
    line: int  # 1-based
    col: int  # 1-based (ast.col_offset + 1)
    rule: str
    message: str
    hint: str = ""
    data: dict = field(default_factory=dict, compare=False)

    def render(self) -> str:
        text = f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"
        if self.hint:
            text += f" (fix: {self.hint})"
        return text


@dataclass
class Suppression:
    line: int  # the line the comment sits on
    rules: frozenset[str]
    reason: str
    col: int
    standalone: bool  # comment-only line -> applies to the next line


class SourceFile:
    """A parsed target: text, AST, suppressions, module identity."""

    def __init__(self, path: pathlib.Path, root: pathlib.Path):
        self.path = path
        self.root = root
        self.rel = path.resolve().relative_to(root).as_posix() \
            if path.resolve().is_relative_to(root) else path.as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree: ast.Module | None = None
        self.parse_error: SyntaxError | None = None
        try:
            self.tree = ast.parse(self.text)
        except SyntaxError as e:
            self.parse_error = e
        self.suppressions = self._parse_suppressions()
        self.module = self._module_name()

    def _comments(self) -> list[tuple[int, int, str]]:
        """(line, col, text) of every real COMMENT token — pragmas and
        suppressions are resolved from the token stream, NOT raw-line
        regexes, so a docstring that merely *mentions* the pragma
        grammar (this engine's own docs do) can never arm it."""
        cached = getattr(self, "_comment_cache", None)
        if cached is not None:
            return cached
        out: list[tuple[int, int, str]] = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    out.append((tok.start[0], tok.start[1], tok.string))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass  # unparseable tail: the parse-error finding covers it
        self._comment_cache = out
        return out

    def _parse_suppressions(self) -> list[Suppression]:
        out = []
        for line_no, col0, comment in self._comments():
            m = _SUPPRESS.search(comment)
            if not m:
                continue
            reason = (m.group(2) or "").strip()
            line_text = self.lines[line_no - 1] \
                if line_no - 1 < len(self.lines) else ""
            out.append(Suppression(
                line=line_no,
                rules=frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip()),
                reason=reason,
                col=col0 + m.start() + 1,
                standalone=line_text[:col0].strip() == "",
            ))
        return out

    def _module_name(self) -> str | None:
        for _line, _col, comment in self._comments():
            m = _MODULE_PRAGMA.search(comment)
            if m:
                return m.group(1)
        rel = pathlib.PurePosixPath(self.rel)
        if len(rel.parts) == 1 and rel.suffix == ".py":
            return rel.stem
        if rel.parts and rel.parts[0] == PACKAGE:
            parts = list(rel.parts)
            if parts[-1] == "__init__.py":
                parts = parts[:-1]
            else:
                parts[-1] = parts[-1][: -len(".py")]
            return ".".join(parts)
        return None

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.text, node) or ""

    def suppressed(self, rule: str, line: int) -> bool:
        for s in self.suppressions:
            if rule not in s.rules:
                continue
            if s.line == line or (s.standalone and s.line == line - 1):
                return True
        return False


class Context:
    """Per-run shared state: the file set, lazily imported registries,
    the package module index for import-graph walks, and a scratch
    ``data`` dict rules use to aggregate across files (e.g. the set of
    fault sites actually fired, consumed by ``finalize``)."""

    def __init__(self, files: list[SourceFile], root: pathlib.Path,
                 full_repo: bool):
        self.files = files
        self.root = root
        # True only for the default (whole-production-tree) walk: repo-
        # level finalize checks (dead registry entries) would misfire on
        # a partial file list.
        self.full_repo = full_repo
        self.data: dict = {}
        self._module_files: dict[str, pathlib.Path] | None = None

    # -- live registries (imported lazily; all device-free by contract) --

    def kernel_names(self) -> frozenset[str]:
        from spark_examples_tpu_torch import kernels

        return frozenset(kernels.names())

    def telemetry(self):
        from spark_examples_tpu_torch.core import telemetry

        return telemetry

    def faults(self):
        from spark_examples_tpu_torch.core import faults

        return faults

    def config_enums(self) -> dict[str, tuple[tuple[str, ...], str]]:
        """family label -> (values, defining module)."""
        from spark_examples_tpu_torch.core import config as C

        mod = PACKAGE + ".core.config"
        return {
            "solver ladder": (tuple(C.SOLVER_LADDER), mod),
            "store codec": (tuple(C.STORE_CODEC_SPECS), mod),
            "tile2d transport": (tuple(C.TILE2D_TRANSPORTS), mod),
            "gram mode": (tuple(C.GRAM_MODES), mod),
            "eigh mode": (tuple(C.EIGH_MODES), mod),
            "braycurtis method": (tuple(C.BRAYCURTIS_METHODS), mod),
            "backend": (tuple(C.BACKENDS), mod),
            "pack stream": (tuple(C.PACK_STREAMS), mod),
            "priority class": (tuple(C.PRIORITY_CLASSES), mod),
        }

    # -- package module index (for the import-graph rule) --

    def module_file(self, dotted: str) -> pathlib.Path | None:
        if self._module_files is None:
            index: dict[str, pathlib.Path] = {}
            pkg = self.root / PACKAGE
            for p in pkg.rglob("*.py"):
                rel = p.relative_to(self.root)
                parts = list(rel.parts)
                if parts[-1] == "__init__.py":
                    parts = parts[:-1]
                else:
                    parts[-1] = parts[-1][: -len(".py")]
                index[".".join(parts)] = p
            self._module_files = index
        return self._module_files.get(dotted)


class Rule:
    """Base analyzer. Subclasses set ``id``/``invariant``/``hint`` and
    implement ``check`` (per file) and optionally ``finalize`` (once per
    run, full-repo mode only — for aggregate invariants)."""

    id: str = ""
    invariant: str = ""
    hint: str = ""

    def check(self, src: SourceFile, ctx: Context):
        return ()

    def finalize(self, ctx: Context):
        return ()

    def finding(self, src: SourceFile, node: ast.AST, message: str,
                hint: str | None = None, **data) -> Finding:
        return Finding(
            path=src.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule=self.id,
            message=message,
            hint=self.hint if hint is None else hint,
            data=data,
        )


_REGISTRY: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    rule = rule_cls()
    if not rule.id:
        raise ValueError(f"rule {rule_cls.__name__} has no id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _REGISTRY[rule.id] = rule
    return rule_cls


def all_rules() -> dict[str, Rule]:
    return dict(_REGISTRY)


# Meta rule ids emitted by the engine itself (not registered analyzers,
# not suppressible).
SUPPRESSION_RULE = "suppression-reason"
PARSE_RULE = "parse-error"

_SUPPRESSION_HINT = (
    "append the reason as a second comment chunk: "
    "# graftlint: disable=<rule>  # <why this site is a deliberate "
    "exception>"
)


def default_targets(root: pathlib.Path = REPO) -> list[pathlib.Path]:
    """The port's production tree: the package, chip_smoke.py and
    bench_torch.py. Tests are excluded by design — they hold bad
    patterns on purpose."""
    targets = sorted((root / PACKAGE).rglob("*.py"))
    for name in (SMOKE, BENCH):
        if (root / name).exists():
            targets.append(root / name)
    return targets


def _expand(paths, root: pathlib.Path) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if not p.is_absolute():
            p = root / p
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        else:
            out.append(p)
    return out


def run(paths=None, rules=None, root: pathlib.Path = REPO) -> list[Finding]:
    """Run the suite; returns findings sorted by location.

    ``paths``: files/dirs (default: the whole production tree — which
    additionally arms the repo-level finalize checks). ``rules``: rule
    id allowlist (default: all registered).
    """
    full_repo = paths is None
    files = [SourceFile(p, root)
             for p in (default_targets(root) if full_repo
                       else _expand(paths, root))]
    active = all_rules()
    if rules is not None:
        unknown = sorted(set(rules) - set(active))
        if unknown:
            raise ValueError(
                f"unknown rule id(s) {', '.join(unknown)} — known: "
                f"{', '.join(sorted(active))}")
        active = {rid: r for rid, r in active.items() if rid in rules}
    ctx = Context(files, root, full_repo=full_repo)

    findings: list[Finding] = []
    for src in files:
        if src.parse_error is not None:
            e = src.parse_error
            findings.append(Finding(
                path=src.rel, line=e.lineno or 1, col=(e.offset or 1),
                rule=PARSE_RULE, message=f"file does not parse: {e.msg}",
                hint="fix the syntax error"))
            continue
        for rule in active.values():
            for f in rule.check(src, ctx):
                if not src.suppressed(f.rule, f.line):
                    findings.append(f)
        # A suppression without a reason is itself a finding — whether
        # or not it suppressed anything this run (a stale reasonless
        # disable is still an unauditable exception).
        for s in src.suppressions:
            if not s.reason:
                findings.append(Finding(
                    path=src.rel, line=s.line, col=s.col,
                    rule=SUPPRESSION_RULE,
                    message="suppression without a reason: "
                            f"disable={','.join(sorted(s.rules))}",
                    hint=_SUPPRESSION_HINT,
                    data={"rules": sorted(s.rules)}))
    if full_repo:
        for rule in active.values():
            findings.extend(rule.finalize(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def format_findings(findings: list[Finding], fmt: str = "text") -> str:
    if fmt == "json":
        return json.dumps(
            {
                "findings": [
                    {"path": f.path, "line": f.line, "col": f.col,
                     "rule": f.rule, "message": f.message, "hint": f.hint}
                    for f in findings
                ],
                "count": len(findings),
                "ok": not findings,
            },
            sort_keys=True, indent=2)
    lines = [f.render() for f in findings]
    lines.append(f"graftlint: {len(findings)} finding(s)"
                 if findings else "graftlint: clean")
    return "\n".join(lines)

