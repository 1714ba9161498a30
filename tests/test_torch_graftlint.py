"""The port's graftlint (spark_examples_tpu_torch/tools/graftlint), held
against the JAX package's suite (tools/graftlint).

- **Same findings where the rules agree.** On the JAX suite's own
  fixtures whose rule has the same semantics in both suites (atomic
  writes, locks, suppressions, threads), both suites give the same
  ``(path, line, col, rule)`` lists. The fixtures are read in place.
- **The port's own forms, pinned.** For each rule the port checks in
  another form (the import boundary and the CUDA-free closure, the
  in-place update contract, torch calls under a lock, the port's
  registries and thread table), a bad fixture gives EXACT ``(rule,
  line, col)`` triples and a good one nothing.
- **Dogfood.** The port's tree lints clean, every suppression carries a
  reason, and the README's port table names every rule.
- **The verb.** ``python -m spark_examples_tpu_torch lint``: exit codes,
  JSON, ``--list-rules``; and importing the suite loads no jax, nothing
  of the JAX package and not even torch.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from spark_examples_tpu_torch.tools import graftlint
from spark_examples_tpu_torch.tools.graftlint import engine
from spark_examples_tpu_torch.tools.graftlint.rules import threads
from tools import graftlint as jax_graftlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "graftlint")
# The JAX suite's fixtures whose rule means the same in both suites.
SHARED = ("atomic_write", "locks", "suppression", "threads")


def _quads(findings):
    return [(f.path, f.line, f.col, f.rule) for f in findings]


def _triples(findings):
    return [(f.rule, f.line, f.col) for f in findings]


# ------------------------------------------ the same findings as JAX's


@pytest.mark.parametrize("which", ("bad", "good"))
@pytest.mark.parametrize("name", SHARED)
def test_same_findings_as_the_jax_suite(name, which):
    path = os.path.join(FIXTURES, name, which + ".py")
    want = _quads(jax_graftlint.run(paths=[path]))
    got = _quads(graftlint.run(paths=[path]))
    assert got == want
    assert bool(got) == (which == "bad")


def test_same_rule_ids_as_the_jax_suite():
    assert set(graftlint.all_rules()) == set(jax_graftlint.all_rules())


def test_thread_table_covers_the_soak_table():
    """THREAD_FAMILIES holds every prefix of tools/soak.py's
    _SUSPECT_THREADS (read from its AST) and the port's own families."""
    tree = ast.parse(open(os.path.join(REPO, "tools", "soak.py")).read())
    soak = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and any(getattr(t, "id", "") == "_SUSPECT_THREADS"
                        for t in n.targets))
    assert len(soak) == 13
    assert set(soak) <= set(threads.THREAD_FAMILIES)
    assert threads.THREAD_FAMILIES[:13] == soak


# --------------------------------------------- the port's own forms

# name -> (files of the bad case, its EXACT triples, files of the good
# case). Each case is written under tmp_path and linted with
# root=tmp_path (the purity rule's import graph is read from there); the
# file named "target.py" is linted.
CASES = {
    "purity-boundary": ({"target.py": '''\
        # graftlint: module=spark_examples_tpu_torch.ops.sample
        import numpy as np
        import jax.numpy as jnp
        from spark_examples_tpu.core import config


        def lazy():
            from tools.graftlint import run
            import jaxlib
            return run, jaxlib, np, jnp, config
        '''}, [
        ("jax-import-purity", 3, 1),   # import jax.numpy
        ("jax-import-purity", 4, 1),   # the JAX package
        ("jax-import-purity", 8, 5),   # the JAX suite, inside a function
        ("jax-import-purity", 9, 5),   # jaxlib, inside a function
    ], {"target.py": '''\
        # graftlint: module=spark_examples_tpu_torch.ops.sample
        import torch
        from spark_examples_tpu_torch.core import config
        from spark_examples_tpu_torch.tools.graftlint import run


        def lazy():
            import spark_examples_tpu_torch.ops.gram as gram
            return torch, config, run, gram
        '''}),
    "purity-closure": ({
        "spark_examples_tpu_torch/__init__.py": "",
        "spark_examples_tpu_torch/ops/__init__.py": "",
        "spark_examples_tpu_torch/ops/warm.py": '''\
            import torch

            WORKSPACE = torch.empty(1 << 20, device="cuda")
            ''',
        "target.py": '''\
            # graftlint: module=spark_examples_tpu_torch.core.faults
            import torch
            from spark_examples_tpu_torch.ops import warm

            STREAM = torch.cuda.Stream()
            ONES = torch.ones(4).cuda()
            VISIBLE = torch.cuda.device_count()


            def f(x=torch.zeros(2, device="cuda:0")):
                return torch.cuda.synchronize(), warm


            if __name__ == "__main__":
                torch.cuda.synchronize()
            '''}, [
        ("jax-import-purity", 3, 1),   # reaches ops/warm.py's workspace
        ("jax-import-purity", 5, 10),  # torch.cuda.Stream()
        ("jax-import-purity", 6, 8),   # .cuda()
        ("jax-import-purity", 10, 9),  # a default value runs at import
    ], {
        "spark_examples_tpu_torch/__init__.py": "",
        "spark_examples_tpu_torch/ops/__init__.py": "",
        "spark_examples_tpu_torch/ops/lazy.py": '''\
            import torch


            def workspace():
                return torch.empty(1 << 20, device="cuda")
            ''',
        "target.py": '''\
            # graftlint: module=spark_examples_tpu_torch.core.faults
            import torch
            from spark_examples_tpu_torch.ops import lazy

            VISIBLE = torch.cuda.device_count(), torch.cuda.is_available()
            CPU = torch.zeros(2, device="cpu")


            def f(x=None):
                return torch.ones(4).cuda(), lazy, x


            if __name__ == "__main__":
                torch.cuda.synchronize()
            '''}),
    "donation": ({"target.py": '''\
        import torch

        from spark_examples_tpu_torch.ops import gram


        def lost(blocks, n, dev):
            for b in blocks:
                gram.update(gram.init(n, "ibs", dev), b, "ibs")


        def stale(acc, block):
            before = acc["cc"]
            gram.update(acc, block, "ibs")
            return (acc["cc"] - before).abs().sum()


        def stale_copy(acc, blocks, metric):
            upd = gram.impl_for(metric, packed=True)
            snap = dict(acc)
            for b in blocks:
                acc = upd(acc, b)
            return torch.equal(snap["cc"], acc["cc"])
        '''}, [
        ("donation-safety", 8, 21),    # a dropped temporary accumulator
        ("donation-safety", 14, 25),   # a view compared after the update
        ("donation-safety", 22, 24),   # a shallow copy, through impl_for
    ], {"target.py": '''\
        from spark_examples_tpu_torch.ops import gram


        def kept(blocks, n, dev):
            acc = gram.init(n, "ibs", dev)
            for b in blocks:
                acc = gram.update(acc, b, "ibs")
            return acc


        def fresh_kept(block, n, dev):
            return gram.update(gram.init(n, "ibs", dev), block, "ibs")


        def snapshot(acc, block):
            before = acc["cc"].clone()
            gram.update(acc, block, "ibs")
            return acc["cc"] - before


        def latest(acc, blocks):
            cc = acc["cc"]
            for b in blocks:
                gram.update(acc, b, "ibs")
            return cc
        '''}),
    "locks": ({"target.py": '''\
        import threading

        import torch

        _lock = threading.Lock()


        def publish(acc, out):
            with _lock:
                out["total"] = acc.sum().item()
                out["rows"] = acc.cpu()
                torch.cuda.synchronize()


        def drain(lock, t):
            lock.acquire()
            try:
                return t.tolist()
            finally:
                lock.release()
        '''}, [
        ("blocking-under-lock", 10, 24),  # .item()
        ("blocking-under-lock", 11, 23),  # .cpu()
        ("blocking-under-lock", 12, 9),   # a torch call
        ("blocking-under-lock", 18, 16),  # .tolist() in acquire/release
    ], {"target.py": '''\
        import threading

        _lock = threading.Lock()


        def publish(acc, out):
            total = acc.sum().item()
            rows = acc.cpu()
            with _lock:
                out["total"] = total
                out["rows"] = rows
        '''}),
    "registry-literal": ({"target.py": '''\
        METHODS = ("exact", "matmul", "fused")
        CLASSES = ["interactive", "batch"]
        KERNELS = {"ibs", "grm"}
        '''}, [
        ("registry-literal", 1, 11),  # braycurtis methods (port's fused)
        ("registry-literal", 2, 11),  # priority classes
        ("registry-literal", 3, 11),  # kernel names
    ], {"target.py": '''\
        # graftlint: module=spark_examples_tpu_torch.core.config
        BRAYCURTIS_METHODS = ("auto", "exact", "matmul", "fused")
        MODES = ["exact", "something-else"]
        '''}),
    "names": ({"target.py": '''\
        from spark_examples_tpu_torch.core import faults
        from spark_examples_tpu_torch.core import telemetry as t


        def handle(t0, dur):
            t.span_at("trace.bogus", t0, dur)
            t.count("kernel.packed_gram.bogus", 1)
            faults.fire("serve.bogus_site")
        '''}, [
        ("telemetry-name", 6, 15),  # span_at, undeclared
        ("telemetry-name", 7, 13),  # undeclared beside the port's names
        ("fault-site", 8, 17),      # undeclared site
    ], {"target.py": '''\
        from spark_examples_tpu_torch.core import faults
        from spark_examples_tpu_torch.core import telemetry as t


        def handle(t0, dur):
            t.span_at("trace.request", t0, dur)
            t.count("kernel.packed_gram.launches", 1)
            faults.fire("multihost.consensus")
        '''}),
    "threads": ({"target.py": '''\
        import threading
        from concurrent.futures import ThreadPoolExecutor


        def start(work):
            t = threading.Thread(target=work, name="codec-build",
                                 daemon=True)
            pool = ThreadPoolExecutor(4)
            return t, pool
        '''}, [
        ("thread-hygiene", 6, 44),  # a name outside THREAD_FAMILIES
        ("thread-hygiene", 8, 12),  # a pool without a prefix
    ], {"target.py": '''\
        import threading
        from concurrent.futures import ThreadPoolExecutor


        def start(work):
            t = threading.Thread(target=work, name="chip-smoke-build",
                                 daemon=True)
            pool = ThreadPoolExecutor(4, thread_name_prefix="neighbors-eval")
            return t, pool
        '''}),
}


def _lint_case(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return graftlint.run(paths=[str(root / "target.py")], root=root)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_form_bad_case_pinned(name, tmp_path):
    files, expected, _good = CASES[name]
    findings = _lint_case(tmp_path, files)
    assert _triples(findings) == expected, "\n".join(
        f.render() for f in findings)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_form_good_case_is_clean(name, tmp_path):
    _bad, _expected, files = CASES[name]
    findings = _lint_case(tmp_path, files)
    assert not findings, "\n".join(f.render() for f in findings)


def test_every_rule_has_a_pinned_case():
    """Each rule the port checks in its own form fires in some bad case;
    the rest are the shared fixtures' (atomic-write)."""
    fired = {r for _f, expected, _g in CASES.values() for r, _l, _c
             in expected}
    assert fired | {"atomic-write"} == set(graftlint.all_rules())


def test_boundary_rule_skips_files_outside_the_port(tmp_path):
    """A test file (no module identity) may import both packages."""
    p = tmp_path / "test_both.py"
    p.write_text("import jax\nfrom spark_examples_tpu import kernels\n")
    assert not graftlint.run(paths=[str(p)], rules=["jax-import-purity"])


# ------------------------------------------------------------- dogfood


def test_port_tree_lints_clean():
    """The port's production tree (the package and chip_smoke.py) has
    zero findings, in well under 30 s."""
    t0 = time.monotonic()
    findings = graftlint.run()
    elapsed = time.monotonic() - t0
    assert not findings, "\n".join(f.render() for f in findings)
    assert elapsed < 30.0, f"graftlint took {elapsed:.1f}s"


def test_default_targets_are_the_port_and_chip_smoke():
    rels = {p.relative_to(engine.REPO).as_posix()
            for p in engine.default_targets()}
    assert "chip_smoke.py" in rels
    assert "bench_torch.py" in rels
    assert "spark_examples_tpu_torch/tools/graftlint/engine.py" in rels
    assert all(r in ("chip_smoke.py", "bench_torch.py")
               or r.startswith("spark_examples_tpu_torch/") for r in rels)


def test_port_suppressions_all_carry_reasons():
    for path in engine.default_targets():
        src = engine.SourceFile(path, engine.REPO)
        for s in src.suppressions:
            assert s.reason, f"{src.rel}:{s.line}: reasonless suppression"
            assert s.rules <= set(graftlint.all_rules()), (
                f"{src.rel}:{s.line}: unknown rule in {sorted(s.rules)}")


def test_readme_port_table_names_every_rule():
    text = open(os.path.join(REPO, "README.md")).read()
    start = text.index("**Static analysis (port).**")
    section = text[start:text.index("\n## ", start + 1)]
    for rule_id in list(graftlint.all_rules()) + [engine.SUPPRESSION_RULE]:
        assert f"`{rule_id}`" in section, (
            f"README 'Static analysis (port)' has no row for {rule_id}")


def test_dead_fault_site_check_runs_only_on_the_full_tree(tmp_path):
    p = tmp_path / "empty.py"
    p.write_text("x = 1\n")
    assert not graftlint.run(paths=[str(p)], rules=["fault-site"])


def test_finding_render_is_precise():
    f = graftlint.run(paths=[os.path.join(FIXTURES, "atomic_write",
                                          "bad.py")])[0]
    assert f.render().startswith(
        "tests/fixtures/graftlint/atomic_write/bad.py:8:10: atomic-write:")


# ------------------------------------------------------------------ CLI


def _cli(*args, module="spark_examples_tpu_torch"):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("module", ("spark_examples_tpu_torch",
                                    "spark_examples_tpu_torch.tools."
                                    "graftlint"))
def test_cli_exit_codes_and_json(module):
    verb = ("lint",) if module == "spark_examples_tpu_torch" else ()
    fixture = os.path.join("tests", "fixtures", "graftlint",
                           "atomic_write")
    bad = _cli(*verb, os.path.join(fixture, "bad.py"), "--format", "json",
               module=module)
    assert bad.returncode == 1, bad.stderr
    doc = json.loads(bad.stdout)
    assert doc["count"] == 2 and not doc["ok"]
    assert [(f["rule"], f["line"], f["col"]) for f in doc["findings"]] == [
        ("atomic-write", 8, 10), ("atomic-write", 14, 5)]

    good = _cli(*verb, os.path.join(fixture, "good.py"), module=module)
    assert good.returncode == 0, good.stdout + good.stderr
    assert "graftlint: clean" in good.stdout

    usage = _cli(*verb, "--rules", "no-such-rule", module=module)
    assert usage.returncode == 2


def test_cli_list_rules_matches_the_jax_suite():
    port = _cli("lint", "--list-rules")
    jax_side = _cli("--list-rules", module="tools.graftlint")
    assert port.returncode == 0 and jax_side.returncode == 0

    def ids(out):
        return [line.split(":", 1)[0] for line in out.splitlines()]

    assert ids(port.stdout) == ids(jax_side.stdout)
    assert len(ids(port.stdout)) == 8


def test_suite_imports_nothing_of_jax_nor_torch():
    """Importing the port's suite (and listing its rules through the
    CLI verb's dispatch) loads no jax, nothing of the JAX package or
    its tools, and — stdlib only at import — not torch either."""
    code = (
        "import sys\n"
        "import spark_examples_tpu_torch.tools.graftlint as g\n"
        "from spark_examples_tpu_torch.tools.graftlint.__main__ import "
        "main\n"
        "assert main(['--list-rules']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'spark_examples_tpu', 'tools', 'torch'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout
