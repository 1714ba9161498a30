"""The ``lint`` verb is dispatched before anything that imports torch, as
the JAX package's CLI dispatches it before any jax import
(``spark_examples_tpu/cli/main.py``). Each check runs in a fresh
interpreter, so nothing an earlier test imported is in ``sys.modules``.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The port's modules a full ``lint`` loads besides the suite itself: it
# reads the kernel registry (which imports torch and ops.genotype), the
# telemetry names, the fault sites and config's enum tuples.
FULL_LINT_MODULES = sorted(
    "spark_examples_tpu_torch" + m for m in (
        "", ".cli", ".cli.main", ".core", ".core.config", ".core.device",
        ".core.faults", ".core.telemetry", ".kernels", ".ops",
        ".ops.genotype", ".tools",
    ))


def _fresh(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_importing_the_cli_loads_no_torch():
    out = _fresh(
        "import json, sys\n"
        "import spark_examples_tpu_torch.cli.main\n"
        "print(json.dumps({'torch': 'torch' in sys.modules}))\n")
    assert out == {"torch": False}


def test_lint_list_rules_in_process_loads_no_torch():
    out = _fresh(
        "import contextlib, io, json, sys\n"
        "from spark_examples_tpu_torch.cli.main import main\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rc = main(['lint', '--list-rules'])\n"
        "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules,\n"
        "                  'rules': len(buf.getvalue().splitlines())}))\n")
    assert out == {"rc": 0, "torch": False, "rules": 8}


def test_python_m_lint_list_rules_loads_no_torch():
    """The verb as a user runs it: ``python -m spark_examples_tpu_torch
    lint --list-rules`` (``__main__`` imports ``cli.main`` first)."""
    out = _fresh(
        "import contextlib, io, json, runpy, sys\n"
        "sys.argv = ['spark_examples_tpu_torch', 'lint', '--list-rules']\n"
        "buf = io.StringIO()\n"
        "try:\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        runpy.run_module('spark_examples_tpu_torch',\n"
        "                         run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))\n")
    assert out == {"rc": 0, "torch": False}


def test_a_lint_usage_error_loads_no_torch():
    out = _fresh(
        "import contextlib, io, json, sys\n"
        "from spark_examples_tpu_torch.cli.main import main\n"
        "try:\n"
        "    with contextlib.redirect_stderr(io.StringIO()):\n"
        "        main(['lint', '--format', 'xml'])\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))\n")
    assert out == {"rc": 2, "torch": False}


def test_full_lint_sets_up_no_cuda_context_and_loads_the_pinned_modules():
    """A full ``lint`` reads the port's registries, and ``kernels``
    imports torch: torch may load, but no CUDA context is set up, and the
    port's modules it loads (the suite's own aside) are pinned."""
    out = _fresh(
        "import contextlib, io, json, sys\n"
        "from spark_examples_tpu_torch.cli.main import main\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rc = main(['lint'])\n"
        "import torch\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] == 'spark_examples_tpu_torch'\n"
        "              and not m.startswith('spark_examples_tpu_torch.tools"
        ".graftlint'))\n"
        "print(json.dumps({'rc': rc, 'clean': 'graftlint: clean' in\n"
        "                  buf.getvalue(), 'cuda': torch.cuda.is_initialized(),"
        "\n                  'modules': mods}))\n")
    assert out["rc"] == 0 and out["clean"]
    assert out["cuda"] is False
    assert out["modules"] == FULL_LINT_MODULES


def test_the_full_parser_still_lists_lint():
    res = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0
    assert "lint" in res.stdout and "graftlint" in res.stdout
