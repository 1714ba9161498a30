"""graftlint for the port — the AST invariant suite of ``tools/graftlint``,
held against the port's own registries.

The same eight rule ids, finding format, JSON document, suppression
grammar and exit codes as the JAX package's suite, so command lines and
``disable=`` comments carry over. Each rule distils a regression from
the repo's bug history (its docstring names the bug); where the bug
class takes another form in PyTorch, the rule checks the port's form:

- ``registry-literal``, ``atomic-write``, ``telemetry-name`` and
  ``fault-site`` keep the JAX suite's logic over the port's modules and
  registries (``kernels.names()``, ``core.telemetry``,
  ``core.faults.SITES``, ``core.config``'s enum tuples).
- ``jax-import-purity``: no import of ``jax``, ``jaxlib``,
  ``spark_examples_tpu`` or ``tools`` anywhere in the port, and no CUDA
  context set up at import time in the device-free closure (the
  supervised parent, the fleet controller, config-time validation).
- ``blocking-under-lock``: ``torch.`` calls and the tensor methods that
  wait for the card, where the JAX suite names jax dispatch.
- ``donation-safety``: the in-place update contract of ``ops/gram.py``
  (the counterpart of jit buffer donation).
- ``thread-hygiene``: thread names against the port's own
  ``THREAD_FAMILIES`` table (``rules/threads.py``).

Stdlib-only at import: it never imports ``tools.graftlint``, ``jax`` or
the JAX package, and reads the port's registries lazily at check time.

Usage::

    python -m spark_examples_tpu_torch lint            # the port's tree
    python -m spark_examples_tpu_torch lint --list-rules
    python -m spark_examples_tpu_torch.tools.graftlint --format json PATH

Suppressions are inline, per line, and MUST carry a reason::

    with self._lock:
        data = f.read()  # graftlint: disable=blocking-under-lock  # <why this one is safe>
"""

from spark_examples_tpu_torch.tools.graftlint.engine import (  # noqa: F401
    Finding,
    all_rules,
    format_findings,
    run,
)
from spark_examples_tpu_torch.tools.graftlint import (  # noqa: F401
    rules as _rules,  # registers
)
