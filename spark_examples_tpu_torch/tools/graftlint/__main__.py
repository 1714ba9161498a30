"""``python -m spark_examples_tpu_torch.tools.graftlint`` — run the
port's invariant suite (also ``python -m spark_examples_tpu_torch lint``).

Exit codes: 0 clean, 1 findings, 2 usage. ``--format json`` emits one
machine-readable document; the default text format is one
``file:line:col: rule: message`` line per finding.
"""

from __future__ import annotations

import argparse
import sys

from spark_examples_tpu_torch.tools.graftlint import engine as E
from spark_examples_tpu_torch.tools.graftlint import (  # noqa: F401
    rules as _rules,  # registers
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint",
        description="AST-based invariant analyzers distilled from this "
                    "repo's bug history, over the PyTorch port (see "
                    "README 'Static analysis (port)')",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                    "port's production tree — spark_examples_tpu_torch/, "
                    "chip_smoke.py and bench_torch.py; tests are "
                    "excluded by design)")
    ap.add_argument("--rules", default=None, metavar="ID[,ID...]",
                    help="run only these rule ids (default: all; see "
                    "--list-rules)")
    ap.add_argument("--format", default="text", choices=["text", "json"])
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table (id + invariant) and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in sorted(E.all_rules().items()):
            print(f"{rid}: {rule.invariant}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        findings = E.run(paths=args.paths or None, rules=rules)
    except ValueError as e:  # unknown rule id
        ap.error(str(e))
    except OSError as e:
        ap.error(f"cannot read target: {e}")
    print(E.format_findings(findings, args.format))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
