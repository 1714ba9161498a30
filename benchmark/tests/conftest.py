"""A tiny benchmark root for the CPU tests: the repository's data files
copied, plus one small configuration, two small mixes (store and
memory), their cells and one added metric, as a later change would add
them: new files and new entries only."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELLS = ("tiny.store", "tiny.memory")
ADDED_METRIC = "ingest_setup_s"


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = root / "benchmark"
    config = json.loads((d / "configs" / "kg3-2504.json").read_text())
    config.update(n_samples=48, n_variants=5000, contig="chr1",
                  groups={"A": 16, "B": 20, "C": 12})
    _dump(d / "configs" / "tiny.json", config)
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    for cell in TINY_CELLS:
        feed = cell.split(".")[1]
        mix = json.loads((d / "traffic" / f"chr22-{feed}.json").read_text())
        mix["block_variants"] = 1024
        _dump(d / "traffic" / f"tiny-{feed}.json", mix)
        entry = {"name": cell, "config": "tiny", "traffic": f"tiny-{feed}",
                 "chips": 1, "why": "a test"}
        bench["workloads"].append(entry)
        limits = json.loads((d / "workloads" /
                             "gnomad2g-15708.chr22-memory.json").read_text())[
                                 "limits"]
        _dump(d / "workloads" / f"{cell}.json",
              {k: v for k, v in entry.items() if k != "name"}
              | {"limits": limits})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TINY_CELLS)
    # Only a job that opens its source has the phase: the memory cell's
    # reader finds nothing, and the metric is left out of its line.
    (d / "metrics" / f"{ADDED_METRIC}.py").write_text(
        '"""The ingest_setup phase a job."""\n\n\n'
        "def read(run):\n"
        "    return run.phase_mean('ingest_setup')\n")
    bench["per_layer"].append({
        "name": ADDED_METRIC, "unit": "s", "better": "lower",
        "source": "program_span", "layer": "feed",
        "moves": "pcoa_job_s", "workloads": list(TINY_CELLS)})
    _dump(root / "BENCHMARK.json", bench)
    return root
