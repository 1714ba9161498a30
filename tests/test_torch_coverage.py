"""The coverage example (``coverage``) against the JAX package's, on the
CPU.

Depths are small integers held in f32, so every comparison is exact:
the synthetic reads are the JAX package's (the same generator, prefix-
stable across batch sizes), the SAM reader parses the same file into
the same reads, the per-base depth equals JAX's bit for bit and a NumPy
``bincount``/``cumsum`` of the same reads, and the CLI's depth TSV and
console lines equal the JAX CLI's byte for byte.
"""

import numpy as np
import pytest

from spark_examples_tpu.core.config import ReferenceRange as JRange
from spark_examples_tpu.ingest import reads as jreads
from spark_examples_tpu.pipelines import coverage as jcoverage
from spark_examples_tpu_torch.core.config import ReferenceRange
from spark_examples_tpu_torch.ingest import reads
from spark_examples_tpu_torch.pipelines import coverage

RANGES = (("chr22", 16_050_000, 16_056_000), ("chr1", 0, 2500),
          ("chrX", 100, 130))


def _synthetic(mod, rng_cls, n=3000, **kw):
    return mod.SyntheticReadsSource(
        [rng_cls(*r) for r in RANGES], reads_per_range=n, seed=7, **kw)


def _oracle(starts, lengths, ref):
    """Per-base depth by NumPy: +1 per start, -1 past each end (clipped
    into the range), inclusive scan."""
    span = ref.end - ref.start
    s = np.clip(starts - ref.start, 0, span - 1)
    e = np.clip(starts + lengths - ref.start, 0, span)
    diff = (np.bincount(s, minlength=span + 1)
            - np.bincount(e, minlength=span + 1))
    return np.cumsum(diff[:-1])


@pytest.mark.parametrize("batch", [1, 977, 1 << 20])
def test_synthetic_reads_equal_jax_and_prefix_stable(batch):
    src = _synthetic(reads, ReferenceRange)
    jsrc = _synthetic(jreads, JRange)
    for ref, jref in zip(src.ranges(), jsrc.ranges()):
        got = [np.concatenate(x) for x in zip(*src.read_batches(ref, batch))]
        want = [np.concatenate(x)
                for x in zip(*jsrc.read_batches(jref, 4096))]
        for a, b in zip(got, want):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [500, 262144])
def test_coverage_equals_jax_and_the_oracle(batch):
    src = _synthetic(reads, ReferenceRange)
    got = coverage.coverage(src, batch=batch, device="cpu")
    want = jcoverage.coverage(_synthetic(jreads, JRange), batch=700)
    assert len(got) == len(want) == len(RANGES)
    for r, w in zip(got, want):
        assert r.depth.dtype == np.float32
        assert r.depth.tobytes() == np.asarray(w.depth).tobytes()
        assert r.n_reads == w.n_reads == 3000
        assert r.mean == w.mean
        np.testing.assert_array_equal(r.histogram(10), w.histogram(10))
        starts, lengths = (np.concatenate(x) for x in
                           zip(*src.read_batches(r.reference)))
        np.testing.assert_array_equal(
            r.depth.astype(np.int64), _oracle(starts, lengths, r.reference))


def _write_sam(path, seed=2):
    rng = np.random.default_rng(seed)
    lines = ["@HD\tVN:1.6", "@SQ\tSN:chr2\tLN:4000", "@SQ\tSN:chr9\tLN:900"]
    for i in range(400):
        contig = "chr2" if i % 3 else "chr9"
        pos = int(rng.integers(1, 3900 if contig == "chr2" else 880))
        seq = "A" * int(rng.integers(20, 160))
        lines.append(f"r{i}\t0\t{contig}\t{pos}\t60\t{len(seq)}M\t*\t0\t0\t"
                     f"{seq}\t*")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("refs", [[], ["chr2:500:3000"]])
def test_sam_source_equals_jax(tmp_path, refs):
    path = str(tmp_path / "r.sam")
    _write_sam(path)
    src = reads.SamSource(path, [ReferenceRange.parse(r) for r in refs])
    jsrc = jreads.SamSource(path, [JRange.parse(r) for r in refs])
    assert [str(r) for r in src.ranges()] == [str(r) for r in jsrc.ranges()]
    got = coverage.coverage(src, batch=50, device="cpu")
    want = jcoverage.coverage(jsrc, batch=64)
    for r, w in zip(got, want):
        assert r.depth.tobytes() == np.asarray(w.depth).tobytes()
        assert r.n_reads == w.n_reads > 0
    # A range on a contig the file does not hold has no reads.
    empty = coverage.coverage(reads.SamSource(
        path, [ReferenceRange("chr5", 0, 10)]), device="cpu")
    assert empty[0].n_reads == 0 and not empty[0].depth.any()


def _cli_pair(tmp_path, capsys, argv):
    from spark_examples_tpu.cli.main import main as jmain
    from spark_examples_tpu_torch.cli.main import main as tmain

    tpath, jpath = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    assert jmain(argv + ["--output-path", jpath]) == 0
    jout = capsys.readouterr().out
    assert tmain(argv + ["--device", "cpu", "--output-path", tpath]) == 0
    tout = capsys.readouterr().out
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        data = ft.read()
        assert data == fj.read()
    assert tout.replace(tpath, "X") == jout.replace(jpath, "X")
    return data.decode()


def test_coverage_cli_synthetic_equals_jax(tmp_path, capsys):
    text = _cli_pair(tmp_path, capsys, [
        "coverage", "--references", "chr1:1000:9000", "chr2:50:3000",
        "--reads-per-range", "2000", "--read-length", "90", "--seed", "3"])
    lines = text.splitlines()
    assert lines[0] == "contig\tposition\tdepth"
    assert len(lines) == 1 + 8000 + 2950
    assert lines[1].startswith("chr1\t1000\t")


def test_coverage_cli_default_range_and_sam_equal_jax(tmp_path, capsys):
    _cli_pair(tmp_path, capsys, ["coverage", "--reads-per-range", "500"])
    path = str(tmp_path / "r.sam")
    _write_sam(path)
    _cli_pair(tmp_path, capsys, ["coverage", "--reads-source", "sam",
                                 "--path", path])


def test_coverage_cli_refusals(capsys, monkeypatch):
    from spark_examples_tpu_torch.cli.main import main as tmain

    with pytest.raises(SystemExit, match="requires --path"):
        tmain(["coverage", "--device", "cpu", "--reads-source", "sam"])
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tmain(["coverage", "--reads-per-range", "10"])
    capsys.readouterr()
