"""The example tier's variant jobs (``search-variants``,
``sample-stats``) against the JAX package's, on the CPU.

Counts are integers, so every comparison is exact: the per-variant
histograms (a full scan, and a position filter with hits, misses and
the empty set), the per-sample counts, and the CLI's TSV files, which
must equal the JAX CLI's byte for byte. The cohort is ragged (the last
block is short) and carries missing calls.
"""

import numpy as np
import pytest

from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.pipelines import examples as jexamples
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.pipelines import examples, runner

N, V = 23, 1000


def _cohort(seed=3):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(N, V), dtype=np.int8)
    g[rng.random((N, V)) < 0.15] = -1
    return g


def _positions():
    return np.sort(np.random.default_rng(4).choice(
        10 ** 6, V, replace=False)).astype(np.int64)


def _sources(with_positions: bool):
    g = _cohort()
    pos = _positions() if with_positions else None
    return (ArraySource(g, contig="chr7", positions=pos),
            JArraySource(g, contig="chr7", positions=pos))


def _rows(items):
    return [tuple(vars(x).items()) for x in items]


@pytest.mark.parametrize("bv", [128, 333, 1000])
@pytest.mark.parametrize("with_positions", [False, True])
def test_full_histogram_equals_jax(bv, with_positions):
    src, jsrc = _sources(with_positions)
    got = examples.genotype_histogram(src, bv, device="cpu")
    want = jexamples.genotype_histogram(jsrc, bv)
    assert len(got) == V
    assert _rows(got) == _rows(want)
    assert [c.allele_freq for c in got] == [c.allele_freq for c in want]
    g = _cohort()
    assert [c.missing for c in got] == list((g == -1).sum(axis=0))


@pytest.mark.parametrize("bv", [128, 333])
def test_filtered_histogram_equals_jax(bv):
    src, jsrc = _sources(True)
    pos = _positions()
    wanted = {int(pos[0]), int(pos[129]), int(pos[-1]), -5, 10 ** 7}
    got = examples.genotype_histogram(src, bv, wanted, device="cpu")
    want = jexamples.genotype_histogram(jsrc, bv, wanted)
    assert [c.position for c in got] == [pos[0], pos[129], pos[-1]]
    assert _rows(got) == _rows(want)
    assert examples.genotype_histogram(src, bv, set(), device="cpu") == []


def test_filtered_search_reduces_only_blocks_with_a_hit(monkeypatch):
    src, _ = _sources(False)
    calls = []
    plain = examples.block_histogram
    monkeypatch.setattr(examples, "block_histogram",
                        lambda b: calls.append(b.shape) or plain(b))
    got = examples.genotype_histogram(src, 100, {5, 950}, device="cpu")
    assert [c.position for c in got] == [5, 950]
    assert len(calls) == 2  # blocks 0 and 9 of 10


@pytest.mark.parametrize("bv", [128, 333, 1000])
def test_sample_stats_equal_jax(bv):
    src, jsrc = _sources(False)
    got = examples.sample_stats(src, bv, device="cpu")
    want = jexamples.sample_stats(jsrc, bv)
    assert _rows(got) == _rows(want)
    g = _cohort()
    assert [s.n_called for s in got] == list((g >= 0).sum(axis=1))
    assert [(s.call_rate, s.het_rate) for s in got] == \
        [(s.call_rate, s.het_rate) for s in want]
    assert examples.sample_stats(ArraySource(g[:, :0]), bv,
                                 device="cpu") == []


def _cli_pair(tmp_path, capsys, argv):
    from spark_examples_tpu.cli.main import main as jmain
    from spark_examples_tpu_torch.cli.main import main as tmain

    tpath, jpath = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    assert jmain(argv + ["--output-path", jpath]) in (0, None)
    jout = capsys.readouterr().out
    assert tmain(argv + ["--device", "cpu", "--output-path", tpath]) == 0
    tout = capsys.readouterr().out
    with open(tpath, "rb") as ft, open(jpath, "rb") as fj:
        data = ft.read()
        assert data == fj.read()
    assert tout.replace(tpath, "X") == jout.replace(jpath, "X")
    return data.decode()


COMMON = ["--n-samples", "30", "--n-variants", "1100", "--block-variants",
          "256", "--seed", "5"]


@pytest.mark.parametrize("positions", [None, ["3", "700", "1099", "5000"]])
def test_search_variants_cli_equals_jax(tmp_path, capsys, positions):
    argv = ["search-variants"] + COMMON
    if positions:
        argv += ["--positions"] + positions
    text = _cli_pair(tmp_path, capsys, argv)
    lines = text.splitlines()
    assert lines[0] == "contig\tposition\thom_ref\thet\thom_alt\tmissing\taf"
    assert len(lines) == 1 + (3 if positions else 1100)


def test_sample_stats_cli_equals_jax(tmp_path, capsys):
    text = _cli_pair(tmp_path, capsys, ["sample-stats"] + COMMON)
    assert len(text.splitlines()) == 31


def test_example_jobs_close_their_source(monkeypatch, capsys):
    from spark_examples_tpu_torch.cli.main import main as tmain

    closed = []
    monkeypatch.setattr(runner, "close_source", closed.append)
    for cmd in ("search-variants", "sample-stats"):
        assert tmain([cmd, "--device", "cpu"] + COMMON) == 0
    assert len(closed) == 2
    capsys.readouterr()


def test_example_jobs_on_cuda_without_a_card_raise(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, _ = _sources(False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        examples.sample_stats(src, 128)
    with pytest.raises(RuntimeError, match="--device cuda"):
        examples.genotype_histogram(src, 128)
