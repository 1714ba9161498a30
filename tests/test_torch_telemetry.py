"""The port's telemetry plane against the JAX package's, on the CPU.

- Histogram summaries, ``derive_throughputs``, ``stall_fraction`` and
  ``effective_gram_time`` equal to JAX's on the same inputs.
- ``should_sample`` decides like JAX's for 1,000 seeded trace ids at
  rates 0.1 and 0.5.
- The export layout (``rank0/{trace.jsonl,metrics.json,requests.json}``,
  ``summary.txt``) and the trace events' keys; the ``telemetry.flush``
  and ``trace.export`` fault sites leave the last good files readable.
- A traced CPU gram job records as many ``phase.gram`` and
  ``gram.block`` spans as JAX's traced job on the same cohort, and the
  feed's ``prefetch.*`` waits; ``PhaseTimer.report`` and the exported
  ``derived`` agree.
- ``--trace-dir`` writes a ``torch.profiler`` Chrome trace on the CPU,
  and raises on ``--device cuda`` without a card.
"""

import json
import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.core import config as jconfig
from spark_examples_tpu.core import telemetry as jtelemetry
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu.pipelines import jobs as jjobs
from spark_examples_tpu_torch.core import faults, profiling, telemetry
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.ingest.source import ArraySource
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job

from conftest import random_genotypes


@pytest.fixture(autouse=True)
def _clean_registries():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(dir=None)
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(dir=None)


# ------------------------------------------------------------ the math

@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential",
                                  "constant", "with_nonpositive"])
def test_histogram_summaries_equal_jax(dist):
    rng = np.random.default_rng(7)
    samples = {
        "lognormal": rng.lognormal(-5.0, 1.5, 3000),
        "uniform": rng.uniform(1e-4, 2e-1, 3000),
        "exponential": rng.exponential(3e-3, 3000),
        "constant": np.full(50, 4.2e-3),
        "with_nonpositive": np.concatenate([rng.uniform(0, 1, 100),
                                            [0.0, -1.0, 1e-12]]),
    }[dist]
    h, jh = telemetry.Histogram(), jtelemetry.Histogram()
    for s in samples:
        h.record(float(s))
        jh.record(float(s))
    assert h.summary() == jh.summary()
    assert h.buckets == jh.buckets
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    other, jother = telemetry.Histogram(), jtelemetry.Histogram()
    other.record(0.5)
    jother.record(0.5)
    assert h.merge(other).summary() == jh.merge(jother).summary()


PHASE_CASES = [
    ({"gram": 2.0, "eigh": 0.5}, {"gram_flops": 4e9, "ingest_bytes": 1e6,
                                  "eigh_flops": 1e9}),
    ({"gram": 2.0, "stream_refresh": 0.5, "ingest": 1.0},
     {"gram_flops": 3e9, "ingest_bytes": 5e6}),
    ({"gram": 0.1, "stream_refresh": 0.3}, {"gram_flops": 1.0}),
    ({}, {"ingest_bytes": 1.0}),
    ({"eigh": 0.0, "gram": 1e-6}, {"eigh_flops": 2.0, "gram_flops": 7.0}),
]


@pytest.mark.parametrize("phases,counters", PHASE_CASES)
def test_derived_metrics_equal_jax(phases, counters):
    assert telemetry.derive_throughputs(phases, counters) == \
        jtelemetry.derive_throughputs(phases, counters)
    assert telemetry.effective_gram_time(phases) == \
        jtelemetry.effective_gram_time(phases)
    for wait in (0.0, 0.25, 3.0):
        assert telemetry.stall_fraction(phases, wait) == \
            jtelemetry.stall_fraction(phases, wait)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_should_sample_decides_like_jax(rate):
    rng = np.random.default_rng(11)
    ids = ["".join(f"{b:02x}" for b in rng.integers(0, 256, 8))
           for _ in range(1000)]
    before, jbefore = telemetry.trace_sample(), jtelemetry.trace_sample()
    try:
        telemetry.set_trace_sample(rate)
        jtelemetry.set_trace_sample(rate)
        got = [telemetry.should_sample(t) for t in ids]
        assert got == [jtelemetry.should_sample(t) for t in ids]
        assert 0.5 * rate * 1000 < sum(got) < 1.5 * rate * 1000
    finally:
        telemetry.set_trace_sample(before)
        jtelemetry.set_trace_sample(jbefore)


def test_sample_rate_edges_and_clamping():
    before = telemetry.trace_sample()
    try:
        telemetry.set_trace_sample(7.0)
        assert telemetry.trace_sample() == 1.0
        assert telemetry.should_sample("x")
        telemetry.set_trace_sample(-1.0)
        assert not telemetry.should_sample("x")
    finally:
        telemetry.set_trace_sample(before)


def test_families_and_undeclared_names():
    assert telemetry.is_declared("phase.anything")
    assert not telemetry.is_declared("phase")
    with pytest.warns(RuntimeWarning, match="not declared"):
        telemetry.observe("no.such.metric", 1.0)
    assert telemetry.counter_value("telemetry.unknown_names") == 1.0


def test_trace_scope_stamps_spans_and_events(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=True)
    assert telemetry.current_trace() is None
    with telemetry.trace_scope(trace_id="abc123") as ctx:
        assert telemetry.current_trace() == ctx
        with telemetry.span("store.heal", cat="store", chunk=3):
            telemetry.event("fault", cat="faults", site="x")
    assert telemetry.current_trace() is None
    evs = {e["name"]: e for e in telemetry.recent_events()}
    assert evs["store.heal"]["args"]["trace_id"] == "abc123"
    assert evs["store.heal"]["args"]["chunk"] == 3
    assert evs["fault"]["args"]["trace_id"] == "abc123"
    assert evs["fault"]["ph"] == "i"
    assert len(telemetry.new_trace_id()) == 16
    assert len(telemetry.new_span_id()) == 8


# ------------------------------------------------------------ export

def test_export_layout_and_event_keys(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=True)
    with telemetry.span("checkpoint.save", cat="checkpoint"):
        telemetry.count("checkpoint.bytes_written", 10)
    sp = telemetry.begin("gram.block", cat="gram")
    sp.end(index=1, stop=64)
    telemetry.span_at("trace.request", 1.0, 0.25, trace_id="t1", status=200)
    telemetry.event("stream.snapshot", cat="stream", n_variants=64)
    telemetry.record_request_exemplar("t1", 0.25, {"total": 0.25},
                                      status=200)
    d = telemetry.export()
    assert d == str(tmp_path / "rank0")
    assert sorted(os.listdir(d)) == ["metrics.json", "requests.json",
                                     "trace.jsonl"]
    assert os.path.exists(tmp_path / "summary.txt")
    lines = [json.loads(x) for x in open(os.path.join(d, "trace.jsonl"))]
    assert lines[0]["ph"] == "M" and lines[0]["args"]["name"] == "rank 0"
    spans = [e for e in lines if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"checkpoint.save", "gram.block",
                                          "trace.request"}
    for e in spans:
        assert set(e) == {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                          "args"}, e
        assert e["pid"] == 0 and e["dur"] >= 0
        assert e["args"]["run_id"] == telemetry.run_id()
        assert e["args"]["attempt"] == 0
    inst = [e for e in lines if e["ph"] == "i"]
    assert [e["name"] for e in inst] == ["stream.snapshot"]
    assert set(inst[0]) == {"name", "cat", "ph", "s", "ts", "pid", "tid",
                            "args"}
    ts = [e["ts"] for e in lines[1:]]
    assert ts == sorted(ts)
    m = json.load(open(os.path.join(d, "metrics.json")))
    assert set(m) == {"counters", "phases", "gauges", "histograms",
                      "derived", "meta"}
    assert m["meta"]["rank"] == 0 and m["meta"]["process_count"] == 1
    assert m["counters"]["checkpoint.bytes_written"] == 10
    req = json.load(open(os.path.join(d, "requests.json")))
    assert [e["trace_id"] for e in req["exemplars"]] == ["t1"]
    # The same keys as the JAX package's exporter writes.
    jtelemetry.configure(dir=str(tmp_path / "jax"), trace_events=True)
    with jtelemetry.span("checkpoint.save", cat="checkpoint"):
        pass
    jd = jtelemetry.export()
    jlines = [json.loads(x) for x in open(os.path.join(jd, "trace.jsonl"))]
    assert set(jlines[1]) == set(spans[0])
    assert set(json.load(open(os.path.join(jd, "metrics.json")))) == set(m)


def test_no_trace_events_keeps_metrics(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=False)
    with telemetry.span("store.heal"):
        pass
    telemetry.event("stream.snapshot", n_variants=1)
    d = telemetry.export()
    lines = [json.loads(x) for x in open(os.path.join(d, "trace.jsonl"))]
    assert [e["ph"] for e in lines] == ["M"]
    m = json.load(open(os.path.join(d, "metrics.json")))
    assert m["histograms"]["store.heal"]["count"] == 1
    # The in-process event ring records with tracing off too.
    assert len(telemetry.events("stream.snapshot")) == 1


def test_flush_fault_leaves_the_last_good_snapshot(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=False)
    telemetry.count("faults.fired")
    flusher = telemetry.PeriodicFlusher(str(tmp_path), interval_s=0.01)
    flusher.flush()
    path = tmp_path / "rank0" / "metrics.json"
    good = json.loads(path.read_text())
    assert good["counters"]["faults.fired"] == 1
    telemetry.count("faults.fired", 5)
    with faults.armed(["telemetry.flush:io_error:max=1"]):
        with pytest.warns(RuntimeWarning, match="periodic telemetry flush"):
            flusher.flush()
        # Parses (not torn) and is the last good one, from before the
        # failed flush.
        assert json.loads(path.read_text()) == good
        flusher.flush()  # recovers
    flusher.stop()
    assert telemetry.counter_value("live.flush_errors") == 1
    assert telemetry.counter_value("live.flushes") >= 2
    assert json.loads(path.read_text())["counters"]["faults.fired"] >= 7


def test_trace_export_fault_keeps_the_old_exemplars(tmp_path):
    telemetry.configure(dir=str(tmp_path), trace_events=True)
    telemetry.record_request_exemplar("a", 0.1, {"total": 0.1})
    d = telemetry.export()
    telemetry.record_request_exemplar("b", 0.2, {"total": 0.2})
    with faults.armed(["trace.export:io_error:max=1"]):
        telemetry.export()
    req = json.load(open(os.path.join(d, "requests.json")))
    assert [e["trace_id"] for e in req["exemplars"]] == ["a"]
    assert telemetry.counter_value("trace.export_errors") == 1


def test_exemplar_ring_keeps_the_slowest():
    for i in range(telemetry.TRACE_EXEMPLARS + 10):
        telemetry.record_request_exemplar(f"t{i}", float(i), {})
    ex = telemetry.request_exemplars()
    assert len(ex) == telemetry.TRACE_EXEMPLARS
    assert ex[0]["trace_id"] == f"t{telemetry.TRACE_EXEMPLARS + 9}"
    assert ex[-1]["total_s"] == 10.0


# ------------------------------------------------------- the gram loop

def _cohort(seed=5, n=24, v=1024):
    return random_genotypes(np.random.default_rng(seed), n=n, v=v)


def _spans(d: str) -> list[str]:
    return [e["name"] for e in map(json.loads, open(os.path.join(
        d, "trace.jsonl"))) if e["ph"] == "X"]


def test_traced_gram_job_spans_match_jax(tmp_path):
    g = _cohort()
    telemetry.configure(dir=str(tmp_path / "port"), trace_events=True)
    out = pcoa_job(JobConfig(ingest=IngestConfig(block_variants=256),
                             compute=ComputeConfig(metric="ibs", num_pc=3,
                                                   device="cpu")),
                   source=ArraySource(g))
    d = telemetry.export()
    jtelemetry.configure(dir=str(tmp_path / "jax"), trace_events=True)
    jjobs.pcoa_job(jconfig.JobConfig(
        ingest=jconfig.IngestConfig(block_variants=256),
        compute=jconfig.ComputeConfig(metric="ibs", num_pc=3)),
        source=JArraySource(g))
    jd = jtelemetry.export()
    names, jnames = _spans(d), _spans(jd)
    for name in ("phase.gram", "gram.block"):
        assert names.count(name) == jnames.count(name), name
    assert names.count("gram.block") == 4
    blocks = [e for e in map(json.loads, open(os.path.join(
        d, "trace.jsonl"))) if e["name"] == "gram.block"]
    assert [b["args"]["index"] for b in blocks] == [1, 2, 3, 4]
    m = json.load(open(os.path.join(d, "metrics.json")))
    assert m["histograms"]["prefetch.get_wait_s"]["count"] == 4
    assert m["histograms"]["prefetch.put_wait_s"]["count"] == 4
    assert m["gauges"]["prefetch.queue_depth"]["n"] >= 4
    assert m["gauges"]["gram.lowering"]["last"] == 0.0
    rep = out.timer.report()
    for key in ("gram_gflops_per_s", "ingest_mb_per_s", "eigh_gflops_per_s"):
        assert m["derived"][key] == pytest.approx(rep[key], rel=0.01), key
    for cname, value in out.timer.counters.items():
        assert m["counters"][cname] == pytest.approx(value)
    assert m["phases"]["gram"] == pytest.approx(out.timer.phases["gram"])
    summary = open(tmp_path / "port" / "summary.txt").read()
    assert summary.startswith("rank\tgram_gflops") and "\n0\t" in summary
    dig = telemetry.digest()
    assert dig["blocks"] == 4 and dig["ingest_retries"] == 0


def test_a_padding_slab_is_a_pad_step_not_a_block(tmp_path):
    """A step that feeds no variant (an all-MISSING padding slab) is a
    ``gram.pad_step`` event, not a ``gram.block`` sample; the
    accumulators are those of the real blocks alone."""
    from spark_examples_tpu_torch.ingest.source import BlockMeta
    from spark_examples_tpu_torch.pipelines import runner

    g = _cohort(v=512)

    class Padded(ArraySource):
        def blocks(self, block_variants, start_variant=0):
            yield from super().blocks(block_variants, start_variant)
            yield (np.full((self.n_samples, 0), -1, np.int8),
                   BlockMeta(index=2, start=512, stop=512))

    job = JobConfig(ingest=IngestConfig(block_variants=256),
                    compute=ComputeConfig(metric="ibs", device="cpu"))
    telemetry.configure(dir=str(tmp_path), trace_events=True)
    padded = runner.run_gram(job, Padded(g), profiling.PhaseTimer())
    assert [e["args"] for e in telemetry.events("gram.pad_step")] == [
        {"index": 3}]
    assert telemetry.metrics_snapshot()["histograms"]["gram.block"][
        "count"] == 2
    plain = runner.run_gram(job, ArraySource(g), profiling.PhaseTimer())
    assert padded.n_variants == plain.n_variants == 512
    for k in plain.acc:
        assert torch.equal(padded.acc[k], plain.acc[k])


def test_device_put_fault_site_fails_the_feed(tmp_path):
    from spark_examples_tpu_torch.ingest.prefetch import stream_to_device

    src = ArraySource(_cohort(v=600))
    with faults.armed(["device.put:io_error:after=1:max=1"]) as inj:
        with pytest.raises(faults.InjectedFault, match="device.put"):
            list(stream_to_device(src, 256, torch.device("cpu")))
        assert inj.fire_count("device.put") == 1
        assert inj.hit_count("device.put") == 2


def test_prefetch_transfer_wait_site_is_armable():
    """The CUDA feed fires ``prefetch.transfer_wait`` when it retires a
    slab (exercised on the card in tests/test_torch_gpu.py); here the
    spec arms and fires through the injector like every site."""
    with faults.armed(["prefetch.transfer_wait:delay:delay=0.001"]) as inj:
        faults.fire("prefetch.transfer_wait")
        assert inj.fire_count("prefetch.transfer_wait") == 1
    assert telemetry.counter_value("faults.fired") == 1


def test_phase_timer_mirrors_phases_and_counters():
    t = profiling.PhaseTimer()
    with t.phase("gram"):
        pass
    with t.phase("gram"):
        pass
    t.add("gram_flops", 1e9)
    snap = telemetry.metrics_snapshot()
    assert snap["phases"]["gram"] == pytest.approx(t.phases["gram"])
    assert snap["histograms"]["phase.gram"]["count"] == 2
    assert snap["counters"]["gram_flops"] == 1e9
    telemetry.count("ingest.retries", 2)
    rep = t.report()
    assert rep["ingest_retries"] == 2 and "gram_gflops_per_s" in rep
    assert "ingest_retries" not in profiling.PhaseTimer().report()


# ------------------------------------------------------------ --trace-dir

def test_trace_dir_writes_a_profiler_trace_on_the_cpu(tmp_path, capsys):
    from spark_examples_tpu_torch.cli.main import main

    prof = tmp_path / "prof"
    tel = tmp_path / "tel"
    assert main(["pcoa", "--device", "cpu", "--n-samples", "20",
                 "--n-variants", "600", "--block-variants", "256",
                 "--num-pc", "3", "--trace-dir", str(prof),
                 "--telemetry-dir", str(tel)]) == 0
    trace = json.load(open(prof / "trace_rank0.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert "telemetry -> " in capsys.readouterr().err
    spans = _spans(str(tel / "rank0"))
    assert spans.count("gram.block") == 3 and "phase.eigh" in spans


def test_trace_dir_on_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        with profiling.trace(str(tmp_path), "cuda"):
            pass
    assert not os.path.exists(tmp_path / "trace_rank0.json")


def test_trace_without_a_dir_is_a_no_op():
    with profiling.trace(None, "cuda") as prof:
        assert prof is None


# ------------------------------------------- the port's spans, the mirror

def _feed_source(kind, g, tmp_path):
    """The cohort ``g`` behind each way the feed reads a block: int8
    blocks packed on the host, a packed store's own bytes, and a dataset
    store decoding into the feed's buffer (the dense direct drive)."""
    from spark_examples_tpu_torch.ingest.bitpack import pack_dosages
    from spark_examples_tpu_torch.ingest.packed import Packed2BitSource

    if kind == "array":
        return ArraySource(g), "auto"
    if kind == "packed":
        return Packed2BitSource(packed=pack_dosages(g), v=g.shape[1]), "auto"
    from spark_examples_tpu_torch.store import compact, open_store

    compact(str(tmp_path / "ds"), ArraySource(g), chunk_variants=256)
    return open_store(str(tmp_path / "ds"), device="cpu"), "dense"


@pytest.mark.parametrize("kind", ["array", "packed", "store"])
def test_cpu_job_counts_the_feed_and_eigh_spans(tmp_path, kind):
    """``feed.read`` once per block the source gives, on every way the
    feed reads one; no ``feed.pin`` (no pinned ring off the card), no
    ``feed.copy`` and no ``gram.device_gap_s`` (device measures);
    ``eigh.solve`` once per job, inside its phase."""
    from spark_examples_tpu_torch.ingest.prefetch import decode_direct

    g = _cohort(v=1000)
    src, pack_stream = _feed_source(kind, g, tmp_path)
    job = JobConfig(ingest=IngestConfig(block_variants=256),
                    compute=ComputeConfig(metric="ibs", num_pc=3,
                                          device="cpu",
                                          pack_stream=pack_stream))
    assert decode_direct(src, pack=False) == (kind == "store")
    outs = [pcoa_job(job, source=src) for _ in range(2)]
    snap = telemetry.metrics_snapshot()
    hists, counters = snap["histograms"], snap["counters"]
    assert hists["feed.read"]["count"] == 2 * 4  # ceil(1000 / 256) a job
    assert hists["gram.block"]["count"] == 2 * 4
    assert hists["eigh.solve"]["count"] == 2
    assert hists["eigh.solve"]["sum"] <= sum(o.timer.phases["eigh"]
                                             for o in outs)
    for name in ("feed.pin", "feed.copy", "kernel.packed_gram.launch"):
        assert name not in hists, name
    assert "gram.device_gap_s" not in counters


def _capture(kind, fn):
    """Run ``fn`` under a CPU ``torch.profiler`` capture: the program's
    own (``--trace-dir``, every thread) or a bare one (the thread that
    started it only, as the benchmark's); the complete events back."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as d:
        if kind == "program":
            with profiling.trace(d, "cpu"):
                fn()
            path = os.path.join(d, "trace_rank0.json")
        else:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fn()
            path = os.path.join(d, "bare.json")
            prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]


@pytest.mark.parametrize("kind", ["program", "bare"])
def test_spans_are_profiler_ranges_in_a_capture(kind):
    """Every span is a range of its own name: each phase exactly once a
    job (its one mirror), the gram blocks and the eigensolve on the
    job's thread; under the program's capture the feed's reads on the
    producer's own thread too."""
    g = _cohort(v=1000)
    job = JobConfig(ingest=IngestConfig(block_variants=256),
                    compute=ComputeConfig(metric="ibs", num_pc=3,
                                          device="cpu"))
    events = _capture(kind, lambda: [pcoa_job(job, source=ArraySource(g))
                                     for _ in range(2)])
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ranges]
    for phase in ("phase.gram", "phase.finalize", "phase.eigh"):
        assert names.count(phase) == 2, phase
    assert names.count("eigh.solve") == 2
    # Every block's span, and the last one cancelled at the stream's end.
    assert names.count("gram.block") == 2 * 5
    job_tid = {e["tid"] for e in ranges if e["name"] == "phase.gram"}
    assert len(job_tid) == 1
    assert {e["tid"] for e in ranges if e["name"] == "gram.block"} == job_tid
    if kind == "program":
        reads = [e for e in ranges if e["name"] == "feed.read"]
        assert len(reads) >= 2 * 4
        assert not {e["tid"] for e in reads} & job_tid


def test_no_range_is_opened_without_a_capture(monkeypatch):
    """With no capture running a span opens no range; under one, each
    span opens one, and closes it when the span ends or is cancelled."""
    opened = []

    class Range:
        def __init__(self, name):
            self.name, self.open = name, True
            opened.append(self)

        def __exit__(self, *exc):
            self.open = False

    monkeypatch.setattr(telemetry, "_mirror",
                        (profiling._capture_running, Range))
    g = _cohort(v=600)
    job = JobConfig(ingest=IngestConfig(block_variants=256),
                    compute=ComputeConfig(metric="ibs", num_pc=3,
                                          device="cpu"))
    pcoa_job(job, source=ArraySource(g))
    with telemetry.span("feed.pin"):
        pass
    telemetry.begin("gram.block").cancel()
    assert opened == []
    monkeypatch.setattr(telemetry, "_mirror", (lambda: True, Range))
    with telemetry.span("feed.pin"):
        pass
    telemetry.begin("gram.block").cancel()
    telemetry.begin("feed.read").end()
    with profiling.device_span("eigh.solve", "cpu"):
        pass
    assert [r.name for r in opened] == ["feed.pin", "gram.block",
                                        "feed.read", "eigh.solve"]
    assert not any(r.open for r in opened)
