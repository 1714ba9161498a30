"""The PyTorch port's file sources against the JAX package's, on the CPU:
VCF (plain and gzip, ``--references``, CRLF, a missing GT subfield,
short records), PLINK (prefix and ``.bed`` path, ranges, chromosome
flush) and the packed store in both directions. Blocks must be equal
byte for byte and every ``BlockMeta`` field equal; a store or fileset
written by either package must read in the other. Files are written
with the JAX package's writers (and the port's, for the other
direction) in ``tmp_path``."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.core.config import ReferenceRange as JRange
from spark_examples_tpu.ingest import packed as jpacked
from spark_examples_tpu.ingest import plink as jplink
from spark_examples_tpu.ingest import vcf as jvcf
from spark_examples_tpu.ingest.source import ArraySource as JArraySource
from spark_examples_tpu_torch import store as tstore
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.config import ReferenceRange
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.ingest import packed as tpacked
from spark_examples_tpu_torch.ingest import plink as tplink
from spark_examples_tpu_torch.ingest import prefetch as tprefetch
from spark_examples_tpu_torch.ingest import vcf as tvcf
from spark_examples_tpu_torch.ingest.resilient import RetryingSource
from spark_examples_tpu_torch.ingest.source import ArraySource, WindowSource

from conftest import random_genotypes

CPU = torch.device("cpu")


def assert_same_stream(got, want):
    """Two (block, BlockMeta) lists: equal blocks, every meta field."""
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gb.dtype == wb.dtype
        np.testing.assert_array_equal(gb, wb)
        assert (gm.index, gm.start, gm.stop, gm.contig) == \
            (wm.index, wm.start, wm.stop, wm.contig)
        if wm.positions is None:
            assert gm.positions is None
        else:
            np.testing.assert_array_equal(gm.positions, wm.positions)
            assert np.asarray(gm.positions).dtype == \
                np.asarray(wm.positions).dtype


@pytest.fixture(scope="module")
def cohort():
    return random_genotypes(np.random.default_rng(31), 13, 300, 0.15)


# ------------------------------------------------------------------- VCF

def _two_contig_vcf(path, g):
    """chr21 (first 120 variants) then chr22, written by the JAX writer."""
    a, b = str(path) + ".a", str(path) + ".b"
    jvcf.write_vcf(a, g[:, :120], contig="chr21", start_pos=100)
    jvcf.write_vcf(b, g[:, 120:], contig="chr22", start_pos=5000)
    with open(path, "w") as out, open(a) as fa, open(b) as fb:
        out.write(fa.read())
        out.writelines(line for line in fb if not line.startswith("#"))


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("bv", [64, 100])
def test_vcf_blocks_and_metas_match_jax(tmp_path, cohort, suffix, bv):
    path = str(tmp_path / f"c{suffix}")
    jvcf.write_vcf(path, cohort)
    t, j = tvcf.VcfSource(path), jvcf.VcfSource(path)
    assert t.sample_ids == j.sample_ids
    assert t.n_variants == j.n_variants == cohort.shape[1]
    got, want = list(t.blocks(bv)), list(j.blocks(bv))
    assert_same_stream(got, want)
    np.testing.assert_array_equal(
        np.concatenate([b for b, _ in got], axis=1), cohort)
    assert_same_stream(list(t.blocks(bv, start_variant=bv)),
                       list(j.blocks(bv, start_variant=bv)))


def test_vcf_contig_flush_and_references_match_jax(tmp_path, cohort):
    path = str(tmp_path / "two.vcf")
    _two_contig_vcf(path, cohort)
    assert_same_stream(list(tvcf.VcfSource(path).blocks(50)),
                       list(jvcf.VcfSource(path).blocks(50)))
    specs = ["chr21:130:180", "chr22:5010:5100"]
    t = tvcf.VcfSource(path, references=[ReferenceRange.parse(s)
                                         for s in specs])
    j = jvcf.VcfSource(path, references=[JRange.parse(s) for s in specs])
    assert t.n_variants == j.n_variants == 50 + 90
    got = list(t.blocks(32))
    assert_same_stream(got, list(j.blocks(32)))
    assert {m.contig for _, m in got} == {"chr21", "chr22"}


def test_vcf_crlf_missing_gt_subfield_and_short_records(tmp_path):
    """CRLF line ends, a sample column without its GT subfield (missing),
    half-calls, multi-allelic and phased calls, a record without GT and
    a short record (skipped, one warning) — the same on both sides."""
    rows = [
        "chr1\t10\t.\tA\tC\t.\tPASS\t.\tGT:DP\t0/1:3\t1|1:4\t./.:0",
        "chr1\t11\t.\tA\tC,G\t.\tPASS\t.\tDP:GT\t3\t5:2/1\t7:.",
        "chr1\t12\t.\tA\tC\t.\tPASS\t.\tDP\t3\t5\t7",
        "chr1\t13\t.\tA\tC\t.\tPASS\t.\tGT\t0/1\t1/1",
        "chr1\t14\t.\tA\tC\t.\tPASS\t.\tGT\t./1\t0\t1/.",
        "chr1\t15\t.\tA\tC\t.\tPASS\t.\tGT\t0/1\t1/1",
    ]
    text = ("##fileformat=VCFv4.2\r\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
            "FILTER\tINFO\tFORMAT\tA\tB\tC\r\n" + "\r\n".join(rows) + "\r\n")
    path = tmp_path / "crlf.vcf"
    path.write_bytes(text.encode())
    t, j = tvcf.VcfSource(str(path)), jvcf.VcfSource(str(path))
    assert t.sample_ids == j.sample_ids == ["A", "B", "C"]
    with pytest.warns(RuntimeWarning, match="sample columns") as rec:
        got = list(t.blocks(8))
    assert len([w for w in rec if "sample columns" in str(w.message)]) == 1
    with pytest.warns(RuntimeWarning, match="sample columns"):
        want = list(j.blocks(8))
    assert_same_stream(got, want)
    np.testing.assert_array_equal(
        got[0][0], [[1, -1, 1], [2, 2, 0], [-1, -1, 1]])
    assert t.n_variants == j.n_variants == 3


def test_vcf_parse_record_lines_matches_jax():
    lines = [b"#x\n", b"chr2\t7\t.\tA\tC\t.\t.\t.\tGT:AD\t1/0:1,2\t0|0\n",
             b"too\tshort\n"]
    got = list(tvcf.parse_record_lines(lines, 2, lambda c, p: True, "m"))
    want = list(jvcf.parse_record_lines(lines, 2, lambda c, p: True, "m"))
    assert [(c, p, col.tolist()) for c, p, col in got] == \
        [(c, p, col.tolist()) for c, p, col in want] == [("chr2", 7, [1, 0])]
    for gt in ("0/0", "0/1", "1/2", "./.", ".", "1", "0|1", "3/0", "", "./0"):
        assert tvcf._dosage(gt) == jvcf._dosage(gt), gt


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_vcf_writers_write_the_same_bytes(tmp_path, cohort, suffix):
    a, b = str(tmp_path / f"t{suffix}"), str(tmp_path / f"j{suffix}")
    tvcf.write_vcf(a, cohort, contig="chr3", start_pos=77)
    jvcf.write_vcf(b, cohort, contig="chr3", start_pos=77)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_vcf_without_a_header_is_refused(tmp_path):
    path = tmp_path / "bad.vcf"
    path.write_text("chr1\t1\t.\tA\tC\t.\t.\t.\tGT\t0/1\n")
    with pytest.raises(ValueError, match="#CHROM"):
        tvcf.VcfSource(str(path)).sample_ids


# ----------------------------------------------------------------- PLINK

@pytest.fixture()
def plink_prefix(tmp_path, cohort):
    prefix = str(tmp_path / "cohort")
    chroms = ["1"] * 130 + ["2"] * 170
    positions = np.concatenate([np.arange(130) * 10 + 5,
                                np.arange(170) * 7 + 1])
    jplink.write_plink(prefix, cohort, chroms=chroms, positions=positions)
    return prefix


@pytest.mark.parametrize("as_bed", [False, True])
@pytest.mark.parametrize("bv", [64, 200])
def test_plink_blocks_match_jax(plink_prefix, cohort, as_bed, bv):
    path = plink_prefix + ".bed" if as_bed else plink_prefix
    t, j = tplink.PlinkSource(path), jplink.PlinkSource(path)
    assert t.sample_ids == j.sample_ids
    assert t.n_samples == j.n_samples == cohort.shape[0]
    assert t.n_variants == j.n_variants == cohort.shape[1]
    got = list(t.blocks(bv))
    assert_same_stream(got, list(j.blocks(bv)))
    np.testing.assert_array_equal(
        np.concatenate([b for b, _ in got], axis=1), cohort)
    assert_same_stream(list(t.blocks(bv, start_variant=bv)),
                       list(j.blocks(bv, start_variant=bv)))


def test_plink_references_match_jax(plink_prefix):
    specs = ["1:100:700", "2:30:400"]
    t = tplink.PlinkSource(plink_prefix,
                           references=[ReferenceRange.parse(s) for s in specs])
    j = jplink.PlinkSource(plink_prefix,
                           references=[JRange.parse(s) for s in specs])
    assert t.n_variants == j.n_variants > 0
    assert_same_stream(list(t.blocks(40)), list(j.blocks(40)))


def test_plink_writers_write_the_same_files(tmp_path, cohort):
    ta, ja = str(tmp_path / "t"), str(tmp_path / "j")
    tplink.write_plink(ta, cohort)
    jplink.write_plink(ja, cohort)
    for ext in (".bed", ".bim", ".fam"):
        with open(ta + ext, "rb") as f, open(ja + ext, "rb") as g:
            assert f.read() == g.read(), ext
    assert_same_stream(list(jplink.PlinkSource(ta).blocks(128)),
                       list(tplink.PlinkSource(ja).blocks(128)))


def test_plink_bad_magic_and_sample_major_are_refused(tmp_path, cohort):
    prefix = str(tmp_path / "x")
    tplink.write_plink(prefix, cohort)
    raw = open(prefix + ".bed", "rb").read()
    open(prefix + ".bed", "wb").write(raw[:2] + b"\x00" + raw[3:])
    with pytest.raises(ValueError, match="sample-major"):
        tplink.PlinkSource(prefix)
    open(prefix + ".bed", "wb").write(b"\x00" + raw[1:])
    with pytest.raises(ValueError, match="bad magic"):
        tplink.PlinkSource(prefix)


# ---------------------------------------------------------- packed store

def _store_files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("bits", [2, 8])
def test_save_packed_writes_the_same_bytes_as_jax(tmp_path, cohort, bits):
    ids = [f"s{i}" for i in range(cohort.shape[0])]
    pos = np.arange(cohort.shape[1], dtype=np.int64) * 3
    tpacked.save_packed(str(tmp_path / "t"), cohort, ids, "chr9", pos, bits)
    jpacked.save_packed(str(tmp_path / "j"), cohort, ids, "chr9", pos, bits)
    assert _store_files(str(tmp_path / "t")) == \
        _store_files(str(tmp_path / "j"))


@pytest.mark.parametrize("bv", [100, 128])
def test_port_reads_a_jax_packed_store(tmp_path, cohort, bv):
    path = str(tmp_path / "store")
    jpacked.save_packed(path, cohort, contig="chr9",
                        positions=np.arange(300) + 11)
    t, j = tpacked.load_packed(path), jpacked.load_packed(path)
    assert isinstance(t, tpacked.Packed2BitSource)
    assert (t.n_samples, t.n_variants, t.sample_ids) == \
        (j.n_samples, j.n_variants, j.sample_ids)
    assert_same_stream(list(t.blocks(bv)), list(j.blocks(bv)))
    if bv % 4 == 0:
        got, want = list(t.packed_blocks(bv)), list(j.packed_blocks(bv))
        assert [b.dtype for b, _ in got] == [np.uint8] * len(want)
        assert_same_stream(got, want)
        with pytest.raises(ValueError, match="divisible by 4"):
            next(t.packed_blocks(bv + 1))


def test_jax_reads_a_port_packed_store_from_pack_source(tmp_path, cohort):
    """pack_source over a multi-contig stream: contig runs, positions and
    bytes as JAX writes them; packed blocks straddling a run carry
    contig=None on both sides."""
    path_t, path_j = str(tmp_path / "t"), str(tmp_path / "j")
    prefix = str(tmp_path / "pl")
    jplink.write_plink(prefix, cohort, chroms=["1"] * 150 + ["2"] * 150,
                       positions=np.arange(300) + 1)
    assert tpacked.pack_source(path_t, tplink.PlinkSource(prefix), 64) == 300
    assert jpacked.pack_source(path_j, jplink.PlinkSource(prefix), 64) == 300
    assert _store_files(path_t) == _store_files(path_j)
    meta = json.load(open(os.path.join(path_t, "meta.json")))
    assert meta["contig_runs"] == [["1", 0], ["2", 150]]
    t, j = jpacked.load_packed(path_t), tpacked.load_packed(path_j)
    assert_same_stream(list(j.blocks(64)), list(t.blocks(64)))
    got, want = list(j.packed_blocks(64)), list(t.packed_blocks(64))
    assert_same_stream(got, want)
    assert [m.contig for _, m in got] == ["1", "1", None, "2", "2"]


def test_bits8_store_loads_as_an_array_source(tmp_path, cohort):
    path = str(tmp_path / "s8")
    jpacked.save_packed(path, cohort, bits=8)
    t = tpacked.load_packed(path)
    assert isinstance(t, ArraySource)
    assert_same_stream(list(t.blocks(77)),
                       list(JArraySource(cohort).blocks(77)))


def _corrupt(path, how):
    meta_path = os.path.join(path, "meta.json")
    meta = json.load(open(meta_path))
    if how == "no meta":
        os.remove(meta_path)
    elif how == "bad json":
        open(meta_path, "w").write("{\"n_samples\": 3,")
    elif how == "no version":
        meta.pop("schema_version")
        json.dump(meta, open(meta_path, "w"))
    elif how == "newer":
        meta["schema_version"] = 99
        json.dump(meta, open(meta_path, "w"))
    elif how == "no field":
        meta.pop("bits")
        json.dump(meta, open(meta_path, "w"))
    elif how == "no genotypes":
        os.remove(os.path.join(path, "genotypes.2bit.npy"))
    elif how == "corrupt npy":
        open(os.path.join(path, "genotypes.2bit.npy"), "wb").write(b"xx")


@pytest.mark.parametrize("how", ["no meta", "bad json", "no version",
                                 "newer", "no field", "no genotypes",
                                 "corrupt npy"])
def test_packed_format_errors_match_jax(tmp_path, cohort, how):
    path = str(tmp_path / "bad")
    tpacked.save_packed(path, cohort)
    _corrupt(path, how)
    with pytest.raises(jpacked.PackedFormatError) as want:
        jpacked.load_packed(path)
    with pytest.raises(tpacked.PackedFormatError) as got:
        tpacked.load_packed(path)
    assert str(got.value) == str(want.value)


def test_packed_feed_ships_the_stored_bytes(tmp_path, cohort):
    """The packed transport streams a packed store's own bytes (padded
    with four-missing bytes at the tail), never its dense blocks."""
    path = str(tmp_path / "store")
    tpacked.save_packed(path, cohort)
    src = tpacked.load_packed(path)

    def no_dense(*a, **k):
        raise AssertionError("the packed transport unpacked the store")

    src.blocks = no_dense
    got = list(tprefetch.stream_to_device(src, 128, CPU, pack=True))
    stored = np.load(os.path.join(path, "genotypes.2bit.npy"))
    assert [m.stop for _, m in got] == [128, 256, 300]
    assert all(b.shape == (13, 32) and b.dtype == torch.uint8
               for b, _ in got)
    flat = np.concatenate([b.numpy() for b, _ in got], axis=1)
    np.testing.assert_array_equal(flat[:, :75], stored)
    assert (flat[:, 75:] == 0xFF).all()
    # A block width off the byte grid falls back to the host re-pack.
    src = tpacked.load_packed(path)
    repacked = list(tprefetch.stream_to_device(src, 130, CPU, pack=True))
    assert [m.stop for _, m in repacked] == [130, 260, 300]


class _HostSlab(tprefetch._Slab):
    """A staging slab in plain host memory (a CPU-only torch cannot pin),
    first filled with a byte no block holds, so a byte the gather missed
    shows."""

    def __init__(self, shape, dtype, free):
        self.tensor = torch.full(shape, 0x5A, dtype=dtype)
        self.array = self.tensor.numpy()
        self._free = free


def _packed_feed_source(kind, g, tmp_path):
    """``(source, its variant 0's column in g, views)``: each source the
    packed feed streams, and whether it hands the feed views."""
    stored = bitpack.pack_dosages(g)
    if kind == "memory":
        return tpacked.Packed2BitSource(stored, g.shape[1]), 0, True
    if kind == "mapping":
        tpacked.save_packed(str(tmp_path / "p"), g)
        return tpacked.load_packed(str(tmp_path / "p")), 0, True
    if kind == "window":
        inner = tpacked.Packed2BitSource(stored, g.shape[1])
        return WindowSource(inner, 64, 256), 64, True
    if kind.startswith("dense"):
        return ArraySource(g), 0, False
    codec, chunk = {"store-raw": ("raw", 64), "store-zlib": ("zlib", 128),
                    "retrying-store": ("raw", 64),
                    "store-repack": ("raw", 48)}[kind]
    path = str(tmp_path / "s")
    tstore.compact(path, ArraySource(g), chunk_variants=chunk, codec=codec)
    src = tstore.open_store(path)
    if kind == "retrying-store":
        src = RetryingSource(src)
    # Blocks of 64 straddle chunks of 48: re-packed from the dense decode.
    return src, 0, kind != "store-repack"


@pytest.mark.parametrize("start", [0, 128])
@pytest.mark.parametrize("kind", ["memory", "mapping", "window", "store-raw",
                                  "store-zlib", "retrying-store",
                                  "store-repack", "dense"])
def test_producer_gathers_a_source_s_views_into_its_slab(
        tmp_path, cohort, monkeypatch, kind, start):
    """The CUDA feed's producer over reused staging slabs: a source that
    holds its 2-bit bytes hands over views, and the gather into the slab
    (the ragged tail padded with 0xFF over the last block's bytes) is
    each block's one host copy, counted by ``feed.gathered_blocks``;
    every slab is byte for byte the block the CPU feed copies out
    (``np.ascontiguousarray`` and ``pad_packed``), and a source that
    builds its blocks is gathered from its own array, uncounted."""
    monkeypatch.setattr(tprefetch, "_Slab", _HostSlab)
    src, col0, views = _packed_feed_source(kind, cohort, tmp_path)
    bv, n = 64, cohort.shape[0]
    width = tprefetch.padded_width(bv, pack=True)
    ring = tprefetch._PinnedRing(4, (n, width), torch.uint8)
    want = list(tprefetch.stream_to_device(src, bv, CPU, start_variant=start,
                                           pack=True))
    telemetry.reset()
    got = []
    for host, slab, meta in tprefetch._produce(src, bv, start, 2, True, ring,
                                               None, width):
        assert host is slab.array
        got.append((host.copy(), meta))
        slab.release()
    assert [m.start for _, m in got] == list(range(start, src.n_variants,
                                                   bv))
    assert_same_stream(got, [(b.numpy(), m) for b, m in want])
    for block, meta in got:
        lo, hi = col0 + meta.start, col0 + meta.stop
        np.testing.assert_array_equal(block, bitpack.pack_dosages(
            tprefetch.pad_block(cohort[:, lo:hi], bv)))
    assert telemetry.counter_value("feed.gathered_blocks") == \
        (len(got) if views else 0)
