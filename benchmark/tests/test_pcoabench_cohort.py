"""The frozen 2-bit layout against the port's codec, byte for byte; the
cohort's determinism; the reference's counts against the port's host
oracle."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import cohort
from benchmark.reference import pcoa_ref
from conftest import ROOT
from spark_examples_tpu_torch.ingest import bitpack
from spark_examples_tpu_torch.utils import oracle


@pytest.mark.parametrize("v", [1, 3, 4, 5, 64, 1031])
def test_pack_matches_the_port_byte_for_byte(v):
    g = np.random.default_rng(v).integers(-1, 3, (7, v)).astype(np.int8)
    mine = cohort.pack_2bit(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(mine, bitpack.pack_dosages(g))
    back = pcoa_ref.unpack_2bit(torch.from_numpy(mine)).numpy()
    np.testing.assert_array_equal(back, bitpack.unpack_dosages_np(mine))
    np.testing.assert_array_equal(back[:, :v], g)


def _config(n=40, v=cohort.CHUNK_VARIANTS + 1001):
    config = json.loads((ROOT / "benchmark" / "configs" /
                         "kg3-2504.json").read_text())
    config.update(n_samples=n, n_variants=v,
                  groups={"A": n // 2, "B": n - n // 2})
    return config


def test_cohort_is_the_seeds():
    config = _config()
    a = cohort.Cohort(config, 2**33 + 1, "cpu").to_host()
    b = cohort.Cohort(config, 2**33 + 1, "cpu").to_host()
    c = cohort.Cohort(config, 2**33 + 2, "cpu").to_host()
    np.testing.assert_array_equal(a, b)
    assert (a != c).mean() > 0.5
    assert a.shape == (40, cohort.packed_width(config["n_variants"]))
    g = bitpack.unpack_dosages_np(a)[:, :config["n_variants"]]
    assert 0.003 < (g < 0).mean() < 0.03  # 1 % missing
    assert (bitpack.unpack_dosages_np(a)[:, config["n_variants"]:] == -1).all()


def test_groups_keep_their_sizes():
    labels = cohort.group_labels([3, 5, 2], seed=9)
    assert np.bincount(labels).tolist() == [3, 5, 2]
    ids = cohort.sample_ids({"X": 3, "Y": 5, "Z": 2}, labels)
    assert sorted(i.split("_")[0] for i in ids) == ["X"] * 3 + ["Y"] * 5 + [
        "Z"] * 2


def test_store_reads_in_the_port(tmp_path):
    from spark_examples_tpu_torch.ingest.packed import load_packed

    config = _config(n=24, v=3001)
    co = cohort.Cohort(config, 5, "cpu")
    mapped = co.write_store(str(tmp_path))
    src = load_packed(str(tmp_path))
    assert src.n_variants == 3001 and src.sample_ids == co.sample_ids
    np.testing.assert_array_equal(np.asarray(src.packed), mapped)


def test_reference_counts_match_the_port_oracle():
    config = _config(n=30, v=2003)
    packed = cohort.Cohort(config, 3, "cpu").to_host()
    d1, m = pcoa_ref.ibs_counts(packed, "cpu", chunk_variants=512)
    g = bitpack.unpack_dosages_np(packed)[:, :2003]
    prods = oracle.cpu_gram_products(g, ("cc", "yc", "t1t1", "t2t2"))
    stats = oracle.combine_products(prods, ("m", "d1"))
    np.testing.assert_array_equal(m.numpy(), stats["m"])
    np.testing.assert_array_equal(d1.numpy(), stats["d1"])
    want = oracle.cpu_finalize(stats, "ibs")["distance"]
    np.testing.assert_allclose(pcoa_ref.ibs_distance(d1, m).numpy(), want,
                               rtol=0, atol=1e-15)
