"""The port's tiled PCoA route against the benchmark's tiled reference
(``benchmark/reference/pcoa_ref_tiled.py``), on the CPU.

A seeded cohort of 302 samples (tiles of 151 rows, not a multiple of 8)
in ten groups over 3,000 variants, drawn by the benchmark's own cohort
model. The program's job is ``pcoa_job`` under the four-card cell's mix
(``benchmark/traffic/tile2d-memory.json``) over four virtual slots,
judged by ``compare.judge`` against the cell's limits; the tiled
reference is held against the dense one; three planted faults on the
tiled route each push a reading over its limit; and the route's
exchange counters read what they count.

At this size the bulk of the spectrum starts at 6 % of ``lam_1`` (at the
cell's 76,156 samples, near 0.05 %), so the mix's 8 power steps leave
the tenth pair short by about 2e-3 ``lam_1``: these jobs take 40, so
what the limits judge is the tiled route's arithmetic.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.cohort import Cohort
from benchmark.reference.compare import judge
from benchmark.reference.pcoa_ref import Reference
from benchmark.reference.pcoa_ref_tiled import (
    TiledReference,
    block_lanczos,
    devices_for,
)
from spark_examples_tpu_torch.core import meshes, telemetry, virtual
from spark_examples_tpu_torch.core.config import (
    ComputeConfig,
    IngestConfig,
    JobConfig,
)
from spark_examples_tpu_torch.core.profiling import CardSkew
from spark_examples_tpu_torch.ingest.packed import Packed2BitSource
from spark_examples_tpu_torch.parallel import gram_sharded as gs
from spark_examples_tpu_torch.parallel import pcoa_sharded as ps
from spark_examples_tpu_torch.pipelines.jobs import pcoa_job

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
CELL = "gnomad3g-76156.tile2d-4chip"
N_SAMPLES, N_VARIANTS, SEED = 302, 3000, 2**33 + 23
# gnomAD v3.1's ten groups scaled to 302 samples (two at least a group).
GROUPS = {"AFR": 82, "AMI": 2, "AMR": 30, "ASJ": 7, "EAS": 10, "FIN": 21,
          "MID": 2, "NFE": 134, "SAS": 10, "OTH": 4}
TEST_ITERS = 40
K = 10


def _read(path):
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def cell():
    cell = _read(BENCH / "workloads" / f"{CELL}.json")
    config = _read(BENCH / "configs" / f"{cell['config']}.json")
    mix = _read(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, mix


@pytest.fixture(scope="module")
def packed(cell):
    config = dict(cell[1], name="test", n_samples=N_SAMPLES,
                  n_variants=N_VARIANTS, groups=GROUPS)
    out = Cohort(config, SEED, torch.device("cpu")).to_host()
    out.flags.writeable = False
    return out


@pytest.fixture(scope="module")
def reference(packed):
    return TiledReference(packed, K, devices_for("cpu"))


def _job(mix, block_variants=1024):
    return JobConfig(
        ingest=IngestConfig(block_variants=block_variants,
                            prefetch_blocks=int(mix["prefetch_blocks"])),
        compute=ComputeConfig(
            metric=mix["metric"], num_pc=int(mix["num_pc"]),
            solver=mix["solver"], eigh_mode=mix["eigh_mode"], device="cpu",
            gram_mode=mix["gram_mode"],
            mesh_shape=tuple(mix["mesh_shape"]),
            tile2d_transport=mix["tile2d_transport"], eigh_iters=TEST_ITERS,
            eigh_oversample=int(mix["eigh_oversample"])))


def _run_job(packed, mix):
    src = Packed2BitSource(packed=packed, v=N_VARIANTS,
                           ids=[f"s{i:03d}" for i in range(N_SAMPLES)])
    with virtual.virtual_slots(int(np.prod(mix["mesh_shape"]))):
        return pcoa_job(_job(mix), source=src)


def _assembled(b):
    n = b.shape[0]
    out = torch.zeros((n, n), dtype=torch.float64)
    for (i, j), t in b.tiles.items():
        r0, r1, c0, c1 = b.spans(i, j)
        out[r0:r1, c0:c1] = t
    return out


def test_the_mix_states_the_tiled_route(cell):
    _, _, mix = cell
    assert mix["gram_mode"] == "tile2d"
    assert tuple(mix["mesh_shape"]) == (2, 2)
    assert mix["tile2d_transport"] == "gather"
    assert (mix["eigh_iters"], mix["eigh_oversample"]) == (8, 32)


def test_tiled_job_within_the_cell_limits(cell, packed, reference):
    limits = cell[0]["limits"]
    out = _run_job(packed, cell[2])
    got = judge(reference, out.coords, out.eigenvalues)
    assert all(got[k] <= limits[k] for k in limits), (got, limits)


@pytest.mark.parametrize("n", [N_SAMPLES, N_SAMPLES - 1])
def test_tiled_reference_is_the_dense_one(packed, n):
    rows = np.ascontiguousarray(packed[:n])
    dense = Reference(rows, K, "cpu")
    tiled = TiledReference(rows, K, devices_for("cpu"))
    b = _assembled(tiled.b)
    assert float((b - dense.b).abs().max() / dense.b.abs().max()) < 1e-12
    gap = (tiled.vals.cpu() - dense.vals).abs().max() / dense.vals[0]
    assert float(gap) < 1e-12
    assert float(tiled.residuals.max() / tiled.vals[0]) <= 1e-9
    v = torch.randn((n, 3), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    assert torch.allclose(tiled.b @ v, dense.b @ v, rtol=0, atol=1e-12 *
                          float(dense.b.abs().max()) * n)


def test_lanczos_raises_past_its_basis():
    a = torch.diag(torch.linspace(1.0, 2.0, 400, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="basis vectors"):
        block_lanczos(a.__matmul__, 400, 10, "cpu", block=8, max_basis=32,
                      check_every=2)


def _skip_one_block_of_slot(slot, which):
    orig = gs._TileContraction.__call__
    seen = {"n": 0}

    def call(self, acc, s, chunk, cache):
        if s == slot:
            seen["n"] += 1
            if seen["n"] == which:
                return None
        return orig(self, acc, s, chunk, cache)
    return gs._TileContraction, "__call__", call


def _mirror_untransposed():
    orig = ps._mirror_walk

    def walk(like, leaves):
        for s, mirror in orig(like, leaves):
            yield s, {k: v.T for k, v in mirror.items()}
    return ps, "_mirror_walk", walk


def _product_drops_slot(slot):
    orig = ps.tiled_matmul

    def matmul(b, q):
        out = orig(b, q)
        r0, r1, c0, c1 = b.spans(slot)
        out[r0:r1] -= b.tiles[slot] @ q[c0:c1].to(b.tiles[slot].device)
        return out
    return ps, "tiled_matmul", matmul


FAULTS = {
    # Off-diagonal slot (0, 1) misses the second block's update.
    "off_diagonal_tile_misses_a_block": lambda: _skip_one_block_of_slot(1, 2),
    # The finalize reads yc[cols, rows] where it needs its transpose.
    "mirror_untransposed": _mirror_untransposed,
    # Every B @ Q leaves out slot (1, 0)'s row block.
    "product_drops_a_slot": lambda: _product_drops_slot(2),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_a_limit(cell, packed, reference, monkeypatch,
                                     fault):
    owner, name, patched = FAULTS[fault]()
    monkeypatch.setattr(owner, name, patched)
    limits = cell[0]["limits"]
    out = _run_job(packed, cell[2])
    got = judge(reference, out.coords, out.eigenvalues)
    assert any(got[k] > limits[k] for k in limits), (fault, got)


def test_exchange_counters_on_virtual_slots(cell, packed):
    names = ("tile2d.fanout_bytes", "tile2d.mirror_bytes",
             "eigh.tiled_products", "gram.tile_skew_s")
    before = {n: telemetry.counter_value(n) for n in names}
    _run_job(packed, cell[2])
    got = {n: telemetry.counter_value(n) - before[n] for n in names}
    # Virtual slots of one device: no byte crosses between devices, and
    # one card has no skew.
    assert got["tile2d.fanout_bytes"] == 0
    assert got["tile2d.mirror_bytes"] == 0
    assert got["gram.tile_skew_s"] == 0
    # iters + 1 power steps and the Rayleigh product (eigh_flops' count).
    assert got["eigh.tiled_products"] == TEST_ITERS + 2


def test_fanout_counts_copies_to_another_device():
    """A mesh over two devices: the gathered block is copied once, to the
    device it is not on, and counted in bytes."""
    mesh = meshes.make_mesh([torch.device("cpu"), torch.device("meta")],
                            (1, 2))
    block = torch.zeros((6, 16), dtype=torch.uint8)
    before = telemetry.counter_value("tile2d.fanout_bytes")
    copies = gs._gathered(mesh, block)
    assert copies[torch.device("cpu")] is block or torch.equal(
        copies[torch.device("cpu")], block)
    assert copies[torch.device("meta")].device.type == "meta"
    assert telemetry.counter_value("tile2d.fanout_bytes") - before == 96


def test_card_skew_needs_two_cards():
    before = telemetry.counter_value("gram.tile_skew_s")
    for devices in (["cpu"] * 4, [torch.device("cpu")]):
        skew = CardSkew(devices)
        skew.next_block()
        skew.mark("cpu")
        skew.count("gram.tile_skew_s")
    gs.read_tile_skew(lambda acc, block: acc)  # an update without one
    assert telemetry.counter_value("gram.tile_skew_s") == before
