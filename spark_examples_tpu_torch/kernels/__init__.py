"""The kernel registry: one declarative object per metric.

Three families, as in the JAX package's registry:

- ``count``: the pair-count kernels. A kernel says which raw int32
  products it accumulates (``pieces``), which statistics its finalize
  reads (``stats``, ``ops.genotype.combine_products`` names), its
  finalize, and the worst per-variant accumulator increment feeding
  the int32 exactness guard. The six dosage kernels stream packed under
  ``pack_stream="auto"`` and the packed-gram CUDA kernel
  (``ops/packed_gram.py``) serves their product sets (``fused``).
  ``euclidean`` and ``dot`` take arbitrary int8 tables (raw values up
  to 127), which neither the 2-bit codec nor that kernel can carry:
  they stream dense and contract through the int8 library product.
- ``float``: kernels with their own f32 accumulators, init and update
  (grm: VanRaden standardized dosages, ``Z Z^T`` in f32).
- ``table``: a dense-table pipeline with its own ``table_runner``
  instead of the gram accumulator (braycurtis, whose Manhattan
  contraction is the CUDA kernel of ``ops/braycurtis_kernel.py``).

A kernel may also declare how the sketch solver (``solvers/``) streams
it without any N x N state: a :class:`FactorSketch` when the centered
solve operator is an exact Gram of per-block features, or a
:class:`DualSketch` for a ratio metric whose numerator and pair-count
denominator stream as two sketches in the same pass. A
:class:`CrossSpec` makes a fitted PCoA model of the metric projectable
(``pipelines/project.py``): which cross statistics to stream between a
new cohort and the panel, and how they finalize. A :class:`PairSpec`
makes it top-k-able (``neighbors/``): which statistics to accumulate
per candidate pair, and how they map to similarities.

Each finalize is the counterpart of the JAX package's registration
(``kernels/builtin.py``), whose ``np_finalize`` twins are the spec. A
gram kernel also declares its own NumPy twin (``np_finalize``), the
finalize of ``--backend cpu-reference`` (``utils/oracle.py``): a count
or float kernel that omits it is refused at registration, as in the
JAX package. A float kernel whose statistics are not additive raw
products also declares its whole-matrix host route
(``oracle_similarity``: grm's in-matrix allele frequencies).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from spark_examples_tpu_torch.ops import genotype


@dataclass(frozen=True)
class FactorSketch:
    """Single-factor streamability: the metric's centered solve operator
    is ``B = (J A)(J A)^T / denom`` for per-block features
    ``A_b = features(block)``.

    ``features(block, precise) -> (a, kept)``: the (N, v) f32 feature
    columns of one int8 dosage block and the kept-variant count feeding
    the denominator (0 when unused). ``uses_nvar``: divide the finalized
    operator by the accumulated kept count (grm). ``pca_family``: the
    factor is the pca job's similarity (shared-alt, no denominator).
    """

    features: Callable
    uses_nvar: bool = False
    pca_family: bool = False


@dataclass(frozen=True)
class DualSketch:
    """Ratio-metric streamability: similarity ``S = NUM ⊘ DEN`` with NUM
    and the pair-count denominator DEN both sums of cross-products of
    per-block feature columns. ``operands(block) -> {name: (N, v) f32}``;
    ``num_terms`` / ``den_terms`` are ``(left, right, weight)`` triples
    meaning ``sum_b w * L_b R_b^T``. ``num_psd``: NUM is positive
    semi-definite, which the single-pass Nystrom rung needs."""

    operands: Callable
    num_terms: tuple[tuple[str, str, float], ...]
    den_terms: tuple[tuple[str, str, float], ...]
    num_psd: bool = True


@dataclass(frozen=True)
class CrossSpec:
    """Out-of-sample projectability of a fitted PCoA model: ``stats``
    are the ``ops.genotype.CROSS_STATS`` names streamed between the new
    cohort and the reference panel; ``d2(acc)`` finalizes the (A, N_ref)
    int32 statistics into squared cross distances in the kernel's own
    distance convention (f32). ``num(acc)``: for ratio kernels, the
    similarity numerator a factorized dual model scales by
    ``1 / (a_q a_j)`` (None: no factorized projection)."""

    stats: tuple[str, ...]
    d2: Callable
    num: Callable | None = None


@dataclass(frozen=True)
class PairSpec:
    """Sparse pairwise evaluability (the neighbors job): ``stats`` are
    ``ops.genotype.CROSS_STATS`` names accumulated per candidate pair
    (both orientations spelled out: ``sn``/``sr``, ``hcn``/``hcr``);
    ``sim(acc)`` maps the accumulated int64 per-pair statistic vectors
    to float64 similarities (NumPy, elementwise over the pair axis),
    the same values as the JAX package's float64 finalize of the dense
    statistics off the diagonal, bit for bit."""

    stats: tuple[str, ...]
    sim: Callable


@dataclass(frozen=True)
class Kernel:
    name: str
    family: str  # "count" | "float" | "table"
    pieces: tuple[str, ...] = ()
    stats: tuple[str, ...] = ()
    max_increment: int | None = None
    # (stats, frame=FULL) -> {"similarity", "distance"}
    finalize: Callable | None = None
    # The NumPy twin of ``finalize`` on float64 statistics
    # (--backend cpu-reference).
    np_finalize: Callable | None = None
    # float family: (N, V) int8 table -> (N, N) float64 similarity, the
    # host oracle's whole-matrix route.
    oracle_similarity: Callable | None = None
    # Inputs are genotype dosages by definition, so pack_stream="auto"
    # ships them 2-bit packed.
    pack_auto: bool = True
    # The int32 budget scales with the streamed table's largest value m
    # (increment bound m^2) instead of max_increment alone.
    value_scaled_budget: bool = False
    # The packed-gram CUDA kernel serves the products
    # (--gram-lowering fused).
    fused: bool = False
    # float family: (n, device) -> fresh accumulators, and
    # (acc, int8 dosage block, precise) -> acc, updating in place.
    init: Callable | None = None
    update: Callable | None = None
    # float family under a tile2d plan: (tile acc, int8 dosage chunk,
    # row slice, col slice, precise, scalars) -> tile acc, in place. The
    # chunk's per-variant statistics come from all its rows; only the
    # tile's rows and columns are contracted; ``scalars`` says whether
    # this slot also adds the scalar leaves (nvar).
    tile_body: Callable | None = None
    # (job, source, timer) -> the (N, N) distance on the job's device.
    table_runner: Callable | None = None
    # How the sketch solver streams the metric (None: exact rung only).
    sketch: FactorSketch | DualSketch | None = None
    # How a fitted PCoA model of the metric projects (None: it does not).
    cross: CrossSpec | None = None
    # How the neighbors job evaluates candidate pairs (None: not
    # top-k-able).
    pair: PairSpec | None = None

    def flops(self, n: int, v: int) -> float:
        """Operations one (n, v) block contributes. Count kernels: one
        ``2 n^2 v`` contraction per int8-split term of each product.
        Float kernels: one ``Z Z^T``. Table kernels: ``3 n^2 v``
        elementwise (|a - b|, a + b, the ratio's share) over all pairs."""
        if self.family == "table":
            return 3.0 * n * n * v
        if self.family == "float":
            return 2.0 * n * n * v
        n_matmuls = sum(
            len(genotype._INT8_SPLIT.get(p, (None,))) for p in self.pieces
        )
        return 2.0 * n * n * v * n_matmuls


class Frame:
    """What a finalize reads beyond its elementwise part, for a whole
    (N, N) matrix: a statistic's transpose, the diagonal, and the Gower
    transform (which reads the similarity's diagonal). A tile of a tiled
    accumulator finalizes through a frame that answers the same three
    from the other tiles (``parallel/pcoa_sharded.py::TileFrame``), so
    every finalize below runs unchanged, tile by tile, bit for bit."""

    def t(self, stats: dict, name: str) -> torch.Tensor:
        return stats[name].T

    def fill_diagonal(self, x: torch.Tensor, value: float) -> torch.Tensor:
        return x.fill_diagonal_(value)

    def gower(self, sim: torch.Tensor) -> torch.Tensor:
        from spark_examples_tpu_torch.ops.distances import (
            similarity_to_distance,
        )

        return similarity_to_distance(sim)


FULL = Frame()


def _ibs_finalize(stats, frame=FULL):
    """PLINK-convention IBS distance ``d1 / (2m)`` over pairwise-complete
    variants; pairs sharing no complete variant get distance 0."""
    m = stats["m"]
    dist = torch.where(m > 0, stats["d1"] / (2.0 * m), 0.0)
    return {"similarity": 1.0 - dist, "distance": dist}


def _ibs2_finalize(stats, frame=FULL):
    """Fraction of pairwise-complete variants with identical genotype;
    pairs sharing no complete variant score 1."""
    m = stats["m"]
    sim = torch.where(m > 0, stats["ibs2"] / (1.0 * m), 1.0)
    return {"similarity": sim, "distance": 1.0 - sim}


def _shared_alt_finalize(stats, frame=FULL):
    """Raw shared-alt-carrier counts (the pca job's similarity), Gower
    distance."""
    s = stats["s"].to(torch.float32)
    return {"similarity": s, "distance": frame.gower(s)}


def _king_finalize(stats, frame=FULL):
    """KING-robust kinship, between-family form: phi = (N_AaAa - 2
    N_AA,aa) / (N_Aa(i) + N_Aa(j)) over pairwise-complete variants. Pairs
    sharing no het variant get phi 0; the diagonal is pinned to
    self-kinship 0.5 so the self-distance is exactly 0."""
    den = (stats["hc"] + frame.t(stats, "hc")).to(torch.float32)
    num = (stats["hh"] - 2 * stats["opp"]).to(torch.float32)
    phi = torch.where(den > 0, num / den, 0.0)
    phi = frame.fill_diagonal(phi, 0.5)
    return {"similarity": phi, "distance": torch.clamp(0.5 - phi, min=0.0)}


def _jaccard_finalize(stats, frame=FULL):
    """Carrier-set Jaccard over pairwise-complete variants: intersection
    ``s`` over union ``sc + sc^T - s``; an empty union scores 1. Gower
    distance."""
    s = stats["s"]
    union = stats["sc"] + frame.t(stats, "sc") - s
    sim = torch.where(union > 0, s / union, 1.0)
    return {"similarity": sim, "distance": frame.gower(sim)}


def _pc_invariant_finalize(stats, frame=FULL):
    """Piecewise-constant invariant similarity: +1 identical genotype, -1
    opposite homozygotes, over the valid-pair count m; pairs sharing no
    complete variant score 1. Distance (1 - s) / 2."""
    m = stats["m"].to(torch.float32)
    num = (stats["ibs2"] - stats["opp"]).to(torch.float32)
    sim = torch.where(m > 0, num / m, 1.0)
    return {"similarity": sim, "distance": (1.0 - sim) / 2.0}


def _euclidean_finalize(stats, frame=FULL):
    """Exact raw-value euclidean distance ``sqrt(max(e2, 0))``; the
    similarity is its negative. The root is taken in float64 and rounded
    once (the correctly rounded f32 root, as JAX's is)."""
    e2 = torch.clamp(stats["e2"].to(torch.float32), min=0.0)
    d = torch.sqrt(e2.to(torch.float64)).to(torch.float32)
    return {"similarity": -d, "distance": d}


def _dot_finalize(stats, frame=FULL):
    """Raw-value inner products, Gower distance."""
    dot = stats["dot"].to(torch.float32)
    return {"similarity": dot, "distance": frame.gower(dot)}


def _grm_finalize(stats, frame=FULL):
    """VanRaden GRM ``zz / max(nvar, 1)``, Gower distance."""
    g = stats["zz"] / torch.clamp(stats["nvar"], min=1.0)
    return {"similarity": g, "distance": frame.gower(g)}


def _np_gower(sim):
    """NumPy twin of ``ops.distances.similarity_to_distance``: the Gower
    transform ``d = sqrt(s_ii + s_jj - 2 s_ij)`` clamped at 0, one
    definition for every ``np_finalize`` below."""
    import numpy as np

    diag = np.diagonal(sim)
    return np.sqrt(np.maximum(diag[:, None] + diag[None, :] - 2 * sim, 0.0))


def _ibs_np_finalize(acc):
    import numpy as np

    with np.errstate(invalid="ignore", divide="ignore"):
        dist = np.where(acc["m"] > 0, acc["d1"] / (2.0 * acc["m"]), 0.0)
    return {"similarity": 1.0 - dist, "distance": dist}


def _ibs2_np_finalize(acc):
    import numpy as np

    with np.errstate(invalid="ignore", divide="ignore"):
        sim = np.where(acc["m"] > 0, acc["ibs2"] / acc["m"], 1.0)
    return {"similarity": sim, "distance": 1.0 - sim}


def _shared_alt_np_finalize(acc):
    return {"similarity": acc["s"], "distance": _np_gower(acc["s"])}


def _euclidean_np_finalize(acc):
    import numpy as np

    d = np.sqrt(np.maximum(acc["e2"], 0.0))
    return {"similarity": -d, "distance": d}


def _dot_np_finalize(acc):
    return {"similarity": acc["dot"], "distance": _np_gower(acc["dot"])}


def _king_np_finalize(acc):
    import numpy as np

    den = acc["hc"] + acc["hc"].T
    with np.errstate(invalid="ignore", divide="ignore"):
        phi = np.where(den > 0, (acc["hh"] - 2 * acc["opp"]) / den, 0.0)
    np.fill_diagonal(phi, 0.5)  # self-kinship even with zero hets
    return {"similarity": phi, "distance": np.maximum(0.5 - phi, 0.0)}


def _jaccard_np_finalize(acc):
    import numpy as np

    s = acc["s"]
    union = acc["sc"] + acc["sc"].T - s
    with np.errstate(invalid="ignore", divide="ignore"):
        sim = np.where(union > 0, s / union, 1.0)
    return {"similarity": sim, "distance": _np_gower(sim)}


def _pc_invariant_np_finalize(acc):
    import numpy as np

    with np.errstate(invalid="ignore", divide="ignore"):
        sim = np.where(acc["m"] > 0,
                       (acc["ibs2"] - acc["opp"]) / acc["m"], 1.0)
    return {"similarity": sim, "distance": (1.0 - sim) / 2.0}


def _grm_np_finalize(acc):
    import numpy as np

    g = acc["zz"] / np.maximum(acc["nvar"], 1.0)
    return {"similarity": g, "distance": _np_gower(g)}


def _grm_oracle(x):
    from spark_examples_tpu_torch.utils import oracle

    return oracle.naive_grm(x)


def _grm_init(n, device):
    from spark_examples_tpu_torch.ops import gram

    return gram.grm_init(n, device)


def _grm_update(acc, block, precise):
    from spark_examples_tpu_torch.ops import gram

    return gram.grm_update(acc, block, precise)


def _grm_tile_body(acc, block, rows, cols, precise, scalars):
    from spark_examples_tpu_torch.ops import gram

    return gram.grm_tile_update(acc, block, rows, cols, precise, scalars)


def _ibs_cross_d2(acc):
    """Squared ibs cross distance ``(d1 / 2m)^2``; 0 where no variant is
    complete for the pair."""
    m = acc["m"]
    dist = torch.where(m > 0, acc["d1"].to(torch.float32) / (2.0 * m), 0.0)
    return dist * dist


def _ibs_cross_num(acc):
    """The dual sketch's numerator ``2m - d1`` between a query row and
    each panel sample (what the fit streamed as sum_v c_i c_j (2 -
    |a - b|))."""
    return (2.0 * acc["m"] - acc["d1"]).to(torch.float32)


def _jaccard_cross_d2(acc):
    """Gower squared cross distance ``2 - 2J``: the union is each side's
    carrier count over pairwise-complete variants minus the shared
    carriers; an empty union scores J = 1."""
    s = acc["s"].to(torch.float32)
    union = (acc["sn"] + acc["sr"]).to(torch.float32) - s
    sim = torch.where(union > 0, s / union, 1.0)
    return torch.clamp(2.0 - 2.0 * sim, min=0.0)


def _jaccard_cross_num(acc):
    """The dual numerator: the raw intersection count ``s``."""
    return acc["s"].to(torch.float32)


def _ibs_pair_sim(acc):
    """``1 - d1 / 2m`` per pair in float64; 1 when the pair shares no
    complete variant."""
    import numpy as np

    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(acc["m"] > 0,
                        1.0 - acc["d1"] / (2.0 * acc["m"]), 1.0)


def _king_pair_sim(acc):
    """KING-robust phi per pair, the het-count denominator ``hcn + hcr``
    (the two orientations of ``hc``); 0 when the pair shares no het
    variant. Candidate pairs are i < j, so the diagonal pin never
    applies."""
    import numpy as np

    den = acc["hcn"] + acc["hcr"]
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(den > 0, (acc["hh"] - 2 * acc["opp"]) / den, 0.0)


def _jaccard_pair_sim(acc):
    """Carrier-set Jaccard per pair, the union ``sn + sr - s``; 1 when
    the union is empty."""
    import numpy as np

    union = acc["sn"] + acc["sr"] - acc["s"]
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, acc["s"] / union, 1.0)


def _ibs_dual_operands(block):
    """Validity, carrier and hom-alt indicators and the dosage of the
    called genotypes, as f32 (N, v) operands."""
    t1 = (block >= 1).to(torch.float32)
    t2 = (block >= 2).to(torch.float32)
    return {"c": (block >= 0).to(torch.float32), "t1": t1, "t2": t2,
            "y": t1 + t2}


def _jaccard_dual_operands(block):
    return {"c": (block >= 0).to(torch.float32),
            "t1": (block >= 1).to(torch.float32)}


def _shared_alt_features(block, precise):
    return (block >= 1).to(torch.float32), 0.0  # denominator unused


def _raw_value_features(block, precise):
    """Raw values with missing calls as 0 (euclidean is exact when no
    call is missing; with missingness the sketch models zero-imputed
    values)."""
    return torch.clamp(block, min=0).to(torch.float32), 0.0


def _grm_features(block, precise):
    """The exact route's VanRaden standardization; the sketch's products
    run in f32 whatever ``precise`` says."""
    from spark_examples_tpu_torch.ops import gram

    z, keep = gram.grm_standardize(block, precise)
    return z.to(torch.float32), keep.sum().to(torch.float32)


def _braycurtis_runner(job, source, timer):
    from spark_examples_tpu_torch.pipelines import runner

    return runner.braycurtis_distance(job, source, timer)


_REGISTRY: dict[str, Kernel] = {}


def _register(kernel: Kernel) -> None:
    """Add a kernel, refusing a half-declared one at import (the JAX
    package's rule, ``kernels/base.py::register``): a gram kernel without
    its NumPy twin would fail only when ``--backend cpu-reference`` runs
    it."""
    if kernel.name in _REGISTRY:
        raise ValueError(f"kernel {kernel.name!r} is already registered")
    if kernel.family not in ("count", "float", "table"):
        raise ValueError(
            f"kernel {kernel.name!r}: unknown family {kernel.family!r} "
            "(count | float | table)"
        )
    if kernel.family == "count":
        missing = [f for f in ("pieces", "stats", "finalize", "np_finalize")
                   if not getattr(kernel, f)]
        if kernel.max_increment is None:
            missing.append("max_increment")
        if missing:
            raise ValueError(
                f"count kernel {kernel.name!r} is missing {missing}")
    if kernel.family == "float":
        missing = [f for f in ("init", "update", "tile_body", "finalize",
                               "np_finalize", "oracle_similarity")
                   if getattr(kernel, f) is None]
        if missing:
            raise ValueError(
                f"float kernel {kernel.name!r} is missing {missing}")
    if kernel.family == "table" and kernel.table_runner is None:
        raise ValueError(
            f"table kernel {kernel.name!r} declares no table_runner")
    _REGISTRY[kernel.name] = kernel


_register(Kernel(
    name="ibs",
    family="count",
    fused=True,
    pieces=("cc", "yc", "t1t1", "t2t2"),
    stats=("m", "d1"),
    max_increment=2,  # yc with y <= 2
    finalize=_ibs_finalize,
    np_finalize=_ibs_np_finalize,
    # NUM = 2m - d1 = sum_v c_i c_j (2 - |a - b|), a PSD kernel per
    # variant, over DEN = 2m (exactly rank-1 when no call is missing).
    sketch=DualSketch(
        operands=_ibs_dual_operands,
        num_terms=(("c", "c", 2.0), ("y", "c", -1.0), ("c", "y", -1.0),
                   ("t1", "t1", 2.0), ("t2", "t2", 2.0)),
        den_terms=(("c", "c", 2.0),),
    ),
    cross=CrossSpec(stats=("m", "d1"), d2=_ibs_cross_d2,
                    num=_ibs_cross_num),
    pair=PairSpec(stats=("m", "d1"), sim=_ibs_pair_sim),
))
_register(Kernel(
    name="ibs2",
    family="count",
    fused=True,
    pieces=("cc", "t1c", "t1t1", "t1t2", "t2t2"),
    stats=("m", "ibs2"),
    max_increment=2,
    finalize=_ibs2_finalize,
    np_finalize=_ibs2_np_finalize,
))
_register(Kernel(
    name="shared-alt",
    family="count",
    fused=True,
    pieces=("t1t1",),
    stats=("s",),
    max_increment=1,
    finalize=_shared_alt_finalize,
    np_finalize=_shared_alt_np_finalize,
    sketch=FactorSketch(features=_shared_alt_features, pca_family=True),
))
_register(Kernel(
    name="king",
    family="count",
    fused=True,
    pieces=("t1c", "t2c", "t1t1", "t1t2", "t2t2"),
    stats=("hh", "opp", "hc"),
    max_increment=2,
    finalize=_king_finalize,
    np_finalize=_king_np_finalize,
    pair=PairSpec(stats=("hh", "opp", "hcn", "hcr"), sim=_king_pair_sim),
))
_register(Kernel(
    name="jaccard",
    family="count",
    fused=True,
    pieces=("t1c", "t1t1"),
    stats=("s", "sc"),
    max_increment=2,  # the finalize's union sc + sc^T - s in int32
    finalize=_jaccard_finalize,
    np_finalize=_jaccard_np_finalize,
    # NUM = intersection counts T1 T1^T (PSD); DEN = the union counts.
    sketch=DualSketch(
        operands=_jaccard_dual_operands,
        num_terms=(("t1", "t1", 1.0),),
        den_terms=(("t1", "c", 1.0), ("c", "t1", 1.0), ("t1", "t1", -1.0)),
    ),
    cross=CrossSpec(stats=("s", "sn", "sr"), d2=_jaccard_cross_d2,
                    num=_jaccard_cross_num),
    pair=PairSpec(stats=("s", "sn", "sr"), sim=_jaccard_pair_sim),
))
_register(Kernel(
    name="pc-invariant",
    family="count",
    fused=True,
    pieces=("cc", "t1c", "t2c", "t1t1", "t1t2", "t2t2"),
    stats=("m", "ibs2", "opp"),
    max_increment=2,
    finalize=_pc_invariant_finalize,
    np_finalize=_pc_invariant_np_finalize,
))
_register(Kernel(
    name="euclidean",
    family="count",
    pieces=("qc", "yy"),
    stats=("e2",),
    pack_auto=False,  # arbitrary int8 values, not 2-bit representable
    max_increment=4,  # qc/yy at dosage values; m^2 in general
    value_scaled_budget=True,
    finalize=_euclidean_finalize,
    np_finalize=_euclidean_np_finalize,
    sketch=FactorSketch(features=_raw_value_features),
))
_register(Kernel(
    name="dot",
    family="count",
    pieces=("yy",),
    stats=("dot",),
    pack_auto=False,
    max_increment=4,
    value_scaled_budget=True,
    finalize=_dot_finalize,
    np_finalize=_dot_np_finalize,
    sketch=FactorSketch(features=_raw_value_features),
))
_register(Kernel(
    name="grm",
    family="float",
    finalize=_grm_finalize,
    np_finalize=_grm_np_finalize,
    oracle_similarity=_grm_oracle,
    init=_grm_init,
    update=_grm_update,
    tile_body=_grm_tile_body,
    sketch=FactorSketch(features=_grm_features, uses_nvar=True),
))
_register(Kernel(
    name="braycurtis",
    family="table",
    pack_auto=False,
    table_runner=_braycurtis_runner,
))


def get(name: str) -> Kernel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; registered kernels: "
            f"{' | '.join(sorted(_REGISTRY))}"
        ) from None


def names() -> tuple[str, ...]:
    """Every registered kernel name, in registration order."""
    return tuple(_REGISTRY)


def fused_names() -> tuple[str, ...]:
    """The count kernels the packed-gram CUDA kernel serves
    (``--gram-lowering fused``): the six dosage kernels. euclidean and
    dot (raw values up to 127) and grm (standardized floats) are not
    among them."""
    return tuple(k.name for k in _REGISTRY.values() if k.fused)


def pairable_names() -> tuple[str, ...]:
    """Kernels whose similarity can be evaluated per candidate pair (a
    PairSpec): the metrics the neighbors job serves."""
    return tuple(k.name for k in _REGISTRY.values() if k.pair is not None)


def gram_names() -> tuple[str, ...]:
    """The kernels that stream through the gram accumulators."""
    return tuple(k.name for k in _REGISTRY.values()
                 if k.family in ("count", "float"))


def finalizable_names() -> tuple[str, ...]:
    """The metrics a job can run: a ported finalize or a table runner."""
    return tuple(k.name for k in _REGISTRY.values()
                 if k.finalize is not None or k.table_runner is not None)


def factor_sketch_names() -> tuple[str, ...]:
    """Kernels streamable as a single-factor sketch."""
    return tuple(k.name for k in _REGISTRY.values()
                 if isinstance(k.sketch, FactorSketch))


def dual_sketch_names() -> tuple[str, ...]:
    """Ratio kernels streamable as a numerator/denominator dual sketch."""
    return tuple(k.name for k in _REGISTRY.values()
                 if isinstance(k.sketch, DualSketch))


def unsketchable_names() -> tuple[str, ...]:
    """Gram kernels with no declared streamability (exact rung only)."""
    return tuple(k.name for k in _REGISTRY.values()
                 if k.family in ("count", "float") and k.sketch is None)


def unsketchable_metric_error(metric: str, solver: str) -> str:
    """The refusal text for a metric the sketch ladder cannot run (the
    JAX package's words, its names derived from the registry)."""
    kern = _REGISTRY.get(metric)
    if kern is not None and isinstance(kern.sketch, DualSketch):
        # Only a dual kernel whose numerator is not PSD lands here.
        return (
            f"--solver {solver} does not support --metric {metric}: its "
            "dual-sketch numerator is not PSD, so the single-pass "
            "Nystrom rung is unavailable — use --solver corrected "
            "(streamed subspace iteration handles indefinite operators)"
        )
    return (
        f"--solver {solver} does not support --metric {metric}: the "
        "sketch streams an exact Gram factor per block, which exists "
        f"for {' | '.join(factor_sketch_names())}; ratio metrics "
        f"({' | '.join(dual_sketch_names())}) stream numerator + "
        "pair-count denominator as a dual sketch; metrics declaring "
        f"neither ({' | '.join(unsketchable_names())}) require the "
        "materialized N x N — use --solver exact for them"
    )


def check_sketchable(metric: str, solver: str) -> None:
    """Raise, naming ``--solver`` and ``--metric``, unless ``metric``
    can run the ``solver`` rung: the one gate of config-time validation
    and the solver driver."""
    kern = _REGISTRY.get(metric)
    spec = kern.sketch if kern is not None else None
    if spec is None:
        raise ValueError(unsketchable_metric_error(metric, solver))
    if (isinstance(spec, DualSketch) and solver == "sketch"
            and not spec.num_psd):
        raise ValueError(unsketchable_metric_error(metric, solver))


def maybe_get(name: str) -> Kernel | None:
    return _REGISTRY.get(name)


def factorized_savable_names() -> tuple[str, ...]:
    """Metrics whose sketch-rung fits save as a factorized model:
    pca-family factor kernels on either rung, dual kernels with a cross
    numerator on the corrected rung."""
    return tuple(
        k.name for k in _REGISTRY.values()
        if (isinstance(k.sketch, FactorSketch) and k.sketch.pca_family)
        or (isinstance(k.sketch, DualSketch) and k.cross is not None
            and k.cross.num is not None)
    )


def check_factorized_savable(metric: str | None, solver: str,
                             kind: str | None = None) -> None:
    """Raise unless a ``--save-model`` fit of ``metric`` on the sketch
    rung ``solver`` can give a projectable factorized model. Config-time
    validation passes no ``kind`` (one JobConfig serves every job kind,
    so only combinations invalid for all of them are refused); the job
    passes it and the kind-specific rows resolve. ``exact`` never takes
    the factorized path and always passes. The JAX package's gate, word
    for word."""
    if solver == "exact":
        return
    if metric is None:
        if kind is None:
            return  # the job's default metric resolves at run time
        metric = "shared-alt" if kind == "pca" else "ibs"
    kern = _REGISTRY.get(metric)
    spec = kern.sketch if kern is not None else None
    savable = " | ".join(factorized_savable_names())
    if isinstance(spec, DualSketch):
        if kern.cross is None or kern.cross.num is None:
            raise ValueError(
                f"--save-model with --solver {solver}: --metric {metric} "
                "declares no cross numerator, so a factorized model of "
                f"it cannot project queries — savable sketch metrics: "
                f"{savable}, or fit with --solver exact"
            )
        if solver != "corrected":
            raise ValueError(
                f"--save-model with --metric {metric}: the dual "
                "centering statistics stream only in the corrected "
                "rung's scaled power passes (the denominator scale "
                "does not exist during pass 0) — use --solver "
                "corrected, or fit with --solver exact"
            )
        return
    if isinstance(spec, FactorSketch):
        if not spec.pca_family:
            raise ValueError(
                f"--save-model with --solver {solver}: --metric {metric} "
                "has no factorized projection path (its factor is not "
                "the PCA similarity and it declares no cross spec) — "
                f"savable sketch metrics: {savable}, or fit with "
                "--solver exact"
            )
        if kind == "pcoa":
            raise ValueError(
                f"--save-model with --solver {solver}: a pcoa fit of "
                f"--metric {metric} serves the Gower geometry, which "
                "the factorized artifact stores only for ratio "
                f"metrics ({' | '.join(dual_sketch_names())}) — save "
                "the pca fit instead, or fit with --solver exact"
            )
        return
    # No sketch spec: the rung itself is refused, with the same text.
    raise ValueError(unsketchable_metric_error(metric, solver))


def streams_packed(metric: str, pack_stream: str) -> bool:
    """Whether ``pack_stream`` ships ``metric``'s blocks 2-bit packed:
    always for "packed", never for "dense", and for "auto" exactly when
    the kernel declares ``pack_auto``."""
    return pack_stream == "packed" or (
        pack_stream == "auto" and get(metric).pack_auto)


def check_fused_lowering(metric: str, packed: bool) -> None:
    """Raise, naming ``--gram-lowering``, unless ``metric`` on this
    transport can run the packed-gram CUDA kernel."""
    if not get(metric).fused:
        raise ValueError(
            f"--gram-lowering fused does not support --metric {metric}: "
            "the packed-gram CUDA kernel decodes 2-bit dosages and serves "
            f"only {' | '.join(fused_names())}; use --gram-lowering "
            "auto|reference for the others"
        )
    if not packed:
        raise ValueError(
            "--gram-lowering fused consumes the 2-bit packed transport "
            f"directly, but --metric {metric} is resolving to a dense "
            "stream — use pack_stream auto|packed (or --gram-lowering "
            "auto|reference)"
        )
