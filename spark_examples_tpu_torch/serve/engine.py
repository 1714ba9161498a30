"""Device-resident projection engine: the model and the reference panel
staged once, every micro-batch answered at one padded shape.

Offline, ``project`` streams the reference panel from disk for every
cohort. The engine stages the panel's int8 genotype blocks on the
device **once**, with the model's eigenvectors and centering
statistics, and answers micro-batches:

- the query batch is padded to ``(max_batch, V)`` with hom-ref rows and
  its cross statistics accumulate against the staged blocks through
  ``pipelines/project.py::update_cross``, the function the offline
  lockstep pass runs (``torch._int_mm`` on the card);
- each live row is finalized at shape ``(1, N_ref)`` by the same
  ``_project`` / ``_project_pca`` / ``_project_factorized_dual`` the
  offline single-query path runs, at the same shape.

A served row therefore equals the offline single-query ``project`` of
that sample bit for bit: the cross statistics are int32 sums, exact for
any block partition and batch padding, and the finalize runs the same
code on the same inputs at the same shape (TF32 off).

The engine keeps no queue and is not thread-safe: the server
(serve/server.py) owns one and runs all its device work on one worker
thread. On a CUDA device every tensor of the engine lives on the
engine's own stream, which that worker makes current
(:func:`bind_stream`).
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.core.profiling import check_nans
from spark_examples_tpu_torch.pipelines import project as P
from spark_examples_tpu_torch.serve.health import CircuitBreaker


def _f32(x, device: torch.device) -> torch.Tensor:
    """The offline path's cast of a model statistic (``np.asarray`` then
    f32 on the device), so both finalize identical tensors."""
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


class ModelContext:
    """A loaded, validated model installed on ``device`` (a name, which
    raises for a missing card, or a resolved ``torch.device``): the
    cross statistics to accumulate, the f32 eigen/centering statistics
    and the per-row finalize."""

    def __init__(self, model, device="cuda"):
        if isinstance(model, (str, bytes)):
            model = P.load_model(model)
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self.stats = P.check_projectable(model)
        self.model = model
        # Factorized models project by family; the pcoa family also needs
        # the query denominator diagonal accumulated beside the stats.
        self.family = getattr(model, "family", model.kind)
        self.needs_qden = (model.kind == "factorized"
                           and self.family == "pcoa")
        self._eigvecs = _f32(model.eigvecs, self.device)
        self._eigvals = _f32(model.eigvals, self.device)
        self._colmean = _f32(model.colmean, self.device)
        self._grand = _f32(model.grand, self.device)
        if self.needs_qden:
            self._scale = _f32(model.scale, self.device)
            self._scale_floor = _f32(model.scale_floor, self.device)

    @property
    def n_ref(self) -> int:
        return self.model.n_ref

    @property
    def n_components(self) -> int:
        return self.model.n_components

    def finalize_row(self, acc: dict, i: int, qden=None) -> torch.Tensor:
        """Row ``i`` of the batch accumulators at shape (1, N_ref),
        through the offline single-query finalize."""
        row = {k: v[i:i + 1] for k, v in acc.items()}
        if self.family == "pca":
            return P._project_pca(row["s"], self._colmean, self._grand,
                                  self._eigvecs)
        if self.needs_qden:
            return P._project_factorized_dual(
                row, qden[i:i + 1], self._scale, self._scale_floor,
                self._colmean, self._grand, self._eigvecs, self._eigvals,
                self.model.metric)
        return P._project(row, self._colmean, self._grand, self._eigvecs,
                          self._eigvals, self.model.metric)


def _padded_batch(genotypes: np.ndarray, max_batch: int,
                  n_variants: int) -> tuple[np.ndarray, int]:
    """(b, V) int8 queries padded with hom-ref rows to ``max_batch``:
    (padded batch, b). Padding rows are computed and never read."""
    g = np.ascontiguousarray(genotypes, dtype=np.int8)
    if g.ndim != 2 or g.shape[1] != n_variants:
        raise ValueError(
            f"query batch must be (b, {n_variants}) int8 dosages, "
            f"got {g.shape}"
        )
    b = g.shape[0]
    if not 1 <= b <= max_batch:
        raise ValueError(f"batch of {b} rows outside [1, {max_batch}]")
    if b < max_batch:
        g = np.concatenate(
            [g, np.zeros((max_batch - b, n_variants), np.int8)], axis=0)
    return g, b


def _cross_batch(ctx: ModelContext, ref_blocks, g: np.ndarray,
                 stats: tuple[str, ...], qden_metric: str | None = None):
    """The padded batch's (max_batch, N_ref) int32 cross statistics
    against the staged blocks (and the query denominator diagonal of
    ``qden_metric``, else None)."""
    rows = g.shape[0]
    acc = {k: torch.zeros((rows, ctx.n_ref), dtype=torch.int32,
                          device=ctx.device) for k in stats}
    qden = (torch.zeros((rows,), dtype=torch.float32, device=ctx.device)
            if qden_metric is not None else None)
    for ref_dev, meta in ref_blocks:
        q = torch.from_numpy(
            np.ascontiguousarray(g[:, meta.start:meta.stop])).to(ctx.device)
        P.update_cross(acc, q, ref_dev)
        if qden is not None:
            qden = P._den_diag(qden, q, qden_metric)
    return acc, qden


def batch_coords(ctx: ModelContext, ref_blocks, genotypes: np.ndarray,
                 max_batch: int, n_variants: int) -> np.ndarray:
    """(b, V) int8 query genotypes -> (b, k) f32 coordinates: hom-ref
    padding to ``max_batch``, int32 cross statistics against the staged
    blocks, the per-row finalize at (1, N_ref). Each row bitwise the
    offline single-query ``pcoa_project_job``."""
    g, b = _padded_batch(genotypes, max_batch, n_variants)
    acc, qden = _cross_batch(
        ctx, ref_blocks, g, ctx.stats,
        ctx.model.metric if ctx.needs_qden else None)
    rows = [ctx.finalize_row(acc, i, qden) for i in range(b)]
    out = torch.cat(rows, dim=0).cpu().numpy()
    check_nans("served batch", out)
    return out


def check_topkable(model) -> "kernels.PairSpec":
    """The gate of top-k neighbors against a model's panel: the model's
    metric must carry a pairwise finalize (a kernel PairSpec). PCA
    models carry no similarity to rank by."""
    metric = getattr(model, "metric", None)
    family = getattr(model, "family", model.kind)
    if family == "pca" or not metric:
        raise ValueError(
            "topk serving needs a metric-bearing (pcoa) model — PCA "
            "models carry no pairwise similarity to rank neighbors by"
        )
    spec = kernels.get(metric).pair
    if spec is None:
        raise ValueError(
            f"metric {metric!r} has no pairwise finalize — topk routes "
            f"support: {', '.join(kernels.pairable_names())}"
        )
    return spec


def batch_pair_sims(ctx: ModelContext, ref_blocks, genotypes: np.ndarray,
                    max_batch: int, n_variants: int) -> np.ndarray:
    """(b, V) int8 queries -> (b, N_ref) float64 exact pairwise
    similarities against the staged panel: the padded-batch int32 cross
    statistics, brought to the host as int64, through the metric's
    PairSpec finalize (the arithmetic the cohort neighbors job runs)."""
    spec = check_topkable(ctx.model)
    g, b = _padded_batch(genotypes, max_batch, n_variants)
    acc, _ = _cross_batch(ctx, ref_blocks, g, spec.stats)
    host = {k: v[:b].cpu().numpy().astype(np.int64)
            for k, v in acc.items()}
    return np.asarray(spec.sim(host), np.float64)


def batch_topk(ctx: ModelContext, ref_blocks, genotypes: np.ndarray,
               max_batch: int, n_variants: int,
               k: int) -> tuple[np.ndarray, np.ndarray]:
    """(b, V) queries -> ``(ids, sims)`` of shape (b, min(k, N_ref)):
    each query's k most similar panel samples, descending, ties by
    ascending panel index (``neighbors/engine.py::topk_rows``)."""
    from spark_examples_tpu_torch.neighbors.engine import topk_rows

    sims = batch_pair_sims(ctx, ref_blocks, genotypes, max_batch,
                           n_variants)
    return topk_rows(sims, k)


def _to_device(block: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host int8 block on ``device`` (a read-only store mapping is
    copied first: torch does not wrap read-only arrays)."""
    if not block.flags.writeable or not block.flags.c_contiguous:
        block = np.array(block, order="C")
    return torch.from_numpy(block).to(device)


def stage_blocks(source_ref, block_variants: int,
                 device) -> tuple[list, int, int]:
    """A reference panel's int8 blocks staged on ``device``:
    ``(blocks, n_variants, nbytes)``."""
    device = torch.device(device)
    blocks = []
    n_variants = 0
    nbytes = 0
    for block, meta in source_ref.blocks(block_variants):
        blocks.append((_to_device(block, device), meta))
        n_variants = meta.stop
        nbytes += int(block.nbytes)
    if n_variants == 0:
        raise ValueError("reference source yielded no variants")
    return blocks, n_variants, nbytes


def shard_stream(source_ref, block_variants: int, max_shard_bytes: int,
                 device):
    """The panel's blocks grouped into consecutive shards of at most
    ``max_shard_bytes`` (at least one block each), each shard staged on
    ``device`` only when it is yielded: ``(blocks, nbytes)`` per shard.
    A server that drops each shard before pulling the next holds one on
    the device at a time; integer sums make the result the same as
    whole-panel staging."""
    device = torch.device(device)

    def stage(pending):
        return [(_to_device(h, device), m) for h, m in pending]

    pending: list = []
    nbytes = 0
    for block, meta in source_ref.blocks(block_variants):
        b = int(block.nbytes)
        if pending and nbytes + b > max_shard_bytes:
            yield stage(pending), nbytes
            pending, nbytes = [], 0
        pending.append((block, meta))
        nbytes += b
    if pending:
        yield stage(pending), nbytes


def device_stream(device) -> tuple[torch.device, "torch.cuda.Stream | None"]:
    """A server's device (a name, which raises for a missing card) and,
    on CUDA, the stream all its device work runs on. The device is
    indexed: the worker thread makes it current, and a bare ``cuda``
    cannot be."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device, None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, torch.cuda.Stream(device)


def on_stream(stream):
    """``stream`` as the current one (CUDA), else nothing."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def bind_stream(device: torch.device, stream) -> None:
    """Make ``device`` and ``stream`` current on the calling thread (a
    no-op off CUDA): a serving worker's first act."""
    if stream is not None:
        torch.cuda.set_device(device)
        torch.cuda.set_stream(stream)


def _store_cache_of(source):
    """The decode cache behind a (possibly wrapped) dataset-store
    source, or None."""
    seen = 0
    while source is not None and seen < 8:  # bounded unwrap
        cache = getattr(source, "cache", None)
        if cache is not None and hasattr(cache, "stats"):
            return cache
        source = getattr(source, "inner", None) or getattr(
            source, "store", None)
        seen += 1
    return None


class ProjectionEngine:
    """A loaded model, its staged reference panel and the batch step.

    ``model`` is a :class:`~spark_examples_tpu_torch.pipelines.project.
    ProjectionModel` (or factorized model) or a path to a saved
    ``.npz``; ``source_ref`` must be the panel the model was fitted on
    (checked by sample ids). ``block_variants`` is the staging
    granularity; it need not match the fit's. ``device`` defaults to the
    card and raises where there is none.
    """

    def __init__(self, model, source_ref, block_variants: int = 8192,
                 max_batch: int = 8, warm: bool = True,
                 device: str = "cuda"):
        if isinstance(model, (str, bytes)):
            model = P.load_model(model)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device, self.stream = device_stream(device)
        self.max_batch = int(max_batch)
        self.block_variants = int(block_variants)
        self._install_model(model)
        P.check_reference_panel(model, source_ref)  # before any staging
        self._panel_ids = list(source_ref.sample_ids)
        self._panel_cache = _store_cache_of(source_ref)
        self._source_ref = source_ref
        # Re-stages run through the breaker; the first staging does not
        # (with no panel staged yet there is nothing to fall back to).
        self.breaker = CircuitBreaker()
        self._ref_blocks, self.n_variants = self._stage_panel(source_ref)
        if warm:
            self.warmup()

    def _stage_panel(self, source_ref) -> tuple[list, int]:
        with on_stream(self.stream):
            blocks, n_variants, _nbytes = stage_blocks(
                source_ref, self.block_variants, self.device)
        return blocks, n_variants

    def restage(self, source_ref=None) -> bool:
        """Refresh the staged panel from its source through the circuit
        breaker. True when re-staged; False in **cached-panel-only
        mode**: the breaker is open, or this attempt failed and fed it,
        and serving goes on from the panel already on the device. The
        swap is all-or-nothing and identity-checked."""
        src = source_ref if source_ref is not None else self._source_ref
        if not self.breaker.allow():
            return False
        try:
            if list(src.sample_ids) != self._panel_ids:
                raise ValueError(
                    "re-staged source carries different sample ids than "
                    "the panel the model was fitted on — refusing the "
                    "swap (fit a new model for a changed panel)"
                )
            blocks, n_variants = self._stage_panel(src)
            if n_variants != self.n_variants:
                raise ValueError(
                    f"re-staged panel streams {n_variants} variants, "
                    f"the staged panel has {self.n_variants} — refusing "
                    "the swap (fit a new model for a changed panel)"
                )
        except Exception as e:
            self.breaker.record_failure()
            warnings.warn(
                f"panel re-stage failed ({e!r}) — serving continues "
                f"from the cached panel (breaker {self.breaker.state})",
                RuntimeWarning, stacklevel=2,
            )
            return False
        except BaseException:
            # An interrupt says nothing about the store: give the probe
            # slot back and let it propagate.
            self.breaker.release_probe()
            raise
        self.breaker.record_success()
        self._ref_blocks = blocks
        if source_ref is not None:
            self._source_ref = source_ref
            self._panel_cache = _store_cache_of(source_ref)
        return True

    @property
    def panel_mode(self) -> str:
        """"staged" (breaker closed) or "cached-only"."""
        return "staged" if self.breaker.state == "closed" else "cached-only"

    def _install_model(self, model) -> None:
        with on_stream(self.stream):
            self._ctx = ModelContext(model, self.device)

    @property
    def model(self):
        return self._ctx.model

    @property
    def stats(self) -> tuple[str, ...]:
        return self._ctx.stats

    def store_cache_stats(self) -> dict | None:
        """The staged panel's store decode-cache accounting, or None
        when the panel did not come from a dataset store."""
        if self._panel_cache is None:
            return None
        return self._panel_cache.stats()

    @property
    def n_ref(self) -> int:
        return self.model.n_ref

    @property
    def n_components(self) -> int:
        return self.model.n_components

    def warmup(self) -> None:
        """One padded batch end to end (first-use allocations and
        library handles paid before any request)."""
        self.project_batch(np.zeros((1, self.n_variants), np.int8))

    def reload_model(self, model) -> None:
        """Hot-swap the served model (same panel, staged blocks reused).
        All or nothing: a failure anywhere, the warmup included, leaves
        the old model serving. PyTorch runs eagerly, so there are no
        compiled programs to drop; the old model's tensors go with its
        context."""
        if isinstance(model, (str, bytes)):
            model = P.load_model(model)
        P.check_projectable(model)
        if model.sample_ids != self._panel_ids:
            raise ValueError(
                "hot-reload refused: the new model was fitted on a "
                "different reference panel than the one staged on "
                "device — restart the server against the right panel"
            )
        old_ctx = self._ctx
        try:
            self._install_model(model)
            self.warmup()
        except BaseException:
            self._ctx = old_ctx
            raise

    def project_batch(self, genotypes: np.ndarray) -> np.ndarray:
        """(b, V) int8 query genotypes -> (b, k) f32 coordinates,
        b <= max_batch; each row bitwise the offline single-query
        ``pcoa_project_job``."""
        with on_stream(self.stream):
            return batch_coords(self._ctx, self._ref_blocks, genotypes,
                                self.max_batch, self.n_variants)
