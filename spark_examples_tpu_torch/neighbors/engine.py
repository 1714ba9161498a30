"""The neighbor engine: MinHash pass -> LSH candidates -> exact top-k.

Three stages, each deterministic:

1. **Signatures** (:func:`minhash_signatures`): the streamed MinHash
   pass over the cohort on the job's device. It rides
   ``runner.run_pass`` on the dense int8 transport (the packed-gram
   kernel is not involved) and checkpoints its ``sig``/``nvar`` leaves
   under the ``solver:minhash`` tag at the job's
   ``--checkpoint-every-blocks`` cadence, in the JAX package's layout and
   uint32 dtypes, so a killed run resumes from the cursor bit-identically
   in either package.
2. **Candidates** (lsh.py): banding over the signatures on the host.
   ``neighbors.filter_frac`` reports the share of all N(N-1)/2 pairs it
   avoided.
3. **Exact evaluation** (:func:`_pair_stats_stream`): a second streamed
   pass on the host that accumulates the kernel's ``PairSpec`` cross
   statistics for only the candidate pairs: int64 sums of the same
   integer products the dense gram accumulates, so ``PairSpec.sim``
   gives the JAX package's similarities bit for bit. Each block's
   contribution runs inside a retry boundary (the
   ``neighbors.candidates`` fault site): a transient IO error recomputes
   the block's contribution from scratch.

The JAX package evaluates each pair statistic as an int64 ``einsum`` of
gathered 0/1 indicator rows. The port packs each indicator into 64-bit
words (``c``, ``t1``, ``t2``; the dosage ``y`` is ``t1 + t2``) and
counts the set bits of each candidate pair's AND: the same integers, 64
variants per word operation, in chunks spread over a thread pool.
"""

from __future__ import annotations

import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import checkpoint as ckpt
from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.config import JobConfig
from spark_examples_tpu_torch.core.device import resolve_device
from spark_examples_tpu_torch.core.profiling import PhaseTimer
from spark_examples_tpu_torch.neighbors import lsh
from spark_examples_tpu_torch.neighbors import minhash as M
from spark_examples_tpu_torch.neighbors.output import PairsResult, TopKResult
from spark_examples_tpu_torch.ops import genotype
from spark_examples_tpu_torch.pipelines import runner

# Checkpoint namespace of the signature pass (the sketch solver's
# ``solver:<metric>`` convention), so a minhash checkpoint can never be
# resumed into a gram or sketch-solver job, or the other way round.
METRIC_TAG = "solver:minhash"

# Candidate pairs per evaluation chunk: bounds each gathered bit-plane
# at _PAIR_CHUNK x words 8-byte words (8 MB for 8192-variant blocks).
_PAIR_CHUNK = 8192

# Indicator bit-planes of each operand name (the dosage is t1 + t2).
_PLANES = {"c": ("c",), "t1": ("t1",), "t2": ("t2",), "y": ("t1", "t2")}

# Threads of the pair evaluation (numpy releases the GIL in its loops).
_WORKERS = max(1, min(8, os.cpu_count() or 1))

# Set-bit counting: numpy >= 2.0's ufunc, else a byte lookup table.
_BITCOUNT = getattr(np, "bitwise_count", None)
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def minhash_signatures(job: JobConfig, source,
                       timer: PhaseTimer) -> tuple[np.ndarray, int]:
    """The streamed signature pass: ``((N, k) uint32 signatures,
    n_variants)``. Resumes from, and saves, ``solver:minhash``
    checkpoints under ``--checkpoint-dir``."""
    cfg = job.compute
    device = resolve_device(cfg.device)
    n = source.n_samples
    hashes, seed = cfg.minhash_hashes, cfg.minhash_seed
    update = M.make_update(hashes, seed, device)
    bv = job.ingest.block_variants
    # Every knob the signatures depend on: a checkpoint from another
    # seed or hash count can never be resumed into this job.
    extra = {"solver": "minhash", "hashes": int(hashes),
             "bands": int(cfg.minhash_bands), "seed": int(seed)}

    state, start_variant = None, 0
    if cfg.checkpoint_dir:
        restored = ckpt.load(cfg.checkpoint_dir, METRIC_TAG,
                             source.sample_ids, block_variants=bv,
                             leaves=list(M.STATE_LEAVES),
                             expect_extra=extra)
        if restored is not None:
            leaves, start_variant, _stats = restored
            state = M.from_checkpoint(leaves, device)
    if state is None:
        state = M.init_state(n, hashes, device)

    cb = None
    if cfg.checkpoint_dir and cfg.checkpoint_every_blocks:
        def cb(st, cursor):
            ckpt.save(cfg.checkpoint_dir, M.to_checkpoint(st), cursor,
                      METRIC_TAG, bv, source.sample_ids, extra=extra)

    with telemetry.span("solver.pass"):
        state, n_variants = runner.run_pass(
            job, source, timer, device, update, state,
            start_variant=start_variant, packed=False,
            # One compare + select per hash per variant column and the
            # carrier test: O(N v + k v), nothing like the gram count.
            block_flops=lambda v: 1.0 * n * v + 1.0 * hashes * v,
            save_cb=cb,
        )
    return M.signatures(state), n_variants


def _np_operands(block: np.ndarray) -> dict[str, np.ndarray]:
    """Host twin of ``ops.genotype.operands`` for the indicator operands
    every PairSpec statistic is built from (c/t1/t2/y). Missing (-1)
    calls and padding contribute zeros, as on the device."""
    g = np.asarray(block)
    c = (g >= 0).astype(np.uint8)
    t1 = (g >= 1).astype(np.uint8)
    t2 = (g >= 2).astype(np.uint8)
    return {"c": c, "t1": t1, "t2": t2, "y": t1 + t2}


def _bit_planes(block: np.ndarray) -> dict[str, np.ndarray]:
    """The c/t1/t2 indicators of an (N, v) block, each packed into an
    (N, ceil(v / 64)) uint64 array (zero bits past v)."""
    ops = _np_operands(block)
    n, v = ops["c"].shape
    words = -(-v // 64)
    planes = {}
    for name in ("c", "t1", "t2"):
        packed = np.zeros((n, words * 8), np.uint8)
        packed[:, :-(-v // 8)] = np.packbits(ops[name], axis=1)
        planes[name] = packed.view(np.uint64)
    return planes


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    """Set bits per row of a (P, W) uint64 array, int64."""
    if _BITCOUNT is not None:
        return _BITCOUNT(x).sum(axis=1, dtype=np.int64)
    return _POP8[x.view(np.uint8)].sum(axis=1, dtype=np.int64)


def _chunk_stats(planes, ii, jj, stats) -> dict[str, np.ndarray]:
    """The statistics of one chunk of pairs: each (left plane, right
    plane) count once, shared across the statistics' terms."""
    rows_i = {p: planes[p][ii] for p in planes}
    rows_j = {p: planes[p][jj] for p in planes}
    counts: dict[tuple[str, str], np.ndarray] = {}
    out = {}
    for s in stats:
        acc = np.zeros(len(ii), np.int64)
        for (left, right), w in genotype.CROSS_STATS[s]:
            for pl in _PLANES[left]:
                for pr in _PLANES[right]:
                    c = counts.get((pl, pr))
                    if c is None:
                        c = counts[(pl, pr)] = _popcount_rows(
                            rows_i[pl] & rows_j[pr])
                    acc += w * c
        out[s] = acc
    return out


def _block_pair_stats(block: np.ndarray, ii: np.ndarray, jj: np.ndarray,
                      stats: tuple[str, ...]) -> dict[str, np.ndarray]:
    """One block's exact contribution to the candidate pairs' cross
    statistics: for each stat, ``sum_terms w * <opL[i], opR[j]>`` over
    the block's variants, int64. Pure: the retry boundary recomputes it
    wholesale."""
    planes = _bit_planes(block)
    out = {s: np.zeros(len(ii), np.int64) for s in stats}
    spans = [(lo, min(lo + _PAIR_CHUNK, len(ii)))
             for lo in range(0, len(ii), _PAIR_CHUNK)]
    if not spans:
        return out

    def one(span):
        lo, hi = span
        return lo, hi, _chunk_stats(planes, ii[lo:hi], jj[lo:hi], stats)

    with ThreadPoolExecutor(min(_WORKERS, len(spans)),
                            thread_name_prefix="neighbors-eval") as pool:
        for lo, hi, part in pool.map(one, spans):
            for s in stats:
                out[s][lo:hi] = part[s]
    return out


def _pair_stats_stream(job: JobConfig, source, timer: PhaseTimer,
                       pairs: np.ndarray,
                       stats: tuple[str, ...]) -> dict[str, np.ndarray]:
    """The exact-evaluation pass: stream the cohort once more and
    accumulate each candidate pair's cross statistics block by block.

    Every block attempt runs through the ``neighbors.candidates`` fault
    site and an IO retry boundary sized by ``--io-retries`` /
    ``--io-retry-backoff``: a transient error discards the attempt and
    recomputes the block's contribution, so the statistics, and the
    output bytes, equal a fault-free run's."""
    ii = np.ascontiguousarray(pairs[:, 0])
    jj = np.ascontiguousarray(pairs[:, 1])
    acc = {s: np.zeros(len(ii), np.int64) for s in stats}
    budget = max(0, job.ingest.io_retries)
    backoff = max(0.0, job.ingest.io_retry_backoff_s)
    with timer.phase("neighbors_eval"):
        for block, _meta in source.blocks(job.ingest.block_variants):
            attempt = 0
            while True:
                try:
                    faults.fire("neighbors.candidates")
                    contrib = _block_pair_stats(block, ii, jj, stats)
                    break
                except IOError as e:
                    if attempt >= budget:
                        raise
                    attempt += 1
                    warnings.warn(
                        "neighbors candidate evaluation hit a transient "
                        f"IO error ({e!r}); recomputing the block "
                        f"(attempt {attempt}/{budget})",
                        RuntimeWarning, stacklevel=2,
                    )
                    if backoff > 0.0:
                        time.sleep(min(backoff * attempt, 30.0))
            for s in stats:
                acc[s] += contrib[s]
    return acc


def topk_rows(sims: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(b, N) similarity rows -> ``(ids, vals)`` of shape
    ``(b, min(k, N))``: descending similarity, ties broken by ascending
    column index (stable argsort over the negated values)."""
    sims = np.asarray(sims, np.float64)
    kk = min(int(k), sims.shape[1])
    order = np.argsort(-sims, axis=1, kind="stable")[:, :kk]
    vals = np.take_along_axis(sims, order, axis=1)
    return order.astype(np.int32), vals


def topk_from_pairs(pairs: np.ndarray, sims: np.ndarray, n: int,
                    k: int) -> tuple[np.ndarray, np.ndarray]:
    """Evaluated candidate edges -> per-sample ``(ids, vals)`` of shape
    (n, k): each sample's k best candidate neighbors, descending
    similarity with ties broken by ascending neighbor id; rows with
    fewer than k candidates pad with id -1 / sim 0.0."""
    ids = np.full((n, k), -1, np.int32)
    vals = np.zeros((n, k), np.float64)
    nbrs: list[list[tuple[float, int]]] = [[] for _ in range(n)]
    for (i, j), s in zip(pairs, sims):
        s = float(s)
        nbrs[int(i)].append((-s, int(j)))
        nbrs[int(j)].append((-s, int(i)))
    for i in range(n):
        if not nbrs[i]:
            continue
        best = sorted(nbrs[i])[:k]
        ids[i, :len(best)] = [j for _neg, j in best]
        vals[i, :len(best)] = [-neg for neg, _j in best]
    return ids, vals


def neighbors_job(job: JobConfig, source=None,
                  timer: PhaseTimer | None = None):
    """The cohort neighbor job: signatures, candidates, exact
    evaluation, sparse reduction. Returns a :class:`TopKResult` or a
    :class:`PairsResult` per ``--neighbors-output``."""
    if timer is None:
        timer = PhaseTimer()
    cfg = job.compute
    metric = cfg.metric or "ibs"
    kern = kernels.get(metric)
    if kern.pair is None:
        raise ValueError(
            f"metric {metric!r} has no pairwise finalize — top-k "
            "neighbors needs a kernel with a PairSpec; currently: "
            f"{', '.join(kernels.pairable_names())}"
        )
    with runner.job_source(job, source, timer) as source:
        n = source.n_samples
        sig, n_variants = minhash_signatures(job, source, timer)
        with timer.phase("lsh"):
            pairs, n_overflow, _nb = lsh.candidate_pairs(
                sig, cfg.minhash_bands, cfg.minhash_bucket_cap)
        telemetry.count("neighbors.candidate_pairs", float(len(pairs)))
        telemetry.count("neighbors.bucket_overflows", float(n_overflow))
        telemetry.gauge_set("neighbors.filter_frac",
                            lsh.filter_fraction(len(pairs), n))
        acc = _pair_stats_stream(job, source, timer, pairs,
                                 kern.pair.stats)
        sample_ids = tuple(source.sample_ids)
    sims = np.asarray(kern.pair.sim(acc), np.float64)
    telemetry.count("neighbors.evaluated_pairs", float(len(pairs)))
    if cfg.neighbors_output == "pairs":
        return PairsResult(pairs=pairs, sims=sims, sample_ids=sample_ids,
                           metric=metric, n_variants=n_variants)
    ids, vals = topk_from_pairs(pairs, sims, n, cfg.neighbors_k)
    return TopKResult(ids=ids, sims=vals, sample_ids=sample_ids,
                      metric=metric, k=cfg.neighbors_k,
                      n_variants=n_variants)
