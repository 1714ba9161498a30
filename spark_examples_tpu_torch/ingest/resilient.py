"""Retrying ingest: a transient IO failure must not kill a long stream.

:class:`RetryingSource` wraps a file-backed GenotypeSource. When a block
read raises a transient IO error it re-opens the source and seeks back
to the cursor: every source's ``blocks(bv, start)`` resumes
deterministically, and the re-opened iterator restarts at the last
yielded block's ``meta.stop``, so the stream downstream is the same
bytes as an unfailed read.

Not retried:

- **Corrupt blocks** (wrong sample count, rank or dtype) fail fast with
  the resume cursor named: retrying would re-yield the same damage.
  Dropping a bad block is not offered; it would shift every later
  cursor.
- **Non-IO exceptions** (ValueError and contract violations, the
  store's ``StoreCorruptError`` among them) propagate unchanged.

The ``ingest.block_read`` fault site (core/faults.py) fires inside the
retry boundary. The JAX package's ``ingest/resilient.py`` is the spec.
"""

from __future__ import annotations

import dataclasses
import random
import time
import warnings
from dataclasses import dataclass

import numpy as np

from spark_examples_tpu_torch.core import faults, telemetry
from spark_examples_tpu_torch.core.dtypes import GENOTYPE_DTYPE
from spark_examples_tpu_torch.ingest.source import GenotypeSource, close_source


class IngestExhaustedError(IOError):
    """Bounded retries ran out. Carries the resume cursor in the message
    and as ``.cursor``."""

    def __init__(self, msg: str, cursor: int):
        super().__init__(msg)
        self.cursor = cursor


class CorruptBlockError(ValueError):
    """A block that cannot be valid (wrong cohort width, rank or dtype).
    Never retried; the cursor is named."""

    def __init__(self, msg: str, cursor: int):
        super().__init__(msg)
        self.cursor = cursor


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter."""

    max_retries: int = 3  # per incident: consecutive failures
    backoff_s: float = 0.05
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 5.0
    jitter: float = 0.25  # +- fraction of the computed backoff
    retry_on: tuple = (IOError, OSError)

    def sleep_s(self, attempt: int, rng: random.Random) -> float:
        base = min(
            self.backoff_s * self.backoff_multiplier ** attempt,
            self.max_backoff_s,
        )
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


def _exhausted(cursor: int, policy: RetryPolicy, e: BaseException
               ) -> IngestExhaustedError:
    telemetry.count("ingest.exhausted")
    return IngestExhaustedError(
        f"ingest failed at variant cursor {cursor} after "
        f"{policy.max_retries} retries: {e!r} — restart this stream at "
        f"start_variant={cursor}",
        cursor,
    )


def _backoff(cursor: int, policy: RetryPolicy, retries_left: int,
             rng: random.Random, e: BaseException) -> None:
    """Count, warn and sleep before the retry that ``retries_left``
    (already decremented) allows."""
    attempt = policy.max_retries - retries_left - 1
    delay = policy.sleep_s(attempt, rng)
    telemetry.count("ingest.retries")
    telemetry.count("ingest.backoff_s", delay)
    warnings.warn(
        f"transient ingest error at variant cursor {cursor} ({e!r}); "
        f"retrying in {delay * 1e3:.0f} ms ({retries_left} retries left)",
        RuntimeWarning,
        stacklevel=3,
    )
    time.sleep(delay)


@dataclass
class RetryingSource:
    """Transparent retry wrapper over a file-backed source.

    Metadata and the ``exact_n_variants`` claim pass through. The packed
    transport (``packed_views``, ``packed_blocks``) and the store's
    decode-to-buffer drive (``block_spans`` + ``decode_range_into``)
    are forwarded under the same retry loop when the inner source has
    them.

    ``reopen``: a factory returning a fresh inner source, called before
    each retry. Sources that open their files inside ``blocks()`` (VCF,
    PLINK) re-open by themselves and need none; memmapped sources (the
    packed store, the dataset store) hold their mapping on the object
    and need one, or a retry would re-slice the same stale mapping. The
    replaced inner source is closed. The budget is per incident: a
    block yielded restores it.
    """

    inner: GenotypeSource
    policy: RetryPolicy = RetryPolicy()
    seed: int = 0
    reopen: object = None  # () -> GenotypeSource, or None

    def __post_init__(self):
        if hasattr(self.inner, "packed_blocks"):
            self.packed_blocks = self._packed_blocks
        if hasattr(self.inner, "packed_views"):
            self.packed_views = self._packed_views
        if hasattr(self.inner, "decode_range_into") and hasattr(
                self.inner, "block_spans"):
            self.block_spans = self._block_spans
            self.decode_range_into = self._decode_range_into

    @property
    def n_samples(self) -> int:
        return self.inner.n_samples

    @property
    def n_variants(self) -> int:
        return self.inner.n_variants

    @property
    def sample_ids(self) -> list[str]:
        return self.inner.sample_ids

    @property
    def exact_n_variants(self) -> bool:
        return bool(getattr(self.inner, "exact_n_variants", False))

    def close(self) -> None:
        close_source(self.inner)

    def _reopen(self) -> None:
        if self.reopen is not None:
            telemetry.count("ingest.reopens")
            old, self.inner = self.inner, self.reopen()
            close_source(old)

    def _validate(self, block: np.ndarray, cursor: int) -> None:
        n = self.inner.n_samples
        if (
            getattr(block, "ndim", 0) != 2
            or block.shape[0] != n
            or block.dtype != GENOTYPE_DTYPE
        ):
            telemetry.count("ingest.corrupt_blocks")
            raise CorruptBlockError(
                f"corrupt block at variant cursor {cursor}: got "
                f"shape {getattr(block, 'shape', None)} dtype "
                f"{getattr(block, 'dtype', None)}, expected ({n}, v) "
                f"{np.dtype(GENOTYPE_DTYPE).name} — the input is damaged "
                "(not a transient failure, so it is not retried); fix the "
                f"file and resume from start_variant={cursor}",
                cursor,
            )

    def _stream(self, opener, start_variant: int, validate: bool):
        """The retry loop: ``opener(cursor)`` re-opens the inner iterator
        at a cursor; ordinals count over the OUTPUT stream, so they do
        not jump back across a re-open. Items are ``(block, meta)``, or
        ``(bytes, meta, view)`` from ``packed_views``."""
        cursor = start_variant
        idx = 0
        rng = random.Random(self.seed)
        retries_left = self.policy.max_retries
        need_reopen = False
        while True:
            it = None
            try:
                # The rebuild and the open sit inside the boundary: on a
                # still-flaky mount they fail like a block read and spend
                # the same budget.
                if need_reopen:
                    self._reopen()
                need_reopen = False
                it = opener(cursor)
                for block, meta, *rest in it:
                    faults.fire("ingest.block_read")
                    if validate:
                        self._validate(block, meta.start)
                    yield (block, dataclasses.replace(meta, index=idx),
                           *rest)
                    idx += 1
                    cursor = meta.stop
                    retries_left = self.policy.max_retries
                return
            except self.policy.retry_on as e:
                if retries_left <= 0:
                    raise _exhausted(cursor, self.policy, e) from e
                retries_left -= 1
                _backoff(cursor, self.policy, retries_left, rng, e)
                need_reopen = True
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()

    def blocks(self, block_variants: int, start_variant: int = 0):
        yield from self._stream(
            lambda cur: self.inner.blocks(block_variants, cur),
            start_variant, validate=True,
        )

    def _packed_blocks(self, block_variants: int, start_variant: int = 0):
        # (N, width/4) uint8: the dense shape/dtype contract does not
        # apply, and the 2-bit codec's unpack is bounds-safe.
        yield from self._stream(
            lambda cur: self.inner.packed_blocks(block_variants, cur),
            start_variant, validate=False,
        )

    def _packed_views(self, block_variants: int, start_variant: int = 0):
        # ``(bytes, meta, view)``: the packed transport's views, under the
        # same loop.
        yield from self._stream(
            lambda cur: self.inner.packed_views(block_variants, cur),
            start_variant, validate=False,
        )

    def _block_spans(self, block_variants: int, start_variant: int = 0):
        # Catalog arithmetic, no chunk IO: nothing to retry.
        yield from self.inner.block_spans(block_variants, start_variant)

    def _decode_range_into(self, lo: int, hi: int, out: np.ndarray,
                           col_off: int = 0) -> None:
        """One bounded decode under the retry boundary. A failed try may
        leave ``out`` partly written; the retry re-decodes the whole
        [lo, hi) span over it."""
        rng = random.Random(self.seed)
        retries_left = self.policy.max_retries
        need_reopen = False
        while True:
            try:
                if need_reopen:
                    self._reopen()
                need_reopen = False
                faults.fire("ingest.block_read")
                self.inner.decode_range_into(lo, hi, out, col_off)
                return
            except self.policy.retry_on as e:
                if retries_left <= 0:
                    raise _exhausted(lo, self.policy, e) from e
                retries_left -= 1
                _backoff(lo, self.policy, retries_left, rng, e)
                need_reopen = True
