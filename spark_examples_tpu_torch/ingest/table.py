"""A sample-by-feature count table (an OTU or sOTU table) as a job's
source: the input of the table metric, Bray-Curtis.

:class:`CountTableSource` holds an (N, F) nonnegative integer table as
CSR in host memory, as a BIOM table holds it: ``indptr`` (N + 1 row
offsets), ``indices`` (each nonzero's feature) and ``counts``. A job
takes the table whole (:meth:`CountTableSource.dense`): the three CSR
arrays are copied to the job's device once, from pinned host memory on
a card, and scattered there into a zeroed float32 (N, F) table, the
operand the Bray-Curtis lowerings read. No count passes through int8 on
the way: a rarefied count runs to the sampling depth, thousands.

Only a table metric reads such a source (:func:`check_source`): the
gram metrics stream int8 dosage blocks, which a count table has none
of. ``n_variants`` is the feature count, so the job's bookkeeping reads
as it does for a genotype source.

A table metric reads every source through :func:`count_table`: a count
table as it is, a genotype source as its dosage matrix
(:class:`DosageTable`), so the Bray-Curtis runner has one path.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_examples_tpu_torch import kernels
from spark_examples_tpu_torch.core import telemetry
from spark_examples_tpu_torch.core.profiling import device_span
from spark_examples_tpu_torch.ingest.source import materialize


def _refusal(what: str) -> ValueError:
    tables = [n for n in kernels.names()
              if kernels.get(n).table_runner is not None]
    return ValueError(
        f"{what}: a count table feeds only a table metric "
        f"({' | '.join(tables)}, e.g. --metric braycurtis)")


def check_source(source, metric: str) -> None:
    """Refuse, before any work, a count table (a source with its own
    ``dense`` table) under a metric that cannot read one: a metric
    without a table runner streams int8 dosage blocks."""
    if (hasattr(source, "dense")
            and kernels.get(metric).table_runner is None):
        raise _refusal(f"metric {metric!r} streams int8 dosage blocks, "
                       "and a count table has none")


class DosageTable:
    """A genotype source read as a count table: its whole int8 dosage
    matrix, block by block, with missing (negative) as absence. A count
    past 127 cannot pass this way; a count table's source is
    :class:`CountTableSource`."""

    def __init__(self, source, block_variants: int):
        self.source = source
        self.block_variants = block_variants

    def dense(self, device) -> torch.Tensor:
        """The float32 (N, V) table on ``device``: int8 over the link,
        widened there."""
        x = np.maximum(materialize(self.source, self.block_variants), 0)
        return torch.from_numpy(x).to(device).to(torch.float32)


def count_table(source, block_variants: int):
    """What a table metric reads ``source`` through: the source itself
    when it holds a count table (it has ``dense``), else its dosage
    matrix (:class:`DosageTable`)."""
    if hasattr(source, "dense"):
        return source
    return DosageTable(source, block_variants)


class CountTableSource:
    """An (N, F) count table held as CSR on the host.

    ``indptr``: (N + 1,) nondecreasing row offsets from 0 to the number
    of nonzeros; ``indices``: each nonzero's feature in ``[0, F)``;
    ``counts``: each nonzero's count, a nonnegative integer. ``ids``:
    the sample ids (``S000000``, ... when None)."""

    def __init__(self, indptr, indices, counts, n_features: int,
                 ids: list[str] | None = None):
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        counts = np.asarray(counts)
        if not np.issubdtype(counts.dtype, np.integer):
            raise TypeError(f"counts must be integers, got {counts.dtype}")
        self.counts = np.ascontiguousarray(counts, dtype=np.int32)
        self.n_features = int(n_features)
        self.ids = ids
        n = self.indptr.shape[0] - 1
        nnz = self.indices.shape[0]
        if (self.indptr.ndim != 1 or n < 0 or self.indptr[0] != 0
                or self.indptr[-1] != nnz or self.counts.shape != (nnz,)
                or np.any(np.diff(self.indptr) < 0)):
            raise ValueError(
                f"not a CSR table: indptr of {self.indptr.shape[0]} "
                f"offsets ending at {self.indptr[-1] if n >= 0 else None}, "
                f"{nnz} indices, {self.counts.shape[0]} counts")
        if nnz and (self.indices.min() < 0
                    or self.indices.max() >= self.n_features):
            raise ValueError(f"feature indices outside [0, "
                             f"{self.n_features})")
        if nnz and self.counts.min() < 0:
            raise ValueError("counts must be nonnegative")
        if ids is not None and len(ids) != n:
            raise ValueError(f"{len(ids)} sample ids for {n} rows")
        self._pinned: tuple[torch.Tensor, ...] | None = None

    @property
    def n_samples(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def n_variants(self) -> int:
        return self.n_features

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def sample_ids(self) -> list[str]:
        if self.ids is not None:
            return self.ids
        return [f"S{i:06d}" for i in range(self.n_samples)]

    def blocks(self, block_variants: int, start_variant: int = 0):
        """A count table streams no dosage blocks: raises."""
        raise _refusal("a count table streams no int8 dosage blocks")

    def _host_arrays(self, pin: bool) -> tuple[torch.Tensor, ...]:
        arrays = (torch.from_numpy(self.indptr),
                  torch.from_numpy(self.indices),
                  torch.from_numpy(self.counts))
        if not pin:
            return arrays
        if self._pinned is None:
            self._pinned = tuple(a.pin_memory() for a in arrays)
        return self._pinned

    def dense(self, device) -> torch.Tensor:
        """The float32 (N, F) table, contiguous on ``device``: the CSR
        arrays copied there once (from pinned memory on a card), then
        scattered into a zeroed table. Spans ``table.upload``; counts
        ``table.nnz`` and ``table.upload_bytes``."""
        device = torch.device(device)
        n, f, nnz = self.n_samples, self.n_features, self.nnz
        cuda = device.type == "cuda"
        with device_span("table.upload", device):
            indptr, indices, counts = (
                a.to(device, non_blocking=cuda)
                for a in self._host_arrays(pin=cuda))
            table = torch.zeros((n, f), dtype=torch.float32, device=device)
            if nnz:
                rows = torch.repeat_interleave(
                    torch.arange(n, device=device), indptr.diff(),
                    output_size=nnz)
                flat = rows * f + indices.to(torch.int64)
                table.view(-1)[flat] = counts.to(torch.float32)
        telemetry.count("table.nnz", float(nnz))
        telemetry.count("table.upload_bytes", float(
            self.indptr.nbytes + self.indices.nbytes + self.counts.nbytes))
        return table
