"""Sparse neighbor artifacts: the ``topk`` and ``pairs`` output files,
byte for byte the JAX package's format (the same magic, header and
array order), so either package loads the other's files.

A neighbor result is deliberately not an ``.npz``: zip members carry
timestamps, so two bit-identical computations would save different
bytes, and byte-identity of the output file is what a killed and
resumed job is held to. The format is a single flat file:

    line 1   JSON header (schema_version, kind, metric, k, shapes,
             sample ids) terminated by ``\\n``
    then     each array's C-order raw bytes, in the header's order

Writes are atomic (tmp + rename in the destination directory); loads
validate eagerly and raise :class:`NeighborFormatError` naming what is
wrong and what to do about it, so a truncated copy or a stale schema
fails at load time, never as garbage neighbor ids downstream.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np

SCHEMA_VERSION = 1
_MAGIC = "spark-examples-tpu/neighbors"

# (name, dtype) per kind — order is the on-disk array order.
_ARRAYS = {
    "topk": (("ids", "<i4"), ("sims", "<f8")),
    "pairs": (("pairs", "<i8"), ("sims", "<f8")),
}


class NeighborFormatError(Exception):
    """A neighbor artifact that cannot be loaded as such — wrong magic,
    unsupported schema, missing fields, or truncated array bytes. The
    message names the defect and the likely fix."""


@dataclass(frozen=True)
class TopKResult:
    """Per-sample sparse top-k: ``ids[i]`` are sample i's k nearest
    neighbor indices in descending similarity (ties broken by ascending
    neighbor id — deterministic), ``sims[i]`` the EXACT similarities
    (the registered kernel's pair finalize, not the MinHash estimate).
    Rows with fewer than k candidates pad with id -1 / sim 0.0."""

    ids: np.ndarray  # (N, k) int32, -1 padded
    sims: np.ndarray  # (N, k) float64, 0.0 padded
    sample_ids: tuple[str, ...]
    metric: str
    k: int
    n_variants: int

    @property
    def kind(self) -> str:
        return "topk"


@dataclass(frozen=True)
class PairsResult:
    """The evaluated candidate edge list: sorted unique ``i < j`` pairs
    with their exact similarities — the ``--neighbors-output pairs``
    shape, for consumers that want the graph rather than the rows."""

    pairs: np.ndarray  # (P, 2) int64
    sims: np.ndarray  # (P,) float64
    sample_ids: tuple[str, ...]
    metric: str
    n_variants: int

    @property
    def kind(self) -> str:
        return "pairs"

    @property
    def k(self) -> int:
        return 0


def save_result(path: str, result) -> None:
    """Atomic single-file write of a :class:`TopKResult` /
    :class:`PairsResult` — byte-deterministic for equal inputs."""
    kind = result.kind
    arrays = []
    payload = []
    for name, dtype in _ARRAYS[kind]:
        arr = np.ascontiguousarray(getattr(result, name), dtype=dtype)
        arrays.append({"name": name, "dtype": dtype,
                       "shape": list(arr.shape)})
        payload.append(arr.tobytes())
    header = {
        "format": _MAGIC,
        "schema_version": SCHEMA_VERSION,
        "kind": kind,
        "metric": result.metric,
        "k": int(result.k),
        "n_variants": int(result.n_variants),
        "sample_ids": list(result.sample_ids),
        "arrays": arrays,
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".neighbors.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(json.dumps(header, sort_keys=True).encode() + b"\n")
            for raw in payload:
                f.write(raw)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_result(path: str, expect_kind: str | None = None):
    """Load and validate a neighbor artifact. ``expect_kind`` pins the
    shape a caller requires ("topk" | "pairs"); every defect raises
    :class:`NeighborFormatError` with the fix named."""
    try:
        with open(path, "rb") as f:
            first = f.readline()
            blob = f.read()
    except OSError as e:
        raise NeighborFormatError(
            f"cannot read neighbor file {path!r}: {e}") from e
    try:
        header = json.loads(first.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise NeighborFormatError(
            f"{path!r} is not a neighbors file (unparseable header line: "
            f"{e}) — expected output of the `neighbors` job"
        ) from e
    if not isinstance(header, dict) or header.get("format") != _MAGIC:
        raise NeighborFormatError(
            f"{path!r} is not a neighbors file (missing "
            f"{_MAGIC!r} format tag)"
        )
    ver = header.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise NeighborFormatError(
            f"{path!r} has neighbors schema_version={ver!r}; this build "
            f"reads version {SCHEMA_VERSION} — regenerate with the "
            "`neighbors` job from this build"
        )
    for field in ("kind", "metric", "k", "n_variants", "sample_ids",
                  "arrays"):
        if field not in header:
            raise NeighborFormatError(
                f"{path!r} neighbors header is missing field {field!r} — "
                "the file is corrupt; regenerate it"
            )
    kind = header["kind"]
    if kind not in _ARRAYS:
        raise NeighborFormatError(
            f"{path!r} carries unknown neighbors kind {kind!r} "
            f"(expected one of {sorted(_ARRAYS)})"
        )
    if expect_kind is not None and kind != expect_kind:
        raise NeighborFormatError(
            f"{path!r} is a {kind!r} neighbors file, but this consumer "
            f"needs {expect_kind!r} — rerun the job with "
            f"--neighbors-output {expect_kind}"
        )
    expected = [list(x) for x in _ARRAYS[kind]]
    if [[a["name"], a["dtype"]] for a in header["arrays"]] != expected:
        raise NeighborFormatError(
            f"{path!r} declares arrays "
            f"{[a['name'] for a in header['arrays']]} for kind {kind!r}; "
            f"expected {[n for n, _ in _ARRAYS[kind]]} — schema drift, "
            "regenerate the file"
        )
    out = {}
    offset = 0
    for spec in header["arrays"]:
        shape = tuple(int(s) for s in spec["shape"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(
            spec["dtype"]).itemsize
        chunk = blob[offset:offset + nbytes]
        if len(chunk) != nbytes:
            raise NeighborFormatError(
                f"{path!r} is truncated: array {spec['name']!r} needs "
                f"{nbytes} bytes, {len(chunk)} remain — partial copy? "
                "re-transfer or regenerate the file"
            )
        out[spec["name"]] = np.frombuffer(
            chunk, dtype=spec["dtype"]).reshape(shape).copy()
        offset += nbytes
    if offset != len(blob):
        raise NeighborFormatError(
            f"{path!r} carries {len(blob) - offset} trailing bytes past "
            "the declared arrays — the file is corrupt; regenerate it"
        )
    common = dict(sample_ids=tuple(header["sample_ids"]),
                  metric=header["metric"],
                  n_variants=int(header["n_variants"]))
    if kind == "topk":
        return TopKResult(ids=out["ids"], sims=out["sims"],
                          k=int(header["k"]), **common)
    return PairsResult(pairs=out["pairs"], sims=out["sims"], **common)
