"""Self-healing for the content-addressed store: repair, don't retire.

A quarantined chunk used to be a dead end: the read failed fast and the
operator re-compacted the whole store. But the content address makes a
repair *verifiable* — the healed bytes must hash to the chunk's own
filename — and the manifest (schema v2) records two recovery routes:

- **Replica.** Chunk files are content-addressed, so any peer store
  directory holding ``chunks/<digest>.bin`` holds THE chunk; healing is
  a verified copy, no manifest surgery.
- **Origin.** The manifest's ``origin`` record (an IngestConfig-shaped
  dict written by ``compact(..., origin=...)``) names the source the
  store was compacted from. Each catalog row is an origin *span*
  (``[start, stop)`` on the compaction's own block grid), so one chunk
  is re-compacted by re-streaming exactly that span — deterministic
  sources (synthetic, packed, VCF, another store) reproduce it bit for
  bit, and the digest check proves they did.

Both routes write tmp + rename and re-verify before the quarantine
entry is dropped, so a failed heal can never replace damage with
different damage. The reader (store/reader.py) calls :func:`heal_chunk`
inline on a verify failure — degradation instead of fail-fast whenever
a route is available — and the ``store heal`` CLI verb runs
:func:`heal` over the whole ledger for offline repair.
"""

from __future__ import annotations

import os
import threading

from spark_examples_tpu_torch.core import hashing, telemetry
from spark_examples_tpu_torch.ingest.source import close_source
from spark_examples_tpu_torch.store import codec as codecmod
from spark_examples_tpu_torch.store import quarantine
from spark_examples_tpu_torch.store.manifest import ChunkRecord, StoreManifest


class HealError(RuntimeError):
    """No route could repair the chunk (no replica holds it, no origin
    is recorded, or the origin stream no longer reproduces the recorded
    digest). The original corruption error should follow."""


# IngestConfig fields that define the compacted stream (the healing
# recipe). Deliberately a closed list: transport/perf knobs (prefetch
# depth, worker counts, caches) cannot change the bytes and are not
# recorded.
_ORIGIN_FIELDS = (
    "source", "path", "n_samples", "n_variants", "n_populations", "seed",
    "maf", "max_missing", "ld_r2", "ld_window", "ld_carry",
)


def origin_from_ingest(cfg, chunk_variants: int) -> dict:
    """The manifest ``origin`` record for a compaction driven by
    ``cfg`` (an IngestConfig): every field that determines the stream's
    bytes, plus the chunk grid the spans were cut on. The source path
    is absolutized — a heal (or ``store heal``) runs from whatever
    working directory the LATER job happens to have, not the
    compaction's."""
    rec = {k: getattr(cfg, k) for k in _ORIGIN_FIELDS}
    if rec.get("path"):
        rec["path"] = os.path.abspath(rec["path"])
    rec["references"] = [str(r) for r in cfg.references]
    rec["chunk_variants"] = int(chunk_variants)
    return rec


def build_origin_source(origin: dict, device: str = "cuda"):
    """Rebuild the origin GenotypeSource from a manifest record, through
    the port's own ``build_source`` on ``device`` (where LD pruning's
    r^2 runs; ``cuda`` raises when no card is visible, as every job
    does). The digest check refuses any span that does not reproduce."""
    from spark_examples_tpu_torch.core.config import (
        IngestConfig,
        ReferenceRange,
    )
    from spark_examples_tpu_torch.core.device import resolve_device
    from spark_examples_tpu_torch.pipelines.runner import build_source

    kw = {k: origin[k] for k in _ORIGIN_FIELDS if k in origin}
    kw["references"] = [ReferenceRange.parse(r)
                        for r in origin.get("references", [])]
    return build_source(IngestConfig(**kw), str(resolve_device(device)))


def _raw_span_from_origin(rec: ChunkRecord, origin: dict,
                          source=None, device: str = "cuda") -> bytes:
    """Re-compact one chunk span from the origin stream into its RAW
    packed payload (pre-compression); the caller re-compresses with the
    chunk's recorded codec and verifies the digest before installing."""
    import numpy as np

    from spark_examples_tpu_torch.ingest import bitpack

    if source is None:
        source = build_origin_source(origin, device)
        try:
            return _raw_span_from_origin(rec, origin, source)
        finally:
            close_source(source)
    chunk_variants = int(origin.get("chunk_variants", 16384))
    for block, meta in source.blocks(chunk_variants, start_variant=rec.start):
        if meta.start != rec.start or meta.stop != rec.stop:
            raise HealError(
                f"origin stream no longer matches the catalog: asked for "
                f"span [{rec.start}, {rec.stop}), got "
                f"[{meta.start}, {meta.stop}) — the origin changed since "
                "compaction; re-compact the store"
            )
        return bitpack.pack_dosages(np.ascontiguousarray(block)).tobytes()
    raise HealError(
        f"origin stream is shorter than the catalog (no block at "
        f"variant {rec.start}) — the origin changed since compaction"
    )


def _dict_trainer_record(manifest: StoreManifest,
                         dict_digest: str) -> ChunkRecord:
    """The chunk that trained ``dict_digest``: the FIRST chunk (stream
    order) carrying that digest — by the writer's construction, the
    first chunk of the dictionary's contig (store/writer.py
    _tag_first_of_contig)."""
    for rec in manifest.chunks:
        if rec.dict_digest == dict_digest:
            return rec
    raise HealError(
        f"dictionary {dict_digest[:16]}... is not referenced by any "
        "catalog row — a stale dicts/ file, nothing to rebuild"
    )


def recover_dict(root: str, manifest: StoreManifest, dict_digest: str,
                 replicas=(), origin_source=None,
                 device: str = "cuda") -> bytes:
    """Recover a missing/corrupt ``dicts/<digest>.zdict`` file in
    place: a digest-verified copy from a replica, else re-derivation
    from the origin (the dictionary is a pure function of its trainer
    chunk's raw payload — store/codec.py train_dict). Returns the
    dictionary bytes; raises :class:`HealError` when no route works."""
    errors: list[str] = []
    data = None
    for rep in replicas:
        cand = codecmod.dict_path(rep, dict_digest)
        try:
            with open(cand, "rb") as f:
                got = f.read()
        except OSError as e:
            errors.append(f"replica {rep!r}: {e}")
            continue
        if hashing.sha256_bytes(got) == dict_digest:
            data = got
            break
        errors.append(f"replica {rep!r}: dictionary bytes do not hash "
                      "to the content address")
    if data is None:
        if manifest.origin is None:
            raise HealError(
                "no replica holds the dictionary and the manifest "
                "records no origin"
                + (": " + "; ".join(errors) if errors else "")
            )
        trainer = _dict_trainer_record(manifest, dict_digest)
        try:
            raw = _raw_span_from_origin(trainer, manifest.origin,
                                        source=origin_source, device=device)
        except (OSError, ValueError) as e:
            raise HealError(
                f"origin re-derivation of the dictionary failed: {e}"
                + ("; " + "; ".join(errors) if errors else "")
            ) from e
        data = codecmod.train_dict(raw)
        if hashing.sha256_bytes(data) != dict_digest:
            raise HealError(
                "re-derived dictionary does not hash to "
                f"{dict_digest[:16]}... — the origin changed since "
                "compaction; re-compact the store"
            )
    path = codecmod.dict_path(root, dict_digest)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".heal.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return data


def _dict_bytes_for_heal(root: str, manifest: StoreManifest,
                         rec: ChunkRecord, replicas=(),
                         origin_source=None,
                         device: str = "cuda") -> bytes | None:
    """The dictionary an origin re-compression of ``rec`` needs —
    loaded from the store (digest-verified), else recovered through
    :func:`recover_dict`."""
    if rec.dict_digest is None:
        return None
    path = codecmod.dict_path(root, rec.dict_digest)
    try:
        with open(path, "rb") as f:
            data = f.read()
        if hashing.sha256_bytes(data) == rec.dict_digest:
            return data
    except OSError:
        pass
    return recover_dict(root, manifest, rec.dict_digest,
                        replicas=replicas, origin_source=origin_source,
                        device=device)


def _install(root: str, rec: ChunkRecord, data: bytes, how: str) -> None:
    """Digest-check + tmp/rename the healed bytes into place."""
    got = hashing.sha256_bytes(data)
    if got != rec.digest:
        raise HealError(
            f"healed bytes from {how} hash to {got[:16]}..., not the "
            f"chunk's content address {rec.digest[:16]}... — refusing to "
            "install a different chunk under this name"
        )
    path = os.path.join(root, rec.filename())
    tmp = path + f".heal.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def heal_chunk(root: str, manifest: StoreManifest, rec: ChunkRecord,
               replicas=(), origin_source=None, device: str = "cuda") -> str:
    """Repair one chunk in place; returns how ("replica:<dir>" or
    "origin"). Raises :class:`HealError` when no route works. On
    success the chunk's quarantine entry (if any) is dropped and
    ``store.healed`` is counted. ``device``: where an origin rebuilt
    here runs (``origin_source`` not given)."""
    with telemetry.span("store.heal"):
        errors: list[str] = []
        for rep in replicas:
            cand = os.path.join(rep, rec.filename())
            try:
                with open(cand, "rb") as f:
                    data = f.read()
                _install(root, rec, data, how=f"replica {rep!r}")
            except (OSError, HealError) as e:
                errors.append(f"replica {rep!r}: {e}")
                continue
            how = f"replica:{rep}"
            break
        else:
            if manifest.origin is None:
                raise HealError(
                    "no replica holds the chunk and the manifest records "
                    "no origin (compacted before schema v2, or origin "
                    "recording disabled)"
                    + (": " + "; ".join(errors) if errors else "")
                )
            try:
                raw = _raw_span_from_origin(rec, manifest.origin,
                                            source=origin_source,
                                            device=device)
                # Re-compression with the chunk's recorded codec and
                # dictionary: the codec is byte-deterministic by
                # contract, so the stored bytes — and therefore the
                # digest _install checks — reproduce exactly.
                data = codecmod.compress(
                    rec.codec, raw,
                    _dict_bytes_for_heal(root, manifest, rec,
                                         replicas=replicas,
                                         origin_source=origin_source,
                                         device=device))
                _install(root, rec, data, how="origin re-compaction")
            except (OSError, ValueError) as e:
                raise HealError(
                    f"origin re-compaction failed: {e}"
                    + ("; " + "; ".join(errors) if errors else "")
                ) from e
            how = "origin"
    telemetry.count("store.healed")
    quarantine.remove(root, rec.digest)
    return how


def heal(root: str, replicas=(), verify_all: bool = False,
         device: str = "cuda") -> dict:
    """Repair every damaged chunk in the store at ``root`` — the
    ``store heal`` CLI verb.

    Walks the quarantine ledger (plus, with ``verify_all``, a full
    re-hash of every chunk file against its content address) and runs
    :func:`heal_chunk` on each damaged chunk. Returns a report::

        {"checked": n, "damaged": n, "healed": [{digest, how}, ...],
         "failed": [{digest, error}, ...], "stale_cleared": n}

    The ledger is never trusted alone: a quarantined chunk whose file
    verifies clean (the operator restored it by hand) just clears its
    entry (reported with ``how="already-intact"``), and entries whose
    digest no longer appears in the manifest (the store was
    re-compacted since the incident) are cleared and counted as
    ``stale_cleared`` — leaving either would alarm on phantom chunks
    forever. A chunk healed from origin is re-compacted through ONE
    origin source shared across chunks (the origin stream is opened
    once), built on ``device``.
    """
    manifest = StoreManifest.load(root)
    by_digest: dict[str, ChunkRecord] = {}
    for rec in manifest.chunks:
        by_digest.setdefault(rec.digest, rec)

    damaged: dict[str, ChunkRecord] = {}
    stale_cleared = 0
    intact: list[dict] = []
    for entry in quarantine.load(root):
        digest = entry.get("digest", "")
        rec = by_digest.get(digest)
        if rec is None:
            if quarantine.remove(root, digest):
                stale_cleared += 1
            continue
        # Never trust the ledger alone: an operator may have already
        # restored the file (the recovery path the quarantine error
        # names — content addressing needs no manifest surgery). A
        # chunk that verifies clean just clears its entry.
        try:
            if hashing.sha256_file(
                    os.path.join(root, rec.filename())) == digest:
                quarantine.remove(root, digest)
                intact.append({"digest": digest, "start": rec.start,
                               "stop": rec.stop,
                               "how": "already-intact"})
                continue
        except OSError:
            pass  # unreadable/missing: genuinely damaged
        damaged[rec.digest] = rec
    checked = len(damaged) + len(intact)
    if verify_all:
        for digest, rec in by_digest.items():
            if digest in damaged:
                continue
            checked += 1
            path = os.path.join(root, rec.filename())
            try:
                if hashing.sha256_file(path) == digest:
                    continue
            except OSError:
                pass
            damaged[digest] = rec

    origin_source = None
    if manifest.origin is not None and damaged:
        try:
            origin_source = build_origin_source(manifest.origin, device)
        except (OSError, ValueError):
            origin_source = None  # per-chunk heals will name the error

    healed, failed = list(intact), []
    try:
        for digest, rec in sorted(damaged.items(),
                                  key=lambda kv: kv[1].start):
            try:
                how = heal_chunk(root, manifest, rec, replicas=replicas,
                                 origin_source=origin_source, device=device)
                healed.append({"digest": digest, "start": rec.start,
                               "stop": rec.stop, "how": how})
            except HealError as e:
                failed.append({"digest": digest, "start": rec.start,
                               "stop": rec.stop, "error": str(e)})
    finally:
        close_source(origin_source)
    return {"checked": checked, "damaged": len(damaged),
            "healed": healed, "failed": failed,
            "stale_cleared": stale_cleared}
