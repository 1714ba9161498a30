"""Accumulator checkpoint / resume for one process, on one device or a
mesh of them.

The gram accumulation is associative, so persisting (accumulators,
variant cursor) every K blocks makes recovery "resume from the last
checkpointed partial sum". The sketch solver saves its (N, r) state the
same way, under its own leaf names, metric tag and ``extra`` record.

The on-disk layout is the JAX package's (``core/checkpoint.py``), so a
checkpoint written by either package resumes under the other with
bit-identical int32 accumulators:

- one ``{leaf}.npy`` per whole leaf (``np.save`` of the leaf's dtype and
  shape; ``layout: "full"``): a replicated or variant-mode plan's
  leaves, and the scalar leaves of any plan;
- a tile2d plan's N x N leaves one file per tile,
  ``{leaf}.t{row0}_{col0}.npy`` keyed by the tile's global offsets
  (``layout: "tiles"``): no whole leaf is ever gathered on the host, and
  each tile loads back onto its own slot's device;
- ``manifest.json`` with the JAX keys: ``next_variant``, ``cursors``
  (``{"0": cursor}``), ``metric``, ``block_variants``, ``sample_hash``,
  ``n_samples``, ``leaves``, ``layout``, ``mesh_shape`` and ``mode`` (the
  plan's, ``[1, 1]`` and ``"replicated"`` on one device; None when saved
  without a plan, as the sketch solver's state is), ``process_count``
  (1), ``stream_stats``, ``extra`` and ``sha256`` (one digest per file).

A tiled checkpoint resumes only under the same mesh shape and mode
(re-tiling a partial sum is never implicit); whole leaves load under any
plan, split into tiles when the plan is tile2d.

Writes are atomic: a ``.tmp`` directory is written, then rotated into
place, and the previous generation is kept as ``.old``. ``load``
verifies every file's sha256 before any leaf reaches a device; a
corrupt latest generation falls back to ``.old``, which is promoted
back to the latest slot (the corrupt one is set aside as ``.corrupt``)
so the next rotation never destroys the only good generation. Only when
both generations fail does it raise :class:`CheckpointCorruptError`.

The JAX package's multi-process agreement rounds are not ported: a
manifest written by more than one process is refused.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings

import numpy as np
import torch

from spark_examples_tpu_torch.core import faults, meshes, telemetry
from spark_examples_tpu_torch.core.meshes import Tiled
from spark_examples_tpu_torch.core.hashing import (
    TeeHashWriter,
    sample_hash,
    sha256_file,
)


class CheckpointCorruptError(RuntimeError):
    """Every on-disk generation failed checksum verification. Raised
    (not silently ignored): restarting from zero discards work the
    operator may be able to recover; delete the checkpoint directory to
    restart deliberately."""


def _host(value) -> np.ndarray:
    """A leaf as a C-contiguous numpy array (torch tensors come off
    their device), so ``np.save`` writes the bytes the JAX package
    writes for the same values."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    # np.require, not np.ascontiguousarray: that one makes a 0-d leaf 1-d.
    return np.require(np.asarray(value), requirements="C")


def _tile_name(leaf: str, row0: int, col0: int) -> str:
    return f"{leaf}.t{row0}_{col0}.npy"


def save(path: str, acc: dict, next_variant: int, metric: str,
         block_variants: int, sample_ids: list[str],
         stream_stats: dict | None = None,
         extra: dict | None = None, plan=None) -> None:
    """Atomically persist accumulators + resume cursor.

    ``plan``: the job's ``GramPlan``, recorded in the manifest
    (``mesh_shape``, ``mode``); a :class:`~core.meshes.Tiled` leaf is
    written one file per tile.

    ``stream_stats``: the feed's stream statistics (``max_value``),
    persisted so that a resumed dot/euclidean job's int32 guard still
    sees the largest value of the whole stream.
    ``extra``: a JSON-serialisable compatibility record (the sketch
    solver stores its rung, rank and seed here); ``load`` refuses a
    checkpoint whose record differs from the job's.
    """
    with telemetry.span("checkpoint.save"):
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # Each file is hashed as it is written, before the fault site
        # fires, so an injected truncation corrupts the file against its
        # recorded digest, as a torn write would.
        checksums: dict[str, str] = {}

        def write(fname: str, value) -> None:
            host = _host(value)
            fpath = os.path.join(tmp, fname)
            with telemetry.span("checkpoint.write"):
                with open(fpath, "wb") as f:
                    tee = TeeHashWriter(f)
                    np.save(tee, host)
            telemetry.count("checkpoint.bytes_written", float(host.nbytes))
            checksums[fname] = tee.sha256.hexdigest()
            faults.fire("checkpoint.tile_write", path=fpath)

        layout: dict[str, str] = {}
        for k, v in acc.items():
            if isinstance(v, Tiled):
                layout[k] = "tiles"
                for s, tile in enumerate(v.tiles):
                    r0, _, c0, _ = v.spans(s)
                    write(_tile_name(k, r0, c0), tile)
            else:
                layout[k] = "full"
                write(f"{k}.npy", v)
        manifest = {
            "next_variant": int(next_variant),
            "cursors": {"0": int(next_variant)},
            "metric": metric,
            "block_variants": int(block_variants),
            "sample_hash": sample_hash(sample_ids),
            "n_samples": len(sample_ids),
            "leaves": sorted(acc),
            "layout": layout,
            "mesh_shape": (list(plan.mesh.shape) if plan is not None
                           else None),
            "mode": plan.mode if plan is not None else None,
            "process_count": 1,
            "stream_stats": dict(stream_stats or {}),
            "extra": dict(extra) if extra else None,
            "sha256": checksums,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # Never a window with zero good generations: the old latest
        # moves aside to .old before the new one lands, and a crash
        # mid-sequence leaves `path` or `path.old` intact.
        with telemetry.span("checkpoint.rotate"):
            old = path + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            if os.path.exists(path):
                os.replace(path, old)
            os.replace(tmp, path)


def _verify_files(path: str, manifest: dict) -> str | None:
    """Re-hash a generation's files against its manifest: a reason on
    the first unreadable or mismatched file, None when all verify. A
    manifest without a ``sha256`` map verifies vacuously."""
    with telemetry.span("checkpoint.verify"):
        sums = manifest.get("sha256")
        if not sums:
            return None
        for fname in sorted(sums):
            fpath = os.path.join(path, fname)
            try:
                faults.fire("checkpoint.tile_read", path=fpath)
                got = sha256_file(fpath)
            except OSError as e:
                return f"{fname}: unreadable ({e})"
            if got != sums[fname]:
                return f"{fname}: sha256 mismatch (truncated or corrupt)"
        return None


def _usable_generation(path: str):
    """The first generation (``path``, then ``path.old``) whose manifest
    parses and whose files verify -> (dir, manifest); None when no
    generation exists; CheckpointCorruptError when every one fails."""
    reasons: list[str] = []
    for gen in (path, path + ".old"):
        manifest_path = os.path.join(gen, "manifest.json")
        if not os.path.exists(manifest_path):
            continue
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            reasons.append(f"{gen}: manifest unreadable ({e})")
            continue
        reason = _verify_files(gen, manifest)
        if reason is not None:
            reasons.append(f"{gen}: {reason}")
            continue
        if reasons:
            warnings.warn(
                f"checkpoint integrity: {'; '.join(reasons)} — falling "
                f"back to the previous good generation at {gen}",
                RuntimeWarning,
                stacklevel=3,
            )
        return gen, manifest
    if reasons:
        raise CheckpointCorruptError(
            "no usable checkpoint generation: " + "; ".join(reasons)
            + " — recover the files or delete the checkpoint "
            "directory to deliberately restart from zero"
        )
    return None


def _promote_fallback(path: str, found):
    """When load resolved to ``.old``, move the good generation back to
    ``path`` and keep the corrupt latest aside as ``path.corrupt``:
    otherwise the next save's rotation would delete the only good
    generation and demote the corrupt one into ``.old``."""
    gen, manifest = found
    if gen == path:
        return found
    try:
        if os.path.exists(path):
            corrupt = path + ".corrupt"
            if os.path.exists(corrupt):
                shutil.rmtree(corrupt)
            os.replace(path, corrupt)
            warnings.warn(
                f"checkpoint: corrupt latest generation set aside as "
                f"{corrupt}; delete it once recovered",
                RuntimeWarning,
                stacklevel=3,
            )
        os.replace(gen, path)
    except OSError as e:
        raise CheckpointCorruptError(
            f"cannot promote fallback checkpoint generation {gen} back "
            f"to {path}: {e}"
        ) from e
    telemetry.count("checkpoint.fallback")
    return path, manifest


def _load_leaf(path: str, k: str, layout: str, manifest: dict, plan,
               device):
    """One leaf back where the plan keeps it: whole on ``device`` (slot
    0's under a plan), or one tile per slot on the slot's device."""
    n = manifest["n_samples"]
    if layout == "full":
        host = torch.from_numpy(np.load(os.path.join(path, f"{k}.npy")))
        if (plan is not None and plan.tiled and host.dim() == 2
                and tuple(host.shape) == (n, n)):
            return Tiled.from_full(plan.mesh, host)
        return host.to(device)
    if plan is None:
        raise ValueError(
            f"checkpoint at {path} holds tiled leaf {k!r} but no plan "
            "was given to place it — pass the job's GramPlan"
        )
    return Tiled(plan.mesh, (n, n), [
        torch.from_numpy(np.load(os.path.join(
            path, _tile_name(k, rows.start, cols.start)))).to(dev)
        for (rows, cols), dev in zip(meshes.tile2d(plan.mesh, n),
                                     plan.mesh.devices)])


def load(path: str, metric: str, sample_ids: list[str],
         block_variants: int | None = None,
         leaves: list[str] | None = None,
         expect_extra: dict | None = None, device="cpu", plan=None):
    """Load ``(acc, next_variant, stream_stats)``, or None when no
    checkpoint exists. ``acc`` holds torch tensors on ``device`` (slot
    0's device under ``plan``), and the tiles of a tiled leaf on their
    slots' devices.

    ``leaves``: the expected leaf names when the checkpoint is not a gram
    accumulation (the sketch solver's state); by default they derive
    from the metric's gram leaves. ``expect_extra``: the required
    ``extra`` record.

    Every file is verified before any leaf is placed on the device.
    Incompatible checkpoints (another metric, cohort, block grid, leaf
    set, ``extra``, process count, or a tile grid other than the plan's)
    are refused rather than mixed into the accumulation.
    """
    if plan is not None:
        device = plan.mesh.home
    with telemetry.span("checkpoint.load"):
        found = _usable_generation(path)
        if found is None:
            return None
        path, manifest = _promote_fallback(path, found)
        if (block_variants is not None
                and manifest["block_variants"] != block_variants):
            raise ValueError(
                f"checkpoint at {path} was written with --block-variants "
                f"{manifest['block_variants']}, job wants {block_variants}; "
                "resume must keep the same block grid"
            )
        if manifest["metric"] != metric:
            raise ValueError(
                f"checkpoint at {path} is for metric {manifest['metric']!r}, "
                f"job wants {metric!r}"
            )
        if manifest["sample_hash"] != sample_hash(sample_ids):
            raise ValueError(
                f"checkpoint at {path} was built for a different cohort "
                f"({manifest['n_samples']} samples)"
            )
        if expect_extra is not None:
            got = manifest.get("extra") or {}
            if got != dict(expect_extra):
                raise ValueError(
                    f"checkpoint at {path} was written under solver/"
                    f"sketch settings {got} but this job runs "
                    f"{dict(expect_extra)} — a resume must keep the same "
                    "--sketch-seed/--sketch-rank/--solver (delete the "
                    "checkpoint directory to deliberately restart)"
                )
        if leaves is not None:
            expected = sorted(leaves)
        else:
            from spark_examples_tpu_torch.ops import gram

            expected = sorted(gram.acc_leaves(metric))
        if manifest["leaves"] != expected:
            raise ValueError(
                f"checkpoint at {path} holds accumulator leaves "
                f"{manifest['leaves']} but this version expects {expected} "
                f"for metric {metric!r} (stale accumulator schema — delete "
                "the checkpoint to restart)"
            )
        if manifest.get("process_count", 1) != 1:
            raise ValueError(
                f"checkpoint at {path} was written by "
                f"{manifest['process_count']} processes; this job runs 1 "
                "— per-process ingest cursors do not transfer across "
                "process counts"
            )
        layout = (manifest.get("layout")
                  or {k: "full" for k in manifest["leaves"]})
        if any(v == "tiles" for v in layout.values()):
            want_mesh = list(plan.mesh.shape) if plan is not None else None
            if (plan is None
                    or manifest.get("mesh_shape") != want_mesh
                    or manifest.get("mode") != plan.mode):
                raise ValueError(
                    f"checkpoint at {path} is tiled for mesh "
                    f"{manifest.get('mesh_shape')} mode "
                    f"{manifest.get('mode')!r}; this job runs mesh "
                    f"{want_mesh} mode {getattr(plan, 'mode', None)!r} — "
                    "resume must keep the tile grid (re-tiling a partial "
                    "sum is never implicit)"
                )
        acc = {k: _load_leaf(path, k, layout.get(k, "full"), manifest, plan,
                             device)
               for k in manifest["leaves"]}
        cursors = manifest.get("cursors") or {"0": manifest["next_variant"]}
        cursor = int(cursors.get("0", manifest["next_variant"]))
        return acc, cursor, manifest.get("stream_stats", {})
