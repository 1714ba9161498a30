"""Versioned JSON sidecars: one validation ladder for on-disk catalogs.

The dataset store's ``manifest.json`` carries a ``schema_version`` and
can be unusable in a few ways: missing, unreadable or truncated JSON, a
file from before versioning, a file from a newer build, a required
field absent. Each raises the caller's error class with the cause named
(the JAX package's ``core/sidecar.py`` wording).
"""

from __future__ import annotations

import json


def load_versioned_sidecar(
    path: str,
    *,
    current_version: int,
    required: tuple,
    error_cls: type,
    noun: str,
    missing_msg: str,
    repair: str,
) -> dict:
    """Load and validate a versioned JSON sidecar, raising ``error_cls``
    with the cause named on every unusable file.

    ``noun`` names the file in errors (e.g. "store manifest");
    ``missing_msg`` is the whole FileNotFoundError message; ``repair``
    is the recovery phrase (e.g. "re-run the compaction"). Returns the
    parsed dict with ``schema_version`` present, an int, and <= current.
    """
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        raise error_cls(missing_msg) from None
    except (OSError, ValueError) as e:
        raise error_cls(
            f"{noun} {path!r} is unreadable ({e}) — truncated or "
            f"corrupt? {repair}"
        ) from None
    if "schema_version" not in raw:
        raise error_cls(
            f"{noun} {path!r} has no 'schema_version' field — written "
            f"by a pre-versioning build; {repair} to upgrade"
        )
    version = int(raw["schema_version"])
    raw["schema_version"] = version
    if version > current_version:
        raise error_cls(
            f"{noun} {path!r} has schema_version {version}, newer than "
            f"this build's {current_version} — upgrade the code or "
            f"{repair} with this version"
        )
    missing = [k for k in required if k not in raw]
    if missing:
        raise error_cls(
            f"{noun} {path!r} (schema_version {version}) is missing "
            f"required field(s) {missing} — truncated or hand-edited? "
            f"{repair}"
        )
    return raw
