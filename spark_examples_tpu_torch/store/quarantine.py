"""Quarantine bookkeeping: the store's append-only corruption ledger.

``quarantine.json`` is the operator-facing record of every chunk whose
bytes stopped matching their content address. It is written by readers
(possibly several readahead workers at once, possibly several processes
sharing the store directory), read by the healer, and trimmed when a
chunk is healed — so the file discipline matters more than the format:

- **Atomic.** Every write lands via tmp + ``os.replace`` (the tmp name
  carries pid + thread id, so concurrent writers never collide on it);
  a reader can never observe a torn ledger.
- **Idempotent.** Entries are keyed by chunk digest: two readahead
  workers quarantining the same chunk in the same millisecond produce
  ONE entry, and re-quarantining an already-recorded chunk is a no-op.
- **Locked in-process.** A process-wide lock per (realpath'd) store
  root serializes the read-modify-write, so concurrent in-process
  writers cannot lose each other's updates. Cross-process writers are
  protected by the rename atomicity (last writer wins on the FILE, but
  each writer re-reads first, so a lost update needs two processes
  racing within one read-modify-write window — and the healer re-checks
  the chunk bytes themselves, never trusting the ledger alone).
"""

from __future__ import annotations

import json
import os
import threading
import warnings

from spark_examples_tpu_torch.store.manifest import QUARANTINE_NAME

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock_for(root: str) -> threading.Lock:
    key = os.path.realpath(root)
    with _locks_guard:
        lock = _locks.get(key)
        if lock is None:
            lock = _locks[key] = threading.Lock()
        return lock


def _path(root: str) -> str:
    return os.path.join(root, QUARANTINE_NAME)


def load(root: str) -> list[dict]:
    """The current ledger ([] when absent or unreadable — a torn ledger
    must never block the read path that is trying to report damage)."""
    try:
        with open(_path(root)) as f:
            entries = json.load(f)
        return entries if isinstance(entries, list) else []
    except (OSError, ValueError):
        return []


def _write(root: str, entries: list[dict]) -> None:
    qpath = _path(root)
    tmp = qpath + f".tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(entries, f)
    os.replace(tmp, qpath)


def record(root: str, entry: dict) -> bool:
    """Append ``entry`` unless its digest is already recorded. Returns
    True when the ledger changed. Never raises: a full disk must not
    mask the corruption error the caller is about to raise."""
    with _lock_for(root):
        try:
            entries = load(root)
            if any(e.get("digest") == entry.get("digest") for e in entries):
                return False
            entries.append(entry)
            _write(root, entries)
            return True
        except OSError as e:
            warnings.warn(
                f"store: could not record quarantined chunk in "
                f"{_path(root)} ({e}) — the corruption error still "
                "stands",
                RuntimeWarning, stacklevel=3,
            )
            return False


def remove(root: str, digest: str) -> bool:
    """Drop the entry for ``digest`` (a healed chunk). Returns True when
    an entry was removed."""
    with _lock_for(root):
        try:
            entries = load(root)
            kept = [e for e in entries if e.get("digest") != digest]
            if len(kept) == len(entries):
                return False
            if kept:
                _write(root, kept)
            else:
                # An empty ledger is represented by NO file (the healthy
                # state a fresh store starts in).
                try:
                    os.remove(_path(root))
                except FileNotFoundError:
                    pass
            return True
        except OSError as e:
            warnings.warn(
                f"store: could not update quarantine ledger at "
                f"{_path(root)} ({e})",
                RuntimeWarning, stacklevel=3,
            )
            return False
