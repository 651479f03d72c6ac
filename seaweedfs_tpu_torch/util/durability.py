"""Durability policy: one barrier for every storage commit point.

The port's copy of ``seaweedfs_tpu/util/durability.py``. Every commit
point of the volume engine calls one of three helpers, and the policy
lives in a single ``[storage]`` TOML block, which the volume server's
``-config`` applies (the offline shell never reads it, so it always
runs under the default):

- :func:`barrier` — "this write is a commit point": flush + fsync under
  the ``commit`` policy, accumulate-and-batch under ``batch``, flush
  only under ``off``.
- :func:`fsync_dir` — persist a directory entry (required after any
  rename/create/unlink that must survive power loss; fsyncing the file
  alone does NOT persist its name on most filesystems).
- :func:`durable_replace` — the full rename-commit idiom: fsync the
  source file, ``os.replace`` it into place, fsync the destination's
  parent directory.

Policy (``[storage] fsync``):

- ``commit`` (default): every barrier fsyncs. An acknowledged write is
  durable — the invariant the crash-recovery tests assert.
- ``batch``: barriers accumulate per-fd byte counts and fsync when
  ``fsync_batch_bytes`` accumulate or ``fsync_batch_seconds`` elapse.
  Bounded-loss mode for ingest-heavy deployments.
- ``off``: flush to the OS only: crash-safe against process death, not
  against power loss.

``durable_replace``/``fsync_dir`` always run regardless of policy —
rename commit points are rare and cheap relative to what they protect
(a vacuum's whole compacted volume, a shard copied from a peer).
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import Optional

MODES = ("commit", "batch", "off")

_LOCK = threading.Lock()
_MODE = "commit"
_BATCH_BYTES = 8 * 1024 * 1024
_BATCH_SECONDS = 1.0
#: fd -> [accumulated bytes, last fsync monotonic time] (batch mode).
_PENDING: dict[int, list] = {}


def configure(mode: Optional[str] = None,
              batch_bytes: Optional[int] = None,
              batch_seconds: Optional[float] = None) -> None:
    global _MODE, _BATCH_BYTES, _BATCH_SECONDS
    with _LOCK:
        if mode is not None:
            if mode not in MODES:
                raise ValueError(
                    f"unknown fsync mode {mode!r}; have "
                    f"{', '.join(MODES)}")
            _MODE = mode
        if batch_bytes is not None:
            _BATCH_BYTES = int(batch_bytes)
        if batch_seconds is not None:
            _BATCH_SECONDS = float(batch_seconds)
        if mode is not None:
            _PENDING.clear()


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[storage]`` block."""
    from . import config as config_mod
    configure(
        mode=config_mod.lookup(conf, "storage.fsync"),
        batch_bytes=config_mod.lookup(conf, "storage.fsync_batch_bytes"),
        batch_seconds=config_mod.lookup(
            conf, "storage.fsync_batch_seconds"))


def mode() -> str:
    return _MODE


def barrier(f, nbytes: int = 0) -> None:
    """Commit barrier on an open file. ``f`` is either a file object
    (flushed first) or a raw fd. Under ``commit`` this fsyncs; under
    ``batch`` it fsyncs once the per-fd byte/age budget is spent;
    under ``off`` it only flushes."""
    if hasattr(f, "flush"):
        f.flush()
        fd = f.fileno()
    else:
        fd = f
    if _MODE == "off":
        return
    if _MODE == "commit":
        os.fsync(fd)
        return
    now = time.monotonic()
    with _LOCK:
        acc = _PENDING.setdefault(fd, [0, now])
        acc[0] += max(0, int(nbytes))
        due = (acc[0] >= _BATCH_BYTES
               or now - acc[1] >= _BATCH_SECONDS)
        if due:
            _PENDING.pop(fd, None)
    if due:
        os.fsync(fd)


def fsync_dir(path: str | Path) -> None:
    """Persist a directory's entries after a rename/create/unlink in
    it. Directories cannot be opened for writing; O_RDONLY is the
    portable fsync handle. Platforms whose directory handles refuse
    fsync (some network filesystems) degrade to a no-op."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        try:
            os.fsync(fd)
        except OSError:  # some network filesystems refuse it
            pass
    finally:
        os.close(fd)


def durable_replace(src: str | Path, dst: str | Path,
                    fsync_src: bool = True) -> None:
    """Atomically rename ``src`` over ``dst`` such that the rename —
    and the bytes it publishes — survive power loss: fsync the source
    file's contents, rename, then fsync the destination's parent
    directory (the rename itself lives in the directory, not the
    file)."""
    src, dst = str(src), str(dst)
    if fsync_src:
        fd = os.open(src, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(src, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)) or ".")


def debug_payload() -> dict:
    """The ``durability`` section of ``/debug/vars``."""
    with _LOCK:
        return {"mode": _MODE, "batch_bytes": _BATCH_BYTES,
                "batch_seconds": _BATCH_SECONDS,
                "pending_fds": len(_PENDING)}
