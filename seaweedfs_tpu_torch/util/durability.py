"""Durability: one barrier for every storage commit point.

The port's copy of ``seaweedfs_tpu/util/durability.py``, at its default
``commit`` policy. Every commit point of the volume engine calls one of
three helpers:

- :func:`barrier` — "this write is a commit point": flush + fsync, so an
  acknowledged write survives power loss.
- :func:`fsync_dir` — persist a directory entry (required after any
  rename/create/unlink that must survive power loss; fsyncing the file
  alone does NOT persist its name on most filesystems).
- :func:`durable_replace` — the full rename-commit idiom: fsync the
  source file, ``os.replace`` it into place, fsync the destination's
  parent directory.

Not ported yet: the ``batch`` and ``off`` policies with ``configure``,
``drain``, ``configure_from`` (the ``[storage]`` TOML block) and
``debug_payload``; they come with the volume server, the only reader
of the ``[storage]`` section (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import os
from pathlib import Path


def barrier(f) -> None:
    """Commit barrier on an open file: ``f`` is either a file object
    (flushed first) or a raw fd; flush, then fsync."""
    if hasattr(f, "flush"):
        f.flush()
        fd = f.fileno()
    else:
        fd = f
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

