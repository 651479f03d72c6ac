"""Needle-id sequencer.

The port of ``seaweedfs_tpu/cluster/sequence.py``, whole. Mirrors
weed/sequence/ (SURVEY.md §2 "Sequencer"): the master hands out
monotonically increasing needle keys in batches. ``peek`` / ``next_batch``
match MemorySequencer's surface; persistence is a tiny text file so a
restarted master never reissues ids (the reference persists via its
sequence file / raft snapshot).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional


class MemorySequencer:
    def __init__(self, start: int = 1,
                 persist_path: Optional[str | Path] = None,
                 checkpoint_every: int = 10000):
        self._lock = threading.Lock()
        self._persist = Path(persist_path) if persist_path else None
        self._checkpoint_every = checkpoint_every
        if self._persist and self._persist.exists():
            # Resume past the last checkpoint; over-skipping is safe,
            # reissuing is not.
            start = max(start,
                        int(self._persist.read_text().strip() or 0)
                        + checkpoint_every)
        self._next = start
        self._checkpoint()

    def _checkpoint(self) -> None:
        if self._persist:
            tmp = self._persist.with_suffix(".tmp")
            tmp.write_text(str(self._next))
            tmp.replace(self._persist)

    def next_batch(self, count: int = 1) -> int:
        """Reserve ``count`` ids; returns the first."""
        if count < 1:
            raise ValueError("count must be >= 1")
        with self._lock:
            first = self._next
            self._next += count
            if self._persist and (
                    first // self._checkpoint_every
                    != self._next // self._checkpoint_every):
                self._checkpoint()
            return first

    def peek(self) -> int:
        with self._lock:
            return self._next

    def set_max(self, seen: int) -> None:
        """Bump past an id observed elsewhere (heartbeat max_file_key).
        Checkpoints immediately: observed ids exist in the cluster, so a
        restart must not fall back below them."""
        with self._lock:
            if seen >= self._next:
                self._next = seen + 1
                self._checkpoint()
