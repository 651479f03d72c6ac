"""The volume engine's .dat file (weed/storage/backend analog).

The port's copy of the local-disk part of
``seaweedfs_tpu/storage/backend.py``. Not ported yet (ROADMAP Queue 1):
the ``mmap`` read path and the backend registry that selects it, which
come with the volume server's ``-backend`` flag and ``[storage]``
section that set them, and the S3 cold tier.

Concurrency contract: ``read_at`` may be called from many threads
concurrently with one appender (it uses positionless pread); mutations
(``write_at``/``truncate``/``flush``/``sync``) are serialized by the
Volume's lock.
"""

from __future__ import annotations

import os
from pathlib import Path


class DiskFile:
    """Plain local file (backend/disk_file.go). Offsets are absolute
    file offsets."""

    def __init__(self, path: str | Path, create: bool = False):
        self.name = str(path)
        mode = "w+b" if create else "r+b"
        self._f = open(self.name, mode)
        self._size = os.fstat(self._f.fileno()).st_size

    def read_at(self, size: int, offset: int) -> bytes:
        return os.pread(self._f.fileno(), size, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        n = os.pwrite(self._f.fileno(), data, offset)
        self._size = max(self._size, offset + n)
        return n

    def append(self, data: bytes) -> int:
        """Append; returns the offset the data landed at."""
        off = self._size
        self.write_at(data, off)
        return off

    def size(self) -> int:
        return self._size

    def truncate(self, size: int) -> None:
        self._f.truncate(size)
        self._size = size

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()

    def fileno(self) -> int:
        return self._f.fileno()
