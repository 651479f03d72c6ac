"""Volume-file backend abstraction (weed/storage/backend analog).

The port's copy of ``seaweedfs_tpu/storage/backend.py``
(``BackendStorageFile``): the volume engine talks to its ``.dat``
through this seam, so a local file and an mmap read path are
interchangeable without touching volume.py. The volume server's
``-backend`` flag picks one by name from :data:`BACKENDS`. The ``s3``
kind (the cold tier) is not ported yet: it waits for the S3 gateway
(ROADMAP Queue 1), and asking for it raises :class:`BackendNotPorted`.

Concurrency contract: ``read_at`` may be called from many threads
concurrently with one appender (it uses positionless pread); mutations
(``write_at``/``truncate``/``flush``/``sync``) are serialized by the
Volume's lock.
"""

from __future__ import annotations

import mmap
import os
from pathlib import Path
from typing import Callable


class BackendStorageFile:
    """One volume data file. Offsets are absolute file offsets."""

    name: str

    def read_at(self, size: int, offset: int) -> bytes:
        raise NotImplementedError

    def write_at(self, data: bytes, offset: int) -> int:
        """Write ``data`` at ``offset``; returns bytes written."""
        raise NotImplementedError

    def append(self, data: bytes) -> int:
        """Append; returns the offset the data landed at."""
        off = self.size()
        self.write_at(data, off)
        return off

    def size(self) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class DiskFile(BackendStorageFile):
    """Plain local file (backend/disk_file.go)."""

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


class MmapFile(DiskFile):
    """Disk file whose reads go through a shared read-only mmap —
    cheaper for hot random reads (backend's mmap option). Writes go to
    the file; the mapping is refreshed when a read crosses the mapped
    frontier."""

    def __init__(self, path: str | Path, create: bool = False):
        super().__init__(path, create)
        self._map: mmap.mmap | None = None
        self._mapped = 0
        self._remap()

    def _remap(self) -> None:
        # Concurrent readers may hold a reference to the outgoing map
        # mid-slice, so it is REPLACED, never closed here — the GC
        # closes it once the last reader drops it. Publish the map
        # before its length so a racing reader sees a map at least as
        # long as the length it reads.
        mapped = os.fstat(self.fileno()).st_size
        new_map = mmap.mmap(self.fileno(), mapped,
                            prot=mmap.PROT_READ) if mapped else None
        self._map = new_map
        self._mapped = mapped

    def read_at(self, size: int, offset: int) -> bytes:
        mp, mapped = self._map, self._mapped
        end = offset + size
        if end > mapped:
            self.flush()
            self._remap()
            mp, mapped = self._map, self._mapped
        if mp is None or end > mapped:
            return super().read_at(size, offset)
        return mp[offset:min(end, mapped)]

    def truncate(self, size: int) -> None:
        self._map = None
        self._mapped = 0
        super().truncate(size)
        self._remap()

    def close(self) -> None:
        self._map = None  # GC closes once readers drain
        super().close()


class BackendNotPorted(ValueError):
    """A backend kind the JAX package has and the port does not yet."""


def _s3_factory(path, create: bool = False) -> BackendStorageFile:
    raise BackendNotPorted(
        "backend 's3' (the S3 cold tier) is not ported yet: it comes "
        "with the S3 gateway (ROADMAP Queue 1)")


def check_kind(kind: str) -> None:
    """Raise what :func:`open_backend` would for ``kind`` (an unknown
    kind, or one not ported yet) without opening anything."""
    if kind not in BACKENDS:
        raise ValueError(f"unknown backend {kind!r}; "
                         f"have {sorted(BACKENDS)}")
    if BACKENDS[kind] is _s3_factory:
        _s3_factory("")


#: name -> factory(path, create) registry (the -backend flag surface).
#: "s3" is the JAX package's cold tier, which the port refuses.
BACKENDS: dict[str, Callable[..., BackendStorageFile]] = {
    "disk": DiskFile,
    "mmap": MmapFile,
    "s3": _s3_factory,
}


def open_backend(kind: str, path: str | Path,
                 create: bool = False) -> BackendStorageFile:
    try:
        factory = BACKENDS[kind]
    except KeyError:
        raise ValueError(f"unknown backend {kind!r}; "
                         f"have {sorted(BACKENDS)}") from None
    return factory(path, create=create)
