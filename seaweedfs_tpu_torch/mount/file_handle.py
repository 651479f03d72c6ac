"""Open-file state for the mount layer: chunk reads + chunked flush.

The port of ``seaweedfs_tpu/mount/file_handle.py``, whole, with one
repair: the JAX flush uploads a chunk without the mount's collection,
so a mount with ``-collection`` assigns a fid in that collection and
then has its upload refused ("volume N not found"); here the upload
names the collection.

Mirrors weed/mount's FileHandle: an open
file carries a snapshot of the entry's chunk list, a dirty-page cache
for writes, and a small LRU of fetched chunks for reads. ``flush``
uploads every dirty interval as fresh chunks (assign fid -> POST to the
volume server -> append FileChunk) and saves the entry through the
filer — the chunk-overlay read path (filer/filechunks.py
visible_intervals, later-mtime wins) makes partial overwrites correct
without read-modify-write.
"""

from __future__ import annotations

import threading
import time

from ..cache import ChunkCache  # noqa: F401 — re-export; the mount
# package's cache is the shared tiered implementation (SLRU +
# admission + TTL + optional disk tier, cache/).
from ..cluster import operation
from ..filer.entry import FileChunk
from .pages import DirtyPages, ReadPages

#: Flush a handle automatically once this much dirty data accumulates
#: (weed mount's writeback threshold role).
MAX_DIRTY_BYTES = 16 * 1024 * 1024
#: Cap one uploaded chunk (large sequential writes split into several).
CHUNK_SIZE = 4 * 1024 * 1024


class FileHandle:
    """One open() of a file. Not itself thread-safe for interleaved
    writes from many threads to the SAME handle beyond the internal
    lock; the kernel serializes per-handle ops in real FUSE."""

    def __init__(self, wfs, path: str, entry, flags: int = 0):
        self.wfs = wfs
        self.path = path
        self.entry = entry  # filer_pb2.Entry snapshot (mutated locally)
        self.flags = flags
        self.pages = DirtyPages()
        self.read_pages = ReadPages()
        self._lock = threading.RLock()
        self._size = max(
            entry.attributes.file_size,
            max((c.offset + c.size for c in entry.chunks), default=0))

    # ------------- geometry -------------

    @property
    def size(self) -> int:
        with self._lock:
            return max(self._size, self.pages.max_stop)

    # ------------- read -------------

    def read(self, offset: int, length: int) -> bytes:
        with self._lock:
            end = min(offset + length, self.size)
            if end <= offset:
                return b""
            buf = bytearray(self.read_pages.read(
                offset, end - offset, self._read_clean,
                size=self._size))
            self.pages.overlay(offset, buf)
            return bytes(buf)

    def _read_clean(self, offset: int, length: int) -> bytes:
        """Flushed-chunk bytes only (no dirty overlay) — the fetch
        callback behind ``read_pages``. Also called from the shared
        prefetch pool, so the chunk-list snapshot takes the handle
        lock (reentrant from the foreground path); the chunk fetches
        themselves run unlocked so prefetch never stalls a writer."""
        buf = bytearray(length)
        with self._lock:
            chunks = [FileChunk(file_id=c.file_id, offset=c.offset,
                                size=c.size, mtime_ns=c.mtime_ns)
                      for c in self.entry.chunks]
        from ..filer.filechunks import read_plan
        for piece in read_plan(chunks, offset, length):
            blob = self.wfs._fetch_chunk(piece.file_id)
            seg = blob[piece.chunk_offset:
                       piece.chunk_offset + piece.length]
            buf[piece.buffer_offset:
                piece.buffer_offset + len(seg)] = seg
        return bytes(buf)

    # ------------- write -------------

    def write(self, offset: int, data: bytes) -> int:
        # The handle lock serializes all ops on ONE open file (the
        # reference weed/mount design); the spill-flush upload below
        # blocks only this file's own ops, never another handle's.
        # seaweedlint: disable=SW103 — per-file upload serialization
        with self._lock:
            self.pages.write(offset, data)
            self.read_pages.invalidate(offset, len(data))
            self._size = max(self._size, offset + len(data))
            if self.pages.dirty_bytes >= MAX_DIRTY_BYTES:
                self.flush()
            return len(data)

    def truncate(self, size: int) -> None:
        # seaweedlint: disable=SW103 — per-file metadata rpc; see write
        with self._lock:
            self.pages.truncate(size)
            self.read_pages.invalidate()
            if size < self._size or size < self.size:
                # Shrink: drop shadowed chunk ranges entirely when the
                # chunk lies wholly past the cut; clip the logical size.
                kept = [c for c in self.entry.chunks if c.offset < size]
                del self.entry.chunks[:]
                for c in kept:
                    nc = self.entry.chunks.add()
                    nc.CopyFrom(c)
                    if nc.offset + nc.size > size:
                        nc.size = size - nc.offset
            self._size = size
            self.entry.attributes.file_size = size
            self.wfs._save_entry(self.path, self.entry)

    # ------------- flush (the chunked upload) -------------

    def flush(self) -> None:
        # Only this handle's own ops wait on the upload; see write().
        # seaweedlint: disable=SW103 — per-file upload serialization
        with self._lock:
            intervals = self.pages.pop_all()
            if not intervals and \
                    self.entry.attributes.file_size == self.size:
                return
            now_ns = time.time_ns()
            for iv in intervals:
                pos = 0
                while pos < len(iv.data):
                    piece = bytes(iv.data[pos:pos + CHUNK_SIZE])
                    fid, url, auth = self.wfs._assign()
                    # the volume is the mount's collection's: a server
                    # finds it by (collection, id)
                    operation.upload(url, fid, piece, jwt=auth,
                                     collection=self.wfs.collection)
                    self.entry.chunks.add(
                        file_id=fid, offset=iv.start + pos,
                        size=len(piece), mtime_ns=now_ns)
                    pos += len(piece)
            self.entry.attributes.file_size = self.size
            self.entry.attributes.mtime = int(time.time())
            self.wfs._save_entry(self.path, self.entry)

    def release(self) -> None:
        self.flush()
        self.read_pages.close()
