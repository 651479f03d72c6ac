"""On-disk cache tier: append-only needle-layer files + in-memory index.

Mirrors weed/util/chunk_cache's on_disk_cache_layer: a fixed ring of
``cache_<i>.dat`` segment files, each an append-only log of
``[header][key][payload]`` records, with the key -> (segment, offset,
size) map held only in memory. Filling the active segment rotates to the
next slot, truncating whatever generation lived there — eviction is
whole-segment, so the tier needs no per-record free-space bookkeeping.

Crash restart: the index is rebuilt by scanning every segment file
(oldest mtime first, so the newest record for a key wins) and the active
segment's torn tail — a record cut mid-write — is truncated away.

Hot-forward compaction (docs/workloads.md): rotation used to drop a
whole generation — including records still taking hits. With
``compaction=True`` (the default), rotating into a segment first copies
its still-hot records (``hits >= hot_min_hits`` since they last
survived, unexpired) forward into the fresh segment, hottest first, up
to half the segment so rotation still reclaims space. Copied records
have their heat reset — surviving the NEXT rotation requires being hit
again, so a once-hot key cannot ride forward forever. Emits
``seaweed_compaction_{segments,bytes_copied,bytes_dropped}_total``.

The port of ``seaweedfs_tpu/cache/disk_tier.py``, whole.
"""

from __future__ import annotations

import struct
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

from ..util import durability, faults
from .readahead import METRICS as _SEAWEED_METRICS

#: magic(1) flags(1) key_len(2) volume(4) data_len(4) expires_epoch(8)
_HEADER = struct.Struct(">BBHId")
_MAGIC = 0xC5
#: One record may not claim more than this fraction of a segment, or a
#: single giant put would wipe a whole generation for one entry.
_MAX_RECORD_FRACTION = 0.5
#: Compaction may fill at most this fraction of the fresh segment with
#: carried-forward hot records — rotation must still free space.
_COMPACT_MAX_FRACTION = 0.5

_M_COMPACT_SEGMENTS = _SEAWEED_METRICS.counter(
    "compaction_segments_total")
_M_COMPACT_COPIED = _SEAWEED_METRICS.counter(
    "compaction_bytes_copied_total")
_M_COMPACT_DROPPED = _SEAWEED_METRICS.counter(
    "compaction_bytes_dropped_total")


class _IndexEntry:
    __slots__ = ("segment", "offset", "size", "volume", "expires",
                 "hits", "last_access")

    def __init__(self, segment: int, offset: int, size: int,
                 volume: Optional[int], expires: float):
        self.segment = segment
        self.offset = offset
        self.size = size
        self.volume = volume
        self.expires = expires
        #: read hits since this record was written (or last carried
        #: forward) — the compaction heat signal
        self.hits = 0
        self.last_access = 0.0


class DiskTier:
    """Thread-safe; callers may also hold their own lock above it."""

    def __init__(self, directory: str | Path,
                 capacity_bytes: int = 256 * 1024 * 1024,
                 segments: int = 4, clock=time.time,
                 compaction: bool = True, hot_min_hits: int = 1):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segments = max(2, int(segments))
        self.segment_cap = max(4096, int(capacity_bytes) // self.segments)
        self.clock = clock
        self.compaction = bool(compaction)
        self.hot_min_hits = max(1, int(hot_min_hits))
        self._lock = threading.RLock()
        self._index: dict[str, _IndexEntry] = {}
        self._sizes = [0] * self.segments
        self._fh: list = [None] * self.segments
        self._active = 0
        self.evictions = 0
        self.compactions = 0
        self.compaction_bytes_copied = 0
        self.compaction_bytes_dropped = 0
        self._load()

    # ------------- segment files -------------

    def _seg_path(self, i: int) -> Path:
        return self.dir / f"cache_{i}.dat"

    def _file(self, i: int):
        if self._fh[i] is None:
            p = self._seg_path(i)
            p.touch(exist_ok=True)
            self._fh[i] = open(p, "r+b")
        return self._fh[i]

    def close(self) -> None:
        with self._lock:
            for i, f in enumerate(self._fh):
                if f is not None:
                    f.close()
                    self._fh[i] = None

    # ------------- load / scan -------------

    def _load(self) -> None:
        present = [(self._seg_path(i).stat().st_mtime, i)
                   for i in range(self.segments)
                   if self._seg_path(i).exists()]
        # Oldest first: a key rewritten in a newer generation overwrites
        # its stale index entry during the replay.
        for _, i in sorted(present):
            self._sizes[i] = self._scan_segment(i)
        if present:
            self._active = sorted(present)[-1][1]

    def _scan_segment(self, i: int) -> int:
        """Replay one segment into the index; returns the byte length of
        the valid prefix (a torn tail is truncated off)."""
        f = self._file(i)
        f.seek(0, 2)
        end = f.tell()
        f.seek(0)
        pos = 0
        while pos + _HEADER.size <= end:
            hdr = f.read(_HEADER.size)
            if len(hdr) < _HEADER.size:
                break
            magic, _flags, key_len, vol, expires = _HEADER.unpack(hdr)
            if magic != _MAGIC:
                break
            size_raw = f.read(4)
            if len(size_raw) < 4:
                break
            size = int.from_bytes(size_raw, "big")
            if pos + _HEADER.size + 4 + key_len + size > end:
                break  # torn tail
            key = f.read(key_len).decode("utf-8", "replace")
            data_off = f.tell()
            f.seek(size, 1)
            self._index[key] = _IndexEntry(
                i, data_off, size, vol or None, expires)
            pos = data_off + size
        if pos < end:
            f.truncate(pos)
        return pos

    # ------------- api -------------

    def admit(self, size: int) -> bool:
        return size <= int(self.segment_cap * _MAX_RECORD_FRACTION)

    def put(self, key: str, data: bytes, volume: Optional[int] = None,
            expires: float = 0.0) -> int:
        """Append one record; returns how many entries rotation evicted."""
        kb = key.encode("utf-8")
        rec_len = _HEADER.size + 4 + len(kb) + len(data)
        if not self.admit(len(data)):
            return 0
        evicted = 0
        with self._lock:
            if self._sizes[self._active] + rec_len > self.segment_cap:
                # seaweedlint: disable=SW103 — sleep only via an armed test-harness delay fault at the crashpoint, never in production
                evicted = self._rotate()
            # seaweedlint: disable=SW103 — the tier lock's whole job is serializing this cache file; the append must see the post-rotation handle
            self._append_locked(key, kb, data, volume, float(expires))
        return evicted

    def _append_locked(self, key: str, kb: bytes, data: bytes,
                       volume: Optional[int], expires: float) -> None:
        """Append one record to the active segment (caller locks)."""
        i = self._active
        f = self._file(i)
        f.seek(self._sizes[i])
        f.write(_HEADER.pack(_MAGIC, 0, len(kb), volume or 0, expires))
        f.write(len(data).to_bytes(4, "big"))
        f.write(kb)
        data_off = self._sizes[i] + _HEADER.size + 4 + len(kb)
        f.write(data)
        faults.check("crash.disktier.append")
        # commit barrier ([storage] fsync policy): a flushed-not-synced
        # record a restart scan finds could be a torn lie after power
        # loss; the scan's tail-truncation handles the un-synced case,
        # but the barrier bounds how much cached data a crash sheds
        durability.barrier(f, _HEADER.size + 4 + len(kb) + len(data))
        self._sizes[i] += _HEADER.size + 4 + len(kb) + len(data)
        self._index[key] = _IndexEntry(i, data_off, len(data),
                                       volume, expires)

    def _rotate(self) -> int:
        nxt = (self._active + 1) % self.segments
        doomed = [(k, e) for k, e in self._index.items()
                  if e.segment == nxt]
        # hot-forward compaction: read the victim generation's
        # still-hot records BEFORE truncating it, hottest first, under
        # a byte budget that keeps rotation freeing space
        survivors: list[tuple[str, bytes, _IndexEntry]] = []
        if self.compaction and doomed:
            now = self.clock()
            budget = int(self.segment_cap * _COMPACT_MAX_FRACTION)
            hot = sorted(
                (pair for pair in doomed
                 if pair[1].hits >= self.hot_min_hits
                 and not (pair[1].expires and now > pair[1].expires)),
                key=lambda p: (-p[1].hits, -p[1].last_access))
            f = self._file(nxt)
            used = 0
            for k, e in hot:
                rec_len = _HEADER.size + 4 + len(k.encode("utf-8")) \
                    + e.size
                if used + rec_len > budget:
                    break
                f.seek(e.offset)
                data = f.read(e.size)
                if len(data) == e.size:
                    survivors.append((k, data, e))
                    used += rec_len
        kept = {k for k, _, _ in survivors}
        dead = 0
        dropped_bytes = 0
        for k, e in doomed:
            del self._index[k]
            if k not in kept:
                dead += 1
                dropped_bytes += e.size
        self.evictions += dead
        f = self._file(nxt)
        f.truncate(0)
        self._sizes[nxt] = 0
        self._active = nxt
        copied_bytes = 0
        for k, data, e in survivors:
            self._append_locked(k, k.encode("utf-8"), data, e.volume,
                                e.expires)
            copied_bytes += len(data)
            # heat resets: surviving the NEXT rotation requires fresh
            # hits, so a once-hot record cannot ride forward forever
        if self.compaction:
            self.compactions += 1
            self.compaction_bytes_copied += copied_bytes
            self.compaction_bytes_dropped += dropped_bytes
            _M_COMPACT_SEGMENTS.inc()
            if copied_bytes:
                _M_COMPACT_COPIED.inc(copied_bytes)
            if dropped_bytes:
                _M_COMPACT_DROPPED.inc(dropped_bytes)
        return dead

    def get(self, key: str
            ) -> Optional[tuple[bytes, Optional[int], float]]:
        """(payload, volume, expires) or None (missing/expired)."""
        with self._lock:
            e = self._index.get(key)
            if e is None:
                return None
            if e.expires and self.clock() > e.expires:
                del self._index[key]
                return None
            f = self._file(e.segment)
            f.seek(e.offset)
            data = f.read(e.size)
            if len(data) != e.size:
                del self._index[key]
                return None
            e.hits += 1
            e.last_access = self.clock()
            return data, e.volume, e.expires

    def remove(self, key: str) -> bool:
        """Drop from the index only; bytes are reclaimed at rotation."""
        with self._lock:
            return self._index.pop(key, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._index.clear()
            for i in range(self.segments):
                if self._seg_path(i).exists():
                    self._file(i).truncate(0)
                self._sizes[i] = 0
            self._active = 0

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._index

    def keys_with_volumes(self) -> Iterator[tuple[str, Optional[int]]]:
        with self._lock:
            items = [(k, e.volume) for k, e in self._index.items()]
        return iter(items)

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def bytes(self) -> int:
        with self._lock:
            return sum(e.size for e in self._index.values())
