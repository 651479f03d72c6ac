"""Append-only volume files: .dat + .idx lifecycle.

The port of ``seaweedfs_tpu/storage/volume.py`` (weed/storage/
volume.go, volume_read_write.go, volume_loading.go): a volume is an
append-only .dat file opened with an 8-byte superblock, needle records
appended 8-byte aligned, and a parallel .idx journal recording (key,
offset, size) per write plus tombstones per delete. Loading replays the
.idx into a CompactMap; reads seek straight to the needle (the Haystack
O(1)-seek property).

The ``.dat`` goes through a named backend (storage/backend.py:
``disk`` or ``mmap``) and the index through a named needle map:
``memory`` (CompactMap), ``native`` (the C++ table, which falls back to
``memory`` with one warning where ``g++`` is missing, as in the JAX
package) or ``sqlite`` (a ``<base>.sdx`` beside the volume); the volume
server's ``-backend`` and ``-index`` flags pick them. Compaction lives
in storage/vacuum.py and swaps the files under the same reader drain
that ``close`` uses. A volume with a ``.tier`` sidecar (storage/tier.py)
reads its .dat through the ``s3`` backend when no local copy is left,
and is read-only either way; ``retier`` swaps the backend under the same
reader drain after a tier move.

Also hosts the synthetic volume writers used by tests and
``chip_smoke.py`` (the reference's ec_test.go builds its fixture volume
the same way).
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..util import durability, faults
from . import backend as backend_mod
from . import needle as needle_mod
from .idx import CompactMap, IndexEntry, walk_index_blob
from .superblock import ReplicaPlacement, SuperBlock
from .types import (NEEDLE_MAP_ENTRY_SIZE, NEEDLE_PADDING_SIZE,
                    TOMBSTONE_FILE_SIZE, to_offset_units)

#: The needle map kinds (``Volume(needle_map=)``, ``Store(needle_map=)``).
NEEDLE_MAPS = ("memory", "native", "sqlite")

_log = logging.getLogger(__name__)
#: Set once the native map's fallback has been reported: the warning is
#: printed once per process, not once per volume.
_native_fallback_warned = False


class VolumeError(RuntimeError):
    pass


def dat_path(base: str | Path) -> Path:
    return Path(str(base) + ".dat")


def idx_path(base: str | Path) -> Path:
    return Path(str(base) + ".idx")


def tier_path(base: str | Path) -> Path:
    """The S3-tier sidecar (storage/tier.py): its presence means the
    durable copy of the .dat lives on the tier."""
    return Path(str(base) + ".tier")


class Volume:
    """A single writable/readable volume addressed by its base path
    (``<dir>/<collection_>?<vid>`` without extension).

    ``backend`` selects the .dat storage implementation by name
    (storage/backend.py :data:`~.backend.BACKENDS`: "disk", "mmap"; a
    tiered volume takes "s3" by itself);
    ``needle_map`` selects the index implementation
    (:data:`NEEDLE_MAPS`)."""

    def __init__(self, base: str | Path, volume_id: int = 0,
                 super_block: Optional[SuperBlock] = None,
                 backend: str = "disk", needle_map: str = "memory"):
        try:
            backend_mod.check_kind(backend)
        except ValueError as e:
            raise VolumeError(str(e)) from None
        if needle_map not in NEEDLE_MAPS:
            raise VolumeError(
                f"unknown needle map kind {needle_map!r}; have "
                f"{', '.join(NEEDLE_MAPS)}")
        self.base = Path(base)
        self.volume_id = volume_id
        self.super_block = super_block or SuperBlock()
        self.backend_kind = backend
        #: The operator-configured kind, never mutated — backend_kind
        #: tracks the CURRENT backend ("s3" while tiered) and retier()
        #: restores this one when the .dat comes back local.
        self._configured_backend = backend
        self.needle_map_kind = needle_map
        self.nm = CompactMap()
        self._dat: Optional[backend_mod.BackendStorageFile] = None
        self._idx = None
        #: Guard: at most one compaction in flight (storage/vacuum.py).
        self.vacuum_in_progress = False
        #: Set when a .tier sidecar exists (the durable copy is on the
        #: S3 tier): writes are refused even on a kept local .dat, or
        #: they would silently diverge from the tiered bytes.
        self.readonly = False
        # Appends mutate shared file-handle state; reads use os.pread on
        # the raw fd, so only writers serialize. Readers register under
        # the lock (consistent needle-map + fd snapshot) and pread
        # outside it; close() and vacuum's commit_compact drain them via
        # _no_readers before closing or swapping the fd, so a read never
        # hits a closed (or kernel-reused) descriptor, nor pre-compact
        # offsets on the compacted file.
        self._lock = threading.RLock()
        self._readers = 0
        #: True while close() or commit_compact drains readers; new
        #: readers block on _no_readers until it clears, so a stream of
        #: overlapping reads cannot starve the drain.
        self._swap_pending = False
        self._no_readers = threading.Condition(self._lock)

    # -- lifecycle --------------------------------------------------------

    def create(self) -> "Volume":
        if dat_path(self.base).exists():
            raise VolumeError(f"{dat_path(self.base)} already exists")
        # A leftover sqlite map from a deleted volume with this id would
        # feed the fresh volume phantom entries — this is a NEW volume,
        # so any prior map is dead by definition.
        Path(str(self.base) + ".sdx").unlink(missing_ok=True)
        self._dat = backend_mod.open_backend(
            self.backend_kind, dat_path(self.base), create=True)
        self._dat.append(self.super_block.to_bytes())
        self._idx = open(idx_path(self.base), "w+b")
        self.nm = self._new_needle_map()
        return self

    def _use_native_map(self) -> bool:
        """native kind requested AND the C library builds here; else
        warn once and fall back to the memory map."""
        global _native_fallback_warned
        from . import needle_map_native
        if needle_map_native.available():
            return True
        if not _native_fallback_warned:
            _native_fallback_warned = True
            _log.warning("native needle map unavailable (no g++?); "
                         "volume %s falls back to the memory map",
                         self.volume_id)
        return False

    def _new_needle_map(self):
        if self.needle_map_kind == "native" and self._use_native_map():
            from .needle_map_native import NativeNeedleMap
            return NativeNeedleMap()
        if self.needle_map_kind == "sqlite":
            from .needle_map_sqlite import SqliteNeedleMap
            return SqliteNeedleMap(
                str(self.base) + ".sdx",
                generation=self.super_block.compact_revision)
        return CompactMap()

    def _load_needle_map(self):
        ip = idx_path(self.base)
        if self.needle_map_kind == "native" and self._use_native_map():
            from .needle_map_native import NativeNeedleMap
            return NativeNeedleMap.load_from_idx(ip)
        if self.needle_map_kind == "sqlite":
            from .needle_map_sqlite import SqliteNeedleMap
            return SqliteNeedleMap.load_from_idx(
                str(self.base) + ".sdx", ip,
                generation=self.super_block.compact_revision)
        return CompactMap.load_from_idx(ip)

    def load(self) -> "Volume":
        p = dat_path(self.base)
        from . import tier as tier_mod
        tiered = tier_mod.TierInfo.maybe_load(self.base) is not None
        if not p.exists():
            if tiered:
                return self._load_tiered()
            raise VolumeError(f"{p} does not exist")
        if tiered:
            # -keepLocal upload: local .dat kept as a hot read cache,
            # but the S3 copy is the durable one — stay read-only even
            # across restarts (the sidecar IS the durable marker)
            self.readonly = True
        # Compaction crash recovery. States (commit renames .cpd over
        # .dat FIRST, then .cpx over .idx):
        #   .cpd + .cpx  -> crash before commit: live volume untouched,
        #                   drop both.
        #   .cpx only    -> crash BETWEEN the renames: the .dat is
        #                   already the compacted one and the old .idx
        #                   points at stale offsets — the .cpx is the
        #                   only correct index, so FINISH the commit.
        #   .cpd only    -> crash mid-compact before .cpx existed: drop.
        cpd = Path(str(self.base) + ".cpd")
        cpx = Path(str(self.base) + ".cpx")
        if cpx.exists() and not cpd.exists():
            durability.durable_replace(cpx, idx_path(self.base))
        else:
            for leftover in (cpd, cpx):
                if leftover.exists():
                    leftover.unlink()
        self._dat = backend_mod.open_backend(self.backend_kind, p)
        head = self._dat.read_at(8, 0)
        if len(head) < 8:
            raise VolumeError(f"{p} shorter than a superblock")
        extra_len = struct.unpack_from(">H", head, 6)[0]
        self.super_block = SuperBlock.parse(
            head + self._dat.read_at(extra_len, 8))
        repairs = check_volume_data_integrity(self.base, self.super_block)
        if repairs.get("dat_truncated_bytes"):
            # the check truncated the file underneath the open backend
            self._dat.close()
            self._dat = backend_mod.open_backend(self.backend_kind, p)
        ip = idx_path(self.base)
        self._idx = open(ip, "a+b") if ip.exists() else open(ip, "w+b")
        self.nm = self._load_needle_map()
        return self

    def _load_tiered(self) -> "Volume":
        """Open a volume whose .dat lives on the S3 tier (sidecar
        present, no local .dat): data bytes come through ranged GETs,
        the hot .idx stays local (the reference's tiering split). A
        tiered volume was sealed before upload, so compaction-crash
        recovery and tail-integrity repair do not apply; the backend
        itself refuses writes."""
        self._dat = backend_mod.open_backend("s3", dat_path(self.base))
        self.backend_kind = "s3"
        self.readonly = True
        head = self._dat.read_at(8, 0)
        if len(head) < 8:
            raise VolumeError(f"{self._dat.name} shorter than a "
                              f"superblock")
        extra_len = struct.unpack_from(">H", head, 6)[0]
        self.super_block = SuperBlock.parse(
            head + self._dat.read_at(extra_len, 8))
        ip = idx_path(self.base)
        if not ip.exists():
            raise VolumeError(
                f"tiered volume {self.base} has no local .idx — the "
                f"index stays local when a volume tiers")
        self._idx = open(ip, "a+b")
        self.nm = self._load_needle_map()
        return self

    def retier(self) -> None:
        """Re-point ``_dat`` at wherever the bytes NOW live (local .dat
        vs .tier sidecar) after a tier move in either direction, while
        the volume keeps serving: in-flight readers are drained exactly
        like the compaction fd swap (new readers park on _no_readers),
        then the backend handle is swapped under the lock. The needle
        map and local .idx are untouched — the tier split keeps the
        index local either way."""
        from . import tier as tier_mod
        with self._lock:
            self._swap_pending = True
            try:
                while self._readers:
                    self._no_readers.wait()
                old = self._dat
                p = dat_path(self.base)
                tiered = tier_mod.TierInfo.maybe_load(self.base) \
                    is not None
                if p.exists():
                    # local bytes (possibly a -keepLocal hot copy)
                    self._dat = backend_mod.open_backend(
                        self._configured_backend, p)
                    self.backend_kind = self._configured_backend
                    self.readonly = tiered
                elif tiered:
                    self._dat = backend_mod.open_backend("s3", p)
                    self.backend_kind = "s3"
                    self.readonly = True
                else:
                    raise VolumeError(
                        f"volume {self.volume_id}: neither {p} nor a "
                        f"tier sidecar exists")
                if old is not None:
                    old.close()
            finally:
                self._swap_pending = False
                self._no_readers.notify_all()

    def close(self) -> None:
        with self._lock:
            self._swap_pending = True
            try:
                while self._readers:
                    self._no_readers.wait()
                for f in (self._dat, self._idx):
                    if f is not None:
                        f.close()
                self._dat = self._idx = None
                # once, and whether or not the .dat was still open (a
                # torn vacuum commit drops the files but not the map):
                # the sqlite map checkpoints on close and refuses a
                # second one
                if self.nm is not None and hasattr(self.nm, "close"):
                    self.nm.close()
                self.nm = None
            finally:
                self._swap_pending = False
                self._no_readers.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- data plane -------------------------------------------------------

    def _append(self, rec: bytes, key: int, body_size: int) -> int:
        """Append one record under the lock: pad to 8 bytes, write the
        .dat, barrier, journal to .idx, barrier, then publish in the map
        (Volume.writeNeedle's order)."""
        with self._lock:
            if self._dat is None:
                raise VolumeError("volume not open")
            # checked UNDER the lock: tier_move seals under this same
            # lock, so a writer that raced past an outside-the-lock
            # check could otherwise append after the seal's sync and
            # lose the needle when the local .dat is dropped
            if self.readonly:
                raise VolumeError(
                    f"volume {self.volume_id} is read-only (tiered "
                    f"copy exists; a local write would silently "
                    f"diverge from it)")
            offset = self._dat.size()
            if offset % NEEDLE_PADDING_SIZE:
                pad = (-offset) % NEEDLE_PADDING_SIZE
                self._dat.write_at(b"\x00" * pad, offset)
                offset += pad
            self._dat.write_at(rec, offset)
            faults.check("crash.append.dat")  # seaweedlint: disable=SW103 — faults.check sleeps only under an armed test-harness delay spec, never in production
            # The barrier flushes (concurrent reads see the record the
            # moment the index entry is visible) and fsyncs: the offset
            # this returns means the needle survives power loss.
            durability.barrier(self._dat, len(rec))
            units = to_offset_units(offset)
            self._idx.write(IndexEntry(key, units, body_size).to_bytes())
            faults.check("crash.append.idx")  # seaweedlint: disable=SW103 — faults.check sleeps only under an armed test-harness delay spec, never in production
            durability.barrier(self._idx, NEEDLE_MAP_ENTRY_SIZE)
            self.nm.set(key, units, body_size)
        return offset

    def write_needle(self, n: needle_mod.Needle) -> int:
        """Append; returns the byte offset of the record. Mirrors
        Volume.writeNeedle: append to .dat, then journal to .idx."""
        rec = n.to_bytes(self.super_block.version)
        return self._append(rec, n.id, needle_mod.parse_header(rec)[2])

    def _read_at(self, key: int) -> tuple[bytes, int]:
        """The raw record of a live needle and its byte offset, read
        outside the lock by a registered reader."""
        with self._lock:
            while self._swap_pending:
                self._no_readers.wait()
            if self._dat is None:
                raise VolumeError("volume not open")
            entry = self.nm.get(key)
            if entry is None:
                raise KeyError(f"needle {key} not found")
            dat = self._dat
            self._readers += 1
        try:
            rec = dat.read_at(
                needle_mod.record_size(entry.size,
                                       self.super_block.version),
                entry.byte_offset)
        finally:
            with self._lock:
                self._readers -= 1
                if not self._readers:
                    self._no_readers.notify_all()
        return rec, entry.byte_offset

    def read_needle(self, key: int, cookie: Optional[int] = None
                    ) -> needle_mod.Needle:
        rec, _ = self._read_at(key)
        n = needle_mod.Needle.parse(rec, self.super_block.version)
        if n.id != key:
            raise VolumeError(
                f"index/offset mismatch: wanted {key}, found {n.id}")
        if cookie is not None and n.cookie != cookie:
            raise VolumeError("cookie mismatch")
        return n

    def read_record(self, key: int) -> tuple[bytes, int]:
        """Raw on-disk record bytes for a live needle plus its byte
        offset — the replica-sync read (reference: ReadNeedleBlob, which
        also hands back the undecoded record)."""
        return self._read_at(key)

    def write_raw_record(self, rec: bytes) -> int:
        """Append a raw record produced by :meth:`read_record` on a
        sibling replica (WriteNeedleBlob): same append discipline as
        write_needle, but the bytes are trusted verbatim so CRC and
        timestamps survive the copy bit-for-bit."""
        _cookie, key, body_size = needle_mod.parse_header(rec)
        want = needle_mod.record_size(body_size,
                                      self.super_block.version)
        if len(rec) != want:
            raise VolumeError(
                f"raw record length {len(rec)} != expected {want} "
                f"for size {body_size}")
        return self._append(rec, key, body_size)

    def delete_needle(self, key: int) -> bool:
        with self._lock:
            if self._idx is None:
                raise VolumeError("volume not open")
            if self.readonly:
                raise VolumeError(
                    f"volume {self.volume_id} is read-only (tiered "
                    f"copy exists; a local delete would silently "
                    f"diverge from it)")
            if not self.nm.delete(key):
                return False
            self._idx.write(
                IndexEntry(key, 0, TOMBSTONE_FILE_SIZE).to_bytes())
            durability.barrier(self._idx, NEEDLE_MAP_ENTRY_SIZE)
        return True

    def configure_replication(self, replication: str) -> None:
        """Rewrite the superblock's replica-placement byte in place
        (reference: VolumeConfigure — the setting lives only in the
        superblock, so no data moves)."""
        rp = ReplicaPlacement.parse(replication)
        with self._lock:
            if self._dat is None:
                raise VolumeError("volume not open")
            if self.readonly:
                raise VolumeError(
                    f"volume {self.volume_id} is read-only (tiered); "
                    f"download it first")
            self.super_block.replica_placement = rp
            self._dat.write_at(self.super_block.to_bytes(), 0)
            durability.barrier(self._dat,
                               len(self.super_block.to_bytes()))

    def sync(self) -> None:
        with self._lock:
            if self._dat is not None:
                self._dat.sync()
            if self._idx is not None:
                self._idx.flush()
                os.fsync(self._idx.fileno())

    @property
    def dat_size(self) -> int:
        with self._lock:
            return self._dat.size()

    def content_size(self) -> int:
        return self.dat_size


def check_volume_data_integrity(base: str | Path,
                                super_block: SuperBlock) -> dict:
    """Crash-recovery tail verification, run on every load.

    The reference's volume_checking.go verifies the LAST index entry's
    needle and refuses the volume on mismatch; here torn tails are
    REPAIRED instead (the write order is dat-then-idx-then-ack, with a
    durability barrier between each, so only un-acknowledged tail
    records can be casualties): a partial trailing .idx entry is truncated, a trailing .idx entry
    whose record is missing/short/mismatched/CRC-torn in the .dat is
    dropped, and .dat bytes past the last journaled record (a torn
    append that never reached the index) are truncated. Trailing
    records are validated by full checksum walk-back — a crash can
    persist a record's header sectors without its body, so header-only
    validation would let a torn needle back into the map. Returns a
    dict of repairs performed (empty = clean)."""
    repairs: dict[str, int] = {}
    ip, dp = idx_path(base), dat_path(base)
    dat_size = dp.stat().st_size
    version = super_block.version
    if not ip.exists():
        return repairs
    blob = ip.read_bytes()  # one read serves every pass below
    idx_size = len(blob)
    if idx_size % NEEDLE_MAP_ENTRY_SIZE:
        idx_size -= idx_size % NEEDLE_MAP_ENTRY_SIZE
        repairs["idx_partial_entry"] = 1
    # Back-walk the trailing entries. Tombstones reference no .dat bytes
    # so they can't be validated — step over them and keep checking the
    # entries beneath (a torn record under a trailing delete must still
    # be caught). If any entry proves invalid, truncate at that entry:
    # everything journaled after it belongs to the same un-acknowledged
    # crash window.
    dat_fd = os.open(dp, os.O_RDONLY)
    try:
        truncate_to = idx_size
        pos = idx_size
        while pos >= NEEDLE_MAP_ENTRY_SIZE:
            e = IndexEntry.from_bytes(blob, pos - NEEDLE_MAP_ENTRY_SIZE)
            if e.is_deleted:
                pos -= NEEDLE_MAP_ENTRY_SIZE
                continue
            rec_len = needle_mod.record_size(e.size, version)
            end = e.byte_offset + rec_len
            ok = False
            if end <= dat_size:
                rec = os.pread(dat_fd, rec_len, e.byte_offset)
                try:
                    _, nid, nsize = needle_mod.parse_header(rec)
                    # full parse = checksum verification of the body
                    needle_mod.Needle.parse(rec, version)
                    ok = nid == e.key and nsize == e.size
                except needle_mod.NeedleError:
                    ok = False
            if ok:
                break
            pos -= NEEDLE_MAP_ENTRY_SIZE
            truncate_to = pos
    finally:
        os.close(dat_fd)
    if truncate_to < idx_size:
        repairs["idx_dropped_entries"] = \
            (idx_size - truncate_to) // NEEDLE_MAP_ENTRY_SIZE
        idx_size = truncate_to
    if idx_size < len(blob):
        blob = blob[:idx_size]
        with open(ip, "r+b") as f:
            f.truncate(idx_size)
            os.fsync(f.fileno())  # a repair is itself a commit point
    # The true append frontier is the max record end over every
    # journaled (non-tombstone) entry — deleted needles' bytes are still
    # in the file; anything beyond is a torn append.
    frontier = super_block.block_size
    for e in walk_index_blob(blob):
        if e.is_deleted:
            continue
        frontier = max(
            frontier,
            e.byte_offset + needle_mod.record_size(e.size, version))
    if dat_size > frontier:
        with open(dp, "r+b") as df:
            df.truncate(frontier)
            os.fsync(df.fileno())
        repairs["dat_truncated_bytes"] = dat_size - frontier
    return repairs


def generate_synthetic_volume(base: str | Path, volume_id: int,
                              n_needles: int, avg_size: int = 1024,
                              seed: int = 0,
                              version: int = 3) -> Volume:
    """Create a .dat/.idx pair full of random needles through the
    ``Volume`` engine (the ec_test.go fixture pattern). Needle sizes
    jitter around ``avg_size``; ids are 1..n; cookies are random.
    Returns the still-open Volume."""
    rng = np.random.default_rng(seed)
    sb = SuperBlock(version=version)
    vol = Volume(base, volume_id, sb).create()
    for i in range(1, n_needles + 1):
        size = max(1, int(rng.integers(avg_size // 2, avg_size * 3 // 2)))
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        n = needle_mod.Needle(
            cookie=int(rng.integers(0, 2**32)), id=i, data=data,
            append_at_ns=int(1_700_000_000_000_000_000 + i))
        vol.write_needle(n)
    vol.sync()
    return vol


def synthetic_needles(avg_size: int = 1024, seed: int = 0
                      ) -> Iterator[needle_mod.Needle]:
    """The endless needle stream of :func:`write_synthetic_volume`:
    ids 1, 2, ...; sizes jitter around ``avg_size``; cookies, data and
    timestamps come from ``seed``."""
    rng = np.random.default_rng(seed)
    n = 0
    while True:
        n += 1
        size = max(1, int(rng.integers(avg_size // 2, avg_size * 3 // 2)))
        yield needle_mod.Needle(
            cookie=int(rng.integers(0, 2**32)), id=n,
            data=rng.integers(0, 256, size, dtype=np.uint8).tobytes(),
            append_at_ns=1_700_000_000_000_000_000 + n)


def write_synthetic_volume(base: str | Path, dat_bytes: int,
                           avg_size: int = 1024, seed: int = 0,
                           version: int = 3) -> int:
    """Write ``<base>.dat`` and ``<base>.idx`` holding the needles of
    :func:`synthetic_needles` until the .dat reaches ``dat_bytes`` (the
    last needle may end past it), with plain buffered writes and no
    fsync. Returns the number of needles."""
    sb = SuperBlock(version=version).to_bytes()
    offset = len(sb)
    n = 0
    needles = synthetic_needles(avg_size, seed)
    with open(dat_path(base), "wb") as dat, open(idx_path(base), "wb") as idx:
        dat.write(sb)
        while offset < dat_bytes:
            ndl = next(needles)
            n += 1
            rec = ndl.to_bytes(version)
            dat.write(rec)
            idx.write(IndexEntry(ndl.id, to_offset_units(offset),
                                 needle_mod.parse_header(rec)[2]).to_bytes())
            offset += len(rec)
    return n
