"""Disk-backed needle map (needle_map_leveldb.go analog, sqlite here).

The port of ``seaweedfs_tpu/storage/needle_map_sqlite.py``. The in-RAM
CompactMap costs ~100 B/needle of Python-object overhead; a
billion-needle volume cannot load it. This map keeps key -> (offset,
size) in a sqlite table next to the volume (``<base>.sdx``) and replays
only the .idx TAIL beyond a persisted watermark on load — the property
that makes huge volumes reloadable in O(new entries) instead of O(all).

The watermark is stored with the index generation (the superblock's
``compact_revision``), so an index that a vacuum commit REPLACED is
detected and the map rebuilt rather than corrupted by replaying
unrelated bytes. The table and meta layout are the JAX package's, so
either package loads the other's ``.sdx``.

Same surface as idx.CompactMap (set/get/delete/len/live_entries +
file_count/deleted_count/deleted_bytes/max_key counters), so Volume
treats the two interchangeably.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Iterator, Optional

from .idx import IndexEntry, walk_index_blob
from .types import NEEDLE_MAP_ENTRY_SIZE, TOMBSTONE_FILE_SIZE

_SCHEMA = """
CREATE TABLE IF NOT EXISTS needles (
    key INTEGER PRIMARY KEY,
    offset_units INTEGER NOT NULL,
    size INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS meta (
    k TEXT PRIMARY KEY,
    v BLOB
);
"""


#: Mutations per durable checkpoint (counters + watermark + commit).
CHECKPOINT_EVERY = 4096


class SqliteNeedleMap:
    def __init__(self, db_path: str | Path, generation: int = 0):
        self.db_path = str(db_path)
        #: Index generation — the volume's superblock compact_revision.
        #: Vacuum commit replaces the whole .idx and bumps the revision,
        #: so a stored generation mismatch proves the map describes a
        #: dead index and must be rebuilt. (A content fingerprint is
        #: NOT sufficient: compaction usually preserves the first index
        #: entry byte-for-byte.)
        self.generation = generation
        try:
            self._db = self._connect()
        except sqlite3.DatabaseError:
            # A torn database is disposable — the .idx journal is the
            # durability source of truth; drop and rebuild.
            Path(self.db_path).unlink(missing_ok=True)
            self._db = self._connect()
        self.file_count = int(self._meta("file_count") or 0)
        self.deleted_count = int(self._meta("deleted_count") or 0)
        self.deleted_bytes = int(self._meta("deleted_bytes") or 0)
        self.max_key = int(self._meta("max_key") or 0)
        self.max_offset_units = int(self._meta("max_offset_units") or 0)
        #: Bytes of .idx this map's state reflects. Mutations advance it
        #: in lockstep (Volume journals exactly one entry per set/
        #: delete) and it is committed ATOMICALLY with the data at each
        #: checkpoint, so after any crash the replay point exactly
        #: matches the persisted table state.
        self._applied_bytes = int(self._meta("idx_watermark") or 0)
        self._dirty = 0

    def _connect(self) -> sqlite3.Connection:
        db = sqlite3.connect(self.db_path, check_same_thread=False)
        db.executescript(_SCHEMA)
        db.commit()
        # fsync per checkpoint, not per statement; one open write
        # transaction accumulates mutations between checkpoints.
        db.execute("PRAGMA synchronous=OFF")
        return db

    # ------------- meta helpers -------------

    def _meta(self, k: str) -> Optional[bytes]:
        row = self._db.execute("SELECT v FROM meta WHERE k=?",
                               (k,)).fetchone()
        return row[0] if row else None

    def _set_meta(self, k: str, v) -> None:
        self._db.execute(
            "INSERT INTO meta(k, v) VALUES(?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v", (k, v))

    def _save_counters(self) -> None:
        for k in ("file_count", "deleted_count", "deleted_bytes",
                  "max_key", "max_offset_units"):
            self._set_meta(k, getattr(self, k))

    def _checkpoint(self) -> None:
        self._save_counters()
        self._set_meta("idx_watermark", self._applied_bytes)
        self._set_meta("idx_generation", self.generation)
        self._db.commit()
        self._dirty = 0

    def _mutated(self) -> None:
        self._applied_bytes += NEEDLE_MAP_ENTRY_SIZE
        self._dirty += 1
        if self._dirty >= CHECKPOINT_EVERY:
            self._checkpoint()

    # ------------- CompactMap surface -------------

    def set(self, key: int, offset_units: int, size: int) -> None:
        row = self._db.execute(
            "SELECT size FROM needles WHERE key=?", (key,)).fetchone()
        if row is not None and row[0] != TOMBSTONE_FILE_SIZE:
            self.deleted_count += 1
            self.deleted_bytes += row[0]
        self._db.execute(
            "INSERT INTO needles(key, offset_units, size) VALUES(?,?,?) "
            "ON CONFLICT(key) DO UPDATE SET "
            "offset_units=excluded.offset_units, size=excluded.size",
            (key, offset_units, size))
        self.file_count += 1
        self.max_key = max(self.max_key, key)
        self.max_offset_units = max(self.max_offset_units, offset_units)
        self._mutated()

    def delete(self, key: int) -> bool:
        row = self._db.execute(
            "SELECT offset_units, size FROM needles WHERE key=?",
            (key,)).fetchone()
        if row is None or row[1] == TOMBSTONE_FILE_SIZE:
            return False
        self.deleted_count += 1
        self.deleted_bytes += row[1]
        self._db.execute(
            "UPDATE needles SET size=? WHERE key=?",
            (TOMBSTONE_FILE_SIZE, key))
        self._mutated()
        return True

    def get(self, key: int) -> Optional[IndexEntry]:
        row = self._db.execute(
            "SELECT offset_units, size FROM needles WHERE key=?",
            (key,)).fetchone()
        if row is None or row[1] == TOMBSTONE_FILE_SIZE:
            return None
        return IndexEntry(key, row[0], row[1])

    def __len__(self) -> int:
        return self._db.execute(
            "SELECT COUNT(*) FROM needles WHERE size != ?",
            (TOMBSTONE_FILE_SIZE,)).fetchone()[0]

    def items(self) -> Iterator[IndexEntry]:
        for key, off, size in self._db.execute(
                "SELECT key, offset_units, size FROM needles"):
            yield IndexEntry(key, off, size)

    def live_entries(self) -> list[IndexEntry]:
        return [IndexEntry(k, o, s) for k, o, s in self._db.execute(
            "SELECT key, offset_units, size FROM needles "
            "WHERE size != ? ORDER BY key", (TOMBSTONE_FILE_SIZE,))]

    def close(self) -> None:
        self._checkpoint()
        self._db.close()

    # ------------- idx replay with watermark -------------

    @classmethod
    def load_from_idx(cls, db_path: str | Path, idx_path: str | Path,
                      generation: int = 0) -> "SqliteNeedleMap":
        m = cls(db_path, generation=generation)
        ip = Path(idx_path)
        blob = ip.read_bytes() if ip.exists() else b""
        usable = len(blob) - len(blob) % NEEDLE_MAP_ENTRY_SIZE
        blob = blob[:usable]
        mark = m._applied_bytes
        stored_gen = int(m._meta("idx_generation") or 0)
        if mark > len(blob) or stored_gen != generation:
            # .idx shrank, or was wholly replaced by a vacuum commit
            # (compact_revision moved): the stored map describes a dead
            # file — rebuild from scratch.
            m._db.execute("DELETE FROM needles")
            m.file_count = m.deleted_count = m.deleted_bytes = 0
            m.max_key = m.max_offset_units = 0
            mark = 0
        m._applied_bytes = mark
        for e in walk_index_blob(blob[mark:]):
            if e.is_deleted:
                m.delete(e.key)
            else:
                m.set(e.key, e.offset_units, e.size)
        m._applied_bytes = len(blob)
        m._checkpoint()
        return m
