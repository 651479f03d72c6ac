"""Pluggable filer metadata stores (weed/filer's FilerStore interface).

The reference ships leveldb/redis/mysql/... backends behind one
interface; this environment has no external services, so the two
backends are ``MemoryStore`` (the reference's in-memory test store) and
``SqliteStore`` — stdlib sqlite3 standing in for the embedded-KV class
(leveldb) with the same observable contract: durable across reopen,
prefix-ordered directory scans, single-writer semantics.

The port of ``seaweedfs_tpu/filer/stores.py``, whole (the sqlite layout
is the JAX package's, so either package opens the other's ``-db``).
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Iterator, Optional

from .entry import Entry, normalize_path, split_path


class FilerStore:
    """insert/update/find/delete/list over Entry, plus a small KV."""

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, path: str) -> Optional[Entry]:
        raise NotImplementedError

    def delete_entry(self, path: str) -> None:
        raise NotImplementedError

    def list_entries(self, dir_path: str, start_name: str = "",
                     limit: int = 1 << 30) -> Iterator[Entry]:
        raise NotImplementedError

    def ensure_parents(self, path: str,
                       mode: int = 0o770) -> list:
        """Insert missing ancestor directories of ``path``; returns
        the created entries shallowest-first (the one parent-synthesis
        invariant shared by the live filer and backup sinks). Raises
        ValueError when an ancestor exists as a file."""
        from .entry import Attr, Entry, split_path

        parent, _ = split_path(path)
        missing: list[str] = []
        while parent != "/":
            e = self.find_entry(parent)
            if e is not None:
                if not e.is_dir:
                    raise ValueError(f"{parent} is not a directory")
                break
            missing.append(parent)
            parent, _ = split_path(parent)
        created = []
        for p in reversed(missing):
            d = Entry(path=p, attr=Attr(is_dir=True, mode=mode))
            self.insert_entry(d)
            created.append(d)
        return created

    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryStore(FilerStore):
    def __init__(self) -> None:
        self._entries: dict[str, Entry] = {}
        self._kv: dict[str, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._entries[normalize_path(entry.path)] = entry.clone()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Optional[Entry]:
        with self._lock:
            e = self._entries.get(normalize_path(path))
            return e.clone() if e else None

    def delete_entry(self, path: str) -> None:
        with self._lock:
            self._entries.pop(normalize_path(path), None)

    def list_entries(self, dir_path: str, start_name: str = "",
                     limit: int = 1 << 30) -> Iterator[Entry]:
        dir_path = normalize_path(dir_path)
        with self._lock:
            names = sorted(
                (p for p in self._entries
                 if split_path(p)[0] == dir_path and p != "/"),
                key=lambda p: split_path(p)[1])
            picked = [p for p in names
                      if split_path(p)[1] > start_name][:limit]
            entries = [self._entries[p].clone() for p in picked]
        yield from entries

    def kv_put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = bytes(value)

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)


class SqliteStore(FilerStore):
    """Embedded durable store; schema = (dir, name) -> entry JSON so
    directory listings are one ordered index range scan, exactly the
    access pattern the reference tunes its leveldb key layout for."""

    def __init__(self, db_path: str) -> None:
        self._db_path = db_path
        self._local = threading.local()
        con = self._con()
        con.execute("""CREATE TABLE IF NOT EXISTS entries (
            dir TEXT NOT NULL, name TEXT NOT NULL, meta TEXT NOT NULL,
            PRIMARY KEY (dir, name))""")
        con.execute("""CREATE TABLE IF NOT EXISTS kv (
            k TEXT PRIMARY KEY, v BLOB NOT NULL)""")
        con.commit()

    def _con(self) -> sqlite3.Connection:
        con = getattr(self._local, "con", None)
        if con is None:
            con = sqlite3.connect(self._db_path, timeout=30)
            con.execute("PRAGMA journal_mode=WAL")
            self._local.con = con
        return con

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.path)
        con = self._con()
        con.execute(
            "INSERT OR REPLACE INTO entries (dir, name, meta) "
            "VALUES (?, ?, ?)",
            (d, name, json.dumps(entry.to_dict())))
        con.commit()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Optional[Entry]:
        d, name = split_path(path)
        if not name:
            return None
        row = self._con().execute(
            "SELECT meta FROM entries WHERE dir = ? AND name = ?",
            (d, name)).fetchone()
        return Entry.from_dict(json.loads(row[0])) if row else None

    def delete_entry(self, path: str) -> None:
        d, name = split_path(path)
        con = self._con()
        con.execute("DELETE FROM entries WHERE dir = ? AND name = ?",
                    (d, name))
        con.commit()

    def list_entries(self, dir_path: str, start_name: str = "",
                     limit: int = 1 << 30) -> Iterator[Entry]:
        rows = self._con().execute(
            "SELECT meta FROM entries WHERE dir = ? AND name > ? "
            "ORDER BY name LIMIT ?",
            (normalize_path(dir_path), start_name, limit)).fetchall()
        for (meta,) in rows:
            yield Entry.from_dict(json.loads(meta))

    def kv_put(self, key: str, value: bytes) -> None:
        con = self._con()
        con.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                    (key, sqlite3.Binary(value)))
        con.commit()

    def kv_get(self, key: str) -> Optional[bytes]:
        row = self._con().execute(
            "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def close(self) -> None:
        con = getattr(self._local, "con", None)
        if con is not None:
            con.close()
            self._local.con = None
