"""Filer entry model: paths, attributes, chunk lists.

Mirrors weed/filer's Entry/Attr/FileChunk (SURVEY.md §2 "Filer": "entry =
attrs + []FileChunk{fileId,offset,size}"). Entries serialize to plain
dicts (JSON) so every store backend — memory, sqlite, a future remote —
shares one codec instead of a per-backend schema.

The port of ``seaweedfs_tpu/filer/entry.py``, whole.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace


def normalize_path(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    while "//" in path:
        path = path.replace("//", "/")
    if len(path) > 1 and path.endswith("/"):
        path = path[:-1]
    return path


def split_path(path: str) -> tuple[str, str]:
    """/a/b/c -> (/a/b, c); / -> (/, '')."""
    path = normalize_path(path)
    if path == "/":
        return "/", ""
    parent, _, name = path.rpartition("/")
    return parent or "/", name


@dataclass(frozen=True)
class FileChunk:
    """One stored chunk of a file: fid into the blob layer + where the
    chunk's bytes land in the logical file."""
    file_id: str
    offset: int
    size: int
    mtime_ns: int = 0
    etag: str = ""

    def to_dict(self) -> dict:
        return {"fileId": self.file_id, "offset": self.offset,
                "size": self.size, "mtime": self.mtime_ns,
                "etag": self.etag}

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(file_id=d["fileId"], offset=int(d["offset"]),
                   size=int(d["size"]), mtime_ns=int(d.get("mtime", 0)),
                   etag=d.get("etag", ""))


@dataclass
class Attr:
    mtime: float = field(default_factory=time.time)
    crtime: float = field(default_factory=time.time)
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    collection: str = ""
    replication: str = ""
    is_dir: bool = False

    def to_dict(self) -> dict:
        return {"mtime": self.mtime, "crtime": self.crtime,
                "mode": self.mode, "uid": self.uid, "gid": self.gid,
                "mime": self.mime, "ttl": self.ttl_sec,
                "collection": self.collection,
                "replication": self.replication, "isDir": self.is_dir}

    @classmethod
    def from_dict(cls, d: dict) -> "Attr":
        return cls(mtime=float(d.get("mtime", 0)),
                   crtime=float(d.get("crtime", 0)),
                   mode=int(d.get("mode", 0o660)),
                   uid=int(d.get("uid", 0)), gid=int(d.get("gid", 0)),
                   mime=d.get("mime", ""), ttl_sec=int(d.get("ttl", 0)),
                   collection=d.get("collection", ""),
                   replication=d.get("replication", ""),
                   is_dir=bool(d.get("isDir", False)))


@dataclass
class Entry:
    path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)

    @property
    def is_dir(self) -> bool:
        return self.attr.is_dir

    @property
    def name(self) -> str:
        return split_path(self.path)[1]

    @property
    def parent(self) -> str:
        return split_path(self.path)[0]

    def size(self) -> int:
        from .filechunks import total_size
        return total_size(self.chunks)

    def to_dict(self) -> dict:
        return {"path": self.path, "attr": self.attr.to_dict(),
                "chunks": [c.to_dict() for c in self.chunks],
                "extended": dict(self.extended)}

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        return cls(path=d["path"], attr=Attr.from_dict(d.get("attr", {})),
                   chunks=[FileChunk.from_dict(c)
                           for c in d.get("chunks", [])],
                   extended=dict(d.get("extended", {})))

    def clone(self) -> "Entry":
        return Entry(path=self.path, attr=replace(self.attr),
                     chunks=list(self.chunks),
                     extended=dict(self.extended))
