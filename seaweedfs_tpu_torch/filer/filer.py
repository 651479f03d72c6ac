"""The Filer: namespace operations, meta-log, chunked file IO.

Mirrors weed/filer/filer.go + filer_notify.go (SURVEY.md §2 "Filer"):
CreateEntry auto-creates parent directories, DeleteEntry can recurse and
returns the orphaned chunks for blob-layer deletion, and every mutation
appends to an in-process meta-log that subscribers consume (the
reference's SubscribeMetadata path that drives replication and the FUSE
cache invalidation).

Chunked IO: ``write_file`` splits a payload into ``chunk_size`` pieces,
assigns + uploads each through the operation client, and stores the
chunk list; ``read_file`` resolves visible intervals and fetches the
needed ranges. Both take the cluster connection as an argument, so the
Filer itself stays a pure metadata object (testable without servers).

The port of ``seaweedfs_tpu/filer/filer.py``: ``write_file`` and
``read_file`` run under ``filer.write_file`` and ``filer.read_file``
trace spans. One fault of the reference is repaired: a subscriber
that dropped an event takes no later one (ROADMAP Queue 3).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

from ..cache import chunk_key, fid_volume, global_chunk_cache
from ..util import tracing
from .entry import Attr, Entry, FileChunk, normalize_path, split_path
from .filechunks import chunk_file_ids, read_plan, total_size
from .stores import FilerStore, MemoryStore


class FilerError(RuntimeError):
    pass


class FilerResyncRequired(FilerError):
    """Replay cannot converge (meta-log window expired, or a subscriber
    lagged past its queue bound): the consumer must do a full re-sync.

    In-process consumers catch this type; cross-process consumers (gRPC
    stream clients) only see the message text, so it MUST contain the
    stable marker ``re-sync required`` — that substring is the wire
    contract the replicator matches on."""


@dataclass
class MetaEvent:
    ts_ns: int
    directory: str
    old_entry: Optional[Entry]
    new_entry: Optional[Entry]
    #: Loop-prevention chain (reference filer.proto ``signatures``):
    #: ids of every filer this mutation has visited, origin first;
    #: the emitting filer's own signature is always the last element.
    signatures: tuple = ()


@dataclass
class _Subscriber:
    queue: list = field(default_factory=list)
    cond: threading.Condition = field(
        default_factory=lambda: threading.Condition())
    #: Set when _notify dropped events because this subscriber lagged
    #: past MAX_SUB_QUEUE — the stream then errors instead of silently
    #: skipping mutations.
    overflowed: bool = False


class Filer:
    #: Default auto-chunk size — matches the reference filer's default
    #: maxMB upload split.
    CHUNK_SIZE = 4 * 1024 * 1024

    #: Bounded replayable meta-log window (filer_notify.go's persisted
    #: log role): subscribers can catch up from ``since_ns`` as long as
    #: it is still inside the window.
    META_LOG_EVENTS = 10_000
    #: Per-subscriber live-queue bound: a consumer stuck behind a slow
    #: sink (e.g. a tar-pitted webhook) must not grow filer memory
    #: without limit — past this, its events drop and its stream errors.
    MAX_SUB_QUEUE = 10_000

    def __init__(self, store: Optional[FilerStore] = None,
                 signature: int = 0, chunk_cache=None):
        self.store = store or MemoryStore()
        #: Hot-read chunk cache (weed chunk_cache analog): read_file
        #: serves repeat chunk fetches from here instead of re-hitting
        #: the volume servers. Defaults to the process-global cache so
        #: the filer server and in-process gateways share one hot set.
        self.chunk_cache = chunk_cache if chunk_cache is not None \
            else global_chunk_cache()
        #: Stable per-filer id for replication loop prevention
        #: (reference: the filer store mints and PERSISTS a random
        #: signature, so a restart keeps its identity and a running
        #: filer.sync's exclude filters stay valid). Nonzero int31;
        #: persisted through the store's kv seam.
        self.signature = signature or self._load_or_mint_signature()
        self._subs: list[_Subscriber] = []
        self._meta_log: collections.deque[MetaEvent] = collections.deque(
            maxlen=self.META_LOG_EVENTS)
        self._lock = threading.RLock()
        # Serializes read-modify-write namespace ops (o_excl check +
        # insert, parent checks, recursive delete) across the threaded
        # HTTP handler and the gRPC worker pool.
        self._ns_lock = threading.RLock()

    def _load_or_mint_signature(self) -> int:
        import random as _random
        raw = self.store.kv_get("filer.signature")
        if raw:
            try:
                return int(raw.decode()) or 1
            except ValueError:
                pass
        sig = _random.getrandbits(31) or 1
        self.store.kv_put("filer.signature", str(sig).encode())
        return sig

    # ------------- namespace -------------

    @staticmethod
    def _expired(entry: Entry) -> bool:
        """Entry-level TTL (reference filer behavior): an entry whose
        volume-TTL lifetime has passed reads as absent — the blob layer
        reaps the chunk data on the same clock, so surfacing the entry
        would only produce dangling-chunk 404s."""
        return bool(entry.attr.ttl_sec) and not entry.is_dir and \
            time.time() > entry.attr.crtime + entry.attr.ttl_sec

    def find_entry(self, path: str) -> Optional[Entry]:
        path = normalize_path(path)
        if path == "/":
            return Entry(path="/", attr=Attr(is_dir=True))
        e = self.store.find_entry(path)
        if e is not None and self._expired(e):
            # lazy reap — re-resolved UNDER the namespace lock: a
            # writer may have recreated the path since the unlocked
            # read, and deleting by path alone would destroy the fresh
            # entry (chunks are volume-reaped; only metadata goes)
            with self._ns_lock:
                cur = self.store.find_entry(path)
                if cur is not None and self._expired(cur):
                    self.store.delete_entry(path)
                    self._notify(split_path(path)[0], cur, None)
                    return None
                e = cur
        return e

    def create_entry(self, entry: Entry, o_excl: bool = False,
                     signatures: tuple = ()) -> Entry:
        path = normalize_path(entry.path)
        if path == "/":
            raise FilerError("cannot create /")
        entry.path = path
        with self._ns_lock:
            old = self.store.find_entry(path)
            if old is not None:
                if o_excl:
                    raise FilerError(f"{path} already exists")
                if old.is_dir != entry.is_dir:
                    raise FilerError(
                        f"{path} exists as a "
                        f"{'directory' if old.is_dir else 'file'}")
            self._ensure_parents(path, signatures)
            self.store.insert_entry(entry)
        self._notify(entry.parent, old, entry, signatures)
        return entry

    def update_entry(self, entry: Entry,
                     signatures: tuple = ()) -> Entry:
        path = normalize_path(entry.path)
        with self._ns_lock:
            old = self.store.find_entry(path)
            if old is None:
                raise FilerError(f"{path} not found")
            self.store.update_entry(entry)
        self._notify(entry.parent, old, entry, signatures)
        return entry

    def _ensure_parents(self, path: str,
                        signatures: tuple = ()) -> None:
        try:
            created = self.store.ensure_parents(path)
        except ValueError as e:
            raise FilerError(str(e)) from None
        for d in created:
            self._notify(split_path(d.path)[0], None, d, signatures)

    def list_entries(self, dir_path: str, start_name: str = "",
                     limit: int = 1 << 30) -> Iterator[Entry]:
        # Filter BEFORE counting the page (limiting at the store and
        # filtering after could return a short/empty page with live
        # entries still ahead, which paginating clients read as EOF) —
        # but keep the store fetches BOUNDED: batches of page size,
        # advancing the name cursor, so a huge directory costs
        # O(page), not O(dir), per request.
        n = 0
        cursor = start_name
        while n < limit:
            batch_size = min(max(limit - n, 64), 4096)
            batch = list(self.store.list_entries(dir_path, cursor,
                                                 batch_size))
            if not batch:
                return
            for e in batch:
                if self._expired(e):
                    continue
                yield e
                n += 1
                if n >= limit:
                    return
            cursor = split_path(batch[-1].path)[1]

    def delete_entry(self, path: str, recursive: bool = False,
                     signatures: tuple = ()) -> list[FileChunk]:
        """Remove an entry; returns every chunk orphaned by the delete so
        the caller can reclaim blob space (filer_delete_entry.go)."""
        path = normalize_path(path)
        with self._ns_lock:
            entry = self.store.find_entry(path)
            if entry is None:
                raise FilerError(f"{path} not found")
            orphans: list[FileChunk] = []
            if entry.is_dir:
                children = list(self.store.list_entries(path))
                # only LIVE children make a directory "not empty":
                # listings hide expired entries, so refusing a delete
                # over them would contradict what the client sees
                # (their metadata is reaped by the recursion below)
                live = [c for c in children if not self._expired(c)]
                if live and not recursive:
                    raise FilerError(f"{path} is not empty")
                if children and not live:
                    recursive = True  # only expired stragglers
                for child in children:
                    orphans.extend(self.delete_entry(
                        child.path, recursive=True,
                        signatures=signatures))
            else:
                orphans.extend(entry.chunks)
            self.store.delete_entry(path)
        self._notify(split_path(path)[0], entry, None, signatures)
        return orphans

    def rename(self, old_path: str, new_path: str,
               signatures: tuple = ()) -> Entry:
        """Move one entry (file or empty-subtree root moves only the
        node itself for directories whose children stay keyed under the
        new prefix via recursion)."""
        old_path = normalize_path(old_path)
        new_path = normalize_path(new_path)
        with self._ns_lock:
            entry = self.store.find_entry(old_path)
            if entry is None:
                raise FilerError(f"{old_path} not found")
            if entry.is_dir:
                for child in list(self.store.list_entries(old_path)):
                    self.rename(
                        child.path,
                        new_path + "/" + split_path(child.path)[1],
                        signatures=signatures)
            moved = entry.clone()
            moved.path = new_path
            self._ensure_parents(new_path, signatures)
            self.store.insert_entry(moved)
            self.store.delete_entry(old_path)
        self._notify(split_path(old_path)[0], entry, None, signatures)
        self._notify(split_path(new_path)[0], None, moved, signatures)
        return moved

    # ------------- meta-log / subscribe -------------

    def _notify(self, directory: str, old: Optional[Entry],
                new: Optional[Entry],
                signatures: tuple = ()) -> None:
        with self._lock:
            # Stamp under the lock: timestamp order == log order, so a
            # subscriber's attach stamp (hello_ts, taken under this
            # same lock) is a true barrier — every event appended after
            # registration carries ts >= it.
            ev = MetaEvent(ts_ns=time.time_ns(), directory=directory,
                           old_entry=old, new_entry=new,
                           signatures=tuple(signatures)
                           + (self.signature,))
            self._meta_log.append(ev)
            subs = list(self._subs)
        for s in subs:
            with s.cond:
                # Once a subscriber has dropped an event it takes no
                # more: it drains to the drop point and errors, so its
                # resume point precedes the gap. (The JAX package keeps
                # appending once the queue has room again, so a consumer
                # sees events past the gap and a resume from its last
                # event skips the dropped span.)
                if s.overflowed or len(s.queue) >= self.MAX_SUB_QUEUE:
                    s.overflowed = True
                else:
                    s.queue.append(ev)
                s.cond.notify()

    def meta_log_covers(self, since_ns: int) -> bool:
        """Whether replay from ``since_ns`` is gap-free: the log either
        never wrapped, or its oldest retained event predates the resume
        point. A wrapped log with a newer head means events in
        (since_ns, head] were evicted — the subscriber must re-sync,
        not silently resume (the reference errors here too)."""
        with self._lock:
            if len(self._meta_log) < self.META_LOG_EVENTS:
                return True
            return self._meta_log[0].ts_ns <= since_ns

    def subscribe(self, stop: Optional[threading.Event] = None,
                  since_ns: int = 0,
                  registered: Optional[threading.Event] = None,
                  hello: bool = False) -> Iterator[MetaEvent]:
        """Blocking event stream (SubscribeMetadata). Iterate on a
        dedicated thread; set ``stop`` to end the stream.

        ``since_ns > 0`` first replays logged events newer than that
        timestamp (up to the META_LOG_EVENTS window), then streams live.
        Registration and the replay snapshot happen under one lock, so
        no event is lost or duplicated across the seam. ``registered``
        (if given) is set the moment the subscriber is attached — a
        caller that must not miss events (the notifier bridge, before
        its server opens ports) waits on it, because a generator body
        only runs at the first next().

        ``hello=True`` first yields a marker MetaEvent (no entries)
        whose ts_ns is THIS filer's clock at registration, stamped
        under the log lock: every later-delivered event has ts >= it,
        so a remote follower can adopt it as a skew-free resume point
        and as proof the stream is attached."""
        sub = _Subscriber()
        with self._lock:
            if since_ns and not self.meta_log_covers(since_ns):
                raise FilerResyncRequired(
                    f"meta log window expired for since_ns={since_ns}; "
                    "full re-sync required")
            replay = [ev for ev in self._meta_log
                      if ev.ts_ns > since_ns] if since_ns else []
            self._subs.append(sub)
            hello_ts = time.time_ns()
        if registered is not None:
            registered.set()
        try:
            if hello:
                yield MetaEvent(ts_ns=hello_ts, directory="",
                                old_entry=None, new_entry=None)
            for ev in replay:
                if stop is not None and stop.is_set():
                    return
                yield ev
            while stop is None or not stop.is_set():
                with sub.cond:
                    while not sub.queue:
                        if sub.overflowed:
                            # drained up to the drop point: erroring
                            # beats silently skipping mutations
                            raise FilerResyncRequired(
                                "subscriber lagged past the queue "
                                "bound; events dropped — full re-sync "
                                "required")
                        if stop is not None and stop.is_set():
                            return
                        sub.cond.wait(timeout=0.1)
                    ev = sub.queue.pop(0)
                yield ev
        finally:
            with self._lock:
                if sub in self._subs:
                    self._subs.remove(sub)

    # ------------- chunked file IO -------------

    def write_file(self, path: str, data: bytes, master,
                   collection: str = "", replication: str = "",
                   ttl: str = "", mime: str = "",
                   chunk_size: Optional[int] = None,
                   append: bool = False,
                   signatures: tuple = ()) -> Entry:
        """Split ``data`` into chunks, upload each (assign + POST), then
        commit the entry — the §3.2 write stack driven from the filer."""
        from ..cluster import operation

        chunk_size = chunk_size or self.CHUNK_SIZE
        with tracing.span("filer.write_file", path=path) as sp:
            sp.n_bytes = len(data)
            return self._write_file_inner(
                path, data, master, collection, replication, ttl, mime,
                chunk_size, append, signatures, operation)

    def _write_file_inner(self, path, data, master, collection,
                          replication, ttl, mime, chunk_size, append,
                          signatures, operation) -> Entry:
        if append:
            cur0 = self.find_entry(normalize_path(path))
            if cur0 is not None:
                # appended chunks inherit the ENTRY's lifecycle: mixing
                # the caller's/rule's ttl with an existing entry would
                # put new chunks on volumes reaped at a different
                # horizon than the entry advertises (silent data loss)
                ttl = (f"{max(1, cur0.attr.ttl_sec // 60)}m"
                       if cur0.attr.ttl_sec else "")
        # Upload outside any lock (slow), with 0-based offsets; the
        # append base is only decided at commit time, under the lock.
        now_ns = time.time_ns()
        new_chunks: list[FileChunk] = []
        for off in range(0, len(data), chunk_size):
            piece = data[off:off + chunk_size]
            a = operation.assign(master, 1, collection, replication,
                                 ttl=ttl)
            operation.upload(a.url, a.fid, bytes(piece), jwt=a.auth,
                             collection=collection)
            new_chunks.append(FileChunk(file_id=a.fid, offset=off,
                                        size=len(piece),
                                        mtime_ns=now_ns))
        # Commit under the namespace lock against the entry that is
        # ACTUALLY there now — two concurrent writers both observed the
        # same pre-upload entry, so basing the append offsets or the
        # chunk reclaim on that stale read would drop the other
        # writer's bytes / leak the loser's freshly uploaded blobs.
        with self._ns_lock:
            current = self.store.find_entry(normalize_path(path))
            if append and current is not None:
                base = total_size(current.chunks)
                chunks = list(current.chunks) + [
                    FileChunk(file_id=c.file_id, offset=base + c.offset,
                              size=c.size, mtime_ns=c.mtime_ns)
                    for c in new_chunks]
                attr = current.attr
            else:
                chunks = new_chunks
                from ..storage.superblock import Ttl
                attr = Attr(collection=collection,
                            replication=replication, mime=mime,
                            ttl_sec=Ttl.parse(ttl).seconds if ttl
                            else 0)
            attr.mtime = time.time()
            entry = Entry(path=path, attr=attr, chunks=chunks)
            self.create_entry(entry, signatures=signatures)
        if current is not None and not append:
            new_ids = {c.file_id for c in chunks}
            stale = [c for c in current.chunks
                     if c.file_id not in new_ids]
            if stale:
                self._delete_chunks_via(master, stale,
                                        current.attr.collection)
        return entry

    def read_file(self, path: str, master, offset: int = 0,
                  length: Optional[int] = None) -> bytes:
        with tracing.span("filer.read_file", path=path) as sp:
            entry = self.find_entry(path)
            if entry is None:
                raise FilerError(f"{path} not found")
            if entry.is_dir:
                raise FilerError(f"{path} is a directory")
            size = total_size(entry.chunks)
            if length is None:
                length = size - offset
            length = max(0, min(length, size - offset))
            buf = bytearray(length)
            for piece in read_plan(entry.chunks, offset, length):
                blob = self._fetch_chunk(master, piece.file_id,
                                         entry.attr.collection)
                part = blob[piece.chunk_offset:
                            piece.chunk_offset + piece.length]
                buf[piece.buffer_offset:
                    piece.buffer_offset + len(part)] = part
            sp.n_bytes = length
            return bytes(buf)

    def _fetch_chunk(self, master, fid: str, collection: str) -> bytes:
        """One whole stored chunk, through the hot-read cache."""
        from ..cluster import operation

        key = chunk_key(getattr(master, "master_url", ""), fid)
        blob = self.chunk_cache.get(key)
        if blob is None:
            blob = operation.download(master, fid, collection)
            self.chunk_cache.put(key, blob, volume=fid_volume(fid))
        return blob

    def delete_file_and_chunks(self, path: str, master,
                               recursive: bool = False,
                               signatures: tuple = ()) -> None:
        entry = self.find_entry(path)
        if entry is None:
            raise FilerError(f"{path} not found")
        col = entry.attr.collection
        orphans = self.delete_entry(path, recursive=recursive,
                                    signatures=signatures)
        self._delete_chunks_via(master, orphans, col)

    def _delete_chunks_via(self, master, chunks: list[FileChunk],
                           collection: str) -> None:
        from ..cluster import operation

        master_url = getattr(master, "master_url", "")
        for fid in chunk_file_ids(chunks):
            # Cache first: a dead chunk must stop serving even when the
            # best-effort blob delete below fails.
            self.chunk_cache.invalidate(chunk_key(master_url, fid))
            try:
                operation.delete(master, fid, collection=collection)
            except Exception:
                pass  # blob GC is best-effort, like the reference's
