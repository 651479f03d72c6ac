"""Client for a filer: gRPC for metadata, HTTP for chunked data.

The port of ``seaweedfs_tpu/cluster/filer_client.py``: the data calls
run under ``filer.put`` / ``filer.get`` trace spans, and the HTTP call
carries the trace context to the filer.

The reference's gateways (S3, WebDAV, mount) all sit on filer.proto plus
the filer HTTP data path (SURVEY.md §2 "S3 gateway", "FUSE mount");
this is that access layer: entry CRUD over the filer gRPC service and
read/write of file bytes through the filer's HTTP API so the gateway
never re-implements chunking.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.parse
from typing import Iterator, Optional

from .. import pb
from ..pb import filer_pb2
from .master import _grpc_port
from ..util import faults, retry, tracing
from ..util import tls as tls_mod


def _with_signatures(query: str, signatures: tuple) -> str:
    """Append the loop-prevention chain as a ``signatures=a,b`` query
    param (the HTTP face of the rpc signatures field)."""
    if not signatures:
        return query
    sig_q = "signatures=" + ",".join(str(x) for x in signatures)
    return f"{query}&{sig_q}" if query else sig_q


class FilerClientError(RuntimeError):
    pass


class FilerClient:
    def __init__(self, filer_url: str):
        """``filer_url`` is the HTTP host:port; gRPC uses the port twin."""
        self.filer_url = filer_url
        self._lock = threading.Lock()
        self._channel = None

    def _stub(self) -> pb.Stub:
        faults.check("filer.meta")  # every metadata RPC passes here
        with self._lock:
            if self._channel is None:
                ip, http_port = self.filer_url.rsplit(":", 1)
                self._channel = tls_mod.dial(
                    f"{ip}:{_grpc_port(int(http_port))}")
            return pb.filer_stub(self._channel)

    def close(self) -> None:
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None

    # ---- metadata (gRPC) ----

    def lookup(self, directory: str, name: str
               ) -> Optional[filer_pb2.Entry]:
        resp = self._stub().LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(directory=directory,
                                                  name=name))
        return resp.entry if resp.entry.name else None

    def list(self, directory: str, prefix: str = "",
             start_from: str = "", limit: int = 0,
             inclusive: bool = False) -> Iterator[filer_pb2.Entry]:
        for r in self._stub().ListEntries(filer_pb2.ListEntriesRequest(
                directory=directory, prefix=prefix,
                start_from_file_name=start_from,
                inclusive_start_from=inclusive, limit=limit)):
            yield r.entry

    def create(self, directory: str, entry: filer_pb2.Entry,
               o_excl: bool = False,
               signatures: tuple = ()) -> None:
        resp = self._stub().CreateEntry(filer_pb2.CreateEntryRequest(
            directory=directory, entry=entry, o_excl=o_excl,
            signatures=list(signatures)))
        if resp.error:
            raise FilerClientError(resp.error)

    def mkdir(self, directory: str, name: str,
              signatures: tuple = ()) -> None:
        self.create(directory, filer_pb2.Entry(
            name=name, is_directory=True,
            attributes=filer_pb2.FuseAttributes(file_mode=0o770)),
            signatures=signatures)

    def delete(self, directory: str, name: str, recursive: bool = False,
               delete_data: bool = True,
               signatures: tuple = ()) -> None:
        resp = self._stub().DeleteEntry(filer_pb2.DeleteEntryRequest(
            directory=directory, name=name, is_recursive=recursive,
            is_delete_data=delete_data, signatures=list(signatures)))
        if resp.error:
            raise FilerClientError(resp.error)

    def rename(self, old_dir: str, old_name: str, new_dir: str,
               new_name: str, signatures: tuple = ()) -> None:
        self._stub().AtomicRenameEntry(filer_pb2.AtomicRenameEntryRequest(
            old_directory=old_dir, old_name=old_name,
            new_directory=new_dir, new_name=new_name,
            signatures=list(signatures)))

    def subscribe(self, path_prefix: str = "/", since_ns: int = 0,
                  client_name: str = "client"):
        """Raw SubscribeMetadata stream (blocking generator). The
        first yielded item is the filer's hello marker (entry-less);
        callers wanting change notifications can treat every item as
        'something happened under the prefix'."""
        yield from self._stub().SubscribeMetadata(
            filer_pb2.SubscribeMetadataRequest(
                client_name=client_name, path_prefix=path_prefix,
                since_ns=since_ns))

    def configuration(self) -> filer_pb2.GetFilerConfigurationResponse:
        """The filer's stable signature (+ default collection/
        replication) — filer.sync's loop-prevention token."""
        return self._stub().GetFilerConfiguration(
            filer_pb2.GetFilerConfigurationRequest())

    # ---- data (HTTP) ----

    def _url(self, path: str, query: str = "") -> str:
        quoted = urllib.parse.quote(path)
        return f"http://{self.filer_url}{quoted}" + \
            (f"?{query}" if query else "")

    def put_data(self, path: str, data: bytes, mime: str = "",
                 query: str = "", signatures: tuple = ()) -> dict:
        query = _with_signatures(query, signatures)
        headers = {"Content-Type": mime} if mime else None
        try:
            with tracing.span("filer.put", path=path) as sp:
                sp.n_bytes = len(data)
                r = retry.http_request(self._url(path, query), data=data,
                                       method="PUT", headers=headers,
                                       point="filer.data", timeout=120)
                return json.loads(r.data or b"{}")
        except urllib.error.HTTPError as e:
            raise FilerClientError(
                f"PUT {path}: {e.code} {e.read()!r}") from e

    def get_data(self, path: str, offset: int = 0,
                 length: Optional[int] = None) -> bytes:
        headers = {}
        if offset or length is not None:
            stop = "" if length is None else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{stop}"
        try:
            with tracing.span("filer.get", path=path) as sp:
                r = retry.http_request(self._url(path), headers=headers,
                                       point="filer.data", timeout=120)
                sp.n_bytes = len(r.data)
                return r.data
        except urllib.error.HTTPError as e:
            err = FilerClientError(f"GET {path}: {e.code}")
            err.code = e.code  # lets callers tell 404 from transient
            raise err from e

    def copy_data(self, src_path: str, dst_path: str, size: int,
                  mime: str = "", window: int = 32 * 1024 * 1024,
                  extended: Optional[dict] = None,
                  file_mode: int = 0) -> int:
        """Materialize ``dst_path`` as a byte copy of ``src_path`` so the
        destination owns FRESH chunks (sharing chunk file_ids would turn
        a later delete/overwrite of either file into silent data loss
        for the other). Windowed to bound memory on large files; windows
        after the first ride the filer's ``op=append``. ``extended`` /
        ``file_mode`` are carried onto the new entry afterwards.

        Self-copy is a no-op (the first window's overwrite would reclaim
        the source's own chunks and truncate it). The copy lands in a
        temp sibling entry and is swapped over ``dst_path`` only once
        complete — ANY mid-copy failure (short read, source deleted,
        source shrank) removes only the temp and raises, so a
        pre-existing destination is never destroyed or left truncated
        by a failed copy."""
        if src_path == dst_path:
            return 0
        dst_dir, _, dst_name = dst_path.rpartition("/")
        tmp_name = f".{dst_name}.copy-{os.getpid()}-{time.time_ns()}"
        tmp_path = f"{dst_dir}/{tmp_name}"
        # Sweep temps orphaned by a copier that died mid-copy (their
        # chunks would otherwise leak forever and show up in listings).
        # Concurrent copies to the SAME destination are undefined, so
        # any sibling matching the prefix is a leftover, not a peer.
        try:
            for e in self.list(dst_dir or "/",
                               prefix=f".{dst_name}.copy-"):
                self.delete_data(f"{dst_dir}/{e.name}")
        except Exception:  # noqa: BLE001 — sweep is best-effort
            pass
        off = 0
        try:
            if size == 0:
                self.put_data(tmp_path, b"", mime=mime)
            while off < size:
                data = self.get_data(src_path, off,
                                     min(window, size - off))
                if not data:
                    raise FilerClientError(
                        f"short read copying {src_path} at {off}/{size} "
                        "(source changed mid-copy)")
                self.put_data(tmp_path, data, mime=mime,
                              query="op=append" if off else "")
                off += len(data)
            if extended or file_mode:
                dup = self.lookup(dst_dir or "/", tmp_name)
                if dup is not None:
                    for k, v in (extended or {}).items():
                        dup.extended[k] = v
                    if file_mode:
                        dup.attributes.file_mode = file_mode
                    self.create(dst_dir or "/", dup)
        except Exception:
            try:
                self.delete_data(tmp_path)
            except Exception:  # noqa: BLE001 — never mask the cause
                pass
            raise
        # Swap in: reclaim the old destination's chunks, then move the
        # finished copy over the name. Past this point the copy is
        # complete — a failure must never delete it (once the old
        # destination is gone, the temp holds the only copy).
        try:
            self.delete_data(dst_path)
        except Exception:
            try:
                self.delete_data(tmp_path)  # dst intact; drop the temp
            except Exception:  # noqa: BLE001
                pass
            raise
        try:
            self.rename(dst_dir or "/", tmp_name, dst_dir or "/",
                        dst_name)
        except Exception as e:
            try:
                self.rename(dst_dir or "/", tmp_name, dst_dir or "/",
                            dst_name)
            except Exception:
                raise FilerClientError(
                    f"copied {src_path} but failed to move into place; "
                    f"complete copy preserved at {tmp_path}") from e
        return off

    def delete_data(self, path: str, recursive: bool = False,
                    signatures: tuple = ()) -> None:
        q = _with_signatures("recursive=true" if recursive else "",
                             signatures)
        try:
            retry.http_request(self._url(path, q), method="DELETE",
                               point="filer.data", timeout=120)
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise FilerClientError(
                    f"DELETE {path}: {e.code}") from e
