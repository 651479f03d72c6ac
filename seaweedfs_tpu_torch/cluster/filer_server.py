"""Filer server: HTTP path API + filer gRPC service over a Filer.

Mirrors weed/server/filer_server*.go + filer_grpc_server*.go (SURVEY.md
§2 "Filer server"): HTTP GET resolves an entry's chunk list and streams
the bytes back from volume servers; PUT/POST auto-chunk the body through
assign+upload before committing the entry; DELETE reclaims chunks.
Directory GETs return JSON listings. The gRPC side exposes the
filer.proto contract (lookup/list/create/update/delete/rename/subscribe)
for programmatic clients (mount, S3 gateway, replication).

The port of ``seaweedfs_tpu/cluster/filer_server.py``. The filer runs no
kernel: its reads go through the process's chunk cache to the volume
servers, whose EC reads repair on their own devices. Each filer's chunk
cache subscribes to the master's invalidation hub
(``invalidation.start_subscriber``). Every HTTP verb runs under a
``filer.<VERB>`` trace root continuing the caller's context, slow or
errored roots are pushed to the master's collector, and
``/debug/traces``, ``/debug/profile`` and ``/debug/vars`` describe the
process; ``-config`` applies ``[tracing]`` and ``[profiler]``. Every
request lands in the filer's usage collector (tenant ``anonymous``, the
bucket of a ``/buckets/<name>/...`` path), which a pusher ships to the
master's ``POST /cluster/usage`` as the JAX filer does; ``[usage]``
switches it.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

from .. import pb
from ..cache import invalidation as invalidation_mod
from ..filer import Filer, FilerError
from ..filer import path_conf as path_conf_mod
from ..filer.entry import Attr, Entry, FileChunk, normalize_path
from ..filer.filechunks import total_size
from ..filer.stores import MemoryStore, SqliteStore
from ..pb import filer_pb2
from ..util import faults as faults_mod
from ..util import glog
from ..util import httpserver
from ..util import profiler, retry, tracing, varz
from ..util.stats import EXPOSITION_CONTENT_TYPE, Metrics
from . import usage as usage_mod
from .master import _grpc_port
from .wdclient import MasterClient
from ..util import tls as tls_mod


class FilerServer:
    def __init__(self, filer: Filer, ip: str = "127.0.0.1",
                 port: int = 8888, master_url: str = "",
                 collection: str = "", replication: str = ""):
        self.filer = filer
        self.ip = ip
        self.port = port
        self.url = f"{ip}:{port}"
        self.master_url = master_url
        self.collection = collection
        self.replication = replication
        self.master = MasterClient(master_url) if master_url else None
        self.metrics = Metrics(namespace="filer")
        #: Process epoch (unix ns): exposed via GetFilerConfiguration
        #: so resuming followers can detect that the in-memory
        #: meta-log restarted and a gap-free resume is impossible.
        import time as _time
        self.started_ns = _time.time_ns()
        #: Per-path storage rules (filer.conf; shell fs.configure).
        #: Loaded at start and re-read on changes via the filer's own
        #: meta stream — empty when no conf exists.
        self.path_conf = path_conf_mod.PathConf()
        #: Traffic accounting (usage plane): the filer has no tenant
        #: auth, so rows land under "anonymous" with the bucket drawn
        #: from /buckets/<name> paths; a pusher ships the cumulative
        #: snapshot to the master (the filer does not heartbeat).
        self.usage = usage_mod.UsageCollector("filer")
        self._usage_pusher: Optional[usage_mod.UsagePusher] = None
        self._conf_stop = threading.Event()
        self._grpc_server = None
        self._http_server: Optional[httpserver.IngressHTTPServer] = None
        self._threads: list[threading.Thread] = []

    def _load_path_conf(self) -> None:
        if self.master is None:
            return  # conf content lives in chunks; no master, no read
        try:
            raw = self.filer.read_file(
                path_conf_mod.FILER_CONF_PATH, self.master)
        except FilerError:
            # whole-object rebind of an immutable PathConf: readers
            # see the old or the new set, never a mix
            # seaweedlint: disable=SW801 — atomic reference swap
            self.path_conf = path_conf_mod.PathConf()  # confirmed gone
            return
        except Exception as e:  # noqa: BLE001 — keep previous rules
            glog.warning("filer: cannot read %s (%s); keeping %d "
                         "path rules", path_conf_mod.FILER_CONF_PATH,
                         e, len(self.path_conf))
            return
        try:
            self.path_conf = path_conf_mod.PathConf.parse(raw)
            glog.info("filer: %d path rule(s) from %s",
                      len(self.path_conf),
                      path_conf_mod.FILER_CONF_PATH)
        except ValueError as e:
            glog.warning("filer: bad %s: %s (keeping %d path rules)",
                         path_conf_mod.FILER_CONF_PATH, e,
                         len(self.path_conf))

    def _follow_path_conf(self) -> None:
        """In-process subscription to this filer's own meta stream,
        reloading the rules whenever the conf directory changes."""
        first = True
        while not self._conf_stop.is_set():
            try:
                if not first:
                    # changes delivered during the gap (overflow,
                    # error) replay nowhere — re-read the conf on
                    # every re-attach
                    self._load_path_conf()
                first = False
                for ev in self.filer.subscribe(stop=self._conf_stop):
                    if self._conf_stop.is_set():
                        return
                    if ev.directory.startswith(
                            path_conf_mod.FILER_CONF_DIR):
                        self._load_path_conf()
            except Exception:  # noqa: BLE001 — overflow: resubscribe
                if self._conf_stop.wait(0.5):
                    return

    # ------------- lifecycle -------------

    def start(self) -> "FilerServer":
        import grpc

        self._grpc_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16))
        self._grpc_server.add_generic_rpc_handlers((pb.generic_handler(
            pb.FILER_SERVICE, pb.FILER_METHODS, _FilerServicer(self)),))
        bound = tls_mod.serve_port(
            self._grpc_server, f"{self.ip}:{_grpc_port(self.port)}")
        if bound == 0:
            raise RuntimeError(
                f"cannot bind filer grpc port {_grpc_port(self.port)}")
        self._grpc_server.start()

        handler = _make_http_handler(self)
        self._http_server = httpserver.IngressHTTPServer(
            (self.ip, self.port), handler, component="filer")
        t = threading.Thread(target=self._http_server.serve_forever,
                             daemon=True, name=f"filer-http-{self.port}")
        t.start()
        self._threads.append(t)
        if self.master_url:
            # Slow/errored filer roots join the master's stitched view.
            tracing.configure_push(self.master_url, node=self.url,
                                   component="filer")
            self._usage_pusher = usage_mod.UsagePusher(
                self.usage, self.master_url, self.url).start()
            # Job-commit cache invalidation: register this filer's
            # chunk cache for the master's fan-out (docs/jobs.md).
            invalidation_mod.start_subscriber(self.master_url,
                                              self.url,
                                              self._conf_stop)
        self._load_path_conf()
        t = threading.Thread(target=self._follow_path_conf,
                             daemon=True,
                             name=f"filer-conf-{self.port}")
        t.start()
        self._threads.append(t)
        glog.info("filer started at %s (grpc %d)", self.url,
                  _grpc_port(self.port))
        return self

    def stop(self) -> None:
        self._conf_stop.set()
        if self._usage_pusher is not None:
            self._usage_pusher.stop()
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5).wait(timeout=2)
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self.master:
            self.master.close()
        self.filer.store.close()

    def __enter__(self) -> "FilerServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------- pb <-> model conversion -------------

def entry_to_pb(e: Entry) -> filer_pb2.Entry:
    out = filer_pb2.Entry(
        name=e.name, is_directory=e.is_dir,
        attributes=filer_pb2.FuseAttributes(
            file_size=total_size(e.chunks), mtime=int(e.attr.mtime),
            file_mode=e.attr.mode, uid=e.attr.uid, gid=e.attr.gid,
            crtime=int(e.attr.crtime), mime=e.attr.mime,
            replication=e.attr.replication, collection=e.attr.collection,
            ttl_sec=e.attr.ttl_sec))
    for c in e.chunks:
        out.chunks.add(file_id=c.file_id, offset=c.offset, size=c.size,
                       mtime_ns=c.mtime_ns, etag=c.etag)
    for k, v in e.extended.items():
        out.extended[k] = v.encode() if isinstance(v, str) else v
    return out


def pb_to_entry(directory: str, p: filer_pb2.Entry) -> Entry:
    import time as _time

    a = p.attributes
    # an unset timestamp means "now", like the HTTP write path — a raw
    # 0 would make gRPC-created entries look 55 years idle to age-based
    # sweeps (s3.clean.uploads, volume.deleteEmpty analogs)
    now = _time.time()
    return Entry(
        path=normalize_path(f"{directory}/{p.name}"),
        attr=Attr(mtime=float(a.mtime or now),
                  crtime=float(a.crtime or now),
                  mode=a.file_mode or 0o660, uid=a.uid, gid=a.gid,
                  mime=a.mime, ttl_sec=a.ttl_sec,
                  collection=a.collection, replication=a.replication,
                  is_dir=p.is_directory),
        chunks=[FileChunk(file_id=c.file_id, offset=c.offset,
                          size=c.size, mtime_ns=c.mtime_ns, etag=c.etag)
                for c in p.chunks],
        extended={k: v.decode("utf-8", "replace")
                  for k, v in p.extended.items()})


class _FilerServicer:
    """filer.proto handlers, 1:1 with filer_grpc_server.go."""

    def __init__(self, fs: FilerServer):
        self.fs = fs

    def LookupDirectoryEntry(self, request, context):
        e = self.fs.filer.find_entry(
            f"{request.directory}/{request.name}")
        resp = filer_pb2.LookupDirectoryEntryResponse()
        if e is not None:
            resp.entry.CopyFrom(entry_to_pb(e))
        return resp

    def ListEntries(self, request, context):
        limit = request.limit or (1 << 30)
        start = request.start_from_file_name
        if request.inclusive_start_from and start:
            e = self.fs.filer.find_entry(f"{request.directory}/{start}")
            if e is not None and (not request.prefix
                                  or e.name.startswith(request.prefix)):
                yield filer_pb2.ListEntriesResponse(entry=entry_to_pb(e))
                limit -= 1
        count = 0
        for e in self.fs.filer.list_entries(request.directory, start):
            if count >= limit:
                break
            if request.prefix and not e.name.startswith(request.prefix):
                continue
            yield filer_pb2.ListEntriesResponse(entry=entry_to_pb(e))
            count += 1

    def CreateEntry(self, request, context):
        resp = filer_pb2.CreateEntryResponse()
        try:
            self.fs.filer.create_entry(
                pb_to_entry(request.directory, request.entry),
                o_excl=request.o_excl,
                signatures=tuple(request.signatures))
        except FilerError as e:
            resp.error = str(e)
        return resp

    def UpdateEntry(self, request, context):
        self.fs.filer.update_entry(
            pb_to_entry(request.directory, request.entry),
            signatures=tuple(request.signatures))
        return filer_pb2.UpdateEntryResponse()

    def DeleteEntry(self, request, context):
        resp = filer_pb2.DeleteEntryResponse()
        path = f"{request.directory}/{request.name}"
        try:
            if request.is_delete_data and self.fs.master is not None:
                self.fs.filer.delete_file_and_chunks(
                    path, self.fs.master,
                    recursive=request.is_recursive,
                    signatures=tuple(request.signatures))
            else:
                self.fs.filer.delete_entry(
                    path, recursive=request.is_recursive,
                    signatures=tuple(request.signatures))
        except FilerError as e:
            resp.error = str(e)
        return resp

    def AtomicRenameEntry(self, request, context):
        self.fs.filer.rename(
            f"{request.old_directory}/{request.old_name}",
            f"{request.new_directory}/{request.new_name}",
            signatures=tuple(request.signatures))
        return filer_pb2.AtomicRenameEntryResponse()

    def GetFilerConfiguration(self, request, context):
        return filer_pb2.GetFilerConfigurationResponse(
            signature=self.fs.filer.signature,
            collection=self.fs.collection,
            replication=self.fs.replication,
            started_ns=self.fs.started_ns)

    def SubscribeMetadata(self, request, context):
        stop = threading.Event()
        # Fires when the client cancels or the server shuts down; without
        # it a cancelled stream would park this executor thread in the
        # subscribe wait-loop forever and block process exit.
        context.add_callback(stop.set)
        prefix = request.path_prefix or "/"
        excluded = set(request.signatures)
        for ev in self.fs.filer.subscribe(stop,
                                          since_ns=request.since_ns,
                                          hello=True):
            if not context.is_active():
                stop.set()
                return
            want = "/" if prefix == "/" else normalize_path(prefix) + "/"
            is_hello = ev.old_entry is None and ev.new_entry is None
            # the hello marker (entry-less, ts = this filer's clock at
            # registration) always passes the prefix filter — followers
            # use it as an attach barrier + skew-free resume point
            if not is_hello and not (ev.directory + "/").startswith(want):
                continue
            # loop-prevention filter: a subscriber names the filers
            # whose changes it must not see again (filer.sync passes
            # its apply target's signature)
            if excluded and excluded & set(ev.signatures):
                continue
            note = filer_pb2.EventNotification(
                delete_chunks=ev.new_entry is None)
            note.signatures.extend(ev.signatures)
            if ev.old_entry is not None:
                note.old_entry.CopyFrom(entry_to_pb(ev.old_entry))
            if ev.new_entry is not None:
                note.new_entry.CopyFrom(entry_to_pb(ev.new_entry))
            yield filer_pb2.SubscribeMetadataResponse(
                directory=ev.directory, event_notification=note,
                ts_ns=ev.ts_ns)


# ------------- HTTP -------------


def _bucket_of(path: str) -> str:
    """Bucket attribution for usage rows: /buckets/<name>/... paths
    (the S3 gateway's layout) map to <name>; everything else is ''."""
    parts = path.strip("/").split("/")
    if len(parts) >= 2 and parts[0] == "buckets":
        return parts[1]
    return ""


def _parse_signatures(q: dict) -> tuple:
    """``signatures=12,34`` query param -> int tuple (the HTTP face of
    the rpc signatures field; non-numeric values are ignored)."""
    raw = q.get("signatures", "")
    out = []
    for part in raw.split(","):
        part = part.strip()
        if part.lstrip("-").isdigit():
            out.append(int(part))
    return tuple(out)

def _make_http_handler(fs: FilerServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "seaweedfs-tpu-filer"

        def log_message(self, fmt, *args):
            glog.v(2, "filer http: " + fmt, *args)

        def _path(self) -> tuple[str, dict]:
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            return normalize_path(unquote(u.path)), q

        def _send(self, code: int, body: bytes = b"",
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _err(self, code: int, msg: str) -> None:
            self._send(code, json.dumps({"error": msg}).encode())

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/metrics":
                self._send(200, (fs.metrics.render()
                                 + tracing.METRICS.render()
                                 + retry.METRICS.render()
                                 + httpserver.METRICS.render()).encode(),
                           EXPOSITION_CONTENT_TYPE)
                return
            if u.path == "/debug/traces":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                self._send(200, json.dumps(tracing.debug_payload(
                    int(q["limit"]) if "limit" in q else None)).encode())
                return
            if u.path == "/debug/profile":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                self._send(200, profiler.profile(
                    float(q.get("seconds", 2.0)),
                    hz=float(q.get("hz", profiler.DEFAULT_BURST_HZ))
                ).encode(), "text/plain; charset=utf-8")
                return
            if u.path == "/debug/vars":
                self._send(200, json.dumps(varz.payload(
                    "filer", fs.metrics,
                    extra={"usage": fs.usage.to_payload()})).encode())
                return
            dl = retry.deadline_from_headers(self.headers)
            if dl is not None and dl.expired():
                self._err(504, "caller deadline already exhausted")
                return
            path, q = self._path()
            fs.metrics.counter("request_total", method="GET").inc()
            t0 = time.perf_counter()
            entry = fs.filer.find_entry(path)
            if entry is None:
                fs.usage.record("anonymous", _bucket_of(path),
                                error=True, key=path)
                self._err(404, f"{path} not found")
                return
            if entry.is_dir:
                limit = int(q.get("limit", "10000"))
                last = q.get("lastFileName", "")
                items = [e.to_dict() for e in
                         fs.filer.list_entries(path, last, limit)]
                self._send(200, json.dumps(
                    {"path": path, "entries": items,
                     "lastFileName":
                         items[-1]["path"].rsplit("/", 1)[-1]
                         if items else ""}).encode())
                return
            if fs.master is None:
                self._err(500, "filer has no master connection")
                return
            size = total_size(entry.chunks)
            offset, length = 0, size
            rng = _parse_range(self.headers.get("Range"), size)
            if rng is not None:
                offset, length = rng
            # Adopt the caller's remaining deadline budget (sent beside
            # the trace header) so downstream volume reads and their
            # retries never outlive the caller's patience.
            with retry.deadline_scope(
                    retry.deadline_from_headers(self.headers)):
                data = fs.filer.read_file(path, fs.master, offset,
                                          length)
            ctype = entry.attr.mime or "application/octet-stream"
            self.send_response(206 if rng is not None else 200)
            if rng is not None:
                self.send_header(
                    "Content-Range",
                    f"bytes {offset}-{offset + len(data) - 1}/{size}")
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            fs.usage.record("anonymous", _bucket_of(path),
                            n_out=len(data),
                            seconds=time.perf_counter() - t0, key=path)

        def do_HEAD(self):
            path, _ = self._path()
            entry = fs.filer.find_entry(path)
            if entry is None:
                self._send(404)
                return
            self.send_response(200)
            self.send_header("Content-Length",
                             str(total_size(entry.chunks)))
            if entry.attr.mime:
                self.send_header("Content-Type", entry.attr.mime)
            self.end_headers()

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n) if n else b""

        def do_PUT(self):
            self._upload()

        def do_POST(self):
            if urlparse(self.path).path == "/cache/invalidate":
                # Maintenance-job fan-out (docs/jobs.md): drop cached
                # chunks of a volume a job just rewrote.
                try:
                    self._send(200, json.dumps(
                        invalidation_mod.handle_event(
                            json.loads(self._read_body() or b"{}"))
                    ).encode())
                except (ValueError, KeyError) as e:
                    self._err(400, str(e))
                return
            self._upload()

        def _upload(self):
            path, q = self._path()
            fs.metrics.counter("request_total", method="PUT").inc()
            t0 = time.perf_counter()
            if q.get("mkdir") == "true" or self.path.rstrip("?").endswith(
                    "/") and not self._body_expected():
                fs.filer.create_entry(Entry(
                    path=path, attr=Attr(is_dir=True, mode=0o770)),
                    signatures=_parse_signatures(q))
                self._send(201, b"{}")
                return
            if fs.master is None:
                self._err(500, "filer has no master connection")
                return
            body = self._read_body()
            ctype = self.headers.get("Content-Type", "")
            raw_dir_target = urlparse(self.path).path.endswith("/")
            if ctype.startswith("multipart/form-data"):
                body, fname = _first_multipart_file(body, ctype)
                if fname and raw_dir_target:
                    # normalize_path stripped the trailing slash; the raw
                    # URL says "store INTO this directory".
                    path = normalize_path(path + "/" + fname)
            # per-path rules (filer.conf): explicit query params win,
            # then the longest matching locationPrefix, then the
            # server-wide flags
            rule = fs.path_conf.match(path)
            col = q.get("collection") or \
                (rule.collection if rule else "") or fs.collection
            rep = q.get("replication") or \
                (rule.replication if rule else "") or fs.replication
            ttl = q.get("ttl") or (rule.ttl if rule else "")
            if ttl:
                from ..storage.superblock import Ttl
                try:
                    Ttl.parse(ttl)
                except ValueError:
                    self._err(400, f"bad ttl {ttl!r}")
                    return
            try:
                with retry.deadline_scope(
                        retry.deadline_from_headers(self.headers)):
                    entry = fs.filer.write_file(
                        path, body, fs.master,
                        collection=col,
                        replication=rep,
                        ttl=ttl,
                        mime=ctype if not ctype.startswith(
                            "multipart/") else "",
                        chunk_size=int(q["maxMB"]) * 1024 * 1024
                        if "maxMB" in q else None,
                        append=q.get("op") == "append",
                        signatures=_parse_signatures(q))
            except FilerError as e:
                fs.usage.record("anonymous", _bucket_of(path),
                                n_in=len(body), error=True, key=path)
                self._err(409, str(e))
                return
            except ValueError as e:
                # bad replication/ttl reaching the assign path (e.g. a
                # typo'd filer.conf rule) must be an HTTP error, not an
                # aborted connection
                fs.usage.record("anonymous", _bucket_of(path),
                                n_in=len(body), error=True, key=path)
                self._err(400, str(e))
                return
            self._send(201, json.dumps(
                {"name": entry.name,
                 "size": total_size(entry.chunks)}).encode())
            fs.usage.record("anonymous", _bucket_of(path),
                            n_in=len(body),
                            seconds=time.perf_counter() - t0, key=path)

        def _body_expected(self) -> bool:
            return int(self.headers.get("Content-Length", "0")) > 0

        def do_DELETE(self):
            path, q = self._path()
            fs.metrics.counter("request_total", method="DELETE").inc()
            recursive = q.get("recursive") == "true"
            sigs = _parse_signatures(q)
            try:
                if fs.master is not None:
                    fs.filer.delete_file_and_chunks(path, fs.master,
                                                    recursive=recursive,
                                                    signatures=sigs)
                else:
                    fs.filer.delete_entry(path, recursive=recursive,
                                          signatures=sigs)
            except FilerError as e:
                fs.usage.record("anonymous", _bucket_of(path),
                                error=True)
                self._err(404 if "not found" in str(e) else 409, str(e))
                return
            self._send(204)
            fs.usage.record("anonymous", _bucket_of(path))

    return tracing.instrument_http_handler(
        httpserver.admission_gate(Handler), "filer")


#: The single-range parser now lives in util/httpserver.py so the
#: filer, volume-server and S3 tiers slice ``bytes=a-b`` identically.
_parse_range = httpserver.parse_range


def _first_multipart_file(body: bytes, ctype: str) -> tuple[bytes, str]:
    """Minimal multipart/form-data parse: first file part's bytes+name."""
    import email.parser
    import email.policy

    msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body)
    for part in msg.iter_parts():
        payload = part.get_payload(decode=True)
        if payload is not None:
            return payload, part.get_filename() or ""
    return b"", ""


def apply_config(conf: dict) -> None:
    """Apply a loaded ``-config`` TOML: ``[grpc.tls]``, ``[tracing]``,
    ``[retry]``, ``[faults]``, ``[storage]`` (the fsync policy),
    ``[profiler]`` (and start its sampler when enabled), ``[usage]`` and
    ``[ingress]``."""
    from ..util import durability as durability_mod

    tls_mod.install_from_config(conf)
    tracing.configure_from(conf)
    retry.configure_from(conf)
    faults_mod.configure_from(conf)
    durability_mod.configure_from(conf)
    profiler.configure_from(conf)
    usage_mod.configure_from(conf)
    httpserver.configure_from(conf)
    profiler.ensure_started()


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m seaweedfs_tpu_torch filer`` (weed/command/filer.go).

    Serves until SIGINT or SIGTERM, then stops cleanly. Exit 2: a bad
    flag or ``-config`` (one ``error:`` line)."""
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(prog="filer")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-db", default="",
                   help="sqlite metadata path (default: in-memory)")
    p.add_argument("-notify.file", dest="notify_file", default="",
                   help="append metadata events to this JSON-lines file")
    p.add_argument("-notify.webhook", dest="notify_webhook", default="",
                   help="POST metadata events to this URL")
    p.add_argument("-config", default="",
                   help="TOML: [grpc.tls], [tracing], [retry], [faults], "
                        "[storage], [profiler], [usage], [ingress]")
    args = p.parse_args(argv)
    from ..util import config as config_mod
    try:
        conf = config_mod.load(args.config) if args.config else {}
        apply_config(conf)
    except (OSError, TypeError, ValueError) as e:
        print(f"error: -config {args.config}: {e}", file=sys.stderr)
        return 2
    store = SqliteStore(args.db) if args.db else MemoryStore()
    filer = Filer(store)
    server = FilerServer(filer, ip=args.ip, port=args.port,
                         master_url=args.master,
                         collection=args.collection,
                         replication=args.replication)
    # Notifiers subscribe BEFORE the server opens its ports and stop
    # AFTER it closes them, so no mutation at either lifecycle edge can
    # slip past the bridge unobserved.
    notifiers = []
    if args.notify_file or args.notify_webhook:
        from ..notification import (FilerNotifier, HttpWebhookQueue,
                                    LogFileQueue)
        if args.notify_file:
            notifiers.append(FilerNotifier(
                filer, LogFileQueue(args.notify_file)).start())
        if args.notify_webhook:
            notifiers.append(FilerNotifier(
                filer, HttpWebhookQueue(args.notify_webhook)).start())
    server.start()
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    server.stop()
    for n in notifiers:
        n.stop()
    return 0
