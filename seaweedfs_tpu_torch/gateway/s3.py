"""S3 REST gateway over the filer (weed/s3api analog, SURVEY.md §2).

Buckets are directories under ``/buckets`` on the filer, objects are
filer entries beneath them — the reference's layout. Supported surface:
bucket CRUD + listing, object PUT/GET/HEAD/DELETE with ranges,
CopyObject, ListObjectsV1/V2 (prefix, delimiter, continuation, max-keys)
and multipart uploads. Multipart "complete" is metadata-only: each
part's chunk list is re-offset and concatenated into the final entry, so
terabyte objects assemble without moving a byte — the chunked-entry
design makes the reference's part-merge copy unnecessary.

Auth: AWS SigV4 (header or presigned) against identities from an
s3-config JSON; with no identities the gateway is open (reference
default).

The port of ``seaweedfs_tpu/gateway/s3.py``: the same routes, status
codes, XML bodies, cache keys and readahead, over the port's filer
client. The gateway runs no kernel: a degraded read is repaired by the
volume servers under the filer (``ClusterEcReader``), on their devices.
Every verb runs under an ``s3.<VERB>`` trace root, ``-toml`` applies
``[tracing]`` and ``[profiler]``, and ``/debug/vars`` and
``/debug/profile`` describe the process. Every request lands in the
gateway's per-tenant usage collector (tenant = the SigV4 identity), which
a pusher ships to the master's ``POST /cluster/usage``. ``-securityConfig``
installs ``[grpc.tls]`` client credentials for the filer's gRPC plane,
as the other tools' flag does.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from typing import Optional

from ..cache import invalidation as invalidation_mod
from ..cache import readahead as readahead_mod
from ..cluster import usage as usage_mod
from ..cluster.filer_client import FilerClient, FilerClientError
from ..pb import filer_pb2
from ..util import glog
from ..util import httpserver
from ..util import profiler, tracing, varz
from ..util.stats import Metrics
from .s3_auth import AuthError, Identity, SigV4Verifier

BUCKETS_DIR = "/buckets"
#: Filer-stored gateway config (the reference keeps its s3 identities
#: in the filer and the gateway subscribes for live reloads; shell
#: `s3.configure` edits this file).
S3_CONF_PATH = "/etc/s3/identities.json"
UPLOADS_DIR = ".uploads"
XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + \
        ET.tostring(root)


def _error_xml(code: str, message: str, resource: str) -> bytes:
    e = ET.Element("Error")
    ET.SubElement(e, "Code").text = code
    ET.SubElement(e, "Message").text = message
    ET.SubElement(e, "Resource").text = resource
    return _xml(e)


_STATUS = {"NoSuchBucket": 404, "NoSuchKey": 404, "NoSuchUpload": 404,
           "BucketAlreadyExists": 409, "BucketNotEmpty": 409,
           "AccessDenied": 403, "InvalidAccessKeyId": 403,
           "SignatureDoesNotMatch": 403, "InvalidArgument": 400,
           "AuthorizationHeaderMalformed": 400,
           "AuthorizationQueryParametersError": 400,
           "InvalidPart": 400, "MalformedXML": 400,
           "InvalidRange": 416, "RequestTimeTooSkewed": 403,
           "InternalError": 500}


class S3Error(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code
        self.message = message or code


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


class S3Gateway:
    def __init__(self, filer_url: str, ip: str = "127.0.0.1",
                 port: int = 8333,
                 identities: Optional[list[Identity]] = None,
                 master_url: str = "",
                 qos: Optional[httpserver.QosEngine] = None):
        self.filer = FilerClient(filer_url)
        self.ip = ip
        self.port = port
        self.url = f"{ip}:{port}"
        #: The master whose cache-invalidation hub this gateway's chunk
        #: cache subscribes to, and where its usage is pushed.
        self.master_url = master_url
        #: Per-tenant traffic accounting (tenant = the SigV4 identity
        #: name; "anonymous" on an open gateway). Pushed to the master
        #: when one is configured — the gateway does not heartbeat.
        self.usage = usage_mod.UsageCollector("s3")
        self._usage_pusher: Optional[usage_mod.UsagePusher] = None
        #: identities passed explicitly (-config file) are static; with
        #: none, the gateway follows the filer-stored config and
        #: reloads it live (the reference's s3.configure flow)
        self.static_identities = identities is not None
        self.auth = SigV4Verifier(identities)
        self.metrics = Metrics(namespace="s3")
        #: per-tenant QoS ladder ([qos] in the server TOML); None =
        #: no classes configured, gateway sheds on raw pressure like
        #: the other components
        self.qos = qos
        self._http_server: Optional[httpserver.IngressHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conf_stop = threading.Event()
        self._conf_thread: Optional[threading.Thread] = None
        #: becomes True after the first DEFINITIVE config read (loaded
        #: or confirmed absent); before that, transient filer errors
        #: leave the gateway deny-all instead of open
        self._conf_loaded = False
        #: Ranged-read readahead: one window per
        #: (path, etag) byte stream, LRU-bounded so churning keys can't
        #: grow state; block cache keys inserted by prefetch and not
        #: yet read live in _ra_prefetched for hit/wasted accounting.
        self._ra_lock = threading.Lock()
        self._ra_windows: OrderedDict[str, object] = OrderedDict()
        self._ra_prefetched: set[str] = set()
        #: block key -> Event set when its in-flight prefetch lands;
        #: a foreground miss WAITS on this instead of re-fetching the
        #: same block the prefetcher already has on the wire
        self._ra_inflight: dict[str, threading.Event] = {}

    def _load_filer_identities(self) -> None:
        try:
            raw = self.filer.get_data(S3_CONF_PATH)
        except Exception as e:  # noqa: BLE001
            if getattr(e, "code", None) == 404:
                # confirmed absent: the operator removed the config,
                # gateway runs open (reference default without config)
                self.auth.set_identities(None)
                # one-way bool latch; both writers only ever set True
                # seaweedlint: disable=SW801 — idempotent latch
                self._conf_loaded = True
            elif self._conf_loaded:
                # transient (filer restart, network): auth must NOT
                # fail open — keep the previous identity set
                glog.warning("s3: cannot read %s (%s); keeping "
                             "previous identities", S3_CONF_PATH, e)
            else:
                # never read a definitive state: deny everything
                # rather than starting open with a config possibly
                # present but unreadable
                glog.warning("s3: cannot read %s (%s); denying all "
                             "requests until the filer answers",
                             S3_CONF_PATH, e)
                self.auth.set_unavailable()
            return
        try:
            import json as json_mod
            idents = parse_identities(json_mod.loads(raw))
        except Exception as e:  # noqa: BLE001 — keep the old set
            glog.warning("s3: bad %s: %s (keeping previous identities)",
                         S3_CONF_PATH, e)
            return
        self.auth.set_identities(idents)
        self._conf_loaded = True
        glog.info("s3: loaded %d identities from filer %s",
                  len(idents), S3_CONF_PATH)

    def _follow_conf(self) -> None:
        """Reload identities whenever the filer-stored config changes
        (SubscribeMetadata on its directory; reconnect with backoff)."""
        conf_dir = S3_CONF_PATH.rsplit("/", 1)[0]
        while not self._conf_stop.is_set():
            try:
                attached = False
                for resp in self.filer.subscribe(
                        path_prefix=conf_dir,
                        client_name=f"s3-{self.port}"):
                    if self._conf_stop.is_set():
                        return
                    if not attached:
                        # the stream's hello marker: re-read the config
                        # once per (re)attach, covering changes made
                        # while we were detached (live-only streams
                        # replay nothing)
                        attached = True
                        self._load_filer_identities()
                        continue
                    note = resp.event_notification
                    if note.new_entry.name or note.old_entry.name:
                        self._load_filer_identities()
            except Exception as e:  # noqa: BLE001 — filer restart etc.
                glog.v(1, "s3 identity watch stream broke: %s", e)
            # stream ended (error OR clean server-side return): pause
            # before re-attaching so a lagging/shutting-down filer is
            # not hammered in a tight loop
            if self._conf_stop.wait(1.0):
                return

    def start(self) -> "S3Gateway":
        if not self.static_identities:
            self._load_filer_identities()
            self._conf_thread = threading.Thread(
                target=self._follow_conf, daemon=True,
                name=f"s3-conf-{self.port}")
            self._conf_thread.start()
        handler = _make_handler(self)
        self._http_server = httpserver.IngressHTTPServer(
            (self.ip, self.port), handler, component="s3")
        # class-aware shedding replaces the generic pressure 429 (the
        # admission gate skips it when .qos is set, so guaranteed
        # tenants are never blind-shed before authentication)
        self._http_server.qos = self.qos
        self._thread = threading.Thread(
            target=self._http_server.serve_forever, daemon=True,
            name=f"s3-{self.port}")
        self._thread.start()
        if self.master_url:
            self._usage_pusher = usage_mod.UsagePusher(
                self.usage, self.master_url, f"s3@{self.url}").start()
            # Job-commit cache invalidation: register this gateway's
            # chunk cache for the master's fan-out.
            invalidation_mod.start_subscriber(self.master_url,
                                              self.url,
                                              self._conf_stop)
        glog.info("s3 gateway at %s -> filer %s", self.url,
                  self.filer.filer_url)
        return self

    def stop(self) -> None:
        self._conf_stop.set()
        if self._usage_pusher is not None:
            self._usage_pusher.stop()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        self.filer.close()

    def __enter__(self) -> "S3Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def account(self, ident, bucket: str, key: str, *,
                n_in: int = 0, n_out: int = 0, seconds: float = 0.0,
                error: bool = False) -> None:
        """One usage row per request; object keys feed the hot-key
        sketch as ``bucket/key`` so /cluster/topk can attribute them."""
        self.usage.record(
            ident.name if ident is not None else "anonymous", bucket,
            n_in=n_in, n_out=n_out, seconds=seconds, error=error,
            key=f"{bucket}/{key}" if bucket and key else "")

    # ---- bucket ops ----

    def list_buckets(self, ident=None) -> bytes:
        root = ET.Element("ListAllMyBucketsResult", xmlns=XMLNS)
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "seaweedfs-tpu"
        buckets = ET.SubElement(root, "Buckets")
        for e in self.filer.list(BUCKETS_DIR):
            if not e.is_directory or e.name == UPLOADS_DIR:
                continue
            if ident is not None and not (
                    ident.can("Read", e.name) or
                    ident.can("Write", e.name)):
                # scoped identities see only buckets they can touch
                # (weed s3api filters the listing the same way)
                continue
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = e.name
            ET.SubElement(b, "CreationDate").text = _iso(
                e.attributes.crtime or e.attributes.mtime)
        return _xml(root)

    def create_bucket(self, bucket: str) -> None:
        if self.filer.lookup(BUCKETS_DIR, bucket) is not None:
            raise S3Error("BucketAlreadyExists", bucket)
        self.filer.mkdir(BUCKETS_DIR, bucket)

    def delete_bucket(self, bucket: str) -> None:
        self._require_bucket(bucket)
        if next(iter(self.filer.list(f"{BUCKETS_DIR}/{bucket}",
                                     limit=1)), None) is not None:
            raise S3Error("BucketNotEmpty", bucket)
        self.filer.delete(BUCKETS_DIR, bucket, recursive=True)

    def _require_bucket(self, bucket: str) -> None:
        if self.filer.lookup(BUCKETS_DIR, bucket) is None:
            raise S3Error("NoSuchBucket", bucket)

    # ---- object listing ----

    def list_objects(self, bucket: str, q: dict, v2: bool) -> bytes:
        self._require_bucket(bucket)
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        if v2:
            after = q.get("continuation-token") or q.get("start-after",
                                                         "")
        else:
            after = q.get("marker", "")
        base = f"{BUCKETS_DIR}/{bucket}"
        # items: ("key", key, entry) | ("prefix", prefix, None), in key
        # order — one list so the continuation token is always the last
        # EMITTED name, whether that was an object or a common prefix.
        items: list[tuple[str, str, Optional[filer_pb2.Entry]]] = []
        # max-keys=0 is legal: answer IsTruncated=false with no items
        # (matching AWS) instead of a token-less truncated response.
        truncated = max_keys > 0 and self._walk(
            base, "", prefix, delimiter, after, max_keys, items)
        root = ET.Element(
            "ListBucketResult", xmlns=XMLNS)
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = prefix
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated else "false"
        if delimiter:
            ET.SubElement(root, "Delimiter").text = delimiter
        if v2:
            ET.SubElement(root, "KeyCount").text = str(len(items))
            if truncated and items:
                ET.SubElement(root, "NextContinuationToken").text = \
                    items[-1][1]
        elif truncated and items:
            ET.SubElement(root, "NextMarker").text = items[-1][1]
        for kind, key, e in items:
            if kind == "prefix":
                cp = ET.SubElement(root, "CommonPrefixes")
                ET.SubElement(cp, "Prefix").text = key
                continue
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = key
            ET.SubElement(c, "LastModified").text = _iso(
                e.attributes.mtime)
            ET.SubElement(c, "ETag").text = f'"{_etag(e)}"'
            ET.SubElement(c, "Size").text = str(e.attributes.file_size)
            ET.SubElement(c, "StorageClass").text = "STANDARD"
        return _xml(root)

    def _walk(self, base: str, rel: str, prefix: str, delimiter: str,
              after: str, max_keys: int, items: list) -> bool:
        """DFS in key order; returns True when truncated. Common
        prefixes count against max-keys at append time, same as keys
        (the S3 contract: MaxKeys bounds keys + CommonPrefixes)."""
        directory = f"{base}/{rel}" if rel else base
        for e in self.filer.list(directory):
            key = f"{rel}{e.name}" if not e.is_directory else \
                f"{rel}{e.name}/"
            if e.is_directory and e.name == UPLOADS_DIR and not rel:
                continue
            probe = key if not e.is_directory else key[:-1]
            if prefix and not probe.startswith(prefix) \
                    and not prefix.startswith(key):
                continue
            if e.is_directory:
                if delimiter == "/" and key.startswith(prefix):
                    if key > after:
                        if len(items) >= max_keys:
                            return True
                        items.append(("prefix", key, None))
                    continue
                if self._walk(base, key, prefix, delimiter, after,
                              max_keys, items):
                    return True
                continue
            if not key.startswith(prefix) or key <= after:
                continue
            if len(items) >= max_keys:
                return True
            items.append(("key", key, e))
        return False

    # ---- object ops ----

    def put_object(self, bucket: str, key: str, data: bytes,
                   mime: str) -> str:
        self._require_bucket(bucket)
        self.filer.put_data(f"{BUCKETS_DIR}/{bucket}/{key}", data,
                            mime=mime)
        return hashlib.md5(data).hexdigest()

    def get_object_entry(self, bucket: str, key: str) -> filer_pb2.Entry:
        self._require_bucket(bucket)
        d, _, name = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")
        e = self.filer.lookup(d, name)
        if e is None or e.is_directory:
            raise S3Error("NoSuchKey", key)
        return e

    #: Ranged reads cache in fixed blocks, so an arbitrary
    #: (offset, length) stream mints at most size/RANGE_BLOCK distinct
    #: keys per object version — never one key per request shape (the
    #: whole-object-poisoning bug this replaced).
    RANGE_BLOCK = 1 * 1024 * 1024
    #: Streams with live readahead windows (LRU cap).
    RANGE_STREAMS = 64
    #: Readahead window ceiling, in RANGE_BLOCK units (8 MiB): deep
    #: enough to hide filer latency, shallow enough that a seek does
    #: not strand tens of MiB of wasted prefetch.
    RANGE_WINDOW_UNITS = 8
    #: Max blocks one prefetch filer read may claim: a foreground read
    #: waiting on a claimed block waits for at most this much data.
    PREFETCH_RUN_BLOCKS = 4

    def get_object(self, bucket: str, key: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        entry = self.get_object_entry(bucket, key)
        path = f"{BUCKETS_DIR}/{bucket}/{key}"
        # Hot-read cache, keyed on content identity (etag covers the
        # chunk list): an overwrite changes the etag, so stale entries
        # can never serve — they just age out of the LRU.
        from ..cache import global_chunk_cache

        etag = _etag(entry)
        size = entry.attributes.file_size
        cache = global_chunk_cache()
        full_key = f"s3:{path}:{etag}:full"
        if offset == 0 and length is None:
            data = cache.get(full_key)
            if data is None:
                data = self.filer.get_data(path)
                cache.put(full_key, data)
            return data
        end = min(offset + (size - offset if length is None
                            else length), size)
        if end <= offset:
            return b""
        # A resident full object serves any range by slicing.
        full = cache.get(full_key)
        if full is not None:
            return full[offset:end]
        return self._ranged_read(cache, path, etag, size, offset,
                                 end - offset)

    def _block_key(self, path: str, etag: str, idx: int) -> str:
        return f"s3:{path}:{etag}:blk:{idx}"

    def _ranged_read(self, cache, path: str, etag: str, size: int,
                     offset: int, length: int) -> bytes:
        """Block-aligned read-through for ranged GETs, with sequential
        read-ahead: a confirmed-sequential stream of ranges prefetches
        upcoming blocks into the chunk cache off-thread."""
        bs = self.RANGE_BLOCK
        end = offset + length
        first, last = offset // bs, (end - 1) // bs
        out = bytearray(length)
        b = first
        while b <= last:
            bkey = self._block_key(path, etag, b)
            blk = cache.get(bkey)
            if blk is None:
                # a prefetch already has this block on the wire: wait
                # for it instead of issuing a duplicate fetch
                blk = self._await_inflight(cache, bkey)
            if blk is not None:
                with self._ra_lock:
                    if bkey in self._ra_prefetched:
                        self._ra_prefetched.discard(bkey)
                        readahead_mod.note_hit()
                lo = max(offset, b * bs)
                hi = min(end, b * bs + len(blk))
                if lo < hi:
                    out[lo - offset:hi - offset] = \
                        blk[lo - b * bs:hi - b * bs]
                b += 1
                continue
            # contiguous run of blocks neither cached nor in flight,
            # fetched in ONE filer read
            run_end = b + 1
            while run_end <= last:
                k = self._block_key(path, etag, run_end)
                if cache.get(k) is not None:
                    break
                with self._ra_lock:
                    if k in self._ra_inflight:
                        break
                run_end += 1
            blob = self.filer.get_data(
                path, b * bs, min(run_end * bs, size) - b * bs)
            for i in range(b, run_end):
                cache.put(self._block_key(path, etag, i),
                          blob[(i - b) * bs:(i - b + 1) * bs])
            lo = max(offset, b * bs)
            hi = min(end, b * bs + len(blob))
            if lo < hi:
                out[lo - offset:hi - offset] = \
                    blob[lo - b * bs:hi - b * bs]
            b = run_end
        self._observe_stream(cache, path, etag, size, offset, length)
        return bytes(out)

    #: A foreground read waits at most this long on an in-flight
    #: prefetch of the block it needs before fetching it itself (the
    #: duplicate fetch is the fallback, not the norm).
    PREFETCH_WAIT_SECONDS = 30.0

    def _await_inflight(self, cache, bkey: str):
        with self._ra_lock:
            ev = self._ra_inflight.get(bkey)
        if ev is None:
            return None
        if not ev.wait(self.PREFETCH_WAIT_SECONDS):
            return None
        return cache.get(bkey)

    def _observe_stream(self, cache, path: str, etag: str, size: int,
                        offset: int, length: int) -> None:
        stream = f"{path}:{etag}"
        with self._ra_lock:
            win = self._ra_windows.get(stream)
            if win is None:
                win = readahead_mod.ReadaheadWindow(
                    unit=self.RANGE_BLOCK,
                    max_units=self.RANGE_WINDOW_UNITS)
                self._ra_windows[stream] = win
                while len(self._ra_windows) > self.RANGE_STREAMS:
                    _, old = self._ra_windows.popitem(last=False)
                    old.close()
            self._ra_windows.move_to_end(stream)
            plan = win.observe(offset, length, size)
        if plan is None:
            return
        start, nbytes = plan
        bs = self.RANGE_BLOCK

        def _prefetch() -> None:
            fetched = 0
            lo_blk = start // bs
            hi_blk = (start + nbytes + bs - 1) // bs
            i = lo_blk
            while i < hi_blk:
                if cache.get(self._block_key(path, etag, i)) \
                        is not None:
                    i += 1
                    continue
                # claim a contiguous run of uncached, unclaimed
                # blocks, then fetch the whole run in ONE filer read
                claimed: list[tuple[str, threading.Event]] = []
                with self._ra_lock:
                    j = i
                    while (j < hi_blk
                           and len(claimed) < self.PREFETCH_RUN_BLOCKS):
                        k = self._block_key(path, etag, j)
                        if k in self._ra_inflight:
                            break
                        ev = threading.Event()
                        self._ra_inflight[k] = ev
                        claimed.append((k, ev))
                        j += 1
                if not claimed:
                    i += 1
                    continue
                try:
                    blob = self.filer.get_data(
                        path, i * bs, min(j * bs, size) - i * bs)
                    # publish each block the moment its bytes land so a
                    # foreground reader waiting on it unblocks without
                    # waiting for the rest of the run
                    for n, (k, ev) in enumerate(claimed):
                        cache.put(k, blob[n * bs:(n + 1) * bs])
                        with self._ra_lock:
                            self._ra_prefetched.add(k)
                            self._ra_inflight.pop(k, None)
                            while len(self._ra_prefetched) > 4096:
                                self._ra_prefetched.pop()
                                readahead_mod.note_wasted()
                        ev.set()
                    fetched += len(blob)
                finally:
                    with self._ra_lock:
                        for k, ev in claimed:
                            self._ra_inflight.pop(k, None)
                            ev.set()
                i = j
            if fetched:
                readahead_mod.record_prefetch(fetched)

        readahead_mod.shared_prefetcher().submit(
            ("s3", path, etag, start), _prefetch)

    def delete_object(self, bucket: str, key: str) -> None:
        self._require_bucket(bucket)
        d, _, name = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")
        try:
            self.filer.delete(d, name, recursive=True)
        except FilerClientError:
            pass  # S3 deletes are idempotent

    #: Copy window: bounds gateway memory and keeps each filer PUT well
    #: inside the HTTP client timeout for arbitrarily large objects.
    COPY_WINDOW = 32 * 1024 * 1024

    def copy_object(self, bucket: str, key: str, src_bucket: str,
                    src_key: str) -> bytes:
        src = self.get_object_entry(src_bucket, src_key)
        self._require_bucket(bucket)
        src_path = f"{BUCKETS_DIR}/{src_bucket}/{src_key}"
        dst_path = f"{BUCKETS_DIR}/{bucket}/{key}"
        # Self-copy (the S3 metadata-refresh idiom) must not touch the
        # data path: copy_data no-ops, and the entry stays as-is.
        self.filer.copy_data(src_path, dst_path,
                             src.attributes.file_size,
                             mime=src.attributes.mime,
                             window=self.COPY_WINDOW,
                             extended=dict(src.extended))
        # Report the DESTINATION's ETag: the copy has its own chunk ids,
        # so echoing the source's would mismatch a later GET/HEAD.
        dst = self.get_object_entry(bucket, key)
        root = ET.Element("CopyObjectResult", xmlns=XMLNS)
        ET.SubElement(root, "LastModified").text = _iso(time.time())
        ET.SubElement(root, "ETag").text = f'"{_etag(dst)}"'
        return _xml(root)

    # ---- multipart ----

    def initiate_multipart(self, bucket: str, key: str) -> bytes:
        self._require_bucket(bucket)
        upload_id = uuid.uuid4().hex
        self.filer.mkdir(f"{BUCKETS_DIR}/{UPLOADS_DIR}", upload_id)
        marker = filer_pb2.Entry(name="key", is_directory=False)
        marker.extended["key"] = key.encode()
        marker.extended["bucket"] = bucket.encode()
        self.filer.create(f"{BUCKETS_DIR}/{UPLOADS_DIR}/{upload_id}",
                          marker)
        root = ET.Element("InitiateMultipartUploadResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        return _xml(root)

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_number: int, data: bytes) -> str:
        self._upload_dir(upload_id, bucket)
        self.filer.put_data(
            f"{BUCKETS_DIR}/{UPLOADS_DIR}/{upload_id}/"
            f"{part_number:05d}.part", data)
        return hashlib.md5(data).hexdigest()

    def _upload_dir(self, upload_id: str,
                    bucket: Optional[str] = None) -> str:
        d = f"{BUCKETS_DIR}/{UPLOADS_DIR}/{upload_id}"
        if self.filer.lookup(f"{BUCKETS_DIR}/{UPLOADS_DIR}",
                             upload_id) is None:
            raise S3Error("NoSuchUpload", upload_id)
        if bucket is not None:
            # the URL bucket was what the caller was AUTHORIZED against;
            # it must be the bucket the upload was initiated in, or a
            # scoped identity could drive another bucket's upload
            marker = self.filer.lookup(d, "key")
            owner = (marker.extended.get("bucket", b"").decode()
                     if marker is not None else "")
            # Markers written before the bucket attribute existed have
            # owner == "" and skip the check (back-compat: such legacy
            # in-flight uploads remain drivable from any bucket the
            # caller can Write). New markers always carry the attribute,
            # so the window closes as old uploads complete or expire.
            if owner and owner != bucket:
                raise S3Error("NoSuchUpload", upload_id)
        return d

    def complete_multipart(self, bucket: str, key: str,
                           upload_id: str) -> bytes:
        d = self._upload_dir(upload_id, bucket)
        parts = sorted(
            (e for e in self.filer.list(d)
             if e.name.endswith(".part")), key=lambda e: e.name)
        if not parts:
            raise S3Error("InvalidPart", "no parts uploaded")
        # Metadata-only assembly: concatenate every part's chunks with
        # re-based offsets into one entry.
        final = filer_pb2.Entry(name=key.rsplit("/", 1)[-1],
                                is_directory=False)
        offset = 0
        for p in parts:
            for c in p.chunks:
                nc = final.chunks.add()
                nc.CopyFrom(c)
                nc.offset = offset + c.offset
            offset += p.attributes.file_size
        final.attributes.CopyFrom(parts[0].attributes)
        final.attributes.file_size = offset
        final.attributes.mtime = int(time.time())
        dst_dir = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")[0]
        self.filer.create(dst_dir, final)
        # Drop the upload scaffolding WITHOUT deleting chunk data — the
        # final entry owns those chunks now.
        self.filer.delete(f"{BUCKETS_DIR}/{UPLOADS_DIR}", upload_id,
                          recursive=True, delete_data=False)
        root = ET.Element("CompleteMultipartUploadResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = \
            f'"{hashlib.md5(str(offset).encode()).hexdigest()}-' \
            f'{len(parts)}"'
        return _xml(root)

    def abort_multipart(self, upload_id: str,
                        bucket: Optional[str] = None) -> None:
        self._upload_dir(upload_id, bucket)
        self.filer.delete(f"{BUCKETS_DIR}/{UPLOADS_DIR}", upload_id,
                          recursive=True, delete_data=True)


def _parse_s3_range(header, size: int):
    """S3 single-range semantics: returns (offset, length), or None to
    serve the full body with 200 (absent/malformed headers are ignored,
    per RFC 7233). Raises InvalidRange (416) when the range is
    syntactically valid but unsatisfiable, e.g. ``bytes=500-`` on a
    100-byte object."""
    if not header or not header.startswith("bytes=") or not size:
        return None
    spec = header[6:].split(",")[0].strip()
    lo, sep, hi = spec.partition("-")
    if not sep:
        return None
    try:
        if not lo:  # suffix: last N bytes
            n = int(hi)
            if n <= 0:
                return None
            offset = max(0, size - n)
            return offset, size - offset
        offset = int(lo)
        stop = int(hi) + 1 if hi else size
    except ValueError:
        return None
    if offset < 0 or (hi and stop <= offset):
        return None  # malformed (last-byte-pos < first-byte-pos)
    if offset >= size:
        raise S3Error("InvalidRange",
                      f"range start {offset} beyond object size {size}")
    return offset, min(stop, size) - offset


def _etag(e: filer_pb2.Entry) -> str:
    if e.extended.get("etag"):
        return e.extended["etag"].decode()
    h = hashlib.md5()
    for c in e.chunks:
        h.update(c.file_id.encode())
    return h.hexdigest()


def _make_handler(gw: S3Gateway):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "seaweedfs-tpu-s3"

        def log_message(self, fmt, *args):
            glog.v(2, "s3 http: " + fmt, *args)

        # -- plumbing --

        def _split(self) -> tuple[str, str, dict, str]:
            u = urllib.parse.urlsplit(self.path)
            q = {k: v[0] for k, v in urllib.parse.parse_qs(
                u.query, keep_blank_values=True).items()}
            parts = urllib.parse.unquote(u.path).lstrip("/").split(
                "/", 1)
            bucket = parts[0]
            key = parts[1] if len(parts) > 1 else ""
            return bucket, key, q, u.query

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n) if n else b""

        def _send(self, code: int, body: bytes = b"",
                  ctype: str = "application/xml",
                  extra: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            if not extra or "Content-Length" not in extra:
                self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if body and self.command != "HEAD":
                self.wfile.write(body)

        def _fail(self, exc) -> None:
            if isinstance(exc, httpserver.QosShed):
                # tenant over its class budget (or pressure-shed by
                # the priority ladder): S3's throttling surface
                self._send(429,
                           _error_xml("SlowDown", str(exc), self.path),
                           extra={"Retry-After":
                                  str(max(1, int(exc.retry_after)))})
                return
            if isinstance(exc, AuthError):
                code, msg = exc.code, str(exc)
            elif isinstance(exc, S3Error):
                code, msg = exc.code, exc.message
            elif isinstance(exc, FilerClientError):
                code, msg = "InternalError", str(exc)
            else:
                code, msg = "InternalError", str(exc)
            self._send(_STATUS.get(code, 500),
                       _error_xml(code, msg, self.path))

        def _auth(self, body: bytes, action: str = "",
                  bucket: str = ""):
            u = urllib.parse.urlsplit(self.path)
            ident = gw.auth.verify(self.command, u.path or "/", u.query,
                                   self.headers,
                                   hashlib.sha256(body).hexdigest())
            # authorization (weed s3.configure identity actions): None
            # identity = open gateway, all actions permitted
            if ident is not None and action and \
                    not ident.can(action, bucket):
                raise AuthError(
                    "AccessDenied",
                    f"{action} on {bucket or 'service'} not permitted "
                    f"for {ident.name}")
            return ident

        def _qos(self, ident) -> Optional[httpserver.QosLease]:
            """Class-aware admission, AFTER SigV4 so the tenant is the
            authenticated identity. Raises QosShed (-> 429 SlowDown)
            when the tenant's class is over budget or sheds under the
            current queue pressure."""
            srv = self.server
            qos = getattr(srv, "qos", None)
            if qos is None:
                return None
            pressure = srv.pressure() if hasattr(srv, "pressure") \
                else 0.0
            return qos.admit(
                ident.name if ident is not None else "anonymous",
                pressure)

        # -- verbs --

        def do_GET(self):
            u = urllib.parse.urlsplit(self.path)
            if u.path == "/debug/vars":
                self._send(200, json.dumps(varz.payload(
                    "s3", gw.metrics,
                    extra={"usage": gw.usage.to_payload()})).encode(),
                    "application/json")
                return
            if u.path == "/debug/profile":
                q = dict(urllib.parse.parse_qsl(u.query))
                self._send(200, profiler.profile(
                    float(q.get("seconds", 2.0)),
                    hz=float(q.get("hz", profiler.DEFAULT_BURST_HZ))
                ).encode(), "text/plain; charset=utf-8")
                return
            bucket, key, q, _ = self._split()
            gw.metrics.counter("request_total", method="GET").inc()
            t0 = time.perf_counter()
            ident = None
            n_out = 0
            err = False
            lease = None
            try:
                ident = self._auth(b"", "Read" if bucket else "", bucket)
                lease = self._qos(ident)
                if not bucket:
                    self._send(200, gw.list_buckets(ident))
                elif not key:
                    v2 = q.get("list-type") == "2"
                    self._send(200, gw.list_objects(bucket, q, v2))
                else:
                    entry = gw.get_object_entry(bucket, key)
                    size = entry.attributes.file_size
                    offset, length = 0, None
                    status, extra = 200, {"Accept-Ranges": "bytes"}
                    parsed = _parse_s3_range(
                        self.headers.get("Range"), size)
                    if parsed is not None:
                        offset, length = parsed
                        status = 206
                        extra["Content-Range"] = \
                            f"bytes {offset}-{offset + length - 1}" \
                            f"/{size}"
                    data = gw.get_object(bucket, key, offset, length)
                    n_out = len(data)
                    extra["ETag"] = f'"{_etag(entry)}"'
                    extra["Last-Modified"] = time.strftime(
                        "%a, %d %b %Y %H:%M:%S GMT",
                        time.gmtime(entry.attributes.mtime))
                    self._send(status, data,
                               entry.attributes.mime
                               or "application/octet-stream", extra)
            except Exception as e:
                err = True
                self._fail(e)
            finally:
                if lease is not None:
                    lease.release()
                gw.account(ident, bucket, key, n_out=n_out,
                           seconds=time.perf_counter() - t0, error=err)

        def do_HEAD(self):
            bucket, key, q, _ = self._split()
            ident = None
            err = False
            lease = None
            try:
                ident = self._auth(b"", "Read", bucket)
                lease = self._qos(ident)
                if not key:
                    gw._require_bucket(bucket)
                    self._send(200)
                    return
                entry = gw.get_object_entry(bucket, key)
                self._send(200, b"",
                           entry.attributes.mime
                           or "application/octet-stream",
                           {"Content-Length":
                            str(entry.attributes.file_size),
                            "Accept-Ranges": "bytes",
                            "ETag": f'"{_etag(entry)}"'})
            except Exception as e:
                err = True
                self._fail(e)
            finally:
                if lease is not None:
                    lease.release()
                gw.account(ident, bucket, "", error=err)

        def do_PUT(self):
            bucket, key, q, _ = self._split()
            gw.metrics.counter("request_total", method="PUT").inc()
            body = self._body()
            t0 = time.perf_counter()
            ident = None
            err = False
            lease = None
            try:
                ident = self._auth(body, "Write" if key else "Admin",
                                   bucket)
                lease = self._qos(ident)
                if not key:
                    gw.create_bucket(bucket)
                    self._send(200)
                elif "partNumber" in q and "uploadId" in q:
                    etag = gw.upload_part(bucket, key, q["uploadId"],
                                          int(q["partNumber"]), body)
                    self._send(200, b"", extra={"ETag": f'"{etag}"'})
                elif "x-amz-copy-source" in self.headers:
                    src = urllib.parse.unquote(
                        self.headers["x-amz-copy-source"]).lstrip("/")
                    sb, _, sk = src.partition("/")
                    # copying also READS the source bucket (identity is
                    # already authenticated; just authorize)
                    if ident is not None and not ident.can("Read", sb):
                        raise AuthError(
                            "AccessDenied",
                            f"Read on {sb} not permitted for "
                            f"{ident.name}")
                    self._send(200, gw.copy_object(bucket, key, sb, sk))
                else:
                    etag = gw.put_object(
                        bucket, key, body,
                        self.headers.get("Content-Type", ""))
                    self._send(200, b"", extra={"ETag": f'"{etag}"'})
            except Exception as e:
                err = True
                self._fail(e)
            finally:
                if lease is not None:
                    lease.release()
                gw.account(ident, bucket, key, n_in=len(body),
                           seconds=time.perf_counter() - t0, error=err)

        def do_POST(self):
            if urllib.parse.urlsplit(self.path).path == \
                    "/cache/invalidate":
                # Maintenance-job fan-out: drop cached
                # chunks of a volume a job just rewrote.
                try:
                    self._send(200, json.dumps(
                        invalidation_mod.handle_event(
                            json.loads(self._body() or b"{}"))
                    ).encode(), ctype="application/json")
                except (ValueError, KeyError) as e:
                    self._send(400, json.dumps(
                        {"error": str(e)}).encode(),
                        ctype="application/json")
                return
            bucket, key, q, _ = self._split()
            body = self._body()
            ident = None
            err = False
            lease = None
            try:
                ident = self._auth(body, "Write", bucket)
                lease = self._qos(ident)
                if "uploads" in q:
                    self._send(200, gw.initiate_multipart(bucket, key))
                elif "uploadId" in q:
                    self._send(200, gw.complete_multipart(
                        bucket, key, q["uploadId"]))
                else:
                    raise S3Error("InvalidArgument",
                                  "unsupported POST")
            except Exception as e:
                err = True
                self._fail(e)
            finally:
                if lease is not None:
                    lease.release()
                gw.account(ident, bucket, "", n_in=len(body),
                           error=err)

        def do_DELETE(self):
            bucket, key, q, _ = self._split()
            gw.metrics.counter("request_total", method="DELETE").inc()
            ident = None
            err = False
            lease = None
            try:
                ident = self._auth(b"", "Write" if key else "Admin",
                                   bucket)
                lease = self._qos(ident)
                if "uploadId" in q:
                    gw.abort_multipart(q["uploadId"], bucket)
                    self._send(204)
                elif not key:
                    gw.delete_bucket(bucket)
                    self._send(204)
                else:
                    gw.delete_object(bucket, key)
                    self._send(204)
            except Exception as e:
                err = True
                self._fail(e)
            finally:
                if lease is not None:
                    lease.release()
                gw.account(ident, bucket, "", error=err)

    return tracing.instrument_http_handler(
        httpserver.admission_gate(Handler), "s3")


def parse_identities(cfg: dict) -> list[Identity]:
    """{"identities": [{"name", "credentials": [{"accessKey",
    "secretKey"}], "actions": [...]}]} — the reference's s3.json
    shape, shared by the -config file and the filer-stored config."""
    out = []
    for ident in cfg.get("identities", []):
        for cred in ident.get("credentials", []):
            out.append(Identity(
                name=ident.get("name", cred["accessKey"]),
                access_key=cred["accessKey"],
                secret_key=cred["secretKey"],
                actions=tuple(ident.get("actions", ["Admin"]))))
    return out


def load_identities(path: str) -> list[Identity]:
    import json

    with open(path) as f:
        return parse_identities(json.load(f))


def main(argv: list[str]) -> int:
    """``python -m seaweedfs_tpu_torch s3`` (weed/command/s3.go).

    Serves until SIGINT or SIGTERM, then stops cleanly. Exit 2: a bad
    flag, ``-securityConfig`` or ``-toml`` (one ``error:`` line)."""
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(prog="s3")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8333)
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-master", default="",
                   help="master url to push usage accounting to (its "
                        "cache-invalidation hub also feeds the "
                        "gateway's chunk cache)")
    p.add_argument("-config", default="",
                   help="identities JSON (empty = open access)")
    p.add_argument("-toml", default="",
                   help="server TOML ([ingress], [qos], [retry], "
                        "[tracing], [profiler])")
    from ..util import tls as tls_mod
    tls_mod.add_security_flag(p)
    args = p.parse_args(argv)
    try:
        tls_mod.install_from_flag(args)
    except (OSError, TypeError, ValueError) as e:
        print(f"error: -securityConfig {args.securityConfig}: {e}",
              file=sys.stderr)
        return 2
    qos = None
    if args.toml:
        from ..util import config as config_mod
        from ..util import retry as retry_mod
        try:
            conf = config_mod.load(args.toml)
            httpserver.configure_from(conf)
            retry_mod.configure_from(conf)
            tracing.configure_from(conf)
            profiler.configure_from(conf)
            qos = httpserver.qos_from_conf(conf)
        except (OSError, TypeError, ValueError) as e:
            print(f"error: -toml {args.toml}: {e}", file=sys.stderr)
            return 2
    idents = load_identities(args.config) if args.config else None
    profiler.ensure_started()
    gw = S3Gateway(args.filer, ip=args.ip, port=args.port,
                   identities=idents, master_url=args.master,
                   qos=qos).start()
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    gw.stop()
    return 0
