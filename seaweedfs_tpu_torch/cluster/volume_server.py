"""Volume server: HTTP data plane + gRPC admin plane over a Store.

The port of ``seaweedfs_tpu/cluster/volume_server.py``
(weed/server/volume_server*.go + volume_grpc_erasure_coding.go; SURVEY.md
§2 "weed volume", "EC gRPC handlers", §3.1-§3.3): serves
``GET/HEAD/POST/PUT/DELETE /<vid>,<fid>`` against local volumes, falls
through to EC shard reads (with interval reconstruction pulling remote
shards over ``VolumeEcShardRead``), fans replicated writes out to peer
replicas, and executes the shell's EC choreography rpcs — generate (the
seal, on the card's GF(2^8) kernels), rebuild, copy (via ``CopyFile``
streaming from the source node), mount, unmount, to-volume. A
background thread streams heartbeat snapshots to the master (§3.4): the
port's own (``cluster/master.py``) or the JAX package's, which speak
the same wire. Both ``ec_shard_peers`` (the shard lookup of the EC read
path and of rebuild, ``LookupEcVolume``) and the replica fan-out
(``LookupVolume``) ask that master. A server may also run with no
master at all (``master_url=""``), when the caller drives the
choreography itself. With a master, a :class:`~.jobs.JobWorker` pulls
the master's leased maintenance tasks (``ec.encode -distributed``,
scrub, vacuum, rebuild, replicate, replica drop) and runs them here,
naming the task in-flight on every heartbeat.

``device`` (None = the card; raises when there is none, before any port
is bound) is where every encode, rebuild, decode and reconstructing
read runs. A failing launch fails its RPC or request: nothing retries
on the host codec. (Products shorter than ``rs_torch.DEVICE_MIN_S`` go
to the host codec by the routing rule, not as a fallback.)

An EC read goes through the post-decode chunk cache
(``ec_cache_bytes``): a hot needle on a sealed volume is decoded once,
then served from the cache until vacuum, ``ec.rebuild``, a DELETE or a
``POST /cache/invalidate`` from the master's hub drops it. Its
per-volume hit and miss counts ride the heartbeat's telemetry rows.

Every HTTP verb and gRPC call runs under a trace span, a GET's needle
read under ``store.read_needle`` or ``ec.reconstruct``; slow or errored
roots are pushed to the master's trace collector. ``/debug/traces``,
``/debug/profile`` and ``/debug/vars`` describe the process, and
``-config`` applies ``[tracing]`` and ``[profiler]``.

Every read and write lands in :attr:`VolumeServer.telemetry` (per-volume
ops, bytes, errors, EC decodes and latency digests) and every read's
needle in :attr:`VolumeServer.usage` (a hot-key sketch); both ride the
heartbeat as the JAX package's ``TelemetrySnapshot`` and
``UsageSnapshot``, show on ``/debug/vars``, and are switched by
``[telemetry]`` and ``[usage]``. The S3 tier RPCs move a volume's .dat to an S3
endpoint and back (``Store.tier_move`` / ``tier_restore``), with the
tier's credentials from the server's environment
(``SEAWEEDFS_TORCH_TIER_ACCESS_KEY`` / ``_SECRET_KEY``).
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .. import pb
from ..cache import ChunkCache
from ..cache import invalidation as invalidation_mod
from ..ops import rs_torch
from ..pb import master_pb2, volume_server_pb2
from ..pipeline import decode as decode_mod
from ..pipeline import encode as encode_mod
from ..pipeline import flight as flight_mod
from ..pipeline import rebuild as rebuild_mod
from ..pipeline.read import EcVolumeReader
from ..pipeline.scheme import DEFAULT_SCHEME, EcScheme
from ..storage import ec_files
from ..storage import scrubber as scrubber_mod
from ..storage.needle import Needle
from ..storage.store import Store, StoreError
from ..storage.superblock import ReplicaPlacement, Ttl
from ..storage.types import FileId
from ..storage.volume import dat_path, idx_path
from ..util import durability, faults, glog, httpserver, profiler, retry, \
    security, tracing, varz
from ..util import tls as tls_mod
from ..util.stats import EXPOSITION_CONTENT_TYPE, Metrics
from . import jobs as jobs_mod
from . import telemetry as telemetry_mod
from . import usage as usage_mod

_COPY_CHUNK = 1024 * 1024


def _grpc_port(http_port: int) -> int:
    """The reference convention: gRPC port = HTTP port + 10000."""
    return http_port + 10000


def free_port_pair() -> int:
    """A free HTTP port ``p`` whose gRPC twin ``p + 10000`` is free too."""
    import socket
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if _grpc_port(p) > 65535:
            continue
        try:
            with socket.socket() as s2:
                s2.bind(("127.0.0.1", _grpc_port(p)))
            return p
        except OSError:
            continue
    raise VolumeServerError("no free port pair")


class VolumeServerError(RuntimeError):
    pass


class ClusterEcReader(EcVolumeReader):
    """EcVolumeReader that falls back to peers for non-local shards.

    Mirrors store_ec.go's readEcShardIntervals: local shard file first,
    then ``VolumeEcShardRead`` against a server holding the shard; a
    shard nobody holds returns None, which triggers interval
    reconstruction upstream (recoverOneRemoteEcShardInterval) on the
    server's device.
    """

    def __init__(self, vs: "VolumeServer", volume_id: int,
                 base: str | Path, scheme: EcScheme = DEFAULT_SCHEME,
                 device=None):
        super().__init__(base, scheme, device=device)
        self._vs = vs
        self._volume_id = volume_id

    def _read_shard_range(self, shard_id: int, offset: int, size: int
                          ) -> Optional[np.ndarray]:
        local = super()._read_shard_range(shard_id, offset, size)
        if local is not None:
            return local
        for url in self._vs.ec_shard_peers(self._volume_id, shard_id):
            if url == self._vs.url:
                continue
            try:
                data = self._vs.remote_shard_read(
                    url, self._volume_id, shard_id, offset, size)
            except Exception as e:  # peer down: try next / reconstruct
                glog.v(1, "ec read from %s failed: %s", url, e)
                continue
            if data is not None and len(data) == size:
                return np.frombuffer(data, dtype=np.uint8)
        return None


class VolumeServer:
    def __init__(self, store: Store, ip: str = "127.0.0.1",
                 port: int = 8080, master_url: str = "",
                 public_url: str = "", data_center: str = "",
                 rack: str = "", pulse_seconds: float = 5.0,
                 secret: str = "", device=None,
                 ec_cache_bytes: int = 64 * 1024 * 1024,
                 job_poll_seconds: Optional[float] = None):
        #: where encode, rebuild, decode and EC reads run; resolved
        #: first, so a server asked for a missing card binds nothing
        self.device = rs_torch.resolve_device(device)
        self.store = store
        self.ip = ip
        self.port = port
        self.url = f"{ip}:{port}"
        self.public_url = public_url or self.url
        # One or more master urls (comma-separated). The heartbeat
        # stream follows the leader the masters report; on stream
        # failure the loop rotates through the list (HA failover).
        self.master_urls = [u for u in master_url.split(",") if u]
        self.master_url = self.master_urls[0] if self.master_urls else ""
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        self.guard = security.Guard(secret)
        self.metrics = Metrics(namespace="volume_server")
        #: Post-decode needle cache for cold-tier (EC) reads: a hot
        #: needle on a sealed volume pays interval assembly / RS decode
        #: once, not per request. Registered with cache/invalidation.py,
        #: so vacuum and ec.rebuild drop the volume's entries.
        self.chunk_cache = ChunkCache(ec_cache_bytes,
                                      metrics=self.metrics)
        #: Per-volume hot stats (ops, bytes, latency digests); a
        #: compact snapshot rides every heartbeat to the master.
        self.telemetry = telemetry_mod.TelemetryCollector()
        #: Per-needle hot-key accounting (usage plane): read fids feed
        #: a SpaceSaving sketch that rides the heartbeat too, so the
        #: master's /cluster/topk can name hot objects per volume.
        self.usage = usage_mod.UsageCollector("volume")
        self.servicer: Optional["_VolumeServicer"] = None
        self._channels: dict[str, object] = {}
        self._grpc_server = None
        self._http_server: Optional[httpserver.IngressHTTPServer] = None
        self._stop = threading.Event()
        self._ec_loc_cache: dict[int, tuple[float, dict[int, list[str]]]] = {}
        self._metrics_pusher = None
        self._lock = threading.RLock()
        #: Maintenance-plane worker: started with the server when it
        #: has a master; claims leased tasks from it and executes them
        #: through the same servicer the shell drives, on ``device``.
        self.job_poll_seconds = job_poll_seconds
        self.job_worker: Optional[jobs_mod.JobWorker] = None

    # ------------- lifecycle -------------

    def start(self) -> "VolumeServer":
        import grpc

        # With a signing key, the whole gRPC plane (admin + EC reads)
        # requires a cluster bearer token — the reference's gRPC TLS
        # role (SURVEY.md §2 Security row), HMAC-keyed here.
        auth = security.grpc_server_interceptor(self.guard)
        self._grpc_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16),
            interceptors=(auth,) if auth else ())
        self.servicer = _VolumeServicer(self)
        self._grpc_server.add_generic_rpc_handlers((pb.generic_handler(
            pb.VOLUME_SERVICE, pb.VOLUME_METHODS, self.servicer),))
        bound = tls_mod.serve_port(
            self._grpc_server, f"{self.ip}:{_grpc_port(self.port)}")
        if bound == 0:
            raise RuntimeError(
                f"cannot bind volume grpc port {_grpc_port(self.port)}")
        self._grpc_server.start()

        handler = _make_http_handler(self)
        self._http_server = httpserver.IngressHTTPServer(
            (self.ip, self.port), handler, component="volume")
        threading.Thread(target=self._http_server.serve_forever,
                         daemon=True, name=f"volume-http-{self.port}").start()

        if self.master_url:
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name=f"volume-hb-{self.port}").start()
            # Tail-sampled slow/errored roots go to the master's
            # collector; followers proxy the POST to the leader.
            tracing.configure_push(self.master_url, node=self.url,
                                   component="volume")
            self.job_worker = jobs_mod.JobWorker(
                self, poll_seconds=self.job_poll_seconds).start()
        glog.info("volume server started at %s (grpc %d, device %s)",
                  self.url, _grpc_port(self.port), self.device)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.job_worker is not None:
            self.job_worker.stop()
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5)
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        for ch in self._channels.values():
            ch.close()
        self._channels.clear()
        with self._lock:
            if self._metrics_pusher is not None:
                self._metrics_pusher.stop()
                self._metrics_pusher = None
        self.chunk_cache.close()
        self.store.close()

    def __enter__(self) -> "VolumeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------- peers / master -------------

    def _channel(self, url: str):
        with self._lock:
            ch = self._channels.get(url)
            if ch is None:
                ip, http_port = url.rsplit(":", 1)
                ch = security.grpc_auth_channel(tls_mod.dial(
                    f"{ip}:{_grpc_port(int(http_port))}"), self.guard)
                self._channels[url] = ch
            return ch

    def peer_stub(self, url: str) -> pb.Stub:
        return pb.volume_stub(self._channel(url))

    def master_stub(self) -> pb.Stub:
        return pb.master_stub(self._channel(self.master_url))

    def _rotate_master(self) -> None:
        if len(self.master_urls) > 1:
            i = self.master_urls.index(self.master_url) \
                if self.master_url in self.master_urls else 0
            # failover re-point: a str rebind is atomic; a racing
            # reader uses either the dying master (and fails over
            # itself) or the new one
            self.master_url = self.master_urls[
                (i + 1) % len(self.master_urls)]

    def _master_call(self, fn, retryable=None):
        """Run ``fn(master_stub)`` with HA failover: a dead master (or a
        follower answering a leader-only rpc, detected by ``retryable``
        on the response) rotates to the next configured master. Without
        this, every data-plane request that consults the master would
        500 during the window between a leader death and the heartbeat
        loop's own rotation."""
        import grpc

        last: Exception = RuntimeError("no master configured")
        for _ in range(max(2, len(self.master_urls) + 1)):
            try:
                r = fn(self.master_stub())
                if retryable is not None and retryable(r):
                    last = RuntimeError("master is not the leader")
                    self._rotate_master()
                    continue
                return r
            except grpc.RpcError as e:
                last = e
                self._rotate_master()
        raise last

    def _heartbeat_snapshot(self) -> master_pb2.Heartbeat:
        # disk-reality self-heal belongs to the heartbeat path, not to
        # read-only status() callers like volume.list
        try:
            self.store.reconcile_ec_shards()
        except Exception as e:  # noqa: BLE001 — never kill a heartbeat
            glog.warning("ec reconcile failed: %s", e)
        st = self.store.status()
        hb = master_pb2.Heartbeat(
            ip=self.ip, port=self.port, public_url=self.public_url,
            max_volume_count=sum(l.max_volumes
                                 for l in self.store.locations),
            data_center=self.data_center, rack=self.rack,
            has_no_volumes=not st["volumes"],
            has_no_ec_shards=not st["ec_shards"])
        max_key = 0
        for v in st["volumes"]:
            vol = self.store.volumes.get((v["collection"], v["id"]))
            if vol is None or vol.nm is None:
                # deleted or unmounted since the snapshot (the JAX
                # package raises KeyError here, which breaks the
                # heartbeat stream; ROADMAP Queue 3)
                continue
            max_key = max(max_key, vol.nm.max_key)
            hb.volumes.add(
                id=v["id"], collection=v["collection"], size=v["size"],
                file_count=v["file_count"],
                delete_count=v.get("deleted_count", 0),
                deleted_byte_count=v.get("deleted_bytes", 0),
                read_only=v["read_only"],
                replica_placement=ReplicaPlacement.parse(
                    v["replica_placement"]).to_byte(),
                version=v.get("version", 3),
                ttl=int.from_bytes(
                    Ttl.parse(v.get("ttl", "")).to_bytes(), "big"),
                modified_at_second=v.get("modified_at_second", 0))
        for s in st["ec_shards"]:
            hb.ec_shards.add(id=s["id"], collection=s["collection"],
                             ec_index_bits=s["ec_index_bits"])
        hb.max_file_key = max_key
        if telemetry_mod.enabled():
            collections = {v["id"]: v["collection"]
                           for v in st["volumes"]}
            for s in st["ec_shards"]:
                collections.setdefault(s["id"], s["collection"])
            hb.telemetry.CopyFrom(self.telemetry.snapshot(
                cache_counts=self.chunk_cache.per_volume_counts(),
                collections=collections))
        if usage_mod.enabled():
            hb.usage.CopyFrom(self.usage.snapshot())
        if jobs_mod.enabled() and self.job_worker is not None:
            # Naming an in-flight task here renews its lease.
            hb.job_progress.CopyFrom(self.job_worker.progress_proto())
        return hb

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._run_heartbeat_stream()
            except Exception as e:
                if not self._stop.is_set():
                    glog.v(1, "heartbeat stream to %s broke: %s",
                           self.master_url, e)
                    # HA failover: rotate to the next configured master
                    # so a dead leader doesn't strand the heartbeat.
                    self._rotate_master()
            self._stop.wait(self.pulse_seconds)

    def _run_heartbeat_stream(self) -> None:
        stub = self.master_stub()

        def gen():
            while not self._stop.is_set():
                yield self._heartbeat_snapshot()
                self._stop.wait(self.pulse_seconds)

        for resp in stub.SendHeartbeat(gen()):
            self._set_metrics_pusher(resp.metrics_address)
            if resp.leader and resp.leader != self.master_url:
                # Follow the leader (the reference volume server redials
                # whatever master the heartbeat response names). Track
                # it in the rotation list too, so if THIS leader later
                # dies we can still rotate back to a seed master.
                glog.v(1, "volume %s: following leader %s", self.url,
                       resp.leader)
                if resp.leader not in self.master_urls:
                    # worst case under a race is a duplicate rotation
                    # entry, which only repeats a failover hop
                    self.master_urls.append(resp.leader)
                self.master_url = resp.leader
                return
            if self._stop.is_set():
                return

    def _set_metrics_pusher(self, address: str) -> None:
        """Start, retarget, or stop the push-gateway pusher per the
        address the master advertised in its heartbeat response (an
        empty address means the master runs without a gateway — stop
        pushing rather than POSTing to a decommissioned endpoint
        forever)."""
        # Decide under the lock, but do the blocking work (pusher-thread
        # join, config rpc with a 5s deadline) OUTSIDE it — _channel()/
        # peer_stub()/ec_shard_peers all share this lock, so holding it
        # across a slow rpc would stall EC reads for seconds.
        with self._lock:
            if self._stop.is_set():
                return
            old = self._metrics_pusher
            if old is not None and old.address == address:
                return  # unchanged
            if old is None and not address:
                return  # nothing running, nothing requested
            self._metrics_pusher = None
        if old is not None:
            old.stop()
        if not address:
            return  # gateway decommissioned: stay stopped
        interval = 15.0
        try:
            cfg = self.master_stub().GetMasterConfiguration(
                master_pb2.GetMasterConfigurationRequest(), timeout=5)
            if cfg.metrics_interval_seconds:
                interval = float(cfg.metrics_interval_seconds)
        except Exception as e:  # noqa: BLE001 — default cadence is fine
            glog.v(1, "metrics interval query failed (%s); using "
                      "default %gs", e, interval)
        from ..util.stats import MetricsPusher
        pusher = MetricsPusher(self.metrics, address, "volume_server",
                               self.url, interval).start()
        with self._lock:
            if self._stop.is_set():
                stale = pusher
            else:
                self._metrics_pusher, stale = pusher, None
        if stale is not None:
            stale.stop()

    def heartbeat_now(self) -> None:
        """One immediate snapshot push (tests / post-admin-op nudge)."""
        if not self.master_url:
            return
        stub = self.master_stub()
        for _ in stub.SendHeartbeat(iter([self._heartbeat_snapshot()])):
            break

    # ------------- EC shard location helpers -------------

    def ec_shard_peers(self, volume_id: int, shard_id: int) -> list[str]:
        """Servers holding one shard, from the master (cached ~1s)."""
        if not self.master_url:
            return []
        now = time.time()
        with self._lock:
            cached = self._ec_loc_cache.get(volume_id)
        if cached is None or now - cached[0] > 1.0:
            resp = self._master_call(lambda stub: stub.LookupEcVolume(
                master_pb2.LookupEcVolumeRequest(volume_id=volume_id)))
            table = {e.shard_id: [l.url for l in e.locations]
                     for e in resp.shard_id_locations}
            with self._lock:
                self._ec_loc_cache[volume_id] = (now, table)
            cached = (now, table)
        return cached[1].get(shard_id, [])

    def remote_shard_read(self, url: str, volume_id: int, shard_id: int,
                          offset: int, size: int) -> bytes:
        out = bytearray()
        for resp in self.peer_stub(url).VolumeEcShardRead(
                volume_server_pb2.VolumeEcShardReadRequest(
                    volume_id=volume_id, shard_id=shard_id,
                    offset=offset, size=size)):
            out.extend(resp.data)
        return bytes(out)

    # ------------- data plane -------------

    @staticmethod
    def _ec_cache_key(volume_id: int, fid: FileId) -> str:
        # vid+key+cookie is cluster-unique; the collection is left out
        # on purpose — lookups with and without it must share the entry.
        return f"ec:{volume_id}:{fid.key}:{fid.cookie}"

    def read_bytes(self, volume_id: int, fid: FileId,
                   collection: str = "") -> bytes:
        """GET path: normal volume first, then mounted EC shards through
        the post-decode cache (a hit decodes nothing)."""
        faults.check("volume.read")
        if self.store.has_volume(volume_id, collection):
            with tracing.span("store.read_needle", vid=volume_id) as sp:
                n = self.store.read_needle(volume_id, fid.key,
                                           fid.cookie, collection)
                sp.n_bytes = len(n.data)
            return faults.mangle("volume.read", n.data)
        ckey = self._ec_cache_key(volume_id, fid)
        cached = self.chunk_cache.get(ckey)
        if cached is not None:
            return cached
        mount = self.store.ec_mounts.get((collection, volume_id))
        if mount is None and collection == "":
            # Collection not known from the fid; match on vid alone.
            for (c, vid), m in list(self.store.ec_mounts.items()):
                if vid == volume_id:
                    mount = m
                    break
        if mount is None:
            raise StoreError(f"volume {volume_id} not found")
        with tracing.span("ec.reconstruct", vid=volume_id) as sp:
            reader = ClusterEcReader(self, volume_id, mount.base,
                                     _scheme_from_vif(mount.base),
                                     device=self.device)
            n = reader.read_needle(fid.key, fid.cookie)
            sp.n_bytes = len(n.data)
            sp.tag(intervals_repaired=reader.intervals_repaired)
        self.metrics.counter("ec_intervals_repaired").inc(
            reader.intervals_repaired)
        self.telemetry.record_ec_decode(volume_id)
        self.chunk_cache.put(ckey, n.data, volume=volume_id)
        return n.data

    def write_needle_local(self, volume_id: int, n: Needle,
                           collection: str = "") -> int:
        return self.store.write_needle(volume_id, n, collection)

    def replica_peers(self, volume_id: int, collection: str = ""
                      ) -> list[str]:
        if not self.master_url:
            return []
        resp = self._master_call(
            lambda stub: stub.LookupVolume(
                master_pb2.LookupVolumeRequest(
                    volume_ids=[str(volume_id)], collection=collection)),
            retryable=lambda r: any(
                e.error and "not the leader" in e.error
                for e in r.volume_id_locations))
        for entry in resp.volume_id_locations:
            return [l.url for l in entry.locations if l.url != self.url]
        return []


class _VolumeServicer:
    """gRPC service impl; 1:1 with volume_grpc_*.go handlers."""

    def __init__(self, vs: VolumeServer):
        self.vs = vs
        # (collection, vid) -> vacuum.CompactState between the Compact
        # and Commit rpcs of a vacuum.
        self._compact_states: dict[tuple[str, int], object] = {}

    # ---- volume admin ----

    def AllocateVolume(self, request, context):
        self.vs.store.create_volume(
            request.volume_id, request.collection,
            request.replication or "000", request.ttl)
        return volume_server_pb2.AllocateVolumeResponse()

    def VolumeDelete(self, request, context):
        self.vs.store.delete_volume(request.volume_id, request.collection)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeDeleteResponse()

    def VolumeMarkReadonly(self, request, context):
        self.vs.store.mark_readonly(request.volume_id, request.collection)
        return volume_server_pb2.VolumeMarkReadonlyResponse()

    def VolumeMarkWritable(self, request, context):
        self.vs.store.mark_writable(request.volume_id, request.collection)
        return volume_server_pb2.VolumeMarkWritableResponse()

    # -- vacuum family (volume_grpc_vacuum.go analogs) ------------------

    def VacuumVolumeCheck(self, request, context):
        return volume_server_pb2.VacuumVolumeCheckResponse(
            garbage_ratio=self.vs.store.garbage_ratio(
                request.volume_id, request.collection))

    def VacuumVolumeCompact(self, request, context):
        from ..storage import vacuum as vacuum_mod

        vol = self.vs.store.get_volume(request.volume_id,
                                       request.collection)
        # keyed per volume, and the vacuum_in_progress claim (taken
        # under vol._lock inside compact) already excludes concurrent
        # compacts of the SAME volume; distinct-key dict ops are
        # GIL-atomic
        self._compact_states[(request.collection, request.volume_id)] = \
            vacuum_mod.compact(vol)
        return volume_server_pb2.VacuumVolumeCompactResponse()

    def VacuumVolumeCommit(self, request, context):
        from ..storage import vacuum as vacuum_mod

        key = (request.collection, request.volume_id)
        state = self._compact_states.pop(key, None)
        if state is None:
            raise VolumeServerError(
                f"no compact in progress for volume {request.volume_id}")
        vol = self.vs.store.get_volume(request.volume_id,
                                       request.collection)
        size = vacuum_mod.commit_compact(vol, state)
        self.vs.heartbeat_now()
        return volume_server_pb2.VacuumVolumeCommitResponse(
            volume_size=size)

    def VacuumVolumeCleanup(self, request, context):
        from ..storage import vacuum as vacuum_mod

        key = (request.collection, request.volume_id)
        self._compact_states.pop(key, None)
        vol = self.vs.store.get_volume(request.volume_id,
                                       request.collection)
        vacuum_mod.abort_compact(vol)
        return volume_server_pb2.VacuumVolumeCleanupResponse()

    # -- cold tier (volume_grpc_tier.go analogs) ------------------------

    def VolumeTierMoveDatToRemote(self, request, context):
        """Move this server's copy of the volume onto the S3 tier
        (Store.tier_move: seal -> heartbeat the freeze -> stream while
        reads keep serving -> reader-drained backend swap). The object
        key carries this server's identity so replicas of one volume
        never overwrite each other's tiered copy. Credentials come
        from the server's environment, never the wire."""
        import os as os_mod

        store = self.vs.store
        endpoint, _, bucket = \
            request.destination_backend_name.rpartition("/")
        if not endpoint or not bucket:
            raise VolumeServerError(
                f"bad destination {request.destination_backend_name!r}; "
                f"want endpoint/bucket")
        vol = store.get_volume(request.volume_id, request.collection)
        info = store.tier_move(
            request.volume_id, request.collection,
            endpoint=endpoint, bucket=bucket,
            object_key=(Path(vol.base).name + "."
                        + self.vs.url.replace(":", "-") + ".dat"),
            keep_local=request.keep_local_dat_file,
            access_key=os_mod.environ.get(
                "SEAWEEDFS_TORCH_TIER_ACCESS_KEY", ""),
            secret_key=os_mod.environ.get(
                "SEAWEEDFS_TORCH_TIER_SECRET_KEY", ""),
            on_sealed=self.vs.heartbeat_now)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeTierMoveDatToRemoteResponse(
            moved_bytes=info.size,
            object_url=f"{info.endpoint}/{info.bucket}/{info.key}")

    def VolumeTierMoveDatFromRemote(self, request, context):
        store = self.vs.store
        size = store.tier_restore(request.volume_id, request.collection)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeTierMoveDatFromRemoteResponse(
            moved_bytes=size)

    def VolumeStatus(self, request, context):
        resp = volume_server_pb2.VolumeStatusResponse()
        store = self.vs.store
        if store.has_volume(request.volume_id, request.collection):
            v = store.get_volume(request.volume_id, request.collection)
            resp.has_volume = True
            resp.dat_size = v.dat_size
            resp.file_count = v.nm.file_count
            resp.read_only = store.is_readonly(request.volume_id,
                                               request.collection)
        m = store.ec_mounts.get((request.collection, request.volume_id))
        if m:
            resp.ec_shard_ids.extend(sorted(m.shard_ids))
        return resp

    def VolumeConfigure(self, request, context):
        """Rewrite the superblock replica placement; the next
        heartbeat reports the new setting and the master re-files the
        volume under the matching layout."""
        resp = volume_server_pb2.VolumeConfigureResponse()
        try:
            self.vs.store.configure_replication(
                request.volume_id, request.replication,
                request.collection)
            self.vs.heartbeat_now()
        except Exception as e:  # noqa: BLE001 — reported, not raised
            resp.error = str(e)
        return resp

    def VolumeMount(self, request, context):
        self.vs.store.mount_volume(request.volume_id,
                                   request.collection)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeMountResponse()

    def VolumeUnmount(self, request, context):
        self.vs.store.unmount_volume(request.volume_id,
                                     request.collection)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeUnmountResponse()

    def ReadNeedleBlob(self, request, context):
        """Raw record bytes for one live needle (the replica-sync read
        behind volume.check.disk; reference volume_grpc_read_write.go
        ReadNeedleBlob)."""
        store = self.vs.store
        if not store.has_volume(request.volume_id, request.collection):
            raise StoreError(f"volume {request.volume_id} not here")
        v = store.get_volume(request.volume_id, request.collection)
        rec, offset = v.read_record(request.needle_id)
        return volume_server_pb2.ReadNeedleBlobResponse(
            needle_blob=rec, offset=offset)

    def WriteNeedleBlob(self, request, context):
        """Append a raw record read from a sibling replica
        (WriteNeedleBlob): bit-for-bit, so CRC/timestamps survive."""
        from ..storage import needle as needle_mod
        store = self.vs.store
        if not store.has_volume(request.volume_id, request.collection):
            raise StoreError(f"volume {request.volume_id} not here")
        v = store.get_volume(request.volume_id, request.collection)
        _c, key, _s = needle_mod.parse_header(request.needle_blob)
        if key != request.needle_id:
            raise StoreError(
                f"blob header id {key} != request id {request.needle_id}")
        offset = v.write_raw_record(bytes(request.needle_blob))
        return volume_server_pb2.WriteNeedleBlobResponse(offset=offset)

    # ---- file streaming ----

    def CopyFile(self, request, context):
        store = self.vs.store
        # Flush buffered appends so the streamed bytes are complete
        # (the write path holds .dat/.idx open with userspace buffers).
        if (request.ext in (".dat", ".idx")
                and store.has_volume(request.volume_id,
                                     request.collection)):
            store.get_volume(request.volume_id, request.collection).sync()
        base = self._base_for(request.volume_id, request.collection,
                              must_exist=False)
        if base is None:
            raise StoreError(
                f"volume {request.volume_id} has no local files")
        path = Path(str(base) + request.ext)
        if not path.exists():
            if request.ignore_source_file_not_found:
                return
            raise StoreError(f"{path} does not exist")
        stop = request.stop_offset or path.stat().st_size
        start = min(request.start_offset, stop)
        with open(path, "rb") as f:
            if start:
                f.seek(start)
            sent = start
            while sent < stop:
                chunk = f.read(min(_COPY_CHUNK, stop - sent))
                if not chunk:
                    break
                sent += len(chunk)
                yield volume_server_pb2.CopyFileResponse(
                    file_content=chunk)

    def VolumeCopy(self, request, context):
        """Pull a whole .dat/.idx pair from the source node and register
        the volume locally (volume.balance / fix.replication's mover).

        The .idx is copied BEFORE the .dat so a write that lands on the
        source mid-copy can only leave the replica's .dat with unindexed
        tail bytes (harmless), never an index entry pointing past the end
        of the data file. Callers that delete the source afterwards
        (volume.balance) must freeze it with VolumeMarkReadonly first.
        """
        vs = self.vs
        if vs.store.has_volume(request.volume_id, request.collection):
            raise StoreError(
                f"volume {request.volume_id} already exists here")
        base = _dest_base(vs, request.volume_id, request.collection)
        src = request.source_data_node
        try:
            _copy_remote_file(vs, src, request.volume_id,
                              request.collection, ".idx", idx_path(base))
            _copy_remote_file(vs, src, request.volume_id,
                              request.collection, ".dat", dat_path(base))
        except Exception:
            # No half-volume may survive: an orphan .dat would register
            # as an empty volume on the next load_existing().
            for p in (dat_path(base), idx_path(base)):
                p.unlink(missing_ok=True)
            raise
        vs.store.load_existing()
        vs.heartbeat_now()
        return volume_server_pb2.VolumeCopyResponse(
            last_append_at_ns=time.time_ns())

    def _base_for(self, volume_id: int, collection: str,
                  must_exist: bool = True):
        store = self.vs.store
        if store.has_volume(volume_id, collection):
            return store.get_volume(volume_id, collection).base
        base = store.ec_base(volume_id, collection)
        if base is None and must_exist:
            raise StoreError(f"volume {volume_id} not found")
        return base

    # ---- EC family ----

    def _scheme(self, data_shards: int, parity_shards: int) -> EcScheme:
        if data_shards and parity_shards:
            return EcScheme(data_shards, parity_shards)
        return DEFAULT_SCHEME

    def VolumeEcShardsGenerate(self, request, context):
        """The §3.1 hot path: stripe + encode on the card's GF(2^8)
        kernels + shard files."""
        vs = self.vs
        vol = vs.store.get_volume(request.volume_id, request.collection)
        scheme = self._scheme(request.data_shards, request.parity_shards)
        vol.sync()
        encode_mod.encode_volume(vol.base, scheme, device=vs.device)
        return volume_server_pb2.VolumeEcShardsGenerateResponse()

    def VolumeEcShardsRebuild(self, request, context):
        """§3.5: pull sibling shards from peers, reconstruct only the
        shards missing cluster-wide, drop the temporary copies."""
        vs = self.vs
        base = vs.store.ec_base(request.volume_id, request.collection)
        if base is None:
            raise StoreError(
                f"no local ec files for volume {request.volume_id}")
        scheme = _scheme_from_vif(base)
        total = scheme.total_shards
        local = set(ec_files.present_shards(base, total))
        # Cluster-wide view: a shard is missing only if neither we nor
        # any peer holds it.
        missing = [sid for sid in range(total)
                   if sid not in local
                   and not vs.ec_shard_peers(request.volume_id, sid)]
        resp = volume_server_pb2.VolumeEcShardsRebuildResponse()
        if not missing:
            return resp
        # Fetch remote siblings until k survivors are on local disk.
        fetched: list = []
        for sid in range(total):
            if len(local) >= scheme.data_shards:
                break
            if sid in local:
                continue
            for url in vs.ec_shard_peers(request.volume_id, sid):
                if url == vs.url:
                    continue
                try:
                    dest = ec_files.shard_path(base, sid)
                    _copy_remote_file(
                        vs, url, request.volume_id,
                        request.collection, ec_files.shard_ext(sid), dest)
                    local.add(sid)
                    fetched.append(dest)
                    break
                except Exception as e:
                    glog.v(1, "shard %d copy from %s failed: %s",
                           sid, url, e)
        try:
            rebuilt = rebuild_mod.rebuild_ec_files(
                base, scheme, wanted=missing, device=vs.device)
        finally:
            for p in fetched:
                if p.exists():
                    p.unlink()
        vs.store.mount_ec_shards(request.volume_id, rebuilt,
                                 request.collection)
        vs.heartbeat_now()
        resp.rebuilt_shard_ids.extend(rebuilt)
        return resp

    def VolumeEcShardsCopy(self, request, context):
        """Pull shards (and index files) from source_data_node to here."""
        vs = self.vs
        base = _dest_base(vs, request.volume_id, request.collection)
        src = request.source_data_node
        for sid in request.shard_ids:
            _copy_remote_file(vs, src, request.volume_id,
                              request.collection, ec_files.shard_ext(sid),
                              ec_files.shard_path(base, sid))
        if request.copy_ecx_file:
            _copy_remote_file(vs, src, request.volume_id,
                              request.collection, ".ecx",
                              ec_files.ecx_path(base))
        if request.copy_ecj_file:
            # .ecj may legitimately not exist (no post-seal deletes yet).
            _copy_remote_file(vs, src, request.volume_id,
                              request.collection, ".ecj",
                              ec_files.ecj_path(base),
                              ignore_missing=True)
        if request.copy_vif_file:
            _copy_remote_file(vs, src, request.volume_id,
                              request.collection, ".vif",
                              ec_files.vif_path(base))
        vs.heartbeat_now()
        return volume_server_pb2.VolumeEcShardsCopyResponse()

    def VolumeEcShardsDelete(self, request, context):
        base = self.vs.store.ec_base(request.volume_id, request.collection)
        if base is not None:
            for sid in request.shard_ids:
                p = ec_files.shard_path(base, sid)
                if p.exists() or p.is_symlink():
                    p.unlink()
        self.vs.store.unmount_ec_shards(
            request.volume_id, list(request.shard_ids),
            request.collection)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeEcShardsDeleteResponse()

    def VolumeEcShardsMount(self, request, context):
        self.vs.store.mount_ec_shards(
            request.volume_id, list(request.shard_ids),
            request.collection)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeEcShardsMountResponse()

    def VolumeEcShardsUnmount(self, request, context):
        # The request carries no collection: unmount the volume's shards
        # in whichever collection mounts them (the JAX package looks in
        # the default collection only, so a collection's shards stayed
        # mounted; ROADMAP Queue 3).
        store = self.vs.store
        for (c, vid) in list(store.ec_mounts):
            if vid == request.volume_id:
                store.unmount_ec_shards(vid, list(request.shard_ids), c)
        self.vs.heartbeat_now()
        return volume_server_pb2.VolumeEcShardsUnmountResponse()

    def VolumeEcShardRead(self, request, context):
        base = self.vs.store.ec_base(request.volume_id)
        if base is None:
            for (c, vid), m in list(self.vs.store.ec_mounts.items()):
                if vid == request.volume_id:
                    base = m.base
                    break
        if base is None:
            raise StoreError(
                f"no shards for volume {request.volume_id} here")
        path = ec_files.shard_path(base, request.shard_id)
        if not path.exists():
            raise StoreError(f"shard {request.shard_id} not here")
        remaining = request.size
        with open(path, "rb") as f:
            f.seek(request.offset)
            while remaining > 0:
                chunk = f.read(min(_COPY_CHUNK, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
                yield volume_server_pb2.VolumeEcShardReadResponse(
                    data=chunk)

    def VolumeEcShardsToVolume(self, request, context):
        """ec.decode's server half: shards -> .dat/.idx again."""
        vs = self.vs
        base = vs.store.ec_base(request.volume_id, request.collection)
        if base is None:
            raise StoreError(
                f"no local ec files for volume {request.volume_id}")
        scheme = _scheme_from_vif(base)
        decode_mod.decode_volume(base, scheme, device=vs.device)
        vs.store.unmount_ec_shards(
            request.volume_id,
            list(range(scheme.total_shards)), request.collection)
        vs.store.load_existing()
        vs.heartbeat_now()
        return volume_server_pb2.VolumeEcShardsToVolumeResponse()

    def VolumeEcBlobDelete(self, request, context):
        base = self.vs.store.ec_base(request.volume_id, request.collection)
        if base is None:
            raise StoreError(
                f"no local ec files for volume {request.volume_id}")
        ec_files.ecj_append(base, request.file_key)
        return volume_server_pb2.VolumeEcBlobDeleteResponse()


def _dest_base(vs: VolumeServer, volume_id: int, collection: str) -> Path:
    """Destination base path for files pulled onto this server."""
    from ..storage.store import volume_base_name

    loc = vs.store._pick_location()
    return loc.directory / volume_base_name(volume_id, collection)


def _scheme_from_vif(base) -> EcScheme:
    """Geometry travels in the .vif (config-4 parametrization)."""
    try:
        vi = ec_files.VolumeInfo.load(base)
        if vi.data_shards and vi.parity_shards:
            return EcScheme(vi.data_shards, vi.parity_shards)
    except Exception:  # noqa: BLE001 — no or unreadable .vif: default
        pass
    return DEFAULT_SCHEME


def _copy_remote_file(vs: VolumeServer, src_url: str, volume_id: int,
                      collection: str, ext: str, dest: Path,
                      ignore_missing: bool = False) -> None:
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    got_any = False
    try:
        with open(tmp, "wb") as f:
            for resp in vs.peer_stub(src_url).CopyFile(
                    volume_server_pb2.CopyFileRequest(
                        volume_id=volume_id, collection=collection,
                        ext=ext,
                        ignore_source_file_not_found=ignore_missing)):
                f.write(resp.file_content)
                got_any = True
    except Exception:
        tmp.unlink(missing_ok=True)
        raise
    if ignore_missing and not got_any and tmp.stat().st_size == 0:
        tmp.unlink()
        return
    # durable rename commit: the copied replica/shard file must survive
    # power loss once callers (ec.rebuild, volume copy) treat it as
    # placed — fsync the bytes AND the directory entry
    durability.durable_replace(tmp, dest)


def _make_http_handler(vs: VolumeServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            glog.v(2, "volume http: " + fmt, *args)

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/octet-stream",
                  extra: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _parse_fid(self) -> tuple[int, FileId, dict]:
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            fid = FileId.parse(u.path.lstrip("/"))
            return fid.volume_id, fid, q

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/status":
                self._json({"Version": "seaweedfs-tpu",
                            **vs.store.status()})
                return
            if u.path == "/metrics":
                self._send(200, (vs.metrics.render()
                                 + tracing.METRICS.render()
                                 + retry.METRICS.render()
                                 + flight_mod.METRICS.render()
                                 + scrubber_mod.METRICS.render()
                                 + httpserver.METRICS.render()).encode(),
                           EXPOSITION_CONTENT_TYPE)
                return
            if u.path == "/debug/traces":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                self._json(tracing.debug_payload(
                    int(q["limit"]) if "limit" in q else None))
                return
            if u.path == "/debug/profile":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                self._send(200, profiler.profile(
                    float(q.get("seconds", 2.0)),
                    hz=float(q.get("hz", profiler.DEFAULT_BURST_HZ))
                ).encode(), "text/plain; charset=utf-8")
                return
            if u.path == "/debug/vars":
                self._json(varz.payload(
                    "volume", vs.metrics,
                    extra={"telemetry": vs.telemetry.to_map(),
                           "cache": vs.chunk_cache.stats(),
                           "usage": vs.usage.to_payload(),
                           "jobs": (vs.job_worker.summary()
                                    if vs.job_worker else None)}))
                return
            t0 = time.perf_counter()
            vid = None
            fid_key = ""
            n_read = 0
            err = False
            try:
                vid, fid, q = self._parse_fid()
                fid_key = str(fid)
                data = vs.read_bytes(vid, fid, q.get("collection", ""))
                n_read = len(data)
                mime = ""
                if "width" in q or "height" in q:
                    try:
                        w = int(q.get("width", 0) or 0)
                        h = int(q.get("height", 0) or 0)
                        if w < 0 or h < 0:
                            raise ValueError
                    except ValueError:
                        self._json({"error": "width/height must be "
                                    "non-negative integers"}, 400)
                        vs.metrics.counter("read_requests",
                                           code="400").inc()
                        return
                    # on-read image scaling (weed/images)
                    from ..images import resized
                    data, mime = resized(data, w, h, q.get("mode", ""))
                # RFC 7233 single range on the (possibly resized) body:
                # shard restores range-read needles directly off the
                # volume server, so 206/Content-Range must be exact.
                rng_hdr = self.headers.get("Range")
                rng = httpserver.parse_range(rng_hdr, len(data)) \
                    if rng_hdr else None
                if rng is not None:
                    off, ln = rng
                    self._send(
                        206, data[off:off + ln],
                        mime or "application/octet-stream",
                        {"Accept-Ranges": "bytes",
                         "Content-Range":
                         f"bytes {off}-{off + ln - 1}/{len(data)}"})
                    vs.metrics.counter("read_requests",
                                       code="206").inc()
                elif rng_hdr and rng_hdr.startswith("bytes="):
                    # well-formed but unsatisfiable (or malformed spec):
                    # answer 416 so a ranged reader never silently gets
                    # the whole needle
                    self._send(
                        416, b"", "application/octet-stream",
                        {"Content-Range": f"bytes */{len(data)}"})
                    vs.metrics.counter("read_requests",
                                       code="416").inc()
                else:
                    self._send(200, data,
                               mime or "application/octet-stream",
                               {"Accept-Ranges": "bytes"})
                    vs.metrics.counter("read_requests",
                                       code="200").inc()
            except faults.FaultDrop:
                # Injected connection drop: no response, hard close.
                # Answering 500 here would leave a healthy-looking
                # keep-alive stream whose next pipelined request reads
                # a response that was never meant to exist.
                err = True
                vs.metrics.counter("read_requests", code="drop").inc()
                httpserver.drop_connection(self)
            except (KeyError, StoreError) as e:
                vs.metrics.counter("read_requests", code="404").inc()
                self._json({"error": str(e)}, 404)
            except Exception as e:
                err = True
                vs.metrics.counter("read_requests", code="500").inc()
                self._json({"error": str(e)}, 500)
            finally:
                dt = time.perf_counter() - t0
                vs.metrics.histogram("read_seconds").observe(dt)
                if vid is not None:
                    vs.telemetry.record_read(vid, n_read, dt, error=err)
                    vs.usage.record_key(fid_key, volume=vid)

        def do_HEAD(self):
            try:
                vid, fid, q = self._parse_fid()
                data = vs.read_bytes(vid, fid, q.get("collection", ""))
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
            except Exception:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

        def do_POST(self):
            if urlparse(self.path).path == "/cache/invalidate":
                # Cluster invalidation fan-out (job commits on other
                # nodes): funnel into the local registry before the
                # fid parser rejects the path.
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    self._json(invalidation_mod.handle_event(payload))
                except (ValueError, OSError) as e:
                    self._json({"error": str(e)}, 400)
                return
            t0 = time.perf_counter()
            vid = None
            n_written = 0
            err = False
            try:
                vid, fid, q = self._parse_fid()
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                n_written = len(body)
                jwt = (self.headers.get("Authorization", "")
                       .removeprefix("BEARER ").strip()
                       or q.get("jwt", ""))
                if not vs.guard.verify(jwt, str(fid)):
                    self._json({"error": "unauthorized"}, 401)
                    return
                n = Needle(id=fid.key, cookie=fid.cookie, data=body)
                vs.write_needle_local(vid, n, q.get("collection", ""))
                if q.get("type") != "replicate":
                    for peer in vs.replica_peers(vid,
                                                 q.get("collection", "")):
                        _replicate_http(peer, str(fid), body, jwt,
                                        q.get("collection", ""))
                self._json({"name": q.get("name", ""), "size": len(body)},
                           201)
                vs.metrics.counter("write_requests", code="201").inc()
            except faults.FaultDrop:
                err = True
                vs.metrics.counter("write_requests", code="drop").inc()
                httpserver.drop_connection(self)
            except StoreError as e:
                vs.metrics.counter("write_requests", code="404").inc()
                self._json({"error": str(e)}, 404)
            except Exception as e:
                err = True
                vs.metrics.counter("write_requests", code="500").inc()
                self._json({"error": str(e)}, 500)
            finally:
                dt = time.perf_counter() - t0
                vs.metrics.histogram("write_seconds").observe(dt)
                if vid is not None:
                    vs.telemetry.record_write(vid, n_written, dt,
                                              error=err)

        do_PUT = do_POST

        def do_DELETE(self):
            try:
                vid, fid, q = self._parse_fid()
                jwt = (self.headers.get("Authorization", "")
                       .removeprefix("BEARER ").strip()
                       or q.get("jwt", ""))
                if not vs.guard.verify(jwt, str(fid)):
                    self._json({"error": "unauthorized"}, 401)
                    return
                ok = vs.store.delete_needle(vid, fid.key,
                                            q.get("collection", ""))
                vs.chunk_cache.invalidate(vs._ec_cache_key(vid, fid))
                if q.get("type") != "replicate":
                    for peer in vs.replica_peers(vid,
                                                 q.get("collection", "")):
                        _replicate_http(peer, str(fid), None, jwt,
                                        q.get("collection", ""))
                self._json({"size": int(ok)})
            except (KeyError, StoreError) as e:
                self._json({"error": str(e)}, 404)
            except Exception as e:
                self._json({"error": str(e)}, 500)

    return tracing.instrument_http_handler(
        httpserver.admission_gate(Handler), "volume")


def _replicate_http(peer_url: str, fid: str, body: Optional[bytes],
                    jwt: str = "", collection: str = "") -> None:
    """Fan a write/delete out to one replica (?type=replicate stops the
    fan-out from cascading; topology/store_replicate.go). Rides the
    resilience layer: a replica mid-restart gets jittered retries, a
    dead one trips its breaker instead of stalling every write."""
    url = f"http://{peer_url}/{fid}?type=replicate"
    if collection:
        url += f"&collection={collection}"
    retry.http_request(url, data=body,
                       method="DELETE" if body is None else "POST",
                       point="replica.push", jwt=jwt, timeout=30)


def apply_config(conf: dict) -> dict:
    """Apply a loaded ``-config`` TOML: ``[grpc.tls]``, ``[tracing]``,
    ``[telemetry]``, ``[usage]``, ``[retry]``, ``[faults]``,
    ``[storage]`` (the fsync policy), ``[storage.scrub]`` (the scrub
    pacer's rate), ``[profiler]`` (and start its sampler when enabled),
    ``[ingress]``, ``[pipeline]``, ``[flight]``, ``[mesh]`` and the
    ``[jobs]`` kill switch. Returns the :class:`VolumeServer` keywords
    the file sets: ``secret`` (the JWT signing key) and
    ``job_poll_seconds`` (``[jobs] poll_seconds``)."""
    from ..util import config as config_mod

    secret = config_mod.lookup(conf, "jwt.signing.key", "")
    tls_mod.install_from_config(conf)
    tracing.configure_from(conf)
    telemetry_mod.configure_from(conf)
    usage_mod.configure_from(conf)
    retry.configure_from(conf)
    faults.configure_from(conf)
    durability.configure_from(conf)
    scrubber_mod.configure_from(conf)
    profiler.configure_from(conf)
    httpserver.configure_from(conf)
    jobs_mod.configure_from(conf)
    profiler.ensure_started()
    if config_mod.lookup(conf, "pipeline") is not None:
        from ..pipeline import pipe as pipe_mod
        pipe_mod.configure_from(conf)
    if config_mod.lookup(conf, "flight") is not None:
        flight_mod.configure_from(conf)
    if config_mod.lookup(conf, "mesh") is not None:
        from ..parallel import mesh as mesh_mod
        mesh_mod.configure_from(conf)
    job_poll = config_mod.lookup(conf, "jobs.poll_seconds")
    return {"secret": secret,
            "job_poll_seconds": (float(job_poll)
                                 if job_poll is not None else None)}


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m seaweedfs_tpu_torch volume`` (weed/command/volume.go).

    Serves until SIGINT or SIGTERM, then stops cleanly. Exit 2: a bad
    flag or ``-config`` (one ``error:`` line); exit 1: no card without
    ``-device cpu``, or a store that does not open."""
    import argparse
    import signal
    import sys

    from ..util import config as config_mod

    p = argparse.ArgumentParser(prog="volume", allow_abbrev=False)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-dir", action="append", required=True)
    p.add_argument("-max", type=int, default=8)
    p.add_argument("-mserver", default="127.0.0.1:9333",
                   help="master ip:port list (comma-separated); empty: "
                        "no master")
    p.add_argument("-dataCenter", default="")
    p.add_argument("-rack", default="")
    p.add_argument("-publicUrl", default="")
    p.add_argument("-pulseSeconds", type=float, default=5.0)
    p.add_argument("-index", default="memory",
                   choices=["memory", "native", "sqlite"],
                   help="needle map kind: memory (dict), native (C++ "
                        "open-addressing table, ~10x less RAM), sqlite "
                        "(disk-backed, index exceeds RAM)")
    p.add_argument("-backend", default="disk",
                   choices=["disk", "mmap"],
                   help=".dat storage backend")
    p.add_argument("-config", default="",
                   help="TOML: the JWT signing key, [grpc.tls], [tracing], "
                        "[telemetry], [usage], "
                        "[retry], [faults], [storage], [storage.scrub], "
                        "[profiler], [ingress], [pipeline], [flight], "
                        "[mesh], [jobs]")
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="where encode, rebuild, decode and EC reads run "
                        "(default: the card)")
    args = p.parse_args(argv)
    try:
        conf = config_mod.load(args.config) if args.config else {}
        server_kw = apply_config(conf)
    except (OSError, TypeError, ValueError) as e:
        print(f"error: -config {args.config}: {e}", file=sys.stderr)
        return 2
    store = None
    try:
        rs_torch.resolve_device(args.device)
        store = Store(args.dir, max_volumes=args.max, backend=args.backend,
                      needle_map=args.index)
        store.load_existing()
    except (RuntimeError, OSError) as e:
        # no card, a location that is not a directory, a volume that
        # does not load (StoreError and VolumeError are RuntimeErrors)
        if store is not None:
            store.close()
        print(f"error: {e}", file=sys.stderr)
        return 1
    vs = VolumeServer(store, ip=args.ip, port=args.port,
                      master_url=args.mserver, public_url=args.publicUrl,
                      data_center=args.dataCenter, rack=args.rack,
                      pulse_seconds=args.pulseSeconds,
                      device=args.device, **server_kw)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    vs.start()
    try:
        stop.wait()
    finally:
        vs.stop()
    return 0
