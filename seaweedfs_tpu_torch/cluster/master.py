"""Master server: control plane over gRPC + HTTP.

The port of ``seaweedfs_tpu/cluster/master.py`` (weed/server/
master_server.go + master_grpc_server.go; SURVEY.md §2 "weed master",
§3.4): volume servers stream heartbeats in and get leader/size-limit
back; clients assign file ids (``/dir/assign``, gRPC ``Assign``) and look
volumes up (``/dir/lookup``, ``LookupVolume``, ``LookupEcVolume``). When
an assign finds no writable volume the master grows one — picks replica
targets off the topology and calls ``AllocateVolume`` on each
(volume_growth.go's ``GrowByCountAndType``). Among several masters
(``peers``) the Raft-lite election of ``ha.py`` picks one leader; a lone
master is always leader. The wire is the reference's, so JAX and port
volume servers, clients and masters mix.

The maintenance plane rides along (``jobs.py``): the leader's
:class:`JobManager` holds the leased work-lists that the volume servers'
job workers pull (``/cluster/jobs/*``, ``/cluster/scrub``), renews
leases from ``Heartbeat.job_progress``, expires them from the reap loop
and checkpoints to ``<meta_dir>/jobs.json``. ``/cluster/status`` keeps
the JAX master's keys.

The tracing plane rides along too: servers push their slow or errored
trace roots to ``POST /cluster/traces``, where :attr:`MasterServer.
trace_collector` stitches the legs of one request into one trace
(``GET /cluster/traces``; a follower proxies both to the leader), and
the master's own roots go straight into it. ``/cluster/profile?node=``
proxies a burst profile of any node, and ``/debug/traces``,
``/debug/profile`` and ``/debug/vars`` (with the jobs summary, the
hub's ``cache_hub`` map and the collector's counts) describe the master
itself. ``-config`` applies ``[tracing]`` and ``[profiler]``.

The telemetry, SLO, usage and policy planes ride along as in the JAX
master: the heartbeat's ``telemetry`` snapshot feeds the topology's
:class:`~.telemetry.ClusterTelemetry` (decayed rates, latency digests,
node health, which ranks the replicas a lookup returns) and its
``usage`` snapshot :attr:`MasterServer.usage`, as do the gateways' and
filers' pushes to ``POST /cluster/usage``; :attr:`MasterServer.slo`
evaluates ``[slo]``'s objectives as multi-window burn rates, and
:attr:`MasterServer.policy` (``[jobs] policy``) submits ``ec_encode``,
``replicate`` and ``replica_drop`` jobs from the reap loop.
``/cluster/telemetry``, ``/cluster/usage``, ``/cluster/topk`` and
``/cluster/slo`` read them (a follower proxies to the leader), and
``/metrics`` and ``/debug/vars`` carry their families and keys.

The cache-invalidation hub (``cache/invalidation.ClusterInvalidationHub``)
is ported: filers subscribe with ``POST /cluster/cache_subscribe``, and a
committed job task that changed a volume's bytes fans
``POST /cache/invalidate`` out to every subscriber and every other
volume server (``_job_task_committed``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
from concurrent import futures
from http.server import BaseHTTPRequestHandler
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import pb
from ..cache import invalidation as invalidation_mod
from ..pb import master_pb2, volume_server_pb2
from ..storage.superblock import ReplicaPlacement, Ttl
from ..storage.types import FileId
from ..util import glog, httpserver, profiler, retry, security, tracing, \
    varz
from ..util import tls as tls_mod
from ..util.stats import EXPOSITION_CONTENT_TYPE, Metrics
from . import ha as ha_mod
from . import jobs as jobs_mod
from . import usage as usage_mod
from .ha import NotLeaderError
from .sequence import MemorySequencer
from .telemetry import ClusterTelemetry, SloEngine
from .topology import Topology, TopologyError, VolumeInfo


def _grpc_port(http_port: int) -> int:
    """The reference convention: gRPC port = HTTP port + 10000."""
    return http_port + 10000


class MasterServer:
    def __init__(self, ip: str = "127.0.0.1", port: int = 9333,
                 volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 sequencer: Optional[MemorySequencer] = None,
                 secret: str = "", seed: Optional[int] = None,
                 garbage_threshold: float = 0.3,
                 garbage_scan_seconds: float = 60.0,
                 peers: Optional[list[str]] = None,
                 meta_dir: Optional[str] = None,
                 election_timeout: tuple[float, float] = (0.45, 0.9),
                 metrics_address: str = "",
                 metrics_interval_seconds: float = 15.0,
                 trace_ring_size: int = 256,
                 clock=time.time):
        self.ip = ip
        self.port = port
        self.url = f"{ip}:{port}"
        self.clock = clock
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds, seed=seed, clock=clock)
        if sequencer is None and meta_dir:
            Path(meta_dir).mkdir(parents=True, exist_ok=True)
            sequencer = MemorySequencer(
                persist_path=Path(meta_dir) / "sequence")
        self.sequencer = sequencer or MemorySequencer()
        # Raft-lite leader election among ``peers`` (HTTP urls incl. or
        # excl. self — self is filtered). No peers = standing leader.
        self.ha = ha_mod.RaftNode(
            self.url, list(peers or []),
            state_path=(Path(meta_dir) / "master.raft.json")
            if meta_dir else None,
            snapshot_state=self._ha_snapshot,
            apply_state=self._ha_apply,
            election_timeout=election_timeout)
        self.default_replication = default_replication
        #: Vacuum trigger: deleted/content ratio above which the reap
        #: loop drives Compact+Commit on the owning server
        #: (topology_vacuum.go; 0 disables the scan).
        self.garbage_threshold = garbage_threshold
        self.garbage_scan_seconds = garbage_scan_seconds
        self.guard = security.Guard(secret)
        self.metrics = Metrics(namespace="master")
        #: Exclusive admin lease for the shell (the master's
        #: LeaseAdminToken behind shell `lock`/`unlock`): one named
        #: client at a time may run destructive choreography; the lease
        #: expires unless renewed so a crashed shell never wedges the
        #: cluster.
        self.admin_lease_seconds = 30.0
        self._admin_mu = threading.Lock()
        self._admin_holder = ""
        self._admin_expires = 0.0
        #: Prometheus push-gateway address, distributed to volume
        #: servers via heartbeat responses (the -metrics.address flow).
        self.metrics_address = metrics_address
        self.metrics_interval_seconds = metrics_interval_seconds
        self._pusher = None
        self._channels: dict[str, object] = {}
        # the dial cache is hit from the reap/vacuum/ttl loops and the
        # ingress handlers; an unlocked check-then-set would leak a
        # duplicate (never-closed) channel per lost race
        self._chan_lock = threading.Lock()
        self._grpc_server = None
        self._http_server: Optional[httpserver.IngressHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._reaper: Optional[threading.Thread] = None
        self._vacuum_thread: Optional[threading.Thread] = None
        self._ttl_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._grow_lock = threading.Lock()
        #: Maintenance plane: durable per-volume task queues pulled by
        #: volume servers under leases renewed on the heartbeat.
        #: Leader-only like the other /cluster/* planes; the checkpoint
        #: keeps sweeps resumable across master restarts.
        self.jobs = jobs_mod.JobManager(
            topology=self.topology,
            checkpoint_path=(Path(meta_dir) / "jobs.json")
            if meta_dir else None,
            clock=clock,
            on_commit=self._job_task_committed)
        #: The policy engine that turns telemetry/usage signals into
        #: submitted jobs (``[jobs] policy``); the reap loop ticks it.
        self.policy = jobs_mod.PolicyEngine(master=self, jobs=self.jobs,
                                            clock=clock)
        #: Cluster cache-invalidation fan-out: gateways subscribe via
        #: POST /cluster/cache_subscribe; job commits that mutate a
        #: volume's bytes publish to subscribers + all volume servers.
        self.cache_hub = invalidation_mod.ClusterInvalidationHub()
        #: Stitched tail-sampled traces (servers POST /cluster/traces).
        #: Lives on every master but only the leader's fills up — the
        #: servers push to the leader, so the reads leader-proxy.
        self.trace_collector = tracing.TraceCollector(
            ring_size=trace_ring_size)
        #: SLO burn-rate engine over the telemetry registry; like the
        #: trace collector, only the leader's fills up.
        self.slo = SloEngine(self.topology.telemetry, clock=clock)
        #: Traffic accounting registry: volume servers ride the
        #: heartbeat (Heartbeat.usage); gateways/filer POST the same
        #: payload to /cluster/usage. Leader-only for the same reason
        #: as traces/telemetry.
        self.usage = usage_mod.ClusterUsage(clock=clock)

    # ------------- HA plumbing -------------

    def _ha_snapshot(self) -> dict:
        return {"max_volume_id": self.topology.max_volume_id,
                "sequence_next": self.sequencer.peek()}

    def _ha_apply(self, state: dict) -> None:
        self.topology.observe_max_volume_id(
            int(state.get("max_volume_id", 0)))
        seq = int(state.get("sequence_next", 0))
        if seq > 1:
            self.sequencer.set_max(seq - 1)

    @property
    def is_leader(self) -> bool:
        return self.ha.is_leader

    @property
    def leader_url(self) -> str:
        return self.ha.leader or (self.url if self.is_leader else "")

    def _require_leader(self) -> None:
        if not self.is_leader:
            raise NotLeaderError(self.leader_url)

    # ------------- lifecycle -------------

    def start(self) -> "MasterServer":
        import grpc

        self._grpc_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16))
        self._grpc_server.add_generic_rpc_handlers((pb.generic_handler(
            pb.MASTER_SERVICE, pb.MASTER_METHODS, _MasterServicer(self)),))
        bound = tls_mod.serve_port(
            self._grpc_server, f"{self.ip}:{_grpc_port(self.port)}")
        if bound == 0:
            raise RuntimeError(
                f"cannot bind master grpc port {_grpc_port(self.port)}")
        self._grpc_server.start()

        self._http_server = httpserver.IngressHTTPServer(
            (self.ip, self.port), _make_http_handler(self),
            component="master")
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever, daemon=True,
            name=f"master-http-{self.port}")
        self._http_thread.start()

        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name=f"master-reaper-{self.port}")
        self._reaper.start()
        self.ha.start()
        self.slo.start()
        # The master's own slow/errored roots go straight into the
        # in-process collector — no HTTP round trip to self.
        tracing.configure_push(self.trace_collector.ingest,
                               node=self.url, component="master")
        if self.metrics_address:
            from ..util.stats import MetricsPusher
            self._pusher = MetricsPusher(
                self.metrics, self.metrics_address, "master", self.url,
                self.metrics_interval_seconds).start()
        glog.info("master started at %s (grpc %d)", self.url,
                  _grpc_port(self.port))
        return self

    def stop(self) -> None:
        self._stop.set()
        self.ha.stop()
        self.slo.stop()
        if self._pusher is not None:
            self._pusher.stop()
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5)
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        for t in (self._reaper, self._vacuum_thread, self._ttl_thread):
            if t is not None:
                t.join(timeout=5)
        with self._chan_lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()

    def __enter__(self) -> "MasterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _reap_loop(self) -> None:
        vacuum_every = max(1, int(self.garbage_scan_seconds /
                                  max(self.topology.pulse_seconds, 0.01)))
        # TTL expiry has minute granularity — a full-topology scan per
        # pulse would be pure churn; once a minute matches the vacuum
        # scan's throttling approach.
        ttl_every = max(1, int(60.0 /
                               max(self.topology.pulse_seconds, 0.01)))
        tick = 0
        while not self._stop.wait(self.topology.pulse_seconds):
            for url in self.topology.reap_dead_nodes():
                glog.warning("master: data node %s missed heartbeats, "
                             "removed from topology", url)
                self.usage.forget(url)
                # Reaped workers hand their leased tasks back now
                # rather than sitting out the rest of the lease.
                self.jobs.forget_worker(url)
                self.cache_hub.forget(url)
            self.jobs.expire()
            if self.is_leader:
                self.policy.maybe_tick()
            if self.is_leader and tick % ttl_every == 0 \
                    and (self._ttl_thread is None or
                         not self._ttl_thread.is_alive()):
                # Off the reap thread: a hung VolumeDelete must not
                # stall dead-node detection (same for the vacuum scan).
                self._ttl_thread = threading.Thread(
                    target=self._reap_ttl_safe, daemon=True,
                    name="master-ttl-reap")
                self._ttl_thread.start()
            tick += 1
            if self.garbage_threshold > 0 and self.is_leader \
                    and tick % vacuum_every == 0 \
                    and (self._vacuum_thread is None
                         or not self._vacuum_thread.is_alive()):
                self._vacuum_thread = threading.Thread(
                    target=self._scan_and_vacuum_safe, daemon=True,
                    name="master-vacuum-scan")
                self._vacuum_thread.start()

    # ------------- maintenance -------------

    def _job_task_committed(self, task) -> None:
        """JobManager on_commit hook: a task that changed what a
        volume's bytes mean (EC seal/rebuild, vacuum, replica drop)
        fans a cache-invalidation event out to every subscribed
        gateway plus every other volume server, so remote chunk caches
        never serve the pre-maintenance bytes."""
        if task.kind not in jobs_mod.MUTATING_KINDS:
            return
        extra = [n.url for n in self.topology.snapshot_nodes()
                 if n.url != task.worker]
        self.cache_hub.publish(task.volume_id, reason=task.kind,
                               origin=task.worker, extra=extra)

    def job_candidate_volumes(self, kind: str,
                              collection: str = "") -> list[int]:
        """Enumerate the work-list for a whole-collection submission
        (``job.submit ec.encode -collection X`` names no volumes):
        ec_encode targets plain volumes not yet EC'd, ec_rebuild
        targets EC volumes, scrub both forms (integrity is universal),
        the rest every plain volume."""
        plain: set[int] = set()
        for _node, vols, _ec in self.topology.snapshot_holdings():
            for v in vols:
                if v.collection == collection:
                    plain.add(v.id)
        ec = {vid for vid, col in list(
            self.topology.ec_collections.items()) if col == collection}
        if kind == "ec_rebuild":
            return sorted(ec)
        if kind == "scrub":
            return sorted(plain | ec)
        if kind == "ec_encode":
            plain -= set(self.topology.ec_locations)
        return sorted(plain)

    def _reap_ttl_safe(self) -> None:
        try:
            self.reap_expired_ttl_volumes()
        except Exception as e:  # noqa: BLE001 — keep the scan cadence
            glog.warning("master: ttl reap failed: %s", e)

    def reap_expired_ttl_volumes(self) -> int:
        """Topology TTL maintenance: a TTL volume whose last write is
        older than its TTL is deleted from every replica server — the
        needles inside are all expired by definition. Returns volumes
        reaped.

        The deadline carries a grace margin beyond the TTL: the mtime
        seen here is from the last heartbeat (stale by up to a pulse),
        so reaping exactly at TTL could destroy a just-acknowledged
        write the next heartbeat would have reported."""
        now = time.time()
        grace = max(10 * self.topology.pulse_seconds, 30.0)
        reaped = 0
        for node in self.topology.snapshot_nodes():
            for v in list(node.volumes.values()):
                if not v.ttl:
                    continue
                ttl_s = Ttl.parse(v.ttl).seconds
                if not ttl_s or not v.modified_at_second:
                    continue
                if now - v.modified_at_second <= ttl_s + grace:
                    continue
                glog.info("master: volume %d on %s expired "
                          "(ttl %s, idle %.0fs); deleting", v.id,
                          node.url, v.ttl, now - v.modified_at_second)
                try:
                    self._volume_stub(node.url).VolumeDelete(
                        volume_server_pb2.VolumeDeleteRequest(
                            volume_id=v.id, collection=v.collection),
                        timeout=30)
                    self.topology.unregister_volume(node.url, v.id,
                                                    v.collection)
                    reaped += 1
                except Exception as e:  # noqa: BLE001 — next scan retries
                    glog.warning("master: ttl delete of volume %d on "
                                 "%s failed: %s", v.id, node.url, e)
        return reaped

    def _scan_and_vacuum_safe(self) -> None:
        try:
            self.scan_and_vacuum()
        except Exception as e:  # noqa: BLE001 — keep the scan cadence up
            glog.warning("master: vacuum scan failed: %s", e)

    def scan_and_vacuum(self, threshold: Optional[float] = None) -> int:
        """topology_vacuum.go analog: walk every volume, and when a
        node-reported garbage ratio exceeds the threshold, drive the
        Check → Compact → Commit rpc sequence on its server. Returns the
        number of volumes vacuumed."""
        threshold = self.garbage_threshold if threshold is None \
            else threshold
        done = 0
        for node in self.topology.snapshot_nodes():
            for v in list(node.volumes.values()):
                if v.size <= 8 or v.read_only:
                    continue
                if v.deleted_byte_count / max(1, v.size - 8) <= threshold:
                    continue
                # Per-volume isolation: one failing volume/server must
                # not starve the rest of the scan.
                try:
                    done += self._vacuum_one(node.url, v, threshold)
                except Exception as e:  # noqa: BLE001
                    glog.warning(
                        "master: vacuum of volume %d on %s failed: %s",
                        v.id, node.url, e)
        return done

    def _vacuum_one(self, node_url: str, v, threshold: float) -> int:
        stub = self._volume_stub(node_url)
        check = stub.VacuumVolumeCheck(
            volume_server_pb2.VacuumVolumeCheckRequest(
                volume_id=v.id, collection=v.collection))
        if check.garbage_ratio <= threshold:
            return 0
        glog.info("master: vacuuming volume %d on %s (garbage %.0f%%)",
                  v.id, node_url, check.garbage_ratio * 100)
        try:
            stub.VacuumVolumeCompact(
                volume_server_pb2.VacuumVolumeCompactRequest(
                    volume_id=v.id, collection=v.collection))
            stub.VacuumVolumeCommit(
                volume_server_pb2.VacuumVolumeCommitRequest(
                    volume_id=v.id, collection=v.collection))
            return 1
        except Exception:
            try:
                stub.VacuumVolumeCleanup(
                    volume_server_pb2.VacuumVolumeCleanupRequest(
                        volume_id=v.id, collection=v.collection))
            except Exception as ce:  # noqa: BLE001 — keep original error
                glog.warning("master: vacuum cleanup of volume %d on %s "
                             "also failed: %s", v.id, node_url, ce)
            raise

    # ------------- volume-server dialing -------------

    def _volume_stub(self, node_url: str) -> pb.Stub:
        with self._chan_lock:
            ch = self._channels.get(node_url)
            if ch is None:
                ip, http_port = node_url.rsplit(":", 1)
                ch = security.grpc_auth_channel(
                    tls_mod.dial(
                        f"{ip}:{_grpc_port(int(http_port))}"), self.guard)
                self._channels[node_url] = ch
        return pb.volume_stub(ch)

    # ------------- admin lock (shell lock/unlock) -------------

    def admin_acquire(self, client: str) -> dict:
        """Acquire (or renew) the exclusive shell lease. Raises
        PermissionError naming the holder when another live lease
        exists. The lease lives in the leader's memory: a failover
        forgets it (the displaced holder's renewer sees the conflict
        within a third of the lease and its shell refuses further
        destructive commands)."""
        if not client:
            raise ValueError("admin lock needs a client name")
        with self._admin_mu:
            now = time.time()
            if (self._admin_holder
                    and self._admin_holder != client
                    and self._admin_expires > now):
                raise PermissionError(
                    f"cluster is locked by {self._admin_holder}")
            self._admin_holder = client
            self._admin_expires = now + self.admin_lease_seconds
            return {"holder": client,
                    "leaseSeconds": self.admin_lease_seconds}

    def admin_release(self, client: str) -> dict:
        with self._admin_mu:
            if self._admin_holder and self._admin_holder != client \
                    and self._admin_expires > time.time():
                raise PermissionError(
                    f"cluster is locked by {self._admin_holder}, "
                    f"not {client}")
            self._admin_holder = ""
            self._admin_expires = 0.0
            return {"released": True}

    def admin_holder(self) -> str:
        """The live lease's holder, or '' when none is live."""
        with self._admin_mu:
            return (self._admin_holder
                    if self._admin_expires > time.time() else "")

    # ------------- core ops -------------

    def grow_volume(self, collection: str = "",
                    replication: Optional[str] = None,
                    ttl: str = "") -> int:
        """Allocate one new volume on replica-placement-chosen nodes."""
        self._require_leader()
        replication = replication or self.default_replication
        # Growth is serialized END TO END under this lock: the id's
        # replication and the AllocateVolume rpcs must complete before
        # a second grow may observe topology, or two volumes could land
        # on one id.
        with self._grow_lock:
            targets = self.topology.pick_grow_targets(replication)
            vid = self.topology.next_volume_id()
            # Persist + replicate the consumed id BEFORE the volume goes
            # live: a leader crash right after allocation must not let
            # its successor reissue the same id (raft MaxVolumeId role).
            self.ha.replicate_now()
            for node in targets:
                self._volume_stub(node.url).AllocateVolume(
                    volume_server_pb2.AllocateVolumeRequest(
                        volume_id=vid, collection=collection,
                        replication=replication, ttl=ttl))
                # Optimistic registration so the volume is writable now;
                # the next heartbeat snapshot confirms it.
                self.topology.register_volume(node.url, VolumeInfo(
                    id=vid, collection=collection,
                    replica_placement=replication, ttl=ttl))
            glog.info("master: grew volume %d on %s", vid,
                      [n.url for n in targets])
            return vid

    def assign(self, count: int = 1, collection: str = "",
               replication: Optional[str] = None, ttl: str = "") -> dict:
        self._require_leader()
        replication = replication or self.default_replication
        self.metrics.counter("assign_requests").inc()
        for attempt in (0, 1):
            try:
                vid, nodes = self.topology.pick_for_write(
                    collection, replication, ttl)
                break
            except TopologyError:
                if attempt:
                    raise
                self.grow_volume(collection, replication, ttl)
        key = self.sequencer.next_batch(max(1, count))
        fid = str(FileId(volume_id=vid, key=key,
                         cookie=security.new_cookie()))
        node = nodes[0]
        return {"fid": fid, "url": node.url,
                "publicUrl": node.public_url or node.url,
                "count": max(1, count),
                "auth": self.guard.sign(fid)}

    def lookup(self, volume_id: int, collection: str = "") -> list[dict]:
        nodes = self.topology.lookup_volume(volume_id, collection)
        if not nodes:
            # EC volumes answer lookups too (any node with a shard),
            # with the shard list per node.
            by_shard = self.topology.lookup_ec_volume(volume_id)
            seen: dict[str, object] = {}
            shards: dict[str, list[int]] = {}
            for sid, node_list in sorted(by_shard.items()):
                for n in node_list:
                    seen[n.url] = n
                    shards.setdefault(n.url, []).append(sid)
            # EC holders are ranked but never excluded: every node may
            # hold shards that exist nowhere else, and a decode needs k
            # distinct shards more than it needs fast ones
            return [{"url": n.url,
                     "publicUrl": n.public_url or n.url,
                     "shards": shards[n.url]}
                    for n in self._rank_replicas(
                        list(seen.values()), volume_id,
                        exclude_unhealthy=False)]
        return [{"url": n.url, "publicUrl": n.public_url or n.url}
                for n in self._rank_replicas(nodes, volume_id)]

    def _rank_replicas(self, nodes: list, volume_id: int,
                       exclude_unhealthy: bool = True) -> list:
        """Telemetry-ranked read routing: healthy nodes first (then
        degraded, unhealthy last), and within a tier by health score
        plus a chunk-cache-warmth bonus for this volume — so clients
        that try locations in order hit the warm healthy replica and
        only fall through to a faulted node at the tail. With no
        telemetry ingested every node scores 100/healthy and the
        topology's deterministic order is preserved (the sort is
        stable).

        Unhealthy-verdict nodes are *excluded* (not just demoted)
        whenever at least one healthy/degraded replica exists —
        handing a client a location the telemetry plane already
        condemned only buys it a timeout before it falls through to
        the next one anyway. The floor: a fully-degraded volume still
        returns every location, because a slow answer beats none."""
        if len(nodes) < 2:
            return nodes
        tele = self.topology.telemetry
        pulse = self.topology.pulse_seconds
        tiers = {"healthy": 0, "degraded": 1, "unhealthy": 2}
        ranked = []
        for i, n in enumerate(nodes):
            h = tele.health(n.url, n.last_seen, pulse)
            warmth = tele.volume_row(n.url, volume_id).get(
                "cache_hit_ratio", 0.0)
            key = (tiers.get(h["verdict"], 2),
                   -(h["score"] + 25.0 * warmth), i)
            ranked.append((key, n))
        ranked.sort(key=lambda kn: kn[0])
        alive = sum(1 for key, _n in ranked if key[0] < 2)
        if exclude_unhealthy and 0 < alive < len(ranked):
            self.metrics.counter(
                "lookup_unhealthy_excluded_total").inc(
                    len(ranked) - alive)
            ranked = ranked[:alive]  # sort left unhealthy at the tail
        return [n for _key, n in ranked]

    # ------------- heartbeat ingestion -------------

    def ingest_heartbeat(self, hb) -> master_pb2.HeartbeatResponse:
        """One heartbeat through the full ingestion path. Its
        ``telemetry`` snapshot feeds the topology's registry, its
        ``usage`` snapshot replaces this node's row in :attr:`usage`,
        and its ``job_progress`` renews the leases of the tasks it
        names."""
        url = f"{hb.ip}:{hb.port}"
        volumes = [VolumeInfo(
            id=v.id, collection=v.collection, size=v.size,
            file_count=v.file_count, delete_count=v.delete_count,
            deleted_byte_count=v.deleted_byte_count,
            read_only=v.read_only,
            replica_placement=str(
                ReplicaPlacement.from_byte(v.replica_placement)),
            version=v.version or 3,
            ttl="" if not v.ttl else str(Ttl.from_bytes(
                v.ttl.to_bytes(2, "big"))),
            modified_at_second=v.modified_at_second,
        ) for v in hb.volumes]
        ec = [(s.collection, s.id, s.ec_index_bits)
              for s in hb.ec_shards]
        node = self.topology.register_heartbeat(
            url, public_url=hb.public_url,
            data_center=hb.data_center, rack=hb.rack,
            max_volume_count=hb.max_volume_count or 8,
            volumes=volumes, ec_shards=ec)
        if node.last_heartbeat_changed:
            with tracing.span("master.heartbeat.topology", node=url,
                              volumes=str(len(volumes))):
                glog.v(1, "master: heartbeat from %s changed topology "
                       "(%d volumes, %d ec entries)", url,
                       len(volumes), len(ec))
        if hb.HasField("telemetry"):
            self.topology.telemetry.ingest(url, hb.telemetry,
                                           metrics=self.metrics)
        if hb.HasField("usage"):
            self.usage.ingest_proto(url, hb.usage)
        if hb.HasField("job_progress"):
            # The heartbeat IS the lease renewal for every task the
            # worker still reports in flight.
            self.jobs.renew(url, hb.job_progress)
        if hb.max_file_key:
            self.sequencer.set_max(hb.max_file_key)
        return master_pb2.HeartbeatResponse(
            volume_size_limit=self.topology.volume_size_limit,
            leader=self.leader_url or self.url,
            metrics_address=self.metrics_address)


class _MasterServicer:
    """gRPC service impl bound via pb.generic_handler."""

    def __init__(self, ms: MasterServer):
        self.ms = ms

    def SendHeartbeat(self, request_iterator, context):
        for hb in request_iterator:
            yield self.ms.ingest_heartbeat(hb)

    def Assign(self, request, context):
        try:
            r = self.ms.assign(count=request.count or 1,
                               collection=request.collection,
                               replication=request.replication or None,
                               ttl=request.ttl)
        except (TopologyError, ValueError, NotLeaderError) as e:
            return master_pb2.AssignResponse(error=str(e))
        return master_pb2.AssignResponse(
            fid=r["fid"], url=r["url"], public_url=r["publicUrl"],
            count=r["count"], auth=r["auth"])

    def LookupVolume(self, request, context):
        resp = master_pb2.LookupVolumeResponse()
        # Volume servers heartbeat only the leader; a follower's cold
        # topology must not masquerade as "volume not found".
        not_leader = None if self.ms.is_leader else \
            NotLeaderError(self.ms.leader_url)
        for vid_str in request.volume_ids:
            entry = resp.volume_id_locations.add()
            entry.volume_id = vid_str
            if not_leader is not None:
                entry.error = str(not_leader)
                continue
            try:
                vid = int(vid_str.split(",")[0])
            except ValueError:
                entry.error = f"bad volume id {vid_str!r}"
                continue
            locs = self.ms.lookup(vid, request.collection)
            if not locs:
                entry.error = f"volume {vid} not found"
            for loc in locs:
                entry.locations.add(url=loc["url"],
                                    public_url=loc["publicUrl"],
                                    shards=loc.get("shards", ()))
        return resp

    def LookupEcVolume(self, request, context):
        # No per-entry error field here: raising surfaces as an RpcError
        # the client's failover loop rotates on.
        self.ms._require_leader()
        resp = master_pb2.LookupEcVolumeResponse(
            volume_id=request.volume_id)
        for sid, nodes in sorted(
                self.ms.topology.lookup_ec_volume(
                    request.volume_id).items()):
            entry = resp.shard_id_locations.add(shard_id=sid)
            for n in nodes:
                entry.locations.add(url=n.url,
                                    public_url=n.public_url or n.url)
        return resp

    def VolumeList(self, request, context):
        resp = master_pb2.VolumeListResponse(
            volume_size_limit_mb=self.ms.topology.volume_size_limit
            // (1024 * 1024))
        topo = resp.topology_info
        topo.id = "topo"
        # Each node's volumes are copied under the topology lock: JAX
        # walks the live dict, which a concurrent grow can resize.
        by_dc: dict[str, dict[str, list]] = {}
        for n, vols, ec in self.ms.topology.snapshot_holdings():
            by_dc.setdefault(n.data_center, {}).setdefault(
                n.rack, []).append((n, vols, ec))
        for dc, racks in sorted(by_dc.items()):
            dci = topo.data_center_infos.add(id=dc)
            for rack, nodes in sorted(racks.items()):
                ri = dci.rack_infos.add(id=rack)
                for n, vols, ec in nodes:
                    dni = ri.data_node_infos.add(
                        id=n.url, volume_count=len(vols),
                        max_volume_count=n.max_volume_count,
                        free_volume_count=n.free_slots,
                        active_volume_count=len(vols))
                    for v in vols:
                        dni.volume_infos.add(
                            id=v.id, size=v.size, collection=v.collection,
                            file_count=v.file_count,
                            delete_count=v.delete_count,
                            deleted_byte_count=v.deleted_byte_count,
                            read_only=v.read_only,
                            replica_placement=ReplicaPlacement.parse(
                                v.replica_placement).to_byte(),
                            version=v.version,
                            ttl=int.from_bytes(
                                Ttl.parse(v.ttl or "").to_bytes(), "big"),
                            modified_at_second=v.modified_at_second)
                    for (col, vid), bits in ec:
                        dni.ec_shard_infos.add(
                            id=vid, collection=col, ec_index_bits=bits.bits)
        return resp

    def GetMasterConfiguration(self, request, context):
        return master_pb2.GetMasterConfigurationResponse(
            volume_size_limit=self.ms.topology.volume_size_limit,
            jwt_enabled=self.ms.guard.enabled,
            metrics_address=self.ms.metrics_address,
            metrics_interval_seconds=max(1, round(
                self.ms.metrics_interval_seconds))
            if self.ms.metrics_address else 0)


def _make_http_handler(ms: MasterServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through glog
            glog.v(2, "master http: " + fmt, *args)

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode())

        def _text(self, body: bytes, code: int = 200) -> None:
            self._send(code, body, "text/plain; charset=utf-8")

        def _proxy_to_leader(self) -> bool:
            """Forward this request to the current leader (follower
            masters stay useful to plain HTTP clients), preserving the
            method and body. Returns True if proxied; False when this
            master IS the leader or none is known."""
            leader = ms.leader_url
            if ms.is_leader or not leader or leader == ms.url:
                return False
            try:
                data = None
                if self.command == "POST":
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    data = self.rfile.read(n) if n else b""
                # No breaker: the "endpoint" is whoever holds the lease
                # right now, and a 503 here is already the retry signal.
                r = retry.http_request(
                    f"http://{leader}{self.path}", data=data,
                    method=self.command, point="master.proxy",
                    timeout=10, use_breaker=False)
                self._send(r.status, r.data)
            except urllib.error.HTTPError as e:
                self._send(e.code, e.read())
            except Exception as e:  # noqa: BLE001
                self._json({"error": f"leader {leader} unreachable: {e}"},
                           503)
            return True

        def do_GET(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                if u.path == "/dir/assign":
                    if self._proxy_to_leader():
                        return
                    self._json(ms.assign(
                        count=int(q.get("count", 1)),
                        collection=q.get("collection", ""),
                        replication=q.get("replication") or None,
                        ttl=q.get("ttl", "")))
                elif u.path == "/dir/lookup":
                    # A follower's topology is cold — answer from the
                    # leader's; mid-election (no leader known) a 503
                    # retry signal, never a false 404.
                    if self._proxy_to_leader():
                        return
                    ms._require_leader()
                    vid = int(str(q.get("volumeId", "0")).split(",")[0])
                    locs = ms.lookup(vid, q.get("collection", ""))
                    if not locs:
                        self._json({"volumeId": str(vid),
                                    "error": "volume not found"}, 404)
                    else:
                        self._json({"volumeId": str(vid),
                                    "locations": locs})
                elif u.path in ("/cluster/status", "/dir/status"):
                    self._json({"IsLeader": ms.is_leader,
                                "Leader": ms.leader_url or ms.url,
                                "Peers": ms.ha.peers,
                                "Term": ms.ha.term,
                                "AdminLockHolder": ms.admin_holder(),
                                "Topology": ms.topology.to_map()})
                elif u.path == "/metrics":
                    self._send(200, (ms.metrics.render()
                                     + ms.slo.metrics.render()
                                     + ms.usage.metrics.render()
                                     + ms.jobs.metrics.render()
                                     + tracing.METRICS.render()
                                     + retry.METRICS.render()
                                     + httpserver.METRICS.render()
                                     ).encode(), EXPOSITION_CONTENT_TYPE)
                elif u.path == "/cluster/telemetry":
                    # Volume servers heartbeat only the leader, so a
                    # follower's registry is cold — answer from the
                    # leader's.
                    if self._proxy_to_leader():
                        return
                    last_seen = {n.url: n.last_seen
                                 for n in ms.topology.snapshot_nodes()}
                    # Default cap keeps the per-volume section top-N by
                    # read rate; ?limit=0 restores the unbounded body.
                    self._json(ms.topology.telemetry.to_map(
                        nodes_last_seen=last_seen,
                        pulse_seconds=ms.topology.pulse_seconds,
                        limit=int(q.get("limit", 512)) or None))
                elif u.path == "/cluster/usage":
                    # Usage lands on the leader (heartbeats + gateway
                    # pushes go there), so read from there.
                    if self._proxy_to_leader():
                        return
                    self._json(ms.usage.to_map(
                        limit=int(q.get("limit", 256)) or None))
                elif u.path == "/cluster/topk":
                    if self._proxy_to_leader():
                        return
                    self._json(ms.usage.topk_map(
                        int(q.get("n", 32))))
                elif u.path == "/cluster/jobs":
                    # Jobs live on the leader (claims/completions and
                    # heartbeat renewals land there), so read there.
                    if self._proxy_to_leader():
                        return
                    doc = ms.jobs.to_map(
                        with_tasks=q.get("tasks", "1") != "0",
                        limit=int(q.get("limit", 1000)) or None)
                    doc["policy"] = ms.policy.payload()
                    self._json(doc)
                elif u.path == "/cluster/scrub":
                    # Scrub-plane view: the scrub jobs (a filtered
                    # /cluster/jobs) plus the candidate volume count.
                    if self._proxy_to_leader():
                        return
                    doc = ms.jobs.to_map(
                        with_tasks=q.get("tasks", "1") != "0",
                        limit=int(q.get("limit", 1000)) or None)
                    self._json({
                        "enabled": doc["enabled"],
                        "jobs": [j for j in doc["jobs"]
                                 if j["kind"] == "scrub"],
                        "candidates": len(ms.job_candidate_volumes(
                            "scrub", q.get("collection", "")))})
                elif u.path == "/cluster/traces":
                    # Tail-sampled traces land on the leader (that is
                    # where servers push), so read from there.
                    if self._proxy_to_leader():
                        return
                    self._json(ms.trace_collector.payload(
                        int(q["limit"]) if q.get("limit") else None))
                elif u.path == "/cluster/slo":
                    if self._proxy_to_leader():
                        return
                    # Evaluate on demand: the tick is idempotent and
                    # this keeps curl output fresh even with a long
                    # background interval.
                    self._json(ms.slo.evaluate())
                elif u.path == "/cluster/profile":
                    # Master-side proxy to any node's /debug/profile so
                    # operators profile the fleet from one place.
                    node = q.get("node", "")
                    if not node:
                        self._json(
                            {"error": "node query parameter required"},
                            400)
                        return
                    seconds = min(float(q.get("seconds", 2.0)),
                                  profiler.MAX_SECONDS)
                    try:
                        r = retry.http_request(
                            f"http://{node}/debug/profile"
                            f"?seconds={seconds}",
                            point="master.profile_proxy",
                            timeout=seconds + 30.0, use_breaker=False)
                    except Exception as e:  # noqa: BLE001
                        self._json({"error":
                                    f"node {node} unreachable: {e}"},
                                   502)
                        return
                    self._text(r.data)
                elif u.path == "/debug/profile":
                    self._text(profiler.profile(
                        float(q.get("seconds", 2.0)),
                        hz=float(q.get("hz",
                                       profiler.DEFAULT_BURST_HZ))
                    ).encode())
                elif u.path == "/debug/traces":
                    self._json(tracing.debug_payload(
                        int(q.get("limit", -1))
                        if q.get("limit") else None))
                elif u.path == "/debug/vars":
                    self._json(varz.payload(
                        "master", ms.metrics,
                        extra={"is_leader": ms.is_leader,
                               "nodes": len(ms.topology.nodes),
                               "slo_state": ms.slo.worst_state(),
                               "slo_alerts": list(ms.slo.alerts),
                               "jobs": ms.jobs.summary(),
                               "cache_hub": ms.cache_hub.to_map(),
                               "trace_collector":
                                   ms.trace_collector.payload(0)}))
                else:
                    self._json({"error": "not found"}, 404)
            except NotLeaderError as e:
                self._json({"error": str(e), "leader": e.leader}, 503)
            except (TopologyError, ValueError) as e:
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if u.path in ("/raft/vote", "/raft/heartbeat"):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if u.path == "/raft/vote":
                        self._json(ms.ha.handle_vote(req))
                    else:
                        self._json(ms.ha.handle_heartbeat(req))
                except (ValueError, OSError) as e:
                    self._json({"error": str(e)}, 400)
            elif u.path in ("/admin/lock", "/admin/unlock"):
                if self._proxy_to_leader():
                    return
                try:
                    client = q.get("client", "")
                    if u.path == "/admin/lock":
                        self._json(ms.admin_acquire(client))
                    else:
                        self._json(ms.admin_release(client))
                except PermissionError as e:
                    self._json({"error": str(e)}, 409)
                except ValueError as e:
                    self._json({"error": str(e)}, 400)
            elif u.path == "/cluster/cache_subscribe":
                # Gateways (filer chunk caches) register here for
                # job-commit invalidation fan-out; re-subscribing
                # refreshes the entry, so a periodic loop survives
                # leader changes.
                if self._proxy_to_leader():
                    return
                url = q.get("url", "")
                if not url:
                    self._json({"error": "url query parameter "
                                "required"}, 400)
                else:
                    ms.cache_hub.subscribe(url)
                    self._json({"ok": True,
                                "subscribers":
                                    len(ms.cache_hub.to_map())})
            elif u.path == "/cluster/traces":
                # Tail-sample sink: servers push slow/errored root
                # bundles here (tracing._push_loop).
                if self._proxy_to_leader():
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    ms.trace_collector.ingest(payload)
                    self._json({"ok": True})
                except (ValueError, OSError) as e:
                    self._json({"error": str(e)}, 400)
            elif u.path == "/cluster/usage":
                # Accounting sink for ingresses that do not heartbeat
                # (S3/filer push their cumulative snapshots here;
                # usage.UsagePusher).
                if self._proxy_to_leader():
                    return
                try:
                    payload = self._body()
                    source = str(payload.get("source", "") or
                                 self.client_address[0])
                    ms.usage.ingest(source, payload)
                    self._json({"ok": True})
                except (ValueError, OSError) as e:
                    self._json({"error": str(e)}, 400)
            elif u.path == "/vol/grow":
                if self._proxy_to_leader():
                    return
                try:
                    n = int(q.get("count", 1))
                    vids = [ms.grow_volume(
                        q.get("collection", ""),
                        q.get("replication") or None,
                        q.get("ttl", "")) for _ in range(n)]
                    self._json({"count": len(vids), "volumeIds": vids})
                except NotLeaderError as e:
                    self._json({"error": str(e), "leader": e.leader}, 503)
                except (TopologyError, ValueError) as e:
                    self._json({"error": str(e)}, 500)
            elif u.path.startswith("/cluster/jobs/"):
                # Maintenance-job control plane: all writes go to the
                # leader (whose JobManager owns the work-lists).
                if self._proxy_to_leader():
                    return
                try:
                    self._jobs_action(u.path[len("/cluster/jobs/"):], q)
                except KeyError as e:
                    self._json({"error": str(e.args[0])}, 404)
                except (ValueError, OSError) as e:
                    self._json({"error": str(e)}, 400)
            elif u.path == "/cluster/scrub":
                # Convenience submit: a scrub job over the named
                # volumes (or every plain + EC volume of the
                # collection when none are named).
                if self._proxy_to_leader():
                    return
                try:
                    body = self._body()
                    col = str(body.get("collection", ""))
                    vids = body.get("volumes") or \
                        ms.job_candidate_volumes("scrub", col)
                    params = dict(body.get("params") or {})
                    if body.get("rate_bytes_per_second") is not None:
                        params["rate_bytes_per_second"] = int(
                            body["rate_bytes_per_second"])
                    self._json({"job": ms.jobs.submit(
                        "scrub", vids, collection=col, params=params,
                        parallel=int(body.get("parallel", 0)),
                        submitted_by=str(
                            body.get("submittedBy", "http")))})
                except (ValueError, OSError) as e:
                    self._json({"error": str(e)}, 400)
            else:
                self.do_GET()

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0) or 0)
            return json.loads(self.rfile.read(n) or b"{}")

        def _jobs_action(self, action: str, q: dict) -> None:
            body = self._body()
            if action == "submit":
                kind = str(body.get("kind", ""))
                vids = body.get("volumes") or []
                if not vids:
                    vids = ms.job_candidate_volumes(
                        kind, str(body.get("collection", "")))
                self._json({"job": ms.jobs.submit(
                    kind, vids,
                    collection=str(body.get("collection", "")),
                    params=body.get("params") or {},
                    parallel=int(body.get("parallel", 0)),
                    submitted_by=str(body.get("submittedBy", "http")))})
            elif action == "claim":
                self._json({"task": ms.jobs.claim(q.get("worker", ""))})
            elif action == "complete":
                self._json(ms.jobs.complete(
                    str(body.get("worker", "")),
                    str(body.get("taskId", "")),
                    bool(body.get("ok")), str(body.get("error", ""))))
            elif action in ("pause", "resume", "cancel"):
                job_id = q.get("job", "") or str(body.get("jobId", ""))
                self._json({"job": getattr(ms.jobs, action)(job_id)})
            else:
                self._json({"error": "not found"}, 404)

    return tracing.instrument_http_handler(
        httpserver.admission_gate(Handler), "master")


def apply_config(conf: dict) -> str:
    """Apply a loaded ``-config`` TOML's process-wide settings: the JWT
    signing key (returned), ``[grpc.tls]``, ``[tracing]``, ``[retry]``,
    ``[faults]``, ``[profiler]``, ``[usage]``, ``[ingress]`` and the
    ``[jobs]`` kill switch, and starts the always-on profiler when
    ``[profiler]`` leaves it enabled. ``[slo]`` and ``[jobs]``'s policy
    keys are checked here (a bad value raises ``ValueError`` before
    anything is applied); :func:`configure_master` applies them, and the
    rest of ``[jobs]``, to a master."""
    from ..util import config as config_mod
    from ..util import faults

    _slo_and_policy(conf, SloEngine(ClusterTelemetry()),
                    jobs_mod.PolicyEngine())
    secret = config_mod.lookup(conf, "jwt.signing.key", "")
    tls_mod.install_from_config(conf)
    tracing.configure_from(conf)
    retry.configure_from(conf)
    faults.configure_from(conf)
    profiler.configure_from(conf)
    usage_mod.configure_from(conf)
    httpserver.configure_from(conf)
    jobs_mod.configure_from(conf)
    profiler.ensure_started()
    return secret


def _slo_and_policy(conf: dict, slo: SloEngine,
                    policy: jobs_mod.PolicyEngine) -> None:
    from ..util import config as config_mod

    if config_mod.lookup(conf, "slo") is not None:
        slo.configure(conf)
    jsec = config_mod.lookup(conf, "jobs")
    if jsec is not None:
        policy.configure(jsec)


def configure_master(ms: MasterServer, conf: dict) -> None:
    """Apply ``[slo]``, ``[jobs] lease_seconds`` and ``max_attempts``
    and ``[jobs]``'s policy keys to ``ms``'s SLO engine, JobManager and
    policy engine (the JAX master's ``main`` does the same)."""
    from ..util import config as config_mod

    jsec = config_mod.lookup(conf, "jobs")
    if isinstance(jsec, dict):
        ms.jobs.lease_seconds = float(
            jsec.get("lease_seconds", ms.jobs.lease_seconds))
        ms.jobs.max_attempts = int(
            jsec.get("max_attempts", ms.jobs.max_attempts))
    _slo_and_policy(conf, ms.slo, ms.policy)


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m seaweedfs_tpu_torch master`` (weed/command/master.go).

    Serves until SIGINT or SIGTERM, then stops cleanly. Exit 2: a bad
    flag or ``-config`` (one ``error:`` line)."""
    import argparse
    import signal
    import sys

    from ..util import config as config_mod

    p = argparse.ArgumentParser(prog="master", allow_abbrev=False)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-pulseSeconds", type=float, default=5.0)
    p.add_argument("-metricsAddress", default="",
                   help="Prometheus push-gateway host:port")
    p.add_argument("-metricsIntervalSeconds", type=float, default=15.0)
    p.add_argument("-peers", default="",
                   help="comma-separated master urls for HA election")
    p.add_argument("-mdir", default="",
                   help="meta dir persisting raft state + sequence")
    p.add_argument("-config", default="",
                   help="TOML: the JWT signing key, [grpc.tls], "
                        "[tracing], [retry], [faults], [profiler], "
                        "[usage], [slo], [ingress], [jobs]")
    args = p.parse_args(argv)
    try:
        conf = config_mod.load(args.config) if args.config else {}
        secret = apply_config(conf)
    except (OSError, TypeError, ValueError) as e:
        print(f"error: -config {args.config}: {e}", file=sys.stderr)
        return 2
    ms = MasterServer(ip=args.ip, port=args.port,
                      volume_size_limit_mb=args.volumeSizeLimitMB,
                      default_replication=args.defaultReplication,
                      pulse_seconds=args.pulseSeconds, secret=secret,
                      peers=[x for x in args.peers.split(",") if x],
                      meta_dir=args.mdir or None,
                      metrics_address=args.metricsAddress,
                      metrics_interval_seconds=args.metricsIntervalSeconds,
                      trace_ring_size=int(config_mod.lookup(
                          conf, "tracing.collector_ring_size", 256)))
    configure_master(ms, conf)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    ms.start()
    try:
        stop.wait()
    finally:
        ms.stop()
    return 0
