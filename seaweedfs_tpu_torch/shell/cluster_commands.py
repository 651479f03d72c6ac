"""Cluster-mode shell commands: choreography over master + volume gRPC.

The port of ``seaweedfs_tpu/shell/cluster_commands.py``'s EC core.
Mirrors weed/shell's cluster commands (SURVEY.md §2 "Shell", §3.1/§3.5):
where the offline commands in commands.py operate on a Store's
directories, these drive a live cluster the way the reference does —
look state up from the master, then sequence VolumeMarkReadonly /
VolumeEcShardsGenerate / Copy / Mount / Delete rpcs across volume
servers. The EC work itself runs inside the volume servers, on each
server's device. Shares the registry protocol with commands.py: each
command is ``fn(env: ClusterEnv, argv)``.

Ported: ``ec.encode`` (with ``-distributed -parallel -mesh``, a leased
sweep on the master's jobs plane), ``ec.rebuild``, ``ec.decode``,
``ec.balance``, ``volume.list``, ``volume.vacuum``, ``volume.grow``,
``volume.move``, ``volume.balance``, ``volume.fix.replication``,
``volume.mark``, ``volume.deleteEmpty``, ``volumeServer.evacuate``,
``volume.check.disk``, ``volume.unmount``, ``volume.mount``,
``volume.configure.replication``, ``volume.fsck`` (against the filer of
``-filer``), ``collection.list``, ``collection.delete``,
``cluster.status``, ``cluster.check`` (with the telemetry and SLO
verdicts), ``lock``, ``unlock``, ``job.submit``, ``job.status``,
``job.pause``, ``job.resume``, ``job.cancel``, ``scrub.start``,
``scrub.status``, ``volume.tier.upload``, ``volume.tier.download``,
``trace.status``, ``trace.dump``, ``trace.top``, ``ingress.status``,
``telemetry.status``, ``volume.heatmap``, ``traffic.top`` and
``tenant.usage``; ``fs.*`` and the S3 gateway's ``s3.*`` live in
``fs_commands.py``.

Unlike the JAX cluster shell, every command runs under a
``shell.<name>`` trace root, so the servers' gRPC and HTTP legs of one
command (``ec.rebuild``'s shard copies and rebuild, say) stitch under
it at the master.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shlex
import socket
import sys
import threading
import time
import urllib.error
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import pb
from ..pb import master_pb2, volume_server_pb2
from ..storage.ec_files import ShardBits
from ..util import retry, security, tracing
from ..util import tls as tls_mod
from .commands import ShellError, _parser


@dataclass
class EcNode:
    """One data node's view for EC planning (shell's ecNode struct)."""
    url: str
    data_center: str
    rack: str
    free_slots: int
    shards: dict[int, list[int]]  # vid -> shard ids here
    collections: dict[int, str] = field(default_factory=dict)  # vid -> col

    def shard_count(self) -> int:
        return sum(len(s) for s in self.shards.values())


@dataclass
class ClusterEnv:
    """Dial info + cached stubs for one cluster (CommandEnv in shell/)."""

    master_url: str
    filer_url: Optional[str] = None
    #: Shared cluster signing key (security.toml jwt.signing.key); when
    #: set, volume-server rpcs carry the cluster bearer token.
    secret: str = ""
    out: io.TextIOBase = None  # type: ignore[assignment]
    _channels: dict = field(default_factory=dict)
    _filer_client: object = None
    #: True while this shell holds the master's exclusive admin lease.
    locked: bool = False
    _lock_client: str = ""
    _lease_lost: bool = False
    _renew_stop: object = None
    _renew_thread: object = None

    def __post_init__(self):
        if self.out is None:
            self.out = sys.stdout

    def println(self, *args) -> None:
        print(*args, file=self.out)

    def filer_client(self):
        """Lazy FilerClient for fs.* commands; None without -filer."""
        if self.filer_url and self._filer_client is None:
            from ..cluster.filer_client import FilerClient
            self._filer_client = FilerClient(self.filer_url)
        return self._filer_client

    def close(self) -> None:
        if self.locked:
            try:
                self.admin_unlock()
            except ShellError:
                pass
        for ch in self._channels.values():
            ch.close()
        self._channels.clear()
        if self._filer_client is not None:
            self._filer_client.close()
            self._filer_client = None

    # -- stubs --

    def _channel(self, url: str, grpc_offset: int = 10000):
        ch = self._channels.get(url)
        if ch is None:
            ip, port = url.rsplit(":", 1)
            ch = tls_mod.dial(f"{ip}:{int(port) + grpc_offset}")
            if self.secret:
                ch = security.grpc_auth_channel(
                    ch, security.Guard(self.secret))
            self._channels[url] = ch
        return ch

    def master(self):
        return pb.master_stub(self._channel(self.master_url))

    def volume(self, url: str):
        return pb.volume_stub(self._channel(url))

    # -- cluster state --

    def volume_list(self) -> master_pb2.VolumeListResponse:
        return self.master().VolumeList(master_pb2.VolumeListRequest())

    def collect_ec_nodes(self) -> list[EcNode]:
        resp = self.volume_list()
        nodes = []
        for dc in resp.topology_info.data_center_infos:
            for rack in dc.rack_infos:
                for dn in rack.data_node_infos:
                    shards: dict[int, list[int]] = {}
                    cols: dict[int, str] = {}
                    for s in dn.ec_shard_infos:
                        shards[s.id] = ShardBits(s.ec_index_bits).ids()
                        cols[s.id] = s.collection
                    nodes.append(EcNode(
                        url=dn.id, data_center=dc.id, rack=rack.id,
                        free_slots=dn.free_volume_count, shards=shards,
                        collections=cols))
        return nodes

    def volume_locations(self, vid: int) -> list[str]:
        resp = self.master().LookupVolume(
            master_pb2.LookupVolumeRequest(volume_ids=[str(vid)]))
        for e in resp.volume_id_locations:
            if e.error:
                raise ShellError(e.error)
            return [loc.url for loc in e.locations]
        return []

    # -- master HTTP plumbing --

    def _master_http(self, path_q: str, method: str = "GET",
                     host: str = "", body: Optional[dict] = None,
                     once: bool = False, timeout: float = 30) -> dict:
        """One JSON request against a master's HTTP plane with the
        error mapping every caller needs (HTTPError body -> message,
        connection failure -> ShellError naming the master). ``once``:
        a single attempt, for a request that must not be repeated."""
        host = host or self.master_url
        try:
            resp = retry.http_request(
                f"http://{host}{path_q}", method=method,
                data=None if body is None else json.dumps(body).encode(),
                point="master.rpc", timeout=timeout,
                retry_policy=retry.RetryPolicy(max_attempts=1)
                if once else None)
            return json.loads(resp.data or b"{}")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise ShellError(msg) from None
        except urllib.error.URLError as e:
            # connection-level failure must surface as the same error
            # type or close()/finally cleanup paths leak past it
            raise ShellError(
                f"master {host} unreachable: {e}") from None

    # -- exclusive admin lease (shell lock/unlock) --

    def _admin_call(self, verb: str) -> dict:
        return self._master_http(
            f"/admin/{verb}?client={self._lock_client}", method="POST")

    def _start_renewer(self, lease: float) -> None:
        """Renew at a third of the lease period; a failed renew
        immediately retries an acquire (a merely-expired free lease is
        recovered silently) and otherwise marks the lease LOST so the
        next destructive command refuses instead of running unlocked."""
        self._lease_lost = False
        self._renew_stop = threading.Event()

        def renew():
            expires = time.monotonic() + lease
            wait = max(0.5, lease / 3)
            while not self._renew_stop.wait(wait):
                try:
                    self._admin_call("lock")
                    expires = time.monotonic() + lease
                    wait = max(0.5, lease / 3)
                except ShellError as e:
                    # a CONFLICT means the lease is genuinely gone; a
                    # transient master hiccup is retried (faster) for
                    # as long as the server-side lease can still be
                    # live — only past expiry is it truly lost
                    if "locked by" in str(e) or \
                            time.monotonic() >= expires:
                        self._lease_lost = True
                        return
                    wait = max(0.5, lease / 6)

        self._renew_thread = threading.Thread(
            target=renew, daemon=True, name="shell-admin-lease")
        self._renew_thread.start()

    def _stop_renewer(self) -> None:
        if self._renew_stop is not None:
            self._renew_stop.set()
            self._renew_thread.join(timeout=2)
            self._renew_stop = self._renew_thread = None

    def admin_lock(self) -> None:
        """Hold the master's exclusive lease until admin_unlock (the
        REPL `lock` command), renewed in the background so a crashed
        shell frees the cluster after one lease period."""
        if self.locked:
            return
        if not self._lock_client:
            self._lock_client = _lock_client_name()
        lease = float(self._admin_call("lock").get("leaseSeconds", 30))
        self.locked = True
        self._start_renewer(lease)

    def admin_unlock(self) -> None:
        if not self.locked:
            return
        self._stop_renewer()
        self.locked = False
        self._admin_call("unlock")

    def exclusive(self):
        """Context for one destructive command. A held REPL lock passes
        through (unless its lease was lost — then refuse loudly); a
        one-shot acquires ephemerally WITH renewal, so commands longer
        than one lease period keep their exclusivity."""

        @contextlib.contextmanager
        def cm():
            if self.locked:
                if self._lease_lost:
                    self.locked = False
                    raise ShellError(
                        "admin lease was lost (expired or taken while "
                        "this shell was stalled); run 'lock' again "
                        "before destructive commands")
                yield
                if self._lease_lost:
                    self.locked = False
                    raise ShellError(
                        "admin lease was lost mid-command; cluster "
                        "state may have been mutated concurrently — "
                        "re-check before retrying (then 'lock' again)")
                return
            if not self._lock_client:
                self._lock_client = _lock_client_name()
            lease = float(
                self._admin_call("lock").get("leaseSeconds", 30))
            self._start_renewer(lease)
            try:
                yield
                if self._lease_lost:
                    raise ShellError(
                        "admin lease was lost mid-command; cluster "
                        "state may have been mutated concurrently — "
                        "re-check before retrying")
            finally:
                self._stop_renewer()
                try:
                    self._admin_call("unlock")
                except ShellError:
                    pass
        return cm()


def _lock_client_name() -> str:
    """Distinct per shell instance: two shells in one process (or one
    host) must contend, not alias each other's lease."""
    return f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"


def _http_delete_needle(env: "ClusterEnv", url: str, vid: int,
                        col: str, key: int) -> None:
    """Tombstone one needle via a server's HTTP DELETE (which fans out
    to its replica peers): cookie recovered over ReadNeedleBlob, write
    JWT minted from the shell secret. Shared by fsck -purge and
    check.disk -resolveDeletes so the auth/URL shape lives once.
    Raises on failure — note the contacted server may have applied
    the tombstone even when its replica fan-out then failed."""
    from ..pb import volume_server_pb2 as vpb
    from ..storage import needle as needle_mod
    from ..storage.types import FileId

    blob = env.volume(url).ReadNeedleBlob(
        vpb.ReadNeedleBlobRequest(volume_id=vid, collection=col,
                                  needle_id=key))
    cookie = needle_mod.parse_header(blob.needle_blob)[0]
    fid = str(FileId(volume_id=vid, key=key, cookie=cookie))
    guard = security.Guard(env.secret)
    retry.http_request(
        f"http://{url}/{fid}" + (f"?collection={col}" if col else ""),
        method="DELETE", point="volume.delete",
        jwt=guard.sign(fid) if guard.enabled else "", timeout=60)


CLUSTER_COMMANDS: dict[str, Callable[[ClusterEnv, list[str]], None]] = {}

#: Commands that mutate cluster state and therefore run under the
#: master's exclusive admin lease (a one-shot invocation acquires the
#: lease around the single command, a REPL `lock` holds it across
#: commands). The set is the JAX shell's, names of commands not ported
#: yet included.
DESTRUCTIVE_COMMANDS = {
    "ec.encode", "ec.decode", "ec.rebuild", "ec.balance",
    "volume.move", "volume.balance", "volume.fix.replication",
    "volume.vacuum", "volume.deleteEmpty", "volume.mark",
    "volumeServer.evacuate", "collection.delete", "volume.grow",
    "volume.tier.upload", "volume.tier.download", "volume.check.disk",
    "s3.configure", "fs.configure", "s3.clean.uploads", "volume.fsck",
    "volume.mount", "volume.unmount",
    "volume.configure.replication",
    "job.submit", "job.cancel", "scrub.start",
}


def cluster_command(name: str):
    def register(fn):
        CLUSTER_COMMANDS[name] = fn
        return fn
    return register


def _spread_targets(nodes: list[EcNode], total: int) -> list[EcNode]:
    """Rack-aware round-robin over least-loaded nodes (the spread step of
    command_ec_encode.go)."""
    if not nodes:
        raise ShellError("no data nodes in topology")
    by_rack: dict[tuple[str, str], list[EcNode]] = {}
    for n in sorted(nodes, key=lambda n: n.shard_count()):
        by_rack.setdefault((n.data_center, n.rack), []).append(n)
    racks = sorted(by_rack.values(),
                   key=lambda ns: sum(n.shard_count() for n in ns))
    out: list[EcNode] = []
    i = 0
    while len(out) < total:
        rack = racks[i % len(racks)]
        out.append(rack[(i // len(racks)) % len(rack)])
        i += 1
    return out


@cluster_command("ec.encode")
def cmd_ec_encode(env: ClusterEnv, argv: list[str]) -> None:
    """Full §3.1 choreography: mark readonly -> generate on the owning
    server -> spread shards rack-aware (copy+mount, delete moved) ->
    delete the source volume. With ``-distributed`` the shell only
    submits a JobManager sweep — every volume server encodes its own
    volumes in parallel under leases, on its own device — and waits."""
    p = _parser("ec.encode")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-dataShards", type=int, default=0)
    p.add_argument("-parityShards", type=int, default=0)
    p.add_argument("-distributed", action="store_true",
                   help="run as a leased job sweep on the workers")
    p.add_argument("-parallel", type=int, default=0,
                   help="with -distributed: max concurrent tasks")
    p.add_argument("-mesh", default="",
                   help="with -distributed: each worker encodes its "
                        "volumes on a dp,sp device mesh (or 'auto'); "
                        "dp*sp must equal the worker's device count")
    args = p.parse_args(argv)
    vid, col = args.volumeId, args.collection
    if args.mesh and not args.distributed:
        raise ShellError(
            "ec.encode: -mesh composes with -distributed (the mesh "
            "lives on the worker running the encode; the plain cluster "
            "path generates shards over gRPC)")
    if args.distributed:
        params = {}
        if args.dataShards and args.parityShards:
            params = {"data_shards": args.dataShards,
                      "parity_shards": args.parityShards}
        if args.mesh:
            # syntax check here (cheap, fail fast); the device-count
            # validation happens on the claiming worker, whose device
            # inventory is what the spec must tile
            from ..parallel import mesh as mesh_mod
            try:
                mesh_mod.parse_spec(args.mesh)
            except mesh_mod.MeshConfigError as e:
                raise ShellError(str(e)) from e
            params["mesh"] = args.mesh
        doc = env._master_http(
            "/cluster/jobs/submit", method="POST",
            body={"kind": "ec_encode", "collection": col,
                  "volumes": [vid] if vid else [],
                  "params": params, "parallel": args.parallel,
                  "submittedBy": "shell"})
        job = doc["job"]
        env.println(f"job {job['jobId']}: distributed ec.encode over "
                    f"{job['total']} volume(s)")
        job = _wait_for_job(env, job["jobId"])
        if job["state"] != "done":
            raise ShellError(f"job {job['jobId']} {job['state']}")
        return
    if not vid:
        raise ShellError("ec.encode: -volumeId required "
                         "(or use -distributed)")

    locs = env.volume_locations(vid)
    if not locs:
        raise ShellError(f"volume {vid} not found")
    source = locs[0]
    src = env.volume(source)
    src.VolumeMarkReadonly(volume_server_pb2.VolumeMarkReadonlyRequest(
        volume_id=vid, collection=col))
    src.VolumeEcShardsGenerate(
        volume_server_pb2.VolumeEcShardsGenerateRequest(
            volume_id=vid, collection=col,
            data_shards=args.dataShards,
            parity_shards=args.parityShards))
    total = ((args.dataShards + args.parityShards)
             if args.dataShards and args.parityShards else 14)
    src.VolumeEcShardsMount(volume_server_pb2.VolumeEcShardsMountRequest(
        volume_id=vid, collection=col, shard_ids=list(range(total))))

    targets = _spread_targets(env.collect_ec_nodes(), total)
    per_target: dict[str, list[int]] = {}
    for sid, node in enumerate(targets):
        per_target.setdefault(node.url, []).append(sid)
    for url, sids in per_target.items():
        if url == source:
            continue
        tgt = env.volume(url)
        tgt.VolumeEcShardsCopy(volume_server_pb2.VolumeEcShardsCopyRequest(
            volume_id=vid, collection=col, shard_ids=sids,
            copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
            source_data_node=source))
        tgt.VolumeEcShardsMount(
            volume_server_pb2.VolumeEcShardsMountRequest(
                volume_id=vid, collection=col, shard_ids=sids))
        src.VolumeEcShardsDelete(
            volume_server_pb2.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=col, shard_ids=sids))
    # Every replica of the now-sealed volume is dropped (the EC copy is
    # authoritative from here on).
    for url in locs:
        env.volume(url).VolumeDelete(
            volume_server_pb2.VolumeDeleteRequest(volume_id=vid,
                                                  collection=col))
    env.println(f"ec.encode volume {vid}: {total} shards over "
                f"{len(per_target)} servers")


@cluster_command("ec.rebuild")
def cmd_ec_rebuild(env: ClusterEnv, argv: list[str]) -> None:
    """§3.5: for every EC volume with missing shards, pick a rebuilder
    holding the most shards and run VolumeEcShardsRebuild there."""
    p = _parser("ec.rebuild")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)
    nodes = env.collect_ec_nodes()
    # vid -> {shard ids present anywhere}; the collection comes from
    # the heartbeat-reported shard info, NOT from the flag, so the RPC
    # always names the volume's real collection.
    present: dict[int, set[int]] = {}
    holders: dict[int, list[EcNode]] = {}
    col_of: dict[int, str] = {}
    for n in nodes:
        for vid, sids in n.shards.items():
            present.setdefault(vid, set()).update(sids)
            holders.setdefault(vid, []).append(n)
            col_of.setdefault(vid, n.collections.get(vid, ""))
    todo = [args.volumeId] if args.volumeId else sorted(present)
    failures = 0
    for vid in todo:
        if not present.get(vid):
            env.println(f"ec.rebuild volume {vid}: no shards anywhere")
            continue
        col = col_of.get(vid, "")
        if args.collection and col != args.collection:
            continue
        # The geometry (k+m) lives in the .vif next to the shards, so
        # the rebuilder server is authoritative about which shards are
        # missing — never guess totals from shard ids here.
        rebuilder = max(holders[vid],
                        key=lambda n: len(n.shards.get(vid, [])))
        try:
            resp = env.volume(rebuilder.url).VolumeEcShardsRebuild(
                volume_server_pb2.VolumeEcShardsRebuildRequest(
                    volume_id=vid, collection=col))
        except Exception as e:
            # One broken volume must not abort the whole sweep.
            env.println(f"ec.rebuild volume {vid}: failed on "
                        f"{rebuilder.url}: {e}")
            failures += 1
            continue
        if resp.rebuilt_shard_ids:
            env.println(f"ec.rebuild volume {vid}: rebuilt "
                        f"{list(resp.rebuilt_shard_ids)} on "
                        f"{rebuilder.url}")
        else:
            env.println(f"ec.rebuild volume {vid}: all shards present")
    if failures:
        raise ShellError(f"ec.rebuild: {failures} volume(s) failed")


@cluster_command("ec.decode")
def cmd_ec_decode(env: ClusterEnv, argv: list[str]) -> None:
    """Collect all shards onto the biggest holder, then
    VolumeEcShardsToVolume turns them back into a normal volume
    (command_ec_decode.go)."""
    p = _parser("ec.decode")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)
    vid, col = args.volumeId, args.collection
    nodes = [n for n in env.collect_ec_nodes() if vid in n.shards]
    if not nodes:
        raise ShellError(f"no EC shards for volume {vid}")
    collector = max(nodes, key=lambda n: len(n.shards.get(vid, [])))
    have = set(collector.shards[vid])
    cstub = env.volume(collector.url)
    for n in nodes:
        if n is collector:
            continue
        need = [s for s in n.shards[vid] if s not in have]
        if not need:
            continue
        cstub.VolumeEcShardsCopy(
            volume_server_pb2.VolumeEcShardsCopyRequest(
                volume_id=vid, collection=col, shard_ids=need,
                source_data_node=n.url))
        have.update(need)
    cstub.VolumeEcShardsToVolume(
        volume_server_pb2.VolumeEcShardsToVolumeRequest(
            volume_id=vid, collection=col))
    # Other nodes drop their shard files + mounts.
    for n in nodes:
        env.volume(n.url).VolumeEcShardsDelete(
            volume_server_pb2.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=col,
                shard_ids=n.shards[vid] if n is not collector
                else list(have)))
    env.println(f"ec.decode volume {vid}: restored on {collector.url}")


@cluster_command("ec.balance")
def cmd_ec_balance(env: ClusterEnv, argv: list[str]) -> None:
    """Even out EC shard counts across servers (command_ec_balance.go):
    move shards from the most-loaded to the least-loaded until spread."""
    p = _parser("ec.balance")
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)

    def scoped_count(n: EcNode) -> int:
        """Shards that the -collection filter makes movable on this
        node — selection and termination use the SAME scope as the
        move picker."""
        if not args.collection:
            return n.shard_count()
        return sum(len(s) for vid, s in n.shards.items()
                   if n.collections.get(vid, "") == args.collection)

    moved = 0
    for _round in range(100):
        nodes = env.collect_ec_nodes()
        if len(nodes) < 2:
            break
        nodes.sort(key=scoped_count)
        low, high = nodes[0], nodes[-1]
        if scoped_count(high) - scoped_count(low) <= 1:
            break

        # Move one shard the low node doesn't already hold for that
        # vid — PREFERRING one whose move improves rack spread (the
        # low node's rack holds fewer shards of that volume than the
        # high node's rack). Count balance still wins when no such
        # candidate exists: the fallback may move within a rack.
        def rack_count(vid: int, dc: str, rack: str) -> int:
            return sum(len(n.shards.get(vid, [])) for n in nodes
                       if (n.data_center, n.rack) == (dc, rack))

        pick: Optional[tuple[int, int]] = None
        fallback: Optional[tuple[int, int]] = None
        for vid, sids in high.shards.items():
            if (args.collection
                    and high.collections.get(vid, "") != args.collection):
                continue
            movable = [sid for sid in sids
                       if sid not in low.shards.get(vid, [])]
            if not movable:
                continue
            if fallback is None:
                fallback = (vid, movable[0])
            if rack_count(vid, low.data_center, low.rack) < \
                    rack_count(vid, high.data_center, high.rack):
                pick = (vid, movable[0])
                break
        if pick is None:
            pick = fallback
        if pick is None:
            break
        vid, sid = pick
        col = high.collections.get(vid, "")
        env.volume(low.url).VolumeEcShardsCopy(
            volume_server_pb2.VolumeEcShardsCopyRequest(
                volume_id=vid, collection=col,
                shard_ids=[sid], copy_ecx_file=True, copy_vif_file=True,
                source_data_node=high.url))
        env.volume(low.url).VolumeEcShardsMount(
            volume_server_pb2.VolumeEcShardsMountRequest(
                volume_id=vid, collection=col, shard_ids=[sid]))
        env.volume(high.url).VolumeEcShardsDelete(
            volume_server_pb2.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=col, shard_ids=[sid]))
        moved += 1
    env.println(f"ec.balance: moved {moved} shards")


@cluster_command("volume.list")
def cmd_volume_list(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("volume.list")
    p.parse_args(argv)
    resp = env.volume_list()
    for dc in resp.topology_info.data_center_infos:
        env.println(f"DataCenter {dc.id}")
        for rack in dc.rack_infos:
            env.println(f"  Rack {rack.id}")
            for dn in rack.data_node_infos:
                env.println(f"    DataNode {dn.id} "
                            f"volumes={dn.volume_count}/"
                            f"{dn.max_volume_count}")
                for v in dn.volume_infos:
                    env.println(
                        f"      volume {v.id} "
                        f"collection={v.collection or '-'} "
                        f"size={v.size} files={v.file_count}"
                        + (" readonly" if v.read_only else ""))
                for s in dn.ec_shard_infos:
                    env.println(
                        f"      ec volume {s.id} "
                        f"collection={s.collection or '-'} "
                        f"shards={ShardBits(s.ec_index_bits).ids()}")


@cluster_command("volume.tier.upload")
def cmd_volume_tier_upload(env: ClusterEnv, argv: list[str]) -> None:
    """Move a volume's .dat to the cold S3 tier on whichever server
    holds it (command_volume_tier_upload.go choreography over
    VolumeTierMoveDatToRemote); the server keeps serving reads through
    ranged GETs and reports the volume read-only from its next
    heartbeat."""
    p = _parser("volume.tier.upload")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dest", required=True,
                   help="endpoint/bucket, e.g. 127.0.0.1:8333/coldstore")
    p.add_argument("-keepLocal", action="store_true")
    args = p.parse_args(argv)
    locs = env.volume_locations(args.volumeId)
    if not locs:
        raise ShellError(f"volume {args.volumeId} not found")
    for url in locs:
        resp = env.volume(url).VolumeTierMoveDatToRemote(
            volume_server_pb2.VolumeTierMoveDatToRemoteRequest(
                volume_id=args.volumeId, collection=args.collection,
                destination_backend_name=args.dest,
                keep_local_dat_file=args.keepLocal))
        env.println(f"volume.tier.upload {args.volumeId} on {url}: "
                    f"{resp.moved_bytes} bytes -> {resp.object_url}")


@cluster_command("volume.tier.download")
def cmd_volume_tier_download(env: ClusterEnv, argv: list[str]) -> None:
    """Bring a tiered volume's .dat back to its server's local disk
    (command_volume_tier_download.go over VolumeTierMoveDatFromRemote)."""
    p = _parser("volume.tier.download")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)
    locs = env.volume_locations(args.volumeId)
    if not locs:
        raise ShellError(f"volume {args.volumeId} not found")
    for url in locs:
        resp = env.volume(url).VolumeTierMoveDatFromRemote(
            volume_server_pb2.VolumeTierMoveDatFromRemoteRequest(
                volume_id=args.volumeId, collection=args.collection))
        env.println(f"volume.tier.download {args.volumeId} on {url}: "
                    f"{resp.moved_bytes} bytes local again")


@cluster_command("volume.vacuum")
def cmd_volume_vacuum(env: ClusterEnv, argv: list[str]) -> None:
    """Drive Check -> Compact -> Commit on every volume whose reported
    garbage ratio exceeds the threshold (command_volume_vacuum.go /
    topology_vacuum.go choreography, operator-triggered)."""
    p = _parser("volume.vacuum")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    args = p.parse_args(argv)
    resp = env.volume_list()
    vacuumed = 0
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for v in dn.volume_infos:
                    if args.volumeId and v.id != args.volumeId:
                        continue
                    if args.collection and \
                            v.collection != args.collection:
                        continue
                    stub = env.volume(dn.id)
                    check = stub.VacuumVolumeCheck(
                        volume_server_pb2.VacuumVolumeCheckRequest(
                            volume_id=v.id, collection=v.collection))
                    threshold = 0.0 if args.volumeId else \
                        args.garbageThreshold
                    if check.garbage_ratio <= threshold:
                        continue
                    try:
                        stub.VacuumVolumeCompact(
                            volume_server_pb2.VacuumVolumeCompactRequest(
                                volume_id=v.id, collection=v.collection))
                        done = stub.VacuumVolumeCommit(
                            volume_server_pb2.VacuumVolumeCommitRequest(
                                volume_id=v.id, collection=v.collection))
                    except Exception:
                        stub.VacuumVolumeCleanup(
                            volume_server_pb2.VacuumVolumeCleanupRequest(
                                volume_id=v.id, collection=v.collection))
                        raise
                    env.println(
                        f"volume.vacuum: volume {v.id} on {dn.id} "
                        f"garbage {check.garbage_ratio:.1%} -> "
                        f"{done.volume_size} bytes")
                    vacuumed += 1
    env.println(f"volume.vacuum: {vacuumed} volumes compacted")


@cluster_command("collection.list")
def cmd_collection_list(env: ClusterEnv, argv: list[str]) -> None:
    """List collections with volume counts and sizes
    (command_collection_list.go)."""
    p = _parser("collection.list")
    p.parse_args(argv)
    resp = env.volume_list()
    agg: dict[str, list] = {}
    ec_ids: dict[str, set] = {}
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for v in dn.volume_infos:
                    a = agg.setdefault(v.collection, [0, 0])
                    a[0] += 1
                    a[1] += v.size
                for s in dn.ec_shard_infos:
                    agg.setdefault(s.collection, [0, 0])
                    # distinct ids: shards of one EC volume spread over
                    # several nodes count as ONE ec volume
                    ec_ids.setdefault(s.collection, set()).add(s.id)
    for col in sorted(agg):
        n, size = agg[col]
        env.println(f"collection {col or '(default)'!s}: {n} volumes, "
                    f"{size} bytes, "
                    f"{len(ec_ids.get(col, ()))} ec volumes")


@cluster_command("volume.grow")
def cmd_volume_grow(env: ClusterEnv, argv: list[str]) -> None:
    """Pre-grow writable volumes via the master (/vol/grow). One
    attempt: the JAX shell retries a failed grow (each retry grows
    again) and then reports only the HTTP status; the port reports the
    master's reason."""
    p = _parser("volume.grow")
    p.add_argument("-count", type=int, default=1)
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    args = p.parse_args(argv)
    try:
        doc = env._master_http(
            f"/vol/grow?count={args.count}&collection={args.collection}"
            f"&replication={args.replication}", method="POST", once=True,
            timeout=60)
    except ShellError as e:
        raise ShellError(f"volume.grow: {e}") from None
    env.println(f"volume.grow: created volumes {doc['volumeIds']}")


@cluster_command("cluster.status")
def cmd_cluster_status(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("cluster.status")
    p.parse_args(argv)
    resp = env.master().GetMasterConfiguration(
        master_pb2.GetMasterConfigurationRequest())
    env.println(f"master {env.master_url} "
                f"volumeSizeLimit={resp.volume_size_limit} "
                f"jwt={'on' if resp.jwt_enabled else 'off'}")
    try:
        doc = env._master_http("/cluster/status")
        # the admin lease lives on the LEADER; a follower's local view
        # is always empty — follow the Leader field before concluding
        # the cluster is unlocked
        if not doc.get("AdminLockHolder") and \
                doc.get("Leader") and \
                doc.get("Leader") != env.master_url:
            doc = env._master_http("/cluster/status",
                                   host=doc["Leader"])
        holder = doc.get("AdminLockHolder", "")
        if holder:
            env.println(f"admin lock held by {holder}")
    except ShellError:
        pass  # status stays best-effort
    nodes = env.collect_ec_nodes()
    env.println(f"{len(nodes)} data nodes")


@cluster_command("lock")
def cmd_lock(env: ClusterEnv, argv: list[str]) -> None:
    """Hold the master's exclusive admin lease across commands
    (command_lock.go); renewed automatically until `unlock`."""
    p = _parser("lock")
    p.parse_args(argv)
    env.admin_lock()
    env.println("locked (exclusive admin lease held; renews "
                "automatically until 'unlock')")


@cluster_command("unlock")
def cmd_unlock(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("unlock")
    p.parse_args(argv)
    if not env.locked:
        env.println("not locked")
        return
    env.admin_unlock()
    env.println("unlocked")


def _job_kind(name: str) -> str:
    """Shell spelling (``ec.encode``) -> manager kind (``ec_encode``)."""
    return name.replace(".", "_")


def _wait_for_job(env: ClusterEnv, job_id: str,
                  timeout: float = 600.0,
                  poll_seconds: float = 0.5) -> dict:
    """Poll /cluster/jobs until ``job_id`` reaches a terminal state,
    printing progress transitions as they happen."""
    deadline = time.monotonic() + timeout
    last = ""
    while True:
        doc = env._master_http("/cluster/jobs?tasks=0")
        jobs = {j["jobId"]: j for j in doc.get("jobs", ())}
        job = jobs.get(job_id)
        if job is None:
            raise ShellError(f"job {job_id} vanished from the master")
        counts = job.get("taskCounts", {})
        line = (f"{job['state']}: " + ", ".join(
            f"{n} {s}" for s, n in sorted(counts.items())))
        if line != last:
            env.println(f"job {job_id} {line}")
            last = line
        if job["state"] in ("done", "failed", "cancelled"):
            return job
        if time.monotonic() > deadline:
            raise ShellError(f"job {job_id} still {job['state']} after "
                             f"{timeout:.0f}s")
        time.sleep(poll_seconds)


@cluster_command("job.submit")
def cmd_job_submit(env: ClusterEnv, argv: list[str]) -> None:
    """Queue a maintenance sweep on the master's JobManager — volume
    servers pull the per-volume tasks under leases.
    ``job.submit ec.encode -collection X -parallel N`` sweeps the
    whole collection; ``-volumeId 3,7`` names volumes explicitly."""
    p = _parser("job.submit")
    p.add_argument("kind",
                   help="ec.encode | ec.rebuild | vacuum | replicate "
                        "| replica.drop")
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", default="",
                   help="comma-separated ids; default: every candidate "
                        "volume of the collection")
    p.add_argument("-parallel", type=int, default=0,
                   help="max concurrently leased tasks (0 = unlimited)")
    p.add_argument("-wait", action="store_true",
                   help="block until the job reaches a terminal state")
    args = p.parse_args(argv)
    vols = [int(x) for x in args.volumeId.split(",") if x]
    doc = env._master_http(
        "/cluster/jobs/submit", method="POST",
        body={"kind": _job_kind(args.kind), "collection": args.collection,
              "volumes": vols, "parallel": args.parallel,
              "submittedBy": "shell"})
    job = doc["job"]
    env.println(f"job {job['jobId']}: {job['total']} "
                f"{job['kind']} task(s) queued")
    if args.wait:
        job = _wait_for_job(env, job["jobId"])
        if job["state"] != "done":
            raise ShellError(f"job {job['jobId']} {job['state']}")


@cluster_command("job.status")
def cmd_job_status(env: ClusterEnv, argv: list[str]) -> None:
    """Show the maintenance plane: every job's task counts, plus the
    policy engine's state (disarmed on a port master)."""
    p = _parser("job.status")
    p.add_argument("-job", default="", help="show one job's tasks")
    args = p.parse_args(argv)
    doc = env._master_http("/cluster/jobs")
    if args.job:
        jobs = [j for j in doc.get("jobs", ())
                if j["jobId"] == args.job]
        if not jobs:
            raise ShellError(f"unknown job {args.job}")
        for t in jobs[0].get("tasks", ()):
            err = f"  {t['error']}" if t["error"] else ""
            env.println(
                f"{t['taskId']}: {t['kind']} volume {t['volumeId']} "
                f"{t['state']} ({t['fraction']:.0%} on "
                f"{t['worker'] or '-'}, attempt {t['attempts']}){err}")
        return
    jobs = doc.get("jobs", ())
    if not jobs:
        env.println("no jobs")
    for j in jobs:
        counts = ", ".join(f"{n} {s}" for s, n in
                           sorted(j.get("taskCounts", {}).items()))
        env.println(f"{j['jobId']}: {j['kind']} "
                    f"[{j['collection'] or 'default'}] {j['state']} "
                    f"({counts or 'empty'})")
    pol = doc.get("policy", {})
    env.println(f"policy: {'on' if pol.get('enabled') else 'off'}, "
                f"{pol.get('ticks', 0)} tick(s), "
                f"{len(pol.get('actions', ()))} recent action(s)")


def _job_control(env: ClusterEnv, verb: str, argv: list[str]) -> None:
    p = _parser(f"job.{verb}")
    p.add_argument("-job", required=True)
    args = p.parse_args(argv)
    job = env._master_http(f"/cluster/jobs/{verb}?job={args.job}",
                           method="POST")["job"]
    env.println(f"job {job['jobId']} {job['state']}")


@cluster_command("job.pause")
def cmd_job_pause(env: ClusterEnv, argv: list[str]) -> None:
    """Stop handing out a job's pending tasks (in-flight leases
    finish); job.resume continues it."""
    _job_control(env, "pause", argv)


@cluster_command("job.resume")
def cmd_job_resume(env: ClusterEnv, argv: list[str]) -> None:
    _job_control(env, "resume", argv)


@cluster_command("job.cancel")
def cmd_job_cancel(env: ClusterEnv, argv: list[str]) -> None:
    """Terminally stop a job: pending tasks are never handed out
    again; a task already leased still reports its completion."""
    _job_control(env, "cancel", argv)


@cluster_command("scrub.start")
def cmd_scrub_start(env: ClusterEnv, argv: list[str]) -> None:
    """Start a paced integrity scrub: every targeted volume's live
    needles are CRC-walked and its EC shards hash-verified on the
    server that holds them, with corrupt data quarantined and
    auto-repaired from replicas / parity. Defaults to every plain + EC
    volume of the collection."""
    p = _parser("scrub.start")
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", default="",
                   help="comma-separated ids; default: every volume "
                        "of the collection")
    p.add_argument("-rate", type=int, default=0,
                   help="byte read rate cap per task "
                        "(0 = [storage.scrub] configured rate)")
    p.add_argument("-parallel", type=int, default=0,
                   help="max concurrently leased tasks (0 = unlimited)")
    p.add_argument("-wait", action="store_true",
                   help="block until the scrub reaches a terminal "
                        "state")
    args = p.parse_args(argv)
    body = {"collection": args.collection,
            "volumes": [int(x) for x in args.volumeId.split(",") if x],
            "parallel": args.parallel, "submittedBy": "shell"}
    if args.rate > 0:
        body["rate_bytes_per_second"] = args.rate
    doc = env._master_http("/cluster/scrub", method="POST", body=body)
    job = doc["job"]
    env.println(f"scrub {job['jobId']}: {job['total']} volume(s) "
                f"queued")
    if args.wait:
        job = _wait_for_job(env, job["jobId"])
        if job["state"] != "done":
            raise ShellError(f"scrub {job['jobId']} {job['state']}")


@cluster_command("scrub.status")
def cmd_scrub_status(env: ClusterEnv, argv: list[str]) -> None:
    """Show the scrub plane: each scrub job's per-volume task states
    and the candidate count still uncovered."""
    p = _parser("scrub.status")
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)
    doc = env._master_http(
        f"/cluster/scrub?collection={args.collection}")
    jobs = doc.get("jobs", ())
    if not jobs:
        env.println("no scrub jobs")
    for j in jobs:
        counts = ", ".join(f"{n} {s}" for s, n in
                           sorted(j.get("taskCounts", {}).items()))
        env.println(f"{j['jobId']}: [{j['collection'] or 'default'}] "
                    f"{j['state']} ({counts or 'empty'})")
        for t in j.get("tasks", ()):
            if t["state"] in ("leased", "failed"):
                err = f"  {t['error']}" if t["error"] else ""
                env.println(
                    f"  {t['taskId']}: volume {t['volumeId']} "
                    f"{t['state']} ({t['fraction']:.0%} on "
                    f"{t['worker'] or '-'}){err}")
    env.println(f"candidate volumes: {doc.get('candidates', 0)}")


def _move_volume(env: ClusterEnv, vid: int, collection: str,
                 src: str, dst: str) -> None:
    """Relocate one volume: freeze on the source, VolumeCopy to the
    destination, delete the source copy. A failed copy thaws the
    source so it never sticks readonly (the move mechanics shared by
    volume.balance and volume.move)."""
    env.volume(src).VolumeMarkReadonly(
        volume_server_pb2.VolumeMarkReadonlyRequest(
            volume_id=vid, collection=collection))
    try:
        env.volume(dst).VolumeCopy(
            volume_server_pb2.VolumeCopyRequest(
                volume_id=vid, collection=collection,
                source_data_node=src))
    except Exception as e:
        thaw = "source thawed"
        try:
            env.volume(src).VolumeMarkWritable(
                volume_server_pb2.VolumeMarkWritableRequest(
                    volume_id=vid, collection=collection))
        except Exception as e2:  # noqa: BLE001 — report both
            thaw = f"thaw also failed: {e2}"
        raise ShellError(
            f"copy of volume {vid} to {dst} failed ({e}); "
            f"{thaw}") from e
    env.volume(src).VolumeDelete(
        volume_server_pb2.VolumeDeleteRequest(
            volume_id=vid, collection=collection))


@cluster_command("volume.move")
def cmd_volume_move(env: ClusterEnv, argv: list[str]) -> None:
    """Relocate one volume between servers
    (command_volume_move.go)."""
    p = _parser("volume.move")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-source", required=True, help="source ip:port")
    p.add_argument("-target", required=True, help="target ip:port")
    args = p.parse_args(argv)
    if args.source == args.target:
        raise ShellError("volume.move: source and target are the same")
    _move_volume(env, args.volumeId, args.collection, args.source,
                 args.target)
    env.println(f"volume.move: volume {args.volumeId} "
                f"{args.source} -> {args.target}")


@cluster_command("collection.delete")
def cmd_collection_delete(env: ClusterEnv, argv: list[str]) -> None:
    """Delete every volume and EC shard of a collection cluster-wide
    (command_collection_delete.go)."""
    p = _parser("collection.delete")
    p.add_argument("-collection", required=True)
    args = p.parse_args(argv)
    col = args.collection
    resp = env.volume_list()
    deleted = 0
    ec_deleted: set[int] = set()
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for v in dn.volume_infos:
                    if v.collection != col:
                        continue
                    env.volume(dn.id).VolumeDelete(
                        volume_server_pb2.VolumeDeleteRequest(
                            volume_id=v.id, collection=col))
                    deleted += 1
                for s in dn.ec_shard_infos:
                    if s.collection != col:
                        continue
                    # EcShardsDelete both unmounts (with the right
                    # collection) and unlinks the shard files
                    env.volume(dn.id).VolumeEcShardsDelete(
                        volume_server_pb2.VolumeEcShardsDeleteRequest(
                            volume_id=s.id, collection=col,
                            shard_ids=ShardBits(
                                s.ec_index_bits).ids()))
                    ec_deleted.add(s.id)
    env.println(f"collection.delete: {col}: {deleted} volumes, "
                f"{len(ec_deleted)} ec volumes removed")


@cluster_command("volume.balance")
def cmd_volume_balance(env: ClusterEnv, argv: list[str]) -> None:
    """Move whole volumes from loaded to free servers
    (command_volume_balance.go, via VolumeCopy + delete)."""
    p = _parser("volume.balance")
    p.add_argument("-collection", default="",
                   help="only move volumes of this collection")
    args = p.parse_args(argv)
    moved = 0
    for _round in range(100):
        resp = env.volume_list()
        # With -collection, BOTH node selection and the termination
        # check run on collection-scoped counts: selecting by total
        # count could pick a "high" node holding none of the target
        # collection and stop with it still concentrated elsewhere.
        counts: list[tuple[int, str, list]] = []
        for dc in resp.topology_info.data_center_infos:
            for rack in dc.rack_infos:
                for dn in rack.data_node_infos:
                    vols = [v for v in dn.volume_infos
                            if not args.collection
                            or v.collection == args.collection]
                    # len(vols) serves both paths: sorting on the
                    # heartbeat's separate volume_count field while
                    # picking moves from volume_infos would leave two
                    # sources to disagree under lag
                    counts.append((len(vols), dn.id, vols))
        if len(counts) < 2:
            break
        counts.sort()
        low_count, low_url, low_vols = counts[0]
        high_count, high_url, high_vols = counts[-1]
        if high_count - low_count <= 1 or not high_vols:
            break
        # The destination may already hold a replica of some of the
        # high node's volumes — pick the first it does not.
        low_ids = {(v.collection, v.id) for v in low_vols}
        movable = [v for v in high_vols
                   if (v.collection, v.id) not in low_ids]
        if not movable:
            break
        v = movable[0]
        try:
            _move_volume(env, v.id, v.collection, high_url, low_url)
        except ShellError as e:
            raise ShellError(f"volume.balance: {e}") from e
        moved += 1
    env.println(f"volume.balance: moved {moved} volumes")


@cluster_command("volume.fix.replication")
def cmd_volume_fix_replication(env: ClusterEnv, argv: list[str]) -> None:
    """Re-replicate under-replicated volumes (the recovery actuator the
    reference cron-drives; command_volume_fix_replication.go)."""
    from ..storage.superblock import ReplicaPlacement

    p = _parser("volume.fix.replication")
    p.parse_args(argv)
    resp = env.volume_list()
    # vid -> (collection, rp, holders)
    vols: dict[int, tuple[str, int, list[str]]] = {}
    all_nodes: list[str] = []
    racks: dict[str, tuple[str, str]] = {}
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                all_nodes.append(dn.id)
                racks[dn.id] = (dc.id, rack.id)
                for v in dn.volume_infos:
                    col, rp, holders = vols.get(
                        v.id, (v.collection, v.replica_placement, []))
                    holders.append(dn.id)
                    vols[v.id] = (col, rp, holders)
    fixed = 0
    for vid, (col, rp_byte, holders) in sorted(vols.items()):
        want = ReplicaPlacement.from_byte(rp_byte).copy_count()
        if len(holders) >= want:
            continue
        # placement-aware, chosen GREEDILY per missing replica: the
        # held-racks set grows after every copy, so two replacements
        # never pile into the same fresh rack while another rack sits
        # empty (a rack-diverse placement exists to survive rack loss)
        for _ in range(want - len(holders)):
            held_racks = {racks[h] for h in holders}
            spare = sorted(
                (u for u in all_nodes if u not in holders),
                key=lambda u: racks[u] in held_racks)
            if not spare:
                break
            target = spare[0]
            env.volume(target).VolumeCopy(
                volume_server_pb2.VolumeCopyRequest(
                    volume_id=vid, collection=col,
                    source_data_node=holders[0]))
            if racks[target] in held_racks:
                env.println(
                    f"volume.fix.replication: WARNING volume {vid} "
                    f"replica lands on rack {racks[target][1]} which "
                    f"already holds one (no rack-free node available)")
            env.println(f"volume.fix.replication: volume {vid} "
                        f"copied {holders[0]} -> {target}")
            holders.append(target)
            fixed += 1
    if not fixed:
        env.println("volume.fix.replication: all volumes fully "
                    "replicated")


@cluster_command("volume.mark")
def cmd_volume_mark(env: ClusterEnv, argv: list[str]) -> None:
    """Mark a volume readonly/writable on its servers (the reference's
    volume.mark; drives VolumeMarkReadonly/Writable on every replica,
    or just one with -node)."""
    p = _parser("volume.mark")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-node", default="",
                   help="only this server (default: every replica)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-readonly", action="store_true")
    g.add_argument("-writable", action="store_true")
    args = p.parse_args(argv)
    locs = [args.node] if args.node else \
        env.volume_locations(args.volumeId)
    if not locs:
        raise ShellError(f"volume {args.volumeId} not found")
    for url in locs:
        stub = env.volume(url)
        if args.readonly:
            stub.VolumeMarkReadonly(
                volume_server_pb2.VolumeMarkReadonlyRequest(
                    volume_id=args.volumeId,
                    collection=args.collection))
        else:
            stub.VolumeMarkWritable(
                volume_server_pb2.VolumeMarkWritableRequest(
                    volume_id=args.volumeId,
                    collection=args.collection))
    state = "readonly" if args.readonly else "writable"
    env.println(f"volume.mark: volume {args.volumeId} {state} on "
                f"{', '.join(locs)}")


@cluster_command("volume.deleteEmpty")
def cmd_volume_delete_empty(env: ClusterEnv, argv: list[str]) -> None:
    """Delete volumes holding zero live files cluster-wide
    (command_volume_delete_empty.go). Dry-runs unless -force; like the
    reference, only volumes untouched for -quietFor seconds qualify —
    the master's snapshot is heartbeat-stale, so a just-written volume
    could otherwise still report zero files."""
    p = _parser("volume.deleteEmpty")
    p.add_argument("-collection", default="")
    p.add_argument("-quietFor", type=int, default=86400,
                   help="seconds since last modification (default 1d)")
    p.add_argument("-force", action="store_true")
    args = p.parse_args(argv)
    resp = env.volume_list()
    now = int(time.time())
    # (collection, vid) -> [holder urls]; a volume counts once however
    # many replicas it has, and ANY replica that is non-empty or
    # recently modified disqualifies the whole volume (replica state is
    # heartbeat-stale and may disagree — be conservative before a
    # destructive sweep).
    holders: dict[tuple[str, int], list[str]] = {}
    disqualified: set[tuple[str, int]] = set()
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for v in dn.volume_infos:
                    if args.collection and \
                            v.collection != args.collection:
                        continue
                    key = (v.collection, v.id)
                    holders.setdefault(key, []).append(dn.id)
                    if v.file_count - v.delete_count > 0:
                        disqualified.add(key)
                    # unknown mtime (0) is never "quiet"
                    if not v.modified_at_second or \
                            now - v.modified_at_second < args.quietFor:
                        disqualified.add(key)
    empties = sorted(k for k in holders if k not in disqualified)
    for col, vid in empties:
        for url in holders[(col, vid)]:
            if args.force:
                env.volume(url).VolumeDelete(
                    volume_server_pb2.VolumeDeleteRequest(
                        volume_id=vid, collection=col))
            env.println(
                f"volume.deleteEmpty: volume {vid} on {url}"
                + ("" if args.force else " (dry run; use -force)"))
    env.println(f"volume.deleteEmpty: {len(empties)} empty volumes"
                + (" deleted" if args.force else " found"))


@cluster_command("volumeServer.evacuate")
def cmd_volume_server_evacuate(env: ClusterEnv, argv: list[str]) -> None:
    """Move every volume and EC shard off one server so it can be
    decommissioned (command_volume_server_evacuate.go): volumes go to
    the least-loaded server without a replica of them, EC shards
    spread over the remaining nodes."""
    p = _parser("volumeServer.evacuate")
    p.add_argument("-node", required=True, help="server ip:port to drain")
    args = p.parse_args(argv)
    victim = args.node
    resp = env.volume_list()
    counts: dict[str, int] = {}   # node url -> volume count
    caps: dict[str, int] = {}     # node url -> max volume count (0 = inf)
    racks: dict[str, tuple[str, str]] = {}  # node url -> (dc, rack)
    holds: dict[str, set[tuple[str, int]]] = {}
    victim_vols: list = []
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                counts[dn.id] = dn.volume_count
                caps[dn.id] = dn.max_volume_count
                racks[dn.id] = (dc.id, rack.id)
                holds[dn.id] = {(v.collection, v.id)
                                for v in dn.volume_infos}
                if dn.id == victim:
                    victim_vols = list(dn.volume_infos)
    if victim not in counts:
        raise ShellError(f"node {victim} not in topology")

    def has_slot(u: str) -> bool:
        return not caps[u] or counts[u] < caps[u]

    moved = 0
    for v in victim_vols:
        # Racks holding the volume's OTHER replicas: landing on one of
        # them would collapse a rack-spread placement like 010, so such
        # targets only qualify as a last resort (with a warning) — the
        # reference evacuate is placement-aware the same way.
        other_racks = {racks[u] for u in counts
                       if u != victim and (v.collection, v.id)
                       in holds[u]}
        candidates = [u for u in counts
                      if u != victim and has_slot(u)
                      and (v.collection, v.id) not in holds[u]]
        # placement safety first, then most free slots
        candidates.sort(key=lambda u: (racks[u] in other_racks,
                                       counts[u] - (caps[u] or 10 ** 9)))
        if not candidates:
            raise ShellError(
                f"volumeServer.evacuate: no target with free space "
                f"for volume {v.id}")
        dst = candidates[0]
        if other_racks and racks[dst] in other_racks:
            env.println(
                f"volumeServer.evacuate: WARNING volume {v.id} lands "
                f"on rack {racks[dst][1]} which already holds a "
                f"replica (no rack-safe target had free space)")
        _move_volume(env, v.id, v.collection, victim, dst)
        counts[dst] += 1
        holds[dst].add((v.collection, v.id))
        env.println(f"volumeServer.evacuate: volume {v.id} -> {dst}")
        moved += 1
    # EC shards: spread over remaining nodes that lack that shard.
    nodes = env.collect_ec_nodes()
    vnode = next((n for n in nodes if n.url == victim), None)
    others = [n for n in nodes if n.url != victim]
    ec_moved = 0
    if vnode is not None and vnode.shards:
        if not others:
            raise ShellError("volumeServer.evacuate: no other nodes "
                             "for EC shards")
        for vid, sids in sorted(vnode.shards.items()):
            col = vnode.collections.get(vid, "")
            for sid in sids:
                tgts = sorted(
                    (n for n in others
                     if sid not in n.shards.get(vid, [])),
                    key=lambda n: n.shard_count())
                if not tgts:
                    raise ShellError(
                        f"volumeServer.evacuate: every node already "
                        f"holds shard {vid}.{sid}")
                t = tgts[0]
                env.volume(t.url).VolumeEcShardsCopy(
                    volume_server_pb2.VolumeEcShardsCopyRequest(
                        volume_id=vid, collection=col, shard_ids=[sid],
                        copy_ecx_file=True, copy_ecj_file=True,
                        copy_vif_file=True, source_data_node=victim))
                env.volume(t.url).VolumeEcShardsMount(
                    volume_server_pb2.VolumeEcShardsMountRequest(
                        volume_id=vid, collection=col, shard_ids=[sid]))
                env.volume(victim).VolumeEcShardsDelete(
                    volume_server_pb2.VolumeEcShardsDeleteRequest(
                        volume_id=vid, collection=col, shard_ids=[sid]))
                t.shards.setdefault(vid, []).append(sid)
                ec_moved += 1
    env.println(f"volumeServer.evacuate: {victim} drained "
                f"({moved} volumes, {ec_moved} ec shards)")


@cluster_command("volume.check.disk")
def cmd_volume_check_disk(env: ClusterEnv, argv: list[str]) -> None:
    """Verify replicas of each volume hold the same live needles and
    sync divergence (command_volume_check_disk.go): stream every
    replica's .idx, diff the live sets, and with -fix copy missing
    needles raw (ReadNeedleBlob -> WriteNeedleBlob) so CRCs and
    timestamps survive bit-for-bit. Size-skewed needles are reported,
    never auto-resolved; tombstone skews are reported by default (a
    needle is never resurrected) and the delete is finished everywhere
    under the explicit -resolveDeletes opt-in."""
    from ..storage import idx as idx_mod
    from ..storage.types import TOMBSTONE_FILE_SIZE

    p = _parser("volume.check.disk")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-fix", action="store_true",
                   help="sync missing needles (default: report only)")
    p.add_argument("-resolveDeletes", action="store_true",
                   help="propagate deletes: a needle tombstoned on "
                        "any replica is deleted everywhere (explicit "
                        "opt-in — this finishes a client's delete, "
                        "it can't be undone)")
    args = p.parse_args(argv)
    resp = env.volume_list()
    # (collection, vid) -> [holder urls]
    replicas: dict[tuple[str, int], list[str]] = {}
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for v in dn.volume_infos:
                    if args.volumeId and v.id != args.volumeId:
                        continue
                    if args.collection and \
                            v.collection != args.collection:
                        continue
                    replicas.setdefault(
                        (v.collection, v.id), []).append(dn.id)

    def live_map(url: str, vid: int,
                 col: str) -> tuple[dict[int, int], set[int]]:
        """(key -> size after tombstone replay, tombstoned keys)."""
        blob = b"".join(
            r.file_content for r in env.volume(url).CopyFile(
                volume_server_pb2.CopyFileRequest(
                    volume_id=vid, collection=col, ext=".idx")))
        live: dict[int, int] = {}
        dead: set[int] = set()
        for e in idx_mod.walk_index_blob(blob):
            if e.size == TOMBSTONE_FILE_SIZE:
                live.pop(e.key, None)
                dead.add(e.key)
            else:
                live[e.key] = e.size
                dead.discard(e.key)
        return live, dead

    checked = synced = divergent = skews = deletes_propagated = 0
    for (col, vid), urls in sorted(replicas.items(),
                                   key=lambda kv: kv[0][1]):
        if len(urls) < 2:
            continue
        checked += 1
        maps: dict[str, dict[int, int]] = {}
        deads: dict[str, set[int]] = {}
        for u in urls:
            maps[u], deads[u] = live_map(u, vid, col)
        union: set[int] = set()
        all_dead: set[int] = set()
        for m in maps.values():
            union.update(m)
        for d in deads.values():
            all_dead.update(d)
        # A needle live on one replica but tombstoned on another is
        # reported; it is only MUTATED under the explicit
        # -resolveDeletes opt-in (finish the client's delete
        # everywhere) — resurrecting is never an option, and the
        # default remains report-only like the reference check.disk.
        for k in sorted(union & all_dead):
            holders_live = [u for u in urls if k in maps[u]]
            if holders_live:
                skews += 1
                env.println(
                    f"volume {vid} needle {k}: live on "
                    f"{', '.join(holders_live)} but deleted elsewhere"
                    + (" — propagating the delete"
                       if args.resolveDeletes else ""))
                if not args.resolveDeletes:
                    continue
                url = holders_live[0]
                try:
                    # the server fans the delete out to its replica
                    # peers, so one request tombstones every live copy
                    _http_delete_needle(env, url, vid, col, k)
                    deletes_propagated += 1
                    skews -= 1  # resolved, no longer outstanding
                except Exception as e:  # noqa: BLE001 — keep sweeping
                    env.println(
                        f"  delete propagation of needle {k} via "
                        f"{url} errored ({e}); the tombstone may have "
                        f"landed there even if replica fan-out "
                        f"failed — re-run to re-check")
        # Same key live with different sizes = a missed overwrite; the
        # idx alone cannot say which side is newer, so report it and
        # keep it OUT of the sync loop below (copying an arbitrary
        # version would auto-pick the winner this command promises
        # never to pick).
        size_skewed: set[int] = set()
        for k in sorted(union - all_dead):
            sizes = {maps[u][k] for u in urls if k in maps[u]}
            if len(sizes) > 1:
                size_skewed.add(k)
                skews += 1
                env.println(
                    f"volume {vid} needle {k}: size differs across "
                    f"replicas ({sorted(sizes)}) — missed overwrite")
        # Keys deleted anywhere are excluded from syncing entirely:
        # copying one onto a replica that never held it would spread a
        # client-deleted needle (the skew report above covers them).
        for u in urls:
            missing = [k for k in union - all_dead - size_skewed
                       if k not in maps[u]]
            if not missing:
                continue
            divergent += 1
            donors = [d for d in urls if d != u]
            env.println(f"volume {vid} on {u}: {len(missing)} "
                        f"needle(s) missing"
                        + ("" if args.fix else " (dry run; use -fix)"))
            if not args.fix:
                continue
            for k in sorted(missing):
                donor = next(d for d in donors if k in maps[d])
                blob = env.volume(donor).ReadNeedleBlob(
                    volume_server_pb2.ReadNeedleBlobRequest(
                        volume_id=vid, collection=col, needle_id=k))
                env.volume(u).WriteNeedleBlob(
                    volume_server_pb2.WriteNeedleBlobRequest(
                        volume_id=vid, collection=col, needle_id=k,
                        needle_blob=blob.needle_blob))
                synced += 1
    env.println(f"volume.check.disk: {checked} replicated volumes "
                f"checked, {divergent} divergent replicas, "
                f"{synced} needles synced, "
                + (f"{deletes_propagated} deletes propagated, "
                   if deletes_propagated else "")
                + f"{skews} unresolved skews")


@cluster_command("volume.unmount")
def cmd_volume_unmount(env: ClusterEnv, argv: list[str]) -> None:
    """Stop serving a volume on one server, keeping its files
    (command_volume_unmount.go) — the maintenance verb before moving a
    volume directory by hand."""
    p = _parser("volume.unmount")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-node", required=True, help="server ip:port")
    args = p.parse_args(argv)
    env.volume(args.node).VolumeUnmount(
        volume_server_pb2.VolumeUnmountRequest(
            volume_id=args.volumeId, collection=args.collection))
    env.println(f"volume.unmount: volume {args.volumeId} unmounted "
                f"on {args.node} (files kept)")


@cluster_command("volume.mount")
def cmd_volume_mount(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("volume.mount")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-node", required=True, help="server ip:port")
    args = p.parse_args(argv)
    env.volume(args.node).VolumeMount(
        volume_server_pb2.VolumeMountRequest(
            volume_id=args.volumeId, collection=args.collection))
    env.println(f"volume.mount: volume {args.volumeId} mounted "
                f"on {args.node}")


@cluster_command("volume.configure.replication")
def cmd_volume_configure_replication(env: ClusterEnv,
                                     argv: list[str]) -> None:
    """Change a volume's replica placement on every replica
    (command_volume_configure_replication.go). Only the superblock
    setting changes; run volume.fix.replication afterwards to create
    the replicas the new placement asks for."""
    p = _parser("volume.configure.replication")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-replication", required=True)
    args = p.parse_args(argv)
    locs = env.volume_locations(args.volumeId)
    if not locs:
        raise ShellError(f"volume {args.volumeId} not found")
    # Try EVERY replica even after a failure: stopping midway would
    # leave the survivors' superblocks silently divergent with no
    # record of which were already changed.
    done: list[str] = []
    failed: list[tuple[str, str]] = []
    for url in locs:
        try:
            resp = env.volume(url).VolumeConfigure(
                volume_server_pb2.VolumeConfigureRequest(
                    volume_id=args.volumeId,
                    collection=args.collection,
                    replication=args.replication))
            err = resp.error
        except Exception as e:  # noqa: BLE001 — keep going
            err = str(e)
        if err:
            failed.append((url, err))
        else:
            done.append(url)
    if failed:
        detail = "; ".join(f"{u}: {e}" for u, e in failed)
        raise ShellError(
            f"volume.configure.replication: volume {args.volumeId} "
            f"now {args.replication} on "
            f"{', '.join(done) if done else 'NO replicas'} but "
            f"FAILED on {detail} — replica placements are divergent; "
            f"re-run when those servers answer")
    env.println(
        f"volume.configure.replication: volume {args.volumeId} -> "
        f"{args.replication} on {', '.join(done)} "
        f"(run volume.fix.replication to materialize new replicas)")


@cluster_command("volume.fsck")
def cmd_volume_fsck(env: ClusterEnv, argv: list[str]) -> None:
    """Cross-check filer chunk references against volume needle maps
    (command_volume_fsck.go): needles no file references are ORPHANS
    (reclaimable with -purge); referenced chunks absent from their
    volume are MISSING (broken files — always just reported). Writes
    racing the scan can look orphaned/missing for one pass; re-run (or
    hold `lock`) before trusting a purge."""
    from ..pb import volume_server_pb2 as vpb
    from ..storage import idx as idx_mod
    from ..storage import needle as needle_mod
    from ..storage.types import TOMBSTONE_FILE_SIZE, FileId

    p = _parser("volume.fsck")
    p.add_argument("-collection", default="",
                   help="limit to one collection")
    p.add_argument("-purge", action="store_true",
                   help="delete orphan needles from normal volumes")
    p.add_argument("-cutoffSeconds", type=int, default=300,
                   help="never purge needles appended within this "
                        "window (writes racing the scan look orphaned "
                        "for one pass; reference fsck's cutoff)")
    p.add_argument("-v", action="store_true", dest="verbose")
    args = p.parse_args(argv)
    from . import fs_commands  # deferred: avoids import cycle

    fc = fs_commands._fc(env)

    # 1) referenced chunk fids from the filer tree
    referenced: dict[tuple[str, int], set[int]] = {}
    where: dict[tuple[str, int, int], str] = {}  # -> first path
    for d, e in fs_commands._walk(fc, "/"):
        if e.is_directory:
            continue
        col = e.attributes.collection
        if args.collection and col != args.collection:
            continue
        for c in e.chunks:
            try:
                f = FileId.parse(c.file_id)
            except ValueError:
                continue
            referenced.setdefault((col, f.volume_id),
                                  set()).add(f.key)
            where.setdefault((col, f.volume_id, f.key),
                             f"{d.rstrip('/')}/{e.name}")

    # 2) live needle maps volume by volume (normal: .idx replay; EC:
    #    .ecx with .ecj deletes)
    resp = env.volume_list()
    vol_holder: dict[tuple[str, int], str] = {}
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for v in dn.volume_infos:
                    vol_holder.setdefault((v.collection, v.id), dn.id)
    ec_holder: dict[tuple[str, int], str] = {}
    for n in env.collect_ec_nodes():
        for vid in n.shards:
            ec_holder.setdefault((n.collections.get(vid, ""), vid),
                                 n.url)

    def fetch(url: str, vid: int, col: str, ext: str,
              optional: bool = False) -> bytes:
        return b"".join(r.file_content for r in env.volume(url).CopyFile(
            vpb.CopyFileRequest(
                volume_id=vid, collection=col, ext=ext,
                ignore_source_file_not_found=optional)))

    live: dict[tuple[str, int], dict[int, int]] = {}
    is_ec: set[tuple[str, int]] = set()
    for key_, url in vol_holder.items():
        col, vid = key_
        if args.collection and col != args.collection:
            continue
        m: dict[int, int] = {}
        for e in idx_mod.walk_index_blob(fetch(url, vid, col, ".idx")):
            if e.size == TOMBSTONE_FILE_SIZE:
                m.pop(e.key, None)
            else:
                m[e.key] = e.size
        live[key_] = m
    for key_, url in ec_holder.items():
        col, vid = key_
        if key_ in live:
            continue
        if args.collection and col != args.collection:
            continue
        m = {}
        for e in idx_mod.walk_index_blob(fetch(url, vid, col, ".ecx")):
            if e.size != TOMBSTONE_FILE_SIZE:
                m[e.key] = e.size
        ecj = fetch(url, vid, col, ".ecj", optional=True)
        for i in range(0, len(ecj) - len(ecj) % 8, 8):
            m.pop(int.from_bytes(ecj[i:i + 8], "big"), None)
        live[key_] = m
        is_ec.add(key_)

    # 3) compare
    orphans = orphan_bytes = missing = purged = 0
    guard = security.Guard(env.secret)
    for key_, m in sorted(live.items()):
        col, vid = key_
        refs = referenced.get(key_, set())
        extra = [k for k in m if k not in refs]
        gone = sorted(refs - set(m))
        if extra:
            orphans += len(extra)
            vol_bytes = sum(m[k] for k in extra)
            orphan_bytes += vol_bytes
            env.println(
                f"volume {vid}{f' ({col})' if col else ''}"
                f"{' [ec]' if key_ in is_ec else ''}: "
                f"{len(extra)} orphan needle(s), {vol_bytes} bytes"
                + (" — purging" if args.purge and key_ not in is_ec
                   else ""))
            if args.verbose:
                for k in sorted(extra):
                    env.println(f"  orphan needle {k}")
            if args.purge and key_ not in is_ec:
                url = vol_holder[key_]
                now_ns = time.time_ns()
                for k in sorted(extra):
                    try:
                        blob = env.volume(url).ReadNeedleBlob(
                            vpb.ReadNeedleBlobRequest(
                                volume_id=vid, collection=col,
                                needle_id=k))
                    except Exception as e:  # noqa: BLE001
                        env.println(
                            f"  purge of needle {k} skipped "
                            f"(read failed: {e})")
                        continue
                    try:
                        rec = needle_mod.Needle.parse(blob.needle_blob)
                    except needle_mod.NeedleError:
                        # v1 record (no timestamp): age unknowable,
                        # cutoff can't apply
                        rec = needle_mod.Needle.parse(
                            blob.needle_blob, version=1)
                    if rec.append_at_ns and \
                            now_ns - rec.append_at_ns < \
                            args.cutoffSeconds * 1_000_000_000:
                        env.println(
                            f"  needle {k} appended "
                            f"{(now_ns - rec.append_at_ns) / 1e9:.0f}s "
                            f"ago (< cutoff); NOT purged — likely a "
                            f"write racing the scan")
                        continue
                    cookie = rec.cookie
                    fid = str(FileId(volume_id=vid, key=k,
                                     cookie=cookie))
                    try:
                        retry.http_request(
                            f"http://{url}/{fid}"
                            + (f"?collection={col}" if col else ""),
                            method="DELETE", point="volume.delete",
                            jwt=(guard.sign(fid) if guard.enabled
                                 else ""), timeout=60)
                        purged += 1
                    except Exception as e:  # noqa: BLE001
                        # one vanished/failed needle (vacuum racing
                        # the purge) must not abort the sweep
                        env.println(
                            f"  purge of needle {k} failed: {e}")
        for k in gone:
            missing += 1
            env.println(
                f"volume {vid}{f' ({col})' if col else ''}: needle "
                f"{k} MISSING but referenced by "
                f"{where.get((col, vid, k), '?')}")
    # volumes the filer references but no live server holds at all: a
    # down node or deleted volume — every chunk on it is unreadable
    for key_ in sorted(set(referenced) - set(live)):
        col, vid = key_
        missing += len(referenced[key_])
        env.println(
            f"volume {vid}{f' ({col})' if col else ''}: NOT FOUND on "
            f"any server but {len(referenced[key_])} chunk(s) "
            f"reference it (e.g. "
            f"{where.get((col, vid, next(iter(referenced[key_]))), '?')})")
    env.println(
        f"volume.fsck: {len(live)} volumes, {orphans} orphan "
        f"needles ({orphan_bytes} bytes)"
        + (f", {purged} purged" if args.purge else "")
        + f", {missing} missing chunks"
        + (" — some files are BROKEN" if missing else ""))


class _CappedLines:
    """Print at most ``limit`` detail lines; the summary keeps exact
    totals. At simulation scale a sweep can find tens of thousands of
    problems — render the head, say how much was cut."""

    def __init__(self, env: ClusterEnv, limit: int):
        self.env = env
        self.limit = max(0, limit)
        self.shown = 0
        self.suppressed = 0

    def println(self, line: str) -> None:
        if self.shown < self.limit:
            self.shown += 1
            self.env.println(line)
        else:
            self.suppressed += 1

    def footer(self) -> None:
        if self.suppressed:
            self.env.println(f"… {self.suppressed} more")


def _trace_hosts(env: ClusterEnv) -> list[tuple[str, str]]:
    """(role, host) pairs whose /debug/traces we can poll: the master,
    every data node in its topology, and the filer when configured."""
    hosts = [("master", env.master_url)]
    try:
        for node in env.collect_ec_nodes():
            hosts.append(("volume", node.url))
    except Exception:  # noqa: BLE001 — master down; report what we can
        pass
    if env.filer_url:
        hosts.append(("filer", env.filer_url))
    return hosts


@cluster_command("trace.status")
def cmd_trace_status(env: ClusterEnv, argv: list[str]) -> None:
    """Per-server tracing state: ring occupancy and config, polled from
    each server's /debug/traces endpoint."""
    p = _parser("trace.status")
    p.parse_args(argv)
    for role, host in _trace_hosts(env):
        try:
            d = env._master_http("/debug/traces?limit=0", host=host)
        except ShellError as e:
            env.println(f"{role} {host}: unreachable ({e})")
            continue
        env.println(f"{role} {host}: enabled={d['enabled']} "
                    f"ring={d['count']}/{d['ring_size']} "
                    f"slow_threshold={d['slow_threshold_seconds']}s")


@cluster_command("ingress.status")
def cmd_ingress_status(env: ClusterEnv, argv: list[str]) -> None:
    """Per-server ingress-plane state (worker pool, queue pressure,
    parked keep-alive connections, shed counters), polled from each
    server's /debug/vars."""
    p = _parser("ingress.status")
    p.parse_args(argv)
    for role, host in _trace_hosts(env):
        try:
            d = env._master_http("/debug/vars", host=host)
        except ShellError as e:
            env.println(f"{role} {host}: unreachable ({e})")
            continue
        ing = d.get("ingress") or {}
        servers = ing.get("servers") or []
        if not servers:
            env.println(f"{role} {host}: no ingress servers")
            continue
        for s in servers:
            env.println(
                f"{role} {host}: [{s['component']}] "
                f"busy={s['busy']}/{s['workers']} "
                f"queued={s['queued']}/{s['queue_depth']} "
                f"pressure={s['pressure']:.2f} "
                f"conns={s['connections']}/{s['max_connections']} "
                f"parked={s['parked']} served={s['served_total']}")
        shed = ing.get("shed") or {}
        if shed:
            env.println(f"{role} {host}: shed " + " ".join(
                f"{k}={v}" for k, v in sorted(shed.items())))


@cluster_command("trace.dump")
def cmd_trace_dump(env: ClusterEnv, argv: list[str]) -> None:
    """Span trees of recent traces across the cluster. With -traceId,
    stitches that trace's spans from every server into one tree."""
    p = _parser("trace.dump")
    p.add_argument("-n", type=int, default=1,
                   help="recent traces per server (without -traceId)")
    p.add_argument("-traceId", default="")
    args = p.parse_args(argv)
    found = False
    if args.traceId:
        # One logical trace leaves partial span sets on several
        # processes; merge them before rendering the tree. The header
        # line comes from the ingress piece: the one with no remote
        # parent, or — when the caller supplied a parent span id, so
        # every piece has one — the piece that started first.
        pieces: list[dict] = []
        for _, host in _trace_hosts(env):
            try:
                d = env._master_http("/debug/traces", host=host)
            except ShellError:
                continue
            pieces.extend(t for t in d["traces"]
                          if t["trace_id"] == args.traceId)
        if pieces:
            root = min(pieces, key=lambda t: (t["remote_parent"] != "",
                                              t["start"]))
            spans = [s for t in pieces for s in t["spans"]]
            merged = dict(root, spans=spans, span_count=len(spans))
            env.println(tracing.render_trace(merged))
            found = True
    else:
        for role, host in _trace_hosts(env):
            try:
                d = env._master_http(f"/debug/traces?limit={args.n}",
                                     host=host)
            except ShellError:
                continue
            for t in d["traces"]:
                env.println(f"[{role} {host}]")
                env.println(tracing.render_trace(t))
                found = True
    if not found:
        env.println("trace.dump: no completed traces")


@cluster_command("trace.top")
def cmd_trace_top(env: ClusterEnv, argv: list[str]) -> None:
    """Worst cross-process traces from the master's tail-sampling
    collector (/cluster/traces): errored traces first, then slowest,
    each with a per-stage time breakdown so the slow hop is named."""
    p = _parser("trace.top")
    p.add_argument("-n", type=int, default=10,
                   help="traces to show (worst first)")
    p.add_argument("-stages", type=int, default=4,
                   help="stages to show per trace")
    args = p.parse_args(argv)
    doc = env._master_http("/cluster/traces")
    traces = doc.get("traces", [])
    if not traces:
        env.println(
            "trace.top: no traces collected yet (servers push roots "
            "slower than [tracing] push_threshold_seconds, and "
            "errored ones, to the master)")
        return
    for t in traces:
        stages: dict = {}
        for s in t.get("spans", []):
            stages[s["name"]] = (stages.get(s["name"], 0.0)
                                 + float(s.get("duration_seconds")
                                         or 0.0))
        t["_stages"] = sorted(stages.items(), key=lambda kv: kv[1],
                              reverse=True)
    traces.sort(key=lambda t: (t.get("status", "ok") == "ok",
                               -float(t.get("duration_seconds") or 0)))
    shown = traces[:max(1, args.n)]
    env.println(f"trace.top: {doc.get('count', len(traces))} stitched "
                f"traces on the master (ring {doc.get('ring_size')}, "
                f"ingested {doc.get('ingested')})")
    for t in shown:
        srcs = ",".join(sorted(t.get("sources", {})))
        env.println(
            f"{t['trace_id']}  {_fmt_ms(t.get('duration_seconds'))}ms "
            f"{t.get('status', 'ok'):<5} {t.get('name') or '?'} "
            f"[{'+'.join(t.get('reasons', []))}] "
            f"spans={t.get('span_count', 0)} sources={srcs}")
        for name, secs in t["_stages"][:max(0, args.stages)]:
            env.println(f"    {_fmt_ms(secs):>9}ms  {name}")


def _fmt_ms(seconds) -> str:
    return "-" if seconds is None else f"{seconds * 1e3:.1f}"


def _fmt_rate(v: float) -> str:
    return f"{v:.2f}" if v < 10 else f"{v:.0f}"


@cluster_command("telemetry.status")
def cmd_telemetry_status(env: ClusterEnv, argv: list[str]) -> None:
    """Per-node telemetry rollup from the master's /cluster/telemetry:
    health verdict + score, decayed op/error rates, merged read p99,
    and how many heartbeat snapshots the master has folded in."""
    p = _parser("telemetry.status")
    p.parse_args(argv)
    doc = env._master_http("/cluster/telemetry")
    nodes = doc.get("nodes", {})
    if not nodes:
        env.println("telemetry.status: no telemetry ingested yet "
                    "(volume servers report on each heartbeat)")
        return
    for url in sorted(nodes):
        n = nodes[url]
        h = n.get("health") or {}
        verdict = h.get("verdict", "unknown")
        score = h.get("score")
        env.println(
            f"{url}: {verdict}"
            + (f" (score {score})" if score is not None else "")
            + f" volumes={n.get('volume_count', 0)}"
            + f" read={_fmt_rate(n.get('read_ops_per_second', 0.0))}/s"
            + f" write={_fmt_rate(n.get('write_ops_per_second', 0.0))}/s"
            + f" err={_fmt_rate(n.get('errors_per_second', 0.0))}/s"
            + f" read_p99={_fmt_ms(n.get('read_p99_seconds'))}ms"
            + f" snapshots={n.get('snapshots', 0)}")
        for reason in h.get("reasons", []):
            env.println(f"  - {reason}")
    median = doc.get("cluster_median_read_p99_seconds")
    if median is not None:
        env.println(f"cluster median read p99: {_fmt_ms(median)}ms "
                    f"(decay halflife "
                    f"{doc.get('decay_halflife_seconds')}s, digest "
                    f"window {doc.get('digest_window_seconds')}s)")


@cluster_command("volume.heatmap")
def cmd_volume_heatmap(env: ClusterEnv, argv: list[str]) -> None:
    """Hottest volume replicas cluster-wide: decayed read/write rates,
    chunk-cache hit ratio and read p99 per (volume, node), with a bar
    scaled to the hottest row."""
    p = _parser("volume.heatmap")
    p.add_argument("-n", type=int, default=20,
                   help="rows to show (hottest first)")
    p.add_argument("-sortBy", default="reads",
                   choices=["reads", "writes", "misses", "p99"])
    args = p.parse_args(argv)
    doc = env._master_http("/cluster/telemetry")
    rows = []
    for vid, per_node in doc.get("volumes", {}).items():
        for url, r in per_node.items():
            rows.append({
                "vid": vid, "node": url,
                "collection": r.get("collection", ""),
                "reads": r.get("read_ops_per_second", 0.0),
                "writes": r.get("write_ops_per_second", 0.0),
                "hits": r.get("cache_hits", 0),
                "misses": r.get("cache_misses", 0),
                "hit_ratio": r.get("cache_hit_ratio", 0.0),
                "p99": (r.get("read_latency") or {}).get("p99"),
            })
    if not rows:
        env.println("volume.heatmap: no telemetry ingested yet")
        return
    sort_key = {"reads": lambda r: r["reads"],
                "writes": lambda r: r["writes"],
                "misses": lambda r: r["misses"],
                "p99": lambda r: r["p99"] or 0.0}[args.sortBy]
    rows.sort(key=sort_key, reverse=True)
    total_rows = len(rows)
    rows = rows[:max(1, args.n)]
    top = max(sort_key(r) for r in rows) or 1.0
    env.println(f"{'volume':>8} {'collection':<12} {'node':<21} "
                f"{'reads/s':>8} {'writes/s':>8} {'hit%':>6} "
                f"{'p99ms':>7}  heat")
    for r in rows:
        bar = "#" * max(1 if sort_key(r) > 0 else 0,
                        round(20 * sort_key(r) / top))
        looked = r["hits"] + r["misses"]
        hitp = f"{100 * r['hit_ratio']:.0f}" if looked else "-"
        env.println(
            f"{r['vid']:>8} {r['collection'] or '-':<12} "
            f"{r['node']:<21} {_fmt_rate(r['reads']):>8} "
            f"{_fmt_rate(r['writes']):>8} {hitp:>6} "
            f"{_fmt_ms(r['p99']):>7}  {bar}")
    if total_rows > len(rows):
        env.println(f"… {total_rows - len(rows)} more rows")
    # What CODE is hot on each node: the continuous profiler's top
    # stacks ride the heartbeat telemetry (leaf frame shown; the full
    # collapsed stacks come from /debug/profile on the node). Capped
    # at -n nodes: a thousand-node fleet renders a head, not a dump.
    hot = {url: n.get("hot_stacks") or []
           for url, n in doc.get("nodes", {}).items()}
    if any(hot.values()):
        env.println("hot code (continuous profiler, samples):")
        with_stacks = [u for u in sorted(hot) if hot[u]]
        for url in with_stacks[:max(1, args.n)]:
            for s in hot[url][:3]:
                leaf = s["stack"].rsplit(";", 1)[-1]
                env.println(f"  {url:<21} {s['samples']:>7}  {leaf}")
        if len(with_stacks) > args.n:
            env.println(f"… {len(with_stacks) - args.n} more nodes")


def _fmt_bytes(n: int) -> str:
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return f"{n}B"


@cluster_command("traffic.top")
def cmd_traffic_top(env: ClusterEnv, argv: list[str]) -> None:
    """Hottest object keys cluster-wide from the master's merged
    SpaceSaving sketches (/cluster/topk): count is an overestimate by
    at most the shown ±error, attributed to the recording tenant and
    volume where known."""
    p = _parser("traffic.top")
    p.add_argument("-n", type=int, default=20,
                   help="keys to show (hottest first)")
    args = p.parse_args(argv)
    doc = env._master_http(f"/cluster/topk?n={max(1, args.n)}")
    top = doc.get("top", [])
    if not top:
        env.println("traffic.top: no usage ingested yet (gateways "
                    "push snapshots, volume servers ride heartbeats)")
        return
    env.println(f"traffic.top: {doc.get('total', 0)} keyed requests "
                f"over {doc.get('sources', 0)} sources "
                f"(sketch capacity {doc.get('capacity')})")
    env.println(f"{'count':>9} {'±err':>6} {'tenant':<14} "
                f"{'volume':>6} key")
    for r in top:
        env.println(
            f"{r['count']:>9} {r.get('error', 0):>6} "
            f"{r.get('tenant') or '-':<14} "
            f"{r.get('volume') or '-':>6} {r['key']}")


@cluster_command("tenant.usage")
def cmd_tenant_usage(env: ClusterEnv, argv: list[str]) -> None:
    """Per-tenant traffic accounting from the master's merged usage
    plane (/cluster/usage): requests, bytes in/out, errors and request
    latency quantiles, broken down per bucket."""
    p = _parser("tenant.usage")
    p.add_argument("-tenant", default="",
                   help="show only this tenant")
    args = p.parse_args(argv)
    doc = env._master_http("/cluster/usage")
    tenants = doc.get("tenants", {})
    if args.tenant:
        tenants = {k: v for k, v in tenants.items()
                   if k == args.tenant}
    if not tenants:
        env.println("tenant.usage: no usage ingested yet"
                    + (f" for tenant {args.tenant!r}"
                       if args.tenant else ""))
        return
    for tenant in sorted(tenants,
                         key=lambda t: -tenants[t]["requests"]):
        t = tenants[tenant]
        env.println(
            f"{tenant}: {t['requests']} requests "
            f"in={_fmt_bytes(t['bytes_in'])} "
            f"out={_fmt_bytes(t['bytes_out'])} "
            f"errors={t['errors']}")
        for bucket in sorted(t.get("buckets", {})):
            b = t["buckets"][bucket]
            lat = b.get("latency") or {}
            env.println(
                f"  {bucket:<16} {b['requests']:>8} req "
                f"in={_fmt_bytes(b['bytes_in']):>9} "
                f"out={_fmt_bytes(b['bytes_out']):>9} "
                f"err={b['errors']}"
                + (f" p50={_fmt_ms(lat.get('p50'))}ms"
                   f" p99={_fmt_ms(lat.get('p99'))}ms"
                   if lat else ""))
    totals = doc.get("totals", {})
    env.println(
        f"total: {totals.get('requests', 0)} requests "
        f"in={_fmt_bytes(totals.get('bytes_in', 0))} "
        f"out={_fmt_bytes(totals.get('bytes_out', 0))} "
        f"errors={totals.get('errors', 0)} "
        f"(sources: {', '.join(sorted(doc.get('sources', {})))})")


@cluster_command("cluster.check")
def cmd_cluster_check(env: ClusterEnv, argv: list[str]) -> None:
    """Read-only cluster health sweep (the reference's cluster.check):
    replica deficits, EC volumes with shard-id gaps, and nodes at
    volume capacity, then the telemetry plane's node verdicts and the
    SLO engine's burn-rate states. Exits nonzero (ShellError) when
    problems exist."""
    from ..storage.superblock import ReplicaPlacement

    p = _parser("cluster.check")
    p.add_argument("-n", type=int, default=50,
                   help="max detail lines to print (counts stay "
                        "exact; 0 = summary only)")
    args = p.parse_args(argv)
    out = _CappedLines(env, args.n)
    resp = env.volume_list()
    vols: dict[int, tuple[str, int, list[str]]] = {}
    node_racks: dict[str, tuple[str, str]] = {}
    full_nodes = 0
    n_nodes = 0
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                n_nodes += 1
                node_racks[dn.id] = (dc.id, rack.id)
                if dn.max_volume_count and \
                        dn.volume_count >= dn.max_volume_count:
                    full_nodes += 1
                    out.println(f"node {dn.id} at capacity "
                                f"({dn.volume_count}/"
                                f"{dn.max_volume_count})")
                for v in dn.volume_infos:
                    col, rp, holders = vols.get(
                        v.id, (v.collection, v.replica_placement, []))
                    holders.append(dn.id)
                    vols[v.id] = (col, rp, holders)
    problems = full_nodes
    for vid, (col, rp_byte, holders) in sorted(vols.items()):
        rp = ReplicaPlacement.from_byte(rp_byte)
        want = rp.copy_count()
        if len(holders) < want:
            out.println(f"volume {vid} under-replicated: "
                        f"{len(holders)}/{want} replicas")
            problems += 1
        elif len(holders) > 1:
            # placement CONFORMANCE, not just count. Two axes, judged
            # by the placement's own semantics: diff_dc wants distinct
            # DCs; diff_rack wants distinct racks WITHIN a DC (a
            # replica in another DC must not mask two same-DC replicas
            # sharing one rack).
            violated = ""
            if rp.diff_dc:
                dcs = {node_racks.get(h, ("?", "?"))[0]
                       for h in holders}
                if len(dcs) < min(len(holders), 1 + rp.diff_dc):
                    violated = (f"{len(holders)} replicas in "
                                f"{len(dcs)} DC(s)")
            if not violated and rp.diff_rack:
                by_dc: dict[str, list[str]] = {}
                for h in holders:
                    d, r = node_racks.get(h, ("?", "?"))
                    by_dc.setdefault(d, []).append(r)
                d, rs = max(by_dc.items(), key=lambda kv: len(kv[1]))
                if len(set(rs)) < min(len(rs), 1 + rp.diff_rack):
                    violated = (f"{len(rs)} replicas in DC {d} share "
                                f"{len(set(rs))} rack(s)")
            if violated:
                out.println(f"volume {vid} placement violation: "
                            f"{violated} for placement {rp}")
                problems += 1
    # EC: shard ids present anywhere per volume; a gap below the max id
    # is definitely a missing shard (totals need the .vif, so only
    # provable gaps are reported — ec.rebuild is authoritative).
    present: dict[int, set[int]] = {}
    for n in env.collect_ec_nodes():
        for vid, sids in n.shards.items():
            present.setdefault(vid, set()).update(sids)
    for vid, sids in sorted(present.items()):
        gaps = sorted(set(range(max(sids) + 1)) - sids)
        if gaps:
            out.println(f"ec volume {vid} missing shards {gaps} "
                        f"(run ec.rebuild)")
            problems += 1
    # Node health verdicts from the telemetry plane, best-effort (an
    # old master without /cluster/telemetry still gets the topology
    # checks above). Only "unhealthy" counts as a problem: degraded
    # nodes are surfaced but a busy-yet-working cluster must not fail
    # the sweep.
    try:
        tele = env._master_http("/cluster/telemetry")
    except ShellError:
        tele = {}
    for url in sorted(tele.get("nodes", {})):
        h = tele["nodes"][url].get("health")
        if not h:
            continue
        line = f"node {url}: {h['verdict']} (score {h['score']})"
        if h.get("reasons"):
            line += " — " + "; ".join(h["reasons"])
        out.println(line)
        if h["verdict"] == "unhealthy":
            problems += 1
    # SLO burn-rate verdicts, same best-effort stance: a paging
    # objective is a problem (the budget is burning too fast on both
    # fast windows); a warning objective is surfaced only.
    try:
        slo = env._master_http("/cluster/slo")
    except ShellError:
        slo = {}
    for name in sorted(slo.get("objectives", {})):
        o = slo["objectives"][name]
        if o.get("state", "ok") == "ok":
            continue
        burns = ", ".join(f"{w}={r}" for w, r in
                          o.get("burn_rates", {}).items())
        out.println(f"slo {name}: {o['state']} (burn {burns})")
        if o["state"] == "page":
            problems += 1
    out.footer()
    env.println(f"cluster.check: {n_nodes} nodes, {len(vols)} volumes, "
                f"{len(present)} ec volumes, {problems} problems")
    if problems:
        raise ShellError(f"cluster.check: {problems} problems found")


def run_cluster_command(env: ClusterEnv, line: str) -> None:
    parts = shlex.split(line)
    if not parts:
        return
    name, argv = parts[0], parts[1:]
    if name in ("help", "?"):
        for c in sorted(CLUSTER_COMMANDS):
            env.println(c)
        return
    fn = CLUSTER_COMMANDS.get(name)
    if fn is None:
        raise ShellError(f"unknown command {name!r} (try 'help')")
    try:
        with tracing.start_trace(f"shell.{name}"):
            if name in DESTRUCTIVE_COMMANDS:
                # mutating choreography runs under the master's
                # exclusive admin lease: held REPL locks pass through,
                # one-shots acquire/release around this single command
                with env.exclusive():
                    fn(env, argv)
            else:
                fn(env, argv)
    except ShellError:
        raise
    except (argparse.ArgumentError, SystemExit) as e:
        raise ShellError(f"{name}: bad arguments ({e})") from None
    except Exception as e:
        raise ShellError(f"{name}: {e}") from None
