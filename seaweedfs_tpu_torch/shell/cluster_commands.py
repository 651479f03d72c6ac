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
``collection.list``, ``cluster.status``, ``lock``, ``unlock``,
``job.submit``, ``job.status``, ``job.pause``, ``job.resume``,
``job.cancel``, ``scrub.start`` and ``scrub.status``. The other cluster
commands, the filer and ``fs.*`` come with later slices (ROADMAP
Queue 1).
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
from ..util import retry, security
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
    #: Shared cluster signing key (security.toml jwt.signing.key); when
    #: set, volume-server rpcs carry the cluster bearer token.
    secret: str = ""
    out: io.TextIOBase = None  # type: ignore[assignment]
    _channels: dict = field(default_factory=dict)
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

    def close(self) -> None:
        if self.locked:
            try:
                self.admin_unlock()
            except ShellError:
                pass
        for ch in self._channels.values():
            ch.close()
        self._channels.clear()

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
        if name in DESTRUCTIVE_COMMANDS:
            # mutating choreography runs under the master's exclusive
            # admin lease: held REPL locks pass through, one-shots
            # acquire/release around this single command
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
