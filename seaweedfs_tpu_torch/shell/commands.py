"""Shell command registry: ec.encode / ec.decode / ec.rebuild / ec.balance
plus volume housekeeping.

The port of the offline part of ``seaweedfs_tpu/shell/commands.py``
(weed/shell/command_ec_encode.go, command_ec_decode.go,
command_ec_rebuild.go, command_ec_balance.go, command_volume_*.go): the
commands run against a CommandEnv that wraps local disk locations (a
Store) and the device the EC pipelines run on. Command syntax and
semantics stay the reference's:

    ec.encode  -volumeId 3 [-collection c]   seal volume into shards+.ecx
    ec.decode  -volumeId 3                   shards back to .dat/.idx
    ec.rebuild [-volumeId 3]                 regenerate missing shards
    ec.balance                               spread shards over locations
    volume.list                              registry snapshot
    volume.delete -volumeId 3                drop a volume's files
    volume.vacuum [-volumeId 3]              compact away deleted needles
    fault.inject -point P -spec S            arm a fault point
    fault.list                               armed faults + the catalog
    fault.clear [-point P]                   disarm one point, or all
    pipeline.status                          config + recent runs
    pipeline.dump -trace F                   flight recorder -> trace
    pipeline.analyze [-all]                  bottleneck verdict
    volume.tier.upload -volumeId 3 -dest h:p/bucket  .dat to the S3 tier
    volume.tier.download -volumeId 3         .dat back to local disk
    cache.status                             chunk-cache counters
    cache.clear                              drop every cached chunk
    ckpt.save -gateway h:p -name N           seeded sharded checkpoint
    ckpt.restore -gateway h:p -name N        restore onto the mesh
    ckpt.list -gateway h:p                   committed checkpoints
    trace.status                             tracing config + span counts
    trace.dump [-n 3] [-traceId T]           recent traces' span trees

``ec.encode`` and ``ec.rebuild`` take ``-mesh dp,sp`` (or ``auto``):
split the command's pipeline work over a (dp, sp) mesh of the local
devices of the env's device type (parallel/mesh.py), over whatever the
shell's ``-config`` set in ``[mesh]``. The ``pipeline.*`` commands read
back what ``[pipeline]``, ``[mesh]`` and ``[flight]`` set and what the
session's runs recorded. ``fault.clear -breakers`` also resets the
retry layer's circuit breakers (util/retry.py). ``ckpt.*`` run on the
env's device (None = the card) and take ``-mesh`` too. Every command
runs under a ``shell.<name>`` trace root, which ``trace.status`` and
``trace.dump`` read back from this process's ring.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import shlex
import shutil
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from ..ops import rs_torch
from ..parallel import mesh as mesh_mod
from ..pipeline import decode as decode_mod
from ..pipeline import encode as encode_mod
from ..pipeline import flight
from ..pipeline import pipe
from ..pipeline import rebuild as rebuild_mod
from ..pipeline.scheme import DEFAULT_SCHEME, EcScheme
from ..storage import ec_files
from ..storage.store import Store, StoreError, volume_base_name
from ..storage.volume import Volume
from ..util import faults, retry


class ShellError(RuntimeError):
    pass


@dataclass
class CommandEnv:
    """What a command needs to run: a Store over directories, where to
    print, the default EC scheme, and the device of the EC pipelines
    (None = the card; "cpu" runs the plain PyTorch codec)."""

    store: Store
    out: io.TextIOBase = None  # type: ignore[assignment]
    scheme: EcScheme = DEFAULT_SCHEME
    device: object = None

    def __post_init__(self):
        if self.out is None:
            self.out = sys.stdout

    def println(self, *args) -> None:
        print(*args, file=self.out)


COMMANDS: dict[str, Callable[[CommandEnv, list[str]], None]] = {}


def command(name: str):
    def register(fn):
        COMMANDS[name] = fn
        return fn
    return register


def _parser(name: str) -> argparse.ArgumentParser:
    # exit_on_error=False so bad flags raise instead of sys.exit()ing the
    # REPL; prefix matching off to keep flag names exact like Go's flag.
    return argparse.ArgumentParser(prog=name, exit_on_error=False,
                                   allow_abbrev=False)


def _scheme_arg(s: Optional[str], default: EcScheme) -> EcScheme:
    if not s:
        return default
    try:
        k, m = (int(x) for x in s.split(","))
    except ValueError:
        raise ShellError(f"bad -scheme {s!r}, want k,m") from None
    return EcScheme(data_shards=k, parity_shards=m,
                    large_block_size=default.large_block_size,
                    small_block_size=default.small_block_size)


def _device(env: CommandEnv):
    """The pipelines' device, resolved before a command touches any
    file: without a card, a command that needs one fails here (the
    RuntimeError becomes a ShellError) and never carries on on the
    CPU."""
    return rs_torch.resolve_device(env.device)


@contextlib.contextmanager
def _mesh_scope(spec: str, device):
    """``-mesh dp,sp`` for ec.encode/ec.rebuild: pin the device mesh over
    the local devices of ``device``'s type for the command's pipeline
    work (parallel/mesh.scoped — validated against the device count
    BEFORE any volume is touched). An empty spec keeps the ambient
    routing."""
    if not spec:
        yield None
        return
    try:
        with mesh_mod.scoped(spec, device.type) as m:
            yield m
    except mesh_mod.MeshConfigError as e:
        raise ShellError(str(e)) from e


def _ec_bases(env: CommandEnv) -> list[tuple[str, int, Path]]:
    """Every (collection, vid, base) with EC artifacts in any location."""
    out = []
    for loc in env.store.locations:
        for col, vid, base, _ids in loc.scan_ec_shards():
            out.append((col, vid, base))
    return out


@command("ec.encode")
def cmd_ec_encode(env: CommandEnv, argv: list[str]) -> None:
    """Seal a volume: stripe + encode on the env's device into k+m
    shard files, write the sorted .ecx and .vif, delete the source
    .dat/.idx — the single-node form of command_ec_encode.go's
    choreography (mark readonly -> VolumeEcShardsGenerate -> spread ->
    delete source)."""
    p = _parser("ec.encode")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-scheme", default="")
    p.add_argument("-keepSource", action="store_true")
    p.add_argument("-mesh", default="",
                   help="encode on a dp,sp device mesh (or 'auto'); "
                        "dp*sp must equal the local device count")
    args = p.parse_args(argv)
    scheme = _scheme_arg(args.scheme, env.scheme)
    device = _device(env)
    # the mesh is validated here, before any volume is touched
    with _mesh_scope(args.mesh, device):
        store = env.store
        vol = store.volumes.get((args.collection, args.volumeId))
        if vol is not None:
            vol.sync()
            base = vol.base
            replication = str(vol.super_block.replica_placement)
        else:
            base = next(
                (loc.base_for(args.volumeId, args.collection)
                 for loc in store.locations
                 if loc.base_for(args.volumeId, args.collection)
                 .with_suffix(".dat").exists()),
                None)
            if base is None:
                raise ShellError(f"volume {args.volumeId} not found")
            replication = ""
        # the encode reads the .dat through its own descriptor, closed
        # when it returns; the Volume's handles close in delete_volume
        vi = encode_mod.encode_volume(base, scheme,
                                      replication=replication,
                                      remove_source=False, device=device)
        if not args.keepSource:
            if vol is not None:
                store.delete_volume(args.volumeId, args.collection)
            else:
                for ext in (".dat", ".idx"):
                    q = Path(str(base) + ext)
                    if q.exists():
                        q.unlink()
        store.mount_ec_shards(args.volumeId,
                              list(range(scheme.total_shards)),
                              args.collection)
        env.println(f"ec.encode volume {args.volumeId}: "
                    f"{scheme.total_shards} shards, version {vi.version}")


@command("ec.decode")
def cmd_ec_decode(env: CommandEnv, argv: list[str]) -> None:
    """Shards -> normal volume again (command_ec_decode.go /
    VolumeEcShardsToVolume): restore .dat+.idx, drop EC artifacts,
    register the volume."""
    p = _parser("ec.decode")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-scheme", default="")
    args = p.parse_args(argv)
    scheme = _scheme_arg(args.scheme, env.scheme)
    device = _device(env)
    store = env.store
    base = store.gather_ec_volume(args.volumeId, args.collection)
    size = decode_mod.decode_volume(base, scheme, device=device)
    store.unmount_ec_shards(args.volumeId,
                            list(range(scheme.total_shards)),
                            args.collection)
    store.remove_ec_volume_files(args.volumeId, args.collection)
    old = store.volumes.pop((args.collection, args.volumeId), None)
    if old is not None:
        old.close()
    # load() runs the tail-integrity check, which may truncate a torn
    # tail and then reopens its .dat
    store.volumes[(args.collection, args.volumeId)] = \
        Volume(base, args.volumeId).load()
    env.println(f"ec.decode volume {args.volumeId}: {size} bytes restored")


@command("ec.rebuild")
def cmd_ec_rebuild(env: CommandEnv, argv: list[str]) -> None:
    """Regenerate missing shard files for one or all EC volumes
    (command_ec_rebuild.go -> VolumeEcShardsRebuild)."""
    p = _parser("ec.rebuild")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-scheme", default="")
    p.add_argument("-mesh", default="",
                   help="rebuild on a dp,sp device mesh (or 'auto'); "
                        "dp*sp must equal the local device count")
    args = p.parse_args(argv)
    scheme = _scheme_arg(args.scheme, env.scheme)
    device = _device(env)
    store = env.store
    targets: list[tuple[str, int]] = []
    if args.volumeId:
        targets.append((args.collection, args.volumeId))
    else:
        targets = sorted({(col, vid) for col, vid, _ in _ec_bases(env)})
    with _mesh_scope(args.mesh, device):
        for col, vid in targets:
            base = store.gather_ec_volume(vid, col)
            rebuilt = rebuild_mod.rebuild_ec_files(base, scheme,
                                                   device=device)
            if rebuilt:
                store.mount_ec_shards(vid, rebuilt, col)
            env.println(f"ec.rebuild volume {vid}: "
                        f"rebuilt {rebuilt if rebuilt else 'nothing'}")


@command("ec.balance")
def cmd_ec_balance(env: CommandEnv, argv: list[str]) -> None:
    """Spread each EC volume's shard files evenly across disk locations
    (command_ec_balance.go's rack-aware spreading, with locations standing
    in for servers in local mode)."""
    p = _parser("ec.balance")
    p.parse_args(argv)
    store = env.store
    locs = [l.directory for l in store.locations]
    if len(locs) < 2:
        env.println("ec.balance: single location, nothing to do")
        return
    moved = 0
    for col, vid in sorted({(c, v) for c, v, _ in _ec_bases(env)}):
        name = volume_base_name(vid, col)
        # Drop gather-created symlink caches first: balancing must move
        # only real files (renaming a symlink over its own target would
        # destroy the shard).
        real: dict[int, Path] = {}
        for d in locs:
            base = d / name
            for sid in range(100):
                p_ = ec_files.shard_path(base, sid)
                if p_.is_symlink():
                    p_.unlink()
                elif p_.exists():
                    real.setdefault(sid, p_)
        for rank, sid in enumerate(sorted(real)):
            src = real[sid]
            dst = ec_files.shard_path(locs[rank % len(locs)] / name, sid)
            if src == dst:
                continue
            # shutil.move: disk locations are usually separate
            # filesystems, where rename() fails with EXDEV
            shutil.move(str(src), str(dst))
            moved += 1
        # every location serving shards needs the index + volume info
        src_base = next((d / name for d in locs
                         if ec_files.ecx_path(d / name).exists()), None)
        if src_base is not None:
            for d in locs:
                for pathfn in (ec_files.ecx_path, ec_files.vif_path):
                    s, t = pathfn(src_base), pathfn(d / name)
                    if s.exists() and s != t and not t.exists():
                        t.write_bytes(s.read_bytes())
    env.println(f"ec.balance: moved {moved} shards over {len(locs)} "
                f"locations")


@command("volume.list")
def cmd_volume_list(env: CommandEnv, argv: list[str]) -> None:
    p = _parser("volume.list")
    p.parse_args(argv)
    st = env.store.status()
    for v in st["volumes"]:
        env.println(f"volume {v['id']} collection={v['collection'] or '-'} "
                    f"size={v['size']} files={v['file_count']} "
                    f"deleted={v['deleted_count']}")
    for e in st["ec_shards"]:
        bits = ec_files.ShardBits(e["ec_index_bits"])
        env.println(f"ec volume {e['id']} "
                    f"collection={e['collection'] or '-'} "
                    f"shards={bits.ids()}")
    if not st["volumes"] and not st["ec_shards"]:
        env.println("no volumes")


def _volume_base(env: CommandEnv, vid: int, collection: str):
    """(volume, base) for a volume id — open in the store or on disk."""
    vol = env.store.volumes.get((collection, vid))
    if vol is not None:
        return vol, vol.base
    base = next(
        (loc.base_for(vid, collection)
         for loc in env.store.locations
         if Path(str(loc.base_for(vid, collection)) + ".dat").exists()
         or Path(str(loc.base_for(vid, collection)) + ".tier").exists()),
        None)
    if base is None:
        raise ShellError(f"volume {vid} not found")
    return None, base


@command("volume.tier.upload")
def cmd_volume_tier_upload(env: CommandEnv, argv: list[str]) -> None:
    """Move a volume's .dat to an S3 endpoint (the project's own
    gateway works) and keep serving reads through ranged GETs —
    command_volume_tier_upload.go over Store.tier_move. The hot .idx
    stays local; the volume becomes read-only until tier.download."""
    from ..storage import tier as tier_mod
    p = _parser("volume.tier.upload")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dest", required=True,
                   help="endpoint/bucket, e.g. 127.0.0.1:8333/coldstore")
    p.add_argument("-accessKey", default="")
    p.add_argument("-secretKey", default="")
    p.add_argument("-keepLocal", action="store_true")
    args = p.parse_args(argv)
    endpoint, _, bucket = args.dest.rpartition("/")
    if not endpoint or not bucket:
        raise ShellError(f"bad -dest {args.dest!r}, want endpoint/bucket")
    vol, base = _volume_base(env, args.volumeId, args.collection)
    if vol is not None:
        info = env.store.tier_move(
            args.volumeId, args.collection, endpoint=endpoint,
            bucket=bucket, keep_local=args.keepLocal,
            access_key=args.accessKey, secret_key=args.secretKey)
    else:
        # offline base (not registered in the store): move the files
        info = tier_mod.upload_volume_dat(
            base, endpoint, bucket,
            access_key=args.accessKey, secret_key=args.secretKey,
            remove_local=not args.keepLocal)
    env.println(f"volume.tier.upload {args.volumeId}: {info.size} bytes "
                f"-> {info.endpoint}/{info.bucket}/{info.key}"
                + (" (local copy kept)" if args.keepLocal else ""))


@command("volume.tier.download")
def cmd_volume_tier_download(env: CommandEnv, argv: list[str]) -> None:
    """Bring a tiered volume's .dat back to local disk and drop the
    sidecar (command_volume_tier_download.go over Store.tier_restore)."""
    from ..storage import tier as tier_mod
    p = _parser("volume.tier.download")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)
    vol, base = _volume_base(env, args.volumeId, args.collection)
    if vol is not None:
        env.store.tier_restore(args.volumeId, args.collection)
    else:
        tier_mod.download_volume_dat(base)
    env.println(f"volume.tier.download {args.volumeId}: local again")


@command("volume.delete")
def cmd_volume_delete(env: CommandEnv, argv: list[str]) -> None:
    p = _parser("volume.delete")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)
    env.store.delete_volume(args.volumeId, args.collection)
    env.println(f"volume.delete {args.volumeId}: done")


@command("volume.vacuum")
def cmd_volume_vacuum(env: CommandEnv, argv: list[str]) -> None:
    """Compact away deleted needles (volume_vacuum.go Compact +
    CommitCompact), reclaiming the space delete tombstones only mark."""
    p = _parser("volume.vacuum")
    p.add_argument("-volumeId", type=int, default=0,
                   help="one volume (default: all above threshold)")
    p.add_argument("-collection", default="")
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    args = p.parse_args(argv)
    targets = [(args.collection, args.volumeId)] if args.volumeId else \
        sorted(k for k in env.store.volumes
               if not args.collection or k[0] == args.collection)
    for col, vid in targets:
        ratio = env.store.garbage_ratio(vid, col)
        threshold = 0.0 if args.volumeId else args.garbageThreshold
        new_size = env.store.vacuum_volume(vid, col, threshold)
        if new_size is None:
            env.println(f"volume.vacuum {vid}: garbage {ratio:.1%} "
                        f"below threshold, skipped")
        else:
            env.println(f"volume.vacuum {vid}: garbage {ratio:.1%} "
                        f"reclaimed, now {new_size} bytes")


@command("trace.status")
def cmd_trace_status(env: CommandEnv, argv: list[str]) -> None:
    """Tracing config + ring-buffer occupancy + per-stage span counts
    of this process (docs/observability.md)."""
    p = _parser("trace.status")
    p.parse_args(argv)
    from ..util import tracing
    payload = tracing.debug_payload()
    env.println(f"trace.status enabled={payload['enabled']} "
                f"ring={payload['count']}/{payload['ring_size']} "
                f"slow_threshold="
                f"{payload['slow_threshold_seconds']}s")
    stages: dict[str, int] = {}
    for t in payload["traces"]:
        for s in t["spans"]:
            stages[s["name"]] = stages.get(s["name"], 0) + 1
    for name in sorted(stages):
        env.println(f"  {name}: {stages[name]} spans")


@command("trace.dump")
def cmd_trace_dump(env: CommandEnv, argv: list[str]) -> None:
    """Span trees of the most recent completed traces."""
    p = _parser("trace.dump")
    p.add_argument("-n", type=int, default=3,
                   help="how many recent traces to print")
    p.add_argument("-traceId", default="",
                   help="dump one specific trace id")
    args = p.parse_args(argv)
    from ..util import tracing
    traces = tracing.recent_traces()
    if args.traceId:
        traces = [t for t in traces if t["trace_id"] == args.traceId]
    else:
        traces = traces[-max(0, args.n):]
    if not traces:
        env.println("trace.dump: no completed traces")
        return
    for t in traces:
        env.println(tracing.render_trace(t))


@command("fault.inject")
def cmd_fault_inject(env: CommandEnv, argv: list[str]) -> None:
    """Arm a fault at a named point:
    fault.inject -point ec.shard_read -spec error@0.5#10"""
    p = _parser("fault.inject")
    p.add_argument("-point", required=True,
                   help="fault point name (see fault.list)")
    p.add_argument("-spec", required=True,
                   help="action[@probability][:param][#count]")
    p.add_argument("-seed", type=int, default=None,
                   help="override the deterministic replay seed")
    args = p.parse_args(argv)
    try:
        fs = faults.inject(args.point, args.spec, seed=args.seed)
    except faults.FaultSpecError as e:
        raise ShellError(f"fault.inject: {e}") from None
    env.println(f"fault.inject: armed {fs.point}={fs.spec}")


@command("fault.list")
def cmd_fault_list(env: CommandEnv, argv: list[str]) -> None:
    """Armed fault specs (with hit counts) and the point catalog."""
    p = _parser("fault.list")
    p.parse_args(argv)
    payload = faults.debug_payload()
    env.println(f"fault.list: enabled={payload['enabled']} "
                f"seed={payload['seed']} "
                f"armed={len(payload['specs'])}")
    for s in payload["specs"]:
        left = "unbounded" if s["remaining"] < 0 else s["remaining"]
        env.println(f"  {s['point']}={s['spec']} hits={s['hits']} "
                    f"remaining={left}")
    env.println("  points: " + ", ".join(faults.CATALOG))


@command("fault.clear")
def cmd_fault_clear(env: CommandEnv, argv: list[str]) -> None:
    """Disarm one fault point (or all), optionally also forgetting
    circuit-breaker state accumulated while faults were armed."""
    p = _parser("fault.clear")
    p.add_argument("-point", default="",
                   help="one point to disarm (default: all)")
    p.add_argument("-breakers", action="store_true",
                   help="also reset all circuit breakers")
    args = p.parse_args(argv)
    faults.clear(args.point or None)
    if args.breakers:
        retry.reset_breakers()
    env.println("fault.clear: "
                + (args.point or "all points") + " disarmed"
                + (" + breakers reset" if args.breakers else ""))


def _ckpt_store(gateway: str, bucket: str):
    from ..ckpt import CheckpointStore
    if not gateway:
        raise ShellError("ckpt.*: -gateway host:port is required")
    return CheckpointStore(gateway, bucket=bucket)


@command("ckpt.save")
def cmd_ckpt_save(env: CommandEnv, argv: list[str]) -> None:
    """Save a seeded synthetic sharded tree through the S3 gateway —
    the operator-facing probe of the checkpoint plane (a real training
    job calls CheckpointStore.save on its own params)."""
    p = _parser("ckpt.save")
    p.add_argument("-gateway", default="", help="S3 gateway host:port")
    p.add_argument("-bucket", default="ckpt")
    p.add_argument("-name", required=True)
    p.add_argument("-mesh", default="",
                   help="dp,sp device mesh (default: configured)")
    p.add_argument("-params", type=int, default=2)
    p.add_argument("-rows", type=int, default=256)
    p.add_argument("-cols", type=int, default=64)
    p.add_argument("-seed", type=int, default=0,
                   help="seeds a torch.Generator whose normal draws fill "
                        "the params (not the JAX package's jax.random "
                        "values; the geometry is the same)")
    args = p.parse_args(argv)
    import torch

    from ..ckpt import sharding as sharding_mod

    store = _ckpt_store(args.gateway, args.bucket)
    device = _device(env)
    with _mesh_scope(args.mesh, device):
        mesh = sharding_mod.local_mesh(device)
        sh = sharding_mod.NamedSharding(
            mesh, sharding_mod.PartitionSpec("dp", "sp"))
        gen = torch.Generator().manual_seed(args.seed)
        tree = {f"param{i}": sharding_mod.device_put(
                    torch.randn((args.rows, args.cols), generator=gen), sh)
                for i in range(args.params)}
        man = store.save(args.name, tree)
    shards = sum(len(pp.shards) for pp in man.params)
    nbytes = sum(s.nbytes for pp in man.params for s in pp.shards)
    env.println(f"ckpt.save {args.name}: {len(man.params)} params "
                f"{shards} shards {nbytes} bytes "
                f"-> s3://{args.bucket}")


@command("ckpt.restore")
def cmd_ckpt_restore(env: CommandEnv, argv: list[str]) -> None:
    """Restore a checkpoint onto the configured mesh of the env's
    device; prints per-param geometry and the ranged-read profile (each
    process reads only its own blocks' byte ranges)."""
    p = _parser("ckpt.restore")
    p.add_argument("-gateway", default="", help="S3 gateway host:port")
    p.add_argument("-bucket", default="ckpt")
    p.add_argument("-name", required=True)
    p.add_argument("-mesh", default="",
                   help="dp,sp device mesh (default: configured)")
    args = p.parse_args(argv)
    from ..ckpt import CheckpointError, ManifestError
    from ..ckpt.sharding import dtype_name

    store = _ckpt_store(args.gateway, args.bucket)
    device = _device(env)
    try:
        with _mesh_scope(args.mesh, device):
            arrays = store.restore(args.name, device=device)
    except (CheckpointError, ManifestError) as e:
        raise ShellError(str(e)) from e
    for name in sorted(arrays):
        a = arrays[name]
        env.println(f"  {name}: {dtype_name(a.dtype)}{list(a.shape)} "
                    f"spec={a.spec}")
    st = store.client.stats
    env.println(f"ckpt.restore {args.name}: {len(arrays)} params, "
                f"{st['ranged_gets']} ranged reads "
                f"{st['bytes_in']} bytes in")


@command("ckpt.list")
def cmd_ckpt_list(env: CommandEnv, argv: list[str]) -> None:
    """Committed checkpoints visible on the gateway (uncommitted saves
    have no manifest and are invisible, same as restore's view)."""
    p = _parser("ckpt.list")
    p.add_argument("-gateway", default="", help="S3 gateway host:port")
    p.add_argument("-bucket", default="ckpt")
    args = p.parse_args(argv)
    store = _ckpt_store(args.gateway, args.bucket)
    rows = store.list_checkpoints()
    for r in rows:
        env.println(f"  {r['name']}: params={r['params']} "
                    f"shards={r['shards']} bytes={r['bytes']}")
    env.println(f"ckpt.list: {len(rows)} checkpoint(s) in "
                f"s3://{args.bucket}")


@command("pipeline.status")
def cmd_pipeline_status(env: CommandEnv, argv: list[str]) -> None:
    """Overlapped-ingest-plane config + per-run stage breakdowns of
    this process."""
    p = _parser("pipeline.status")
    p.parse_args(argv)
    cfg = pipe.current()
    # the JAX package's line: the grouped-dispatch fields are shown as
    # set, though the port reads them nowhere (pipeline/pipe.py)
    env.println(
        f"pipeline.status depth={cfg.depth} "
        f"batch_bytes={cfg.batch_bytes} "
        f"grouped_batch_bytes={cfg.grouped_batch_bytes} "
        f"group_cap={cfg.group_cap or 'env'} "
        f"writers={cfg.writer_threads}x{cfg.writer_queue_depth} "
        f"feedback={cfg.feedback} overlapped={cfg.overlapped} "
        f"preallocate={cfg.preallocate} "
        f"double_buffer={cfg.double_buffer}")
    # read the mesh module as the JAX shell reads its own: only when
    # something imported it
    mesh = sys.modules.get("seaweedfs_tpu_torch.parallel.mesh")
    if mesh is not None:
        mp = mesh.debug_payload()
        if mp["batches"] or mp["configured"]["enabled"]:
            env.println(
                f"  mesh: axes=dp{mp['axes']['dp']}xsp{mp['axes']['sp']}"
                f" batches={mp['batches']} in={mp['bytes_in']}B "
                f"dispatch={mp['dispatch_seconds']}s "
                f"collective={mp['collective_seconds']}s "
                f"configured={mp['configured']}")
    pay = pipe.debug_payload()
    env.println(
        f"  totals: runs={pay['runs']} batches={pay['batches']} "
        f"in={pay['bytes_in']}B out={pay['bytes_out']}B "
        f"read={pay['read_seconds']}s compute={pay['compute_seconds']}s "
        f"write={pay['write_seconds']}s wall={pay['wall_seconds']}s")

    def _busy(run: dict) -> str:
        # busy FRACTION of the run's wall window, not raw thread-seconds:
        # stage sums add seconds from several threads (the writeback
        # workers alone), so a share above 100% would mean nothing
        wall = run.get("wall") or 0.0
        if wall <= 0:
            return "busy=n/a"
        return ("busy read={:.0%} compute={:.0%} write={:.0%}".format(
            min(1.0, run["read"] / wall),
            min(1.0, run["compute"] / wall),
            min(1.0, run["write"] / wall)))

    for run in pay["recent"]:
        env.println(
            f"  {run['kind']}: {run['batches']} batches "
            f"in {run['groups']} dispatches (max group "
            f"{run['max_group']}) {run['bytes_in']}B "
            f"{_busy(run)} wall={run['wall']}s "
            f"{run.get('gibps', 0)} GiB/s")
    fp = flight.debug_payload()
    last = fp.get("last_run")
    if last:
        # recorder-derived occupancy: measured against the recorded wall
        # window, the honest version of the busy lines above
        frac = " ".join(f"{k}={v:.0%}"
                        for k, v in last["busy_fraction"].items())
        env.println(f"  flight: window={last['window_seconds']}s "
                    f"batches={last['batches']} {frac}")
        env.println(f"  flight: {last['verdict']}")
    elif fp.get("armed"):
        env.println("  flight: armed, no recorded run yet")


def _require_armed() -> None:
    if not flight.armed():
        raise ShellError(
            "flight recorder not armed — set [flight] enabled = true "
            "or SEAWEEDFS_TORCH_FLIGHT=1 and rerun the pipeline")


@command("pipeline.dump")
def cmd_pipeline_dump(env: CommandEnv, argv: list[str]) -> None:
    """Export the flight recorder's window as Chrome trace-event JSON
    (open in Perfetto or chrome://tracing — one track per stage thread
    plus queue-depth / pool-occupancy counter tracks)."""
    p = _parser("pipeline.dump")
    p.add_argument("-trace", required=True,
                   help="output path for the trace JSON")
    args = p.parse_args(argv)
    _require_armed()
    n = flight.dump_trace(args.trace)
    env.println(f"pipeline.dump: {n} trace events -> {args.trace} "
                f"(load in Perfetto / chrome://tracing)")


@command("pipeline.analyze")
def cmd_pipeline_analyze(env: CommandEnv, argv: list[str]) -> None:
    """Name the recorded window's bottleneck stage and recommend
    [pipeline] knob changes, with the occupancy evidence printed
    alongside."""
    p = _parser("pipeline.analyze")
    p.add_argument("-all", action="store_true",
                   help="analyze the whole ring, not just the last run")
    args = p.parse_args(argv)
    _require_armed()
    ana = flight.analyze(last_run_only=not args.all)
    if ana["bottleneck"] is None:
        env.println("pipeline.analyze: no recorded batches")
        return
    occ = ana["occupancy"]
    env.println(f"pipeline.analyze: {ana['verdict']}")
    env.println(f"  window={occ['window_seconds']}s "
                f"batches={occ['batches']} events={occ['events']}")
    for stage in sorted(occ["busy_fraction"],
                        key=occ["busy_fraction"].get, reverse=True):
        frac = occ["busy_fraction"][stage]
        line = f"  {stage}: busy={frac:.1%}"
        bub = occ["bubble_seconds"].get(stage)
        if bub is not None:
            line += f" bubble={bub}s"
        env.println(line)
    if occ["waited_on"]:
        waits = ", ".join(
            f"{k}={v}" for k, v in sorted(occ["waited_on"].items(),
                                          key=lambda kv: -kv[1]))
        env.println(f"  per-batch critical path (batches that waited "
                    f"longest on each stage): {waits}")
    env.println("  recommendations:")
    for rec in ana["recommendations"]:
        env.println(f"   - {rec}")


@command("cache.status")
def cmd_cache_status(env: CommandEnv, argv: list[str]) -> None:
    """Hit/miss/eviction and occupancy counters of the process-wide
    chunk cache (docs/cache.md)."""
    p = _parser("cache.status")
    p.parse_args(argv)
    from ..cache import global_chunk_cache, invalidation
    st = global_chunk_cache().stats()
    env.println(f"cache.status hits={st['hits']} misses={st['misses']} "
                f"hit_ratio={st['hit_ratio']:.3f}")
    env.println(f"  memory: {st['memory_entries']} entries "
                f"{st['memory_bytes']}/{st['memory_capacity']} bytes "
                f"(protected={st['protected_bytes']} "
                f"probation={st['probation_bytes']})")
    if "disk_entries" in st:
        env.println(f"  disk: {st['disk_entries']} entries "
                    f"{st['disk_bytes']}/{st['disk_capacity']} bytes")
        env.println(f"  compaction: "
                    f"{'on' if st['disk_compaction'] else 'off'} "
                    f"segments={st['compactions']} "
                    f"bytes_copied={st['compaction_bytes_copied']} "
                    f"bytes_dropped={st['compaction_bytes_dropped']}")
    else:
        env.println("  disk: tier disabled")
    env.println(f"  evictions={st['evictions']} "
                f"admission_rejects={st['admission_rejects']} "
                f"ttl_seconds={st['ttl_seconds']}")
    from ..cache import readahead
    ra = readahead.stats()
    env.println(f"  readahead: windows_open={ra['windows_open']} "
                f"opened={ra['windows_opened']} "
                f"prefetch={ra['prefetch_issued']} "
                f"({ra['prefetch_bytes']} bytes) "
                f"hits={ra['prefetch_hits']} "
                f"wasted={ra['prefetch_wasted']} "
                f"dropped={ra['prefetch_dropped']}")
    per_vol = global_chunk_cache().per_volume_counts()
    if per_vol:
        def ratio(c: dict) -> float:
            looked = c.get("hits", 0) + c.get("misses", 0)
            return c.get("hits", 0) / looked if looked else 0.0
        env.println("  per volume (hit ratio desc):")
        for vid in sorted(per_vol, key=lambda v: -ratio(per_vol[v])):
            c = per_vol[vid]
            env.println(
                f"    volume {vid}: hits={c.get('hits', 0)} "
                f"misses={c.get('misses', 0)} "
                f"rejects={c.get('rejects', 0)} "
                f"hit_ratio={ratio(c):.3f}")
    if invalidation.events:
        pairs = " ".join(f"{k}={v}"
                         for k, v in sorted(invalidation.events.items()))
        env.println(f"  invalidations: {pairs}")


@command("cache.clear")
def cmd_cache_clear(env: CommandEnv, argv: list[str]) -> None:
    """Drop every cached chunk (memory and disk tiers)."""
    p = _parser("cache.clear")
    p.parse_args(argv)
    from ..cache import global_chunk_cache
    cache = global_chunk_cache()
    st = cache.stats()
    dropped = st["memory_entries"] + st.get("disk_entries", 0)
    cache.clear()
    env.println(f"cache.clear: dropped {dropped} entries")


def run_command(env: CommandEnv, line: str) -> None:
    """Parse and run one shell line."""
    parts = shlex.split(line)
    if not parts:
        return
    name, argv = parts[0], parts[1:]
    if name in ("help", "?"):
        for c in sorted(COMMANDS):
            env.println(c)
        return
    fn = COMMANDS.get(name)
    if fn is None:
        raise ShellError(f"unknown command {name!r} (try 'help')")
    from ..util import tracing
    try:
        with tracing.start_trace(f"shell.{name}"):
            fn(env, argv)
    except ShellError:
        raise
    except (argparse.ArgumentError, SystemExit) as e:
        raise ShellError(f"{name}: bad arguments ({e})") from None
    except (StoreError, OSError, RuntimeError) as e:
        raise ShellError(f"{name}: {e}") from None
