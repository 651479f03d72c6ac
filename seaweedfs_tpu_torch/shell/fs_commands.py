"""Filer (fs.*) shell commands.

Mirrors weed/shell's command_fs_*.go family (SURVEY.md §2 "Shell"):
path-level operations against a live filer — listing, usage accounting,
cat, rm, mkdir, mv — plus ``fs.meta.save`` / ``fs.meta.load``, which
dump and restore the metadata tree (entries WITH their chunk manifests,
like the reference's fs.meta pair) so a namespace can be backed up or
seeded without copying blob data.

Registered into the cluster-mode registry (they need a -filer url on
the shell; local -dir mode has no filer to talk to).

The port of ``seaweedfs_tpu/shell/fs_commands.py``, whole: ``fs.*``,
``fs.meta.*``, ``fs.configure``, and the gateway's ``s3.bucket.*``,
``s3.clean.uploads`` and ``s3.configure``.
"""

from __future__ import annotations

import json

from ..pb import filer_pb2
from .cluster_commands import ClusterEnv, cluster_command
from .commands import ShellError, _parser


def _fc(env: ClusterEnv):
    c = env.filer_client()
    if c is None:
        raise ShellError("no filer configured (start the shell with "
                         "-filer <host:port>)")
    return c


def _norm(p: str) -> str:
    return "/" + p.strip("/")


def _entry_size(e) -> int:
    return max(e.attributes.file_size,
               max((c.offset + c.size for c in e.chunks), default=0))


def _walk(fc, path):
    """Yield (dir, entry) over the subtree rooted at ``path``."""
    stack = [_norm(path)]
    while stack:
        d = stack.pop()
        for e in fc.list(d):
            yield d, e
            if e.is_directory:
                stack.append(d.rstrip("/") + "/" + e.name)


@cluster_command("fs.ls")
def cmd_fs_ls(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("fs.ls")
    p.add_argument("-l", action="store_true", dest="long")
    p.add_argument("path", nargs="?", default="/")
    args = p.parse_args(argv)
    fc = _fc(env)
    n = 0
    for e in fc.list(_norm(args.path)):
        n += 1
        if args.long:
            kind = "d" if e.is_directory else "-"
            mode = e.attributes.file_mode or (0o755 if e.is_directory
                                              else 0o644)
            env.println(f"{kind}{mode & 0o7777:04o} "
                        f"{_entry_size(e):>12} {e.name}")
        else:
            env.println(e.name + ("/" if e.is_directory else ""))
    if args.long:
        env.println(f"total {n}")


@cluster_command("fs.du")
def cmd_fs_du(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("fs.du")
    p.add_argument("path", nargs="?", default="/")
    args = p.parse_args(argv)
    fc = _fc(env)
    files = dirs = size = 0
    for _d, e in _walk(fc, args.path):
        if e.is_directory:
            dirs += 1
        else:
            files += 1
            size += _entry_size(e)
    env.println(f"{size} bytes, {files} files, {dirs} dirs "
                f"under {_norm(args.path)}")


@cluster_command("fs.cat")
def cmd_fs_cat(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("fs.cat")
    p.add_argument("path")
    args = p.parse_args(argv)
    data = _fc(env).get_data(_norm(args.path))
    env.println(data.decode("utf-8", "replace"))


@cluster_command("fs.mkdir")
def cmd_fs_mkdir(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("fs.mkdir")
    p.add_argument("path")
    args = p.parse_args(argv)
    d, _, n = _norm(args.path).rpartition("/")
    if not n:
        raise ShellError("cannot mkdir /")
    _fc(env).mkdir(d or "/", n)
    env.println(f"created {_norm(args.path)}")


@cluster_command("fs.rm")
def cmd_fs_rm(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("fs.rm")
    p.add_argument("-r", action="store_true", dest="recursive")
    p.add_argument("path")
    args = p.parse_args(argv)
    fc = _fc(env)
    path = _norm(args.path)
    d, _, n = path.rpartition("/")
    e = fc.lookup(d or "/", n)
    if e is None:
        raise ShellError(f"{path} not found")
    if e.is_directory and not args.recursive:
        raise ShellError(f"{path} is a directory (use -r)")
    fc.delete(d or "/", n, recursive=args.recursive, delete_data=True)
    env.println(f"removed {path}")


@cluster_command("fs.mv")
def cmd_fs_mv(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("fs.mv")
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    fc = _fc(env)
    sd, _, sn = _norm(args.src).rpartition("/")
    dd, _, dn = _norm(args.dst).rpartition("/")
    if fc.lookup(sd or "/", sn) is None:
        raise ShellError(f"{_norm(args.src)} not found")
    fc.rename(sd or "/", sn, dd or "/", dn)
    env.println(f"moved {_norm(args.src)} -> {_norm(args.dst)}")


@cluster_command("fs.tree")
def cmd_fs_tree(env: ClusterEnv, argv: list[str]) -> None:
    """Recursively print the namespace as an indented tree
    (command_fs_tree.go)."""
    p = _parser("fs.tree")
    p.add_argument("path", nargs="?", default="/")
    args = p.parse_args(argv)
    fc = _fc(env)
    root = _norm(args.path)
    env.println(root)
    files = dirs = 0

    def rec(d: str, indent: str) -> None:
        nonlocal files, dirs
        entries = list(fc.list(d))
        for i, e in enumerate(entries):
            last = i == len(entries) - 1
            tee = "└── " if last else "├── "
            env.println(indent + tee + e.name
                        + ("/" if e.is_directory else ""))
            if e.is_directory:
                dirs += 1
                rec(d.rstrip("/") + "/" + e.name,
                    indent + ("    " if last else "│   "))
            else:
                files += 1

    rec(root, "")
    env.println(f"{dirs} directories, {files} files")


# -- s3.bucket.*: buckets are directories under /buckets on the filer
#    (the same convention the S3 gateway serves; gateway/s3.py
#    BUCKETS_DIR) --

_BUCKETS_DIR = "/buckets"


@cluster_command("s3.bucket.list")
def cmd_s3_bucket_list(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("s3.bucket.list")
    p.parse_args(argv)
    fc = _fc(env)
    n = 0
    for e in fc.list(_BUCKETS_DIR):
        if not e.is_directory:
            continue
        size = files = 0
        for _d, sub in _walk(fc, f"{_BUCKETS_DIR}/{e.name}"):
            if not sub.is_directory:
                files += 1
                size += _entry_size(sub)
        env.println(f"{e.name}  {size} bytes, {files} objects")
        n += 1
    env.println(f"{n} buckets")


@cluster_command("s3.bucket.create")
def cmd_s3_bucket_create(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("s3.bucket.create")
    p.add_argument("-name", required=True)
    args = p.parse_args(argv)
    fc = _fc(env)
    if fc.lookup(_BUCKETS_DIR, args.name) is not None:
        raise ShellError(f"bucket {args.name} already exists")
    fc.mkdir(_BUCKETS_DIR, args.name)
    env.println(f"created bucket {args.name}")


@cluster_command("s3.bucket.delete")
def cmd_s3_bucket_delete(env: ClusterEnv, argv: list[str]) -> None:
    """Delete a bucket and every object in it (the reference requires
    the bucket name twice nowhere; -force skips the empty check)."""
    p = _parser("s3.bucket.delete")
    p.add_argument("-name", required=True)
    p.add_argument("-force", action="store_true",
                   help="delete even when the bucket is not empty")
    args = p.parse_args(argv)
    fc = _fc(env)
    if fc.lookup(_BUCKETS_DIR, args.name) is None:
        raise ShellError(f"bucket {args.name} not found")
    if not args.force:
        if any(True for _ in fc.list(f"{_BUCKETS_DIR}/{args.name}")):
            raise ShellError(
                f"bucket {args.name} is not empty (use -force)")
    fc.delete(_BUCKETS_DIR, args.name, recursive=True,
              delete_data=True)
    env.println(f"deleted bucket {args.name}")


@cluster_command("s3.clean.uploads")
def cmd_s3_clean_uploads(env: ClusterEnv, argv: list[str]) -> None:
    """Abort multipart uploads older than -timeAgo
    (command_s3_clean_uploads.go): a client that initiated an upload
    and vanished leaves part data consuming volumes forever otherwise.
    Age is measured from the NEWEST part, so an in-progress upload is
    never reaped while parts keep arriving."""
    import time as time_mod

    p = _parser("s3.clean.uploads")
    p.add_argument("-timeAgo", default="24h",
                   help="abort uploads idle longer than this "
                        "(e.g. 30m, 24h, 7d)")
    p.add_argument("-force", action="store_true",
                   help="actually delete (default: dry run)")
    args = p.parse_args(argv)
    per = {"s": 1, "m": 60, "h": 3600, "d": 86400}
    unit = args.timeAgo[-1] if args.timeAgo else ""
    if unit not in per or not args.timeAgo[:-1].isdigit():
        raise ShellError(
            f"s3.clean.uploads: bad -timeAgo {args.timeAgo!r} "
            f"(want <n>[smhd])")
    cutoff = time_mod.time() - int(args.timeAgo[:-1]) * per[unit]
    fc = _fc(env)
    uploads_dir = f"{_BUCKETS_DIR}/.uploads"
    reaped = kept = 0
    for e in fc.list(uploads_dir):
        if not e.is_directory:
            continue
        newest = e.attributes.mtime
        key = bucket = ""
        for part in fc.list(f"{uploads_dir}/{e.name}"):
            newest = max(newest, part.attributes.mtime)
            if part.name == "key":
                key = part.extended.get("key", b"").decode("utf-8",
                                                           "replace")
                bucket = part.extended.get(
                    "bucket", b"").decode("utf-8", "replace")
        if newest >= cutoff:
            kept += 1
            continue
        idle_h = (time_mod.time() - newest) / 3600
        env.println(
            f"upload {e.name} ({bucket}/{key}) idle {idle_h:.1f}h"
            + ("" if args.force else " (dry run; use -force)"))
        if args.force:
            fc.delete(uploads_dir, e.name, recursive=True,
                      delete_data=True)
        reaped += 1
    env.println(f"s3.clean.uploads: {reaped} stale uploads"
                + (" aborted" if args.force else " found")
                + f", {kept} active kept")


@cluster_command("fs.configure")
def cmd_fs_configure(env: ClusterEnv, argv: list[str]) -> None:
    """Manage per-path storage rules (command_fs_configure.go): writes
    under -locationPrefix inherit the rule's collection/replication/
    ttl; the filer reloads the stored filer.conf live."""
    from ..filer.path_conf import FILER_CONF_PATH, PathConf, PathRule

    p = _parser("fs.configure")
    p.add_argument("-locationPrefix", default="",
                   help="path prefix the rule applies to")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="",
                   help="e.g. 5m, 2h, 1d (volume TTL class)")
    p.add_argument("-delete", action="store_true")
    p.add_argument("-apply", action="store_true",
                   help="persist (default: dry-run print)")
    args = p.parse_args(argv)
    fc = _fc(env)
    try:
        raw = fc.get_data(FILER_CONF_PATH)
    except Exception as e:  # noqa: BLE001
        if getattr(e, "code", None) == 404:
            raw = b'{"locations": []}'
        else:
            raise ShellError(
                f"fs.configure: cannot read current conf ({e}); "
                f"retry when the filer answers") from None
    try:
        conf = PathConf.parse(raw)
    except ValueError as e:
        raise ShellError(
            f"fs.configure: {FILER_CONF_PATH} holds invalid JSON "
            f"({e}); fix or remove it first") from None
    rules = [r for r in conf.rules
             if r.location_prefix != args.locationPrefix]
    if args.locationPrefix and not args.delete:
        # validate BEFORE persisting: a typo'd rule would poison every
        # write under the prefix with opaque assign-time errors
        from ..storage.superblock import ReplicaPlacement, Ttl
        try:
            if args.ttl:
                Ttl.parse(args.ttl)
            if args.replication:
                ReplicaPlacement.parse(args.replication)
        except ValueError as e:
            raise ShellError(f"fs.configure: {e}") from None
        rules.append(PathRule(
            location_prefix=args.locationPrefix,
            collection=args.collection,
            replication=args.replication,
            ttl=args.ttl))
    elif args.delete and not args.locationPrefix:
        raise ShellError("fs.configure: -delete needs -locationPrefix")
    doc = {"locations": [r.to_json() for r in
                         sorted(rules,
                                key=lambda r: r.location_prefix)]}
    env.println(json.dumps(doc, indent=2))
    if args.apply:
        fc.put_data(FILER_CONF_PATH,
                    json.dumps(doc, indent=2).encode(),
                    mime="application/json")
        env.println(f"applied to {FILER_CONF_PATH} (filer reloads "
                    f"live)")
    else:
        env.println("dry run (use -apply to persist)")


@cluster_command("s3.configure")
def cmd_s3_configure(env: ClusterEnv, argv: list[str]) -> None:
    """Manage the filer-stored S3 identity config the gateway reloads
    live (command_s3_configure.go): upsert or delete an identity, show
    the resulting JSON, and persist it with -apply."""
    from ..gateway.s3 import S3_CONF_PATH

    p = _parser("s3.configure")
    p.add_argument("-user", default="",
                   help="identity name to add/update/delete")
    p.add_argument("-access_key", default="")
    p.add_argument("-secret_key", default="")
    p.add_argument("-actions", default="",
                   help="comma-separated: Admin, Read, Write, "
                        "optionally bucket-scoped like Write:bucket")
    p.add_argument("-delete", action="store_true")
    p.add_argument("-reset", action="store_true",
                   help="start from an empty config (repairs a "
                        "corrupt identities.json)")
    p.add_argument("-apply", action="store_true",
                   help="persist (default: dry-run print)")
    args = p.parse_args(argv)
    fc = _fc(env)
    if args.reset:
        cfg = {"identities": []}
    else:
        try:
            raw = fc.get_data(S3_CONF_PATH)
        except Exception as e:  # noqa: BLE001
            if getattr(e, "code", None) == 404:
                raw = None  # confirmed: no config yet
            else:
                # a transient read error + -apply would otherwise
                # persist an EMPTY config and lock every user out
                raise ShellError(
                    f"s3.configure: cannot read current config "
                    f"({e}); retry when the filer answers") from None
        if raw is None:
            cfg = {"identities": []}
        else:
            try:
                cfg = json.loads(raw)
            except ValueError as e:
                raise ShellError(
                    f"s3.configure: {S3_CONF_PATH} holds invalid "
                    f"JSON ({e}); rebuild it with -reset") from None
    idents = cfg.setdefault("identities", [])
    if args.user:
        idents[:] = [i for i in idents if i.get("name") != args.user]
        if not args.delete:
            if not args.access_key or not args.secret_key:
                raise ShellError(
                    "s3.configure: -access_key and -secret_key are "
                    "required to add/update an identity")
            idents.append({
                "name": args.user,
                "credentials": [{"accessKey": args.access_key,
                                 "secretKey": args.secret_key}],
                "actions": [a for a in args.actions.split(",") if a]
                or ["Admin"],
            })
    elif args.delete:
        raise ShellError("s3.configure: -delete needs -user")
    env.println(json.dumps(cfg, indent=2))
    if args.apply:
        fc.put_data(S3_CONF_PATH, json.dumps(cfg, indent=2).encode(),
                    mime="application/json")
        env.println(f"applied to {S3_CONF_PATH} (gateways reload live)")
    else:
        env.println("dry run (use -apply to persist)")


def _entry_to_json(directory: str, e) -> dict:
    return {
        "dir": directory,
        "name": e.name,
        "isDir": e.is_directory,
        "attributes": {
            "fileSize": e.attributes.file_size,
            "mtime": e.attributes.mtime,
            "fileMode": e.attributes.file_mode,
            "crtime": e.attributes.crtime,
            "mime": e.attributes.mime,
            "ttlSec": e.attributes.ttl_sec,
            "collection": e.attributes.collection,
            "replication": e.attributes.replication,
        },
        "chunks": [{"fileId": c.file_id, "offset": c.offset,
                    "size": c.size, "mtime_ns": c.mtime_ns}
                   for c in e.chunks],
        "extended": {k: v.decode("latin-1")
                     for k, v in e.extended.items()},
    }


def _entry_from_json(d: dict) -> filer_pb2.Entry:
    e = filer_pb2.Entry(name=d["name"], is_directory=d["isDir"])
    a = d.get("attributes", {})
    e.attributes.file_size = a.get("fileSize", 0)
    e.attributes.mtime = a.get("mtime", 0)
    e.attributes.file_mode = a.get("fileMode", 0)
    e.attributes.crtime = a.get("crtime", 0)
    e.attributes.mime = a.get("mime", "")
    e.attributes.ttl_sec = a.get("ttlSec", 0)
    e.attributes.collection = a.get("collection", "")
    e.attributes.replication = a.get("replication", "")
    for c in d.get("chunks", []):
        e.chunks.add(file_id=c["fileId"], offset=c["offset"],
                     size=c["size"], mtime_ns=c.get("mtime_ns", 0))
    for k, v in d.get("extended", {}).items():
        e.extended[k] = v.encode("latin-1")
    return e


@cluster_command("fs.meta.cat")
def cmd_fs_meta_cat(env: ClusterEnv, argv: list[str]) -> None:
    """Print one entry's full metadata as JSON (command_fs_meta_cat.go)
    — the debugging verb for inspecting chunk manifests and extended
    attributes."""
    p = _parser("fs.meta.cat")
    p.add_argument("path")
    args = p.parse_args(argv)
    fc = _fc(env)
    path = _norm(args.path)
    d, _, n = path.rpartition("/")
    e = fc.lookup(d or "/", n)
    if e is None:
        raise ShellError(f"{path} not found")
    env.println(json.dumps(_entry_to_json(d or "/", e), indent=2))


@cluster_command("fs.meta.save")
def cmd_fs_meta_save(env: ClusterEnv, argv: list[str]) -> None:
    """Dump the metadata tree as JSON lines (entries + chunk
    manifests); blob data stays in the volume servers."""
    p = _parser("fs.meta.save")
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("path", nargs="?", default="/")
    args = p.parse_args(argv)
    fc = _fc(env)
    n = 0
    with open(args.outfile, "w", encoding="utf-8") as f:
        for d, e in _walk(fc, args.path):
            f.write(json.dumps(_entry_to_json(d, e)) + "\n")
            n += 1
    env.println(f"saved {n} entries to {args.outfile}")


@cluster_command("fs.meta.load")
def cmd_fs_meta_load(env: ClusterEnv, argv: list[str]) -> None:
    p = _parser("fs.meta.load")
    p.add_argument("-i", dest="infile", required=True)
    args = p.parse_args(argv)
    fc = _fc(env)
    n = 0
    with open(args.infile, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            fc.create(d["dir"], _entry_from_json(d))
            n += 1
    env.println(f"loaded {n} entries from {args.infile}")
