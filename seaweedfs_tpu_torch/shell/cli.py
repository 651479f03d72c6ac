"""Shell entry point: REPL or one-shot command execution.

The port of ``seaweedfs_tpu/shell/cli.py``: with ``-master`` the
commands drive a live cluster over gRPC (``cluster_commands.py``; the EC
work runs inside the volume servers, on each server's device); with
``-dir`` they operate directly on local disk locations. ``-c`` runs a
command — or a ``;``-separated sequence sharing one session, so a held
``lock`` covers the later commands — and exits. ``-device`` picks where
the offline EC pipelines run: ``cuda`` (the default, which fails without
a card) or ``cpu`` (the plain PyTorch codec). ``-config F`` loads a TOML
file and applies its ``[pipeline]``, ``[mesh]`` and ``[flight]``
sections for the session (restored when ``main`` returns); with
``-master`` its JWT signing key signs the volume-server rpcs and its
``[grpc.tls]`` secures them. A file that cannot be read, an unknown key
or a ``[mesh]`` that cannot tile the ``-device`` type's devices is
refused with one ``error:`` line and exit status 1 before any volume is
touched:

    python -m seaweedfs_tpu_torch shell -master 127.0.0.1:9333 \
        -c "lock; ec.encode -volumeId 3; ec.balance; unlock"
    python -m seaweedfs_tpu_torch shell -dir /data -c "ec.encode -volumeId 3"
    python -m seaweedfs_tpu_torch shell -dir /a -dir /b -device cpu
    python -m seaweedfs_tpu_torch shell -dir /data -config ec.toml \
        -c "ec.encode -volumeId 3; pipeline.status; pipeline.analyze"
    python -m seaweedfs_tpu_torch shell -master 127.0.0.1:9333 \
        -filer 127.0.0.1:8888 -c "fs.ls -l /; fs.du /; volume.fsck"

``-filer`` names the filer that ``fs.*`` and ``volume.fsck`` talk to.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

from ..storage.store import Store, StoreError
from ..storage.tier import TierError
from ..storage.volume import VolumeError
from ..util import config as config_mod
from ..util import tls as tls_mod
from .cluster_commands import ClusterEnv, run_cluster_command
from .commands import CommandEnv, ShellError, run_command


def build_env(dirs: list[str], max_volumes: int = 8,
              device=None) -> CommandEnv:
    """A CommandEnv over the volumes found in ``dirs``. When one fails
    to load, every volume loaded before it is closed and the error
    raised."""
    store = Store(dirs, max_volumes=max_volumes)
    try:
        store.load_existing()
    except BaseException:
        store.close()
        raise
    return CommandEnv(store=store, device=device)


def _keep(stack: contextlib.ExitStack, cfg, after=None) -> None:
    """Put the dataclass ``cfg`` back as it is now when ``stack``
    closes, then call ``after``."""
    saved = dataclasses.replace(cfg)

    def restore():
        for f in dataclasses.fields(saved):
            setattr(cfg, f.name, getattr(saved, f.name))
        if after is not None:
            after()

    stack.callback(restore)


def _apply_config(stack: contextlib.ExitStack, conf: dict,
                 device_type: str) -> None:
    """Apply ``conf``'s ``[pipeline]``, ``[mesh]`` and ``[flight]``
    sections, each module imported only when its section is there, and
    restore each when ``stack`` closes. A ``[mesh]`` is validated
    against the local ``device_type`` devices here, so a mesh that
    cannot tile them is refused before any work starts. Raises
    ``TypeError`` (an unknown key), ``ValueError`` (a bad value, or
    ``mesh.MeshConfigError``) or ``RuntimeError`` (no card)."""
    if config_mod.lookup(conf, "pipeline") is not None:
        from ..pipeline import pipe as pipe_mod
        _keep(stack, pipe_mod.current())
        pipe_mod.configure_from(conf)
    if config_mod.lookup(conf, "mesh") is not None:
        from ..parallel import mesh as mesh_mod
        _keep(stack, mesh_mod.current())
        mesh_mod.configure_from(conf)
        mesh_mod.configured_mesh(device_type)
    if config_mod.lookup(conf, "flight") is not None:
        from ..pipeline import flight as flight_mod
        # restoring the fields and calling configure() re-arms or
        # disarms the recorder as it was
        _keep(stack, flight_mod.current(), flight_mod.configure)
        flight_mod.configure_from(conf)


def _repl(run, env) -> int:
    while True:
        try:
            line = input("> ")
        except EOFError:
            return 0
        if line.strip() in ("exit", "quit"):
            return 0
        try:
            run(env, line)
        except ShellError as e:
            print(f"error: {e}", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="shell", allow_abbrev=False)
    p.add_argument("-dir", action="append", default=None,
                   help="local disk location (repeatable; offline mode)")
    p.add_argument("-master", default=None,
                   help="master ip:port (cluster mode)")
    p.add_argument("-filer", default=None,
                   help="filer ip:port (enables fs.* commands)")
    p.add_argument("-config", default="",
                   help="TOML file whose [pipeline], [mesh] and [flight] "
                        "sections tune the EC pipelines; with -master, "
                        "its jwt.signing.key and [grpc.tls]")
    p.add_argument("-maxVolumes", type=int, default=8)
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="where the EC pipelines run (default: the card)")
    p.add_argument("-c", dest="oneshot", default=None,
                   help="run command(s) and exit; ';' separates a "
                        "sequence sharing one session (quoted "
                        "arguments must not contain ';')")
    args = p.parse_args(argv)
    if bool(args.dir) == bool(args.master):
        print("error: exactly one of -dir / -master is required",
              file=sys.stderr)
        return 2

    with contextlib.ExitStack() as stack:
        conf: dict = {}
        try:
            if args.config:
                if not os.path.isfile(args.config):
                    raise OSError(f"-config {args.config}: no such file")
                conf = config_mod.load(args.config)
                _apply_config(stack, conf, args.device)
            if args.master:
                tls_mod.install_from_config(conf)
        except (OSError, TypeError, ValueError, RuntimeError) as e:
            # refused before any volume is touched
            print(f"error: {e}", file=sys.stderr)
            return 1
        return _session(args, conf)


def _session(args, conf: dict) -> int:
    if args.master:
        from . import fs_commands  # noqa: F401 — registers fs.* commands
        env = ClusterEnv(
            master_url=args.master, filer_url=args.filer,
            secret=config_mod.lookup(conf, "jwt.signing.key", ""))
        run, cleanup = run_cluster_command, env.close
    else:
        try:
            env = build_env(args.dir, args.maxVolumes, args.device)
        except (StoreError, VolumeError, TierError, OSError) as e:
            # e.g. a volume whose .tier sidecar does not parse
            print(f"error: {e}", file=sys.stderr)
            return 1
        run, cleanup = run_command, env.store.close
    try:
        if args.oneshot is not None:
            for line in args.oneshot.split(";"):
                if not line.strip():
                    continue
                try:
                    run(env, line.strip())
                except ShellError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 1
                except ValueError as e:
                    # shlex on a fragment of a quoted-';' argument:
                    # a clean error, not a traceback
                    print(f"error: cannot parse {line.strip()!r} "
                          f"({e}); note ';' inside quotes is not "
                          f"supported in -c sequences",
                          file=sys.stderr)
                    return 1
            return 0
        return _repl(run, env)
    finally:
        cleanup()


if __name__ == "__main__":
    sys.exit(main())
