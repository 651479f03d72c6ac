"""Shell entry point: REPL or one-shot command execution.

The port of ``seaweedfs_tpu/shell/cli.py`` for its offline mode: with
``-dir`` the commands operate directly on local disk locations. ``-c``
runs a command — or a ``;``-separated sequence sharing one session — and
exits. ``-device`` picks where the EC pipelines run: ``cuda`` (the
default, which fails without a card) or ``cpu`` (the plain PyTorch
codec):

    python -m seaweedfs_tpu_torch shell -dir /data -c "ec.encode -volumeId 3"
    python -m seaweedfs_tpu_torch shell -dir /a -dir /b -device cpu

Not ported yet: ``-master`` (the cluster shell), ``-filer`` and
``-config`` (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import sys

from ..storage.store import Store, StoreError
from ..storage.volume import VolumeError
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
                   help="master ip:port (cluster mode; not ported yet)")
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
    if args.master:
        print("error: -master (the cluster shell) is not ported yet; "
              "use -dir", file=sys.stderr)
        return 2

    try:
        env = build_env(args.dir, args.maxVolumes, args.device)
    except (StoreError, VolumeError, OSError) as e:
        # e.g. a tiered volume: the S3 tier is not ported yet
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        if args.oneshot is not None:
            for line in args.oneshot.split(";"):
                if not line.strip():
                    continue
                try:
                    run_command(env, line.strip())
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
        return _repl(run_command, env)
    finally:
        env.store.close()


if __name__ == "__main__":
    sys.exit(main())
