"""Top-level CLI dispatcher — the `weed` binary analog.

The port of ``seaweedfs_tpu/__main__.py``, with these subcommands so far:

    python -m seaweedfs_tpu_torch master -port 9333 [-peers a,b,c]
    python -m seaweedfs_tpu_torch volume -dir d -mserver host:port \
        [-device cuda|cpu]
    python -m seaweedfs_tpu_torch filer -master host:port [-port 8888] \
        [-db meta.sqlite]
    python -m seaweedfs_tpu_torch s3 -filer host:port [-port 8333] \
        [-config identities.json] [-toml server.toml] [-master host:port]
    python -m seaweedfs_tpu_torch shell  -master host:port [-filer h:p] \
        | -dir ... [-device cuda|cpu]
    python -m seaweedfs_tpu_torch upload -master host:port file...
    python -m seaweedfs_tpu_torch download -master host:port fid...
    python -m seaweedfs_tpu_torch delete -master host:port fid...

The other subcommands (webdav, mount, benchmark, ...) come with later
slices of the port (ROADMAP Queue 1).
"""

from __future__ import annotations

import sys


def _run_shell(argv: list[str]) -> int:
    from .shell.cli import main
    return main(argv)


def _run_volume(argv: list[str]) -> int:
    from .cluster.volume_server import main
    return main(argv)


def _run_master(argv: list[str]) -> int:
    from .cluster.master import main
    return main(argv)


def _run_filer(argv: list[str]) -> int:
    from .cluster.filer_server import main
    return main(argv)


def _run_s3(argv: list[str]) -> int:
    from .gateway.s3 import main
    return main(argv)


def _run_client(name: str):
    def run(argv: list[str]) -> int:
        from . import cli_tools
        return getattr(cli_tools, f"run_{name}")(argv)
    return run


COMMANDS = {
    "shell": _run_shell,
    "volume": _run_volume,
    "master": _run_master,
    "filer": _run_filer,
    "s3": _run_s3,
    "upload": _run_client("upload"),
    "download": _run_client("download"),
    "delete": _run_client("delete"),
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m seaweedfs_tpu_torch <command> [flags]\n\n"
              "commands:\n  " + "\n  ".join(sorted(COMMANDS)),
              file=sys.stderr)
        return 0 if argv else 1
    name = argv[0]
    fn = COMMANDS.get(name)
    if fn is None:
        print(f"unknown command {name!r}", file=sys.stderr)
        return 1
    return fn(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
