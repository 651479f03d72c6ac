"""Top-level CLI dispatcher — the `weed` binary analog.

The port of ``seaweedfs_tpu/__main__.py``, with two subcommands so far:

    python -m seaweedfs_tpu_torch shell  -dir ... [-device cuda|cpu]
    python -m seaweedfs_tpu_torch volume -dir d -mserver host:port \
        [-device cuda|cpu]

The other subcommands (master, filer, ...) come with later slices of the
port.
"""

from __future__ import annotations

import sys


def _run_shell(argv: list[str]) -> int:
    from .shell.cli import main
    return main(argv)


def _run_volume(argv: list[str]) -> int:
    from .cluster.volume_server import main
    return main(argv)


COMMANDS = {
    "shell": _run_shell,
    "volume": _run_volume,
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
