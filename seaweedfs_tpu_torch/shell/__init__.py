"""Admin shell: the `weed shell` analog, offline (``-dir``) mode."""

from .commands import COMMANDS, CommandEnv, run_command  # noqa: F401
