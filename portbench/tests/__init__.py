"""CPU tests of the benchmark (``python -m pytest portbench/tests``); the
``cuda`` ones need a card and skip without one."""
