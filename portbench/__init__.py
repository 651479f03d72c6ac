"""The benchmark of the PyTorch and CUDA port, ``seaweedfs_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout::

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON object as the last line of standard output (see
``harness.py``). ``python3 -m portbench.control`` reads the numbers the
correctness limits were set from: the program's over many seeds and the
control's. The CPU tests are under ``tests/`` here
(``python -m pytest portbench/tests``); those marked ``cuda`` need a card.
"""
