"""``python3 -m portbench``: one run of one cell (harness.main)."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
