"""``python3 -m portbench.control``: the readings a cell's limits are set
from, in one process.

Runs the cell with the program on ``--seeds`` and with the control
(breakers.control: the plain reference with the Cauchy code matrix in
the codec's place) on ``--control-seeds``, each a whole run (set-up,
``--seconds`` of window, the check), and prints one JSON line per run:
the side, the seed, ``correct`` and every number compared. The control
computes on the host in plain NumPy, slower than the card. So that a
short window compares as many answers as a run of the program does,
``--check-share`` and ``--control-check-share`` set the share of rows or
reads each side samples in place of the cell's ``check_share``. Needs
the card(s) the cell asks for, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import breakers, harness


def main(argv: list) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--check-share", type=float, default=None)
    p.add_argument("--control-check-share", type=float, default=None)
    args = p.parse_args(argv)

    def share(x):
        return None if x is None else {"traffic": {"check_share": x}}

    runs = [("program", s, None, share(args.check_share))
            for s in args.seeds.split(",") if s]
    runs += [("control", s, breakers.control, share(args.control_check_share))
             for s in args.control_seeds.split(",") if s]
    for side, seed, patch, overrides in runs:
        try:
            result, outcome = harness.run(
                args.workload, int(seed), args.seconds, False,
                time.perf_counter(),
                patch=patch or harness.contextlib.nullcontext,
                overrides=overrides)
        except harness.NoCard as e:
            print(f"portbench.control: {e}", file=sys.stderr)
            return harness.EXIT_NO_CARD
        print(json.dumps({"side": side, "seed": int(seed),
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "info": outcome.info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
