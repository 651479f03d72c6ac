"""idle_reader_wait.seal (%): the share of the traced window in which the
card ran no kernel and no copy while the pipeline's compute stage waited
on the reader (the blocking read-queue get of ``pipe._run_overlapped``),
by portbench/hostspans.py: each idle stretch goes to the first of h2d,
group_wait, reader_wait, dispatch open at its middle."""

from portbench import hostspans


def read(outcome):
    return hostspans.share(outcome, "reader_wait")
