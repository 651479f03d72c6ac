"""idle_group_wait.seal (%): the share of the traced window in which the
card ran no kernel and no copy while the group drain waited for its
group to fill (``dispatch_group`` in ``pipe._run_overlapped``, from its
first wait to its last batch or its give-up), by portbench/hostspans.py:
each idle stretch goes to the first of h2d, group_wait, reader_wait,
dispatch open at its middle."""

from portbench import hostspans


def read(outcome):
    return hostspans.share(outcome, "group_wait")
