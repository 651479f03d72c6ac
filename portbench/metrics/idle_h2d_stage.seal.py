"""idle_h2d_stage.seal (%): the share of the traced window in which the
card ran no kernel and no copy while the dispatch thread staged the
slabs' copies to the card (``rs_torch._dispatch_run``), by
portbench/hostspans.py: each idle stretch goes to the first of h2d,
group_wait, reader_wait, dispatch open at its middle."""

from portbench import hostspans


def read(outcome):
    return hostspans.share(outcome, "h2d")
