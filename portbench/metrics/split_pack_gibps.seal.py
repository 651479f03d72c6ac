"""split_pack_gibps.seal (GiB/s): the rate at which the reader copied the
column chunks of rows wider than the batch bound into their batches,
``PipeStats.split_pack_bytes`` over ``split_pack_seconds`` (the chunks'
share of ``pack``); nothing where the run split no row or the program
has no such counters."""


def read(outcome):
    st = outcome.readings.get("pipe")
    nbytes = getattr(st, "split_pack_bytes", 0)
    seconds = getattr(st, "split_pack_seconds", 0.0)
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds / 2 ** 30
