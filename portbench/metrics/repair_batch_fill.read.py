"""repair_batch_fill.read (requests/batch): interval repairs per codec
call of the shared ``IntervalRepairAggregator`` in the window (its
``requests`` over its ``batches``)."""


def read(outcome):
    r = outcome.readings
    if not r.get("repair_batches"):
        return None
    return r["repair_requests"] / r["repair_batches"]
