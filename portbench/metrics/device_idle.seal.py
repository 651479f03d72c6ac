"""device_idle.seal (%): the share of the traced window in which the card
ran no kernel and no copy (1 - the union of its activity over the
window), from torch.profiler's device trace."""


def read(outcome):
    reading = outcome.window.reading
    if "dat_bytes" not in outcome.readings or reading is None or \
            reading.window_s <= 0 or reading.busy_s <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)
