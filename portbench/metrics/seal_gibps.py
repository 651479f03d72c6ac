"""seal_gibps (GiB/s): the .dat bytes of every volume the window's one
``encode_packed`` call sealed (each volume's shards, data and parity,
landed on the host), over the host seconds from the call to its
return."""


def read(outcome):
    r = outcome.readings
    if "dat_bytes" not in r or r["seal_seconds"] <= 0:
        return None
    return r["dat_bytes"] / 2 ** 30 / r["seal_seconds"]
