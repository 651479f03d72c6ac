"""degraded_read_mibps (MiB/s): needle record bytes of every read that
finished, over the host seconds from the first client's first read to
the last client's last return."""


def read(outcome):
    r = outcome.readings
    if "read_bytes" not in r or r["read_seconds"] <= 0:
        return None
    return r["read_bytes"] / 2 ** 20 / r["read_seconds"]
