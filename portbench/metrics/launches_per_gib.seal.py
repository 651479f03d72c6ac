"""launches_per_gib.seal (launches/GiB): GF(2^8) kernel launches of the
window (``rs_cuda``'s launch counts) per GiB of .dat sealed."""


def read(outcome):
    r = outcome.readings
    if "dat_bytes" not in r or not r["dat_bytes"] or not r["launches"]:
        return None
    return r["launches"] / (r["dat_bytes"] / 2 ** 30)
