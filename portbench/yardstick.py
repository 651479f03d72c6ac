"""The benchmark's own arithmetic: peaks, a kernel's least bytes, sampling.

A roofline share counts the bytes a GF(2^8) product needs from the
shapes of the call (each input byte read once, each output byte written
once), whatever kernel computes it, over the card's published memory
bandwidth, divided by the kernel time the device trace gives.
"""

from __future__ import annotations

#: Published HBM bandwidth (bytes/s) by ``torch.cuda.get_device_name()``:
#: NVIDIA's H100 SXM5 data sheet, 3.35 TB/s at the 700 W limit.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

#: The GF(2^8) kernels' own names start with this.
GF_KERNEL_PREFIX = "gf_"

_MASK = (1 << 64) - 1


def gf_call_bytes(n_out: int, n_in: int, batch: int, s: int) -> int:
    """Least HBM bytes of y (B, n_out, S) = coefs (n_out, n_in) x (B, n_in,
    S): the input read once and the output written once."""
    return (n_in + n_out) * batch * s


def is_gf_kernel(name: str) -> bool:
    """Whether a device trace's kernel name is one of the GF(2^8) kernels:
    ``void (anonymous namespace)::gf_transpose_kernel<4>(gf::Args)`` and
    the like, whatever its namespace and template arguments."""
    own = name.split("(gf::")[0].split("<")[0].split("::")[-1]
    return own.strip().startswith(GF_KERNEL_PREFIX)


def roofline_percent(nbytes: int, kernel_seconds: float,
                     device_name: str):
    """Share (%) of the least time ``nbytes`` take at the card's peak in
    the kernel time measured; None where either is unknown or nought."""
    peak = HBM_BYTES_PER_S.get(device_name)
    if not peak or kernel_seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / peak) / kernel_seconds


def unit_hash(seed: int, *keys: int) -> float:
    """A number in [0, 1) fixed by ``seed`` and ``keys`` (splitmix64)."""
    x = seed & _MASK
    for key in keys:
        x = (x ^ ((key + 0x9E3779B97F4A7C15) & _MASK)) & _MASK
        x = (x + 0x9E3779B97F4A7C15) & _MASK
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
        x ^= x >> 31
    return x / 2.0 ** 64
