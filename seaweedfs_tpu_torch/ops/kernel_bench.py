"""Time the GF(2^8) kernels on the card at the main path's two shapes.

    python3 seaweedfs_tpu_torch/ops/kernel_bench.py [--label NAME]

Times each kernel wrapper, with the harness of :func:`time_ms`, on
RS(10,4) parity rows at the encode slab ``(25, 10, 1 MiB)`` and on the
decode rows for lost shards 2, 7, 11 and 13 at the rebuild chunk
``(1, 10, 21,600,768)``, beside the memory bound of each shape, and
prints one JSON line per kernel and shape (three timed windows each).
It imports ``seaweedfs_tpu_torch`` from ``sys.path``, so run with
``PYTHONPATH`` set to a checkout to time that checkout's kernels: two
checkouts timed in turns inside one call compare on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from seaweedfs_tpu_torch.ops import rs_cuda, rs_torch
from seaweedfs_tpu_torch.pipeline import rebuild
from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12
MIB = 1 << 20
LOST = (2, 7, 11, 13)


def time_ms(fn, inputs, reps: int) -> float:
    """Device milliseconds per call of ``fn`` over distinct ``inputs``.

    A warm-up runs the same ``reps`` calls and keeps their outputs alive,
    so the caching allocator holds every output block before the timed
    window opens (a cudaMalloc inside the window would be timed as
    kernel time). Then CUDA events around ``reps`` calls,
    and the window closed by fetching a checksum of every output."""

    def run():
        return [fn(inputs[r % len(inputs)]) for r in range(reps)]

    outs = run()
    torch.cuda.synchronize()
    del outs
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = run()
    end.record()
    checksum = 0
    for y in outs:
        checksum ^= int(y.view(-1)[::4097].to(torch.int64).sum().item())
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def shapes(device) -> list:
    """(rows, coefs, shape) of the encode slab and the rebuild chunk of a
    1 GiB RS(10,4) volume."""
    enc = rs_torch.Encoder(10, 4, device=device)
    present = [i for i in range(14) if i not in LOST]
    chunk = rebuild.chunk_length(DEFAULT_SCHEME.shard_file_size(1 << 30),
                                 10)
    return [("parity", enc.parity_coefs, (25, 10, MIB)),
            ("decode rows", enc.decode_matrix_rows(present, list(LOST)),
             (1, 10, chunk))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="",
                    help="tag for the output lines (which checkout)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels = {"transpose": rs_cuda.apply_gf_matrix_transpose,
               "swar": rs_cuda.apply_gf_matrix_swar}
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    for what, coefs, shape in shapes(dev):
        inputs = [torch.randint(0, 256, shape, dtype=torch.uint8,
                                device=dev, generator=gen)
                  for _ in range(4)]
        moved = (coefs.shape[0] + coefs.shape[1]) * shape[0] * shape[2]
        for name, wrapper in kernels.items():
            ms = [time_ms(lambda x: wrapper(coefs, x), inputs, 20)
                  for _ in range(3)]
            # older checkouts have no occupancy export
            occ = getattr(rs_cuda, "blocks_per_sm", None)
            print(json.dumps({
                "label": args.label, "kernel": name, "rows": what,
                "shape": shape, "ms": ms,
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "blocks_per_sm": occ(name, *coefs.shape) if occ else None,
                "card": card}), flush=True)
        del inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
