"""Time the GF(2^8) kernels on the card at the main path's two shapes.

    python3 seaweedfs_tpu_torch/ops/kernel_bench.py [--label NAME]
    python3 -m seaweedfs_tpu_torch.ops.kernel_bench --crossover

Times each kernel wrapper, with the harness of :func:`time_ms`, on
RS(10,4) parity rows at the encode slab ``(25, 10, 1 MiB)`` and on the
decode rows for lost shards 2, 7, 11 and 13 at the rebuild chunk
``(1, 10, 21,600,768)``, beside the memory bound of each shape, and
prints one JSON line per kernel and shape (three timed windows each).
It imports ``seaweedfs_tpu_torch`` from ``sys.path``, so run with
``PYTHONPATH`` set to a checkout to time that checkout's kernels: two
checkouts timed in turns inside one call compare on one card.

``--crossover`` measures the small-payload rule's threshold
(``rs_torch.DEVICE_MIN_S``): for one lost shard's decode row (10 inputs,
1 output) at B = 1 (one interval repair) and B = 128 (the repair
aggregator's largest batch), and S = 1 KiB ... 4 MiB in powers of two, it
times the native host codec against a round trip to the card through
``apply_matrix_host`` (pageable H2D, kernel, D2H, ``np.asarray``), as the
read path pays it, and prints one JSON line per (B, S), then the
smallest S at which the card wins at each B, and the smallest S at which
the card's round trip at B = 1 leaves its fixed-cost floor
(:func:`floor_end_s`), which sets ``DEVICE_MIN_S`` (PERF.md §6).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import rs_cuda, rs_native, rs_torch
from seaweedfs_tpu_torch.pipeline import rebuild
from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12
MIB = 1 << 20
LOST = (2, 7, 11, 13)
DISPATCH = "SEAWEEDFS_TORCH_HOST_DISPATCH"


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


def host_ms(fn, seconds: float = 0.2, min_reps: int = 5) -> list:
    """Host wall milliseconds of each of at least ``min_reps`` calls of
    ``fn`` (after two warm-up calls), repeated for about ``seconds``."""
    fn()
    fn()
    times = []
    t_end = time.perf_counter() + seconds
    while len(times) < min_reps or time.perf_counter() < t_end:
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def crossover(device, card: str, batches=(1, 128),
              sizes=tuple(1 << e for e in range(10, 23))) -> list:
    """The native codec against the card's round trip for one decode
    row over 10 survivors (module docstring); one dict per (B, S)."""
    enc = rs_torch.Encoder(10, 4, device=device)
    coefs = enc.decode_matrix_rows([i for i in range(14) if i not in LOST],
                                   [LOST[0]])
    block = np.random.default_rng(20261016).integers(
        0, 256, 1 << 24, dtype=np.uint8)
    saved = rs_torch.DEVICE_MIN_S, os.environ.get(DISPATCH)
    rows = []
    try:
        # every timed host call goes to the card, whatever the link rule
        rs_torch.DEVICE_MIN_S = 0
        os.environ[DISPATCH] = "device"
        for b in batches:
            for s in sizes:
                x = np.resize(block, (b, 10, s))   # pageable, as np.stack
                want = rs_native.apply_gf_matrix(coefs, x)
                got = np.asarray(rs_torch.apply_matrix_host(coefs, x,
                                                            device))
                if not np.array_equal(got, want):
                    raise AssertionError(f"card != native at B={b} S={s}")
                native = host_ms(lambda: rs_native.apply_gf_matrix(coefs, x))
                cardt = host_ms(lambda: np.asarray(
                    rs_torch.apply_matrix_host(coefs, x, device)))
                rows.append({
                    "B": b, "S": s,
                    "native_ms": statistics.median(native),
                    "card_ms": statistics.median(cardt),
                    "native_min_ms": min(native), "card_min_ms": min(cardt),
                    "reps": [len(native), len(cardt)],
                    "simd_level": rs_native.simd_level(), "card": card})
                print(json.dumps(rows[-1]), flush=True)
                del x
    finally:
        rs_torch.DEVICE_MIN_S = saved[0]
        if saved[1] is None:
            os.environ.pop(DISPATCH, None)
        else:
            os.environ[DISPATCH] = saved[1]
    return rows


def crossover_s(rows, b: int = 1):
    """The smallest S at which the card's median beats the native
    codec's at batch ``b``, or None."""
    wins = [r["S"] for r in rows
            if r["B"] == b and r["card_ms"] < r["native_ms"]]
    return min(wins) if wins else None


def floor_end_s(rows, b: int = 1):
    """The smallest S at which the card's round trip takes at least twice
    its floor (its median over S <= 4 KiB) at batch ``b``: below it the
    round trip is fixed cost, from it the time grows with the bytes
    copied. None if it never does."""
    mine = [r for r in rows if r["B"] == b]
    floor = statistics.median(r["card_ms"] for r in mine if r["S"] <= 4096)
    grown = [r["S"] for r in mine if r["card_ms"] >= 2 * floor]
    return min(grown) if grown else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="",
                    help="tag for the output lines (which checkout)")
    ap.add_argument("--crossover", action="store_true",
                    help="time the host codec against the card's round "
                         "trip instead (rs_torch.DEVICE_MIN_S)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.crossover:
        rows = crossover(dev, card)
        print(json.dumps({"crossover_S_B1": crossover_s(rows, 1),
                          "crossover_S_B128": crossover_s(rows, 128),
                          "floor_end_S_B1": floor_end_s(rows, 1),
                          "DEVICE_MIN_S": rs_torch.DEVICE_MIN_S,
                          "card": card}), flush=True)
        return 0
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
