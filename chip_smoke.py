#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc`` (on PATH or under CUDA_HOME), and
exits non-zero without printing a result when either is missing, or when
run outside the repository (the package will not import). Phases, each
of which fails the run on any mismatch:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: the kernel library from ``seaweedfs_tpu_torch/ops/csrc`` (set-up);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, byte for byte, at the main path's shapes, for RS(10,4) parity
   rows, RS(10,4) decode rows with shards 2, 7, 11 and 13 lost, RS(6,3)
   and RS(12,4) parity rows and a ragged S; then a sweep that launches
   every instance the dispatch has (1-8 outputs of 10 inputs; 4, 6, 12
   and 70 inputs; 12 outputs; a ragged S), also against the numpy oracle;
   then each kernel's time at the encode slab (25, 10, 1 MiB) and at the
   rebuild chunk (1, 10, 21,600,768) beside its plain version's and its
   memory bound, and its blocks per SM at both;
4. path: a seeded 1 GiB volume of real needles sealed with
   ``encode_volume`` overlapped and sync (identical bytes, parity checked
   against the numpy oracle ``rs_ref``), shards 2, 7, 11, 13 rebuilt with
   ``rebuild_ec_files``, the volume decoded with ``decode_volume`` after
   losing shards 0 and 5, and encode + rebuild again with
   ``SEAWEEDFS_TORCH_KERNEL=swar``; launch counters prove each kernel ran.

The last three lines are the ``kernels`` JSON, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_ref, rs_torch
from seaweedfs_tpu_torch.ops.kernel_bench import (HBM_BYTES_PER_S, shapes,
                                                  time_ms)
from seaweedfs_tpu_torch.pipeline import decode, encode, pipe, rebuild
from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
from seaweedfs_tpu_torch.storage import ec_files, idx as idx_mod
from seaweedfs_tpu_torch.storage import volume as volume_mod

SEED = 20261016
MIB = 1 << 20
#: The deployment's volume: a 1 GiB .dat, RS(10,4), 1 GiB / 1 MiB blocks.
VOLUME_BYTES = 1 << 30
LOST_REBUILD = (2, 7, 11, 13)
LOST_DECODE = (0, 5)
#: The sweep's shard length: not a multiple of the kernels' 1 KiB blocks
#: after padding to either granule, nor of 16 or 128 itself.
SWEEP_S = 200_037
KERNELS = {
    "transpose": dict(
        wrapper=rs_cuda.apply_gf_matrix_transpose,
        plain=rs_cuda.apply_gf_matrix_transpose_ref,
        source="seaweedfs_tpu_torch/ops/csrc/gf_transpose.cu",
        replaces="seaweedfs_tpu/ops/rs_pallas.py:71"),
    "swar": dict(
        wrapper=rs_cuda.apply_gf_matrix_swar,
        plain=rs_cuda.apply_gf_matrix_swar_ref,
        source="seaweedfs_tpu_torch/ops/csrc/gf_swar.cu",
        replaces="seaweedfs_tpu/ops/rs_pallas.py:127"),
}


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)
    print(f"  ok: {what}", flush=True)


def say(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def kernel_phase(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    # the encode slab (one 256 MiB batch: 25 small rows) and one rebuild
    # chunk with the decode rows for lost 2, 7, 11, 13
    main_shapes = shapes(dev)
    (_, parity, slab), (_, decode_rows, chunk) = main_shapes
    cases = [
        ("RS(10,4) parity", parity, slab),
        ("RS(10,4) decode rows, lost 2,7,11,13", decode_rows, chunk),
        ("RS(6,3) parity", rs_torch.Encoder(6, 3, device=dev).parity_coefs,
         (25, 6, MIB)),
        ("RS(12,4) parity", rs_torch.Encoder(12, 4, device=dev).parity_coefs,
         (25, 12, MIB)),
        ("RS(10,4) parity, ragged S", parity, (3, 10, MIB + 1000 + 3)),
    ]
    # the sweep: every output-count instance, other input counts, a table
    # that fits only 7 outputs per launch (70 inputs), and more outputs
    # than one launch takes; S is ragged for both kernels' 1 KiB blocks
    sweep = [(10, m) for m in range(1, 9)] + [(4, 4), (6, 3), (12, 4),
                                                (70, 8), (4, 12)]
    for n_in, n_out in sweep:
        cases.append((f"sweep {n_in} inputs -> {n_out} outputs",
                      gf256.build_code_matrix(n_in, n_in + n_out)[n_in:],
                      (3, n_in, SWEEP_S)))
    max_err = {name: 0 for name in KERNELS}
    for label, coefs, shape in cases:
        x = rand(shape)
        # an independent oracle on a slice: the numpy codec
        n = min(shape[2], 4096)
        xs = x[0, :, :n].cpu().numpy()
        oracle = np.stack([
            np.bitwise_xor.reduce(np.stack([
                gf256.gf_mul_bytes(int(coefs[o, d]), xs[d])
                for d in range(coefs.shape[1])]), axis=0)
            for o in range(coefs.shape[0])])
        for name, k in KERNELS.items():
            y = k["wrapper"](coefs, x)
            ref = k["plain"](coefs, x)
            torch.cuda.synchronize()
            err = int((y.to(torch.int16) - ref.to(torch.int16))
                      .abs().max().item())
            max_err[name] = max(max_err[name], err)
            check(err == 0 and tuple(y.shape) == (shape[0], coefs.shape[0],
                                                  shape[2]),
                  f"{name} kernel == plain version, {label}, "
                  f"x {tuple(shape)}")
            check(np.array_equal(y[0, :, :n].cpu().numpy(), oracle),
                  f"{name} kernel == numpy oracle on a slice, {label}")
        del x
    torch.cuda.empty_cache()

    # time both kernels and their plain versions at the encode slab and
    # at the rebuild chunk; occupancy of the instances those shapes use
    timings = {}
    for what, coefs, shape in main_shapes:
        inputs = [rand(shape) for _ in range(4)]
        moved = (coefs.shape[0] + coefs.shape[1]) * shape[0] * shape[2]
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        for name, k in KERNELS.items():
            ms = time_ms(lambda x, w=k["wrapper"]: w(coefs, x), inputs, 20)
            plain_ms = time_ms(lambda x, p=k["plain"]: p(coefs, x),
                                inputs, 3)
            per_sm = rs_cuda.blocks_per_sm(name, *coefs.shape)
            timings[(name, shape)] = (ms, plain_ms, bound_ms)
            say(f"  {name}: {ms:.4f} ms per {shape} {what} call "
                f"({moved / ms / 1e6:.1f} GB/s moved, "
                f"{bound_ms / ms:.1%} of the bound), bound {bound_ms:.4f} ms "
                f"(bytes), plain version {plain_ms:.3f} ms, no library "
                f"call; {per_sm} blocks per SM")
        del inputs
        torch.cuda.empty_cache()
    occ = {name: [rs_cuda.blocks_per_sm(name, m, 10) for m in range(1, 9)]
           for name in KERNELS}
    say(f"  blocks per SM with 10 inputs and 1-8 outputs: {json.dumps(occ)}")
    return {"max_err": max_err, "timings": timings, "slab": slab}


# --------------------------------------------------------------------------
# path phase
# --------------------------------------------------------------------------

def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(16 * MIB), b""):
            h.update(chunk)
    return h.hexdigest()


def sealed_digests(base) -> dict:
    names = [ec_files.shard_ext(i) for i in range(DEFAULT_SCHEME.total_shards)]
    names += [".ecx", ".vif"]
    return {n: sha256_file(str(base) + n) for n in names}


def check_parity_sampled(base, dat_size: int, rng) -> None:
    """Parity bytes at random shard offsets against the numpy oracle."""
    k, m = DEFAULT_SCHEME.data_shards, DEFAULT_SCHEME.parity_shards
    size = DEFAULT_SCHEME.shard_file_size(dat_size)
    ref = rs_ref.ReferenceEncoder(k, m)
    span = 64 * 1024
    for off in rng.integers(0, size - span, 4):
        off = int(off)
        data = []
        for i in range(k + m):
            with open(ec_files.shard_path(base, i), "rb") as f:
                f.seek(off)
                data.append(np.frombuffer(f.read(span), dtype=np.uint8))
        check(np.array_equal(ref.encode_parity(np.stack(data[:k])),
                             np.stack(data[k:])),
              f"parity == rs_ref at shard offset {off}")


def drive(what: str, fn, expect: dict, launches: dict):
    """Run one main-path call with every launch count set to 0 just
    before it, and check which kernels it launched."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    got = counts()
    for name, want in expect.items():
        check(got[name] > 0 if want else got[name] == 0,
              f"{what}: {name} kernel launched {got[name]} times")
        launches[name] += got[name]
    return out, wall


def path_phase(dev, workdir: str, label: str) -> dict:
    rng = np.random.default_rng(SEED)
    base = os.path.join(workdir, "vol1")
    t0 = time.perf_counter()
    n = volume_mod.write_synthetic_volume(base, VOLUME_BYTES,
                                          avg_size=MIB, seed=SEED)
    dat_size = os.path.getsize(base + ".dat")
    dat_sha = sha256_file(base + ".dat")
    idx_entries = list(idx_mod.walk_index_file(base + ".idx"))
    say(f"  volume: {n} needles, .dat {dat_size} bytes, "
        f"{DEFAULT_SCHEME.shard_file_size(dat_size)} bytes per shard "
        f"(set-up {time.perf_counter() - t0:.1f} s)")
    gib = dat_size / (1 << 30)
    launches = {name: 0 for name in KERNELS}
    os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)
    result = {}

    for overlapped in (True, False):
        mode = "overlapped" if overlapped else "sync"
        st = pipe.PipeStats()
        _, wall = drive(
            f"encode_volume ({mode})",
            lambda: encode.encode_volume(base, device=dev, stats=st,
                                         overlapped=overlapped),
            {"transpose": True, "swar": False}, launches)
        say(f"  encode ({mode}): {gib / wall:.3f} GiB/s of .dat in "
            f"{wall:.3f} s on {label}; stages {json.dumps(st.to_dict())}")
        result[f"encode_{mode}_gibps"] = gib / wall
        digests = sealed_digests(base)
        if overlapped:
            sealed = digests
        else:
            check(digests == sealed, "overlapped and sync encode give "
                  "identical shards, .ecx and .vif")
    check_parity_sampled(base, dat_size, rng)

    shard_size = DEFAULT_SCHEME.shard_file_size(dat_size)

    def lose_and_rebuild(kernel: str) -> float:
        for i in LOST_REBUILD:
            os.remove(ec_files.shard_path(base, i))
        st = pipe.PipeStats()
        got, wall = drive(
            f"rebuild_ec_files ({kernel})",
            lambda: rebuild.rebuild_ec_files(base, device=dev, stats=st),
            {"transpose": kernel == "transpose",
             "swar": kernel == "swar"}, launches)
        check(got == list(LOST_REBUILD), f"rebuilt shards {got}")
        rate = len(LOST_REBUILD) * shard_size / (1 << 30) / wall
        say(f"  rebuild ({kernel}): {rate:.3f} GiB/s of rebuilt shards "
            f"({DEFAULT_SCHEME.data_shards * shard_size / (1 << 30) / wall:.3f}"
            f" GiB/s of survivors "
            f"read) in {wall:.3f} s on {label}; stages "
            f"{json.dumps(st.to_dict())}")
        check(sealed_digests(base) == sealed,
              f"rebuilt shards sha256-equal to the sealed ones ({kernel})")
        return rate

    result["rebuild_gibps"] = lose_and_rebuild("transpose")

    os.remove(base + ".dat")
    os.remove(base + ".idx")
    for i in LOST_DECODE:
        os.remove(ec_files.shard_path(base, i))
    size, wall = drive("decode_volume",
                       lambda: decode.decode_volume(base, device=dev),
                       {"transpose": True, "swar": False}, launches)
    say(f"  decode: {gib / wall:.3f} GiB/s of .dat in {wall:.3f} s on "
        f"{label}")
    check(size == dat_size and sha256_file(base + ".dat") == dat_sha,
          "decoded .dat sha256-equal to the original")
    check(list(idx_mod.walk_index_file(base + ".idx")) == idx_entries,
          ".idx entries restored")

    os.environ["SEAWEEDFS_TORCH_KERNEL"] = "swar"
    try:
        st = pipe.PipeStats()
        _, wall = drive(
            "encode_volume (swar)",
            lambda: encode.encode_volume(base, device=dev, stats=st),
            {"transpose": False, "swar": True}, launches)
        say(f"  encode (swar): {gib / wall:.3f} GiB/s of .dat in "
            f"{wall:.3f} s on {label}; stages {json.dumps(st.to_dict())}")
        result["encode_swar_gibps"] = gib / wall
        check(sealed_digests(base) == sealed,
              "swar encode sha256-equal to the transpose encode")
        result["rebuild_swar_gibps"] = lose_and_rebuild("swar")
    finally:
        os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)
    result["launches"] = launches
    say(f"  launches on the main path: {json.dumps(launches)}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    label = nvidia_smi_line()
    say(f"device: {label}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    say("phase build:")
    t0 = time.perf_counter()
    rs_cuda.library()
    say(f"  kernel library built in {time.perf_counter() - t0:.2f} s "
        f"(builds this process: {rs_cuda.BUILDS})")
    for line in rs_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(f"  {line.strip()}")

    say("phase kernels:")
    kres = kernel_phase(dev)

    say("phase path:")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pres = path_phase(dev, workdir, label)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    rows = []
    for name, k in KERNELS.items():
        ms, plain_ms, bound_ms = kres["timings"][(name, kres["slab"])]
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": pres["launches"][name],
            "max_abs_err": kres["max_err"][name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
        })
    say(json.dumps({"kernels": rows}))
    say(label)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
