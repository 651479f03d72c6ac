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
   rows and decode rows with shards 2, 7, 11 and 13 lost (at the 256 MiB
   encode slab, also config 3's slab, and the rebuild chunk), RS(6,3) and
   RS(12,4) parity rows and a ragged S; then a sweep that launches every
   instance the dispatch has (1-8 outputs of 10 inputs; 4, 6, 12 and 70
   inputs; 12 outputs; a ragged S), also against the numpy oracle; then
   each kernel's time at the slab and the chunk beside its plain
   version's and its memory bound, and its blocks per SM;
4. native: the host codec (``rs_native``, built with ``g++``) against
   ``rs_ref`` at 4 sizes, with its SIMD level;
5. path: a seeded 1 GiB volume of real needles sealed with
   ``encode_volume`` overlapped and sync (identical bytes, parity checked
   against the numpy oracle ``rs_ref``), shards 2, 7, 11, 13 rebuilt with
   ``rebuild_ec_files``; then the read phase: shards 0, 5, 11, 13 removed, every needle read through
   ``EcVolumeReader`` (once directly, once from 8 threads through one
   ``IntervalRepairAggregator``) and held against the original ``.dat``,
   and the shards rebuilt; the volume decoded with ``decode_volume`` after
   losing shards 0 and 5, and encode + rebuild again with
   ``SEAWEEDFS_TORCH_KERNEL=swar``; launch counters prove each kernel ran,
   and the host codec's call counter which reads it served;
6. repair under load (BASELINE config 5): ``repair_bench.run`` for 8 s,
   a bulk decode of 4 lost shards through the kernels while 8 reader
   threads send 64 QPS of 4 KiB interval repairs, all checked;
7. config 4: the restored volume sealed with RS(6,3) and RS(12,4), m
   shards rebuilt, and the volume decoded after losing data shards 0 and
   3, all sha256-checked, parity against ``rs_ref`` on sampled rows;
8. config 3 (the many-volume batcher): ``batch.encode_many`` over 1000
   volumes of 30 MiB (GiB/s of volume bytes, stage times, launches), then
   ``batch.encode_packed`` over the same with every parity span checked
   whole against ``rs_ref`` and the batch census printed, 200 volumes on the
   SWAR kernel, and 200 under ``SEAWEEDFS_TORCH_HOST_DISPATCH=auto``
   (the probe's two rates, its verdict and the route taken); then 32
   volumes of real needles sealed by ``batch.encode_volumes``, each
   sha256-equal to a single-volume ``write_ec_files``.

Every phase but that auto pass runs with
``SEAWEEDFS_TORCH_HOST_DISPATCH=device``, so that large host slabs
launch the kernels whatever the link probe would say.
The last three lines are the ``kernels`` JSON, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_native, rs_ref
from seaweedfs_tpu_torch.ops import rs_torch
from seaweedfs_tpu_torch.ops.kernel_bench import (HBM_BYTES_PER_S, shapes,
                                                  time_ms)
from seaweedfs_tpu_torch.pipeline import (batch, decode, encode, pipe, read,
                                          rebuild, repair, repair_bench,
                                          stripe)
from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage import ec_files, idx as idx_mod
from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage import volume as volume_mod

SEED = 20261016
MIB = 1 << 20
#: The deployment's volume: a 1 GiB .dat, RS(10,4), 1 GiB / 1 MiB blocks.
VOLUME_BYTES = 1 << 30
LOST_REBUILD = (2, 7, 11, 13)
LOST_DECODE = (0, 5)
#: The read phase's and config 5's lost shards: two data, two parity.
LOST_READ = repair_bench.DEFAULT_LOST
READ_THREADS = 8
#: The sweep's shard length: not a multiple of the kernels' 1 KiB blocks
#: after padding to either granule, nor of 16 or 128 itself.
SWEEP_S = 200_037
GIB = 1 << 30
#: BASELINE config 3: 1000 volumes of 30 MiB sealed in one job, payloads
#: from a seeded pool of 8 distinct buffers; the SWAR and auto passes run
#: 200 of them; the file-level pass seals 32 volumes of real needles.
C3_VOLUMES = 1000
C3_VOLUME_BYTES = 30 * MIB
C3_POOL = 8
C3_SHORT = 200
C3_FILES = 32
C3_NEEDLE = 64 * 1024
#: BASELINE config 4: (k, m, shards lost before the rebuild) on the 1 GiB
#: volume; the decode loses data shards 0 and 3.
CONFIG4 = ((6, 3, (0, 4, 7)), (12, 4, (1, 6, 12, 15)))
C4_LOST_DECODE = (0, 3)
DISPATCH = "SEAWEEDFS_TORCH_HOST_DISPATCH"
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
    rs_native.apply_gf_matrix.calls = 0


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

    # the encode slab and the rebuild chunk (decode rows for lost 2, 7,
    # 11, 13): one 256 MiB batch each (25 small rows: also config 3's slab)
    main_shapes = shapes(dev)
    cases = [(f"RS(10,4) {what}", coefs, shape)
             for what, coefs, shape in main_shapes]
    parity = main_shapes[0][1]
    cases += [
        # config 4's slabs
        (f"RS({k},{m}) parity", rs_torch.Encoder(k, m, device=dev)
         .parity_coefs, (batch.max_rows_per_batch(
             k, MIB, batch.DEFAULT_MAX_BATCH_BYTES), k, MIB))
        for k, m, _ in CONFIG4] + [
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
    # the kernels JSON line reports the slab the card's main path runs:
    # encode and the config-3 batcher
    return {"max_err": max_err, "timings": timings,
            "slab": main_shapes[0][2]}


# --------------------------------------------------------------------------
# native phase
# --------------------------------------------------------------------------

def native_phase() -> None:
    """The host codec against the numpy oracle at 4 sizes, on this
    machine's CPU (its SIMD level may differ from a development host's)."""
    t0 = time.perf_counter()
    check(rs_native.available(), "native host codec built with g++")
    say(f"  built in {time.perf_counter() - t0:.2f} s; simd_level "
        f"{rs_native.simd_level()} (0 scalar, 2 AVX2, 3 GFNI+AVX512); "
        f"DEVICE_MIN_S {rs_torch.DEVICE_MIN_S}")
    rng = np.random.default_rng(SEED)
    enc = rs_torch.Encoder(10, 4, device="cpu")
    ref = rs_ref.ReferenceEncoder(10, 4)
    present = [i for i in range(14) if i not in LOST_READ]
    rows = enc.decode_matrix_rows(present, list(LOST_READ))
    for s in (1, 4096, 128 * 1024 + 3, 4 * MIB):
        x = rng.integers(0, 256, (10, s), dtype=np.uint8)
        check(np.array_equal(rs_native.apply_gf_matrix(enc.parity_coefs, x),
                             ref.encode_parity(x)),
              f"native parity == rs_ref, S = {s}")
        full = np.concatenate([x, ref.encode_parity(x)])
        check(np.array_equal(rs_native.apply_gf_matrix(rows, full[present]),
                             full[list(LOST_READ)]),
              f"native decode rows rebuild shards {LOST_READ}, S = {s}")


# --------------------------------------------------------------------------
# path phase
# --------------------------------------------------------------------------

def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(16 * MIB), b""):
            h.update(chunk)
    return h.hexdigest()


def sealed_digests(base, scheme=DEFAULT_SCHEME, shards=None) -> dict:
    """sha256 of the shard files (all, or ``shards``), and of .ecx and
    .vif when all are asked for."""
    names = [ec_files.shard_ext(i) for i in (
        range(scheme.total_shards) if shards is None else shards)]
    if shards is None:
        names += [".ecx", ".vif"]
    return {n: sha256_file(str(base) + n) for n in names}


def check_parity_sampled(base, dat_size: int, rng,
                         scheme=DEFAULT_SCHEME) -> None:
    """Parity bytes at random shard offsets against the numpy oracle."""
    k, m = scheme.data_shards, scheme.parity_shards
    size = scheme.shard_file_size(dat_size)
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


def read_phase(dev, base: str, idx_entries, sealed: dict,
               launches: dict) -> dict:
    """Read every needle with shards 0, 5, 11, 13 lost, directly and from
    8 threads through one aggregator, each against the original .dat;
    then rebuild the lost shards."""
    for i in LOST_READ:
        os.remove(ec_files.shard_path(base, i))
    dat = np.memmap(base + ".dat", dtype=np.uint8, mode="r")
    result = {}

    def check_records(got: dict, what: str) -> None:
        bad = [e.key for e in idx_entries
               if got[e.key] != dat[e.byte_offset:e.byte_offset
                                    + needle_mod.record_size(e.size, 3)]
               .tobytes()]
        check(len(got) == len(idx_entries) and not bad,
              f"{what}: all {len(got)} needles byte-equal to the original "
              f".dat (differing: {bad[:5]})")

    def timed_read(reader, key, lat, out):
        t0 = time.perf_counter()
        out[key] = reader.read_record(key)
        lat.append(time.perf_counter() - t0)

    def direct():
        reader = read.EcVolumeReader(base, device=dev)
        lat, out = [], {}
        for e in idx_entries:
            timed_read(reader, e.key, lat, out)
        return reader, None, lat, out

    def aggregated():
        lat, out, errors = [], {}, []
        with repair.IntervalRepairAggregator(device=dev) as agg:
            reader = read.EcVolumeReader(base, aggregator=agg, device=dev)

            def work(part):
                try:
                    for e in part:
                        timed_read(reader, e.key, lat, out)
                except Exception as exc:  # noqa: BLE001 — raised below
                    errors.append(exc)

            threads = [threading.Thread(target=work,
                                        args=(idx_entries[t::READ_THREADS],))
                       for t in range(READ_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if errors or any(t.is_alive() for t in threads):
                raise SmokeError(f"aggregated read failed: {errors[:1]}")
        return reader, agg, lat, out

    for what, fn in (("read (direct)", direct),
                     (f"read ({READ_THREADS} threads, aggregator)",
                      aggregated)):
        (reader, agg, lat, out), wall = drive(
            what, fn, {"transpose": True, "swar": False}, launches)
        native = rs_native.apply_gf_matrix.calls
        check_records(out, what)
        lat_ms = np.asarray(lat) * 1e3
        stats = {
            "needles_per_s": len(out) / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "intervals_repaired": reader.intervals_repaired,
            "agg_batches": agg.batches if agg else None,
            "agg_requests": agg.requests if agg else None,
            "native_calls": native, "kernel_launches": counts(),
            "wall_s": wall}
        say(f"  {what}: {json.dumps(stats)}")
        check(reader.intervals_repaired > 0 and native > 0,
              f"{what}: {reader.intervals_repaired} intervals repaired, "
              f"{native} of them on the host codec (below "
              f"{rs_torch.DEVICE_MIN_S} bytes)")
        result[what] = stats
    del dat

    got, wall = drive("rebuild_ec_files (after the read phase)",
                      lambda: rebuild.rebuild_ec_files(base, device=dev),
                      {"transpose": True, "swar": False}, launches)
    check(got == list(LOST_READ) and sealed_digests(base) == sealed,
          f"shards {got} rebuilt sha256-equal to the sealed ones")
    return result


def repair_phase(dev, workdir: str, shard_len: int, launches: dict) -> dict:
    """BASELINE config 5 at this volume's shard size."""
    os.makedirs(workdir)
    res, wall = drive(
        "repair_bench.run (config 5)",
        lambda: repair_bench.run(
            duration_s=8, qps=64, shard_len=shard_len, interval_size=4096,
            lost=LOST_READ, bulk_chunk=4 * MIB, n_reader_threads=8,
            verify=True, workdir=workdir, device=dev),
        {"transpose": True, "swar": False}, launches)
    native = rs_native.apply_gf_matrix.calls
    res.update(native_calls=native, kernel_launches=counts(), wall_s=wall)
    say(f"  config 5: {json.dumps(res)}")
    # 4 KiB is below DEVICE_MIN_S: the repairs take the host codec, the
    # 4 MiB bulk chunks the kernel
    check(4096 < rs_torch.DEVICE_MIN_S <= 4 * MIB and native > 0,
          f"config 5: 4 KiB repairs on the host codec ({native} calls), "
          f"bulk decode on the kernel ({counts()['transpose']} launches)")
    check(res["reads"] > 0 and res["achieved_qps"] > 32,
          f"config 5: {res['reads']} checked repairs at "
          f"{res['achieved_qps']:.1f} QPS, no mismatch")
    return res


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
    result["read"] = read_phase(dev, base, idx_entries, sealed, launches)

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
    result.update(launches=launches, base=base, dat_sha=dat_sha,
                  idx_entries=idx_entries)
    say(f"  launches on the path phase: {json.dumps(launches)}")
    return result


# --------------------------------------------------------------------------
# config 4: RS(6,3) and RS(12,4) on the 1 GiB volume
# --------------------------------------------------------------------------

def config4_phase(dev, pres: dict, label: str, launches: dict) -> dict:
    """Seal the restored 1 GiB volume with each scheme, rebuild m lost
    shards, and decode it after losing two data shards."""
    rng = np.random.default_rng(SEED + 4)
    base = pres["base"]
    dat_size = os.path.getsize(base + ".dat")
    gib = dat_size / GIB
    result = {}
    for k, m, lost in CONFIG4:
        scheme = EcScheme(k, m)
        b = f"{base}_rs{k}_{m}"
        os.link(base + ".dat", b + ".dat")
        os.link(base + ".idx", b + ".idx")
        st = pipe.PipeStats()
        _, enc_wall = drive(
            f"encode_volume RS({k},{m})",
            lambda: encode.encode_volume(b, scheme, device=dev, stats=st),
            {"transpose": True, "swar": False}, launches)
        sealed = sealed_digests(b, scheme)
        check_parity_sampled(b, dat_size, rng, scheme)
        for i in lost:
            os.remove(ec_files.shard_path(b, i))
        got, reb_wall = drive(
            f"rebuild_ec_files RS({k},{m})",
            lambda: rebuild.rebuild_ec_files(b, scheme, device=dev),
            {"transpose": True, "swar": False}, launches)
        check(got == list(lost) and sealed_digests(b, scheme) == sealed,
              f"RS({k},{m}): shards {got} rebuilt sha256-equal to the "
              f"sealed ones")
        os.remove(b + ".dat")
        os.remove(b + ".idx")
        for i in C4_LOST_DECODE:
            os.remove(ec_files.shard_path(b, i))
        size, dec_wall = drive(
            f"decode_volume RS({k},{m})",
            lambda: decode.decode_volume(b, scheme, device=dev),
            {"transpose": True, "swar": False}, launches)
        check(size == dat_size and sha256_file(b + ".dat") == pres["dat_sha"]
              and list(idx_mod.walk_index_file(b + ".idx"))
              == pres["idx_entries"],
              f"RS({k},{m}): .dat decoded after losing shards "
              f"{C4_LOST_DECODE} sha256-equal to the original, .idx restored")
        rates = {"encode_gibps": gib / enc_wall,
                 "rebuild_gibps": len(lost) * scheme.shard_file_size(
                     dat_size) / GIB / reb_wall,
                 "decode_gibps": gib / dec_wall,
                 "encode_batches": st.batches}
        say(f"  RS({k},{m}) on {label}: {json.dumps(rates)}")
        result[f"RS({k},{m})"] = rates
        for f in os.listdir(os.path.dirname(b)):
            if f.startswith(os.path.basename(b) + "."):
                os.remove(os.path.join(os.path.dirname(b), f))
    return result


# --------------------------------------------------------------------------
# config 3: the many-volume coalescing batcher
# --------------------------------------------------------------------------

def config3_phase(dev, label: str, launches: dict) -> dict:
    """1000 volumes of 30 MiB through ``batch.encode_many`` (timed, with
    no sink), then through ``batch.encode_packed`` with every parity span
    checked against the numpy oracle; then 200 volumes on the SWAR kernel
    and 200 under the ``auto`` link rule, both checked."""
    scheme = DEFAULT_SCHEME
    k, m = scheme.data_shards, scheme.parity_shards
    vol = f"{C3_VOLUME_BYTES // MIB} MiB"
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    pool = [rng.integers(0, 256, C3_VOLUME_BYTES, dtype=np.uint8)
            for _ in range(C3_POOL)]
    # each pool buffer's whole parity shards from the numpy oracle, which
    # shares no code with the kernels or their plain versions
    enc = scheme.encoder(dev)
    oracle = rs_ref.ReferenceEncoder(k, m)
    refs = [oracle.encode_parity(np.stack(stripe.stripe(p, scheme)))
            for p in pool]
    say(f"  set-up {time.perf_counter() - t0:.1f} s ({C3_POOL} reference "
        f"volumes of parity {refs[0].shape} from rs_ref)")

    checked = collections.Counter()

    def check_sink(key, shard_id, offset, blocks):
        # runs on the pipeline's writer thread; a mismatch fails the run
        if shard_id < k:
            return
        want = refs[key % C3_POOL][shard_id - k,
                                   offset:offset + blocks.size]
        if not np.array_equal(blocks, want.reshape(blocks.shape)):
            raise SmokeError(f"config 3: volume {key} shard {shard_id} "
                             f"differs at offset {offset}")
        checked["bytes"] += blocks.size

    def sources(n):
        return ((i, pool[i % C3_POOL]) for i in range(n))

    def run(what, n, expect, checked_run):
        st = pipe.PipeStats()
        checked.clear()
        if checked_run:
            fn = lambda: batch.encode_packed(sources(n), check_sink, scheme,
                                             device=dev, stats=st)
        else:
            fn = lambda: batch.encode_many([pool[i % C3_POOL]
                                            for i in range(n)],
                                           scheme, device=dev, stats=st)[0]
        total, wall = drive(what, fn, expect, launches)
        got = counts()
        gibps = total / GIB / wall
        check(total == n * C3_VOLUME_BYTES,
              f"{what}: {total} bytes of {n} volumes")
        if checked_run:
            check(checked["bytes"] == n * m * scheme.shard_file_size(
                C3_VOLUME_BYTES),
                  f"{what}: every parity span of {n} volumes "
                  f"({checked['bytes']} bytes) equals its reference")
        res = {"volumes": n, "gibps": gibps, "wall_s": wall,
               "launches": got,
               "native_calls": rs_native.apply_gf_matrix.calls,
               "stages": st.to_dict()}
        say(f"  {what}: {gibps:.3f} GiB/s of volume bytes on {label}; "
            f"{json.dumps(res)}")
        return res, st

    result = {}
    # warm-up outside the counted runs: pinned output blocks, caches
    batch.encode_many(pool * 2, scheme, device=dev)
    res, st = run(f"encode_many ({C3_VOLUMES} x {vol}, timed)", C3_VOLUMES,
                  {"transpose": True, "swar": False}, False)
    result["timed"] = res

    # the census: every batch shape the checked pass hands the codec
    census: collections.Counter = collections.Counter()
    single = enc.encode_parity_host

    def census_single(b):
        census[tuple(b.shape)] += 1
        return single(b)

    enc.encode_parity_host = census_single
    try:
        res, st = run(f"encode_packed ({C3_VOLUMES} x {vol}, checked)",
                      C3_VOLUMES, {"transpose": True, "swar": False}, True)
    finally:
        del enc.encode_parity_host
    res["census"] = {str(k_): v for k_, v in census.items()}
    rows_cap = batch.max_rows_per_batch(k, MIB,
                                        batch.DEFAULT_MAX_BATCH_BYTES)
    rows = C3_VOLUMES * scheme.shard_file_size(C3_VOLUME_BYTES) // MIB
    want = {(rows_cap, k, MIB): rows // rows_cap}
    if rows % rows_cap:
        want[(rows % rows_cap, k, MIB)] = 1
    check(sum(census.values()) == st.batches and census == want,
          f"config 3 census: {dict(census)} "
          f"(batch bound {batch.DEFAULT_MAX_BATCH_BYTES} bytes)")
    result["checked"] = res

    os.environ["SEAWEEDFS_TORCH_KERNEL"] = "swar"
    try:
        result["swar"], st = run(
            f"encode_packed ({C3_SHORT} x {vol}, swar, checked)", C3_SHORT,
            {"transpose": False, "swar": True}, True)
    finally:
        os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)

    # the auto link rule: probe once, print its verdict, follow it
    os.environ[DISPATCH] = "auto"
    try:
        t0 = time.perf_counter()
        stay = rs_torch._stay_on_host(dev)
        link, native = rs_torch.calibration()
        probe = {"link_gibps": link, "native_gibps": native,
                 "verdict": "host slabs stay on the host codec" if stay
                 else "host slabs cross to the card",
                 "probe_s": time.perf_counter() - t0}
        say(f"  auto probe on {label}: {json.dumps(probe)}")
        res, st = run(f"encode_packed ({C3_SHORT} x {vol}, auto, checked)",
                      C3_SHORT, {"transpose": not stay, "swar": False}, True)
        check((res["native_calls"] > 0) == stay,
              f"config 3 auto: the route taken follows the verdict "
              f"({res['native_calls']} host-codec calls, "
              f"{res['launches']['transpose']} launches)")
    finally:
        os.environ[DISPATCH] = "device"
    res["probe"] = probe
    result["auto"] = res
    return result


def config3_files_phase(dev, workdir: str, label: str,
                        launches: dict) -> dict:
    """32 seeded volumes of real needles sealed by ``encode_volumes``;
    each one's shard files sha256-equal to a single-volume encode."""
    os.makedirs(workdir)
    bases = [os.path.join(workdir, f"c3v{i}") for i in range(C3_FILES)]
    t0 = time.perf_counter()
    # the needles' CRCs take about a second per volume in Python: make
    # the volumes in parallel worker processes
    with ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        list(ex.map(volume_mod.write_synthetic_volume, bases,
                    [C3_VOLUME_BYTES] * C3_FILES, [C3_NEEDLE] * C3_FILES,
                    [SEED + i for i in range(C3_FILES)]))
    sizes = [os.path.getsize(b + ".dat") for b in bases]
    say(f"  {C3_FILES} volumes, {sum(sizes)} bytes of .dat ({min(sizes)}-"
        f"{max(sizes)} each; set-up {time.perf_counter() - t0:.1f} s)")
    st = pipe.PipeStats()
    total, wall = drive(
        f"encode_volumes ({C3_FILES} volumes)",
        lambda: batch.encode_volumes(bases, device=dev, stats=st),
        {"transpose": True, "swar": False}, launches)
    check(total == sum(DEFAULT_SCHEME.shard_file_size(n) for n in sizes)
          * DEFAULT_SCHEME.data_shards,
          f"encode_volumes: {total} bytes packed in {st.batches} batches")
    res = {"volumes": C3_FILES, "dat_bytes": sum(sizes),
           "gibps": sum(sizes) / GIB / wall, "wall_s": wall,
           "launches": counts(), "stages": st.to_dict()}
    say(f"  encode_volumes: {res['gibps']:.3f} GiB/s of .dat on {label}; "
        f"{json.dumps(res)}")
    same = 0
    for b in bases:
        single = b + "_single"
        os.link(b + ".dat", single + ".dat")
        encode.write_ec_files(single, device=dev)
        same += all(sha256_file(ec_files.shard_path(b, i))
                    == sha256_file(ec_files.shard_path(single, i))
                    for i in range(DEFAULT_SCHEME.total_shards))
    check(same == C3_FILES, f"encode_volumes: {same} of {C3_FILES} volumes' "
          f"14 shard files sha256-equal to a single-volume write_ec_files")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # every phase but config 3's auto pass pins large host slabs to the
    # card, so that each launch count means what it says
    os.environ[DISPATCH] = "device"
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

    say("phase native:")
    native_phase()

    say("phase path:")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pres = path_phase(dev, workdir, label)
        launches = pres["launches"]
        say("phase repair under load (config 5):")
        repair_phase(dev, os.path.join(workdir, "config5"),
                     DEFAULT_SCHEME.shard_file_size(VOLUME_BYTES), launches)
        say("phase config 4 (RS(6,3) and RS(12,4), 1 GiB volume):")
        config4_phase(dev, pres, label, launches)
        say("phase config 3 (1000 x 30 MiB volumes, coalesced):")
        config3_phase(dev, label, launches)
        say("phase config 3, file level:")
        config3_files_phase(dev, os.path.join(workdir, "config3"), label,
                            launches)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"  launches on the main path: {json.dumps(launches)}")

    rows = []
    for name, k in KERNELS.items():
        ms, plain_ms, bound_ms = kres["timings"][(name, kres["slab"])]
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": launches[name],
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
