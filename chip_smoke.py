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
   RS(12,4) parity rows, a ragged S and the scrub's parity-proof chunk
   ``(1, 10, 4 MiB)``; then a sweep that launches every
   instance the dispatch has (1-8 outputs of 10 inputs; 4, 6, 12 and 70
   inputs; 12 outputs; a ragged S), also against the numpy oracle; then
   each kernel's time at the slab, the rebuild chunk and the scrub chunk
   beside its plain version's and its memory bound, and its blocks per
   SM;
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
6. shell (config 1 through the admin shell): the path phase's needles
   written through ``Store.write_needle`` into a store of two disk
   locations (.dat and .idx sha256-equal to the path phase's; the
   ingest rate of the write_needle calls alone printed, with
   ``Needle.to_bytes`` timed apart on the same needles), then ``shell.cli.main`` in this process with
   ``ec.encode; ec.balance; volume.list`` (shards, .ecx and .vif held
   against the path phase's, spread over both locations, one launch per
   batch), ``ec.rebuild`` after losing 2 shards in each location, and
   ``ec.decode`` after losing data shards 0 and 5 (.dat, .idx and every
   needle read back through ``Store.read_needle``); then ``python -m
   seaweedfs_tpu_torch shell`` in its own process on a 16 MiB volume,
   held against an in-process encode; each command's wall seconds and
   GiB/s beside the direct call's;
7. cluster (config 1 through two port volume servers, A and B, in this
   process with no master, over localhost gRPC and HTTP): the path
   phase's needles POSTed to A (.dat and .idx sha256-equal to the path
   phase's; MiB/s), ``VolumeEcShardsGenerate`` (shards, .ecx and .vif
   sha256-equal to the sealed ones, one launch per batch; GiB/s beside
   the direct encode), every needle read by HTTP GET from A's shards (no
   launch), ``VolumeEcShardsCopy`` of every shard to B (sha256-equal,
   GiB/s) and one ``VolumeEcShardRead`` range, every needle read from B
   with shards 0, 5, 11 and 13 deleted (reconstruct-on-read: needles/s,
   p50, p99, launches, host-codec calls), ``VolumeEcShardsRebuild``
   (sha256-equal), ``VolumeEcShardsToVolume`` after losing data shards 0
   and 5 (.dat and .idx sha256-equal, every needle read back); then
   ``python -m seaweedfs_tpu_torch volume`` in its own process (status,
   one POST, one GET, SIGTERM);
8. repair under load (BASELINE config 5): ``repair_bench.run`` for 8 s,
   a bulk decode of 4 lost shards through the kernels while 8 reader
   threads send 64 QPS of 4 KiB interval repairs, all checked;
9. config 4: the restored volume sealed with RS(6,3) and RS(12,4), m
   shards rebuilt, and the volume decoded after losing data shards 0 and
   3, all sha256-checked, parity against ``rs_ref`` on sampled rows;
10. mesh (the multi-device split, ``parallel/mesh.py``): (a) through the
   normal routing, the shell's ``ec.encode -mesh 1,1`` in turns with the
   unsplit ``ec.encode`` (a warm-up, then A, B, B, A twice) on config 1's
   volume, shards and .ecx sha256-equal and launches equal (one per
   batch), then ``ec.rebuild -mesh 1,1`` after losing 4 shards (one
   launch per chunk); (b) the dry-run twin (``parallel/dryrun.run``)
   over four ``cuda:0`` entries as a 2 x 2 grid, and
   ``encode_parity_host_sharded`` on a (25, 10, 1 MiB) slab over that
   grid (B pads to 26, S splits in two: 4 launches), byte-equal to the
   unsplit path and to ``rs_ref`` on sampled rows; (c) ``-mesh 2,2``
   refused on one card with no file changed;
11. config (the shell's ``-config``): on config 1's volume through
   ``shell.cli.main``, (a) a TOML of ``[pipeline] double_buffer``,
   ``[mesh]`` 1 x 1 and ``[flight]``: ``ec.encode -keepSource;
   pipeline.status; pipeline.analyze; pipeline.dump -trace`` (shards,
   .ecx and .vif sha256-equal to the sealed ones, one launch per batch,
   one read / h2d / dispatch / d2h_sync / write span per batch in the
   trace), then ``ec.rebuild`` of 4 lost shards; (b) ``double_buffer``
   off against on over the 1 x 1 split (off copies on the side stream
   ahead of each kernel, on copies on a copy stream one batch ahead),
   (c) the flight recorder disarmed against armed (the armed runs print
   ``pipeline.analyze``), each a warm-up of each side then A, B, B, A
   with both medians and their ratio, launches checked on every encode
   and the files sha256-checked on one of each side;
12. storage (the engine at rest, on config 1's volume): (a) a seeded
   .idx of 1,000,000 needles with 10% deleted loaded by the memory,
   native and sqlite needle maps (equal live entries and counters, the
   native library built), with each load's seconds; (b) every third
   needle deleted and ``volume.vacuum`` run through ``shell.cli.main``,
   then ``vacuum_volume`` through ``Store(needle_map="native")`` and
   ``Store(needle_map="sqlite")``: the .dat sha256-equal to the
   superblock plus the live records, every live needle equal, the
   deleted gone, compact_revision 1, all three runs' .dat and .idx
   equal, GiB/s of live bytes copied; (c) a crash at
   ``crash.vacuum.midcommit`` and a reload that installs the .cpx and
   serves every acknowledged needle; (d) ``ec.encode`` of the compacted
   volume, ``scrub_ec``'s baseline with one parity-proof launch per
   4 MiB chunk, then one byte flipped in shards 3 and 12 and both
   quarantined and rebuilt to their sealed sha256; (e) ``scrub_volume``
   repairing one rotten needle from an intact copy, needles/s;
13. config 3 (the many-volume batcher): ``batch.encode_many`` over 1000
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
import contextlib
import hashlib
import io
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
from seaweedfs_tpu_torch.parallel import dryrun, mesh
from seaweedfs_tpu_torch.pipeline import (batch, decode, encode, pipe, read,
                                          rebuild, repair, repair_bench,
                                          stripe)
from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.shell import cli
from seaweedfs_tpu_torch.shell import commands as shell_commands
from seaweedfs_tpu_torch.storage import ec_files, idx as idx_mod
from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage import (needle_map_native,
                                         needle_map_sqlite, scrubber,
                                         superblock)
from seaweedfs_tpu_torch.storage import store as store_mod
from seaweedfs_tpu_torch.storage import volume as volume_mod
from seaweedfs_tpu_torch.util import faults

SEED = 20261016
MIB = 1 << 20
#: the checkout's root: ``python -m seaweedfs_tpu_torch`` runs from here
REPO = os.path.dirname(os.path.abspath(__file__))
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

def scrub_case(parity) -> tuple:
    """scrub_ec's parity proof: one (1, 10, 4 MiB) chunk of the data
    shards to the 4 parity shards (the storage phase's shape)."""
    return ("scrub parity-proof chunk", parity,
            (1, DEFAULT_SCHEME.data_shards, scrubber.EC_CHUNK_BYTES))


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
             k, MIB, pipe.current().batch_bytes), k, MIB))
        for k, m, _ in CONFIG4] + [
        ("RS(10,4) parity, ragged S", parity, (3, 10, MIB + 1000 + 3)),
        scrub_case(parity),
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
    for what, coefs, shape in main_shapes + [scrub_case(parity)]:
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
    idx_sha = sha256_file(base + ".idx")
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
        say(f"  page cache before the {mode} encode: {_dirty_mib()}")
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
    result["decode_gibps"] = gib / wall
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
                  idx_sha=idx_sha, idx_entries=idx_entries, sealed=sealed,
                  n_needles=n)
    say(f"  launches on the path phase: {json.dumps(launches)}")
    return result


# --------------------------------------------------------------------------
# shell phase: config 1 through the admin shell
# --------------------------------------------------------------------------

#: the pipeline calls the shell's ec.* commands make
SHELL_PIPELINE = ((encode, "encode_volume"), (rebuild, "rebuild_ec_files"),
                  (decode, "decode_volume"))


@contextlib.contextmanager
def _timed_commands(log: list):
    """Wrap every registered shell command so that each run appends
    (name, wall seconds, launches during it, seconds inside its pipeline
    calls) to ``log``."""
    saved = dict(shell_commands.COMMANDS)
    saved_calls = [getattr(mod, fn) for mod, fn in SHELL_PIPELINE]
    inner = [0.0]
    depth = [0]

    def timed_call(fn):
        def call(*args, **kwargs):   # outermost pipeline call only
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    inner[0] += time.perf_counter() - t0
        return call

    def wrap(name, fn):
        def run(env, argv):
            before = counts()
            inner[0] = 0.0
            t0 = time.perf_counter()
            fn(env, argv)
            wall = time.perf_counter() - t0
            log.append((name, wall, {k: v - before[k]
                                     for k, v in counts().items()},
                        inner[0]))
        return run

    shell_commands.COMMANDS.update(
        {name: wrap(name, fn) for name, fn in saved.items()})
    for (mod, fn), orig in zip(SHELL_PIPELINE, saved_calls):
        setattr(mod, fn, timed_call(orig))
    try:
        yield
    finally:
        shell_commands.COMMANDS.update(saved)
        for (mod, fn), orig in zip(SHELL_PIPELINE, saved_calls):
            setattr(mod, fn, orig)


def shell_main(args: list, log: list, launches: dict, what: str,
               expect=None) -> list:
    """``shell.cli.main`` in this process with every launch count set to
    0 just before it; ``expect`` says which kernels it must launch (by
    default the transpose kernel only); returns its printed lines."""
    out = io.StringIO()

    def run():
        with contextlib.redirect_stdout(out):
            return cli.main(args)

    with _timed_commands(log):
        rc, _ = drive(what, run,
                      expect or {"transpose": True, "swar": False},
                      launches)
    lines = out.getvalue().splitlines()
    for line in lines:
        say(f"  > {line}")
    check(rc == 0, f"{what}: exit {rc}")
    return lines


def shell_phase(dev, workdir: str, pres: dict, label: str,
                launches: dict) -> dict:
    """Config 1 through the port's admin shell: the path phase's needles
    written through ``Store.write_needle`` into a store of two disk
    locations, then ``ec.encode; ec.balance; volume.list``, a rebuild of
    4 lost shards, and a decode after losing 2 data shards, each held
    against the path phase's files; then one ``python -m
    seaweedfs_tpu_torch shell`` subprocess on a 16 MiB volume."""
    t_phase = time.perf_counter()
    scheme = DEFAULT_SCHEME
    a, b = os.path.join(workdir, "A"), os.path.join(workdir, "B")
    os.makedirs(a)
    os.makedirs(b)
    vid = 1
    dat_size = os.path.getsize(pres["base"] + ".dat")
    gib = dat_size / GIB
    shard_size = scheme.shard_file_size(dat_size)
    result = {}

    # 1-4: the path phase's needles through the Store, every write
    # acknowledged under the commit policy (2 fsyncs each). Only the
    # write_needle calls are timed; making each needle and hashing it
    # for the check are not. Needle.to_bytes (the CRC32-C and the
    # record's assembly, which write_needle runs too) is timed on its
    # own on the same needles, outside the write_needle window.
    store = store_mod.Store([a, b])
    vol = store.create_volume(vid)
    version = vol.super_block.version
    needles = volume_mod.synthetic_needles(avg_size=MIB, seed=SEED)
    written = {}
    write_s = to_bytes_s = 0.0
    while vol.dat_size < VOLUME_BYTES:
        n = next(needles)
        t0 = time.perf_counter()
        n.to_bytes(version)
        t1 = time.perf_counter()
        store.write_needle(vid, n)
        t2 = time.perf_counter()
        to_bytes_s += t1 - t0
        write_s += t2 - t1
        written[n.id] = (n.cookie, hashlib.sha256(n.data).digest())
    store.close()
    vbase = os.path.join(os.path.dirname(vol.base), str(vid))
    result["ingest"] = {
        "needles": len(written), "write_needle_s": write_s,
        "needles_per_s": len(written) / write_s,
        "mib_per_s": dat_size / MIB / write_s,
        "to_bytes_s": to_bytes_s,
        "ms_per_needle": 1e3 * write_s / len(written),
        "to_bytes_ms_per_needle": 1e3 * to_bytes_s / len(written),
        "fsyncs": 2 * len(written)}
    say(f"  ingest through Store.write_needle on {label}: "
        f"{json.dumps(result['ingest'])}")
    check(len(written) == pres["n_needles"]
          and sha256_file(vbase + ".dat") == pres["dat_sha"],
          f"{len(written)} needles written through Store.write_needle: "
          f".dat sha256-equal to the path phase's volume, superblock "
          f"included")
    check(sha256_file(vbase + ".idx") == pres["idx_sha"],
          ".idx sha256-equal to the path phase's volume")

    # 5: seal, spread, list in one session
    log: list = []
    lines = shell_main(["-dir", a, "-dir", b, "-c",
                        f"ec.encode -volumeId {vid}; ec.balance; "
                        f"volume.list"], log, launches,
                       "shell ec.encode; ec.balance; volume.list")
    sealed = pres["sealed"]
    sealed_shards = {ec_files.shard_ext(i): sealed[ec_files.shard_ext(i)]
                     for i in range(scheme.total_shards)}

    def shard_paths() -> dict:
        st = store_mod.Store([a, b])
        return st.ec_shard_paths(vid)

    def digests(ids) -> dict:
        paths = shard_paths()
        return {ec_files.shard_ext(i): sha256_file(paths[i]) for i in ids}

    in_a = ec_files.present_shards(os.path.join(a, str(vid)))
    in_b = ec_files.present_shards(os.path.join(b, str(vid)))
    check(digests(range(scheme.total_shards)) == sealed_shards
          and sha256_file(vbase + ".ecx") == sealed[".ecx"],
          "shell ec.encode: 14 shards and .ecx sha256-equal to the path "
          "phase's")
    # the shell seals a registered volume, so its .vif carries the
    # volume's replica placement (000); the path phase's direct call
    # passed none. Same file otherwise:
    vi = ec_files.VolumeInfo.load(pres["base"])
    vi.replication = "000"
    ref = os.path.join(workdir, "vif_ref")
    vi.save(ref)
    check(sha256_file(vbase + ".vif") == sha256_file(ref + ".vif"),
          "shell ec.encode: .vif sha256-equal to the path phase's with "
          "replication 000 from the volume's superblock")
    check(len(in_a) == len(in_b) == 7
          and sorted(in_a + in_b) == list(range(scheme.total_shards)),
          f"ec.balance: shards {in_a} in A, {in_b} in B")
    check(any(line.startswith(f"ec volume {vid} ") and
              f"shards={list(range(scheme.total_shards))}" in line
              for line in lines), "volume.list lists all 14 shards")
    batches = len(list(encode.plan_batches(dat_size, scheme,
                                           pipe.current().batch_bytes)))
    enc_log = [e for e in log if e[0] == "ec.encode"][0]
    check(enc_log[2]["transpose"] == batches and enc_log[2]["swar"] == 0,
          f"shell ec.encode: transpose kernel launched "
          f"{enc_log[2]['transpose']} times, one per batch ({batches})")
    result["encode"] = enc_log

    # 6: lose 2 shards in each location, rebuild
    lost = sorted([in_a[1], in_a[-1], in_b[3], in_b[-1]])
    for i in lost:
        os.remove(shard_paths()[i])
    check(len(shard_paths()) == scheme.total_shards - len(lost),
          f"shards {lost} removed, 2 from each location")
    log.clear()
    lines = shell_main(["-dir", a, "-dir", b, "-c",
                        f"ec.rebuild -volumeId {vid}"], log, launches,
                       "shell ec.rebuild")
    check(lines == [f"ec.rebuild volume {vid}: rebuilt {lost}"]
          and digests(range(scheme.total_shards)) == sealed_shards,
          f"shell ec.rebuild: shards {lost} rebuilt sha256-equal to the "
          f"sealed ones")
    result["rebuild"] = log[0]

    # 7: lose data shards 0 and 5, decode, read every needle back
    for i in LOST_DECODE:
        os.remove(os.path.realpath(shard_paths()[i]))
    log.clear()
    shell_main(["-dir", a, "-dir", b, "-c", f"ec.decode -volumeId {vid}"],
               log, launches, "shell ec.decode")
    result["decode"] = log[0]
    check(sha256_file(vbase + ".dat") == pres["dat_sha"]
          and sha256_file(vbase + ".idx") == pres["idx_sha"],
          "shell ec.decode: .dat and .idx sha256-equal to the originals")
    store = store_mod.Store([a, b])
    store.load_existing()
    try:
        bad = [k for k, (cookie, h) in written.items()
               if hashlib.sha256(store.read_needle(vid, k, cookie=cookie)
                                 .data).digest() != h]
    finally:
        store.close()
    check(not bad and not [p for d in (a, b) for p in os.listdir(d)
                           if ".ec" in p or p.endswith(".vif")],
          f"all {len(written)} needles read back through "
          f"Store.read_needle equal to the ones written; no EC file left")

    # 8: the CLI as an operator runs it, in its own process
    c, d = os.path.join(workdir, "C"), os.path.join(workdir, "D")
    os.makedirs(c)
    os.makedirs(d)
    volume_mod.write_synthetic_volume(os.path.join(c, "2"), 16 * MIB,
                                      avg_size=64 * 1024, seed=SEED + 2)
    for ext in (".dat", ".idx"):
        os.link(os.path.join(c, "2" + ext), os.path.join(d, "2" + ext))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-dir", c,
         "-c", "ec.encode -volumeId 2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    sub_wall = time.perf_counter() - t0
    for line in (r.stdout + r.stderr).splitlines():
        say(f"  $ {line}")
    check(r.returncode == 0,
          f"python -m seaweedfs_tpu_torch shell -dir C -c 'ec.encode "
          f"-volumeId 2' (16 MiB, own process, {sub_wall:.1f} s): exit 0")
    encode.encode_volume(os.path.join(d, "2"), replication="000",
                         device=dev)
    same = all(sha256_file(os.path.join(c, "2" + ext))
               == sha256_file(os.path.join(d, "2" + ext))
               for ext in [ec_files.shard_ext(i)
                           for i in range(scheme.total_shards)]
               + [".ecx", ".vif"])
    check(same, "the subprocess's 14 shards, .ecx and .vif sha256-equal "
          "to an in-process encode_volume")
    result["subprocess_s"] = sub_wall

    # 9: each command's rate beside the direct call's in this run
    for key, moved, direct in (
            ("encode", gib, pres["encode_overlapped_gibps"]),
            ("rebuild", len(lost) * shard_size / GIB, pres["rebuild_gibps"]),
            ("decode", gib, pres["decode_gibps"])):
        _, wall, _, inner = result[key]
        result[f"{key}_gibps"] = moved / wall
        say(f"  ec.{key}: {wall:.3f} s ({inner:.3f} s in the pipeline "
            f"call, {wall - inner:.3f} s of registry and file work), "
            f"{moved / wall:.3f} GiB/s through the shell vs "
            f"{direct:.3f} GiB/s direct ({moved / wall / direct:.2f}x) "
            f"on {label}")
    shutil.rmtree(a)
    shutil.rmtree(b)
    say(f"  shell phase: {time.perf_counter() - t_phase:.1f} s")
    return result


# --------------------------------------------------------------------------
# cluster phase: config 1 through two port volume servers
# --------------------------------------------------------------------------

def _dirty_mib() -> str:
    """The kernel's dirty and under-writeback page-cache MiB: what an
    encode's fsyncs wait behind."""
    try:
        with open("/proc/meminfo") as f:
            kib = {k: int(v.split()[0]) for k, v in
                   (line.split(":", 1) for line in f)
                   if k in ("Dirty", "Writeback")}
    except OSError:
        return "not readable"
    return ", ".join(f"{k} {v / 1024:.1f} MiB" for k, v in kib.items())


class _NeedleClock:
    """Stands in for ``time`` in storage/needle.py while the HTTP ingest
    runs: the server stamps each needle it writes with ``time_ns()``,
    and this clock hands out the stamps ``synthetic_needles`` gave the
    path phase's needles (its base plus the needle id, the ids in
    order), so the ingested volume must be byte-equal to that one."""

    def __init__(self):
        self.n = 0

    def time_ns(self) -> int:
        self.n += 1
        return 1_700_000_000_000_000_000 + self.n


def _http(conn, method: str, path: str, body=None) -> tuple:
    conn.request(method, path, body=body)
    r = conn.getresponse()
    return r.status, r.read()


def cluster_phase(dev, workdir: str, pres: dict, label: str,
                  launches: dict) -> dict:
    """Config 1 through two port volume servers, A and B, in this process
    on the card with no master (``master_url=""``), over localhost gRPC
    and HTTP, this phase driving the choreography the shell would:
    allocate on A, ingest the path phase's needles by HTTP POST, seal
    with ``VolumeEcShardsGenerate``, read every needle from A's shards,
    copy all shards to B, read every needle from B with shards 0, 5, 11
    and 13 lost (reconstruct-on-read), rebuild them, decode with
    ``VolumeEcShardsToVolume``; then ``python -m seaweedfs_tpu_torch
    volume`` in its own process. The peer lookup through a master
    (``ec_shard_peers``) is not driven here: the port has no master yet,
    and it runs in tier-1 against the JAX master."""
    import http.client

    import grpc

    from seaweedfs_tpu_torch import pb
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           _grpc_port,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.storage.types import FileId

    t_phase = time.perf_counter()
    scheme = DEFAULT_SCHEME
    vid = 1
    dat_size = os.path.getsize(pres["base"] + ".dat")
    gib = dat_size / GIB
    sealed = pres["sealed"]
    result = {}
    dirs = {name: os.path.join(workdir, name) for name in "AB"}
    servers, channels = {}, []
    for name, d in dirs.items():
        os.makedirs(d)
        servers[name] = VolumeServer(store_mod.Store([d]),
                                     port=free_port_pair(),
                                     device=dev).start()

    def stub(name):
        ch = grpc.insecure_channel(
            f"127.0.0.1:{_grpc_port(servers[name].port)}",
            options=[("grpc.max_receive_message_length", 64 * MIB)])
        channels.append(ch)
        return pb.volume_stub(ch)

    a, b = stub("A"), stub("B")
    conns = {name: http.client.HTTPConnection("127.0.0.1", vs.port,
                                              timeout=300)
             for name, vs in servers.items()}
    abase = os.path.join(dirs["A"], str(vid))
    bbase = os.path.join(dirs["B"], str(vid))
    try:
        # 1-2: allocate on A, then the path phase's needles by HTTP POST
        a.AllocateVolume(vpb.AllocateVolumeRequest(volume_id=vid))
        vol = servers["A"].store.get_volume(vid)
        needles = volume_mod.synthetic_needles(avg_size=MIB, seed=SEED)
        written = {}
        post_s = 0.0
        real_time = needle_mod.time
        needle_mod.time = _NeedleClock()
        try:
            while vol.dat_size < VOLUME_BYTES:
                n = next(needles)
                fid = str(FileId(vid, n.id, n.cookie))
                t0 = time.perf_counter()
                code, body = _http(conns["A"], "POST", f"/{fid}", n.data)
                post_s += time.perf_counter() - t0
                if code != 201:
                    raise SmokeError(f"POST {fid}: {code} {body[:200]!r}")
                written[fid] = hashlib.sha256(n.data).digest()
        finally:
            needle_mod.time = real_time
        result["ingest"] = {
            "needles": len(written), "post_s": post_s,
            "needles_per_s": len(written) / post_s,
            "mib_per_s": dat_size / MIB / post_s,
            "ms_per_needle": 1e3 * post_s / len(written)}
        say(f"  HTTP ingest into A on {label}: "
            f"{json.dumps(result['ingest'])}")
        check(len(written) == pres["n_needles"]
              and sha256_file(abase + ".dat") == pres["dat_sha"]
              and sha256_file(abase + ".idx") == pres["idx_sha"],
              f"{len(written)} needles POSTed to A: .dat and .idx "
              f"sha256-equal to the path phase's volume")

        def read_all(name: str, what: str, expect: dict) -> list:
            """GET every needle from server ``name`` with the launch
            counts set to 0 just before; each body held against the
            written one; returns each GET's seconds."""
            times = []

            def run():
                for fid, digest in written.items():
                    t0 = time.perf_counter()
                    code, body = _http(conns[name], "GET", f"/{fid}")
                    times.append(time.perf_counter() - t0)
                    if code != 200 or \
                            hashlib.sha256(body).digest() != digest:
                        raise SmokeError(f"{what}: GET {fid} gave {code}")
            drive(what, run, expect, launches)
            check(len(times) == len(written), f"{what}: all "
                  f"{len(written)} needles equal to the ones written")
            return times

        # 3: seal on A, one launch per batch. Its baseline is a direct
        # encode_volume of A's own .dat just before, in the same cache
        # state (its files removed again); comparison launches, not
        # counted in the main-path totals
        a.VolumeMarkReadonly(vpb.VolumeMarkReadonlyRequest(volume_id=vid))
        batches = len(list(encode.plan_batches(dat_size, scheme,
                                               pipe.current().batch_bytes)))
        say(f"  page cache before the direct encode of A's .dat: "
            f"{_dirty_mib()}")
        st = pipe.PipeStats()
        _, direct_wall = drive(
            "encode_volume of A's .dat (baseline)",
            lambda: encode.encode_volume(abase, scheme, device=dev,
                                         stats=st),
            {"transpose": True, "swar": False},
            {name: 0 for name in KERNELS})
        check(sealed_digests(abase) == sealed, "encode_volume of A's .dat: "
              "sha256-equal to the path phase's sealed files")
        for name in sealed:
            os.remove(abase + name)
        say(f"  encode_volume of A's .dat: {gib / direct_wall:.3f} GiB/s in "
            f"{direct_wall:.3f} s on {label}; stages "
            f"{json.dumps(st.to_dict())}")
        say(f"  page cache before VolumeEcShardsGenerate: {_dirty_mib()}")
        _, wall = drive("VolumeEcShardsGenerate on A",
                        lambda: a.VolumeEcShardsGenerate(
                            vpb.VolumeEcShardsGenerateRequest(volume_id=vid)),
                        {"transpose": True, "swar": False}, launches)
        got = counts()["transpose"]
        check(got == batches, f"VolumeEcShardsGenerate: transpose kernel "
              f"launched {got} times, one per batch ({batches})")
        check(sealed_digests(abase) == sealed,
              "VolumeEcShardsGenerate: 14 shards, .ecx and .vif "
              "sha256-equal to the path phase's sealed files")
        result["generate_gibps"] = gib / wall
        result["generate_direct_gibps"] = gib / direct_wall
        say(f"  VolumeEcShardsGenerate: {gib / wall:.3f} GiB/s of .dat in "
            f"{wall:.3f} s vs encode_volume of the same .dat just before "
            f"{gib / direct_wall:.3f} GiB/s ({direct_wall / wall:.2f}x) on "
            f"{label}")

        # 4: mount, drop the .dat, read every needle from A's shards
        a.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
            volume_id=vid, shard_ids=list(range(scheme.total_shards))))
        a.VolumeDelete(vpb.VolumeDeleteRequest(volume_id=vid))
        check(not os.path.exists(abase + ".dat"), "VolumeDelete: A's .dat "
              "gone, its shards mounted")
        times = read_all("A", "GET from A's local shards",
                         {"transpose": False, "swar": False})
        result["local_read_needles_per_s"] = len(times) / sum(times)
        say(f"  GET from A's shards: {len(times) / sum(times):.1f} "
            f"needles/s, host-codec calls "
            f"{rs_native.apply_gf_matrix.calls} on {label}")

        # 5: B copies every shard, .ecx, .ecj (absent) and .vif from A
        moved = sum(os.path.getsize(abase + n) for n in sealed)
        t0 = time.perf_counter()
        b.VolumeEcShardsCopy(vpb.VolumeEcShardsCopyRequest(
            volume_id=vid, shard_ids=list(range(scheme.total_shards)),
            copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
            source_data_node=servers["A"].url))
        copy_s = time.perf_counter() - t0
        result["copy_gibps"] = moved / GIB / copy_s
        say(f"  VolumeEcShardsCopy A -> B: {moved} bytes in {copy_s:.3f} s,"
            f" {moved / GIB / copy_s:.3f} GiB/s on {label}")
        check(sealed_digests(bbase) == sealed and
              not os.path.exists(bbase + ".ecj"),
              "VolumeEcShardsCopy: B's 14 shards, .ecx and .vif "
              "sha256-equal to A's")
        off, size = 12345, MIB + 7
        got = b"".join(r.data for r in a.VolumeEcShardRead(
            vpb.VolumeEcShardReadRequest(volume_id=vid, shard_id=3,
                                         offset=off, size=size)))
        with open(ec_files.shard_path(abase, 3), "rb") as f:
            f.seek(off)
            check(got == f.read(size), f"VolumeEcShardRead of shard 3 "
                  f"[{off}, {off + size}) equal to the file's bytes")
        b.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
            volume_id=vid, shard_ids=list(range(scheme.total_shards))))

        # 6: lose 4 shards on B, reconstruct-on-read
        b.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
            volume_id=vid, shard_ids=list(LOST_READ)))
        times = read_all("B", f"GET from B with shards {list(LOST_READ)} "
                         f"lost (reconstruct-on-read)",
                         {"transpose": True, "swar": False})
        ms = np.asarray(times) * 1e3
        result["degraded_read"] = {
            "needles_per_s": len(times) / sum(times),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "launches": counts(),
            "host_codec_calls": rs_native.apply_gf_matrix.calls,
            "intervals_repaired": servers["B"].metrics.counter(
                "ec_intervals_repaired").value}
        say(f"  degraded GET from B on {label}: "
            f"{json.dumps(result['degraded_read'])}")

        # 7: rebuild the lost shards on B
        resp, wall = drive(
            "VolumeEcShardsRebuild on B",
            lambda: b.VolumeEcShardsRebuild(
                vpb.VolumeEcShardsRebuildRequest(volume_id=vid)),
            {"transpose": True, "swar": False}, launches)
        check(list(resp.rebuilt_shard_ids) == list(LOST_READ)
              and sealed_digests(bbase) == sealed,
              f"VolumeEcShardsRebuild: {list(resp.rebuilt_shard_ids)} "
              f"rebuilt sha256-equal to the sealed shards")
        shard_size = scheme.shard_file_size(dat_size)
        result["rebuild_gibps"] = len(LOST_READ) * shard_size / GIB / wall
        say(f"  VolumeEcShardsRebuild: {wall:.3f} s, "
            f"{result['rebuild_gibps']:.3f} GiB/s of rebuilt shards vs "
            f"{pres['rebuild_gibps']:.3f} direct on {label}")

        # 8: lose data shards 0 and 5, decode back to a volume
        b.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
            volume_id=vid, shard_ids=list(LOST_DECODE)))
        _, wall = drive(
            "VolumeEcShardsToVolume on B",
            lambda: b.VolumeEcShardsToVolume(
                vpb.VolumeEcShardsToVolumeRequest(volume_id=vid)),
            {"transpose": True, "swar": False}, launches)
        result["to_volume_gibps"] = gib / wall
        say(f"  VolumeEcShardsToVolume: {wall:.3f} s, {gib / wall:.3f} "
            f"GiB/s of .dat vs decode_volume {pres['decode_gibps']:.3f} "
            f"direct on {label}")
        check(sha256_file(bbase + ".dat") == pres["dat_sha"]
              and sha256_file(bbase + ".idx") == pres["idx_sha"]
              and servers["B"].store.has_volume(vid),
              "VolumeEcShardsToVolume: .dat and .idx sha256-equal to the "
              "originals, the volume mounted again")
        read_all("B", "GET from B's decoded volume",
                 {"transpose": False, "swar": False})
    finally:
        for c in conns.values():
            c.close()
        for ch in channels:
            ch.close()
        for vs in servers.values():
            vs.stop()
    shutil.rmtree(dirs["A"])
    shutil.rmtree(dirs["B"])

    # 9: the volume server as an operator runs it, in its own process
    c = os.path.join(workdir, "C")
    os.makedirs(c)
    port = free_port_pair()
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-dir", c,
         "-mserver", "", "-port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        conn = None
        while time.perf_counter() - t0 < 180 and proc.poll() is None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=30)
                code, body = _http(conn, "GET", "/status")
                break
            except OSError:
                conn = None
                time.sleep(0.2)
        check(conn is not None and code == 200,
              f"python -m seaweedfs_tpu_torch volume: /status answers "
              f"{json.loads(body) if conn else None} after "
              f"{time.perf_counter() - t0:.1f} s")
        ch = grpc.insecure_channel(f"127.0.0.1:{_grpc_port(port)}")
        pb.volume_stub(ch).AllocateVolume(
            vpb.AllocateVolumeRequest(volume_id=2))
        ch.close()
        data = np.random.default_rng(SEED).integers(
            0, 256, 3 * MIB, dtype=np.uint8).tobytes()
        fid = str(FileId(2, 77, 0x1234abcd))
        posted = _http(conn, "POST", f"/{fid}", data)[0]
        code, body = _http(conn, "GET", f"/{fid}")
        check(posted == 201 and code == 200 and body == data,
              "python -m seaweedfs_tpu_torch volume: one POST and one GET "
              "of 3 MiB, equal bytes")
        conn.close()
    finally:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    for line in (out + err).splitlines()[-5:]:
        say(f"  $ {line}")
    check(proc.returncode == 0, f"the volume subprocess stopped on SIGTERM "
          f"with exit {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s")
    result["subprocess_s"] = time.perf_counter() - t0
    shutil.rmtree(c)
    result["seconds"] = time.perf_counter() - t_phase
    say(f"  cluster phase: {result['seconds']:.1f} s")
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
# mesh: the multi-device split
# --------------------------------------------------------------------------

def mesh_phase(dev, workdir: str, pres: dict, label: str,
               launches: dict) -> dict:
    """(a) ``ec.encode -mesh 1,1`` through the shell in turns with the
    unsplit command, then ``ec.rebuild -mesh 1,1``; (b) the dry-run twin
    and a (25, 10, 1 MiB) slab over a 2 x 2 grid of cuda:0 cells; (c)
    ``-mesh 2,2`` refused on one card."""
    t_phase = time.perf_counter()
    scheme = DEFAULT_SCHEME
    vid = 1
    dat_size = os.path.getsize(pres["base"] + ".dat")
    shard_size = scheme.shard_file_size(dat_size)
    batches = len(list(encode.plan_batches(dat_size, scheme,
                                           pipe.current().batch_bytes)))
    chunks = -(-shard_size // rebuild.chunk_length(shard_size,
                                                   scheme.data_shards))
    dirs = {"unsplit": os.path.join(workdir, "unsplit"),
            "mesh 1,1": os.path.join(workdir, "mesh")}
    for d in dirs.values():
        os.makedirs(d)
        for ext in (".dat", ".idx"):
            os.link(pres["base"] + ext, os.path.join(d, f"{vid}{ext}"))
    result = {"encode_s": {name: [] for name in dirs}}

    # (a) a warm-up, then A, B, B, A twice: each run seals the same
    # volume into a directory with no shards (the previous run's removed
    # untimed). The host allocator caches the pinned pool buffers a run
    # frees, so only the first run pays for pinning them.
    for name in ("unsplit",) + ("unsplit", "mesh 1,1", "mesh 1,1",
                                "unsplit") * 2:
        d = dirs[name]
        for f in os.listdir(d):
            if not f.endswith((".dat", ".idx")):
                os.remove(os.path.join(d, f))
        flag = " -mesh 1,1" if name != "unsplit" else ""
        log: list = []
        shell_main(["-dir", d, "-c",
                    f"ec.encode -volumeId {vid} -keepSource{flag}"],
                   log, launches, f"shell ec.encode ({name})")
        _, wall, got, _inner = log[0]
        check(got == {"transpose": batches, "swar": 0},
              f"shell ec.encode ({name}): {got['transpose']} launches, one "
              f"per batch ({batches})")
        result["encode_s"][name].append(wall)
        check(not mesh.current().enabled, "the -mesh scope closed")
    result["warmup_s"] = result["encode_s"]["unsplit"].pop(0)
    digests = {name: sealed_digests(os.path.join(d, str(vid)))
               for name, d in dirs.items()}
    sealed = {n: h for n, h in pres["sealed"].items() if n != ".vif"}
    check(digests["mesh 1,1"] == digests["unsplit"]
          and {n: h for n, h in digests["mesh 1,1"].items()
               if n != ".vif"} == sealed,
          "shell ec.encode -mesh 1,1: 14 shards, .ecx and .vif sha256-equal "
          "to the unsplit command's (and shards and .ecx to the path "
          "phase's)")
    enc_s = result["encode_s"]
    med = {name: float(np.median(t)) for name, t in enc_s.items()}
    result["median_ratio"] = med["mesh 1,1"] / med["unsplit"]
    say(f"  ec.encode A/B on {label}: warm-up {result['warmup_s']} s, "
        f"then unsplit {enc_s['unsplit']} s, -mesh 1,1 "
        f"{enc_s['mesh 1,1']} s; medians {med['unsplit']:.3f} and "
        f"{med['mesh 1,1']:.3f} s, -mesh 1,1 / unsplit = "
        f"{result['median_ratio']:.3f} ({dat_size / GIB:.3f} GiB of .dat "
        f"each)")

    mbase = os.path.join(dirs["mesh 1,1"], str(vid))
    for i in LOST_REBUILD:
        os.remove(ec_files.shard_path(mbase, i))
    log = []
    lines = shell_main(["-dir", dirs["mesh 1,1"], "-c",
                        f"ec.rebuild -volumeId {vid} -mesh 1,1"],
                       log, launches, "shell ec.rebuild (mesh 1,1)")
    _, wall, got, _inner = log[0]
    check(lines == [f"ec.rebuild volume {vid}: rebuilt "
                    f"{list(LOST_REBUILD)}"]
          and got == {"transpose": chunks, "swar": 0},
          f"shell ec.rebuild -mesh 1,1: {got['transpose']} launches, one "
          f"per chunk ({chunks})")
    check(sealed_digests(mbase, shards=LOST_REBUILD)
          == {ec_files.shard_ext(i): pres["sealed"][ec_files.shard_ext(i)]
              for i in LOST_REBUILD},
          f"shell ec.rebuild -mesh 1,1: shards {list(LOST_REBUILD)} "
          f"sha256-equal to the sealed ones")
    result["rebuild_s"] = wall
    say(f"  ec.rebuild -mesh 1,1 on {label}: {wall:.3f} s, "
        f"{len(LOST_REBUILD) * shard_size / GIB / wall:.3f} GiB/s rebuilt")

    # (b) the split code on CUDA tensors: a 2 x 2 grid of cuda:0 cells
    cells = [dev] * 4
    res, wall = drive(f"dry run over [{dev}] * 4",
                      lambda: dryrun.run(cells),
                      {"transpose": True, "swar": False}, launches)
    check(res["mesh"] == {"dp": 2, "sp": 2} and res["mismatches"] == 0,
          f"dry-run twin over [{dev}] * 4: {json.dumps(res)}")
    grid = mesh.make_mesh(cells, dp=2, sp=2)
    enc = scheme.encoder(dev)
    rng = np.random.default_rng(SEED + 6)
    rows = batch.max_rows_per_batch(scheme.data_shards, MIB,
                                    pipe.current().batch_bytes)
    slab = rng.integers(0, 256, (rows, scheme.data_shards, MIB),
                        dtype=np.uint8)
    t0 = time.perf_counter()
    unsplit = np.asarray(enc.encode_parity_host(slab))
    unsplit_s = time.perf_counter() - t0
    got, split_s = drive(
        f"encode_parity_host_sharded {slab.shape} on a 2 x 2 grid",
        lambda: np.asarray(mesh.encode_parity_host_sharded(enc, slab,
                                                           grid)),
        {"transpose": True, "swar": False}, launches)
    check(counts()["transpose"] == 4,
          f"2 x 2 grid: {counts()['transpose']} launches for one slab, one "
          f"per cell (B = {rows} padded to {-(-rows // 2) * 2})")
    check(got.shape == unsplit.shape and np.array_equal(got, unsplit),
          f"2 x 2 grid: parity {got.shape} byte-equal to the unsplit path")
    # again, with the pinned staging and output buffers of the first
    # call cached by the host allocator
    t0 = time.perf_counter()
    np.asarray(mesh.encode_parity_host_sharded(enc, slab, grid))
    warm_s = time.perf_counter() - t0
    oracle = rs_ref.ReferenceEncoder(scheme.data_shards,
                                     scheme.parity_shards)
    span = 64 * 1024
    for r in (0, rows // 2 - 1, rows // 2, rows - 1):
        s0 = int(rng.integers(0, MIB - span))
        check(np.array_equal(got[r, :, s0:s0 + span],
                             oracle.encode_parity(slab[r, :, s0:s0 + span])),
              f"2 x 2 grid: row {r} bytes {s0}.. equal to rs_ref")
    say(f"  2 x 2 grid of {dev} cells on {label}: {split_s:.3f} s per "
        f"slab round trip, {warm_s:.3f} s the second time, against "
        f"{unsplit_s:.3f} s unsplit (a correctness phase: the cells share "
        f"one stream)")
    result.update(dryrun=res, slab_split_s=split_s, slab_warm_s=warm_s,
                  slab_unsplit_s=unsplit_s)
    del slab, got, unsplit

    # (c) -mesh 2,2 on one card: refused before any file changes
    def snapshot():
        out = {}
        for f in os.listdir(dirs["mesh 1,1"]):
            st = os.stat(os.path.join(dirs["mesh 1,1"], f))
            out[f] = (st.st_size, st.st_mtime_ns)
        return out

    before = snapshot()
    for line in (f"ec.encode -volumeId {vid} -mesh 2,2",
                 f"ec.rebuild -volumeId {vid} -mesh 2,2"):
        err = io.StringIO()

        def refused():
            with contextlib.redirect_stderr(err), \
                    contextlib.redirect_stdout(io.StringIO()):
                return cli.main(["-dir", dirs["mesh 1,1"], "-c", line])

        rc, _ = drive(f"shell {line}", refused,
                      {"transpose": False, "swar": False}, launches)
        msg = err.getvalue().strip()
        say(f"  > {msg}")
        check(rc == 1 and msg.startswith("error: ")
              and "cannot tile the 1 local device(s)" in msg
              and snapshot() == before,
              f"shell {line}: refused on one card (exit {rc}), no file "
              f"changed")
    for d in dirs.values():
        shutil.rmtree(d)
    say(f"  mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return result


# --------------------------------------------------------------------------
# config: the shell's -config ([pipeline], [mesh], [flight])
# --------------------------------------------------------------------------

#: the config phase's TOML files: (a) all three sections, the lookahead
#: over a 1 x 1 mesh; (b) the A/B of double_buffer; (d) the recorder
#: armed and disarmed on the unsplit path
CONFIGS = {
    "all": "[pipeline]\ndouble_buffer = true\n\n[mesh]\nenabled = true\n"
           "dp = 1\nsp = 1\n\n[flight]\nenabled = true\n",
    "lookahead off": "[pipeline]\ndouble_buffer = false\n\n[mesh]\n"
                     "enabled = true\ndp = 1\nsp = 1\n",
    "lookahead on": "[pipeline]\ndouble_buffer = true\n\n[mesh]\n"
                    "enabled = true\ndp = 1\nsp = 1\n",
    "disarmed": "[flight]\nenabled = false\n",
    "armed": "[flight]\nenabled = true\n",
}


def config_phase(dev, workdir: str, pres: dict, label: str,
                 launches: dict) -> dict:
    """Config 1's volume through ``shell.cli.main -config``: (a)
    ``[pipeline] double_buffer``, ``[mesh]`` 1 x 1 and ``[flight]``
    for an encode with ``pipeline.status``, ``pipeline.analyze`` and
    ``pipeline.dump -trace``, then a rebuild of 4 lost shards; (b) the
    A/B of ``double_buffer`` off and on, in turns; (c) the recorder
    armed against disarmed, in turns. Every encode's launches are
    counted against its plans; (a) and the first timed run of each side
    of (b) and (c) are sha256-checked (hashing 1.5 GB takes about a
    second, so not every run)."""
    t_phase = time.perf_counter()
    scheme = DEFAULT_SCHEME
    vid = 1
    dat_size = os.path.getsize(pres["base"] + ".dat")
    shard_size = scheme.shard_file_size(dat_size)
    batch_bytes = pipe.current().batch_bytes
    batches = len(list(encode.plan_batches(dat_size, scheme, batch_bytes)))
    chunks = -(-shard_size // rebuild.chunk_length(shard_size,
                                                   scheme.data_shards))
    d = os.path.join(workdir, "vol")
    os.makedirs(d)
    for ext in (".dat", ".idx"):
        os.link(pres["base"] + ext, os.path.join(d, f"{vid}{ext}"))
    base = os.path.join(d, str(vid))
    conf = {}
    for name, text in CONFIGS.items():
        conf[name] = os.path.join(workdir, name.replace(" ", "_") + ".toml")
        with open(conf[name], "w") as f:
            f.write(text)
    # the shell seals a registered volume: its .vif carries replication
    # 000 (the shell phase's check); shards and .ecx are the path phase's
    vi = ec_files.VolumeInfo.load(pres["base"])
    vi.replication = "000"
    vif_ref = os.path.join(workdir, "vif_ref")
    vi.save(vif_ref)
    sealed = dict(pres["sealed"], **{".vif": sha256_file(vif_ref + ".vif")})

    def clean():
        for f in os.listdir(d):
            if not f.endswith((".dat", ".idx")):
                os.remove(os.path.join(d, f))

    def run(what, config, want, commands="", verify=True):
        """One ``ec.encode -keepSource`` (plus ``commands``) through the
        shell into a directory with no shards: launches equal to
        ``want``, and with ``verify`` every file sha256-equal to the
        sealed one; returns (command wall seconds, seconds inside its
        pipeline call, lines)."""
        clean()
        log: list = []
        args = ["-dir", d] + (["-config", conf[config]] if config else [])
        lines = shell_main(args + ["-c", f"ec.encode -volumeId {vid} "
                                         f"-keepSource{commands}"],
                           log, launches, what)
        _, wall, got, inner = log[0]
        check(got == {"transpose": want, "swar": 0},
              f"{what}: {got['transpose']} launches ({want} planned)")
        if verify:
            check(sealed_digests(base) == sealed,
                  f"{what}: shards, .ecx and .vif sha256-equal to the "
                  f"sealed ones")
        return wall, inner, lines

    # (a) all three sections: the encode, its status, verdict and trace
    trace = os.path.join(workdir, "trace.json")
    wall, _inner, lines = run("shell -config (all three sections) ec.encode",
                      "all", batches, f"; pipeline.status; "
                      f"pipeline.analyze; pipeline.dump -trace {trace}")
    result = {"encode_s": wall}
    check(lines[1].endswith("double_buffer=True")
          and lines[2].startswith("  mesh: axes=dp1xsp1 ")
          and any(ln.startswith("pipeline.analyze: bottleneck: ")
                  for ln in lines),
          "pipeline.status shows the [pipeline] and [mesh] sections, "
          "pipeline.analyze names a bottleneck")
    with open(trace) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    per_batch = {name: sorted(e["args"]["batch"] for e in spans
                              if e["name"] == name)
                 for name in ("read", "dispatch", "d2h_sync", "write")}
    check(all(ids == list(range(batches)) for ids in per_batch.values())
          and sum(e["name"] == "h2d" for e in spans) == batches,
          f"the trace holds one read, h2d, dispatch, d2h_sync and write "
          f"span per batch ({batches} batches, {len(spans)} spans)")
    check(not mesh.current().enabled and not pipe.current().double_buffer,
          "the shell restored the config after the session")
    for i in LOST_REBUILD:
        os.remove(ec_files.shard_path(base, i))
    log: list = []
    lines = shell_main(["-dir", d, "-config", conf["all"], "-c",
                        f"ec.rebuild -volumeId {vid}; pipeline.analyze"],
                       log, launches, "shell -config ec.rebuild")
    _, wall, got, _inner = log[0]
    check(lines[0] == f"ec.rebuild volume {vid}: rebuilt "
                      f"{list(LOST_REBUILD)}"
          and got == {"transpose": chunks, "swar": 0}
          and sealed_digests(base) == sealed,
          f"shell -config ec.rebuild: {got['transpose']} launches, one per "
          f"chunk ({chunks}); shards sha256-equal to the sealed ones")
    result["rebuild_s"] = wall

    def turns(what, a, b, want, commands=""):
        """A warm-up of each side (the first run of a pool size pins its
        buffers, which the host allocator then caches), then A, B, B, A,
        timed inside the encode's pipeline call (the layer the knob acts
        on; the command's wall beside it); the medians and B / A. B's
        runs also run ``commands``."""
        times = {a: [], b: []}
        walls = {a: [], b: []}
        for i, name in enumerate((a, b, a, b, b, a)):
            wall, inner, _ = run(f"{what}: {name}", name, want[name],
                                 commands if name == b else "",
                                 verify=i in (2, 3))
            if i >= 2:
                times[name].append(inner)
                walls[name].append(wall)
        med = {k: float(np.median(v)) for k, v in times.items()}
        say(f"  {what} on {label}, seconds in the pipeline call: {a} "
            f"{times[a]}, {b} {times[b]}; medians {med[a]:.3f} and "
            f"{med[b]:.3f} s, {b} / {a} = {med[b] / med[a]:.3f} (command "
            f"walls: {a} {walls[a]}, {b} {walls[b]})")
        return {"s": times, "wall_s": walls, "median_ratio": med[b] / med[a]}

    # (b) double_buffer off against on, both through the 1 x 1 split:
    # off is the split's default placement (each batch's copy on the
    # side stream ahead of its kernel), on adds the copy stream and the
    # one-batch lookahead
    result["double_buffer"] = turns(
        "ec.encode A/B of [pipeline] double_buffer", "lookahead off",
        "lookahead on", {"lookahead off": batches, "lookahead on": batches})
    # (c) the recorder's own cost on the unsplit path, whose verdict
    # pipeline.analyze prints after each armed run
    result["flight"] = turns(
        "ec.encode with the flight recorder disarmed / armed", "disarmed",
        "armed", {"disarmed": batches, "armed": batches},
        commands="; pipeline.analyze")
    clean()
    shutil.rmtree(d)
    say(f"  config phase: {time.perf_counter() - t_phase:.1f} s")
    return result


# --------------------------------------------------------------------------
# storage: the engine at rest (needle maps, vacuum, crash, scrub)
# --------------------------------------------------------------------------

#: (a): a seeded .idx of a volume of a million ~30 KiB files, about 10%
#: of them deleted (one tombstone appended per deleted key).
MAP_NEEDLES = 1_000_000
MAP_NEEDLE_BYTES = 30 * 1024
MAP_DELETED = 0.1
#: (d): the bytes one parity-proof product covers per shard.
SCRUB_CHUNK = scrubber.EC_CHUNK_BYTES


def _map_counters(nm) -> tuple:
    return (len(nm), nm.file_count, nm.deleted_count, nm.deleted_bytes,
            nm.max_key, nm.max_offset_units)


def _write_map_idx(path: str) -> int:
    """MAP_NEEDLES entries at 8-byte aligned offsets of ~30 KiB records,
    then a tombstone for MAP_DELETED of the keys; returns the entries."""
    rng = np.random.default_rng(SEED + 8)
    n = MAP_NEEDLES
    sizes = rng.integers(MAP_NEEDLE_BYTES // 2, MAP_NEEDLE_BYTES * 3 // 2,
                         n, dtype=np.uint64)
    recs = -(-(sizes + 16 + 4 + 4 + 8 + 8) // 8) * 8   # padded records
    offsets = 8 + np.concatenate([[0], np.cumsum(recs[:-1])])
    dead = np.sort(rng.choice(n, int(n * MAP_DELETED), replace=False))
    rows = np.zeros(n + len(dead), dtype=[("key", ">u8"), ("off", ">u4"),
                                          ("size", ">u4")])
    rows["key"][:n] = np.arange(1, n + 1)
    rows["off"][:n] = offsets // 8
    rows["size"][:n] = sizes
    rows["key"][n:] = dead + 1
    rows["size"][n:] = 0xFFFFFFFF
    rows.tofile(path)
    return len(rows)


def _live_records(base: str, version: int = 3) -> list:
    """(key, byte offset, record bytes) of the live needles of a closed
    volume, in .dat order: what a compaction copies."""
    nm = idx_mod.CompactMap.load_from_idx(base + ".idx")
    return sorted(((e.key, e.byte_offset,
                    needle_mod.record_size(e.size, version))
                   for e in nm.live_entries()), key=lambda r: r[1])


def _record_digests(vol, keys) -> dict:
    """sha256 of each needle's record (header, data, CRC, timestamp) as
    the volume's read path serves it: equal records carry equal data,
    without the numpy CRC32-C pass a Needle.parse would add."""
    return {k: hashlib.sha256(vol.read_record(k)[0]).hexdigest()
            for k in keys}


def _flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def storage_phase(dev, workdir: str, pres: dict, label: str,
                  launches: dict) -> dict:
    """The storage engine at rest on config 1's volume: (a) a million-
    entry .idx through the memory, native and sqlite needle maps; (b)
    every third needle deleted and the volume compacted through the
    shell's ``volume.vacuum`` (memory map), then through
    ``Store(needle_map="native")`` and ``Store(needle_map="sqlite")``;
    (c) a crash at ``crash.vacuum.midcommit`` and the reload; (d)
    ``ec.encode`` of the compacted volume, ``scrub_ec``'s baseline (one
    parity-proof launch per 4 MiB chunk) and its repair of two rotten
    shards; (e) ``scrub_volume`` repairing one rotten needle from an
    intact copy."""
    t_phase = time.perf_counter()
    os.makedirs(workdir)
    result = {}
    vid = 1

    # (a) the three needle maps on one .idx
    idx_path = os.path.join(workdir, "map.idx")
    n_entries = _write_map_idx(idx_path)
    maps, secs = {}, {}
    for kind, load in (
            ("memory", lambda: idx_mod.CompactMap.load_from_idx(idx_path)),
            ("native", lambda: needle_map_native.NativeNeedleMap
             .load_from_idx(idx_path)),
            ("sqlite", lambda: needle_map_sqlite.SqliteNeedleMap
             .load_from_idx(os.path.join(workdir, "map.sdx"), idx_path))):
        t0 = time.perf_counter()
        maps[kind] = load()
        secs[kind] = time.perf_counter() - t0
    check(needle_map_native.available()
          and isinstance(maps["native"], needle_map_native.NativeNeedleMap),
          "the native needle map built with g++ (no fallback)")
    ref = _map_counters(maps["memory"])
    live = [(e.key, e.offset_units, e.size)
            for e in maps["memory"].live_entries()]
    for kind in ("native", "sqlite"):
        check(_map_counters(maps[kind]) == ref
              and [(e.key, e.offset_units, e.size)
                   for e in maps[kind].live_entries()] == live,
              f"{kind} map: live_entries and counters equal to the memory "
              f"map's ({ref[0]} live of {n_entries} .idx entries)")
    for m in maps.values():
        if hasattr(m, "close"):
            m.close()
    say(f"  needle maps, seconds to load {n_entries} .idx entries: "
        f"{json.dumps(secs)} on {label}")
    result["map_load_s"] = secs
    del maps, live

    # (b) every third needle deleted, then compacted three ways
    src = pres["base"]
    keys = [e.key for e in pres["idx_entries"]]
    deleted = set(keys[2::3])
    with volume_mod.Volume(src, vid).load() as v:
        want = _record_digests(v, [k for k in keys if k not in deleted])
    records = [r for r in _live_records(src) if r[0] not in deleted]
    live_bytes = sum(r[2] for r in records)
    new_sb = superblock.SuperBlock(compact_revision=1)

    def expected_dat_sha() -> str:
        """sha256 of the superblock (compact revision 1) and the live
        records, each 8-byte aligned, read from the original .dat."""
        h = hashlib.sha256(new_sb.to_bytes())
        pos = len(new_sb.to_bytes())
        with open(src + ".dat", "rb") as f:
            for _key, off, size in records:
                pad = (-pos) % 8
                h.update(b"\0" * pad)
                f.seek(off)
                h.update(f.read(size))
                pos += pad + size
        return h.hexdigest()

    want_dat = expected_dat_sha()

    def copy_volume(name: str) -> str:
        """The path phase's volume under ``name``: the .dat hard-linked
        (nothing below writes it in place: deletes append to the .idx
        and a compaction renames a new file over it), the .idx copied,
        every third needle deleted through a Store."""
        d = os.path.join(workdir, name)
        os.makedirs(d)
        os.link(src + ".dat", os.path.join(d, f"{vid}.dat"))
        shutil.copyfile(src + ".idx", os.path.join(d, f"{vid}.idx"))
        st = store_mod.Store([d])
        try:
            st.load_existing()
            done = sum(st.delete_needle(vid, k) for k in sorted(deleted))
        finally:
            st.close()
        if done != len(deleted):
            raise SmokeError(f"{name}: {done} of {len(deleted)} deletes")
        return d

    def check_compacted(d: str, what: str) -> dict:
        base = os.path.join(d, str(vid))
        digests = {ext: sha256_file(base + ext) for ext in (".dat", ".idx")}
        with volume_mod.Volume(base, vid).load() as v:
            check(v.super_block.compact_revision == 1
                  and isinstance(v.nm, idx_mod.CompactMap),
                  f"{what}: compact_revision 0 -> 1")
            got = _record_digests(v, sorted(want))
            gone = [k for k in deleted if v.nm.get(k) is not None]
        check(digests[".dat"] == want_dat,
              f"{what}: .dat sha256-equal to the superblock plus the "
              f"{len(records)} live records")
        check(got == want and not gone,
              f"{what}: every live needle's record sha256-equal to the "
              f"original, all {len(deleted)} deleted needles gone")
        return digests

    # through the shell: the memory map
    d_mem = copy_volume("vacuum_memory")
    t0 = time.perf_counter()
    lines = shell_main(["-dir", d_mem, "-c", f"volume.vacuum -volumeId {vid}"],
                       [], launches, "shell volume.vacuum (memory map)",
                       expect={"transpose": False, "swar": False})
    wall = time.perf_counter() - t0
    check(len(lines) == 1 and "reclaimed" in lines[0],
          "shell volume.vacuum: one 'reclaimed' line")
    rates = {"shell volume.vacuum (memory)": live_bytes / GIB / wall}
    mem_digests = check_compacted(d_mem, "shell volume.vacuum")
    dirs = {"memory": d_mem}
    for kind, nm_type in (("native", needle_map_native.NativeNeedleMap),
                          ("sqlite", needle_map_sqlite.SqliteNeedleMap)):
        d = copy_volume(f"vacuum_{kind}")
        st = store_mod.Store([d], needle_map=kind)
        try:
            st.load_existing()
            vol = st.get_volume(vid)
            check(isinstance(vol.nm, nm_type),
                  f"Store(needle_map={kind!r}) loads a {nm_type.__name__}")
            _, wall = drive(f"Store(needle_map={kind!r}).vacuum_volume",
                            lambda: st.vacuum_volume(vid),
                            {"transpose": False, "swar": False}, launches)
            check(isinstance(vol.nm, nm_type),
                  f"{kind}: the reloaded map is a {nm_type.__name__}")
        finally:
            st.close()
        rates[f"Store vacuum_volume ({kind})"] = live_bytes / GIB / wall
        check(check_compacted(d, f"{kind} vacuum") == mem_digests,
              f"{kind} vacuum: .dat and .idx sha256-equal to the memory "
              f"map's run")
        dirs[kind] = d
    say(f"  vacuum, GiB/s of live needles copied ({live_bytes} bytes of "
        f"{len(records)} needles): {json.dumps(rates)} on {label}")
    result["vacuum_gibps"] = rates

    # (c) a crash between the commit's two renames, then the reload
    d = copy_volume("vacuum_crash")
    base = os.path.join(d, str(vid))

    class Crash(BaseException):
        pass

    def crash(point):
        raise Crash(point)

    st = store_mod.Store([d])
    st.load_existing()
    faults.set_crash_handler(crash)
    faults.inject("crash.vacuum.midcommit", "crash#1")
    try:
        try:
            st.vacuum_volume(vid)
        except Crash:
            pass
        else:
            raise SmokeError("crash.vacuum.midcommit did not fire")
    finally:
        faults.clear()
        faults.set_crash_handler(None)
        st.close()
    check(not os.path.exists(base + ".cpd") and os.path.exists(base + ".cpx"),
          "crash at crash.vacuum.midcommit: the compacted .dat is live, "
          "its .cpx kept by cleanup (abort_compact)")
    st = store_mod.Store([d])
    try:
        st.load_existing()
        vol = st.get_volume(vid)
        got = _record_digests(vol, sorted(want))
        gone = [k for k in deleted if vol.nm.get(k) is not None]
    finally:
        st.close()
    check(not os.path.exists(base + ".cpx") and got == want and not gone,
          f"reload after the crash: the .cpx installed, all {len(want)} "
          f"acknowledged live needles served, deleted ones gone")
    shutil.rmtree(d)

    # (d) seal the compacted volume, scrub its shards on the card
    d = dirs["memory"]
    base = os.path.join(d, str(vid))
    scheme = DEFAULT_SCHEME
    shell_main(["-dir", d, "-c", f"ec.encode -volumeId {vid}"], [],
               launches, "shell ec.encode (the compacted volume)")
    shard_len = os.path.getsize(ec_files.shard_path(base, 0))
    sealed_shards = {i: sha256_file(ec_files.shard_path(base, i))
                     for i in range(scheme.total_shards)}
    scrubbed = scheme.total_shards * shard_len
    proof_launches = -(-shard_len // SCRUB_CHUNK)
    res, wall = drive("scrub_ec (baseline)",
                      lambda: scrubber.scrub_ec(base, scheme, device=dev),
                      {"transpose": True, "swar": False}, launches)
    got = counts()
    check(res["baseline"] and res["corrupt"] == 0
          and got["transpose"] == proof_launches,
          f"scrub_ec baseline: parity proven with {got['transpose']} "
          f"launches = ceil({shard_len} / {SCRUB_CHUNK})")
    result["scrub_ec_baseline"] = {"gibps": scrubbed / GIB / wall,
                                   "wall_s": wall, "launches": got}
    for sid in (3, 12):
        _flip_byte(str(ec_files.shard_path(base, sid)), shard_len // 2 + sid)
    res, wall = drive("scrub_ec (two rotten shards)",
                      lambda: scrubber.scrub_ec(base, scheme, device=dev),
                      {"transpose": True, "swar": False}, launches)
    check(res["corrupt"] == 2 and len(res["quarantined"]) == 2
          and res["repaired"] == 2 and res["repair_failed"] == 0,
          f"scrub_ec: shards 3 and 12 corrupt 2, quarantined "
          f"{len(res['quarantined'])}, repaired {res['repaired']}")
    check(all(sha256_file(ec_files.shard_path(base, i)) == sealed_shards[i]
              for i in range(scheme.total_shards)),
          "rebuilt shards 3 and 12 sha256-equal to the sealed ones")
    result["scrub_ec_repair"] = {"gibps": scrubbed / GIB / wall,
                                 "wall_s": wall, "launches": counts()}
    say(f"  scrub_ec, GiB/s of the 14 x {shard_len} shard bytes: "
        f"{json.dumps({k: result[k] for k in ('scrub_ec_baseline', 'scrub_ec_repair')})}"
        f" on {label}")

    # (e) one rotten needle in the native run's copy, repaired from the
    # sqlite run's (the two are sha256-equal)
    rotten = os.path.join(dirs["native"], str(vid))
    intact = volume_mod.Volume(os.path.join(dirs["sqlite"], str(vid)),
                               vid).load()
    vol = volume_mod.Volume(rotten, vid).load()
    try:
        victim = sorted(want)[len(want) // 2]
        _rec, off = vol.read_record(victim)
        _flip_byte(rotten + ".dat", off + 30)
        t0 = time.perf_counter()
        res = scrubber.scrub_volume(
            vol, fetch_record=lambda key: intact.read_record(key)[0])
        wall = time.perf_counter() - t0
        check(res["checked"] == len(want) and res["corrupt"] == 1
              and res["repaired"] == 1,
              f"scrub_volume: checked {res['checked']} of {len(want)}, "
              f"corrupt {res['corrupt']}, repaired {res['repaired']}")
        vol.read_needle(victim)            # parses: its CRC holds again
        check(_record_digests(vol, [victim])[victim] == want[victim],
              f"needle {victim} reads back equal")
    finally:
        vol.close()
        intact.close()
    result["scrub_volume"] = {"needles_per_s": res["checked"] / wall,
                              "wall_s": wall}
    say(f"  scrub_volume: {res['checked'] / wall:.1f} needles/s "
        f"({res['bytes'] / MIB / wall:.1f} MiB/s) on {label}")
    shutil.rmtree(workdir)
    say(f"  storage phase: {time.perf_counter() - t_phase:.1f} s")
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
                                        pipe.current().batch_bytes)
    rows = C3_VOLUMES * scheme.shard_file_size(C3_VOLUME_BYTES) // MIB
    want = {(rows_cap, k, MIB): rows // rows_cap}
    if rows % rows_cap:
        want[(rows % rows_cap, k, MIB)] = 1
    check(sum(census.values()) == st.batches and census == want,
          f"config 3 census: {dict(census)} "
          f"(batch bound {pipe.current().batch_bytes} bytes)")
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
    t_start = time.perf_counter()
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
        say("phase shell (config 1 through the admin shell):")
        shell_phase(dev, os.path.join(workdir, "shell"), pres, label,
                    launches)
        say("phase cluster (config 1 through two port volume servers):")
        cluster_phase(dev, os.path.join(workdir, "cluster"), pres, label,
                      launches)
        say("phase repair under load (config 5):")
        repair_phase(dev, os.path.join(workdir, "config5"),
                     DEFAULT_SCHEME.shard_file_size(VOLUME_BYTES), launches)
        say("phase config 4 (RS(6,3) and RS(12,4), 1 GiB volume):")
        config4_phase(dev, pres, label, launches)
        say("phase mesh (the multi-device split):")
        mesh_phase(dev, os.path.join(workdir, "mesh"), pres, label,
                   launches)
        say("phase config (the shell's -config):")
        config_phase(dev, os.path.join(workdir, "config"), pres, label,
                     launches)
        say("phase storage (needle maps, vacuum, crash, scrub):")
        storage_phase(dev, os.path.join(workdir, "storage"), pres, label,
                      launches)
        say("phase config 3 (1000 x 30 MiB volumes, coalesced):")
        config3_phase(dev, label, launches)
        say("phase config 3, file level:")
        config3_files_phase(dev, os.path.join(workdir, "config3"), label,
                            launches)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"  launches on the main path: {json.dumps(launches)}")
    say(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
        f"builds included")

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
