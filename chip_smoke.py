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
   ``rebuild_ec_files``; then the read phase: shards 0, 5, 11, 13
   removed, every 2nd needle read through
   ``EcVolumeReader`` (once directly, once from 8 threads through one
   ``IntervalRepairAggregator``) and held against the original ``.dat``,
   and the shards rebuilt; the volume decoded with ``decode_volume`` after
   losing shards 0 and 5, and encode + rebuild again with
   ``SEAWEEDFS_TORCH_KERNEL=swar``; launch counters prove each kernel ran,
   and the host codec's call counter which reads it served;
6. shell (config 1 through the admin shell): the path phase's first 513
   needle records copied into a store of two disk locations and the
   other 513 written through ``Store.write_needle`` (.dat and .idx
   sha256-equal to the path phase's; the ingest rate of the write_needle
   calls alone printed, with
   ``Needle.to_bytes`` timed apart on every 4th of the same needles), then ``shell.cli.main`` in this process with
   ``ec.encode; ec.balance; volume.list`` (shards, .ecx and .vif held
   against the path phase's, spread over both locations, one launch per
   batch), ``ec.rebuild`` after losing 2 shards in each location, and
   ``ec.decode`` after losing data shards 0 and 5 (.dat, .idx and every
   needle read back through ``Store.read_needle``); then ``python -m
   seaweedfs_tpu_torch shell`` in its own process on a 16 MiB volume,
   held against an in-process encode; each command's wall seconds and
   GiB/s beside the direct call's;
7. cluster (config 1 through a port master and two port volume servers,
   A and B on one rack, in this process, over localhost gRPC and HTTP):
   by RPC, the path phase's last 513 needles POSTed to A after its first
   513 records were copied there (.dat and .idx sha256-equal to the
   path phase's; MiB/s), ``VolumeEcShardsGenerate``
   (shards, .ecx and .vif sha256-equal to the sealed ones, one launch
   per batch; GiB/s beside the direct encode), every 4th needle read by
   HTTP GET from A's shards (no launch), ``VolumeEcShardsCopy`` of every
   shard to B (sha256-equal, GiB/s) and one ``VolumeEcShardRead`` range,
   every 4th needle read from B with shards 0, 5, 11 and 13 deleted on
   both servers (reconstruct-on-read: needles/s, p50, p99, launches,
   host-codec calls), ``VolumeEcShardsRebuild`` (sha256-equal),
   ``VolumeEcShardsToVolume`` after losing data shards 0 and 5 (.dat and
   .idx sha256-equal, every 4th needle read back); then through the master:
   64 needles of about 1 MiB by ``operation.submit`` with replication
   001, each read back sha256-equal from A and from B (MiB/s, ms per
   needle); the cluster shell in this process running ``lock; ec.encode;
   ec.balance; volume.list; unlock`` on the restored volume (one launch
   per batch, shards spread even/odd over A/B and sha256-equal to the
   sealed ones; GiB/s beside the RPC-driven Generate); every 4th needle
   read by ``operation.download`` with shards 0, 5, 11 and 13 gone, each
   server fetching what it lacks through ``ec_shard_peers`` (needles/s,
   p50, p99, launches); the shell's ``ec.rebuild`` and ``ec.decode``
   (sha256-equal; GiB/s); then ``python -m seaweedfs_tpu_torch master``,
   ``volume`` joining it (status, one POST, one GET), each in its own
   process, and the cluster shell's ``volume.list`` against them in
   this process (a ``shell -master`` subprocess before the telemetry
   phase came) naming the volume subprocess and an in-process server
   (SIGTERM ends both servers);
8. jobs (the jobs plane, config 1's volume): a port master (lease 5 s,
   checkpoint in its meta dir) and two port volume servers, A and B on
   two racks, both on the card and set up through the ``volume
   -config`` code (``[jobs] poll_seconds = 0.2``, ``[storage.scrub]``
   unpaced), with copies of the path phase's volume in their stores;
   the cluster shell's ``ec.encode -distributed -collection sweep
   -parallel 2`` over 4 of them (both workers on the card at once: the
   job done with a task on each, every volume's shards and .ecx
   sha256-equal to the path phase's seal, one launch per batch counted
   per worker, the master's topology and ``/metrics``; GiB/s beside
   each task's seconds), ``-volumeId 15 -mesh 1,1`` (done, sha256-equal,
   one launch per batch), ``-mesh 2,2`` on a small volume (the job
   failed after ``max_attempts`` claims by its only holder, with the
   ``MeshConfigError`` text, no launch, in bounded time), and the scrub
   job on one sealed volume: its baseline (one parity-proof launch per
   4 MiB chunk), then one byte of shard 3 rotten, quarantined and
   rebuilt to its sealed sha256 (GiB/s and launches beside the storage
   phase's direct ``scrub_ec``);
9. telemetry (the telemetry, SLO, usage and policy planes): a port
   master through ``master -config`` (a 1024 MB size limit, ``[jobs]
   policy = true`` ticking every 0.5 s with a 600 s cooldown, a read
   latency and an availability objective on short windows) and two port
   volume servers A and B through ``volume -config`` (``[telemetry]``,
   ``[usage]``), pulse 0.5 s, on the card, with a copy of the path
   phase's volume unread in A's store (full at 0.9 of the limit): with
   no command, the master's policy submits ``ec_encode`` and A's worker
   seals it (one launch per batch, shards and .ecx sha256-equal to the
   path phase's; the seconds from the submitting tick to done, the
   policy's actions ring); the source and shards 0, 5, 11 and 13
   dropped, every 8th needle read through the master's lookup by
   ``operation.download`` (byte-equal; needles/s, p50, p99, launches),
   the master's ``/cluster/telemetry`` counting each GET as one EC
   decode, A's read p99 from the digests, both nodes healthy; the
   cluster shell's ``ec.rebuild`` (sha256-equal), ``telemetry.status``,
   ``volume.heatmap``, ``traffic.top``, ``tenant.usage`` and
   ``cluster.check`` (0 problems), the SLO objectives ``ok`` with the
   engine's evaluations, and ``record_read``'s ns per call with the
   collector on and off;
10. filer (the filer stack with its chunk cache): a port master, two port
   volume servers A and B (64 MiB post-decode caches each) and one port
   filer (the default ``[cache]``, 64 MiB), in this process: 32 files of
   seeded sizes over 1-8 MiB (about 144 MiB) PUT through the filer's HTTP
   into collection ``filer`` (4 MiB chunks, on two volumes), ``fs.ls``,
   ``fs.du`` and ``volume.fsck`` (0 orphans, 0 missing) through ``shell
   -master ... -filer ...``, ``ec.encode`` of both volumes over A and B,
   shards 0, 5, 11 and 13 deleted everywhere and every file read back
   through the filer sha256-equal (repairs on the card: files/s, MiB/s,
   p50, p99, launches, host-codec calls), the hot set (the last files
   read, at most 32 MiB) again from the filer's cache (no launch, no
   volume-server read), again with the filer's cache cleared from the
   servers' post-decode caches (no launch, each server's hits),
   ``ec.rebuild`` dropping every cached entry of both volumes and the hot
   set read back with no launch; then ``python -m seaweedfs_tpu_torch
   filer`` in its own process (one PUT and one GET, SIGTERM); last the
   trace step, after every rate above: ``[tracing]
   push_threshold_seconds = 0`` (every root pushed to the master), every
   chunk cache cleared, shards 0, 5, 11 and 13 lost again, 8 files read
   through the filer under trace ids of the step's own, one
   ``ec.rebuild`` through the cluster shell (the ``pipe.compute``
   series counts its batches), a burst profile of A through the
   master's ``/cluster/profile`` while reads are in flight, and the
   master's ``/cluster/traces``: each GET stitched with its filer and
   volume legs and its root, every child inside its parent (a remote
   leg's end up to 50 ms past its caller's), the transpose kernel
   launched inside the traced window; it prints each span name's share
   of a GET's wall time (p50, p99; inclusive and self), the rebuild's
   ``grpc.*`` legs and ``n_bytes``, each server's ``/debug/vars``, the
   burst's top stacks and the cost of one span enter and exit;
11. s3 (the S3 gateway, the checkpoint plane on the card's tensors, the
   S3 tier): a port master, two port volume servers A and B, one port
   filer (collection ``s3``) and two ``S3Gateway`` objects over it (one open,
   one with a SigV4 identity), in this process: one decoder layer of
   Llama-2-7B at its published widths (Hugging Face
   ``meta-llama/Llama-2-7b-hf`` ``config.json``: hidden 4096,
   intermediate 11008; the depth cut to one layer), float16 from a
   numpy seed, its seven matrices sharded ``("dp", "sp")`` over a 2 x 2
   grid of four ``cuda:0`` cells and its two norms replicated, saved
   from the card by ``CheckpointStore.save`` (MiB/s, objects), listed by
   the shell's ``ckpt.list``, restored onto the grid (every block
   ``torch.equal`` on the card, MiB/s, p50/p99 ms per block, ranged
   GETs, no launch); the collection's volumes sealed over A and B,
   shards 0, 5, 11 and 13 deleted everywhere, every chunk cache cleared,
   and the layer restored again (every block equal; the repairs launch
   the transpose kernel; host-codec calls); one ``down_proj`` shard
   object (2048 x 5504, 21.5 MiB) as 1 MiB sequential ranged GETs
   (sha256-equal; the readahead window opens; prefetched, hit and wasted
   counts), a 64 MiB multipart upload in 8 MiB parts and a CopyObject
   (sha256-equal), a signed PUT and GET, an unsigned PUT and a stale date
   refused; one shard object with one byte flipped, and the restore
   fails closed with ``CorruptShardError``; a 128 MiB volume of config
   1's first needles in an offline store moved to the tier with
   ``volume.tier.upload`` (signed, multipart), every 4th needle read
   through the tier, ``ec.encode`` refused, ``volume.tier.download``
   (.dat sha256-equal) and ``ec.encode`` (one launch, shards and .ecx
   sha256-equal to sealing the local copy); then ``python -m
   seaweedfs_tpu_torch s3`` in its own process (one PUT, one GET,
   SIGTERM);
12. repair under load (BASELINE config 5): ``repair_bench.run`` for 5 s,
   a bulk decode of 4 lost shards through the kernels while 8 reader
   threads send 64 QPS of 4 KiB interval repairs, all checked;
13. config 4: the restored volume sealed with RS(6,3) and RS(12,4), m
   shards rebuilt, and the volume decoded after losing data shards 0 and
   3, all sha256-checked, parity against ``rs_ref`` on sampled rows;
14. mesh (the multi-device split, ``parallel/mesh.py``): (a) through the
   normal routing, the shell's ``ec.encode -mesh 1,1`` in turns with the
   unsplit ``ec.encode`` (a warm-up, then A, B) on config 1's
   volume, shards and .ecx sha256-equal and launches equal (one per
   batch), then ``ec.rebuild -mesh 1,1`` after losing 4 shards (one
   launch per chunk); (b) the dry-run twin (``parallel/dryrun.run``)
   over four ``cuda:0`` entries as a 2 x 2 grid, and
   ``encode_parity_host_sharded`` on a (25, 10, 1 MiB) slab over that
   grid (B pads to 26, S splits in two: 4 launches), byte-equal to the
   unsplit path and to ``rs_ref`` on sampled rows; (c) ``-mesh 2,2``
   refused on one card with no file changed;
15. config (the shell's ``-config``): on config 1's volume through
   ``shell.cli.main``, (a) a TOML of ``[pipeline] double_buffer``,
   ``[mesh]`` 1 x 1 and ``[flight]``: ``ec.encode -keepSource;
   pipeline.status; pipeline.analyze; pipeline.dump -trace`` (shards,
   .ecx and .vif sha256-equal to the sealed ones, one launch per batch,
   one read / h2d / dispatch / d2h_sync / write span per batch in the
   trace), then ``ec.rebuild`` of 4 lost shards; (b) ``double_buffer``
   off against on over the 1 x 1 split (off copies on the side stream
   ahead of each kernel, on copies on a copy stream one batch ahead),
   (c) the flight recorder disarmed against armed (the armed runs print
   ``pipeline.analyze``), each a warm-up of each side then A, B
   with both medians and their ratio, launches checked on every encode
   and the files sha256-checked on one of each side;
16. storage (the engine at rest, on config 1's volume): (a) a seeded
   .idx of 500,000 needles with 10% deleted loaded by the memory,
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
17. config 3 (the many-volume batcher): ``batch.encode_many`` over 1000
   volumes of 30 MiB (GiB/s of volume bytes, stage times, launches), then
   ``batch.encode_packed`` over 100 of them with every parity span checked
   whole against ``rs_ref`` and the batch census printed, 100 volumes on the
   SWAR kernel, and 200 under ``SEAWEEDFS_TORCH_HOST_DISPATCH=auto``
   (the probe's two rates, its verdict and the route taken); then 32
   volumes of real needles sealed by ``batch.encode_volumes``, each
   sha256-equal to a single-volume ``write_ec_files``.

Every phase but that auto pass runs with
``SEAWEEDFS_TORCH_HOST_DISPATCH=device``, so that large host slabs
launch the kernels whatever the link probe would say.
Repeats were cut as phases came, to keep the script under 480 s on the
fast hosts: config 3's checked pass to 200 of the 1000 volumes, the mesh
phase's second A/B round and ``Needle.to_bytes`` timed on every 4th
needle (jobs phase); the cluster phase's GETs from A's shards and from
B's decoded volume to every 4th needle (filer phase); for the s3 phase,
the cluster phase's degraded GETs from B and degraded
``operation.download`` from every 2nd needle to every 4th, the mesh
phase's A/B from A, B, B, A to A, B, the config phase's two A/Bs from A,
B, B, A to A, B (each after its warm-ups), the read phase's two reads to
every 2nd needle, the filer phase's files from 64 to 32, config 5 from
8 s to 5 s and config 3's three checked passes from 200 volumes to 100;
for the filer phase's trace step, the storage phase's needle-map loads
from 1,000,000 needles (1,100,000 ``.idx`` entries) to 500,000
(550,000); for the telemetry phase, the cluster phase's ``python -m
seaweedfs_tpu_torch shell -master ... -c volume.list`` subprocess (the
cluster shell now runs that ``volume.list`` in this process), and the
shell phase's ``write_needle`` calls and the cluster phase's HTTP POSTs
from all 1026 needles to the last 513 (the first 513 are copied in).
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
#: The shell phase times ``Needle.to_bytes`` apart on every 4th needle.
TO_BYTES_EVERY = 4
#: The shell phase's ``write_needle`` calls and the cluster phase's HTTP
#: POSTs write the needles after the first INGEST_FROM of config 1's
#: volume; those come in as a copy of the path phase's records (all
#: 1026 needles were written both ways before the telemetry phase came).
INGEST_FROM = 513
LOST_REBUILD = (2, 7, 11, 13)
LOST_DECODE = (0, 5)
#: The read phase's and config 5's lost shards: two data, two parity.
LOST_READ = repair_bench.DEFAULT_LOST
READ_THREADS = 8
#: The read phase reads every 2nd needle, directly and through the
#: aggregator (every needle before the s3 phase came).
READ_EVERY = 2
#: Config 5 runs this many seconds (8 before the s3 phase came).
CONFIG5_SECONDS = 5
#: The sweep's shard length: not a multiple of the kernels' 1 KiB blocks
#: after padding to either granule, nor of 16 or 128 itself.
SWEEP_S = 200_037
GIB = 1 << 30
#: BASELINE config 3: 1000 volumes of 30 MiB sealed in one job, payloads
#: from a seeded pool of 8 distinct buffers; the checked, SWAR and auto
#: passes run 100 of them; the file-level pass seals 32 volumes of real
#: needles.
C3_VOLUMES = 1000
C3_VOLUME_BYTES = 30 * MIB
C3_POOL = 8
C3_SHORT = 100
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


def copy_prefix(pres: dict, base: str, k: int) -> int:
    """Copy the path phase's superblock and its first ``k`` needle
    records to ``<base>.dat``, their entries to ``<base>.idx``: the
    volume as it stood after ``k`` writes. Returns its .dat size."""
    from seaweedfs_tpu_torch.storage.types import NEEDLE_MAP_ENTRY_SIZE
    e = pres["idx_entries"][k - 1]
    end = e.byte_offset + needle_mod.record_size(e.size)
    for ext, n in ((".dat", end), (".idx", k * NEEDLE_MAP_ENTRY_SIZE)):
        with open(pres["base"] + ext, "rb") as src, \
                open(base + ext, "wb") as dst:
            dst.write(src.read(n))
    return end


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
    """Read every ``READ_EVERY``-th needle with shards 0, 5, 11, 13 lost,
    directly and from 8 threads through one aggregator, each against the
    original .dat; then rebuild the lost shards."""
    idx_entries = idx_entries[::READ_EVERY]
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
            duration_s=CONFIG5_SECONDS, qps=64, shard_len=shard_len,
            interval_size=4096,
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
    after the first ``INGEST_FROM`` (whose records are copied in) written
    through ``Store.write_needle`` into a store of two disk locations,
    then ``ec.encode; ec.balance; volume.list``, a rebuild of
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

    # 1-4: the path phase's needles after the first INGEST_FROM through
    # the Store, every write acknowledged under the commit policy (2
    # fsyncs each). Only the
    # write_needle calls are timed; making each needle and hashing it
    # for the check are not. Needle.to_bytes (the CRC32-C and the
    # record's assembly, which write_needle runs too) is timed on its
    # own on every TO_BYTES_EVERY-th needle (a sample keeps the script
    # in its time budget), outside the write_needle window.
    copied = copy_prefix(pres, os.path.join(a, str(vid)), INGEST_FROM)
    store = store_mod.Store([a, b])
    store.load_existing()
    vol = store.get_volume(vid)
    version = vol.super_block.version
    needles = volume_mod.synthetic_needles(avg_size=MIB, seed=SEED)
    written = {}
    for _ in range(INGEST_FROM):
        n = next(needles)
        written[n.id] = (n.cookie, hashlib.sha256(n.data).digest())
    write_s = to_bytes_s = 0.0
    timed = 0
    while vol.dat_size < VOLUME_BYTES:
        n = next(needles)
        if n.id % TO_BYTES_EVERY == 0:
            t0 = time.perf_counter()
            n.to_bytes(version)
            to_bytes_s += time.perf_counter() - t0
            timed += 1
        t1 = time.perf_counter()
        store.write_needle(vid, n)
        write_s += time.perf_counter() - t1
        written[n.id] = (n.cookie, hashlib.sha256(n.data).digest())
    store.close()
    vbase = os.path.join(os.path.dirname(vol.base), str(vid))
    n_written = len(written) - INGEST_FROM
    result["ingest"] = {
        "needles": n_written, "write_needle_s": write_s,
        "needles_per_s": n_written / write_s,
        "mib_per_s": (dat_size - copied) / MIB / write_s,
        "to_bytes_s": to_bytes_s,
        "ms_per_needle": 1e3 * write_s / n_written,
        "to_bytes_needles": timed,
        "to_bytes_ms_per_needle": 1e3 * to_bytes_s / timed,
        "fsyncs": 2 * n_written}
    say(f"  ingest through Store.write_needle on {label}: "
        f"{json.dumps(result['ingest'])}")
    check(len(written) == pres["n_needles"]
          and sha256_file(vbase + ".dat") == pres["dat_sha"],
          f"needles {INGEST_FROM + 1}-{len(written)} written through "
          f"Store.write_needle after the first {INGEST_FROM} copied: .dat "
          f"sha256-equal to the path phase's volume, superblock included")
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

    def __init__(self, n: int = 0):
        self.n = n

    def time_ns(self) -> int:
        self.n += 1
        return 1_700_000_000_000_000_000 + self.n


def _http(conn, method: str, path: str, body=None) -> tuple:
    conn.request(method, path, body=body)
    r = conn.getresponse()
    return r.status, r.read()


#: The cluster phase's heartbeat pulse (master and servers), seconds.
CLUSTER_PULSE = 1.0
#: The cluster phase GETs every 4th needle from A's local shards and
#: from B's decoded volume (no launch either; it read all of them
#: before the filer phase came).
LOCAL_GET_EVERY = 4
#: ... and every 4th needle with shards lost, from B and through
#: ``operation.download`` (all of them before the filer phase, every
#: 2nd before the s3 phase).
DEGRADED_GET_EVERY = 4
#: The replicated uploads of the cluster phase: 64 needles of about 1 MiB
#: with replication 001 (A and B share a rack).
REPLICATED_NEEDLES = 64


def cluster_shell(master_url: str, script: str, what: str, expect: dict,
                  launches: dict) -> tuple:
    """The cluster shell's ``-c`` session in this process: one
    ``ClusterEnv`` on the master, and each command of ``script`` through
    ``run_cluster_command`` as ``shell -master ... -c`` runs it, each
    driven with every launch count set to 0 just before it. ``expect``
    maps a command to the kernels it must launch; every other command
    must launch none. Returns the printed lines and each command's
    (name, seconds, launches)."""
    from seaweedfs_tpu_torch.shell.cluster_commands import (
        ClusterEnv, run_cluster_command)

    out, log = io.StringIO(), []
    env = ClusterEnv(master_url=master_url, out=out)
    try:
        for line in filter(None, (x.strip() for x in script.split(";"))):
            name = line.split()[0]
            got = dict.fromkeys(launches, 0)
            _, wall = drive(f"{what}: {line}",
                            lambda: run_cluster_command(env, line),
                            expect.get(name, dict.fromkeys(launches, False)),
                            got)
            log.append((name, wall, got))
            for k, v in got.items():
                launches[k] += v
    finally:
        env.close()
    lines = out.getvalue().splitlines()
    for line in lines:
        say(f"  > {line}")
    return lines, log


def cluster_phase(dev, workdir: str, pres: dict, label: str,
                  launches: dict) -> dict:
    """Config 1 through a port master and two port volume servers, A and
    B (one rack), in this process on the card, over localhost gRPC and
    HTTP. First this phase drives the choreography the shell would, by
    RPC: ingest the path phase's needles after the first ``INGEST_FROM``
    (copied into A's store) by HTTP POST,
    seal with ``VolumeEcShardsGenerate``, read every needle from A's
    shards, copy all shards to B, read every needle from B with shards
    0, 5, 11 and 13 lost everywhere (reconstruct-on-read), rebuild them,
    decode with ``VolumeEcShardsToVolume``. Then through the master:
    replicated uploads (``operation.submit``, replication 001) read back
    from A and from B; the cluster shell's ``lock; ec.encode; ec.balance;
    volume.list; unlock`` on the restored volume; degraded reads through
    ``operation.download`` with shards 0, 5, 11 and 13 gone, served
    through ``ec_shard_peers``; the shell's ``ec.rebuild`` and
    ``ec.decode``. Last, ``python -m seaweedfs_tpu_torch master`` and
    ``volume`` (joining it) in their own processes, and the cluster
    shell's ``volume.list`` against them."""
    import http.client

    import grpc

    from seaweedfs_tpu_torch import pb
    from seaweedfs_tpu_torch.cluster import operation
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           _grpc_port,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.storage.types import FileId

    t_phase = time.perf_counter()
    scheme = DEFAULT_SCHEME
    total = scheme.total_shards
    vid = 1
    dat_size = os.path.getsize(pres["base"] + ".dat")
    gib = dat_size / GIB
    shard_size = scheme.shard_file_size(dat_size)
    sealed = pres["sealed"]
    result = {}
    phase_launches = {"rpc": dict.fromkeys(KERNELS, 0),
                      "shell": dict.fromkeys(KERNELS, 0),
                      "client": dict.fromkeys(KERNELS, 0)}
    dirs = {name: os.path.join(workdir, name) for name in "AB"}
    master = MasterServer(port=free_port_pair(),
                          pulse_seconds=CLUSTER_PULSE).start()
    servers, channels = {}, []
    for name, d in dirs.items():
        os.makedirs(d)
        st = store_mod.Store([d])
        if name == "A":
            # volume 1 as it stood after INGEST_FROM writes
            copied = copy_prefix(pres, os.path.join(d, str(vid)),
                                 INGEST_FROM)
            st.load_existing()
        servers[name] = VolumeServer(
            st, port=free_port_pair(), master_url=master.url,
            data_center="dc1", rack="r0", pulse_seconds=CLUSTER_PULSE,
            device=dev).start()
        servers[name].heartbeat_now()
    check(sorted(master.topology.nodes) == sorted(
        vs.url for vs in servers.values()),
        f"port master {master.url}: A and B joined by heartbeat")
    mc = MasterClient(master.url)

    def stub(name):
        ch = grpc.insecure_channel(
            f"127.0.0.1:{_grpc_port(servers[name].port)}",
            options=[("grpc.max_receive_message_length", 64 * MIB)])
        channels.append(ch)
        return pb.volume_stub(ch)

    def settle():
        for vs in servers.values():
            vs.heartbeat_now()

    a, b = stub("A"), stub("B")
    conns = {name: http.client.HTTPConnection("127.0.0.1", vs.port,
                                              timeout=300)
             for name, vs in servers.items()}
    abase = os.path.join(dirs["A"], str(vid))
    bbase = os.path.join(dirs["B"], str(vid))
    rpc = phase_launches["rpc"]
    try:
        # 1-2: the rest of the path phase's needles by HTTP POST to A
        vol = servers["A"].store.get_volume(vid)
        needles = volume_mod.synthetic_needles(avg_size=MIB, seed=SEED)
        written = {}
        for _ in range(INGEST_FROM):
            n = next(needles)
            written[str(FileId(vid, n.id, n.cookie))] = \
                hashlib.sha256(n.data).digest()
        post_s = 0.0
        real_time = needle_mod.time
        needle_mod.time = _NeedleClock(INGEST_FROM)
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
        posted = len(written) - INGEST_FROM
        result["ingest"] = {
            "needles": posted, "post_s": post_s,
            "needles_per_s": posted / post_s,
            "mib_per_s": (dat_size - copied) / MIB / post_s,
            "ms_per_needle": 1e3 * post_s / posted}
        say(f"  HTTP ingest into A on {label}: "
            f"{json.dumps(result['ingest'])}")
        check(len(written) == pres["n_needles"]
              and sha256_file(abase + ".dat") == pres["dat_sha"]
              and sha256_file(abase + ".idx") == pres["idx_sha"],
              f"needles {INGEST_FROM + 1}-{len(written)} POSTed to A "
              f"after the first {INGEST_FROM} copied: .dat and .idx "
              f"sha256-equal to the path phase's volume")

        def read_all(name: str, what: str, expect: dict,
                     every: int = 1) -> list:
            """GET every ``every``-th needle from server ``name`` with
            the launch counts set to 0 just before; each body held
            against the written one; returns each GET's seconds."""
            times = []
            wanted = list(written.items())[::every]

            def run():
                for fid, digest in wanted:
                    t0 = time.perf_counter()
                    code, body = _http(conns[name], "GET", f"/{fid}")
                    times.append(time.perf_counter() - t0)
                    if code != 200 or \
                            hashlib.sha256(body).digest() != digest:
                        raise SmokeError(f"{what}: GET {fid} gave {code}")
            drive(what, run, expect, rpc)
            check(len(times) == len(wanted), f"{what}: "
                  f"{len(wanted)} of {len(written)} needles equal to the "
                  f"ones written")
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
                        {"transpose": True, "swar": False}, rpc)
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
            volume_id=vid, shard_ids=list(range(total))))
        a.VolumeDelete(vpb.VolumeDeleteRequest(volume_id=vid))
        check(not os.path.exists(abase + ".dat"), "VolumeDelete: A's .dat "
              "gone, its shards mounted")
        times = read_all("A", "GET from A's local shards",
                         {"transpose": False, "swar": False},
                         every=LOCAL_GET_EVERY)
        result["local_read_needles_per_s"] = len(times) / sum(times)
        say(f"  GET from A's shards: {len(times) / sum(times):.1f} "
            f"needles/s, host-codec calls "
            f"{rs_native.apply_gf_matrix.calls} on {label}")

        # 5: B copies every shard, .ecx, .ecj (absent) and .vif from A
        moved = sum(os.path.getsize(abase + n) for n in sealed)
        t0 = time.perf_counter()
        b.VolumeEcShardsCopy(vpb.VolumeEcShardsCopyRequest(
            volume_id=vid, shard_ids=list(range(total)),
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
            volume_id=vid, shard_ids=list(range(total))))

        # 6: lose 4 shards on B and on A: the master names no holder of
        # them, so B reconstructs them on read
        for s in (a, b):
            s.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
                volume_id=vid, shard_ids=list(LOST_READ)))
        settle()
        check(sorted(master.topology.lookup_ec_volume(vid)) ==
              [s for s in range(total) if s not in LOST_READ],
              f"the master's LookupEcVolume: shards {list(LOST_READ)} "
              f"held nowhere")
        times = read_all("B", f"GET from B with shards {list(LOST_READ)} "
                         f"lost (reconstruct-on-read)",
                         {"transpose": True, "swar": False},
                         every=DEGRADED_GET_EVERY)
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
            {"transpose": True, "swar": False}, rpc)
        check(list(resp.rebuilt_shard_ids) == list(LOST_READ)
              and sealed_digests(bbase) == sealed,
              f"VolumeEcShardsRebuild: {list(resp.rebuilt_shard_ids)} "
              f"rebuilt sha256-equal to the sealed shards")
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
            {"transpose": True, "swar": False}, rpc)
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
                 {"transpose": False, "swar": False},
                 every=LOCAL_GET_EVERY)
        # the shard files left on A and B go; the volume lives on B
        for s in (a, b):
            s.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
                volume_id=vid, shard_ids=list(range(total))))
        settle()
        check(not master.topology.lookup_ec_volume(vid) and
              [n.url for n in master.topology.lookup_volume(vid)] ==
              [servers["B"].url], f"the master: volume {vid} on B alone, "
              f"no EC shards of it")
        say(f"  launches of the RPC-driven steps: {json.dumps(rpc)}")

        # 9: replicated uploads through the master (replication 001)
        rng = np.random.default_rng(SEED + 9)
        blobs = [rng.integers(0, 256, MIB + int(rng.integers(-4096, 4096)),
                              dtype=np.uint8).tobytes()
                 for _ in range(REPLICATED_NEEDLES)]
        fids, up = [], []
        for blob in blobs:
            t0 = time.perf_counter()
            fids += operation.submit(mc, [blob], replication="001")
            up.append(time.perf_counter() - t0)
        rvid = int(fids[0].split(",")[0])
        check(sorted(loc["url"] for loc in mc.lookup(rvid)) ==
              sorted(vs.url for vs in servers.values()),
              f"operation.submit -replication 001: the master grew volume "
              f"{rvid} on A and B")
        # fresh connections: the ingress closes a keep-alive connection
        # that idled through the RPC-driven steps
        for c in conns.values():
            c.close()
        conns = {name: http.client.HTTPConnection("127.0.0.1", vs.port,
                                                  timeout=300)
                 for name, vs in servers.items()}
        equal = sum(
            hashlib.sha256(_http(conns[name], "GET", f"/{fid}")[1]).digest()
            == hashlib.sha256(blob).digest()
            for name in "AB" for fid, blob in zip(fids, blobs))
        check(equal == 2 * len(fids), f"{len(fids)} replicated needles: "
              f"{equal} GETs from A and B sha256-equal to the uploads")
        up_mib = sum(len(x) for x in blobs) / MIB
        result["replicated_upload"] = {
            "needles": len(fids), "seconds": sum(up),
            "mib_per_s": up_mib / sum(up),
            "ms_per_needle": 1e3 * sum(up) / len(up),
            "p99_ms": float(np.percentile(np.asarray(up) * 1e3, 99))}
        say(f"  replicated upload (001, A and B) on {label}: "
            f"{json.dumps(result['replicated_upload'])}")

        # 10: the cluster shell seals the restored volume on B and
        # spreads its shards over A and B
        shell = phase_launches["shell"]
        lines, log = cluster_shell(
            master.url, f"lock; ec.encode -volumeId {vid}; ec.balance; "
            f"volume.list; unlock", "shell",
            {"ec.encode": {"transpose": True, "swar": False}}, shell)
        enc = next(e for e in log if e[0] == "ec.encode")
        check(enc[2]["transpose"] == batches,
              f"shell ec.encode: transpose kernel launched "
              f"{enc[2]['transpose']} times, one per batch ({batches})")
        settle()
        held = {name: sorted(vs.store.ec_mounts[("", vid)].shard_ids)
                for name, vs in servers.items()
                if ("", vid) in vs.store.ec_mounts}
        check(held == {"A": list(range(0, total, 2)),
                       "B": list(range(1, total, 2))},
              f"shell ec.encode: shards spread A {held.get('A')}, "
              f"B {held.get('B')}, as the JAX shell's rack spread puts "
              f"them")
        digests = {}
        for name, sids in held.items():
            base = os.path.join(dirs[name], str(vid))
            digests.update({ec_files.shard_ext(s): sha256_file(
                ec_files.shard_path(base, s)) for s in sids})
            for ext in (".ecx", ".vif"):
                check(sha256_file(base + ext) == sealed[ext],
                      f"shell ec.encode: {name}'s {ext} sha256-equal to "
                      f"the path phase's")
        check(digests == {k: v for k, v in sealed.items()
                          if k.startswith(".ec") and k != ".ecx"},
              "shell ec.encode: the 14 shards over A and B sha256-equal "
              "to the path phase's sealed files")
        check(not servers["B"].store.has_volume(vid)
              and any(f"ec volume {vid}" in line for line in lines),
              "shell ec.encode: the source volume dropped; volume.list "
              "shows the EC volume")
        result["shell_encode_gibps"] = gib / enc[1]
        say(f"  shell ec.encode: {gib / enc[1]:.3f} GiB/s of .dat in "
            f"{enc[1]:.3f} s (Generate, then 7 shards copied to A) vs "
            f"VolumeEcShardsGenerate {result['generate_gibps']:.3f} GiB/s "
            f"on {label}; commands "
            f"{json.dumps([(n, round(s, 3), c) for n, s, c in log])}")

        # 11: shards 0, 5, 11 and 13 gone; degraded reads through the
        # master: each server has the shards it lacks from the other
        # (ec_shard_peers asks the master) and reconstructs the rest
        for name, vs in servers.items():
            gone = [s for s in held[name] if s in LOST_READ]
            (a if name == "A" else b).VolumeEcShardsDelete(
                vpb.VolumeEcShardsDeleteRequest(volume_id=vid,
                                                shard_ids=gone))
        settle()
        check(sorted(master.topology.lookup_ec_volume(vid)) ==
              [s for s in range(total) if s not in LOST_READ],
              f"the master: shards {list(LOST_READ)} held nowhere")
        mc.invalidate()
        repaired0 = sum(vs.metrics.counter("ec_intervals_repaired").value
                        for vs in servers.values())
        times = []

        wanted = list(written.items())[::DEGRADED_GET_EVERY]

        def download_all():
            for fid, digest in wanted:
                t0 = time.perf_counter()
                body = operation.download(mc, fid)
                times.append(time.perf_counter() - t0)
                if hashlib.sha256(body).digest() != digest:
                    raise SmokeError(f"operation.download {fid}: bytes "
                                     f"differ from the .dat's")
        drive("operation.download with shards "
              f"{list(LOST_READ)} gone (ec_shard_peers through the master)",
              download_all, {"transpose": True, "swar": False},
              phase_launches["client"])
        check(len(times) == len(wanted), f"operation.download: "
              f"{len(wanted)} of {len(written)} needles equal to the .dat's")
        ms = np.asarray(times) * 1e3
        result["master_degraded_read"] = {
            "needles_per_s": len(times) / sum(times),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "launches": counts(),
            "host_codec_calls": rs_native.apply_gf_matrix.calls,
            "intervals_repaired": sum(
                vs.metrics.counter("ec_intervals_repaired").value
                for vs in servers.values()) - repaired0}
        say(f"  degraded operation.download through the master on "
            f"{label}: {json.dumps(result['master_degraded_read'])}")

        # 12: the shell rebuilds the lost shards, then decodes
        lines, log = cluster_shell(
            master.url, "ec.rebuild", "shell",
            {"ec.rebuild": {"transpose": True, "swar": False}}, shell)
        check(any(f"rebuilt {list(LOST_READ)}" in line for line in lines),
              f"shell ec.rebuild: shards {list(LOST_READ)} rebuilt")
        settle()
        for name, vs in servers.items():
            base = os.path.join(dirs[name], str(vid))
            for s in vs.store.ec_mounts[("", vid)].shard_ids:
                if sha256_file(ec_files.shard_path(base, s)) != \
                        sealed[ec_files.shard_ext(s)]:
                    raise SmokeError(f"shell ec.rebuild: {name}'s shard "
                                     f"{s} differs from the sealed one")
        check(sorted(master.topology.lookup_ec_volume(vid)) ==
              list(range(total)), "shell ec.rebuild: every shard held "
              "again, each sha256-equal to the sealed one")
        wall = log[0][1]
        result["shell_rebuild_gibps"] = \
            len(LOST_READ) * shard_size / GIB / wall
        say(f"  shell ec.rebuild: {wall:.3f} s, "
            f"{result['shell_rebuild_gibps']:.3f} GiB/s of rebuilt shards "
            f"(survivors fetched from the other server first) vs "
            f"VolumeEcShardsRebuild {result['rebuild_gibps']:.3f} on "
            f"{label}")
        lines, log = cluster_shell(
            master.url, f"ec.decode -volumeId {vid}", "shell", {}, shell)
        settle()
        back = [name for name, vs in servers.items()
                if vs.store.has_volume(vid)]
        check(len(back) == 1, f"shell ec.decode: volume {vid} restored on "
              f"{back}")
        base = os.path.join(dirs[back[0]], str(vid))
        check(sha256_file(base + ".dat") == pres["dat_sha"]
              and sha256_file(base + ".idx") == pres["idx_sha"],
              "shell ec.decode: .dat and .idx sha256-equal to the "
              "originals")
        wall = log[0][1]
        result["shell_decode_gibps"] = gib / wall
        say(f"  shell ec.decode: {wall:.3f} s, {gib / wall:.3f} GiB/s of "
            f".dat (missing shards copied first; every data shard "
            f"present, so no product) vs VolumeEcShardsToVolume "
            f"{result['to_volume_gibps']:.3f} on {label}")
        say(f"  launches of the shell-driven steps: {json.dumps(shell)}; "
            f"of operation.download: "
            f"{json.dumps(phase_launches['client'])}")
    finally:
        mc.close()
        for c in conns.values():
            c.close()
        for ch in channels:
            ch.close()
        for vs in servers.values():
            vs.stop()
        master.stop()
    shutil.rmtree(dirs["A"])
    shutil.rmtree(dirs["B"])
    for part in phase_launches.values():
        for name, n in part.items():
            launches[name] += n
    result["launches"] = phase_launches

    # 13: the master, a volume server joining it and the shell, as an
    # operator runs them, each in its own process
    c = os.path.join(workdir, "C")
    os.makedirs(c)
    mport, port = free_port_pair(), free_port_pair()
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    procs = {}
    for name, args in (
            ("master", ["master", "-port", str(mport),
                        "-pulseSeconds", str(CLUSTER_PULSE)]),
            ("volume", ["volume", "-dir", c, "-mserver",
                        f"127.0.0.1:{mport}", "-port", str(port),
                        "-pulseSeconds", str(CLUSTER_PULSE)])):
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch"] + args,
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    d_dir = os.path.join(workdir, "D")
    os.makedirs(d_dir)
    d_server = None
    outs = {}
    try:
        conn = None
        while time.perf_counter() - t0 < 180 and all(
                p.poll() is None for p in procs.values()):
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
        d_server = VolumeServer(
            store_mod.Store([d_dir]), port=free_port_pair(),
            master_url=f"127.0.0.1:{mport}", pulse_seconds=CLUSTER_PULSE,
            device=dev).start()
        d_server.heartbeat_now()
        # the cluster shell in this process against the master
        # subprocess (a shell subprocess of its own until the telemetry
        # phase came)
        t1 = time.perf_counter()
        want = (f"DataNode 127.0.0.1:{port} volumes=1/",
                f"DataNode {d_server.url} volumes=0/")
        listed = ""
        while time.perf_counter() - t1 < 120:
            lines, _log = cluster_shell(f"127.0.0.1:{mport}", "volume.list",
                                        "master subprocess", {},
                                        dict.fromkeys(KERNELS, 0))
            listed = "\n".join(lines)
            if all(w in listed for w in want):
                break
            time.sleep(CLUSTER_PULSE)
        check(all(w in listed for w in want),
              f"the cluster shell's volume.list against the master "
              f"subprocess names the volume subprocess and the in-process "
              f"server ({time.perf_counter() - t1:.1f} s)")
    finally:
        if d_server is not None:
            d_server.stop()
        for name in ("volume", "master"):
            proc = procs[name]
            proc.terminate()
            try:
                outs[name] = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                outs[name] = proc.communicate()
    for name, (out, err) in outs.items():
        for line in (out + err).splitlines()[-3:]:
            say(f"  $ [{name}] {line}")
        check(procs[name].returncode == 0, f"the {name} subprocess "
              f"stopped on SIGTERM with exit {procs[name].returncode}")
    result["subprocess_s"] = time.perf_counter() - t0
    shutil.rmtree(c)
    shutil.rmtree(d_dir)
    result["seconds"] = time.perf_counter() - t_phase
    say(f"  cluster phase: {result['seconds']:.1f} s")
    return result


# --------------------------------------------------------------------------
# jobs phase: ec.encode -distributed and the scrub job on two workers
# --------------------------------------------------------------------------

#: The jobs phase's master pulse and lease, in seconds. The servers
#: heartbeat at the same pulse and their workers poll at JOBS_CONFIG's
#: ``poll_seconds``.
JOBS_PULSE = 0.5
JOBS_LEASE = 5.0
#: The volume servers' -config: poll for tasks every 0.2 s, scrub
#: unpaced.
JOBS_CONFIG = ("[jobs]\npoll_seconds = 0.2\n\n"
               "[storage.scrub]\nrate_bytes_per_second = 0\n")
#: The jobs phase's volumes, each a copy of the path phase's 1 GiB
#: volume: (server, collection, volume id). Collection ``sweep`` is the
#: distributed sweep's; 15 is the mesh step's.
JOBS_VOLUMES = (("A", "sweep", 11), ("A", "sweep", 12),
                ("B", "sweep", 13), ("B", "sweep", 14), ("B", "mesh", 15))
#: The volume of a few needles the mesh 2,2 step fails on, on A.
JOBS_FAULT_VID = 16


def _digests(paths: list) -> list:
    """sha256 of several files at once (hashlib releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(sha256_file, paths))


def jobs_phase(dev, workdir: str, pres: dict, label: str,
               launches: dict) -> dict:
    """The jobs plane on the card: a port master and two port volume
    servers, A and B (racks r0 and r1), in this process, both on
    ``dev``, set up through the same ``-config`` code that ``python -m
    seaweedfs_tpu_torch volume -config`` and ``master -config`` run.
    Copies of the path phase's 1 GiB volume go into their stores first.
    Then through the cluster shell: ``ec.encode -distributed -collection
    sweep -parallel 2`` (4 volumes, both workers on the one card at
    once), ``-volumeId 15 -mesh 1,1``, ``-mesh 2,2`` on a small volume
    (fails within ``max_attempts`` claims, no launch), and the scrub job
    on volume 11 before and after one byte of its shard 3 rots."""
    import urllib.request

    from seaweedfs_tpu_torch.cluster import master as master_mod
    from seaweedfs_tpu_torch.cluster import volume_server as vs_mod
    from seaweedfs_tpu_torch.shell.cluster_commands import (
        ClusterEnv, run_cluster_command)
    from seaweedfs_tpu_torch.util import config as config_mod

    t_phase = time.perf_counter()
    scheme = DEFAULT_SCHEME
    total = scheme.total_shards
    src = pres["base"]
    dat_size = os.path.getsize(src + ".dat")
    shard_len = scheme.shard_file_size(dat_size)
    gib = dat_size / GIB
    want = {n: pres["sealed"][n] for n in
            [ec_files.shard_ext(i) for i in range(total)] + [".ecx"]}
    batches = len(list(encode.plan_batches(dat_size, scheme,
                                           pipe.current().batch_bytes)))
    result = {}
    os.makedirs(workdir)
    need = len(JOBS_VOLUMES) * (dat_size + total * shard_len) + (4 << 30)
    free = shutil.disk_usage(workdir).free
    check(free > need, f"free disk {free} bytes > the {need} this phase "
          f"may put there")
    dirs = {name: os.path.join(workdir, name) for name in "AB"}
    for d in dirs.values():
        os.makedirs(d)
    t0 = time.perf_counter()
    for name, col, vid in JOBS_VOLUMES:
        dst = os.path.join(dirs[name], store_mod.volume_base_name(vid, col))
        for ext in (".dat", ".idx"):
            shutil.copyfile(src + ext, dst + ext)
    volume_mod.generate_synthetic_volume(
        os.path.join(dirs["A"], store_mod.volume_base_name(
            JOBS_FAULT_VID, "fault")), JOBS_FAULT_VID, 8, avg_size=4096,
        seed=SEED).close()
    say(f"  set-up: {len(JOBS_VOLUMES)} copies of the path phase's "
        f"volume in {time.perf_counter() - t0:.1f} s")

    conf_path = os.path.join(workdir, "volume.toml")
    with open(conf_path, "w") as f:
        f.write(JOBS_CONFIG)
    server_kw = vs_mod.apply_config(config_mod.load(conf_path))
    check(server_kw["job_poll_seconds"] == 0.2
          and scrubber.configured_rate() == 0,
          f"volume -config: {json.dumps(server_kw)}, scrub rate "
          f"{scrubber.configured_rate()}")
    mconf = {"jobs": {"lease_seconds": JOBS_LEASE}}
    master_mod.apply_config(mconf)
    master = master_mod.MasterServer(
        port=vs_mod.free_port_pair(), pulse_seconds=JOBS_PULSE,
        meta_dir=os.path.join(workdir, "meta"))
    master_mod.configure_master(master, mconf)
    master.start()
    servers = {}
    env = None
    try:
        for i, (name, d) in enumerate(dirs.items()):
            st = store_mod.Store([d])
            st.load_existing()
            servers[name] = vs_mod.VolumeServer(
                st, port=vs_mod.free_port_pair(), master_url=master.url,
                data_center="dc1", rack=f"r{i}", pulse_seconds=JOBS_PULSE,
                device=dev, **server_kw).start()
            servers[name].heartbeat_now()
        a, b = servers["A"], servers["B"]
        check(sorted(master.topology.nodes) == sorted(
            vs.url for vs in servers.values())
            and master.jobs.lease_seconds == JOBS_LEASE,
            f"port master {master.url} (lease {JOBS_LEASE} s): A and B "
            f"joined, workers polling every "
            f"{a.job_worker.poll_seconds} s")

        def settle():
            for vs in servers.values():
                vs.heartbeat_now()

        def job(job_id):
            return next(j for j in master.jobs.to_map()["jobs"]
                        if j["jobId"] == job_id)

        def finished(kind, vids):
            return {name: [f for f in vs.job_worker.finished
                           if f["kind"] == kind and f["volumeId"] in vids]
                    for name, vs in servers.items()}

        def base_of(name, col, vid):
            return os.path.join(dirs[name],
                                store_mod.volume_base_name(vid, col))

        def sealed_equal(name, col, vid) -> bool:
            base = base_of(name, col, vid)
            got = _digests([base + n for n in want])
            return dict(zip(want, got)) == want

        def shell_step(script, what, kernel_cmd):
            _, log = cluster_shell(
                master.url, script, what,
                {kernel_cmd: {"transpose": True, "swar": False}}, launches)
            return next((w, g) for name, w, g in log if name == kernel_cmd)

        # 1. the sweep: 4 volumes, two workers sharing the card
        sweep = [vid for _n, col, vid in JOBS_VOLUMES if col == "sweep"]
        say(f"  page cache before the sweep: {_dirty_mib()}")
        wall, got = shell_step(
            "lock; ec.encode -distributed -collection sweep -parallel 2; "
            "unlock", "jobs sweep", "ec.encode")
        j1 = job("j1")
        workers = sorted({t["worker"] for t in j1["tasks"]})
        check(j1["state"] == "done" and j1["total"] == 4
              and workers == sorted([a.url, b.url]),
              f"sweep job j1 {j1['state']}: {j1['total']} tasks, workers "
              f"{workers}")
        per = finished("ec_encode", sweep)
        for name, fs in per.items():
            check(len(fs) == 2 and all(
                f["ok"] and f["launches"] == {"transpose": batches}
                for f in fs),
                f"worker {name}: volumes {[f['volumeId'] for f in fs]}, "
                f"launches {[f['launches'] for f in fs]} ({batches} "
                f"batches each)")
        check(got["transpose"] == 4 * batches,
              f"sweep: {got['transpose']} transpose launches = 4 x "
              f"{batches}")
        for name, col, vid in JOBS_VOLUMES:
            if col == "sweep":
                check(sealed_equal(name, col, vid),
                      f"volume {vid} on {name}: 14 shards and .ecx "
                      f"sha256-equal to the path phase's seal")
        settle()
        check(all(vid in master.topology.ec_locations for vid in sweep),
              "the master's topology shows the 4 EC volumes")
        with urllib.request.urlopen(f"http://{master.url}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        check('seaweed_jobs_tasks{kind="ec_encode",state="done"} 4'
              in text, "master /metrics: seaweed_jobs_tasks"
              "{kind=\"ec_encode\",state=\"done\"} 4")
        result["sweep"] = {
            "gibps": 4 * gib / wall, "wall_s": wall,
            "task_s": {name: [f["seconds"] for f in fs]
                       for name, fs in per.items()}}
        say(f"  sweep: {4 * gib / wall:.3f} GiB/s of .dat over two "
            f"workers sharing {label} ({wall:.3f} s from submit to done, "
            f"as the shell saw it); task seconds "
            f"{json.dumps(result['sweep']['task_s'])}; the path phase's "
            f"single encode {pres['encode_overlapped_gibps']:.3f} GiB/s")

        # 2. the mesh: -mesh 1,1 on B's volume 15
        wall, got = shell_step(
            "lock; ec.encode -distributed -collection mesh -volumeId 15 "
            "-mesh 1,1; unlock", "jobs mesh", "ec.encode")
        check(job("j2")["state"] == "done" and got["transpose"] == batches
              and finished("ec_encode", [15])["B"][0]["launches"]
              == {"transpose": batches},
              f"mesh 1,1 job j2 done: {got['transpose']} launches on the "
              f"one cell")
        check(sealed_equal("B", "mesh", 15), "volume 15: shards and .ecx "
              "sha256-equal to the path phase's seal")
        task_s = finished("ec_encode", [15])["B"][0]["seconds"]
        result["mesh"] = {"wall_s": wall, "task_s": task_s}
        say(f"  mesh 1,1: {gib / wall:.3f} GiB/s of .dat from submit to "
            f"done ({wall:.3f} s), the task {task_s:.3f} s on {label}")

        # 3. the repaired fault: -mesh 2,2 cannot tile one card
        env = ClusterEnv(master_url=master.url, out=io.StringIO())
        reset_counts()
        t0 = time.perf_counter()
        err = ""
        try:
            run_cluster_command(env, "ec.encode -distributed -collection "
                                f"fault -volumeId {JOBS_FAULT_VID} "
                                f"-mesh 2,2")
        except shell_commands.ShellError as e:
            err = str(e)
        wall = time.perf_counter() - t0
        got = counts()
        t = job("j3")["tasks"][0]
        check(err == "job j3 failed", f"-mesh 2,2: the shell says {err!r}")
        check(t["state"] == "failed"
              and t["attempts"] == master.jobs.max_attempts
              and t["excluded"] == [a.url]
              and t["error"].startswith("MeshConfigError: "),
              f"-mesh 2,2 task failed after {t['attempts']} claims by A "
              f"(max_attempts {master.jobs.max_attempts}): "
              f"{t['error'][:90]}")
        check(sum(got.values()) == 0 and wall < 60,
              f"-mesh 2,2: {got} launches, failed in {wall:.3f} s (the "
              f"reference's task would stay pending and the shell wait "
              f"600 s)")
        result["mesh_fault_s"] = wall

        # 4. the scrub job on volume 11, its EC form only (its plain
        # copy dropped, as the shell's ec.encode drops its source)
        a.store.delete_volume(11, "sweep")
        settle()
        b11 = base_of("A", "sweep", 11)
        proof = -(-shard_len // SCRUB_CHUNK)
        say(f"  page cache before the scrub job: {_dirty_mib()}")
        for step in ("baseline", "repair"):
            if step == "repair":
                _flip_byte(str(ec_files.shard_path(b11, 3)),
                           shard_len // 2)
            wall, got = shell_step(
                "scrub.start -collection sweep -volumeId 11 -wait; "
                "scrub.status -collection sweep", f"jobs scrub ({step})",
                "scrub.start")
            f = finished("scrub", [11])["A"][-1]
            check(f["ok"] and f["launches"] == {
                k: n for k, n in got.items() if n},
                f"scrub job ({step}) on A: {got} launches")
            if step == "baseline":
                check(got["transpose"] == proof,
                      f"scrub baseline: parity proven with {proof} "
                      f"launches = ceil({shard_len} / {SCRUB_CHUNK})")
            result[f"scrub_{step}"] = {
                "gibps": total * shard_len / GIB / f["seconds"],
                "task_s": f["seconds"], "wall_s": wall,
                "launches": got}
        q = scrubber.quarantine_dir(b11)
        check(sealed_equal("A", "sweep", 11)
              and any(p.startswith(os.path.basename(b11) + ".ec03")
                      for p in os.listdir(q)),
              "shard 3 quarantined and rebuilt to its sealed sha256, the "
              "other shards untouched")
        say(f"  scrub job, GiB/s of the 14 x {shard_len} shard bytes "
            f"(task seconds on the worker): "
            f"{json.dumps({k: result[k] for k in ('scrub_baseline', 'scrub_repair')})}"
            f" on {label}")
        result["disk_bytes"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _d, fs in os.walk(workdir) for f in fs)
        say(f"  bytes the phase put on disk: {result['disk_bytes']}")
    finally:
        if env is not None:
            env.close()
        for vs in servers.values():
            vs.stop()
        master.stop()
        scrubber.configure(scrubber.DEFAULT_RATE_BYTES_PER_SECOND)
        shutil.rmtree(workdir, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    say(f"  jobs phase: {result['seconds']:.1f} s")
    return result


# --------------------------------------------------------------------------
# telemetry phase: a cold full volume sealed by the master's own policy
# --------------------------------------------------------------------------

#: The telemetry phase's pulse (master and servers) and size limit: the
#: path phase's 1 GiB volume is past ``full_fraction`` 0.9 of 1024 MB.
TELEMETRY_PULSE = 0.5
TELEMETRY_LIMIT_MB = 1024
TELEMETRY_VID = 21
#: ... its degraded GETs go to every 8th needle of the volume.
TELEMETRY_GET_EVERY = 8
TELEMETRY_MASTER_CONFIG = (
    "[jobs]\npolicy = true\npolicy_interval_seconds = 0.5\n"
    "cooldown_seconds = 600.0\n\n"
    "[slo]\nenabled = true\nread_p99_ms = 2000.0\navailability = 0.99\n"
    "evaluation_interval_seconds = 0.5\nfast_window_seconds = 30.0\n"
    "fast_long_window_seconds = 60.0\nslow_window_seconds = 120.0\n")
TELEMETRY_VOLUME_CONFIG = ("[jobs]\npoll_seconds = 0.2\n\n"
                           "[telemetry]\nenabled = true\n\n"
                           "[usage]\nenabled = true\n")
#: ``record_read`` calls timed with the collector on and off.
RECORD_READ_N = 200_000


def record_read_cost_ns(telemetry_mod) -> dict:
    """ns per ``TelemetryCollector.record_read`` with the collector on
    and off (the JAX package's ``--telemetry-overhead``, in process)."""
    out = {}
    for on in (True, False):
        telemetry_mod.configure(enabled=on)
        try:
            c = telemetry_mod.TelemetryCollector()
            t0 = time.perf_counter_ns()
            for i in range(RECORD_READ_N):
                c.record_read(i & 7, 1 << 20, 0.001)
            out["on" if on else "off"] = \
                (time.perf_counter_ns() - t0) / RECORD_READ_N
        finally:
            telemetry_mod.configure(enabled=True)
    return out


def telemetry_phase(dev, workdir: str, pres: dict, label: str,
                    launches: dict) -> dict:
    """The telemetry, SLO, usage and policy planes on the card: a port
    master set up through ``master -config`` (``-volumeSizeLimitMB
    1024``, ``[jobs] policy = true`` ticking every 0.5 s with a 600 s
    cooldown, a latency and an availability objective on short windows)
    and two port volume servers A and B through ``volume -config``
    (``[telemetry]``, ``[usage]``; pulse 0.5 s), in this process, on
    ``dev``. A copy of the path phase's 1 GiB volume sits unread in A's
    store, full at ``full_fraction`` 0.9. With no command, the master's
    policy submits ``ec_encode`` for it and A's job worker seals it on
    the card (sha256-equal to the path phase's seal). Then, with the
    source and shards 0, 5, 11 and 13 dropped, every 8th needle is read
    through the master's lookup (byte-equal), the master's
    ``/cluster/telemetry`` counts each as one EC decode, the four shell
    commands of the planes and ``cluster.check`` answer, the SLO
    objectives stay ``ok``, and ``record_read`` is timed with the
    collector on and off."""
    import urllib.request

    from seaweedfs_tpu_torch.cluster import master as master_mod
    from seaweedfs_tpu_torch.cluster import operation, telemetry, usage
    from seaweedfs_tpu_torch.cluster import volume_server as vs_mod
    from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.storage.types import FileId
    from seaweedfs_tpu_torch.util import config as config_mod

    t_phase = time.perf_counter()
    scheme = DEFAULT_SCHEME
    total = scheme.total_shards
    vid = TELEMETRY_VID
    src = pres["base"]
    dat_size = os.path.getsize(src + ".dat")
    batches = len(list(encode.plan_batches(dat_size, scheme,
                                           pipe.current().batch_bytes)))
    want = {n: pres["sealed"][n] for n in
            [ec_files.shard_ext(i) for i in range(total)] + [".ecx"]}
    result = {}
    dirs = {name: os.path.join(workdir, name) for name in "AB"}
    for d in dirs.values():
        os.makedirs(d)
    base = os.path.join(dirs["A"], store_mod.volume_base_name(vid, ""))
    for ext in (".dat", ".idx"):
        shutil.copyfile(src + ext, base + ext)
    check(dat_size >= 0.9 * TELEMETRY_LIMIT_MB * MIB,
          f"volume {vid} on A: .dat {dat_size} bytes, full at 0.9 of "
          f"{TELEMETRY_LIMIT_MB} MB")
    # the needles the degraded GETs read back, from the copy before it
    # is sealed: fid -> sha256 of the data
    wanted = {}
    vol = volume_mod.Volume(base, vid).load()
    try:
        for e in pres["idx_entries"][::TELEMETRY_GET_EVERY]:
            n = vol.read_needle(e.key)
            wanted[str(FileId(vid, n.id, n.cookie))] = \
                hashlib.sha256(n.data).digest()
    finally:
        vol.close()

    vconf = os.path.join(workdir, "volume.toml")
    mconf_path = os.path.join(workdir, "master.toml")
    with open(vconf, "w") as f:
        f.write(TELEMETRY_VOLUME_CONFIG)
    with open(mconf_path, "w") as f:
        f.write(TELEMETRY_MASTER_CONFIG)
    server_kw = vs_mod.apply_config(config_mod.load(vconf))
    mconf = config_mod.load(mconf_path)
    master_mod.apply_config(mconf)
    master = master_mod.MasterServer(
        port=vs_mod.free_port_pair(), pulse_seconds=TELEMETRY_PULSE,
        volume_size_limit_mb=TELEMETRY_LIMIT_MB)
    master_mod.configure_master(master, mconf)
    pol = master.policy.payload()
    check(telemetry.enabled() and usage.enabled() and pol["enabled"]
          and pol["interval_seconds"] == 0.5
          and pol["thresholds"]["cooldown_seconds"] == 600.0
          and sorted(master.slo.payload()["objectives"])
          == ["availability", "read_p99_ms"],
          f"master -config: policy {json.dumps(pol['thresholds'])}, SLO "
          f"objectives {sorted(master.slo.payload()['objectives'])}; "
          f"volume -config: [telemetry] and [usage] on")
    servers = {}
    mc = None
    try:
        seal = {}

        def sealed_by_policy():
            # the main path: nothing but the master's own policy asks
            # for this seal
            master.start()
            for i, (name, d) in enumerate(dirs.items()):
                st = store_mod.Store([d])
                st.load_existing()
                servers[name] = vs_mod.VolumeServer(
                    st, port=vs_mod.free_port_pair(),
                    master_url=master.url, data_center="dc1",
                    rack=f"r{i}", pulse_seconds=TELEMETRY_PULSE,
                    device=dev, **server_kw).start()
            servers["A"].heartbeat_now()
            seal["joined"] = time.time()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 120:
                jobs = master.jobs.to_map()["jobs"]
                if any(j["state"] in ("done", "failed", "cancelled")
                       for j in jobs):
                    seal["done"] = time.time()
                    return jobs
                time.sleep(0.02)
            raise SmokeError(f"the policy sealed nothing in 120 s: "
                             f"{json.dumps(master.policy.payload())}")
        got = dict.fromkeys(launches, 0)
        jobs, wall = drive("the policy's ec_encode of the cold full volume",
                           sealed_by_policy,
                           {"transpose": True, "swar": False}, got)
        a = servers["A"]
        check(len(jobs) == 1 and jobs[0]["kind"] == "ec_encode"
              and jobs[0]["submittedBy"] == "policy"
              and jobs[0]["state"] == "done"
              and [t["volumeId"] for t in jobs[0]["tasks"]] == [vid]
              and jobs[0]["tasks"][0]["worker"] == a.url,
              f"job {jobs[0]['jobId']}: {jobs[0]['kind']} submitted by "
              f"{jobs[0]['submittedBy']!r}, {jobs[0]['state']} on A")
        fin = [f for f in a.job_worker.finished if f["volumeId"] == vid]
        check(got["transpose"] == batches and fin and fin[0]["ok"]
              and fin[0]["launches"] == {"transpose": batches},
              f"the seal: {got['transpose']} transpose launches = "
              f"{batches} batches, all on A's worker thread")
        for k, v in got.items():
            launches[k] += v
        digests = _digests([base + n for n in want])
        check(dict(zip(want, digests)) == want,
              f"volume {vid}: 14 shards and .ecx sha256-equal to the path "
              f"phase's seal")
        acts = list(master.policy.actions)
        check([x["action"] for x in acts] == ["ec_encode"]
              and acts[0]["volumeId"] == vid,
              f"the policy's actions ring: {json.dumps(acts)}")
        result["seal"] = {
            "first_tick_to_done_s": seal["done"] - acts[0]["ts"],
            "join_to_done_s": seal["done"] - seal["joined"],
            "task_s": fin[0]["seconds"], "ticks": master.policy.ticks}
        say(f"  policy seal on {label}: {json.dumps(result['seal'])} "
            f"(the task {dat_size / GIB / fin[0]['seconds']:.3f} GiB/s of "
            f".dat)")

        # 2: the source and shards 0, 5, 11 and 13 gone; every 8th
        # needle read through the master's lookup
        a.servicer.VolumeDelete(vpb.VolumeDeleteRequest(
            volume_id=vid, collection=""), None)
        a.servicer.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection="", shard_ids=list(LOST_READ)), None)
        a.heartbeat_now()
        check(sorted(master.topology.lookup_ec_volume(vid)) ==
              [s for s in range(total) if s not in LOST_READ]
              and not master.topology.lookup_volume(vid),
              f"the master: volume {vid} only as EC, shards "
              f"{list(LOST_READ)} held nowhere")
        for vs in servers.values():
            vs.chunk_cache.clear()
        mc = MasterClient(master.url)
        times = []

        def download_all():
            for fid, digest in wanted.items():
                t0 = time.perf_counter()
                body = operation.download(mc, fid)
                times.append(time.perf_counter() - t0)
                if hashlib.sha256(body).digest() != digest:
                    raise SmokeError(f"operation.download {fid}: bytes "
                                     f"differ from the .dat's")
        got = dict.fromkeys(launches, 0)
        drive(f"operation.download of every {TELEMETRY_GET_EVERY}th "
              f"needle with shards {list(LOST_READ)} gone",
              download_all, {"transpose": True, "swar": False}, got)
        for k, v in got.items():
            launches[k] += v
        ms = np.asarray(times) * 1e3
        result["degraded"] = {
            "gets": len(times), "needles_per_s": len(times) / sum(times),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "launches": got}
        say(f"  degraded GETs through the master on {label}: "
            f"{json.dumps(result['degraded'])}")
        t0 = time.perf_counter()
        doc = None
        while time.perf_counter() - t0 < 30:
            for vs in servers.values():
                vs.heartbeat_now()
            with urllib.request.urlopen(
                    f"http://{master.url}/cluster/telemetry",
                    timeout=30) as r:
                doc = json.loads(r.read())
            row = doc["volumes"].get(str(vid), {}).get(a.url, {})
            if row.get("ec_decodes") == len(wanted):
                break
            time.sleep(TELEMETRY_PULSE / 5)
        row = doc["volumes"].get(str(vid), {}).get(a.url, {})
        check(row.get("ec_decodes") == len(wanted)
              and row.get("read_ops") == len(wanted),
              f"/cluster/telemetry: volume {vid} on A, ec_decodes "
              f"{row.get('ec_decodes')} = read_ops {row.get('read_ops')} "
              f"= the {len(wanted)} GETs")
        nodes = doc["nodes"]
        p99 = nodes[a.url].get("read_p99_seconds")
        scores = [nodes[vs.url]["health"]["score"]
                  for vs in servers.values()]
        check(p99 is not None and p99 > 0 and all(
            nodes[vs.url]["health"]["verdict"] == "healthy"
            for vs in servers.values()),
            f"/cluster/telemetry: A's read p99 {p99} s from the digests; "
            f"A and B healthy (scores {scores})")
        result["telemetry"] = {
            "read_p99_s": p99,
            "read_latency": row.get("read_latency"),
            "cluster_median_read_p99_s":
                doc.get("cluster_median_read_p99_seconds")}
        say(f"  /cluster/telemetry on {label}: "
            f"{json.dumps(result['telemetry'])}")

        # 3: the lost shards rebuilt by the cluster shell, then the
        # planes' shell commands and cluster.check
        lines, log = cluster_shell(
            master.url, "lock; ec.rebuild; unlock; telemetry.status; "
            "volume.heatmap; traffic.top; tenant.usage; cluster.check",
            "telemetry shell", {"ec.rebuild": {"transpose": True,
                                               "swar": False}}, launches)
        rebuilt = next(g for name, _w, g in log if name == "ec.rebuild")
        digests = _digests([base + n for n in want])
        check(dict(zip(want, digests)) == want,
              f"the shell's ec.rebuild ({rebuilt} launches): shards "
              f"{list(LOST_READ)} sha256-equal to the path phase's seal")
        check(lines and lines[-1].endswith(" 0 problems")
              and any(ln.startswith(f"{a.url}: healthy") for ln in lines)
              and any(ln.startswith("traffic.top: ") for ln in lines),
              f"the shell: telemetry.status, volume.heatmap, traffic.top, "
              f"tenant.usage and cluster.check answered ({len(lines)} "
              f"lines; {lines[-1]!r})")
        with urllib.request.urlopen(f"http://{master.url}/cluster/slo",
                                    timeout=30) as r:
            slo = json.loads(r.read())
        states = {k: o["state"] for k, o in slo["objectives"].items()}
        check(states == {"read_p99_ms": "ok", "availability": "ok"}
              and slo["evaluations"] > 0,
              f"/cluster/slo: {json.dumps(states)} after "
              f"{slo['evaluations']} evaluations")
        result["slo"] = {"evaluations": slo["evaluations"],
                         "states": states}

        # 4: what the collector costs a read
        result["record_read_ns"] = record_read_cost_ns(telemetry)
        say(f"  the SLO engine: {slo['evaluations']} evaluations; "
            f"record_read on {label}'s host: "
            f"{json.dumps(result['record_read_ns'])} ns per call "
            f"(collector on / off)")
    finally:
        if mc is not None:
            mc.close()
        for vs in servers.values():
            vs.stop()
        master.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    say(f"  telemetry phase: {result['seconds']:.1f} s")
    return result


# --------------------------------------------------------------------------
# filer phase: the filer stack with its chunk cache, on a sealed volume
# --------------------------------------------------------------------------

#: The filer phase's files: FILER_FILES of seeded sizes uniform over
#: 1-8 MiB (about 144 MiB; 64 files before the s3 phase came), PUT
#: through the filer into one collection and
#: cut into FILER_CHUNK_MB chunks; the hot set is the last files read,
#: at most FILER_HOT_BYTES in all, so it fits the filer's 64 MiB cache
#: and each volume server's 64 MiB post-decode cache.
FILER_FILES = 32
FILER_CHUNK_MB = 4
FILER_HOT_BYTES = 32 * MIB
FILER_COLLECTION = "filer"
FILER_PULSE = 0.5


#: The filer phase's trace step: this many files read through the filer
#: with shards LOST_READ lost, each under a trace id of the step's own.
TRACE_GETS = 8
#: The span names of a degraded GET whose share of the GET's wall time
#: the step prints.
TRACE_GET_NAMES = ("filer.GET", "filer.read_file", "cache.get",
                   "volume.read", "read.degraded", "volume.GET",
                   "ec.reconstruct", "grpc.VolumeEcShardRead")
#: A remote leg's root (an HTTP verb's or a gRPC method's span) is closed
#: by its server after the response is written, so its end may trail the
#: caller's span by a thread switch; every other child is held to its
#: parent up to the 1 us rounding of the durations.
TRACE_REMOTE_SLACK = 0.05
#: span enters and exits timed for the cost of one span, outside a
#: trace and inside one (100 roots of 1000 children)
SPAN_COST_N = 100_000


def _is_remote_root(name: str) -> bool:
    head, _, verb = name.rpartition(".")
    return name.startswith("grpc.") or (
        head.isidentifier() and verb in ("GET", "PUT", "POST", "DELETE",
                                         "HEAD"))


def _children_outside_parents(trace: dict) -> list:
    spans = {s["span_id"]: s for s in trace["spans"]}
    bad = []
    for s in trace["spans"]:
        p = spans.get(s["parent_id"])
        if p is None:
            continue
        slack = TRACE_REMOTE_SLACK if _is_remote_root(s["name"]) else 1e-5
        s_end = s["start"] + s["duration_seconds"]
        p_end = p["start"] + p["duration_seconds"]
        if s["start"] < p["start"] or s_end > p_end + slack:
            bad.append(f"{s['name']} outside {p['name']}")
    return bad


def _self_seconds(trace: dict) -> dict:
    """Per span name: the seconds under that span and under none of its
    children (the union of the children's intervals taken out)."""
    kids: dict = {}
    for s in trace["spans"]:
        kids.setdefault(s["parent_id"], []).append(s)
    out: dict = {}
    for s in trace["spans"]:
        lo, hi = s["start"], s["start"] + s["duration_seconds"]
        ivals = sorted((max(lo, c["start"]),
                        min(hi, c["start"] + c["duration_seconds"]))
                       for c in kids.get(s["span_id"], ()))
        covered, cur_lo, cur_hi = 0.0, None, None
        for a, b in ivals:
            if b <= a:
                continue
            if cur_hi is None or a > cur_hi:
                if cur_hi is not None:
                    covered += cur_hi - cur_lo
                cur_lo, cur_hi = a, b
            else:
                cur_hi = max(cur_hi, b)
        if cur_hi is not None:
            covered += cur_hi - cur_lo
        out[s["name"]] = out.get(s["name"], 0.0) + max(
            0.0, s["duration_seconds"] - covered)
    return out


def span_cost_ns() -> dict:
    """The cost of one ``tracing.span`` enter and exit, in ns: outside a
    trace (the no-op path), and inside one. The roots of the inside
    measurement are neither pushed nor kept."""
    from seaweedfs_tpu_torch.util import tracing

    t0 = time.perf_counter_ns()
    for _ in range(SPAN_COST_N):
        with tracing.span("bench.noop"):
            pass
    outside = (time.perf_counter_ns() - t0) / SPAN_COST_N
    saved = tracing._PUSH_THRESHOLD
    tracing._PUSH_THRESHOLD = 1e9
    inside_ns = 0
    try:
        for _ in range(SPAN_COST_N // 1000):
            with tracing.start_trace("bench.root"):
                t0 = time.perf_counter_ns()
                for _ in range(1000):
                    with tracing.span("bench.child"):
                        pass
                inside_ns += time.perf_counter_ns() - t0
    finally:
        tracing._PUSH_THRESHOLD = saved
        tracing.reset()
    return {"outside_ns": outside, "inside_ns": inside_ns / SPAN_COST_N}


def trace_step(master, servers: dict, filer, conn, files: dict,
               digests: dict, fcache, label: str,
               launches: dict) -> dict:
    """The filer phase's trace step, after its measured rates: every
    root pushed to the master (``[tracing] push_threshold_seconds =
    0``), every chunk cache cleared, shards LOST_READ lost again, then
    TRACE_GETS files read through the filer under trace ids of the
    step's own, one ``ec.rebuild`` through the cluster shell, a burst
    profile of server A through ``/cluster/profile`` while reads are in
    flight, and the master's ``/cluster/traces`` read back. In this one
    process every bundle carries the node of the last server that set
    the push target (the filer); the legs are told apart by their span
    names. The burst's own reads come after the traces are read back,
    with the push threshold at its default again."""
    import http.client
    import urllib.request

    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.shell.cluster_commands import ClusterEnv
    from seaweedfs_tpu_torch.util import tracing

    t_step = time.perf_counter()
    result = {}
    tracing.configure_from({"tracing": {"push_threshold_seconds": 0.0}})
    base = f"http://{master.url}"

    def get_json(url):
        with urllib.request.urlopen(url, timeout=60) as r:
            return json.loads(r.read())

    def settle():
        for vs in servers.values():
            vs.heartbeat_now()

    def drain():
        deadline = time.time() + 60
        while tracing.push_stats()["queued"] and time.time() < deadline:
            time.sleep(0.01)

    vids = sorted({v for vs in servers.values()
                   for (_c, v) in vs.store.ec_mounts})
    env = ClusterEnv(master_url=master.url, out=io.StringIO())
    try:
        for vs in servers.values():
            for (col, v), m in list(vs.store.ec_mounts.items()):
                gone = [s for s in m.shard_ids if s in LOST_READ]
                if gone:
                    env.volume(vs.url).VolumeEcShardsDelete(
                        vpb.VolumeEcShardsDeleteRequest(
                            volume_id=v, collection=col, shard_ids=gone))
    finally:
        env.close()
    settle()
    check(all(not set(master.topology.lookup_ec_volume(v)) & set(LOST_READ)
              for v in vids),
          f"trace step: shards {list(LOST_READ)} of volumes {vids} lost "
          f"again")
    time.sleep(1.1)    # the servers' shard-location caches expire
    fcache.clear()
    for vs in servers.values():
        vs.chunk_cache.clear()
    before = {t["trace_id"] for t in get_json(
        f"{base}/cluster/traces")["traces"]}

    # 1-2. the traced degraded GETs
    paths = list(files)[:TRACE_GETS]
    tids = {p: f"{SEED:08x}{i:08x}" for i, p in enumerate(paths)}

    def gets():
        for p in paths:
            conn.request("GET", p, headers={
                tracing.TRACE_HEADER: f"{tids[p]}-"})
            r = conn.getresponse()
            body = r.read()
            if r.status != 200 or \
                    hashlib.sha256(body).digest() != digests[p]:
                raise SmokeError(f"trace step: GET {p} gave {r.status}")
            drain()
    reset_counts()
    t0 = time.perf_counter()
    gets()
    get_wall = time.perf_counter() - t0
    got = counts()
    host_calls = rs_native.apply_gf_matrix.calls
    for k, v in got.items():
        launches[k] += v

    # 3. one ec.rebuild through the cluster shell, its pipeline series
    hist = tracing.METRICS.histogram("request_stage_seconds",
                                     stage="pipe.compute")
    n0, batches0 = hist.n, pipe.debug_payload()["batches"]
    _, log = cluster_shell(master.url, f"lock; ec.rebuild -collection "
                           f"{FILER_COLLECTION}; unlock",
                           "trace step rebuild",
                           {"ec.rebuild": {"transpose": True,
                                           "swar": False}}, launches)
    settle()
    rebuild_batches = pipe.debug_payload()["batches"] - batches0
    check(hist.n - n0 == rebuild_batches > 0,
          f"trace step: the pipe.compute series counted "
          f"{hist.n - n0} batches, the ec.rebuild runs {rebuild_batches}")
    for name, _w, g in log:
        for k, v in g.items():
            got[k] += v

    drain()
    time.sleep(0.2)
    # 5. (read before the burst's reads, which are not pushed) the
    # master's stitched traces
    doc = get_json(f"{base}/cluster/traces")
    push = tracing.push_stats()
    tracing._PUSH_THRESHOLD = None

    # 4. a burst profile of A while reads are in flight
    stop = threading.Event()
    others = [p for p in files if p not in tids]

    def load():
        lconn = http.client.HTTPConnection("127.0.0.1", filer.port,
                                           timeout=120)
        try:
            i = 0
            while not stop.is_set():
                fcache.clear()
                _http(lconn, "GET", others[i % len(others)])
                i += 1
        finally:
            lconn.close()
    th = threading.Thread(target=load, name="trace-step-load")
    th.start()
    try:
        with urllib.request.urlopen(
                f"{base}/cluster/profile?node={servers['A'].url}"
                f"&seconds=0.5", timeout=60) as r:
            burst = r.read().decode()
    finally:
        stop.set()
        th.join()
    stacks = [ln for ln in burst.strip().splitlines() if ln]
    check(len(stacks) >= 1 and all(int(ln.rsplit(" ", 1)[1]) >= 1
                                   for ln in stacks),
          f"trace step: the burst profile of A through /cluster/profile "
          f"has {len(stacks)} collapsed stacks")
    by_id = {t["trace_id"]: t for t in doc["traces"]}
    traced = [by_id.get(tids[p]) for p in paths]
    check(all(t is not None and t["has_root"] and t["name"] == "filer.GET"
              and {"filer.GET", "volume.GET"} <= {s["name"]
                                                  for s in t["spans"]}
              for t in traced),
          f"trace step: each of the {TRACE_GETS} GETs stitched at the "
          f"master with its filer and volume legs and its root")
    outside = [b for t in traced for b in _children_outside_parents(t)]
    check(not outside, f"trace step: every child span lies inside its "
          f"parent ({outside[:3]})")
    check(got["transpose"] > 0,
          f"trace step: the transpose kernel launched {got['transpose']} "
          f"times inside the traced window")
    shares, selfs = {n: [] for n in TRACE_GET_NAMES}, {}
    walls = []
    for t in traced:
        root = next(s for s in t["spans"] if s["name"] == "filer.GET"
                    and not s["parent_id"])
        wall = root["duration_seconds"]
        walls.append(wall)
        for n in TRACE_GET_NAMES:
            shares[n].append(sum(s["duration_seconds"] for s in t["spans"]
                                 if s["name"] == n) / wall)
        for n, v in _self_seconds(t).items():
            selfs.setdefault(n, []).append(v / wall)
    for n in selfs:
        selfs[n] += [0.0] * (len(traced) - len(selfs[n]))

    def med_p99(v):
        return {"p50": float(np.percentile(v, 50)),
                "p99": float(np.percentile(v, 99))}
    result["get"] = {
        "wall_ms": {k: 1e3 * x for k, x in med_p99(walls).items()},
        "spans": {n: med_p99(v) for n, v in shares.items()},
        "self": {n: med_p99(v) for n, v in sorted(selfs.items())},
        "span_counts": [t["span_count"] for t in traced]}
    say(f"  trace step on {label}:")
    say(f"  degraded GETs through the filer, {TRACE_GETS} stitched traces, "
        f"wall ms {json.dumps(result['get']['wall_ms'])}, spans per trace "
        f"{result['get']['span_counts']}")
    say(f"  share of a GET's wall time in each span name (p50, p99): "
        f"{json.dumps(result['get']['spans'])}")
    say(f"  share under each span name and under none of its children "
        f"(self time; the root's is the time under no child span): "
        f"{json.dumps(result['get']['self'])}")
    new_rebuilds = [t for t in doc["traces"]
                    if t["name"] == "shell.ec.rebuild"
                    and t["trace_id"] not in before]
    check(len(new_rebuilds) == 1 and new_rebuilds[0]["has_root"],
          "trace step: one stitched shell.ec.rebuild trace")
    rt = new_rebuilds[0]
    legs: dict = {}
    for s in rt["spans"]:
        if s["name"].startswith("grpc.") or s["name"] in (
                "shell.ec.rebuild", "ec.rebuild"):
            legs.setdefault(s["name"], [0, 0.0])
            legs[s["name"]][0] += 1
            legs[s["name"]][1] += s["duration_seconds"]
    rb_bytes = sum(s["bytes"] for s in rt["spans"]
                   if s["name"] == "ec.rebuild")
    result["rebuild"] = {"legs": {n: {"calls": c, "s": sec}
                                  for n, (c, sec) in sorted(legs.items())},
                         "self_s": _self_seconds(rt),
                         "ec_rebuild_bytes": rb_bytes}
    check(rb_bytes > 0 and "grpc.VolumeEcShardsRebuild" in legs,
          f"trace step: the ec.rebuild trace holds the servers' legs and "
          f"{rb_bytes} rebuilt bytes")
    say(f"  ec.rebuild legs (calls, seconds): "
        f"{json.dumps(result['rebuild']['legs'])}; ec.rebuild spans' "
        f"n_bytes {rb_bytes}; seconds under each span name and under "
        f"none of its children: {json.dumps(result['rebuild']['self_s'])}")
    say(f"  launches inside the step: {json.dumps(got)} (the GETs "
        f"{get_wall:.3f} s; host-codec calls of the GETs {host_calls}); "
        f"the push worker: {json.dumps(push)}")
    for name, url in [("master", master.url)] + [
            (n, vs.url) for n, vs in servers.items()] + [
            ("filer", filer.url)]:
        vz = get_json(f"http://{url}/debug/vars")
        served = [(s["component"], s["served_total"])
                  for s in vz["ingress"]["servers"]]
        say(f"  /debug/vars of {name}: pipeline.runs "
            f"{vz['pipeline'].get('runs')}, slow_requests "
            f"{len(vz['slow_requests'])}, trace_push "
            f"{json.dumps(vz['trace_push'])}, ingress served "
            f"{json.dumps(served)}, shed "
            f"{json.dumps(vz['ingress']['shed'])}")
    parked = ("wait", "select", "_serve", "_worker", "sleep", "accept",
              "get", "poll", "_wait_once", "channel_spin", "readinto")
    busy = [ln for ln in stacks
            if ln.rsplit(" ", 1)[0].rsplit(":", 1)[-1] not in parked]
    for what, rows in (("top 5", stacks[:5]),
                       ("top 5 not parked in a wait", busy[:5])):
        say(f"  the burst's {what} collapsed stacks (the last 6 frames):")
        for ln in rows:
            stack, n = ln.rsplit(" ", 1)
            say(f"    {n} samples: ...;{';'.join(stack.split(';')[-6:])}")
    result["span_cost"] = span_cost_ns()
    say(f"  one tracing.span enter and exit, {SPAN_COST_N} of each: "
        f"{result['span_cost']['outside_ns']:.0f} ns outside a trace, "
        f"{result['span_cost']['inside_ns']:.0f} ns inside one")
    tracing.configure_push(None)
    tracing._PUSH_THRESHOLD = None
    result["seconds"] = time.perf_counter() - t_step
    say(f"  trace step: {result['seconds']:.1f} s")
    return result


def filer_phase(dev, workdir: str, label: str, launches: dict) -> dict:
    """The filer stack in this process on the card: a port master, two
    port volume servers A and B (their default 64 MiB post-decode
    caches) and one port filer (the default ``[cache]``, 64 MiB). 64
    files PUT through the filer's HTTP; ``fs.ls``, ``fs.du`` and
    ``volume.fsck`` through ``shell -master ... -filer ...``; the
    collection sealed with ``ec.encode`` over A and B; shards 0, 5, 11
    and 13 deleted everywhere and every file read back through the filer
    (repairs on the card); the hot set read again from the filer's cache
    (no launch, no volume-server read), then from the volume servers'
    post-decode caches (no launch); ``ec.rebuild`` drops every cached
    entry of the volumes, and the hot set reads back with no launch; last
    ``python -m seaweedfs_tpu_torch filer`` in its own process."""
    import http.client
    import signal
    import urllib.error
    import urllib.request

    from seaweedfs_tpu_torch import cache as cache_mod
    from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.shell.cluster_commands import ClusterEnv

    t_phase = time.perf_counter()
    result = {}
    rng = np.random.default_rng(SEED + 12)
    sizes = [int(x) for x in rng.integers(MIB, 8 * MIB + 1, FILER_FILES)]
    files = {f"/{FILER_COLLECTION}/f{i:02d}.bin": rng.bytes(n)
             for i, n in enumerate(sizes)}
    digests = {p: hashlib.sha256(b).digest() for p, b in files.items()}
    total = sum(sizes)
    say(f"  {FILER_FILES} files of {total} bytes ({total / MIB:.1f} MiB), "
        f"sizes seeded over 1-8 MiB, {FILER_CHUNK_MB} MiB chunks")
    # the process's chunk cache as `filer` starts it: the [cache] defaults
    cache_mod.configure_global()
    fcache = cache_mod.global_chunk_cache()
    check(fcache.stats()["memory_capacity"] == 64 * MIB,
          "the filer's chunk cache: the [cache] default of 64 MiB")
    master = MasterServer(port=free_port_pair(),
                          pulse_seconds=FILER_PULSE).start()
    servers, filer, env, conn = {}, None, None, None
    try:
        for name in "AB":
            d = os.path.join(workdir, name)
            os.makedirs(d)
            servers[name] = VolumeServer(
                store_mod.Store([d]), port=free_port_pair(),
                master_url=master.url, data_center="dc1", rack="r0",
                pulse_seconds=FILER_PULSE, device=dev).start()
            servers[name].heartbeat_now()
        a, b = servers["A"], servers["B"]
        check(a.chunk_cache.stats()["memory_capacity"] == 64 * MIB,
              "volume servers A and B: post-decode caches of 64 MiB")
        filer = FilerServer(Filer(), port=free_port_pair(),
                            master_url=master.url).start()

        def settle():
            for vs in servers.values():
                vs.heartbeat_now()

        def vs_reads() -> int:
            return sum(int(vs.metrics.counter("read_requests",
                                              code=c).value)
                       for vs in servers.values() for c in ("200", "206"))

        # 1. writes through the filer's HTTP, one volume grown on each
        # server first so the files spread over both
        vids = sorted(master.grow_volume(FILER_COLLECTION)
                      for _ in range(2))
        settle()
        conn = http.client.HTTPConnection("127.0.0.1", filer.port,
                                          timeout=300)
        put_s = 0.0
        for path, data in files.items():
            t0 = time.perf_counter()
            code, body = _http(conn, "PUT", f"{path}?collection="
                               f"{FILER_COLLECTION}&maxMB={FILER_CHUNK_MB}",
                               data)
            put_s += time.perf_counter() - t0
            if code != 201:
                raise SmokeError(f"PUT {path}: {code} {body[:200]!r}")
        chunks = {p: filer.filer.find_entry(p).chunks for p in files}
        used = sorted({int(c.file_id.split(",")[0])
                       for cs in chunks.values() for c in cs})
        n_chunks = sum(len(cs) for cs in chunks.values())
        check(used == vids and n_chunks == sum(
            -(-n // (FILER_CHUNK_MB * MIB)) for n in sizes),
            f"{FILER_FILES} files in {n_chunks} chunks of at most "
            f"{FILER_CHUNK_MB} MiB on volumes {used}")
        result["put"] = {"files_per_s": FILER_FILES / put_s,
                         "mib_per_s": total / MIB / put_s, "s": put_s}
        say(f"  PUT through the filer on {label}: "
            f"{json.dumps(result['put'])}")
        settle()

        # 2. listing and fsck through shell -master ... -filer ...
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            (rc,), _ = drive(
                "shell -filer: fs.ls, fs.du, volume.fsck",
                lambda: (cli.main(["-master", master.url, "-filer",
                                   filer.url, "-c",
                                   f"fs.ls -l /{FILER_COLLECTION}; "
                                   f"fs.du /{FILER_COLLECTION}; "
                                   "volume.fsck"]),),
                dict.fromkeys(KERNELS, False), launches)
        # drive's own "ok:" lines went to the same buffer
        lines = [x for x in out.getvalue().splitlines()
                 if not x.startswith("  ok: ")]
        for line in lines[-3:]:
            say(f"  > {line}")
        check(rc == 0 and f"total {FILER_FILES}" in lines
              and f"{total} bytes, {FILER_FILES} files, 0 dirs under "
              f"/{FILER_COLLECTION}" in lines,
              f"fs.ls -l lists {FILER_FILES} files, fs.du {total} bytes")
        check(lines[-1].startswith("volume.fsck: 2 volumes, 0 orphan "
                                   "needles (0 bytes), 0 missing chunks"),
              f"volume.fsck: 0 orphans, 0 missing chunks ({lines[-1]})")

        # 3. seal the collection over A and B
        _, seal_log = cluster_shell(
            master.url, "lock; " + "; ".join(
                f"ec.encode -volumeId {v} -collection {FILER_COLLECTION}"
                for v in vids) + "; unlock", "filer seal",
            {"ec.encode": {"transpose": True, "swar": False}}, launches)
        settle()
        held = {name: sorted(v for (_c, v) in vs.store.ec_mounts)
                for name, vs in servers.items()}
        check(all(h == vids for h in held.values()) and not any(
            vs.store.has_volume(v, FILER_COLLECTION)
            for vs in servers.values() for v in vids),
            f"ec.encode: volumes {vids} sealed, shards on A and B "
            f"({sum(w for n, w, _ in seal_log if n == 'ec.encode'):.3f} s)")

        # 4. lose shards 0, 5, 11, 13 everywhere; read every file
        env = ClusterEnv(master_url=master.url, out=io.StringIO())
        for vs in servers.values():
            for (col, v), m in list(vs.store.ec_mounts.items()):
                gone = [s for s in m.shard_ids if s in LOST_READ]
                if gone:
                    env.volume(vs.url).VolumeEcShardsDelete(
                        vpb.VolumeEcShardsDeleteRequest(
                            volume_id=v, collection=col, shard_ids=gone))
        settle()
        check(all(sorted(master.topology.lookup_ec_volume(v)) ==
                  [s for s in range(DEFAULT_SCHEME.total_shards)
                   if s not in LOST_READ] for v in vids),
              f"shards {list(LOST_READ)} of volumes {vids} held nowhere")
        time.sleep(1.1)    # the servers' shard-location caches expire

        def get_all(paths, what, expect):
            times = []

            def run():
                for p in paths:
                    t0 = time.perf_counter()
                    code, body = _http(conn, "GET", p)
                    times.append(time.perf_counter() - t0)
                    if code != 200 or \
                            hashlib.sha256(body).digest() != digests[p]:
                        raise SmokeError(f"{what}: GET {p} gave {code}")
            drive(what, run, expect, launches)
            return times

        order = list(files)
        times = get_all(order, f"filer GET, shards {list(LOST_READ)} lost",
                        {"transpose": True, "swar": False})
        got = counts()
        ms = np.asarray(times) * 1e3
        result["degraded"] = {
            "files_per_s": len(times) / sum(times),
            "mib_per_s": total / MIB / sum(times),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "launches": got,
            "host_codec_calls": rs_native.apply_gf_matrix.calls}
        check(len(times) == FILER_FILES, f"filer GET: all {FILER_FILES} "
              f"files sha256-equal to what was PUT")
        say(f"  degraded filer GET on {label}: "
            f"{json.dumps(result['degraded'])}")

        # 5. the hot set again: the filer's cache answers
        hot, hot_bytes = [], 0
        for p in reversed(order):
            if hot_bytes + len(files[p]) > FILER_HOT_BYTES:
                break
            hot.insert(0, p)
            hot_bytes += len(files[p])
        reads0 = vs_reads()
        times = get_all(hot, "filer GET of the hot set (filer cache)",
                        dict.fromkeys(KERNELS, False))
        check(vs_reads() == reads0, f"hot set ({len(hot)} files, "
              f"{hot_bytes} bytes): no volume-server read request")
        result["filer_cache"] = {"files": len(hot), "bytes": hot_bytes,
                                 "mib_per_s": hot_bytes / MIB / sum(times),
                                 "hits": fcache.hits}
        say(f"  hot set from the filer's cache: "
            f"{json.dumps(result['filer_cache'])}")

        # 6. the filer's cache cleared: the servers' caches answer
        fcache.clear()
        hits0 = {n: vs.chunk_cache.hits for n, vs in servers.items()}
        reads0 = vs_reads()
        times = get_all(hot, "filer GET of the hot set (post-decode "
                        "caches)", dict.fromkeys(KERNELS, False))
        hits = {n: vs.chunk_cache.hits - hits0[n]
                for n, vs in servers.items()}
        n_hot_chunks = sum(len(chunks[p]) for p in hot)
        check(sum(hits.values()) == n_hot_chunks
              and vs_reads() - reads0 == n_hot_chunks,
              f"hot set: {n_hot_chunks} chunk reads, all post-decode "
              f"cache hits ({hits})")
        result["vs_cache"] = {"mib_per_s": hot_bytes / MIB / sum(times),
                              "hits": hits,
                              "per_volume": {n: vs.chunk_cache
                                             .per_volume_counts()
                                             for n, vs in servers.items()}}
        say(f"  hot set from the volume servers' caches: "
            f"{json.dumps(result['vs_cache'])}")

        # 7. ec.rebuild drops every cached entry of the volumes
        _, log = cluster_shell(master.url, f"lock; ec.rebuild -collection "
                      f"{FILER_COLLECTION}; unlock", "filer rebuild",
                      {"ec.rebuild": {"transpose": True, "swar": False}},
                      launches)
        settle()
        result["rebuild_s"] = sum(w for n, w, _ in log if n == "ec.rebuild")
        result["seal_s"] = sum(w for n, w, _ in seal_log
                               if n == "ec.encode")
        say(f"  ec.encode of volumes {vids}: {result['seal_s']:.3f} s, "
            f"ec.rebuild: {result['rebuild_s']:.3f} s on {label}")
        left = {n: vs.chunk_cache.stats()["memory_entries"]
                for n, vs in servers.items()}
        check(all(n == 0 for n in left.values())
              and all(c.invalidate_volume(v) == 0
                      for c in [fcache] + [vs.chunk_cache
                                           for vs in servers.values()]
                      for v in vids),
              f"ec.rebuild: every cached entry of volumes {vids} dropped "
              f"(servers' entries {left}; per-volume counts "
              f"{json.dumps({n: vs.chunk_cache.per_volume_counts() for n, vs in servers.items()})})")
        deadline = time.time() + 30
        while time.time() < deadline and not all(
                vs.ec_shard_peers(v, s) for vs in servers.values()
                for v in vids for s in LOST_READ):
            time.sleep(0.2)
        times = get_all(hot, "filer GET of the hot set after ec.rebuild",
                        dict.fromkeys(KERNELS, False))
        check(len(times) == len(hot), "hot set after ec.rebuild: "
              "byte-equal, no launch")

        # 8. python -m seaweedfs_tpu_torch filer in its own process
        t_sub = time.perf_counter()
        port = free_port_pair()
        penv = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "filer",
             "-port", str(port), "-master", master.url],
            cwd=REPO, env=penv, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        try:
            url = f"http://127.0.0.1:{port}"
            deadline = time.time() + 60
            while True:
                try:
                    urllib.request.urlopen(url + "/", timeout=2)
                    break
                except urllib.error.HTTPError:
                    break
                except OSError:
                    if time.time() > deadline or proc.poll() is not None:
                        raise SmokeError("the filer subprocess did not "
                                         "come up")
                    time.sleep(0.2)
            blob = rng.bytes(MIB + 3)
            req = urllib.request.Request(url + "/sub/blob.bin", data=blob,
                                         method="PUT")
            with urllib.request.urlopen(req, timeout=60) as r:
                put_code = r.status
            with urllib.request.urlopen(url + "/sub/blob.bin",
                                        timeout=60) as r:
                back = r.read()
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
        result["subprocess_s"] = time.perf_counter() - t_sub
        check(put_code == 201 and back == blob and rc == 0,
              f"python -m seaweedfs_tpu_torch filer: PUT {put_code}, GET "
              f"byte-equal, exit {rc} on SIGTERM "
              f"({result['subprocess_s']:.1f} s)")

        # 9. the trace step, after every rate above
        result["trace"] = trace_step(master, servers, filer, conn, files,
                                     digests, fcache, label, launches)
    finally:
        if conn is not None:
            conn.close()
        if env is not None:
            env.close()
        if filer is not None:
            filer.stop()
        for vs in servers.values():
            vs.stop()
        master.stop()
        from seaweedfs_tpu_torch.util import tracing
        tracing.configure_push(None)
        tracing._PUSH_THRESHOLD = None
        cache_mod.configure_global()
        shutil.rmtree(workdir, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    say(f"  filer phase: {result['seconds']:.1f} s")
    return result


# --------------------------------------------------------------------------
# s3 phase: the S3 gateway, the checkpoint plane on the card's tensors and
# the S3 tier
# --------------------------------------------------------------------------

#: One decoder layer of Llama-2-7B at its published widths (Hugging Face
#: meta-llama/Llama-2-7b-hf config.json: hidden_size 4096,
#: intermediate_size 11008), float16; the depth is cut to one layer.
LLAMA_HIDDEN = 4096
LLAMA_INTERMEDIATE = 11008
S3_COLLECTION = "s3"
S3_PULSE = 0.5
#: The multipart upload: 64 MiB in 8 MiB parts.
S3_MULTIPART_BYTES = 64 * MIB
S3_PART_BYTES = 8 * MIB
#: The tiered volume: 128 MiB of config 1's needles (its first needles),
#: cut from the 1 GiB volume for time; every 4th needle read through
#: the tier.
TIER_VOLUME_BYTES = 128 * MIB
TIER_READ_EVERY = 4
S3_AK, S3_SK = "CHIPAK", "CHIPSK"


def llama_layer(rng) -> dict:
    """The layer's parameters as numpy float16, named as Hugging Face
    names them, with values seeded from numpy."""
    h, i = LLAMA_HIDDEN, LLAMA_INTERMEDIATE
    shapes = {"self_attn": {"q_proj": (h, h), "k_proj": (h, h),
                            "v_proj": (h, h), "o_proj": (h, h)},
              "mlp": {"gate_proj": (i, h), "up_proj": (i, h),
                      "down_proj": (h, i)},
              "input_layernorm": (h,), "post_attention_layernorm": (h,)}

    def make(v):
        if isinstance(v, dict):
            return {k: make(x) for k, x in v.items()}
        return rng.standard_normal(v, dtype=np.float32).astype(np.float16)
    return make(shapes)


def _leaves(tree, prefix=""):
    """``(name, leaf)`` of a tree of dicts and lists, names as the
    checkpoint store builds them."""
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def s3_phase(dev, workdir: str, label: str, launches: dict) -> dict:
    """The S3 gateway, the checkpoint plane and the S3 tier in this
    process on the card: a port master, two port volume servers A and B,
    one port filer (collection ``s3``) and two gateways over it, one open
    and one with a SigV4 identity. (1) One Llama-2-7B decoder layer,
    float16, its matrices sharded ``("dp", "sp")`` over a 2 x 2 grid of
    four ``cuda:0`` cells and its norms replicated, saved from the card
    through the open gateway, listed by the shell's ``ckpt.list``, and
    restored onto the same grid: every block equal on the card, no
    launch. (2) Every volume of the collection sealed over A and B,
    shards 0, 5, 11 and 13 deleted everywhere, every chunk cache cleared,
    and the layer restored again: every block equal, the repairs on the
    card. (3) One shard object of ``down_proj`` read whole as 1 MiB
    sequential ranged GETs (the readahead window opens), a 64 MiB
    multipart upload in 8 MiB parts and a CopyObject, sha256-equal; a
    signed PUT and GET, an unsigned PUT and a stale date refused. (4) One
    shard object overwritten with one byte flipped: the restore fails
    closed. (5) A 128 MiB volume of config 1's needles in an offline
    store tiered to the signed gateway (multipart), read through the
    tier, refused by ``ec.encode``, downloaded sha256-equal and sealed
    with one launch, its shards sha256-equal to sealing the local copy.
    (6) ``python -m seaweedfs_tpu_torch s3`` in its own process."""
    import http.client
    import signal
    import urllib.error
    import urllib.request

    from seaweedfs_tpu_torch import cache as cache_mod
    from seaweedfs_tpu_torch.cache import readahead
    from seaweedfs_tpu_torch.ckpt import (CheckpointStore, CorruptShardError,
                                          GatewayClient, NamedSharding,
                                          PartitionSpec, device_put)
    from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.gateway.s3 import S3Gateway
    from seaweedfs_tpu_torch.gateway.s3_auth import (Identity,
                                                     sign_request_headers)
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.shell.cluster_commands import ClusterEnv

    t_phase = time.perf_counter()
    result = {}
    rng = np.random.default_rng(SEED + 13)
    host = llama_layer(rng)
    total = sum(a.nbytes for _, a in _leaves(host))
    say(f"  Llama-2-7B decoder layer: {len(list(_leaves(host)))} params, "
        f"{total} bytes ({total / MIB:.1f} MiB) float16, sharded "
        f"(dp, sp) over 2 x 2 cuda:0 cells, norms replicated")
    mesh_ = mesh.Mesh([dev] * 4, 2, 2)
    split = NamedSharding(mesh_, PartitionSpec("dp", "sp"))
    whole = NamedSharding(mesh_, PartitionSpec())

    def place(tree):
        return {k: place(v) if isinstance(v, dict) else device_put(
                    torch.from_numpy(v).to(dev),
                    split if v.ndim == 2 else whole)
                for k, v in tree.items()}

    layer = {"layers": [place(host)]}
    torch.cuda.synchronize(dev)
    cache_mod.configure_global()
    gcache = cache_mod.global_chunk_cache()
    master = MasterServer(port=free_port_pair(),
                          pulse_seconds=S3_PULSE).start()
    servers, filer, gws, env = {}, None, [], None
    try:
        for name in "AB":
            d = os.path.join(workdir, name)
            os.makedirs(d)
            servers[name] = VolumeServer(
                store_mod.Store([d]), port=free_port_pair(),
                master_url=master.url, data_center="dc1", rack="r0",
                pulse_seconds=S3_PULSE, device=dev).start()
            servers[name].heartbeat_now()
        filer = FilerServer(Filer(), port=free_port_pair(),
                            master_url=master.url,
                            collection=S3_COLLECTION).start()
        g0 = S3Gateway(filer.url, port=free_port_pair()).start()
        g1 = S3Gateway(filer.url, port=free_port_pair(), identities=[
            Identity("chip", S3_AK, S3_SK)]).start()
        gws += [g0, g1]

        def settle():
            for vs in servers.values():
                vs.heartbeat_now()

        vids = sorted(master.grow_volume(S3_COLLECTION) for _ in range(2))
        settle()

        # 1. save from the card, list, restore clean
        st = CheckpointStore(g0.url)
        man, wall = drive("ckpt.save of the layer from the card",
                          lambda: st.save("llama2-7b-layer0", layer),
                          dict.fromkeys(KERNELS, False), launches)
        n_obj = sum(len(p.shards) for p in man.params)
        check(sum(s.nbytes for p in man.params for s in p.shards) == total
              and n_obj == 30 and man.mesh_axes == {"dp": 2, "sp": 2},
              f"ckpt.save: {len(man.params)} params, {n_obj} shard "
              f"objects, {total} bytes, mesh {man.mesh_axes}")
        result["save"] = {"s": wall, "mib_per_s": total / MIB / wall,
                          "objects": st.client.stats["puts"]}
        say(f"  ckpt.save on {label}: {json.dumps(result['save'])}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-dir", workdir, "-device", "cuda", "-c",
                           f"ckpt.list -gateway {g0.url}"])
        for line in out.getvalue().splitlines():
            say(f"  > {line}")
        check(rc == 0 and f"  llama2-7b-layer0: params=9 shards=30 "
              f"bytes={total}" in out.getvalue().splitlines(),
              "shell ckpt.list: the layer, 9 params, 30 shards")

        def restore(what, expect):
            client = GatewayClient(g0.url)
            rst = CheckpointStore(g0.url, client=client)
            times = []
            real = rst._place_block

            def timed(*a, **k):
                t0 = time.perf_counter()
                placed = real(*a, **k)
                times.append(time.perf_counter() - t0)
                return placed
            rst._place_block = timed
            got, wall = drive(what, lambda: rst.restore(
                "llama2-7b-layer0", mesh=mesh_, template=layer), expect,
                launches)
            torch.cuda.synchronize(dev)
            same = all(
                len(a.blocks) == len(b.blocks) == 4 and all(
                    torch.equal(x.data, y.data) and x.start == y.start
                    and y.data.device == dev
                    for x, y in zip(a.blocks, b.blocks))
                for (_, a), (_, b) in zip(_leaves(layer), _leaves(got)))
            ms = np.asarray(times) * 1e3
            return same, {"s": wall, "mib_per_s": total / MIB / wall,
                          "blocks": len(times),
                          "p50_ms": float(np.percentile(ms, 50)),
                          "p99_ms": float(np.percentile(ms, 99)),
                          "ranged_gets": client.stats["ranged_gets"]}

        same, result["restore"] = restore(
            "ckpt.restore onto the 2 x 2 grid",
            dict.fromkeys(KERNELS, False))
        check(same, f"clean restore: all {result['restore']['blocks']} "
              f"blocks torch.equal on the card, no launch")
        say(f"  clean restore on {label}: {json.dumps(result['restore'])}")

        # 2. seal, lose shards 0, 5, 11, 13, clear every cache, restore
        _, seal_log = cluster_shell(
            master.url, "lock; " + "; ".join(
                f"ec.encode -volumeId {v} -collection {S3_COLLECTION}"
                for v in vids) + "; unlock", "s3 seal",
            {"ec.encode": {"transpose": True, "swar": False}}, launches)
        settle()
        check(all(sorted(v for (_c, v) in vs.store.ec_mounts) == vids
                  for vs in servers.values()),
              f"ec.encode: volumes {vids} sealed over A and B")
        env = ClusterEnv(master_url=master.url, out=io.StringIO())
        for vs in servers.values():
            for (col, v), m in list(vs.store.ec_mounts.items()):
                gone = [s for s in m.shard_ids if s in LOST_READ]
                if gone:
                    env.volume(vs.url).VolumeEcShardsDelete(
                        vpb.VolumeEcShardsDeleteRequest(
                            volume_id=v, collection=col, shard_ids=gone))
        settle()
        gcache.clear()
        for vs in servers.values():
            vs.chunk_cache.clear()
        check(all(sorted(master.topology.lookup_ec_volume(v)) ==
                  [s for s in range(DEFAULT_SCHEME.total_shards)
                   if s not in LOST_READ] for v in vids)
              and gcache.stats()["memory_entries"] == 0,
              f"shards {list(LOST_READ)} held nowhere; the process's and "
              f"both servers' chunk caches empty")
        time.sleep(1.1)    # the servers' shard-location caches expire
        same, result["degraded"] = restore(
            f"ckpt.restore, shards {list(LOST_READ)} lost",
            {"transpose": True, "swar": False})
        result["degraded"]["launches"] = counts()
        result["degraded"]["host_codec_calls"] = \
            rs_native.apply_gf_matrix.calls
        result["seal_s"] = sum(w for n, w, _ in seal_log
                               if n == "ec.encode")
        check(same, f"degraded restore: all "
              f"{result['degraded']['blocks']} blocks torch.equal")
        say(f"  degraded restore on {label}: "
            f"{json.dumps(result['degraded'])}; seal "
            f"{result['seal_s']:.3f} s")

        # 3. the S3 surface at realistic sizes
        gcache.clear()
        down = man.param("layers/0/mlp/down_proj").shards[0]
        client = GatewayClient(g0.url)
        ra0 = readahead.stats()
        t0 = time.perf_counter()
        h = hashlib.sha256()
        for off in range(0, down.nbytes, MIB):
            h.update(client.get_range("ckpt", down.key, off,
                                      min(MIB, down.nbytes - off)))
        wall = time.perf_counter() - t0
        ra = {k: readahead.stats()[k] - ra0[k] for k in
              ("windows_opened", "prefetch_bytes", "prefetch_hits",
               "prefetch_wasted")}
        result["ranged"] = {"bytes": down.nbytes, "gets":
                            -(-down.nbytes // MIB), "s": wall,
                            "mib_per_s": down.nbytes / MIB / wall, **ra}
        check(h.hexdigest() == down.sha256 and ra["windows_opened"] > 0,
              f"{down.key} ({down.stop[0] - down.start[0]} x "
              f"{down.stop[1] - down.start[1]}) as 1 MiB ranged GETs: "
              f"sha256-equal, readahead window opened")
        say(f"  ranged GETs on {label}: {json.dumps(result['ranged'])}")
        blob = rng.bytes(S3_MULTIPART_BYTES)
        conn = http.client.HTTPConnection("127.0.0.1", g0.port,
                                          timeout=300)
        try:
            _http(conn, "PUT", "/mpbkt")
            t0 = time.perf_counter()
            _, body = _http(conn, "POST", "/mpbkt/big.bin?uploads")
            uid = body.split(b"<UploadId>")[1].split(b"<")[0].decode()
            codes = [_http(conn, "PUT", f"/mpbkt/big.bin?partNumber="
                           f"{i + 1}&uploadId={uid}",
                           blob[i * S3_PART_BYTES:
                                (i + 1) * S3_PART_BYTES])[0]
                     for i in range(S3_MULTIPART_BYTES // S3_PART_BYTES)]
            codes.append(_http(conn, "POST",
                               f"/mpbkt/big.bin?uploadId={uid}")[0])
            put_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gcode, got = _http(conn, "GET", "/mpbkt/big.bin")
            get_s = time.perf_counter() - t0
            conn.request("PUT", "/mpbkt/copy.bin", headers={
                "x-amz-copy-source": "/mpbkt/big.bin"})
            r = conn.getresponse()
            ccode, _ = r.status, r.read()
            _, copied = _http(conn, "GET", "/mpbkt/copy.bin")
        finally:
            conn.close()
        sha = hashlib.sha256(blob).digest()
        result["multipart"] = {
            "put_mib_per_s": S3_MULTIPART_BYTES / MIB / put_s,
            "get_mib_per_s": S3_MULTIPART_BYTES / MIB / get_s}
        check(set(codes) == {200} and gcode == 200 and ccode == 200
              and hashlib.sha256(got).digest() == sha
              and hashlib.sha256(copied).digest() == sha,
              f"{S3_MULTIPART_BYTES // MIB} MiB multipart upload in "
              f"{S3_PART_BYTES // MIB} MiB parts and a CopyObject: "
              f"sha256-equal ({json.dumps(result['multipart'])})")

        def signed(method, path, body=b"", stale=False, sign=True):
            url = f"http://{g1.url}{path}"
            hdrs = sign_request_headers(method, url, {}, body, S3_AK,
                                        S3_SK) if sign else {}
            if stale:
                hdrs["x-amz-date"] = "20200101T000000Z"
            req = urllib.request.Request(url, data=body or None,
                                         method=method, headers=hdrs)
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        note = rng.bytes(MIB + 5)
        codes = [signed("PUT", "/sigbkt")[0],
                 signed("PUT", "/sigbkt/o.bin", note)[0]]
        code, back = signed("GET", "/sigbkt/o.bin")
        codes += [code, signed("PUT", "/sigbkt/u.bin", b"x",
                               sign=False)[0],
                  signed("PUT", "/sigbkt/s.bin", b"x", stale=True)[0]]
        check(codes == [200, 200, 200, 403, 403] and back == note,
              f"SigV4: signed PUT and GET 200, unsigned PUT 403, stale "
              f"date 403 ({codes})")

        # 4. a corrupted shard object fails closed
        victim = down
        raw = bytearray(client.get("ckpt", victim.key))
        raw[len(raw) // 2] ^= 0xFF
        client.put("ckpt", victim.key, bytes(raw))
        got = None
        try:
            got = CheckpointStore(g0.url).restore(
                "llama2-7b-layer0", mesh=mesh_)
            failed = ""
        except CorruptShardError as e:
            failed = str(e)
        check(got is None and "sha256" in failed,
              f"one byte flipped in {victim.key}: CorruptShardError, "
              f"nothing returned")

        # 5. the tier: a 128 MiB volume of config 1's needles
        tdir = os.path.join(workdir, "tier")
        os.makedirs(os.path.join(tdir, "orig"))
        tbase = os.path.join(tdir, "7")
        n_needles = volume_mod.write_synthetic_volume(
            tbase, TIER_VOLUME_BYTES, avg_size=MIB, seed=SEED)
        for ext in (".dat", ".idx"):
            shutil.copy(tbase + ext, os.path.join(tdir, "orig", "7" + ext))
        dat_sha = sha256_file(tbase + ".dat")
        dat_bytes = os.path.getsize(tbase + ".dat")
        check(signed("PUT", "/coldstore")[0] == 200,
              "signed PUT of the tier's bucket")
        # the tier's credentials: the sidecar keeps none, and the s3
        # backend reads them from the environment when it opens
        os.environ["SEAWEEDFS_TORCH_TIER_ACCESS_KEY"] = S3_AK
        os.environ["SEAWEEDFS_TORCH_TIER_SECRET_KEY"] = S3_SK
        tstore = store_mod.Store([tdir])
        tstore.load_existing()
        tenv = shell_commands.CommandEnv(store=tstore, out=io.StringIO(),
                                         device=dev)
        try:
            _, up_s = drive("volume.tier.upload (signed, multipart)",
                            lambda: shell_commands.run_command(
                                tenv, f"volume.tier.upload -volumeId 7 "
                                      f"-dest {g1.url}/coldstore "
                                      f"-accessKey {S3_AK} "
                                      f"-secretKey {S3_SK}"),
                            dict.fromkeys(KERNELS, False), launches)
            vol = tstore.get_volume(7)
            check(vol.backend_kind == "s3" and tstore.is_readonly(7)
                  and not os.path.exists(tbase + ".dat"),
                  f"volume.tier.upload: {n_needles} needles, {dat_bytes} "
                  f"bytes to the tier, the volume read-only on the s3 "
                  f"backend ({up_s:.3f} s)")
            orig = volume_mod.Volume(os.path.join(tdir, "orig", "7")).load()
            try:
                keys = sorted(e.key for e in orig.nm.live_entries())
                t0 = time.perf_counter()
                ok = all(vol.read_needle(k).data == orig.read_needle(k).data
                         for k in keys[::TIER_READ_EVERY])
                read_s = time.perf_counter() - t0
            finally:
                orig.close()
            check(ok, f"every {TIER_READ_EVERY}th needle read through the "
                  f"tier equal ({read_s:.3f} s)")
            try:
                shell_commands.run_command(tenv, "ec.encode -volumeId 7")
                refused = ""
            except shell_commands.ShellError as e:
                refused = str(e)
            check("tier.download" in refused and not os.path.exists(
                tbase + ".ecx"), "ec.encode of the tiered volume refused")
            _, down_s = drive("volume.tier.download",
                              lambda: shell_commands.run_command(
                                  tenv, "volume.tier.download -volumeId 7"),
                              dict.fromkeys(KERNELS, False), launches)
            check(sha256_file(tbase + ".dat") == dat_sha
                  and not tstore.is_readonly(7),
                  f"volume.tier.download: .dat sha256-equal, writable "
                  f"({down_s:.3f} s)")
            got = dict.fromkeys(KERNELS, 0)
            _, enc_s = drive("ec.encode after the download",
                             lambda: shell_commands.run_command(
                                 tenv, "ec.encode -volumeId 7"),
                             {"transpose": True, "swar": False}, got)
            launches["transpose"] += got["transpose"]
            encode.encode_volume(os.path.join(tdir, "orig", "7"),
                                 device=dev)
            local = os.path.join(tdir, "orig", "7")
            shards = range(DEFAULT_SCHEME.total_shards)
            check(got["transpose"] == 1,
                  f"ec.encode after the download: {got['transpose']} "
                  f"launch")
            check(sealed_digests(tbase, shards=shards)
                  == sealed_digests(local, shards=shards)
                  and sha256_file(tbase + ".ecx")
                  == sha256_file(local + ".ecx"),
                  "ec.encode after the download: shards and .ecx "
                  "sha256-equal to sealing the local copy")
        finally:
            os.environ.pop("SEAWEEDFS_TORCH_TIER_ACCESS_KEY", None)
            os.environ.pop("SEAWEEDFS_TORCH_TIER_SECRET_KEY", None)
            tstore.close()
        result["tier"] = {"bytes": dat_bytes, "upload_s": up_s,
                          "upload_mib_per_s": dat_bytes / MIB / up_s,
                          "download_s": down_s,
                          "download_mib_per_s": dat_bytes / MIB / down_s,
                          "read_every_4th_s": read_s, "encode_s": enc_s}
        say(f"  tier on {label}: {json.dumps(result['tier'])}")

        # 6. python -m seaweedfs_tpu_torch s3 in its own process
        t_sub = time.perf_counter()
        port = free_port_pair()
        proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "s3", "-port",
             str(port), "-filer", filer.url],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            url = f"http://127.0.0.1:{port}"
            deadline = time.time() + 60
            while True:
                try:
                    urllib.request.urlopen(url + "/", timeout=2).read()
                    break
                except urllib.error.HTTPError:
                    break
                except OSError:
                    if time.time() > deadline or proc.poll() is not None:
                        raise SmokeError("the s3 subprocess did not come "
                                         "up")
                    time.sleep(0.2)
            sub = rng.bytes(MIB + 3)
            for path, body in (("/subbkt", None), ("/subbkt/o.bin", sub)):
                req = urllib.request.Request(url + path, data=body,
                                             method="PUT")
                with urllib.request.urlopen(req, timeout=60) as r:
                    put_code = r.status
            with urllib.request.urlopen(url + "/subbkt/o.bin",
                                        timeout=60) as r:
                back = r.read()
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
        result["subprocess_s"] = time.perf_counter() - t_sub
        check(put_code == 200 and back == sub and rc == 0,
              f"python -m seaweedfs_tpu_torch s3: PUT {put_code}, GET "
              f"byte-equal, exit {rc} on SIGTERM "
              f"({result['subprocess_s']:.1f} s)")
    finally:
        if env is not None:
            env.close()
        for gw in gws:
            gw.stop()
        if filer is not None:
            filer.stop()
        for vs in servers.values():
            vs.stop()
        master.stop()
        cache_mod.configure_global()
        shutil.rmtree(workdir, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    say(f"  s3 phase: {result['seconds']:.1f} s")
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

    # (a) a warm-up, then A, B (one turn each keeps the script in its
    # time budget since the s3 phase came): each run seals the same
    # volume into a directory with no shards (the previous run's removed
    # untimed). The host allocator caches the pinned pool buffers a run
    # frees, so only the first run pays for pinning them.
    for name in ("unsplit", "unsplit", "mesh 1,1"):
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
        buffers, which the host allocator then caches), then A, B (one
        turn each since the s3 phase came), timed inside the encode's pipeline call (the layer the knob acts
        on; the command's wall beside it); the medians and B / A. B's
        runs also run ``commands``."""
        times = {a: [], b: []}
        walls = {a: [], b: []}
        for i, name in enumerate((a, b, a, b)):
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

#: (a): a seeded .idx of a volume of half a million ~30 KiB files, about
#: 10% of them deleted (one tombstone appended per deleted key); a
#: million before the trace step came.
MAP_NEEDLES = 500_000
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
    no sink), then 100 of them through ``batch.encode_packed`` with every
    parity span checked against the numpy oracle and the batch census
    taken; then 100 volumes on the SWAR kernel and 100 under the ``auto``
    link rule, both checked. (100 cover the same 8 payloads and batch
    shape as 1000, in a tenth of the script's time.)"""
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
        res, st = run(f"encode_packed ({C3_SHORT} x {vol}, checked)",
                      C3_SHORT, {"transpose": True, "swar": False}, True)
    finally:
        del enc.encode_parity_host
    res["census"] = {str(k_): v for k_, v in census.items()}
    rows_cap = batch.max_rows_per_batch(k, MIB,
                                        pipe.current().batch_bytes)
    rows = C3_SHORT * scheme.shard_file_size(C3_VOLUME_BYTES) // MIB
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
        say("phase cluster (config 1 through a port master and two port "
            "volume servers):")
        cluster_phase(dev, os.path.join(workdir, "cluster"), pres, label,
                      launches)
        say("phase jobs (ec.encode -distributed and the scrub job on two "
            "workers):")
        jres = jobs_phase(dev, os.path.join(workdir, "jobs"), pres, label,
                          launches)
        say("phase telemetry (a cold full volume sealed by the master's "
            "own policy):")
        telemetry_phase(dev, os.path.join(workdir, "telemetry"), pres,
                        label, launches)
        say("phase filer (the filer stack with its chunk cache, on a "
            "sealed volume):")
        filer_phase(dev, os.path.join(workdir, "filer"), label, launches)
        say("phase s3 (the S3 gateway, the checkpoint plane on the card's "
            "tensors, the S3 tier):")
        s3_phase(dev, os.path.join(workdir, "s3"), label, launches)
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
        sres = storage_phase(dev, os.path.join(workdir, "storage"), pres,
                             label, launches)
        for step in ("baseline", "repair"):
            say(f"  scrub {step}: the jobs phase's scrub job "
                f"{jres[f'scrub_{step}']['gibps']:.3f} GiB/s with "
                f"{json.dumps(jres[f'scrub_{step}']['launches'])} launches, "
                f"the storage phase's direct scrub_ec "
                f"{sres[f'scrub_ec_{step}']['gibps']:.3f} GiB/s with "
                f"{json.dumps(sres[f'scrub_ec_{step}']['launches'])}")
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
