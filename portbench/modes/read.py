"""Degraded-read cells: closed-loop clients reading whole needles of a
sealed volume with shards lost, through the port's
``pipeline/read.EcVolumeReader.read_needle`` and one shared
``pipeline/repair.IntervalRepairAggregator`` at its defaults.

Set-up writes a version-3 volume under ``TMPDIR`` through the port's
needle codec (``Needle.to_bytes``, its CRC32-C included), the superblock
and ``.idx`` entries: needles of sizes drawn once from the
configuration's ``needle_size_seed`` (the same sizes for every seed, at
most ``read_needles`` of them), in an order, with cookies and bytes,
from ``--seed``, the bytes made on the device in one call. It seals the volume with
``pipeline/encode.encode_volume`` on the device, removes the lost shards
(and the .dat and .idx), and warms up with ``warmup_reads`` reads of the
cell's own traffic. In the window each of ``clients`` threads reads a
needle drawn uniformly from those with at least one interval on a lost
shard, and again, until ``--seconds`` have passed; the read in flight
then finishes. Kept for the check: ``check_share`` of the reads, drawn
from the seed, and every read of the ``check_longest`` longest needles.
Once the window has closed each kept needle is compared, every byte,
id and cookie, with what set-up wrote. The volume is removed at exit.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

import numpy as np

from .. import reference, trace, yardstick
from ..harness import Cell, Check, Outcome

APPEND_AT_NS = 1_700_000_000_000_000_000
#: A needle record around its data: header 16, DataSize 4, flags 1,
#: CRC 4, AppendAtNs 8 (version 3), padded to 8 bytes.
RECORD_OVERHEAD = 16 + 4 + 1 + 4 + 8


def record_bytes(data_size: int) -> int:
    raw = data_size + RECORD_OVERHEAD
    return raw + (-raw) % 8


def needle_sizes(cfg: dict) -> np.ndarray:
    """The volume's needle sizes, before the seed orders them: drawn
    from ``needle_size_seed`` around ``needle_avg_bytes`` until the
    records and the 8-byte superblock reach ``volume_bytes``, or the
    first ``read_needles`` of them where the configuration cuts the read
    cells' volume."""
    avg = cfg["needle_avg_bytes"]
    rng = np.random.default_rng(cfg["needle_size_seed"])
    sizes = rng.integers(avg // 2, avg * 3 // 2,
                         cfg["volume_bytes"] // (avg // 2) + 2)
    ends = 8 + np.cumsum([record_bytes(int(s)) for s in sizes])
    sizes = sizes[:int(np.searchsorted(ends, cfg["volume_bytes"])) + 1]
    return sizes[:cfg.get("read_needles", len(sizes))]


class Volume:
    """The sealed volume set-up writes: each needle's id (1..n), cookie,
    bytes (views of one host buffer) and record offset and length."""

    def __init__(self, base: str, cfg: dict, seed: int, device):
        import torch
        from seaweedfs_tpu_torch.storage import idx, needle, superblock
        from seaweedfs_tpu_torch.storage import volume as volume_mod
        from seaweedfs_tpu_torch.storage.types import to_offset_units
        rng = np.random.default_rng(seed)
        sizes = needle_sizes(cfg)
        sizes = sizes[rng.permutation(len(sizes))]
        self.cookies = rng.integers(0, 2 ** 32, len(sizes))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        t = torch.empty(int(sizes.sum()), dtype=torch.uint8, device=device)
        t.random_(generator=gen)
        self.blob = t.cpu().numpy()
        del t
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.data = [self.blob[a:a + s] for a, s in zip(starts, sizes)]
        self.offsets, self.records = [], []
        sb = superblock.SuperBlock(version=3).to_bytes()
        off = len(sb)
        with open(volume_mod.dat_path(base), "wb") as dat, \
                open(volume_mod.idx_path(base), "wb") as ix:
            dat.write(sb)
            for i, d in enumerate(self.data):
                n = needle.Needle(cookie=int(self.cookies[i]), id=i + 1,
                                  data=d.tobytes(),
                                  append_at_ns=APPEND_AT_NS + i + 1)
                rec = n.to_bytes(3)
                dat.write(rec)
                ix.write(idx.IndexEntry(n.id, to_offset_units(off),
                                        needle.parse_header(rec)[2])
                         .to_bytes())
                self.offsets.append(off)
                self.records.append(len(rec))
                off += len(rec)
        self.dat_size = off


def run(cell: Cell) -> Outcome:
    import torch
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_native
    from seaweedfs_tpu_torch.pipeline import encode, read, repair
    from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
    from seaweedfs_tpu_torch.storage import ec_files
    from seaweedfs_tpu_torch.storage import volume as volume_mod

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    sch = cfg["scheme"]
    scheme = EcScheme(sch["data_shards"], sch["parity_shards"],
                      sch["large_block_bytes"], sch["small_block_bytes"])
    cuda = dev.type == "cuda"
    lost = set(cfg["lost_shards"])
    tmp = tempfile.mkdtemp(prefix="portbench-read-")
    agg = None
    try:
        base = os.path.join(tmp, "1")
        vol = Volume(base, cfg, cell.seed, dev)
        encode.encode_volume(base, scheme, device=dev)
        for s in lost:
            os.remove(ec_files.shard_path(base, s))
        os.remove(volume_mod.dat_path(base))
        os.remove(volume_mod.idx_path(base))
        layout = reference.Layout(scheme.data_shards,
                                  scheme.large_block_size,
                                  scheme.small_block_size, vol.dat_size)
        keys = [i + 1 for i in range(len(vol.data))
                if any(s in lost for s, _, _ in
                       layout.locate(vol.offsets[i], vol.records[i]))]
        longest = set(sorted(keys, key=lambda key: -vol.records[key - 1])
                      [:tr["check_longest"]])
        agg = repair.IntervalRepairAggregator(scheme, device=dev)
        reader = read.EcVolumeReader(base, scheme, aggregator=agg,
                                     device=dev)
        clients = tr["clients"]

        def drive(window, deadline=None, reads=None):
            """The clients, each a thread; client c keeps its reads'
            (start, end, key, needle if kept) and errors."""
            out = [dict(done=[], errors=0) for _ in range(clients)]

            def client(c):
                rng = np.random.default_rng([cell.seed, c])
                j = 0
                while True:
                    t0 = time.perf_counter()
                    if (deadline is not None and t0 >= deadline) or \
                            (reads is not None and j >= reads):
                        return
                    key = keys[int(rng.integers(len(keys)))]
                    keep = key in longest or yardstick.unit_hash(
                        cell.seed, c, j) < tr["check_share"]
                    j += 1
                    try:
                        with window.span("pb.read.read_needle"):
                            n = reader.read_needle(key)
                    except Exception:  # noqa: BLE001 — counted as failed
                        out[c]["errors"] += 1
                        continue
                    out[c]["done"].append((t0, time.perf_counter(), key,
                                           n if keep else None))

            threads = [threading.Thread(target=client, args=(c,),
                                        name=f"pb-client-{c}")
                       for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return out

        warm = trace.Window(False, cuda)
        drive(warm, reads=-(-tr["warmup_reads"] // clients))
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - cell.t0

        window = trace.Window(cell.trace, cuda)
        req0, bat0 = agg.requests, agg.batches
        launches0 = rs_cuda.apply_gf_matrix_transpose.launches + \
            rs_cuda.apply_gf_matrix_swar.launches
        native0 = rs_native.apply_gf_matrix.calls
        with cell.patch(), trace.gf_calls(cell.trace) as calls, window:
            out = drive(window, deadline=time.perf_counter() + cell.seconds)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        agg.close()
        requests, batches = agg.requests - req0, agg.batches - bat0
        agg = None
        launches = rs_cuda.apply_gf_matrix_transpose.launches + \
            rs_cuda.apply_gf_matrix_swar.launches - launches0
        native = rs_native.apply_gf_matrix.calls - native0
    finally:
        if agg is not None:
            agg.close()
        shutil.rmtree(tmp, ignore_errors=True)

    done = [d for o in out for d in o["done"]]
    errors = sum(o["errors"] for o in out)
    wrong = checked = 0
    for _, _, key, n in done:
        if n is None:
            continue
        checked += 1
        want = vol.data[key - 1]
        got = np.frombuffer(n.data, dtype=np.uint8)
        if n.id != key or n.cookie != int(vol.cookies[key - 1]) or \
                got.size != want.size or not np.array_equal(got, want):
            wrong += 1
    first = min(d[0] for d in done) if done else 0.0
    last = max(d[1] for d in done) if done else 0.0
    checks = [Check("reads_wrong", errors + wrong, max=0),
              Check("reads_checked", checked, min=1)]
    info = {"reads": len(done), "errors": errors, "reads_checked": checked,
            "eligible_needles": len(keys), "launches": launches,
            "host_codec_calls": native, "repair_requests": requests,
            "repair_batches": batches}
    return Outcome(
        setup_s=setup_s, attempted=len(done) + errors,
        failed=errors + wrong, checks=checks,
        readings={"read_bytes": sum(vol.records[d[2] - 1] for d in done),
                  "read_seconds": last - first,
                  "latencies_s": [d[1] - d[0] for d in done],
                  "repair_requests": requests, "repair_batches": batches,
                  "launches": launches, "host_codec_calls": native,
                  "gf_bytes": sum(yardstick.gf_call_bytes(*c)
                                  for c in calls),
                  "device_name": torch.cuda.get_device_name(dev)
                  if cuda else "cpu"},
        window=window, memory_peak_bytes=peak, info=info)
