"""Repair-under-load harness: BASELINE.json config 5.

The port of ``seaweedfs_tpu/pipeline/repair_bench.py``. Streams a bulk
4-shard-loss decode (chunked reconstruct of every lost shard from k
survivors, through the GF(2^8) kernels on the card) while reader threads
issue small-interval repairs at a target QPS through the micro-batch
aggregator (repair.py): the in-process analog of 64 clients reading
needles off a degraded volume while ``ec.rebuild`` runs (store_ec.go
readEcShardIntervals + recoverOneRemoteEcShardInterval).

Shard bytes live in real temporary files: every survivor interval a
reader repairs is file I/O plus codec math, and every repaired interval
is checked against the lost shards' bytes, so the reported p99 covers
the whole read path.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np

from ..storage import ec_files
from .repair import IntervalRepairAggregator
from .scheme import DEFAULT_SCHEME, EcScheme

GIB = 1024 ** 3

#: Default lost shards: two data + two parity (worst realistic mix).
DEFAULT_LOST = (0, 5, 11, 13)


def run(duration_s: float = 8.0, qps: int = 64,
        shard_len: int = 32 * 1024 * 1024,
        interval_size: int = 4096,
        lost: Sequence[int] = DEFAULT_LOST,
        bulk_chunk: int = 4 * 1024 * 1024,
        scheme: EcScheme = DEFAULT_SCHEME,
        n_reader_threads: int = 8,
        verify: bool = True,
        workdir: Optional[str] = None,
        device=None) -> dict:
    """Run config 5 on ``device`` (None = the card); returns decode GiB/s
    and read latency percentiles.

    ``shard_len`` bytes per shard on disk; the bulk decode cycles over
    the survivors in ``bulk_chunk``-sized pieces reconstructing all
    ``lost`` shards until ``duration_s`` elapses, while reader threads
    fire ``interval_size`` repairs at ``qps`` aggregate."""
    k, total = scheme.data_shards, scheme.total_shards
    lost = tuple(lost)
    survivors = [i for i in range(total) if i not in lost]
    if len(survivors) < k:
        raise ValueError("too many lost shards")
    enc = scheme.encoder(device)
    rng = np.random.default_rng(99)

    own_dir = None
    if workdir is None:
        own_dir = tempfile.TemporaryDirectory(prefix="ec-repair-bench-")
        workdir = own_dir.name
    base = os.path.join(workdir, "1")
    files: dict = {}
    try:
        # -- fixture: k random data shards + m parity, all on disk -------
        data = rng.integers(0, 256, (k, shard_len), dtype=np.uint8)
        parity = enc.encode_parity(data).cpu().numpy()

        def shard(i: int) -> np.ndarray:
            return data[i] if i < k else parity[i - k]

        # copies, so the references pin neither array after the del
        reference = {i: shard(i).copy() for i in lost}
        for i in survivors:
            shard(i).tofile(ec_files.shard_path(base, i))
        del data, parity

        for i in survivors:
            files[i] = open(ec_files.shard_path(base, i), "rb")
        file_locks = {i: threading.Lock() for i in survivors}

        def read_interval(shard_id: int, off: int, size: int
                          ) -> np.ndarray:
            with file_locks[shard_id]:
                f = files[shard_id]
                f.seek(off)
                buf = f.read(size)
            return np.frombuffer(buf, dtype=np.uint8)

        agg = IntervalRepairAggregator(scheme, device=device)
        stop = threading.Event()
        latencies: list[float] = []
        lat_lock = threading.Lock()
        errors: list[BaseException] = []

        # -- reader side: qps small-interval repairs ---------------------
        def reader(tid: int):
            r = np.random.default_rng(1000 + tid)
            period = n_reader_threads / qps
            next_t = time.perf_counter() + r.uniform(0, period)
            while not stop.is_set():
                now = time.perf_counter()
                if now < next_t:
                    time.sleep(min(next_t - now, 0.01))
                    continue
                next_t += period
                want = lost[int(r.integers(len(lost)))]
                off = int(r.integers(0, max(1, shard_len - interval_size)))
                size = min(interval_size, shard_len - off)
                t0 = time.perf_counter()
                try:
                    rows = np.stack([read_interval(i, off, size)
                                     for i in survivors[:k]])
                    out = agg.repair(survivors[:k], rows, want)
                    dt = time.perf_counter() - t0
                    if verify and not np.array_equal(
                            out, reference[want][off:off + size]):
                        raise AssertionError(
                            f"repair mismatch shard {want} @{off}")
                    with lat_lock:
                        latencies.append(dt)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)
                    stop.set()
                    return

        threads = [threading.Thread(target=reader, args=(t,), daemon=True,
                                    name=f"ec-bench-read-{t}")
                   for t in range(n_reader_threads)]
        for t in threads:
            t.start()

        # -- bulk side: streaming chunked decode of all lost shards ------
        decoded_in = 0
        chunks = max(1, shard_len // bulk_chunk)
        ci = 0
        t_start = time.perf_counter()
        try:
            while time.perf_counter() - t_start < duration_s \
                    and not stop.is_set():
                off = (ci % chunks) * bulk_chunk
                size = min(bulk_chunk, shard_len - off)
                rows = np.stack([read_interval(i, off, size)
                                 for i in survivors[:k]])
                out = np.asarray(enc.reconstruct_batch_host(
                    rows[None], survivors[:k], list(lost)))
                if verify and ci < len(lost):
                    j = ci  # spot-check one lost shard per early chunk
                    if not np.array_equal(
                            out[0, j], reference[lost[j]][off:off + size]):
                        raise AssertionError(f"bulk decode mismatch shard "
                                             f"{lost[j]} chunk {ci}")
                decoded_in += rows.size
                ci += 1
            elapsed = time.perf_counter() - t_start
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
            agg.close()
        if errors:
            raise RuntimeError(
                f"repair-under-load failed: {errors[0]!r}") from errors[0]

        lat = np.asarray(sorted(latencies)) if latencies else \
            np.asarray([float("nan")])
        return {
            "decode_gibps": decoded_in / GIB / elapsed,
            "read_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "read_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "reads": len(latencies),
            "achieved_qps": len(latencies) / elapsed,
            "agg_batches": agg.batches,
            "agg_requests": agg.requests,
            "bulk_chunks": ci,
        }
    finally:
        for f in files.values():
            f.close()
        if own_dir is not None:
            own_dir.cleanup()
