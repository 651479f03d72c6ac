"""Interval micro-batch aggregator: many small repairs, one codec call.

The port of ``seaweedfs_tpu/pipeline/repair.py``. Under repair-under-load
(BASELINE config 5) dozens of concurrent needle reads each need a small
interval of a lost shard reconstructed while a bulk decode streams on
the same card. The aggregator queues requests briefly (``max_wait_s``),
groups them by (survivor set, wanted shard), zero-pads each group to a
common interval length (padding is transparent because the codec is
position-wise), reconstructs the whole group in ONE batched codec call
and fans the results back out to the waiting readers. The call goes
through ``scheme.encoder(device).reconstruct_batch_host``, so the
small-payload rule (``rs_torch.DEVICE_MIN_S``) decides on the padded
length whether the group runs on the host codec or the card.

Reference analog: store_ec.go recoverOneRemoteEcShardInterval issues one
``Reconstruct`` per interval per read.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .scheme import DEFAULT_SCHEME, EcScheme


@dataclass
class _Request:
    present: tuple[int, ...]
    wanted: int
    rows: np.ndarray            # (k, size) survivor interval bytes
    size: int
    future: Future = field(default_factory=Future)


class IntervalRepairAggregator:
    """Thread-safe micro-batching front end for interval reconstructs.

    ``repair`` blocks the calling reader thread until its interval is
    rebuilt; internally a single worker drains the queue in batches.
    """

    def __init__(self, scheme: EcScheme = DEFAULT_SCHEME,
                 max_batch: int = 128, max_wait_s: float = 0.002,
                 device=None):
        self.scheme = scheme
        self.encoder = scheme.encoder(device)   # raises without a card
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run,
                                        name="ec-repair-agg",
                                        daemon=True)
        self.batches = 0       # observability
        self.requests = 0
        self._worker.start()

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)
        # Fail fast anything that raced the shutdown: a request left in
        # the queue would otherwise stall its caller for the full
        # repair() timeout.
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, _Request) and not item.future.done():
                    item.future.set_exception(
                        RuntimeError("aggregator closed"))
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- caller side ------------------------------------------------------

    def repair(self, present: Sequence[int], rows: np.ndarray,
               wanted: int, timeout: Optional[float] = 60.0
               ) -> np.ndarray:
        """Rebuild shard ``wanted``'s interval from survivor ``rows``
        ((k, size) uint8, ordered to match ``present``); blocks until
        the batched codec call delivers."""
        if self._stop.is_set():
            raise RuntimeError("aggregator closed")
        rows = np.asarray(rows, dtype=np.uint8)
        req = _Request(tuple(present)[:self.scheme.data_shards], wanted,
                       rows, rows.shape[-1])
        self._q.put(req)
        return req.future.result(timeout=timeout)

    # -- worker side ------------------------------------------------------

    def _drain(self, first: _Request) -> list[_Request]:
        batch = [first]
        t_end = _now() + max(0.0, self.max_wait_s)
        while len(batch) < self.max_batch:
            remaining = t_end - _now()
            try:
                item = self._q.get(timeout=remaining) \
                    if remaining > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-post the stop sentinel
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                return
            batch = self._drain(item)
            # the counters change only on this one worker thread
            # seaweedlint: disable=SW802 — single agg thread
            self.requests += len(batch)
            groups: dict[tuple, list[_Request]] = {}
            for r in batch:
                groups.setdefault((r.present, r.wanted), []).append(r)
            for (present, wanted), reqs in groups.items():
                # seaweedlint: disable=SW802 — single agg thread
                self.batches += 1
                try:
                    smax = max(r.size for r in reqs)
                    arr = np.zeros(
                        (len(reqs), self.scheme.data_shards, smax),
                        dtype=np.uint8)
                    for i, r in enumerate(reqs):
                        arr[i, :, :r.size] = r.rows[
                            :self.scheme.data_shards]
                    out = np.asarray(self.encoder.reconstruct_batch_host(
                        arr, list(present), [wanted]))
                    for i, r in enumerate(reqs):
                        r.future.set_result(out[i, 0, :r.size].copy())
                except Exception as e:  # noqa: BLE001 — to every waiter
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)


_now = time.perf_counter
