"""Dataloader scans over gateway objects.

The second workload the checkpoint plane serves: a training job
streaming many data objects per epoch. :class:`ObjectLoader` scans a
key list in a SEEDED shuffle (every epoch is reproducible, and every
data-parallel worker derives its own disjoint order from the same
seed), fetching up to ``prefetch_depth`` objects ahead of the consumer
on a small thread pool — the same bounded-lookahead shape as the mount
layer's readahead, but at object granularity. ``depth=0`` degrades to
synchronous GETs, the no-readahead baseline.

The port of ``seaweedfs_tpu/ckpt/loader.py``, whole.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Iterator, Optional

from .s3client import GatewayClient


class ObjectLoader:
    """Seeded shuffled scans over one bucket's objects."""

    def __init__(self, client: GatewayClient, bucket: str,
                 keys: Optional[list[str]] = None, prefix: str = "",
                 seed: int = 0, prefetch_depth: int = 4):
        self.client = client
        self.bucket = bucket
        self._keys = list(keys) if keys is not None \
            else client.list(bucket, prefix)
        self.seed = int(seed)
        self.depth = max(0, int(prefetch_depth))
        self.stats = {"objects": 0, "bytes": 0, "wait_seconds": 0.0,
                      "epochs": 0}

    @property
    def keys(self) -> list[str]:
        return list(self._keys)

    def epoch_order(self, epoch: int) -> list[str]:
        """The (deterministic) key order for one epoch."""
        order = list(self._keys)
        random.Random(f"{self.seed}:{epoch}").shuffle(order)
        return order

    def scan(self, epoch: int = 0) -> Iterator[tuple[str, bytes]]:
        """Yield ``(key, data)`` over one epoch's shuffled order,
        keeping at most ``prefetch_depth`` fetches in flight."""
        order = self.epoch_order(epoch)
        self.stats["epochs"] += 1
        if self.depth == 0:
            for key in order:
                t0 = time.perf_counter()
                data = self.client.get(self.bucket, key)
                self.stats["wait_seconds"] += time.perf_counter() - t0
                self.stats["objects"] += 1
                self.stats["bytes"] += len(data)
                yield key, data
            return
        # bounded lookahead: a deque of in-flight fetch slots, each
        # filled by its own short-lived worker; the consumer pops the
        # head (preserving order) and tops the tail back up
        window: deque[tuple[str, threading.Thread, list]] = deque()
        it = iter(order)

        def _start(key: str):
            slot: list = [None, None]  # [data, exception]

            def _fetch():
                try:
                    slot[0] = self.client.get(self.bucket, key)
                except Exception as e:  # noqa: BLE001 — re-raised
                    slot[1] = e

            t = threading.Thread(target=_fetch, daemon=True,
                                 name="ckpt-loader")
            t.start()
            window.append((key, t, slot))

        for key in it:
            _start(key)
            if len(window) >= self.depth:
                break
        while window:
            key, t, slot = window.popleft()
            t0 = time.perf_counter()
            t.join()
            self.stats["wait_seconds"] += time.perf_counter() - t0
            nxt = next(it, None)
            if nxt is not None:
                _start(nxt)
            if slot[1] is not None:
                raise slot[1]
            self.stats["objects"] += 1
            self.stats["bytes"] += len(slot[0])
            yield key, slot[0]
