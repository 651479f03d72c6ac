"""EC read path: serve a needle straight from shard files, repairing
missing intervals on the fly.

The port of ``seaweedfs_tpu/pipeline/read.py`` (store_ec.go): look the
needle up in the .ecx, map it to shard intervals (ec_locate), read each
interval from its shard file, and when a shard cannot serve one, gather
the same byte range from k surviving shards and reconstruct just that
interval (recoverOneRemoteEcShardInterval). The codec is
``scheme.encoder(device)``: an interval shorter than
``rs_torch.DEVICE_MIN_S`` is rebuilt by the native host codec, a longer
one by the GF(2^8) kernels on the card. This is the repair-under-load
primitive BASELINE config 5 exercises.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops import rs_torch
from ..ops.rs_ref import TooFewShardsError
from ..storage import ec_files, idx as idx_mod, needle as needle_mod
from ..util import faults, retry
from .decode import find_dat_file_size
from .scheme import DEFAULT_SCHEME, EcScheme


class EcReadError(RuntimeError):
    pass


class EcVolumeReader:
    """Read needles of one sealed volume from its local shard files.

    "Shard missing" means the file is absent (the in-process analog of a
    dead shard server). One reader may serve several threads.
    ``device`` (None = the card; raises without one) runs the
    reconstructions; ``aggregator``, an optional
    ``repair.IntervalRepairAggregator``, lets concurrent readers share
    batched codec calls instead of one reconstruct each (config 5).
    """

    def __init__(self, base: str | Path, scheme: EcScheme = DEFAULT_SCHEME,
                 version: Optional[int] = None, aggregator=None,
                 device=None):
        self.base = Path(base)
        self.scheme = scheme
        self.device = rs_torch.resolve_device(device)
        self.aggregator = aggregator
        ecxp = ec_files.ecx_path(base)
        if not ecxp.exists():
            raise EcReadError(f"{ecxp} does not exist")
        self._ecx_blob = ecxp.read_bytes()
        self._deleted = ec_files.ecj_deleted_set(base)
        vi = ec_files.VolumeInfo.load(base)
        # needle version: explicit argument > .vif record > the default
        self.version = version if version is not None else (vi.version or 3)
        self._dat_size = vi.dat_file_size or find_dat_file_size(
            base, self.version)
        #: on-the-fly repairs; readers on several threads share it
        self.intervals_repaired = 0
        self._count_lock = threading.Lock()

    # -- shard io ---------------------------------------------------------

    def _read_shard_range(self, shard_id: int, offset: int, size: int
                          ) -> Optional[np.ndarray]:
        """One interval from one shard file; ``None`` means this shard
        cannot serve it: absent file, injected fault, or a short read
        (shard mid-copy or truncated). A damaged shard degrades into the
        reconstruction path instead of failing the whole needle read."""
        try:
            faults.check("ec.shard_read")
        except faults.FaultError:
            return None
        p = ec_files.shard_path(self.base, shard_id)
        if not p.exists():
            return None
        with open(p, "rb") as f:
            f.seek(offset)
            buf = f.read(size)
        buf = faults.mangle("ec.shard_read", buf)
        if len(buf) != size:
            return None
        return np.frombuffer(buf, dtype=np.uint8)

    def _recover_interval(self, shard_id: int, offset: int, size: int
                          ) -> np.ndarray:
        """Rebuild one interval of one shard from the other shards (the
        reconstruct-on-read path)."""
        present, rows = [], []
        for i in range(self.scheme.total_shards):
            if i == shard_id:
                continue
            row = self._read_shard_range(i, offset, size)
            if row is not None:
                present.append(i)
                rows.append(row)
            if len(present) == self.scheme.data_shards:
                break
        if len(present) < self.scheme.data_shards:
            raise TooFewShardsError(
                f"interval repair needs {self.scheme.data_shards} live "
                f"shards, found {len(present)}")
        if self.aggregator is not None:
            out = self.aggregator.repair(present, np.stack(rows), shard_id)
        else:
            enc = self.scheme.encoder(self.device)
            out = np.asarray(enc.reconstruct_batch_host(
                np.stack(rows)[None], present, [shard_id]))[0, 0]
        with self._count_lock:
            self.intervals_repaired += 1
        retry.record_degraded("ec_reconstruct")
        return out

    # -- needle reads -----------------------------------------------------

    def lookup(self, key: int) -> idx_mod.IndexEntry:
        e = idx_mod.search_ecx_blob(self._ecx_blob, key)
        if e is None or e.is_deleted or key in self._deleted:
            raise KeyError(f"needle {key} not found")
        return e

    def read_record(self, key: int) -> bytes:
        """Raw on-disk needle record bytes, assembled from intervals."""
        e = self.lookup(key)
        rec_size = needle_mod.record_size(e.size, self.version)
        parts = []
        for iv in self.scheme.locate(e.byte_offset, rec_size,
                                     self._dat_size):
            buf = self._read_shard_range(iv.shard_id,
                                         iv.inner_block_offset, iv.size)
            if buf is None:
                buf = self._recover_interval(iv.shard_id,
                                             iv.inner_block_offset,
                                             iv.size)
            parts.append(buf)
        return np.concatenate(parts).tobytes()

    def read_needle(self, key: int, cookie: Optional[int] = None
                    ) -> needle_mod.Needle:
        n = needle_mod.Needle.parse(self.read_record(key), self.version)
        if n.id != key:
            raise EcReadError(f"ecx/offset mismatch: wanted {key}, "
                              f"found {n.id}")
        if cookie is not None and n.cookie != cookie:
            raise EcReadError("cookie mismatch")
        return n

    def delete_needle(self, key: int) -> None:
        """Post-seal delete: journal to .ecj (store_ec_delete.go)."""
        self.lookup(key)
        ec_files.ecj_append(self.base, key)
        self._deleted.add(key)
