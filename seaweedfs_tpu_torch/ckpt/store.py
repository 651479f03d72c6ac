"""Sharded torch-tensor checkpoint store over the S3 gateway.

Save (multi-process safe):

1. every process writes one object per (param, block) for the blocks it
   OWNS (``replica_id == 0`` — exactly one writer per global block no
   matter how the tensor is replicated), named by the block's global
   start indices so no coordination is needed to agree on keys;
2. every process writes its part-manifest to
   ``{root}/_parts/{rank}.json``;
3. rank 0 waits for all parts, merges them, orders each param's shard
   table canonically and assigns packed byte ranges
   (``Manifest.finalize``), and writes ``{root}/manifest.json`` — the
   COMMIT POINT; the other processes poll for it as the save barrier.

Rank and world size come from ``torch.distributed`` when a process
group is initialised, else 0 and 1; the store never starts a group.

Restore: read the manifest, lay each param's blocks out over the live
mesh with a :class:`~.sharding.NamedSharding` of the stored spec, and
read each distinct block once — a RANGED read of the covering shard
object(s) (an axis-0 slice of a saved shard is contiguous in its
C-order bytes, so restoring onto more cells than saved sub-range-reads
instead of over-reading; only axis-0 resharding is supported). Block
bytes are assembled in a :class:`~..pipeline.pipe.HostBufferPool` slab
(pinned when the mesh is on the card) and copied to every device that
holds the block; the slab goes back to the pool only after those copies
have landed. Every whole-shard read is sha256-verified against the
manifest, and a mismatch fails closed with :class:`CorruptShardError` —
a checkpoint never half-loads.

The port of ``seaweedfs_tpu/ckpt/store.py`` on torch tensors: a leaf is
a :class:`~.sharding.ShardedTensor` (the counterpart of a ``jax.Array``
with a ``NamedSharding``) or a plain tensor or array, which counts as
replicated. Tree paths name params as the JAX package's do (dict keys in
sorted order, list and tuple indices, joined by ``/``), so either
package restores the other's checkpoints. A save runs under a
``ckpt.save`` trace span, and a restore's reads and copies under
``ckpt.restore``.
"""

from __future__ import annotations

import hashlib
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from ..util import faults, glog, tracing
from .manifest import (Manifest, ManifestError, ParamSpec, ShardEntry,
                       spec_from_json, spec_to_json)
from .s3client import GatewayClient
from .sharding import (Block, NamedSharding, ShardedTensor, dtype_name,
                       local_mesh, tensor_bytes, torch_dtype)


class CheckpointError(Exception):
    """Save/restore failed in a way retrying won't fix."""


class CorruptShardError(CheckpointError):
    """A shard object's bytes do not hash to the manifest's sha256."""


def _path_name(path: tuple) -> str:
    """tree path -> stable object-key-safe param name."""
    return "/".join(str(p) for p in path) or "_root"


def _flatten(tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in the JAX package's order: dict keys sorted,
    list and tuple items in order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (i,))
        return out
    return [(path, tree)]


def _unflatten(template, leaves: dict, path: tuple = ()):
    """``template``'s structure with each leaf replaced by the restored
    param of the same name."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, path + (i,))
                              for i, v in enumerate(template))
    pname = _path_name(path)
    if pname not in leaves:
        raise ManifestError(f"template leaf {pname!r} not in checkpoint")
    return leaves[pname]


def _process() -> tuple[int, int]:
    """(rank, world size) of this process in the save."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointStore:
    """Checkpoints under ``{bucket}/{prefix}/{name}/`` on one gateway."""

    MANIFEST = "manifest.json"

    def __init__(self, gateway_url: str, bucket: str = "ckpt",
                 prefix: str = "checkpoints",
                 client: Optional[GatewayClient] = None,
                 barrier_timeout: float = 120.0):
        self.client = client or GatewayClient(gateway_url)
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.barrier_timeout = float(barrier_timeout)

    def _root(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    # ------------- save -------------

    def save(self, name: str, tree: Any) -> Manifest:
        """Write one checkpoint; every participating process calls this
        with its own view of ``tree``. Returns the merged manifest (rank
        0 builds it; the others re-read the committed one)."""
        with tracing.span("ckpt.save"):
            return self._save(name, tree)

    def _save(self, name: str, tree: Any) -> Manifest:
        pid, nproc = _process()
        root = self._root(name)
        self.client.ensure_bucket(self.bucket)
        if pid == 0:
            # Overwriting a committed checkpoint under the same name:
            # clear stale parts FIRST, then the manifest — its absence
            # is the "cleanup done" signal the other processes wait on,
            # so no process writes a fresh part that cleanup could
            # swallow, and the old manifest can never double as OUR
            # commit point.
            for i in range(nproc):
                self.client.delete(self.bucket, f"{root}/_parts/{i}.json")
            self.client.delete(self.bucket, f"{root}/{self.MANIFEST}")
        else:
            self._await_absent(f"{root}/{self.MANIFEST}")
        leaves = _flatten(tree)
        if not leaves:
            raise CheckpointError("empty pytree")
        part = Manifest({})
        for path, leaf in leaves:
            part.params.append(self._save_leaf(root, _path_name(path),
                                               leaf, part, pid))
        self.client.put(self.bucket, f"{root}/_parts/{pid}.json",
                        part.to_json(), "application/json")
        if pid == 0:
            man = self._merge_parts(root, nproc)
            man.finalize()
            man.validate()
            # the manifest PUT is the checkpoint's rename-style commit
            # point: a crash on either side leaves a fully readable
            # prior state (no manifest = no checkpoint)
            faults.check("crash.ckpt.save")
            self.client.put(self.bucket, f"{root}/{self.MANIFEST}",
                            man.to_json(), "application/json")
            glog.info("ckpt: committed %s (%d params, %d procs)",
                      root, len(man.params), nproc)
            return man
        return self._await_manifest(root)

    def _save_leaf(self, root: str, pname: str, leaf, part: Manifest,
                   pid: int) -> ParamSpec:
        if isinstance(leaf, ShardedTensor):
            if not part.mesh_axes:
                part.mesh_axes.update(leaf.sharding.mesh_axes)
            p = ParamSpec(pname, dtype_name(leaf.dtype), leaf.shape,
                          spec_to_json(leaf.spec))
            for b in leaf.blocks:
                if b.replica_id != 0:
                    continue  # exactly one writer per global block
                p.shards.append(self._put_block(
                    root, pname, tensor_bytes(b.data), b.start, b.stop))
            return p
        # a plain tensor or array is "replicated": only rank 0 writes it
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(np.asarray(leaf))
        p = ParamSpec(pname, dtype_name(t.dtype), tuple(t.shape),
                      [None] * t.dim())
        if pid == 0:
            p.shards.append(self._put_block(
                root, pname, tensor_bytes(t), (0,) * t.dim(),
                tuple(t.shape)))
        return p

    def _put_block(self, root: str, pname: str, data: bytes,
                   start: tuple, stop: tuple) -> ShardEntry:
        key = f"{root}/{pname}/shard-" + "_".join(str(i) for i in start)
        self.client.put(self.bucket, key, data)
        return ShardEntry(key, start, stop, len(data),
                          hashlib.sha256(data).hexdigest())

    def _merge_parts(self, root: str, nproc: int) -> Manifest:
        parts: dict[int, Manifest] = {}
        deadline = time.monotonic() + self.barrier_timeout
        while len(parts) < nproc:
            for i in range(nproc):
                if i in parts:
                    continue
                raw = self._get_if_exists(f"{root}/_parts/{i}.json")
                if raw is not None:
                    parts[i] = Manifest.from_json(raw)
            if len(parts) < nproc:
                if time.monotonic() > deadline:
                    raise CheckpointError(
                        f"save barrier: {len(parts)}/{nproc} part "
                        f"manifests after {self.barrier_timeout}s")
                time.sleep(0.05)
        merged = Manifest({})
        for i in sorted(parts):
            for p in parts[i].params:
                merged.mesh_axes.update(parts[i].mesh_axes)
                try:
                    mine = merged.param(p.name)
                except ManifestError:
                    merged.params.append(p)
                    continue
                seen = {s.start for s in mine.shards}
                mine.shards.extend(s for s in p.shards
                                   if s.start not in seen)
        return merged

    def _get_if_exists(self, key: str) -> Optional[bytes]:
        import urllib.error
        try:
            return self.client.get(self.bucket, key)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def _await_absent(self, key: str) -> None:
        deadline = time.monotonic() + self.barrier_timeout
        while self.client.head(self.bucket, key) is not None:
            if time.monotonic() > deadline:
                raise CheckpointError(
                    f"save barrier: stale {key} never cleared "
                    f"(process 0 missing?)")
            time.sleep(0.05)

    def _await_manifest(self, root: str) -> Manifest:
        deadline = time.monotonic() + self.barrier_timeout
        while True:
            raw = self._get_if_exists(f"{root}/{self.MANIFEST}")
            if raw is not None:
                return Manifest.from_json(raw)
            if time.monotonic() > deadline:
                raise CheckpointError(
                    f"save barrier: no {self.MANIFEST} under {root} "
                    f"after {self.barrier_timeout}s")
            time.sleep(0.05)

    # ------------- restore -------------

    def read_manifest(self, name: str) -> Manifest:
        raw = self._get_if_exists(f"{self._root(name)}/{self.MANIFEST}")
        if raw is None:
            raise ManifestError(
                f"no {self.MANIFEST} under {self._root(name)} — "
                f"checkpoint absent or its save never committed")
        man = Manifest.from_json(raw)
        man.validate()
        return man

    def restore(self, name: str, mesh=None, template: Any = None,
                pool=None, device=None) -> Any:
        """Load one checkpoint onto ``mesh`` (default: the configured
        mesh over the local devices of ``device``'s type, None = the
        card). Returns a tree shaped like ``template`` when given
        (leaves matched by tree-path name), else a flat
        ``{param_name: ShardedTensor}`` dict."""
        man = self.read_manifest(name)
        if mesh is None:
            mesh = local_mesh(device)
        shardings = [NamedSharding(mesh, spec_from_json(p.spec))
                     for p in man.params]
        if pool is None:
            pool = self._make_pool(man, shardings, mesh)
        with tracing.span("ckpt.restore"):
            arrays = {p.name: self._restore_param(p, sh, pool)
                      for p, sh in zip(man.params, shardings)}
        if template is None:
            return arrays
        return _unflatten(template, arrays)

    def _make_pool(self, man: Manifest, shardings: list, mesh):
        """Two staging slabs as large as the largest block this mesh
        needs, pinned when the mesh is on the card."""
        from ..pipeline.pipe import HostBufferPool

        biggest = 1
        for p, sh in zip(man.params, shardings):
            item = torch_dtype(p.dtype).itemsize
            for cell, _dev in sh.cells():
                start, stop = sh.index(cell, p.shape)
                biggest = max(biggest, item * math.prod(
                    hi - lo for lo, hi in zip(start, stop)))
        return HostBufferPool(max(4096, biggest), 2,
                              pinned=mesh.device_type == "cuda")

    def _restore_param(self, p: ParamSpec, sharding: NamedSharding,
                       pool) -> ShardedTensor:
        shape = tuple(p.shape)
        dtype = torch_dtype(p.dtype)
        cells: dict[tuple, list] = {}
        for cell, dev in sharding.cells():
            cells.setdefault(sharding.index(cell, shape), []).append(
                (cell, dev))
        blocks = []
        for (start, stop), holders in cells.items():
            placed = self._place_block(p, start, stop, dtype, pool,
                                       {dev for _, dev in holders})
            blocks += [Block(placed[dev], start, stop,
                             sharding.replica_id(cell), cell)
                       for cell, dev in holders]
        order = {cell: i for i, (cell, _) in enumerate(sharding.cells())}
        blocks.sort(key=lambda b: order[b.cell])
        return ShardedTensor(shape, dtype, sharding, blocks)

    def _place_block(self, p: ParamSpec, start: tuple, stop: tuple,
                     dtype: torch.dtype, pool, devices: set) -> dict:
        """One block read into a staging slab and copied to each of
        ``devices``; the slab is released only after every copy from it
        has landed."""
        bshape = tuple(hi - lo for lo, hi in zip(start, stop))
        nbytes = dtype.itemsize * math.prod(bshape)
        buf = pool.acquire(timeout=30.0)
        events = []
        try:
            view = buf[:nbytes]
            self._read_block(p, start, stop, view)
            host = torch.from_numpy(view).view(dtype).reshape(bshape)
            placed = {}
            for dev in devices:
                if dev.type == "cuda":
                    t = torch.empty(bshape, dtype=dtype, device=dev)
                    t.copy_(host, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(dev))
                    events.append(ev)
                else:
                    t = host.clone()
                placed[dev] = t
            return placed
        finally:
            for ev in events:
                ev.synchronize()
            pool.release(buf)

    def _read_block(self, p: ParamSpec, start: tuple, stop: tuple,
                    out: np.ndarray) -> None:
        """Fill ``out`` (uint8, the block's C-order bytes) from the
        covering saved shard(s) with ranged reads of exactly the bytes
        needed."""
        shape = tuple(hi - lo for lo, hi in zip(start, stop))
        itemsize = torch_dtype(p.dtype).itemsize
        row = itemsize * math.prod(shape[1:])
        filled = 0
        for s in sorted(p.shards, key=lambda s: s.start):
            if s.start[1:] != start[1:] or s.stop[1:] != stop[1:]:
                if self._intersects(s, start, stop):
                    raise ManifestError(
                        f"{p.name!r}: restore block {start}..{stop} "
                        f"cuts shard {s.key} on a non-leading axis — "
                        f"only axis-0 resharding is supported")
                continue
            lo = max(start[0] if start else 0,
                     s.start[0] if s.start else 0)
            hi = min(stop[0] if stop else 1, s.stop[0] if s.stop else 1)
            if lo >= hi:
                continue
            off = (lo - (s.start[0] if s.start else 0)) * row
            nbytes = (hi - lo) * row
            raw = self._fetch_verified(p, s, off, nbytes)
            pos = (lo - (start[0] if start else 0)) * row
            out[pos:pos + nbytes] = np.frombuffer(raw, np.uint8)
            filled += nbytes
        if filled != out.nbytes:
            raise ManifestError(
                f"{p.name!r}: shards cover {filled} of {out.nbytes} "
                f"bytes for block {start}..{stop}")

    @staticmethod
    def _intersects(s: ShardEntry, start: tuple, stop: tuple) -> bool:
        return all(lo < shi and slo < hi for lo, hi, slo, shi in
                   zip(start, stop, s.start, s.stop))

    def _fetch_verified(self, p: ParamSpec, s: ShardEntry, off: int,
                        nbytes: int) -> bytes:
        """Ranged read of ``[off, off+nbytes)`` from one shard object;
        whole-shard reads verify the manifest sha256 and fail closed on
        mismatch."""
        data = self.client.get_range(self.bucket, s.key, off, nbytes)
        if len(data) != nbytes:
            raise CorruptShardError(
                f"{p.name!r}: shard {s.key} range [{off}, "
                f"{off + nbytes}) returned {len(data)} bytes")
        if off == 0 and nbytes == s.nbytes:
            digest = hashlib.sha256(data).hexdigest()
            if digest != s.sha256:
                raise CorruptShardError(
                    f"{p.name!r}: shard {s.key} sha256 {digest} "
                    f"!= manifest {s.sha256} — refusing to load")
        return data

    # ------------- listing -------------

    def list_checkpoints(self) -> list[dict]:
        """[{name, params, shards, bytes}] for every COMMITTED
        checkpoint under the prefix (uncommitted saves are invisible,
        matching restore's view)."""
        out = []
        pfx = f"{self.prefix}/" if self.prefix else ""
        for key in self.client.list(self.bucket, pfx):
            if not key.endswith(f"/{self.MANIFEST}"):
                continue
            name = key[len(pfx):-len(self.MANIFEST) - 1]
            try:
                man = Manifest.from_json(self.client.get(self.bucket, key))
            except ManifestError as e:
                glog.v(1, f"ckpt.list: skipping malformed manifest "
                          f"{key}: {e}")
                continue
            out.append({
                "name": name,
                "params": len(man.params),
                "shards": sum(len(p.shards) for p in man.params),
                "bytes": sum(s.nbytes for p in man.params
                             for s in p.shards)})
        return sorted(out, key=lambda d: d["name"])
