"""Checkpoint manifest: the metadata that makes shard objects a model.

A checkpoint is laid out as one object per (param, shard) plus ONE
``manifest.json`` (docs/workloads.md "Checkpoint layout"):

``{root}/{param}/shard-{i0}_{i1}...``
    the C-order bytes of that shard's block of the global array
    (``i0``, ``i1``, ... are the block's global start indices — a
    deterministic name every writing process computes independently)
``{root}/manifest.json``
    format tag, the mesh axis sizes it was saved under, and one
    :class:`ParamSpec` per leaf: dtype, global shape, the
    ``PartitionSpec`` as JSON, and per-shard entries (global start/stop
    indices, nbytes, sha256, and the byte range the shard occupies in
    the param's packed C-order stream).

The manifest is the COMMIT POINT: a save that dies before writing it
leaves garbage shard objects but no restorable checkpoint, and restore
never has to guess whether a save finished. sha256 is per shard object
so restore verifies exactly what it reads (full-shard reads; sub-range
reads are covered by the surrounding object's hash only when the whole
object is eventually consumed — see store.py).

The port of ``seaweedfs_tpu/ckpt/manifest.py``. Specs parse into the
port's own :class:`~.sharding.PartitionSpec`; the JSON is the same, so
either package reads a manifest the other wrote.
"""

from __future__ import annotations

import json
from typing import Optional

from .sharding import PartitionSpec

FORMAT = "seaweed-ckpt/1"


class ManifestError(Exception):
    """Manifest missing, malformed, or incompatible with the request."""


def spec_to_json(spec) -> list:
    """``PartitionSpec`` -> JSON: one entry per dim, each None, an axis
    name, or a list of axis names (a tuple-sharded dim)."""
    out: list = []
    for part in tuple(spec):
        if part is None:
            out.append(None)
        elif isinstance(part, (tuple, list)):
            out.append([str(a) for a in part])
        else:
            out.append(str(part))
    return out


def spec_from_json(obj) -> PartitionSpec:
    parts = []
    for part in obj:
        if part is None:
            parts.append(None)
        elif isinstance(part, list):
            parts.append(tuple(part))
        else:
            parts.append(str(part))
    return PartitionSpec(*parts)


class ShardEntry:
    """One saved shard object of one param."""

    __slots__ = ("key", "start", "stop", "nbytes", "sha256",
                 "byte_start", "byte_stop")

    def __init__(self, key: str, start: tuple, stop: tuple,
                 nbytes: int, sha256: str,
                 byte_start: int = 0, byte_stop: int = 0):
        self.key = key
        self.start = tuple(int(x) for x in start)
        self.stop = tuple(int(x) for x in stop)
        self.nbytes = int(nbytes)
        self.sha256 = sha256
        self.byte_start = int(byte_start)
        self.byte_stop = int(byte_stop)

    def to_json(self) -> dict:
        return {"key": self.key, "start": list(self.start),
                "stop": list(self.stop), "nbytes": self.nbytes,
                "sha256": self.sha256, "byte_start": self.byte_start,
                "byte_stop": self.byte_stop}

    @classmethod
    def from_json(cls, d: dict) -> "ShardEntry":
        try:
            return cls(d["key"], d["start"], d["stop"], d["nbytes"],
                       d["sha256"], d.get("byte_start", 0),
                       d.get("byte_stop", 0))
        except (KeyError, TypeError) as e:
            raise ManifestError(f"bad shard entry: {e}") from e


class ParamSpec:
    """One pytree leaf: global geometry + its shard table."""

    __slots__ = ("name", "dtype", "shape", "spec", "shards")

    def __init__(self, name: str, dtype: str, shape: tuple,
                 spec: list, shards: Optional[list] = None):
        self.name = name
        self.dtype = str(dtype)
        self.shape = tuple(int(x) for x in shape)
        self.spec = list(spec)
        self.shards: list[ShardEntry] = list(shards or [])

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype,
                "shape": list(self.shape), "spec": self.spec,
                "shards": [s.to_json() for s in self.shards]}

    @classmethod
    def from_json(cls, d: dict) -> "ParamSpec":
        try:
            return cls(d["name"], d["dtype"], d["shape"], d["spec"],
                       [ShardEntry.from_json(s) for s in d["shards"]])
        except (KeyError, TypeError) as e:
            raise ManifestError(f"bad param spec: {e}") from e


def _itemsize(dtype: str, name: str) -> int:
    from .sharding import torch_dtype
    try:
        return torch_dtype(dtype).itemsize
    except ValueError as e:
        raise ManifestError(f"param {name!r}: {e}") from None


class Manifest:
    """The whole checkpoint's metadata (what ``manifest.json`` holds)."""

    __slots__ = ("mesh_axes", "params")

    def __init__(self, mesh_axes: dict,
                 params: Optional[list] = None):
        self.mesh_axes = {str(k): int(v)
                          for k, v in (mesh_axes or {}).items()}
        self.params: list[ParamSpec] = list(params or [])

    def param(self, name: str) -> ParamSpec:
        for p in self.params:
            if p.name == name:
                return p
        raise ManifestError(f"param {name!r} not in manifest")

    def finalize(self) -> None:
        """Order each param's shards canonically (by global start
        index) and assign packed-stream byte ranges — the merge step
        process 0 runs before committing the manifest."""
        for p in self.params:
            p.shards.sort(key=lambda s: s.start)
            pos = 0
            for s in p.shards:
                s.byte_start = pos
                s.byte_stop = pos + s.nbytes
                pos = s.byte_stop

    def validate(self) -> None:
        for p in self.params:
            if not p.shards:
                raise ManifestError(f"param {p.name!r} has no shards")
            itemsize = _itemsize(p.dtype, p.name)
            for s in p.shards:
                if len(s.start) != len(p.shape) or \
                        len(s.stop) != len(p.shape):
                    raise ManifestError(
                        f"{p.name!r}: shard rank mismatch")
                n = itemsize
                for lo, hi, dim in zip(s.start, s.stop, p.shape):
                    if not 0 <= lo < hi <= dim:
                        raise ManifestError(
                            f"{p.name!r}: shard {s.key} out of bounds")
                    n *= hi - lo
                if n != s.nbytes:
                    raise ManifestError(
                        f"{p.name!r}: shard {s.key} nbytes {s.nbytes} "
                        f"!= block size {n}")

    def to_json(self) -> bytes:
        return json.dumps(
            {"format": FORMAT, "mesh_axes": self.mesh_axes,
             "params": [p.to_json() for p in self.params]},
            indent=1, sort_keys=True).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Manifest":
        try:
            d = json.loads(raw)
        except ValueError as e:
            raise ManifestError(f"manifest is not JSON: {e}") from e
        if d.get("format") != FORMAT:
            raise ManifestError(
                f"unsupported manifest format {d.get('format')!r} "
                f"(want {FORMAT})")
        try:
            return cls(d.get("mesh_axes", {}),
                       [ParamSpec.from_json(p) for p in d["params"]])
        except (KeyError, TypeError) as e:
            raise ManifestError(f"bad manifest: {e}") from e
