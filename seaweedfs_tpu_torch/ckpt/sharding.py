"""Torch tensors laid out over a (dp, sp) mesh: the port's counterpart of
``jax.sharding.PartitionSpec``, ``NamedSharding`` and a sharded
``jax.Array``, as much of them as the checkpoint plane needs.

A :class:`PartitionSpec` names, for each dimension of a global shape,
``None`` (not split), one mesh axis (``"dp"`` or ``"sp"``), or a tuple of
axes (the dimension is split over their product, the first axis
outermost). A :class:`NamedSharding` pairs it with a
``parallel/mesh.Mesh``; for every cell ``(i, j)`` of the grid it gives
the cell's block of the global array (:meth:`NamedSharding.index`) and
its replica id, counted over the axes the spec does not use, so each
distinct block has exactly one replica 0 — the same blocks and replica
ids JAX gives the devices of a mesh of the same shape. A
:class:`ShardedTensor` holds one :class:`Block` per cell: a torch tensor
on the cell's device with its global ``(start, stop)``. Cells on one
device that hold the same block share one tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh as mesh_mod

#: The mesh's axes, outermost first (``Mesh.shape``'s order).
AXES = ("dp", "sp")


class PartitionSpec(tuple):
    """One entry per dimension: None, an axis name or a tuple of axis
    names. Compares and prints like ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (list, tuple)):
                p = tuple(str(a) for a in p)
                for a in p:
                    _check_axis(a)
            elif p is not None:
                p = str(p)
                _check_axis(p)
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


def _check_axis(name: str) -> None:
    if name not in AXES:
        raise ValueError(f"unknown mesh axis {name!r}; have {AXES}")


class NamedSharding:
    """A spec over a mesh: which block of a global array each cell
    holds."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: mesh_mod.Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def cells(self):
        """``((i, j), device)`` for every cell, row-major."""
        for i, row in enumerate(self.mesh.devices):
            for j, dev in enumerate(row):
                yield (i, j), dev

    def index(self, cell: tuple, shape: tuple) -> tuple[tuple, tuple]:
        """The cell's block of a ``shape`` array: global (start, stop)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {shape} has dimensions")
        coord = dict(zip(AXES, cell))
        start, stop = [], []
        for d, dim in enumerate(shape):
            part = self.spec[d] if d < len(self.spec) else None
            axes = () if part is None else \
                (part if isinstance(part, tuple) else (part,))
            n, k = 1, 0
            for a in axes:
                n *= self.mesh.shape[a]
                k = k * self.mesh.shape[a] + coord[a]
            if dim % n:
                raise ValueError(
                    f"dimension {d} of {shape} ({dim}) does not split "
                    f"evenly over {n} cells of {part!r}")
            step = dim // n
            start.append(k * step)
            stop.append((k + 1) * step)
        return tuple(start), tuple(stop)

    def replica_id(self, cell: tuple) -> int:
        """The cell's rank among the cells holding the same block."""
        used = set()
        for part in self.spec:
            if part is not None:
                used.update(part if isinstance(part, tuple) else (part,))
        rid = 0
        for a, c in zip(AXES, cell):
            if a not in used:
                rid = rid * self.mesh.shape[a] + c
        return rid

    @property
    def mesh_axes(self) -> dict:
        return dict(self.mesh.shape)


class Block:
    """One cell's block: ``data`` on the cell's device."""

    __slots__ = ("data", "start", "stop", "replica_id", "cell")

    def __init__(self, data: torch.Tensor, start: tuple, stop: tuple,
                 replica_id: int, cell: tuple):
        self.data = data
        self.start = tuple(start)
        self.stop = tuple(stop)
        self.replica_id = replica_id
        self.cell = cell

    @property
    def device(self) -> torch.device:
        return self.data.device


class ShardedTensor:
    """A global array of ``shape`` and ``dtype`` as blocks over a mesh."""

    __slots__ = ("shape", "dtype", "sharding", "blocks")

    def __init__(self, shape: tuple, dtype: torch.dtype,
                 sharding: NamedSharding, blocks: list):
        self.shape = tuple(int(x) for x in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.blocks: list[Block] = list(blocks)

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def to_tensor(self, device=None) -> torch.Tensor:
        """The whole array assembled on ``device`` (default: the first
        block's device)."""
        dev = torch.device(device) if device is not None \
            else self.blocks[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for b in self.blocks:
            if b.replica_id == 0:
                out[tuple(slice(lo, hi) for lo, hi in
                          zip(b.start, b.stop))] = b.data.to(dev)
        return out

    def __array__(self, dtype=None, copy=None):
        a = tensor_to_numpy(self.to_tensor("cpu"))
        return a if dtype is None else a.astype(dtype)


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """Cut ``x`` (a torch tensor on any device, or an array) into the
    blocks ``sharding`` gives each cell, each copied to its cell's
    device; cells on one device that hold one block share its tensor."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    shape = tuple(t.shape)
    placed: dict = {}
    blocks = []
    for cell, dev in sharding.cells():
        start, stop = sharding.index(cell, shape)
        key = (start, stop, dev)
        data = placed.get(key)
        if data is None:
            view = t[tuple(slice(lo, hi) for lo, hi in zip(start, stop))]
            data = placed[key] = view.to(dev, copy=True).contiguous()
        blocks.append(Block(data, start, stop, sharding.replica_id(cell),
                            cell))
    return ShardedTensor(shape, t.dtype, sharding, blocks)


#: torch dtype -> the numpy name a manifest records (the JAX package's
#: ``str(arr.dtype)``), for the dtypes numpy knows; bfloat16 by name.
_NAMES = {torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
          torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
          torch.float16: "float16", torch.float32: "float32",
          torch.float64: "float64", torch.bfloat16: "bfloat16",
          torch.complex64: "complex64", torch.complex128: "complex128"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"dtype {dtype} has no checkpoint name") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown checkpoint dtype {name!r}") from None


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The C-order bytes of ``t`` (copied to the host if it is not)."""
    return t.detach().contiguous().reshape(-1).cpu().view(
        torch.uint8).numpy().tobytes()


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy; bfloat16 (which numpy lacks) as float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def local_mesh(device=None) -> mesh_mod.Mesh:
    """The configured mesh over the local devices of ``device``'s type
    (None = the card), else every such device as one grid
    (``make_mesh``'s most-square factorization)."""
    from ..ops import rs_torch
    dev = rs_torch.resolve_device(device)
    return mesh_mod.configured_mesh(dev.type) or \
        mesh_mod.make_mesh(mesh_mod.local_devices(dev.type))

