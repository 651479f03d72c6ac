"""Split EC work over a (dp, sp) grid of local devices.

The port of ``seaweedfs_tpu/parallel/mesh.py``. The reference spreads EC
work by placing shard files on different servers; here one host batch
``(B, n_in, S)`` is cut into cells over a grid of devices:

* ``dp`` (volume/batch axis): rows ``i·B/dp …`` go to grid row ``i`` —
  the analog of many volume servers encoding at once;
* ``sp`` (stripe axis): bytes ``j·S/sp …`` go to grid column ``j`` —
  the analog of striping one .dat over shard servers. The GF(2^8) map is
  position-wise, so neither axis needs any communication; only the
  verify steps' checksums are summed over every cell.

Each cell goes to its device and runs through ``rs_cuda.apply_gf_matrix``:
the hand-written kernel for a CUDA cell, its plain version for a CPU
cell. The split never takes the host codec (``rs_torch``'s small-payload
and link rules): a mesh launch count is one launch per cell per batch
(per :func:`rs_cuda.outputs_per_launch` output rows).

On the card, every cell works on the side stream of its device
(``rs_torch._side_stream``): its input copy (from a pinned staging
buffer of its own, or from the whole contiguous batch when the grid is
1 × 1 and nothing pads), its kernel, and the copy of its output into a
pinned host buffer of its own, followed by an event. Under the
``[pipeline] double_buffer`` lookahead (``copy_stream=True``), which
issues the next batch's prepare before the current batch's apply, the
input copy runs on a copy stream of its device instead and records an
event the side stream waits on just before the kernel, so it need not
queue behind the current batch's kernel and copy back. The result's
``np.asarray`` waits on every cell's last event and assembles the cells
on the host, slicing the padding off; a caller that recycles the input
buffer after it can never overwrite bytes still being copied. A grid
may repeat a device: cells on one card run in order on its streams.

Routing (:func:`routing_mesh`): the ``[mesh]`` TOML section
(:func:`configure_from`, the shell's ``-config``) or the ``-mesh dp,sp``
shell flag, which overrides it for one command, pins a mesh over the
local devices of the command's device type; more than one card with no
mesh configured splits adaptively (:data:`AUTO`); anything else stays on
the single-device path of ``rs_torch``. Prepare records the flight
recorder's H2D events. Each prepare and apply lands in the tracing
series ``trace_request_stage_seconds{stage=pipe.compute.dispatch|
pipe.compute.collective}``, and the axis sizes in the
``trace_mesh_axis_size`` gauges.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import bitslice, rs_cuda, rs_torch

GROUP = bitslice.GROUP_BYTES
#: The verify steps' checksums wrap like the reference's uint32 psum.
U32 = 0xFFFFFFFF


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """The devices a mesh of ``device_type`` spans: every card for
    ``cuda`` (raises without one), the one host device for ``cpu``."""
    if device_type == "cuda":
        rs_torch.resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r}")


class Mesh:
    """A (dp, sp) grid of torch devices, row-major: ``devices[i][j]``
    holds cell (i, j). A device may stand in several cells."""

    __slots__ = ("devices", "shape")

    def __init__(self, devices: Sequence, dp: int, sp: int):
        devs = [torch.device(d) for d in devices]
        if len(devs) != dp * sp:
            raise ValueError(f"{len(devs)} devices for a {dp}x{sp} mesh")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh spans one device type, got "
                             f"{sorted({d.type for d in devs})}")
        self.devices = [devs[i * sp:(i + 1) * sp] for i in range(dp)]
        self.shape = {"dp": dp, "sp": sp}

    @property
    def device_type(self) -> str:
        return self.devices[0][0].type


def _auto_factor(n: int) -> tuple[int, int]:
    """Most-square (dp, sp) with sp >= dp (stripe parallelism is
    communication-free here, so over-sharding it is harmless)."""
    dp = 1
    for f in range(int(math.isqrt(n)), 0, -1):
        if n % f == 0:
            dp = f
            break
    return dp, n // dp


def make_mesh(devices=None, dp: Optional[int] = None,
              sp: Optional[int] = None) -> Mesh:
    """Build a (dp, sp) mesh over the given devices (default: every
    card).

    Without explicit sizes, picks the most-square factorization with the
    stripe axis at least as large as the batch axis. An explicit request
    is honored or refused, never silently re-factored: any (dp, sp) that
    cannot tile the device count raises with the factorization that
    would."""
    devices = local_devices("cuda") if devices is None else list(devices)
    n = len(devices)
    if dp is not None and dp < 1 or sp is not None and sp < 1:
        raise ValueError(f"mesh axes must be positive, got dp={dp} sp={sp}")
    if dp is None and sp is None:
        dp, sp = _auto_factor(n)
    elif dp is None:
        if n % sp:
            raise ValueError(
                f"sp={sp} does not divide device count {n} "
                f"(auto factorization would be dp,sp = "
                f"{_auto_factor(n)[0]},{_auto_factor(n)[1]})")
        dp = n // sp
    elif sp is None:
        if n % dp:
            raise ValueError(
                f"dp={dp} does not divide device count {n} "
                f"(auto factorization would be dp,sp = "
                f"{_auto_factor(n)[0]},{_auto_factor(n)[1]})")
        sp = n // dp
    if dp * sp != n:
        raise ValueError(
            f"dp*sp = {dp}*{sp} = {dp * sp} != device count {n}: an "
            f"explicit mesh must tile ALL local devices (want dp*sp == "
            f"{n}, e.g. {_auto_factor(n)[0]},{_auto_factor(n)[1]})")
    return Mesh(devices, dp, sp)


# --------------------------------------------------------------------------
# configuration — the [mesh] TOML section and the -mesh shell flag
# --------------------------------------------------------------------------

class MeshConfigError(ValueError):
    """A -mesh request that cannot tile the local devices."""


@dataclass
class MeshConfig:
    """An EXPLICIT device mesh for the encode/rebuild/batch paths.
    Disabled (the default) keeps the auto routing: several cards split
    adaptively, everything else takes the single-device path. ``0`` for
    an axis means "derive" (most-square factorization)."""

    enabled: bool = False
    dp: int = 0
    sp: int = 0


_CONFIG = MeshConfig()


def current() -> MeshConfig:
    return _CONFIG


def configure(**kw) -> None:
    """Set config fields; None values keep their current setting."""
    for key, val in kw.items():
        if not hasattr(_CONFIG, key):
            raise TypeError(f"unknown mesh config key {key!r}")
        if val is not None:
            cur = getattr(_CONFIG, key)
            setattr(_CONFIG, key, type(cur)(val))


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[mesh]`` block (missing keys keep
    their current values; an unknown key raises ``TypeError``)."""
    from ..util import config as config_mod
    sect = config_mod.lookup(conf, "mesh")
    if not isinstance(sect, dict):
        return
    configure(**sect)


def parse_spec(spec: str) -> tuple[int, int]:
    """``-mesh dp,sp`` -> (dp, sp); ``-mesh auto`` -> (0, 0), the
    most-square factorization of the local device count."""
    text = (spec or "").strip().lower()
    if text in ("auto", ""):
        return 0, 0
    parts = text.split(",")
    try:
        if len(parts) != 2:
            raise ValueError
        dp, sp = int(parts[0]), int(parts[1])
        if dp < 1 or sp < 1:
            raise ValueError
    except ValueError:
        raise MeshConfigError(
            f"bad mesh spec {spec!r}: want 'dp,sp' with positive "
            f"integers (e.g. '2,4') or 'auto'") from None
    return dp, sp


@contextlib.contextmanager
def scoped(spec: str, device_type: str = "cuda"):
    """Enable an explicit mesh over the local ``device_type`` devices
    for one command (the ``-mesh`` shell flag, over whatever ``[mesh]``
    set): parse, validate against the device count — a clear
    :class:`MeshConfigError` BEFORE any work starts — and restore the
    previous config on exit. Yields the Mesh."""
    dp, sp = parse_spec(spec)
    prev = (_CONFIG.enabled, _CONFIG.dp, _CONFIG.sp)
    _CONFIG.enabled, _CONFIG.dp, _CONFIG.sp = True, dp, sp
    try:
        yield configured_mesh(device_type)
    finally:
        _CONFIG.enabled, _CONFIG.dp, _CONFIG.sp = prev


_configured_cache: dict = {}   # (device type, n_devices, dp, sp) -> Mesh


def configured_mesh(device_type: str = "cuda") -> Optional[Mesh]:
    """The configured Mesh over the local ``device_type`` devices, or
    None when the config is disabled. An explicit (dp, sp) that cannot
    tile the device count is a :class:`MeshConfigError` — the request
    is honored or refused, never silently re-factored."""
    if not _CONFIG.enabled:
        return None
    devices = local_devices(device_type)
    n = len(devices)
    key = (device_type, n, _CONFIG.dp, _CONFIG.sp)
    mesh = _configured_cache.get(key)
    if mesh is None:
        try:
            mesh = make_mesh(devices, dp=_CONFIG.dp or None,
                             sp=_CONFIG.sp or None)
        except ValueError as e:
            auto = _auto_factor(n)
            raise MeshConfigError(
                f"mesh dp={_CONFIG.dp or 'auto'},"
                f"sp={_CONFIG.sp or 'auto'} cannot tile the {n} local "
                f"device(s): {e}. Pass -mesh dp,sp with dp*sp == {n} "
                f"(e.g. '{auto[0]},{auto[1]}'), or -mesh auto.") from e
        _configured_cache.clear()  # one live shape
        _configured_cache[key] = mesh
    return mesh


#: Sentinel :func:`routing_mesh` returns for "split, but let the auto
#: path adapt the mesh per batch" (several cards).
AUTO = object()


def _card(dev: torch.device) -> bool:
    """Whether ``dev`` is a card, where several devices split work with
    no flag (tests substitute this to route a CPU device list)."""
    return dev.type == "cuda"


def routing_mesh(device=None):
    """What the encode / rebuild / batcher paths on ``device`` (None =
    the card) should do: the configured Mesh when ``-mesh`` is given,
    :data:`AUTO` with more than one card, or None for the single-device
    path."""
    dev = rs_torch.resolve_device(device)
    mesh = configured_mesh(dev.type)
    if mesh is not None:
        return mesh
    if _card(dev) and len(local_devices(dev.type)) > 1:
        return AUTO
    return None


# --------------------------------------------------------------------------
# cells: placement, the per-cell product, assembly
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    """One copy stream per card for the lookahead's input copies, so the
    next batch's copy need not queue behind the current batch's kernel
    and output copy on the side stream."""
    return torch.cuda.Stream(device=dev)


@contextlib.contextmanager
def _on(dev: torch.device):
    """Run a cell's work on its device: on a card, on that card's side
    stream (the one the single-device host path uses)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), \
            torch.cuda.stream(rs_torch._side_stream(dev)):
        yield


def _cells(mesh: Mesh, b: int, s: int):
    """(device, row slice, byte slice) of every cell of a (b, ·, s)
    array that tiles ``mesh`` exactly, row-major."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    bp, sq = b // dp, s // sp
    for i in range(dp):
        for j in range(sp):
            yield (mesh.devices[i][j], slice(i * bp, (i + 1) * bp),
                   slice(j * sq, (j + 1) * sq))


class Sharded:
    """A (B, n, S) uint8 array split over a mesh: ``cells[c]`` is the
    tensor of cell c (row-major) on its device, and ``ready[c]`` the
    event its copy to a card records (None where no copy is in flight).
    ``np.asarray`` gathers it to the host."""

    __slots__ = ("cells", "shape", "mesh", "ready", "_keep")

    def __init__(self, cells: list, shape: tuple, mesh: Mesh, keep=(),
                 ready=None):
        self.cells = cells
        self.shape = tuple(shape)
        self.mesh = mesh
        self.ready = ready if ready is not None else [None] * len(cells)
        self._keep = keep   # host staging buffers of queued copies

    def cell(self, c: int) -> torch.Tensor:
        """Cell c's tensor, for work on the current stream of its device:
        that stream first waits for the cell's copy to land."""
        if self.ready[c] is not None:
            torch.cuda.current_stream(self.cells[c].device).wait_event(
                self.ready[c])
        return self.cells[c]

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, dtype=np.uint8)
        for c, (dev, rows, cols) in enumerate(
                _cells(self.mesh, self.shape[0], self.shape[2])):
            with _on(dev):
                out[rows, :, cols] = self.cell(c).cpu().numpy()
        return out if dtype is None else out.astype(dtype)


def _to_cell(host: torch.Tensor, dev: torch.device, copy_stream: bool):
    """Start copying ``host`` to ``dev``: on a card, on its side stream
    ahead of the kernel, or with ``copy_stream`` on its copy stream with
    an event behind the copy (the side stream's kernel waits on it); the
    CPU takes the tensor as it is. Returns (tensor, event or None)."""
    if dev.type != "cuda":
        return host.to(dev), None
    if not copy_stream:
        with _on(dev):
            return host.to(dev, non_blocking=True), None
    with torch.cuda.device(dev), torch.cuda.stream(_copy_stream(dev)):
        x = host.to(dev, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
    # the side stream reads x: its memory may not be reused before the
    # side stream's work on it is done
    x.record_stream(rs_torch._side_stream(dev))
    return x, ready


def _place(x: np.ndarray, mesh: Mesh, b_pad: int, s_pad: int,
           copy_stream: bool = False) -> Sharded:
    """Start copying HOST ``x`` (b, n, s), zero-padded to (b_pad, n,
    s_pad), to the mesh's cells (on a copy stream per card with
    ``copy_stream``: :func:`_to_cell`). Each cell is staged into a
    contiguous buffer of its own (pinned for a card) — a strided slice
    of a host batch is no async copy source — except on a 1 × 1 grid
    with no padding, which copies the whole contiguous batch as it is."""
    b, n, s = x.shape
    cuda = mesh.device_type == "cuda"
    if len(mesh.devices) == len(mesh.devices[0]) == 1 \
            and (b, s) == (b_pad, s_pad) and x.flags.c_contiguous:
        src = torch.from_numpy(x)
        cell, ready = _to_cell(src, mesh.devices[0][0], copy_stream)
        return Sharded([cell], x.shape, mesh, (src,), [ready])
    cells, keep, events = [], [], []
    for dev, rows, cols in _cells(mesh, b_pad, s_pad):
        stage = torch.empty((rows.stop - rows.start, n,
                             cols.stop - cols.start), dtype=torch.uint8,
                            pin_memory=cuda)
        host = stage.numpy()
        rr = max(0, min(rows.stop, b) - rows.start)
        cc = max(0, min(cols.stop, s) - cols.start)
        if rr < host.shape[0] or cc < host.shape[2]:
            host[...] = 0
        host[:rr, :, :cc] = x[rows.start:rows.start + rr, :,
                              cols.start:cols.start + cc]
        cell, ready = _to_cell(stage, dev, copy_stream)
        cells.append(cell)
        events.append(ready)
        keep.append(stage)
    return Sharded(cells, (b_pad, n, s_pad), mesh, keep, events)


def shard_batch(x: np.ndarray, mesh: Mesh, pad: bool = False) -> Sharded:
    """Place a host (B, k, S) batch on the mesh, rows over dp and bytes
    over sp.

    Validates divisibility (rows must divide dp; S per cell must stay a
    multiple of the 128-byte packing group) — or, with ``pad=True``,
    zero-pads the row axis to the dp multiple and S to the sp*group
    granule instead (zero rows/columns encode to zero output; callers
    slice by the ORIGINAL extents, as prepare_batch/apply_prepared
    do)."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    b, n_in, s = x.shape
    b_pad, s_pad = b, s
    if pad and (b % dp or s % (sp * GROUP)):
        b_pad = -(-b // dp) * dp
        s_pad = -(-s // (sp * GROUP)) * (sp * GROUP)
    if b_pad % dp:
        raise ValueError(f"batch {b} not divisible by dp={dp}")
    if s_pad % (sp * GROUP):
        raise ValueError(
            f"shard length {s} not divisible by sp*{GROUP} = {sp * GROUP}")
    return _place(np.asarray(x, dtype=np.uint8), mesh, b_pad, s_pad)


def _map_cells(fn, xs: Sharded, n_out: int, mesh: Mesh) -> Sharded:
    """``fn(cell)`` on every cell on its device -> the (B, n_out, S)
    Sharded of the outputs. ``xs`` must be placed on a mesh of the shape
    of ``mesh``, the one the step was made for."""
    if xs.mesh.shape != mesh.shape:
        raise ValueError(f"input placed on a {xs.mesh.shape} mesh, the "
                         f"step was made for {mesh.shape}")
    outs = []
    for c, (dev, _r, _c) in enumerate(
            _cells(xs.mesh, xs.shape[0], xs.shape[2])):
        with _on(dev):
            outs.append(fn(xs.cell(c)))
    return Sharded(outs, (xs.shape[0], n_out, xs.shape[2]), xs.mesh)


def _u32_sum(ys: Sharded) -> int:
    """Sum of every element of every cell, mod 2^32: the reference's
    uint32 psum. Each cell sums exactly in int64; the total wraps once."""
    total = 0
    for (dev, _r, _c), y in zip(_cells(ys.mesh, ys.shape[0], ys.shape[2]),
                                ys.cells):
        with _on(dev):
            total += int(y.sum(dtype=torch.int64).item())
    return total & U32


# --------------------------------------------------------------------------
# the verify steps (dry run, tests): device in, device out, checksum
# --------------------------------------------------------------------------

def make_sharded_encode_step(encoder: rs_torch.Encoder, mesh: Mesh):
    """Sharded (B, k, S) -> (Sharded (B, m, S) parity, checksum).

    The checksum is the byte-sum of the parity **mod 2^32**, summed over
    every cell (the cross-server integrity handshake a multi-server
    encode does over gRPC in the reference). Host-side verifiers must
    reduce mod 2^32 too."""
    coefs = encoder.parity_coefs

    def step(xs: Sharded):
        parity = _map_cells(lambda x: rs_cuda.apply_gf_matrix(coefs, x),
                            xs, coefs.shape[0], mesh)
        return parity, _u32_sum(parity)

    return step


def make_sharded_train_step(encoder: rs_torch.Encoder, mesh: Mesh,
                            lost: tuple[int, ...] = (0,)):
    """The FULL EC step of the dry run: encode -> drop ``lost`` shards
    -> reconstruct them -> compare with the originals, returning
    (Sharded (B, m, S) parity, mismatch count summed over every cell)."""
    k = encoder.data_shards
    parity_coefs = encoder.parity_coefs
    lost = sorted(lost)
    present = [i for i in range(encoder.total_shards) if i not in lost]
    rebuild_coefs = encoder.decode_matrix_rows(present, lost)

    def step(xs: Sharded):
        bad = []

        def cell(x):
            parity = rs_cuda.apply_gf_matrix(parity_coefs, x)
            full = torch.cat([x, parity], dim=1)
            rebuilt = rs_cuda.apply_gf_matrix(rebuild_coefs,
                                              full[:, present[:k]])
            bad.append(rebuilt != full[:, lost])
            return parity

        parity = _map_cells(cell, xs, parity_coefs.shape[0], mesh)
        return parity, _u32_sum(Sharded(
            bad, (xs.shape[0], len(lost), xs.shape[2]), xs.mesh))

    return step


def make_sharded_rebuild_step(encoder: rs_torch.Encoder, mesh: Mesh,
                              present, wanted):
    """Sharded survivors (B, k, S) -> (Sharded (B, len(wanted), S)
    rebuilt, checksum as in :func:`make_sharded_encode_step`).

    ``present`` may be ANY survivor set (uneven mixes of data and parity
    ids; the first k are used): each cell rebuilds its slice of the lost
    shards from its slice of the survivors."""
    rows = encoder.decode_matrix_rows(list(present), list(wanted))

    def step(surv: Sharded):
        rebuilt = _map_cells(lambda x: rs_cuda.apply_gf_matrix(rows, x),
                             surv, rows.shape[0], mesh)
        return rebuilt, _u32_sum(rebuilt)

    return step


def _granule(sp: int) -> int:
    """S granule of a split batch: each cell's byte range is a whole
    number of 128-byte packing groups (the kernels take any S)."""
    return sp * GROUP


# --------------------------------------------------------------------------
# telemetry — pipe.compute split into dispatch (H2D shard placement)
# vs collective (the per-cell apply) time, plus per-axis gauges
# --------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_TOTALS = {"batches": 0, "bytes_in": 0, "bytes_out": 0,
           "dispatch_seconds": 0.0, "collective_seconds": 0.0}
_LAST_SHAPE = {"dp": 0, "sp": 0}
#: the closed stage vocabulary — prepare is "dispatch", the apply is
#: "collective"; nothing else ever reaches _observe
_STAGE_NAMES = {"dispatch": "pipe.compute.dispatch",
                "collective": "pipe.compute.collective"}
#: stage suffix -> (latency histogram, bytes counter); cached like
#: pipe._STAGE_INSTRUMENTS — a rare double-create just wins the same
#: registry entry.
_INSTRUMENTS: dict = {}


def _observe(kind: str, seconds: float, nbytes: int, mesh: Mesh) -> None:
    """Fold one prepare ("dispatch") or apply ("collective")
    measurement into the module totals, the shared
    ``request_stage_seconds{stage=pipe.compute.<kind>}`` tracing series
    and the per-axis ``mesh_axis_size`` gauges."""
    from ..util import tracing
    tup = _INSTRUMENTS.get(kind)
    if tup is None:
        stage = _STAGE_NAMES[kind]
        tup = (tracing.METRICS.histogram("request_stage_seconds",
                                         stage=stage),
               tracing.METRICS.counter("stage_bytes_total",
                                       stage=stage))
        _INSTRUMENTS[kind] = tup
    tup[0].observe(seconds)
    if nbytes:
        tup[1].inc(nbytes)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    shape_changed = False
    with _STATS_LOCK:
        _TOTALS[f"{kind}_seconds"] += seconds
        if kind == "dispatch":
            _TOTALS["batches"] += 1
            _TOTALS["bytes_in"] += nbytes
        else:
            _TOTALS["bytes_out"] += nbytes
        if (_LAST_SHAPE["dp"], _LAST_SHAPE["sp"]) != (dp, sp):
            _LAST_SHAPE["dp"], _LAST_SHAPE["sp"] = dp, sp
            shape_changed = True
    if shape_changed:
        for axis, size in (("dp", dp), ("sp", sp)):
            tracing.METRICS.gauge("mesh_axis_size", axis=axis).set(size)


def debug_payload() -> dict:
    """The configured shape plus the cumulative dispatch/collective
    split."""
    with _STATS_LOCK:
        out = {k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in _TOTALS.items()}
        out["axes"] = dict(_LAST_SHAPE)
    out["configured"] = {"enabled": _CONFIG.enabled,
                         "dp": _CONFIG.dp, "sp": _CONFIG.sp}
    return out


def reset_telemetry() -> None:
    """Drop the cumulative mesh-stage totals (tests)."""
    with _STATS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0 if isinstance(_TOTALS[k], int) else 0.0
        _LAST_SHAPE["dp"] = _LAST_SHAPE["sp"] = 0


# --------------------------------------------------------------------------
# the production host-batch path: prepare (H2D) / apply (per-cell kernels)
# --------------------------------------------------------------------------

class Prepared:
    """A host batch already placed on the mesh: the (possibly padded)
    Sharded input plus the original (b, s), so apply can slice the
    padding back off."""

    __slots__ = ("arr", "b", "s", "mesh")

    def __init__(self, arr: Sharded, b: int, s: int, mesh: Mesh):
        self.arr = arr
        self.b = b
        self.s = s
        self.mesh = mesh


class _MeshResult:
    """Async (b, n_out, s) result of a split product: each cell's output
    sits in its own host buffer (pinned, behind an event, for a card).
    ``np.asarray`` waits on every event and assembles the cells, padding
    sliced off; a 1 × 1 result with no padding is its buffer as it is."""

    __slots__ = ("outs", "shape", "b", "s", "src")

    def __init__(self, outs: list, shape: tuple, b: int, s: int,
                 src: Prepared):
        self.outs = outs      # (row slice, byte slice, host, event)
        self.shape = shape    # padded (B, n_out, S)
        self.b = b
        self.s = s
        self.src = src        # keeps the staged inputs until the wait

    def __array__(self, dtype=None, copy=None):
        b_pad, n_out, s_pad = self.shape
        if len(self.outs) == 1 and (self.b, self.s) == (b_pad, s_pad):
            _r, _c, host, done = self.outs[0]
            if done is not None:
                done.synchronize()
            out = host.numpy()
        else:
            out = np.empty((self.b, n_out, self.s), dtype=np.uint8)
            for rows, cols, host, done in self.outs:
                if done is not None:
                    done.synchronize()
                rr = max(0, min(rows.stop, self.b) - rows.start)
                cc = max(0, min(cols.stop, self.s) - cols.start)
                if rr and cc:
                    out[rows.start:rows.start + rr, :,
                        cols.start:cols.start + cc] = \
                        host.numpy()[:rr, :, :cc]
        self.src = None
        return out if dtype is None else out.astype(dtype)


def _auto_mesh_for(b: int, device_type: str) -> Mesh:
    """The adaptive auto mesh over every local ``device_type`` device:
    small B (the rebuild path streams B=1 chunks) drops to an sp-only
    mesh so every device holds a stripe slice instead of (dp-1)/dp of
    them computing zero padding."""
    devices = local_devices(device_type)
    dp_auto, _ = _auto_factor(len(devices))
    return make_mesh(devices, dp=dp_auto if b >= dp_auto else 1)


def prepare_batch(batch: np.ndarray, mesh=None, device=None,
                  copy_stream: bool = False) -> Prepared:
    """Pad a HOST (B, n_in, S) u8 batch to the mesh geometry and start
    its copies to the cells.

    Rows pad to the dp multiple and S to the granule — zero rows/columns
    map to zero output and are sliced off by :func:`apply_prepared`.
    With ``mesh=None`` (or :data:`AUTO`) the adaptive auto mesh over the
    local devices of ``device``'s type is used; an explicit Mesh is
    honored AS GIVEN — an uneven batch pads rather than re-factoring the
    mesh. ``copy_stream`` issues the copies on a copy stream per card
    (:func:`_to_cell`). The placement time lands in the "dispatch"
    totals; the flight
    recorder's H2D span covers it (its end means the copies are issued,
    not landed: the landing is in the batch's sync span)."""
    from ..pipeline import flight
    t0 = time.perf_counter()
    flight.record(flight.EV_H2D_SUBMIT)
    b, n_in, s = batch.shape
    if mesh is None or mesh is AUTO:
        mesh = _auto_mesh_for(b, rs_torch.resolve_device(device).type)
    dp = mesh.shape["dp"]
    gran = _granule(mesh.shape["sp"])
    b_pad = -(-b // dp) * dp
    s_pad = -(-s // gran) * gran
    arr = _place(batch, mesh, b_pad, s_pad, copy_stream)
    _observe("dispatch", time.perf_counter() - t0, b_pad * n_in * s_pad,
             mesh)
    flight.record(flight.EV_H2D_READY, arg=b_pad * n_in * s_pad)
    return Prepared(arr, b, s, mesh)


def apply_prepared(coefs: np.ndarray, prep: Prepared) -> _MeshResult:
    """Apply coefficient rows to a prepared batch, one product per cell
    on its device; returns the async (b, n_out, s) result sliced back to
    the original extents (``np.asarray`` waits — callers in the 3-stage
    pipeline keep that wait on the writer thread). The enqueue time
    lands in the "collective" totals."""
    t0 = time.perf_counter()
    coefs = np.ascontiguousarray(coefs, dtype=np.uint8)
    arr = prep.arr
    outs = []
    for c, (dev, rows, cols) in enumerate(
            _cells(prep.mesh, arr.shape[0], arr.shape[2])):
        with _on(dev):
            y = rs_cuda.apply_gf_matrix(coefs, arr.cell(c))
            if dev.type == "cuda":
                host = torch.empty(y.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(y, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            else:
                host, done = y, None
        outs.append((rows, cols, host, done))
    shape = (arr.shape[0], coefs.shape[0], arr.shape[2])
    _observe("collective", time.perf_counter() - t0,
             prep.b * coefs.shape[0] * prep.s, prep.mesh)
    return _MeshResult(outs, shape, prep.b, prep.s, prep)


def encode_step_fns(encoder: rs_torch.Encoder, mesh=None,
                    copy_stream: bool = False):
    """(prepare_fn, apply_fn) pair for the pipeline's compute stage:
    prepare starts the copies to the cells (on a copy stream per card
    with ``copy_stream``, for the double-buffer lookahead), apply runs
    the parity product on the prepared batch."""
    coefs = encoder.parity_coefs

    def prep(batch: np.ndarray) -> Prepared:
        return prepare_batch(batch, mesh, encoder.device, copy_stream)

    def apply(prepared: Prepared) -> _MeshResult:
        return apply_prepared(coefs, prepared)

    return prep, apply


def _apply_host_sharded(coefs: np.ndarray, batch: np.ndarray, mesh=None,
                        device=None) -> _MeshResult:
    """Apply coefficient rows to a HOST (B, n_in, S) u8 batch over a
    mesh; returns the async (B, n_out, S) result. ``mesh=None``/
    :data:`AUTO` adapts the mesh to the batch over the local devices of
    ``device``'s type; an explicit Mesh is honored as given."""
    return apply_prepared(coefs, prepare_batch(batch, mesh, device))


def encode_parity_host_sharded(encoder: rs_torch.Encoder,
                               batch: np.ndarray, mesh=None) -> _MeshResult:
    """Split encode: HOST (B, k, S) u8 -> async (B, m, S) parity over a
    mesh. The entry the coalescing batcher uses when routing_mesh() says
    to split. ``mesh``: None/AUTO for the adaptive auto mesh over the
    encoder's device type, or the explicit Mesh to honor."""
    return _apply_host_sharded(encoder.parity_coefs, batch, mesh,
                               encoder.device)


def reconstruct_host_sharded(encoder: rs_torch.Encoder,
                             survivors: np.ndarray, present, wanted,
                             mesh=None) -> _MeshResult:
    """Split rebuild: decode rows for (present -> wanted) applied to HOST
    survivor chunks over a mesh — the split form of
    ``reconstruct_batch_host`` that the rebuild pipeline uses when
    routing_mesh() says to split. ``survivors``: (B, len(present), S)
    u8, first k used. ``mesh`` as in :func:`encode_parity_host_sharded`."""
    rows = encoder.decode_matrix_rows(list(present), list(wanted))
    chosen = survivors[:, :encoder.data_shards, :]
    if not chosen.flags.c_contiguous:
        chosen = np.ascontiguousarray(chosen)
    return _apply_host_sharded(rows, chosen, mesh, encoder.device)
