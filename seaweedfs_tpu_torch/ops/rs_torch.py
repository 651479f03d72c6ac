"""Batched Reed-Solomon codec on PyTorch: the port of ops/rs_jax.py.

The same method surface as ``seaweedfs_tpu.ops.rs_jax.Encoder`` (and the
klauspost ``Encoder`` it mirrors), on ``(B, k, S)`` uint8 batches. Every
GF(2^8) product goes through ``rs_cuda.apply_gf_matrix``: a hand-written
kernel for tensors on the card, its plain PyTorch version for tensors on
the CPU. Reconstruction takes the first k surviving shard indices,
inverts those k rows of the code matrix on the host, and applies the
needed rows through the same kernel; the inverses are memoized per
survivor set.

The host-slab path (``*_host`` / ``*_host_multi``) is what the
pipelines call. On the card it issues, on a side stream, an async copy
from the (pinned) pool buffer to the device, the kernel launch, and an
async copy into a pinned output, then records an event. The result's
``np.asarray`` (the pipeline writer's sync point) waits on that event
only. Results come back in submission order because everything runs on
one stream. The copy that reads the pool buffer precedes that event on
the same stream, so a caller that recycles the buffer after
``np.asarray`` can never overwrite bytes still being copied.

The hybrid rule, in the order it is applied to a HOST product:

1. the small-payload rule: a product whose shard length S is below
   :data:`DEVICE_MIN_S` goes to the native host codec
   (``rs_native.apply_gf_matrix``) on every device, because below it a
   round trip to the card is its fixed cost, two to three times the host
   codec's time; the read path's interval repairs are its callers;
2. the link-bandwidth half, on the card only: ``auto``
   (``SEAWEEDFS_TORCH_HOST_DISPATCH``, the default) probes the link's
   round-trip rate and the host codec's rate once per process
   (:func:`_device_worth_it`) and keeps the product on the host codec
   when the link is the slower; ``device`` and ``native`` pin the choice;
3. else the card. On the CPU, products from ``DEVICE_MIN_S`` take the
   kernels' plain PyTorch versions.

A tensor already on the card is never copied back for either rule, and
where the native library cannot be built every product goes to the
kernels. A kernel that fails to build or launch raises; nothing gives
way to the host for it.

Grouped dispatch (``*_host_multi``, the port of the JAX package's
``apply_matrix_host_multi``): a run of adjacent slabs of one shape, at
most :func:`_dispatch_group` of them (``SEAWEEDFS_TORCH_DISPATCH_GROUP``,
16 by default), is ONE kernel call with batch G·B. The run's slabs are
copied from their pool buffers into one device staging tensor, one
launch per :func:`rs_cuda.outputs_per_launch` row block covers them
all (one for RS(10,4)), and one copy back into one pinned output with
one event serves every slab's result. The JAX package splits a run into
power-of-two sub-dispatches to spare XLA's compile cache; a launch here
takes any batch, so a run is dispatched whole. Its buffer-donation knob
has no counterpart either: the staging tensor is allocated on the side
stream, so the caching allocator hands its memory out again only in
that stream's order. :func:`host_dispatch_group` is the pipelines'
group width: 1 on the CPU and wherever ``parallel/mesh.routing_mesh``
splits the batches. Two settings bound a group, as in the JAX package,
and the smaller wins: ``SEAWEEDFS_TORCH_DISPATCH_GROUP`` is the most
slabs one run carries, whoever calls :func:`apply_matrix_host_multi`
(the environment variable keeps the JAX package's name and default);
``[pipeline] group_cap`` narrows the pipelines' drain below it for one
configuration (pipeline/pipe.py ``pick_grouped_dispatch``), so a
drained group is never split here.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..pipeline import flight
from . import gf256, rs_cuda, rs_native
from .rs_ref import ShardSizeError, TooFewShardsError


#: Shard length (bytes) from which a host product goes to the card.
#: Measured for one interval repair (B = 1, 10 inputs, 1 output), round
#: trip from pageable memory included, with ``python -m
#: seaweedfs_tpu_torch.ops.kernel_bench --crossover`` on an NVIDIA H100
#: 80GB HBM3 at 700 W whose host has GFNI (PERF.md §6): the card
#: won at no S from 1 KiB to 4 MiB at B = 1 and at every S to 32 KiB at
#: B = 128. Below 128 KiB the card's round trip is its fixed cost (twice
#: the host codec's at B = 1); from 128 KiB it grows with the bytes
#: copied, at about the host codec's rate, and the choice between the two
#: is the link-bandwidth half of the hybrid rule.
DEVICE_MIN_S = 128 * 1024

#: Probe results of the link-bandwidth half: GiB/s of the host<->card
#: round trip and of the host codec, measured once per process.
_link_gibps: Optional[float] = None
_native_gibps: Optional[float] = None
_calibrate_lock = threading.Lock()


def _dispatch_group() -> int:
    """``SEAWEEDFS_TORCH_DISPATCH_GROUP`` (default 16): the most slabs one
    run of the grouped host path carries. Read and validated at use time,
    so a typo surfaces as a ``ValueError`` from the encode call."""
    raw = os.environ.get("SEAWEEDFS_TORCH_DISPATCH_GROUP") or "16"
    try:
        g = int(raw)
    except (TypeError, ValueError):
        g = -1
    if g < 1:
        raise ValueError(
            f"SEAWEEDFS_TORCH_DISPATCH_GROUP={raw!r}: expected a positive "
            f"integer")
    return g


def host_dispatch_group(device=None) -> int:
    """Group width for the host-slab pipelines on ``device`` (None = the
    card), one policy for encode, rebuild and the batcher: 1 on the CPU,
    1 where ``parallel/mesh.routing_mesh`` splits every batch over a mesh
    (``-mesh``, ``[mesh]``, or more than one card), else
    :func:`_dispatch_group`."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 1
    from ..parallel import mesh as mesh_mod
    if mesh_mod.routing_mesh(dev) is not None:
        return 1
    return _dispatch_group()


def host_codec_takes(s: int) -> bool:
    """The small-payload rule: whether a host product of shard length
    ``s`` goes to the native host codec."""
    return s < DEVICE_MIN_S and rs_native.available()


def _dispatch_mode() -> str:
    """``SEAWEEDFS_TORCH_HOST_DISPATCH``, read and validated at use time
    so a typo surfaces from the codec call: ``auto`` (the default)
    measures, ``device`` and ``native`` pin the choice for large host
    slabs."""
    mode = os.environ.get("SEAWEEDFS_TORCH_HOST_DISPATCH") or "auto"
    if mode not in ("auto", "device", "native"):
        raise ValueError(
            f"SEAWEEDFS_TORCH_HOST_DISPATCH={mode!r}: expected "
            f"'auto', 'device' or 'native'")
    return mode


def _measure_link_gibps(device=None, n_bytes: int = 8 * 1024 * 1024
                        ) -> float:
    """Host->card->host round-trip rate of a pageable buffer (GiB/s of
    payload moved per second of wall time, both directions counted),
    after one warm-up round trip of the same buffer, so that creating
    the CUDA context and the copies' staging buffers is not timed as
    link bandwidth."""
    dev = resolve_device(device)
    x = np.zeros(n_bytes, dtype=np.uint8)
    torch.from_numpy(x).to(dev).cpu()
    t0 = time.perf_counter()
    torch.from_numpy(x).to(dev).cpu()
    dt = time.perf_counter() - t0
    return 2 * n_bytes / (1024 ** 3) / max(dt, 1e-9)


def _measure_native_gibps(n_bytes: int = 16 * 1024 * 1024) -> float:
    """Host codec rate (input GiB/s) on an encode-shaped (10 -> 4)
    product, after a warm-up call that builds the library and tables."""
    k = 10
    coefs = gf256.build_code_matrix(k, k + 4)[k:]
    x = np.zeros((k, n_bytes // k), dtype=np.uint8)
    rs_native.apply_gf_matrix(coefs, x)
    t0 = time.perf_counter()
    rs_native.apply_gf_matrix(coefs, x)
    dt = time.perf_counter() - t0
    return x.size / (1024 ** 3) / max(dt, 1e-9)


def _device_worth_it(device=None) -> bool:
    """The link-bandwidth half of the hybrid rule: should a large HOST
    slab cross to the card? ``auto`` probes both rates once per process
    (under a lock, re-checked inside it, so concurrent callers neither
    probe twice nor share the link with each other's probe); the card
    wins only when the link outruns the host codec."""
    mode = _dispatch_mode()
    if mode == "device":
        return True
    if mode == "native":
        return False
    if not rs_native.available():
        return True
    global _link_gibps, _native_gibps
    if _link_gibps is None:
        # seaweedlint: disable=SW103 — the host codec's library is built by rs_native.available() above, outside the lock, so _measure_native_gibps only loads it; the sleep edge ... -> _build -> VolumeServer.read_bytes -> check is a false name-based resolution of Path.read_bytes
        with _calibrate_lock:
            if _link_gibps is None:
                link = _measure_link_gibps(device)
                _native_gibps = _measure_native_gibps()
                _link_gibps = link
    return _link_gibps > _native_gibps


def _stay_on_host(device=None) -> bool:
    """Large host slabs stay on the host when the link can't outrun the
    host codec (and the codec exists)."""
    return not _device_worth_it(device) and rs_native.available()


def calibration() -> Optional[tuple[float, float]]:
    """The ``auto`` probe's (link GiB/s, host codec GiB/s), or None
    before the first probe."""
    if _link_gibps is None:
        return None
    return _link_gibps, _native_gibps


def _host_takes(s: int, dev: torch.device) -> bool:
    """The hybrid rule for a HOST product of shard length ``s`` bound
    for ``dev``: True sends it to the native host codec (module
    docstring, steps 1-2)."""
    _dispatch_mode()
    if host_codec_takes(s):
        return True
    return dev.type == "cuda" and _stay_on_host(dev)


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Asking for CUDA where there is none
    raises: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false. Pass "
            "device='cpu' to run the plain PyTorch codec on the host.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card for the host-slab path: one stream keeps
    copies, kernels and results in FIFO order."""
    return torch.cuda.Stream(device=device)


class _HostResult:
    """Async (B, n_out, S) result of a host slab on the card:
    ``np.asarray`` waits on the event recorded after the D2H copy (one
    event and one pinned output for all the slabs of a run) and views the
    slab's rows of that output."""

    __slots__ = ("host", "done")

    def __init__(self, host: torch.Tensor, done: torch.cuda.Event):
        self.host = host
        self.done = done

    def __array__(self, dtype=None, copy=None):
        self.done.synchronize()
        out = self.host.numpy()
        if dtype is not None and out.dtype != dtype:
            return out.astype(dtype)
        return out


def apply_matrix(coefs: np.ndarray, x, device=None) -> torch.Tensor:
    """(n_in, S) or (B, n_in, S) uint8 (numpy or tensor) -> the GF(2^8)
    map's result as a tensor on ``device``. Any S."""
    dev = resolve_device(device)
    t = x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    if t.dim() not in (2, 3):
        raise ValueError(f"expected (n_in, S) or (B, n_in, S), got "
                         f"{tuple(t.shape)}")
    squeeze = t.dim() == 2
    if t.device.type == "cpu" and host_codec_takes(t.shape[-1]):
        y = rs_native.apply_gf_matrix(coefs, t.numpy())
        return torch.from_numpy(y).to(dev)
    t = t.to(device=dev, dtype=torch.uint8)
    y = rs_cuda.apply_gf_matrix(coefs, t[None] if squeeze else t)
    return y[0] if squeeze else y


def apply_matrix_host(coefs: np.ndarray, batch: np.ndarray, device=None):
    """HOST (B, n_in, S) uint8 -> a result whose ``np.asarray`` is
    (B, n_out, S) uint8: a numpy array from the host codec (the hybrid
    rule, module docstring) or on the CPU, an async :class:`_HostResult`
    on the card."""
    return _apply_host(coefs, [batch], resolve_device(device), 1)[0]


def apply_matrix_host_multi(coefs: np.ndarray, batches, device=None):
    """Grouped :func:`apply_matrix_host`: a list of HOST (B, n_in, S)
    uint8 slabs -> their results, in order.

    Slabs are walked in order. One the hybrid rule sends to the host
    codec (:func:`_host_takes`; the link probe is taken once per process)
    flushes the open run and goes to ``rs_native``. A slab whose
    shape differs from the run's flushes it, and so does a run that
    reached :func:`_dispatch_group` slabs. A flushed run is one kernel
    call (:func:`_dispatch_run`), dispatched whole."""
    return _apply_host(coefs, batches, resolve_device(device),
                       _dispatch_group())


def _apply_host(coefs: np.ndarray, batches, dev: torch.device,
                cap: int) -> list:
    """The run logic of :func:`apply_matrix_host_multi`, runs of at most
    ``cap`` slabs."""
    coefs = np.ascontiguousarray(coefs, dtype=np.uint8)
    out: list = [None] * len(batches)
    run: list[int] = []
    slabs = [np.ascontiguousarray(b, dtype=np.uint8) for b in batches]

    def flush():
        if run:
            for i, r in zip(run, _dispatch_run(coefs,
                                               [slabs[i] for i in run],
                                               dev)):
                out[i] = r
            run.clear()

    for i, slab in enumerate(slabs):
        if _host_takes(slab.shape[-1], dev):
            flush()
            out[i] = rs_native.apply_gf_matrix(coefs, slab)
            continue
        if run and (slab.shape != slabs[run[0]].shape or len(run) >= cap):
            flush()
        run.append(i)
    flush()
    return out


def _dispatch_run(coefs: np.ndarray, slabs: list, dev: torch.device
                  ) -> list:
    """One run of G equal-shaped (B, n_in, S) host slabs as ONE
    ``rs_cuda.apply_gf_matrix`` call with batch G·B: the slabs are copied
    into one staging tensor of (G·B, n_in, S_pad), S_pad being S padded
    to the chosen kernel's granule (pad columns zeroed once, so the
    wrapper copies nothing again). On the card, everything is enqueued
    on the side stream: G async copies from the (pinned) slabs, the
    launches, one async copy into one pinned (G·B, n_out, S) output and
    one event, which every slab's :class:`_HostResult` shares; the G
    copies are one ``h2d`` flight span (batch ``flight.STAGED``). On the
    CPU, the plain version over the same staging tensor. A launch that
    fails raises; nothing is retried slab by slab."""
    g = len(slabs)
    b, n_in, s = slabs[0].shape
    n_out = coefs.shape[0]
    granule = rs_cuda.TRANSPOSE_GRANULE if rs_cuda.kernel() == "transpose" \
        else rs_cuda.SWAR_GRANULE
    sp = -(-s // granule) * granule
    rs_cuda.check_launch_size(g * b, sp)
    if dev.type == "cpu":
        x = torch.empty((g * b, n_in, sp), dtype=torch.uint8)
        x[..., s:] = 0
        for j, slab in enumerate(slabs):
            x[j * b:(j + 1) * b, :, :s] = torch.from_numpy(slab)
        y = rs_cuda.apply_gf_matrix(coefs, x)[..., :s].numpy()
        return [y[j * b:(j + 1) * b] for j in range(g)]
    stream = _side_stream(dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        x = torch.empty((g * b, n_in, sp), dtype=torch.uint8, device=dev)
        if sp != s:
            x[..., s:].zero_()
        # the copy staging: from pageable slabs each copy returns once
        # CUDA has staged it, so the calling thread waits here
        flight.record(flight.EV_H2D_SUBMIT, batch=flight.STAGED)
        for j, slab in enumerate(slabs):
            x[j * b:(j + 1) * b, :, :s].copy_(torch.from_numpy(slab),
                                              non_blocking=True)
        flight.record(flight.EV_H2D_READY, batch=flight.STAGED,
                      arg=g * b * n_in * s)
        y = rs_cuda.apply_gf_matrix(coefs, x)
        host = torch.empty((g * b, n_out, s), dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(y[..., :s], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return [_HostResult(host[j * b:(j + 1) * b], done) for j in range(g)]


class Encoder:
    """Parametrized RS(k, m) with the klauspost Encoder method set,
    running on ``device`` (``None`` = the card)."""

    def __init__(self, data_shards: int, parity_shards: int, device=None,
                 matrix: Optional[np.ndarray] = None):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("data_shards and parity_shards must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("at most 256 total shards in GF(2^8)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.device = resolve_device(device)
        if matrix is None:
            matrix = gf256.build_code_matrix(data_shards, self.total_shards)
        self.matrix = matrix
        self._decode_cache: dict[tuple[int, ...], np.ndarray] = {}

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, device=None) -> "Encoder":
        """An encoder over a given systematic (k+m, k) code matrix (top k
        rows the identity), e.g. one built by another implementation."""
        matrix = np.array(matrix, dtype=np.uint8)
        if matrix.ndim != 2 or matrix.shape[0] <= matrix.shape[1]:
            raise ValueError(f"matrix must be (k+m, k), got {matrix.shape}")
        k = matrix.shape[1]
        if not np.array_equal(matrix[:k], np.eye(k, dtype=np.uint8)):
            raise ValueError("matrix is not systematic: top k rows must "
                             "be the identity")
        matrix.setflags(write=False)
        return cls(k, matrix.shape[0] - k, device=device, matrix=matrix)

    # -- batched array API -------------------------------------------------

    @property
    def parity_coefs(self) -> np.ndarray:
        """(m, k) uint8 parity rows of the code matrix, C-contiguous."""
        return np.ascontiguousarray(self.matrix[self.data_shards:],
                                    dtype=np.uint8)

    def encode_parity(self, data) -> torch.Tensor:
        """data (B, k, S) or (k, S) uint8 -> parity (B, m, S) / (m, S)
        as a tensor on the encoder's device."""
        return apply_matrix(self.parity_coefs, data, self.device)

    def encode_parity_host(self, batch):
        """Pipeline path: HOST (B, k, S) uint8 -> parity whose
        ``np.asarray`` is (B, m, S) uint8 (see apply_matrix_host)."""
        return apply_matrix_host(self.parity_coefs, batch, self.device)

    def encode_parity_host_multi(self, batches):
        """encode_parity_host over a list of slabs, in order."""
        return apply_matrix_host_multi(self.parity_coefs, batches,
                                       self.device)

    def reconstruct_batch_host(self, shards, present: Sequence[int],
                               wanted: Optional[Sequence[int]] = None):
        """reconstruct_batch for HOST survivor arrays ``shards``
        (B, len(present), S) uint8; async like encode_parity_host."""
        rows = self._decode_rows_for(present, wanted)
        return apply_matrix_host(rows, shards[:, :self.data_shards, :],
                                 self.device)

    def reconstruct_batch_host_multi(self, chunks, present: Sequence[int],
                                     wanted: Optional[Sequence[int]] = None):
        """reconstruct_batch_host over a list of chunks sharing one
        survivor set, in order."""
        rows = self._decode_rows_for(present, wanted)
        return apply_matrix_host_multi(
            rows, [c[:, :self.data_shards, :] for c in chunks], self.device)

    def _decode_rows_for(self, present: Sequence[int],
                         wanted: Optional[Sequence[int]]) -> np.ndarray:
        """Default ``wanted`` to every missing shard and build the
        decode rows."""
        present = list(present)
        if wanted is None:
            wanted = sorted(set(range(self.total_shards)) - set(present))
        if not wanted:
            raise ValueError("nothing to reconstruct")
        return self.decode_matrix_rows(present, wanted)

    def encode_batch(self, data) -> torch.Tensor:
        """data (..., k, S) -> all shards (..., k+m, S)."""
        data = _as_tensor(data, self.device)
        return torch.cat([data, self.encode_parity(data)], dim=-2)

    def verify_batch(self, shards) -> bool:
        shards = _as_tensor(shards, self.device)
        parity = self.encode_parity(shards[..., :self.data_shards, :])
        return bool(torch.equal(parity, shards[..., self.data_shards:, :]))

    def decode_matrix_rows(self, present: Sequence[int],
                           wanted: Sequence[int]) -> np.ndarray:
        """Host-side coefficient rows that rebuild ``wanted`` shards from
        the shards listed in ``present`` (the first k of them are used).
        Rows for a wanted parity shard are its parity row composed with
        the decode matrix, so every missing shard comes out of one pass."""
        present = tuple(present)
        if len(present) < self.data_shards:
            raise TooFewShardsError(
                f"need {self.data_shards} shards, have {len(present)}")
        chosen = present[:self.data_shards]
        decode = self._decode_cache.get(chosen)
        if decode is None:
            decode = gf256.gf_matrix_invert(self.matrix[list(chosen), :])
            self._decode_cache[chosen] = decode
        rows = []
        for w in wanted:
            if w < self.data_shards:
                rows.append(decode[w])
            else:
                rows.append(gf256.gf_matmul(self.matrix[w][None, :],
                                            decode)[0])
        return np.stack(rows, axis=0)

    def reconstruct_batch(self, shards, present: Sequence[int],
                          wanted: Optional[Sequence[int]] = None
                          ) -> torch.Tensor:
        """``shards`` (B, len(present), S) uint8, ONLY the survivors in
        ``present`` order -> (B, len(wanted), S) on the device."""
        rows = self._decode_rows_for(present, wanted)
        shards = _as_tensor(shards, self.device)
        return apply_matrix(rows, shards[..., :self.data_shards, :],
                            self.device)

    # -- klauspost-style in-place list API ---------------------------------

    def encode(self, shards: list) -> None:
        if len(shards) != self.total_shards:
            raise ShardSizeError(
                f"expected {self.total_shards} shards, got {len(shards)}")
        if len({len(s) for s in shards}) != 1:
            raise ShardSizeError("shards have inconsistent sizes")
        data = np.stack([np.asarray(s, dtype=np.uint8)
                         for s in shards[:self.data_shards]])
        parity = self.encode_parity(data).cpu().numpy()
        for i in range(self.parity_shards):
            shards[self.data_shards + i][:] = parity[i]

    def verify(self, shards: Sequence) -> bool:
        return self.verify_batch(
            np.stack([np.asarray(s, dtype=np.uint8) for s in shards]))

    def reconstruct(self, shards: list, data_only: bool = False) -> None:
        if len(shards) != self.total_shards:
            raise ShardSizeError(
                f"expected {self.total_shards} shards, got {len(shards)}")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) == self.total_shards:
            return
        wanted = [i for i, s in enumerate(shards) if s is None
                  and (not data_only or i < self.data_shards)]
        if not wanted:
            return
        surv = np.stack([np.asarray(shards[i], dtype=np.uint8)
                         for i in present])
        rebuilt = self.reconstruct_batch(surv[None], present,
                                         wanted).cpu().numpy()[0]
        for i, buf in zip(wanted, rebuilt):
            shards[i] = buf

    def reconstruct_data(self, shards: list) -> None:
        self.reconstruct(shards, data_only=True)

    def split(self, data) -> list:
        """klauspost ``Split``: one buffer -> k data shards (last
        zero-padded) + m zeroed parity shards, ready for encode()."""
        buf = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data.astype(np.uint8)
        if buf.size == 0:
            raise ShardSizeError("cannot split empty buffer")
        per = -(-buf.size // self.data_shards)
        padded = np.zeros(per * self.data_shards, dtype=np.uint8)
        padded[:buf.size] = buf
        shards = [padded[i * per:(i + 1) * per].copy()
                  for i in range(self.data_shards)]
        shards += [np.zeros(per, dtype=np.uint8)
                   for _ in range(self.parity_shards)]
        return shards

    def join(self, shards: Sequence, size: int) -> bytes:
        """klauspost ``Join``: concatenate the k data shards, trim to
        ``size``."""
        if len(shards) < self.data_shards:
            raise TooFewShardsError("join needs all data shards")
        cat = np.concatenate([np.asarray(s, dtype=np.uint8)
                              for s in shards[:self.data_shards]])
        if cat.size < size:
            raise ShardSizeError("shards shorter than requested size")
        return cat[:size].tobytes()


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    return x.to(device=device, dtype=torch.uint8)
