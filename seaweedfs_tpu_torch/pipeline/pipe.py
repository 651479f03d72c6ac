"""Overlapped ingest plane: host -> device -> host with buffer reuse.

The port of ``seaweedfs_tpu/pipeline/pipe.py``:

- a reader thread materializes host batches (``os.preadv`` straight into
  a pool of reusable buffers, :class:`HostBufferPool`) and feeds a
  depth-limited queue;
- the calling thread hands each batch to ``encode_fn``, which returns at
  once (on the card: an async copy, kernel and copy back on a side
  stream — ops/rs_torch.py); on one card, runs of batches already read
  share ONE dispatch (``encode_multi_fn``, ops/rs_torch.py
  ``apply_matrix_host_multi``: one kernel launch over the whole group),
  with a :class:`GroupController` sizing the group from measured stage
  latencies; with a ``prepare_fn`` (the mesh path) the stage splits into
  prepare and apply, and ``[pipeline] double_buffer`` issues the next
  batch's prepare before the current batch's apply;
- a writer thread calls ``np.asarray`` on the oldest result, which waits
  for THAT batch only while newer ones are still in flight, and hands the
  bytes to ``write_fn``.

On CUDA the pool buffers are pinned host memory, so the copies to and
from the card run asynchronously. Queue depths, batch bounds, writer
width and the group cap come from the ``[pipeline]`` TOML section
(:func:`configure_from`, the shell's ``-config``); :class:`PipelineConfig`'s
defaults are the only source of them. Every completed run is folded into
the process totals and a ring of recent runs (:func:`publish_stats`,
read by the shell's ``pipeline.status``), and every batch's lifecycle
goes to the flight recorder when it is armed (pipeline/flight.py), as it
is for any run a torch profile records (``flight.follow_profiler``). The
compute stage's wait on the reader (``reader_wait``) and the group
drain's wait (``group_wait``) are flight spans and :class:`PipeStats`
seconds of their own, beside the reader's ``pack`` (batch.py,
stripe.py).

Each batch's read, compute (its dispatch
share plus the wait on its result) and write land in the tracing series
``trace_request_stage_seconds{stage=pipe.read|pipe.compute|pipe.write}``
(``_stage_observe``). The race and buffer checkers hook in where the
JAX package hooks them (``SEAWEEDFS_TORCH_RACECHECK``,
``SEAWEEDFS_TORCH_BUFCHECK``, util/racecheck.py, util/bufcheck.py):
each pool buffer is registered, tagged on acquire and poisoned on
release, and the pool and each run's stats are registered with the race
checker, and so is a run's :class:`GroupController`. The pool's buffers
are page-aligned whole pages, so the buffer checker's ``protect`` mode
can close them.
A failed run publishes nothing here, where the JAX package folds its
partial stats into the totals.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from ..util import bufcheck, racecheck
from . import flight

# SEAWEEDFS_TORCH_FLIGHT=1 arms the recorder for any process that runs a
# pipeline; unset means every flight.record() below is one attribute
# load + None test.
flight.install_from_env()
# SEAWEEDFS_TORCH_BUFCHECK / _RACECHECK arm the checkers the same way;
# unset, every hook below is one module-flag test.
bufcheck.install_from_env()
racecheck.install_from_env()

#: Row-view shard writes need rows at least this long: below it the
#: per-row write overhead beats the strided gather-copy it avoids, so
#: smaller blocks take the copy path.
ROW_WRITE_MIN_BLOCK = 64 * 1024

_END = object()


# --------------------------------------------------------------------------
# configuration — the [pipeline] TOML section
# --------------------------------------------------------------------------

@dataclass
class PipelineConfig:
    """Tuning knobs of the overlapped ingest plane, at the JAX package's
    defaults. Flags > TOML > these defaults. ``0`` means "derive":
    ``group_cap`` defers to ``SEAWEEDFS_TORCH_DISPATCH_GROUP``,
    ``pool_buffers`` is sized from depth and group
    (:func:`pool_buffers`)."""

    depth: int = 2                           # stage-queue depth
    batch_bytes: int = 256 * 1024 * 1024     # max input bytes per batch
    # max input bytes per batch while grouping: the queues then hold up
    # to ``group`` batches each, so each batch shrinks to bound host memory
    grouped_batch_bytes: int = 64 * 1024 * 1024
    group_cap: int = 0                       # max batches per dispatch
    writer_threads: int = 4                  # shard-writeback pool width
    writer_queue_depth: int = 4              # pending jobs per writer
    pool_buffers: int = 0                    # reusable host buffers
    feedback: bool = True                    # stage-latency controller
    overlapped: bool = True                  # False = synchronous path
    preallocate: bool = True                 # size shard files up front
    double_buffer: bool = False              # one-deep H2D lookahead


_CONFIG = PipelineConfig()


def current() -> PipelineConfig:
    return _CONFIG


def configure(**kw) -> None:
    """Set config fields; None values keep their current setting."""
    for key, val in kw.items():
        if not hasattr(_CONFIG, key):
            raise TypeError(f"unknown pipeline config key {key!r}")
        if val is not None:
            cur = getattr(_CONFIG, key)
            setattr(_CONFIG, key, type(cur)(val))


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[pipeline]`` block (missing keys
    keep their current values; an unknown key raises ``TypeError``)."""
    from ..util import config as config_mod
    sect = config_mod.lookup(conf, "pipeline")
    if not isinstance(sect, dict):
        return
    configure(**sect)


def pick_grouped_dispatch(multi_fn, max_bytes: int,
                          cap_bytes: Optional[int] = None, device=None,
                          overlapped: Optional[bool] = None):
    """ONE grouping policy for the encode, rebuild and batcher pipelines
    on ``device`` (None = the card): returns (multi_fn or None, group,
    max_bytes).

    The group width is ``rs_torch.host_dispatch_group(device)`` — more
    than 1 only on one card whose batches no mesh splits — clamped by
    ``[pipeline] group_cap`` when set. When grouping is on, the per-item
    byte bound is clamped to ``cap_bytes`` (default: ``[pipeline]
    grouped_batch_bytes``). The synchronous path (``overlapped`` false;
    None = ``[pipeline] overlapped``) dispatches one batch at a time, so
    it never groups and keeps its bound, where the JAX package clamps
    it all the same: output bytes do not depend on the bound."""
    from ..ops import rs_torch
    if cap_bytes is None:
        cap_bytes = _CONFIG.grouped_batch_bytes
    if overlapped is None:
        overlapped = _CONFIG.overlapped
    group = rs_torch.host_dispatch_group(device) if overlapped else 1
    if _CONFIG.group_cap:
        group = min(group, _CONFIG.group_cap)
    if group <= 1:
        return None, 1, max_bytes
    return multi_fn, group, min(max_bytes, cap_bytes)


def pool_buffers(n_batches: int, lookahead: bool = False,
                 group: int = 1) -> int:
    """Reusable host buffers for a run of ``n_batches``: ``[pipeline]
    pool_buffers``, or one per queue slot on each side of the dispatch
    (``max(depth, group)`` deep, so a group can form) plus the batches
    being read and written — and one more for the batch the
    double-buffer lookahead holds. Never more buffers than batches, and
    with the lookahead at least two: the held batch is dispatched only
    once the next one has been read."""
    want = _CONFIG.pool_buffers or \
        max(4, max(_CONFIG.depth, group) + 2) + int(lookahead)
    if lookahead:
        want = max(want, 2)
    return max(1, min(want, n_batches))


def pread_into(fd: int, view: np.ndarray, offset: int) -> None:
    """Read exactly ``len(view)`` bytes of ``fd`` at ``offset`` straight
    into the buffer ``view`` (no intermediate copy)."""
    mv = memoryview(view)
    want, got = len(mv), 0
    while got < want:
        n = os.preadv(fd, [mv[got:]], offset + got)
        if n <= 0:
            raise EOFError(f"short read from fd {fd} at offset "
                           f"{offset + got}")
        got += n


def _page_aligned(nbytes: int, pinned: bool):
    """A tensor owning a page-aligned run of whole pages at least
    ``nbytes`` long: (tensor, the (nbytes,) view, the whole-page span).
    A page-locked allocation is tried at its exact page count first,
    since the card's host allocator rounds sizes up to a power of two
    and is page-aligned in practice."""
    page = bufcheck.PAGE
    span = -(-nbytes // page) * page
    for extra in ((0, page) if pinned else (page,)):
        t = torch.empty(span + extra, dtype=torch.uint8,
                        pin_memory=pinned)
        a = t.numpy()
        off = -a.ctypes.data % page
        if off + span <= a.nbytes:
            return t, a[off:off + nbytes], span
    raise AssertionError("a page of slack always aligns")


class HostBufferPool:
    """A fixed set of reusable host buffers, handed out as (nbytes,)
    uint8 numpy arrays. ``pinned`` buffers are page-locked
    (``torch.empty(..., pin_memory=True)``) so copies to the card are
    asynchronous DMA; otherwise plain memory. Every buffer starts on a
    page and owns whole pages (the buffer checker's ``protect`` mode
    closes them). ``acquire`` blocks when every buffer is in flight —
    that blocking IS the host-memory bound."""

    def __init__(self, nbytes: int, count: int, pinned: bool = False):
        if nbytes <= 0 or count <= 0:
            raise ValueError("nbytes and count must be positive")
        self.nbytes = nbytes
        self.count = count
        self._free: queue.Queue = queue.Queue()
        # the tensors own the memory the numpy views point into
        self._tensors = []
        for _ in range(count):
            t, buf, span = _page_aligned(nbytes, pinned)
            self._tensors.append(t)
            bufcheck.register(buf, t, pinned=pinned, span=span)
            self._free.put(buf)
        racecheck.register(self, "pipeline.HostBufferPool")

    def acquire(self, timeout: Optional[float] = None) -> np.ndarray:
        """A free buffer; blocks until one is recycled. Raises
        ``queue.Empty`` on timeout."""
        flight.record(flight.EV_POOL_WAIT)
        buf = self._free.get(timeout=timeout)
        bufcheck.on_acquire(buf)
        if flight.armed():
            occ = float(self.in_flight())
            flight.record(flight.EV_POOL_GOT, value=occ)
            flight.record(flight.EV_POOL_OCC, value=occ)
        return buf

    def release(self, buf: np.ndarray) -> None:
        """Return a buffer obtained from :meth:`acquire`."""
        bufcheck.on_release(buf)
        self._free.put(buf)
        if flight.armed():
            occ = float(self.in_flight())
            flight.record(flight.EV_RECYCLE, value=occ)
            flight.record(flight.EV_POOL_OCC, value=occ)

    def in_flight(self) -> int:
        return self.count - self._free.qsize()


# --------------------------------------------------------------------------
# stage metrics and the ring of recent runs
# --------------------------------------------------------------------------

@dataclass
class PipeStats:
    """Per-run stage accounting. Each field is written by exactly one
    stage thread and read after the join, so no locking is needed."""

    batches: int = 0
    groups: int = 0                 # compute dispatch steps
    max_group: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    read_seconds: float = 0.0       # batch materialization (reader)
    dispatch_seconds: float = 0.0   # encode_fn enqueue (calling thread)
    sync_seconds: float = 0.0       # np.asarray device wait (writer)
    write_seconds: float = 0.0      # write_fn + positioned writes
    wall_seconds: float = 0.0
    # the port's host stages that can hold the card (flight spans of the
    # same names)
    pack_seconds: float = 0.0       # copies into fresh batches (reader)
    pack_bytes: int = 0             # bytes those copies moved (reader)
    reader_wait_seconds: float = 0.0  # compute stage on the read queue
    group_wait_seconds: float = 0.0   # the group drain's waits (compute)

    @property
    def compute_seconds(self) -> float:
        """Device-side stage time: dispatch + the D2H sync wait."""
        return self.dispatch_seconds + self.sync_seconds

    def stage_seconds(self) -> dict:
        """The reader/compute/writer breakdown."""
        return {"read": round(self.read_seconds, 6),
                "compute": round(self.compute_seconds, 6),
                "write": round(self.write_seconds, 6),
                "wall": round(self.wall_seconds, 6)}

    def to_dict(self) -> dict:
        d = self.stage_seconds()
        d.update(batches=self.batches, groups=self.groups,
                 max_group=self.max_group, bytes_in=self.bytes_in,
                 bytes_out=self.bytes_out,
                 dispatch_seconds=round(self.dispatch_seconds, 6),
                 sync_seconds=round(self.sync_seconds, 6),
                 pack_seconds=round(self.pack_seconds, 6),
                 pack_bytes=self.pack_bytes,
                 reader_wait_seconds=round(self.reader_wait_seconds, 6),
                 group_wait_seconds=round(self.group_wait_seconds, 6))
        if self.wall_seconds > 0:
            d["gibps"] = round(
                self.bytes_in / (1 << 30) / self.wall_seconds, 3)
        return d


#: Process-lifetime totals + a short ring of completed-run snapshots,
#: printed by the pipeline.status shell command.
_TELEMETRY_LOCK = threading.Lock()
_TOTALS = {"runs": 0, "batches": 0, "bytes_in": 0, "bytes_out": 0,
           "read_seconds": 0.0, "compute_seconds": 0.0,
           "write_seconds": 0.0, "wall_seconds": 0.0}
RECENT: deque = deque(maxlen=8)


def publish_stats(stats: PipeStats, kind: str = "pipe") -> None:
    """Fold one completed run into the process totals + recent ring."""
    with _TELEMETRY_LOCK:
        _TOTALS["runs"] += 1
        _TOTALS["batches"] += stats.batches
        _TOTALS["bytes_in"] += stats.bytes_in
        _TOTALS["bytes_out"] += stats.bytes_out
        _TOTALS["read_seconds"] += stats.read_seconds
        _TOTALS["compute_seconds"] += stats.compute_seconds
        _TOTALS["write_seconds"] += stats.write_seconds
        _TOTALS["wall_seconds"] += stats.wall_seconds
        entry = {"kind": kind}
        entry.update(stats.to_dict())
        RECENT.append(entry)


def last_run() -> Optional[dict]:
    """Most recent completed run's snapshot."""
    with _TELEMETRY_LOCK:
        return dict(RECENT[-1]) if RECENT else None


def debug_payload() -> dict:
    """Totals + the recent-run ring."""
    with _TELEMETRY_LOCK:
        out = {k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in _TOTALS.items()}
        out["recent"] = [dict(e) for e in RECENT]
    return out


def reset_telemetry() -> None:
    """Drop totals and the recent ring (tests)."""
    with _TELEMETRY_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0 if isinstance(_TOTALS[k], int) else 0.0
        RECENT.clear()


#: Open step records (:func:`recording_steps`): (thread ident or None,
#: the list the steps go to). Empty, a dispatch step records nothing.
_STEP_SINKS: list = []
_STEP_LOCK = threading.Lock()


@contextlib.contextmanager
def recording_steps(this_thread: bool = False):
    """Record the dispatch steps of every pipeline run while the block is
    open (with ``this_thread``, only the steps the calling thread
    dispatches). Yields a list that gains, per step, the tuple of the
    shapes of the batches dispatched together: one batch on the
    ungrouped paths, a group on the drain. From it a caller works out
    the kernel runs those steps make on the host-slab path (one per
    stretch of equal shapes, ops/rs_torch.py) apart from the kernels'
    own launch counts."""
    sink: list = []
    entry = (threading.get_ident() if this_thread else None, sink)
    with _STEP_LOCK:
        _STEP_SINKS.append(entry)
    try:
        yield sink
    finally:
        with _STEP_LOCK:
            _STEP_SINKS.remove(entry)


def _note_step(batches) -> None:
    """One dispatch step of ``batches``, to every open record."""
    if not _STEP_SINKS:
        return
    shapes = tuple(tuple(np.shape(b)) for b in batches)
    me = threading.get_ident()
    with _STEP_LOCK:
        for who, sink in _STEP_SINKS:
            if who is None or who == me:
                sink.append(shapes)


#: stage name -> latency histogram + bytes counter in the tracing
#: metrics family, so the pipeline's stage breakdown lands in the same
#: ``trace_request_stage_seconds{stage=...}`` series every other
#: subsystem reports into. Cached like tracing._INSTRUMENTS: plain
#: dict, a rare double-create just wins the same registry entry.
_STAGE_INSTRUMENTS: dict = {}


def _stage_observe(stage: str, seconds: float, nbytes: int = 0) -> None:
    tup = _STAGE_INSTRUMENTS.get(stage)
    if tup is None:
        from ..util import tracing
        tup = (tracing.METRICS.histogram("request_stage_seconds",
                                         stage=stage),
               tracing.METRICS.counter("stage_bytes_total", stage=stage))
        _STAGE_INSTRUMENTS[stage] = tup
    tup[0].observe(seconds)
    if nbytes:
        tup[1].inc(nbytes)


# --------------------------------------------------------------------------
# feedback controller for grouped dispatch
# --------------------------------------------------------------------------

class GroupController:
    """Sizes grouped dispatch from measured stage latencies, as the JAX
    package's does (the same constants and hill-climb, so the same notes
    give the same widths).

    Wider groups pay one launch, one copy back and one event for more
    slabs, but only when the reader keeps a group's worth of batches
    queued, and only while the per-batch dispatch cost keeps falling with
    the width:

    - after each dispatch, EWMA the per-BATCH dispatch seconds at that
      width; widen (x2, up to the cap) while wider stays cheaper per
      batch, back off when it measures worse than half the width;
    - when the reader repeatedly can't fill the current target
      (starvation), halve the target.

    ``wait_seconds`` bounds how long the compute stage may block for one
    more batch while a group forms: one EWMA read latency, capped.
    """

    WAIT_CAP = 0.05        # never stall dispatch more than this per slot
    ALPHA = 0.4            # EWMA weight for new measurements
    WORSE = 1.05           # hysteresis: "wider got worse" margin

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self.width = min(2, self.cap)
        self._per_batch: dict[int, float] = {}
        self._ewma_read = 0.0
        self._starve = 0.0
        racecheck.register(self, "pipeline.GroupController")

    def note_read(self, seconds: float) -> None:
        self._ewma_read = seconds if not self._ewma_read else \
            (1 - self.ALPHA) * self._ewma_read + self.ALPHA * seconds

    def note_dispatch(self, seconds: float, width: int) -> None:
        width = max(1, width)
        pb = seconds / width
        cur = self._per_batch.get(width)
        self._per_batch[width] = pb if cur is None else \
            (1 - self.ALPHA) * cur + self.ALPHA * pb
        half = self._per_batch.get(max(1, width // 2))
        if width > 1 and half is not None \
                and self._per_batch[width] > half * self.WORSE:
            self.width = max(1, width // 2)
        elif width >= self.width and self._starve < 0.5:
            self.width = min(self.cap, max(width, self.width) * 2)

    def note_starved(self) -> None:
        self._starve = (1 - self.ALPHA) * self._starve + self.ALPHA
        if self._starve > 0.8:
            self.width = max(1, self.width // 2)

    def note_supplied(self) -> None:
        self._starve = (1 - self.ALPHA) * self._starve

    def target(self) -> int:
        return self.width

    def wait_seconds(self) -> float:
        if self.width <= 1:
            return 0.0
        return min(self._ewma_read or self.WAIT_CAP, self.WAIT_CAP)


class PipelineError(RuntimeError):
    pass


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

def run_pipeline(batches: Iterable[tuple[Any, np.ndarray]],
                 encode_fn: Callable[[Any], Any],
                 write_fn: Callable[[Any, np.ndarray, np.ndarray], None],
                 recycle_fn: Optional[
                     Callable[[Any, np.ndarray], None]] = None,
                 stats: Optional[PipeStats] = None,
                 overlapped: Optional[bool] = None,
                 kind: str = "pipe",
                 publish: bool = True,
                 prepare_fn: Optional[Callable[[np.ndarray], Any]] = None,
                 encode_multi_fn: Optional[Callable[[list], list]] = None,
                 group: int = 1,
                 controller: Optional[GroupController] = None) -> int:
    """Drive (meta, host_batch) items through ``encode_fn`` with
    read/compute/write overlap.

    ``encode_fn(batch)`` returns an async result (or a host array);
    ``write_fn(meta, batch, result_np)`` runs on the writer thread in
    FIFO order; ``recycle_fn(meta, batch)``, when given, runs after
    ``write_fn`` returns — the hook pooled readers use to hand buffers
    back, and the one every failure path calls for batches whose write
    never ran. Returns the number of batches written. Exceptions from
    any stage propagate as :class:`PipelineError`.

    ``prepare_fn(batch)``, when given, splits the compute stage in two:
    its return value (the mesh path's placed batch,
    parallel/mesh.encode_step_fns) is what ``encode_fn`` receives. With
    ``[pipeline] double_buffer`` the overlapped path issues the NEXT
    batch's ``prepare_fn`` before the CURRENT batch's ``encode_fn``, so
    its copy to the card overlaps the current product; the synchronous
    path runs prepare and encode back to back, so output bytes are the
    same either way.

    When ``encode_multi_fn`` is given with ``group > 1``, the compute
    stage of the overlapped path drains up to a target number of batches
    already read and dispatches them together (``encode_multi_fn(list of
    batches)`` returns their results in order; on the card one launch
    covers them). The target comes from a :class:`GroupController` fed
    with the stage latencies (``[pipeline] feedback``; pass
    ``controller`` to share one across runs), which may wait a bounded
    time for a group to form; with ``feedback = false`` the drain is
    greedy and never waits. The queues grow to ``group`` deep so groups
    CAN form. Grouping and ``prepare_fn`` exclude each other (grouping
    is the one-card lever, the split the mesh's): asking for both raises
    ``ValueError``.

    ``overlapped=False`` (or ``[pipeline] overlapped = false``) runs the
    same stages inline on the calling thread, one batch per dispatch:
    the synchronous path whose output bytes the overlapped one must
    match.

    ``stats`` receives the stage breakdown; a run that completes is also
    folded into the process totals under ``kind`` unless ``publish`` is
    False (the file paths publish after their writeback time is folded
    in). A failed run publishes nothing.
    """
    cfg = _CONFIG
    if overlapped is None:
        overlapped = cfg.overlapped
    st = stats if stats is not None else PipeStats()
    racecheck.register(st, "pipeline.PipeStats")
    grouping = encode_multi_fn is not None and group > 1
    if grouping and prepare_fn is not None:
        raise ValueError(
            "prepare_fn cannot combine with grouped dispatch (grouping "
            "is one-card only; the prepare/apply split is the mesh "
            "path)")
    if grouping and controller is None and cfg.feedback:
        controller = GroupController(group)
    t_wall = time.perf_counter()
    # a torch profile of the run carries its host stages: arm a ring for
    # it when nothing else did (one attribute read per run; a torch that
    # lacks the private attribute only loses the profile-following ring)
    flight.follow_profiler(
        getattr(torch.autograd.profiler, "_is_profiler_enabled", False))
    flight.record(flight.EV_RUN_START, arg=hash(kind) & 0x7FFFFFFF)
    done = False
    try:
        if not overlapped:
            n = _run_sync(batches, encode_fn, write_fn, recycle_fn, st,
                          prepare_fn)
        else:
            n = _run_overlapped(batches, encode_fn, write_fn, cfg.depth,
                                recycle_fn, st, prepare_fn,
                                cfg.double_buffer and prepare_fn is not None,
                                encode_multi_fn if grouping else None,
                                group, controller)
        done = True
    finally:
        st.wall_seconds = time.perf_counter() - t_wall
        # the end marker closes analyze()'s window whether or not the
        # run completed
        flight.record(flight.EV_RUN_END)
        if publish and done:
            publish_stats(st, kind=kind)
        if flight.armed():
            # end-of-run fold into the seaweed_pipeline_* gauges and the
            # flight payload — never on the hot path, and never allowed
            # to fail the run it observed
            try:
                flight.publish_run_gauges()
            except Exception:  # noqa: BLE001  # seaweedlint: disable=SW301 — observability must not fail the observed run
                pass
        # stage threads are joined: a later run may legitimately drive
        # the same stats object from another thread
        racecheck.quiesce(st)
    return n


def _batch_nbytes(batch) -> int:
    return getattr(batch, "nbytes", 0)


def _record_depth(q: queue.Queue, which: int) -> None:
    """Queue-depth counter event (``which``: 0 = read queue, 1 = write
    queue); the depth is only read when the recorder is armed."""
    if flight.armed():
        flight.record(flight.EV_QDEPTH, value=float(q.qsize()), arg=which)


def _run_sync(batches, encode_fn, write_fn, recycle_fn, st: PipeStats,
              prepare_fn=None) -> int:
    """The synchronous reference path: same stages, one thread (prepare
    runs immediately before encode, so the split changes nothing here —
    that is what makes it the byte-identity oracle for the
    double-buffered path)."""
    it = iter(batches)
    while True:
        seq = st.batches
        flight.record(flight.EV_READ_START, batch=seq)
        t0 = time.perf_counter()
        try:
            meta, batch = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        st.read_seconds += t1 - t0
        flight.record(flight.EV_READ_END, batch=seq,
                      arg=_batch_nbytes(batch))
        _stage_observe("pipe.read", t1 - t0, _batch_nbytes(batch))
        try:
            flight.record(flight.EV_DISPATCH, batch=seq)
            result = encode_fn(batch if prepare_fn is None
                               else prepare_fn(batch))
            t2 = time.perf_counter()
            st.dispatch_seconds += t2 - t1
            flight.record(flight.EV_DISPATCH_DONE, batch=seq, arg=1)
            _note_step((batch,))
            flight.record(flight.EV_SYNC_START, batch=seq)
            result_np = np.asarray(result)
            t3 = time.perf_counter()
            st.sync_seconds += t3 - t2
            flight.record(flight.EV_SYNC_END, batch=seq,
                          arg=result_np.nbytes)
            _stage_observe("pipe.compute", t3 - t1, result_np.nbytes)
            flight.record(flight.EV_WRITE_START, batch=seq)
            write_fn(meta, batch, result_np)
        except Exception as e:
            if recycle_fn is not None:
                recycle_fn(meta, batch)
            raise PipelineError(f"pipeline stage failed: {e!r}") from e
        if recycle_fn is not None:
            recycle_fn(meta, batch)
        dt = time.perf_counter() - t3
        st.write_seconds += dt
        flight.record(flight.EV_WRITE_END, batch=seq)
        _stage_observe("pipe.write", dt)
        # seaweedlint: disable=SW801 — single driver per stats object
        st.batches += 1
        # seaweedlint: disable=SW801 — same single-driver contract
        st.groups += 1
        # seaweedlint: disable=SW801 — same single-driver contract
        st.max_group = max(st.max_group, 1)
        # seaweedlint: disable=SW801 — same single-driver contract
        st.bytes_in += _batch_nbytes(batch)
        # seaweedlint: disable=SW801 — same single-driver contract
        st.bytes_out += result_np.nbytes
    return st.batches


def _run_overlapped(batches, encode_fn, write_fn, depth, recycle_fn,
                    st: PipeStats, prepare_fn=None,
                    lookahead: bool = False, encode_multi_fn=None,
                    group: int = 1,
                    controller: Optional[GroupController] = None) -> int:
    if encode_multi_fn is not None:
        depth = max(depth, group)
    read_q: queue.Queue = queue.Queue(maxsize=depth)
    write_q: queue.Queue = queue.Queue(maxsize=depth)
    errors: list[BaseException] = []
    stop = threading.Event()

    def recycle_quietly(meta, batch):
        # failure paths: the first error is already recorded, so a
        # recycle failure here must not mask it
        if recycle_fn is not None:
            try:
                recycle_fn(meta, batch)
            except Exception:  # noqa: BLE001  # seaweedlint: disable=SW301 — best-effort recycle on a failure path; the first error is already recorded
                pass

    def fail(e: BaseException, drop) -> None:
        # a compute-stage failure: record it, stop the stages, and
        # recycle every batch it held so a pooled reader blocked on
        # acquire() can drain out
        errors.append(e)
        stop.set()
        for meta, batch in drop:
            recycle_quietly(meta, batch)

    # Per-stage batch sequence numbers for the flight recorder: every
    # queue between stages is FIFO and grouping and the lookahead keep
    # order,
    # so the reader's n-th batch IS the compute stage's n-th and the
    # writer's n-th.
    def reader():
        seq = 0
        try:
            it = iter(batches)
            while not stop.is_set():
                flight.record(flight.EV_READ_START, batch=seq)
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                dt = time.perf_counter() - t0
                st.read_seconds += dt
                flight.record(flight.EV_READ_END, batch=seq,
                              arg=_batch_nbytes(item[1]))
                seq += 1
                _stage_observe("pipe.read", dt, _batch_nbytes(item[1]))
                if controller is not None:
                    controller.note_read(dt)
                read_q.put(item)
                _record_depth(read_q, 0)
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)
            stop.set()
        finally:
            read_q.put(_END)

    def writer():
        seq = 0
        while True:
            item = write_q.get()
            if item is _END:
                return
            _record_depth(write_q, 1)
            meta, batch, result, disp_share = item
            if stop.is_set():
                recycle_quietly(meta, batch)
                continue
            try:
                flight.record(flight.EV_SYNC_START, batch=seq)
                t0 = time.perf_counter()
                result_np = np.asarray(result)
                t1 = time.perf_counter()
                st.sync_seconds += t1 - t0
                flight.record(flight.EV_SYNC_END, batch=seq,
                              arg=result_np.nbytes)
                # the batch's compute stage: its dispatch share plus the
                # wait on its result (the card's event, on CUDA)
                _stage_observe("pipe.compute", disp_share + (t1 - t0),
                               result_np.nbytes)
                flight.record(flight.EV_WRITE_START, batch=seq)
                write_fn(meta, batch, result_np)
                if recycle_fn is not None:
                    recycle_fn(meta, batch)
                dt = time.perf_counter() - t1
                st.write_seconds += dt
                flight.record(flight.EV_WRITE_END, batch=seq)
                _stage_observe("pipe.write", dt)
                seq += 1
                st.batches += 1
                st.bytes_in += _batch_nbytes(batch)
                st.bytes_out += result_np.nbytes
            except BaseException as e:  # noqa: BLE001 — re-raised by the caller
                # BaseException: a crash point's simulated crash too, as
                # in the JAX writer; a dead writer thread would let the
                # run end as if every write had landed
                errors.append(e)
                stop.set()
                recycle_quietly(meta, batch)

    def dispatch(meta, batch, payload, t0) -> None:
        # one batch's encode_fn (a failure drops it and the batch the
        # lookahead holds), then the result goes to the writer in FIFO
        # order
        nonlocal cseq, pending
        flight.record(flight.EV_DISPATCH, batch=cseq)
        try:
            result = encode_fn(payload)
        except Exception as e:  # noqa: BLE001 — see fail()
            drop = [(meta, batch)]
            if pending is not None:
                drop.append(pending[:2])
                pending = None
            fail(e, drop)
            return
        flight.record(flight.EV_DISPATCH_DONE, batch=cseq, arg=1)
        _note_step((batch,))
        cseq += 1
        disp = time.perf_counter() - t0
        st.dispatch_seconds += disp
        st.groups += 1
        st.max_group = 1
        write_q.put((meta, batch, result, disp))
        _record_depth(write_q, 1)

    def dispatch_group(item) -> bool:
        # the group drain: whatever is already queued, plus — while the
        # controller's measured amortization pays for it — a bounded
        # wait for the group to fill to its target; one encode_multi_fn
        # call for the lot. True when the reader's end marker was taken.
        nonlocal cseq
        target = min(group, controller.target()) if controller else group
        items, ended = [item], False
        waited = None   # host clock at the drain's first wait
        while len(items) < target:
            try:
                nxt = read_q.get_nowait()
            except queue.Empty:
                wait = controller.wait_seconds() if controller else 0.0
                if wait > 0.0 and waited is None:
                    flight.record(flight.EV_GROUP_WAIT)
                    waited = time.perf_counter()
                try:
                    nxt = read_q.get(timeout=wait) if wait > 0.0 \
                        else read_q.get_nowait()
                except queue.Empty:
                    if controller is not None:
                        controller.note_starved()
                    break
            if nxt is _END:
                ended = True
                break
            items.append(nxt)
        if waited is not None:
            st.group_wait_seconds += time.perf_counter() - waited
            flight.record(flight.EV_GROUP_DONE, arg=len(items))
        if controller is not None and len(items) >= target:
            controller.note_supplied()
        if stop.is_set():
            for it in items:
                recycle_quietly(*it)
            return ended
        t0 = time.perf_counter()
        flight.record(flight.EV_DISPATCH, batch=cseq)
        try:
            results = encode_multi_fn([b for _, b in items])
        except Exception as e:  # noqa: BLE001 — see fail()
            fail(e, items)
            return ended
        disp = time.perf_counter() - t0
        st.dispatch_seconds += disp
        flight.record(flight.EV_DISPATCH_DONE, batch=cseq, arg=len(items))
        _note_step([b for _, b in items])
        cseq += len(items)
        st.groups += 1
        st.max_group = max(st.max_group, len(items))
        if controller is not None:
            controller.note_dispatch(disp, len(items))
        share = disp / len(items)
        for (meta, batch), result in zip(items, results):
            write_q.put((meta, batch, result, share))
            _record_depth(write_q, 1)
        return ended

    rt = threading.Thread(target=reader, name="ec-pipe-read", daemon=True)
    wt = threading.Thread(target=writer, name="ec-pipe-write", daemon=True)
    rt.start()
    wt.start()
    cseq = 0
    #: the double-buffer lookahead: the one (meta, batch, prepared) whose
    #: copy to the card is in flight while the previous batch computes;
    #: flushed after the loop
    pending = None
    try:
        while True:
            flight.record(flight.EV_READER_WAIT)
            t0 = time.perf_counter()
            item = read_q.get()
            st.reader_wait_seconds += time.perf_counter() - t0
            flight.record(flight.EV_READER_GOT)
            if item is _END:
                break
            if stop.is_set():
                # a later stage failed: drain the reader, recycling so a
                # pooled reader blocked on acquire() can finish
                recycle_quietly(*item)
                continue
            if encode_multi_fn is not None:
                if dispatch_group(item):
                    break
                continue
            meta, batch = item
            t0 = time.perf_counter()
            try:
                payload = batch if prepare_fn is None else prepare_fn(batch)
            except Exception as e:  # noqa: BLE001 — see fail()
                drop = [(meta, batch)]
                if pending is not None:
                    drop.append(pending[:2])
                    pending = None
                fail(e, drop)
                continue
            if lookahead:
                # the batch just prepared has its copy in flight:
                # dispatch the PREVIOUS prepared batch so its product
                # overlaps this copy
                pending, prev = (meta, batch, payload), pending
                if prev is None:
                    st.dispatch_seconds += time.perf_counter() - t0
                    continue
                meta, batch, payload = prev
            dispatch(meta, batch, payload, t0)
        # flush the double-buffer tail: the last prepared batch has no
        # successor to overlap with
        if pending is not None:
            meta, batch, payload = pending
            pending = None
            if stop.is_set():
                recycle_quietly(meta, batch)
            else:
                dispatch(meta, batch, payload, time.perf_counter())
    finally:
        if pending is not None:
            recycle_quietly(*pending[:2])
        write_q.put(_END)
        wt.join()
        stop.set()
        # unblock a reader waiting on a full queue and recycle what it
        # had already materialized
        while rt.is_alive() or not read_q.empty():
            try:
                item = read_q.get(timeout=0.05)
            except queue.Empty:  # seaweedlint: disable=SW301 — empty queue: poll again until the reader has exited
                continue
            if item is not _END:
                recycle_quietly(*item)
        rt.join()
    if errors:
        raise PipelineError(
            f"pipeline stage failed: {errors[0]!r}") from errors[0]
    return st.batches
