"""Writeback overlap: positioned shard writes on a small thread pool.

The port of seaweedfs_tpu/pipeline/writeback.py, with its flight-recorder
events (a queued write, a retired one) and its crash point
(``crash.ec.writeback``), and without its race-checker and
buffer-checker hooks. Pool width, queue depth and preallocation come
from ``[pipeline]`` (pipe.current()).

Shard writes run off the pipeline's critical path: shard files are
preallocated to their final size up front, every row lands at a
deterministic offset (the stripe layout fixes them), so writes become
positional ``os.pwritev`` calls that a pool of writer threads retires
while the NEXT batch's transfer and compute are in flight.

Jobs for one path are routed to one worker (hash(path) % threads), so
a single file's writes never interleave across threads and per-fd
pwritev needs no locking; different files spread across the pool.

:class:`BatchToken` is a countdown latch the encode path uses to
recycle a pooled input buffer only after every write that still
references it has retired (data shards are zero-copy views into the
batch slab).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..util import faults
from . import flight


#: Linux UIO_MAXIOV; one pwritev can scatter at most this many
#: segments, longer row lists are chunked.
IOV_MAX = 1024

_END = object()


def preallocate(fd: int, size: int) -> None:
    """Reserve ``size`` bytes for ``fd`` so positional writes never
    grow the file incrementally (allocation persists across the whole
    encode instead of racing it). ``posix_fallocate`` where the OS has
    it, plain ``ftruncate`` otherwise (tmpfs, macOS)."""
    if size <= 0:
        return
    try:
        os.posix_fallocate(fd, 0, size)
    except (AttributeError, OSError):
        os.ftruncate(fd, size)


def pwrite_rows(fd: int, offset: int, rows: Sequence[np.ndarray]) -> int:
    """Write ``rows`` contiguously at ``offset`` via ``os.pwritev``,
    chunking at IOV_MAX; returns bytes written. Rows may be
    non-contiguous views — pwritev needs buffers, so those are
    materialized per-row (still no whole-batch gather copy)."""
    total = 0
    n = len(rows)
    i = 0
    while i < n:
        chunk = [r if r.flags["C_CONTIGUOUS"] else np.ascontiguousarray(r)
                 for r in rows[i:i + IOV_MAX]]
        want = sum(r.nbytes for r in chunk)
        wrote = os.pwritev(fd, chunk, offset + total)
        while wrote < want:
            # short write: retry the remainder (regular files rarely
            # short-write, but pwritev makes no promise)
            flat = b"".join(bytes(r) for r in chunk)[wrote:]
            wrote += os.pwrite(fd, flat, offset + total + wrote)
        total += want
        i += IOV_MAX
    return total


class BatchToken:
    """Countdown latch: fires ``on_done`` when ``expect`` registered
    writes have all retired. The encode path recycles its pooled input
    slab here — data-shard rows are views into it, so the buffer must
    outlive every pending write."""

    def __init__(self, expect: int, on_done: Callable[[], None]):
        self._lock = threading.Lock()
        self._left = expect
        self._on_done = on_done
        if expect <= 0:
            self._fire()

    def _fire(self) -> None:
        cb, self._on_done = self._on_done, None
        if cb is not None:
            cb()

    def done_one(self) -> None:
        with self._lock:
            self._left -= 1
            fire = self._left == 0
        if fire:  # callback outside the lock
            self._fire()


class WriterError(RuntimeError):
    pass


class WriterPool:
    """N writer threads retiring positioned shard writes.

    ``open_file`` registers a path once (O_CREAT|O_WRONLY, optionally
    preallocated); ``submit`` enqueues one positioned multi-row write.
    Queues are bounded — a slow disk backpressures the pipeline instead
    of buffering the whole volume in RAM. The first worker exception is
    re-raised from the next ``submit``/``close`` on the caller thread.
    """

    def __init__(self):
        from . import pipe as pipe_mod
        cfg = pipe_mod.current()
        self.threads = max(1, cfg.writer_threads)
        self._queues = [queue.Queue(maxsize=max(1, cfg.writer_queue_depth))
                        for _ in range(self.threads)]
        self._fds: dict[str, int] = {}
        self._errors: list[BaseException] = []
        self.busy_seconds = 0.0
        self._busy_lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._worker, args=(q,),
                             name=f"ec-writeback-{i}", daemon=True)
            for i, q in enumerate(self._queues)]
        for t in self._workers:
            t.start()

    # -- registration ----------------------------------------------------

    def open_file(self, path: str, size: int = 0) -> None:
        """Create/register ``path``; with ``size`` (and ``[pipeline]
        preallocate``) reserve its final length up front."""
        if path in self._fds:
            return
        from . import pipe as pipe_mod
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        if pipe_mod.current().preallocate:
            preallocate(fd, size)
        # open_file is a setup call: the fd is registered before any
        # write for it is submitted, so workers only READ the entry
        self._fds[path] = fd

    # -- job submission --------------------------------------------------

    def submit(self, path: str, offset: int,
               rows: Sequence[np.ndarray],
               token: Optional[BatchToken] = None) -> None:
        """Queue ``rows`` for a contiguous positioned write to ``path``
        at ``offset``. Raises :class:`WriterError` if a worker already
        failed."""
        if self._errors:
            self._raise()
        # crash point on the submitting thread: a crash here models
        # losing the process with shard slices already queued or
        # retired but the encode not yet acknowledged
        faults.check("crash.ec.writeback")
        fd = self._fds.get(path)
        if fd is None:
            raise WriterError(f"writeback: {path!r} not opened")
        q = self._queues[hash(path) % self.threads]
        if flight.armed():
            flight.record(flight.EV_WRITE_SUBMIT,
                          arg=sum(r.nbytes for r in rows))
        q.put((fd, offset, rows, token))

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Drain every queue, join workers, close fds. Raises the first
        worker error, if any."""
        for q in self._queues:
            q.put(_END)
        for t in self._workers:
            t.join()
        for fd in self._fds.values():
            try:
                os.close(fd)
            except OSError:  # best-effort close-all; first error re-raised below
                pass
        self._fds.clear()
        if self._errors:
            self._raise()

    def abort(self) -> None:
        """close() for failure paths: never raises."""
        try:
            self.close()
        except WriterError:  # failure path; the caller is already raising the original error
            pass

    def _raise(self) -> None:
        err = self._errors[0]
        raise WriterError(f"shard writeback failed: {err!r}") from err

    # -- worker ----------------------------------------------------------

    def _worker(self, q: queue.Queue) -> None:
        busy_acc = 0.0
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                fd, offset, rows, token = item
                if self._errors:
                    # fail fast but keep draining (and keep firing
                    # tokens so pooled buffers are not leaked on the
                    # error path)
                    if token is not None:
                        token.done_one()
                    continue
                t0 = time.perf_counter()
                try:
                    wrote = pwrite_rows(fd, offset, rows)
                    dt = time.perf_counter() - t0
                    flight.record(flight.EV_PWRITEV_RETIRE, value=dt,
                                  arg=wrote)
                    busy_acc += dt
                except BaseException as e:  # noqa: BLE001 — re-raised at submit/close
                    # list.append is GIL-atomic and the list is only
                    # drained after the workers join
                    self._errors.append(e)
                finally:
                    if token is not None:
                        token.done_one()
        finally:
            # one flush per worker lifetime: the counter is only read
            # after close() joins the workers
            with self._busy_lock:
                self.busy_seconds += busy_acc
