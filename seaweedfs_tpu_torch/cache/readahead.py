"""Sequential-read detection + async read-ahead (docs/workloads.md).

The checkpoint/dataloader workloads (ckpt/) are dominated by large
sequential scans: a restore range-reads consecutive shard ranges, a
dataloader streams object after object. Every hop in that path (mount
ReadPages, the S3 gateway's ranged-GET block cache) sees the same
shape — reads marching forward through a byte stream — and the fetch
behind it (filer -> volume HTTP, or the cache disk tier) has real
latency worth hiding.

:class:`ReadaheadWindow` is the pure detector: it watches (offset,
length) reads on one stream, and once ``confirm`` consecutive reads
continue sequentially it opens a prefetch window that DOUBLES each
time the reader catches up with the prefetched frontier (classic OS
readahead ramp), up to ``max_units``. A seek collapses the window;
sequential behavior must be re-proven. The detector only *plans*
prefetches — consumers issue them through the shared
:class:`Prefetcher` (a small bounded daemon pool) and account hits
and waste with :func:`note_hit` / :func:`note_wasted`.

Counters (``seaweed_readahead_*``, surfaced by ``cache.status`` and
/metrics):

- ``seaweed_readahead_windows_opened_total`` — streams that proved
  sequential and opened a window
- ``seaweed_readahead_prefetch_total`` / ``_prefetch_bytes_total`` —
  prefetch spans issued and their bytes
- ``seaweed_readahead_hits_total`` — reads served from prefetched data
- ``seaweed_readahead_wasted_total`` — prefetched spans evicted or
  invalidated without ever serving a read
- ``seaweed_readahead_dropped_total`` — prefetch plans shed because
  the prefetcher queue was saturated (back-pressure, not an error)

The port of ``seaweedfs_tpu/cache/readahead.py``, whole.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from ..util import glog
from ..util.stats import Metrics

METRICS = Metrics(namespace="seaweed")

_M_OPENED = METRICS.counter("readahead_windows_opened_total")
_M_PREFETCH = METRICS.counter("readahead_prefetch_total")
_M_PREFETCH_BYTES = METRICS.counter("readahead_prefetch_bytes_total")
_M_HITS = METRICS.counter("readahead_hits_total")
_M_WASTED = METRICS.counter("readahead_wasted_total")
_M_DROPPED = METRICS.counter("readahead_dropped_total")

_OPEN_LOCK = threading.Lock()
_OPEN_WINDOWS = 0


def note_hit(n: int = 1) -> None:
    """A read was served from prefetched data."""
    _M_HITS.inc(n)


def note_wasted(n: int = 1) -> None:
    """Prefetched data was evicted/invalidated without serving."""
    _M_WASTED.inc(n)


def stats() -> dict:
    """Process-wide readahead counters for ``cache.status``."""
    with _OPEN_LOCK:
        open_now = _OPEN_WINDOWS
    return {
        "windows_open": open_now,
        "windows_opened": int(_M_OPENED.value),
        "prefetch_issued": int(_M_PREFETCH.value),
        "prefetch_bytes": int(_M_PREFETCH_BYTES.value),
        "prefetch_hits": int(_M_HITS.value),
        "prefetch_wasted": int(_M_WASTED.value),
        "prefetch_dropped": int(_M_DROPPED.value),
    }


class ReadaheadWindow:
    """Sequential detector + doubling window for ONE byte stream.

    Pure bookkeeping — no I/O, no threads, not itself thread-safe
    (each consumer guards its own instance). ``observe(offset,
    length)`` returns a ``(prefetch_offset, prefetch_bytes)`` span to
    issue, or None. Spans are unit-aligned and never overlap a span
    already planned for this stream (``_frontier`` tracks how far
    ahead prefetch has been issued).
    """

    __slots__ = ("unit", "initial_units", "max_units", "confirm",
                 "_expected", "_streak", "_window", "_frontier",
                 "_ramp_at", "_open")

    def __init__(self, *, unit: int = 128 * 1024,
                 initial_units: int = 2, max_units: int = 64,
                 confirm: int = 2):
        self.unit = max(1, int(unit))
        self.initial_units = max(1, int(initial_units))
        self.max_units = max(self.initial_units, int(max_units))
        self.confirm = max(1, int(confirm))
        self._expected: Optional[int] = None
        self._streak = 0
        self._window = 0          # current window, in units
        self._frontier = 0        # absolute offset prefetched up to
        self._ramp_at = 0         # end offset at which to double
        self._open = False

    @property
    def is_open(self) -> bool:
        return self._open

    @property
    def window_units(self) -> int:
        return self._window

    def _close(self) -> None:
        global _OPEN_WINDOWS
        if self._open:
            self._open = False
            with _OPEN_LOCK:
                _OPEN_WINDOWS -= 1

    def close(self) -> None:
        """Stream is done (handle closed / stream evicted)."""
        self._close()
        self._expected = None
        self._streak = 0
        self._window = 0

    def observe(self, offset: int, length: int,
                size: Optional[int] = None):
        """Record one read; returns (prefetch_offset, prefetch_bytes)
        or None. ``size`` (when known) clamps the plan at EOF.

        A read is "sequential" when it starts where the last one
        ended, give or take one unit (page-aligned consumers re-read
        a partial tail page; that must not break the streak).
        """
        global _OPEN_WINDOWS
        if length <= 0:
            return None
        end = offset + length
        if self._expected is not None and \
                abs(offset - self._expected) <= self.unit:
            self._streak += 1
        else:
            # first read of the stream, or a seek: reset
            self._close()
            self._streak = 0
            self._window = 0
            self._frontier = end
            self._expected = end
            return None
        self._expected = max(end, self._expected)
        if self._streak < self.confirm:
            return None
        if self._window == 0:
            self._window = self.initial_units
            self._open = True
            with _OPEN_LOCK:
                _OPEN_WINDOWS += 1
            _M_OPENED.inc()
            self._ramp_at = end + self._window * self.unit
        elif end >= self._ramp_at:
            # the reader consumed a full window's worth while staying
            # sequential: ramp up (classic OS readahead doubling)
            self._window = min(self._window * 2, self.max_units)
            self._ramp_at = end + self._window * self.unit
        start = max(end, self._frontier)
        # Align the span outward to unit boundaries. Aligning start
        # DOWN may re-cover a partial unit of the previous plan (the
        # consumers' cache checks dedupe that); clamping it back up to
        # an UNALIGNED _frontier must never happen — consumers file
        # blob slices under start//unit indexes, so an unaligned start
        # would cache wrong bytes under wrong pages.
        start = (start // self.unit) * self.unit
        stop = end + self._window * self.unit
        stop = -(-stop // self.unit) * self.unit
        if size is not None:
            stop = min(stop, size)
        if stop <= start:
            return None
        self._frontier = stop
        return start, stop - start


class Prefetcher:
    """Small shared daemon pool running prefetch thunks.

    Bounded queue; a saturated queue DROPS new plans (counted) rather
    than blocking the foreground read — read-ahead is an optimization,
    never back-pressure on the hot path. In-flight keys are deduped so
    two streams over the same blocks don't double-fetch.
    """

    def __init__(self, workers: int = 2, depth: int = 16):
        self.workers = max(1, int(workers))
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._inflight: set = set()
        self._lock = threading.Lock()
        self._started = False

    def _ensure_threads(self) -> None:
        if self._started:
            return
        with self._lock:
            if self._started:
                return
            for i in range(self.workers):
                t = threading.Thread(target=self._run, daemon=True,
                                     name=f"readahead-{i}")
                t.start()
            self._started = True

    def _run(self) -> None:
        while True:
            key, fn = self._q.get()
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — advisory work
                glog.v(1, "readahead prefetch failed: %s", e)
            finally:
                with self._lock:
                    self._inflight.discard(key)

    def submit(self, key, fn: Callable[[], None]) -> bool:
        """Queue one prefetch thunk; False when deduped or shed."""
        with self._lock:
            if key in self._inflight:
                return False
            self._inflight.add(key)
        try:
            self._q.put_nowait((key, fn))
        except queue.Full:
            with self._lock:
                self._inflight.discard(key)
            _M_DROPPED.inc()
            return False
        self._ensure_threads()
        return True

    def pending(self) -> int:
        return self._q.qsize()


_shared_lock = threading.Lock()
_shared: Optional[Prefetcher] = None


def shared_prefetcher() -> Prefetcher:
    """The process-wide prefetch pool (mount handles + gateway)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = Prefetcher()
        return _shared


def record_prefetch(nbytes: int) -> None:
    """One prefetch span actually fetched (issued by a consumer)."""
    _M_PREFETCH.inc()
    if nbytes:
        _M_PREFETCH_BYTES.inc(nbytes)
