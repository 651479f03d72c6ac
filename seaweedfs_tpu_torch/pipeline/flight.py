"""Pipeline flight recorder: per-batch lifecycle timelines.

The port of ``seaweedfs_tpu/pipeline/flight.py``. The aggregate stage
accounting (``PipeStats``) says how much thread time each pipeline
stage burned, but not WHEN — overlap bubbles, lookahead stalls and
queue-wait serialization inside the reader→H2D→compute→writer pipeline
are invisible in per-stage sums. Every batch flowing through pipe.py /
encode.py / rebuild.py / writeback.py and the mesh prepare/apply split
emits timestamped lifecycle events into a bounded per-process ring.

Hot-path discipline:

* the ring's slots are PREALLOCATED and written in place — recording an
  event allocates nothing; the port keeps them as one flat list per
  field, so a ring of any size is made in a few list allocations (a run
  that a profile records arms one in its own window);
* timestamps are ``time.monotonic_ns()`` (one clock for the whole
  process, immune to wall-clock steps);
* when the recorder is disarmed, :func:`record` is a single attribute
  load + ``is None`` test — the instrumentation sites stay in the code
  and cost nothing measurable; sites whose arguments cost something to
  compute test :func:`armed` first. ``chip_smoke.py``'s config phase
  times an armed encode against a disarmed one.

On the card, the sync span (``EV_SYNC_START`` / ``EV_SYNC_END``) is the
writer's wait in ``np.asarray`` on a result: the wait on the CUDA event
recorded after the batch's device-to-host copy (ops/rs_torch.py,
parallel/mesh.py), so it covers the kernel and both copies still in
flight when the writer reaches the batch.

On top of the ring:

* :func:`chrome_trace` — Chrome trace-event JSON (one track per stage
  thread plus counter tracks for queue depth and pool occupancy),
  loadable in Perfetto / chrome://tracing; the ``pipeline.dump -trace``
  shell command writes it to a file;
* :func:`occupancy` / :func:`analyze` — per-stage busy fractions over
  the recorded wall window, bubble time, per-batch critical-path
  attribution (which stage each batch actually waited on), and a
  bottleneck verdict with concrete ``[pipeline]`` knob recommendations
  (the ``pipeline.analyze`` shell command);
* ``seaweed_pipeline_*`` gauges + a "flight" payload
  (:func:`debug_payload`), refreshed at the end of every recorded run.

The port's host stages. Every event of the JAX package keeps its code,
name and pairing; the port adds the host stages that can leave the card
idle on the one-card seal path, each with a ``PipeStats`` counter that
``pipeline.status`` shows and that counts whether or not the recorder
is armed:

* ``pack`` (21 / 22, arg = bytes; the reader, paired by thread): the
  batcher's copies into fresh memory, ``batch._Bucket.flush`` when it
  concatenates rows or copies a non-contiguous column chunk, and
  ``stripe._pad_to`` (``pack_seconds``, ``pack_bytes``);
* ``reader_wait`` (23 / 24; compute, by thread): the blocking read-queue
  get of the overlapped path's main loop (``reader_wait_seconds``);
* ``group_wait`` (25 / 26, arg = group width; compute, by thread): one
  span per group drain, from its first bounded wait to the last batch
  it takes or its give-up (``group_wait_seconds``);
* ``h2d`` with batch :data:`STAGED` (8 / 9; compute):
  ``rs_torch._dispatch_run``'s copies of a run's slabs into the staging
  tensor on the card (from pageable memory each copy returns once CUDA
  has staged it).

None of them adds busy time to :func:`occupancy` / :func:`analyze`:
``pack`` lies inside ``read``, the two waits are waits, and a staged
``h2d`` lies inside the ``dispatch`` that already counts it;
:func:`chrome_trace` draws them on the reader's and the compute track,
and :func:`spans` hands out every paired span.

The ring follows a torch profile: at the start of every
``pipe.run_pipeline``, a run that ``torch.profiler`` records and that
finds no recorder armed arms one of :data:`PROFILE_CAPACITY` slots
(:func:`follow_profiler`: one attribute read per run); it stays armed,
to be read after the profile, until a run no profile records. Spans
cannot go into the profile itself: a ``record_function`` range on a
thread started inside the profile is not recorded unless the profile
records all threads. One clock: the ring stamps ``time.monotonic_ns()``,
which reads the same ``CLOCK_MONOTONIC`` as ``time.perf_counter()``, so
a span lands on a profile's timeline by one host-clock reading taken
beside a ``record_function`` mark the profile also holds:
``(t_ns / 1e9 - t_mark) * 1e6 + mark_start_us``. The benchmark does
this (``portbench/hostspans.py``) and puts each idle stretch of the
card down to the state open at its middle.

Armed via the ``[flight]`` TOML section (:func:`configure_from`) or
``SEAWEEDFS_TORCH_FLIGHT=1`` in the environment (:func:`install_from_env`
— ``SEAWEEDFS_TORCH_FLIGHT=<n>`` sizes the ring). Concurrency note: slot
claims go through ``itertools.count`` (atomic under the GIL), so
concurrent recorders never interleave within one slot; a reader that
snapshots WHILE a run is in flight may see a torn slot, which
``snapshot`` filters by validity — every exporter here runs after the
run's join.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..util import stats

# --------------------------------------------------------------------------
# event vocabulary
# --------------------------------------------------------------------------

#: batch lifecycle (paired start/end events share a batch id; per-stage
#: FIFO order makes per-stage sequence numbers line up across threads)
EV_RUN_START = 1       # arg: kind hash (informational)
EV_RUN_END = 2
EV_ENQUEUE = 3         # batch plan queued for materialization; arg=bytes
EV_READ_START = 4
EV_READ_END = 5        # arg=bytes materialized
EV_POOL_WAIT = 6       # reader blocked on HostBufferPool.acquire
EV_POOL_GOT = 7        # value=in-flight buffers after acquire
EV_H2D_SUBMIT = 8      # mesh prepare: async device_put issued
EV_H2D_READY = 9       # prepare returned (transfer in flight); arg=bytes
EV_DISPATCH = 10       # compute dispatch (jit enqueue) begins
EV_DISPATCH_DONE = 11  # dispatch returned (async); arg=group width
EV_SYNC_START = 12     # writer blocks on np.asarray (device wait + D2H)
EV_SYNC_END = 13       # result bytes on host; arg=bytes
EV_WRITE_START = 14    # writer-stage write_fn begins
EV_WRITE_END = 15      # write_fn + recycle_fn returned
EV_WRITE_SUBMIT = 16   # positioned write queued on the WriterPool
EV_PWRITEV_RETIRE = 17 # one positioned write retired; value=seconds, arg=bytes
EV_RECYCLE = 18        # pooled buffer returned; value=in-flight after
EV_QDEPTH = 19         # counter: value=depth, arg: 0=read_q 1=write_q
EV_POOL_OCC = 20       # counter: value=in-flight pooled buffers
#: the port's host stages that can hold the card (none in the JAX package)
EV_PACK_START = 21     # reader copies rows into fresh memory (batch, stripe)
EV_PACK_END = 22       # arg=bytes copied
EV_READER_WAIT = 23    # compute stage blocks on the read queue
EV_READER_GOT = 24     # it got a batch (or the reader's end marker)
EV_GROUP_WAIT = 25     # the group drain's first bounded wait for a batch
EV_GROUP_DONE = 26     # the drain took its last batch or gave up; arg=width

#: Batch id of the one-card copy staging (ops/rs_torch.py): an h2d span
#: nested in a dispatch span, whose seconds that dispatch already counts.
STAGED = -2

_NAMES = {
    EV_RUN_START: "run_start", EV_RUN_END: "run_end",
    EV_ENQUEUE: "enqueue", EV_READ_START: "read_start",
    EV_READ_END: "read_end", EV_POOL_WAIT: "pool_wait",
    EV_POOL_GOT: "pool_got", EV_H2D_SUBMIT: "h2d_submit",
    EV_H2D_READY: "h2d_ready", EV_DISPATCH: "dispatch",
    EV_DISPATCH_DONE: "dispatch_done", EV_SYNC_START: "sync_start",
    EV_SYNC_END: "sync_end", EV_WRITE_START: "write_start",
    EV_WRITE_END: "write_end", EV_WRITE_SUBMIT: "write_submit",
    EV_PWRITEV_RETIRE: "pwritev_retire", EV_RECYCLE: "recycle",
    EV_QDEPTH: "queue_depth", EV_POOL_OCC: "pool_occupancy",
    EV_PACK_START: "pack_start", EV_PACK_END: "pack_end",
    EV_READER_WAIT: "reader_wait", EV_READER_GOT: "reader_got",
    EV_GROUP_WAIT: "group_wait", EV_GROUP_DONE: "group_done",
}

#: (start, end, track-name) pairs rendered as duration events; pairing
#: is by batch id (>=0) or, for batchless spans like pool waits, by
#: thread ident.
_SPAN_PAIRS = (
    (EV_READ_START, EV_READ_END, "read"),
    (EV_POOL_WAIT, EV_POOL_GOT, "pool_wait"),
    (EV_H2D_SUBMIT, EV_H2D_READY, "h2d"),
    (EV_DISPATCH, EV_DISPATCH_DONE, "dispatch"),
    (EV_SYNC_START, EV_SYNC_END, "d2h_sync"),
    (EV_WRITE_START, EV_WRITE_END, "write"),
    (EV_PACK_START, EV_PACK_END, "pack"),
    (EV_READER_WAIT, EV_READER_GOT, "reader_wait"),
    (EV_GROUP_WAIT, EV_GROUP_DONE, "group_wait"),
)
_SPAN_START = {start: name for start, _end, name in _SPAN_PAIRS}
_SPAN_END = {end: name for _start, end, name in _SPAN_PAIRS}

_QUEUE_NAMES = {0: "read_q_depth", 1: "write_q_depth"}

# slot layout: [ts_ns, event, batch, tid, value, arg]
_TS, _EV, _BATCH, _TID, _VAL, _ARG = range(6)


class FlightRecorder:
    """A bounded ring of preallocated event slots.

    ``capacity`` slots are allocated up front; recording claims the
    next slot via an atomic counter and overwrites in place, so the
    steady state allocates nothing and the oldest events are evicted
    by wrap-around (``dropped`` counts them)."""

    def __init__(self, capacity: int = 65536):
        self.capacity = max(64, int(capacity))
        n = self.capacity
        # one list per slot field (the slot layout's order)
        self._fields = ([0] * n, [0] * n, [-1] * n, [0] * n, [0.0] * n,
                        [0] * n)
        self._claim = itertools.count()
        self._hi = -1   # highest claimed index (benign race: monotone)

    def record(self, event: int, batch: int = -1, value: float = 0.0,
               arg: int = 0) -> None:
        i = next(self._claim)
        j = i % self.capacity
        ts, ev, bt, tid, val, ag = self._fields
        ts[j] = time.monotonic_ns()
        ev[j] = event
        bt[j] = batch
        tid[j] = threading.get_ident()
        val[j] = value
        ag[j] = arg
        self._hi = i

    @property
    def written(self) -> int:
        return self._hi + 1

    @property
    def dropped(self) -> int:
        return max(0, self.written - self.capacity)

    def snapshot(self) -> list[tuple]:
        """Valid events oldest-first (a sorted copy; the ring itself is
        unordered once it wraps)."""
        rows = [r for r in zip(*self._fields) if r[_EV] != 0]
        rows.sort(key=lambda r: r[_TS])
        return rows

    def reset(self) -> None:
        n = self.capacity
        self._fields[_EV][:] = [0] * n
        self._fields[_TS][:] = [0] * n
        self._claim = itertools.count()
        self._hi = -1


# --------------------------------------------------------------------------
# module state: the armed recorder + the [flight] config
# --------------------------------------------------------------------------

@dataclass
class FlightConfig:
    """The ``[flight]`` TOML section (docs/pipeline.md). Flags > TOML >
    defaults, like every other subsystem (util/config.py)."""

    enabled: bool = False
    capacity: int = 65536


_CONFIG = FlightConfig()
_REC: Optional[FlightRecorder] = None
#: True while ``_REC`` is the ring :func:`follow_profiler` armed.
_FOLLOWING = False
#: Held by every write of ``_REC`` and ``_FOLLOWING``: runs on several
#: threads may arm or drop the ring at once.
_ARM_LOCK = threading.Lock()
#: Slots of the ring armed for a profiled run: a 51 s traced seal window
#: of either benchmark cell records under a fifth of it.
PROFILE_CAPACITY = 1 << 17


def current() -> FlightConfig:
    return _CONFIG


def configure(**kw) -> None:
    """Set config fields; None keeps the current value. Arms or
    disarms the recorder so a runtime toggle (the bench harness, a
    config reload) takes effect immediately."""
    for key, val in kw.items():
        if not hasattr(_CONFIG, key):
            raise TypeError(f"unknown flight config key {key!r}")
        if val is not None:
            cur = getattr(_CONFIG, key)
            setattr(_CONFIG, key, type(cur)(val))
    if _CONFIG.enabled:
        arm(_CONFIG.capacity)
    else:
        disarm()


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[flight]`` block (missing keys keep
    their current values; an unknown key raises ``TypeError``, where the
    JAX package drops it)."""
    from ..util import config as config_mod
    sect = config_mod.lookup(conf, "flight")
    if not isinstance(sect, dict):
        return
    configure(**sect)


def install_from_env() -> None:
    """``SEAWEEDFS_TORCH_FLIGHT=1`` arms the recorder for any process (a
    subprocess shell is armed this way); a value > 1 sizes the ring.
    Unset/0/empty is a no-op."""
    raw = os.environ.get("SEAWEEDFS_TORCH_FLIGHT", "").strip()
    if not raw or raw == "0":
        return
    try:
        n = int(raw)
    except ValueError:
        n = 1
    configure(enabled=True, capacity=n if n > 1 else None)


def arm(capacity: Optional[int] = None) -> FlightRecorder:
    """Install (or keep) the process recorder; returns it."""
    global _REC, _FOLLOWING
    cap = int(capacity or _CONFIG.capacity)
    with _ARM_LOCK:
        if _REC is None or _REC.capacity != cap:
            _REC = FlightRecorder(cap)
        _CONFIG.enabled = True
        _FOLLOWING = False
        return _REC


def disarm() -> None:
    global _REC, _FOLLOWING
    with _ARM_LOCK:
        _REC = None
        _CONFIG.enabled = False
        _FOLLOWING = False


def follow_profiler(profiling: bool) -> None:
    """Called at the start of every pipeline run with whether a torch
    profile is recording. A profiled run that finds no recorder armed
    arms a :data:`PROFILE_CAPACITY` ring, so the profile's timeline can
    carry the pipeline's host stages (:func:`spans`); the ring stays
    armed, to be read once the profile ends, until a run that no profile
    records. A recorder armed by ``[flight]`` or the environment is left
    as it is."""
    global _REC, _FOLLOWING
    if not (profiling and _REC is None or not profiling and _FOLLOWING):
        return
    with _ARM_LOCK:
        if profiling and _REC is None:
            _REC = FlightRecorder(PROFILE_CAPACITY)
            _FOLLOWING = True
        elif not profiling and _FOLLOWING:
            _REC = None
            _FOLLOWING = False


def armed() -> bool:
    return _REC is not None


def recorder() -> Optional[FlightRecorder]:
    return _REC


def record(event: int, batch: int = -1, value: float = 0.0,
           arg: int = 0) -> None:
    """The instrumentation entry point: no-op (one None test) when the
    recorder is disarmed."""
    r = _REC
    if r is not None:
        r.record(event, batch, value, arg)


def _paired(evs: list[tuple]):
    """Every event in order as ``(event, span name, start event)``: a
    span's start gives its name and None, its end the name and the start
    it closes (None when none is open), any other event None and None.
    Spans pair by batch id (>=0) or, for batchless spans, by thread
    ident: the one pairing every exporter here reads."""
    open_spans: dict[tuple, tuple] = {}
    for ev in evs:
        kind, batch = ev[_EV], ev[_BATCH]
        name = _SPAN_START.get(kind) or _SPAN_END.get(kind)
        if name is None:
            yield ev, None, None
            continue
        key = (name, batch if batch >= 0 else ("t", ev[_TID]))
        if kind in _SPAN_START:
            open_spans[key] = ev
            yield ev, name, None
        else:
            yield ev, name, open_spans.pop(key, None)


def _events(events: Optional[list[tuple]]) -> list[tuple]:
    """``events`` oldest-first, or the armed ring's (none disarmed)."""
    if events is None:
        return _REC.snapshot() if _REC is not None else []
    return sorted(events, key=lambda r: r[_TS])


def spans(events: Optional[list[tuple]] = None) -> list[tuple]:
    """The recorded spans on the process's monotonic clock, oldest
    start first: (name, start ns, end ns, thread ident, batch) for every
    start/end pair of ``_SPAN_PAIRS`` (:func:`_paired`).
    ``time.monotonic_ns`` and ``time.perf_counter`` read one clock, so
    these lie on the timeline of any host clock reading taken with
    either."""
    out = [(name, st[_TS], ev[_TS], ev[_TID], ev[_BATCH])
           for ev, name, st in _paired(_events(events)) if st is not None]
    out.sort(key=lambda s: s[1])
    return out


# --------------------------------------------------------------------------
# Chrome trace-event export
# --------------------------------------------------------------------------

def _thread_names(events: list[tuple]) -> dict[int, str]:
    """tid -> human track name, derived from the event mix each thread
    produced (pipeline threads are per-run daemons, dead by export
    time, so live-thread inspection cannot name them)."""
    roles: dict[int, str] = {}
    for ev in events:
        tid, kind = ev[_TID], ev[_EV]
        if kind in (EV_READ_START, EV_READ_END, EV_ENQUEUE,
                    EV_PACK_START, EV_PACK_END):
            roles.setdefault(tid, "reader")
        elif kind in (EV_SYNC_START, EV_SYNC_END,
                      EV_WRITE_START, EV_WRITE_END):
            roles.setdefault(tid, "writer")
        elif kind == EV_PWRITEV_RETIRE:
            roles.setdefault(tid, "writeback")
        elif kind in (EV_DISPATCH, EV_DISPATCH_DONE,
                      EV_H2D_SUBMIT, EV_H2D_READY, EV_READER_WAIT,
                      EV_READER_GOT, EV_GROUP_WAIT, EV_GROUP_DONE):
            roles.setdefault(tid, "compute")
    # distinct writeback workers get numbered tracks
    n_wb = 0
    for tid in sorted(t for t, r in roles.items() if r == "writeback"):
        roles[tid] = f"writeback-{n_wb}"
        n_wb += 1
    return roles


def chrome_trace(events: Optional[list[tuple]] = None) -> dict:
    """The recorded window as a Chrome trace-event document
    (``{"traceEvents": [...]}``) — open in Perfetto or
    chrome://tracing. Duration events pair the lifecycle start/end
    codes per batch (per thread for batchless spans); queue depth and
    pool occupancy become counter tracks; submits/retires/recycles are
    instant events."""
    evs = _events(events)
    pid = os.getpid()
    out: list[dict] = []
    if not evs:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t0 = evs[0][_TS]

    def us(ts_ns: int) -> float:
        return (ts_ns - t0) / 1000.0

    for tid, name in _thread_names(evs).items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": name}})

    for ev, name, st in _paired(evs):
        ts, kind, batch, tid, val, arg = ev
        if name is not None:
            if st is None:
                continue
            out.append({
                "name": name, "ph": "X", "cat": "flight",
                "ts": round(us(st[_TS]), 3),
                "dur": round((ts - st[_TS]) / 1000.0, 3),
                "pid": pid, "tid": tid,
                "args": {"batch": batch, "bytes": arg},
            })
        elif kind == EV_QDEPTH:
            out.append({
                "name": _QUEUE_NAMES.get(arg, f"queue_{arg}_depth"),
                "ph": "C", "cat": "flight", "ts": round(us(ts), 3),
                "pid": pid, "tid": 0, "args": {"depth": val},
            })
        elif kind == EV_POOL_OCC:
            out.append({
                "name": "pool_occupancy", "ph": "C", "cat": "flight",
                "ts": round(us(ts), 3), "pid": pid, "tid": 0,
                "args": {"in_flight": val},
            })
        elif kind in (EV_WRITE_SUBMIT, EV_RECYCLE, EV_ENQUEUE,
                      EV_RUN_START, EV_RUN_END):
            out.append({
                "name": _NAMES[kind], "ph": "i", "s": "t",
                "cat": "flight", "ts": round(us(ts), 3),
                "pid": pid, "tid": tid,
                "args": {"batch": batch, "arg": arg},
            })
        elif kind == EV_PWRITEV_RETIRE:
            # retire records carry their own duration (value=seconds):
            # render the busy span ending at the record time
            dur_us = val * 1e6
            out.append({
                "name": "pwritev", "ph": "X", "cat": "flight",
                "ts": round(us(ts) - dur_us, 3),
                "dur": round(dur_us, 3), "pid": pid, "tid": tid,
                "args": {"bytes": arg},
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def dump_trace(path: str,
               events: Optional[list[tuple]] = None) -> int:
    """Write the Chrome trace JSON to ``path``; returns the event
    count."""
    doc = chrome_trace(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


# --------------------------------------------------------------------------
# occupancy analytics + the bottleneck analyzer
# --------------------------------------------------------------------------

def _last_run_events(evs: list[tuple]) -> list[tuple]:
    """Events since the most recent RUN_START (the whole window when
    no run marker survived eviction)."""
    for i in range(len(evs) - 1, -1, -1):
        if evs[i][_EV] == EV_RUN_START:
            return evs[i:]
    return evs


def occupancy(events: Optional[list[tuple]] = None,
              last_run_only: bool = True) -> dict:
    """Per-stage busy seconds + fractions over the recorded wall
    window, bubble time, and per-batch critical-path attribution.

    Stage vocabulary (what each busy fraction means):

    * ``read`` — reader thread materializing batches (pool-acquire
      wait EXCLUDED: that sub-window is ``pool_wait``, backpressure
      from the writer/recycle side, not read cost);
    * ``dispatch`` — compute-stage enqueue time (the Python + jit
      dispatch floor), H2D prepare included;
    * ``d2h`` — writer blocked in ``np.asarray``: the device finishing
      the batch plus the D2H copy — on a link-bound box this is where
      the dispatch-link floor shows up;
    * ``write`` — writer-thread write_fn time;
    * ``writeback`` — positioned-write pool busy seconds (sum across
      workers, so this one alone may exceed the window).

    The port's host-stage spans (``pack``, ``reader_wait``,
    ``group_wait``) and the staged copies (``h2d`` with batch
    :data:`STAGED`) add to no stage: :func:`spans` hands them out.

    Per batch, the exclusive wait components are: queue-wait before
    dispatch (read_end -> dispatch start) and queue-wait before the
    writer picks it up (dispatch done -> sync start); ``waited_on``
    counts, per batch, the largest component — the stage that batch
    actually waited on."""
    evs = _events(events)
    if last_run_only:
        evs = _last_run_events(evs)
    if not evs:
        return {"window_seconds": 0.0, "batches": 0, "busy_seconds": {},
                "busy_fraction": {}, "bubble_seconds": {},
                "waited_on": {}, "events": 0}
    t_lo, t_hi = evs[0][_TS], evs[-1][_TS]
    window = max(1e-9, (t_hi - t_lo) / 1e9)

    busy = {"read": 0.0, "pool_wait": 0.0, "dispatch": 0.0,
            "d2h": 0.0, "write": 0.0, "writeback": 0.0}
    # per-batch timeline marks for critical-path attribution
    marks: dict[int, dict] = {}
    span_stage = {
        "read": "read", "pool_wait": "pool_wait", "h2d": "dispatch",
        "dispatch": "dispatch", "d2h_sync": "d2h", "write": "write",
    }
    for ev, name, st in _paired(evs):
        ts, kind, batch, tid, val, arg = ev
        if kind in _SPAN_START:
            if batch >= 0:
                m = marks.setdefault(batch, {})
                m.setdefault(f"{name}_start", ts)
        elif name is not None:
            if st is None or name not in span_stage or batch == STAGED:
                # the port's host stages are waits or lie inside a read,
                # and a staged copy lies inside its dispatch: no busy
                # time of their own
                continue
            dt = (ts - st[_TS]) / 1e9
            busy[span_stage[name]] += dt
            if batch >= 0:
                m = marks.setdefault(batch, {})
                m[f"{name}_end"] = ts
                m[name] = m.get(name, 0.0) + dt
        elif kind == EV_PWRITEV_RETIRE:
            busy["writeback"] += val

    # pool waits nest INSIDE read spans (HostBufferPool.acquire runs
    # on the reader thread mid-materialization), so they must be
    # carved out after the walk — at POOL_GOT time the enclosing read
    # span is still open and has contributed nothing to subtract from
    busy["read"] = max(0.0, busy["read"] - busy["pool_wait"])

    # a start with no matching end (e.g. the reader's final next() that
    # hit StopIteration) is not a batch — keep only completed spans
    marks = {b: m for b, m in marks.items()
             if any(k in m for k in ("read", "dispatch", "h2d",
                                     "d2h_sync", "write"))}
    waited: dict[str, int] = {}
    for b, m in marks.items():
        comp = {
            "read": m.get("read", 0.0),
            "dispatch/h2d": m.get("dispatch", 0.0) + m.get("h2d", 0.0)
            + m.get("d2h_sync", 0.0),
            "write": m.get("write", 0.0),
        }
        if "read_end" in m and "dispatch_start" in m:
            comp["queue_wait_compute"] = max(
                0.0, (m["dispatch_start"] - m["read_end"]) / 1e9)
        if "dispatch_end" in m and "d2h_sync_start" in m:
            comp["queue_wait_writer"] = max(
                0.0, (m["d2h_sync_start"] - m["dispatch_end"]) / 1e9)
        top = max(comp, key=comp.get)
        waited[top] = waited.get(top, 0) + 1

    frac = {k: round(v / window, 4) for k, v in busy.items()}
    bubble = {k: round(max(0.0, window - v), 6)
              for k, v in busy.items() if k != "writeback"}
    return {
        "window_seconds": round(window, 6),
        "batches": len(marks),
        "events": len(evs),
        "busy_seconds": {k: round(v, 6) for k, v in busy.items()},
        "busy_fraction": frac,
        "bubble_seconds": bubble,
        "waited_on": waited,
    }


#: bottleneck -> (headline, [pipeline] knob advice) for the analyzer
_ADVICE = {
    "dispatch/h2d": (
        "the dispatch/H2D link stage is the floor — batches sit in "
        "the device round-trip, not on the host",
        ["raise [pipeline] depth (deeper lookahead keeps more "
         "transfers in flight)",
         "enable [pipeline] double_buffer = true on the mesh path "
         "(overlap the next batch's H2D with the current collective)",
         "grow [pipeline] batch_bytes / grouped_batch_bytes so each "
         "dispatch amortizes the fixed per-call floor",
         "raise [pipeline] group_cap (wider grouped dispatch on a "
         "single accelerator)"]),
    "read": (
        "the reader is the floor — compute and writer idle waiting "
        "for batch materialization",
        ["raise [pipeline] pool_buffers so the reader can run ahead",
         "shrink [pipeline] grouped_batch_bytes for finer overlap",
         "check the source filesystem (bench disk_write_gibps)"]),
    "pool_wait": (
        "the reader is blocked on buffer recycle — writeback "
        "backpressure, not read cost",
        ["raise [pipeline] pool_buffers",
         "raise [pipeline] writer_threads / writer_queue_depth so "
         "writes retire (and recycle buffers) sooner"]),
    "write": (
        "the writer stage is the floor — shard writeback gates the "
        "pipeline",
        ["raise [pipeline] writer_threads / writer_queue_depth",
         "confirm preallocate = true (growing files serializes)",
         "check the destination filesystem (bench disk_write_gibps)"]),
}


def analyze(events: Optional[list[tuple]] = None,
            last_run_only: bool = True) -> dict:
    """Name the bottleneck stage of the recorded window and recommend
    concrete ``[pipeline]`` knob changes, with the occupancy evidence
    attached. Stage grouping for the verdict: ``dispatch`` + ``d2h``
    merge into "dispatch/h2d" (host-side enqueue and device/link
    round-trip are one serialized lane on the compute path)."""
    occ = occupancy(events, last_run_only=last_run_only)
    if not occ["batches"]:
        return {"verdict": "no recorded batches", "occupancy": occ,
                "bottleneck": None, "recommendations": []}
    frac = occ["busy_fraction"]
    lanes = {
        "dispatch/h2d": frac.get("dispatch", 0.0) + frac.get("d2h", 0.0),
        "read": frac.get("read", 0.0),
        "pool_wait": frac.get("pool_wait", 0.0),
        "write": frac.get("write", 0.0),
    }
    bottleneck = max(lanes, key=lanes.get)
    headline, recs = _ADVICE[bottleneck]
    # refine dispatch/h2d advice ordering: if the host enqueue
    # dominates the device wait (d2h), larger batches and wider groups
    # come first
    if bottleneck == "dispatch/h2d" and \
            frac.get("dispatch", 0.0) > frac.get("d2h", 0.0):
        recs = [recs[2], recs[3], recs[0], recs[1]]
    waited = occ["waited_on"]
    top_wait = max(waited, key=waited.get) if waited else None
    return {
        "verdict": f"bottleneck: {bottleneck} "
                   f"({lanes[bottleneck]:.0%} of the "
                   f"{occ['window_seconds']:.3f}s window busy) — "
                   f"{headline}",
        "bottleneck": bottleneck,
        "lane_fraction": {k: round(v, 4) for k, v in lanes.items()},
        "waited_on_top": top_wait,
        "recommendations": recs,
        "occupancy": occ,
    }


# --------------------------------------------------------------------------
# gauges + the flight payload
# --------------------------------------------------------------------------

_LAST_ANALYSIS: dict = {}
_ANALYSIS_LOCK = threading.Lock()

#: ``seaweed_pipeline_*`` gauge registry (the volume server appends
#: ``METRICS.render()`` to its ``/metrics`` output, as the JAX package's
#: does).
METRICS = stats.Metrics(namespace="seaweed")


def publish_run_gauges() -> Optional[dict]:
    """Fold the just-finished run's occupancy into the
    ``seaweed_pipeline_*`` gauges and cache it for :func:`debug_payload`;
    called by ``pipe.run_pipeline`` when the recorder is armed (end of
    run — never on the hot path). Returns the analysis."""
    if _REC is None:
        return None
    analysis = analyze()
    occ = analysis.get("occupancy") or {}
    if not occ.get("batches"):
        return analysis
    for stage, frac in occ["busy_fraction"].items():
        METRICS.gauge("pipeline_stage_busy_fraction",
                      stage=stage).set(frac)
    METRICS.gauge("pipeline_flight_window_seconds").set(
        occ["window_seconds"])
    METRICS.gauge("pipeline_flight_batches").set(
        occ["batches"])
    with _ANALYSIS_LOCK:
        _LAST_ANALYSIS.clear()
        _LAST_ANALYSIS.update(
            {k: analysis[k] for k in ("verdict", "bottleneck",
                                      "lane_fraction")})
        _LAST_ANALYSIS["busy_fraction"] = occ["busy_fraction"]
        _LAST_ANALYSIS["window_seconds"] = occ["window_seconds"]
        _LAST_ANALYSIS["batches"] = occ["batches"]
    return analysis


def debug_payload() -> dict:
    """The "flight" payload (``/debug/vars`` in the JAX package; the
    ``pipeline.status`` shell command here): ring state + the last
    run's verdict."""
    out: dict = {"armed": armed(), "capacity": _CONFIG.capacity}
    r = _REC
    if r is not None:
        out["written"] = r.written
        out["dropped"] = r.dropped
    with _ANALYSIS_LOCK:
        if _LAST_ANALYSIS:
            out["last_run"] = dict(_LAST_ANALYSIS)
    return out


def reset() -> None:
    """Drop recorded events + the cached verdict (tests, bench)."""
    if _REC is not None:
        _REC.reset()
    with _ANALYSIS_LOCK:
        _LAST_ANALYSIS.clear()
