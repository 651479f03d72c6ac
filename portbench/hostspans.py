"""The card's idle time in a traced window, put down to the pipeline's host
stages.

After a traced window on the card, the device's kernels and copies come
from the window's profiler (``Window._prof.events()``, the trace
categories of ``trace.DEVICE_CATS``), and the pipeline's spans from the
flight ring that a profiled run arms (``flight.spans``: ``h2d``, the copy
staging, of batch ``flight.STAGED`` only; ``group_wait``, the group
drain's wait; ``reader_wait``, the compute stage's wait on the reader;
``dispatch``, the rest of the dispatch). The ring's clock is the host
clock ``trace.Window`` reads, so its spans are placed on the profiler's
timeline as the window places its own (:func:`placed`):
``(t_ns / 1e9 - Window._t0) * 1e6 + w0``, ``w0`` being the start of the
``pb.window`` mark. Every idle stretch of the card goes whole to the
first state of :data:`STATES` open at its middle, or to ``none``.

Nothing is read from a run that was not traced, ran on no card, or whose
ring dropped events, nor from a program without the ring's spans: the
result is then None. It is computed once and kept in the outcome's
``info`` (so the run's ``portbench:`` line shows it).
"""

from __future__ import annotations

import bisect
import time
from typing import Optional

from . import trace

#: The pipeline states an idle stretch may go to, first match first.
STATES = ("h2d", "group_wait", "reader_wait", "dispatch")
NONE = "none"
KEY = "hostspans"


def _merged(intervals) -> tuple[list, list]:
    """The union of (a, b) intervals as sorted starts and ends."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def attribute(busy: list, spans: dict, w0: float, w1: float) -> dict:
    """Idle stretches of the window [w0, w1] (µs) outside the ``busy``
    intervals, each put down whole to the first state of :data:`STATES`
    whose ``spans[state]`` intervals hold its middle, else to ``none``.
    Returns the window's and the idle seconds, the stretches' count and
    the idle seconds by state."""
    b_starts, b_ends = _merged((max(a, w0), min(b, w1)) for a, b in busy
                               if a < w1 and b > w0)
    gaps, edge = [], w0
    for a, b in zip(b_starts, b_ends):
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if edge < w1:
        gaps.append((edge, w1))
    open_at = {s: _merged(spans.get(s, ())) for s in STATES}
    idle = dict.fromkeys(STATES + (NONE,), 0.0)
    for a, b in gaps:
        mid = (a + b) / 2
        for state in STATES:
            starts, ends = open_at[state]
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ends[i] > mid:
                break
        else:
            state = NONE
        idle[state] += (b - a) / 1e6
    return {"window_s": (w1 - w0) / 1e6,
            "idle_s": sum(b - a for a, b in gaps) / 1e6,
            "gaps": len(gaps), "idle": idle}


def placed(ring_spans, staged: int, t0: float, w0: float) -> dict:
    """The ring's spans (``flight.spans``) of :data:`STATES` by state, on
    the profiler's timeline (µs): ``t0`` is the host clock's reading
    (s) at the profiler's ``w0``. Of the ``h2d`` spans only those of
    batch ``staged``, the one-card copy staging: the mesh's prepare
    records ``h2d`` spans of its own, under the batch's id."""
    out: dict = {}
    for name, a, b, _tid, batch in ring_spans:
        if name in STATES and (name != "h2d" or batch == staged):
            out.setdefault(name, []).append(
                ((a / 1e9 - t0) * 1e6 + w0, (b / 1e9 - t0) * 1e6 + w0))
    return out


def _device_op(e) -> bool:
    """Whether profiler event ``e`` is a kernel or a copy on the card: by
    its trace category where the event has one (torch 2.13), else by its
    device, user annotations aside (torch 2.11, the card's, whose events
    carry no category)."""
    cat = getattr(e, "activity_type", None)
    if cat is not None:
        return cat in trace.DEVICE_CATS
    return e.device_type.name != "CPU" and \
        not getattr(e, "is_user_annotation", False)


def _measure(outcome) -> Optional[dict]:
    window = outcome.window
    prof = getattr(window, "_prof", None)
    if not window.traced or not window.cuda or window.reading is None or \
            prof is None:
        return None
    from seaweedfs_tpu_torch.pipeline import flight
    rec, spans_of = flight.recorder(), getattr(flight, "spans", None)
    if rec is None or spans_of is None or rec.dropped:
        return None
    t = time.perf_counter()
    events = prof.events()
    mark = next((e for e in events if e.name == "pb.window"
                 and e.device_type.name == "CPU"), None)
    if mark is None:
        return None
    w0, w1 = mark.time_range.start, mark.time_range.end
    busy = [(e.time_range.start, e.time_range.end) for e in events
            if _device_op(e)]
    spans = placed(spans_of(), flight.STAGED, window._t0, w0)
    out = attribute(busy, spans, w0, w1)
    out.update(spans={s: len(spans.get(s, ())) for s in STATES},
               events=rec.written, dropped=rec.dropped,
               read_s=time.perf_counter() - t)
    return out


def read(outcome) -> Optional[dict]:
    """The attribution of the outcome's traced window (module docstring),
    or None; computed once per outcome."""
    if KEY not in outcome.info:
        outcome.info[KEY] = _measure(outcome)
    return outcome.info[KEY]


def share(outcome, state: str) -> Optional[float]:
    """The share (%) of a seal window in which the card was idle under
    ``state``, or None."""
    if "dat_bytes" not in outcome.readings:
        return None
    got = read(outcome)
    if got is None or got["window_s"] <= 0:
        return None
    return 100.0 * got["idle"][state] / got["window_s"]
