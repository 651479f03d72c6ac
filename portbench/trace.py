"""The measured window, and in a traced run what the device did in it.

With tracing off, :class:`Window` only reads the host clock around the
timed call: no profiler, no spans. With tracing on, ``torch.profiler``
records the device's kernels and copies (CUPTI), the benchmark's own
files record spans around their calls into the program (:meth:`span`,
on any thread, in host-clock time), and :func:`gf_calls` records the
shapes of every GF(2^8) product handed to the kernels. The device's idle
gaps are labelled by the pipeline's state (``hostspans.STATES``) that the
program's flight ring has open at each one's middle; the ring's spans
are placed on the trace's clock by the ``pb.window`` annotation, whose
start the profiler and the host clock both mark.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

from . import yardstick

#: Trace categories of device activity: what makes the device busy.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Reading:
    """What a traced window read: seconds the device was busy (the union
    of its kernels and copies) in ``window_s``, the device operations by
    total seconds, the idle gaps by what the host was doing, and the
    GF(2^8) kernels' seconds."""

    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list
    gf_kernel_s: float


@dataclass
class Window:
    """``with Window(traced, cuda) as w:`` around the timed call; then
    ``w.seconds`` is its host wall time and, traced, ``w.reading``."""

    traced: bool
    cuda: bool
    seconds: float = 0.0
    reading: Optional[Reading] = None
    _spans: list = field(default_factory=list)
    _t0: float = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around a call into the program; records nothing
        unless traced."""
        if not self.traced:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.perf_counter()))

    def __enter__(self):
        self._prof = self._mark = None
        if self.traced:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._mark = torch.profiler.record_function("pb.window")
            self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if not self.traced:
            return False
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.reading = self._read()
        return False

    def _read(self) -> Reading:
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        mark = next(e for e in events if e.get("name") == "pb.window"
                    and e.get("ph") == "X")
        w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        dev = sorted((max(float(e["ts"]), w0),
                      min(float(e["ts"]) + float(e.get("dur", 0)), w1),
                      e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                     and float(e["ts"]) < w1
                     and float(e["ts"]) + float(e.get("dur", 0)) > w0)
        ops: dict = {}
        gf_s = 0.0
        for a, b, name in dev:
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
            if yardstick.is_gf_kernel(name):
                gf_s += (b - a) / 1e6
        busy, gaps, edge = 0.0, [], w0
        for a, b, name in dev:
            if a > edge:
                gaps.append((edge, a, name))
            if b > edge:
                busy += b - max(a, edge)
                edge = b
        if edge < w1:
            gaps.append((edge, w1, "end of window"))
        return Reading(
            busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
            device_ops=sorted(ops.items(), key=lambda kv: -kv[1])[:TOP],
            idle_gaps=_label_gaps(gaps, _ring_states(self._t0, w0)),
            gf_kernel_s=gf_s)


def _ring_states(t0: float, w0: float) -> Optional[dict]:
    """The flight ring's spans of ``hostspans.STATES`` on the trace's
    clock (``t0``: the host clock at the trace's ``w0``), or None where
    no ring ran or it dropped events."""
    from seaweedfs_tpu_torch.pipeline import flight

    from . import hostspans
    rec, spans_of = flight.recorder(), getattr(flight, "spans", None)
    if rec is None or spans_of is None or rec.dropped:
        return None
    return hostspans.placed(spans_of(), flight.STAGED, t0, w0)


def _label_gaps(gaps: list, states: Optional[dict]) -> list:
    """Sum the idle gaps by the pipeline state open at each one's middle
    (the first of ``hostspans.STATES`` whose ``states`` spans hold it,
    else ``none``; ``no ring`` where ``states`` is None) and the device
    operation that ends it: [[label, seconds], ...], largest first, the
    state first in each label. Past :data:`TOP` labels the smallest go
    to one ``other`` entry, so the seconds always sum to the idle."""
    from . import hostspans
    open_at = {s: hostspans._merged(states.get(s, ()))
               for s in hostspans.STATES} if states is not None else {}
    sums: dict = {}
    for a, b, nxt in gaps:
        mid = (a + b) / 2
        state = hostspans.NONE if states is not None else "no ring"
        for name, (starts, ends) in open_at.items():
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ends[i] > mid:
                state = name
                break
        key = f"{state} -> {nxt}"
        total, count = sums.get(key, (0.0, 0))
        sums[key] = (total + (b - a) / 1e6, count + 1)
    ranked = sorted(sums.items(), key=lambda kv: -kv[1][0])
    if len(ranked) > TOP:
        rest = ranked[TOP - 1:]
        ranked = ranked[:TOP - 1] + [("other", (
            sum(t for _, (t, _) in rest), sum(c for _, (_, c) in rest)))]
    return [[f"{key} ({count} gaps)", total]
            for key, (total, count) in ranked]


@contextlib.contextmanager
def gf_calls(enabled: bool):
    """Record (n_out, n_in, batch, S) of every GF(2^8) product the
    program hands ``rs_cuda.apply_gf_matrix``: the kernels' one entry.
    Yields the list; records nothing unless ``enabled``."""
    calls: list = []
    if not enabled:
        yield calls
        return
    from seaweedfs_tpu_torch.ops import rs_cuda
    inner = rs_cuda.apply_gf_matrix

    def recording(coefs, x):
        calls.append((int(coefs.shape[0]), int(coefs.shape[1]),
                      int(x.shape[0]), int(x.shape[-1])))
        return inner(coefs, x)

    rs_cuda.apply_gf_matrix = recording
    try:
        yield calls
    finally:
        rs_cuda.apply_gf_matrix = inner
