"""Continuous sampling profiler (pure stdlib, flamegraph-ready).

A timer thread walks ``sys._current_frames()`` and folds every thread's
stack into a *collapsed stack* string — ``caller;...;leaf`` with frames
rendered ``file.py:function`` — the exact input format of Brendan
Gregg's ``flamegraph.pl`` / speedscope / pprof's collapsed importer.
Two modes share the sampling core:

* **always-on low rate** (default 1 Hz): a daemon thread aggregates
  into a bounded per-process table, read by :func:`hot_stacks` and the
  ``profiler`` section of ``/debug/vars``. Cost is one frame walk per
  second.
* **on-demand burst**: ``GET /debug/profile?seconds=N`` on any server
  runs a dedicated high-rate (default 97 Hz) capture for N seconds and
  returns the collapsed text, piped straight into
  ``flamegraph.pl > out.svg``.

97 Hz, not 100: a sampling period that is coprime with common 10 ms /
100 ms timer loops avoids lockstep aliasing where every sample lands on
the same sleep (the pprof trick).

Configured by the ``[profiler]`` TOML block (see ``config.SCAFFOLDS``):
``enabled``, ``hz``, ``top_k``, ``max_stacks``.

The port's copy of ``seaweedfs_tpu/util/profiler.py`` (pure stdlib).
The top-k hot stacks ride the volume server's heartbeat telemetry
(``TelemetrySnapshot.hot_stacks``), so ``volume.heatmap`` on the master
names what code is hot on each node.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

#: On-demand capture limits: one burst may not exceed this wall time
#: (the handler thread blocks for the duration) or this rate.
MAX_SECONDS = 60.0
MAX_HZ = 250.0
DEFAULT_BURST_HZ = 97.0

_ENABLED = False
_HZ = 1.0
_TOP_K = 5
_MAX_STACKS = 512

_LOCK = threading.Lock()
#: collapsed stack -> sample count (always-on aggregate; bounded by
#: ``max_stacks`` — on overflow the rarest stacks are evicted).
_AGG: dict[str, int] = {}
_SAMPLES = 0          # total samples folded into _AGG
_EVICTED = 0          # stacks dropped by the bound
_STARTED_AT = 0.0
_THREAD: Optional[threading.Thread] = None
_STOP = threading.Event()

#: Thread idents whose stacks are never recorded (the samplers
#: themselves — a profiler that mostly profiles its own wait loop
#: drowns the signal).
_IGNORED_IDENTS: set = set()


def _frame_name(frame) -> str:
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


def _collapse(frame) -> str:
    """Root-first ``a;b;c`` collapsed form of one thread's stack."""
    parts = []
    while frame is not None:
        parts.append(_frame_name(frame))
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


def _sample_into(agg: dict, ignore: set) -> int:
    """One ``sys._current_frames()`` walk folded into ``agg``;
    returns the number of thread stacks recorded."""
    n = 0
    for ident, frame in sys._current_frames().items():
        if ident in ignore:
            continue
        stack = _collapse(frame)
        if stack:
            agg[stack] = agg.get(stack, 0) + 1
            n += 1
    return n


def _evict_locked() -> None:
    global _EVICTED
    if len(_AGG) <= _MAX_STACKS:
        return
    keep = sorted(_AGG.items(), key=lambda kv: kv[1],
                  reverse=True)[:_MAX_STACKS]
    _EVICTED += len(_AGG) - len(keep)
    _AGG.clear()
    _AGG.update(keep)


def _run() -> None:
    global _SAMPLES
    period = 1.0 / max(0.01, _HZ)
    while not _STOP.wait(period):
        with _LOCK:
            if not _ENABLED:
                return
            _sample_into(_AGG, _IGNORED_IDENTS)
            _SAMPLES += 1
            _evict_locked()


# --------------------------------------------------------------------------
# configuration / lifecycle
# --------------------------------------------------------------------------

def configure(enabled: Optional[bool] = None,
              hz: Optional[float] = None,
              top_k: Optional[int] = None,
              max_stacks: Optional[int] = None) -> None:
    """Apply settings; starts or stops the always-on sampler so a
    runtime toggle (the bench harness, a config reload) takes effect
    immediately."""
    global _ENABLED, _HZ, _TOP_K, _MAX_STACKS
    with _LOCK:
        if hz is not None:
            _HZ = min(float(hz), MAX_HZ)
        if top_k is not None:
            _TOP_K = max(1, int(top_k))
        if max_stacks is not None:
            _MAX_STACKS = max(8, int(max_stacks))
            _evict_locked()
        if enabled is not None:
            _ENABLED = bool(enabled)
    if enabled is not None:
        (ensure_started if _ENABLED else stop)()


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[profiler]`` block (missing keys
    keep their current values)."""
    from . import config as config_mod
    configure(
        enabled=config_mod.lookup(conf, "profiler.enabled"),
        hz=config_mod.lookup(conf, "profiler.hz"),
        top_k=config_mod.lookup(conf, "profiler.top_k"),
        max_stacks=config_mod.lookup(conf, "profiler.max_stacks"))


def enabled() -> bool:
    return _ENABLED


def ensure_started() -> None:
    """Start the always-on sampler thread if enabled and not running
    (idempotent; every server calls this at boot)."""
    global _THREAD, _STARTED_AT
    if not _ENABLED:
        return
    with _LOCK:
        if _THREAD is not None and _THREAD.is_alive():
            return
        _STOP.clear()
        t = threading.Thread(target=_run, daemon=True,
                             name="profiler-sampler")
        _THREAD = t
        if not _STARTED_AT:
            _STARTED_AT = time.time()
    t.start()
    _IGNORED_IDENTS.add(t.ident)


def stop() -> None:
    global _THREAD
    _STOP.set()
    t = _THREAD
    if t is not None:
        t.join(timeout=2)
        _IGNORED_IDENTS.discard(t.ident)
    _THREAD = None


def reset() -> None:
    """Drop the always-on aggregate (tests, bench toggles)."""
    global _SAMPLES, _EVICTED
    with _LOCK:
        _AGG.clear()
        _SAMPLES = 0
        _EVICTED = 0


# --------------------------------------------------------------------------
# queries
# --------------------------------------------------------------------------

def hot_stacks(k: Optional[int] = None) -> list[tuple[str, int]]:
    """Top-k (collapsed_stack, samples) from the always-on aggregate,
    hottest first."""
    with _LOCK:
        items = sorted(_AGG.items(), key=lambda kv: kv[1], reverse=True)
    return items[:k if k is not None else _TOP_K]


def collapsed(agg: Optional[dict] = None) -> str:
    """Aggregate -> flamegraph-ready text, one ``stack count`` line per
    distinct stack, hottest first. Defaults to the always-on table."""
    if agg is None:
        with _LOCK:
            agg = dict(_AGG)
    items = sorted(agg.items(), key=lambda kv: kv[1], reverse=True)
    return "".join(f"{stack} {count}\n" for stack, count in items)


def profile(seconds: float, hz: float = DEFAULT_BURST_HZ) -> str:
    """Blocking on-demand capture: sample every thread at ``hz`` for
    ``seconds``, return collapsed-stack text. Runs on the caller's
    thread (the HTTP handler serving ``/debug/profile``), whose own
    stack is excluded — a burst that mostly shows itself waiting in
    ``profile()`` is noise."""
    seconds = min(max(0.05, float(seconds)), MAX_SECONDS)
    hz = min(max(1.0, float(hz)), MAX_HZ)
    period = 1.0 / hz
    ignore = set(_IGNORED_IDENTS)
    ignore.add(threading.get_ident())
    agg: dict[str, int] = {}
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        _sample_into(agg, ignore)
        time.sleep(period)
    return collapsed(agg)


def debug_payload() -> dict:
    """The profiler section of ``/debug/vars``."""
    with _LOCK:
        n_stacks = len(_AGG)
        samples = _SAMPLES
        evicted = _EVICTED
    return {
        "enabled": _ENABLED,
        "hz": _HZ,
        "top_k": _TOP_K,
        "samples": samples,
        "distinct_stacks": n_stacks,
        "evicted_stacks": evicted,
        "running": _THREAD is not None and _THREAD.is_alive(),
        "hot_stacks": [{"stack": s, "samples": c}
                       for s, c in hot_stacks()],
    }
