"""Dapper-style end-to-end request tracing.

Every request entering the system (S3/WebDAV verb, FUSE op, shell
command) opens a *trace*: a tree of spans identified by
``trace_id / span_id / parent_id``. The context crosses process hops in
an ``X-Seaweed-Trace`` HTTP header and the ``x-seaweed-trace`` gRPC
metadata key, so one S3 GET leaves spans on the gateway, the filer, the
master, and the volume server, each recording wall time, bytes moved,
and outcome.

Per-process state is deliberately simple — every server in this
codebase handles one request per thread (ThreadingHTTPServer and the
gRPC ThreadPoolExecutor), so the active span stack is a
``threading.local`` and needs no locks. Completed traces land in a
bounded ring buffer served as JSON from each server's ``/debug/traces``
endpoint and summarized by the ``trace.status`` / ``trace.dump`` shell
commands; stage latencies feed the ``trace_request_stage_seconds``
histogram family in :data:`METRICS`. Traces slower than the configured
threshold emit a one-line span-tree summary through ``glog``.

Config lives in a ``[tracing]`` TOML block (see ``config.SCAFFOLDS``):
``enabled``, ``ring_size``, ``slow_threshold_seconds``.

The port's copy of ``seaweedfs_tpu/util/tracing.py``. The wire stays the
JAX package's byte for byte — the ``X-Seaweed-Trace`` header, the
``x-seaweed-trace`` gRPC metadata key and the bundle servers POST to the
master's ``/cluster/traces`` — so a request that crosses port and JAX
processes stitches into one trace at either package's master.
"""

from __future__ import annotations

import functools
import json
import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional, Union

from . import glog, stats

TRACE_HEADER = "X-Seaweed-Trace"
GRPC_METADATA_KEY = "x-seaweed-trace"

#: Process-wide stage metrics (``trace_request_stage_seconds{stage=..}``
#: etc.). Servers append ``METRICS.render()`` to their ``/metrics``
#: output so the family is scraped everywhere without merging registries.
METRICS = stats.Metrics(namespace="trace")

_ENABLED = True
_SLOW_THRESHOLD = 1.0
_RING: deque = deque(maxlen=256)
#: Slow-request ring: compact summaries of every trace that crossed
#: the slow threshold, served by each server's ``/debug/vars``. Kept
#: separate from ``_RING`` so slow outliers survive long after the
#: main ring has churned past them.
_SLOW_RING: deque = deque(maxlen=64)

#: HTTP paths never traced — scrapes and debug polls would otherwise
#: flood the ring buffer with single-span traces.
_UNTRACED_PATHS = frozenset(("/metrics", "/status", "/healthz"))
_UNTRACED_PREFIXES = ("/debug/", "/cluster/", "/dir/status", "/raft/")

# -- tail-sampled collection ------------------------------------------------
#: Push target for completed local roots that are slow or errored:
#: either an HTTP URL string ("host:port" of the master — the bundle is
#: POSTed to /cluster/traces through the resilient retry layer) or a
#: callable taking the payload dict (the master ingests its own traces
#: in-process instead of dialing itself). None disables pushing.
_PUSH_TARGET: Union[str, Callable, None] = None
_PUSH_NODE = ""           # this process's advertised host:port
_PUSH_COMPONENT = ""      # master / volume / filer / s3 / webdav
_PUSH_THRESHOLD: Optional[float] = None  # None -> slow threshold
#: Bounded hand-off queue to the push worker; the request thread only
#: appends — a slow or absent master must never block the data path.
_PUSH_QUEUE: deque = deque(maxlen=64)
_PUSH_WAKE = threading.Event()
_PUSH_THREAD: Optional[threading.Thread] = None
_PUSH_STATS = {"pushed": 0, "errors": 0, "dropped": 0}


class Span:
    """One timed stage; ``bytes``/``status``/``tags`` are caller-set."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "start", "end", "n_bytes", "status", "tags")

    def __init__(self, trace_id: str, span_id: str, parent_id: str,
                 name: str, tags: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = time.time()
        self.end = 0.0
        self.n_bytes = 0
        self.status = "ok"
        self.tags = tags

    @property
    def duration(self) -> float:
        return (self.end or time.time()) - self.start

    def tag(self, **kv) -> "Span":
        if self.tags is None:
            self.tags = {}
        self.tags.update({k: str(v) for k, v in kv.items()})
        return self

    def to_dict(self) -> dict:
        d = {"span_id": self.span_id, "parent_id": self.parent_id,
             "name": self.name, "start": self.start,
             "duration_seconds": round(self.duration, 6),
             "bytes": self.n_bytes, "status": self.status}
        if self.tags:
            d["tags"] = dict(self.tags)
        return d


#: Sink for span mutations made inside disabled/trace-less sections;
#: never read, so concurrent writes are harmless.
_NULL_SPAN = Span("", "", "", "null")


#: Plain C-level ``threading.local`` — NOT a subclass with
#: ``__init__``: subclass locals re-run ``__init__`` under a lock on
#: each new thread's first touch, which every HTTP request pays (one
#: thread per request). Attributes are created lazily in
#: :func:`_stack` instead.
_STATE = threading.local()


def _stack() -> list:
    st = getattr(_STATE, "stack", None)
    if st is None:
        st = []
        _STATE.stack = st
        _STATE.finished = []
    return st


#: Span-id generator. A PRNG seeded from the OS, not os.urandom per id:
#: ids only need uniqueness, and the syscall per span is measurable on
#: the cached-read hot path. getrandbits on the shared instance is a
#: single C call, so it is atomic under the GIL.
_RNG = random.Random(os.urandom(16))


def _new_id() -> str:
    return "%016x" % _RNG.getrandbits(64)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

def configure(enabled: Optional[bool] = None,
              ring_size: Optional[int] = None,
              slow_threshold_seconds: Optional[float] = None) -> None:
    global _ENABLED, _SLOW_THRESHOLD, _RING
    if enabled is not None:
        _ENABLED = bool(enabled)
    if ring_size is not None and ring_size != _RING.maxlen:
        _RING = deque(_RING, maxlen=max(1, int(ring_size)))
    if slow_threshold_seconds is not None:
        _SLOW_THRESHOLD = float(slow_threshold_seconds)


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[tracing]`` block (missing keys keep
    their current values)."""
    from . import config as config_mod
    configure(
        enabled=config_mod.lookup(conf, "tracing.enabled"),
        ring_size=config_mod.lookup(conf, "tracing.ring_size"),
        slow_threshold_seconds=config_mod.lookup(
            conf, "tracing.slow_threshold_seconds"))
    global _PUSH_THRESHOLD
    thr = config_mod.lookup(conf, "tracing.push_threshold_seconds")
    if thr is not None:
        _PUSH_THRESHOLD = float(thr)
    url = config_mod.lookup(conf, "tracing.collector_url")
    if url:
        configure_push(url)


def configure_push(target: Union[str, Callable, None],
                   node: Optional[str] = None,
                   component: Optional[str] = None,
                   threshold_seconds: Optional[float] = None) -> None:
    """Enable (or disable, with ``target=None``) tail-sampled pushing
    of slow/errored local roots. ``target`` is the master's
    ``host:port`` (POSTed to ``/cluster/traces``) or a callable payload
    sink (the master's own in-process collector)."""
    global _PUSH_TARGET, _PUSH_NODE, _PUSH_COMPONENT, _PUSH_THRESHOLD
    _PUSH_TARGET = target
    if node is not None:
        _PUSH_NODE = node
    if component is not None:
        _PUSH_COMPONENT = component
    if threshold_seconds is not None:
        _PUSH_THRESHOLD = float(threshold_seconds)
    if target is not None:
        _ensure_push_worker()


def push_threshold() -> float:
    return (_PUSH_THRESHOLD if _PUSH_THRESHOLD is not None
            else _SLOW_THRESHOLD)


def _ensure_push_worker() -> None:
    global _PUSH_THREAD
    if _PUSH_THREAD is not None and _PUSH_THREAD.is_alive():
        return
    t = threading.Thread(target=_push_loop, daemon=True,
                         name="trace-push")
    _PUSH_THREAD = t
    t.start()


def _push_loop() -> None:
    while True:
        _PUSH_WAKE.wait()
        _PUSH_WAKE.clear()
        while _PUSH_QUEUE:
            try:
                payload = _PUSH_QUEUE.popleft()
            except IndexError:
                break
            target = _PUSH_TARGET
            if target is None:
                continue
            try:
                if callable(target):
                    target(payload)
                else:
                    from . import retry
                    retry.http_request(
                        f"http://{target}/cluster/traces",
                        data=json.dumps(payload).encode(),
                        method="POST",
                        headers={"Content-Type": "application/json"},
                        point="trace.push", timeout=5.0,
                        use_breaker=False)
                _PUSH_STATS["pushed"] += 1
            except Exception:  # noqa: BLE001 — collection is best-effort
                _PUSH_STATS["errors"] += 1


def _enqueue_push(root: Span, spans: list, reason: str) -> None:
    if len(_PUSH_QUEUE) >= (_PUSH_QUEUE.maxlen or 0):
        _PUSH_STATS["dropped"] += 1
    _PUSH_QUEUE.append({
        "node": _PUSH_NODE,
        "component": _PUSH_COMPONENT,
        "reason": reason,
        "bundle": _bundle(root, spans),
    })
    _PUSH_WAKE.set()


def push_stats() -> dict:
    return dict(_PUSH_STATS,
                queued=len(_PUSH_QUEUE),
                target=(_PUSH_TARGET if isinstance(_PUSH_TARGET, str)
                        else bool(_PUSH_TARGET)))


def enabled() -> bool:
    return _ENABLED


def slow_threshold() -> float:
    return _SLOW_THRESHOLD


def reset() -> None:
    """Drop ring-buffer contents and this thread's state (tests)."""
    _RING.clear()
    _SLOW_RING.clear()
    _STATE.stack = []
    _STATE.finished = []


# --------------------------------------------------------------------------
# context propagation
# --------------------------------------------------------------------------

def current_span() -> Optional[Span]:
    st = _stack()
    return st[-1] if st else None


def active() -> bool:
    """True when this thread is inside a trace — the hot-path guard
    callers use to skip span bookkeeping entirely."""
    if not _ENABLED:
        return False
    try:
        return bool(_STATE.stack)
    except AttributeError:
        return False


def outbound_value() -> Optional[str]:
    """``trace_id-span_id`` for the active span, else None."""
    sp = current_span()
    return f"{sp.trace_id}-{sp.span_id}" if sp is not None else None


def inject(headers: dict) -> dict:
    """Add the trace header to an outgoing HTTP header dict in place."""
    val = outbound_value()
    if val is not None:
        headers[TRACE_HEADER] = val
    return headers


def parse_value(value: Optional[str]) -> tuple[Optional[str], str]:
    """Header/metadata value -> (trace_id, parent_span_id)."""
    if not value:
        return None, ""
    trace_id, sep, parent = value.partition("-")
    if not sep or not trace_id:
        return None, ""
    return trace_id, parent


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

#: stage name -> (latency histogram, ok/error span counters, bytes
#: counter). The registry lookup rebuilds a sorted label tuple under a
#: lock every call; caching the instruments here keeps the per-span
#: cost to plain attribute work. Plain dict: assignment is atomic and
#: a rare double-create just wins the same registry entry.
_INSTRUMENTS: dict = {}


def _instruments(name: str) -> tuple:
    tup = _INSTRUMENTS.get(name)
    if tup is None:
        tup = (METRICS.histogram("request_stage_seconds", stage=name),
               METRICS.counter("spans_total", stage=name, status="ok"),
               METRICS.counter("spans_total", stage=name,
                               status="error"),
               METRICS.counter("stage_bytes_total", stage=name))
        _INSTRUMENTS[name] = tup
    return tup


def _record(sp: Span) -> None:
    hist, ok, err, nbytes = _instruments(sp.name)
    # The trace id rides the histogram bucket as an exemplar: a scrape
    # showing a fat p99 bucket names the exact trace to pull from
    # /cluster/traces (one slot per bucket, no cardinality growth).
    hist.observe(sp.duration, exemplar=sp.trace_id)
    (ok if sp.status == "ok" else err).inc()
    if sp.n_bytes:
        nbytes.inc(sp.n_bytes)


def _finish(sp: Span, exc: Optional[BaseException]) -> None:
    # Child-span close must stay minimal: it runs BEFORE the response
    # is written (the root's close runs after), so metrics recording
    # and ring bundling are all deferred to the root close below.
    sp.end = time.time()
    if exc is not None and sp.status == "ok":
        sp.status = f"error:{type(exc).__name__}"
    st = _STATE
    if st.stack and st.stack[-1] is sp:
        st.stack.pop()
    st.finished.append(sp)
    if not st.stack:  # local root closed — record + bundle the trace
        spans, st.finished = st.finished, []
        for s in spans:
            _record(s)
        _RING.append((sp, spans))  # dict form built lazily on read
        if sp.duration >= _SLOW_THRESHOLD:
            summary = summarize_spans(spans)
            _SLOW_RING.append({
                "ts": sp.end, "trace_id": sp.trace_id,
                "name": sp.name,
                "duration_seconds": round(sp.duration, 6),
                "status": sp.status, "spans": len(spans),
                "summary": summary,
            })
            glog.warning("slow trace %s %s %.3fs: %s", sp.trace_id,
                         sp.name, sp.duration, summary)
        if _PUSH_TARGET is not None:
            # Tail sampling: only roots that turned out slow or errored
            # leave the process — the head-sampled firehose stays local.
            slow = sp.duration >= push_threshold()
            errored = sp.status != "ok"
            if slow or errored:
                _enqueue_push(sp, spans,
                              "slow" if slow else "error")


class _SpanHandle:
    """Context manager for one span. Hand-rolled (not
    ``@contextmanager``) because the generator machinery costs more
    than the span bookkeeping itself on the cached-read hot path."""

    __slots__ = ("_name", "_tags", "_header", "_root", "_sp")

    def __init__(self, name: str, tags: Optional[dict],
                 header: Optional[str] = None, root: bool = False):
        self._name = name
        self._tags = tags
        self._header = header
        self._root = root
        self._sp = _NULL_SPAN

    def __enter__(self) -> Span:
        st = _stack()
        if not _ENABLED or not (st or self._root):
            return _NULL_SPAN
        tags = self._tags
        if tags:
            tags = {k: str(v) for k, v in tags.items()}
        if st:  # child of the active span (roots degrade too)
            parent = st[-1]
            sp = Span(parent.trace_id, _new_id(), parent.span_id,
                      self._name, tags or None)
        else:  # local trace root, continuing any upstream context
            trace_id, parent_id = parse_value(self._header)
            sp = Span(trace_id or _new_id(), _new_id(), parent_id,
                      self._name, tags or None)
        st.append(sp)
        self._sp = sp
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._sp is not _NULL_SPAN:
            _finish(self._sp, exc)
        return False


def span(name: str, **tags) -> _SpanHandle:
    """Child span of the active trace; a cheap no-op outside one."""
    return _SpanHandle(name, tags or None)


def start_trace(name: str, header: Optional[str] = None,
                **tags) -> _SpanHandle:
    """Open a local trace root at an ingress point. ``header`` is the
    upstream ``X-Seaweed-Trace`` value (continues that trace) or None
    (mints a fresh trace id). Nested calls degrade to child spans."""
    return _SpanHandle(name, tags or None, header=header, root=True)


def traced(name: str, **tags):
    """Decorator form of :func:`start_trace` for entry-point methods
    (FUSE ops, shell commands)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _ENABLED:
                return fn(*a, **kw)
            with start_trace(name, **tags):
                return fn(*a, **kw)
        return wrapper
    return deco


# --------------------------------------------------------------------------
# inspection: ring buffer, /debug/traces payload, summaries
# --------------------------------------------------------------------------

def _bundle(root: Span, spans: list) -> dict:
    return {
        "trace_id": root.trace_id,
        "name": root.name,
        "start": spans[0].start if spans else root.start,
        "duration_seconds": round(root.duration, 6),
        "span_count": len(spans),
        "remote_parent": root.parent_id,
        "status": root.status,
        "spans": [s.to_dict() for s in spans],
    }


def recent_traces(limit: Optional[int] = None) -> list[dict]:
    """Most recent completed traces, newest last."""
    entries = list(_RING)
    if limit is not None and limit >= 0:
        entries = entries[-limit:] if limit else []
    return [_bundle(root, spans) for root, spans in entries]


def slow_requests(limit: Optional[int] = None) -> list[dict]:
    """Most recent slow-trace summaries, newest last (the
    ``/debug/vars`` slow-request ring)."""
    entries = list(_SLOW_RING)
    if limit is not None and limit >= 0:
        entries = entries[-limit:] if limit else []
    return entries


def debug_payload(limit: Optional[int] = None) -> dict:
    """The ``/debug/traces`` JSON body."""
    return {
        "enabled": _ENABLED,
        "ring_size": _RING.maxlen,
        "slow_threshold_seconds": _SLOW_THRESHOLD,
        "count": len(_RING),  # total held, regardless of limit
        "traces": recent_traces(limit),
    }


def summarize_spans(spans: list) -> str:
    """One-line span tree: ``root 1.2s{child 0.9s{leaf 0.1s}}``.
    Accepts Span objects or their ``to_dict()`` form."""
    ds = [s.to_dict() if isinstance(s, Span) else s for s in spans]
    by_parent: dict[str, list[dict]] = {}
    ids = {d["span_id"] for d in ds}
    roots = []
    for d in ds:
        if d["parent_id"] in ids:
            by_parent.setdefault(d["parent_id"], []).append(d)
        else:
            roots.append(d)

    def fmt(d: dict) -> str:
        base = f"{d['name']} {d['duration_seconds']:.3f}s"
        if d.get("bytes"):
            base += f" {d['bytes']}B"
        if d.get("status", "ok") != "ok":
            base += f" !{d['status']}"
        kids = sorted(by_parent.get(d["span_id"], ()),
                      key=lambda k: k["start"])
        if kids:
            base += "{" + ",".join(fmt(k) for k in kids) + "}"
        return base

    return ",".join(fmt(r) for r in sorted(roots,
                                           key=lambda r: r["start"]))


def render_trace(trace: dict) -> str:
    """Multi-line indented span tree for ``trace.dump``."""
    ds = trace.get("spans", [])
    by_parent: dict[str, list[dict]] = {}
    ids = {d["span_id"] for d in ds}
    roots = []
    for d in ds:
        if d["parent_id"] in ids:
            by_parent.setdefault(d["parent_id"], []).append(d)
        else:
            roots.append(d)
    lines = [f"trace {trace['trace_id']} {trace['name']} "
             f"{trace['duration_seconds']:.3f}s "
             f"({trace['span_count']} spans)"]

    def walk(d: dict, depth: int) -> None:
        extra = f" {d['bytes']}B" if d.get("bytes") else ""
        if d.get("status", "ok") != "ok":
            extra += f" !{d['status']}"
        tags = d.get("tags")
        if tags:
            extra += " " + ",".join(f"{k}={v}" for k, v in
                                    sorted(tags.items()))
        lines.append(f"{'  ' * (depth + 1)}{d['name']} "
                     f"{d['duration_seconds']:.3f}s{extra}")
        for k in sorted(by_parent.get(d["span_id"], ()),
                        key=lambda k: k["start"]):
            walk(k, depth + 1)

    for r in sorted(roots, key=lambda r: r["start"]):
        walk(r, 0)
    return "\n".join(lines)


# --------------------------------------------------------------------------
# master-side tail-sampled trace collection
# --------------------------------------------------------------------------

class TraceCollector:
    """Cluster-wide store for tail-sampled traces.

    Every server pushes its slow/errored local roots here (HTTP POST
    ``/cluster/traces``, or a direct call for the master's own traces);
    bundles sharing a trace id are stitched into ONE cross-process
    trace, so ``/cluster/traces`` shows the gateway, filer, master and
    volume legs of a bad request together. Bounded two ways: at most
    ``ring_size`` traces (oldest evicted) and ``max_spans`` spans per
    trace (extra spans counted, not stored). Span-id dedup makes
    re-delivery through the retry layer idempotent.
    """

    MAX_SPANS = 512

    def __init__(self, ring_size: int = 256):
        self.ring_size = max(1, int(ring_size))
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self.ingested = 0
        self.rejected = 0

    def ingest(self, payload: dict) -> None:
        """Fold one pushed ``{node, component, reason, bundle}`` in."""
        bundle = (payload or {}).get("bundle") or {}
        trace_id = bundle.get("trace_id")
        spans = bundle.get("spans") or []
        if not trace_id or not isinstance(spans, list):
            self.rejected += 1
            return
        node = str(payload.get("node") or "")
        component = str(payload.get("component") or "")
        source = f"{component}@{node}" if component or node else "?"
        reason = str(payload.get("reason") or "slow")
        is_root = not bundle.get("remote_parent")
        with self._lock:
            e = self._traces.get(trace_id)
            if e is None:
                e = {"trace_id": trace_id, "name": bundle.get("name"),
                     "first_ts": bundle.get("start"),
                     "last_ts": bundle.get("start"),
                     "duration_seconds": 0.0, "status": "ok",
                     "reasons": [], "sources": {}, "spans": [],
                     "span_count": 0, "has_root": False,
                     "_span_ids": set()}
                self._traces[trace_id] = e
                while len(self._traces) > self.ring_size:
                    self._traces.popitem(last=False)
            else:
                self._traces.move_to_end(trace_id)
            self.ingested += 1
            start = bundle.get("start")
            if start is not None:
                if e["first_ts"] is None or start < e["first_ts"]:
                    e["first_ts"] = start
                if e["last_ts"] is None or start > e["last_ts"]:
                    e["last_ts"] = start
            # The true root bundle (no upstream context) names the
            # trace and sets its end-to-end duration; until one lands,
            # the longest local root stands in.
            dur = float(bundle.get("duration_seconds") or 0.0)
            if is_root and not e["has_root"]:
                e["has_root"] = True
                e["name"] = bundle.get("name")
                e["duration_seconds"] = dur
            elif is_root == e["has_root"] and dur > e["duration_seconds"]:
                if not e["has_root"]:
                    e["name"] = bundle.get("name")
                e["duration_seconds"] = dur
            st = bundle.get("status", "ok")
            if st != "ok" and e["status"] == "ok":
                e["status"] = st
            if reason not in e["reasons"]:
                e["reasons"].append(reason)
            for s in spans:
                sid = s.get("span_id")
                if sid in e["_span_ids"]:
                    continue
                e["_span_ids"].add(sid)
                e["span_count"] += 1
                e["sources"][source] = e["sources"].get(source, 0) + 1
                if len(e["spans"]) < self.MAX_SPANS:
                    s = dict(s)
                    s["node"] = source
                    e["spans"].append(s)

    @staticmethod
    def _public(e: dict) -> dict:
        return {k: v for k, v in e.items() if not k.startswith("_")}

    def traces(self, limit: Optional[int] = None) -> list[dict]:
        """Stitched traces, most recently touched last."""
        with self._lock:
            entries = [self._public(e) for e in self._traces.values()]
        if limit is not None and limit >= 0:
            entries = entries[-limit:] if limit else []
        return entries

    def top(self, limit: int = 10) -> list[dict]:
        """Worst traces first (errored above slow, then by duration),
        each with a per-stage time breakdown — the ``trace.top`` view."""
        with self._lock:
            entries = [self._public(e) for e in self._traces.values()]
        for e in entries:
            stages: dict[str, float] = {}
            for s in e["spans"]:
                stages[s["name"]] = (stages.get(s["name"], 0.0)
                                     + float(s.get("duration_seconds")
                                             or 0.0))
            e["stages"] = dict(sorted(stages.items(),
                                      key=lambda kv: kv[1],
                                      reverse=True))
        entries.sort(key=lambda e: (e["status"] == "ok",
                                    -e["duration_seconds"]))
        return entries[:max(0, int(limit))]

    def payload(self, limit: Optional[int] = None) -> dict:
        """The ``/cluster/traces`` JSON body."""
        with self._lock:
            count = len(self._traces)
        return {
            "ring_size": self.ring_size,
            "count": count,
            "ingested": self.ingested,
            "rejected": self.rejected,
            "traces": self.traces(limit),
        }


# --------------------------------------------------------------------------
# HTTP server instrumentation
# --------------------------------------------------------------------------

def _http_untraced(path: str) -> bool:
    p = path.split("?", 1)[0]
    # startswith takes the whole prefix tuple in one C call
    return p in _UNTRACED_PATHS or p.startswith(_UNTRACED_PREFIXES)


def instrument_http_handler(cls, component: str):
    """Wrap every ``do_*`` verb of a BaseHTTPRequestHandler subclass in
    a trace root named ``<component>.<VERB>`` that continues any
    upstream ``X-Seaweed-Trace`` context."""
    for attr in dir(cls):
        if attr.startswith("do_"):
            setattr(cls, attr,
                    _wrap_http_verb(getattr(cls, attr), component,
                                    attr[3:]))
    return cls


def _wrap_http_verb(fn, component: str, verb: str):
    name = f"{component}.{verb}"

    @functools.wraps(fn)
    def handler(self):
        if not _ENABLED or _http_untraced(self.path):
            return fn(self)
        hdr = self.headers.get(TRACE_HEADER)
        with start_trace(name, header=hdr, path=self.path):
            return fn(self)

    return handler


# --------------------------------------------------------------------------
# gRPC propagation (mirrors util/security.py's interceptor plumbing)
# --------------------------------------------------------------------------

def grpc_trace_channel(channel):
    """Wrap a channel so every call carries the active trace context in
    metadata. Calls made outside a trace add nothing."""
    import grpc

    from .security import _ClientCallDetails

    class _Attach(grpc.UnaryUnaryClientInterceptor,
                  grpc.UnaryStreamClientInterceptor,
                  grpc.StreamUnaryClientInterceptor,
                  grpc.StreamStreamClientInterceptor):
        def _details(self, cd):
            val = outbound_value()
            if val is None:
                return cd
            md = list(cd.metadata or [])
            md.append((GRPC_METADATA_KEY, val))
            return _ClientCallDetails(cd, md)

        def intercept_unary_unary(self, cont, cd, req):
            return cont(self._details(cd), req)

        def intercept_unary_stream(self, cont, cd, req):
            return cont(self._details(cd), req)

        def intercept_stream_unary(self, cont, cd, it):
            return cont(self._details(cd), it)

        def intercept_stream_stream(self, cont, cd, it):
            return cont(self._details(cd), it)

    return grpc.intercept_channel(channel, _Attach())


def grpc_metadata_value(context) -> Optional[str]:
    try:
        md = dict(context.invocation_metadata() or ())
    except Exception:  # noqa: BLE001 — non-grpc test doubles
        return None
    return md.get(GRPC_METADATA_KEY)


def wrap_grpc_unary(fn, rpc_name: str):
    """Server-side: run a unary handler under a ``grpc.<Method>`` span
    continuing the caller's context from invocation metadata."""
    name = f"grpc.{rpc_name}"

    @functools.wraps(fn)
    def handler(request, context):
        if not _ENABLED:
            return fn(request, context)
        with start_trace(name, header=grpc_metadata_value(context)):
            return fn(request, context)

    return handler


def wrap_grpc_stream(fn, rpc_name: str):
    """Server-side: span around a server-streaming handler; the span
    stays open until the response generator is exhausted (the sync gRPC
    server drains it on the same worker thread)."""
    name = f"grpc.{rpc_name}"

    @functools.wraps(fn)
    def handler(request, context):
        if not _ENABLED:
            yield from fn(request, context)
            return
        with start_trace(name, header=grpc_metadata_value(context)):
            yield from fn(request, context)

    return handler
