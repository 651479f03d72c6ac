"""Shared overload-resilient ingress core for every HTTP server.

The reference runs each server (master, volume, filer, S3, WebDAV) on
Go's ``net/http`` — goroutine-per-connection with keep-alive, idle
timeouts, and backpressure for free. The stdlib analog this repo grew
up on, ``ThreadingHTTPServer``, has none of that: an unbounded thread
per connection, connections torn down after every request, and under
overload the process fails by accident (thread exhaustion, queue
collapse) instead of by policy. :class:`IngressHTTPServer` is the
drop-in replacement that turns overload into policy:

* **Bounded worker pool** — ``workers`` threads service parsed
  requests off one dispatch queue; the thread count never grows with
  concurrency. The accept loop only registers connections (cheap), so
  a connection flood cannot stack threads.
* **Keep-alive discipline** — HTTP/1.1 persistent connections do NOT
  pin workers: after each response an idle connection is *parked* on a
  selector thread and re-dispatched when readable. Idle connections
  past ``keepalive_idle_seconds`` are reaped; ``max_connections``
  caps the per-server connection census (beyond it, new connections
  get an immediate 429 and close).
* **Admission control** — before the application verb runs, requests
  whose ``X-Seaweed-Deadline`` budget is already spent are answered
  504 (the caller stopped waiting; doing the work is pure waste), and
  when dispatch-queue pressure passes ``shed_watermark`` requests are
  shed with 429 + ``Retry-After`` instead of queueing toward
  collapse. Apply with :func:`admission_gate` *under* the tracing
  wrapper so shed decisions are tagged on the request's span.
* **Per-tenant QoS** — :class:`QosEngine` (S3 gateway) maps the
  SigV4-authenticated identity to a priority class with token-bucket
  rate and concurrency limits. Under pressure, low-priority classes
  shed first (priority ``p`` sheds at ``watermark ** p``); a
  priority-0 class is never pressure-shed, so a guaranteed tenant
  rides out another tenant's overload with zero failures.

Every decision is observable: ``seaweed_ingress_*`` metrics (rendered
on ``/metrics`` next to the retry/tracing planes), an ``ingress``
section in ``/debug/vars`` (:func:`debug_payload`), and ``shed=...``
tags on trace spans. Config lives in ``[ingress]`` / ``[qos]`` TOML
blocks.

The port's copy of ``seaweedfs_tpu/util/httpserver.py``.
"""

from __future__ import annotations

import json
import math
import queue
import selectors
import socket
import socketserver
import threading
import time
import weakref
from http.server import HTTPServer
from typing import Optional

from . import glog, stats, tracing

DEADLINE_HEADER = "X-Seaweed-Deadline"


def parse_range(header, size: int):
    """RFC 7233 single-range parse: (offset, length) or None to serve
    the full body with 200 (unknown units and malformed values are
    ignored, suffix ranges bytes=-N mean the LAST N bytes). Shared by
    the filer, volume-server and S3 read paths so every tier slices a
    ``bytes=a-b`` identically."""
    if not header or not header.startswith("bytes="):
        return None
    spec = header[6:].split(",")[0].strip()
    lo, sep, hi = spec.partition("-")
    if not sep:
        return None
    try:
        if not lo:  # suffix: last N bytes
            n = int(hi)
            if n <= 0:
                return None
            offset = max(0, size - n)
            return offset, size - offset
        offset = int(lo)
        stop = int(hi) + 1 if hi else size
    except ValueError:
        return None
    if offset >= size:
        return None
    return offset, max(0, min(stop, size) - offset)

#: Ingress metrics (``seaweed_ingress_shed_total{reason,class}``,
#: ``seaweed_ingress_requests_total`` ...). Servers append
#: ``METRICS.render()`` to their ``/metrics`` output.
METRICS = stats.Metrics(namespace="seaweed")

#: Admission-plane master switch (the structural pool/keep-alive core
#: is always on); ``[ingress] enabled`` sets it.
_ENABLED = True

#: Paths never shed by pressure: shedding the endpoints an operator
#: uses to see *why* the server sheds would be self-defeating.
_EXEMPT_PREFIXES = ("/debug/", "/metrics", "/status", "/healthz",
                    "/cluster/status")

_SHED_LOCK = threading.Lock()
_SHED_COUNTS: dict[tuple[str, str], int] = {}

_SERVERS: "weakref.WeakSet[IngressHTTPServer]" = weakref.WeakSet()


class IngressConfig:
    """Tuning for one server's ingress core (``[ingress]`` TOML)."""

    __slots__ = ("workers", "queue_depth", "max_connections",
                 "keepalive_idle_seconds", "keepalive_max_requests",
                 "request_read_timeout", "shed_watermark",
                 "retry_after_seconds", "min_deadline_seconds")

    def __init__(self, workers: int = 16, queue_depth: int = 64,
                 max_connections: int = 512,
                 keepalive_idle_seconds: float = 15.0,
                 keepalive_max_requests: int = 1000,
                 request_read_timeout: float = 30.0,
                 shed_watermark: float = 0.75,
                 retry_after_seconds: float = 1.0,
                 min_deadline_seconds: float = 0.0):
        self.workers = int(workers)
        self.queue_depth = int(queue_depth)
        self.max_connections = int(max_connections)
        self.keepalive_idle_seconds = float(keepalive_idle_seconds)
        self.keepalive_max_requests = int(keepalive_max_requests)
        self.request_read_timeout = float(request_read_timeout)
        self.shed_watermark = float(shed_watermark)
        self.retry_after_seconds = float(retry_after_seconds)
        self.min_deadline_seconds = float(min_deadline_seconds)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


_DEFAULT = IngressConfig()


def default_config() -> IngressConfig:
    return _DEFAULT


def configure(enabled: Optional[bool] = None, **fields) -> None:
    """Flip the admission switch and/or override default-config
    fields (None values keep current)."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)
    for k, v in fields.items():
        if v is None:
            continue
        if k not in IngressConfig.__slots__:
            raise AttributeError(f"no ingress config field {k!r}")
        setattr(_DEFAULT, k, type(getattr(_DEFAULT, k))(v))


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[ingress]`` block."""
    sec = (conf or {}).get("ingress")
    if not isinstance(sec, dict):
        return
    configure(
        enabled=sec.get("enabled"),
        workers=sec.get("workers"),
        queue_depth=sec.get("queue_depth"),
        max_connections=sec.get("max_connections"),
        keepalive_idle_seconds=sec.get("keepalive_idle_seconds"),
        keepalive_max_requests=sec.get("keepalive_max_requests"),
        request_read_timeout=sec.get("request_read_timeout_seconds"),
        shed_watermark=sec.get("shed_watermark"),
        retry_after_seconds=sec.get("retry_after_seconds"),
        min_deadline_seconds=sec.get("min_deadline_seconds"))


def _count_shed(reason: str, cls_name: str) -> None:
    METRICS.counter("ingress_shed_total", reason=reason,
                    **{"class": cls_name}).inc()
    with _SHED_LOCK:
        _SHED_COUNTS[(reason, cls_name)] = \
            _SHED_COUNTS.get((reason, cls_name), 0) + 1
    sp = tracing.current_span()
    if sp is not None:
        sp.tag(shed=reason)


def shed_counts() -> dict[str, int]:
    """``{"reason|class": n}`` snapshot (``/debug/vars``)."""
    with _SHED_LOCK:
        return {f"{r}|{c}": n for (r, c), n in _SHED_COUNTS.items()}


# --------------------------------------------------------------------------
# the server core
# --------------------------------------------------------------------------

class _Conn:
    """One accepted connection moving between queue, worker, parker."""

    __slots__ = ("sock", "addr", "handler", "requests", "parked_at",
                 "opened_at")

    def __init__(self, sock, addr):
        self.sock = sock
        self.addr = addr
        self.handler = None
        self.requests = 0
        self.parked_at = 0.0
        self.opened_at = time.monotonic()


def _one_shot(cls):
    """Subclass whose __init__ only runs setup(): the worker drives
    ``handle_one_request`` explicitly so one handler object survives
    across parks (its rfile buffer may hold a pipelined request). The
    response to a connection's last allowed request says
    ``Connection: close``, so a keep-alive client opens a new
    connection instead of writing into one the server has closed (the
    JAX package closes it unannounced; ROADMAP Queue 3)."""
    def end_headers(self):
        if getattr(self, "_ingress_last", False):
            self.send_header("Connection", "close")
        cls.end_headers(self)

    return type("_Ingress" + cls.__name__, (cls,),
                {"handle": lambda self: None,
                 "finish": lambda self: None,
                 "end_headers": end_headers})


class _Parker(threading.Thread):
    """Selector thread holding idle keep-alive connections so they
    never pin a worker; readable ones re-enter the dispatch queue,
    idle ones past the keep-alive window are reaped."""

    def __init__(self, server: "IngressHTTPServer"):
        super().__init__(
            name=f"ingress-{server.component}-parker", daemon=True)
        self.server = server
        self._sel = selectors.DefaultSelector()
        self._rsock, self._wsock = socket.socketpair()
        self._rsock.setblocking(False)
        self._sel.register(self._rsock, selectors.EVENT_READ, None)
        self._incoming: list[_Conn] = []
        self._lock = threading.Lock()
        self._stopped = False

    def park(self, conn: _Conn) -> None:
        # a _Conn has exactly one owner at any moment (selector loop
        # OR one worker), handed off through the parked queue; no two
        # threads hold it at once
        # single-owner handoff
        conn.parked_at = time.monotonic()
        with self._lock:
            if self._stopped:
                self.server._close(conn)
                return
            self._incoming.append(conn)
        self._wake()

    def parked(self) -> int:
        # minus the always-registered wake pipe; a closed selector
        # (server shut down) has no map and parks nothing
        try:
            m = self._sel.get_map()
        except RuntimeError:
            return 0
        return max(0, len(m) - 1) if m is not None else 0

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        self._wake()

    def _wake(self) -> None:
        try:
            self._wsock.send(b"x")
        except OSError:  # wake pipe already closed; parker is exiting anyway
            pass

    def run(self) -> None:
        srv = self.server
        while True:
            with self._lock:
                if self._stopped:
                    break
                newly, self._incoming = self._incoming, []
            for conn in newly:
                try:
                    self._sel.register(
                        conn.sock, selectors.EVENT_READ, conn)
                except (KeyError, ValueError, OSError):
                    srv._close(conn)
            wait = max(0.05, min(
                1.0, srv.config.keepalive_idle_seconds / 4))
            try:
                events = self._sel.select(wait)
            except OSError:
                events = []
            for key, _ in events:
                if key.data is None:
                    try:
                        while self._rsock.recv(4096):
                            pass
                    except (BlockingIOError, OSError):  # wake-pipe drain; empty is the normal exit
                        pass
                    continue
                try:
                    self._sel.unregister(key.fileobj)
                except (KeyError, ValueError):  # socket raced to close; dispatch still owns the conn
                    pass
                srv._dispatch.put(key.data)
            now = time.monotonic()
            idle = srv.config.keepalive_idle_seconds
            for key in list(self._sel.get_map().values()):
                conn = key.data
                if conn is None or now - conn.parked_at < idle:
                    continue
                try:
                    self._sel.unregister(key.fileobj)
                except (KeyError, ValueError):  # socket raced to close; reap proceeds
                    pass
                METRICS.counter("ingress_idle_reaped_total",
                                component=srv.component).inc()
                srv._close(conn)
        for key in list(self._sel.get_map().values()):
            if key.data is not None:
                self.server._close(key.data)
        with self._lock:
            leftover, self._incoming = self._incoming, []
        for conn in leftover:
            self.server._close(conn)
        try:
            self._sel.close()
        except OSError:  # final teardown; nothing left to leak
            pass
        self._rsock.close()
        self._wsock.close()


class IngressHTTPServer(HTTPServer):
    """Drop-in ``ThreadingHTTPServer`` replacement (same constructor
    shape, ``serve_forever``/``shutdown``/``server_close`` surface)
    with the bounded-pool + keep-alive + admission core."""

    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128  # kernel listen() backlog

    def __init__(self, server_address, HandlerClass, *,
                 config: Optional[IngressConfig] = None,
                 component: str = "http"):
        super().__init__(server_address, HandlerClass)
        self.config = config or _DEFAULT
        self.component = component
        #: Optional QosEngine: when set (S3 gateway), pressure shedding
        #: is class-aware and happens after auth in the handler, not in
        #: the generic admission gate.
        self.qos: Optional[QosEngine] = None
        self.admission = AdmissionController(self)
        self._handler_cls = _one_shot(HandlerClass)
        self._dispatch: "queue.Queue[Optional[_Conn]]" = queue.Queue()
        self._conns: set[_Conn] = set()
        self._lock = threading.Lock()
        self._busy = 0
        self._served = 0
        self._closing = False
        self._workers = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"ingress-{component}-w{i}")
            for i in range(self.config.workers)]
        for t in self._workers:
            t.start()
        self._parker = _Parker(self)
        self._parker.start()
        _SERVERS.add(self)

    # -- accept path (runs on the serve_forever thread) ------------------

    def process_request(self, request, client_address):
        cfg = self.config
        with self._lock:
            over = self._closing or len(self._conns) >= cfg.max_connections
            if not over:
                conn = _Conn(request, client_address)
                self._conns.add(conn)
        if over:
            _count_shed("connections", "anonymous")
            try:
                request.settimeout(1.0)
                request.sendall(
                    b"HTTP/1.1 429 Too Many Requests\r\n"
                    b"Retry-After: %d\r\nContent-Length: 0\r\n"
                    b"Connection: close\r\n\r\n"
                    % max(1, int(cfg.retry_after_seconds)))
            except OSError:  # best-effort courtesy 429; peer may already be gone
                pass
            self.shutdown_request(request)
            return
        try:
            request.settimeout(cfg.request_read_timeout)
        except OSError:  # socket died at accept; worker read will surface it
            pass
        METRICS.counter("ingress_connections_total",
                        component=self.component).inc()
        self._dispatch.put(conn)

    # -- worker pool ------------------------------------------------------

    def _work(self) -> None:
        while True:
            conn = self._dispatch.get()
            if conn is None:
                return
            with self._lock:
                self._busy += 1
            try:
                self._service(conn)
            except Exception as e:  # noqa: BLE001 — conn dies, pool lives
                glog.v(1, "ingress %s: connection from %s died: %s: %s",
                       self.component, conn.addr, type(e).__name__, e)
                self._close(conn)
            finally:
                with self._lock:
                    self._busy -= 1

    def _service(self, conn: _Conn) -> None:
        cfg = self.config
        if conn.handler is None:
            try:
                # single-owner handoff
                conn.handler = self._handler_cls(
                    conn.sock, conn.addr, self)
            except Exception:  # noqa: BLE001 — setup failed, drop it
                self._close(conn)
                return
        h = conn.handler
        while True:
            h.close_connection = True
            h._ingress_last = \
                conn.requests + 1 >= cfg.keepalive_max_requests
            try:
                h.handle_one_request()
            except (ConnectionError, TimeoutError, OSError):
                self._close(conn)
                return
            with self._lock:
                self._served += 1
            if getattr(h, "_ingress_drop", False) or h.close_connection:
                self._close(conn)
                return
            # single-owner handoff
            conn.requests += 1
            if conn.requests >= cfg.keepalive_max_requests:
                self._close(conn)
                return
            state = self._pending(conn)
            if state == "data":
                if self._dispatch.qsize() == 0:
                    continue  # nothing else waiting; stay inline
                self._dispatch.put(conn)  # yield between pipelined reqs
                return
            if state == "idle":
                self._parker.park(conn)
                return
            self._close(conn)  # eof / error
            return

    def _pending(self, conn: _Conn) -> str:
        """After a response: 'data' (next request bytes already here),
        'idle' (park it), or 'eof' (peer gone). Checks the handler's
        rfile buffer first — a pipelined request may have been pulled
        off the wire by a buffered readline — then MSG_PEEKs the
        socket to distinguish idle from EOF."""
        sock = conn.sock
        try:
            sock.setblocking(False)
            try:
                buf = conn.handler.rfile.peek(1)
            except (BlockingIOError, InterruptedError):
                buf = b""
            if buf:
                return "data"
            try:
                probe = sock.recv(1, socket.MSG_PEEK)
                return "data" if probe else "eof"
            except (BlockingIOError, InterruptedError):
                return "idle"
        except (OSError, ValueError):
            return "eof"
        finally:
            try:
                sock.settimeout(self.config.request_read_timeout)
            except OSError:  # peer closed mid-probe; next read reports eof
                pass

    def _close(self, conn: _Conn) -> None:
        with self._lock:
            self._conns.discard(conn)
        if conn.handler is not None:
            try:
                socketserver.StreamRequestHandler.finish(conn.handler)
            except Exception:  # noqa: BLE001 — flush on an already-dead socket
                pass
            conn.handler = None
        try:
            self.shutdown_request(conn.sock)
        except Exception:  # noqa: BLE001 — close on an already-dead socket
            pass

    # -- pressure + introspection ----------------------------------------

    def pressure(self) -> float:
        """Dispatch-queue fill against the configured logical depth
        (can exceed 1.0 — the physical bound is max_connections)."""
        return self._dispatch.qsize() / max(1, self.config.queue_depth)

    def stats_payload(self) -> dict:
        with self._lock:
            busy, conns, served = self._busy, len(self._conns), \
                self._served
        return {"component": self.component,
                "workers": self.config.workers, "busy": busy,
                "queued": self._dispatch.qsize(),
                "queue_depth": self.config.queue_depth,
                "pressure": round(self.pressure(), 4),
                "connections": conns,
                "max_connections": self.config.max_connections,
                "parked": self._parker.parked(),
                "served_total": served,
                "qos": self.qos.payload() if self.qos else None}

    # -- teardown ---------------------------------------------------------

    def server_close(self) -> None:
        with self._lock:
            self._closing = True
        self._parker.stop()
        for _ in self._workers:
            self._dispatch.put(None)
        super().server_close()
        with self._lock:
            conns = list(self._conns)
        for c in conns:  # unblocks workers stuck mid-read
            try:
                c.sock.close()
            except OSError:  # shutdown path; double-close is fine
                pass
        for t in self._workers:
            t.join(timeout=2.0)
        self._parker.join(timeout=2.0)
        with self._lock:
            self._conns.clear()


def debug_payload() -> dict:
    """The ``ingress`` section of ``/debug/vars``."""
    return {"enabled": _ENABLED,
            "servers": [s.stats_payload() for s in list(_SERVERS)
                        if not s._closing],
            "shed": shed_counts()}


# --------------------------------------------------------------------------
# admission control
# --------------------------------------------------------------------------

class AdmissionController:
    """Per-request decisions taken between header parse and the
    application verb (the earliest point a policy answer can still be
    a well-formed HTTP response)."""

    __slots__ = ("server",)

    def __init__(self, server: IngressHTTPServer):
        self.server = server

    def check(self, handler) -> Optional[tuple]:
        """None to admit, else ``(status, reason, retry_after)``."""
        cfg = self.server.config
        val = handler.headers.get(DEADLINE_HEADER)
        if val:
            try:
                remaining = float(val)
            except (TypeError, ValueError):
                remaining = None
            if remaining is not None \
                    and remaining <= cfg.min_deadline_seconds:
                return (504, "deadline", None)
        if getattr(self.server, "qos", None) is None \
                and not handler.path.startswith(_EXEMPT_PREFIXES):
            if self.server.pressure() >= cfg.shed_watermark:
                return (429, "pressure", cfg.retry_after_seconds)
        return None


def reject(handler, status: int, reason: str,
           retry_after: Optional[float] = None,
           cls_name: str = "anonymous") -> None:
    """Answer a shed decision: counted, span-tagged, keep-alive kept
    (a policy rejection is a healthy connection speaking clearly)."""
    _count_shed(reason, cls_name)
    body = json.dumps({"error": "request shed by admission control",
                       "reason": reason, "class": cls_name}).encode()
    try:
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        if retry_after:
            handler.send_header(
                "Retry-After", str(max(1, int(math.ceil(retry_after)))))
        handler.end_headers()
        if handler.command != "HEAD":
            handler.wfile.write(body)
    except OSError:
        handler.close_connection = True


def drop_connection(handler) -> None:
    """Mark the connection for a hard close with no response — the
    fault-injection ``drop`` action must look like a connection reset,
    and on a keep-alive connection a half-written exchange would
    poison the next pipelined request."""
    handler._ingress_drop = True
    handler.close_connection = True


def admission_gate(cls):
    """Wrap every ``do_*`` verb with the admission check. Apply
    *before* ``tracing.instrument_http_handler`` so the trace span is
    outermost and shed decisions land inside it as tags."""
    for name in dir(cls):
        if name.startswith("do_"):
            setattr(cls, name, _gated(getattr(cls, name)))
    return cls


def _gated(fn):
    if getattr(fn, "_ingress_gated", False):
        return fn

    def gated(self):
        srv = getattr(self, "server", None)
        ctrl = getattr(srv, "admission", None)
        if ctrl is None or not _ENABLED:
            return fn(self)
        METRICS.counter("ingress_requests_total",
                        component=srv.component).inc()
        decision = ctrl.check(self)
        if decision is None:
            return fn(self)
        reject(self, *decision)

    gated._ingress_gated = True
    gated.__name__ = fn.__name__
    gated.__qualname__ = getattr(fn, "__qualname__", fn.__name__)
    return gated


# --------------------------------------------------------------------------
# per-tenant QoS (S3 gateway)
# --------------------------------------------------------------------------

class QosShed(Exception):
    """A QoS rejection — mapped to 429 + Retry-After at the gateway."""

    def __init__(self, tenant: str, cls_name: str, reason: str,
                 retry_after: float = 1.0):
        super().__init__(
            f"tenant {tenant!r} (class {cls_name}) shed: {reason}")
        self.tenant = tenant
        self.class_name = cls_name
        self.reason = reason
        self.retry_after = retry_after


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second up to ``burst``."""

    __slots__ = ("rate", "burst", "tokens", "stamp", "clock", "_lock")

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.clock = clock
        self.stamp = clock()
        self._lock = threading.Lock()

    def take(self) -> float:
        """0.0 when a token was granted, else seconds until one is."""
        with self._lock:
            now = self.clock()
            self.tokens = min(
                self.burst,
                self.tokens + (now - self.stamp) * self.rate)
            self.stamp = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return 0.0
            if self.rate <= 0:
                return 1.0
            return (1.0 - self.tokens) / self.rate


class QosClass:
    __slots__ = ("name", "priority", "rate", "burst", "concurrency")

    def __init__(self, name: str, priority: int = 1, rate: float = 0.0,
                 burst: float = 0.0, concurrency: int = 0):
        self.name = name
        self.priority = max(0, int(priority))
        self.rate = float(rate)        # req/s; 0 = unlimited
        self.burst = float(burst) or max(1.0, self.rate)
        self.concurrency = int(concurrency)  # in-flight; 0 = unlimited

    def to_dict(self) -> dict:
        return {"priority": self.priority, "rate_per_second": self.rate,
                "burst": self.burst, "concurrency": self.concurrency}


class QosLease:
    """Releases the tenant's in-flight slot exactly once."""

    __slots__ = ("_engine", "_tenant", "_done")

    def __init__(self, engine: "QosEngine", tenant: str):
        self._engine = engine
        self._tenant = tenant
        self._done = False

    def release(self) -> None:
        if not self._done:
            self._done = True
            self._engine._release(self._tenant)

    def __enter__(self) -> "QosLease":
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class QosEngine:
    """Priority classes + per-tenant token buckets/concurrency caps.

    Pressure shedding is priority-laddered: class priority ``p`` sheds
    when ingress pressure reaches ``watermark ** p`` — the lowest
    priority gives way earliest, priority 0 ("guaranteed") is never
    pressure-shed and only its own explicit rate/concurrency limits
    (if any) can reject it.
    """

    def __init__(self, classes: Optional[dict] = None,
                 tenants: Optional[dict] = None,
                 default_class: str = "standard",
                 watermark: float = 0.75, clock=time.monotonic):
        self.classes: dict[str, QosClass] = dict(classes or {})
        if default_class not in self.classes:
            self.classes[default_class] = QosClass(default_class)
        self.tenants = {str(k): str(v)
                        for k, v in (tenants or {}).items()}
        self.default_class = default_class
        self.watermark = float(watermark)
        self.clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self._admitted = 0
        self._shed = 0
        self._lock = threading.Lock()

    def class_of(self, tenant: str) -> QosClass:
        name = self.tenants.get(tenant, self.default_class)
        return self.classes.get(name) or self.classes[self.default_class]

    def shed_threshold(self, qc: QosClass) -> float:
        if qc.priority <= 0:
            return float("inf")
        return self.watermark ** qc.priority

    def admit(self, tenant: str, pressure: float = 0.0) -> QosLease:
        qc = self.class_of(tenant)
        if pressure >= self.shed_threshold(qc):
            self._reject(tenant, qc, "pressure", 1.0)
        if qc.rate > 0:
            with self._lock:
                bucket = self._buckets.get(tenant)
                if bucket is None or bucket.rate != qc.rate:
                    bucket = self._buckets[tenant] = TokenBucket(
                        qc.rate, qc.burst, self.clock)
            wait = bucket.take()
            if wait > 0:
                self._reject(tenant, qc, "rate", wait)
        with self._lock:
            inflight = self._inflight.get(tenant, 0)
            over = 0 < qc.concurrency <= inflight
            if not over:
                self._inflight[tenant] = inflight + 1
                self._admitted += 1
        if over:
            self._reject(tenant, qc, "concurrency", 1.0)
        METRICS.counter("ingress_qos_admitted_total",
                        **{"class": qc.name}).inc()
        return QosLease(self, tenant)

    def _reject(self, tenant: str, qc: QosClass, reason: str,
                retry_after: float):
        with self._lock:
            self._shed += 1
        _count_shed(reason, qc.name)
        raise QosShed(tenant, qc.name, reason,
                      max(1.0, math.ceil(retry_after)))

    def _release(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0) - 1
            if n <= 0:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n

    def payload(self) -> dict:
        with self._lock:
            return {"default_class": self.default_class,
                    "watermark": self.watermark,
                    "classes": {n: c.to_dict()
                                for n, c in self.classes.items()},
                    "tenants": dict(self.tenants),
                    "inflight": dict(self._inflight),
                    "admitted_total": self._admitted,
                    "shed_total": self._shed}


def qos_from_conf(conf: Optional[dict]) -> Optional[QosEngine]:
    """Build a :class:`QosEngine` from a ``[qos]`` TOML block, or None
    when absent/disabled. Schema (subset-parser-safe — scalar values,
    dotted tables only)::

        [qos]
        enabled = true
        default_class = "standard"
        watermark = 0.75

        [qos.class.gold]
        priority = 0          # 0 = guaranteed, never pressure-shed
        rate_per_second = 0.0 # 0 = unlimited
        burst = 0.0
        concurrency = 0       # 0 = unlimited

        [qos.tenant]
        alice = "gold"
    """
    sec = (conf or {}).get("qos")
    if not isinstance(sec, dict) or not sec.get("enabled", False):
        return None
    classes = {}
    for name, c in (sec.get("class") or {}).items():
        if not isinstance(c, dict):
            continue
        classes[name] = QosClass(
            name, priority=int(c.get("priority", 1)),
            rate=float(c.get("rate_per_second", 0.0)),
            burst=float(c.get("burst", 0.0)),
            concurrency=int(c.get("concurrency", 0)))
    tenants = {k: v for k, v in (sec.get("tenant") or {}).items()
               if isinstance(v, str)}
    return QosEngine(
        classes, tenants,
        default_class=str(sec.get("default_class", "standard")),
        watermark=float(sec.get("watermark", _DEFAULT.shed_watermark)))
