"""Unified resilience policy layer: retry + deadline + circuit breaker.

Every HTTP call between cluster nodes (in the port so far, the volume
server's replica fan-out; the JAX package's clients and sinks too) goes
through :func:`http_request` instead of a bare
``urllib.request.urlopen``:

* **Retry** — capped exponential backoff with full jitter, but only for
  errors :func:`retryable` classifies as transient (connection faults,
  timeouts, 5xx/429, injected :class:`~.faults.FaultError`). A 4xx is
  the server speaking clearly and is raised immediately.
* **Deadline budgets** — each request runs under a
  :class:`Deadline`. An ingress handler that received an
  ``X-Seaweed-Deadline`` header adopts the caller's remaining budget
  via :func:`deadline_scope`, so a client's 60s budget bounds the
  downstream calls too — retries never outlive the caller's patience.
* **Circuit breaker** — per-endpoint (host:port) failure tracking:
  after ``breaker_threshold`` consecutive failures the breaker opens
  and calls fail fast with :class:`BreakerOpenError` (a ``URLError``,
  so replica-failover loops treat it as one more dead replica) until a
  half-open probe succeeds after ``breaker_cooldown`` seconds. State
  surfaces in :data:`METRICS`; ``fault.clear -breakers`` resets it.

Fault points (:mod:`.faults`) are compiled in: the armed point fires
before the wire call and its data actions mangle the response body, so
injected chaos exercises exactly this machinery.

The module also owns the ``seaweed_degraded_reads_total`` counter —
each hop of the graceful read-degradation ladder (replica -> replica ->
EC decode) calls :func:`record_degraded`.

Config lives in a ``[retry]`` TOML block.

The port's copy of ``seaweedfs_tpu/util/retry.py``: :func:`inject`
stamps the trace context beside the deadline, and
:func:`record_degraded` tags the active span.
:func:`degraded_counts` reads the degraded-read counts by stage without
parsing the metrics text.
"""

from __future__ import annotations

import http.client
import io
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from . import faults, stats, tracing

DEADLINE_HEADER = "X-Seaweed-Deadline"

#: Resilience metrics (``seaweed_retries_total``,
#: ``seaweed_degraded_reads_total``, ``seaweed_breaker_state`` ...).
#: Servers append ``METRICS.render()`` to their ``/metrics`` output.
METRICS = stats.Metrics(namespace="seaweed")

#: HTTP statuses worth retrying: the server (or an LB in front of it)
#: says "not right now", not "never".
RETRYABLE_STATUSES = frozenset((429, 500, 502, 503, 504))


class DeadlineExceeded(TimeoutError):
    pass


class Deadline:
    """A monotonic spend-down budget for one logical request."""

    __slots__ = ("budget", "_until")

    def __init__(self, budget_seconds: float):
        self.budget = float(budget_seconds)
        self._until = time.monotonic() + self.budget

    def remaining(self) -> float:
        return self._until - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def header_value(self) -> str:
        return f"{max(0.0, self.remaining()):.3f}"


class RetryPolicy:
    """Backoff shape + attempt/time budgets. ``backoff(attempt)`` is
    full-jitter: uniform in [0, min(max_delay, base * 2^attempt)] —
    the AWS-style spread that keeps retry storms from synchronizing."""

    __slots__ = ("max_attempts", "base_delay", "max_delay", "timeout",
                 "failover_budget", "breaker_threshold",
                 "breaker_cooldown")

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, timeout: float = 60.0,
                 failover_budget: float = 5.0,
                 breaker_threshold: int = 5,
                 breaker_cooldown: float = 5.0):
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        #: Default per-request deadline budget (seconds) when no
        #: ambient deadline is active — the config-driven replacement
        #: for the old hardcoded ``urlopen(timeout=60)`` literals.
        self.timeout = timeout
        #: Cap on master leader-failover loops waiting out an election.
        self.failover_budget = failover_budget
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown

    def backoff(self, attempt: int, rng=random) -> float:
        return rng.uniform(
            0, min(self.max_delay, self.base_delay * (2 ** attempt)))


_POLICY = RetryPolicy()


def policy() -> RetryPolicy:
    return _POLICY


def configure(**kw) -> None:
    """Override individual :class:`RetryPolicy` fields at runtime."""
    for k, v in kw.items():
        if v is None:
            continue
        if not hasattr(_POLICY, k):
            raise AttributeError(f"no retry policy field {k!r}")
        setattr(_POLICY, k, v)


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[retry]`` block (missing keys keep
    their current values)."""
    from . import config as config_mod
    configure(
        max_attempts=config_mod.lookup(conf, "retry.max_attempts"),
        base_delay=config_mod.lookup(conf, "retry.base_delay_seconds"),
        max_delay=config_mod.lookup(conf, "retry.max_delay_seconds"),
        timeout=config_mod.lookup(conf, "retry.request_timeout_seconds"),
        failover_budget=config_mod.lookup(
            conf, "retry.failover_budget_seconds"),
        breaker_threshold=config_mod.lookup(
            conf, "retry.breaker.failure_threshold"),
        breaker_cooldown=config_mod.lookup(
            conf, "retry.breaker.cooldown_seconds"))
    v = config_mod.lookup(conf, "retry.pool.max_idle_per_host")
    if v is not None:
        _POOL.max_idle_per_host = int(v)
    v = config_mod.lookup(conf, "retry.pool.idle_seconds")
    if v is not None:
        _POOL.idle_seconds = float(v)


# --------------------------------------------------------------------------
# deadline propagation
# --------------------------------------------------------------------------

_STATE = threading.local()


def current_deadline() -> Optional[Deadline]:
    st = getattr(_STATE, "deadlines", None)
    return st[-1] if st else None


class _DeadlineScope:
    """Context manager pushing a deadline for this thread; ``None``
    budgets are a no-op so ingress handlers can pass whatever the
    header parse produced without branching."""

    __slots__ = ("_dl",)

    def __init__(self, dl: Optional[Deadline]):
        self._dl = dl

    def __enter__(self) -> Optional[Deadline]:
        if self._dl is not None:
            st = getattr(_STATE, "deadlines", None)
            if st is None:
                st = _STATE.deadlines = []
            st.append(self._dl)
        return self._dl

    def __exit__(self, *exc) -> bool:
        if self._dl is not None:
            st = _STATE.deadlines
            if st and st[-1] is self._dl:
                st.pop()
        return False


def deadline_scope(budget) -> _DeadlineScope:
    """``budget`` is seconds, a :class:`Deadline`, or None (no-op)."""
    if budget is None or isinstance(budget, Deadline):
        return _DeadlineScope(budget)
    return _DeadlineScope(Deadline(float(budget)))


def deadline_from_headers(headers) -> Optional[Deadline]:
    """Adopt the caller's remaining budget from ``X-Seaweed-Deadline``
    (a relative seconds value — absolute stamps would need synchronized
    clocks). Returns None when absent/garbled."""
    val = headers.get(DEADLINE_HEADER) if headers is not None else None
    if not val:
        return None
    try:
        return Deadline(max(0.0, float(val)))
    except (TypeError, ValueError):
        return None


def inject(headers: dict, deadline: Optional[Deadline] = None) -> dict:
    """Stamp trace context + remaining deadline onto outgoing headers."""
    tracing.inject(headers)
    dl = deadline or current_deadline()
    if dl is not None:
        headers[DEADLINE_HEADER] = dl.header_value()
    return headers


# --------------------------------------------------------------------------
# error classification
# --------------------------------------------------------------------------

def retryable(exc: BaseException) -> bool:
    """Is this error worth another attempt? HTTP 4xx means the request
    itself is wrong — never retried; everything that smells like a
    transport or server-side transient is."""
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in RETRYABLE_STATUSES
    return isinstance(exc, (urllib.error.URLError, ConnectionError,
                            TimeoutError, faults.FaultError, OSError))


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

class BreakerOpenError(urllib.error.URLError):
    """Raised instead of dialing while a breaker is open. A URLError,
    so replica-failover loops skip to the next location."""

    def __init__(self, endpoint: str):
        super().__init__(f"circuit breaker open for {endpoint}")
        self.endpoint = endpoint


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe.

    closed -> (threshold consecutive failures) -> open
    open   -> (cooldown elapses) -> half-open: ONE probe call allowed
    half-open -> success -> closed | failure -> open (timer resets)
    """

    __slots__ = ("key", "threshold", "cooldown", "failures", "state",
                 "opened_at", "open_count", "_probing", "_lock")

    def __init__(self, key: str, threshold: Optional[int] = None,
                 cooldown: Optional[float] = None):
        self.key = key
        self.threshold = threshold if threshold is not None \
            else _POLICY.breaker_threshold
        self.cooldown = cooldown if cooldown is not None \
            else _POLICY.breaker_cooldown
        self.failures = 0
        self.state = "closed"
        self.opened_at = 0.0
        self.open_count = 0
        self._probing = False
        self._lock = threading.Lock()

    def _gauge(self) -> None:
        # closed=0, half_open=0.5, open=1 — graphable as "how broken"
        val = {"closed": 0.0, "half_open": 0.5, "open": 1.0}[self.state]
        METRICS.gauge("breaker_state", endpoint=self.key).set(val)

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if time.monotonic() - self.opened_at < self.cooldown:
                    return False
                self.state = "half_open"
                self._probing = True
                self._gauge()
                return True
            # half-open: exactly one in-flight probe
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._probing = False
            if self.state != "closed":
                self.state = "closed"
                self._gauge()

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._probing = False
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self.failures >= self.threshold):
                self.state = "open"
                self.opened_at = time.monotonic()
                self.open_count += 1
                self._gauge()
                METRICS.counter("breaker_open_total",
                                endpoint=self.key).inc()
            elif self.state == "open":
                self.opened_at = time.monotonic()

    def to_dict(self) -> dict:
        with self._lock:
            return {"endpoint": self.key, "state": self.state,
                    "consecutive_failures": self.failures,
                    "open_count": self.open_count,
                    "threshold": self.threshold,
                    "cooldown_seconds": self.cooldown}


_BREAKERS: dict[str, CircuitBreaker] = {}
_BREAKERS_LOCK = threading.Lock()


def breaker_for(endpoint: str) -> CircuitBreaker:
    brk = _BREAKERS.get(endpoint)
    if brk is None:
        with _BREAKERS_LOCK:
            brk = _BREAKERS.setdefault(endpoint,
                                       CircuitBreaker(endpoint))
    return brk


def breakers_payload() -> list[dict]:
    """The breakers section of ``/debug/vars``."""
    with _BREAKERS_LOCK:
        brks = list(_BREAKERS.values())
    return [b.to_dict() for b in brks]


def reset_breakers() -> None:
    """Forget all breaker state (tests, ``fault.clear -breakers``)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()


# --------------------------------------------------------------------------
# client connection pooling
# --------------------------------------------------------------------------

class _IdleConn:
    __slots__ = ("conn", "last_used")

    def __init__(self, conn):
        self.conn = conn
        self.last_used = time.monotonic()


class ConnectionPool:
    """Persistent ``http.client`` connections keyed by ``host:port``.

    Every intra-cluster hop (gateway -> filer -> master -> volume)
    used to pay a fresh TCP handshake per request because urllib sends
    ``Connection: close``. With the ingress core speaking real
    HTTP/1.1 keep-alive, the client side can finally hold sockets
    open: release() parks a clean connection, acquire() hands it back
    for the next request to the same endpoint. Stale sockets (server
    reaped the idle connection first) surface as an immediate
    RemoteDisconnected and cost one transparent redial, never a
    user-visible failure.
    """

    def __init__(self, max_idle_per_host: int = 4,
                 idle_seconds: float = 30.0):
        self.max_idle_per_host = max_idle_per_host
        self.idle_seconds = idle_seconds
        self._idle: dict[str, list[_IdleConn]] = {}
        self._lock = threading.Lock()

    def acquire(self, netloc: str, timeout: float):
        """-> (connection, reused). The caller owns the connection
        until release()/discard()."""
        now = time.monotonic()
        while True:
            with self._lock:
                stack = self._idle.get(netloc)
                ic = stack.pop() if stack else None
            if ic is None:
                break
            conn = ic.conn
            if now - ic.last_used > self.idle_seconds \
                    or conn.sock is None:
                self.discard(conn)
                continue
            try:
                conn.sock.settimeout(timeout)
            except OSError:
                self.discard(conn)
                continue
            METRICS.counter("pool_reuse_total").inc()
            return conn, True
        host, _, port = netloc.partition(":")
        conn = http.client.HTTPConnection(
            host, int(port) if port else 80, timeout=timeout)
        METRICS.counter("pool_dial_total").inc()
        return conn, False

    def release(self, netloc: str, conn) -> None:
        """Park a connection whose response was fully read."""
        with self._lock:
            stack = self._idle.setdefault(netloc, [])
            if len(stack) < self.max_idle_per_host:
                stack.append(_IdleConn(conn))
                return
        self.discard(conn)

    def discard(self, conn) -> None:
        try:
            conn.close()
        except Exception:  # noqa: BLE001  # seaweedlint: disable=SW301 — discarding a dead connection
            pass

    def clear(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
        for stack in idle.values():
            for ic in stack:
                self.discard(ic.conn)

    def idle_count(self, netloc: Optional[str] = None) -> int:
        with self._lock:
            if netloc is not None:
                return len(self._idle.get(netloc, ()))
            return sum(len(s) for s in self._idle.values())

    def payload(self) -> dict:
        """The ``http_pool`` section of ``/debug/vars``."""
        with self._lock:
            return {"max_idle_per_host": self.max_idle_per_host,
                    "idle_seconds": self.idle_seconds,
                    "idle": {k: len(v) for k, v in self._idle.items()
                             if v}}


_POOL = ConnectionPool()

#: Sockets that died between requests (server closed the idle keep-
#: alive first): retried once on a fresh dial without consuming an
#: attempt or tripping the breaker — the endpoint never saw it.
_STALE_ERRORS = (http.client.RemoteDisconnected,
                 http.client.CannotSendRequest, ConnectionResetError,
                 ConnectionAbortedError, BrokenPipeError)


def pool() -> ConnectionPool:
    return _POOL


def close_pool() -> None:
    """Drop every idle pooled connection (tests, fault drills)."""
    _POOL.clear()


def _pooled_request(url: str, netloc: str, selector: str, method: str,
                    data: Optional[bytes], hdrs: dict,
                    timeout: float, point: str):
    """One wire exchange over a pooled connection. Returns
    ``(status, headers, body)``; raises ``HTTPError`` for >= 400 (body
    attached, connection still reusable — the endpoint answered) and
    wraps transport errors in ``URLError`` so callers' existing
    ``except urllib.error.*`` clauses keep working."""
    stale_redial = False
    while True:
        conn, reused = _POOL.acquire(netloc, timeout)
        try:
            # The armed fault point fires while holding the pooled
            # connection: a ``drop`` kills *this* socket, exactly like
            # a peer reset would, instead of poisoning the pool.
            faults.check(point)
            conn.request(method, selector, body=data, headers=hdrs)
            resp = conn.getresponse()
            body = resp.read()
        except faults.FaultError:
            _POOL.discard(conn)
            raise
        except Exception as e:  # noqa: BLE001 — transport layer
            _POOL.discard(conn)
            if reused and not stale_redial \
                    and isinstance(e, _STALE_ERRORS):
                stale_redial = True
                METRICS.counter("pool_stale_redial_total").inc()
                continue
            if isinstance(e, urllib.error.URLError):
                raise
            raise urllib.error.URLError(e) from e
        mangled = faults.mangle(point, body)
        if mangled is not body:
            # truncate/corrupt actions simulate a wire cut mid-body;
            # a connection that "lost" bytes must not serve the next
            # pipelined request.
            _POOL.discard(conn)
            body = mangled
        elif resp.will_close:
            _POOL.discard(conn)
        else:
            _POOL.release(netloc, conn)
        if resp.status >= 400:
            raise urllib.error.HTTPError(
                url, resp.status, resp.reason, resp.headers,
                io.BytesIO(body))
        return resp.status, resp.headers, body


# --------------------------------------------------------------------------
# degraded-read accounting
# --------------------------------------------------------------------------

def record_degraded(stage: str) -> None:
    """Count one hop of the read-degradation ladder
    (``seaweed_degraded_reads_total{stage=...}``) and tag the active
    span so the hop shows up in the request's trace."""
    METRICS.counter("degraded_reads_total", stage=stage).inc()
    sp = tracing.current_span()
    if sp is not None:
        sp.tag(degraded=stage)
    with _DEGRADED_LOCK:
        _DEGRADED[stage] = _DEGRADED.get(stage, 0) + 1


_DEGRADED_LOCK = threading.Lock()
_DEGRADED: dict[str, int] = {}


def degraded_counts() -> dict[str, int]:
    """A snapshot of :func:`record_degraded`'s counts by stage."""
    with _DEGRADED_LOCK:
        return dict(_DEGRADED)


# --------------------------------------------------------------------------
# the HTTP call everyone makes
# --------------------------------------------------------------------------

class HttpResponse:
    __slots__ = ("status", "headers", "data")

    def __init__(self, status: int, headers, data: bytes):
        self.status = status
        self.headers = headers
        self.data = data


def http_request(url: str, data: Optional[bytes] = None,
                 method: Optional[str] = None,
                 headers: Optional[dict] = None, *,
                 point: str = "", jwt: str = "",
                 timeout: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 use_breaker: bool = True) -> HttpResponse:
    """One resilient HTTP request.

    Runs under the thread's ambient :class:`Deadline` when one is
    active (ingress-adopted budgets bound the whole downstream fan-out)
    or a fresh one of ``timeout`` / the policy's default budget.
    Transient failures retry with full-jitter backoff while attempts
    and budget remain; the endpoint's circuit breaker fails fast when
    it is open. Non-retryable ``HTTPError`` raises immediately
    (and counts as breaker *success* — the endpoint answered).
    On exhaustion the last underlying error is re-raised, so callers'
    existing ``except urllib.error.*`` clauses keep working.
    """
    pol = retry_policy or _POLICY
    dl = current_deadline()
    if dl is None:
        dl = Deadline(pol.timeout if timeout is None else timeout)
    brk = breaker_for(urllib.parse.urlsplit(url).netloc) \
        if use_breaker else None
    label = point or "other"
    last: Optional[BaseException] = None
    attempt = 0
    while True:
        if brk is not None and not brk.allow():
            METRICS.counter("breaker_rejected_total",
                            point=label).inc()
            raise BreakerOpenError(brk.key) from last
        try:
            hdrs = dict(headers) if headers else {}
            inject(hdrs, dl)
            if jwt:
                hdrs["Authorization"] = f"BEARER {jwt}"
            att_timeout = min(pol.timeout if timeout is None
                              else timeout, dl.remaining())
            if att_timeout <= 0:
                raise DeadlineExceeded(
                    f"deadline exhausted before attempt {attempt + 1} "
                    f"of {method or 'GET'} {url}")
            parts = urllib.parse.urlsplit(url)
            if parts.scheme == "http":
                selector = parts.path or "/"
                if parts.query:
                    selector += "?" + parts.query
                status, resp_headers, body = _pooled_request(
                    url, parts.netloc, selector,
                    method or ("POST" if data is not None else "GET"),
                    data, hdrs, att_timeout, point)
            else:
                faults.check(point)
                req = urllib.request.Request(
                    url, data=data, method=method, headers=hdrs)
                with urllib.request.urlopen(
                        req, timeout=att_timeout) as r:
                    body = r.read()
                    status = r.status
                    resp_headers = r.headers
                body = faults.mangle(point, body)
            if brk is not None:
                brk.record_success()
            return HttpResponse(status, resp_headers, body)
        except DeadlineExceeded:
            if last is not None:
                raise last
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            if not retryable(e):
                if brk is not None and isinstance(
                        e, urllib.error.HTTPError):
                    brk.record_success()  # endpoint alive, spoke HTTP
                raise
            if brk is not None:
                brk.record_failure()
            METRICS.counter("request_failures_total", point=label).inc()
            last = e
            attempt += 1
            if attempt >= pol.max_attempts:
                break
            delay = pol.backoff(attempt)
            if dl.remaining() <= delay:
                break
            METRICS.counter("retries_total", point=label).inc()
            time.sleep(delay)
    assert last is not None
    raise last
