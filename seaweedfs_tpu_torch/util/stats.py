"""Prometheus-text metrics registry.

The port's copy of the part of ``seaweedfs_tpu/util/stats.py`` that the
flight recorder (pipeline/flight.py) uses: counters, gauges and latency
histograms addressable by name and labels, rendered in the Prometheus
exposition format byte for byte as the JAX package renders them, and
the ``MetricsPusher`` a volume server starts when its master advertises
a push gateway. Left out: the ``Digest`` quantile sketch, which only the
telemetry plane uses (ROADMAP Queue 1, "Telemetry, SLO, usage and the
policy engine").
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from typing import Iterable, Optional

DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: Content-Type servers must send on ``/metrics`` responses.
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4"


def _escape_label_value(v: str) -> str:
    # Exposition-format escaping: backslash first, then quote/newline.
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self.value += float(amount)


class Histogram:
    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0
        #: bucket index -> (exemplar_id, value, unix_ts): the most
        #: recent exemplar observed per bucket (one slot per bucket
        #: keeps storage O(buckets), never O(observations)).
        self.exemplars: dict[int, tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        with self._lock:
            i = bisect_right(self.buckets, value)
            self.counts[i] += 1
            self.total += value
            self.n += 1
            if exemplar:
                self.exemplars[i] = (exemplar, value, time.time())


class Metrics:
    """One registry per server process."""

    def __init__(self, namespace: str = "seaweedfs_tpu"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple, str], object] = {}
        # the JAX package registers the registry with its lockset race
        # checker here; the checkers wait for their port (ROADMAP
        # Queue 1, "The sim harness, the lint and the checkers")

    def _get(self, kind: str, name: str, labels: dict[str, str],
             factory):
        key = (name, tuple(sorted((labels or {}).items())), kind)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels, Histogram)

    def render(self) -> str:
        """Prometheus exposition text."""
        lines: list[str] = []
        with self._lock:
            items = sorted(self._metrics.items(),
                           key=lambda kv: (kv[0][0], kv[0][1]))
        for (name, labels, kind), m in items:
            full = f"{self.namespace}_{name}"
            lab = _fmt_labels(dict(labels))
            if kind == "counter":
                lines.append(f"# TYPE {full} counter")
                lines.append(f"{full}{lab} {m.value}")
            elif kind == "gauge":
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full}{lab} {m.value}")
            else:
                lines.append(f"# TYPE {full} histogram")
                cum = 0
                for b, c in zip(m.buckets, m.counts):
                    cum += c
                    le = dict(labels); le["le"] = "%g" % b
                    lines.append(f"{full}_bucket{_fmt_labels(le)} {cum}")
                le = dict(labels); le["le"] = "+Inf"
                lines.append(
                    f"{full}_bucket{_fmt_labels(le)} {m.n}")
                lines.append(f"{full}_sum{lab} {m.total}")
                lines.append(f"{full}_count{lab} {m.n}")
                # Exemplars ride as comment lines, NOT OpenMetrics
                # ``... # {trace_id=..}`` suffixes: the 0.0.4 text
                # format (and the strict mini parser the smoke scripts
                # run) treats unknown ``#`` lines as comments, so the
                # trace link is greppable without breaking any scraper.
                # trace_id here is an exemplar annotation, not a metric
                # label — cardinality stays one slot per bucket.
                for i in sorted(m.exemplars):
                    ex_id, ex_val, ex_ts = m.exemplars[i]
                    le = dict(labels)
                    le["le"] = ("%g" % m.buckets[i]
                                if i < len(m.buckets) else "+Inf")
                    lines.append(
                        f"# EXEMPLAR {full}_bucket{_fmt_labels(le)} "
                        f'trace_id="{_escape_label_value(ex_id)}" '
                        f"value={ex_val:g} ts={ex_ts:.3f}")
        return "\n".join(lines) + "\n"


class MetricsPusher:
    """Prometheus push-gateway client (weed/stats push mode): POSTs the
    text exposition to ``http://<addr>/metrics/job/<job>/instance/<i>``
    on an interval. Best-effort — an unreachable gateway is counted,
    never fatal, and the interval keeps ticking."""

    def __init__(self, metrics: "Metrics", address: str, job: str,
                 instance: str, interval_seconds: float = 15.0):
        import threading

        self.metrics = metrics
        self.address = address
        self.job = job
        self.instance = instance
        self.interval = max(1.0, interval_seconds)
        self.pushed = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # stop()'s final flush runs on the caller's thread and the
        # join above it has a timeout: a hung push means BOTH threads
        # can be inside push_once at once, so the counters need a lock
        self._count_lock = threading.Lock()

    def start(self) -> "MetricsPusher":
        import threading

        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"metrics-push-{self.job}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        # Final best-effort push so metrics from the last interval
        # aren't lost at shutdown.
        self.push_once()

    def push_once(self) -> bool:
        import urllib.request

        url = (f"http://{self.address}/metrics/job/{self.job}"
               f"/instance/{self.instance}")
        body = self.metrics.render().encode()
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "text/plain"})
        try:
            # best-effort fire-and-forget push to an out-of-cluster
            # gateway: a breaker/retry would add queueing where dropping
            # a sample is the right behaviour; bounded by the 5 s timeout
            with urllib.request.urlopen(req, timeout=5):
                with self._count_lock:
                    self.pushed += 1
                return True
        except Exception:  # noqa: BLE001 — gateway may be down
            with self._count_lock:
                self.errors += 1
            return False

    def _run(self) -> None:
        # immediate first push, then the interval cadence
        while not self._stop.is_set():
            self.push_once()
            if self._stop.wait(self.interval):
                return
