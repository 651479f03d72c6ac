"""Prometheus-text metrics registry.

The port's copy of ``seaweedfs_tpu/util/stats.py``: counters, gauges and
latency histograms addressable by name and labels, rendered in the
Prometheus exposition format byte for byte as the JAX package renders
them; the ``MetricsPusher`` a volume server starts when its master
advertises a push gateway; and the mergeable ``Digest`` quantile sketch
that the telemetry and usage planes ship on the heartbeat (its
``to_dict`` and proto forms equal the JAX package's for the same
samples).
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


class Digest:
    """Mergeable fixed-size quantile sketch (centroid compaction).

    A simplified t-digest (Dunning & Ertl): samples are buffered, then
    compacted into at most ``max_centroids`` (mean, weight) pairs with
    a uniform per-centroid weight cap (the merging digest's ``k0``
    scale function), so no single centroid can smear more than
    ``~2/max_centroids`` of the rank space — the property that keeps
    body quantiles honest even on bimodal latency data where most of
    the mass piles into one narrow mode. Unlike a histogram the sketch
    is bucket-free, so digests produced on different servers can be
    shipped (proto/JSON) and :meth:`merge`\\ d at the master, and
    ``quantile(0.99)`` still interpolates real sample positions instead
    of bucket edges; 64 centroids bounds the rank error near 1.5% while
    the wire size stays ~1 KiB.

    Thread-safe; all public methods take the internal lock.
    """

    __slots__ = ("max_centroids", "_means", "_weights", "_buf",
                 "min", "max", "count", "sum", "_lock")

    def __init__(self, max_centroids: int = 64):
        if max_centroids < 2:
            raise ValueError("max_centroids must be >= 2")
        self.max_centroids = int(max_centroids)
        self._means: list[float] = []
        self._weights: list[float] = []
        self._buf: list[float] = []
        self.min = float("inf")
        self.max = float("-inf")
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    # -- ingest ---------------------------------------------------

    def add(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._buf.append(value)
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            if len(self._buf) >= self.max_centroids:
                self._compact_locked()

    def merge(self, other: "Digest") -> None:
        """Fold ``other`` into this digest (other is not modified)."""
        with other._lock:
            means = list(other._means) + list(other._buf)
            weights = list(other._weights) + [1.0] * len(other._buf)
            omin, omax = other.min, other.max
            ocount, osum = other.count, other.sum
        if not ocount:
            return
        with self._lock:
            self._compact_locked()
            self._means += means
            self._weights += weights
            self.count += ocount
            self.sum += osum
            if omin < self.min:
                self.min = omin
            if omax > self.max:
                self.max = omax
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Fold the sample buffer in and merge nearest centroid pairs
        until at most ``max_centroids`` remain."""
        if self._buf:
            self._means += self._buf
            self._weights += [1.0] * len(self._buf)
            self._buf = []
        n = len(self._means)
        if n <= self.max_centroids:
            if n > 1 and any(self._means[i] > self._means[i + 1]
                             for i in range(n - 1)):
                pairs = sorted(zip(self._means, self._weights))
                self._means = [m for m, _ in pairs]
                self._weights = [w for _, w in pairs]
            return
        pairs = sorted(zip(self._means, self._weights))
        # One merge pass with a uniform weight cap: accumulate adjacent
        # centroids while the running group stays under 2*total/k. A
        # closest-gap policy would instead pile dense-mode mass into
        # one mega-centroid and wreck mid-range quantiles on skewed
        # data; the cap bounds every centroid's rank footprint.
        total = sum(w for _, w in pairs)
        cap = 2.0 * total / self.max_centroids
        out: list[tuple[float, float]] = []
        m_acc, w_acc = pairs[0]
        for m, w in pairs[1:]:
            if w_acc + w <= cap:
                m_acc = (m_acc * w_acc + m * w) / (w_acc + w)
                w_acc += w
            else:
                out.append((m_acc, w_acc))
                m_acc, w_acc = m, w
        out.append((m_acc, w_acc))
        pairs = out
        while len(pairs) > self.max_centroids:
            # rare fallback (pathological weight layouts): merge the
            # closest adjacent pair until the budget holds
            best, gap = 0, float("inf")
            for i in range(len(pairs) - 1):
                d = pairs[i + 1][0] - pairs[i][0]
                if d < gap:
                    best, gap = i, d
            (m1, w1), (m2, w2) = pairs[best], pairs[best + 1]
            w = w1 + w2
            pairs[best:best + 2] = [((m1 * w1 + m2 * w2) / w, w)]
        self._means = [m for m, _ in pairs]
        self._weights = [w for _, w in pairs]

    # -- query ----------------------------------------------------

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile (0 <= q <= 1); NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            self._compact_locked()
            if not self._means:
                return float("nan")
            if len(self._means) == 1:
                return self._means[0]
            total = sum(self._weights)
            target = q * total
            # centroid i covers the cumulative-weight interval around
            # its midpoint; interpolate between adjacent midpoints
            cum = 0.0
            mids = []
            for m, w in zip(self._means, self._weights):
                mids.append((cum + w / 2.0, m))
                cum += w
            # anchor the ends at the exact observed extremes
            pts = [(0.0, self.min)] + mids + [(total, self.max)]
            for i in range(len(pts) - 1):
                c0, m0 = pts[i]
                c1, m1 = pts[i + 1]
                if target <= c1:
                    if c1 == c0:
                        return m1
                    return m0 + (m1 - m0) * (target - c0) / (c1 - c0)
            return self.max

    def cdf(self, x: float) -> float:
        """Estimate the fraction of samples <= ``x`` (the inverse of
        :meth:`quantile`, same midpoint interpolation); NaN when empty.
        This is what lets an SLO engine turn a latency digest into a
        good/bad event ratio ("what fraction of reads beat 250 ms")."""
        x = float(x)
        with self._lock:
            self._compact_locked()
            if not self._means:
                return float("nan")
            if x < self.min:
                return 0.0
            if x >= self.max:
                return 1.0
            total = sum(self._weights)
            cum = 0.0
            pts = [(0.0, self.min)]
            for m, w in zip(self._means, self._weights):
                pts.append((cum + w / 2.0, m))
                cum += w
            pts.append((total, self.max))
            for i in range(len(pts) - 1):
                c0, m0 = pts[i]
                c1, m1 = pts[i + 1]
                if x <= m1:
                    if m1 == m0:
                        return c1 / total
                    return (c0 + (c1 - c0) * (x - m0) / (m1 - m0)) / total
            return 1.0

    def percentiles(self, *qs: float) -> dict[str, float]:
        """Convenience: {"p50": ..., "p99": ...} for the given qs."""
        return {"p" + ("%g" % (q * 100)).replace(".", "_"):
                self.quantile(q) for q in qs}

    # -- wire formats ---------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            self._compact_locked()
            return {
                "means": list(self._means),
                "weights": list(self._weights),
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "count": self.count,
                "sum": self.sum,
            }

    @classmethod
    def from_dict(cls, d: dict,
                  max_centroids: int = 64) -> "Digest":
        dg = cls(max_centroids=max_centroids)
        dg._means = [float(m) for m in d.get("means", ())]
        dg._weights = [float(w) for w in d.get("weights", ())]
        dg.count = int(d.get("count", 0))
        dg.sum = float(d.get("sum", 0.0))
        if dg.count:
            dg.min = float(d["min"])
            dg.max = float(d["max"])
        return dg

    def to_proto(self):
        """Fill a fresh ``master_pb.DigestMessage`` (lazy import keeps
        stats.py usable without the pb package)."""
        from ..pb import master_pb2

        d = self.to_dict()
        msg = master_pb2.DigestMessage(
            centroid_means=d["means"], centroid_weights=d["weights"],
            min=d["min"], max=d["max"], count=d["count"], sum=d["sum"])
        return msg

    @classmethod
    def from_proto(cls, msg, max_centroids: int = 64) -> "Digest":
        return cls.from_dict(
            {"means": list(msg.centroid_means),
             "weights": list(msg.centroid_weights),
             "min": msg.min, "max": msg.max,
             "count": msg.count, "sum": msg.sum},
            max_centroids=max_centroids)


class Metrics:
    """One registry per server process."""

    def __init__(self, namespace: str = "seaweedfs_tpu"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple, str], object] = {}
        from . import racecheck
        racecheck.register(self, "stats.Metrics")

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
            # seaweedlint: disable=SW601 — best-effort fire-and-forget push to an out-of-cluster pushgateway: a breaker/retry would add queueing where dropping a sample is the correct behavior; bounded by the 5s timeout
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
