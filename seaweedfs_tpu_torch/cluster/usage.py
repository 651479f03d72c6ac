"""Per-tenant traffic accounting plane: who and what drives the load.

Every ingress — S3 gateway (tenant = the ``s3_auth`` identity), WebDAV,
filer, and volume server (per-needle hot keys) — keeps a
:class:`UsageCollector`: cumulative per-(tenant, bucket) counters
(requests, bytes in/out, errors, latency
:class:`~seaweedfs_tpu_torch.util.stats.Digest`) plus a mergeable
:class:`SpaceSaving` top-k sketch of hot object keys. Volume servers
ship their snapshot on the heartbeat (``Heartbeat.usage``); gateways
and the filer, which do not heartbeat, push the same payload as JSON
to the master's ``POST /cluster/usage`` on a small interval
(:class:`UsagePusher`, best-effort like the trace push loop).

The master folds every source into a :class:`ClusterUsage` registry
with *replacement* semantics: each source's latest cumulative snapshot
overwrites its previous one, and the cluster-wide picture
(``/cluster/usage``, ``/cluster/topk``) is merged across sources at
read time. That makes repeated heartbeats idempotent and turns a
process restart into a plain counter reset for that source — no
regression bookkeeping needed.

SpaceSaving (Metwally et al.; merge rule from Agarwal et al.,
"Mergeable Summaries") guarantees for every reported key
``count - error <= true <= count``; merging sums estimates, charging a
key absent from a full sketch that sketch's minimum counter — the most
it could have absorbed — so the bounds survive distribution.

The collector hot path is gated on a module flag (:func:`configure` /
``[usage] enabled`` in the server config) so a caller can toggle it
at runtime, as the telemetry collector's flag is. Prometheus export is
cardinality-capped: only the first :data:`TENANT_GAUGE_CAP` distinct
tenants get their own ``seaweed_tenant_*`` label; later ones fold into
``tenant="other"``.

The port's copy of ``seaweedfs_tpu/cluster/usage.py``. The wire is the
JAX package's (``master_pb.UsageSnapshot`` on the heartbeat, the same
JSON body on ``POST /cluster/usage``), so either package's master folds
the other's sources into equal rows.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ..pb import master_pb2
from ..util import glog, retry
from ..util.stats import Digest, Metrics

_ENABLED = True

#: Capacity of every SpaceSaving sketch (count error <= total/TOP_K).
TOP_K = 64
#: Max distinct tenant label values exported; the rest are "other".
TENANT_GAUGE_CAP = 32
#: Default gateway/filer -> master push interval (seconds).
PUSH_INTERVAL = 5.0
#: Centroid budget for shipped latency digests.
DIGEST_CENTROIDS = 64

_PUSH_INTERVAL = PUSH_INTERVAL


def configure(enabled: Optional[bool] = None,
              push_interval_seconds: Optional[float] = None) -> None:
    global _ENABLED, _PUSH_INTERVAL
    if enabled is not None:
        _ENABLED = bool(enabled)
    if push_interval_seconds is not None:
        _PUSH_INTERVAL = max(0.05, float(push_interval_seconds))


def configure_from(conf: dict) -> None:
    """Apply a ``[usage]`` config-file section, if present."""
    u = conf.get("usage") if isinstance(conf, dict) else None
    if isinstance(u, dict):
        configure(enabled=u.get("enabled"),
                  push_interval_seconds=u.get("push_interval_seconds"))


def enabled() -> bool:
    return _ENABLED


def push_interval() -> float:
    return _PUSH_INTERVAL


# --------------------------------------------------------------------------
# the mergeable top-k sketch
# --------------------------------------------------------------------------


class SpaceSaving:
    """Top-k heavy hitters with per-key overestimation error.

    Not thread-safe — callers (the collector, the master registry)
    hold their own lock. Entries are ``key -> [count, error, tenant,
    volume]``; when full, the minimum-count entry is evicted and the
    newcomer inherits its count as both estimate floor and error.
    """

    def __init__(self, capacity: int = TOP_K):
        self.capacity = max(1, int(capacity))
        self._entries: dict[str, list] = {}
        self.total = 0

    def __len__(self) -> int:
        return len(self._entries)

    def offer(self, key: str, n: int = 1, tenant: str = "",
              volume: int = 0) -> None:
        self.total += n
        e = self._entries.get(key)
        if e is not None:
            e[0] += n
            if tenant and not e[2]:
                e[2] = tenant
            if volume and not e[3]:
                e[3] = volume
            return
        if len(self._entries) < self.capacity:
            self._entries[key] = [n, 0, tenant, volume]
            return
        victim = min(self._entries, key=lambda k: self._entries[k][0])
        floor = self._entries.pop(victim)[0]
        self._entries[key] = [floor + n, floor, tenant, volume]

    def min_count(self) -> int:
        """Max count an absent key could have absorbed (0 unless
        full) — the cross-sketch charge in :meth:`merge`."""
        if len(self._entries) < self.capacity:
            return 0
        return min(e[0] for e in self._entries.values())

    def estimate(self, key: str) -> tuple[int, int]:
        """(count, error) for ``key`` — the absent-key charge applies."""
        e = self._entries.get(key)
        if e is not None:
            return e[0], e[1]
        m = self.min_count()
        return m, m

    def merge(self, other: "SpaceSaving") -> None:
        mine, theirs = self.min_count(), other.min_count()
        merged: dict[str, list] = {}
        for key in set(self._entries) | set(other._entries):
            a = self._entries.get(key)
            b = other._entries.get(key)
            count = (a[0] if a else mine) + (b[0] if b else theirs)
            error = (a[1] if a else mine) + (b[1] if b else theirs)
            meta = a if a and (a[2] or a[3]) else (b or a)
            merged[key] = [count, error, meta[2], meta[3]]
        keep = sorted(merged, key=lambda k: (-merged[k][0], k))
        self._entries = {k: merged[k] for k in keep[:self.capacity]}
        # per the class docstring the sketch is lock-free by design:
        # every caller (collector, master aggregation) serializes
        # merges under its own lock
        # seaweedlint: disable=SW802 — callers hold their own lock
        self.total += other.total

    def entries(self) -> list[dict]:
        """Rows sorted by count desc then key (deterministic)."""
        out = [{"key": k, "count": e[0], "error": e[1],
                "tenant": e[2], "volume": e[3]}
               for k, e in self._entries.items()]
        out.sort(key=lambda r: (-r["count"], r["key"]))
        return out

    # -- wire formats ---------------------------------------------

    def to_dict(self) -> dict:
        return {"capacity": self.capacity, "total": self.total,
                "entries": self.entries()}

    @classmethod
    def from_dict(cls, d: dict) -> "SpaceSaving":
        s = cls(capacity=int(d.get("capacity", TOP_K)))
        s.total = int(d.get("total", 0))
        for r in d.get("entries", ()):
            s._entries[str(r["key"])] = [
                int(r.get("count", 0)), int(r.get("error", 0)),
                str(r.get("tenant", "")), int(r.get("volume", 0))]
        return s

    def fill_proto(self, snap: master_pb2.UsageSnapshot) -> None:
        snap.topk_total = self.total
        snap.topk_capacity = self.capacity
        for r in self.entries():
            snap.top_keys.add(key=r["key"], count=r["count"],
                              error=r["error"], tenant=r["tenant"],
                              volume=r["volume"])

    @classmethod
    def from_proto(cls, snap: master_pb2.UsageSnapshot) -> "SpaceSaving":
        return cls.from_dict({
            "capacity": snap.topk_capacity or TOP_K,
            "total": snap.topk_total,
            "entries": [{"key": e.key, "count": e.count,
                         "error": e.error, "tenant": e.tenant,
                         "volume": e.volume} for e in snap.top_keys]})


# --------------------------------------------------------------------------
# per-process collector (every ingress owns one)
# --------------------------------------------------------------------------


class _TenantRow:
    __slots__ = ("requests", "bytes_in", "bytes_out", "errors",
                 "latency")

    def __init__(self):
        self.requests = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.errors = 0
        self.latency = Digest(DIGEST_CENTROIDS)


class UsageCollector:
    """Cumulative per-(tenant, bucket) accounting on one server.

    ``record`` is hot-path safe: one module-flag predicate when
    disabled; a dict hit, integer bumps, and a sketch offer under one
    lock when enabled. Everything ships cumulative — the master
    replaces this source's previous snapshot, so snapshots need no
    draining and a lost push costs nothing.
    """

    def __init__(self, component: str, top_k: int = TOP_K):
        self.component = component
        self._lock = threading.Lock()
        self._rows: dict[tuple[str, str], _TenantRow] = {}
        self._topk = SpaceSaving(top_k)
        self._started = time.monotonic()

    def record(self, tenant: str, bucket: str = "", *,
               n_in: int = 0, n_out: int = 0, seconds: float = 0.0,
               error: bool = False, key: str = "",
               volume: int = 0) -> None:
        if not _ENABLED:
            return
        tenant = tenant or "anonymous"
        with self._lock:
            row = self._rows.get((tenant, bucket))
            if row is None:
                row = self._rows[(tenant, bucket)] = _TenantRow()
            row.requests += 1
            row.bytes_in += n_in
            row.bytes_out += n_out
            if error:
                row.errors += 1
            if key:
                self._topk.offer(key, tenant=tenant, volume=volume)
        if seconds > 0.0:
            row.latency.add(seconds)

    def record_key(self, key: str, volume: int = 0, n: int = 1,
                   tenant: str = "") -> None:
        """Hot-key-only path (volume servers: per-needle reads)."""
        if not _ENABLED:
            return
        with self._lock:
            self._topk.offer(key, n, tenant=tenant, volume=volume)

    def _payload_locked(self) -> dict:
        tenants = []
        for (tenant, bucket), row in sorted(self._rows.items()):
            r = {"tenant": tenant, "bucket": bucket,
                 "requests": row.requests, "bytes_in": row.bytes_in,
                 "bytes_out": row.bytes_out, "errors": row.errors}
            if row.latency.count:
                r["latency"] = row.latency.to_dict()
            tenants.append(r)
        sk = self._topk.to_dict()
        return {"component": self.component,
                "window_ns": max(
                    0, int((time.monotonic() - self._started) * 1e9)),
                "tenants": tenants, "top_keys": sk["entries"],
                "topk_total": sk["total"],
                "topk_capacity": sk["capacity"]}

    def to_payload(self) -> dict:
        """The JSON push body (also the ``/debug/vars`` local view)."""
        with self._lock:
            return self._payload_locked()

    def snapshot(self) -> master_pb2.UsageSnapshot:
        """The same cumulative state as a heartbeat-ready proto."""
        with self._lock:
            p = self._payload_locked()
        snap = master_pb2.UsageSnapshot(
            window_ns=p["window_ns"], component=p["component"],
            topk_total=p["topk_total"],
            topk_capacity=p["topk_capacity"])
        for r in p["tenants"]:
            t = snap.tenants.add(
                tenant=r["tenant"], bucket=r["bucket"],
                requests=r["requests"], bytes_in=r["bytes_in"],
                bytes_out=r["bytes_out"], errors=r["errors"])
            if r.get("latency"):
                t.latency.CopyFrom(
                    Digest.from_dict(r["latency"]).to_proto())
        for r in p["top_keys"]:
            snap.top_keys.add(key=r["key"], count=r["count"],
                              error=r["error"], tenant=r["tenant"],
                              volume=r["volume"])
        return snap


def snapshot_to_payload(snap: master_pb2.UsageSnapshot) -> dict:
    """Normalize a wire snapshot to the payload-dict ingest shape."""
    tenants = []
    for t in snap.tenants:
        r = {"tenant": t.tenant, "bucket": t.bucket,
             "requests": int(t.requests), "bytes_in": int(t.bytes_in),
             "bytes_out": int(t.bytes_out), "errors": int(t.errors)}
        if t.latency.count:
            r["latency"] = Digest.from_proto(t.latency).to_dict()
        tenants.append(r)
    return {"component": snap.component,
            "window_ns": int(snap.window_ns), "tenants": tenants,
            "top_keys": [{"key": e.key, "count": int(e.count),
                          "error": int(e.error), "tenant": e.tenant,
                          "volume": int(e.volume)}
                         for e in snap.top_keys],
            "topk_total": int(snap.topk_total),
            "topk_capacity": int(snap.topk_capacity) or TOP_K}


class UsagePusher:
    """Background push of a collector's snapshot to the master.

    For ingresses that do not heartbeat (S3, WebDAV, filer). Loss is
    harmless — the payload is cumulative and the master replaces the
    previous one — so pushes are best-effort with the breaker off,
    mirroring the trace push loop.
    """

    def __init__(self, collector: UsageCollector, master_url: str,
                 source: str):
        self.collector = collector
        self.master_url = master_url
        self.source = source
        self.pushed = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "UsagePusher":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"usage-push-{self.collector.component}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def push_once(self) -> None:
        body = dict(self.collector.to_payload())
        body["source"] = self.source
        retry.http_request(
            f"http://{self.master_url}/cluster/usage",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"},
            point="usage.push", timeout=5.0, use_breaker=False)
        # incremented only on the single pusher thread; stop() joins
        # without a final flush
        # seaweedlint: disable=SW802 — single pusher thread
        self.pushed += 1

    def _loop(self) -> None:
        while not self._stop.wait(_PUSH_INTERVAL):
            if not _ENABLED:
                continue
            try:
                self.push_once()
            except Exception as e:
                # seaweedlint: disable=SW802 — single pusher thread
                self.errors += 1
                glog.v(1, "usage push to %s failed: %s",
                       self.master_url, e)


# --------------------------------------------------------------------------
# master side: per-source replacement, read-time merge
# --------------------------------------------------------------------------


class _SourceRec:
    __slots__ = ("component", "rows", "sketch", "last_ingest",
                 "snapshots")

    def __init__(self):
        self.component = ""
        #: (tenant, bucket) -> row dict with a Digest under "latency"
        self.rows: dict[tuple[str, str], dict] = {}
        self.sketch = SpaceSaving(TOP_K)
        self.last_ingest = 0.0
        self.snapshots = 0


class ClusterUsage:
    """Cluster-wide accounting registry at the master.

    Each source (volume server url, gateway instance) stores its
    latest cumulative snapshot; ``to_map``/``topk_map`` merge across
    sources on demand. ``metrics`` is a dedicated registry so the
    gauges render under the ``seaweed_`` namespace on ``/metrics``.
    """

    def __init__(self, clock=time.time):
        self._lock = threading.Lock()
        self._sources: dict[str, _SourceRec] = {}
        self.clock = clock
        self.metrics = Metrics(namespace="seaweed")
        self._tenant_labels: set[str] = set()

    # ---------------- ingestion ----------------

    def ingest(self, source: str, payload: dict) -> None:
        """Replace ``source``'s snapshot with a payload dict (the JSON
        push body / a normalized heartbeat proto)."""
        rows: dict[tuple[str, str], dict] = {}
        for t in payload.get("tenants", ()):
            row = {"requests": int(t.get("requests", 0)),
                   "bytes_in": int(t.get("bytes_in", 0)),
                   "bytes_out": int(t.get("bytes_out", 0)),
                   "errors": int(t.get("errors", 0)),
                   "latency": Digest.from_dict(t["latency"])
                   if t.get("latency") else None}
            rows[(str(t.get("tenant", "")),
                  str(t.get("bucket", "")))] = row
        sketch = SpaceSaving.from_dict(
            {"capacity": payload.get("topk_capacity", TOP_K),
             "total": payload.get("topk_total", 0),
             "entries": payload.get("top_keys", ())})
        with self._lock:
            rec = self._sources.get(source)
            if rec is None:
                rec = self._sources[source] = _SourceRec()
            rec.component = str(payload.get("component", ""))
            rec.rows = rows
            rec.sketch = sketch
            rec.last_ingest = self.clock()
            rec.snapshots += 1
        self._update_gauges()

    def ingest_proto(self, source: str,
                     snap: master_pb2.UsageSnapshot) -> None:
        self.ingest(source, snapshot_to_payload(snap))

    def forget(self, source: str) -> None:
        """Drop a source (node reaped from the topology)."""
        with self._lock:
            self._sources.pop(source, None)

    # ---------------- merged views ----------------

    def _merged_locked(self) -> dict[tuple[str, str], dict]:
        out: dict[tuple[str, str], dict] = {}
        for rec in self._sources.values():
            for key, row in rec.rows.items():
                agg = out.get(key)
                if agg is None:
                    agg = out[key] = {
                        "requests": 0, "bytes_in": 0, "bytes_out": 0,
                        "errors": 0, "latency": None}
                for f in ("requests", "bytes_in", "bytes_out",
                          "errors"):
                    agg[f] += row[f]
                if row["latency"] is not None:
                    if agg["latency"] is None:
                        agg["latency"] = Digest(DIGEST_CENTROIDS)
                    agg["latency"].merge(row["latency"])
        return out

    def to_map(self, limit: Optional[int] = None) -> dict:
        """JSON body for ``/cluster/usage``.

        ``limit`` caps the tenants section to the top-N by requests
        (``tenants_total``/``tenants_omitted`` say what was dropped) —
        a 2,000-source cluster must not render every tenant row."""
        now = self.clock()
        with self._lock:
            merged = self._merged_locked()
            sources = {
                src: {"component": rec.component,
                      "snapshots": rec.snapshots,
                      "tenant_rows": len(rec.rows),
                      "top_keys": len(rec.sketch),
                      "last_ingest_age_seconds":
                          round(max(0.0, now - rec.last_ingest), 3)}
                for src, rec in self._sources.items()}
        tenants: dict[str, dict] = {}
        totals = {"requests": 0, "bytes_in": 0, "bytes_out": 0,
                  "errors": 0}
        for (tenant, bucket), row in sorted(merged.items()):
            t = tenants.get(tenant)
            if t is None:
                t = tenants[tenant] = {
                    "requests": 0, "bytes_in": 0, "bytes_out": 0,
                    "errors": 0, "buckets": {}}
            b = {"requests": row["requests"],
                 "bytes_in": row["bytes_in"],
                 "bytes_out": row["bytes_out"],
                 "errors": row["errors"]}
            if row["latency"] is not None and row["latency"].count:
                d = row["latency"]
                b["latency"] = {"count": d.count,
                                "mean": d.sum / d.count}
                b["latency"].update(d.percentiles(0.5, 0.95, 0.99))
            t["buckets"][bucket or "-"] = b
            for f in totals:
                t[f] += b[f]
                totals[f] += b[f]
        out = {"tenants": tenants, "totals": totals,
               "sources": sources}
        if limit is not None and 0 < limit < len(tenants):
            top = sorted(tenants,
                         key=lambda t: (-tenants[t]["requests"], t))
            out["tenants"] = {t: tenants[t] for t in top[:limit]}
            out["tenants_total"] = len(tenants)
            out["tenants_omitted"] = len(tenants) - limit
        return out

    def merged_topk(self) -> SpaceSaving:
        with self._lock:
            sketches = [rec.sketch for rec in self._sources.values()]
        merged = SpaceSaving(max([s.capacity for s in sketches],
                                 default=TOP_K))
        for s in sketches:
            merged.merge(s)
        return merged

    def topk_map(self, n: int = 32) -> dict:
        """JSON body for ``/cluster/topk``."""
        merged = self.merged_topk()
        return {"top": merged.entries()[:max(1, int(n))],
                "total": merged.total, "capacity": merged.capacity,
                "sources": len(self._sources)}

    # ---------------- gauges ----------------

    def _tenant_label(self, tenant: str) -> str:
        """First TENANT_GAUGE_CAP distinct tenants keep their name;
        later ones share "other" so the series set stays bounded."""
        # under the lock: gauge updates run on ingest (rpc) threads
        # AND the reap loop, and an unlocked check-then-add lets the
        # label set blow past the cap
        with self._lock:
            if tenant in self._tenant_labels:
                return tenant
            if len(self._tenant_labels) < TENANT_GAUGE_CAP:
                self._tenant_labels.add(tenant)
                return tenant
        return "other"

    def _update_gauges(self) -> None:
        with self._lock:
            merged = self._merged_locked()
        per_tenant: dict[str, dict] = {}
        for (tenant, _bucket), row in merged.items():
            label = self._tenant_label(tenant)
            agg = per_tenant.setdefault(
                label, {"requests": 0, "bytes_in": 0, "bytes_out": 0,
                        "errors": 0})
            for f in agg:
                agg[f] += row[f]
        for label, agg in per_tenant.items():
            self.metrics.gauge("tenant_requests_total",
                               tenant=label).set(agg["requests"])
            self.metrics.gauge("tenant_bytes_in_total",
                               tenant=label).set(agg["bytes_in"])
            self.metrics.gauge("tenant_bytes_out_total",
                               tenant=label).set(agg["bytes_out"])
            self.metrics.gauge("tenant_errors_total",
                               tenant=label).set(agg["errors"])
