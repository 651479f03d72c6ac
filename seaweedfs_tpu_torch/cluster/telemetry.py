"""Cluster telemetry plane: per-volume hot stats over heartbeats.

Monarch-style push aggregation (PAPERS.md): each volume server keeps a
:class:`TelemetryCollector` of per-volume hot stats — read/write ops,
bytes, chunk-cache hits/misses, EC decodes, errors, and latency
:class:`~seaweedfs_tpu_torch.util.stats.Digest`\\ s — and ships a compact
:class:`master_pb.TelemetrySnapshot` on every heartbeat. The master
folds snapshots into a :class:`ClusterTelemetry` registry: monotonic
counters become exponentially-decayed rates, latency digests are kept
as a sliding window of mergeable sketches (so ``p99`` at the master is
computed over real sample positions, not re-bucketed histograms), and
each node gets a health score from heartbeat staleness, error rate,
and tail latency vs the cluster median.

Counters in a snapshot are cumulative since process start (a restart
shows up as a counter regression and is treated as a fresh baseline);
digests are drained per heartbeat window so the master's sliding
window only ever holds recent samples.

The collector hot path is gated on a module flag
(:func:`configure` / ``[telemetry] enabled`` in the server config), so
a caller can toggle it at runtime and time ``record_read`` with the
collector on and off (``chip_smoke.py``'s telemetry phase does).

The port's copy of ``seaweedfs_tpu/cluster/telemetry.py``. The wire is
the JAX package's (``master_pb.TelemetrySnapshot`` on the heartbeat),
so a port volume server feeds a JAX master the same rows as a port
master, and the other way round.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Iterable, Optional

from ..pb import master_pb2
from ..util import glog, profiler
from ..util.stats import Digest, Metrics

_ENABLED = True

#: Default half-life for master-side rate decay (seconds).
DECAY_HALFLIFE = 60.0
#: Latency digests older than this fall out of the master's window.
DIGEST_WINDOW = 300.0
#: Centroid budget for shipped digests (~1 KiB per digest on the wire).
DIGEST_CENTROIDS = 64


def configure(enabled: Optional[bool] = None) -> None:
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)


def configure_from(conf: dict) -> None:
    """Apply a ``[telemetry]`` config-file section, if present."""
    t = conf.get("telemetry") if isinstance(conf, dict) else None
    if isinstance(t, dict):
        configure(enabled=t.get("enabled"))


def enabled() -> bool:
    return _ENABLED


# --------------------------------------------------------------------------
# volume-server side: the collector
# --------------------------------------------------------------------------


class _VolStats:
    __slots__ = ("read_ops", "write_ops", "read_bytes", "write_bytes",
                 "ec_decodes", "errors", "read_latency", "write_latency")

    def __init__(self):
        self.read_ops = 0
        self.write_ops = 0
        self.read_bytes = 0
        self.write_bytes = 0
        self.ec_decodes = 0
        self.errors = 0
        self.read_latency = Digest(DIGEST_CENTROIDS)
        self.write_latency = Digest(DIGEST_CENTROIDS)


class TelemetryCollector:
    """Per-volume hot stats on one volume server.

    ``record_*`` are hot-path safe: one module-flag predicate when
    disabled; a dict hit plus integer bumps and a buffered digest
    append when enabled.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._vols: dict[int, _VolStats] = {}
        self._window_start = time.monotonic()

    def _vol(self, volume_id: int) -> _VolStats:
        v = self._vols.get(volume_id)
        if v is None:
            v = self._vols[volume_id] = _VolStats()
        return v

    def record_read(self, volume_id: int, n_bytes: int,
                    seconds: float, error: bool = False) -> None:
        if not _ENABLED:
            return
        with self._lock:
            v = self._vol(volume_id)
            v.read_ops += 1
            v.read_bytes += n_bytes
            if error:
                v.errors += 1
        v.read_latency.add(seconds)

    def record_write(self, volume_id: int, n_bytes: int,
                     seconds: float, error: bool = False) -> None:
        if not _ENABLED:
            return
        with self._lock:
            v = self._vol(volume_id)
            v.write_ops += 1
            v.write_bytes += n_bytes
            if error:
                v.errors += 1
        v.write_latency.add(seconds)

    def record_ec_decode(self, volume_id: int, n: int = 1) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._vol(volume_id).ec_decodes += n

    def snapshot(self, cache_counts: Optional[dict] = None,
                 collections: Optional[dict] = None
                 ) -> master_pb2.TelemetrySnapshot:
        """Drain one heartbeat window into a wire snapshot.

        Counters ship cumulative; digests are swapped out so each
        snapshot carries only the latencies observed since the last
        one. ``cache_counts`` is ``ChunkCache.per_volume_counts()``
        (cumulative hits/misses keyed by volume id); ``collections``
        maps volume id -> collection name for labeling.
        """
        now = time.monotonic()
        snap = master_pb2.TelemetrySnapshot(
            window_ns=max(0, int((now - self._window_start) * 1e9)))
        cache_counts = cache_counts or {}
        collections = collections or {}
        with self._lock:
            self._window_start = now
            vids = sorted(set(self._vols) | set(cache_counts))
            drained: list[tuple[int, _VolStats, Digest, Digest]] = []
            for vid in vids:
                v = self._vols.get(vid)
                if v is None:
                    v = self._vols[vid] = _VolStats()
                rd, v.read_latency = v.read_latency, \
                    Digest(DIGEST_CENTROIDS)
                wd, v.write_latency = v.write_latency, \
                    Digest(DIGEST_CENTROIDS)
                drained.append((vid, v, rd, wd))
        for vid, v, rd, wd in drained:
            cc = cache_counts.get(vid, {})
            m = snap.volumes.add(
                volume_id=vid,
                collection=str(collections.get(vid, "")),
                read_ops=v.read_ops, write_ops=v.write_ops,
                read_bytes=v.read_bytes, write_bytes=v.write_bytes,
                cache_hits=int(cc.get("hits", 0)),
                cache_misses=int(cc.get("misses", 0)),
                ec_decodes=v.ec_decodes, errors=v.errors)
            if rd.count:
                m.read_latency.CopyFrom(rd.to_proto())
            if wd.count:
                m.write_latency.CopyFrom(wd.to_proto())
        # The always-on profiler's hottest stacks ride along, so the
        # master's heatmap can say what code is hot, not just which
        # volume (a few hundred bytes per heartbeat at most).
        if profiler.enabled():
            for stack, samples in profiler.hot_stacks():
                snap.hot_stacks.add(stack=stack, samples=samples)
        return snap

    def to_map(self) -> dict:
        """JSON-able local view (volume server ``/debug/vars``)."""
        with self._lock:
            items = list(self._vols.items())
        out = {}
        for vid, v in items:
            out[str(vid)] = {
                "read_ops": v.read_ops, "write_ops": v.write_ops,
                "read_bytes": v.read_bytes,
                "write_bytes": v.write_bytes,
                "ec_decodes": v.ec_decodes, "errors": v.errors,
                "read_latency": _digest_summary(v.read_latency),
                "write_latency": _digest_summary(v.write_latency),
            }
        return out


def _digest_summary(d: Digest) -> dict:
    if not d.count:
        return {"count": 0}
    out = {"count": d.count, "mean": d.sum / d.count}
    out.update(d.percentiles(0.5, 0.95, 0.99))
    return out


# --------------------------------------------------------------------------
# master side: rolling aggregation with decay + health scoring
# --------------------------------------------------------------------------

_RATE_FIELDS = ("read_ops", "write_ops", "read_bytes", "write_bytes",
                "cache_hits", "cache_misses", "ec_decodes", "errors")


class _VolAgg:
    __slots__ = ("cum", "rates", "windows", "collection")

    def __init__(self):
        self.cum: dict[str, int] = {f: 0 for f in _RATE_FIELDS}
        self.rates: dict[str, float] = {f: 0.0 for f in _RATE_FIELDS}
        #: (wall ts, read Digest | None, write Digest | None)
        self.windows: deque = deque()
        self.collection = ""


class _NodeAgg:
    __slots__ = ("volumes", "last_ingest", "snapshots", "hot_stacks",
                 "last_gauges")

    def __init__(self):
        self.volumes: dict[int, _VolAgg] = {}
        self.last_ingest = 0.0
        self.snapshots = 0
        #: latest heartbeat's profiler top-k: [(collapsed_stack, n)]
        self.hot_stacks: list[tuple[str, int]] = []
        #: last time this node's Prometheus gauges were refreshed —
        #: gauge upkeep is rate-limited off the per-pulse hot path.
        self.last_gauges = 0.0


#: Per-node Prometheus series cap: only the top-K volumes by read rate
#: keep per-volume gauges, so a thousand-volume node exports a bounded
#: series set instead of one gauge pair per volume.
VOLUME_GAUGE_CAP = 64


class ClusterTelemetry:
    """Rolling per-node / per-volume registry at the master.

    Rates are EWMA-decayed with half-life ``halflife`` so a volume
    that went cold shows a falling rate instead of its lifetime mean;
    latency digests are kept for ``window`` seconds and merged on
    demand for quantile queries.
    """

    def __init__(self, halflife: float = DECAY_HALFLIFE,
                 window: float = DIGEST_WINDOW,
                 clock=time.time,
                 gauge_interval: float = 15.0):
        self._lock = threading.Lock()
        self._nodes: dict[str, _NodeAgg] = {}
        self.halflife = max(1.0, float(halflife))
        self.window = max(1.0, float(window))
        self.clock = clock
        #: Minimum seconds between per-node gauge refreshes (the first
        #: ingest for a node always updates, so tests and fresh nodes
        #: see series immediately).
        self.gauge_interval = max(0.0, float(gauge_interval))
        #: Data generation + memo for the cluster median p99 — the
        #: lookup ranking path asks for it per replica set, and without
        #: the memo each ask walks every node's digest windows.
        self._gen = 0
        self._median_cache: tuple[int, Optional[float]] = (-1, None)

    # ---------------- ingestion ----------------

    def ingest(self, node_url: str,
               snap: master_pb2.TelemetrySnapshot,
               metrics: Optional[Metrics] = None) -> None:
        now = self.clock()
        with self._lock:
            self._gen += 1
            node = self._nodes.get(node_url)
            if node is None:
                node = self._nodes[node_url] = _NodeAgg()
            dt = now - node.last_ingest if node.last_ingest else \
                max(snap.window_ns / 1e9, 1e-3)
            dt = max(dt, 1e-3)
            alpha = 1.0 - 0.5 ** (dt / self.halflife)
            node.last_ingest = now
            node.snapshots += 1
            if snap.hot_stacks:
                node.hot_stacks = [(hs.stack, int(hs.samples))
                                   for hs in snap.hot_stacks]
            seen = set()
            new_volume = False
            for v in snap.volumes:
                seen.add(v.volume_id)
                agg = node.volumes.get(v.volume_id)
                if agg is None:
                    agg = node.volumes[v.volume_id] = _VolAgg()
                    new_volume = True
                if v.collection:
                    agg.collection = v.collection
                for f in _RATE_FIELDS:
                    new = getattr(v, f)
                    prev = agg.cum[f]
                    # counter regression == server restart: the new
                    # cumulative value IS the delta since the reset
                    delta = new - prev if new >= prev else new
                    agg.cum[f] = new
                    agg.rates[f] += alpha * (delta / dt - agg.rates[f])
                rd = Digest.from_proto(v.read_latency) \
                    if v.read_latency.count else None
                wd = Digest.from_proto(v.write_latency) \
                    if v.write_latency.count else None
                if rd is not None or wd is not None:
                    agg.windows.append((now, rd, wd))
                while agg.windows and \
                        now - agg.windows[0][0] > self.window:
                    agg.windows.popleft()
            # volumes absent from the snapshot decay toward zero
            for vid, agg in node.volumes.items():
                if vid in seen:
                    continue
                for f in _RATE_FIELDS:
                    agg.rates[f] -= alpha * agg.rates[f]
                while agg.windows and \
                        now - agg.windows[0][0] > self.window:
                    agg.windows.popleft()
        if metrics is not None:
            # A never-exported node or a volume the gauges have not
            # seen yet refreshes immediately; steady state is
            # rate-limited to one refresh per gauge_interval.
            due = new_volume or node.last_gauges == 0.0 or \
                now - node.last_gauges >= self.gauge_interval
            if due:
                node.last_gauges = now
                self._update_gauges(metrics, node_url)

    def forget(self, node_url: str) -> None:
        """Drop a node (reaped from the topology)."""
        with self._lock:
            self._gen += 1
            self._nodes.pop(node_url, None)

    def _update_gauges(self, metrics: Metrics, node_url: str) -> None:
        """Master-side Prometheus gauges for the node just ingested.

        Reads the raw aggregates directly (no per-volume row rendering
        or digest merging) and keeps per-volume series for only the
        top ``VOLUME_GAUGE_CAP`` volumes by read rate, so a node with
        hundreds of volumes costs a bounded, flat amount per refresh.
        """
        now = self.clock()
        rows: list[tuple[float, int, float]] = []
        tot_read = tot_write = 0.0
        with self._lock:
            node = self._nodes.get(node_url)
            if node is None:
                return
            decay = self._decay_factor(node, now)
            for vid, agg in node.volumes.items():
                r = agg.rates["read_ops"] * decay
                tot_read += r
                tot_write += agg.rates["write_ops"] * decay
                hits = agg.cum["cache_hits"]
                looked = hits + agg.cum["cache_misses"]
                rows.append((r, vid,
                             hits / looked if looked else 0.0))
        if len(rows) > VOLUME_GAUGE_CAP:
            rows.sort(key=lambda t: -t[0])
            del rows[VOLUME_GAUGE_CAP:]
        for r, vid, ratio in rows:
            metrics.gauge(
                "telemetry_volume_read_ops_per_second",
                # seaweedlint: disable=SW401 — VOLUME_GAUGE_CAP cap
                node=node_url, volume=str(vid)).set(r)
            metrics.gauge(
                "telemetry_volume_cache_hit_ratio",
                # seaweedlint: disable=SW401 — VOLUME_GAUGE_CAP cap
                node=node_url, volume=str(vid)).set(ratio)
        metrics.gauge("telemetry_node_read_ops_per_second",
                      node=node_url).set(tot_read)
        metrics.gauge("telemetry_node_write_ops_per_second",
                      node=node_url).set(tot_write)
        p99 = self.node_quantile(node_url, 0.99)
        if p99 is not None:
            metrics.gauge("telemetry_node_read_p99_seconds",
                          node=node_url).set(p99)

    # ---------------- views ----------------

    def _decay_factor(self, node: _NodeAgg, now: float) -> float:
        if not node.last_ingest:
            return 1.0
        return 0.5 ** (max(0.0, now - node.last_ingest) / self.halflife)

    def node_volumes(self, node_url: str) -> dict:
        """Per-volume rows for one node (decayed to 'now')."""
        now = self.clock()
        with self._lock:
            node = self._nodes.get(node_url)
            if node is None:
                return {}
            decay = self._decay_factor(node, now)
            return {vid: self._row_locked(node, vid, agg, decay)
                    for vid, agg in node.volumes.items()}

    def _row_locked(self, node: _NodeAgg, vid: int, agg: _VolAgg,
                    decay: float) -> dict:
        hits = agg.cum["cache_hits"]
        misses = agg.cum["cache_misses"]
        looked = hits + misses
        row = {
            "collection": agg.collection,
            "read_ops": agg.cum["read_ops"],
            "write_ops": agg.cum["write_ops"],
            "read_bytes": agg.cum["read_bytes"],
            "write_bytes": agg.cum["write_bytes"],
            "cache_hits": hits, "cache_misses": misses,
            "cache_hit_ratio":
                hits / looked if looked else 0.0,
            "ec_decodes": agg.cum["ec_decodes"],
            "errors": agg.cum["errors"],
            "read_ops_per_second":
                agg.rates["read_ops"] * decay,
            "write_ops_per_second":
                agg.rates["write_ops"] * decay,
            "read_bytes_per_second":
                agg.rates["read_bytes"] * decay,
            "errors_per_second":
                agg.rates["errors"] * decay,
        }
        d = self._merged_locked(node, vid, read=True)
        if d is not None and d.count:
            row["read_latency"] = _digest_summary(d)
        d = self._merged_locked(node, vid, read=False)
        if d is not None and d.count:
            row["write_latency"] = _digest_summary(d)
        return row

    def volume_row(self, node_url: str, vid: int) -> dict:
        """The two signals `/dir/lookup` ranking needs for one volume
        on one node — O(1), no digest merges, no full-node render
        (``node_volumes`` builds every row on the node, which at
        hundreds of volumes per node is far too heavy per lookup)."""
        now = self.clock()
        with self._lock:
            node = self._nodes.get(node_url)
            agg = node.volumes.get(vid) if node is not None else None
            if agg is None:
                return {}
            hits = agg.cum["cache_hits"]
            looked = hits + agg.cum["cache_misses"]
            return {
                "cache_hit_ratio": hits / looked if looked else 0.0,
                "read_ops_per_second":
                    agg.rates["read_ops"] * self._decay_factor(node, now),
            }

    def _merged_locked(self, node: _NodeAgg, vid: Optional[int],
                       read: bool = True) -> Optional[Digest]:
        merged: Optional[Digest] = None
        vols: Iterable[_VolAgg] = (
            node.volumes.values() if vid is None
            else filter(None, [node.volumes.get(vid)]))
        for agg in vols:
            for _ts, rd, wd in agg.windows:
                d = rd if read else wd
                if d is None:
                    continue
                if merged is None:
                    merged = Digest(DIGEST_CENTROIDS)
                merged.merge(d)
        return merged

    def volume_read_rates(self) -> dict[int, float]:
        """Cluster-wide per-volume read-op EWMA, summed across every
        node serving the volume (replicas and EC shards alike). This
        is the signal the jobs policy engine thresholds against for
        cold-EC / hot-replicate / cool-shrink decisions, so the sum
        must see total demand on the volume, not one replica's share
        of it."""
        now = self.clock()
        with self._lock:
            out: dict[int, float] = {}
            for node in self._nodes.values():
                decay = self._decay_factor(node, now)
                for vid, agg in node.volumes.items():
                    out[vid] = out.get(vid, 0.0) \
                        + agg.rates["read_ops"] * decay
            return out

    def volume_cache_warmth(self) -> dict[int, float]:
        """Cluster-wide per-volume cache hit ratio (hits over lookups,
        summed across every node serving the volume). A warm volume's
        reads are being absorbed by chunk caches, so its raw read rate
        overstates the load the disks would take back if the policy
        engine EC-encoded or shrank it — the maintenance plane feeds
        this into its rows."""
        with self._lock:
            hits: dict[int, int] = {}
            looked: dict[int, int] = {}
            for node in self._nodes.values():
                for vid, agg in node.volumes.items():
                    h = agg.cum["cache_hits"]
                    m = agg.cum["cache_misses"]
                    hits[vid] = hits.get(vid, 0) + h
                    looked[vid] = looked.get(vid, 0) + h + m
            return {vid: (hits[vid] / n if n else 0.0)
                    for vid, n in looked.items()}

    def node_quantile(self, node_url: str, q: float,
                      read: bool = True) -> Optional[float]:
        """Merged latency quantile across a node's recent windows."""
        with self._lock:
            node = self._nodes.get(node_url)
            if node is None:
                return None
            d = self._merged_locked(node, None, read=read)
        if d is None or not d.count:
            return None
        v = d.quantile(q)
        return None if math.isnan(v) else v

    def cluster_counters(self) -> dict:
        """Cluster-wide cumulative op/error totals (the availability
        SLO diffs consecutive reads of this)."""
        ops = errors = 0
        with self._lock:
            for node in self._nodes.values():
                for agg in node.volumes.values():
                    ops += agg.cum["read_ops"] + agg.cum["write_ops"]
                    errors += agg.cum["errors"]
        return {"ops": ops, "errors": errors}

    def digests_since(self, ts: float,
                      read: bool = True) -> Optional[Digest]:
        """Merge every latency digest window ingested after ``ts``
        across all nodes — the per-evaluation-interval sample set the
        latency SLOs consume (each window is counted once as long as
        callers advance ``ts``)."""
        merged: Optional[Digest] = None
        with self._lock:
            for node in self._nodes.values():
                for agg in node.volumes.values():
                    for wts, rd, wd in agg.windows:
                        if wts <= ts:
                            continue
                        d = rd if read else wd
                        if d is None:
                            continue
                        if merged is None:
                            merged = Digest(DIGEST_CENTROIDS)
                        merged.merge(d)
        return merged

    def node_hot_stacks(self) -> dict:
        """node url -> latest heartbeat hot stacks."""
        with self._lock:
            return {url: [{"stack": s, "samples": n}
                          for s, n in node.hot_stacks]
                    for url, node in self._nodes.items()
                    if node.hot_stacks}

    def cluster_median_p99(self, read: bool = True) -> Optional[float]:
        # Memoized per data generation (read side only — that is the
        # one health() asks for on every ranked lookup): recomputing
        # walks every node's digest windows, and between ingests the
        # answer cannot change.
        if read:
            with self._lock:
                gen = self._gen
                cached_gen, cached = self._median_cache
                if cached_gen == gen:
                    return cached
        with self._lock:
            urls = list(self._nodes)
        p99s = sorted(p for p in (self.node_quantile(u, 0.99, read)
                                  for u in urls) if p is not None)
        if not p99s:
            median = None
        else:
            mid = len(p99s) // 2
            median = p99s[mid] if len(p99s) % 2 else \
                (p99s[mid - 1] + p99s[mid]) / 2.0
        if read:
            with self._lock:
                self._median_cache = (gen, median)
        return median

    # ---------------- health ----------------

    def health(self, node_url: str, last_seen: float,
               pulse_seconds: float) -> dict:
        """Score one node 0-100 (see docs/observability.md).

        ``score = 100 * (1 - stale) * (1 - err) * (1 - lat)`` where
        ``stale`` ramps 0->1 as the last heartbeat ages from 2 to 8
        pulses, ``err`` is 10x the decayed error fraction (capped at
        1), and ``lat`` ramps 0->1 as the node's read p99 goes from
        2x to 10x the cluster median. >=80 healthy, >=50 degraded,
        else unhealthy.
        """
        now = self.clock()
        pulse = max(pulse_seconds, 1e-3)
        staleness = max(0.0, now - last_seen)
        stale = min(1.0, max(0.0, (staleness - 2 * pulse) / (6 * pulse)))
        reasons = []
        if stale > 0:
            reasons.append(f"heartbeat {staleness:.1f}s old")
        err = 0.0
        ops = errs = 0.0
        with self._lock:
            node = self._nodes.get(node_url)
            if node is not None:
                decay = self._decay_factor(node, now)
                for agg in node.volumes.values():
                    ops += (agg.rates["read_ops"]
                            + agg.rates["write_ops"]) * decay
                    errs += agg.rates["errors"] * decay
        if ops > 0:
            frac = errs / ops
            err = min(1.0, 10.0 * frac)
            if err > 0.01:
                reasons.append(f"error rate {frac:.1%}")
        lat = 0.0
        p99 = self.node_quantile(node_url, 0.99)
        median = self.cluster_median_p99()
        if p99 is not None and median and median > 0:
            ratio = p99 / median
            lat = min(1.0, max(0.0, (ratio - 2.0) / 8.0))
            if lat > 0:
                reasons.append(
                    f"read p99 {p99 * 1e3:.1f}ms = {ratio:.1f}x "
                    f"cluster median")
        score = round(100.0 * (1 - stale) * (1 - err) * (1 - lat))
        verdict = ("healthy" if score >= 80 else
                   "degraded" if score >= 50 else "unhealthy")
        return {"score": score, "verdict": verdict, "reasons": reasons,
                "heartbeat_age_seconds": round(staleness, 3),
                "read_p99_seconds": p99,
                "ops_per_second": round(ops, 3),
                "errors_per_second": round(errs, 4)}

    # ---------------- the /cluster/telemetry payload ----------------

    def to_map(self, nodes_last_seen: Optional[dict] = None,
               pulse_seconds: float = 5.0,
               limit: Optional[int] = None) -> dict:
        """JSON body for ``/cluster/telemetry``. ``nodes_last_seen``
        maps node url -> topology ``last_seen`` (health needs it).

        ``limit`` caps the per-volume section to the top-N volumes by
        cluster-wide read rate (``volumes_total``/``volumes_omitted``
        say what was dropped) — without it a million-volume cluster
        renders a multi-MB document."""
        nodes_last_seen = nodes_last_seen or {}
        with self._lock:
            urls = sorted(set(self._nodes) | set(nodes_last_seen))
        if limit is not None and int(limit) > 0:
            return self._to_map_capped(urls, nodes_last_seen,
                                       pulse_seconds, int(limit))
        nodes = {}
        volumes: dict[str, dict] = {}
        for url in urls:
            vols = self.node_volumes(url)
            with self._lock:
                node = self._nodes.get(url)
                snapshots = node.snapshots if node else 0
                last_ingest = node.last_ingest if node else 0.0
                hot = list(node.hot_stacks) if node else []
            totals = {"read_ops_per_second": 0.0,
                      "write_ops_per_second": 0.0,
                      "errors_per_second": 0.0}
            for vid, row in vols.items():
                for k in totals:
                    totals[k] += row[k]
                volumes.setdefault(str(vid), {})[url] = row
            entry = {"snapshots": snapshots,
                     "last_ingest": last_ingest,
                     "volume_count": len(vols), **totals}
            p99 = self.node_quantile(url, 0.99)
            if p99 is not None:
                entry["read_p99_seconds"] = p99
            if hot:
                entry["hot_stacks"] = [{"stack": s, "samples": n}
                                       for s, n in hot]
            if url in nodes_last_seen:
                entry["health"] = self.health(
                    url, nodes_last_seen[url], pulse_seconds)
            nodes[url] = entry
        out = {"nodes": nodes, "volumes": volumes,
               "decay_halflife_seconds": self.halflife,
               "digest_window_seconds": self.window}
        median = self.cluster_median_p99()
        if median is not None:
            out["cluster_median_read_p99_seconds"] = median
        return out

    def _to_map_capped(self, urls: list, nodes_last_seen: dict,
                       pulse_seconds: float, limit: int) -> dict:
        """The ``limit``-capped `/cluster/telemetry` body: node totals
        are computed from the raw aggregates (no per-volume row render)
        and full rows are built only for the top-``limit`` volumes."""
        now = self.clock()
        nodes = {}
        per_vid_rate: dict[int, float] = {}
        vid_holders: dict[int, list[str]] = {}
        for url in urls:
            with self._lock:
                node = self._nodes.get(url)
                snapshots = node.snapshots if node else 0
                last_ingest = node.last_ingest if node else 0.0
                hot = list(node.hot_stacks) if node else []
                totals = {"read_ops_per_second": 0.0,
                          "write_ops_per_second": 0.0,
                          "errors_per_second": 0.0}
                nvols = 0
                if node is not None:
                    decay = self._decay_factor(node, now)
                    nvols = len(node.volumes)
                    for vid, agg in node.volumes.items():
                        r = agg.rates["read_ops"] * decay
                        totals["read_ops_per_second"] += r
                        totals["write_ops_per_second"] += \
                            agg.rates["write_ops"] * decay
                        totals["errors_per_second"] += \
                            agg.rates["errors"] * decay
                        per_vid_rate[vid] = \
                            per_vid_rate.get(vid, 0.0) + r
                        vid_holders.setdefault(vid, []).append(url)
            entry = {"snapshots": snapshots,
                     "last_ingest": last_ingest,
                     "volume_count": nvols, **totals}
            p99 = self.node_quantile(url, 0.99)
            if p99 is not None:
                entry["read_p99_seconds"] = p99
            if hot:
                entry["hot_stacks"] = [{"stack": s, "samples": n}
                                       for s, n in hot]
            if url in nodes_last_seen:
                entry["health"] = self.health(
                    url, nodes_last_seen[url], pulse_seconds)
            nodes[url] = entry
        top = sorted(per_vid_rate,
                     key=lambda v: (-per_vid_rate[v], v))[:limit]
        volumes: dict[str, dict] = {}
        for vid in top:
            by_node = {}
            for url in vid_holders.get(vid, ()):
                with self._lock:
                    node = self._nodes.get(url)
                    agg = node.volumes.get(vid) \
                        if node is not None else None
                    if agg is None:
                        continue
                    by_node[url] = self._row_locked(
                        node, vid, agg, self._decay_factor(node, now))
            if by_node:
                volumes[str(vid)] = by_node
        out = {"nodes": nodes, "volumes": volumes,
               "volumes_total": len(per_vid_rate),
               "volumes_omitted":
                   max(0, len(per_vid_rate) - len(top)),
               "limit": limit,
               "decay_halflife_seconds": self.halflife,
               "digest_window_seconds": self.window}
        median = self.cluster_median_p99()
        if median is not None:
            out["cluster_median_read_p99_seconds"] = median
        return out


# --------------------------------------------------------------------------
# master side: SLO burn-rate engine
# --------------------------------------------------------------------------

#: Latency objectives budget 1% of ops over the target ("p99" in the
#: objective name literally means 99% of ops must beat the target).
_LATENCY_BUDGET = 0.01


def _fmt_window(seconds: float) -> str:
    if seconds < 3600:
        return "%gm" % (seconds / 60.0)
    return "%gh" % (seconds / 3600.0)


class _Objective:
    __slots__ = ("name", "kind", "target", "budget", "read")

    def __init__(self, name: str, kind: str, target: float,
                 budget: float, read: bool = True):
        self.name = name
        self.kind = kind          # "latency" | "availability"
        self.target = target      # seconds | min ok-fraction
        self.budget = budget      # allowed bad-event fraction
        self.read = read


class SloEngine:
    """Declarative SLOs evaluated against the telemetry registry with
    SRE-style multi-window burn rates.

    Each evaluation tick turns the interval's telemetry into (bad,
    total) event counts per objective — for latency objectives, bad is
    the digest mass above the target (``Digest.cdf``); for
    availability, the error-counter delta — and appends them to a
    per-objective history ring. A window's **burn rate** is then

        (bad/total over the window) / error budget

    i.e. "how many times faster than sustainable is the budget
    burning". State per objective: ``page`` when BOTH fast windows
    (default 5m and 1h) burn above ``fast_burn_threshold`` (the
    short window makes the alert reactive, the long one keeps a brief
    blip from paging), ``warn`` when the slow window (default 6h)
    burns above ``slow_burn_threshold``, else ``ok``. Transitions land
    in a bounded alert ring surfaced by ``/debug/vars`` and
    ``/cluster/slo``; every (objective, window) pair exports a
    ``seaweed_slo_burn_rate`` gauge.
    """

    def __init__(self, telemetry: ClusterTelemetry, clock=time.time):
        self.telemetry = telemetry
        self.clock = clock
        #: Own registry, ``seaweed_`` namespace — the master appends
        #: its render to /metrics next to the trace/retry families.
        self.metrics = Metrics(namespace="seaweed")
        self._lock = threading.Lock()
        self.enabled = False
        self.eval_interval = 5.0
        self.fast_burn_threshold = 14.4
        self.slow_burn_threshold = 6.0
        self.fast_window = 300.0
        self.fast_long_window = 3600.0
        self.slow_window = 21600.0
        self._objectives: list[_Objective] = []
        #: name -> deque[(ts, bad, total)], pruned past slow_window
        self._history: dict[str, deque] = {}
        self._state: dict[str, str] = {}
        self._last_counters: Optional[dict] = None
        self._last_digest_ts = 0.0
        self.alerts: deque = deque(maxlen=64)
        self.evaluations = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------- configuration ----------------

    def configure(self, conf: Optional[dict]) -> "SloEngine":
        """Apply a loaded config dict's ``[slo]`` section (also accepts
        the section itself). Rebuilds the objective list; histories of
        surviving objectives are kept."""
        s = conf or {}
        if isinstance(s.get("slo"), dict):
            s = s["slo"]
        with self._lock:
            self.enabled = bool(s.get("enabled", self.enabled))
            self.eval_interval = float(
                s.get("evaluation_interval_seconds", self.eval_interval))
            self.fast_burn_threshold = float(
                s.get("fast_burn_threshold", self.fast_burn_threshold))
            self.slow_burn_threshold = float(
                s.get("slow_burn_threshold", self.slow_burn_threshold))
            self.fast_window = float(
                s.get("fast_window_seconds", self.fast_window))
            self.fast_long_window = float(
                s.get("fast_long_window_seconds", self.fast_long_window))
            self.slow_window = float(
                s.get("slow_window_seconds", self.slow_window))
            objectives = []
            ms = float(s.get("read_p99_ms", 0.0) or 0.0)
            if ms > 0:
                objectives.append(_Objective(
                    "read_p99_ms", "latency", ms / 1e3,
                    _LATENCY_BUDGET, read=True))
            ms = float(s.get("write_p99_ms", 0.0) or 0.0)
            if ms > 0:
                objectives.append(_Objective(
                    "write_p99_ms", "latency", ms / 1e3,
                    _LATENCY_BUDGET, read=False))
            avail = float(s.get("availability", 0.0) or 0.0)
            if avail > 0:
                if not 0 < avail < 1:
                    raise ValueError(
                        f"[slo] availability must be in (0, 1): {avail}")
                objectives.append(_Objective(
                    "availability", "availability", avail, 1.0 - avail))
            self._objectives = objectives
            names = {o.name for o in objectives}
            for name in names:
                self._history.setdefault(name, deque())
                self._state.setdefault(name, "ok")
            for stale in set(self._history) - names:
                del self._history[stale]
                del self._state[stale]
        return self

    # ---------------- evaluation ----------------

    def _burn(self, name: str, window: float, now: float) -> float:
        bad = total = 0.0
        for ts, b, t in self._history[name]:
            if now - ts <= window:
                bad += b
                total += t
        if total <= 0:
            return 0.0
        budget = next(o.budget for o in self._objectives
                      if o.name == name)
        return (bad / total) / max(budget, 1e-9)

    def evaluate(self) -> dict:
        """One tick: sample the telemetry registry, update burn rates,
        gauges, and alert states. Safe to call on demand (tests, the
        lazy /cluster/slo path) — the interval deltas self-correct."""
        now = self.clock()
        with self._lock:
            if not self.enabled or not self._objectives:
                return self.payload_locked(now)
            self.evaluations += 1
            counters = self.telemetry.cluster_counters()
            prev, self._last_counters = self._last_counters, counters
            read_d = self.telemetry.digests_since(self._last_digest_ts,
                                                  read=True)
            write_d = self.telemetry.digests_since(self._last_digest_ts,
                                                   read=False)
            self._last_digest_ts = now
            for o in self._objectives:
                if o.kind == "availability":
                    if prev is None:
                        continue
                    total = max(0, counters["ops"] - prev["ops"])
                    bad = min(total, max(
                        0, counters["errors"] - prev["errors"]))
                else:
                    d = read_d if o.read else write_d
                    if d is None or not d.count:
                        continue
                    frac_ok = d.cdf(o.target)
                    if math.isnan(frac_ok):
                        continue
                    total = d.count
                    bad = (1.0 - frac_ok) * total
                hist = self._history[o.name]
                hist.append((now, float(bad), float(total)))
                while hist and now - hist[0][0] > self.slow_window:
                    hist.popleft()
            for o in self._objectives:
                burns = {
                    _fmt_window(self.fast_window):
                        self._burn(o.name, self.fast_window, now),
                    _fmt_window(self.fast_long_window):
                        self._burn(o.name, self.fast_long_window, now),
                    _fmt_window(self.slow_window):
                        self._burn(o.name, self.slow_window, now),
                }
                for win, rate in burns.items():
                    self.metrics.gauge("slo_burn_rate", slo=o.name,
                                       window=win).set(rate)
                fast, fast_long, slow = burns.values()
                if (fast > self.fast_burn_threshold
                        and fast_long > self.fast_burn_threshold):
                    state = "page"
                elif slow > self.slow_burn_threshold:
                    state = "warn"
                else:
                    state = "ok"
                if state != self._state[o.name]:
                    self.alerts.append({
                        "ts": now, "slo": o.name,
                        "from": self._state[o.name], "to": state,
                        "burn_rates": {w: round(r, 2)
                                       for w, r in burns.items()},
                    })
                    self._state[o.name] = state
            return self.payload_locked(now)

    # ---------------- views ----------------

    def payload_locked(self, now: Optional[float] = None) -> dict:
        """/cluster/slo JSON; caller holds no lock requirement — only
        reads coherent snapshots of the per-objective rings."""
        now = self.clock() if now is None else now
        objectives = {}
        for o in self._objectives:
            hist = self._history.get(o.name, ())
            bad = sum(b for _, b, _ in hist)
            total = sum(t for _, _, t in hist)
            objectives[o.name] = {
                "kind": o.kind,
                "target": (o.target if o.kind == "availability"
                           else o.target * 1e3),
                "unit": "fraction" if o.kind == "availability" else "ms",
                "error_budget": o.budget,
                "state": self._state.get(o.name, "ok"),
                "bad_events": round(bad, 2),
                "total_events": round(total, 2),
                "burn_rates": {
                    _fmt_window(w): round(self._burn(o.name, w, now), 3)
                    for w in (self.fast_window, self.fast_long_window,
                              self.slow_window)} if total else {},
            }
        return {
            "enabled": self.enabled,
            "evaluations": self.evaluations,
            "evaluation_interval_seconds": self.eval_interval,
            "fast_burn_threshold": self.fast_burn_threshold,
            "slow_burn_threshold": self.slow_burn_threshold,
            "windows_seconds": [self.fast_window, self.fast_long_window,
                                self.slow_window],
            "objectives": objectives,
            "alerts": list(self.alerts),
        }

    def payload(self) -> dict:
        with self._lock:
            return self.payload_locked()

    def worst_state(self) -> str:
        """ok < warn < page — what cluster.check folds in."""
        order = {"ok": 0, "warn": 1, "page": 2}
        with self._lock:
            states = list(self._state.values())
        return max(states, key=lambda s: order.get(s, 0), default="ok")

    # ---------------- lifecycle ----------------

    def start(self) -> "SloEngine":
        if not self.enabled or (self._thread is not None
                                and self._thread.is_alive()):
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slo-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.eval_interval):
            try:
                self.evaluate()
            except Exception as e:  # noqa: BLE001 — engine must not die
                glog.warning("slo evaluation failed: %s: %s",
                             type(e).__name__, e)
