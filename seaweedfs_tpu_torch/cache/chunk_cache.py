"""Tiered hot-read chunk cache (weed/util/chunk_cache analog).

Memory tier: a segmented LRU (SLRU). New keys enter *probation*; a
second access promotes to *protected*, whose LRU victim demotes back to
probation. One large sequential scan therefore churns only the
probation segment — the hot set in protected survives (the admission /
scan-resistance property the reference gets from its layered caches).

Disk tier (optional): append-only needle-layer segment files with an
in-memory index (disk_tier.py). Memory-tier evictions demote to disk;
disk hits promote back into memory probation.

Both tiers honor TTL and explicit invalidation (per key, per volume,
or clear). Every cache registers with cache/invalidation.py so vacuum
and EC rebuild drop stale volumes everywhere.

The port of ``seaweedfs_tpu/cache/chunk_cache.py``. Inside a trace,
``get`` and ``put`` run under ``cache.get`` (tagged ``hit``) and
``cache.put`` (tagged ``admitted``) spans. Not ported yet: the race
checker's registration (ROADMAP Queue 1, "The sim harness, the lint and
the checkers").
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from ..util import tracing
from ..util.stats import Counter, Metrics
from . import invalidation
from .disk_tier import DiskTier

#: Default registry for caches not handed a server's own Metrics.
METRICS = Metrics(namespace="chunk_cache")


def fid_volume(fid: str) -> Optional[int]:
    """'3,0163...' -> 3; None for keys that aren't fids."""
    try:
        return int(str(fid).split(",")[0])
    except (ValueError, AttributeError):
        return None


def chunk_key(master_url: str, fid: str) -> str:
    """Cache key for one stored chunk. The master url scopes the key to
    a cluster: volume ids and needle keys are small integers that
    collide across clusters (and across tests) with different bytes."""
    return f"chunk:{master_url}:{fid}"


def key_volume(key: str) -> Optional[int]:
    """Volume id out of any cache-key shape ('chunk:<master>:<fid>',
    'ec:<vid>:<key>:<cookie>', or a bare fid); None when unparseable.
    Used to attribute misses — a miss has no stored entry to carry the
    volume tag."""
    if key.startswith("ec:"):
        try:
            return int(key.split(":", 2)[1])
        except (ValueError, IndexError):
            return None
    if key.startswith("chunk:"):
        return fid_volume(key.rsplit(":", 1)[-1])
    return fid_volume(key)


class _Entry:
    __slots__ = ("data", "expires", "volume")

    def __init__(self, data: bytes, expires: float,
                 volume: Optional[int]):
        self.data = data
        self.expires = expires
        self.volume = volume


class SegmentedLRU:
    """Byte-bounded SLRU. NOT thread-safe — ChunkCache holds the lock."""

    def __init__(self, capacity_bytes: int,
                 protected_fraction: float = 0.8):
        self.capacity = max(1, int(capacity_bytes))
        self.protected_cap = int(self.capacity *
                                 min(0.95, max(0.1, protected_fraction)))
        self._probation: OrderedDict[str, _Entry] = OrderedDict()
        self._protected: OrderedDict[str, _Entry] = OrderedDict()
        self.probation_bytes = 0
        self.protected_bytes = 0

    @property
    def bytes(self) -> int:
        return self.probation_bytes + self.protected_bytes

    @property
    def entries(self) -> int:
        return len(self._probation) + len(self._protected)

    def get(self, key: str) -> Optional[_Entry]:
        e = self._protected.get(key)
        if e is not None:
            self._protected.move_to_end(key)
            return e
        e = self._probation.pop(key, None)
        if e is None:
            return None
        # promote; overflow demotes the protected LRU back to probation
        self.probation_bytes -= len(e.data)
        self._protected[key] = e
        self.protected_bytes += len(e.data)
        while self.protected_bytes > self.protected_cap and \
                len(self._protected) > 1:
            k2, e2 = self._protected.popitem(last=False)
            self.protected_bytes -= len(e2.data)
            self._probation[k2] = e2
            self.probation_bytes += len(e2.data)
        return e

    def put(self, key: str, entry: _Entry) -> list[tuple[str, _Entry]]:
        """Insert into probation; returns evicted (key, entry) pairs."""
        self.remove(key)
        self._probation[key] = entry
        self.probation_bytes += len(entry.data)
        evicted: list[tuple[str, _Entry]] = []
        while self.bytes > self.capacity:
            if self._probation:
                k, e = self._probation.popitem(last=False)
                self.probation_bytes -= len(e.data)
            elif self._protected:
                k, e = self._protected.popitem(last=False)
                self.protected_bytes -= len(e.data)
            else:  # pragma: no cover — capacity >= 1 guards this
                break
            evicted.append((k, e))
        return evicted

    def remove(self, key: str) -> Optional[_Entry]:
        e = self._probation.pop(key, None)
        if e is not None:
            self.probation_bytes -= len(e.data)
            return e
        e = self._protected.pop(key, None)
        if e is not None:
            self.protected_bytes -= len(e.data)
        return e

    def __contains__(self, key: str) -> bool:
        return key in self._probation or key in self._protected

    def clear(self) -> None:
        self._probation.clear()
        self._protected.clear()
        self.probation_bytes = self.protected_bytes = 0


class ChunkCache:
    """Thread-safe two-tier chunk cache with TTL + invalidation."""

    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024, *,
                 disk_dir: Optional[str] = None,
                 disk_capacity_bytes: int = 256 * 1024 * 1024,
                 disk_segments: int = 4,
                 disk_compaction: bool = True,
                 disk_hot_min_hits: int = 1,
                 ttl_seconds: float = 0.0,
                 admission_max_fraction: float = 0.125,
                 protected_fraction: float = 0.8,
                 metrics: Optional[Metrics] = None,
                 clock=time.time):
        self._lock = threading.RLock()
        self._mem = SegmentedLRU(capacity_bytes, protected_fraction)
        self._disk = DiskTier(disk_dir, disk_capacity_bytes,
                              disk_segments, clock=clock,
                              compaction=disk_compaction,
                              hot_min_hits=disk_hot_min_hits) \
            if disk_dir else None
        self.ttl = float(ttl_seconds)
        #: Admission control: one item larger than this never enters the
        #: memory tier, so a big-object scan cannot displace the hot set.
        self.admission_max = max(
            1, int(self._mem.capacity *
                   min(1.0, max(0.001, admission_max_fraction))))
        self.metrics = metrics if metrics is not None else METRICS
        # Hot-path counters resolved ONCE: the registry lookup (tuple
        # key + registry lock) is measurable per-get at cache speeds.
        self._m_hit_mem = self.metrics.counter("cache_hits",
                                               tier="memory")
        self._m_hit_disk = self.metrics.counter("cache_hits",
                                                tier="disk")
        self._m_miss = self.metrics.counter("cache_misses")
        self._m_evict = self.metrics.counter("cache_evictions",
                                             tier="memory")
        self._m_reject = self.metrics.counter("cache_admission_rejected")
        self._g_mem_bytes = self.metrics.gauge("cache_bytes",
                                               tier="memory")
        self._g_mem_entries = self.metrics.gauge("cache_entries",
                                                 tier="memory")
        self._g_disk_bytes = self.metrics.gauge("cache_bytes",
                                                tier="disk")
        self._g_disk_entries = self.metrics.gauge("cache_entries",
                                                  tier="disk")
        # Per-volume hit/miss/reject counters (cache_volume_* families)
        # feed the telemetry plane's per-volume heartbeat stats. The
        # label space is capped: the first _vol_label_cap distinct
        # volumes get their own series, the rest share volume="other",
        # so a pathological workload can't mint unbounded label values.
        self._vol_label_cap = 128
        self._vol_counters: dict[tuple[str, int], Counter] = {}
        self._vol_labelled: set[int] = set()
        self._m_vol_other: dict[str, Counter] = {}
        self.clock = clock
        self._volumes: dict[int, set[str]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admission_rejects = 0
        if self._disk is not None:
            # crash-restart reload: rebuild the volume index from the
            # disk tier's replayed record headers
            for key, vol in self._disk.keys_with_volumes():
                if vol:
                    self._volumes.setdefault(vol, set()).add(key)
        invalidation.register_cache(self)
        # the race checker registers the cache here in the JAX package;
        # the port has no checkers yet (ROADMAP Queue 1, "The sim
        # harness, the lint and the checkers")

    # ------------- internal -------------

    def _count(self, name: str, **labels) -> None:
        self.metrics.counter(f"cache_{name}", **labels).inc()

    def _gauges(self) -> None:
        self._g_mem_bytes.set(self._mem.bytes)
        self._g_mem_entries.set(self._mem.entries)
        if self._disk is not None:
            self._g_disk_bytes.set(self._disk.bytes)
            self._g_disk_entries.set(self._disk.entries)

    def _vol_count(self, kind: str, volume: Optional[int]) -> None:
        """Bump the per-volume counter for one hit/miss/reject. Caller
        holds ``self._lock`` (membership checks and the labelled set
        are lock-protected state)."""
        if volume is None:
            return
        c = self._vol_counters.get((kind, volume))
        if c is None:
            if volume in self._vol_labelled or \
                    len(self._vol_labelled) < self._vol_label_cap:
                self._vol_labelled.add(volume)
                c = self.metrics.counter(
                    f"cache_volume_{kind}",
                    # seaweedlint: disable=SW401 — _vol_label_cap caps ids, then "other"
                    volume=str(volume))
                self._vol_counters[(kind, volume)] = c
            else:
                c = self._m_vol_other.get(kind)
                if c is None:
                    c = self.metrics.counter(f"cache_volume_{kind}",
                                             volume="other")
                    self._m_vol_other[kind] = c
                # NOT cached under (kind, volume): the cache dict must
                # stay bounded by the label cap
        c.inc()

    def per_volume_counts(self) -> dict[int, dict[str, int]]:
        """{volume_id: {"hits": n, "misses": n, "rejects": n}} for the
        labelled volumes (telemetry heartbeat source)."""
        with self._lock:
            out: dict[int, dict[str, int]] = {}
            for (kind, vid), c in self._vol_counters.items():
                out.setdefault(vid, {})[kind] = int(c.value)
            return out

    def _track(self, key: str, volume: Optional[int]) -> None:
        if volume is not None:
            self._volumes.setdefault(volume, set()).add(key)

    def _untrack(self, key: str, volume: Optional[int]) -> None:
        if volume is None:
            return
        s = self._volumes.get(volume)
        if s is not None:
            s.discard(key)
            if not s:
                del self._volumes[volume]

    # ------------- api -------------

    def get(self, key: str) -> Optional[bytes]:
        if not tracing.active():
            return self._get_inner(key)
        with tracing.span("cache.get") as sp:
            data = self._get_inner(key)
            if data is None:
                sp.tags = {"hit": "false"}
            else:
                sp.n_bytes = len(data)
                sp.tags = {"hit": "true"}
            return data

    def _get_inner(self, key: str) -> Optional[bytes]:
        now = self.clock()
        with self._lock:
            e = self._mem.get(key)
            if e is not None:
                if e.expires and now > e.expires:
                    self._mem.remove(key)
                    if self._disk is not None:
                        self._disk.remove(key)
                    self._untrack(key, e.volume)
                else:
                    self.hits += 1
                    self._m_hit_mem.inc()
                    self._vol_count("hits", e.volume)
                    return e.data
            elif self._disk is not None:
                rec = self._disk.get(key)
                if rec is not None:
                    data, volume, expires = rec
                    self.hits += 1
                    self._m_hit_disk.inc()
                    self._vol_count("hits", volume)
                    # promote back into memory probation
                    if len(data) <= self.admission_max:
                        self._insert_mem(key, _Entry(data, expires,
                                                     volume))
                    return data
            self.misses += 1
            self._m_miss.inc()
            self._vol_count("misses", key_volume(key))
            return None

    def put(self, key: str, data: bytes, volume: Optional[int] = None,
            ttl: Optional[float] = None) -> bool:
        if not tracing.active():
            return self._put_inner(key, data, volume, ttl)
        with tracing.span("cache.put") as sp:
            sp.n_bytes = len(data)
            admitted = self._put_inner(key, data, volume, ttl)
            sp.tag(admitted=str(admitted).lower())
            return admitted

    def _put_inner(self, key: str, data: bytes,
                   volume: Optional[int] = None,
                   ttl: Optional[float] = None) -> bool:
        data = bytes(data)
        ttl_eff = self.ttl if ttl is None else float(ttl)
        expires = self.clock() + ttl_eff if ttl_eff > 0 else 0.0
        entry = _Entry(data, expires, volume)
        with self._lock:
            if len(data) > self.admission_max:
                self.admission_rejects += 1
                self._m_reject.inc()
                self._vol_count("rejects", volume)
                # a too-big-for-memory item may still fit the disk tier
                if self._disk is not None and self._disk.admit(len(data)):
                    self._disk.put(key, data, volume, expires)
                    self._track(key, volume)
                    self._gauges()
                    return True
                return False
            self._insert_mem(key, entry)
            self._track(key, volume)
            self._gauges()
            return True

    def _insert_mem(self, key: str, entry: _Entry) -> None:
        for k, e in self._mem.put(key, entry):
            self.evictions += 1
            self._m_evict.inc()
            if self._disk is not None and self._disk.admit(len(e.data)):
                self._disk.put(k, e.data, e.volume, e.expires)
            elif not (self._disk is not None and k in self._disk):
                self._untrack(k, e.volume)

    def invalidate(self, key: str) -> None:
        with self._lock:
            e = self._mem.remove(key)
            if self._disk is not None:
                self._disk.remove(key)
            if e is not None:
                self._untrack(key, e.volume)
            else:
                for vid in list(self._volumes):
                    self._untrack(key, vid)
            self._count("invalidations")
            self._gauges()

    def invalidate_volume(self, volume_id: int) -> int:
        """Drop every entry tagged with ``volume_id`` (vacuum / EC
        rebuild / overwrite hooks). Returns how many were dropped."""
        with self._lock:
            keys = self._volumes.pop(int(volume_id), set())
            for k in keys:
                self._mem.remove(k)
                if self._disk is not None:
                    self._disk.remove(k)
            if keys:
                self._count("invalidations", scope="volume")
                self._gauges()
            return len(keys)

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            if self._disk is not None:
                self._disk.clear()
            self._volumes.clear()
            self._gauges()

    def close(self) -> None:
        invalidation.unregister_cache(self)
        if self._disk is not None:
            self._disk.close()

    def stats(self) -> dict:
        with self._lock:
            out = {
                "memory_entries": self._mem.entries,
                "memory_bytes": self._mem.bytes,
                "memory_capacity": self._mem.capacity,
                "protected_bytes": self._mem.protected_bytes,
                "probation_bytes": self._mem.probation_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "admission_rejects": self.admission_rejects,
                "ttl_seconds": self.ttl,
            }
            total = self.hits + self.misses
            out["hit_ratio"] = self.hits / total if total else 0.0
            if self._disk is not None:
                out["disk_entries"] = self._disk.entries
                out["disk_bytes"] = self._disk.bytes
                out["disk_capacity"] = \
                    self._disk.segment_cap * self._disk.segments
                out["disk_evictions"] = self._disk.evictions
                out["disk_dir"] = str(self._disk.dir)
                out["disk_compaction"] = self._disk.compaction
                out["compactions"] = self._disk.compactions
                out["compaction_bytes_copied"] = \
                    self._disk.compaction_bytes_copied
                out["compaction_bytes_dropped"] = \
                    self._disk.compaction_bytes_dropped
            return out

    # handy for tests
    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._mem or (
                self._disk is not None and key in self._disk)


# ------------- process-global cache + config -------------

_global_lock = threading.Lock()
_global: Optional[ChunkCache] = None


def global_chunk_cache() -> ChunkCache:
    """The shared read-path cache (filer chunk reads, gateway GETs).
    Built lazily with defaults; ``configure_global`` replaces it."""
    global _global
    with _global_lock:
        if _global is None:
            _global = ChunkCache()
        return _global


def configure_global(**kwargs) -> ChunkCache:
    """Rebuild the process-global cache (e.g. from ``[cache]`` TOML)."""
    global _global
    with _global_lock:
        old, _global = _global, ChunkCache(**kwargs)
        if old is not None:
            old.close()
        return _global


def from_config(conf: dict, clock=time.time) -> ChunkCache:
    """Build a cache from a loaded TOML dict (util/config.py ``load``),
    honoring the ``[cache]`` scaffold's knobs."""
    from ..util.config import lookup

    disk_dir = lookup(conf, "cache.disk.dir", "") or None
    return ChunkCache(
        int(lookup(conf, "cache.memory_bytes", 64 * 1024 * 1024)),
        disk_dir=disk_dir,
        disk_capacity_bytes=int(lookup(conf, "cache.disk.capacity_bytes",
                                       256 * 1024 * 1024)),
        disk_segments=int(lookup(conf, "cache.disk.segments", 4)),
        disk_compaction=bool(lookup(conf, "cache.disk.compaction", True)),
        disk_hot_min_hits=int(lookup(conf, "cache.disk.hot_min_hits", 1)),
        ttl_seconds=float(lookup(conf, "cache.ttl_seconds", 0.0)),
        admission_max_fraction=float(
            lookup(conf, "cache.admission_max_fraction", 0.125)),
        protected_fraction=float(
            lookup(conf, "cache.protected_fraction", 0.8)),
        clock=clock)
