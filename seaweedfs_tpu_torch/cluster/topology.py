"""Master-side in-memory cluster topology.

The port of ``seaweedfs_tpu/cluster/topology.py``, with its telemetry
registry (``ClusterTelemetry``, fed by the heartbeat) and without the
sim harness's from-scratch index check (``_rebuild_indexes`` /
``check_indexes``).

Mirrors weed/topology/ (SURVEY.md §2 "Topology"): a DC -> rack ->
data-node tree rebuilt from heartbeat snapshots, per-(collection, replication, ttl)
volume layouts that track which volumes are writable and where replicas
live, and EC shard location maps (topology_ec.go's EcShardLocations).
``pick_for_write`` implements volume_layout.go's writable-volume choice;
``pick_grow_targets`` is the placement half of volume_growth.go —
replica targets spread across data centers / racks / nodes according to
the replica-placement code (e.g. ``010`` = one extra copy on a different
rack, same DC).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

from ..storage.ec_files import ShardBits
from ..storage.superblock import ReplicaPlacement, Ttl
from .telemetry import ClusterTelemetry


@dataclass(slots=True)
class VolumeInfo:
    """One volume replica as reported by a heartbeat.

    ``slots=True`` matters at simulation scale: a million replicas are
    resident in one master process, and the per-instance ``__dict__``
    would triple their footprint.
    """
    id: int
    collection: str = ""
    size: int = 0
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: str = "000"
    version: int = 3
    ttl: str = ""
    #: Last .dat mtime (unix seconds); drives topology TTL reaping.
    modified_at_second: int = 0


@dataclass
class DataNode:
    url: str                     # "ip:port" — the node id
    public_url: str = ""
    data_center: str = "DefaultDataCenter"
    rack: str = "DefaultRack"
    max_volume_count: int = 8
    volumes: dict[tuple[str, int], VolumeInfo] = field(default_factory=dict)
    ec_shards: dict[tuple[str, int], ShardBits] = field(default_factory=dict)
    last_seen: float = field(default_factory=time.time)
    #: Did the last heartbeat snapshot change this node's contribution
    #: to the indexes? Steady-state pulses leave it False, which is the
    #: signal the ingestion path uses to skip span/log allocation.
    last_heartbeat_changed: bool = True

    @property
    def volume_count(self) -> int:
        return len(self.volumes)

    @property
    def ec_shard_count(self) -> int:
        return sum(b.count() for b in self.ec_shards.values())

    @property
    def free_slots(self) -> int:
        # The reference charges EC shards fractionally; one volume ==
        # one slot, ec shards count at shards/total granularity.
        return max(0, self.max_volume_count - self.volume_count
                   - (self.ec_shard_count + 13) // 14)


class TopologyError(RuntimeError):
    pass


@dataclass(frozen=True)
class LayoutKey:
    collection: str
    replication: str
    ttl: str


class VolumeLayout:
    """Tracks volumes of one (collection, replication, ttl) class."""

    def __init__(self, key: LayoutKey):
        self.key = key
        self.locations: dict[int, set[str]] = {}       # vid -> node urls
        self.readonly: set[int] = set()
        self.sizes: dict[int, int] = {}

    def writable(self, volume_size_limit: int) -> list[int]:
        rp = ReplicaPlacement.parse(self.key.replication)
        return [vid for vid, urls in self.locations.items()
                if vid not in self.readonly
                and len(urls) >= rp.copy_count()
                and self.sizes.get(vid, 0) < volume_size_limit]


class Topology:
    """The whole tree + layouts + EC shard map. Thread-safe."""

    def __init__(self, volume_size_limit: int = 30 * 1024 ** 3,
                 pulse_seconds: float = 5.0, seed: Optional[int] = None,
                 clock=time.time):
        self._lock = threading.RLock()
        self.nodes: dict[str, DataNode] = {}
        self.layouts: dict[LayoutKey, VolumeLayout] = {}
        # vid -> {shard_id -> set of node urls}; collection in ec_collections
        self.ec_locations: dict[int, dict[int, set[str]]] = {}
        self.ec_collections: dict[int, str] = {}
        # Reverse maps that make index maintenance per-volume instead of
        # per-cluster: which nodes hold a (collection, vid), which layout
        # keys it currently appears under, and which (url, collection)
        # pairs hold EC shards for a vid. Kept in lockstep with
        # ``layouts``/``ec_locations`` by ``_reindex_volume``/``_reindex_ec``.
        self._vol_holders: dict[tuple[str, int], set[str]] = {}
        self._vol_keys: dict[tuple[str, int], set[LayoutKey]] = {}
        self._ec_holders: dict[int, dict[tuple[str, str], ShardBits]] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.max_volume_id = 0
        self.clock = clock
        #: Rolling per-node/per-volume hot stats + health, fed by
        #: telemetry snapshots riding heartbeats (telemetry.py).
        self.telemetry = ClusterTelemetry(clock=clock)
        #: Ingestion counters for the sim/bench plane: total heartbeats
        #: and how many took the unchanged-topology fast path.
        self.heartbeats_total = 0
        self.heartbeats_unchanged = 0
        self._rng = random.Random(seed)

    # ---------------- heartbeat ingestion ----------------

    def register_heartbeat(self, url: str, *, public_url: str = "",
                           data_center: str = "", rack: str = "",
                           max_volume_count: int = 8,
                           volumes: "Iterable[VolumeInfo] | dict" = (),
                           ec_shards: Iterable[tuple[str, int, int]] = (),
                           ) -> DataNode:
        """Full-snapshot update of one node (SURVEY.md §3.4).

        ``ec_shards`` items are (collection, volume_id, ec_index_bits).

        Index maintenance is per-node delta, not per-cluster rebuild:
        only volumes whose index-relevant fields (membership, size,
        read_only, placement, ttl) differ from the node's previous
        snapshot are re-indexed, so a steady-state pulse costs O(node
        volumes) to diff and touches no shared index entry at all.
        ``node.last_heartbeat_changed`` records whether this snapshot
        changed anything.

        ``VolumeInfo`` objects are treated as immutable once reported:
        a snapshot that reuses a previously-reported object is taken as
        "no change" without field comparison, so callers must replace
        (not mutate) an object to report new stats for its volume.

        ``volumes`` may also be a pre-keyed ``{(collection, id):
        VolumeInfo}`` dict, which is ADOPTED as the node's snapshot
        without re-keying — ownership transfers, the caller must never
        mutate it afterwards. The sim harness hands over ``dict(...)``
        copies this way; at thousands of nodes the per-pulse tuple
        construction is the difference between flat and quadratic.
        """
        with self._lock:
            self.heartbeats_total += 1
            node = self.nodes.get(url)
            changed = False
            if node is None:
                node = DataNode(url=url)
                self.nodes[url] = node
                changed = True
            node.public_url = public_url or url
            if data_center and node.data_center != data_center:
                node.data_center = data_center
                changed = True
            if rack and node.rack != rack:
                node.rack = rack
                changed = True
            if node.max_volume_count != max_volume_count:
                node.max_volume_count = max_volume_count
                changed = True
            node.last_seen = self.clock()

            old_vols = node.volumes
            new_vols = volumes if isinstance(volumes, dict) \
                else {(v.collection, v.id): v for v in volumes}
            touched: list[tuple[str, int]] = []
            for k, v in new_vols.items():
                ov = old_vols.get(k)
                if ov is v:
                    continue
                if ov is None or (ov.size != v.size
                                  or ov.read_only != v.read_only
                                  or ov.replica_placement
                                  != v.replica_placement
                                  or ov.ttl != v.ttl):
                    touched.append(k)
            removed = [k for k in old_vols if k not in new_vols]
            node.volumes = new_vols
            for k in removed:
                hs = self._vol_holders.get(k)
                if hs is not None:
                    hs.discard(url)
                    if not hs:
                        del self._vol_holders[k]
            for k in touched:
                self._vol_holders.setdefault(k, set()).add(url)
                if k[1] > self.max_volume_id:
                    self.max_volume_id = k[1]
            for k in touched:
                self._reindex_volume(*k)
            for k in removed:
                self._reindex_volume(*k)

            old_ec = node.ec_shards
            new_ec = {(c, vid): ShardBits(bits)
                      for (c, vid, bits) in ec_shards}
            ec_touched: list[tuple[str, int]] = []
            for k, bits in new_ec.items():
                ob = old_ec.get(k)
                if ob is None or ob.bits != bits.bits:
                    ec_touched.append(k)
            ec_removed = [k for k in old_ec if k not in new_ec]
            node.ec_shards = new_ec
            for (col, vid) in ec_removed:
                hmap = self._ec_holders.get(vid)
                if hmap is not None:
                    hmap.pop((url, col), None)
                    if not hmap:
                        del self._ec_holders[vid]
            for (col, vid) in ec_touched:
                self._ec_holders.setdefault(vid, {})[(url, col)] = \
                    new_ec[(col, vid)]
                if vid > self.max_volume_id:
                    self.max_volume_id = vid
            for (_c, vid) in ec_touched:
                self._reindex_ec(vid)
            for (_c, vid) in ec_removed:
                self._reindex_ec(vid)

            changed = changed or bool(touched) or bool(removed) \
                or bool(ec_touched) or bool(ec_removed)
            node.last_heartbeat_changed = changed
            if not changed:
                self.heartbeats_unchanged += 1
            return node

    def register_volume(self, url: str, info: VolumeInfo) -> None:
        """Record one freshly-allocated volume on a node immediately
        (optimistic registration after AllocateVolume; the next full
        heartbeat snapshot confirms it)."""
        with self._lock:
            node = self.nodes.get(url)
            if node is None:
                raise TopologyError(f"unknown data node {url}")
            k = (info.collection, info.id)
            node.volumes[k] = info
            self.max_volume_id = max(self.max_volume_id, info.id)
            self._vol_holders.setdefault(k, set()).add(url)
            self._reindex_volume(*k)

    def unregister_volume(self, url: str, volume_id: int,
                          collection: str = "") -> None:
        """Drop one volume from a node immediately (TTL reap / delete);
        the next heartbeat snapshot confirms the removal."""
        with self._lock:
            node = self.nodes.get(url)
            if node is None:
                return
            k = (collection, volume_id)
            if node.volumes.pop(k, None) is None:
                return
            hs = self._vol_holders.get(k)
            if hs is not None:
                hs.discard(url)
                if not hs:
                    del self._vol_holders[k]
            self._reindex_volume(*k)

    def snapshot_nodes(self) -> list[DataNode]:
        """Stable list of nodes for iteration outside the lock."""
        with self._lock:
            return list(self.nodes.values())

    def snapshot_holdings(self) -> list[
            tuple[DataNode, list[VolumeInfo], list[tuple]]]:
        """Each node with copies of its volumes and its
        ``((collection, vid), ShardBits)`` EC entries, taken under the
        lock: ``register_volume`` (a grow) adds to a node's volumes in
        place, so a walk of them outside the lock can fail."""
        with self._lock:
            return [(n, list(n.volumes.values()), list(n.ec_shards.items()))
                    for n in self.nodes.values()]

    def unregister(self, url: str) -> None:
        with self._lock:
            node = self.nodes.pop(url, None)
            if node is not None:
                self._drop_node_from_indexes(node)

    def reap_dead_nodes(self, timeout: Optional[float] = None) -> list[str]:
        """Drop nodes whose heartbeats stopped (the failure detector)."""
        # Floor of 10 s: on a loaded host a healthy server's heartbeat
        # thread can starve for whole seconds (observed under the
        # flake-hunt antagonist with pulse 0.2 s: nodes reaped every
        # few seconds while alive); 5x a sub-second test pulse is
        # noise, not a death verdict. Production pulse (5 s) keeps its
        # reference-matching 25 s window.
        timeout = timeout if timeout is not None \
            else max(5 * self.pulse_seconds, 10.0)
        now = self.clock()
        with self._lock:
            dead = [u for u, n in self.nodes.items()
                    if now - n.last_seen > timeout]
            for u in dead:
                node = self.nodes.pop(u)
                self._drop_node_from_indexes(node)
        for u in dead:
            self.telemetry.forget(u)
        return dead

    # ---------------- index maintenance ----------------
    #
    # The shared indexes (``layouts``, ``ec_locations``) are maintained
    # per-volume: any change to who holds (collection, vid) triggers a
    # recompute of just that volume's entries from its current holders
    # (at most replica-count nodes). A 2,000-node heartbeat sweep over
    # an unchanged cluster therefore does zero index writes.

    def _reindex_volume(self, collection: str, vid: int) -> None:
        """Recompute every index entry for one logical volume from the
        node snapshots of its current holders (callers hold the lock)."""
        k = (collection, vid)
        per_key: dict[LayoutKey, tuple[set[str], int, bool]] = {}
        for url in self._vol_holders.get(k, ()):
            node = self.nodes.get(url)
            v = node.volumes.get(k) if node is not None else None
            if v is None:
                continue
            key = LayoutKey(collection, v.replica_placement, v.ttl)
            urls, size, ro = per_key.get(key, (None, 0, False))
            if urls is None:
                urls = set()
            urls.add(url)
            per_key[key] = (urls, max(size, v.size), ro or v.read_only)
        for key in self._vol_keys.get(k, set()) - set(per_key):
            lay = self.layouts.get(key)
            if lay is not None:
                lay.locations.pop(vid, None)
                lay.sizes.pop(vid, None)
                lay.readonly.discard(vid)
                if not lay.locations:
                    del self.layouts[key]
        for key, (urls, size, ro) in per_key.items():
            lay = self.layouts.get(key)
            if lay is None:
                lay = self.layouts[key] = VolumeLayout(key)
            lay.locations[vid] = urls
            lay.sizes[vid] = size
            if ro:
                lay.readonly.add(vid)
            else:
                lay.readonly.discard(vid)
        if per_key:
            self._vol_keys[k] = set(per_key)
        else:
            self._vol_keys.pop(k, None)

    def _reindex_ec(self, vid: int) -> None:
        """Recompute the EC shard-location map for one volume id from
        its current shard holders (callers hold the lock)."""
        holders = self._ec_holders.get(vid)
        if not holders:
            self.ec_locations.pop(vid, None)
            self.ec_collections.pop(vid, None)
            return
        shard_map: dict[int, set[str]] = {}
        col = ""
        for (url, c), bits in holders.items():
            col = c
            for sid in bits.ids():
                shard_map.setdefault(sid, set()).add(url)
        self.ec_locations[vid] = shard_map
        self.ec_collections[vid] = col

    def _drop_node_from_indexes(self, node: DataNode) -> None:
        """Remove one (already unlinked) node's contribution — O(its
        own volumes), not O(cluster) (callers hold the lock)."""
        for k in node.volumes:
            hs = self._vol_holders.get(k)
            if hs is not None:
                hs.discard(node.url)
                if not hs:
                    del self._vol_holders[k]
            self._reindex_volume(*k)
        for (col, vid) in node.ec_shards:
            hmap = self._ec_holders.get(vid)
            if hmap is not None:
                hmap.pop((node.url, col), None)
                if not hmap:
                    del self._ec_holders[vid]
            self._reindex_ec(vid)

    # ---------------- lookups ----------------

    def lookup_volume(self, volume_id: int, collection: str = ""
                      ) -> list[DataNode]:
        with self._lock:
            urls: set[str] = set()
            for key, lay in self.layouts.items():
                if collection and key.collection != collection:
                    continue
                urls |= lay.locations.get(volume_id, set())
            return [self.nodes[u] for u in sorted(urls) if u in self.nodes]

    def lookup_ec_volume(self, volume_id: int
                         ) -> dict[int, list[DataNode]]:
        with self._lock:
            out: dict[int, list[DataNode]] = {}
            for sid, urls in self.ec_locations.get(volume_id, {}).items():
                out[sid] = [self.nodes[u] for u in sorted(urls)
                            if u in self.nodes]
            return out

    def next_volume_id(self) -> int:
        with self._lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def observe_max_volume_id(self, vid: int) -> None:
        """Bump past an id seen elsewhere (HA state replication): a
        follower promoted to leader must never reissue a volume id its
        predecessor already consumed."""
        with self._lock:
            self.max_volume_id = max(self.max_volume_id, vid)

    # ---------------- write placement ----------------

    def pick_for_write(self, collection: str = "", replication: str = "000",
                       ttl: str = "") -> tuple[int, list[DataNode]]:
        """A writable volume id + its replica nodes, or TopologyError."""
        Ttl.parse(ttl)  # validate early
        key = LayoutKey(collection, replication, ttl)
        with self._lock:
            lay = self.layouts.get(key)
            if lay is None:
                raise TopologyError(
                    f"no writable volumes for {key} (grow first)")
            writable = lay.writable(self.volume_size_limit)
            if not writable:
                raise TopologyError(
                    f"no writable volumes for {key} (grow first)")
            vid = self._rng.choice(writable)
            return vid, [self.nodes[u] for u in sorted(lay.locations[vid])
                         if u in self.nodes]

    def pick_grow_targets(self, replication: str = "000",
                          ) -> list[DataNode]:
        """Placement for a brand-new volume's replicas.

        volume_growth.go semantics: the replica-placement digits are
        (other DCs, other racks same DC, other nodes same rack). Picks a
        primary node with free slots, then satisfies each digit; raises
        if the cluster can't.
        """
        rp = ReplicaPlacement.parse(replication)
        with self._lock:
            candidates = [n for n in self.nodes.values() if n.free_slots > 0]
            if not candidates:
                raise TopologyError("no data node with free slots")
            self._rng.shuffle(candidates)
            # Prefer least-loaded primary for balance.
            candidates.sort(key=lambda n: n.volume_count)
            for primary in candidates:
                chosen = self._grow_from(primary, rp, candidates)
                if chosen is not None:
                    return chosen
            raise TopologyError(
                f"cannot satisfy replica placement {replication}")

    def _grow_from(self, primary: DataNode, rp: ReplicaPlacement,
                   candidates: list[DataNode]) -> Optional[list[DataNode]]:
        chosen = [primary]

        def ok_same_rack(n):
            return (n.data_center == primary.data_center
                    and n.rack == primary.rack and n is not primary)

        def ok_other_rack(n):
            return (n.data_center == primary.data_center
                    and n.rack != primary.rack)

        def ok_other_dc(n):
            return n.data_center != primary.data_center

        for count, pred in ((rp.same_rack, ok_same_rack),
                            (rp.diff_rack, ok_other_rack),
                            (rp.diff_dc, ok_other_dc)):
            pool = [n for n in candidates if pred(n) and n not in chosen]
            if len(pool) < count:
                return None
            chosen.extend(pool[:count])
        return chosen

    # ---------------- EC placement ----------------

    def pick_ec_spread(self, total_shards: int,
                       exclude: Iterable[str] = ()) -> list[DataNode]:
        """Round-robin shard targets, racks first (command_ec_encode.go's
        spread step): sort nodes by (ec load), interleave racks."""
        with self._lock:
            nodes = [n for n in self.nodes.values()
                     if n.url not in set(exclude)]
            if not nodes:
                nodes = list(self.nodes.values())
            if not nodes:
                raise TopologyError("no data nodes for EC spread")
            by_rack: dict[tuple[str, str], list[DataNode]] = {}
            for n in sorted(nodes, key=lambda n: n.ec_shard_count):
                by_rack.setdefault((n.data_center, n.rack), []).append(n)
            racks = sorted(by_rack.values(),
                           key=lambda ns: sum(n.ec_shard_count for n in ns))
            out: list[DataNode] = []
            i = 0
            while len(out) < total_shards:
                rack = racks[i % len(racks)]
                out.append(rack[(i // len(racks)) % len(rack)])
                i += 1
            return out

    # ---------------- status ----------------

    def to_map(self) -> dict:
        """JSON-able snapshot (master /cluster/status, /vol/status)."""
        with self._lock:
            dcs: dict[str, dict[str, list[dict]]] = {}
            for n in self.nodes.values():
                rackmap = dcs.setdefault(n.data_center, {})
                rackmap.setdefault(n.rack, []).append({
                    "Url": n.url, "PublicUrl": n.public_url,
                    "Volumes": n.volume_count,
                    "EcShards": n.ec_shard_count,
                    "Max": n.max_volume_count,
                })
            return {
                "Max": sum(n.max_volume_count for n in self.nodes.values()),
                "Free": sum(n.free_slots for n in self.nodes.values()),
                "DataCenters": dcs,
                "MaxVolumeId": self.max_volume_id,
            }
