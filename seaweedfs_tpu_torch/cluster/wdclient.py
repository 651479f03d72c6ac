"""Master client with a vid -> locations cache.

The port of ``seaweedfs_tpu/cluster/wdclient.py``, with its
``master.lookup`` (tagged ``cached``) and ``master.assign`` trace spans
and without the vid-map cache counters (ROADMAP Queue 1, "Telemetry,
SLO, usage and the policy engine").
Mirrors weed/wdclient (SURVEY.md §2 "Master client"): clients keep a
cached volume-id -> server-locations map, refreshed through the master's
LookupVolume, so repeated reads don't hit the master. It speaks the
reference's wire, so it works against a port master or a JAX one.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Optional

from .. import pb
from ..pb import master_pb2
from ..util import retry, tracing
from ..util import tls as tls_mod
from .master import _grpc_port

_LEADER_RE = re.compile(r"leader is ([0-9A-Za-z_.-]+:\d+)")


class MasterClient:
    """Accepts one or more master urls (comma-separated); follows the
    leader named in not-leader errors and rotates on dial failure, the
    way wdclient.MasterClient tracks the raft leader."""

    def __init__(self, master_url: str, cache_seconds: float = 10.0):
        self.master_urls = [u for u in master_url.split(",") if u]
        self.master_url = self.master_urls[0] if self.master_urls else ""
        self.cache_seconds = cache_seconds
        self._lock = threading.Lock()
        self._vid_map: dict[int, tuple[float, list[dict]]] = {}
        self._channel = None

    def _stub(self) -> pb.Stub:
        with self._lock:
            if self._channel is None:
                ip, http_port = self.master_url.rsplit(":", 1)
                self._channel = tls_mod.dial(
                    f"{ip}:{_grpc_port(int(http_port))}")
            return pb.master_stub(self._channel)

    def _redial(self, url: str) -> None:
        with self._lock:
            if url == self.master_url:
                return
            if self._channel is not None:
                self._channel.close()
                self._channel = None
            self.master_url = url
            if url not in self.master_urls:
                self.master_urls.append(url)

    def _rotate(self) -> None:
        if len(self.master_urls) < 2:
            return
        i = self.master_urls.index(self.master_url) \
            if self.master_url in self.master_urls else 0
        self._redial(self.master_urls[(i + 1) % len(self.master_urls)])

    def _with_failover(self, call):
        """Run ``call()``; on a not-leader error follow the named
        leader (or rotate and wait briefly when the leader is unknown
        mid-election), on a dead connection rotate masters. Dial
        failures and named-leader follows are bounded by the master
        count; the wait-out-an-election loop is bounded by the request
        deadline (ambient, or the policy's failover budget)."""
        import grpc

        budget = retry.current_deadline() or retry.Deadline(
            retry.policy().failover_budget)
        last: Exception = RuntimeError("no master configured")
        attempts = 0
        max_attempts = max(3, len(self.master_urls) + 1)
        while attempts < max_attempts:
            try:
                return call()
            except grpc.RpcError as e:
                last = e
                attempts += 1
                self._rotate()
            except RuntimeError as e:
                msg = str(e)
                if "not the leader" not in msg:
                    raise
                last = e
                m = _LEADER_RE.search(msg)
                if m:
                    attempts += 1
                    self._redial(m.group(1))
                else:
                    # Election in flight: rotate and wait a beat. This
                    # rung retries on TIME, not attempts — but only
                    # while the request deadline has budget left.
                    if budget.expired():
                        raise last
                    self._rotate()
                    time.sleep(min(0.3, max(0.0, budget.remaining())))
        raise last

    def close(self) -> None:
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None

    def lookup(self, volume_id: int, collection: str = "") -> list[dict]:
        """[{'url', 'publicUrl'}] for a volume; cached."""
        now = time.time()
        with self._lock:
            hit = self._vid_map.get(volume_id)
            if hit and now - hit[0] < self.cache_seconds:
                with tracing.span("master.lookup", vid=volume_id,
                                  cached="true"):
                    return hit[1]

        def call():
            resp = self._stub().LookupVolume(
                master_pb2.LookupVolumeRequest(
                    volume_ids=[str(volume_id)], collection=collection))
            for entry in resp.volume_id_locations:
                if entry.error and "not the leader" in entry.error:
                    # retryable via the failover loop (follows leader)
                    raise RuntimeError(entry.error)
            return resp

        with tracing.span("master.lookup", vid=volume_id,
                          cached="false"):
            resp = self._with_failover(call)
        locs: list[dict] = []
        for entry in resp.volume_id_locations:
            if entry.error:
                raise KeyError(entry.error)
            locs = [{"url": loc.url, "publicUrl": loc.public_url or loc.url}
                    for loc in entry.locations]
        with self._lock:
            self._vid_map[volume_id] = (now, locs)
        return locs

    def lookup_ec(self, volume_id: int) -> dict[int, list[str]]:
        resp = self._with_failover(lambda: self._stub().LookupEcVolume(
            master_pb2.LookupEcVolumeRequest(volume_id=volume_id)))
        return {e.shard_id: [loc.url for loc in e.locations]
                for e in resp.shard_id_locations}

    def assign(self, count: int = 1, collection: str = "",
               replication: str = "", ttl: str = "") -> dict:
        def call():
            resp = self._stub().Assign(master_pb2.AssignRequest(
                count=count, collection=collection,
                replication=replication, ttl=ttl))
            if resp.error:
                raise RuntimeError(resp.error)
            return resp

        with tracing.span("master.assign"):
            resp = self._with_failover(call)
        return {"fid": resp.fid, "url": resp.url,
                "publicUrl": resp.public_url, "count": resp.count,
                "auth": resp.auth}

    def invalidate(self, volume_id: Optional[int] = None) -> None:
        with self._lock:
            if volume_id is None:
                self._vid_map.clear()
            else:
                self._vid_map.pop(volume_id, None)
