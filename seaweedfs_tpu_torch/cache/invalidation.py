"""Cache invalidation registry: storage mutators -> live caches.

Vacuum compaction and EC shard rebuild change what a volume's bytes
mean; any chunk cache still holding pre-mutation payloads for that
volume must drop them before the next read. Mutators call
``volume_invalidated`` / ``base_invalidated`` here; every live
``ChunkCache`` registers itself at construction (weakly, so caches die
with their owners) and gets ``invalidate_volume`` called.

Over-invalidation is always safe — a dropped entry is just a future
miss — so notifications carry only the volume id, never a collection.

The registry above is **process-local**. A job-driven vacuum or EC
rebuild finishing on one volume server used to leave every *other*
host's gateway chunk cache holding the stale bytes (ROADMAP cache
item b). :class:`ClusterInvalidationHub` closes that gap: it lives on
the master, gateways subscribe (``POST /cluster/cache_subscribe``),
and when a mutating job task commits the hub POSTs
``/cache/invalidate`` to every subscriber + volume server — each
recipient funnels the event into its local registry via
``handle_event``. Delivery is best-effort single-attempt (same
webhook transport as the notification plane): a missed invalidation
only costs correctness if the volume mutates *and* the gateway re-
reads through a cache that never expires, and the TTL-less chunk
caches here are capacity-evicted, so the design accepts it, exactly
like the reference's best-effort ``cache.purge`` messages.

The port of ``seaweedfs_tpu/cache/invalidation.py``, whole.
"""

from __future__ import annotations

import re
import threading
import weakref
from pathlib import Path

from ..util import glog

_lock = threading.Lock()
_caches: "weakref.WeakSet" = weakref.WeakSet()
#: reason -> notification count, for cache.status / tests.
events: dict[str, int] = {}

_BASE_VID_RE = re.compile(r"(\d+)$")


def register_cache(cache) -> None:
    with _lock:
        _caches.add(cache)


def unregister_cache(cache) -> None:
    with _lock:
        _caches.discard(cache)


def volume_invalidated(volume_id: int, reason: str = "") -> None:
    with _lock:
        events[reason or "unknown"] = events.get(reason or "unknown",
                                                 0) + 1
        targets = list(_caches)
    for c in targets:
        try:
            c.invalidate_volume(volume_id)
        except Exception:  # noqa: BLE001 — one dying cache must not
            pass           # block the others from invalidating


def base_invalidated(base, reason: str = "") -> None:
    """Notify from a volume *base path* (``.../<collection>_<vid>`` or
    ``.../<vid>``), the identity EC-layer code has in hand."""
    m = _BASE_VID_RE.search(Path(base).name)
    if m:
        volume_invalidated(int(m.group(1)), reason=reason)


# --------------------------------------------------------------------------
# cluster fan-out
# --------------------------------------------------------------------------


def handle_event(payload: dict) -> dict:
    """Receiver side of the fan-out: any server's
    ``POST /cache/invalidate`` lands here and funnels into the local
    registry. The reason is prefixed ``remote:`` so cache.status can
    tell local mutations from cluster broadcasts."""
    vid = int(payload.get("volumeId", 0) or 0)
    if vid <= 0:
        raise ValueError("volumeId required")
    reason = str(payload.get("reason", "") or "unknown")
    volume_invalidated(vid, reason=f"remote:{reason}")
    return {"ok": True, "volumeId": vid}


class ClusterInvalidationHub:
    """Master-side publisher: subscribed gateways + ad-hoc extra
    targets (the topology's volume servers) each get one best-effort
    ``POST /cache/invalidate`` per committed mutating job task.

    Reuses the notification plane's :class:`HttpWebhookQueue` as the
    transport — single attempt, breaker-guarded, with sent/dropped
    counters per destination.
    """

    def __init__(self, timeout: float = 2.0):
        self.timeout = timeout
        self._lock = threading.Lock()
        self._subs: dict[str, object] = {}      # url -> HttpWebhookQueue
        self.published = 0

    def _queue(self, url: str):
        # Lazy import: cache/ must stay importable without notification/.
        from ..notification.queues import HttpWebhookQueue
        with self._lock:
            q = self._subs.get(url)
            if q is None:
                q = HttpWebhookQueue(f"http://{url}/cache/invalidate",
                                     timeout=self.timeout)
                self._subs[url] = q
            return q

    def subscribe(self, url: str) -> None:
        self._queue(url)

    def forget(self, url: str) -> None:
        with self._lock:
            self._subs.pop(url, None)

    def publish(self, volume_id: int, reason: str = "", origin: str = "",
                extra: "list[str] | tuple[str, ...]" = ()) -> int:
        """Fan one invalidation out to every subscriber plus ``extra``
        targets, skipping ``origin`` (the mutating node already
        invalidated locally). Returns destinations attempted."""
        event = {"type": "cache.invalidate", "volumeId": int(volume_id),
                 "reason": reason, "origin": origin}
        with self._lock:
            urls = set(self._subs)
        urls.update(extra)
        urls.discard(origin)
        n = 0
        for url in sorted(urls):
            self._queue(url).send(event)
            n += 1
        if n:
            # publish() is called from every mutating request thread;
            # the counter increment needs the same lock the subscriber
            # map uses or concurrent publishes lose ticks
            with self._lock:
                self.published += 1
            glog.v(1, "cache: invalidation of volume %d (%s) fanned "
                   "out to %d host(s)", volume_id, reason, n)
        return n

    def to_map(self) -> dict:
        with self._lock:
            return {url: {"sent": getattr(q, "sent", 0),
                          "dropped": getattr(q, "dropped", 0)}
                    for url, q in self._subs.items()}


def start_subscriber(master_url: str, self_url: str,
                     stop_event: threading.Event,
                     interval: float = 30.0) -> threading.Thread:
    """Gateway-side registration loop: (re-)subscribe this host's
    ``/cache/invalidate`` endpoint with the master every ``interval``
    seconds, so the subscription survives master restarts and leader
    changes (the POST leader-proxies)."""
    def _loop() -> None:
        from ..util import retry
        while True:
            try:
                retry.http_request(
                    f"http://{master_url}/cluster/cache_subscribe"
                    f"?url={self_url}",
                    method="POST", point="cache.subscribe", timeout=5,
                    use_breaker=False,
                    retry_policy=retry.RetryPolicy(max_attempts=1))
            except Exception as e:  # noqa: BLE001 — retry next round
                glog.v(1, "cache: subscribe with %s failed: %s",
                       master_url, e)
            if stop_event.wait(interval):
                return

    t = threading.Thread(target=_loop, daemon=True,
                         name=f"cache-subscriber-{self_url}")
    t.start()
    return t
