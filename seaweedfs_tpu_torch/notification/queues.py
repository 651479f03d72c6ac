"""Message queues + the filer->queue bridge (weed/notification).

The port of ``seaweedfs_tpu/notification/queues.py``, whole, over the
port's ``util/retry``.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Optional

from ..util import glog, retry


def event_to_dict(ev) -> dict:
    """Serialize a filer MetaEvent the way the reference publishes
    EventNotification messages (old/new entry, chunks included)."""

    def entry(e):
        if e is None:
            return None
        return {
            "path": e.path,
            "isDir": e.attr.is_dir,
            "size": e.size(),
            "mtime": e.attr.mtime,
            "chunks": [{"fileId": c.file_id, "offset": c.offset,
                        "size": c.size} for c in e.chunks],
        }

    return {"tsNs": ev.ts_ns, "directory": ev.directory,
            "oldEntry": entry(ev.old_entry),
            "newEntry": entry(ev.new_entry),
            # origin chain (filer.sync loop prevention): lets external
            # consumers distinguish local writes from replicated ones
            "signatures": list(ev.signatures)}


class MessageQueue:
    """One notification sink (notification.MessageQueue interface)."""

    def send(self, event: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LogFileQueue(MessageQueue):
    """Append-only JSON-lines event log."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")

    def send(self, event: dict) -> None:
        with self._lock:
            self._f.write(json.dumps(event) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class HttpWebhookQueue(MessageQueue):
    """POST each event as JSON to a webhook URL. Delivery is
    best-effort: a dead endpoint drops events (counted), it never
    stalls the bridge."""

    def __init__(self, url: str, timeout: float = 2.0):
        self.url = url
        self.timeout = timeout
        self.sent = 0
        self.dropped = 0

    def send(self, event: dict) -> None:
        body = json.dumps(event).encode()
        try:
            # Single attempt (best-effort delivery must not stall the
            # bridge) but breaker-guarded: a dead endpoint fails fast
            # instead of eating a connect timeout per event.
            retry.http_request(
                self.url, data=body, method="POST",
                headers={"Content-Type": "application/json"},
                point="notify.webhook", timeout=self.timeout,
                retry_policy=retry.RetryPolicy(max_attempts=1))
            self.sent += 1
        except Exception as e:  # noqa: BLE001 — drop, don't stall
            self.dropped += 1
            if self.dropped in (1, 10, 100) or self.dropped % 1000 == 0:
                glog.warning("notification webhook %s failing "
                             "(%d dropped): %s", self.url,
                             self.dropped, e)


class FilerNotifier:
    """Bridges one Filer's meta-log onto a MessageQueue on a dedicated
    thread (filer_notify.go's notifyMetaListeners role for external
    queues)."""

    def __init__(self, filer, queue: MessageQueue,
                 path_prefix: str = "/"):
        self.filer = filer
        self.queue = queue
        self.path_prefix = "/" + path_prefix.strip("/")
        self.published = 0
        #: Times the bridge lagged and had to re-attach (usually fully
        #: recovered via meta-log replay).
        self.resubscribed = 0
        #: Events UNRECOVERABLY lost: the lag outran the meta-log
        #: replay window too.
        self.lost = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FilerNotifier":
        registered = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(registered,), daemon=True,
            name="filer-notifier")
        self._thread.start()
        # Block until the subscriber is attached so no mutation between
        # start() and the thread's first iteration can slip past.
        if not registered.wait(timeout=5):
            glog.warning("filer notifier did not attach within 5s; "
                         "early events may be missed")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.queue.close()

    def _run(self, registered: Optional[threading.Event] = None) -> None:
        want = "/" if self.path_prefix == "/" else self.path_prefix + "/"
        last_ts = 0
        since = 0
        while not self._stop.is_set():
            try:
                for ev in self.filer.subscribe(self._stop,
                                               since_ns=since,
                                               registered=registered):
                    last_ts = ev.ts_ns
                    if not (ev.directory + "/").startswith(want):
                        continue
                    try:
                        self.queue.send(event_to_dict(ev))
                        # all three counters mutate only on the
                        # single filer-notifier thread
                        # seaweedlint: disable=SW802 — single thread
                        self.published += 1
                    except Exception as e:  # noqa: BLE001 — keep going
                        glog.warning("notification publish failed: %s",
                                     e)
                return  # stop was set
            except Exception as e:  # noqa: BLE001 — lagged: re-attach
                from ..filer.filer import FilerResyncRequired

                registered = None
                # seaweedlint: disable=SW802 — single notifier thread
                self.resubscribed += 1
                window_gone = (isinstance(e, FilerResyncRequired)
                               and "window expired" in str(e))
                if window_gone or not last_ts:
                    # beyond the replay window: genuinely lost ground
                    # seaweedlint: disable=SW802 — single thread
                    self.lost += 1
                    since = 0
                    glog.warning("notification stream lost events "
                                 "(%s); re-subscribing live", e)
                else:
                    # recover the dropped span from the meta-log replay
                    since = max(1, last_ts - 1)
                    glog.v(1, "notification stream lagged (%s); "
                           "replaying from %d", e, since)
                self._stop.wait(0.2)
