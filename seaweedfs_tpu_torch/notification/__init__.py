"""Metadata event notification (weed/notification analog).

The filer's meta-log already feeds in-cluster subscribers
(SubscribeMetadata / replication); this package is the EXTERNAL fan-out
seam the reference wires to kafka/gcp-pubsub/etc. — a ``MessageQueue``
interface plus the implementations this environment can actually run:
an append-only JSON-lines log file and an HTTP webhook. A
``FilerNotifier`` bridges a live Filer's subscribe stream onto a queue
on its own thread, so the filer mutation path never blocks on a slow
consumer.

The port of ``seaweedfs_tpu/notification/__init__.py``, whole.
"""

from .queues import FilerNotifier, HttpWebhookQueue, LogFileQueue, \
    MessageQueue

__all__ = ["FilerNotifier", "HttpWebhookQueue", "LogFileQueue",
           "MessageQueue"]
