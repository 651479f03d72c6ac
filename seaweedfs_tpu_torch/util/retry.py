"""Degraded-read accounting: the port's part of ``seaweedfs_tpu/util/retry.py``.

Only :func:`record_degraded` is ported: the read path counts each hop
down the degradation ladder (``"ec_reconstruct"``: an interval rebuilt
from survivors because its shard could not serve it). The counts live in
a dict under a lock; :func:`degraded_counts` reads them. In the JAX
package the same call
feeds the ``degraded_reads_total`` metric and tags the active tracing
span; the metrics registry and the spans are not ported yet (ROADMAP
Queue 1 item 6).
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_degraded: dict[str, int] = {}


def record_degraded(stage: str) -> None:
    """Count one hop of the read-degradation ladder at ``stage``."""
    with _lock:
        _degraded[stage] = _degraded.get(stage, 0) + 1


def degraded_counts() -> dict[str, int]:
    """A snapshot of the counts by stage."""
    with _lock:
        return dict(_degraded)
