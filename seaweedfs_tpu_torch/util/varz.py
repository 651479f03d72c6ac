"""``/debug/vars`` payload — the Go ``expvar`` analog.

Every HTTP server (master, volume, filer, S3, WebDAV) serves one JSON
document with process vitals (pid, uptime, RSS, CPU, threads, fds, GC)
plus the tracing slow-request ring, so "what is this process doing" is
one curl away without a metrics stack. Callers pass ``extra`` for
role-specific sections (the volume server attaches its telemetry
collector, chunk cache and usage collector, the master its trace
collector and SLO state).

The port's copy of ``seaweedfs_tpu/util/varz.py``. Its lazy section
lookups name the port's modules (``seaweedfs_tpu_torch.*``): in a
process that holds both packages, the port's page never reports the JAX
package's pipeline.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from typing import Optional

from . import profiler, tracing
from .stats import Metrics

try:
    import resource
except ImportError:  # non-unix: the /proc vitals still apply
    resource = None  # type: ignore[assignment]

_START_TIME = time.time()


def _pipeline_payload() -> dict:
    # lazy: the EC pipeline (and its torch import chain) must not load
    # just because a gateway served /debug/vars
    mod = sys.modules.get("seaweedfs_tpu_torch.pipeline.pipe")
    if mod is None:
        return {}
    return mod.debug_payload()


def _flight_payload() -> dict:
    # lazy like the pipeline payload: only meaningful once the flight
    # recorder module is loaded (any pipeline import pulls it in)
    mod = sys.modules.get("seaweedfs_tpu_torch.pipeline.flight")
    if mod is None:
        return {}
    return mod.debug_payload()


def _mesh_payload() -> dict:
    # lazy like the pipeline payload: parallel/mesh pulls in torch
    mod = sys.modules.get("seaweedfs_tpu_torch.parallel.mesh")
    if mod is None:
        return {}
    return mod.debug_payload()


def _ingress_payload() -> dict:
    # lazy for the same reason — and httpserver imports stats only,
    # so this stays cheap even when no IngressHTTPServer exists
    mod = sys.modules.get("seaweedfs_tpu_torch.util.httpserver")
    if mod is None:
        return {}
    return mod.debug_payload()


def _rss_bytes() -> Optional[int]:
    # /proc is authoritative on linux; ru_maxrss is a peak, not current
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def _open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def payload(component: str, metrics: Optional[Metrics] = None,
            extra: Optional[dict] = None) -> dict:
    # here, not top: retry imports varz users
    from . import durability, faults, retry
    out = {
        "component": component,
        "pid": os.getpid(),
        "start_time": _START_TIME,
        "uptime_seconds": round(time.time() - _START_TIME, 3),
        "python_version": sys.version.split()[0],
        "argv": sys.argv,
        "threads": threading.active_count(),
        "gc_counts": gc.get_count(),
        "slow_requests": tracing.slow_requests(),
        "trace_push": tracing.push_stats(),
        "breakers": retry.breakers_payload(),
        "faults": faults.debug_payload(),
        "durability": durability.debug_payload(),
        "profiler": profiler.debug_payload(),
        "pipeline": _pipeline_payload(),
        "flight": _flight_payload(),
        "mesh": _mesh_payload(),
        "ingress": _ingress_payload(),
        "http_pool": retry.pool().payload(),
    }
    rss = _rss_bytes()
    if rss is not None:
        out["rss_bytes"] = rss
    fds = _open_fds()
    if fds is not None:
        out["open_fds"] = fds
    if resource is not None:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out["user_cpu_seconds"] = ru.ru_utime
        out["system_cpu_seconds"] = ru.ru_stime
    if metrics is not None:
        with metrics._lock:
            out["metric_series"] = len(metrics._metrics)
        out["metrics_namespace"] = metrics.namespace
    if extra:
        out.update(extra)
    return out
