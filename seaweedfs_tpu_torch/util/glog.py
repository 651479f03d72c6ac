"""glog-style leveled logging.

Mirrors the reference's weed/glog wrapper (SURVEY.md §5
"Tracing/profiling"): ``glog.v(n, ...)`` messages print only when the
process verbosity is >= n (reference flag ``-v=N``); info/warning/error
always print, each stamped with severity, time, and caller. Implemented
on the stdlib logging module so tests can capture records normally.

The port's copy of ``seaweedfs_tpu/util/glog.py``, logging under the
``seaweedfs_tpu_torch.glog`` logger (not the package's own logger, whose
children the port's modules log to: this one does not propagate). A line
logged inside an active span of the port's tracing ends with
`` trace=<id> span=<id>``.
"""

from __future__ import annotations

import logging
import os
import sys

_logger = logging.getLogger("seaweedfs_tpu_torch.glog")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(
        "%(levelname).1s%(asctime)s %(name)s] %(message)s",
        datefmt="%m%d %H:%M:%S"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False

#: Process verbosity, like the reference's -v flag; env override for tests.
VERBOSITY = int(os.environ.get("WEED_V", "0"))


def set_verbosity(n: int) -> None:
    global VERBOSITY
    VERBOSITY = n


def _trace_suffix() -> str:
    """`` trace=<id> span=<id>`` when this thread is inside an active
    span, else "" — the glue that lets ``trace.top`` output grep
    straight into server logs. Looked up through sys.modules because
    tracing imports glog (never the other way around); until tracing is
    loaded there is no span to correlate anyway. The name is the port's
    module: a span the JAX package opened in the same process is not
    this package's."""
    tracing = sys.modules.get("seaweedfs_tpu_torch.util.tracing")
    if tracing is None or not tracing.active():
        return ""
    sp = tracing.current_span()
    if sp is None:
        return ""
    return f" trace={sp.trace_id} span={sp.span_id}"


def v(level: int, fmt: str, *args) -> None:
    if VERBOSITY >= level:
        _logger.info(fmt + _trace_suffix(), *args)


def info(fmt: str, *args) -> None:
    _logger.info(fmt + _trace_suffix(), *args)


def warning(fmt: str, *args) -> None:
    _logger.warning(fmt + _trace_suffix(), *args)


def error(fmt: str, *args) -> None:
    _logger.error(fmt + _trace_suffix(), *args)
