"""Test-session hygiene for the port's test files that build JAX objects.

The JAX test suite runs with its race checker armed (``tests/conftest.py``
sets ``SEAWEED_RACECHECK=1``). ``racecheck.register`` hangs a
``weakref.finalize(obj, TRACKER.purge, id)`` on every JAX ``Metrics``,
``IngressHTTPServer``, ``ChunkCache``, pipeline pool and ``PipeStats``,
and several of these are cyclic by construction (an ingress server, its
parker and its admission controller point at each other), so only the
garbage collector frees them. ``_RaceTracker._transition`` allocates
while it holds the plain lock ``TRACKER._mu``; when that allocation
starts a collection that finalizes such an object, ``purge`` takes
``_mu`` again and the thread deadlocks on itself (ROADMAP Queue 3, JAX
``util/racecheck.py``). Which collection lands in that window depends on
the collector's counters, which every earlier file in a worker shifts:
the port's files, which build many such objects, made
``tests/test_pipe.py`` (whose own exception tests leave a ``PipeStats``
in a cycle) hang in some worker orders.

Importing this module, which every ``tests/test_torch_*.py`` that builds
JAX objects does, makes ``TRACKER._mu`` reentrant, so a purge that a
collection runs inside ``_transition`` completes. What the checker
records and reports is unchanged: such a purge drops only the state of
an object that is already unreachable, never that of the object under
transition. The JAX package's files stay as they are.

Each of those files also imports :func:`collect_jax_garbage`, which
collects after the file's last test, so no JAX object a port file built
is finalized during another file.

    from torch_teardown import collect_jax_garbage  # noqa: F401
"""

import _thread
import gc

import pytest
from seaweedfs_tpu.util import racecheck


def _reentrant_tracker_lock() -> None:
    tracker = racecheck.TRACKER
    if isinstance(tracker._mu, _thread.RLock):
        return
    old = tracker._mu
    with old:
        tracker._mu = _thread.RLock()


_reentrant_tracker_lock()


@pytest.fixture(scope="module", autouse=True)
def collect_jax_garbage():
    yield
    gc.collect()
