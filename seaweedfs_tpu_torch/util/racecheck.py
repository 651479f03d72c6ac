"""Eraser-style lockset race detector for the port's shared objects.

The port of ``seaweedfs_tpu/util/racecheck.py``. Under
``SEAWEEDFS_TORCH_RACECHECK=1|record|raise`` selected long-lived shared
objects (the pipeline's buffer pools and stage stats, the writeback
pool, the metrics registry, the chunk cache, the ingress server)
instrument themselves at construction: their class is swapped for a
subclass whose ``__setattr__`` reports every attribute write to a
per-(object, attr) state machine before storing the value. Held locks
come from the port's lockcheck ledger (``lockcheck.held_locks()``), so
arming this checker arms the port's lockcheck: only locks created under
its factories are visible.

The state machine is classic Eraser (Savage et al. 1997), per
(object, attribute):

  virgin ──first write (thread T)──> exclusive(T)
  exclusive(T) ──write by T──> exclusive(T)           (no cost)
  exclusive(T) ──read  by U──> shared, C := held(U)
  exclusive(T) ──write by U──> shared-modified, C := held(U)
  shared       ──write──>      shared-modified, C := C ∩ held
  shared/shared-modified ──access──> C := C ∩ held

C empty in shared-modified = no lock consistently protected the
attribute: a race report carrying both stacks. ``raise`` mode raises
``RaceViolation`` at the offending write; record mode logs through glog
and keeps going, and ``races()`` returns everything observed.
Happens-before edges a lockset checker cannot see (thread join, pool
handoff) are declared with ``quiesce(obj)``.

Repaired against the JAX package: its tracker purges a dead object's
states from a ``weakref.finalize`` callback that takes the tracker's
plain lock ``_mu``, while ``_transition`` allocates under that same
lock; a garbage collection there runs the callback on the thread that
holds ``_mu``, and the thread deadlocks on itself. Here the callback
only queues the dead object's id (``deque.append`` takes no lock); the
queue is drained outside ``_mu`` at the next ``register`` or
``_transition``, before any new state is recorded, so a new object at
a reused address never inherits a dead one's history.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import weakref
from collections import deque
from dataclasses import dataclass, field

from . import lockcheck

__all__ = ["install_from_env", "install", "uninstall", "enabled",
           "register", "note_read", "quiesce", "races", "reset",
           "RaceViolation", "RaceReport", "TRACKER"]

#: Attribute-name tokens that mark synchronization primitives; writing
#: a Lock/Event into a slot is how objects BECOME safe, not a race.
_SYNC_TOKENS = ("lock", "cond", "event", "sem")

_VIRGIN = "virgin"
_EXCLUSIVE = "exclusive"
_SHARED = "shared"
_SHARED_MOD = "shared-modified"


class RaceViolation(AssertionError):
    """An attribute's candidate lockset became empty."""


_sync_memo: dict[str, bool] = {}


def _sync_attr(name: str) -> bool:
    # memoized: runs on every instrumented attribute write, and the
    # attr-name population is the registered classes' fields (bounded)
    v = _sync_memo.get(name)
    if v is None:
        low = name.lower()
        # "_Class__attr" is a name-mangled private: those writes come
        # from class-internal protocols we do not control — e.g.
        # socketserver's _BaseServer__shutdown_request handshake,
        # which serve_forever and shutdown() flip from different
        # threads by design (GIL-atomic flag + Event). This repo's own
        # classes use single-underscore attrs, so nothing real hides
        # behind the exemption.
        v = name.startswith("__") or \
            (name.startswith("_") and "__" in name[1:]) or \
            any(t in low for t in _SYNC_TOKENS)
        _sync_memo[name] = v
    return v


def _capture_stack(limit: int = 6) -> tuple:
    """Raw (file, line, func) frames of the caller, cheapest possible:
    ``traceback.format_stack`` costs tens of microseconds and EVERY
    off-fast-path access must capture its stack (a lock-protected
    cross-thread counter stays off the fast path forever, and an armed
    encode would spend its time formatting). Formatting happens in
    :func:`_render_stack`, only when a report actually fires."""
    try:
        f = sys._getframe(2)
    except ValueError:
        return ()
    # skip the tracker's own frames (__setattr__/note_read -> on_* ->
    # _transition) whichever entry path was taken
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    out = []
    while f is not None and len(out) < limit:
        out.append((f.f_code.co_filename, f.f_lineno,
                    f.f_code.co_name))
        f = f.f_back
    return tuple(out)


def _render_stack(frames: tuple) -> str:
    return "".join(
        f'  File "{fn}", line {ln}, in {name}\n'
        for fn, ln, name in reversed(frames))


@dataclass
class _AttrState:
    state: str = _VIRGIN
    owner: int = 0                      # thread ident while exclusive
    lockset: frozenset = frozenset()    # candidate lockset C
    stack: tuple = ()                   # raw frames of last access
    thread: str = ""
    reported: bool = False


@dataclass
class RaceReport:
    obj: str
    attr: str
    thread: str
    stack: str
    prior_thread: str
    prior_stack: str

    def describe(self) -> str:
        return (f"unsynchronized access: attribute '{self.attr}' of "
                f"{self.obj} has an empty candidate lockset.\n"
                f"--- this write ({self.thread}):\n{self.stack}"
                f"--- earlier access ({self.prior_thread}):\n"
                f"{self.prior_stack}")


@dataclass
class _RaceTracker:
    states: dict = field(default_factory=dict)
    names: dict = field(default_factory=dict)
    reports: list = field(default_factory=list)
    raise_on_race: bool = False

    def __post_init__(self):
        # raw C lock: instrumented writes happen on every thread and
        # the tracker must never recurse through a TrackedLock
        self._mu = _thread.allocate_lock()
        #: ids of registered objects that died, purged outside _mu
        self._dead: deque = deque()

    def on_dead(self, oid: int) -> None:
        """The finalizer of a registered object: queue, never lock (it
        can run inside a collection on a thread that holds ``_mu``)."""
        self._dead.append(oid)

    def drain_dead(self) -> None:
        while self._dead:
            try:
                oid = self._dead.popleft()
            except IndexError:
                return
            self.purge(oid)

    # -- state machine -----------------------------------------------

    def _describe(self, obj) -> str:
        return self.names.get(id(obj)) or \
            f"{type(obj).__module__}.{type(obj).__name__}"

    def _transition(self, obj, attr: str, write: bool):
        if self._dead:
            self.drain_dead()
        key = (id(obj), attr)
        tid = threading.get_ident()
        # Lock-free fast paths for the two steady states that dominate
        # armed hot loops (GIL-atomic dict/attr reads; a stale read at
        # worst falls through to the locked slow path). Without these,
        # a lock-protected cross-thread counter — permanently
        # shared-modified — would pay _mu contention plus a stack
        # capture on EVERY write, and an armed encode would crawl.
        st = self.states.get(key)
        if st is not None:
            state = st.state
            if state == _EXCLUSIVE:
                if tid == st.owner:
                    return None         # same owner: nothing changes
            elif state == _SHARED_MOD or (state == _SHARED
                                          and not write):
                if st.reported:
                    return None         # one report per attr
                cl = st.lockset
                if cl:
                    # this thread's own held list, read in place (only
                    # the owning thread ever mutates it); plain loops,
                    # no generator allocation, C is typically one lock
                    held = lockcheck.TRACKER._held()
                    for lid in cl:
                        for h in held:
                            if id(h) == lid:
                                break
                        else:
                            break       # a C lock is not held: slow path
                    else:
                        # C ∩ held == C: no state, lockset, or report
                        # change. The stack snapshot goes stale — a
                        # later report shows the access that last
                        # CHANGED the state, which is the useful one.
                        return None
        hit = None
        with self._mu:
            st = self.states.get(key)
            if st is not None and st.state == _EXCLUSIVE \
                    and tid == st.owner:
                return None
            # off the fast path only: snapshot this thread's locks
            held = frozenset(id(l) for l in lockcheck.held_locks())
            if st is None:
                self.states[key] = _AttrState(
                    _EXCLUSIVE, tid, held, _capture_stack(),
                    threading.current_thread().name)
                return None
            if st.state == _EXCLUSIVE:
                st.state = _SHARED_MOD if write else _SHARED
                st.lockset = held
            else:
                if write:
                    st.state = _SHARED_MOD
                st.lockset = st.lockset & held
            if st.state == _SHARED_MOD and not st.lockset \
                    and not st.reported:
                st.reported = True
                hit = RaceReport(
                    obj=self._describe(obj), attr=attr,
                    thread=threading.current_thread().name,
                    stack=_render_stack(_capture_stack()),
                    prior_thread=st.thread,
                    prior_stack=_render_stack(st.stack))
                self.reports.append(hit)
            st.stack = _capture_stack()
            st.thread = threading.current_thread().name
        if hit is not None:
            if self.raise_on_race:
                raise RaceViolation(hit.describe())
            from . import glog
            glog.warning("racecheck: %s", hit.describe())
        return hit

    def on_write(self, obj, attr: str):
        if _sync_attr(attr):
            return None
        return self._transition(obj, attr, write=True)

    def on_read(self, obj, attr: str):
        if _sync_attr(attr):
            return None
        return self._transition(obj, attr, write=False)

    def purge(self, oid: int) -> None:
        with self._mu:
            for key in [k for k in self.states if k[0] == oid]:
                del self.states[key]
            self.names.pop(oid, None)


TRACKER = _RaceTracker()

#: original class -> instrumented subclass
_instrumented: dict[type, type] = {}

_installed = False


def _instrument_class(cls: type) -> type:
    icls = _instrumented.get(cls)
    if icls is None:
        def __setattr__(self, name, value, _base=cls):
            # store first: a detected race HAS happened either way,
            # and record mode must not alter program behavior
            _base.__setattr__(self, name, value)
            TRACKER.on_write(self, name)

        icls = type(cls.__name__, (cls,), {
            "__setattr__": __setattr__,
            "_racecheck_base": cls,
        })
        icls.__module__ = cls.__module__
        icls.__qualname__ = cls.__qualname__
        _instrumented[cls] = icls
    return icls


def enabled() -> bool:
    return _installed


def install(raise_on_race: bool = False) -> None:
    """Arm the checker (idempotent). Implies lockcheck, which supplies
    the per-thread held-locks ledger."""
    global _installed
    TRACKER.raise_on_race = raise_on_race
    if not lockcheck.enabled():
        lockcheck.install()
    _installed = True


def uninstall() -> None:
    """Stop registering new objects. Already-instrumented objects keep
    their subclass and keep reporting (mirrors lockcheck)."""
    global _installed
    _installed = False


def install_from_env() -> bool:
    """Honor SEAWEEDFS_TORCH_RACECHECK: "1"/"record" records, "raise"
    also raises RaceViolation at the offending write."""
    mode = os.environ.get("SEAWEEDFS_TORCH_RACECHECK", "").strip().lower()
    if mode in ("1", "true", "record", "on"):
        install(raise_on_race=False)
    elif mode == "raise":
        install(raise_on_race=True)
    return _installed


def register(obj, name: str | None = None) -> bool:
    """Instrument one object's attribute writes. No-op (False) when
    the checker is disarmed — THE fast path: construction sites call
    this unconditionally and pay one module-global flag test.

    Objects whose layout forbids ``__class__`` assignment (slots-only
    classes, C extensions) are skipped, not errors."""
    if not _installed:
        return False
    cls = type(obj)
    if getattr(cls, "_racecheck_base", None) is not None:
        return True                     # already instrumented
    try:
        obj.__class__ = _instrument_class(cls)
    except TypeError:
        return False
    TRACKER.drain_dead()
    TRACKER.names[id(obj)] = name or \
        f"{cls.__module__}.{cls.__qualname__}"
    # not weakref-able: per-attr state outlives the object (bounded
    # by the handful of registered singletons, so acceptable)
    try:
        weakref.finalize(obj, TRACKER.on_dead, id(obj))
    except TypeError:  # seaweedlint: disable=SW301 — tracking stays correct, only cleanup is lost
        pass
    return True


def note_read(obj, attr: str):
    """Record a read-side access (``__setattr__`` cannot see reads).
    Drives exclusive -> shared and refines the candidate lockset."""
    if not _installed and not TRACKER.states:
        return None
    return TRACKER.on_read(obj, attr)


def quiesce(obj) -> None:
    """Declare a happens-before point for every attribute of ``obj``
    (thread join, pool handoff): states return to virgin so the next
    writer starts a fresh exclusive epoch instead of racing history."""
    TRACKER.purge(id(obj))
    # keep the display name: the object stays registered
    cls = type(obj)
    base = getattr(cls, "_racecheck_base", None)
    if base is not None:
        TRACKER.names[id(obj)] = f"{base.__module__}.{base.__qualname__}"


def races() -> list[RaceReport]:
    return list(TRACKER.reports)


def reset() -> None:
    """Clear all state machines and reports (tests)."""
    TRACKER._dead.clear()
    with TRACKER._mu:
        TRACKER.states.clear()
        TRACKER.reports.clear()
