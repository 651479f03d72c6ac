"""Deterministic, seedable fault-injection plane.

The port's copy of ``seaweedfs_tpu/util/faults.py``, so that a test arms
a fault in each package's own registry and damages a shard read alike.
Named *fault points* sit on I/O paths: ``faults.check("ec.shard_read")``
runs before the operation and may raise, sleep, or drop the call;
``faults.mangle("ec.shard_read", buf)`` runs on the bytes an operation
returned and may truncate or corrupt them. With no faults armed (the
default) both are one module-flag test.

A fault *spec* is a compact string::

    action[@probability][:param][#count]

    error            raise FaultError on every call
    drop             raise FaultDrop (simulated dropped connection)
    delay:0.2        sleep 0.2s, then proceed
    delay:0.2@0.5    ... on a seeded coin-flip half the time
    truncate:0.5     mangle() returns the first half of the bytes
    corrupt          mangle() flips bytes at seeded positions
    crash            power-cut the process at the point (os._exit), or
                     call the handler set by set_crash_handler
    error@0.3#5      30% of calls, at most 5 injections total

Coin flips come from a per-spec ``random.Random`` seeded from the
global seed and the point name, so a run replays identically: same
seed, same injection schedule. Specs arm at runtime through
:func:`inject` or the ``SEAWEED_FAULTS`` environment variable
(``point=spec;point=spec``), or a ``[faults]`` TOML block
(:func:`configure_from`, which the volume server's ``-config`` applies).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

#: Fault points on the port's paths, named as in the JAX catalog. Arming
#: an unknown name still works (points are matched by string).
CATALOG = (
    "volume.read",     # client GET of a needle from a volume server
    "volume.write",    # client POST of a needle
    "volume.delete",   # client DELETE of a needle
    "replica.push",    # volume server fanning a write to a replica
    "ec.shard_read",   # one shard-interval read (pipeline/read.py)
    # Crashpoints: named commit-path instants where a `crash` spec kills
    # the process (or calls the handler set by set_crash_handler).
    "crash.append.dat",      # needle appended to .dat, .idx not yet
    "crash.append.idx",      # .idx journaled, ack not yet returned
    "crash.vacuum.compact",  # mid-compact: .cpd/.cpx partially built
    "crash.vacuum.precommit",  # compact done, neither rename applied
    "crash.vacuum.midcommit",  # .cpd renamed over .dat, .cpx not yet
    "crash.ec.writeback",      # EC shard slice positioned-write issued
)


class FaultError(OSError):
    """An injected failure. Subclasses OSError so the retry layer's
    transient-error classification treats it like a real I/O fault."""


class FaultDrop(FaultError):
    """An injected dropped call (connection reset mid-flight)."""


class FaultSpecError(ValueError):
    pass


class FaultSpec:
    """One armed fault: parsed action + seeded coin-flip state."""

    __slots__ = ("point", "action", "probability", "param", "remaining",
                 "spec", "rng", "hits")

    ACTIONS = ("error", "drop", "delay", "truncate", "corrupt", "crash")

    def __init__(self, point: str, spec: str, seed: Optional[int] = None):
        self.point = point
        self.spec = spec
        body = spec.strip()
        self.remaining = -1  # -1 = unbounded
        if "#" in body:
            body, _, cnt = body.rpartition("#")
            try:
                self.remaining = int(cnt)
            except ValueError:
                raise FaultSpecError(
                    f"bad count in fault spec {spec!r}") from None
        self.probability = 1.0
        if "@" in body:
            body, _, prob = body.partition("@")
            try:
                self.probability = float(prob)
            except ValueError:
                raise FaultSpecError(
                    f"bad probability in fault spec {spec!r}") from None
        action, _, param = body.partition(":")
        action = action.strip()
        if action not in self.ACTIONS:
            raise FaultSpecError(
                f"unknown fault action {action!r}; "
                f"have {', '.join(self.ACTIONS)}")
        self.action = action
        if param:
            try:
                self.param = float(param)
            except ValueError:
                raise FaultSpecError(
                    f"bad param in fault spec {spec!r}") from None
        else:
            self.param = {"delay": 0.05, "truncate": 0.5}.get(action, 0.0)
        base = _SEED if seed is None else seed
        # Stable per-point stream: replaying the same seed + spec set
        # reproduces the exact injection schedule.
        self.rng = random.Random(f"{base}:{point}:{spec}")
        self.hits = 0

    def fire(self) -> bool:
        """Seeded coin flip + count budget; True = inject this call."""
        if self.remaining == 0:
            return False
        if self.probability < 1.0 and self.rng.random() >= self.probability:
            return False
        if self.remaining > 0:
            self.remaining -= 1
        self.hits += 1
        return True

    def to_dict(self) -> dict:
        return {"point": self.point, "spec": self.spec,
                "action": self.action, "probability": self.probability,
                "param": self.param, "remaining": self.remaining,
                "hits": self.hits}


_LOCK = threading.Lock()
_SPECS: dict[str, FaultSpec] = {}
#: Installed by a crash-recording harness while it records: a
#: callable(point) expected to raise (SimulatedCrash). When None, a
#: fired `crash` spec hard-exits the process (os._exit) instead.
_CRASH_HANDLER = None
_SEED = 0
_ENABLED = True
#: Hot-path flag: True only when enabled AND at least one spec is
#: armed. check()/mangle() test this one name and return.
_ACTIVE = False


def _recompute_active() -> None:
    global _ACTIVE
    _ACTIVE = _ENABLED and bool(_SPECS)


def configure(enabled: Optional[bool] = None,
              seed: Optional[int] = None) -> None:
    global _ENABLED, _SEED
    with _LOCK:
        if enabled is not None:
            _ENABLED = bool(enabled)
        if seed is not None:
            _SEED = int(seed)
        _recompute_active()


def configure_from(conf: dict) -> None:
    """Apply a loaded TOML dict's ``[faults]`` block: ``enabled``,
    ``seed``, and an ``inject`` string of ``point=spec`` pairs joined
    by ``;`` (same syntax as ``SEAWEED_FAULTS``)."""
    from . import config as config_mod
    configure(enabled=config_mod.lookup(conf, "faults.enabled"),
              seed=config_mod.lookup(conf, "faults.seed"))
    inject_all(config_mod.lookup(conf, "faults.inject", "") or "")


def configure_from_env(environ=os.environ) -> None:
    """Arm faults named in ``SEAWEED_FAULTS`` (and seed from
    ``SEAWEED_FAULTS_SEED``). Servers call this at start so a chaos
    harness can inject into subprocesses it cannot reach by API."""
    seed = environ.get("SEAWEED_FAULTS_SEED")
    if seed:
        configure(seed=int(seed))
    inject_all(environ.get("SEAWEED_FAULTS", ""))


def inject_all(pairs: str) -> None:
    for part in pairs.split(";"):
        part = part.strip()
        if not part:
            continue
        point, eq, spec = part.partition("=")
        if not eq:
            raise FaultSpecError(
                f"bad fault pair {part!r}, want point=spec")
        inject(point.strip(), spec.strip())


def inject(point: str, spec: str, seed: Optional[int] = None) -> FaultSpec:
    """Arm (or replace) the fault at ``point``. Returns the parsed
    spec; raises :class:`FaultSpecError` on a malformed one."""
    fs = FaultSpec(point, spec, seed=seed)
    with _LOCK:
        _SPECS[point] = fs
        _recompute_active()
    return fs


def clear(point: Optional[str] = None) -> None:
    """Disarm one point, or all of them."""
    with _LOCK:
        if point is None:
            _SPECS.clear()
        else:
            _SPECS.pop(point, None)
        _recompute_active()


def specs() -> list[dict]:
    with _LOCK:
        return [fs.to_dict() for fs in _SPECS.values()]


def active() -> bool:
    return _ACTIVE


def set_crash_handler(handler) -> None:
    """Route fired `crash` specs to ``handler(point)`` instead of
    ``os._exit``, for an in-process crash simulation; pass None to
    restore process-exit semantics."""
    global _CRASH_HANDLER
    _CRASH_HANDLER = handler


def debug_payload() -> dict:
    """Whether faults are enabled, the seed, and every armed spec with
    its hit count (what ``fault.list`` prints)."""
    return {"enabled": _ENABLED, "seed": _SEED, "specs": specs()}


def check(point: str) -> None:
    """Control-path fault point: may raise FaultError/FaultDrop or
    sleep. A no-op (one flag test) when nothing is armed."""
    if not _ACTIVE:
        return
    fs = _SPECS.get(point)
    # data actions fire in mangle() only — consuming their coin-flip
    # stream here would halve the armed count/schedule
    if fs is None or fs.action in ("truncate", "corrupt") \
            or not fs.fire():
        return
    if fs.action == "delay":
        time.sleep(fs.param)
    elif fs.action == "drop":
        raise FaultDrop(f"injected drop at {point}")
    elif fs.action == "crash":
        handler = _CRASH_HANDLER
        if handler is not None:
            handler(point)  # in-process simulation
        # Real crash semantics: no atexit, no finally blocks, no
        # buffered-file flushes — exactly what power loss looks like
        # to everything this process had not fsynced.
        os._exit(86)
    else:
        raise FaultError(f"injected fault at {point}")


def mangle(point: str, data: bytes) -> bytes:
    """Data-path fault point: may truncate or corrupt ``data``. The
    spec's coin flip happens in :func:`check` only when the action is
    control-path; data actions flip here."""
    if not _ACTIVE:
        return data
    fs = _SPECS.get(point)
    if fs is None or fs.action not in ("truncate", "corrupt") \
            or not fs.fire():
        return data
    if fs.action == "truncate":
        return data[:int(len(data) * fs.param)]
    if not data:
        return data
    buf = bytearray(data)
    n = max(1, len(buf) // 1024)
    for _ in range(n):
        i = fs.rng.randrange(len(buf))
        buf[i] ^= 0xFF
    return bytes(buf)


# Arm anything the environment asks for as soon as the module loads, so
# subprocess servers (chaos_smoke.sh, bench helpers) need no API call.
if os.environ.get("SEAWEED_FAULTS"):
    configure_from_env()
