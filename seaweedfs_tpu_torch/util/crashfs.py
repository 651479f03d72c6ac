"""Torn-write crash simulation over the storage fd layer.

The port's copy of ``seaweedfs_tpu/util/crashfs.py``, driving the port's
``util/faults`` through ``set_crash_handler``. ALICE/CrashMonkey-style
crash-state exploration without a VM: while a :class:`CrashRecorder` is
active, every file mutation under its root — ``open``-file
writes/truncates (volume ``.idx``, vacuum ``.cpd/.cpx``), ``os.pwrite``
(the ``DiskFile`` backend's positioned appends),
``os.replace``/``rename``, ``os.unlink`` and every ``os.fsync`` — is
recorded in order. A fired ``crash`` fault spec (util/faults.py) raises
:class:`SimulatedCrash` through the workload and freezes the log.
:meth:`CrashRecorder.replay` then materializes what a power cut at that
instant could legally leave on disk, into a FRESH directory:

- ops made durable by a subsequent ``fsync`` of their file (renames,
  creates and unlinks: of their parent *directory*) are always applied
  — an fsync is a promise;
- unsynced ("volatile") ops survive only up to a seeded random cut,
  modeling how much of the page cache the disk had drained;
- applied volatile *data* writes may additionally be dropped
  independently (out-of-order persistence: a later write can reach the
  platter while an earlier one does not);
- the last applied volatile write may be **torn** at a 512-byte sector
  boundary (a partially persisted sector run).

The original root keeps the fully-applied state (writes really do hit
disk during recording — only the log is extra); the replay directory
is the crash state, which recovery code (volume load's
``check_volume_data_integrity``, vacuum's ``.cpd/.cpx`` state machine,
the store's orphan sweep) must bring back to a volume that serves
every acknowledged write byte-identically and never serves a torn
needle. tests/test_torch_crashfs.py asserts exactly that across
crashpoints and replay seeds.

Single recorder at a time, single-threaded workloads — this is a test
harness, not a production interposition layer.
"""

from __future__ import annotations

import builtins
import os
import random
import shutil
import threading
from pathlib import Path
from typing import Optional

from . import faults

SECTOR = 512


class SimulatedCrash(BaseException):
    """Raised through the workload when a `crash` fault fires under a
    recording. BaseException: crash must not be swallowed by the
    broad ``except Exception`` resilience handlers on the I/O paths —
    nothing in-process survives a power cut."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point


class _Op:
    __slots__ = ("kind", "path", "a", "b", "durable", "vrank")

    def __init__(self, kind: str, path: str, a=None, b=None):
        self.kind = kind    # write | trunc | create | rename | unlink
        self.path = path    # rename: the SOURCE path (a = dest)
        self.a = a
        self.b = b
        self.durable = False
        self.vrank = -1

    def durability_key(self) -> str:
        """The path whose fsync persists this op: the file itself for
        content ops, the parent directory for namespace ops (rename/
        create/unlink live in the directory, not the file)."""
        if self.kind in ("write", "trunc"):
            return self.path
        p = self.a if self.kind == "rename" else self.path
        return os.path.dirname(p)


_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional["CrashRecorder"] = None


class _TrackedFile:
    """Thin proxy over a real writable file object that logs mutating
    calls to the active recorder. Reads, seeks and everything else
    delegate untouched."""

    def __init__(self, f, rec: "CrashRecorder", path: str):
        self._f = f
        self._rec = rec
        self._path = path
        rec._register_fd(f.fileno(), path)

    def write(self, data):
        pos = self._f.tell()
        n = self._f.write(data)
        self._rec._record(_Op("write", self._path, pos,
                              bytes(data[:n if n is not None
                                         else len(data)])))
        return n

    def writelines(self, lines):
        for line in lines:
            self.write(line)

    def truncate(self, size=None):
        if size is None:
            size = self._f.tell()
        out = self._f.truncate(size)
        self._rec._record(_Op("trunc", self._path, int(size)))
        return out

    def close(self):
        try:
            return self._f.close()
        finally:
            self._rec._unregister_fd(self._path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return iter(self._f)

    def __getattr__(self, name):
        return getattr(self._f, name)


class CrashRecorder:
    """Record every mutation under ``root``; replay a legal crash
    prefix into a fresh directory. Use as a context manager around the
    workload; arm a ``crash`` fault spec (``faults.inject("crash.
    append.dat", "crash#1")``) to pick the instant."""

    def __init__(self, root: str | Path):
        self.root = os.path.abspath(str(root))
        self.ops: list[_Op] = []
        self.crashed = False
        self.crash_point: Optional[str] = None
        self._recording = False
        self._lock = threading.Lock()
        self._fd_paths: dict[int, str] = {}
        self._snapshot: Optional[str] = None
        self._saved = {}

    # -- recording plumbing ----------------------------------------------

    def _mine(self, path) -> Optional[str]:
        try:
            p = os.path.abspath(os.fspath(path))
        except TypeError:
            return None
        if p == self.root or p.startswith(self.root + os.sep):
            return p
        return None

    def _record(self, op: _Op) -> None:
        with self._lock:
            if self._recording:
                self.ops.append(op)

    def _register_fd(self, fd: int, path: str) -> None:
        with self._lock:
            if self._recording:
                self._fd_paths[fd] = path

    def _unregister_fd(self, path: str) -> None:
        with self._lock:
            for fd, p in list(self._fd_paths.items()):
                if p == path:
                    del self._fd_paths[fd]

    # -- patched entry points --------------------------------------------

    def _open(self, file, mode="r", *args, **kwargs):
        real = self._saved["open"]
        p = self._mine(file)
        if p is None or not any(c in mode for c in "wax+"):
            return real(file, mode, *args, **kwargs)
        existed = os.path.exists(p)
        f = real(file, mode, *args, **kwargs)
        if "w" in mode or not existed:
            self._record(_Op("create", p))
        return _TrackedFile(f, self, p)

    def _os_open(self, path, flags, *args, **kwargs):
        fd = self._saved["os_open"](path, flags, *args, **kwargs)
        p = self._mine(path)
        if p is not None:
            if (flags & os.O_CREAT) and (flags & os.O_TRUNC):
                self._record(_Op("create", p))
            self._register_fd(fd, p)
        return fd

    def _os_close(self, fd):
        with self._lock:
            self._fd_paths.pop(fd, None)
        return self._saved["os_close"](fd)

    def _os_pwrite(self, fd, data, offset):
        n = self._saved["os_pwrite"](fd, data, offset)
        path = self._fd_paths.get(fd)
        if path is not None:
            self._record(_Op("write", path, int(offset),
                             bytes(data[:n])))
        return n

    def _os_fsync(self, fd):
        out = self._saved["os_fsync"](fd)
        path = self._fd_paths.get(fd)
        if path is not None:
            with self._lock:
                if self._recording:
                    for op in self.ops:
                        if op.durability_key() == path:
                            op.durable = True
        return out

    def _os_ftruncate(self, fd, size):
        out = self._saved["os_ftruncate"](fd, size)
        path = self._fd_paths.get(fd)
        if path is not None:
            self._record(_Op("trunc", path, int(size)))
        return out

    def _os_replace(self, src, dst, **kwargs):
        out = self._saved["os_replace"](src, dst, **kwargs)
        p = self._mine(dst)
        if p is not None:
            self._record(_Op("rename", os.path.abspath(os.fspath(src)),
                             p))
        return out

    def _os_unlink(self, path, **kwargs):
        out = self._saved["os_unlink"](path, **kwargs)
        p = self._mine(path)
        if p is not None:
            self._record(_Op("unlink", p))
        return out

    def _on_crash(self, point: str) -> None:
        with self._lock:
            self.crashed = True
            self.crash_point = point
            self._recording = False
        raise SimulatedCrash(point)

    # -- lifecycle --------------------------------------------------------

    def __enter__(self) -> "CrashRecorder":
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a CrashRecorder is already active")
            _ACTIVE = self
        self._snapshot = self.root + ".crashfs-snapshot"
        shutil.rmtree(self._snapshot, ignore_errors=True)
        shutil.copytree(self.root, self._snapshot)
        self._saved = {
            "open": builtins.open, "os_open": os.open,
            "os_close": os.close, "os_pwrite": os.pwrite,
            "os_fsync": os.fsync, "os_ftruncate": os.ftruncate,
            "os_replace": os.replace, "os_rename": os.rename,
            "os_unlink": os.unlink,
        }
        builtins.open = self._open
        os.open = self._os_open
        os.close = self._os_close
        os.pwrite = self._os_pwrite
        os.fsync = self._os_fsync
        os.ftruncate = self._os_ftruncate
        os.replace = self._os_replace
        os.rename = self._os_replace
        os.unlink = self._os_unlink
        faults.set_crash_handler(self._on_crash)
        self._recording = True
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with self._lock:
            self._recording = False
        faults.set_crash_handler(None)
        builtins.open = self._saved["open"]
        os.open = self._saved["os_open"]
        os.close = self._saved["os_close"]
        os.pwrite = self._saved["os_pwrite"]
        os.fsync = self._saved["os_fsync"]
        os.ftruncate = self._saved["os_ftruncate"]
        os.replace = self._saved["os_replace"]
        os.rename = self._saved["os_rename"]
        os.unlink = self._saved["os_unlink"]
        with _ACTIVE_LOCK:
            _ACTIVE = None

    # -- replay -----------------------------------------------------------

    def replay(self, dest: str | Path, seed: int = 0,
               tear_probability: float = 0.5,
               drop_probability: float = 0.25) -> Path:
        """Materialize one legal post-crash state into ``dest`` (wiped
        first). Deterministic per ``seed``; different seeds explore
        different legal states for the same recorded run."""
        if self._snapshot is None:
            raise RuntimeError("replay() before recording started")
        rng = random.Random(seed)
        dest = Path(os.path.abspath(str(dest)))
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(self._snapshot, dest)

        volatile = [op for op in self.ops if not op.durable]
        for i, op in enumerate(volatile):
            op.vrank = i
        cut = rng.randint(0, len(volatile))
        tear_last = rng.random() < tear_probability

        def target(p: str) -> str:
            rel = os.path.relpath(p, self.root)
            return str(dest) if rel == "." else str(dest / rel)

        for op in self.ops:
            if not op.durable:
                if op.vrank >= cut:
                    continue
                if (op.kind == "write" and op.vrank < cut - 1
                        and rng.random() < drop_probability):
                    continue  # out-of-order persistence lost this one
            data = op.b
            if (not op.durable and op.kind == "write"
                    and op.vrank == cut - 1 and tear_last):
                keep = rng.randrange(0, len(data) // SECTOR + 1) * SECTOR
                data = data[:keep]
                if not data:
                    continue
            try:
                if op.kind == "write":
                    tp = target(op.path)
                    os.makedirs(os.path.dirname(tp), exist_ok=True)
                    flags = os.O_WRONLY | os.O_CREAT
                    fd = os.open(tp, flags)
                    try:
                        os.pwrite(fd, data, op.a)
                    finally:
                        os.close(fd)
                elif op.kind == "trunc":
                    with open(target(op.path), "r+b") as f:
                        f.truncate(op.a)
                elif op.kind == "create":
                    tp = target(op.path)
                    os.makedirs(os.path.dirname(tp), exist_ok=True)
                    with open(tp, "wb"):
                        pass
                elif op.kind == "rename":
                    src = target(op.path)
                    if os.path.exists(src):
                        # replaying a recorded crash state: durability
                        # is what is under test, not a property of the
                        # replay
                        os.replace(src, target(op.a))
                elif op.kind == "unlink":
                    Path(target(op.path)).unlink(missing_ok=True)
            except FileNotFoundError:
                # The op's file never materialized in this crash state
                # (its create/rename was itself dropped) — exactly the
                # cross-file reordering a real crash can expose.
                continue
        return dest

    def cleanup(self) -> None:
        if self._snapshot:
            shutil.rmtree(self._snapshot, ignore_errors=True)
            self._snapshot = None
