"""ctypes bridge to the native needle map (native/needle_map.cpp).

The port of ``seaweedfs_tpu/storage/needle_map_native.py``. The C++
source is the port's own copy of the JAX package's: one open-addressing
array of 16-byte entries (~24 B/slot) in place of a Python dict at
~200 B/entry, with ``.idx`` replay inside the library in one call.

Same surface as idx.CompactMap (set/get/delete/len/live_entries/
items/close + the counters the store status and the vacuum read) —
except ``items()``, which yields only LIVE entries where CompactMap
also yields tombstones (see the method comment).

The library is built with ``g++`` at first use into ``native/build/``
(listed in .gitignore) under a name that hashes the source and the
flags, as ``ops/rs_native.py`` builds the host codec, so an edited
source never loads a stale build and nothing is written beside the
source. A failed build is remembered: :func:`available` is then false
for the life of the process, and ``Volume`` falls back to the memory
map with a warning, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional

from .idx import IndexEntry
from .types import NEEDLE_MAP_ENTRY_SIZE

SRC = Path(__file__).resolve().parent.parent / "native" / "needle_map.cpp"
BUILD_DIR = SRC.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_build_error: Optional["NativeUnavailable"] = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    lib = BUILD_DIR / f"libneedle_map_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process temporary name, renamed into place: two processes
    # building at once never load a half-written file
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"g++ build failed: {detail}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _get_lib():
    global _lib, _build_error
    # the lock makes the one-time g++ build happen once per process
    with _lib_lock:
        if _lib is None and _build_error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
            except (NativeUnavailable, OSError) as e:
                _build_error = e if isinstance(e, NativeUnavailable) \
                    else NativeUnavailable(f"cannot load the map: {e}")
                raise _build_error from e
            lib.nm_new.restype = ctypes.c_void_p
            lib.nm_new.argtypes = [ctypes.c_uint64]
            lib.nm_free.restype = None
            lib.nm_free.argtypes = [ctypes.c_void_p]
            lib.nm_set.restype = ctypes.c_int
            lib.nm_set.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_uint32, ctypes.c_uint32]
            lib.nm_delete.restype = ctypes.c_int
            lib.nm_delete.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.nm_get.restype = ctypes.c_int
            lib.nm_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.POINTER(ctypes.c_uint32)]
            lib.nm_live.restype = ctypes.c_uint64
            lib.nm_live.argtypes = [ctypes.c_void_p]
            lib.nm_stats.restype = None
            lib.nm_stats.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_uint64)] * 5
            lib.nm_dump_live.restype = ctypes.c_uint64
            lib.nm_dump_live.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64]
            lib.nm_load_idx.restype = ctypes.c_uint64
            lib.nm_load_idx.argtypes = [ctypes.c_void_p,
                                        ctypes.c_char_p, ctypes.c_uint64]
            _lib = lib
        if _lib is None:
            raise _build_error
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (decided once)."""
    try:
        _get_lib()
        return True
    except NativeUnavailable:
        return False


class NativeNeedleMap:
    """CompactMap drop-in backed by the C open-addressing table."""

    def __init__(self, cap_hint: int = 0) -> None:
        self._lib = _get_lib()
        self._h = self._lib.nm_new(cap_hint)
        if not self._h:
            raise MemoryError("nm_new failed")
        self._lock = threading.Lock()

    def _handle(self):
        """Guard: a NULL handle must raise (like sqlite's
        ProgrammingError after close), never reach the C library —
        ctypes would pass NULL and segfault the process."""
        h = self._h
        if not h:
            raise RuntimeError("needle map is closed")
        return h

    # -- CompactMap surface ----------------------------------------------

    def set(self, key: int, offset_units: int, size: int) -> None:
        with self._lock:
            if self._lib.nm_set(self._handle(), key, offset_units,
                                size) != 0:
                raise MemoryError("needle map allocation failed")

    def delete(self, key: int) -> bool:
        with self._lock:
            return bool(self._lib.nm_delete(self._handle(), key))

    def get(self, key: int) -> Optional[IndexEntry]:
        off = ctypes.c_uint32()
        size = ctypes.c_uint32()
        with self._lock:
            ok = self._lib.nm_get(self._handle(), key, ctypes.byref(off),
                                  ctypes.byref(size))
        if not ok:
            return None
        return IndexEntry(key, off.value, size.value)

    def __len__(self) -> int:
        with self._lock:
            return int(self._lib.nm_live(self._handle()))

    def live_entries(self) -> List[IndexEntry]:
        with self._lock:
            # count + dump under ONE lock hold: a writer between the
            # two would otherwise silently truncate the listing
            h = self._handle()
            n = int(self._lib.nm_live(h))
            keys = (ctypes.c_uint64 * n)()
            offs = (ctypes.c_uint32 * n)()
            sizes = (ctypes.c_uint32 * n)()
            got = self._lib.nm_dump_live(h, keys, offs, sizes, n)
        out = [IndexEntry(keys[i], offs[i], sizes[i])
               for i in range(got)]
        out.sort(key=lambda e: e.key)
        return out

    def items(self) -> Iterator[IndexEntry]:
        # Divergence from idx.CompactMap.items(): only LIVE entries are
        # yielded — tombstoned keys are dropped by nm_dump_live.
        return iter(self.live_entries())

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.nm_free(self._h)
                self._h = None

    def __del__(self):  # best-effort; close() is the real contract
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    # -- the counters the store status and the vacuum read ----------------

    def _stats(self) -> list[int]:
        vals = [ctypes.c_uint64() for _ in range(5)]
        with self._lock:
            self._lib.nm_stats(self._handle(),
                               *[ctypes.byref(v) for v in vals])
        return [v.value for v in vals]

    @property
    def file_count(self) -> int:
        return self._stats()[0]

    @property
    def deleted_count(self) -> int:
        return self._stats()[1]

    @property
    def deleted_bytes(self) -> int:
        return self._stats()[2]

    @property
    def max_offset_units(self) -> int:
        return self._stats()[3]

    @property
    def max_key(self) -> int:
        return self._stats()[4]

    # -- loading ----------------------------------------------------------

    @classmethod
    def load_from_idx(cls, path) -> "NativeNeedleMap":
        blob = Path(path).read_bytes() if Path(path).exists() else b""
        if len(blob) % NEEDLE_MAP_ENTRY_SIZE:
            raise ValueError(
                f"index length {len(blob)} not a multiple of "
                f"{NEEDLE_MAP_ENTRY_SIZE}")
        n = len(blob) // NEEDLE_MAP_ENTRY_SIZE
        m = cls(cap_hint=n)
        if n:
            applied = m._lib.nm_load_idx(m._h, blob, n)
            if applied != n:
                m.close()
                raise MemoryError(
                    f"needle map load failed at record {applied}/{n}")
        return m
