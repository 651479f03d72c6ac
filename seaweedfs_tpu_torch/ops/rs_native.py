"""ctypes bridge to the native host GF(2^8) codec (native/gf256_rs.cpp).

The port of ``seaweedfs_tpu/ops/rs_native.py``. The C++ source is the
port's own copy of the JAX package's: a small library with a plain C
interface, compiled with ``g++`` at first use and driven over ctypes.
Python threads can fan one large apply out across column chunks because
the C calls release the GIL. Dispatch ladder inside the library:
GFNI+AVX512 (one ``vgf2p8affineqb`` per 64 bytes, bit convention
self-calibrated at init) -> AVX2 nibble tables -> scalar table.

Role in the port: the host leg of the small-payload rule
(``rs_torch.DEVICE_MIN_S``): a product whose shard length is below the
crossover measured on the card is computed here, because a round trip
to the card costs more than the math (the read path's interval repairs).

The library is built into ``native/build/`` (listed in .gitignore) under
a name that hashes the source and the flags, so an edited source never
loads a stale build and nothing is written beside the source. A failed
build is remembered: :func:`available` is then false for the life of
the process and the small-payload rule sends everything to the kernels.

:func:`apply_gf_matrix` counts its calls in its ``calls`` attribute
(under a lock, since the read path calls it from several threads), which
a caller may reset to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from ..util import durability

SRC = Path(__file__).resolve().parent.parent / "native" / "gf256_rs.cpp"
BUILD_DIR = SRC.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

#: Column chunk per worker thread when fanning out (bytes).
THREAD_CHUNK = 8 * 1024 * 1024

_lib = None
_build_error: Optional["NativeUnavailable"] = None
_lib_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_calls_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    lib = BUILD_DIR / f"libgf256_rs_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process temporary name, renamed into place: two processes
    # building at once never load a half-written file
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        durability.durable_replace(tmp, lib)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"g++ build failed: {detail}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load():
    global _lib, _build_error
    # the lock makes the one-time g++ build happen once per process
    # seaweedlint: disable=SW103 — intentional build-once lock; the sleep edge _build -> VolumeServer.read_bytes -> check is a false name-based resolution of Path.read_bytes
    with _lib_lock:
        if _lib is None and _build_error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
            except (NativeUnavailable, OSError) as e:
                _build_error = e if isinstance(e, NativeUnavailable) \
                    else NativeUnavailable(f"cannot load the codec: {e}")
                raise _build_error from e
            lib.gf256_init.argtypes = []
            lib.gf256_init.restype = None
            lib.gf256_simd_level.argtypes = []
            lib.gf256_simd_level.restype = ctypes.c_int
            lib.rs_apply.restype = None
            lib.rs_apply.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.c_size_t]
            lib.gf256_init()
            _lib = lib
        if _lib is None:
            raise _build_error
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (decided once)."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def simd_level() -> int:
    """0 = scalar, 2 = AVX2 nibble tables, 3 = GFNI+AVX512."""
    return int(_load().gf256_simd_level())


def _ptr(a: np.ndarray, offset: int = 0):
    return ctypes.cast(a.ctypes.data + offset,
                       ctypes.POINTER(ctypes.c_uint8))


def _apply_2d(lib, coefs: np.ndarray, x: np.ndarray, out: np.ndarray,
              threads: int) -> None:
    n_out, n_in = coefs.shape
    s = x.shape[-1]
    cp = _ptr(coefs)
    if threads <= 1 or s < 2 * THREAD_CHUNK:
        lib.rs_apply(cp, n_out, n_in, _ptr(x), s, _ptr(out), s, s)
        return
    global _pool
    with _lib_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="gf256-native")
    n_chunks = min(threads, -(-s // THREAD_CHUNK))
    bounds = [s * i // n_chunks for i in range(n_chunks + 1)]
    # column windows are zero-copy: the same row strides from offset base
    # pointers, each on a pool thread (the C call releases the GIL)
    futs = [_pool.submit(lib.rs_apply, cp, n_out, n_in, _ptr(x, lo), s,
                         _ptr(out, lo), s, hi - lo)
            for lo, hi in zip(bounds, bounds[1:])]
    for f in futs:
        f.result()


def apply_gf_matrix(coefs: np.ndarray, x: np.ndarray,
                    threads: Optional[int] = None) -> np.ndarray:
    """y[..., o, s] = XOR_d coefs[o, d] * x[..., d, s] on the host CPU.

    (n_in, S) or (B, n_in, S) uint8 numpy in, numpy out; any S.
    ``threads`` (default: the CPU count, at most 4) fans a shard longer
    than ``2 * THREAD_CHUNK`` out over column chunks."""
    if threads is None:
        threads = min(os.cpu_count() or 1, 4)
    lib = _load()
    coefs = np.ascontiguousarray(coefs, dtype=np.uint8)
    if coefs.ndim != 2:
        raise ValueError(f"coefs must be (n_out, n_in), got {coefs.shape}")
    n_out, n_in = coefs.shape
    x = np.ascontiguousarray(x, dtype=np.uint8)
    if x.ndim == 2:
        want_shape = (n_out, x.shape[1])
    elif x.ndim == 3:
        want_shape = (x.shape[0], n_out, x.shape[2])
    else:
        raise ValueError(
            f"expected (n_in, S) or (B, n_in, S), got {x.shape}")
    if x.shape[-2] != n_in:
        raise ValueError(f"x must have {n_in} input shards, got {x.shape}")
    out = np.empty(want_shape, dtype=np.uint8)
    with _calls_lock:
        apply_gf_matrix.calls += 1
    if x.ndim == 2:
        _apply_2d(lib, coefs, x, out, threads)
    else:
        for b in range(x.shape[0]):
            _apply_2d(lib, coefs, x[b], out[b], threads)
    return out


apply_gf_matrix.calls = 0
