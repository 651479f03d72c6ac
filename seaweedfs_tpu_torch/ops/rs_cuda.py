"""The two hand-written GF(2^8) kernels, their wrappers and plain versions.

Both compute y[b, o, s] = XOR_d coefs[o, d] * x[b, d, s] over GF(2^8)
(polynomial 0x11D) on (B, n_in, S) uint8 tensors:

* the **transpose kernel** (``csrc/gf_transpose.cu``) replaces
  ``seaweedfs_tpu/ops/rs_pallas.py`` ``_make_kernel`` (via
  ``apply_gf_matrix_words``): each lane bit-transposes 32 bytes per shard
  in registers and applies the expanded GF(2) matrix to the bit planes by
  the method of four Russians (per-lane XOR tables of 4 planes in shared
  memory, two lookups per matrix row). Plain version:
  :func:`apply_gf_matrix_transpose_ref` (ops/bitslice.py).
* the **SWAR kernel** (``csrc/gf_swar.cu``) replaces ``_make_swar_kernel``
  (via ``apply_gf_matrix_swar_words``): per 32-bit word, bit plane j of the
  4 bytes is ``(x >> j) & 0x01010101`` and output bytes accumulate
  ``plane * (c * 2^j)``. Plain version: :func:`apply_gf_matrix_swar_ref`.

Their memory bound on an H100 is (n_in + n_out) * B * S bytes over
3.35 TB/s; the source notes in ``csrc/`` say what bounds each in fact.
The coefficient matrix is data: a table of ``(n_out, n_in, 8)`` bytes
built on the host (cached per matrix in host memory) travels in the
launch's parameter block, so one build serves every survivor set and no
table lives in device memory, where a launch queued on another stream
could outlive it. The parameter block holds ``TABLE_BYTES``, so a launch
takes at most :func:`outputs_per_launch` rows.

Both sources are compiled with ``nvcc`` for ``sm_90a`` at first use, one
process per source in parallel, into one shared library with a plain C
interface under ``csrc/build/`` (listed in .gitignore), and loaded with
``ctypes``. ``BUILDS`` counts the builds of this process.

A wrapper takes its plain version only for a tensor on the CPU. For a
CUDA tensor it launches its kernel or raises; nothing falls back. Each
wrapper counts its launches in its ``launches`` attribute, a plain
integer that a caller may reset to 0; the count is taken under a lock
(:func:`count_launch`), since the read path launches from several
threads at once. :func:`thread_launches` says how many of them the
calling thread made, which attributes launches to one of several
callers sharing the card (the job workers of two volume servers).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from . import bitslice, gf256

#: Outputs per kernel launch at most (the kernels' MAXO): wider
#: matrices take one launch per MAXO output rows.
MAXO = 8
#: Bytes of coefficient table a launch carries in its parameter block
#: (csrc/gf_common.cuh): n_out * n_in * 8 of them.
TABLE_BYTES = 4032
#: Byte granules along S: the wrappers zero-pad S up to these (zero bytes
#: give zero output, so padding is transparent) and slice the result.
TRANSPOSE_GRANULE = 128
SWAR_GRANULE = 16
#: A shard length that needs no padding for either kernel.
GRANULE = max(TRANSPOSE_GRANULE, SWAR_GRANULE)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gf_transpose.cu", "gf_swar.cu")
HEADERS = ("gf_common.cuh",)
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel library builds in this process, and the last build's compiler
#: output (register and shared-memory use from ``-Xptxas -v``).
BUILDS = 0
BUILD_LOG = ""
_lib = None
_lib_lock = threading.Lock()
_launches_lock = threading.Lock()
_thread_counts = threading.local()


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME")


def _build() -> Path:
    """Compile every source in parallel, link one library, and return
    its path. The name carries a hash of the sources and flags, so an
    edited source never loads a stale build."""
    global BUILDS, BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update((CSRC / src).read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"libgf256_kernels_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode:
            failed.append(src)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
    tmp = lib.with_suffix(".so.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    BUILDS += 1
    BUILD_LOG = "\n".join(logs)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for fn in (lib.gf_transpose_launch, lib.gf_swar_launch):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for fn in (lib.gf_transpose_blocks_per_sm,
                       lib.gf_swar_blocks_per_sm):
                fn.argtypes = [ctypes.c_int, ctypes.c_int]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


# --------------------------------------------------------------------------
# coefficient tables (the matrix as kernel data)
# --------------------------------------------------------------------------

def transpose_table(coefs: np.ndarray) -> np.ndarray:
    """(n_out, n_in, 8) uint8: byte [o, d, i] has bit j set iff output
    bit i of shard o takes input bit j of shard d — the expanded GF(2)
    matrix, one row byte per (o, d, i)."""
    coefs = np.asarray(coefs, dtype=np.uint8)
    n_out, n_in = coefs.shape
    mbits = bitslice.expand_gf2(coefs).reshape(n_out, 8, n_in, 8)
    weights = (1 << np.arange(8)).astype(np.uint16)
    rows = (mbits.astype(np.uint16) * weights).sum(axis=-1)  # (o, i, d)
    return np.ascontiguousarray(rows.transpose(0, 2, 1).astype(np.uint8))


def swar_table(coefs: np.ndarray) -> np.ndarray:
    """(n_out, n_in, 8) uint8: [o, d, j] = coefs[o, d] * 2^j in GF(2^8)."""
    coefs = np.asarray(coefs, dtype=np.uint8)
    mul = gf256.mul_table()
    return np.ascontiguousarray(
        mul[coefs[..., None], (1 << np.arange(8))[None, None, :]])


@functools.lru_cache(maxsize=128)
def _host_table(kind: str, coefs_bytes: bytes, n_out: int,
                n_in: int) -> np.ndarray:
    """A kernel's table in host memory, made once per matrix. The launch
    function copies it into the kernel's parameters, so evicting it
    never frees anything a queued launch still reads."""
    coefs = np.frombuffer(coefs_bytes, dtype=np.uint8).reshape(n_out, n_in)
    table = transpose_table(coefs) if kind == "transpose" \
        else swar_table(coefs)
    table.setflags(write=False)
    return table


def outputs_per_launch(n_in: int) -> int:
    """Output rows one launch takes: MAXO, or fewer where their table
    would not fit in ``TABLE_BYTES`` (more than 63 inputs)."""
    per = min(MAXO, TABLE_BYTES // (8 * n_in))
    if per < 1:
        raise ValueError(f"{n_in} inputs: a launch's table holds at most "
                         f"{TABLE_BYTES // 8} input shards")
    return per


def blocks_per_sm(kind: str, n_out: int, n_in: int) -> int:
    """Resident blocks per SM of the kernel instance a launch of
    ``n_out`` outputs over ``n_in`` inputs uses, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current
    card."""
    lib = library()
    fn = (lib.gf_transpose_blocks_per_sm if kind == "transpose"
          else lib.gf_swar_blocks_per_sm)
    got = fn(n_out, n_in)
    if got <= 0:
        raise RuntimeError(f"{kind} occupancy query failed: CUDA error "
                           f"{-got}")
    return got


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _pad_s(x: torch.Tensor, granule: int) -> torch.Tensor:
    """``x`` zero-padded along S to a multiple of ``granule``, contiguous
    and 16-byte aligned: the kernels and the plain versions read it as 4-
    or 16-byte words, so a view at an odd offset is copied."""
    pad = (-x.shape[-1]) % granule
    if pad:
        return torch.nn.functional.pad(x, (0, pad))
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def apply_gf_matrix_transpose_ref(coefs: np.ndarray,
                                  x: torch.Tensor) -> torch.Tensor:
    """Plain version of the transpose kernel: pack to bit planes with
    the 32x32 transpose, XOR the planes each matrix row selects, unpack
    (ops/bitslice.py). Any S; any device."""
    s = x.shape[-1]
    y = bitslice.apply_gf_matrix(coefs, _pad_s(x, TRANSPOSE_GRANULE))
    return y[..., :s]


def apply_gf_matrix_swar_ref(coefs: np.ndarray,
                             x: torch.Tensor) -> torch.Tensor:
    """Plain version of the SWAR kernel, in the TPU kernel's own form:
    plane (d, j) = (x_d >> j) & 0x01010101 over int32 words, output row
    8o+i = XOR of the planes its GF(2) row selects, shifted back in at
    bit i. Any S; any device."""
    coefs = np.asarray(coefs, dtype=np.uint8)
    n_out, n_in = coefs.shape
    s = x.shape[-1]
    w = _pad_s(x, 4).view(torch.int32)                 # (B, n_in, W)
    lo = bitslice.as_i32(0x01010101)
    planes = [(w[:, d] if j == 0 else bitslice.srl(w[:, d], j)) & lo
              for d in range(n_in) for j in range(8)]
    mbits = bitslice.expand_gf2(coefs)
    outs = []
    for o in range(n_out):
        y = torch.zeros_like(w[:, 0])
        for i in range(8):
            for t in np.nonzero(mbits[8 * o + i])[0]:
                y ^= planes[int(t)] << i
        outs.append(y)
    return torch.stack(outs, dim=1).view(torch.uint8)[..., :s]


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(coefs, x: torch.Tensor) -> np.ndarray:
    coefs = np.ascontiguousarray(coefs, dtype=np.uint8)
    if coefs.ndim != 2 or not coefs.size:
        raise ValueError(f"coefs must be (n_out, n_in), got {coefs.shape}")
    if not isinstance(x, torch.Tensor) or x.dim() != 3 \
            or x.shape[1] != coefs.shape[1] or x.dtype != torch.uint8:
        raise ValueError(f"x must be a (B, {coefs.shape[1]}, S) uint8 "
                         f"tensor, got {getattr(x, 'shape', type(x))}")
    return coefs


def _launch(kind: str, coefs: np.ndarray, x: torch.Tensor,
            counted) -> torch.Tensor:
    """Run one kernel on CUDA tensor ``x`` on the current stream, one
    launch per :func:`outputs_per_launch` output rows. Pads S to the
    kernel's granule."""
    n_out, n_in = coefs.shape
    per = outputs_per_launch(n_in)
    lib = library()
    fn, granule = ((lib.gf_transpose_launch, TRANSPOSE_GRANULE)
                   if kind == "transpose"
                   else (lib.gf_swar_launch, SWAR_GRANULE))
    b, _, s = x.shape
    with torch.cuda.device(x.device):
        xp = _pad_s(x, granule)
        sp = xp.shape[-1]
        y = torch.empty((b, n_out, sp), dtype=torch.uint8, device=x.device)
        table = _host_table(kind, coefs.tobytes(), n_out, n_in)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for o0 in range(0, n_out, per):
            oc = min(per, n_out - o0)
            err = fn(xp.data_ptr(), y.data_ptr() + o0 * sp,
                     table.ctypes.data + o0 * n_in * 8, b, n_in, oc, n_out,
                     sp, stream)
            if err:
                raise RuntimeError(f"{kind} kernel launch failed: CUDA "
                                   f"error {err}")
            count_launch(counted)
    return y if sp == s else y[..., :s]


def count_launch(counted) -> None:
    """Add one to ``counted.launches``: a read-modify-write that threads
    launching at once would otherwise lose."""
    with _launches_lock:
        counted.launches += 1
    mine = getattr(_thread_counts, "by_kernel", None)
    if mine is None:
        mine = _thread_counts.by_kernel = {}
    name = getattr(counted, "kernel", "")
    mine[name] = mine.get(name, 0) + 1


def thread_launches() -> dict:
    """Launches the calling thread has made, by kernel name: a copy
    that only ever grows, so a caller subtracts two readings."""
    return dict(getattr(_thread_counts, "by_kernel", None) or {})


def apply_gf_matrix_transpose(coefs: np.ndarray,
                              x: torch.Tensor) -> torch.Tensor:
    """(B, n_in, S) uint8 -> (B, n_out, S) uint8 through the transpose
    kernel (CUDA tensors) or its plain version (CPU tensors)."""
    coefs = _check(coefs, x)
    if x.device.type == "cpu":
        return apply_gf_matrix_transpose_ref(coefs, x)
    if x.device.type != "cuda":
        raise ValueError(f"no GF(2^8) kernel for device {x.device}")
    return _launch("transpose", coefs, x, apply_gf_matrix_transpose)


def apply_gf_matrix_swar(coefs: np.ndarray,
                         x: torch.Tensor) -> torch.Tensor:
    """(B, n_in, S) uint8 -> (B, n_out, S) uint8 through the SWAR
    kernel (CUDA tensors) or its plain version (CPU tensors)."""
    coefs = _check(coefs, x)
    if x.device.type == "cpu":
        return apply_gf_matrix_swar_ref(coefs, x)
    if x.device.type != "cuda":
        raise ValueError(f"no GF(2^8) kernel for device {x.device}")
    return _launch("swar", coefs, x, apply_gf_matrix_swar)


apply_gf_matrix_transpose.launches = 0
apply_gf_matrix_swar.launches = 0
apply_gf_matrix_transpose.kernel = "transpose"
apply_gf_matrix_swar.kernel = "swar"


def kernel() -> str:
    """The kernel choice, ``SEAWEEDFS_TORCH_KERNEL`` = transpose (the
    default) or swar, read and validated at use time so a typo surfaces
    from the encode call."""
    choice = os.environ.get("SEAWEEDFS_TORCH_KERNEL") or "transpose"
    if choice not in ("transpose", "swar"):
        raise ValueError(f"SEAWEEDFS_TORCH_KERNEL={choice!r}: expected "
                         f"'transpose' or 'swar'")
    return choice


def apply_gf_matrix(coefs: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """y[b, o, s] = XOR_d coefs[o, d] * x[b, d, s] through the chosen
    kernel (:func:`kernel`); any S."""
    if kernel() == "swar":
        return apply_gf_matrix_swar(coefs, x)
    return apply_gf_matrix_transpose(coefs, x)
