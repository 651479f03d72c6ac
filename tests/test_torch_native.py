"""The port's native host codec (seaweedfs_tpu_torch/ops/rs_native.py) and
its small-payload rule (rs_torch.DEVICE_MIN_S), against the JAX package's
native codec and the numpy oracle, on the CPU. GF(2^8) coding is exact:
tolerance 0. Tests that build the library skip where ``g++`` is missing."""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_native as jax_native
from seaweedfs_tpu.ops.rs_ref import ReferenceEncoder
from seaweedfs_tpu_torch.ops import rs_cuda, rs_native, rs_torch
from torch_teardown import collect_jax_garbage  # noqa: F401

GEOMETRIES = [(10, 4), (6, 3), (12, 4), (3, 1)]
RAGGED = (1, 31, 64, 4097, 100_001)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ toolchain unavailable")


def _ref_apply(coefs, x):
    """The JAX package's numpy oracle (rs_ref's codeSomeShards loop) on
    (n_in, S) or (B, n_in, S)."""
    if x.ndim == 3:
        return np.stack([_ref_apply(coefs, xb) for xb in x])
    ref = ReferenceEncoder(coefs.shape[1], 1)
    return np.stack(ref._code_some(np.asarray(coefs, np.uint8), list(x)))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_apply_matches_jax_native_and_oracle(gxx, k, m, ndim):
    rng = np.random.default_rng(k * 31 + m)
    enc = rs_torch.Encoder(k, m, device="cpu")
    present = list(range(m, k + m))          # first m shards lost
    sets = [enc.parity_coefs,
            enc.decode_matrix_rows(present, list(range(m)))]
    for s in RAGGED:
        shape = (k, s) if ndim == 2 else (2, k, s)
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        for coefs in sets:
            got = rs_native.apply_gf_matrix(coefs, x)
            np.testing.assert_array_equal(
                got, jax_native.apply_gf_matrix(coefs, x))
            if s <= 4097:
                np.testing.assert_array_equal(got, _ref_apply(coefs, x))
    want = ReferenceEncoder(k, m).encode_parity(x if ndim == 2 else x[0])
    np.testing.assert_array_equal(
        rs_native.apply_gf_matrix(enc.parity_coefs, x if ndim == 2
                                  else x[0]), want)


def test_threads_and_errors(gxx, monkeypatch):
    """Column fan-out over threads, and bad shapes."""
    monkeypatch.setattr(rs_native, "THREAD_CHUNK", 1000)
    rng = np.random.default_rng(2)
    coefs = rs_torch.Encoder(10, 4, device="cpu").parity_coefs
    x = rng.integers(0, 256, (10, 10_007), dtype=np.uint8)
    got = rs_native.apply_gf_matrix(coefs, x, threads=4)
    np.testing.assert_array_equal(got, jax_native.apply_gf_matrix(coefs, x,
                                                                  threads=1))
    with pytest.raises(ValueError, match="input shards"):
        rs_native.apply_gf_matrix(coefs, x[:9])
    with pytest.raises(ValueError, match="coefs must be"):
        rs_native.apply_gf_matrix(coefs[0], x)
    with pytest.raises(ValueError, match="expected"):
        rs_native.apply_gf_matrix(coefs, x[None, None])


def test_library_is_built_under_build_dir(gxx):
    assert rs_native.available()
    assert rs_native.simd_level() in (0, 2, 3)
    built = list(rs_native.BUILD_DIR.glob("libgf256_rs_*.so"))
    assert built, "no library under native/build"
    # nothing is written beside the sources (this codec's and the
    # native needle map's)
    assert {p.name for p in rs_native.SRC.parent.iterdir()} \
        <= {"gf256_rs.cpp", "needle_map.cpp", "build"}


class _Plain:
    """Counts calls of ``rs_cuda.apply_gf_matrix``: the kernels' route,
    which takes the plain versions for CPU tensors."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = rs_cuda.apply_gf_matrix

        def spy(coefs, x):
            self.n += 1
            return real(coefs, x)

        monkeypatch.setattr(rs_cuda, "apply_gf_matrix", spy)


@pytest.mark.parametrize("entry", ["apply_matrix", "apply_matrix_host",
                                   "reconstruct_batch_host"])
def test_routing_follows_device_min_s(gxx, monkeypatch, entry):
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 4096)
    plain = _Plain(monkeypatch)
    enc = rs_torch.Encoder(10, 4, device="cpu")
    present = [i for i in range(14) if i not in (0, 5, 11, 13)]
    rng = np.random.default_rng(3)
    for s, native in ((4095, True), (4096, False), (1, True),
                      (5000, False)):
        x = rng.integers(0, 256, (3, 10, s), dtype=np.uint8)
        calls0, plain0 = rs_native.apply_gf_matrix.calls, plain.n
        if entry == "apply_matrix":
            got = rs_torch.apply_matrix(enc.parity_coefs, x, "cpu")
            assert isinstance(got, torch.Tensor)
            want = jax_native.apply_gf_matrix(enc.parity_coefs, x)
        elif entry == "apply_matrix_host":
            got = rs_torch.apply_matrix_host(enc.parity_coefs, x, "cpu")
            want = jax_native.apply_gf_matrix(enc.parity_coefs, x)
        else:
            got = enc.reconstruct_batch_host(x, present, [0, 13])
            want = jax_native.apply_gf_matrix(
                enc.decode_matrix_rows(present, [0, 13]), x)
        np.testing.assert_array_equal(np.asarray(got), want)
        assert rs_native.apply_gf_matrix.calls - calls0 == int(native)
        assert plain.n - plain0 == int(not native)


def test_without_the_library_every_product_takes_the_kernels(monkeypatch):
    monkeypatch.setattr(rs_native, "available", lambda: False)
    plain = _Plain(monkeypatch)
    x = np.random.default_rng(4).integers(0, 256, (1, 10, 100), np.uint8)
    coefs = rs_torch.Encoder(10, 4, device="cpu").parity_coefs
    calls0 = rs_native.apply_gf_matrix.calls
    got = np.asarray(rs_torch.apply_matrix_host(coefs, x, "cpu"))
    np.testing.assert_array_equal(got[0], ReferenceEncoder(10, 4)
                                  .encode_parity(x[0]))
    assert plain.n == 1 and rs_native.apply_gf_matrix.calls == calls0


def test_a_failed_build_is_remembered(monkeypatch, tmp_path):
    """A library that cannot be built makes ``available`` false without
    running the compiler again on every call."""
    runs = []

    def fail(*a, **k):
        runs.append(a)
        raise OSError("no compiler")

    monkeypatch.setattr(rs_native, "_lib", None)
    monkeypatch.setattr(rs_native, "_build_error", None)
    monkeypatch.setattr(rs_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(rs_native.subprocess, "run", fail)
    assert not rs_native.available()
    assert not rs_native.available()
    with pytest.raises(rs_native.NativeUnavailable):
        rs_native.apply_gf_matrix(np.ones((1, 1), np.uint8),
                                  np.ones((1, 8), np.uint8))
    assert len(runs) == 1


def _slow_counter(name):
    def get(self):
        value = getattr(self, "_" + name)
        time.sleep(1e-6)        # other threads run between read and write
        return value

    def put(self, v):
        setattr(self, "_" + name, v)

    cls = type("SlowCount", (), {name: property(get, put)})
    obj = cls()
    setattr(obj, "_" + name, 0)
    return obj


def _hammer(fn, threads=8, each=300):
    ts = [threading.Thread(target=lambda: [fn() for _ in range(each)])
          for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    return threads * each


def test_launch_counts_survive_threads():
    """The kernel wrappers' counting path, from 8 threads at once."""
    counted = _slow_counter("launches")
    n = _hammer(lambda: rs_cuda.count_launch(counted))
    assert counted.launches == n


def test_native_call_counts_survive_threads(gxx, monkeypatch):
    """The host codec's call count, from 8 threads at once."""
    coefs = np.ones((1, 2), np.uint8)
    x = np.ones((2, 16), np.uint8)
    real = rs_native.apply_gf_matrix
    counted = _slow_counter("calls")
    monkeypatch.setattr(rs_native, "apply_gf_matrix", counted)
    n = _hammer(lambda: real(coefs, x))
    assert counted.calls == n
