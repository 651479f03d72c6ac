"""The port's hybrid routing (seaweedfs_tpu_torch/ops/rs_torch.py)
against the JAX package's, on the CPU.

With the link and host-codec probe rates pinned (as
tests/test_encode_parity_host.py and tests/test_dispatch_group.py pin
them), the port's link-bandwidth rule decides as ``rs_jax`` does in
every mode; the knob rejects bad values; and a list of host slabs of
mixed shapes is routed slab by slab, byte-equal to per-slab calls."""

import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_jax
from seaweedfs_tpu.ops import rs_native as jax_native
from seaweedfs_tpu_torch.ops import rs_native, rs_ref, rs_torch

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.fixture()
def probed(monkeypatch):
    """Pin both packages' probe results; the test sets the rates."""
    def pin(mode, link, native, available=True):
        monkeypatch.setattr(rs_jax, "HOST_DISPATCH", mode)
        monkeypatch.setenv("SEAWEEDFS_TORCH_HOST_DISPATCH", mode)
        for mod in (rs_jax, rs_torch):
            monkeypatch.setattr(mod, "_link_gibps", link)
            monkeypatch.setattr(mod, "_native_gibps", native)
        monkeypatch.setattr(jax_native, "available", lambda: available)
        monkeypatch.setattr(rs_native, "available", lambda: available)
    return pin


@pytest.mark.parametrize("available", [True, False],
                         ids=["codec", "no-codec"])
@pytest.mark.parametrize("link,native", [(0.02, 2.0), (50.0, 2.0),
                                         (2.0, 2.0)],
                         ids=["slow-link", "fast-link", "tie"])
@pytest.mark.parametrize("mode", ["auto", "device", "native"])
def test_link_rule_decides_as_the_jax_one(probed, mode, link, native,
                                          available):
    probed(mode, link, native, available)
    worth = rs_jax._device_worth_it()
    stay = rs_jax._stay_on_host()
    assert rs_torch._device_worth_it() == worth
    assert rs_torch._stay_on_host() == stay
    # the routing order: small S -> codec, then the link rule on the
    # card; the CPU takes the plain versions from DEVICE_MIN_S
    big, small = rs_torch.DEVICE_MIN_S, rs_torch.DEVICE_MIN_S - 1
    assert rs_torch._host_takes(big, CUDA) == stay
    assert rs_torch._host_takes(small, CUDA) == available
    assert rs_torch._host_takes(small, CPU) == available
    assert rs_torch._host_takes(big, CPU) is False
    if mode == "auto" and available:
        assert rs_torch.calibration() == (link, native)


def test_probe_runs_once_under_concurrent_callers(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TORCH_HOST_DISPATCH", "auto")
    monkeypatch.setattr(rs_torch, "_link_gibps", None)
    monkeypatch.setattr(rs_torch, "_native_gibps", None)
    monkeypatch.setattr(rs_native, "available", lambda: True)
    calls = []

    def probe(name, rate):
        def fn(*args):
            calls.append(name)
            time.sleep(0.05)       # hold the lock while others arrive
            return rate
        return fn

    monkeypatch.setattr(rs_torch, "_measure_link_gibps", probe("link", 1.0))
    monkeypatch.setattr(rs_torch, "_measure_native_gibps",
                        probe("native", 3.0))
    assert rs_torch.calibration() is None
    got: list = []
    threads = [threading.Thread(
        target=lambda: got.append(rs_torch._stay_on_host(CUDA)))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(calls) == ["link", "native"]
    assert got == [True] * 8
    assert rs_torch.calibration() == (1.0, 3.0)


@pytest.mark.parametrize("fn", [
    lambda: rs_torch._host_takes(1, CPU),
    lambda: rs_torch.apply_matrix_host(np.ones((1, 1), np.uint8),
                                       np.zeros((1, 1, 1 << 20), np.uint8),
                                       "cpu"),
], ids=["rule", "product"])
@pytest.mark.parametrize("value", ["banana", "0"])
def test_knob_is_validated_at_use_time(monkeypatch, fn, value):
    monkeypatch.setenv("SEAWEEDFS_TORCH_HOST_DISPATCH", value)
    with pytest.raises(ValueError, match="SEAWEEDFS_TORCH_HOST_DISPATCH"):
        fn()


@pytest.mark.parametrize("seed", [1, 2])
def test_host_slabs_of_mixed_shapes_route_slab_by_slab(monkeypatch, seed):
    """A slab below the small-payload threshold goes to the host codec,
    the others to the kernels' plain versions; results come back in
    order, byte-equal to per-slab calls and to rs_ref."""
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 4096)
    rng = np.random.default_rng(seed)
    enc = rs_torch.Encoder(4, 2, device="cpu")
    ref = rs_ref.ReferenceEncoder(4, 2)
    shapes = [(2, 4, 8192), (2, 4, 8192), (1, 4, 2048), (3, 4, 4096 + 300),
              (1, 4, 8192), (2, 4, 8192)]
    slabs = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    calls = rs_native.apply_gf_matrix.calls
    outs = enc.encode_parity_host_multi(slabs)
    assert rs_native.apply_gf_matrix.calls == calls + 1
    assert len(outs) == len(slabs)
    for x, out in zip(slabs, outs):
        got = np.asarray(out)
        np.testing.assert_array_equal(got, np.asarray(
            enc.encode_parity_host(x)))
        np.testing.assert_array_equal(got, np.stack(
            [ref.encode_parity(xb) for xb in x]))
