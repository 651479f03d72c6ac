"""The port's CUDA kernels and host path on the card. Every test here
needs a CUDA card and skips without one: the kernels have no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held byte for byte against its plain PyTorch version on
the same inputs (GF(2^8) coding is exact: tolerance 0)."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_native, rs_torch
from seaweedfs_tpu_torch.pipeline import encode, pipe, read, repair
from seaweedfs_tpu_torch.pipeline import repair_bench
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files, volume

LOST = (2, 7, 11, 13)
PRESENT = [i for i in range(14) if i not in LOST]
KERNELS = [(rs_cuda.apply_gf_matrix_transpose,
            rs_cuda.apply_gf_matrix_transpose_ref),
           (rs_cuda.apply_gf_matrix_swar, rs_cuda.apply_gf_matrix_swar_ref)]
KINDS = ["transpose", "swar"]
#: (n_in, n_out): every output-count instance with 10 inputs, other input
#: counts, and 70 inputs, whose table fits only 7 outputs per launch
SWEEP = [(10, m) for m in range(1, 9)] + [(4, 4), (6, 3), (12, 4), (70, 8)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture(autouse=True)
def _host_slabs_to_the_card(monkeypatch):
    """Pin the link-bandwidth rule to the card, so that every host
    product from DEVICE_MIN_S launches a kernel whatever the probe
    would say on this machine."""
    monkeypatch.setenv("SEAWEEDFS_TORCH_HOST_DISPATCH", "device")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
@pytest.mark.parametrize("s", [65536, 65536 + 300, 65536 + 1003])
@pytest.mark.parametrize("n_in,n_out", SWEEP,
                         ids=[f"{k}to{m}" for k, m in SWEEP])
def test_kernel_matches_plain_version(kernel, s, n_in, n_out):
    _need_card()
    wrapper, plain = KERNELS[kernel]
    enc = rs_torch.Encoder(n_in, n_out, device="cuda")
    x = torch.randint(0, 256, (3, n_in, s), dtype=torch.uint8,
                      device="cuda",
                      generator=torch.Generator("cuda").manual_seed(s))
    sets = [enc.parity_coefs]
    if (n_in, n_out) == (10, 4):
        sets.append(enc.decode_matrix_rows(PRESENT, list(LOST)))
    per = rs_cuda.outputs_per_launch(n_in)
    for coefs in sets:
        n = wrapper.launches
        y = wrapper(coefs, x)
        torch.cuda.synchronize()
        assert wrapper.launches == n + -(-n_out // per)
        assert torch.equal(y, plain(coefs, x))
    assert rs_cuda.blocks_per_sm(KINDS[kernel], min(n_out, per), n_in) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
def test_queued_launch_outlives_its_table(kernel):
    """A launch queued on a side stream keeps its coefficients after the
    table cache is cleared and the default stream reuses freed memory:
    the table travels in the launch's parameters."""
    _need_card()
    wrapper, plain = KERNELS[kernel]
    coefs = rs_torch.Encoder(10, 4, device="cuda").parity_coefs
    x = torch.randint(0, 256, (1, 10, 1 << 20), dtype=torch.uint8,
                      device="cuda")
    want = plain(coefs, x)
    wrapper(coefs, x)                    # first use on the default stream
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)   # keep the next launch queued
        y = wrapper(coefs, x)
    rs_cuda._host_table.cache_clear()
    junk = [torch.full((coefs.size * 8,), 0xFF, dtype=torch.uint8,
                       device="cuda") for _ in range(64)]
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
def test_kernel_more_outputs_than_one_launch(kernel):
    _need_card()
    wrapper, plain = KERNELS[kernel]
    coefs = gf256.build_code_matrix(4, 16)[4:]          # 12 outputs
    x = torch.randint(0, 256, (2, 4, 4096), dtype=torch.uint8,
                      device="cuda")
    n = wrapper.launches
    assert torch.equal(wrapper(coefs, x), plain(coefs, x))
    assert wrapper.launches == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
def test_kernel_takes_a_view_at_an_odd_offset(kernel):
    _need_card()
    wrapper, plain = KERNELS[kernel]
    coefs = rs_torch.Encoder(10, 4, device="cuda").parity_coefs
    flat = torch.randint(0, 256, (10 * 4096 + 3,), dtype=torch.uint8,
                         device="cuda")
    x = flat[3:].view(1, 10, 4096)          # contiguous, 3 bytes in
    assert x.data_ptr() % 16
    assert torch.equal(wrapper(coefs, x), plain(coefs, x))


@pytest.mark.cuda
def test_host_results_come_back_in_order_from_pinned_buffers(monkeypatch):
    _need_card()
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 0)   # every slab to the card
    enc = rs_torch.Encoder(10, 4)                       # device=None
    assert enc.device.type == "cuda"
    cpu = rs_torch.Encoder(10, 4, device="cpu")
    pool = pipe.HostBufferPool(10 * 8192, 3, pinned=True)
    rng = np.random.default_rng(0)
    bufs, results, wants = [], [], []
    for _ in range(3):
        buf = pool.acquire()
        batch = buf.reshape(1, 10, 8192)
        batch[:] = rng.integers(0, 256, batch.shape, dtype=np.uint8)
        wants.append(cpu.encode_parity_host(batch.copy()))
        results.append(enc.encode_parity_host(batch))
        bufs.append(buf)
    for want, got, buf in zip(wants, results, bufs):
        np.testing.assert_array_equal(np.asarray(got), want)
        buf[:] = 0          # safe: the copy that read it has completed
        pool.release(buf)
    assert pool.in_flight() == 0


#: the read path's small geometry (tests/test_torch_read.py), and a
#: threshold that sends intervals of 2 KiB and more to the kernels
READ_SCHEME = EcScheme(10, 4, large_block_size=64 * 1024,
                       small_block_size=8 * 1024)
READ_LOST = (0, 5, 11, 13)


def _launches():
    return (rs_cuda.apply_gf_matrix_transpose.launches
            + rs_cuda.apply_gf_matrix_swar.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("aggregated", [False, True],
                         ids=["direct", "aggregator"])
def test_reader_on_the_card_matches_the_cpu(tmp_path, monkeypatch,
                                            aggregated):
    _need_card()
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 2048)
    base = tmp_path / "v"
    n = volume.write_synthetic_volume(base, 300_000, avg_size=3000, seed=7)
    encode.encode_volume(base, READ_SCHEME, device="cpu")
    for i in READ_LOST:
        ec_files.shard_path(base, i).unlink()
    launches0, calls0 = _launches(), rs_native.apply_gf_matrix.calls
    cpu = read.EcVolumeReader(base, READ_SCHEME, device="cpu")
    want = {k: cpu.read_record(k) for k in range(1, n + 1)}
    if aggregated:
        with repair.IntervalRepairAggregator(READ_SCHEME,
                                             device="cuda") as agg:
            card = read.EcVolumeReader(base, READ_SCHEME, aggregator=agg)
            got = {k: card.read_record(k) for k in range(1, n + 1)}
    else:
        card = read.EcVolumeReader(base, READ_SCHEME)       # device=None
        got = {k: card.read_record(k) for k in range(1, n + 1)}
    assert got == want
    assert card.intervals_repaired == cpu.intervals_repaired > 0
    assert _launches() > launches0
    assert rs_native.apply_gf_matrix.calls > calls0


@pytest.mark.cuda
def test_repair_bench_on_the_card(tmp_path):
    _need_card()
    res = repair_bench.run(duration_s=1.0, shard_len=8 << 20,
                           bulk_chunk=4 << 20, scheme=READ_SCHEME,
                           workdir=str(tmp_path))
    assert res["reads"] > 10 and res["bulk_chunks"] >= 4


@pytest.mark.cuda
def test_host_slabs_on_the_card_match_plain(monkeypatch):
    """A list of host slabs of mixed shapes: one below the small-payload
    threshold goes to the host codec, every other slab launches the
    kernel; all byte-equal to the plain versions."""
    _need_card()
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 4096)
    rng = np.random.default_rng(4)
    enc = rs_torch.Encoder(10, 4)
    cpu = rs_torch.Encoder(10, 4, device="cpu")
    shapes = [(2, 10, 65536)] * 3 + [(1, 10, 2048), (3, 10, 65536 + 300),
                                     (1, 10, 1 << 20)] + [(2, 10, 65536)] * 5
    slabs = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    n = _launches()
    outs = enc.encode_parity_host_multi(slabs)
    assert _launches() == n + len(slabs) - 1      # one slab below 4 KiB
    for x, out in zip(slabs, outs):
        assert isinstance(out, np.ndarray) == (x.shape[-1] < 4096)
        np.testing.assert_array_equal(np.asarray(out),
                                      cpu.encode_parity_host(x))


@pytest.mark.cuda
def test_encode_many_on_the_card_matches_the_cpu(monkeypatch):
    _need_card()
    from seaweedfs_tpu_torch.pipeline import batch
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 4096)
    scheme = EcScheme(10, 4, large_block_size=64 * 1024,
                      small_block_size=8 * 1024)
    rng = np.random.default_rng(8)
    payloads = [rng.integers(0, 256, int(rng.integers(1, 900 * 1024)),
                             dtype=np.uint8) for _ in range(9)]
    n = _launches()
    _, got = batch.encode_many(payloads, scheme, 1 << 20, keep_output=True)
    assert _launches() > n
    _, want = batch.encode_many(payloads, scheme, 1 << 20, keep_output=True,
                                device="cpu")
    for mine, ref in zip(got, want):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
