"""The port's ec.encode / ec.rebuild / ec.decode pipelines
(seaweedfs_tpu_torch/pipeline) against the JAX package's, on the CPU.

Volumes of real needles are made with a seed; .dat sizes span large
rows, small rows and a ragged tail of the small-block geometry
tests/test_mesh_pipeline.py uses. A volume sealed by either package must
be byte-identical (sha256) to the other's, and either package must
rebuild and decode what the other sealed."""

import hashlib
import os

import numpy as np
import pytest

from seaweedfs_tpu.pipeline import decode as jax_decode
from seaweedfs_tpu.pipeline import encode as jax_encode
from seaweedfs_tpu.pipeline import pipe as jax_pipe
from seaweedfs_tpu.pipeline import rebuild as jax_rebuild
from seaweedfs_tpu.pipeline import stripe as jax_stripe
from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.pipeline import decode, encode, pipe, rebuild
from seaweedfs_tpu_torch.pipeline import stripe
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files, idx as idx_mod, volume
from torch_teardown import collect_jax_garbage  # noqa: F401

GEOMETRY = dict(large_block_size=8192, small_block_size=2048)
SCHEME = EcScheme(10, 4, **GEOMETRY)
JAX_SCHEME = JaxScheme(10, 4, **GEOMETRY)
#: below one large row (80 KiB): large rows go in 128-byte column
#: chunks, small rows (20 KiB) two to a batch
BATCH = 48 * 1024
LOST = (2, 7, 11, 13)
#: .dat sizes: two large rows (80 KiB each) + small rows + ragged tail;
#: small rows only
SIZES = (200_000, 50_000)


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _sealed(base) -> dict:
    exts = [ec_files.shard_ext(i) for i in range(SCHEME.total_shards)]
    return {e: _sha(str(base) + e) for e in exts + [".ecx", ".vif"]}


def _volume(tmp_path, name, size, seed=11):
    base = tmp_path / name
    volume.write_synthetic_volume(base, size, avg_size=3000, seed=seed)
    return base


def _jax_seal(base):
    jax_encode.encode_volume(base, JAX_SCHEME, max_batch_bytes=BATCH)


def _port_seal(base, overlapped=True):
    encode.encode_volume(base, SCHEME, max_batch_bytes=BATCH, device="cpu",
                         overlapped=overlapped)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("overlapped", [True, False])
def test_sealed_volumes_identical_across_packages(tmp_path, monkeypatch,
                                                  size, overlapped):
    a = _volume(tmp_path, "port", size)
    b = _volume(tmp_path, "jax", size)
    assert _sha(str(a) + ".dat") == _sha(str(b) + ".dat")
    assert SCHEME.large_rows_count(size) == (2 if size > 160_000 else 0)
    st = pipe.PipeStats()
    encode.encode_volume(a, SCHEME, max_batch_bytes=BATCH, device="cpu",
                         stats=st, overlapped=overlapped)
    monkeypatch.setattr(jax_pipe.current(), "overlapped", overlapped)
    _jax_seal(b)
    assert st.batches > 1
    assert _sealed(a) == _sealed(b)


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_rebuild_what_the_other_package_sealed(tmp_path, sealer):
    base = _volume(tmp_path, "v", SIZES[0])
    (_jax_seal if sealer == "jax" else _port_seal)(base)
    sealed = _sealed(base)
    for i in LOST:
        os.remove(ec_files.shard_path(base, i))
    if sealer == "jax":
        got = rebuild.rebuild_ec_files(base, SCHEME, device="cpu",
                                       chunk_bytes=5000)
    else:
        got = jax_rebuild.rebuild_ec_files(base, JAX_SCHEME,
                                           chunk_bytes=5000)
    assert got == list(LOST)
    assert _sealed(base) == sealed


@pytest.mark.parametrize("sealer,decoder", [("jax", "port"),
                                            ("port", "port"),
                                            ("port", "jax")])
def test_decode_restores_dat_and_idx(tmp_path, sealer, decoder):
    base = _volume(tmp_path, "v", SIZES[0])
    dat = _sha(str(base) + ".dat")
    entries = list(idx_mod.walk_index_file(str(base) + ".idx"))
    (_jax_seal if sealer == "jax" else _port_seal)(base)
    os.remove(str(base) + ".dat")
    os.remove(str(base) + ".idx")
    for i in (0, 5):
        os.remove(ec_files.shard_path(base, i))
    if decoder == "port":
        size = decode.decode_volume(base, SCHEME, device="cpu")
    else:
        size = jax_decode.decode_volume(base, JAX_SCHEME)
    assert size == os.path.getsize(str(base) + ".dat")
    assert _sha(str(base) + ".dat") == dat
    assert list(idx_mod.walk_index_file(str(base) + ".idx")) == entries
    assert decode.find_dat_file_size(base) == os.path.getsize(
        str(base) + ".dat")


@pytest.mark.parametrize("size", SIZES)
def test_data_shards_hold_the_striped_dat(tmp_path, size):
    # the port's stripe copy is the layout oracle for plan_batches
    base = _volume(tmp_path, "v", size)
    _port_seal(base)
    dat = np.fromfile(str(base) + ".dat", np.uint8)
    want = stripe.stripe(dat, SCHEME)
    for s, w in zip(want, jax_stripe.stripe(dat, JAX_SCHEME)):
        np.testing.assert_array_equal(s, w)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(
            np.fromfile(ec_files.shard_path(base, i), np.uint8), w)
    np.testing.assert_array_equal(stripe.unstripe(want, dat.size, SCHEME),
                                  dat)


def test_pread_into_refuses_a_short_file(tmp_path):
    path = tmp_path / "short"
    path.write_bytes(bytes(range(100)))
    buf = np.zeros(64, np.uint8)
    fd = os.open(path, os.O_RDONLY)
    try:
        pipe.pread_into(fd, buf[:32], 50)
        np.testing.assert_array_equal(buf[:32], np.arange(50, 82))
        with pytest.raises(EOFError, match="short read"):
            pipe.pread_into(fd, buf, 50)
    finally:
        os.close(fd)


def test_plan_batches_cover_the_dat():
    size = SIZES[0]
    plans = list(encode.plan_batches(size, SCHEME, 30_000))
    covered = sum(h for p in plans for _, _, _, h in p.segs)
    assert covered == size
    assert all(p.nbytes <= 30_000 or p.shape[0] == 1 for p in plans)


def test_pipeline_failure_recycles_every_buffer():
    pool = pipe.HostBufferPool(16, 2)

    def batches():
        for _ in range(6):
            buf = pool.acquire(timeout=5)
            yield buf, buf.reshape(1, 1, 16)

    def encode_fn(batch):
        if encode_fn.calls == 3:
            raise RuntimeError("boom")
        encode_fn.calls += 1
        return np.zeros((1, 1, 16), np.uint8)

    for overlapped in (True, False):
        encode_fn.calls = 0
        with pytest.raises(pipe.PipelineError, match="boom"):
            pipe.run_pipeline(batches(), encode_fn, lambda m, b, r: None,
                              recycle_fn=lambda m, b: pool.release(m),
                              overlapped=overlapped)
        assert pool.in_flight() == 0


@pytest.mark.parametrize("size,cap", [(1, None), (5000, 5000),
                                      (20_000, 128), (108_003_328, None)])
def test_rebuild_chunks_split_the_shard_evenly(size, cap):
    c = rebuild.chunk_length(size, 10, cap)
    n = -(-size // c)
    assert c % rs_cuda.GRANULE == 0
    assert c <= max(rs_cuda.GRANULE,
                    pipe.current().batch_bytes // 10 if cap is None else cap)
    assert (n - 1) * c < size <= n * c
    # equal shares: the last chunk is short by less than a granule per chunk
    assert size - (n - 1) * c > c - n * rs_cuda.GRANULE


def test_pools_hold_one_buffer_per_batch_at_most(tmp_path, monkeypatch):
    made = []

    class Pool(pipe.HostBufferPool):
        def __init__(self, nbytes, count, pinned=False):
            made.append((nbytes, count))
            super().__init__(nbytes, count, pinned)

    monkeypatch.setattr(pipe, "HostBufferPool", Pool)
    base = _volume(tmp_path, "v", SIZES[1])
    st = pipe.PipeStats()
    encode.encode_volume(base, SCHEME, max_batch_bytes=BATCH, device="cpu",
                         stats=st)
    # 3 small rows of 20 KiB, two to a batch
    assert st.batches == 2 < pipe.pool_buffers(1000)
    assert made == [(2 * 10 * 2048, 2)]
    sealed = _sealed(base)
    for i in LOST:
        os.remove(ec_files.shard_path(base, i))
    assert rebuild.rebuild_ec_files(base, SCHEME, device="cpu") == list(LOST)
    # one chunk holds the whole 6 KiB shard of each of the 10 survivors
    assert made[1] == (10 * 3 * 2048, 1)
    assert _sealed(base) == sealed
