"""The port's many-volume coalescing batcher (seaweedfs_tpu_torch/
pipeline/batch.py) against the JAX package's, on the CPU.

The cases of tests/test_batch.py — its small-block scheme and ragged
payloads (empty, exactly one small row, two large rows plus a tiny tail),
a batch bound below one row, an oversized row that must be column-split,
and volumes that mix large and small rows — go through both packages
with the same seeded inputs. Packed batches, in-memory shards and sealed
shard files must be byte-equal (an exact codec: tolerance 0)."""

import hashlib
import os
import warnings

import numpy as np
import pytest

from seaweedfs_tpu.pipeline import batch as jax_batch
from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
from seaweedfs_tpu_torch.ops import rs_native, rs_torch
from seaweedfs_tpu_torch.pipeline import batch, encode, pipe
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage.superblock import SuperBlock
from seaweedfs_tpu_torch.storage.volume import dat_path

# Small blocks so multi-row striping happens at test sizes.
GEOMETRY = dict(large_block_size=64 * 1024, small_block_size=8 * 1024)
SCHEME = EcScheme(10, 4, **GEOMETRY)
JAX_SCHEME = JaxScheme(10, 4, **GEOMETRY)


def _ragged(rng):
    # Deliberately ragged sizes: tail padding, sub-row volumes, empties.
    sizes = [int(rng.integers(1, 300 * 1024)) for _ in range(12)]
    sizes[0] = 0
    sizes[1] = 8 * 1024 * 10          # exactly one small row
    sizes[2] = 64 * 1024 * 10 * 2 + 5  # two large rows + tiny tail
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in sizes]


def _tiny(rng):
    return [rng.integers(0, 256, 90 * 1024, dtype=np.uint8)
            for _ in range(3)]


def _oversized(rng):
    # per_row = 10 * 64 KiB = 640 KiB > the 200 KiB bound: column chunks
    return [rng.integers(0, 256, 64 * 1024 * 10 + 777, dtype=np.uint8)
            for _ in range(2)]


def _mixed(rng):
    # each volume: 1 large row (640 KiB) + small tail rows
    return [rng.integers(0, 256, 64 * 1024 * 10 + 20 * 1024,
                         dtype=np.uint8) for _ in range(6)]


#: name -> (payload maker, seed, batch bound), as in tests/test_batch.py
CASES = {
    "ragged": (_ragged, 42, 1024 * 1024),
    "tiny-bound": (_tiny, 7, 1),
    "oversized-row": (_oversized, 9, 200 * 1024),
    "mixed-shapes": (_mixed, 13, 4 * 1024 * 1024),
}


def _payloads(case):
    make, seed, bound = CASES[case]
    return make(np.random.default_rng(seed)), bound


def _spans(spans):
    return [(sp.key, sp.r0, sp.n, sp.offset) for sp in spans]


@pytest.mark.parametrize("case", list(CASES))
def test_packed_batches_equal_across_packages(case):
    payloads, bound = _payloads(case)
    src = list(enumerate(payloads))
    mine = list(batch.iter_packed_batches(iter(src), SCHEME, bound))
    ref = list(jax_batch.iter_packed_batches(iter(src), JAX_SCHEME, bound))
    assert len(mine) == len(ref) > 0
    for (spans, packed), (jspans, jpacked) in zip(mine, ref):
        assert _spans(spans) == _spans(jspans)
        assert packed.shape == jpacked.shape
        np.testing.assert_array_equal(packed, jpacked)
    if case == "oversized-row":
        # one row exceeds the bound: column-split, and the bound held
        assert all(p.size <= 210 * 1024 for _, p in mine)
        assert any(p.shape[2] not in (SCHEME.small_block_size,
                                      SCHEME.large_block_size)
                   for _, p in mine)
    if case == "mixed-shapes":
        # small-row batches mix keys from several volumes
        assert any(len({sp.key for sp in spans}) > 1
                   for spans, p in mine
                   if p.shape[2] == SCHEME.small_block_size)


@pytest.mark.parametrize("case", list(CASES))
def test_encode_many_equals_jax(case):
    payloads, bound = _payloads(case)
    st = pipe.PipeStats()
    total, shards = batch.encode_many(payloads, SCHEME, bound,
                                      keep_output=True, device="cpu",
                                      stats=st)
    jtotal, jshards = jax_batch.encode_many(payloads, JAX_SCHEME, bound,
                                            keep_output=True)
    assert total == jtotal == sum(
        SCHEME.shard_file_size(p.size) * SCHEME.data_shards
        for p in payloads)
    for i in range(len(payloads)):
        for s in range(SCHEME.total_shards):
            np.testing.assert_array_equal(shards[i][s], jshards[i][s],
                                          err_msg=f"volume {i} shard {s}")
    assert st.batches > 0 and st.bytes_in == total


def test_encode_many_on_the_plain_versions(monkeypatch):
    """The ragged case with the small-payload rule turned down, so every
    product takes the kernels' plain versions, not the host codec."""
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 0)
    payloads, bound = _payloads("ragged")
    calls = rs_native.apply_gf_matrix.calls
    _, shards = batch.encode_many(payloads, SCHEME, bound,
                                  keep_output=True, device="cpu")
    assert rs_native.apply_gf_matrix.calls == calls
    _, jshards = jax_batch.encode_many(payloads, JAX_SCHEME, bound,
                                       keep_output=True)
    for mine, ref in zip(shards, jshards):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _shard_shas(base):
    return [_sha(ec_files.shard_path(base, s))
            for s in range(SCHEME.total_shards)]


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
def test_encode_volumes_equals_jax_and_write_ec_files(tmp_path,
                                                      monkeypatch, plain):
    if plain:
        monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 0)
    rng = np.random.default_rng(3)
    mine, ref = [], []
    for i in range(6):
        size = int(rng.integers(1, 400 * 1024))
        body = SuperBlock().to_bytes() + \
            rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for group, name in ((mine, f"port{i}"), (ref, f"jax{i}")):
            base = str(tmp_path / name)
            with open(dat_path(base), "wb") as f:
                f.write(body)
            group.append(base)
    with warnings.catch_warnings():
        # batches that view a .dat must reach torch writable
        warnings.simplefilter("error")
        total = batch.encode_volumes(mine, SCHEME,
                                     max_batch_bytes=256 * 1024,
                                     device="cpu")
    jtotal = jax_batch.encode_volumes(ref, JAX_SCHEME,
                                      max_batch_bytes=256 * 1024)
    assert total == jtotal > 0
    for base, jbase in zip(mine, ref):
        got = _shard_shas(base)
        assert got == _shard_shas(jbase), base
        for s in range(SCHEME.total_shards):
            os.remove(ec_files.shard_path(base, s))
        encode.write_ec_files(base, SCHEME, device="cpu")
        assert _shard_shas(base) == got, base

