"""The port's many-volume coalescing batcher (seaweedfs_tpu_torch/
pipeline/batch.py) against the JAX package's, on the CPU.

The cases of tests/test_batch.py — its small-block scheme and ragged
payloads (empty, exactly one small row, two large rows plus a tiny tail),
a batch bound below one row, an oversized row that must be column-split,
and volumes that mix large and small rows — and one volume that is a
single contiguous span go through both packages with the same seeded
inputs. Packed batches (fresh, and packed into a buffer source),
in-memory shards and sealed shard files must be byte-equal (an exact
codec: tolerance 0). The port's seals pack into a pool of host buffers:
forced to recycle two buffers under the buffer checker, which poisons a
released buffer, every shard stays exact."""

import dataclasses
import hashlib
import os
import warnings

import numpy as np
import pytest

from seaweedfs_tpu.pipeline import batch as jax_batch
from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
from seaweedfs_tpu_torch.ops import rs_native, rs_torch
from seaweedfs_tpu_torch.pipeline import batch, encode, flight, pipe
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.util import bufcheck
from seaweedfs_tpu_torch.storage.superblock import SuperBlock
from seaweedfs_tpu_torch.storage.volume import dat_path
from torch_teardown import collect_jax_garbage  # noqa: F401

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


def _single(rng):
    # two whole small rows: the one batch is one contiguous span
    return [rng.integers(0, 256, 2 * 8 * 1024 * 10, dtype=np.uint8)]


#: name -> (payload maker, seed, batch bound), as in tests/test_batch.py
CASES = {
    "ragged": (_ragged, 42, 1024 * 1024),
    "tiny-bound": (_tiny, 7, 1),
    "oversized-row": (_oversized, 9, 200 * 1024),
    "mixed-shapes": (_mixed, 13, 4 * 1024 * 1024),
    "single-span": (_single, 5, 4 * 8 * 1024 * 10),
}


def _payloads(case):
    make, seed, bound = CASES[case]
    return make(np.random.default_rng(seed)), bound


#: Cases with a row wider than the bound whose last column chunk is
#: narrower than the others: the port hands it on right after its row
#: (every chunk a batch of its own), the JAX package holds it in a bucket
#: until the call's end and packs it with other volumes' (ROADMAP, faults
#: of the reference), so the batches differ and what each shard range
#: receives is compared instead.
SPLIT_ORDER = {"oversized-row"}


def _spans(spans):
    return [(sp.key, sp.r0, sp.n, sp.offset) for sp in spans]


def _received(batches) -> dict:
    """(key, data shard, shard offset) -> the bytes the batches put
    there, whatever their order."""
    out = {}
    for spans, packed in batches:
        for sp in spans:
            for s in range(packed.shape[1]):
                out[(sp.key, s, sp.offset)] = \
                    packed[sp.r0:sp.r0 + sp.n, s].tobytes()
    return out


def _assert_same_batches(case, mine, ref, spans_equal):
    """In order, batch for batch; in :data:`SPLIT_ORDER`'s cases, the
    same bytes at every (key, shard, offset), and as many in all."""
    assert mine and ref
    if case in SPLIT_ORDER:
        assert sum(p.nbytes for _, p in mine) == \
            sum(p.nbytes for _, p in ref)
        assert _received(mine) == _received(ref)
        return
    assert len(mine) == len(ref)
    for (spans, packed), (jspans, jpacked) in zip(mine, ref):
        assert packed.shape == jpacked.shape
        np.testing.assert_array_equal(packed, jpacked)
        assert spans_equal(spans, jspans, packed.shape[2])


@pytest.mark.parametrize("case", list(CASES))
def test_packed_batches_equal_across_packages(case):
    payloads, bound = _payloads(case)
    src = list(enumerate(payloads))
    mine = list(batch.iter_packed_batches(iter(src), SCHEME, bound))
    ref = list(jax_batch.iter_packed_batches(iter(src), JAX_SCHEME, bound))
    _assert_same_batches(case, mine, ref,
                         lambda a, b, _block: _spans(a) == _spans(b))
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


def _runs(spans, block):
    """(key, r0, n, offset) runs: a span that continues the one before
    it (same volume, next rows, next shard offset) joins it, however a
    packer split the rows."""
    out = []
    for sp in spans:
        if out and out[-1][0] == sp.key and \
                out[-1][1] + out[-1][2] == sp.r0 and \
                out[-1][3] + out[-1][2] * block == sp.offset:
            out[-1][2] += sp.n
        else:
            out.append([sp.key, sp.r0, sp.n, sp.offset])
    return out


def _poisoned_buffers(bound):
    """A buffer source whose buffers hold no zeros and are larger than
    any batch: a byte the packer does not write shows."""
    size = batch.max_packed_bytes(SCHEME.data_shards, bound) + 4096
    return lambda: np.full(size, 0xA5, dtype=np.uint8)


@pytest.mark.parametrize("case", list(CASES))
def test_pooled_batches_equal_across_packages(case):
    """Packed into a buffer source (the pool's way: the padded row's pad
    zeroed in place, no intermediate copy), the batches are the JAX
    package's, and every byte packed is counted as pooled."""
    payloads, bound = _payloads(case)
    src = list(enumerate(payloads))
    st = pipe.PipeStats()
    mine = [(spans, packed.copy()) for spans, packed in
            batch.iter_packed_batches(iter(src), SCHEME, bound, st,
                                      _poisoned_buffers(bound))]
    ref = list(jax_batch.iter_packed_batches(iter(src), JAX_SCHEME, bound))
    _assert_same_batches(case, mine, ref, lambda a, b, block:
                         _runs(a, block) == _runs(b, block))
    assert st.pack_pooled_bytes == st.pack_bytes == \
        sum(p.nbytes for _, p in mine)


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
    # every batch went through the pool: packed once, into a pool buffer
    d = st.to_dict()
    assert d["pack_pooled_bytes"] == d["pack_bytes"] == total
    assert d["pool_wait_seconds"] >= 0.0


def test_iter_packed_batches_without_a_pool_is_unchanged():
    """The fresh-array path (parallel/dryrun.py, bench.py): a volume's
    padded last row is one pack span (``stripe._pad_to``), each batch of
    several parts one more, a single contiguous span a view of its
    source; the shapes are the JAX package's, and nothing is pooled."""
    row = SCHEME.data_shards * SCHEME.small_block_size
    rng = np.random.default_rng(11)
    sizes = [row + row // 2 + 3, 2 * row, row, row]
    src = [(i, rng.integers(0, 256, n, dtype=np.uint8))
           for i, n in enumerate(sizes)]
    single = [(9, rng.integers(0, 256, 2 * row, dtype=np.uint8))]
    st = pipe.PipeStats()
    flight.arm()
    try:
        out = list(batch.iter_packed_batches(iter(src), SCHEME, 4 * row,
                                             st))
        (one,) = batch.iter_packed_batches(iter(single), SCHEME, 4 * row,
                                           st)
        packs = [sp for sp in flight.spans() if sp[0] == "pack"]
    finally:
        flight.disarm()
        flight.reset()
    ref = list(jax_batch.iter_packed_batches(iter(src), JAX_SCHEME,
                                             4 * row))
    assert [p.shape for _, p in out] == [p.shape for _, p in ref] == \
        [(4, 10, SCHEME.small_block_size), (2, 10, SCHEME.small_block_size)]
    for (spans, p), (jspans, jp) in zip(out, ref):
        assert _spans(spans) == _spans(jspans)
        np.testing.assert_array_equal(p, jp)
    # the pad of volume 0, then the two concatenated batches
    assert len(packs) == 3
    assert st.pack_bytes == (row + row // 2 + 3) + 6 * row
    assert np.shares_memory(one[1], single[0][1])
    assert st.pack_pooled_bytes == 0 and st.pool_wait_seconds == 0.0


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



# --------------------------------------------------------------------------
# two pool buffers recycled under the buffer checker
# --------------------------------------------------------------------------

@pytest.fixture
def two_checked_buffers(monkeypatch):
    """``[pipeline] pool_buffers = 2`` and the port's buffer checker armed
    by its variable (each released buffer poisoned, each queued write's
    buffer generation verified around its ``pwritev``); both put back."""
    saved = dataclasses.replace(pipe.current())
    was = bufcheck.enabled()
    monkeypatch.setenv("SEAWEEDFS_TORCH_BUFCHECK", "1")
    assert bufcheck.install_from_env()
    pipe.configure(pool_buffers=2)
    try:
        yield
    finally:
        for f in dataclasses.fields(saved):
            setattr(pipe.current(), f.name, getattr(saved, f.name))
        if not was:
            bufcheck.uninstall()
            bufcheck.reset()


def _volume_files(tmp_path, rng, sizes):
    """The same .dat bodies as port and JAX volumes: (port bases, JAX
    bases)."""
    mine, ref = [], []
    for i, size in enumerate(sizes):
        body = SuperBlock().to_bytes() + \
            rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for group, name in ((mine, f"port{i}"), (ref, f"jax{i}")):
            base = str(tmp_path / name)
            with open(dat_path(base), "wb") as f:
                f.write(body)
            group.append(base)
    return mine, ref


@pytest.mark.parametrize("path", ["encode_many", "encode_volumes"])
def test_recycled_pool_buffers_keep_every_shard_exact(tmp_path, path,
                                                      two_checked_buffers):
    """Two buffers serve every batch, so each is reused many times while
    sinks and queued shard writes may still view the last: a recycle
    before the last reader would put poison into a shard or trip the
    checker. Large rows take the row-view writes behind a batch token,
    small rows the copy path."""
    rng = np.random.default_rng(21)
    # one or two large rows (640 KiB) and a ragged small-row tail each
    sizes = [int(rng.integers(1, 3)) * 64 * 1024 * 10 +
             int(rng.integers(1, 60 * 1024)) for _ in range(12)]
    bound = 64 * 1024 * 10  # one large row, or eight small ones
    st = pipe.PipeStats()
    if path == "encode_many":
        payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
        _, shards = batch.encode_many(payloads, SCHEME, bound,
                                      keep_output=True, device="cpu",
                                      stats=st)
        _, jshards = jax_batch.encode_many(payloads, JAX_SCHEME, bound,
                                           keep_output=True)
        for mine, ref in zip(shards, jshards):
            for a, b in zip(mine, ref):
                np.testing.assert_array_equal(a, b)
    else:
        mine, ref = _volume_files(tmp_path, rng, sizes)
        batch.encode_volumes(mine, SCHEME, max_batch_bytes=bound,
                             device="cpu", stats=st)
        jax_batch.encode_volumes(ref, JAX_SCHEME, max_batch_bytes=bound)
        for base, jbase in zip(mine, ref):
            assert _shard_shas(base) == _shard_shas(jbase), base
    assert st.batches >= 16
    assert st.pack_pooled_bytes == st.pack_bytes == st.bytes_in
    assert bufcheck.stats()["tracked"] >= 2
    assert not bufcheck.violations()
