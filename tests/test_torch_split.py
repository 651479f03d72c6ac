"""Rows wider than the batch bound (seaweedfs_tpu_torch/pipeline/batch.py's
column split), on the CPU at a large-row scheme cut small: 655,360 B
large blocks and 131,072 B small ones, volumes of 15,728,640 B (two
large rows, then two whole small rows, no pad), a 4 MiB batch bound. Each
large row splits into a 419,328 B column chunk and a 236,032 B straggler.

The port's shards equal the plain reference's (portbench/reference.py,
NumPy) and the JAX package's; every column chunk of a volume leaves the
batcher before any row of the next volume is packed (the JAX batcher
holds a straggler that does not fill a batch until the call's end); the
file path's shard files equal the JAX package's; the split counters are
exact."""

import hashlib

import numpy as np
import pytest

from portbench import reference
from seaweedfs_tpu.pipeline import batch as jax_batch
from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
from seaweedfs_tpu_torch.pipeline import batch, flight, pipe
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage.superblock import SuperBlock
from seaweedfs_tpu_torch.storage.volume import dat_path
from torch_teardown import collect_jax_garbage  # noqa: F401

LARGE, SMALL, VOLUME = 655_360, 131_072, 15_728_640
SCHEME = EcScheme(10, 4, large_block_size=LARGE, small_block_size=SMALL)
JAX_SCHEME = JaxScheme(10, 4, large_block_size=LARGE,
                       small_block_size=SMALL)
BOUND = 4 * 1024 * 1024
CHUNK = batch.column_width(10, BOUND)
VOLUMES = 5


def _payloads(n=VOLUMES, seed=26):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, VOLUME, dtype=np.uint8) for _ in range(n)]


def _reference_shards(dat: np.ndarray) -> list:
    """Every shard of ``dat`` from the plain reference: its striping and
    its Vandermonde RS(10,4)."""
    lay = reference.Layout(10, LARGE, SMALL, dat.size)
    matrix = reference.code_matrix(10, 14)
    rows = []
    for row in range(lay.rows):
        data = lay.data(dat, row)
        rows.append(np.concatenate([data, reference.apply(matrix[10:],
                                                          data)]))
    return [np.concatenate([r[s] for r in rows]) for s in range(14)]


def test_the_layout_is_two_split_large_rows_then_whole_small_rows():
    lay = reference.Layout(10, LARGE, SMALL, VOLUME)
    assert (lay.large_rows, lay.small_rows) == (2, 2)
    assert not lay.padded(lay.rows - 1)
    assert CHUNK == 419_328 and LARGE - CHUNK == 236_032


def test_encode_many_equals_the_reference_and_jax():
    payloads = _payloads()
    total, shards = batch.encode_many(payloads, SCHEME, BOUND,
                                      keep_output=True, device="cpu")
    _, jshards = jax_batch.encode_many(payloads, JAX_SCHEME, BOUND,
                                       keep_output=True)
    assert total == VOLUMES * 10 * (2 * LARGE + 2 * SMALL)
    for i, dat in enumerate(payloads):
        want = _reference_shards(dat)
        for s in range(14):
            np.testing.assert_array_equal(shards[i][s], want[s],
                                          err_msg=f"volume {i} shard {s}")
            np.testing.assert_array_equal(shards[i][s], jshards[i][s],
                                          err_msg=f"volume {i} shard {s}")


def _buffers(bound=BOUND):
    """A pooled packer's buffer source, poisoned: a byte it does not
    write shows."""
    size = batch.max_packed_bytes(10, bound)
    return lambda: np.full(size, 0xA5, dtype=np.uint8)


def _closes_each_volume(batches) -> bool:
    """Whether the batch holding each volume's last column chunk comes
    before the first batch holding any span of the next volume."""
    last_chunk, first = {}, {}
    for i, (spans, packed) in enumerate(batches):
        for sp in spans:
            first.setdefault(sp.key, i)
            if packed.shape[2] not in (SMALL, LARGE):
                last_chunk[sp.key] = i
    assert sorted(last_chunk) == list(range(VOLUMES))
    return all(last_chunk[v] < first[v + 1] for v in range(VOLUMES - 1))


#: Batch bounds: the CPU cells' 4 MiB, whose 236,032 B straggler fills a
#: batch alone, and one whose 15,616 B straggler a bucket would hold (20
#: to a batch), as the 16,384 B straggler of a 1 GiB block is at 64 MiB.
BOUNDS = {"straggler-fills-a-batch": BOUND, "straggler-held": 3_200_000}


@pytest.mark.parametrize("bound", list(BOUNDS.values()), ids=list(BOUNDS))
@pytest.mark.parametrize("pooled", [False, True], ids=["fresh", "pooled"])
def test_every_chunk_of_a_volume_leaves_before_the_next_volume(pooled,
                                                                bound):
    src = list(enumerate(_payloads()))
    mine = [(spans, np.array(p)) for spans, p in batch.iter_packed_batches(
        iter(src), SCHEME, bound, pipe.PipeStats(),
        _buffers(bound) if pooled else None)]
    assert _closes_each_volume(mine)
    # each chunk a batch of its own, right after the one before it
    cols = batch.column_width(10, bound)
    widths = [p.shape for _, p in mine if p.shape[2] not in (SMALL, LARGE)]
    assert widths == ([(1, 10, cols)] * (LARGE // cols) +
                      [(1, 10, LARGE % cols)]) * (2 * VOLUMES)
    # the JAX batcher holds a straggler that does not fill a batch until
    # the call's end: there the rule fails
    ref = list(jax_batch.iter_packed_batches(iter(src), JAX_SCHEME, bound))
    assert _closes_each_volume(ref) == (bound == BOUND)


@pytest.mark.parametrize("pooled", [False, True], ids=["fresh", "pooled"])
def test_the_split_counters_are_exact(pooled):
    src = list(enumerate(_payloads()))
    st = pipe.PipeStats()
    flight.arm()
    try:
        out = [(spans, p.nbytes, p.shape[2]) for spans, p in
               batch.iter_packed_batches(iter(src), SCHEME, BOUND, st,
                                         _buffers() if pooled else None)]
        flushes = [ev for ev in flight.recorder().snapshot()
                   if ev[1] == flight.EV_SPLIT_FLUSH]
    finally:
        flight.disarm()
        flight.reset()
    chunk_bytes = sum(n for _, n, w in out if w not in (SMALL, LARGE))
    assert chunk_bytes == VOLUMES * 2 * 10 * LARGE
    assert (st.split_rows, st.split_chunks) == (2 * VOLUMES, 4 * VOLUMES)
    assert st.split_pack_bytes == chunk_bytes
    assert 0 < st.split_pack_seconds <= st.pack_seconds
    assert st.split_pack_bytes < st.pack_bytes
    assert 0 < st.split_hold_max_seconds
    assert [ev[5] for ev in flushes] == \
        [n for _, n, w in out if w not in (SMALL, LARGE)]
    d = st.to_dict()
    assert d["split_rows"] == 2 * VOLUMES and \
        d["split_pack_bytes"] == chunk_bytes


def test_rows_within_the_bound_count_no_split():
    src = list(enumerate(_payloads(2)))
    st = pipe.PipeStats()
    list(batch.iter_packed_batches(iter(src), SCHEME, 8 * 1024 * 1024, st))
    assert (st.split_rows, st.split_chunks, st.split_pack_bytes) == (0, 0, 0)
    assert st.split_pack_seconds == st.split_hold_max_seconds == 0.0


def test_encode_volumes_equals_jax_with_held_stragglers(tmp_path):
    """The file path (a collection's ``ec.encode``) at the bound whose
    stragglers the JAX batcher holds: the same shard files."""
    bound = BOUNDS["straggler-held"]
    bases = {"port": [], "jax": []}
    for i, body in enumerate(_payloads(3)):
        for side, group in bases.items():
            base = str(tmp_path / f"{side}{i}")
            with open(dat_path(base), "wb") as f:
                f.write(SuperBlock().to_bytes() + body.tobytes())
            group.append(base)
    st = pipe.PipeStats()
    total = batch.encode_volumes(bases["port"], SCHEME, bound, device="cpu",
                                 stats=st)
    assert total == jax_batch.encode_volumes(bases["jax"], JAX_SCHEME,
                                             bound)
    assert (st.split_rows, st.split_chunks) == (6, 18)

    def sha(base, s):
        with open(ec_files.shard_path(base, s), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    for mine, ref in zip(bases["port"], bases["jax"]):
        assert [sha(mine, s) for s in range(14)] == \
            [sha(ref, s) for s in range(14)]
