"""The port's host stages that can hold the card, on the CPU: the reader's
``pack`` copies (batch._Bucket.flush, stripe._pad_to), the compute
stage's wait on the reader and the group drain's wait — their
``PipeStats`` counters and flight spans — and the ring that a torch
profile of a run arms. Port only: the JAX package records none of them.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.pipeline import batch, flight, pipe
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme

K, SMALL = 10, 8 * 1024
SCHEME = EcScheme(K, 4, large_block_size=64 * 1024, small_block_size=SMALL)
ROW = K * SMALL


@pytest.fixture(autouse=True)
def disarmed():
    flight.disarm()
    flight.reset()
    yield
    flight.disarm()
    flight.reset()


def _packed(sizes, bound, seed=0):
    rng = np.random.default_rng(seed)
    vols = [(i, rng.integers(0, 256, n, dtype=np.uint8))
            for i, n in enumerate(sizes)]
    st = pipe.PipeStats()
    out = list(batch.iter_packed_batches(iter(vols), SCHEME, bound, st))
    return out, st


# --------------------------------------------------------------------------
# pack_bytes: the bytes the reader copied, exactly
# --------------------------------------------------------------------------

def test_a_single_contiguous_span_is_handed_on_and_counts_nothing():
    out, st = _packed([2 * ROW], bound=4 * ROW)
    ((spans, packed),) = out
    assert len(spans) == 1 and packed.shape == (2, K, SMALL)
    assert st.pack_bytes == 0 and st.pack_seconds == 0.0


def test_a_concatenated_batch_counts_its_bytes():
    out, st = _packed([ROW, ROW, ROW], bound=4 * ROW)
    ((spans, packed),) = out
    assert len(spans) == 3 and packed.nbytes == 3 * ROW
    assert st.pack_bytes == 3 * ROW and st.pack_seconds > 0


def test_a_padded_tail_counts_the_pad_copy():
    tail = ROW // 2 + 3
    out, st = _packed([ROW + tail], bound=4 * ROW)
    ((spans, packed),) = out
    # the pad copies the volume's bytes past its whole rows into a fresh
    # array of whole rows; the batch is then one contiguous span
    assert packed.shape == (2, K, SMALL) and len(spans) == 1
    assert st.pack_bytes == ROW + tail


def test_a_column_chunk_of_an_oversized_row_counts_its_copy():
    bound = ROW // 4
    out, st = _packed([ROW], bound=bound)
    assert len(out) > 1 and all(len(s) == 1 for s, _ in out)
    assert st.pack_bytes == sum(p.nbytes for _, p in out) == ROW


# --------------------------------------------------------------------------
# reader_wait and group_wait
# --------------------------------------------------------------------------

def _grouped_run(read_sleep, dispatch_sleep, n=12, group=4):
    def batches():
        for i in range(n):
            time.sleep(read_sleep)
            yield i, np.full(256, i, dtype=np.uint8)

    def multi(bs):
        time.sleep(dispatch_sleep)
        return [b ^ 1 for b in bs]

    st, got = pipe.PipeStats(), []
    pipe.run_pipeline(batches(), lambda b: b ^ 1,
                      lambda meta, b, r: got.append(meta), stats=st,
                      encode_multi_fn=multi, group=group, publish=False)
    assert got == list(range(n)) and st.groups < n
    return st


def test_the_waits_track_a_sleeping_reader():
    sleep, n = 0.02, 12
    st = _grouped_run(sleep, 0.0, n=n)
    assert st.reader_wait_seconds > 0 and st.group_wait_seconds > 0
    # the compute stage waits on the reader in the one place or the other
    # for about the reader's whole sleep, and never longer than the run
    waited = st.reader_wait_seconds + st.group_wait_seconds
    assert 0.7 * n * sleep <= waited <= st.wall_seconds


def test_the_waits_stay_near_zero_with_a_fast_reader():
    st = _grouped_run(0.0, 0.01)
    assert st.reader_wait_seconds < 0.05 and st.group_wait_seconds < 0.05
    assert st.reader_wait_seconds + st.group_wait_seconds < \
        0.25 * st.wall_seconds


# --------------------------------------------------------------------------
# the ring a torch profile arms
# --------------------------------------------------------------------------

def _packed_grouped_run(st):
    rng = np.random.default_rng(7)
    vols = [rng.integers(0, 256, ROW + ROW // 3, dtype=np.uint8)
            for _ in range(2)]

    def sources():
        for i in range(8):
            time.sleep(0.01)
            yield i, vols[i % 2]

    pipe.run_pipeline(
        batch.iter_packed_batches(sources(), SCHEME, 3 * ROW, st),
        lambda b: b, lambda meta, b, r: None, stats=st,
        encode_multi_fn=lambda bs: list(bs), group=4, publish=False)


def test_a_profiled_run_leaves_paired_host_stage_spans_in_the_ring():
    st = pipe.PipeStats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _packed_grouped_run(st)
    assert flight.armed() and flight.recorder().dropped == 0
    names = {s[0] for s in flight.spans()}
    assert {"pack", "reader_wait", "group_wait", "read"} <= names
    for name, t0, t1, _tid, _b in flight.spans():
        assert t1 >= t0, name
    assert st.pack_bytes > 0 and st.pack_seconds > 0
    # the next run no profile records drops the ring
    pipe.run_pipeline([(0, np.zeros(8, dtype=np.uint8))], lambda b: b,
                      lambda meta, b, r: None, publish=False)
    assert not flight.armed()


def test_without_a_profiler_a_disarmed_run_records_nothing():
    st = pipe.PipeStats()
    _packed_grouped_run(st)
    assert not flight.armed() and flight.recorder() is None
    # the counters count all the same
    assert st.pack_bytes > 0 and st.reader_wait_seconds > 0


def test_a_torch_without_the_profiler_attribute_only_loses_the_ring():
    # the attribute is torch's private one: a build that drops it must
    # still seal, with no ring following its profiles. It is taken away
    # inside the profile, whose start sets it and whose end clears it.
    prof = torch.autograd.profiler
    st = pipe.PipeStats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        del prof._is_profiler_enabled
        try:
            _packed_grouped_run(st)
        finally:
            prof._is_profiler_enabled = True
    assert prof._is_profiler_enabled is False
    assert not flight.armed() and flight.recorder() is None
    assert st.batches > 0 and st.pack_bytes > 0
