"""The port's ingest plane (seaweedfs_tpu_torch/pipeline/pipe.py) against
the JAX package's, on the CPU: the same items come out in the same order
with the same stage counts, and a failure in any stage propagates and
hands every pooled buffer back."""

import threading

import numpy as np
import pytest

from seaweedfs_tpu.pipeline import pipe as jax_pipe
from seaweedfs_tpu_torch.pipeline import pipe

WATCHDOG = 60


@pytest.mark.parametrize("overlapped", [True, False],
                         ids=["overlapped", "sync"])
def test_pipeline_order_and_count_equal_jax(overlapped):
    rng = np.random.default_rng(11)
    items = [(i, rng.integers(0, 256, (1, 3, int(rng.integers(1, 64))),
                              dtype=np.uint8)) for i in range(23)]
    out = {}
    for name, mod in (("port", pipe), ("jax", jax_pipe)):
        written = []
        st = mod.PipeStats()
        n = mod.run_pipeline(iter(items), lambda b: b ^ 0x5A,
                             lambda m, b, r: written.append((m, r.copy())),
                             stats=st, overlapped=overlapped)
        out[name] = (n, st.batches, st.bytes_in, st.bytes_out, written)
    n, batches, bytes_in, bytes_out, written = out["port"]
    jn, jbatches, jbytes_in, jbytes_out, jwritten = out["jax"]
    assert n == jn == batches == jbatches == len(items)
    assert bytes_in == jbytes_in == bytes_out == jbytes_out
    assert [m for m, _ in written] == [m for m, _ in jwritten] \
        == list(range(len(items)))
    for (_, r), (_, jr), (_, x) in zip(written, jwritten, items):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(r, x ^ 0x5A)


def test_pipeline_writer_error_propagates():
    def write(meta, batch, result):
        raise RuntimeError("disk full")

    for mod in (pipe, jax_pipe):
        with pytest.raises(mod.PipelineError, match="disk full"):
            mod.run_pipeline(((i, np.array([i])) for i in range(50)),
                             lambda b: b, write)


@pytest.mark.parametrize("stage", ["read", "compute", "write"])
def test_failure_in_any_stage_recycles_every_batch(stage):
    """A failure in any stage hands every buffer back, so a pooled
    reader blocked on acquire() drains out and the run ends."""
    pool = pipe.HostBufferPool(16, 3)

    def batches():
        for i in range(40):
            if stage == "read" and i == 17:
                raise RuntimeError("boom")
            buf = pool.acquire(timeout=WATCHDOG)
            yield buf, buf

    def encode_fn(b):
        if stage == "compute" and encode_fn.calls == 3:
            raise RuntimeError("boom")
        encode_fn.calls += 1
        return np.zeros(1, np.uint8)
    encode_fn.calls = 0

    def write(meta, batch, result):
        write.calls += 1
        if stage == "write" and write.calls == 5:
            raise RuntimeError("boom")
    write.calls = 0

    done = threading.Event()
    err: list = []

    def run():
        try:
            pipe.run_pipeline(batches(), encode_fn, write,
                              recycle_fn=lambda m, b: pool.release(m))
        except pipe.PipelineError as e:
            err.append(e)
        done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WATCHDOG)
    assert done.is_set() and not t.is_alive()
    assert err and "boom" in str(err[0])
    assert pool.in_flight() == 0
