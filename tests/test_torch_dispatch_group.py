"""Grouped dispatch in the port against the JAX package's, on the CPU.

The port's ``rs_torch.apply_matrix_host_multi`` (one kernel call over a
run of equal-shaped slabs), ``pipe.GroupController``,
``pipe.pick_grouped_dispatch`` and the group drain of
``pipe.run_pipeline``, with their callers (encode, rebuild and the
batcher), go case for case through the cases of the JAX package's
tests/test_dispatch_group.py, the grouping cases of tests/test_pipe.py
and tests/test_mesh_pipeline.py::test_prepare_fn_rejected_with_grouping.
The JAX side runs under its own ``forced_pallas`` fixture (the words
kernels in interpret mode); the port's runs on ``device="cpu"``, where a
run is one call of the kernels' plain version over the run's staging
tensor, with ``rs_torch.host_dispatch_group`` monkeypatched to the JAX
tests' cap where a pipeline must group. Slabs come from numpy seeds;
outputs are GF(2^8) bytes, held byte-equal (tolerance 0) to the JAX
package's and to ``rs_ref``."""

import dataclasses
import hashlib
import shutil
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_jax, rs_pallas
from seaweedfs_tpu.ops import rs_native as jax_native
from seaweedfs_tpu.pipeline import pipe as jax_pipe
from seaweedfs_tpu_torch.ops import rs_cuda, rs_native, rs_ref, rs_torch
from seaweedfs_tpu_torch.pipeline import pipe
from torch_runs import dispatched, expected_runs, plan_shapes
from torch_teardown import collect_jax_garbage  # noqa: F401

#: The JAX tests' slab length: one Pallas segment (128 KiB), which is
#: also the port's DEVICE_MIN_S, so such a slab takes the kernel path.
SEG = rs_pallas.SEG_BYTES
#: The JAX tests' pinned group width for the pipelines.
CAP = 4
WATCHDOG = 60


@pytest.fixture()
def forced_pallas(monkeypatch):
    """tests/test_dispatch_group.py's fixture: the JAX package's words
    kernels in interpret mode, link pinned to the device."""
    monkeypatch.setattr(rs_jax, "_use_pallas", lambda: True)
    monkeypatch.setattr(rs_jax, "PALLAS_MIN_S", 1024)
    monkeypatch.setattr(rs_jax, "HOST_DISPATCH", "device")
    monkeypatch.setattr(rs_jax, "PALLAS_KERNEL", "transpose")
    real_w = rs_pallas.apply_gf_matrix_words
    monkeypatch.setattr(
        rs_pallas, "apply_gf_matrix_words",
        lambda c, x, **kw: real_w(c, x, interpret=True))
    rs_jax._jitted_apply.cache_clear()
    rs_jax._jitted_apply_multi.cache_clear()
    yield
    rs_jax._jitted_apply.cache_clear()
    rs_jax._jitted_apply_multi.cache_clear()


@pytest.fixture()
def calls(monkeypatch):
    """The batch of every ``rs_cuda.apply_gf_matrix`` call the port's
    host path makes: one entry per run."""
    seen: list[int] = []
    real = rs_cuda.apply_gf_matrix

    def spy(coefs, x):
        seen.append(x.shape[0])
        return real(coefs, x)

    monkeypatch.setattr(rs_cuda, "apply_gf_matrix", spy)
    monkeypatch.delenv("SEAWEEDFS_TORCH_DISPATCH_GROUP", raising=False)
    return seen


@pytest.fixture()
def slow_link(monkeypatch):
    """Both packages' probes pinned to a link slower than the host
    codec, and the port's product bound for the card (the link rule
    applies there only; every slab then stays on the host, so nothing
    touches a card)."""
    if not (rs_native.available() and jax_native.available()):
        pytest.skip("native codec unavailable")
    monkeypatch.setattr(rs_jax, "HOST_DISPATCH", "auto")
    monkeypatch.setenv("SEAWEEDFS_TORCH_HOST_DISPATCH", "auto")
    for mod in (rs_jax, rs_torch):
        monkeypatch.setattr(mod, "_link_gibps", 0.02)
        monkeypatch.setattr(mod, "_native_gibps", 2.0)
    monkeypatch.setattr(rs_torch, "resolve_device",
                        lambda device=None: torch.device("cuda"))


def _oracle(k, m, x):
    ref = rs_ref.ReferenceEncoder(k, m)
    return np.stack([ref.encode_parity(xb) for xb in x])


def _slabs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]


# --------------------------------------------------------------------------
# apply_matrix_host_multi (tests/test_dispatch_group.py)
# --------------------------------------------------------------------------

def test_multi_groups_are_byte_exact(forced_pallas, calls):
    k, m = 4, 2
    batches = _slabs(1, [(1, k, SEG)] * 5)
    jax_outs = rs_jax.Encoder(k, m).encode_parity_host_multi(batches)
    outs = rs_torch.Encoder(k, m, device="cpu") \
        .encode_parity_host_multi(batches)
    assert len(outs) == len(jax_outs) == 5
    for x, out, jout in zip(batches, outs, jax_outs):
        assert isinstance(jout, rs_jax._HostParity)
        np.testing.assert_array_equal(np.asarray(out), _oracle(k, m, x))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(jout))
    assert rs_jax._jitted_apply_multi.cache_info().misses >= 1
    # one call over all five slabs, not five single calls
    assert calls == [5]


def test_multi_respects_group_cap(forced_pallas, calls, monkeypatch):
    monkeypatch.setattr(rs_jax, "DISPATCH_GROUP", "2")
    monkeypatch.setenv("SEAWEEDFS_TORCH_DISPATCH_GROUP", "2")
    k, m = 4, 2
    batches = _slabs(2, [(1, k, SEG)] * 3)
    jax_outs = rs_jax.Encoder(k, m).encode_parity_host_multi(batches)
    outs = rs_torch.Encoder(k, m, device="cpu") \
        .encode_parity_host_multi(batches)
    for x, out, jout in zip(batches, outs, jax_outs):
        np.testing.assert_array_equal(np.asarray(out), _oracle(k, m, x))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(jout))
    assert rs_jax._jitted_apply_multi.cache_info().misses == 1
    # 3 slabs at cap 2: one run of 2, then the lone slab
    assert calls == [2, 1]


def test_multi_mixed_shapes_and_ineligible(forced_pallas, calls,
                                           monkeypatch):
    """A shape change flushes the run; a slab below the port's
    small-payload threshold (the JAX package's non-conforming slab) goes
    to the host codec; every result is still byte-exact and in order."""
    if not rs_native.available():
        pytest.skip("native codec unavailable")
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 4096)
    k, m = 4, 2
    rng = np.random.default_rng(3)
    big = [rng.integers(0, 256, (1, k, 2 * SEG), dtype=np.uint8)
           for _ in range(2)]
    small = [rng.integers(0, 256, (1, k, SEG), dtype=np.uint8)
             for _ in range(2)]
    odd = rng.integers(0, 256, (1, k, 2048), dtype=np.uint8)
    batches = [big[0], big[1], odd, small[0], small[1]]
    jax_outs = rs_jax.Encoder(k, m).encode_parity_host_multi(batches)
    native = rs_native.apply_gf_matrix.calls
    outs = rs_torch.Encoder(k, m, device="cpu") \
        .encode_parity_host_multi(batches)
    for x, out, jout in zip(batches, outs, jax_outs):
        np.testing.assert_array_equal(np.asarray(out), _oracle(k, m, x))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(jout))
    assert not isinstance(jax_outs[2], rs_jax._HostParity)
    # the odd slab took the host codec, between two runs of two
    assert rs_native.apply_gf_matrix.calls == native + 1
    assert calls == [2, 2]


def test_multi_stays_host_side_on_slow_link(forced_pallas, slow_link,
                                            calls):
    k, m = 4, 2
    batches = _slabs(4, [(1, k, SEG)] * 3)
    jax_outs = rs_jax.Encoder(k, m).encode_parity_host_multi(batches)
    outs = rs_torch.Encoder(k, m).encode_parity_host_multi(batches)
    for x, out, jout in zip(batches, outs, jax_outs):
        assert isinstance(out, np.ndarray) and isinstance(jout, np.ndarray)
        np.testing.assert_array_equal(out, _oracle(k, m, x))
        np.testing.assert_array_equal(out, jout)
    assert calls == []


def test_nonconforming_slab_stays_native_on_slow_link(forced_pallas,
                                                      slow_link, calls):
    """A slab of a ragged S that the JAX package's word form rejects
    stays on the host on a slow link, single and grouped, in both."""
    k, m = 4, 2
    x = _slabs(6, [(1, k, SEG + 1024)])[0]
    enc, jenc = rs_torch.Encoder(k, m), rs_jax.Encoder(k, m)
    out, jout = enc.encode_parity_host(x), jenc.encode_parity_host(x)
    assert isinstance(out, np.ndarray) and isinstance(jout, np.ndarray)
    np.testing.assert_array_equal(out, _oracle(k, m, x))
    np.testing.assert_array_equal(out, jout)
    for o, jo in zip(enc.encode_parity_host_multi([x, x]),
                     jenc.encode_parity_host_multi([x, x])):
        assert isinstance(o, np.ndarray) and isinstance(jo, np.ndarray)
        np.testing.assert_array_equal(o, _oracle(k, m, x))
        np.testing.assert_array_equal(o, jo)
    assert calls == []


def test_reconstruct_multi_byte_exact(forced_pallas, calls):
    k, m = 4, 2
    rng = np.random.default_rng(5)
    ref = rs_ref.ReferenceEncoder(k, m)
    chunks, wants = [], []
    present = [0, 2, 3, 4]  # lost shards 1 (data) and 5 (parity)
    for _ in range(3):
        x = rng.integers(0, 256, (1, k, SEG), dtype=np.uint8)
        full = np.concatenate([x[0], ref.encode_parity(x[0])])
        chunks.append(np.ascontiguousarray(full[present])[None])
        wants.append(full)
    jax_outs = rs_jax.Encoder(k, m).reconstruct_batch_host_multi(
        chunks, present, [1, 5])
    outs = rs_torch.Encoder(k, m, device="cpu") \
        .reconstruct_batch_host_multi(chunks, present, [1, 5])
    for out, jout, full in zip(outs, jax_outs, wants):
        got = np.asarray(out)
        np.testing.assert_array_equal(got[0, 0], full[1])
        np.testing.assert_array_equal(got[0, 1], full[5])
        np.testing.assert_array_equal(got, np.asarray(jout))
    assert calls == [3]


def test_dispatch_group_env_validation(monkeypatch):
    for value in ("banana", "0"):
        monkeypatch.setattr(rs_jax, "DISPATCH_GROUP", value)
        monkeypatch.setenv("SEAWEEDFS_TORCH_DISPATCH_GROUP", value)
        with pytest.raises(ValueError, match="SEAWEEDFS_TPU_DISPATCH_GROUP"):
            rs_jax._dispatch_group()
        with pytest.raises(ValueError,
                           match="SEAWEEDFS_TORCH_DISPATCH_GROUP"):
            rs_torch._dispatch_group()
        # a bad value surfaces from the grouped product itself
        with pytest.raises(ValueError,
                           match="SEAWEEDFS_TORCH_DISPATCH_GROUP"):
            rs_torch.Encoder(4, 2, device="cpu").encode_parity_host_multi(
                _slabs(7, [(1, 4, SEG)]))
    monkeypatch.setattr(rs_jax, "DISPATCH_GROUP", "4")
    monkeypatch.setenv("SEAWEEDFS_TORCH_DISPATCH_GROUP", "4")
    assert rs_jax._dispatch_group() == rs_torch._dispatch_group() == 4
    monkeypatch.delenv("SEAWEEDFS_TORCH_DISPATCH_GROUP")
    assert rs_torch._dispatch_group() == 16   # the JAX package's default


def test_rebuild_grouped_chunks_stay_granule_aligned(forced_pallas, calls,
                                                     monkeypatch, tmp_path):
    """tests/test_dispatch_group.py::test_rebuild_grouped_chunks_stay_
    seg_aligned in both packages: an unaligned ``chunk_bytes`` request
    rebuilds byte-identically, every chunk but the last is a whole number
    of the port's kernel granules (the JAX package's: of its Pallas
    segment), and the grouped dispatch engages."""
    from seaweedfs_tpu.pipeline import encode as jax_encode
    from seaweedfs_tpu.pipeline import rebuild as jax_rebuild
    from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
    from seaweedfs_tpu.storage import ec_files as jax_ec_files
    from seaweedfs_tpu.storage.volume import generate_synthetic_volume
    from seaweedfs_tpu_torch.pipeline import rebuild
    from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
    from seaweedfs_tpu_torch.storage import ec_files

    monkeypatch.setattr(rs_jax, "host_dispatch_group", lambda: CAP)
    monkeypatch.setattr(rs_torch, "host_dispatch_group",
                        lambda device=None: CAP)
    geometry = dict(data_shards=4, parity_shards=2, large_block_size=SEG,
                    small_block_size=SEG)
    scheme, jax_scheme = EcScheme(**geometry), JaxScheme(**geometry)
    jbase = tmp_path / "jax" / "9"
    jbase.parent.mkdir()
    vol = generate_synthetic_volume(jbase, 9, n_needles=700, avg_size=4000,
                                    seed=9)
    vol.close()
    jax_encode.encode_volume(jbase, jax_scheme, max_batch_bytes=4 * SEG)
    want = jax_ec_files.shard_path(jbase, 0).read_bytes()
    jax_ec_files.shard_path(jbase, 0).unlink()
    shutil.copytree(jbase.parent, tmp_path / "port")

    before = rs_jax._jitted_apply_multi.cache_info()
    assert jax_rebuild.rebuild_ec_files(jbase, jax_scheme,
                                        chunk_bytes=SEG + 1000) == [0]
    assert jax_ec_files.shard_path(jbase, 0).read_bytes() == want
    after = rs_jax._jitted_apply_multi.cache_info()
    assert (after.misses + after.hits) > (before.misses + before.hits)

    base = tmp_path / "port" / "9"
    takes: list[int] = []
    real = rs_torch.Encoder.reconstruct_batch_host_multi

    def spy(self, chunks, present, wanted=None):
        takes.extend(c.shape[-1] for c in chunks)
        return real(self, chunks, present, wanted)

    monkeypatch.setattr(rs_torch.Encoder, "reconstruct_batch_host_multi",
                        spy)
    st = pipe.PipeStats()
    with pipe.recording_steps() as steps:
        assert rebuild.rebuild_ec_files(base, scheme,
                                        chunk_bytes=SEG + 1000,
                                        device="cpu", stats=st) == [0]
    assert ec_files.shard_path(base, 0).read_bytes() == want
    assert len(takes) == st.batches > 1 and st.max_group > 1
    assert all(t % rs_cuda.GRANULE == 0 for t in takes[:-1])
    assert len(set(takes[:-1])) == 1
    # one kernel call per stretch of equal shapes in a dispatch step
    assert len(dispatched(steps)) == st.batches
    assert len(calls) == expected_runs(steps) < st.batches


# --------------------------------------------------------------------------
# the group drain (tests/test_dispatch_group.py, tests/test_pipe.py)
# --------------------------------------------------------------------------

def _guarded(fn):
    """Run ``fn`` on a thread under the watchdog: a deadlocked pipeline
    fails the test instead of hanging the suite."""
    box: dict = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(WATCHDOG)
    assert not t.is_alive(), "pipeline hung (watchdog expired)"
    if "error" in box:
        raise box["error"]
    return box["value"]


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_pipeline_groups_preserve_order_and_count(mod):
    n_items, cap = 23, 4
    seen_groups: list[int] = []

    def multi(batches):
        seen_groups.append(len(batches))
        return [b * 2 for b in batches]

    written: list[tuple[int, int]] = []
    items = [(i, np.array([i], dtype=np.int64)) for i in range(n_items)]
    st = mod.PipeStats()
    n = _guarded(lambda: mod.run_pipeline(
        iter(items), lambda b: b * 2,
        lambda meta, batch, result: written.append((meta, int(result[0]))),
        encode_multi_fn=multi, group=cap, stats=st))
    assert n == n_items
    assert [m for m, _ in written] == list(range(n_items))
    assert all(v == 2 * m for m, v in written)
    assert sum(seen_groups) == n_items and max(seen_groups) <= cap
    assert st.groups == len(seen_groups)
    assert st.max_group == max(seen_groups)


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_pipeline_group_one_keeps_single_path(mod):
    multi_calls: list[str] = []

    def multi(batches):  # pragma: no cover - must not run
        multi_calls.append("multi")
        return batches

    out: list[int] = []
    n = _guarded(lambda: mod.run_pipeline(
        ((i, np.array([i])) for i in range(5)), lambda b: b + 1,
        lambda m, b, r: out.append(int(r[0])),
        encode_multi_fn=multi, group=1))
    assert n == 5 and not multi_calls and out == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_pipeline_group_writer_error_propagates(mod):
    def write(meta, batch, result):
        raise RuntimeError("disk full")

    with pytest.raises(mod.PipelineError, match="disk full"):
        _guarded(lambda: mod.run_pipeline(
            ((i, np.array([i])) for i in range(50)), lambda b: b, write,
            encode_multi_fn=lambda bs: list(bs), group=4))


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_writer_sees_batches_in_fifo_order_with_groups(mod):
    order = []

    def multi(bs):
        return [b * 2 for b in bs]

    def batches():
        for i in range(40):
            yield i, np.full(4, i, dtype=np.uint8)

    n = _guarded(lambda: mod.run_pipeline(
        batches(), lambda b: b * 2,
        lambda meta, b, r: order.append((meta, int(r[0]))),
        encode_multi_fn=multi, group=5))
    assert n == 40
    assert order == [(i, (2 * i) % 256) for i in range(40)]


def test_group_failure_recycles_every_batch():
    """Port rule: a grouped dispatch that raises hands every batch of its
    group back, so a pooled reader drains out, and publishes nothing."""
    pool = pipe.HostBufferPool(16, 6)

    def batches():
        for _ in range(40):
            buf = pool.acquire(timeout=WATCHDOG)
            yield buf, buf

    def multi(bs):
        multi.calls += 1
        if multi.calls == 3:
            raise RuntimeError("launch failed")
        return [np.zeros(1, np.uint8) for _ in bs]
    multi.calls = 0

    with pytest.raises(pipe.PipelineError, match="launch failed"):
        _guarded(lambda: pipe.run_pipeline(
            batches(), lambda b: b, lambda m, b, r: None,
            recycle_fn=lambda m, b: pool.release(m), encode_multi_fn=multi,
            group=4, publish=False))
    assert pool.in_flight() == 0


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_prepare_fn_rejected_with_grouping(mod):
    with pytest.raises(ValueError, match="prepare_fn"):
        mod.run_pipeline(iter([]), lambda b: b, lambda *a: None,
                         encode_multi_fn=lambda bs: bs, group=4,
                         prepare_fn=lambda b: b, publish=False)


# --------------------------------------------------------------------------
# GroupController (tests/test_pipe.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_group_controller_widens_under_fixed_dispatch_floor(mod):
    c = mod.GroupController(cap=16)
    for _ in range(40):
        w = c.target()
        c.note_read(0.0001)
        c.note_supplied()
        c.note_dispatch(0.008 + 0.0001 * w, w)
    assert c.target() == 16


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_group_controller_backs_off_when_wider_is_worse(mod):
    c = mod.GroupController(cap=16)
    for _ in range(6):
        w = c.target()
        c.note_supplied()
        c.note_dispatch(0.001 * w * w, w)
    assert c.target() < 16


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_group_controller_halves_on_reader_starvation(mod):
    c = mod.GroupController(cap=16)
    c.width = 16
    for _ in range(20):
        c.note_starved()
    assert c.target() == 1


@pytest.mark.parametrize("mod", [pipe, jax_pipe], ids=["port", "jax"])
def test_group_controller_wait_is_bounded(mod):
    c = mod.GroupController(cap=8)
    c.note_read(10.0)
    assert 0 < c.wait_seconds() <= mod.GroupController.WAIT_CAP
    c.width = 1
    assert c.wait_seconds() == 0.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_group_controller_widths_equal_jax(seed):
    """The same seeded sequence of notes gives the same target and wait
    after every note in both packages."""
    assert (pipe.GroupController.WAIT_CAP, pipe.GroupController.ALPHA,
            pipe.GroupController.WORSE) == (
        jax_pipe.GroupController.WAIT_CAP, jax_pipe.GroupController.ALPHA,
        jax_pipe.GroupController.WORSE)
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 33))
    port, ref = pipe.GroupController(cap), jax_pipe.GroupController(cap)
    for _ in range(300):
        op, v = int(rng.integers(0, 4)), float(rng.random())
        for c in (port, ref):
            if op == 0:
                c.note_read(v * 0.1)
            elif op == 1:
                w = c.target()
                c.note_dispatch(0.002 * w + v * 0.01, w)
            elif op == 2:
                c.note_starved()
            else:
                c.note_supplied()
        assert port.target() == ref.target()
        assert port.wait_seconds() == ref.wait_seconds()


# --------------------------------------------------------------------------
# the policy (tests/test_pipe.py::test_group_cap_clamps_grouped_dispatch)
# --------------------------------------------------------------------------

@pytest.fixture
def pipe_config():
    """Both packages' [pipeline] config restored after the test."""
    saved = [(mod, dataclasses.replace(mod.current()))
             for mod in (pipe, jax_pipe)]
    yield
    for mod, cfg in saved:
        for f in dataclasses.fields(cfg):
            setattr(mod.current(), f.name, getattr(cfg, f.name))


def test_group_cap_clamps_grouped_dispatch(pipe_config, monkeypatch):
    monkeypatch.setattr(rs_jax, "host_dispatch_group", lambda: 16)
    monkeypatch.setattr(rs_torch, "host_dispatch_group",
                        lambda device=None: 16)
    for mod in (pipe, jax_pipe):
        mod.configure(group_cap=4)
        multi, group, nbytes = mod.pick_grouped_dispatch(
            lambda bs: bs, 256 * 1024 * 1024)
        assert multi is not None and group == 4
        assert nbytes == mod.current().grouped_batch_bytes == 64 << 20
        mod.configure(group_cap=1)
        assert mod.pick_grouped_dispatch(lambda bs: bs, 1 << 28) == \
            (None, 1, 1 << 28)


def test_host_dispatch_group_policy(monkeypatch):
    """1 on the CPU (as the JAX package's 1 off its device path), 1
    where a mesh splits the batches, else the env's width."""
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
    assert rs_torch.host_dispatch_group("cpu") == 1
    assert pipe.pick_grouped_dispatch(lambda bs: bs, 1 << 28,
                                      device="cpu") == (None, 1, 1 << 28)
    monkeypatch.setattr(rs_torch, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setenv("SEAWEEDFS_TORCH_DISPATCH_GROUP", "8")
    monkeypatch.setattr(mesh_mod, "routing_mesh", lambda device=None: None)
    assert rs_torch.host_dispatch_group() == 8
    monkeypatch.setattr(mesh_mod, "routing_mesh",
                        lambda device=None: mesh_mod.AUTO)
    assert rs_torch.host_dispatch_group() == 1


def test_the_sync_path_keeps_its_batch_bound(pipe_config, monkeypatch):
    """The synchronous path dispatches one batch at a time, so the policy
    neither groups it nor clamps its bound, whether it is asked for or
    configured."""
    monkeypatch.setattr(rs_torch, "host_dispatch_group",
                        lambda device=None: 16)
    assert pipe.pick_grouped_dispatch(lambda bs: bs, 1 << 28,
                                      overlapped=False) == (None, 1, 1 << 28)
    pipe.configure(overlapped=False)
    assert pipe.pick_grouped_dispatch(lambda bs: bs, 1 << 28) == \
        (None, 1, 1 << 28)
    assert pipe.pick_grouped_dispatch(lambda bs: bs, 1 << 28,
                                      overlapped=True)[1:] == (16, 64 << 20)


def _run_shapes(shapes, **kw) -> pipe.PipeStats:
    st = pipe.PipeStats()
    pipe.run_pipeline(((None, np.zeros(s, np.uint8)) for s in shapes),
                      lambda b: b, lambda *a: None, stats=st,
                      publish=False, **kw)
    return st


def test_recording_steps_per_thread_and_process_wide(pipe_config):
    """A record opened with ``this_thread`` keeps the steps its own
    thread dispatches, an open one every thread's, and neither keeps a
    step once its block has closed."""
    with pipe.recording_steps() as every, \
            pipe.recording_steps(this_thread=True) as mine:
        _run_shapes([(1, 2, 8), (2, 2, 8)], overlapped=False)
        t = threading.Thread(target=_run_shapes, args=([(3, 2, 8)],),
                             kwargs={"overlapped": False})
        t.start()
        t.join(WATCHDOG)
    _run_shapes([(4, 2, 8)], overlapped=False)
    assert mine == [((1, 2, 8),), ((2, 2, 8),)]
    assert every == mine + [((3, 2, 8),)]


@pytest.mark.parametrize("feedback", [False, True])
def test_recorded_steps_are_the_drain_groups(pipe_config, feedback):
    """On the group drain each recorded step is one ``encode_multi_fn``
    call's batches, in order: the steps hold every batch once, and as
    many steps as the run counted groups."""
    pipe.configure(feedback=feedback)
    shapes = [(1, 2, 8)] * 5 + [(2, 2, 8)] * 3 + [(1, 2, 8)] * 4
    widths: list[int] = []

    def multi(bs):
        widths.append(len(bs))
        return list(bs)

    with pipe.recording_steps() as steps:
        st = _run_shapes(shapes, overlapped=True, encode_multi_fn=multi,
                         group=CAP)
    assert dispatched(steps) == shapes and st.batches == len(shapes)
    assert [len(s) for s in steps] == widths and st.groups == len(steps)
    assert max(widths) == st.max_group <= CAP


def test_oversized_run_raises_and_never_splits():
    """A run past the kernels' task bound is refused with ValueError;
    a group of 16 batches of 64 MiB is far inside it."""
    with pytest.raises(ValueError, match="tasks of 1 KiB"):
        rs_cuda.check_launch_size(16 * (1 << 20), 1 << 20)
    # 16 x (6 rows of 10 x 1 MiB blocks): the default grouped encode
    rs_cuda.check_launch_size(16 * 6, 1 << 20)
    # 16 x one 64 MiB column chunk per shard row
    rs_cuda.check_launch_size(16, 64 << 20)


# --------------------------------------------------------------------------
# the three callers: grouped against ungrouped, in both packages
# --------------------------------------------------------------------------

def _digest(paths) -> list:
    return [hashlib.sha256(p.read_bytes()).hexdigest() for p in paths]


@pytest.fixture
def grouped(pipe_config, monkeypatch):
    """Grouping forced in both packages' pipelines (the policy pinned to
    the JAX tests' cap), small grouped batches, greedy drain off, and
    the port's small-payload threshold below these slabs, so every slab
    takes the kernel path (as ``forced_pallas`` lowers the JAX one)."""
    monkeypatch.setattr(rs_jax, "host_dispatch_group", lambda: CAP)
    monkeypatch.setattr(rs_torch, "host_dispatch_group",
                        lambda device=None: CAP)
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 1024)
    for mod in (pipe, jax_pipe):
        mod.configure(grouped_batch_bytes=48 * 1024)


GEOMETRY = dict(data_shards=10, parity_shards=4, large_block_size=8192,
                small_block_size=2048)


def test_grouped_encode_equals_ungrouped_in_both(grouped, calls, tmp_path):
    from seaweedfs_tpu.pipeline import encode as jax_encode
    from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
    from seaweedfs_tpu_torch.pipeline import encode
    from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
    from seaweedfs_tpu_torch.storage import ec_files, volume

    scheme, jax_scheme = EcScheme(**GEOMETRY), JaxScheme(**GEOMETRY)
    digests = {}
    for name in ("port", "port-sync", "jax", "jax-sync"):
        base = tmp_path / name
        volume.write_synthetic_volume(base, 400_000, avg_size=3000, seed=4)
        st = pipe.PipeStats() if name.startswith("port") \
            else jax_pipe.PipeStats()
        overlapped = not name.endswith("sync")
        c0 = len(calls)
        with pipe.recording_steps() as steps:
            if name.startswith("port"):
                encode.write_ec_files(base, scheme, stats=st,
                                      overlapped=overlapped, device="cpu")
            else:
                jax_encode.write_ec_files(base, jax_scheme, stats=st,
                                          overlapped=overlapped)
        digests[name] = _digest(ec_files.shard_path(base, i)
                                for i in range(scheme.total_shards))
        if name == "port":
            # grouped: batches at the grouped bound, one kernel call
            # per stretch of equal shapes in a dispatch step
            assert dispatched(steps) == plan_shapes(encode.plan_batches(
                (tmp_path / "port.dat").stat().st_size, scheme, 48 * 1024))
            assert st.max_group > 1 and st.groups == len(steps) < st.batches
            assert len(calls) - c0 == expected_runs(steps) < st.batches
        if name == "port-sync":
            # ungrouped: the sync path keeps [pipeline] batch_bytes
            assert dispatched(steps) == plan_shapes(encode.plan_batches(
                (tmp_path / "port-sync.dat").stat().st_size, scheme,
                pipe.current().batch_bytes))
            assert len(calls) - c0 == len(steps) == st.batches
        if name == "jax":
            assert st.max_group > 1
        if name.endswith("sync"):
            assert st.max_group == 1 and st.groups == st.batches
    assert len(set(tuple(d) for d in digests.values())) == 1


def test_grouped_rebuild_equals_ungrouped_in_both(grouped, calls,
                                                 tmp_path):
    from seaweedfs_tpu.pipeline import rebuild as jax_rebuild
    from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
    from seaweedfs_tpu_torch.pipeline import encode, rebuild
    from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
    from seaweedfs_tpu_torch.storage import ec_files, volume

    scheme, jax_scheme = EcScheme(**GEOMETRY), JaxScheme(**GEOMETRY)
    base = tmp_path / "r"
    volume.write_synthetic_volume(base, 400_000, avg_size=3000, seed=5)
    pipe.configure(group_cap=1)
    encode.write_ec_files(base, scheme, device="cpu")
    pipe.configure(group_cap=0)
    paths = [ec_files.shard_path(base, i)
             for i in range(scheme.total_shards)]
    sealed = _digest(paths)
    for name in ("port", "jax"):
        for i in (1, 12):
            paths[i].unlink()
        if name == "port":
            st = pipe.PipeStats()
            c0 = len(calls)
            with pipe.recording_steps() as steps:
                assert rebuild.rebuild_ec_files(
                    base, scheme, chunk_bytes=4096, device="cpu",
                    stats=st) == [1, 12]
            assert st.max_group > 1 and len(dispatched(steps)) == st.batches
            assert len(calls) - c0 == expected_runs(steps) < st.batches
        else:
            assert jax_rebuild.rebuild_ec_files(
                base, jax_scheme, chunk_bytes=4096) == [1, 12]
        assert _digest(paths) == sealed


def test_grouped_encode_packed_equals_ungrouped_in_both(grouped, calls):
    from seaweedfs_tpu.pipeline import batch as jax_batch
    from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
    from seaweedfs_tpu_torch.pipeline import batch
    from seaweedfs_tpu_torch.pipeline.scheme import EcScheme

    scheme, jax_scheme = EcScheme(**GEOMETRY), JaxScheme(**GEOMETRY)
    rng = np.random.default_rng(8)
    payloads = [rng.integers(0, 256, int(rng.integers(1, 120_000)),
                             dtype=np.uint8) for _ in range(24)]
    out = {}
    st = pipe.PipeStats()
    with pipe.recording_steps() as steps:
        out["port"] = batch.encode_many(payloads, scheme, keep_output=True,
                                        device="cpu", stats=st)
    assert st.max_group > 1 and len(dispatched(steps)) == st.batches
    assert len(calls) == expected_runs(steps) < st.batches
    out["jax"] = jax_batch.encode_many(payloads, jax_scheme,
                                       keep_output=True)
    pipe.configure(group_cap=1)
    out["ungrouped"] = batch.encode_many(payloads, scheme, keep_output=True,
                                         device="cpu")
    totals = {name: total for name, (total, _) in out.items()}
    assert len(set(totals.values())) == 1
    for name in ("jax", "ungrouped"):
        for vol, want in zip(out["port"][1], out[name][1]):
            for s, w in zip(vol, want):
                np.testing.assert_array_equal(s, w)
