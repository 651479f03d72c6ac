"""The port's ingest plane (seaweedfs_tpu_torch/pipeline/pipe.py) against
the JAX package's, on the CPU: the same items come out in the same order
with the same stage counts, and a failure in any stage propagates and
hands every pooled buffer back."""

import threading

import numpy as np
import pytest

from seaweedfs_tpu.pipeline import pipe as jax_pipe
from seaweedfs_tpu_torch.pipeline import pipe
from torch_teardown import collect_jax_garbage  # noqa: F401

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


# ------------------------------------------------------------------
# the [pipeline] config, the ring of recent runs and the double-buffer
# lookahead — each against the JAX package's tests/test_pipe.py cases,
# in both packages
# ------------------------------------------------------------------

import dataclasses  # noqa: E402

from seaweedfs_tpu.util import config as jax_config  # noqa: E402
from seaweedfs_tpu_torch.ops import rs_torch  # noqa: E402
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from seaweedfs_tpu_torch.pipeline import encode  # noqa: E402
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme  # noqa: E402
from seaweedfs_tpu_torch.storage import ec_files, volume  # noqa: E402
from seaweedfs_tpu_torch.util import config  # noqa: E402

PACKAGES = {"port": (pipe, config), "jax": (jax_pipe, jax_config)}
SCHEME = EcScheme(10, 4, large_block_size=8192, small_block_size=2048)


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


@pytest.fixture
def pipe_config():
    """Both packages' [pipeline] config, ring and the port's mesh config
    restored after the test (the state is process-wide)."""
    saved = {name: dataclasses.replace(mod.current())
             for name, (mod, _c) in PACKAGES.items()}
    yield
    for name, (mod, _c) in PACKAGES.items():
        for f in dataclasses.fields(saved[name]):
            setattr(mod.current(), f.name, getattr(saved[name], f.name))
        mod.reset_telemetry()
    mesh_mod.configure(enabled=False, dp=0, sp=0)


def test_pipeline_config_fields_and_defaults_equal_jax(pipe_config):
    port = dataclasses.asdict(pipe.PipelineConfig())
    assert port == dataclasses.asdict(jax_pipe.PipelineConfig())
    assert len(port) == 11
    assert port["depth"] == 2 and port["batch_bytes"] == 256 << 20
    assert port["writer_threads"] == port["writer_queue_depth"] == 4
    # the only source of these defaults: no module constant remains
    for name in ("DEPTH", "BATCH_BYTES", "POOL_BUFFERS", "WRITER_THREADS",
                 "WRITER_QUEUE_DEPTH"):
        assert not hasattr(pipe, name)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pipeline_config_scaffold_round_trips(pipe_config, pkg):
    mod, cfg_mod = PACKAGES[pkg]
    conf = cfg_mod._parse_toml_subset(cfg_mod.scaffold("pipeline"))
    mod.configure_from(conf)
    cfg = mod.current()
    assert cfg.depth == 2
    assert cfg.batch_bytes == 256 * 1024 * 1024
    assert cfg.grouped_batch_bytes == 64 * 1024 * 1024
    assert cfg.writer_threads == 4 and cfg.writer_queue_depth == 4
    assert cfg.feedback and cfg.overlapped and cfg.preallocate
    assert cfg.double_buffer is False


@pytest.mark.parametrize("pkg", PACKAGES)
def test_configure_from_applies_partial_section(pipe_config, pkg):
    mod = PACKAGES[pkg][0]
    mod.configure_from({"pipeline": {"depth": 7, "overlapped": False,
                                     "group_cap": 3}})
    cfg = mod.current()
    assert cfg.depth == 7 and cfg.overlapped is False
    assert cfg.group_cap == 3
    assert cfg.batch_bytes == 256 * 1024 * 1024  # untouched keys keep
    mod.configure_from({})  # no [pipeline] section: a no-op
    assert mod.current().depth == 7


@pytest.mark.parametrize("pkg", PACKAGES)
def test_configure_rejects_unknown_keys(pipe_config, pkg):
    with pytest.raises(TypeError, match="unknown pipeline config"):
        PACKAGES[pkg][0].configure(qdepth=3)


def test_configure_from_refuses_an_unknown_toml_key(pipe_config):
    """The port refuses an unknown [pipeline] key in a file; the JAX
    package drops it silently."""
    conf = {"pipeline": {"depth": 3, "qdepth": 9}}
    with pytest.raises(TypeError, match="unknown pipeline config key "
                                        "'qdepth'"):
        pipe.configure_from(conf)
    jax_pipe.configure_from(conf)
    assert jax_pipe.current().depth == 3


def test_pool_buffers_rule(pipe_config):
    assert pipe.pool_buffers(100) == 4           # depth 2 + 2
    assert pipe.pool_buffers(100, lookahead=True) == 5
    assert pipe.pool_buffers(3) == 3             # never more than batches
    assert pipe.pool_buffers(0) == 1
    pipe.configure(pool_buffers=1)
    assert pipe.pool_buffers(100) == 1
    # the lookahead holds one batch until the next is read: never 1
    assert pipe.pool_buffers(100, lookahead=True) == 2


# -- the lookahead in run_pipeline ----------------------------------------


@pytest.mark.parametrize("double_buffer", [True, False])
def test_lookahead_results_equal_jax_and_sync(pipe_config, double_buffer):
    """prepare_fn + encode_fn with and without the one-deep lookahead, in
    both packages: the same results in the same order as the sync
    path."""
    rng = np.random.default_rng(5)
    items = [(i, rng.integers(0, 256, (2, 3, 64), dtype=np.uint8))
             for i in range(17)]
    seen = {}
    for name, (mod, _c) in PACKAGES.items():
        mod.configure(double_buffer=double_buffer)
        for overlapped in (True, False):
            got = []
            _guarded(lambda: mod.run_pipeline(
                iter(items), lambda p: p[1] ^ p[0],
                lambda m, b, r: got.append((m, r.copy())),
                prepare_fn=lambda b: (0x3C, b.copy()),
                overlapped=overlapped, publish=False))
            seen[(name, overlapped)] = got
    want = [(i, x ^ 0x3C) for i, x in items]
    for got in seen.values():
        assert [m for m, _ in got] == list(range(17))
        for (_, r), (_, w) in zip(got, want):
            np.testing.assert_array_equal(r, w)


def test_lookahead_never_recycles_a_buffer_a_prepared_batch_reads(
        pipe_config):
    """The double-buffer lookahead on the CPU through a 1 x 1 mesh, whose
    prepare passes the pooled batch as it is: a recycle hook that
    overwrites each returned buffer must leave every result equal to the
    sync path's."""
    mesh = mesh_mod.make_mesh(mesh_mod.local_devices("cpu"), dp=1, sp=1)
    enc = rs_torch.Encoder(10, 4, device="cpu")
    prep, apply = mesh_mod.encode_step_fns(enc, mesh)
    rng = np.random.default_rng(9)
    srcs = [rng.integers(0, 256, (2, 10, 1024), dtype=np.uint8)
            for _ in range(12)]
    pipe.configure(double_buffer=True)
    results = {}
    for overlapped in (True, False):
        pool = pipe.HostBufferPool(srcs[0].nbytes,
                                   pipe.pool_buffers(len(srcs),
                                                     lookahead=True))
        got = []

        def batches():
            for i, s in enumerate(srcs):
                buf = pool.acquire(timeout=WATCHDOG)
                view = buf.reshape(s.shape)
                view[...] = s
                yield (i, buf), view

        def recycle(meta, _batch):
            meta[1][:] = 0xEE          # scribble, then hand back
            pool.release(meta[1])

        _guarded(lambda: pipe.run_pipeline(
            batches(), apply,
            lambda m, b, r: got.append((m[0], np.array(r))),
            recycle_fn=recycle, prepare_fn=prep, overlapped=overlapped,
            publish=False))
        assert pool.in_flight() == 0
        results[overlapped] = got
    assert [m for m, _ in results[True]] == list(range(len(srcs)))
    for (_, a), (_, b), s in zip(results[True], results[False], srcs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, rs_torch.apply_matrix(enc.parity_coefs, s, "cpu").numpy())


# -- the ring of recent runs ----------------------------------------------


#: PipeStats.to_dict's keys the JAX package has not, at a fresh run's 0.
HOST_STAGE_KEYS = {"pack_seconds": 0.0, "pack_bytes": 0,
                   "reader_wait_seconds": 0.0, "group_wait_seconds": 0.0,
                   "pack_pooled_bytes": 0, "pool_wait_seconds": 0.0,
                   "split_rows": 0, "split_chunks": 0, "split_pack_bytes": 0,
                   "split_pack_seconds": 0.0,
                   "split_hold_max_seconds": 0.0}


def test_stats_publish_and_debug_payload_equal_jax(pipe_config):
    """The JAX case, then the same stats folded into both rings give the
    same totals and entries."""
    for mod, _c in PACKAGES.values():
        mod.reset_telemetry()
    st = pipe.PipeStats()
    _guarded(lambda: pipe.run_pipeline(
        ((i, np.zeros(1024, dtype=np.uint8)) for i in range(4)),
        lambda b: b, lambda m, b, r: None, stats=st, kind="test.pipe"))
    assert st.batches == 4 and st.bytes_in == 4 * 1024
    assert st.stage_seconds().keys() == {"read", "compute", "write",
                                         "wall"}
    pay = pipe.debug_payload()
    assert pay["runs"] == 1 and pay["batches"] == 4
    assert pay["recent"][-1]["kind"] == "test.pipe"
    last = pipe.last_run()
    assert last is not None and last["bytes_in"] == 4 * 1024
    # the same stats in both packages' rings: equal payloads
    pipe.reset_telemetry()
    for i in range(10):
        fields = dict(batches=i + 1, groups=i + 1, max_group=1,
                      bytes_in=1000 * i, bytes_out=400 * i,
                      read_seconds=0.5 * i, dispatch_seconds=0.25,
                      sync_seconds=0.125 * i, write_seconds=0.75,
                      wall_seconds=1.0 + i)
        for mod, _c in PACKAGES.values():
            mod.publish_stats(mod.PipeStats(**fields), kind=f"k{i}")
    # the port's entries are the JAX ones plus exactly its host-stage
    # counters, at 0 here; the totals are equal
    port, ref = pipe.debug_payload(), jax_pipe.debug_payload()
    assert len(port["recent"]) == len(ref["recent"]) == 8
    for mine, theirs in zip(port.pop("recent"), ref.pop("recent")):
        assert {k: v for k, v in mine.items() if k in theirs} == theirs
        assert {k: mine[k] for k in mine if k not in theirs} == \
            HOST_STAGE_KEYS
    assert port == ref
    assert len(pipe.RECENT) == 8 == pipe.RECENT.maxlen
    mine, theirs = pipe.last_run(), jax_pipe.last_run()
    assert mine == dict(theirs, **HOST_STAGE_KEYS)
    assert pipe.last_run()["kind"] == "k9"
    pipe.reset_telemetry()
    assert pipe.last_run() is None and pipe.debug_payload()["runs"] == 0


def test_failed_run_publishes_nothing(pipe_config):
    """Port-only rule: a failed run leaves the totals and the ring as
    they were (the JAX package folds its partial stats in)."""
    def write(meta, batch, result):
        if meta == 3:
            raise RuntimeError("disk full")

    for name, (mod, _c) in PACKAGES.items():
        mod.reset_telemetry()
        with pytest.raises(mod.PipelineError, match="disk full"):
            _guarded(lambda: mod.run_pipeline(
                ((i, np.zeros(16, np.uint8)) for i in range(8)),
                lambda b: b, write, kind="failing"))
    assert pipe.debug_payload()["runs"] == 0 and pipe.last_run() is None
    assert jax_pipe.debug_payload()["runs"] == 1


# -- the grouped-dispatch fields on the CPU -------------------------------


def _dat(tmp_path, name):
    base = tmp_path / name
    volume.write_synthetic_volume(base, 200_000, avg_size=3000, seed=4)
    return base


def _shards(base):
    return [ec_files.shard_path(base, i).read_bytes()
            for i in range(SCHEME.total_shards)]


GROUPING = {"group_cap": 4, "grouped_batch_bytes": 24 * 1024,
            "feedback": False}


def test_grouping_fields_leave_the_encode_plans_alone(tmp_path,
                                                      pipe_config):
    """On the CPU the grouping policy gives group 1 in both packages, as
    the JAX package's does off its device path: a [pipeline] section
    that sets the three grouping fields loads, and the overlapped encode
    makes one dispatch per planned batch at the full batch bound,
    publishes them to the ring, and writes the sync path's bytes, the
    same in both packages."""
    from seaweedfs_tpu.pipeline import encode as jax_encode
    from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
    jax_scheme = JaxScheme(10, 4, large_block_size=8192,
                           small_block_size=2048)
    assert rs_torch.host_dispatch_group("cpu") == 1
    for mod in (pipe, jax_pipe):
        mod.configure_from({"pipeline": GROUPING})
    grouped, plain = _dat(tmp_path, "g"), _dat(tmp_path, "s")
    twin = _dat(tmp_path, "j")
    dat_size = (tmp_path / "g.dat").stat().st_size
    plans = list(encode.plan_batches(dat_size, SCHEME, 48 * 1024))
    for mod, write in ((pipe, lambda st: encode.write_ec_files(
            grouped, SCHEME, 48 * 1024, stats=st, device="cpu")),
                       (jax_pipe, lambda st: jax_encode.write_ec_files(
            twin, jax_scheme, 48 * 1024, stats=st))):
        st = mod.PipeStats()
        write(st)
        assert st.batches == st.groups == len(plans) > 1
        assert st.max_group == 1
        assert mod.last_run()["kind"] == "ec.encode"
        assert mod.last_run()["groups"] == len(plans)
    encode.write_ec_files(plain, SCHEME, 24 * 1024, overlapped=False,
                          device="cpu")
    assert _shards(grouped) == _shards(plain) == _shards(twin)


def test_grouping_fields_leave_the_rebuild_chunks_alone(tmp_path,
                                                        pipe_config):
    """On the CPU the same fields leave a rebuild's chunks at
    ``[pipeline] batch_bytes`` over the survivors, one dispatch each, in
    both packages (the JAX package's default chunk is its own 64 MiB,
    one chunk here, so its count is held against that)."""
    from seaweedfs_tpu.pipeline import rebuild as jax_rebuild
    from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
    from seaweedfs_tpu_torch.pipeline import rebuild
    jax_scheme = JaxScheme(10, 4, large_block_size=8192,
                           small_block_size=2048)
    base = _dat(tmp_path, "r")
    encode.write_ec_files(base, SCHEME, 48 * 1024, device="cpu")
    sealed = _shards(base)
    for mod in (pipe, jax_pipe):
        mod.configure(batch_bytes=40 * 1024, **GROUPING)
    size = ec_files.shard_path(base, 0).stat().st_size
    chunks = -(-size // rebuild.chunk_length(size, SCHEME.data_shards))
    for mod, rebuild_fn in (
            (pipe, lambda: rebuild.rebuild_ec_files(base, SCHEME,
                                                    device="cpu")),
            (jax_pipe, lambda: jax_rebuild.rebuild_ec_files(
                base, jax_scheme))):
        for i in (1, 12):
            ec_files.shard_path(base, i).unlink()
        assert rebuild_fn() == [1, 12]
        run = mod.last_run()
        assert run["kind"] == "ec.rebuild"
        assert run["batches"] == run["groups"] == (
            chunks if mod is pipe else -(-size // (64 << 20)))
        assert run["max_group"] == 1
        assert _shards(base) == sealed
    assert chunks > 1
