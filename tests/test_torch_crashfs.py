"""The port's crash harness (seaweedfs_tpu_torch/util/crashfs.py) and its
crash points, against the JAX package's, on the CPU.

Mirrors the recorder, append, vacuum and EC-writeback cases of
tests/test_crashfs.py with the port's ``CrashRecorder``: a workload is
recorded, a ``crash#1`` spec fires at a named crash point, and several
legal post-crash disk states (one per replay seed) are recovered with
``Volume.load``. Every acknowledged write must be served byte-identical
and no torn needle served. Where the two packages run the same
workload, the replayed crash states must be the same files (tolerance
0): the port issues the same writes, fsyncs and renames as the
reference."""

import os
from pathlib import Path

import pytest

from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.util import crashfs as jax_crashfs
from seaweedfs_tpu.util import durability as jax_durability
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu_torch.pipeline.encode import encode_volume
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import vacuum as vacuum_mod
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import (Volume,
                                                generate_synthetic_volume)
from seaweedfs_tpu_torch.util import faults
from seaweedfs_tpu_torch.util.crashfs import CrashRecorder, SimulatedCrash
from torch_teardown import collect_jax_garbage  # noqa: F401

SCHEME = EcScheme(data_shards=10, parity_shards=4,
                  large_block_size=2048, small_block_size=256)
REPLAY_SEEDS = range(6)
PKGS = {
    "jax": (jax_volume, jax_vacuum, JaxNeedle, jax_faults,
            jax_crashfs.CrashRecorder, jax_crashfs.SimulatedCrash),
    "port": (port_volume, vacuum_mod, Needle, faults, CrashRecorder,
             SimulatedCrash),
}


@pytest.fixture(autouse=True)
def _pristine_fault_state():
    jax_durability.configure(mode="commit")
    for mod in (faults, jax_faults):
        mod.clear()
    yield
    for mod in (faults, jax_faults):
        mod.clear()
        mod.set_crash_handler(None)


def _needle_data(i: int) -> bytes:
    return bytes((i * 37 + j) % 256 for j in range(90 + 17 * i))


def _tree(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


# -- recorder semantics -----------------------------------------------------


def test_recorder_fsync_is_a_promise_volatile_tail_is_not(tmp_path):
    root = tmp_path / "d"
    root.mkdir()
    rec = CrashRecorder(root)
    with rec:
        with open(root / "f", "wb") as f:
            f.write(b"A" * 512)
            f.flush()
            os.fsync(f.fileno())     # durable from here on
            f.write(b"B" * 512)
            f.write(b"C" * 512)      # volatile tail
    states = set()
    for seed in REPLAY_SEEDS:
        dest = rec.replay(tmp_path / f"r{seed}", seed=seed)
        data = (dest / "f").read_bytes()
        assert data[:512] == b"A" * 512
        assert len(data) <= 1536
        states.add(data)
    assert len(states) > 1           # the seeds explore several states
    rec.cleanup()


def test_recorder_is_exclusive_and_restores_the_os_layer(tmp_path):
    real = (open, os.open, os.pwrite, os.fsync, os.replace, os.unlink)
    rec = CrashRecorder(tmp_path)
    with rec:
        with pytest.raises(RuntimeError, match="already active"):
            CrashRecorder(tmp_path).__enter__()
    assert (open, os.open, os.pwrite, os.fsync, os.replace,
            os.unlink) == real
    with pytest.raises(RuntimeError, match="before recording"):
        CrashRecorder(tmp_path).replay(tmp_path / "x")
    rec.cleanup()


def test_same_workload_same_replays_as_jax(tmp_path):
    """One recorded file workload replays to the same crash states in
    both packages, seed for seed."""
    trees = {}
    for name, (_v, _vac, _n, _f, recorder, _c) in PKGS.items():
        root = tmp_path / name / "d"
        root.mkdir(parents=True)
        rec = recorder(root)
        with rec:
            with open(root / "a", "wb") as f:
                f.write(b"1" * 700)
                f.flush()
                os.fsync(f.fileno())
                f.write(b"2" * 1300)
            fd = os.open(root / "b", os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
            os.pwrite(fd, b"3" * 2000, 0)
            os.close(fd)
            os.replace(root / "b", root / "c")
        trees[name] = [_tree(rec.replay(tmp_path / name / f"r{s}", seed=s))
                       for s in REPLAY_SEEDS]
        rec.cleanup()
    assert trees["port"] == trees["jax"]


# -- append crash points ----------------------------------------------------


@pytest.mark.parametrize("point", ["crash.append.dat", "crash.append.idx"])
def test_append_crash_acked_needles_survive_any_replay(tmp_path, point):
    trees = {}
    for name, (vol_mod, _vac, ndl, flt, recorder, crash) in PKGS.items():
        root = tmp_path / name / "disk"
        root.mkdir(parents=True)
        acked = {}
        inflight = b"\xAB" * 700
        rec = recorder(root)
        with rec:
            # created INSIDE the recording: the volume's fds register
            # with the recorder, so every pwrite/fsync is logged
            vol = vol_mod.Volume(root / "1", 1).create()
            for i in range(1, 13):
                acked[i] = _needle_data(i)
                vol.write_needle(ndl(cookie=0xC0 + i, id=i, data=acked[i],
                                     append_at_ns=i))
            flt.inject(point, "crash#1")
            with pytest.raises(crash):
                vol.write_needle(ndl(cookie=1, id=99, data=inflight,
                                     append_at_ns=99))
        assert rec.crashed and rec.crash_point == point
        vol.close()
        trees[name] = []
        for seed in REPLAY_SEEDS:
            dest = rec.replay(tmp_path / name / f"r{seed}", seed=seed)
            trees[name].append(_tree(dest))
            with Volume(dest / "1", 1).load() as rvol:
                for key, data in acked.items():
                    assert rvol.read_needle(key).data == data
                try:
                    got = rvol.read_needle(99)
                except KeyError:
                    pass
                else:
                    assert got.data == inflight
        rec.cleanup()
    assert trees["port"] == trees["jax"]


# -- vacuum crash points ----------------------------------------------------


@pytest.mark.parametrize("point", ["crash.vacuum.compact",
                                   "crash.vacuum.precommit",
                                   "crash.vacuum.midcommit"])
def test_vacuum_crash_never_loses_or_resurrects(tmp_path, point):
    deleted = (2, 9, 17, 23, 28)
    trees = {}
    for name, (vol_mod, vac, _n, flt, recorder, crash) in PKGS.items():
        root = tmp_path / name / "disk"
        root.mkdir(parents=True)
        base = root / "7"
        vol = vol_mod.generate_synthetic_volume(base, 7, n_needles=30,
                                                avg_size=220, seed=11)
        want = {k: vol.read_needle(k).data for k in range(1, 31)}
        for k in deleted:
            vol.delete_needle(k)
            del want[k]
        vol.sync()
        vol.close()
        rec = recorder(root)
        with rec:
            vol = vol_mod.Volume(base, 7).load()
            flt.inject(point, "crash#1")
            # compact/commit driven directly: vacuum()'s abort path is
            # process cleanup, which a power cut never gets to run
            with pytest.raises(crash):
                state = vac.compact(vol)
                vac.commit_compact(vol, state)
        assert rec.crashed and rec.crash_point == point
        vol.close()
        trees[name] = []
        for seed in REPLAY_SEEDS:
            dest = rec.replay(tmp_path / name / f"r{seed}", seed=seed)
            trees[name].append(_tree(dest))
            with Volume(dest / "7", 7).load() as rvol:
                for key, data in want.items():
                    assert rvol.read_needle(key).data == data
                for k in deleted:
                    with pytest.raises(KeyError):
                        rvol.read_needle(k)
            # recovery consumed or discarded the compact leftovers
            assert not (dest / "7.cpd").exists()
            assert not (dest / "7.cpx").exists()
        rec.cleanup()
    assert trees["port"] == trees["jax"]


def test_vacuum_crash_in_process_then_cleanup_and_reload(tmp_path):
    """vacuum() under a crash handler at midcommit: abort_compact keeps
    the .cpx (the compacted .dat is already live), and the next load
    installs it; every acknowledged needle is served."""
    base = tmp_path / "5"
    vol = generate_synthetic_volume(base, 5, n_needles=20, avg_size=300,
                                    seed=3)
    want = {k: vol.read_needle(k).data for k in range(2, 21, 2)}
    for k in range(1, 21, 2):
        vol.delete_needle(k)

    class Crash(BaseException):
        pass

    def crash(point):
        raise Crash(point)

    faults.set_crash_handler(crash)
    faults.inject("crash.vacuum.midcommit", "crash#1")
    with pytest.raises(Crash):
        vacuum_mod.vacuum(vol)
    assert not vol.vacuum_in_progress
    assert not vacuum_mod.cpd_path(base).exists()
    assert vacuum_mod.cpx_path(base).exists()
    vol.close()
    with Volume(base, 5).load() as v2:
        assert not vacuum_mod.cpx_path(base).exists()
        assert v2.super_block.compact_revision == 1
        for k, data in want.items():
            assert v2.read_needle(k).data == data
        assert len(v2.nm) == len(want)


# -- the EC writeback crash point -------------------------------------------


def test_crash_point_catalog_covers_the_reference_points_on_the_path():
    for point in ("crash.append.dat", "crash.append.idx",
                  "crash.vacuum.compact", "crash.vacuum.precommit",
                  "crash.vacuum.midcommit", "crash.ec.writeback"):
        assert point in faults.CATALOG and point in jax_faults.CATALOG
    # the port's catalog is the JAX one's points in the JAX order
    order = [p for p in jax_faults.CATALOG if p in faults.CATALOG]
    assert order == list(faults.CATALOG)


def _armed_writeback_crash(fired: list):
    class Crash(BaseException):
        pass

    def crash(point):
        fired.append(point)
        raise Crash(point)

    faults.set_crash_handler(crash)
    faults.inject("crash.ec.writeback", "crash#1")
    return Crash


def test_ec_writeback_crash_fires_in_the_port_encode(tmp_path):
    """An armed ``crash.ec.writeback`` with ``set_crash_handler`` fires
    during the port's ``encode_volume``, on the pipeline's writer stage,
    and the run fails instead of ending as if every write had landed: no
    .ecx is written. Several batches, so the stages must drain after
    the crash."""
    base = tmp_path / "9"
    generate_synthetic_volume(base, 9, n_needles=60, avg_size=280,
                              seed=4).close()
    fired = []
    crash = _armed_writeback_crash(fired)
    with pytest.raises(BaseException) as info:
        encode_volume(base, SCHEME, max_batch_bytes=4096, device="cpu")
    cause = info.value
    while not isinstance(cause, crash) and cause.__cause__ is not None:
        cause = cause.__cause__
    assert isinstance(cause, crash)
    assert fired == ["crash.ec.writeback"]
    assert faults.specs()[0]["hits"] == 1
    assert not Path(str(base) + ".ecx").exists()
    faults.clear()
    faults.set_crash_handler(None)
    # the source volume is intact, and a clean encode then succeeds
    with Volume(base, 9).load() as v:
        assert len(v.nm) == 60
    encode_volume(base, SCHEME, max_batch_bytes=4096, device="cpu")
    assert Path(str(base) + ".ecx").exists()


def test_ec_writeback_crash_point_is_on_the_writer_pool_only(tmp_path):
    """As in the JAX package, the crash point sits in
    ``WriterPool.submit``: the synchronous path, which writes inline,
    never crosses it."""
    base = tmp_path / "9"
    generate_synthetic_volume(base, 9, n_needles=20, avg_size=280,
                              seed=4).close()
    fired = []
    _armed_writeback_crash(fired)
    encode_volume(base, SCHEME, device="cpu", overlapped=False)
    assert fired == [] and faults.specs()[0]["hits"] == 0
    assert Path(str(base) + ".ecx").exists()


def test_ec_writeback_crash_leaves_source_volume_intact(tmp_path):
    """The JAX case with the port's recorder: every replayed state of a
    crash at ``crash.ec.writeback`` has no .ecx (partial shards are
    inert) and a source volume that serves every needle."""
    root = tmp_path / "disk"
    root.mkdir()
    base = root / "9"
    vol = generate_synthetic_volume(base, 9, n_needles=60, avg_size=280,
                                    seed=4)
    want = {k: vol.read_needle(k).data for k in range(1, 61)}
    vol.close()
    rec = CrashRecorder(root)
    with rec:
        faults.inject("crash.ec.writeback", "crash#1")
        with pytest.raises(BaseException):
            encode_volume(base, SCHEME, device="cpu")
    assert rec.crashed and rec.crash_point == "crash.ec.writeback"
    for seed in (0, 1, 2):
        dest = rec.replay(tmp_path / f"r{seed}", seed=seed)
        assert not (dest / "9.ecx").exists()
        with Volume(dest / "9", 9).load() as rvol:
            for key, data in want.items():
                assert rvol.read_needle(key).data == data
    rec.cleanup()
