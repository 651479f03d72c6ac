"""The port's compaction (seaweedfs_tpu_torch/storage/vacuum.py) against
the JAX package's, on the CPU.

One JAX-written volume, with deletes, overwrites, and writes and deletes
that land between ``compact`` and ``commit_compact``, is copied twice:
JAX vacuums one copy and the port the other, for each needle map kind.
The compacted ``.dat`` and ``.idx`` must be byte-equal (tolerance 0), and
each package must load and read the other's. Then the cases of
tests/test_vacuum.py and all five of tests/test_vacuum_races.py, run on
the port."""

import os
import shutil
import sqlite3
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import store as port_store
from seaweedfs_tpu_torch.storage import vacuum as vacuum_mod
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.idx import IndexEntry
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import (Volume, VolumeError,
                                                dat_path,
                                                generate_synthetic_volume,
                                                idx_path)
from torch_teardown import collect_jax_garbage  # noqa: F401

PKGS = {"jax": (jax_volume, jax_vacuum, jax_needle, jax_store),
        "port": (port_volume, vacuum_mod, port_needle, port_store)}
MAPS = ["memory", "native", "sqlite"]


def _fill(base, n=40, seed=0):
    vol = generate_synthetic_volume(base, 1, n_needles=n, seed=seed)
    payloads = {i: vol.read_needle(i).data for i in range(1, n + 1)}
    return vol, payloads


def _seed_volume(d) -> dict:
    """A JAX-written volume of 60 needles, 20 deleted and 10 overwritten
    (the old records become garbage too); returns key -> data."""
    rng = np.random.default_rng(4)
    want = {}
    with jax_volume.Volume(d / "7", 7).create() as v:
        for i in range(1, 61):
            data = rng.integers(0, 256, int(rng.integers(50, 900)),
                                dtype=np.uint8).tobytes()
            v.write_needle(jax_needle.Needle(cookie=i, id=i, data=data,
                                             append_at_ns=i))
            want[i] = data
        for i in range(2, 61, 3):
            v.delete_needle(i)
            del want[i]
        for i in range(1, 30, 3):
            data = bytes([i]) * (100 + i)
            v.write_needle(jax_needle.Needle(cookie=i, id=i, data=data,
                                             append_at_ns=100 + i))
            want[i] = data
    return want


def _files(base) -> dict:
    return {ext: Path(str(base) + ext).read_bytes()
            for ext in (".dat", ".idx")}


@pytest.mark.parametrize("kind", MAPS)
def test_vacuum_is_byte_equal_to_jax_and_cross_loads(tmp_path, kind):
    seed = tmp_path / "seed"
    seed.mkdir()
    want = _seed_volume(seed)
    out, ratios = {}, {}
    for name, (vol_mod, vac, ndl, _st) in PKGS.items():
        d = tmp_path / name
        shutil.copytree(seed, d)
        vol = vol_mod.Volume(d / "7", 7, needle_map=kind).load()
        ratios[name] = vac.garbage_ratio(vol)
        state = vac.compact(vol)
        # post-snapshot activity: the makeupDiff replay carries it over
        vol.write_needle(ndl.Needle(cookie=9, id=500, data=b"late" * 40,
                                    append_at_ns=500))
        vol.delete_needle(4)
        vol.write_needle(ndl.Needle(cookie=9, id=7, data=b"re" * 70,
                                    append_at_ns=501))
        size = vac.commit_compact(vol, state)
        assert size == vol.dat_size
        assert vol.super_block.compact_revision == 1
        assert not vol.vacuum_in_progress
        # what the replayed diff deleted or overwrote stays garbage
        after = vac.garbage_ratio(vol)
        vol.close()
        out[name] = _files(d / "7")
        ratios[name] = (ratios[name], after)
    assert ratios["port"] == ratios["jax"]
    assert ratios["port"][0] > 0.3 > ratios["port"][1] > 0
    assert out["port"] == out["jax"]
    want.update({500: b"late" * 40, 7: b"re" * 70})
    del want[4]
    # each package loads and reads the other's compacted volume
    for reader, writer in (("jax", "port"), ("port", "jax")):
        vol_mod = PKGS[reader][0]
        with vol_mod.Volume(tmp_path / writer / "7", 7,
                            needle_map=kind).load() as v:
            assert v.super_block.compact_revision == 1
            assert {e.key for e in v.nm.live_entries()} == set(want)
            for key, data in want.items():
                assert v.read_needle(key).data == data
            for key in (2, 4, 59):
                with pytest.raises(KeyError):
                    v.read_needle(key)


@pytest.mark.parametrize("kind", MAPS)
def test_shell_of_each_package_vacuums_alike(tmp_path, kind):
    """Store(needle_map=kind).vacuum_volume in both packages: equal
    sizes and files; a second vacuum below threshold is a no-op."""
    seed = tmp_path / "seed"
    seed.mkdir()
    _seed_volume(seed)
    out = {}
    for name, (_vol, _vac, _ndl, st_mod) in PKGS.items():
        d = tmp_path / name
        shutil.copytree(seed, d)
        st = st_mod.Store([d], needle_map=kind)
        st.load_existing()
        try:
            ratio = st.garbage_ratio(7)
            size = st.vacuum_volume(7, threshold=0.3)
            again = st.vacuum_volume(7, threshold=0.3)
            out[name] = (ratio, size, again, st.garbage_ratio(7),
                         st.status()["volumes"][0]["file_count"])
        finally:
            st.close()
        out[name] += tuple(_files(d / "7").values())
    assert out["port"] == out["jax"]
    assert out["port"][1] is not None and out["port"][2] is None


# -- the JAX tests/test_vacuum.py cases, on the port ------------------------


@pytest.mark.parametrize("backend", ["disk", "mmap"])
def test_vacuum_on_each_backend(tmp_path, backend):
    """Compaction on each ``.dat`` backend, with a write and a delete
    between the snapshot and the commit: the files equal the JAX
    package's on the same backend, and the volume keeps its backend
    kind across the swap and serves reads at once."""
    seed = tmp_path / "seed"
    seed.mkdir()
    want = _seed_volume(seed)
    out = {}
    for name, (vol_mod, vac, ndl, _st) in PKGS.items():
        d = tmp_path / name
        shutil.copytree(seed, d)
        vol = vol_mod.Volume(d / "7", 7, backend=backend).load()
        state = vac.compact(vol)
        vol.write_needle(ndl.Needle(cookie=9, id=500, data=b"late" * 40,
                                    append_at_ns=500))
        vol.delete_needle(4)
        vac.commit_compact(vol, state)
        assert vol.backend_kind == backend
        assert type(vol._dat).__name__ == \
            ("MmapFile" if backend == "mmap" else "DiskFile")
        assert vol.read_needle(500).data == b"late" * 40
        for key in (1, 58):
            assert vol.read_needle(key).data == want[key]
        vol.close()
        out[name] = _files(d / "7")
    assert out["port"] == out["jax"]


def test_vacuum_reclaims_space_and_preserves_reads(tmp_path):
    base = str(tmp_path / "1")
    vol, payloads = _fill(base)
    before = vol.dat_size
    deleted = list(range(1, 41, 2))  # every odd needle
    for k in deleted:
        assert vol.delete_needle(k)
    assert vacuum_mod.garbage_ratio(vol) > 0.3
    new_size = vacuum_mod.vacuum(vol, threshold=0.3)
    assert new_size is not None and new_size < before
    assert vol.super_block.compact_revision == 1
    assert vacuum_mod.garbage_ratio(vol) == 0.0
    for k, data in payloads.items():
        if k in deleted:
            with pytest.raises(KeyError):
                vol.read_needle(k)
        else:
            assert vol.read_needle(k).data == data
    assert idx_path(base).stat().st_size == 16 * 20   # tombstones gone
    vol.close()
    v2 = Volume(base, 1).load()
    assert v2.super_block.compact_revision == 1
    for k in range(2, 41, 2):
        assert v2.read_needle(k).data == payloads[k]
    v2.close()


def test_vacuum_below_threshold_is_noop(tmp_path):
    vol, _ = _fill(str(tmp_path / "1"), n=20)
    vol.delete_needle(1)
    assert vacuum_mod.vacuum(vol, threshold=0.9) is None
    assert vol.super_block.compact_revision == 0
    vol.close()


def test_crash_before_commit_leaves_volume_intact(tmp_path):
    base = str(tmp_path / "1")
    vol, payloads = _fill(base, n=10)
    vol.delete_needle(1)
    vacuum_mod.compact(vol)  # state dropped = crash before commit
    vol.close()
    assert vacuum_mod.cpd_path(base).exists()
    v2 = Volume(base, 1).load()  # load cleans leftovers
    assert not vacuum_mod.cpd_path(base).exists()
    assert not vacuum_mod.cpx_path(base).exists()
    for k in range(2, 11):
        assert v2.read_needle(k).data == payloads[k]
    v2.close()


def test_torn_commit_between_renames_recovers(tmp_path):
    """Crash AFTER .cpd->.dat but BEFORE .cpx->.idx: load must finish
    the commit (the .cpx is the only index matching the new .dat)."""
    base = str(tmp_path / "1")
    vol, payloads = _fill(base, n=20)
    for k in range(1, 11):
        vol.delete_needle(k)
    vacuum_mod.compact(vol)
    vol.close()
    os.replace(vacuum_mod.cpd_path(base), dat_path(base))
    v2 = Volume(base, 1).load()
    assert not vacuum_mod.cpx_path(base).exists()
    assert v2.super_block.compact_revision == 1
    for k in range(11, 21):
        assert v2.read_needle(k).data == payloads[k]
    for k in range(1, 11):
        with pytest.raises(KeyError):
            v2.read_needle(k)
    v2.close()


def test_concurrent_compact_rejected(tmp_path):
    vol, _ = _fill(str(tmp_path / "1"), n=10)
    vol.delete_needle(1)
    state = vacuum_mod.compact(vol)
    with pytest.raises(VolumeError, match="in progress"):
        vacuum_mod.compact(vol)
    vacuum_mod.commit_compact(vol, state)
    with pytest.raises(VolumeError, match="no compaction in progress"):
        vacuum_mod.commit_compact(vol, state)
    vol.delete_needle(2)              # a new cycle is allowed again
    assert vacuum_mod.vacuum(vol, threshold=0.0) is not None
    vol.close()


def test_failed_compact_releases_the_claim_and_cleans_up(tmp_path,
                                                         monkeypatch):
    """A compact that fails part-way (a short read) drops its .cpd/.cpx
    and the in-progress claim, so the next vacuum runs."""
    base = str(tmp_path / "1")
    vol, payloads = _fill(base, n=10)
    vol.delete_needle(1)
    real = vol._dat.read_at
    monkeypatch.setattr(vol._dat, "read_at", lambda size, off: b"")
    with pytest.raises(VolumeError, match="short read compacting"):
        vacuum_mod.compact(vol)
    assert not vol.vacuum_in_progress
    assert not vacuum_mod.cpd_path(base).exists()
    assert not vacuum_mod.cpx_path(base).exists()
    monkeypatch.setattr(vol._dat, "read_at", real)
    assert vacuum_mod.vacuum(vol) is not None
    for k in range(2, 11):
        assert vol.read_needle(k).data == payloads[k]
    vol.close()


def test_store_vacuum(tmp_path):
    st = port_store.Store([tmp_path], max_volumes=4)
    st.create_volume(3)
    rng = np.random.default_rng(0)
    for i in range(1, 31):
        st.write_needle(3, Needle(
            cookie=1, id=i, append_at_ns=i,
            data=rng.integers(0, 256, 500, dtype=np.uint8).tobytes()))
    for i in range(1, 16):
        st.delete_needle(3, i)
    assert st.garbage_ratio(3) > 0.3
    assert st.vacuum_volume(3, threshold=0.3) is not None
    assert st.garbage_ratio(3) == 0.0
    assert st.read_needle(3, 20).data is not None
    st.close()


@pytest.mark.parametrize("kind", MAPS)
def test_store_close_after_a_torn_commit_closes_the_map(tmp_path,
                                                        monkeypatch, kind):
    """The second rename failing takes the volume's files out of service
    but leaves it in the Store; Store.close must still close its needle
    map (a sqlite map checkpoints and closes its database), and the next
    load installs the .cpx and serves every live needle."""
    base = str(tmp_path / "1")
    _vol, payloads = _fill(base, n=12)
    _vol.close()
    st = port_store.Store([tmp_path], needle_map=kind)
    st.load_existing()
    vol = st.get_volume(1)
    for k in range(1, 7):
        vol.delete_needle(k)
    real = vacuum_mod.durability.durable_replace

    def failing(src, dst, *a, **kw):
        if str(src).endswith(".cpx"):
            raise OSError("disk full")
        return real(src, dst, *a, **kw)

    monkeypatch.setattr(vacuum_mod.durability, "durable_replace", failing)
    nm = vol.nm
    with pytest.raises(OSError, match="disk full"):
        st.vacuum_volume(1)
    monkeypatch.setattr(vacuum_mod.durability, "durable_replace", real)
    assert vol._dat is None and vacuum_mod.cpx_path(base).exists()
    assert vol.nm is nm                      # the map is still open
    st.close()
    assert vol.nm is None
    if kind == "sqlite":
        with pytest.raises(sqlite3.ProgrammingError):
            nm._db.execute("SELECT 1")
    vol.close()                              # a second close is a no-op
    st2 = port_store.Store([tmp_path], needle_map=kind)
    st2.load_existing()
    assert not vacuum_mod.cpx_path(base).exists()
    assert st2.get_volume(1).super_block.compact_revision == 1
    for k in range(7, 13):
        assert st2.read_needle(1, k).data == payloads[k]
    for k in range(1, 7):
        with pytest.raises(KeyError):
            st2.read_needle(1, k)
    st2.close()


# -- the five cases of tests/test_vacuum_races.py, on the port --------------


def test_cleanup_unlinks_cpx_before_cpd(tmp_path, monkeypatch):
    """An interrupted cleanup() must never leave the .cpx-only state
    that load() interprets as a torn commit."""
    base = str(tmp_path / "1")
    vol, payloads = _fill(base)
    for k in range(1, 21):
        vol.delete_needle(k)
    vacuum_mod.compact(vol)
    first_unlink = {}
    real_unlink = os.unlink

    class Boom(RuntimeError):
        pass

    def dying_unlink(p, *a, **kw):
        if not first_unlink:
            first_unlink["path"] = str(p)
            real_unlink(p, *a, **kw)
            raise Boom("crash mid-cleanup")
        return real_unlink(p, *a, **kw)

    monkeypatch.setattr(os, "unlink", dying_unlink)
    monkeypatch.setattr("pathlib.Path.unlink",
                        lambda self: dying_unlink(str(self)))
    with pytest.raises(Boom):
        vacuum_mod.abort_compact(vol)
    monkeypatch.undo()
    assert first_unlink["path"].endswith(".cpx")
    assert not vacuum_mod.cpx_path(base).exists()
    assert vacuum_mod.cpd_path(base).exists()
    vol.close()
    vol2 = Volume(base, 1).load()
    for k in range(21, 41):
        assert vol2.read_needle(k).data == payloads[k]
    assert not vacuum_mod.cpd_path(base).exists()
    vol2.close()


def test_read_during_commit_compact_never_misreads(tmp_path):
    """Readers racing commit_compact() always get correct bytes — never
    EBADF, never pre-compact offsets against the compacted file."""
    base = str(tmp_path / "1")
    vol, payloads = _fill(base, n=60)
    for k in range(1, 31):
        vol.delete_needle(k)
    live = {k: v for k, v in payloads.items() if k > 30}
    stop = threading.Event()
    errors = []

    def reader():
        keys = sorted(live)
        i = 0
        while not stop.is_set():
            k = keys[i % len(keys)]
            try:
                if vol.read_needle(k).data != live[k]:
                    errors.append(f"wrong bytes for {k}")
                    return
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{type(e).__name__}: {e}")
                return
            i += 1

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(5):
            state = vacuum_mod.compact(vol)
            vacuum_mod.commit_compact(vol, state)
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for k, v in live.items():
        assert vol.read_needle(k).data == v
    vol.close()


def test_commit_diff_replay_rejects_short_read(tmp_path):
    """A diff entry whose .dat record is missing bytes (torn concurrent
    write) aborts the commit instead of writing a corrupt record."""
    vol, _ = _fill(str(tmp_path / "1"), n=10)
    state = vacuum_mod.compact(vol)
    vol.write_needle(Needle(cookie=7, id=999, data=b"x" * 4096,
                            append_at_ns=1))
    with vol._lock:
        vol._dat.flush()
        sz = dat_path(vol.base).stat().st_size
        vol._dat.truncate(sz - 1024)
    with pytest.raises(VolumeError, match="short read"):
        vacuum_mod.commit_compact(vol, state)
    vol.close()


def test_writes_racing_commit_compact_survive(tmp_path):
    """Every write acknowledged during a compact/commit cycle is readable
    afterwards: the drain opens no window after the diff replay."""
    vol, _ = _fill(str(tmp_path / "1"), n=20)
    for k in range(1, 11):
        vol.delete_needle(k)
    stop = threading.Event()
    written, errors = [], []

    def writer(first):
        i = first
        while not stop.is_set():
            try:
                vol.write_needle(Needle(cookie=1, id=i, data=b"w" * 128,
                                        append_at_ns=i))
                written.append(i)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            i += 2

    threads = [threading.Thread(target=writer, args=(f,))
               for f in (10_000, 10_001)]
    for t in threads:
        t.start()
    try:
        for _ in range(5):
            state = vacuum_mod.compact(vol)
            vacuum_mod.commit_compact(vol, state)
            time.sleep(0.005)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert written
    for i in written:
        assert vol.read_needle(i).data == b"w" * 128, \
            f"acknowledged write {i} lost by commit_compact"
    vol.close()


def test_cleanup_preserves_torn_commit_marker(tmp_path):
    """cleanup()/abort_compact after a commit that already renamed .cpd
    over .dat must NOT delete the .cpx: it is the only index matching
    the now-live compacted .dat."""
    base = str(tmp_path / "1")
    vol, payloads = _fill(base, n=30)
    for k in range(1, 16):
        vol.delete_needle(k)
    vacuum_mod.compact(vol)
    vol.close()
    os.replace(vacuum_mod.cpd_path(base), dat_path(base))
    vacuum_mod.cleanup(base)  # the error-path abort
    assert vacuum_mod.cpx_path(base).exists()
    vol2 = Volume(base, 1).load()
    for k in range(16, 31):
        assert vol2.read_needle(k).data == payloads[k]
    for k in range(1, 16):
        with pytest.raises(KeyError):
            vol2.read_needle(k)
    vol2.close()


def test_commit_rename_failure_keeps_the_volume_serving(tmp_path,
                                                        monkeypatch):
    """The first rename failing leaves the live files untouched and
    reopened; abort_compact drops .cpd/.cpx and the claim."""
    base = str(tmp_path / "1")
    vol, payloads = _fill(base, n=12)
    for k in range(1, 7):
        vol.delete_needle(k)
    real = vacuum_mod.durability.durable_replace

    def failing(src, dst, *a, **kw):
        if str(src).endswith(".cpd"):
            raise OSError("disk full")
        return real(src, dst, *a, **kw)

    monkeypatch.setattr(vacuum_mod.durability, "durable_replace", failing)
    with pytest.raises(OSError, match="disk full"):
        vacuum_mod.vacuum(vol)
    assert not vol.vacuum_in_progress
    assert not vacuum_mod.cpd_path(base).exists()
    assert not vacuum_mod.cpx_path(base).exists()
    assert vol.super_block.compact_revision == 0
    for k in range(7, 13):
        assert vol.read_needle(k).data == payloads[k]
    vol.close()


def test_load_drops_idx_entry_without_dat_record(tmp_path):
    """An index entry whose record never made it to the .dat is dropped
    on load instead of serving garbage (the load-time check vacuum's
    crash states rely on)."""
    base = str(tmp_path / "1")
    vol, payloads = _fill(base, n=5)
    dat_end = vol.dat_size
    vol.close()
    with open(idx_path(base), "ab") as f:
        f.write(IndexEntry(999, dat_end // 8, 1234).to_bytes())
    v2 = Volume(base, 1).load()
    assert v2.nm.get(999) is None
    for k, data in payloads.items():
        assert v2.read_needle(k).data == data
    v2.close()
