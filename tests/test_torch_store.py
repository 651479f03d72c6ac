"""The port's Volume engine and Store registry
(seaweedfs_tpu_torch/storage/volume.py, store.py) against the JAX
package's, on the CPU.

The same needles, made from a seed, go through both packages; every
.dat, .idx, shard, .ecx and .vif either writes must be byte-equal to the
other's (tolerance 0), and each package must load what the other wrote.
Ports the cases of tests/test_volume.py and tests/test_store.py."""

import os
import shutil
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu.pipeline.encode import encode_volume as jax_encode_volume
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu_torch.pipeline.encode import encode_volume
from seaweedfs_tpu_torch.storage import ec_files, needle
from seaweedfs_tpu_torch.storage import store as port_store
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.util import faults as port_faults

PKGS = {"jax": (jax_volume, jax_store, jax_needle),
        "port": (port_volume, port_store, needle)}


def _needles(mod, n, seed=0, max_size=300):
    rng = np.random.default_rng(seed)
    return [mod.Needle(cookie=int(rng.integers(0, 2**32)), id=i,
                       data=rng.integers(0, 256, int(rng.integers(1, max_size)),
                                         dtype=np.uint8).tobytes(),
                       append_at_ns=1_700_000_000_000_000_000 + i)
            for i in range(1, n + 1)]


def _files(d) -> dict:
    """name -> bytes (or the link target relative to ``d``) of every
    file under ``d``."""
    out = {}
    for root, _dirs, names in os.walk(d):
        for name in names:
            p = os.path.join(root, name)
            rel = os.path.relpath(p, d)
            out[rel] = ("link", os.path.relpath(os.path.realpath(p), d)) \
                if os.path.islink(p) else Path(p).read_bytes()
    return out


def _both(tmp_path):
    roots = {}
    for name in PKGS:
        roots[name] = tmp_path / name
        roots[name].mkdir()
    return roots


# -- Volume: the JAX tests/test_volume.py cases, both packages ------------


def test_volume_write_read_roundtrip(tmp_path):
    roots = _both(tmp_path)
    for name, (vol_mod, _st, ndl) in PKGS.items():
        with vol_mod.Volume(roots[name] / "1", 1).create() as v:
            off = v.write_needle(ndl.Needle(cookie=7, id=100, data=b"abc",
                                            append_at_ns=1))
            assert off == 8  # right after the superblock
            v.write_needle(ndl.Needle(cookie=8, id=101, data=b"defgh",
                                      append_at_ns=2))
            assert v.read_needle(100).data == b"abc"
            assert v.read_needle(101, cookie=8).data == b"defgh"
            with pytest.raises(vol_mod.VolumeError):
                v.read_needle(101, cookie=9)  # wrong cookie
            with pytest.raises(KeyError):
                v.read_needle(999)
    assert _files(roots["jax"]) == _files(roots["port"])


def test_volume_reload_from_disk(tmp_path):
    roots = _both(tmp_path)
    for name, (vol_mod, _st, ndl) in PKGS.items():
        base = roots[name] / "2"
        with vol_mod.Volume(base, 2).create() as v:
            v.write_needle(ndl.Needle(cookie=1, id=1, data=b"one",
                                      append_at_ns=1))
            v.write_needle(ndl.Needle(cookie=2, id=2, data=b"two",
                                      append_at_ns=2))
            v.delete_needle(1)
            v.sync()
        with vol_mod.Volume(base).load() as v2:
            assert v2.read_needle(2).data == b"two"
            with pytest.raises(KeyError):
                v2.read_needle(1)  # tombstoned in .idx
            v2.write_needle(ndl.Needle(cookie=3, id=3, data=b"three",
                                       append_at_ns=3))
            assert v2.read_needle(3).data == b"three"
    assert _files(roots["jax"]) == _files(roots["port"])


def test_volume_create_refuses_overwrite(tmp_path):
    base = tmp_path / "3"
    port_volume.Volume(base, 3).create().close()
    with pytest.raises(port_volume.VolumeError):
        port_volume.Volume(base, 3).create()


def test_offsets_are_8_byte_aligned_and_files_equal(tmp_path):
    roots = _both(tmp_path)
    offsets = {}
    for name, (vol_mod, _st, ndl) in PKGS.items():
        with vol_mod.Volume(roots[name] / "4", 4).create() as v:
            offsets[name] = [v.write_needle(n)
                             for n in _needles(ndl, 29, seed=0, max_size=50)]
    assert all(off % 8 == 0 for off in offsets["port"])
    assert offsets["port"] == offsets["jax"]
    assert _files(roots["jax"]) == _files(roots["port"])


def test_synthetic_volume_generator(tmp_path):
    roots = _both(tmp_path)
    for name, (vol_mod, _st, _n) in PKGS.items():
        v = vol_mod.generate_synthetic_volume(roots[name] / "5", 5,
                                              n_needles=50, avg_size=200,
                                              seed=3)
        try:
            assert len(v.nm) == 50
            for key in (1, 25, 50):
                assert len(v.read_needle(key).data) >= 1
        finally:
            v.close()
    assert _files(roots["jax"]) == _files(roots["port"])


def test_synthetic_needles_match_the_volume_writer(tmp_path):
    """write_synthetic_volume and the Volume engine fed the same
    synthetic_needles stream write the same .dat and .idx."""
    a, b = tmp_path / "a", tmp_path / "b"
    n = port_volume.write_synthetic_volume(a, 20_000, avg_size=700, seed=9)
    needles = port_volume.synthetic_needles(avg_size=700, seed=9)
    with port_volume.Volume(b, 1).create() as v:
        while v.dat_size < 20_000:
            v.write_needle(next(needles))
        assert len(v.nm) == n
    for ext in (".dat", ".idx"):
        assert Path(str(a) + ext).read_bytes() == \
            Path(str(b) + ext).read_bytes()


def test_raw_records_and_replication_rewrite(tmp_path):
    roots = _both(tmp_path)
    for name, (vol_mod, _st, ndl) in PKGS.items():
        with vol_mod.Volume(roots[name] / "1", 1).create() as src, \
                vol_mod.Volume(roots[name] / "2", 2).create() as dst:
            for n in _needles(ndl, 6, seed=2):
                src.write_needle(n)
            for key in range(1, 7):
                rec, off = src.read_record(key)
                assert dst.write_raw_record(rec) == off
            with pytest.raises(vol_mod.VolumeError):
                dst.write_raw_record(rec[:-8])   # length disagrees
            dst.configure_replication("010")
        with vol_mod.Volume(roots[name] / "2").load() as v:
            assert str(v.super_block.replica_placement) == "010"
            assert v.content_size() == v.dat_size
    files = _files(roots["jax"])
    assert files == _files(roots["port"])
    assert files["1.dat"][8:] == files["2.dat"][8:]


def test_every_acknowledged_write_is_fsynced(tmp_path, monkeypatch):
    """The commit policy: a write fsyncs the .dat and then the .idx
    before it returns, a delete fsyncs the .idx."""
    synced: list[str] = []
    real = os.fsync

    def fsync(fd):
        synced.append(os.path.basename(os.readlink(f"/proc/self/fd/{fd}")))
        real(fd)

    monkeypatch.setattr(os, "fsync", fsync)
    with port_volume.Volume(tmp_path / "1", 1).create() as v:
        synced.clear()
        for n in _needles(needle, 3, seed=4):
            v.write_needle(n)
        assert synced == ["1.dat", "1.idx"] * 3
        synced.clear()
        assert v.delete_needle(2)
        assert synced == ["1.idx"]


# -- what the port refuses --------------------------------------------------


@pytest.mark.parametrize("kind", ["native", "sqlite"])
def test_unported_needle_maps_raise(tmp_path, kind):
    """A needle map kind the port does not have (here ``nativedb`` and
    ``sqlitedb``, which neither package has) raises, in Volume and in
    Store, before anything is written."""
    with pytest.raises(port_volume.VolumeError,
                       match="unknown needle map kind"):
        port_volume.Volume(tmp_path / "1", 1, needle_map=kind + "db")
    st = port_store.Store([tmp_path], needle_map=kind + "db")
    with pytest.raises(port_volume.VolumeError, match="memory, native"):
        st.create_volume(1)
    assert list(tmp_path.iterdir()) == []   # nothing written instead


@pytest.mark.parametrize("kind", ["native", "sqlite"])
def test_needle_map_kinds_open_and_serve(tmp_path, kind):
    """The JAX package's ``native`` and ``sqlite`` kinds open, and a
    needle written through one is read back after a reload."""
    with port_volume.Volume(tmp_path / "1", 1, needle_map=kind).create() as v:
        v.write_needle(needle.Needle(cookie=1, id=1, data=b"x",
                                     append_at_ns=1))
    with port_volume.Volume(tmp_path / "1", 1, needle_map=kind).load() as v:
        assert v.read_needle(1).data == b"x"


def test_volume_reads_each_append_and_writes_the_same_files_as_jax(
        tmp_path):
    """A Volume in both packages: each needle reads back right after its
    append, and the .dat and .idx are equal after a delete and a
    reload."""
    roots = _both(tmp_path)
    for name, (vol_mod, _st, ndl) in PKGS.items():
        base = roots[name] / "1"
        with vol_mod.Volume(base, 1).create() as v:
            for n in _needles(ndl, 12, seed=8):
                v.write_needle(n)
                assert v.read_needle(n.id).data == n.data
            v.delete_needle(4)
        with vol_mod.Volume(base, 1).load() as v:
            assert len(v.nm) == 11
    assert _files(roots["jax"]) == _files(roots["port"])


@pytest.mark.parametrize("backend", ["disk", "mmap"])
def test_backends_write_the_same_files_as_jax(tmp_path, backend):
    """A Volume on each ``.dat`` backend in both packages: each needle
    reads back right after its append (the mmap backend remaps past its
    frontier), and the files are equal after a delete, a replication
    rewrite and a reload on the same backend."""
    roots = _both(tmp_path)
    for name, (vol_mod, _st, ndl) in PKGS.items():
        base = roots[name] / "1"
        with vol_mod.Volume(base, 1, backend=backend).create() as v:
            assert v.backend_kind == backend
            for n in _needles(ndl, 12, seed=8):
                v.write_needle(n)
                assert v.read_needle(n.id).data == n.data
            v.delete_needle(4)
            v.configure_replication("010")
        with vol_mod.Volume(base, 1, backend=backend).load() as v:
            assert len(v.nm) == 11
            assert v.read_needle(12).data == _needles(ndl, 12, seed=8)[-1].data
    assert _files(roots["jax"]) == _files(roots["port"])


def test_mmap_file_remaps_and_truncates(tmp_path):
    """The mmap backend in both packages: the same reads, including one
    past the mapped frontier (a remap), and after a truncate."""
    from seaweedfs_tpu.storage import backend as jax_backend
    from seaweedfs_tpu_torch.storage import backend as port_backend
    got = {}
    for name, mod in (("jax", jax_backend), ("port", port_backend)):
        b = mod.MmapFile(tmp_path / f"{name}.dat", create=True)
        out = [b.append(b"a" * 4096), b.read_at(10, 0)]
        out.append(b.append(b"b" * 100))
        out.append(b.read_at(5, 4096))           # past the frontier
        out.append(b.read_at(200, 4000))          # spans both appends
        b.write_at(b"WORLD", 4)
        out.append(b.read_at(12, 0))
        b.truncate(50)
        out += [b.size(), b.read_at(100, 0), b.read_at(10, 60)]
        b.sync()
        b.close()
        b2 = mod.MmapFile(tmp_path / f"{name}.dat")
        out.append(b2.read_at(50, 0))
        b2.close()
        got[name] = out
    assert got["port"] == got["jax"]
    assert got["port"][3] == b"b" * 5 and got["port"][6] == 50


def test_backend_registry_refuses_s3_and_unknown_kinds(tmp_path):
    """``disk`` and ``mmap`` open; the JAX package's ``s3`` cold tier is
    refused with a "not ported yet" error, an unknown kind as in the JAX
    package, and a Volume or Store asked for either writes nothing."""
    from seaweedfs_tpu_torch.storage import backend as port_backend
    for kind, cls in (("disk", port_backend.DiskFile),
                      ("mmap", port_backend.MmapFile)):
        b = port_backend.open_backend(kind, tmp_path / f"{kind}.dat",
                                      create=True)
        assert type(b) is cls
        b.close()
    with pytest.raises(port_backend.BackendNotPorted, match="not ported"):
        port_backend.open_backend("s3", tmp_path / "s3.dat")
    with pytest.raises(ValueError, match="unknown backend"):
        port_backend.open_backend("s4", tmp_path / "s4.dat")
    d = tmp_path / "store"
    d.mkdir()
    for kind in ("s3", "s4"):
        with pytest.raises(port_volume.VolumeError, match="backend"):
            port_volume.Volume(d / "1", 1, backend=kind).create()
        st = port_store.Store([d], backend=kind)
        with pytest.raises(port_volume.VolumeError, match="backend"):
            st.create_volume(1)
    assert list(d.iterdir()) == []


def test_tier_sidecar_and_s3_backend_raise(tmp_path):
    with port_volume.Volume(tmp_path / "6", 6).create() as v:
        v.write_needle(needle.Needle(cookie=1, id=1, data=b"x",
                                     append_at_ns=1))
    (tmp_path / "6.tier").write_text('{"endpoint": "e", "bucket": "b"}')
    with pytest.raises(port_volume.VolumeError, match="tier"):
        port_volume.Volume(tmp_path / "6").load()
    st = port_store.Store([tmp_path])
    with pytest.raises(port_volume.VolumeError, match="tier"):
        st.load_existing()
    (tmp_path / "6.dat").unlink()       # tiered with no local .dat
    with pytest.raises(port_volume.VolumeError, match="tier"):
        st.mount_volume(6)


def test_shell_refuses_a_tiered_store_and_closes_what_it_loaded(
        tmp_path, monkeypatch, capsys):
    """A .tier sidecar (the S3 tier is not ported) makes the shell print
    one ``error:`` line naming the volume and exit non-zero, with every
    volume loaded before it closed."""
    from seaweedfs_tpu_torch.shell import cli
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for d, vid in ((a, 5), (b, 6)):
        with port_volume.Volume(d / str(vid), vid).create() as v:
            v.write_needle(needle.Needle(cookie=1, id=1, data=b"x",
                                         append_at_ns=1))
    (b / "6.tier").write_text('{"endpoint": "e", "bucket": "b"}')
    closed = []
    real_close = port_volume.Volume.close

    def close(self):
        closed.append(self.base)
        return real_close(self)

    monkeypatch.setattr(port_volume.Volume, "close", close)
    rc = cli.main(["-dir", str(a), "-dir", str(b), "-device", "cpu",
                   "-c", "volume.list"])
    err = capsys.readouterr().err.splitlines()
    assert rc == 1
    assert len(err) == 1 and err[0].startswith("error: ")
    assert str(b / "6") in err[0] and "tier" in err[0]
    assert closed == [a / "5"]


def test_create_drops_a_stale_sqlite_map(tmp_path):
    """A leftover .sdx of a deleted volume with the same id must not feed
    a volume the port creates: the JAX sqlite map then loads exactly the
    new .idx, as the memory map does."""
    base = tmp_path / "4"
    with jax_volume.Volume(base, 4, needle_map="sqlite").create() as v:
        for n in _needles(jax_needle, 4, seed=1):
            v.write_needle(n)
    assert Path(str(base) + ".sdx").exists()
    for ext in (".dat", ".idx"):        # deleted outside the store
        Path(str(base) + ext).unlink()
    with port_volume.Volume(base, 4).create() as v:
        for n in _needles(needle, 8, seed=2):
            v.write_needle(n)
    with jax_volume.Volume(base, 4, needle_map="sqlite").load() as v:
        got = sorted((e.key, e.offset_units, e.size)
                     for e in v.nm.live_entries())
    with jax_volume.Volume(base, 4).load() as v:
        want = sorted((e.key, e.offset_units, e.size)
                      for e in v.nm.live_entries())
    assert got == want and [k for k, _o, _s in want] == list(range(1, 9))


# -- crash recovery ---------------------------------------------------------


class _Crash(Exception):
    pass


def _raise_crash(point):
    raise _Crash(point)


def _torn_tail(vol_mod, ndl, base, damage):
    """Write 5 needles, then damage the tail as a crash would."""
    with vol_mod.Volume(base, 1).create() as v:
        for n in _needles(ndl, 5, seed=7):
            v.write_needle(n)
    dat, idx = str(base) + ".dat", str(base) + ".idx"
    if damage == "dat_garbage":      # an append that never reached .idx
        with open(dat, "ab") as f:
            f.write(b"\x01" * 77)
    elif damage == "idx_partial":    # half an index entry
        with open(idx, "ab") as f:
            f.write(b"\x00" * 9)
    elif damage == "record_torn":    # last record's body cut short
        size = os.path.getsize(dat)
        os.truncate(dat, size - 20)


@pytest.mark.parametrize("damage", ["dat_garbage", "idx_partial",
                                    "record_torn"])
def test_integrity_check_truncates_torn_tail_alike(tmp_path, damage):
    roots = _both(tmp_path)
    repairs, live = {}, {}
    for name, (vol_mod, _st, ndl) in PKGS.items():
        base = roots[name] / "1"
        _torn_tail(vol_mod, ndl, base, damage)
        sb = vol_mod.Volume(base)
        with sb.load() as v:
            live[name] = sorted(e.key for e in v.nm.live_entries())
        _torn_tail(vol_mod, ndl, roots[name] / "2", damage)
        with open(str(roots[name] / "2") + ".dat", "rb") as f:
            head = f.read(8)
        repairs[name] = vol_mod.check_volume_data_integrity(
            roots[name] / "2", type(sb.super_block).parse(head))
    assert repairs["port"] == repairs["jax"] and repairs["port"]
    assert live["port"] == live["jax"]
    assert _files(roots["jax"]) == _files(roots["port"])


@pytest.mark.parametrize("point,torn_idx", [
    ("crash.append.dat", 0), ("crash.append.idx", 0),
    ("crash.append.idx", 7)])
def test_crash_point_recovers_alike(tmp_path, point, torn_idx):
    """Arm the crashpoint in each package's own registry: the fourth
    write dies there; the reload recovers to the same files and map."""
    assert point in port_faults.CATALOG and point in jax_faults.CATALOG
    roots = _both(tmp_path)
    live = {}
    for name, (vol_mod, _st, ndl) in PKGS.items():
        fmod = port_faults if name == "port" else jax_faults
        base = roots[name] / "1"
        v = vol_mod.Volume(base, 1).create()
        ns = _needles(ndl, 4, seed=5)
        for n in ns[:3]:
            v.write_needle(n)
        fmod.set_crash_handler(_raise_crash)
        fmod.inject(point, "crash#1")
        try:
            with pytest.raises(_Crash):
                v.write_needle(ns[3])
        finally:
            fmod.clear()
            fmod.set_crash_handler(None)
        v.close()
        if torn_idx:   # the crash tore the journal entry's last bytes
            idx = str(base) + ".idx"
            os.truncate(idx, os.path.getsize(idx) - torn_idx)
        with vol_mod.Volume(base).load() as v2:
            live[name] = sorted(e.key for e in v2.nm.live_entries())
            for n in ns[:3]:
                assert v2.read_needle(n.id).data == n.data
    assert live["port"] == live["jax"]
    assert live["port"] == ([1, 2, 3, 4] if point == "crash.append.idx"
                            and not torn_idx else [1, 2, 3])
    assert _files(roots["jax"]) == _files(roots["port"])


# -- concurrency ------------------------------------------------------------


def test_concurrent_writers_and_readers_on_one_volume(tmp_path):
    """4 writer and 4 reader threads on one volume, with a short switch
    interval: every needle lands once at an aligned offset, every read
    returns its needle whole, and close() waits for in-flight reads."""
    n_writers, per = 4, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    v = port_volume.Volume(tmp_path / "1", 1).create()
    written: dict[int, bytes] = {}
    errors: list = []
    done = threading.Event()
    try:
        def writer(w):
            try:
                for n in _needles(needle, per, seed=w):
                    n = needle.Needle(cookie=n.cookie, id=w * 1000 + n.id,
                                      data=n.data,
                                      append_at_ns=n.append_at_ns)
                    assert v.write_needle(n) % 8 == 0
                    written[n.id] = n.data
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        def reader():
            try:
                while not done.is_set():
                    for key, data in list(written.items()):
                        assert v.read_needle(key).data == data
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        ws = [threading.Thread(target=writer, args=(w,))
              for w in range(n_writers)]
        rs = [threading.Thread(target=reader) for _ in range(4)]
        for t in ws + rs:
            t.start()
        for t in ws:
            t.join(timeout=60)
        done.set()
        for t in rs:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ws + rs)
        assert not errors, errors[:1]
        assert len(v.nm) == len(written) == n_writers * per

        # readers racing close(): each read returns its needle or finds
        # the volume closed, never a closed descriptor
        stop = threading.Event()
        outcomes: list = []

        def late_reader():
            while not stop.is_set():
                try:
                    v.read_needle(1001)
                    outcomes.append("read")
                except port_volume.VolumeError:
                    outcomes.append("closed")
                    return
                except Exception as e:  # noqa: BLE001 — asserted below
                    outcomes.append(e)
                    return

        ts = [threading.Thread(target=late_reader) for _ in range(4)]
        for t in ts:
            t.start()
        v.close()
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert all(o in ("read", "closed") for o in outcomes), outcomes[:3]
    finally:
        sys.setswitchinterval(old)
        v.close()
    with port_volume.Volume(tmp_path / "1").load() as v2:
        for key, data in written.items():
            assert v2.read_needle(key).data == data


# -- Store: the JAX tests/test_store.py cases, both packages -----------------


def test_base_name_roundtrip():
    for st in (port_store, jax_store):
        assert st.volume_base_name(3) == "3"
        assert st.volume_base_name(3, "pics") == "pics_3"
        assert st.parse_base_name("3") == ("", 3)
        assert st.parse_base_name("pics_3") == ("pics", 3)
        assert st.parse_base_name("a_b_7") == ("a_b", 7)
        with pytest.raises(ValueError):
            st.parse_base_name("nodigits")


def test_store_create_write_read_delete(tmp_path):
    roots = _both(tmp_path)
    for name, (_v, st_mod, ndl) in PKGS.items():
        st = st_mod.Store([roots[name]])
        st.create_volume(1)
        off = st.write_needle(1, ndl.Needle(cookie=7, id=42, data=b"hello",
                                            append_at_ns=5))
        assert off == 8  # first record lands right after the superblock
        assert st.read_needle(1, 42, cookie=7).data == b"hello"
        st.mark_readonly(1)
        with pytest.raises(st_mod.StoreError):
            st.write_needle(1, ndl.Needle(cookie=1, id=2, data=b"n"))
        st.mark_writable(1)
        assert st.delete_needle(1, 42)
        with pytest.raises(KeyError):
            st.read_needle(1, 42)
        st.close()
    assert _files(roots["jax"]) == _files(roots["port"])


def test_store_loads_the_other_packages_volumes(tmp_path):
    """A JAX-written directory loads in the port's Store and reads back
    every needle, and the other way round."""
    roots = _both(tmp_path)
    wrote = {}
    for name, (vol_mod, st_mod, ndl) in PKGS.items():
        st = st_mod.Store([roots[name]])
        st.create_volume(5, collection="pics", replica_placement="001")
        wrote[name] = _needles(ndl, 12, seed=8)
        for n in wrote[name]:
            st.write_needle(5, n, collection="pics")
        st.delete_needle(5, 3, collection="pics")
        st.close()
    assert _files(roots["jax"]) == _files(roots["port"])
    for reader, writer in (("port", "jax"), ("jax", "port")):
        st = PKGS[reader][1].Store([roots[writer]])
        st.load_existing()
        for n in wrote[writer]:
            if n.id == 3:
                with pytest.raises(KeyError):
                    st.read_needle(5, 3, collection="pics")
                continue
            got = st.read_needle(5, n.id, cookie=n.cookie,
                                 collection="pics")
            assert got.data == n.data and got.append_at_ns == n.append_at_ns
        status = st.status()
        assert status["volumes"][0]["replica_placement"] == "001"
        st.close()


def test_store_load_existing_and_heartbeat(tmp_path):
    roots = _both(tmp_path)
    status = {}
    for name, (vol_mod, st_mod, _n) in PKGS.items():
        vol_mod.generate_synthetic_volume(roots[name] / "5", 5,
                                          n_needles=10, avg_size=64).close()
        (roots[name] / "7.dat.part").write_bytes(b"orphan")
        st = st_mod.Store([roots[name]])
        st.load_existing()
        assert st.has_volume(5)
        assert not (roots[name] / "7.dat.part").exists()
        status[name] = st.status()
        st.close()
    for s in status.values():
        for v in s["volumes"]:
            v.pop("modified_at_second")
    assert status["port"] == status["jax"]
    assert status["port"]["volumes"][0]["file_count"] == 10
    assert status["port"]["ec_shards"] == []


def test_store_two_locations_balance(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(); d2.mkdir()
    st = port_store.Store([d1, d2], max_volumes=2)
    for vid in range(1, 5):
        st.create_volume(vid)
    # 4 volumes over 2 locations with capacity 2 each: both full.
    with pytest.raises(port_store.StoreError):
        st.create_volume(99)
    by_dir = {}
    for v in st.volumes.values():
        by_dir[v.base.parent.name] = by_dir.get(v.base.parent.name, 0) + 1
    assert sorted(by_dir.values()) == [2, 2]
    st.close()


def test_store_ec_mount_cycle(tmp_path):
    roots = _both(tmp_path)
    for name, (vol_mod, st_mod, _n) in PKGS.items():
        vol_mod.generate_synthetic_volume(roots[name] / "9", 9, n_needles=8,
                                          avg_size=128).close()
        if name == "port":
            encode_volume(roots[name] / "9", remove_source=True,
                          device="cpu")
        else:
            jax_encode_volume(roots[name] / "9", remove_source=True)
        st = st_mod.Store([roots[name]])
        st.load_existing()
        assert not st.has_volume(9)
        assert st.ec_mounts[("", 9)].shard_bits.count() == 14
        st.unmount_ec_shards(9, [0, 1])
        assert st.ec_mounts[("", 9)].shard_bits.count() == 12
        st.mount_ec_shards(9, [0, 1])
        assert st.ec_mounts[("", 9)].shard_bits.count() == 14
        assert st.status()["ec_shards"][0]["ec_index_bits"] == (1 << 14) - 1
        with pytest.raises(st_mod.StoreError):
            st.mount_ec_shards(77, [0])
        st.close()
    assert _files(roots["jax"]) == _files(roots["port"])


def test_gather_mount_reconcile_reach_the_same_state(tmp_path):
    """Shards split over two locations: gather links the siblings under
    one base, mount registers them, a lost file drops out on reconcile,
    and remove_ec_volume_files clears links and files; both packages
    reach the same files and mount table at every step."""
    seal = tmp_path / "seal"
    seal.mkdir()
    jax_volume.generate_synthetic_volume(seal / "4", 4, n_needles=9,
                                         avg_size=300, seed=6).close()
    jax_encode_volume(seal / "4", remove_source=True)
    state = {}
    for name, (_v, st_mod, _n) in PKGS.items():
        a, b = tmp_path / name / "a", tmp_path / name / "b"
        shutil.copytree(seal, a)
        b.mkdir()
        for sid in (1, 4, 12):
            shutil.move(ec_files.shard_path(a / "4", sid),
                        ec_files.shard_path(b / "4", sid))
        shutil.move(ec_files.vif_path(a / "4"), ec_files.vif_path(b / "4"))
        st = st_mod.Store([a, b])
        st.load_existing()
        steps = [sorted(st.ec_shard_paths(4))]
        base = st.gather_ec_volume(4)
        steps.append((os.path.relpath(base, tmp_path / name),
                      _files(tmp_path / name)))
        st.mount_ec_shards(4, list(range(14)))
        steps.append(st.status()["ec_shards"])
        os.remove(ec_files.shard_path(b / "4", 12))
        os.remove(ec_files.shard_path(a / "4", 12))   # the link too
        st.reconcile_ec_shards()
        steps.append(st.status()["ec_shards"])
        st.remove_ec_volume_files(4)
        steps.append(_files(tmp_path / name))
        st.reconcile_ec_shards()
        steps.append(st.status())
        st.close()
        state[name] = steps
    assert state["port"] == state["jax"]
    assert state["port"][2][0]["ec_index_bits"] == (1 << 14) - 1
    assert state["port"][3][0]["ec_index_bits"] == (1 << 14) - 1 - (1 << 12)
    assert state["port"][4] == {}


def test_store_unmount_mount_delete_volume(tmp_path):
    roots = _both(tmp_path)
    for name, (_v, st_mod, ndl) in PKGS.items():
        st = st_mod.Store([roots[name]])
        st.create_volume(2, collection="col")
        st.write_needle(2, ndl.Needle(cookie=1, id=1, data=b"x",
                                      append_at_ns=9), collection="col")
        st.mark_readonly(2, collection="col")
        st.unmount_volume(2, collection="col")
        assert not st.has_volume(2, collection="col")
        assert st.is_readonly(2, collection="col")   # kept over unmount
        st.mount_volume(2, collection="col")
        assert st.read_needle(2, 1, collection="col").data == b"x"
        st.configure_replication(2, "100", collection="col")
        with pytest.raises(st_mod.StoreError):
            st.mount_volume(3)
        snapshot = _files(roots[name])
        st.delete_volume(2, collection="col")
        assert not (roots[name] / "col_2.dat").exists()
        assert not (roots[name] / "col_2.idx").exists()
        assert not st.has_volume(2, collection="col")
        assert not st.is_readonly(2, collection="col")
        st.close()
        roots[name] = snapshot
    assert roots["jax"] == roots["port"]
