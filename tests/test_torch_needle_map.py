"""The port's native and sqlite needle maps
(seaweedfs_tpu_torch/storage/needle_map_native.py, needle_map_sqlite.py)
against the JAX package's, on the CPU.

The same seeded ``.idx`` goes through both packages' maps; live entries
and every counter must be equal (tolerance 0). Ports the cases of
tests/test_needle_map_native.py, plus the sqlite map's watermark and
generation, and the ``Volume`` fallback when ``g++`` is missing."""

import logging
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle_map_native as jax_native
from seaweedfs_tpu.storage import needle_map_sqlite as jax_sqlite
from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.idx import CompactMap as JaxCompactMap
from seaweedfs_tpu_torch.storage import needle, needle_map_native
from seaweedfs_tpu_torch.storage import needle_map_sqlite, vacuum
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.idx import CompactMap, IndexEntry
from seaweedfs_tpu_torch.storage.types import TOMBSTONE_FILE_SIZE
from torch_teardown import collect_jax_garbage  # noqa: F401


def _entries(m) -> list:
    return [(e.key, e.offset_units, e.size) for e in m.live_entries()]


def _counters(m) -> tuple:
    return (len(m), m.file_count, m.deleted_count, m.deleted_bytes,
            m.max_key, m.max_offset_units)


def _write_idx(path, n=2000, key_space=300, seed=3):
    """Random sets and ~20% tombstones over a small key space, so keys
    are overwritten, deleted and resurrected."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for _ in range(n):
            key = int(rng.integers(1, key_space))
            if rng.random() < 0.2:
                f.write(IndexEntry(key, 0, TOMBSTONE_FILE_SIZE).to_bytes())
            else:
                f.write(IndexEntry(key, int(rng.integers(0, 2**31)),
                                   int(rng.integers(0, 2**30))).to_bytes())


def test_native_library_builds_into_the_port_build_dir():
    """The port's own g++ build, named by a hash of source and flags
    (no fallback can hide here: this machine has g++)."""
    assert needle_map_native.available()
    lib = needle_map_native._build()
    assert lib.parent == needle_map_native.BUILD_DIR
    assert lib.name.startswith("libneedle_map_") and lib.exists()
    assert needle_map_native.SRC.read_bytes() != b""
    m = needle_map_native.NativeNeedleMap()
    assert isinstance(m, needle_map_native.NativeNeedleMap)
    m.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_workload_equals_compact_map(seed):
    rng = np.random.default_rng(seed)
    nat = needle_map_native.NativeNeedleMap()
    ref = CompactMap()
    for _ in range(5000):
        key = int(rng.integers(1, 800))
        op = rng.random()
        if op < 0.65:
            off = int(rng.integers(0, 2**32))
            size = int(rng.integers(0, 2**31))
            nat.set(key, off, size)
            ref.set(key, off, size)
        elif op < 0.9:
            assert nat.delete(key) == ref.delete(key)
        else:
            got, want = nat.get(key), ref.get(key)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.offset_units, got.size) == \
                    (want.offset_units, want.size)
    assert _counters(nat) == _counters(ref)
    assert _entries(nat) == _entries(ref)
    assert list(nat.items()) == nat.live_entries()
    nat.close()
    with pytest.raises(RuntimeError, match="closed"):
        nat.get(1)


def test_growth_past_initial_capacity():
    nat = needle_map_native.NativeNeedleMap()
    n = 50_000  # well past the 1024-slot initial table
    for k in range(1, n + 1):
        nat.set(k, k * 2, k % 1000 + 1)
    assert len(nat) == n
    assert nat.get(1).offset_units == 2
    assert nat.get(n).offset_units == 2 * n
    assert nat.max_key == n
    nat.close()


@pytest.mark.parametrize("seed", [3, 4])
def test_same_idx_through_both_packages_maps(tmp_path, seed):
    """One .idx through the memory, native and sqlite maps of both
    packages: equal live entries and counters everywhere."""
    path = tmp_path / "1.idx"
    _write_idx(path, seed=seed)
    maps = {
        "port memory": CompactMap.load_from_idx(path),
        "port native": needle_map_native.NativeNeedleMap.load_from_idx(path),
        "port sqlite": needle_map_sqlite.SqliteNeedleMap.load_from_idx(
            tmp_path / "port.sdx", path),
        "jax memory": JaxCompactMap.load_from_idx(path),
        "jax native": jax_native.NativeNeedleMap.load_from_idx(path),
        "jax sqlite": jax_sqlite.SqliteNeedleMap.load_from_idx(
            tmp_path / "jax.sdx", path),
    }
    want = (_entries(maps["jax memory"]), _counters(maps["jax memory"]))
    for name, m in maps.items():
        assert (_entries(m), _counters(m)) == want, name
        if hasattr(m, "close"):
            m.close()


def test_native_load_refuses_a_partial_entry(tmp_path):
    path = tmp_path / "1.idx"
    path.write_bytes(IndexEntry(1, 1, 10).to_bytes() + b"\x00" * 5)
    with pytest.raises(ValueError, match="multiple of 16"):
        needle_map_native.NativeNeedleMap.load_from_idx(path)


def test_sqlite_replays_only_the_tail_and_either_package_reads_it(tmp_path):
    """The watermark: a reload replays the .idx entries past it. The
    .sdx layout is the JAX package's, so each package resumes the
    other's map."""
    path = tmp_path / "1.idx"
    _write_idx(path, n=600, seed=5)
    head = path.read_bytes()
    m = needle_map_sqlite.SqliteNeedleMap.load_from_idx(tmp_path / "p.sdx",
                                                        path)
    assert m._applied_bytes == len(head)
    m.close()
    jax_sqlite.SqliteNeedleMap.load_from_idx(tmp_path / "j.sdx",
                                             path).close()
    _write_idx(tmp_path / "tail.idx", n=200, seed=6)
    with open(path, "ab") as f:
        f.write((tmp_path / "tail.idx").read_bytes())
    ref = JaxCompactMap.load_from_idx(path)
    replayed = []
    real_set = needle_map_sqlite.SqliteNeedleMap.set

    def counting_set(self, *args):
        replayed.append(args[0])
        return real_set(self, *args)

    needle_map_sqlite.SqliteNeedleMap.set = counting_set
    try:
        port = needle_map_sqlite.SqliteNeedleMap.load_from_idx(
            tmp_path / "j.sdx", path)
    finally:
        needle_map_sqlite.SqliteNeedleMap.set = real_set
    jax = jax_sqlite.SqliteNeedleMap.load_from_idx(tmp_path / "p.sdx", path)
    # only the 200 tail entries were replayed (tombstones go to delete)
    assert 0 < len(replayed) <= 200
    for m in (port, jax):
        assert (_entries(m), _counters(m)) == (_entries(ref), _counters(ref))
        m.close()


def test_sqlite_generation_follows_the_vacuum(tmp_path):
    """A vacuum replaces the .idx and bumps compact_revision: the sqlite
    map is rebuilt at generation 1 in both packages, and each package's
    reload of the other's compacted volume agrees."""
    files = {}
    for name, (vol_mod, vac) in {"port": (port_volume, vacuum),
                                 "jax": (jax_volume, jax_vacuum)}.items():
        d = tmp_path / name
        d.mkdir()
        vol = vol_mod.generate_synthetic_volume(d / "1", 1, n_needles=40,
                                                avg_size=200, seed=2)
        vol.close()
        vol = vol_mod.Volume(d / "1", 1, needle_map="sqlite").load()
        assert vol.nm.generation == 0
        for k in range(1, 41, 3):
            vol.delete_needle(k)
        assert vac.vacuum(vol) is not None
        assert vol.nm.generation == 1
        assert int(vol.nm._meta("idx_generation")) == 1
        files[name] = {ext: Path(str(d / "1") + ext).read_bytes()
                       for ext in (".dat", ".idx")}
        entries = _entries(vol.nm)
        vol.close()
        # the other package reloads this one's volume and map
        other = jax_volume if name == "port" else port_volume
        with other.Volume(d / "1", 1, needle_map="sqlite").load() as v:
            assert v.nm.generation == 1
            assert _entries(v.nm) == entries
            assert len(entries) == 26
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("kind", ["native", "sqlite"])
def test_volume_roundtrip_equals_jax(tmp_path, kind):
    """A Volume on each map kind writes the same .dat and .idx as the
    JAX package's on the same needles, and reloads them."""
    out = {}
    for name, vol_mod in (("port", port_volume), ("jax", jax_volume)):
        d = tmp_path / name
        d.mkdir()
        ndl = needle if name == "port" else __import__(
            "seaweedfs_tpu.storage.needle", fromlist=["Needle"])
        rng = np.random.default_rng(11)
        payloads = {}
        with vol_mod.Volume(d / "9", 9, needle_map=kind).create() as vol:
            for i in range(1, 40):
                data = rng.integers(0, 256, int(rng.integers(10, 4000)),
                                    dtype=np.uint8).tobytes()
                vol.write_needle(ndl.Needle(cookie=i * 7, id=i, data=data,
                                            append_at_ns=i))
                payloads[i] = (i * 7, data)
            assert vol.delete_needle(5)
            del payloads[5]
        with vol_mod.Volume(d / "9", 9, needle_map=kind).load() as vol:
            for i, (cookie, data) in payloads.items():
                assert vol.read_needle(i, cookie=cookie).data == data
            with pytest.raises(KeyError):
                vol.read_needle(5)
            out[name] = (_entries(vol.nm), _counters(vol.nm))
        out[name] += tuple(Path(str(d / "9") + ext).read_bytes()
                           for ext in (".dat", ".idx"))
    assert out["port"] == out["jax"]


def test_native_fallback_warns_once_and_uses_the_memory_map(
        tmp_path, monkeypatch, caplog):
    """Where g++ is missing the native kind falls back to the memory map
    with one warning per process, as the JAX package does."""
    monkeypatch.setattr(needle_map_native, "available", lambda: False)
    monkeypatch.setattr(port_volume, "_native_fallback_warned", False)
    with caplog.at_level(logging.WARNING, logger=port_volume.__name__):
        for vid in (1, 2):
            with port_volume.Volume(tmp_path / str(vid), vid,
                                    needle_map="native").create() as v:
                assert type(v.nm) is CompactMap
                v.write_needle(needle.Needle(cookie=1, id=1, data=b"x",
                                             append_at_ns=1))
            with port_volume.Volume(tmp_path / str(vid), vid,
                                    needle_map="native").load() as v:
                assert type(v.nm) is CompactMap and len(v.nm) == 1
    warned = [r for r in caplog.records if "native needle map" in r.message]
    assert len(warned) == 1
