"""The port's chunk cache (``seaweedfs_tpu_torch/cache``) against the JAX
package's: every scenario of ``tests/test_chunk_cache.py`` runs through
both packages with equal observables; one seeded get/put/invalidate
sequence gives equal hits, misses, rejects and evictions and byte-equal
disk-tier segment files; ``crash.disktier.append`` fires at the same
record in both and the reloaded tiers agree."""

import hashlib
import io
import random
import threading
from pathlib import Path

import pytest
from torch_teardown import collect_jax_garbage  # noqa: F401

import seaweedfs_tpu.cache as jax_cache
import seaweedfs_tpu.cache.chunk_cache as jax_chunk_cache
import seaweedfs_tpu.util.config as jax_config
import seaweedfs_tpu.util.faults as jax_faults
import seaweedfs_tpu_torch.cache as port_cache
import seaweedfs_tpu_torch.cache.chunk_cache as port_chunk_cache
import seaweedfs_tpu_torch.util.config as port_config
import seaweedfs_tpu_torch.util.faults as port_faults

PKGS = {"jax": (jax_cache, jax_chunk_cache._Entry),
        "port": (port_cache, port_chunk_cache._Entry)}


def _payload(key: str, size: int = 200) -> bytes:
    h = hashlib.blake2s(key.encode()).digest()
    return (h * (size // len(h) + 1))[:size]


def _both(fn, tmp_path=None):
    """``fn(cache_pkg, Entry, workdir)`` in both packages; results equal."""
    got = {}
    for name, (c, entry) in PKGS.items():
        work = None
        if tmp_path is not None:
            work = tmp_path / name
            work.mkdir()
        got[name] = fn(c, entry, work)
    assert got["port"] == got["jax"]
    return got["port"]


def test_fid_volume_and_chunk_key():
    got = _both(lambda c, e, w: (
        c.fid_volume("3,01637037d6"), c.fid_volume("not-a-fid"),
        c.chunk_key("127.0.0.1:9333", "3,01637037d6"),
        c.chunk_key("a:1", "3,01") != c.chunk_key("b:1", "3,01")))
    assert got == (3, None, "chunk:127.0.0.1:9333:3,01637037d6", True)


def _slru_scan(c, E, w):
    lru = c.SegmentedLRU(10_000, protected_fraction=0.8)
    hot = [f"hot{i}" for i in range(5)]
    for k in hot:
        lru.put(k, E(b"x" * 1000, 0.0, None))
        lru.get(k)
    for i in range(50):
        lru.put(f"scan{i}", E(b"y" * 1000, 0.0, None))
    return [k in lru for k in hot], lru.entries, lru.bytes


def _slru_overflow(c, E, w):
    lru = c.SegmentedLRU(4_000, protected_fraction=0.5)
    for i in range(3):
        lru.put(f"k{i}", E(b"x" * 1000, 0.0, None))
        lru.get(f"k{i}")
    return lru.protected_bytes, lru.probation_bytes, lru.entries


def _slru_eviction_order(c, E, w):
    lru = c.SegmentedLRU(3_000)
    lru.put("hot", E(b"x" * 1000, 0.0, None))
    lru.get("hot")
    lru.put("cold1", E(b"x" * 1000, 0.0, None))
    lru.put("cold2", E(b"x" * 1000, 0.0, None))
    evicted = lru.put("cold3", E(b"x" * 1000, 0.0, None))
    return [k for k, _ in evicted], "hot" in lru


@pytest.mark.parametrize("case,want", [
    (_slru_scan, ([True] * 5, None, None)),
    (_slru_overflow, None),
    (_slru_eviction_order, (["cold1"], True)),
])
def test_slru_equal(case, want):
    got = _both(case)
    if want is not None and case is _slru_scan:
        assert got[0] == want[0]
    elif want is not None:
        assert got == want
    if case is _slru_overflow:
        assert got[0] <= 2_000 and got[2] == 3


def _admission(c, E, w):
    cc = c.ChunkCache(8_192, admission_max_fraction=0.125)
    out = (cc.put("big", b"z" * 2_000), cc.admission_rejects,
           cc.get("big"), cc.put("ok", b"z" * 500), cc.get("ok"))
    cc.close()
    return out


def _oversized_to_disk(c, E, w):
    cc = c.ChunkCache(8_192, admission_max_fraction=0.125,
                      disk_dir=str(w / "d"))
    out = (cc.put("big", _payload("big", 2_000)), cc.admission_rejects,
           cc.stats()["memory_entries"],
           cc.get("big") == _payload("big", 2_000))
    cc.close()
    return out


def _ttl_clock(c, E, w):
    now = [1000.0]
    cc = c.ChunkCache(1 << 20, ttl_seconds=10.0, disk_dir=str(w / "d"),
                      clock=lambda: now[0])
    cc.put("k", b"v")
    first = cc.get("k")
    now[0] += 11.0
    out = (first, cc.get("k"), "k" in cc)
    cc.close()
    return out


def _per_put_ttl(c, E, w):
    now = [0.0]
    cc = c.ChunkCache(1 << 20, ttl_seconds=0.0, clock=lambda: now[0])
    cc.put("forever", b"a")
    cc.put("brief", b"b", ttl=5.0)
    now[0] = 6.0
    out = (cc.get("forever"), cc.get("brief"))
    cc.close()
    return out


def _demote_promote(c, E, w):
    cc = c.ChunkCache(2_048, admission_max_fraction=0.5,
                      disk_dir=str(w / "d"))
    for k in "abc":
        cc.put(k, _payload(k, 1000))
    disk = cc.stats()["disk_entries"]
    out = (disk >= 1, cc.get("a") == _payload("a", 1000),
           cc.stats()["hits"], "a" in cc)
    cc.close()
    return out


def _invalidate_key(c, E, w):
    cc = c.ChunkCache(1 << 20, disk_dir=str(w / "d"))
    cc.put("k", b"v", volume=7)
    cc.invalidate("k")
    out = (cc.get("k"), cc.invalidate_volume(7))
    cc.close()
    return out


def _invalidate_volume(c, E, w):
    cc = c.ChunkCache(1 << 20,
                      metrics=c.chunk_cache.Metrics(namespace="t"))
    cc.put("v1a", b"x", volume=1)
    cc.put("v1b", b"y", volume=1)
    cc.put("v2", b"z", volume=2)
    out = (cc.invalidate_volume(1), cc.get("v1a"), cc.get("v1b"),
           cc.get("v2"), cc.per_volume_counts())
    cc.close()
    return out


def _registry(c, E, w):
    c1, c2 = c.ChunkCache(1 << 20), c.ChunkCache(1 << 20)
    c1.put("k1", b"a", volume=9)
    c2.put("k2", b"b", volume=9)
    before = c.invalidation.events.get("test", 0)
    c.invalidation.volume_invalidated(9, reason="test")
    out = (c1.get("k1"), c2.get("k2"),
           c.invalidation.events.get("test", 0) - before)
    c1.close()
    c2.close()
    return out


def _crash_restart_reload(c, E, w):
    d = str(w / "d")
    cc = c.ChunkCache(250, admission_max_fraction=1.0, disk_dir=d)
    for i in range(5):
        cc.put(f"k{i}", _payload(f"k{i}"), volume=i % 2)
    cc.close()
    c2 = c.ChunkCache(250, admission_max_fraction=1.0, disk_dir=d)
    out = ([c2.get(f"k{i}") == _payload(f"k{i}") for i in range(4)],
           c2.invalidate_volume(1) >= 1)
    c2.close()
    return out


def _torn_tail(c, E, w):
    d = w / "d"
    t = c.DiskTier(d, capacity_bytes=1 << 20, segments=2)
    t.put("whole", _payload("whole"), None, 0.0)
    t.close()
    with open(d / "cache_0.dat", "ab") as f:
        f.write(b"\xc5\x00\x00")
    t2 = c.DiskTier(d, capacity_bytes=1 << 20, segments=2)
    got = t2.get("whole")
    out = (got is not None and got[0] == _payload("whole"), t2.entries,
           (d / "cache_0.dat").read_bytes())
    t2.close()
    return out


def _rotation(c, E, w):
    t = c.DiskTier(w / "d", capacity_bytes=8_192, segments=2)
    for i in range(40):
        t.put(f"k{i}", _payload(f"k{i}", 500), None, 0.0)
    out = (t.evictions, t.bytes, t.get("k39")[0] == _payload("k39", 500),
           sorted(p.name for p in (w / "d").iterdir()))
    t.close()
    return out


def _zipf(c, E, w):
    hot = [f"obj{i}" for i in range(10)]
    cold = [f"obj{i}" for i in range(10, 100)]
    cc = c.ChunkCache(16_000, admission_max_fraction=0.2)
    rng = random.Random(42)
    fetches = 0
    for _ in range(4000):
        k = rng.choice(hot) if rng.random() < 0.9 else rng.choice(cold)
        b = cc.get(k)
        if b is None:
            fetches += 1
            cc.put(k, _payload(k, 1000))
    st = cc.stats()
    cc.close()
    return st["hits"], st["misses"], st["evictions"], fetches


CASES = {"admission": (_admission, (False, 1, None, True, b"z" * 500)),
         "oversized_to_disk": (_oversized_to_disk, (True, 1, 0, True)),
         "ttl_clock": (_ttl_clock, (b"v", None, False)),
         "per_put_ttl": (_per_put_ttl, (b"a", None)),
         "demote_promote": (_demote_promote, (True, True, 1, True)),
         "invalidate_key": (_invalidate_key, (None, 0)),
         "invalidate_volume": (_invalidate_volume, None),
         "registry": (_registry, (None, None, 1)),
         "crash_restart_reload": (_crash_restart_reload,
                                  ([True] * 4, True)),
         "torn_tail": (_torn_tail, None),
         "rotation": (_rotation, None),
         "zipf": (_zipf, None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_scenario_equal(case, tmp_path):
    fn, want = CASES[case]
    got = _both(fn, tmp_path)
    if want is not None:
        assert got == want
    if case == "invalidate_volume":
        assert got[:4] == (2, None, None, b"z")
    if case == "torn_tail":
        assert got[:2] == (True, 1)
    if case == "rotation":
        assert got[0] > 0 and got[1] <= 8_192 and got[2]
    if case == "zipf":
        hits, misses, _ev, fetches = got
        assert hits + misses == 4000 and hits / 4000 >= 0.80
        assert fetches == misses


def test_seeded_sequence_equal_counts_and_segment_bytes(tmp_path):
    """The same seeded get/put/invalidate sequence through both caches
    (two tiers, fixed clock) gives equal hits, misses, rejects and
    evictions at every step, and byte-equal disk-tier segment files."""
    def run(c, E, w):
        # a registry of its own: the default one is process-wide
        cc = c.ChunkCache(16_384, admission_max_fraction=0.25,
                          disk_dir=str(w / "d"), disk_capacity_bytes=32_768,
                          disk_segments=3, clock=lambda: 5000.0,
                          metrics=c.chunk_cache.Metrics(namespace="t"))
        rng = random.Random(1234)
        keys = [f"key{i}" for i in range(80)]
        trace = []
        for step in range(3000):
            k = rng.choice(keys)
            r = rng.random()
            if r < 0.6:
                got = cc.get(k)
                assert got is None or got == _payload(k, 300 + len(k) * 40)
            elif r < 0.95:
                cc.put(k, _payload(k, 300 + len(k) * 40),
                       volume=int(k[3:]) % 5,
                       ttl=None if r < 0.9 else 100.0)
            elif r < 0.98:
                cc.invalidate(k)
            else:
                cc.invalidate_volume(rng.randrange(5))
            if step % 100 == 0:
                trace.append((cc.hits, cc.misses, cc.admission_rejects,
                              cc.evictions))
        st = cc.stats()
        assert st.pop("disk_dir") == str(w / "d")
        counts = cc.per_volume_counts()
        cc.close()
        segs = {p.name: p.read_bytes()
                for p in sorted((w / "d").iterdir())}
        return trace, st, counts, segs

    trace, st, counts, segs = _both(run, tmp_path)
    assert st["hits"] > 0 and st["misses"] > 0 and st["evictions"] > 0
    assert len(segs) == 3 and all(segs.values())


def test_crash_disktier_append_fires_at_the_same_record(tmp_path):
    """``crash.disktier.append`` (in the port's catalog) fires after a
    record is written and before it is indexed; the reloaded tiers of
    both packages agree record for record."""
    assert "crash.disktier.append" in port_faults.CATALOG

    class Crash(Exception):
        pass

    def boom(point):
        raise Crash(point)

    got = {}
    for name, faults in (("jax", jax_faults), ("port", port_faults)):
        c = PKGS[name][0]
        d = tmp_path / name
        t = c.DiskTier(d, capacity_bytes=1 << 20, segments=2)
        for i in range(3):
            t.put(f"k{i}", _payload(f"k{i}"), i, 0.0)
        faults.set_crash_handler(boom)
        faults.inject("crash.disktier.append", "crash#1")
        try:
            with pytest.raises(Crash, match="crash.disktier.append"):
                t.put("k3", _payload("k3"), 3, 0.0)
        finally:
            faults.clear()
            faults.set_crash_handler(None)
        indexed = t.get("k3")
        t.close()
        t2 = c.DiskTier(d, capacity_bytes=1 << 20, segments=2)
        got[name] = (indexed, [t2.get(f"k{i}") for i in range(4)],
                     (d / "cache_0.dat").read_bytes())
        t2.close()
    assert got["port"] == got["jax"]
    indexed, reloaded, _ = got["port"]
    assert indexed is None       # the crash came before the index
    assert reloaded[0][0] == _payload("k0")


def test_concurrent_readers_writers_and_invalidation(tmp_path):
    c = port_cache.ChunkCache(32_768, admission_max_fraction=0.5,
                              disk_dir=str(tmp_path / "d"),
                              disk_capacity_bytes=65_536, disk_segments=2)
    keys = [f"key{i}" for i in range(64)]
    errors: list[str] = []

    def worker(seed: int) -> None:
        rng = random.Random(seed)
        try:
            for _ in range(1500):
                k = rng.choice(keys)
                got = c.get(k)
                if got is None:
                    c.put(k, _payload(k), volume=int(k[3:]) % 4)
                elif got != _payload(k):
                    errors.append(f"corrupt read for {k}")
                    return
                if rng.random() < 0.01:
                    c.invalidate_volume(rng.randrange(4))
                if rng.random() < 0.005:
                    c.invalidate(rng.choice(keys))
        except Exception as e:  # noqa: BLE001 — surfaced via errors
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "stress worker wedged"
    assert errors == []
    st = c.stats()
    assert st["hits"] > 0 and st["misses"] > 0
    c.close()


def test_shell_cache_status_and_clear_print_the_same_lines(tmp_path):
    """The offline shells' ``cache.status`` and ``cache.clear`` over each
    package's global cache print the same lines."""
    from seaweedfs_tpu.shell import commands as jax_commands
    from seaweedfs_tpu.storage.store import Store as JaxStore
    from seaweedfs_tpu_torch.shell import commands as port_commands
    from seaweedfs_tpu_torch.storage.store import Store as PortStore

    outs = {}
    for name, cmds, store_cls in (("jax", jax_commands, JaxStore),
                                  ("port", port_commands, PortStore)):
        c = PKGS[name][0]
        c.configure_global(disk_dir=str(tmp_path / name / "d"))
        try:
            cache = c.global_chunk_cache()
            cache.put("k", b"x" * 64)
            cache.get("k")
            cache.get("nope")
            (tmp_path / name / "s").mkdir()
            out = io.StringIO()
            kw = dict(device="cpu") if name == "port" else {}
            env = cmds.CommandEnv(store=store_cls([str(tmp_path / name /
                                                       "s")]), out=out, **kw)
            cmds.run_command(env, "cache.status")
            cmds.run_command(env, "cache.clear")
            assert cache.get("k") is None
            env.store.close()
            outs[name] = out.getvalue()
        finally:
            c.configure_global()
    # the invalidation counters are process-wide and differ by history
    strip = [l for l in outs["port"].splitlines()
             if not l.lstrip().startswith("invalidations:")]
    assert strip == [l for l in outs["jax"].splitlines()
                     if not l.lstrip().startswith("invalidations:")]
    assert "hits=1" in outs["port"] and "disk:" in outs["port"]
    assert "dropped 1 entries" in outs["port"]


def test_from_config_honors_scaffold_knobs(tmp_path):
    assert port_config.scaffold("cache") == jax_config.scaffold("cache")

    def run(c, E, w):
        cfg = port_config if c is port_cache else jax_config
        p = w / "cache.toml"
        p.write_text(cfg.scaffold("cache").replace(
            'dir = ""', f'dir = "{w / "tier"}"'))
        cc = c.from_config(cfg.load(p))
        st = cc.stats()
        out = (st["memory_capacity"], st["disk_capacity"], cc.admission_max)
        cc.close()
        return out

    assert _both(run, tmp_path) == (67108864, 268435456,
                                    int(67108864 * 0.125))


def test_readahead_stats_keys_equal():
    assert sorted(port_cache.readahead.stats()) == \
        sorted(jax_cache.readahead.stats())
    assert Path(port_cache.readahead.__file__).parent.name == "cache"


def test_caches_without_a_registry_share_per_volume_counts():
    """A reference quirk the port keeps: ``ChunkCache`` objects built
    without ``metrics=`` share the default registry, so their
    ``per_volume_counts`` (the heartbeat's source) are one set of
    counters. Volume servers pass their own registry, so only caches
    built bare (tests, a second gateway cache in one process) see it."""
    def run(c, E, w):
        one, two = c.ChunkCache(1 << 20), c.ChunkCache(1 << 20)
        base = one.per_volume_counts().get(9_999, {}).get("hits", 0)
        for cc in (one, two):
            cc.put("k", b"v", volume=9_999)
            cc.get("k")
        out = (one.per_volume_counts()[9_999]["hits"] - base,
               two.per_volume_counts()[9_999]["hits"] - base,
               one.hits, two.hits)
        one.close()
        two.close()
        return out

    assert _both(run) == (2, 2, 1, 1)
