"""Cache invalidation in the port against the JAX package: vacuum and EC
rebuild drop stale entries, the port volume server's post-decode cache
pays the decode once for a hot EC needle (as the JAX server's does), a
DELETE and ``POST /cache/invalidate`` drop entries, and the master's hub
fans job commits out to subscribed filers and volume servers across
packages. Mirrors ``tests/test_cache_invalidation.py``; port servers run
``device="cpu"``."""

import json
import time
import types
import urllib.request

import pytest
from torch_teardown import collect_jax_garbage  # noqa: F401

from seaweedfs_tpu.cache import invalidation as jax_invalidation
from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.pipeline.encode import encode_volume as jax_encode_volume
from seaweedfs_tpu.pipeline.read import EcVolumeReader as JaxEcVolumeReader
from seaweedfs_tpu.storage.store import Store as JaxStore
from seaweedfs_tpu_torch.cache import ChunkCache, invalidation
from seaweedfs_tpu_torch.cluster import filer_server, master
from seaweedfs_tpu_torch.cluster import volume_server
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.ops import rs_torch
from seaweedfs_tpu_torch.pipeline.encode import encode_volume
from seaweedfs_tpu_torch.pipeline.read import EcVolumeReader
from seaweedfs_tpu_torch.pipeline.rebuild import rebuild_ec_files
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage import vacuum as vacuum_mod
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import FileId
from seaweedfs_tpu_torch.storage.volume import generate_synthetic_volume

from test_cluster_integration import _free_port_pair

TEST_SCHEME = EcScheme(data_shards=10, parity_shards=4,
                       large_block_size=2048, small_block_size=256)


def test_vacuum_drops_stale_cache_entries(tmp_path):
    """write -> cache-warm -> overwrite -> vacuum -> read is fresh."""
    base = tmp_path / "3"
    vol = generate_synthetic_volume(base, 3, n_needles=20, seed=1)
    cache = ChunkCache(1 << 20)

    def read_through(key: int) -> bytes:
        ck = f"vol3:{key}"
        b = cache.get(ck)
        if b is None:
            b = vol.read_needle(key).data
            cache.put(ck, b, volume=3)
        return b

    old = read_through(5)
    assert read_through(5) == old
    fresh = b"fresh-bytes-after-overwrite" * 4
    n5 = vol.read_needle(5)
    vol.write_needle(Needle(cookie=n5.cookie, id=5, data=fresh,
                            append_at_ns=1_800_000_000_000_000_000))
    assert read_through(5) == old            # stale, still served
    before = invalidation.events.get("vacuum", 0)
    assert vacuum_mod.vacuum(vol, threshold=0.0) is not None
    assert invalidation.events.get("vacuum", 0) == before + 1
    assert read_through(5) == fresh
    cache.close()
    vol.close()


def test_ec_rebuild_invalidates_volume(tmp_path, monkeypatch):
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 1)   # plain versions
    base = tmp_path / "7"
    vol = generate_synthetic_volume(base, 7, n_needles=60, avg_size=300,
                                    seed=2)
    vol.close()
    encode_volume(base, TEST_SCHEME, device="cpu")
    ec_files.shard_path(base, 2).unlink()
    cache = ChunkCache(1 << 20)
    cache.put("ec:7:1:0", b"decoded-needle", volume=7)
    before = invalidation.events.get("ec-rebuild", 0)
    assert rebuild_ec_files(base, TEST_SCHEME, device="cpu") == [2]
    assert cache.get("ec:7:1:0") is None
    assert invalidation.events.get("ec-rebuild", 0) == before + 1
    cache.close()


def _ec_only_store(tmp_path, store_cls, encode, lost=()):
    """A store of one package holding only the EC artifacts of volume 7
    (sealed by the JAX package; .dat/.idx gone, ``lost`` shards too)."""
    base = tmp_path / "7"
    vol = generate_synthetic_volume(base, 7, n_needles=40, avg_size=300,
                                    seed=3)
    wanted = {k: vol.read_needle(k) for k in (1, 2, 3)}
    vol.close()
    encode(base)
    (tmp_path / "7.dat").unlink()
    (tmp_path / "7.idx").unlink()
    for s in lost:
        ec_files.shard_path(base, s).unlink()
    st = store_cls([tmp_path])
    st.load_existing()
    return st, wanted


@pytest.mark.parametrize("lost", [(), (0, 5, 11, 13)])
def test_hot_ec_needle_decodes_once(tmp_path, monkeypatch, lost):
    """Repeated reads of a hot needle on a sealed volume hit the
    post-decode cache: one decode for five reads, in the port's volume
    server as in the JAX one; with shards lost, one repair."""
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 1)
    calls = {"jax": 0, "port": 0}

    def counting(pkg, orig):
        def read_record(self, key):
            calls[pkg] += 1
            return orig(self, key)
        return read_record

    monkeypatch.setattr(JaxEcVolumeReader, "read_record",
                        counting("jax", JaxEcVolumeReader.read_record))
    monkeypatch.setattr(EcVolumeReader, "read_record",
                        counting("port", EcVolumeReader.read_record))
    got = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        store_cls = JaxStore if pkg == "jax" else Store
        st, wanted = _ec_only_store(d, store_cls, jax_encode_volume, lost)
        vs = (jax_volume_server.VolumeServer(st) if pkg == "jax" else
              volume_server.VolumeServer(st, device="cpu"))
        n1, n2 = wanted[1], wanted[2]
        fid = FileId(volume_id=7, key=1, cookie=n1.cookie)
        reads = [vs.read_bytes(7, fid) for _ in range(5)]
        assert all(r == n1.data for r in reads)
        after_hot = calls[pkg]
        assert vs.read_bytes(7, FileId(7, 2, n2.cookie)) == n2.data
        after_other = calls[pkg]
        # invalidation (vacuum/rebuild would do this) forces a re-decode
        (jax_invalidation if pkg == "jax" else
         invalidation).volume_invalidated(7, reason="test")
        assert vs.read_bytes(7, fid) == n1.data
        got[pkg] = (after_hot, after_other, calls[pkg],
                    vs.chunk_cache.per_volume_counts().get(7))
        vs.chunk_cache.close()
        st.close()
    assert got["port"][:3] == got["jax"][:3] == (1, 2, 3)
    assert got["port"][3] == {"hits": 4, "misses": 3}


def test_volume_server_delete_and_post_invalidate(tmp_path):
    """A cached EC entry goes on ``chunk_cache.invalidate``, and on a
    ``POST /cache/invalidate`` to a started port server; a bad body is a
    400."""
    st, wanted = _ec_only_store(tmp_path, Store, jax_encode_volume)
    vs = volume_server.VolumeServer(st, port=_free_port_pair(),
                                    device="cpu").start()
    try:
        n3 = wanted[3]
        fid = FileId(volume_id=7, key=3, cookie=n3.cookie)
        assert vs.read_bytes(7, fid) == n3.data
        key = vs._ec_cache_key(7, fid)
        assert key in vs.chunk_cache
        vs.chunk_cache.invalidate(key)
        assert key not in vs.chunk_cache
        assert vs.read_bytes(7, fid) == n3.data and key in vs.chunk_cache

        def post(body: bytes):
            req = urllib.request.Request(
                f"http://{vs.url}/cache/invalidate", data=body,
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        before = invalidation.events.get("remote:vacuum", 0)
        assert post(json.dumps({"volumeId": 7, "reason": "vacuum"})
                    .encode()) == (200, {"ok": True, "volumeId": 7})
        assert key not in vs.chunk_cache
        assert invalidation.events.get("remote:vacuum", 0) == before + 1
        assert post(b"{}")[0] == 400
    finally:
        vs.stop()


def _post_json(url: str) -> dict:
    req = urllib.request.Request(url, data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("master_pkg", ["port", "jax"])
def test_hub_fans_job_commits_out_to_filers_and_servers(tmp_path,
                                                        master_pkg):
    """A filer's chunk cache subscribes to the master's hub; a committed
    mutating job task fans ``/cache/invalidate`` out to it and to every
    other volume server; a read-only task kind fans nothing out; a reaped
    node is forgotten. The port master and the JAX master reach port
    filers and servers alike."""
    m_mod = master if master_pkg == "port" else jax_master
    ms = m_mod.MasterServer(port=_free_port_pair(), pulse_seconds=0.2,
                            seed=3).start()
    d = tmp_path / "v"
    d.mkdir()
    vs = volume_server.VolumeServer(Store([d]), port=_free_port_pair(),
                                    master_url=ms.url, pulse_seconds=0.2,
                                    device="cpu").start()
    fs = filer_server.FilerServer(Filer(), port=_free_port_pair(),
                                  master_url=ms.url).start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and (
                fs.url not in ms.cache_hub.to_map()
                or len(ms.topology.nodes) < 1):
            time.sleep(0.05)
        assert fs.url in ms.cache_hub.to_map()
        assert _post_json(f"http://{ms.url}/cluster/cache_subscribe"
                          f"?url={fs.url}")["ok"] is True
        before = invalidation.events.get("remote:vacuum", 0)
        ms._job_task_committed(types.SimpleNamespace(
            kind="vacuum", volume_id=42, worker="127.0.0.1:1"))
        # the filer and the volume server both got one event
        assert invalidation.events.get("remote:vacuum", 0) == before + 2
        assert ms.cache_hub.to_map()[fs.url]["sent"] >= 1
        ms._job_task_committed(types.SimpleNamespace(
            kind="scrub", volume_id=42, worker="127.0.0.1:1"))
        assert invalidation.events.get("remote:vacuum", 0) == before + 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_json(f"http://{ms.url}/cluster/cache_subscribe")
        assert ei.value.code == 400
        ms.cache_hub.forget(fs.url)
        assert fs.url not in ms.cache_hub.to_map()
    finally:
        fs.stop()
        vs.stop()
        ms.stop()
