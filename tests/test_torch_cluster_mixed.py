"""A mixed cluster on the CPU: the JAX package's volume server beside the
port's, under one JAX master, and the JAX cluster shell driving servers
of the port alone.

Every byte crosses between the packages over the wire only (``CopyFile``,
``VolumeCopy``, ``VolumeEcShardRead``, HTTP): a volume one package
sealed is read by the other, shard reads cross packages in both
directions, and each side's ``/status`` has the same shape. The port's
servers run ``device="cpu"``."""

import hashlib
import io
import json
import shutil
import time
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest

from seaweedfs_tpu.cluster import operation
from seaweedfs_tpu.cluster.master import MasterServer
from seaweedfs_tpu.cluster.volume_server import VolumeServer as JaxServer
from seaweedfs_tpu.cluster.wdclient import MasterClient
from seaweedfs_tpu.shell.cluster_commands import (ClusterEnv,
                                                  run_cluster_command)
from seaweedfs_tpu.storage.store import Store as JaxStore
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer, _grpc_port
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import FileId

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _wait_nodes(master, n, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and len(master.topology.nodes) < n:
        time.sleep(0.05)
    assert len(master.topology.nodes) >= n, "volume servers never joined"


def _settle(servers):
    for vs in servers:
        vs.heartbeat_now()
    time.sleep(2.5 * PULSE)


def _stub(vs):
    ch = grpc.insecure_channel(f"127.0.0.1:{_grpc_port(vs.port)}")
    return pb.volume_stub(ch), ch


def _get(url) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _post(url, data: bytes) -> None:
    req = urllib.request.Request(url, data=data, method="POST")
    urllib.request.urlopen(req, timeout=30).read()


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A JAX master; server 0 is the JAX package's, 1 and 2 the port's."""
    master = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                          pulse_seconds=PULSE, seed=17).start()
    servers = [JaxServer(JaxStore([tmp_path_factory.mktemp("jax0")]),
                         port=_free_port_pair(), master_url=master.url,
                         pulse_seconds=PULSE).start()]
    for i in (1, 2):
        servers.append(VolumeServer(
            Store([tmp_path_factory.mktemp(f"port{i}")]),
            port=_free_port_pair(), master_url=master.url,
            pulse_seconds=PULSE, device="cpu").start())
    _wait_nodes(master, 3)
    yield master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def _fill(vs, vid: int, collection: str, n: int, seed: int) -> dict:
    """Allocate ``vid`` on ``vs`` and POST ``n`` needles: fid -> bytes.
    The volume spans two 1 MiB blocks, so shards 0 and 1 hold data."""
    stub, ch = _stub(vs)
    stub.AllocateVolume(vpb.AllocateVolumeRequest(volume_id=vid,
                                                  collection=collection))
    ch.close()
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1, n + 1):
        fid = FileId(vid, i, int(rng.integers(0, 2**32)))
        blob = rng.integers(0, 256, int(rng.integers(40_000, 80_000)),
                            dtype=np.uint8).tobytes()
        _post(f"http://{vs.url}/{fid}?collection={collection}", blob)
        out[str(fid)] = blob
    return out


@pytest.mark.parametrize("sealer", [0, 1], ids=["jax_seals", "port_seals"])
def test_shards_spread_over_both_packages_serve_every_needle(mixed,
                                                             tmp_path,
                                                             sealer):
    """One package's server seals a volume; its shards spread over all
    three servers with shard 0 lost; a GET on each server pulls the
    shards it lacks from servers of the other package over
    ``VolumeEcShardRead`` and reconstructs shard 0's intervals. The
    sealed files equal what the other package seals from a copy of the
    same volume."""
    master, servers = mixed
    vid = 40 + sealer
    col = f"mix{sealer}"
    owner = servers[sealer]
    blobs = _fill(owner, vid, col, 30, seed=vid)
    stub, ch = _stub(owner)
    stub.VolumeMarkReadonly(vpb.VolumeMarkReadonlyRequest(
        volume_id=vid, collection=col))
    base = owner.store.get_volume(vid, col).base
    ref = tmp_path / base.name
    for ext in (".dat", ".idx"):
        shutil.copyfile(str(base) + ext, str(ref) + ext)
    stub.VolumeEcShardsGenerate(vpb.VolumeEcShardsGenerateRequest(
        volume_id=vid, collection=col))
    # the other package seals the copy: the same files
    if sealer == 0:
        from seaweedfs_tpu_torch.pipeline.encode import encode_volume
        encode_volume(ref, device="cpu")
    else:
        from seaweedfs_tpu.pipeline.encode import encode_volume
        encode_volume(ref)
    names = [ec_files.shard_ext(i) for i in range(14)] + [".ecx", ".vif"]
    assert {n: _sha(str(base) + n) for n in names} == \
        {n: _sha(str(ref) + n) for n in names}

    # spread: the owner keeps 1-4, the next server takes 5-9, the last
    # 10-13; shard 0 is lost everywhere
    others = [vs for vs in servers if vs is not owner]
    plan = {owner: list(range(1, 5)), others[0]: list(range(5, 10)),
            others[1]: list(range(10, 14))}
    for vs in others:
        s, c = _stub(vs)
        s.VolumeEcShardsCopy(vpb.VolumeEcShardsCopyRequest(
            volume_id=vid, collection=col, shard_ids=plan[vs],
            copy_ecx_file=True, copy_vif_file=True,
            source_data_node=owner.url))
        s.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
            volume_id=vid, collection=col, shard_ids=plan[vs]))
        c.close()
    stub.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection=col,
        shard_ids=[0] + list(range(5, 14))))
    stub.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
        volume_id=vid, collection=col, shard_ids=plan[owner]))
    stub.VolumeDelete(vpb.VolumeDeleteRequest(volume_id=vid,
                                              collection=col))
    ch.close()
    for vs in others:
        vbase = vs.store.ec_base(vid, col)
        for i in plan[vs]:
            assert _sha(ec_files.shard_path(vbase, i)) == \
                _sha(ec_files.shard_path(ref, i))
    _settle(servers)
    for vs in servers:
        got = {fid: _get(f"http://{vs.url}/{fid}?collection={col}")
               for fid in blobs}
        assert got == blobs, f"reads through {type(vs).__module__}"
    # the port's readers rebuilt shard 0's intervals from remote shards
    for vs in servers[1:]:
        assert vs.metrics.counter("ec_intervals_repaired").value > 0


def test_status_has_the_same_shape_on_both_sides(mixed):
    """A volume written on the JAX server and copied to a port server
    (``VolumeCopy`` over the JAX server's ``CopyFile``): both
    ``/status`` documents have the same keys and an equal row for it."""
    master, servers = mixed
    jax_vs, port_vs = servers[0], servers[1]
    blobs = _fill(jax_vs, 60, "st", 5, seed=60)
    stub, ch = _stub(port_vs)
    stub.VolumeCopy(vpb.VolumeCopyRequest(
        volume_id=60, collection="st", source_data_node=jax_vs.url))
    ch.close()
    docs = [json.loads(_get(f"http://{vs.url}/status"))
            for vs in (jax_vs, port_vs)]
    assert docs[0].keys() == docs[1].keys()
    rows = [[dict(r, modified_at_second=0) for r in d["volumes"]
             if r["id"] == 60] for d in docs]
    assert rows[0] == rows[1] and len(rows[0]) == 1
    for d in docs:
        for r in d["volumes"]:
            assert r.keys() == rows[0][0].keys()
    for fid, blob in blobs.items():
        assert _get(f"http://{port_vs.url}/{fid}?collection=st") == blob


@pytest.fixture()
def port_cluster(tmp_path):
    master = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                          pulse_seconds=PULSE, seed=1).start()
    servers = []
    for i in range(3):
        d = tmp_path / f"vol{i}"
        d.mkdir()
        servers.append(VolumeServer(
            Store([d], max_volumes=8), port=_free_port_pair(),
            master_url=master.url, data_center="dc1", rack=f"r{i % 2}",
            pulse_seconds=PULSE, device="cpu").start())
    _wait_nodes(master, 3)
    yield master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def test_jax_cluster_shell_drives_port_servers(port_cluster, tmp_path):
    """``ec.encode``, ``ec.rebuild`` and ``ec.decode`` of the JAX cluster
    shell against port servers alone, as tests/test_cluster_shell.py
    runs them against JAX servers: every needle reads back at each step
    and the decoded .dat and .idx are sha256-equal to the originals."""
    master, servers = port_cluster
    mc = MasterClient(master.url)
    rng = np.random.default_rng(3)
    blobs = [rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
             for _ in range(15)]
    fids = operation.submit(mc, blobs)
    vid = int(fids[0].split(",")[0])
    keep = [(f, b) for f, b in zip(fids, blobs)
            if int(f.split(",")[0]) == vid]
    owner = next(vs for vs in servers if vs.store.has_volume(vid))
    obase = owner.store.get_volume(vid).base
    owner.store.get_volume(vid).sync()
    orig = {ext: _sha(str(obase) + ext) for ext in (".dat", ".idx")}

    out = io.StringIO()
    env = ClusterEnv(master_url=master.url, out=out)
    run_cluster_command(env, f"ec.encode -volumeId {vid}")
    assert "shards over" in out.getvalue()
    _settle(servers)
    assert not any(vs.store.has_volume(vid) for vs in servers)
    holders = [vs for vs in servers
               if any(v == vid for (_c, v) in vs.store.ec_mounts)]
    assert len(holders) >= 2
    mc.invalidate()
    for fid, want in keep:
        assert operation.download(mc, fid) == want

    # lose the shard holding the needles (the volume fits in shard 0)
    victim = next(vs for vs in holders
                  if 0 in next(m for (c, v), m in vs.store.ec_mounts.items()
                               if v == vid).shard_ids)
    m = next(m for (c, v), m in victim.store.ec_mounts.items() if v == vid)
    ec_files.shard_path(m.base, 0).unlink()
    victim.store.unmount_ec_shards(vid, [0])
    _settle(servers)
    for fid, want in keep:
        assert operation.download(mc, fid) == want
    run_cluster_command(env, "ec.rebuild")
    assert "rebuilt [0]" in out.getvalue()
    _settle(servers)
    assert sorted(master.topology.lookup_ec_volume(vid)) == list(range(14))

    run_cluster_command(env, f"ec.decode -volumeId {vid}")
    _settle(servers)
    back = [vs for vs in servers if vs.store.has_volume(vid)]
    assert len(back) == 1
    vbase = back[0].store.get_volume(vid).base
    assert {ext: _sha(str(vbase) + ext) for ext in (".dat", ".idx")} == orig
    mc.invalidate()
    for fid, want in keep:
        assert operation.download(mc, fid) == want
    mc.close()
    env.close()
