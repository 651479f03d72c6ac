"""The port's volume server (seaweedfs_tpu_torch/cluster/volume_server.py)
in a cluster led by the JAX package's master, on the CPU.

Three port servers join one JAX ``MasterServer`` over real localhost
gRPC and HTTP, as ``tests/test_cluster_integration.py`` runs three JAX
servers; the JAX client library (``cluster/operation``) writes, reads
and deletes through them. The gRPC EC choreography (generate, spread,
reconstruct-on-read, rebuild, to-volume) is held sha256-equal to the
JAX package's ``encode_volume`` on a copy of the same volume. Then the
data plane's HTTP (ranges, HEAD, 404, ``/metrics``), JWT on writes and
gRPC, and the entry points (``python -m seaweedfs_tpu_torch volume``,
the refused ``-config`` sections, the refusal without a card). Every
server runs ``device="cpu"``: the plain PyTorch codec, and the native
host codec below ``rs_torch.DEVICE_MIN_S``."""

import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch

from conftest import parse_exposition
from seaweedfs_tpu.cluster import operation
from seaweedfs_tpu.cluster.master import MasterServer
from seaweedfs_tpu.cluster.volume_server import VolumeServer as JaxServer
from seaweedfs_tpu.cluster.wdclient import MasterClient
from seaweedfs_tpu.pipeline.encode import encode_volume as jax_encode_volume
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage.store import Store as JaxStore
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.cluster import volume_server
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer, _grpc_port
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import FileId
from seaweedfs_tpu_torch.util.stats import EXPOSITION_CONTENT_TYPE

from test_cluster_integration import _free_port_pair

PULSE = 0.2
REPO = Path(__file__).resolve().parent.parent


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _sealed(base) -> dict:
    names = [ec_files.shard_ext(i) for i in range(14)] + [".ecx", ".vif"]
    return {n: _sha(str(base) + n) for n in names}


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


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    master = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                          pulse_seconds=PULSE, seed=42).start()
    servers = []
    for i in range(3):
        d = tmp_path_factory.mktemp(f"pvol{i}")
        vs = VolumeServer(Store([d], max_volumes=8), port=_free_port_pair(),
                          master_url=master.url, data_center="dc1",
                          rack=f"r{i % 2}", pulse_seconds=PULSE,
                          device="cpu").start()
        servers.append(vs)
    _wait_nodes(master, 3)
    yield master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def test_write_read_delete_cycle(cluster):
    master, servers = cluster
    mc = MasterClient(master.url)
    payloads = [bytes([i]) * (100 + i) for i in range(20)]
    fids = operation.submit(mc, payloads)
    assert len(fids) == 20
    for fid, want in zip(fids, payloads):
        assert operation.download(mc, fid) == want
    operation.delete(mc, fids[0])
    mc.invalidate()
    with pytest.raises(Exception):
        operation.download(mc, fids[0])
    # every write landed on a port server's own store
    assert sum(len(vs.store.volumes) for vs in servers) >= 1
    mc.close()


def test_replicated_write_lands_on_both_replicas(cluster):
    master, servers = cluster
    mc = MasterClient(master.url)
    a = operation.assign(mc, collection="rep", replication="010")
    operation.upload(a.url, a.fid, b"replica-me", jwt=a.auth,
                     collection="rep")
    vid = int(a.fid.split(",")[0])
    _settle(servers)
    holders = [vs for vs in servers if vs.store.has_volume(vid, "rep")]
    assert len(holders) == 2
    fid = FileId.parse(a.fid)
    for vs in holders:
        n = vs.store.read_needle(vid, fid.key, fid.cookie, "rep")
        assert n.data == b"replica-me"
    mc.close()


def test_ec_choreography_matches_jax(cluster, tmp_path):
    master, servers = cluster
    mc = MasterClient(master.url)
    rng = np.random.default_rng(7)
    blobs = [rng.integers(0, 256, 2000 + i, dtype=np.uint8).tobytes()
             for i in range(25)]
    fids = operation.submit(mc, blobs, collection="ec")
    vid = int(fids[0].split(",")[0])
    keep = [(f, b) for f, b in zip(fids, blobs)
            if int(f.split(",")[0]) == vid]
    assert keep
    owner = next(vs for vs in servers if vs.store.has_volume(vid, "ec"))
    stub, ch = _stub(owner)
    base = owner.store.get_volume(vid, "ec").base

    # the JAX package seals a copy of the same .dat/.idx
    stub.VolumeMarkReadonly(vpb.VolumeMarkReadonlyRequest(
        volume_id=vid, collection="ec"))
    ref = tmp_path / base.name
    for ext in (".dat", ".idx"):
        shutil.copyfile(str(base) + ext, str(ref) + ext)
    orig = {ext: _sha(str(ref) + ext) for ext in (".dat", ".idx")}
    jax_encode_volume(ref)
    want = _sealed(ref)

    # 1. generate: 14 shards, .ecx and .vif equal to the JAX seal
    stub.VolumeEcShardsGenerate(vpb.VolumeEcShardsGenerateRequest(
        volume_id=vid, collection="ec"))
    assert _sealed(base) == want
    stub.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
        volume_id=vid, collection="ec", shard_ids=list(range(14))))

    # 2. spread shards 7..13 to another port server (CopyFile pull)
    target = next(vs for vs in servers if vs is not owner)
    tstub, tch = _stub(target)
    moved = list(range(7, 14))
    tstub.VolumeEcShardsCopy(vpb.VolumeEcShardsCopyRequest(
        volume_id=vid, collection="ec", shard_ids=moved,
        copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
        source_data_node=owner.url))
    tstub.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
        volume_id=vid, collection="ec", shard_ids=moved))
    stub.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection="ec", shard_ids=moved))
    stub.VolumeDelete(vpb.VolumeDeleteRequest(volume_id=vid,
                                              collection="ec"))
    tbase = target.store.ec_base(vid, "ec")
    for i in moved:
        assert _sha(ec_files.shard_path(tbase, i)) == \
            want[ec_files.shard_ext(i)]
    _settle(servers)

    # 3. every needle reads back from shards on two servers
    mc.invalidate()
    for fid, blob in keep:
        assert operation.download(mc, fid, collection="ec") == blob

    # 4. one shard file lost: reconstruct-on-read still serves (the
    # volume is smaller than one 1 MiB block, so every needle lies in
    # shard 0)
    lost = 0
    ec_files.shard_path(base, lost).unlink()
    owner.store.unmount_ec_shards(vid, [lost], "ec")
    _settle(servers)
    for fid, blob in keep:
        assert operation.download(mc, fid, collection="ec") == blob
    assert owner.metrics.counter("ec_intervals_repaired").value > 0 or \
        target.metrics.counter("ec_intervals_repaired").value > 0

    # 5. rebuild returns [lost], byte-equal to the sealed shard
    resp = stub.VolumeEcShardsRebuild(vpb.VolumeEcShardsRebuildRequest(
        volume_id=vid, collection="ec"))
    assert list(resp.rebuilt_shard_ids) == [lost]
    assert _sha(ec_files.shard_path(base, lost)) == \
        want[ec_files.shard_ext(lost)]

    # 6. to-volume on the owner, after pulling the spread shards back
    stub.VolumeEcShardsCopy(vpb.VolumeEcShardsCopyRequest(
        volume_id=vid, collection="ec", shard_ids=moved,
        source_data_node=target.url))
    stub.VolumeEcShardsToVolume(vpb.VolumeEcShardsToVolumeRequest(
        volume_id=vid, collection="ec"))
    assert {ext: _sha(str(base) + ext) for ext in (".dat", ".idx")} == orig
    assert owner.store.has_volume(vid, "ec")
    for fid, blob in keep:
        f = FileId.parse(fid)
        assert owner.store.read_needle(vid, f.key, f.cookie,
                                       "ec").data == blob
    tstub.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection="ec", shard_ids=moved))
    mc.close()
    ch.close()
    tch.close()


def _get(url, headers=None, method="GET"):
    req = urllib.request.Request(url, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_ranges_head_404_and_metrics(cluster):
    master, servers = cluster
    mc = MasterClient(master.url)
    body = bytes(range(256)) * 4
    a = operation.assign(mc)
    operation.upload(a.url, a.fid, body, jwt=a.auth)
    url = f"http://{a.url}/{a.fid}"
    code, h, got = _get(url, {"Range": "bytes=10-19"})
    assert (code, got) == (206, body[10:20])
    assert h["Content-Range"] == f"bytes 10-19/{len(body)}"
    code, h, got = _get(url, {"Range": "bytes=-5"})
    assert (code, got) == (206, body[-5:])
    code, h, _ = _get(url, {"Range": f"bytes={len(body)}-"})
    assert code == 416 and h["Content-Range"] == f"bytes */{len(body)}"
    code, h, got = _get(url, method="HEAD")
    assert code == 200 and int(h["Content-Length"]) == len(body)
    fid = FileId.parse(a.fid)
    other = FileId(fid.volume_id, fid.key + 12345, fid.cookie)
    assert _get(f"http://{a.url}/{other}")[0] == 404
    assert _get(f"http://{a.url}/{other}", method="HEAD")[0] == 404
    assert _get(f"http://{a.url}/999,01637037d6")[0] == 404
    # left out of the port: image resizing 501, /debug/* 404
    code, _, got = _get(url + "?width=10")
    assert code == 501 and b"not ported" in got
    for path in ("/debug/vars", "/debug/traces", "/debug/profile"):
        assert _get(f"http://{a.url}{path}")[0] == 404
    code, h, got = _get(f"http://{a.url}/metrics")
    assert code == 200 and h["Content-Type"] == EXPOSITION_CONTENT_TYPE
    samples = parse_exposition(got.decode())
    assert any(k.startswith("volume_server_read_requests")
               for k in samples)
    code, _, got = _get(f"http://{a.url}/status")
    doc = json.loads(got)
    assert code == 200 and doc["Version"] == "seaweedfs-tpu"
    assert any(v["id"] == fid.volume_id for v in doc["volumes"])
    mc.close()


def test_tier_rpcs_are_unimplemented(cluster):
    _, servers = cluster
    stub, ch = _stub(servers[0])
    for name, req in (("VolumeTierMoveDatToRemote",
                       vpb.VolumeTierMoveDatToRemoteRequest(
                           volume_id=1, destination_backend_name="e/b")),
                      ("VolumeTierMoveDatFromRemote",
                       vpb.VolumeTierMoveDatFromRemoteRequest(volume_id=1))):
        with pytest.raises(grpc.RpcError) as e:
            getattr(stub, name)(req)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
        assert "S3 tier" in e.value.details()
    ch.close()


def test_jwt_on_writes_and_grpc(tmp_path):
    """A JAX master and a port server sharing one signing key: the
    master's assign token lets the write through, an unsigned POST gets
    401, a gRPC call without the cluster token is refused, and the
    master's own (signed) calls reach the port server."""
    key = "sh4red-key"
    master = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                          pulse_seconds=PULSE, seed=3, secret=key).start()
    vs = VolumeServer(Store([tmp_path]), port=_free_port_pair(),
                      master_url=master.url, pulse_seconds=PULSE,
                      secret=key, device="cpu").start()
    try:
        _wait_nodes(master, 1)
        mc = MasterClient(master.url)
        [fid] = operation.submit(mc, [b"signed"])   # master grew it
        assert operation.download(mc, fid) == b"signed"
        a = operation.assign(mc)
        assert a.auth
        req = urllib.request.Request(f"http://{vs.url}/{a.fid}",
                                     data=b"unsigned", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 401
        operation.upload(a.url, a.fid, b"ok", jwt=a.auth)
        stub, ch = _stub(vs)
        with pytest.raises(grpc.RpcError) as e:
            stub.VolumeStatus(vpb.VolumeStatusRequest(volume_id=1))
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED
        ch.close()
        mc.close()
    finally:
        vs.stop()
        master.stop()


def test_heartbeat_starts_the_metrics_pusher_the_master_advertises(
        tmp_path):
    """A JAX master that advertises a push gateway in its heartbeat
    responses: the port server starts a ``MetricsPusher`` there, which
    POSTs its exposition text under its job and instance."""
    import http.server
    import threading
    pushes = []

    class Gateway(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            pushes.append((self.path, body))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    gw = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Gateway)
    threading.Thread(target=gw.serve_forever, daemon=True).start()
    gw_addr = f"127.0.0.1:{gw.server_address[1]}"
    master = MasterServer(port=_free_port_pair(), pulse_seconds=PULSE,
                          seed=5, metrics_address=gw_addr,
                          metrics_interval_seconds=1).start()
    vs = VolumeServer(Store([tmp_path]), port=_free_port_pair(),
                      master_url=master.url, pulse_seconds=PULSE,
                      device="cpu").start()
    want = f"/metrics/job/volume_server/instance/{vs.url}"
    try:
        deadline = time.time() + 10
        while time.time() < deadline and \
                not any(p == want for p, _ in pushes):
            time.sleep(0.05)
        assert vs._metrics_pusher is not None
        assert vs._metrics_pusher.address == gw_addr
        body = next(b for p, b in pushes if p == want)   # the master
        parse_exposition(body.decode())                  # pushes too
    finally:
        vs.stop()
        master.stop()
        gw.shutdown()
        gw.server_close()
    assert vs._metrics_pusher is None            # stopped with the server


class _Clock:
    """A stand-in for ``time`` in a needle module: ``time_ns`` counts
    from the synthetic volumes' base stamp, so two servers writing the
    same needles in the same order write the same bytes."""

    def __init__(self):
        self.n = 0

    def time_ns(self):
        self.n += 1
        return 1_700_000_000_000_000_000 + self.n


def test_mmap_backend_and_sqlite_index_write_what_jax_writes(
        tmp_path, monkeypatch):
    """``-backend mmap -index sqlite``: a JAX server and a port server,
    each on a Store with those settings, take the same writes and a
    delete over HTTP and write the same .dat and .idx."""
    monkeypatch.setattr(jax_needle, "time", _Clock())
    monkeypatch.setattr(needle, "time", _Clock())
    rng = np.random.default_rng(5)
    blobs = [rng.integers(0, 256, int(rng.integers(1, 3000)),
                          dtype=np.uint8).tobytes() for _ in range(20)]
    files = {}
    for name, srv_cls, store_cls in (("jax", JaxServer, JaxStore),
                                     ("port", VolumeServer, Store)):
        d = tmp_path / name
        d.mkdir()
        store = store_cls([d], backend="mmap", needle_map="sqlite")
        kw = {"device": "cpu"} if name == "port" else {}
        vs = srv_cls(store, port=_free_port_pair(), **kw).start()
        try:
            stub, ch = _stub(vs)
            stub.AllocateVolume(vpb.AllocateVolumeRequest(volume_id=7))
            ch.close()
            for i, blob in enumerate(blobs, 1):
                fid = FileId(7, i, 0x1000 + i)
                req = urllib.request.Request(f"http://{vs.url}/{fid}",
                                             data=blob, method="POST")
                urllib.request.urlopen(req, timeout=10).read()
            req = urllib.request.Request(f"http://{vs.url}/{FileId(7, 4, 0x1004)}",
                                         method="DELETE")
            urllib.request.urlopen(req, timeout=10).read()
            vol = vs.store.get_volume(7)
            assert type(vol._dat).__name__ == "MmapFile"
            assert type(vol.nm).__name__ == "SqliteNeedleMap"
            assert _get(f"http://{vs.url}/{FileId(7, 9, 0x1009)}")[2] == \
                blobs[8]
        finally:
            vs.stop()
        files[name] = {ext: (d / f"7{ext}").read_bytes()
                       for ext in (".dat", ".idx")}
    assert files["port"] == files["jax"]


def test_admin_rpcs_answer_as_jax_does(tmp_path, monkeypatch):
    """The same sequence of admin RPCs and HTTP writes against a JAX
    server and a port server (no master): status, replication rewrite,
    needle blobs, the vacuum family, read-only marks, unmount and mount,
    generate, mount, a post-seal blob delete, unmount. Every response
    and every file the two servers leave is equal."""
    monkeypatch.setattr(jax_needle, "time", _Clock())
    monkeypatch.setattr(needle, "time", _Clock())
    answers, files = {}, {}
    for name, cls, st, kw in (("jax", JaxServer, JaxStore, {}),
                              ("port", VolumeServer, Store,
                               {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        vs = cls(st([d]), port=_free_port_pair(), **kw).start()
        stub, ch = _stub(vs)
        out = []
        try:
            def call(method, **fields):
                req = getattr(vpb, f"{method}Request")(**fields)
                out.append((method,
                            getattr(stub, method)(req).SerializeToString()))

            call("AllocateVolume", volume_id=8, replication="001")
            call("AllocateVolume", volume_id=9)
            rng = np.random.default_rng(8)
            for i in range(1, 11):
                body = rng.integers(0, 256, 700 + i, dtype=np.uint8)
                urllib.request.urlopen(urllib.request.Request(
                    f"http://{vs.url}/{FileId(8, i, 100 + i)}",
                    data=body.tobytes(), method="POST"), timeout=10).read()
            call("VolumeStatus", volume_id=8)
            call("VolumeConfigure", volume_id=8, replication="010")
            call("VolumeConfigure", volume_id=77, replication="010")
            call("ReadNeedleBlob", volume_id=8, needle_id=3)
            blob = vpb.ReadNeedleBlobResponse.FromString(
                out[-1][1]).needle_blob
            call("WriteNeedleBlob", volume_id=9, needle_id=3,
                 needle_blob=blob)
            for i in (2, 4, 6):
                _get(f"http://{vs.url}/{FileId(8, i, 100 + i)}",
                     method="DELETE")
            call("VacuumVolumeCheck", volume_id=8)
            call("VacuumVolumeCompact", volume_id=8)
            call("VacuumVolumeCommit", volume_id=8)
            call("VacuumVolumeCleanup", volume_id=8)
            call("VolumeMarkReadonly", volume_id=8)
            call("VolumeStatus", volume_id=8)
            call("VolumeMarkWritable", volume_id=8)
            call("VolumeUnmount", volume_id=9)
            call("VolumeStatus", volume_id=9)
            call("VolumeMount", volume_id=9)
            call("VolumeStatus", volume_id=9)
            call("VolumeMarkReadonly", volume_id=8)
            call("VolumeEcShardsGenerate", volume_id=8)
            call("VolumeEcShardsMount", volume_id=8,
                 shard_ids=list(range(14)))
            call("VolumeEcBlobDelete", volume_id=8, file_key=5)
            call("VolumeEcShardsUnmount", volume_id=8, shard_ids=[12, 13])
            call("VolumeStatus", volume_id=8)
            assert _get(f"http://{vs.url}/{FileId(9, 3, 103)}")[0] == 200
        finally:
            ch.close()
            vs.stop()
        answers[name] = out
        files[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert answers["port"] == answers["jax"]
    assert files["port"] == files["jax"]
    assert "8.ecj" in files["port"] and "8.ec13" in files["port"]
    status = vpb.VolumeStatusResponse.FromString(answers["port"][-1][1])
    assert status.has_volume and list(status.ec_shard_ids) == list(range(12))


# -- entry points -------------------------------------------------------------


def test_volume_subcommand_joins_the_jax_master(tmp_path):
    master = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                          pulse_seconds=PULSE, seed=9).start()
    port = _free_port_pair()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-dir",
         str(tmp_path), "-mserver", master.url, "-port", str(port),
         "-pulseSeconds", str(PULSE), "-device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        _wait_nodes(master, 1, timeout=60)
        mc = MasterClient(master.url)
        [fid] = operation.submit(mc, [b"from a subprocess"])
        assert operation.download(mc, fid) == b"from a subprocess"
        assert list(tmp_path.glob("*.dat"))
        mc.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        master.stop()
    assert proc.returncode == 0, err


@pytest.mark.parametrize("section", volume_server.UNPORTED_SECTIONS)
def test_unported_config_section_exits_2(tmp_path, capsys, section):
    conf = tmp_path / "v.toml"
    conf.write_text(f"[storage]\nfsync = \"commit\"\n\n[{section}]\n"
                    f"enabled = true\n")
    rc = volume_server.main(["-dir", str(tmp_path), "-config", str(conf),
                             "-device", "cpu", "-mserver", ""])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 2
    assert len(err) == 1 and err[0].startswith("error:")
    assert f"[{section}]" in err[0] and "not ported" in err[0]
    assert list(tmp_path.iterdir()) == [conf]   # nothing else touched


def test_server_without_a_card_raises_before_binding(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    port = _free_port_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VolumeServer(Store([tmp_path]), port=port)
    for p in (port, _grpc_port(port)):     # nothing was bound
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))
    assert volume_server.main(["-dir", str(tmp_path), "-mserver", "",
                               "-port", str(port)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# -- faults of the reference, and the port's behaviour (ROADMAP Queue 3) -----


def test_read_only_volume_refuses_needle_deletes(tmp_path):
    """JAX ``Store.delete_needle`` (storage/store.py:385) deletes from a
    volume marked read-only, whose seal may already be under way; the
    port refuses, in the Store and over HTTP DELETE, as it refuses
    writes."""
    (tmp_path / "jax").mkdir()
    jst = JaxStore([tmp_path / "jax"])
    jst.create_volume(1)
    jst.write_needle(1, jax_needle.Needle(cookie=1, id=5, data=b"x"))
    jst.mark_readonly(1)
    assert jst.delete_needle(1, 5)                # the reference's fault
    jst.close()
    (tmp_path / "port").mkdir()
    vs = VolumeServer(Store([tmp_path / "port"]), port=_free_port_pair(),
                      device="cpu").start()
    try:
        stub, ch = _stub(vs)
        stub.AllocateVolume(vpb.AllocateVolumeRequest(volume_id=1))
        fid = FileId(1, 5, 1)
        urllib.request.urlopen(urllib.request.Request(
            f"http://{vs.url}/{fid}", data=b"x", method="POST"),
            timeout=10).read()
        stub.VolumeMarkReadonly(vpb.VolumeMarkReadonlyRequest(volume_id=1))
        ch.close()
        code, _, body = _get(f"http://{vs.url}/{fid}", method="DELETE")
        assert code == 404 and b"read-only" in body
        with pytest.raises(Exception, match="read-only"):
            vs.store.delete_needle(1, 5)
        assert _get(f"http://{vs.url}/{fid}")[2] == b"x"
    finally:
        vs.stop()


def _sealed_collection_volume(vs, vid: int, col: str) -> None:
    stub, ch = _stub(vs)
    stub.AllocateVolume(vpb.AllocateVolumeRequest(volume_id=vid,
                                                  collection=col))
    urllib.request.urlopen(urllib.request.Request(
        f"http://{vs.url}/{FileId(vid, 1, 9)}?collection={col}",
        data=b"sealed", method="POST"), timeout=10).read()
    stub.VolumeEcShardsGenerate(vpb.VolumeEcShardsGenerateRequest(
        volume_id=vid, collection=col))
    stub.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
        volume_id=vid, collection=col, shard_ids=list(range(14))))
    stub.VolumeEcShardsUnmount(vpb.VolumeEcShardsUnmountRequest(
        volume_id=vid, shard_ids=[0, 1]))
    ch.close()


def test_ec_shards_unmount_finds_a_collections_shards(tmp_path):
    """``VolumeEcShardsUnmountRequest`` has no collection field, and JAX
    ``VolumeEcShardsUnmount`` (cluster/volume_server.py:881) looks in
    the default collection only: a collection's shards stay mounted.
    The port unmounts them in the collection that mounts them."""
    mounted = {}
    for name, cls, st, kw in (("jax", JaxServer, JaxStore, {}),
                              ("port", VolumeServer, Store,
                               {"device": "cpu"})):
        (tmp_path / name).mkdir()
        vs = cls(st([tmp_path / name]), port=_free_port_pair(),
                 **kw).start()
        try:
            _sealed_collection_volume(vs, 3, "pics")
            mounted[name] = sorted(vs.store.ec_mounts[("pics", 3)].shard_ids)
        finally:
            vs.stop()
    assert mounted["jax"] == list(range(14))      # the reference's fault
    assert mounted["port"] == list(range(2, 14))


def test_heartbeat_skips_a_volume_deleted_after_the_status_snapshot(
        tmp_path, monkeypatch):
    """JAX ``_heartbeat_snapshot`` (cluster/volume_server.py:286) looks
    each volume of ``store.status()`` up again with ``[]``: a volume
    deleted in between raises KeyError inside the heartbeat stream,
    which breaks it. The port leaves that volume out of the beat."""
    got = {}
    for name, cls, st, kw in (("jax", JaxServer, JaxStore, {}),
                              ("port", VolumeServer, Store,
                               {"device": "cpu"})):
        (tmp_path / name).mkdir()
        store = st([tmp_path / name])
        store.create_volume(1)
        store.create_volume(2)
        vs = cls(store, port=_free_port_pair(), **kw)
        status = store.status()
        store.delete_volume(2)
        monkeypatch.setattr(store, "status", lambda s=status: s)
        try:
            got[name] = [v.id for v in vs._heartbeat_snapshot().volumes]
        except KeyError as e:
            got[name] = e
        store.close()
    assert isinstance(got["jax"], KeyError)       # the reference's fault
    assert got["port"] == [1]
