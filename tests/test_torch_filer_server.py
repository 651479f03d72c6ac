"""The port's filer server and client (``cluster/filer_server.py``,
``filer_client.py``) against the JAX package's, on the CPU.

Four stacks share one module: a port filer on a port master and port
volume servers, a JAX filer on a JAX cluster, and the two mixed stacks (a
port filer on the JAX cluster, a JAX filer on the port cluster). Every
case of ``tests/test_filer_server.py`` runs on each, and every file reads
back sha256-equal, ranges included. Port servers run ``device="cpu"``.
Also: the ``filer`` subprocess and its refused ``-config`` sections."""

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest

from seaweedfs_tpu import pb as jax_pb
from seaweedfs_tpu.cluster import filer_client as jax_filer_client
from seaweedfs_tpu.cluster import filer_server as jax_filer_server
from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.cluster import filer_client, filer_server
from seaweedfs_tpu_torch.cluster import master, volume_server
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.storage import store

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
REPO = Path(__file__).resolve().parent.parent
CLUSTER = {"jax": (jax_master, jax_volume_server, jax_store),
           "port": (master, volume_server, store)}
FILER = {"jax": (jax_filer_server, JaxFiler, jax_filer_client, jax_pb),
         "port": (filer_server, Filer, filer_client, pb)}
#: stack name -> (filer package, cluster package)
STACKS = {"port": ("port", "port"), "jax": ("jax", "jax"),
          "port_on_jax": ("port", "jax"), "jax_on_port": ("jax", "port")}


def _wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _cluster(tmp_path_factory, pkg):
    m_mod, vs_mod, st_mod = CLUSTER[pkg]
    ms = m_mod.MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                            pulse_seconds=PULSE, seed=7).start()
    servers = []
    for i in range(2):
        d = tmp_path_factory.mktemp(f"fvol_{pkg}{i}")
        kw = dict(device="cpu") if pkg == "port" else {}
        servers.append(vs_mod.VolumeServer(
            st_mod.Store([d], max_volumes=8), port=_free_port_pair(),
            master_url=ms.url, pulse_seconds=PULSE, **kw).start())
    _wait_for(lambda: len(ms.topology.nodes) == 2,
              what="volume server registration")
    return ms, servers


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    clusters = {pkg: _cluster(tmp_path_factory, pkg)
                for pkg in ("jax", "port")}
    filers = {}
    for name, (fpkg, cpkg) in STACKS.items():
        fs_mod, filer_cls = FILER[fpkg][:2]
        filers[name] = fs_mod.FilerServer(
            filer_cls(), port=_free_port_pair(),
            master_url=clusters[cpkg][0].url).start()
    yield filers
    for f in filers.values():
        f.stop()
    for ms, servers in clusters.values():
        for vs in servers:
            vs.stop()
        ms.stop()


@pytest.fixture(params=sorted(STACKS))
def stack(request, stacks):
    """(stack name, its filer server, the filer's package modules)"""
    name = request.param
    return name, stacks[name], FILER[STACKS[name][0]]


def _url(filer, path: str) -> str:
    return f"http://{filer.url}{path}"


def _put(filer, path, data: bytes, query: str = ""):
    req = urllib.request.Request(_url(filer, path) + query, data=data,
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(filer, path, headers=None) -> bytes:
    req = urllib.request.Request(_url(filer, path), headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_put_get_roundtrip_chunked(stack):
    name, filer, _ = stack
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, 3 * 1024 * 1024 + 17,
                           dtype=np.uint8).tobytes()
    # maxMB=1 forces 4 chunks through assign/upload
    resp = _put(filer, f"/docs/{name}/big.bin", payload, "?maxMB=1")
    assert resp["size"] == len(payload)
    entry = filer.filer.find_entry(f"/docs/{name}/big.bin")
    assert len(entry.chunks) == 4
    assert _sha(_get(filer, f"/docs/{name}/big.bin")) == _sha(payload)
    head = urllib.request.Request(_url(filer, f"/docs/{name}/big.bin"),
                                  method="HEAD")
    with urllib.request.urlopen(head, timeout=30) as r:
        assert int(r.headers["Content-Length"]) == len(payload)


def test_range_read(stack):
    _, filer, _ = stack
    payload = bytes(range(256)) * 1024
    _put(filer, "/docs/range.bin", payload)
    for lo, hi in ((1000, 1999), (0, 0), (len(payload) - 7,
                                          len(payload) - 1)):
        got = _get(filer, "/docs/range.bin", {"Range": f"bytes={lo}-{hi}"})
        assert _sha(got) == _sha(payload[lo:hi + 1])


def test_suffix_and_bad_ranges(stack):
    _, filer, _ = stack
    payload = bytes(range(256)) * 64
    _put(filer, "/docs/suffix.bin", payload)
    got = _get(filer, "/docs/suffix.bin", {"Range": "bytes=-100"})
    assert got == payload[-100:]
    # unknown unit / malformed -> full body with 200
    for bad in ("items=0-10", "bytes=abc-", "bytes=5"):
        req = urllib.request.Request(_url(filer, "/docs/suffix.bin"),
                                     headers={"Range": bad})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            assert r.read() == payload


def test_multipart_upload_into_directory(stack):
    _, filer, _ = stack
    boundary = "x123"
    body = (f"--{boundary}\r\n"
            "Content-Disposition: form-data; name=\"file\"; "
            "filename=\"pic.bin\"\r\n"
            "Content-Type: application/octet-stream\r\n\r\n").encode() \
        + b"PAYLOAD" + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        _url(filer, "/gallery/"), data=body, method="POST",
        headers={"Content-Type":
                 f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 201
    assert _get(filer, "/gallery/pic.bin") == b"PAYLOAD"


def test_directory_listing_json(stack):
    _, filer, _ = stack
    _put(filer, "/list/a.txt", b"a")
    _put(filer, "/list/b.txt", b"bb")
    body = json.loads(_get(filer, "/list"))
    names = [e["path"].rsplit("/", 1)[-1] for e in body["entries"]]
    assert names == ["a.txt", "b.txt"]
    assert body["lastFileName"] == "b.txt"


def test_delete_reclaims_and_404s(stack):
    _, filer, _ = stack
    _put(filer, "/del/x.bin", b"x" * 1024)
    req = urllib.request.Request(_url(filer, "/del/x.bin"),
                                 method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 204
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(filer, "/del/x.bin")
    assert ei.value.code == 404


def test_grpc_surface(stack):
    name, filer, (_, _, _, pkg_pb) = stack
    # each package's stub against the filer: the wire is one
    for stub_pb in (pb, jax_pb):
        ch = grpc.insecure_channel(f"127.0.0.1:{filer.port + 10000}")
        stub = stub_pb.filer_stub(ch)
        stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory="/grpc", entry=filer_pb2.Entry(
                name="hello.txt",
                attributes=filer_pb2.FuseAttributes(file_mode=0o640),
                chunks=[filer_pb2.FileChunk(file_id="1,ff", offset=0,
                                            size=5)])))
        resp = stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(directory="/grpc",
                                                  name="hello.txt"))
        assert resp.entry.name == "hello.txt"
        assert resp.entry.chunks[0].file_id == "1,ff"
        assert resp.entry.attributes.file_mode == 0o640
        names = [r.entry.name for r in stub.ListEntries(
            filer_pb2.ListEntriesRequest(directory="/grpc"))]
        assert names == ["hello.txt"]
        stub.AtomicRenameEntry(filer_pb2.AtomicRenameEntryRequest(
            old_directory="/grpc", old_name="hello.txt",
            new_directory="/grpc", new_name="renamed.txt"))
        resp = stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(directory="/grpc",
                                                  name="renamed.txt"))
        assert resp.entry.name == "renamed.txt"
        stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
            directory="/grpc", name="renamed.txt"))
        resp = stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(directory="/grpc",
                                                  name="renamed.txt"))
        assert not resp.entry.name
        conf = stub.GetFilerConfiguration(
            filer_pb2.GetFilerConfigurationRequest())
        assert conf.signature == filer.filer.signature
        assert conf.started_ns == filer.started_ns
        ch.close()


def test_subscribe_metadata_stream(stack):
    name, filer, _ = stack
    ch = grpc.insecure_channel(f"127.0.0.1:{filer.port + 10000}")
    stream = pb.filer_stub(ch).SubscribeMetadata(
        filer_pb2.SubscribeMetadataRequest(client_name="t"))
    it = iter(stream)
    hello = next(it)
    assert not hello.event_notification.new_entry.name
    assert not hello.event_notification.old_entry.name
    assert hello.ts_ns > 0
    _put(filer, f"/sub/{name}/notify.txt", b"hi")
    ev = next(it)
    assert ev.event_notification.new_entry.name in ("sub", name,
                                                    "notify.txt")
    stream.cancel()
    ch.close()


def test_copy_data_failure_preserves_existing_destination(stack):
    """A failed copy does not destroy a pre-existing destination; a
    successful one replaces it."""
    name, filer, (_, _, fc_mod, _) = stack
    fc = fc_mod.FilerClient(filer.url)
    try:
        _put(filer, "/cp/src.bin", b"s" * 100)
        _put(filer, "/cp/dst.bin", b"d" * 64)
        orig_get = fc.get_data

        def flaky_get(path, offset=0, length=None):
            if offset >= 64:
                raise fc_mod.FilerClientError("injected mid-copy failure")
            return orig_get(path, offset, length)

        fc.get_data = flaky_get
        with pytest.raises(fc_mod.FilerClientError, match="injected"):
            fc.copy_data("/cp/src.bin", "/cp/dst.bin", size=100,
                         window=64)
        fc.get_data = orig_get
        assert _get(filer, "/cp/dst.bin") == b"d" * 64
        listing = json.loads(_get(filer, "/cp"))
        names = [e["path"].rsplit("/", 1)[-1]
                 for e in listing.get("entries", [])]
        assert all("copy-" not in n for n in names)
        assert fc.copy_data("/cp/src.bin", "/cp/dst.bin", size=100,
                            window=64) == 100
        assert _get(filer, "/cp/dst.bin") == b"s" * 100
    finally:
        fc.close()


def test_copy_data_swap_failure_preserves_bytes(stack):
    name, filer, (_, _, fc_mod, _) = stack
    fc = fc_mod.FilerClient(filer.url)
    try:
        _put(filer, "/cps/src.bin", b"s" * 80)
        _put(filer, "/cps/dst.bin", b"d" * 16)

        def broken_rename(*a, **kw):
            raise fc_mod.FilerClientError("injected rename failure")

        fc.rename = broken_rename
        with pytest.raises(fc_mod.FilerClientError, match="preserved at"):
            fc.copy_data("/cps/src.bin", "/cps/dst.bin", size=80)
        listing = json.loads(_get(filer, "/cps"))
        tmp = [e["path"].rsplit("/", 1)[-1]
               for e in listing.get("entries", [])
               if "copy-" in e["path"]]
        assert tmp
        assert _get(filer, f"/cps/{tmp[0]}") == b"s" * 80
        # leave the directory as the next stack's run expects it
        for n in tmp:
            fc.delete_data(f"/cps/{n}")
    finally:
        fc.close()


def test_clients_cross_packages(stacks):
    """Each package's FilerClient against every stack: writes, appends,
    reads and ranged reads are sha256-equal whoever wrote them."""
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 300_017, dtype=np.uint8).tobytes()
    for name, filer in sorted(stacks.items()):
        for cname, fc_mod in (("port", filer_client),
                              ("jax", jax_filer_client)):
            fc = fc_mod.FilerClient(filer.url)
            path = f"/cross/{name}/{cname}.bin"
            try:
                fc.put_data(path, payload[:200_000],
                            query="maxMB=1")
                fc.put_data(path, payload[200_000:], query="op=append")
                for other in (filer_client, jax_filer_client):
                    oc = other.FilerClient(filer.url)
                    assert _sha(oc.get_data(path)) == _sha(payload)
                    assert _sha(oc.get_data(path, 199_990, 30)) == \
                        _sha(payload[199_990:200_020])
                    e = oc.lookup(f"/cross/{name}", f"{cname}.bin")
                    assert e.attributes.file_size == len(payload)
                    assert len(e.chunks) == 2
                    oc.close()
                with pytest.raises(fc_mod.FilerClientError) as ei:
                    fc.get_data(path + ".missing")
                assert ei.value.code == 404
            finally:
                fc.close()


def test_debug_pages_and_metrics(stacks):
    """The port filer serves ``/debug/vars``, ``/debug/traces`` and
    ``/debug/profile`` as the JAX filer does, and ``/metrics`` with the
    tracing family."""
    filer = stacks["port"]
    vz = json.loads(_get(filer, "/debug/vars"))
    jvz = json.loads(_get(stacks["jax"], "/debug/vars"))
    assert vz["component"] == jvz["component"] == "filer"
    # the JAX page's keys, the usage plane's among them
    assert set(jvz) - set(vz) == set()
    assert vz["usage"]["component"] == jvz["usage"]["component"] == "filer"
    tr = json.loads(_get(filer, "/debug/traces?limit=1"))
    assert tr["enabled"] is True and "traces" in tr
    assert set(tr) == set(json.loads(_get(stacks["jax"],
                                          "/debug/traces?limit=1")))
    text = _get(filer, "/debug/profile?seconds=0.1").decode()
    for line in text.splitlines():
        stack, count = line.rsplit(" ", 1)
        assert int(count) >= 1 and ":" in stack
    body = _get(filer, "/metrics").decode()
    assert "filer_request_total" in body
    assert "trace_request_stage_seconds" in body


def test_filer_subprocess_round_trips(stacks, tmp_path):
    """``python -m seaweedfs_tpu_torch filer`` against a master, with a
    ``-config`` holding ``[tracing]`` and ``[usage]``: one PUT and one
    GET through it, which its usage pusher reports to the master's
    ``/cluster/usage``, then SIGTERM stops it with exit 0; a ``-config``
    with a bad ``[usage]`` value exits 2 with one line."""
    ms_url = stacks["port"].master_url
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    port = _free_port_pair()
    db = tmp_path / "meta.db"
    conf = tmp_path / "f.toml"
    conf.write_text("[tracing]\nenabled = true\n\n[usage]\nenabled = true\n"
                    "push_interval_seconds = 0.2\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer", "-port",
         str(port), "-master", ms_url, "-db", str(db), "-config",
         str(conf)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        url = f"127.0.0.1:{port}"

        def up():
            try:
                urllib.request.urlopen(f"http://{url}/", timeout=1)
                return True
            except urllib.error.HTTPError:
                return True
            except OSError:
                return False
        _wait_for(up, timeout=60, what="filer subprocess")
        fc = filer_client.FilerClient(url)
        fc.put_data("/sub/p.bin", b"subprocess" * 1000)
        assert fc.get_data("/sub/p.bin") == b"subprocess" * 1000
        fc.close()

        def pushed():
            with urllib.request.urlopen(
                    f"http://{ms_url}/cluster/usage", timeout=10) as r:
                doc = json.loads(r.read())
            src = doc["sources"].get(url)
            anon = doc["tenants"].get("anonymous", {})
            return src if src and src["component"] == "filer" and \
                anon.get("bytes_in", 0) >= 10_000 else None
        _wait_for(pushed, timeout=30, what="the filer's usage push")
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0, proc.stderr.read()
    # the -db it wrote opens in the JAX store with the entry
    from seaweedfs_tpu.filer import SqliteStore as JaxSqliteStore
    st = JaxSqliteStore(str(db))
    assert st.find_entry("/sub/p.bin").size() == 10_000
    st.close()
    conf.write_text("[tracing]\nenabled = true\n\n[usage]\n"
                    "push_interval_seconds = \"soon\"\n")
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer", "-port",
         "1", "-master", ms_url, "-config", str(conf)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    err = out.stderr.strip().splitlines()
    assert out.returncode == 2 and len(err) == 1
    assert err[0].startswith("error: -config")
