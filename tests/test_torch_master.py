"""The port's master (topology, sequencer, Raft-lite HA) and its clients
(wdclient, operation) against the JAX package's, on the CPU.

With equal seeds the same heartbeats give the same ``VolumeList``,
assign picks, lookups and ``LookupEcVolume`` answers in both packages.
Live clusters mix the packages on the wire: JAX volume servers
heartbeat a port master, port servers the JAX master, and each
package's client writes, reads and deletes through the other's master.
Port servers run ``device="cpu"``."""

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import operation as jax_operation
from seaweedfs_tpu.cluster import sequence as jax_sequence
from seaweedfs_tpu.cluster import topology as jax_topology
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.cluster import wdclient as jax_wdclient
from seaweedfs_tpu.pb import master_pb2 as jax_master_pb2
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.util import security as jax_security
from seaweedfs_tpu_torch.cluster import master, operation, sequence, topology
from seaweedfs_tpu_torch.cluster import volume_server, wdclient
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.storage import store
from seaweedfs_tpu_torch.storage.superblock import ReplicaPlacement, Ttl
from seaweedfs_tpu_torch.util import security

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2

PKGS = {
    "jax": dict(master=jax_master, operation=jax_operation,
                sequence=jax_sequence, topology=jax_topology,
                volume_server=jax_volume_server, wdclient=jax_wdclient,
                master_pb2=jax_master_pb2, store=jax_store,
                security=jax_security),
    "port": dict(master=master, operation=operation, sequence=sequence,
                 topology=topology, volume_server=volume_server,
                 wdclient=wdclient, master_pb2=master_pb2, store=store,
                 security=security),
}


def _wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# the same heartbeats through both packages' topology and sequencer
# ---------------------------------------------------------------------------

def _heartbeats() -> list[bytes]:
    """Serialized heartbeats of six nodes over two DCs of two racks:
    three volumes each in three collections, with replication 001 on
    every fourth, a TTL on every fifth, every sixth full and every
    seventh read-only, and the EC shards of two volumes."""
    out = []
    for i in range(6):
        hb = master_pb2.Heartbeat(
            ip="127.0.0.1", port=18080 + i,
            public_url=f"127.0.0.1:{28080 + i}" if i % 2 else "",
            data_center=f"dc{i % 2}", rack=f"r{i // 2 % 2}",
            max_volume_count=6 + i % 3, max_file_key=1000 * i)
        for vid in range(3 * i + 1, 3 * i + 4):
            hb.volumes.add(
                id=vid, collection=["", "pics", "logs"][vid % 3],
                size=(70 << 20) if vid % 6 == 0 else 4096 * vid,
                file_count=vid * 3, delete_count=vid % 2,
                deleted_byte_count=100 * (vid % 4),
                read_only=vid % 7 == 0,
                replica_placement=ReplicaPlacement.parse(
                    "001" if vid % 4 == 0 else "000").to_byte(),
                version=3,
                ttl=int.from_bytes(
                    Ttl.parse("3d" if vid % 5 == 0 else "").to_bytes(),
                    "big"),
                modified_at_second=1_700_000_000 + vid)
        for ec_vid, bits in ((90, 0b1010101 << i), (91, 0x3fff >> i)):
            hb.ec_shards.add(id=ec_vid, collection="ec",
                             ec_index_bits=bits & 0x3fff)
        out.append(hb.SerializeToString())
    return out


def _master_of(pkg: str, seed: int, clock):
    """A master that is not started: ingest, assign and the servicer
    run on their own, with no socket bound."""
    mods = PKGS[pkg]
    return mods["master"].MasterServer(
        port=9333, volume_size_limit_mb=64, seed=seed, clock=clock)


@pytest.fixture()
def fixed_cookies(monkeypatch):
    for pkg in PKGS.values():
        counter = iter(range(1, 1 << 30))
        monkeypatch.setattr(pkg["security"], "new_cookie",
                            lambda c=counter: next(c) * 2654435761 % 2**32)


def test_same_heartbeats_give_the_same_answers(fixed_cookies):
    now = [1000.0]
    clock = lambda: now[0]  # noqa: E731
    beats = _heartbeats()
    masters = {pkg: _master_of(pkg, 5, clock) for pkg in PKGS}
    answers = {}
    for pkg, ms in masters.items():
        pb2 = PKGS[pkg]["master_pb2"]
        servicer = PKGS[pkg]["master"]._MasterServicer(ms)
        resps = [ms.ingest_heartbeat(pb2.Heartbeat.FromString(b))
                 .SerializeToString() for b in beats]
        # a repeated pulse changes nothing
        resps.append(ms.ingest_heartbeat(pb2.Heartbeat.FromString(
            beats[0])).SerializeToString())
        got = {"responses": resps,
               "unchanged": ms.topology.heartbeats_unchanged,
               "max_volume_id": ms.topology.max_volume_id,
               "sequence": ms.sequencer.peek(),
               "to_map": ms.topology.to_map()}
        got["volume_list"] = servicer.VolumeList(
            pb2.VolumeListRequest(), None).SerializeToString()
        got["assign"] = [
            {k: v for k, v in ms.assign(count=c, collection=col,
                                        replication=rp).items()}
            for c, col, rp in [(1, "", None), (3, "pics", "000"),
                               (1, "logs", None), (2, "", "000")] * 4]
        got["lookup"] = [ms.lookup(v, c) for v in range(1, 20)
                         for c in ("", "pics")] + [ms.lookup(90),
                                                   ms.lookup(91, "ec")]
        got["lookup_rpc"] = servicer.LookupVolume(pb2.LookupVolumeRequest(
            volume_ids=["1", "2,abc", "x", "90", "404"]),
            None).SerializeToString()
        got["lookup_ec"] = [servicer.LookupEcVolume(
            pb2.LookupEcVolumeRequest(volume_id=v), None).SerializeToString()
            for v in (90, 91, 404)]
        got["grow_targets"] = [
            [n.url for n in ms.topology.pick_grow_targets(rp)]
            for rp in ("000", "001", "010", "100", "000", "011") * 3]
        got["ec_spread"] = [n.url for n in
                            ms.topology.pick_ec_spread(14, exclude=[
                                "127.0.0.1:18080"])]
        got["config"] = servicer.GetMasterConfiguration(
            pb2.GetMasterConfigurationRequest(), None).SerializeToString()
        # two nodes stop beating; the reap drops exactly them
        now[0] += 30.0
        for b in beats[2:]:
            ms.ingest_heartbeat(pb2.Heartbeat.FromString(b))
        got["reaped"] = ms.topology.reap_dead_nodes()
        got["after_reap"] = servicer.VolumeList(
            pb2.VolumeListRequest(), None).SerializeToString()
        got["lookup_after_reap"] = [ms.lookup(v) for v in range(1, 20)]
        now[0] -= 30.0
        answers[pkg] = got
    assert answers["port"] == answers["jax"]
    # the answers are not trivial: picks spread over volumes and nodes
    picks = answers["port"]["assign"]
    assert len({p["fid"].split(",")[0] for p in picks}) > 3
    assert len({p["url"] for p in picks}) > 2
    assert answers["port"]["reaped"] == ["127.0.0.1:18080",
                                         "127.0.0.1:18081"]
    # the heartbeats' max_file_key (5000) moved the sequencer past it
    assert answers["port"]["sequence"] == 5001


def test_assign_without_a_writable_volume_fails_alike():
    for pkg in PKGS:
        ms = _master_of(pkg, 1, time.time)
        with pytest.raises(PKGS[pkg]["topology"].TopologyError,
                           match="no data node with free slots"):
            ms.assign()


def test_heartbeat_fields_of_unported_planes_are_ignored():
    """A heartbeat carrying ``telemetry``, ``usage`` and ``job_progress``
    gives the same response and the same topology as one without them:
    those fields touch no topology state. The telemetry and usage
    registries, ported since, take in the node."""
    seen = []
    for with_fields in (False, True):
        ms = _master_of("port", 2, lambda: 1000.0)
        for b in _heartbeats():
            hb = master_pb2.Heartbeat.FromString(b)
            if with_fields:
                hb.telemetry.window_ns = 10**9
                hb.usage.window_ns = 10**9
                hb.usage.component = "volume"
                hb.job_progress.claimed_total = 3
                assert all(hb.HasField(f) for f in
                           ("telemetry", "usage", "job_progress"))
            resp = ms.ingest_heartbeat(hb)
        url = f"{hb.ip}:{hb.port}"
        assert (url in ms.usage.to_map()["sources"]) is with_fields
        assert (url in ms.topology.telemetry.to_map()["nodes"]) \
            is with_fields
        seen.append((resp.SerializeToString(), ms.topology.to_map(),
                     master._MasterServicer(ms).VolumeList(
                         master_pb2.VolumeListRequest(), None)
                     .SerializeToString()))
    assert seen[0] == seen[1]


def test_metrics_address_reaches_servers_and_the_pusher(tmp_path):
    """``-metricsAddress``: the master advertises the gateway in its
    heartbeat responses and ``GetMasterConfiguration``, as JAX's does,
    and its own ``MetricsPusher`` posts the exposition there."""
    import http.server

    got = []

    class Gateway(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            got.append((self.path, self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    gw = http.server.HTTPServer(("127.0.0.1", 0), Gateway)
    threading.Thread(target=gw.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{gw.server_address[1]}"
    answers = {}
    try:
        for pkg in PKGS:
            ms = PKGS[pkg]["master"].MasterServer(
                port=_free_port_pair(), metrics_address=addr,
                metrics_interval_seconds=30).start()
            try:
                pb2 = PKGS[pkg]["master_pb2"]
                servicer = PKGS[pkg]["master"]._MasterServicer(ms)
                answers[pkg] = (
                    ms.ingest_heartbeat(pb2.Heartbeat(
                        ip="127.0.0.1", port=1)).metrics_address,
                    servicer.GetMasterConfiguration(
                        pb2.GetMasterConfigurationRequest(), None)
                    .SerializeToString())
                _wait_for(lambda: any(f"/instance/{ms.url}" in p
                                      for p, _ in got),
                          what=f"the {pkg} master's first push")
            finally:
                ms.stop()
    finally:
        gw.shutdown()
        gw.server_close()
    assert answers["port"][0] == answers["jax"][0] == addr
    assert answers["port"][1] == answers["jax"][1]
    assert all(p.startswith("/metrics/job/master/instance/")
               for p, _ in got)


@pytest.mark.parametrize("batches", [[1, 5, 3], [9999, 2, 1], [40000]])
def test_sequencer_persists_and_resumes_alike(tmp_path, batches):
    seen = {}
    for pkg, mods in PKGS.items():
        path = tmp_path / f"{pkg}.seq"
        s = mods["sequence"].MemorySequencer(persist_path=path,
                                             checkpoint_every=1000)
        firsts = [s.next_batch(n) for n in batches]
        s.set_max(s.peek() + 17)
        resumed = mods["sequence"].MemorySequencer(
            persist_path=path, checkpoint_every=1000)
        with pytest.raises(ValueError):
            resumed.next_batch(0)
        seen[pkg] = (firsts, s.peek(), path.read_text(), resumed.peek())
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------------------------
# live clusters that mix the packages
# ---------------------------------------------------------------------------

def _start_cluster(tmp_path, master_pkg, server_pkg, n=2, rack=lambda i:
                   f"r{i}", replication="000", **master_kw):
    ms = PKGS[master_pkg]["master"].MasterServer(
        port=_free_port_pair(), volume_size_limit_mb=64,
        pulse_seconds=PULSE, seed=3, default_replication=replication,
        **master_kw).start()
    servers = []
    for i in range(n):
        d = tmp_path / f"{server_pkg}{i}"
        d.mkdir()
        kw = dict(device="cpu") if server_pkg == "port" else {}
        servers.append(PKGS[server_pkg]["volume_server"].VolumeServer(
            PKGS[server_pkg]["store"].Store([d], max_volumes=8),
            port=_free_port_pair(), master_url=ms.url, data_center="dc1",
            rack=rack(i), pulse_seconds=PULSE, **kw).start())
        # join one at a time: the topology's node order is fixed
        _wait_for(lambda: len(ms.topology.nodes) == i + 1,
                  what="volume server registration")
    return ms, servers


def _stop_cluster(ms, servers):
    for vs in servers:
        vs.stop()
    ms.stop()


@pytest.mark.parametrize("master_pkg,server_pkg,client_pkg", [
    ("port", "jax", "jax"), ("port", "jax", "port"),
    ("jax", "port", "port"), ("port", "port", "jax")])
def test_clients_write_read_and_delete_through_either_master(
        tmp_path, master_pkg, server_pkg, client_pkg):
    ms, servers = _start_cluster(tmp_path, master_pkg, server_pkg)
    ops = PKGS[client_pkg]["operation"]
    mc = PKGS[client_pkg]["wdclient"].MasterClient(ms.url)
    try:
        rng = np.random.default_rng(11)
        blobs = [rng.integers(0, 256, int(rng.integers(100, 30000)),
                              dtype=np.uint8).tobytes() for _ in range(12)]
        fids = ops.submit(mc, blobs, collection="mix")
        for fid, blob in zip(fids, blobs):
            assert ops.download(mc, fid, collection="mix") == blob
        ops.delete(mc, fids[0], collection="mix")
        with pytest.raises(ops.OperationError):
            ops.download(mc, fids[0], collection="mix")
        assert ops.download(mc, fids[1], collection="mix") == blobs[1]
        # the master's sequencer issued every key once
        keys = [int(f.split(",")[1][:-8], 16) for f in fids]
        assert len(set(keys)) == len(keys)
        locs = mc.lookup(int(fids[1].split(",")[0]), "mix")
        assert locs and set(locs[0]) == {"url", "publicUrl"}
    finally:
        mc.close()
        _stop_cluster(ms, servers)


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_replication_001_fans_a_post_out_to_the_other_server(tmp_path,
                                                            client_pkg):
    """Two port servers on one rack under a port master: a POST to
    either one lands on both, and a delete on both."""
    ms, servers = _start_cluster(tmp_path, "port", "port",
                                 rack=lambda i: "r0", replication="001")
    ops = PKGS[client_pkg]["operation"]
    mc = PKGS[client_pkg]["wdclient"].MasterClient(ms.url)
    try:
        blobs = [bytes([i]) * (1000 + 7 * i) for i in range(8)]
        fids = ops.submit(mc, blobs, replication="001")
        for fid, blob in zip(fids, blobs):
            for vs in servers:
                with urllib.request.urlopen(f"http://{vs.url}/{fid}",
                                            timeout=10) as r:
                    assert r.read() == blob
        vid = int(fids[0].split(",")[0])
        assert sorted(loc["url"] for loc in mc.lookup(vid)) == \
            sorted(vs.url for vs in servers)
        ops.delete(mc, fids[0])
        for vs in servers:
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"http://{vs.url}/{fids[0]}",
                                       timeout=10)
    finally:
        mc.close()
        _stop_cluster(ms, servers)


def test_http_plane_answers_as_jax_does(tmp_path):
    """/dir/assign, /dir/lookup, /dir/status, /vol/grow and the admin
    lock over HTTP, on a port and a JAX master with one JAX server
    each: the same keys, codes and errors."""
    docs = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        ms, servers = _start_cluster(tmp_path / pkg, pkg, "jax", n=1)

        def get(path, method="GET"):
            req = urllib.request.Request(f"http://{ms.url}{path}",
                                         method=method)
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        try:
            code, a = get("/dir/assign?count=2&collection=h")
            vid = a["fid"].split(",")[0]
            st = get("/dir/status")[1]
            got = {
                "assign": (code, sorted(a), a["count"]),
                "lookup": get(f"/dir/lookup?volumeId={vid}&collection=h"),
                "missing": get("/dir/lookup?volumeId=404"),
                "grow": get("/vol/grow?count=2&collection=g", "POST"),
                "bad_grow": get("/vol/grow?replication=200", "POST"),
                "status": (sorted(st), st["IsLeader"], st["Term"],
                           st["Peers"], sorted(st["Topology"])),
                "lock": get("/admin/lock?client=a", "POST"),
                "lock2": get("/admin/lock?client=b", "POST"),
                "holder": get("/cluster/status")[1]["AdminLockHolder"],
                "unlock": get("/admin/unlock?client=a", "POST"),
                "noname": get("/admin/lock", "POST"),
                "nothing": get("/nothing"),
            }
            with urllib.request.urlopen(f"http://{ms.url}/metrics",
                                        timeout=10) as r:
                body = r.read().decode()
                got["metrics"] = (r.headers["Content-Type"],
                                  "master_assign_requests" in body)
        finally:
            _stop_cluster(ms, servers)
        got["lookup"][1]["locations"][0].pop("url")
        got["lookup"][1]["locations"][0].pop("publicUrl")
        docs[pkg] = got
    assert docs["port"] == docs["jax"]
    assert docs["port"]["grow"] == (200, {"count": 2, "volumeIds": [2, 3]})
    assert docs["port"]["lock2"][0] == 409
    assert docs["port"]["metrics"][1]


# ---------------------------------------------------------------------------
# Raft-lite HA
# ---------------------------------------------------------------------------

def _one_leader(masters):
    leaders = [m for m in masters if not m._stop.is_set() and m.is_leader]
    return leaders[0] if len(leaders) == 1 else None


def _ha_masters(tmp_path, pkgs):
    ports = [_free_port_pair() for _ in pkgs]
    urls = [f"127.0.0.1:{p}" for p in ports]
    return [PKGS[pkg]["master"].MasterServer(
        port=ports[i], peers=urls, meta_dir=str(tmp_path / f"m{i}"),
        pulse_seconds=PULSE, volume_size_limit_mb=64, seed=11,
        election_timeout=(0.3, 0.6), garbage_threshold=0).start()
        for i, pkg in enumerate(pkgs)], urls


def _http_json(url, method="GET"):
    """One request, retried on the 503 a follower answers mid-election."""
    deadline = time.time() + 30
    while True:
        try:
            req = urllib.request.Request(url, method=method)
            with urllib.request.urlopen(req, timeout=10) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code != 503 or time.time() > deadline:
                raise
            time.sleep(0.2)


def test_three_port_masters_elect_one_leader_and_fail_over(tmp_path):
    masters, urls = _ha_masters(tmp_path, ["port"] * 3)
    d = tmp_path / "vols"
    d.mkdir()
    vs = volume_server.VolumeServer(
        store.Store([d], max_volumes=16), port=_free_port_pair(),
        master_url=",".join(urls), pulse_seconds=PULSE,
        device="cpu").start()
    mc = wdclient.MasterClient(",".join(urls))
    try:
        leader = _wait_for(lambda: _one_leader(masters), what="one leader")
        _wait_for(lambda: all(m.leader_url == leader.url for m in masters),
                  what="leader agreement")
        _wait_for(lambda: len(leader.topology.nodes) == 1,
                  what="volume server registration")
        follower = next(m for m in masters if not m.is_leader)
        # a follower proxies /dir/assign and /dir/lookup to the leader
        a = _http_json(f"http://{follower.url}/dir/assign")
        vid = int(a["fid"].split(",")[0])
        operation.upload(a["url"], a["fid"], b"through-a-follower")
        looked = _http_json(f"http://{follower.url}/dir/lookup"
                            f"?volumeId={vid}")
        assert [loc["url"] for loc in looked["locations"]] == [vs.url]
        st = _http_json(f"http://{follower.url}/cluster/status")
        assert st["IsLeader"] is False and st["Leader"] == leader.url
        b = operation.assign(mc)
        keys_before = {a["fid"], b.fid}
        max_vid = leader.topology.max_volume_id
        seq_before = leader.sequencer.peek()
        # every follower holds the replicated state
        _wait_for(lambda: all(m.sequencer.peek() >= seq_before
                              and m.topology.max_volume_id >= max_vid
                              for m in masters), what="state replication")

        leader.stop()
        survivors = [m for m in masters if m is not leader]
        new = _wait_for(lambda: _one_leader(survivors), what="re-election")
        assert new.topology.max_volume_id >= max_vid
        assert new.sequencer.peek() >= seq_before
        _wait_for(lambda: new.topology.lookup_volume(vid, ""),
                  what="volume server follows the new leader")
        c = _wait_for(lambda: _try(lambda: operation.assign(mc)),
                      what="assign after failover")
        assert c.fid not in keys_before
        assert int(c.fid.split(",")[1][:-8], 16) >= seq_before
        grown = _http_json(f"http://{new.url}/vol/grow", "POST")
        assert grown["volumeIds"][0] > max_vid
        assert operation.download(mc, a["fid"]) == b"through-a-follower"
    finally:
        mc.close()
        vs.stop()
        for m in masters:
            if not m._stop.is_set():
                m.stop()


def _try(fn):
    try:
        return fn()
    except Exception:  # noqa: BLE001 — mid-election: try again
        return None


@pytest.mark.parametrize("pkgs", [("port", "jax", "port"),
                                  ("jax", "port", "jax")])
def test_port_and_jax_masters_agree_on_one_leader(tmp_path, pkgs):
    """The election's wire (``/raft/vote``, ``/raft/heartbeat`` JSON) is
    the same in both packages, so a mixed set elects one leader and
    elects again when it stops."""
    masters, _urls = _ha_masters(tmp_path, list(pkgs))
    try:
        leader = _wait_for(lambda: _one_leader(masters), what="one leader")
        _wait_for(lambda: all(m.leader_url == leader.url for m in masters),
                  what="leader agreement")
        leader.stop()
        survivors = [m for m in masters if m is not leader]
        new = _wait_for(lambda: _one_leader(survivors), what="re-election")
        _wait_for(lambda: all(m.leader_url == new.url for m in survivors),
                  what="agreement after failover")
        terms = {m.ha.term for m in survivors}
        assert len(terms) == 1 and terms.pop() > leader.ha.term
    finally:
        for m in masters:
            if not m._stop.is_set():
                m.stop()


# ---------------------------------------------------------------------------
# faults of the reference found while porting the master
# ---------------------------------------------------------------------------

def test_volume_list_during_a_grow_does_not_fail(fixed_cookies):
    """JAX ``_MasterServicer.VolumeList`` (``cluster/master.py:755``)
    walks each node's ``volumes`` dict outside the topology lock, while
    ``Topology.register_volume`` (a grow's optimistic registration) adds
    to that dict in place: a grow that lands mid-walk fails the listing
    with ``RuntimeError: dictionary changed size during iteration``. The
    port snapshots each node's volumes under the lock."""
    results = {}
    for pkg, mods in PKGS.items():
        ms = _master_of(pkg, 1, time.time)
        info = mods["topology"].VolumeInfo

        class Racy(dict):
            """A node's volumes whose walk lets a grow in after the
            first volume, as a concurrent grow would."""

            def values(self):
                it = iter(dict.values(self))
                first = next(it)
                t = threading.Thread(target=ms.topology.register_volume,
                                     args=("n1:80", info(id=99)))
                t.start()
                t.join(0.5)
                yield first
                yield from it

        ms.topology.register_heartbeat(
            "n1:80", volumes=Racy({("", 1): info(id=1),
                                   ("", 2): info(id=2)}))
        servicer = mods["master"]._MasterServicer(ms)
        try:
            resp = servicer.VolumeList(mods["master_pb2"].VolumeListRequest(),
                                       None)
            results[pkg] = sorted(v.id for v in resp.topology_info
                                  .data_center_infos[0].rack_infos[0]
                                  .data_node_infos[0].volume_infos)
        except RuntimeError as e:
            results[pkg] = str(e)
    assert "changed size during iteration" in results["jax"]
    assert results["port"] == [1, 2]


def test_sha256_of_a_blob_round_trip_through_the_port_client(tmp_path):
    """``upload`` / ``download`` / ``delete`` as CLI subcommands over a
    port master, in process."""
    from seaweedfs_tpu_torch import cli_tools
    ms, servers = _start_cluster(tmp_path, "port", "port", n=1)
    try:
        src = tmp_path / "blob.bin"
        data = np.random.default_rng(5).integers(
            0, 256, 50_000, dtype=np.uint8).tobytes()
        src.write_bytes(data)
        import contextlib
        import io
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli_tools.run_upload(["-master", ms.url, str(src)]) == 0
        fid = json.loads(out.getvalue())[0]["fid"]
        dest = tmp_path / "dl"
        dest.mkdir()
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli_tools.run_download(
                ["-master", ms.url, "-dir", str(dest), fid]) == 0
        got = (dest / fid.replace(",", "_")).read_bytes()
        assert hashlib.sha256(got).digest() == hashlib.sha256(data).digest()
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli_tools.run_delete(["-master", ms.url, fid]) == 0
        mc = wdclient.MasterClient(ms.url)
        with pytest.raises(operation.OperationError):
            operation.download(mc, fid)
        mc.close()
    finally:
        _stop_cluster(ms, servers)
