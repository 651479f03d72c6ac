"""The telemetry, usage and policy planes on live clusters, port against
JAX, on the CPU (port servers run ``device="cpu"``).

* Mixed clusters both ways — port volume servers under a JAX master and
  JAX volume servers under a port master — give the same
  ``/cluster/telemetry`` rows, the same ``/cluster/usage`` and the same
  ``_rank_replicas`` order as an all-JAX and an all-port twin driven by
  the same requests (time-derived fields masked: rates, latencies,
  ingest times, and the fids, whose cookies are random).
* The four shell commands of the planes and ``cluster.check`` print the
  same lines through both shells on twin clusters, numbers masked.
* The policy loop of JAX ``tests/test_jobs.py``
  (``test_policy_loop_grows_then_shrinks_replica``) on a port cluster,
  and the closed loop the port adds on the card: a cold full volume
  sealed by the master's own policy, sha256-equal to a JAX offline seal,
  with the degraded reads after it counted as EC decodes.
"""

import hashlib
import io
import json
import re
import shutil
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import usage as jax_usage
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.pipeline.encode import encode_volume as jax_encode_volume
from seaweedfs_tpu.shell import cluster_commands as jax_cluster_commands
from seaweedfs_tpu.shell import commands as jax_commands
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu_torch.cluster import master, operation, usage, \
    volume_server
from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch.shell import cluster_commands, commands
from seaweedfs_tpu_torch.storage import ec_files, store
from seaweedfs_tpu_torch.storage import volume as volume_mod
from seaweedfs_tpu_torch.util import faults

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
MASTER = {"jax": jax_master, "port": master}
SERVER = {"jax": (jax_volume_server, jax_store),
          "port": (volume_server, store)}
FAULTS = {"jax": jax_faults, "port": faults}
USAGE = {"jax": jax_usage, "port": usage}
SHELL = {"jax": (jax_cluster_commands, jax_commands.ShellError),
         "port": (cluster_commands, commands.ShellError)}
SEALED = [ec_files.shard_ext(i) for i in range(14)] + [".ecx", ".vif"]


@pytest.fixture(autouse=True)
def _clean_faults():
    for mod in FAULTS.values():
        mod.clear()
    yield
    for mod in FAULTS.values():
        mod.clear()


def _wait_for(pred, timeout=30.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _cluster(tmp_path, master_pkg, server_pkg, n=2, volumes=(), **ms_kw):
    """A ``master_pkg`` master and ``n`` ``server_pkg`` servers joined in
    turn; ``volumes[i]`` is a list of (vid, needles, avg size) made in
    server i's directory before it starts."""
    ms = MASTER[master_pkg].MasterServer(
        port=_free_port_pair(), pulse_seconds=PULSE, seed=3,
        **dict({"volume_size_limit_mb": 64}, **ms_kw)).start()
    vs_mod, st_mod = SERVER[server_pkg]
    servers = []
    for i in range(n):
        d = tmp_path / f"{master_pkg}-{server_pkg}{i}"
        d.mkdir(parents=True)
        for vid, needles, avg in (volumes[i] if i < len(volumes) else ()):
            volume_mod.generate_synthetic_volume(
                d / store.volume_base_name(vid, ""), vid, needles,
                avg_size=avg, seed=vid).close()
        st = st_mod.Store([d], max_volumes=8)
        st.load_existing()
        kw = dict(device="cpu") if server_pkg == "port" else {}
        servers.append(vs_mod.VolumeServer(
            st, port=_free_port_pair(), master_url=ms.url,
            pulse_seconds=PULSE, job_poll_seconds=0.1, **kw).start())
        _wait_for(lambda: len(ms.topology.nodes) == i + 1,
                  what="volume server registration")
    return ms, servers


def _stop(ms, servers):
    for vs in servers:
        try:
            vs.stop()
        except Exception:  # noqa: BLE001 — some are stopped mid-test
            pass
    ms.stop()


def _http(method, url, data=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json(url):
    return json.loads(_http("GET", url)[1])


# ---------------------------------------------------------------------------
# mixed clusters: the same rows at either package's master
# ---------------------------------------------------------------------------

def _drive(tmp_path, master_pkg, server_pkg):
    """One replicated needle written through server A, read 5 times on A
    and 3 times on B (plus one 404 on B), then 4 reads on A that an
    injected fault fails. Returns the master's rows with time-derived
    fields masked, nodes named A and B."""
    ms, servers = _cluster(tmp_path, master_pkg, server_pkg,
                           default_replication="001")
    a, b = servers
    role = {a.url: "A", b.url: "B"}
    base = f"http://{ms.url}"
    try:
        vid = ms.grow_volume("")
        for vs in servers:
            vs.heartbeat_now()
        fid = f"{vid},{1:x}{0x1234abcd:08x}"
        body = b"telemetry" * 500
        status, _ = _http("POST", f"http://{a.url}/{fid}", body)
        assert status == 201
        for _ in range(5):
            assert _http("GET", f"http://{a.url}/{fid}") == (200, body)
        for _ in range(3):
            assert _http("GET", f"http://{b.url}/{fid}") == (200, body)
        assert _http("GET", f"http://{b.url}/{vid},2000000000")[0] == 404
        FAULTS[server_pkg].inject("volume.read", "error#4")
        for _ in range(4):
            assert _http("GET", f"http://{a.url}/{fid}")[0] == 500
        FAULTS[server_pkg].clear()

        def landed():
            for vs in servers:
                vs.heartbeat_now()
            doc = _json(f"{base}/cluster/telemetry")
            rows = doc["volumes"].get(str(vid), {})
            reads = {role[u]: r["read_ops"] for u, r in rows.items()}
            return doc if reads == {"A": 9, "B": 4} else None
        tele = _wait_for(landed, what="both nodes' reads at the master")
        udoc = _json(f"{base}/cluster/usage")
        topk = _json(f"{base}/cluster/topk?n=10")
        order = [role[n["url"]] for n in
                 _json(f"{base}/dir/lookup?volumeId={vid}")["locations"]]
        ranked = [role[n.url] for n in ms._rank_replicas(
            [n for n in ms.topology.snapshot_nodes()
             if n.url in role], vid)]
    finally:
        _stop(ms, servers)
    keep = ("collection", "read_ops", "write_ops", "read_bytes",
            "write_bytes", "cache_hits", "cache_misses", "ec_decodes",
            "errors")
    rows = {role[u]: {k: r[k] for k in keep} | {
        "read_latency_count": r.get("read_latency", {}).get("count"),
        "write_latency_count": r.get("write_latency", {}).get("count")}
        for u, r in tele["volumes"][str(vid)].items()}
    nodes = {role[u]: {"verdict": n["health"]["verdict"],
                       "volume_count": n["volume_count"]}
             for u, n in tele["nodes"].items()}
    sources = {role[s]: {k: v for k, v in row.items()
                         if k not in ("last_ingest_age_seconds",
                                      "snapshots")}
               for s, row in udoc["sources"].items()}
    top = [(e["key"].replace(fid, "FID"), e["count"], e["error"],
            e["volume"] == vid) for e in topk["top"]]
    return {"rows": rows, "nodes": nodes, "sources": sources,
            "tenants": udoc["tenants"], "totals": udoc["totals"],
            "top": top, "topk_total": topk["total"],
            "lookup": order, "rank": ranked}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    return {pkg: _drive(tmp_path_factory.mktemp(f"twin-{pkg}"), pkg, pkg)
            for pkg in ("jax", "port")}


def test_all_port_cluster_equals_all_jax_twin(twins):
    assert twins["port"] == twins["jax"]
    got = twins["port"]
    assert got["rows"]["A"]["read_ops"] == 9
    assert got["rows"]["A"]["errors"] == 4
    assert got["rows"]["A"]["write_ops"] == got["rows"]["B"]["write_ops"] \
        == 1
    assert got["rows"]["B"]["read_latency_count"] == 4
    assert got["nodes"]["A"]["verdict"] == "unhealthy"
    assert got["nodes"]["B"]["verdict"] == "healthy"
    assert got["top"][0] == ("FID", 12, 0, True)     # 9 on A, 3 on B
    # the condemned replica is excluded from the lookup
    assert got["lookup"] == got["rank"] == ["B"]


@pytest.mark.parametrize("master_pkg,server_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_mixed_cluster_rows_equal_the_twins(tmp_path, twins, master_pkg,
                                            server_pkg):
    got = _drive(tmp_path, master_pkg, server_pkg)
    assert got == twins["jax"] == twins["port"]


# ---------------------------------------------------------------------------
# the shells' lines
# ---------------------------------------------------------------------------

_ADDR = re.compile(r"127\.0\.0\.1:\d+")
_NUM = re.compile(r"\d+(\.\d+)?")
_SOURCES = re.compile(r"\(sources: ([^)]*)\)")


def _shell_lines(tmp_path, pkg):
    ms, servers = _cluster(tmp_path, pkg, pkg)
    shell, shell_error = SHELL[pkg]
    out = io.StringIO()
    env = shell.ClusterEnv(master_url=ms.url, out=out)
    lines = {}
    try:
        ms.slo.configure({"slo": {"enabled": True, "read_p99_ms": 5000.0,
                                  "availability": 0.5}})
        vid = ms.grow_volume("")
        for vs in servers:
            vs.heartbeat_now()
        holder = ms.lookup(vid)[0]["url"]
        fid = f"{vid},{1:x}{0x1234abcd:08x}"
        assert _http("POST", f"http://{holder}/{fid}", b"x" * 999)[0] == 201
        for _ in range(3):
            assert _http("GET", f"http://{holder}/{fid}")[0] == 200
        # a gateway's push: two tenants' rows, one hot object key
        col = USAGE[pkg].UsageCollector("s3")
        for i in range(4):
            col.record("alice", "photos", n_out=8192, seconds=0.002,
                       key="photos/hot.bin")
        col.record("bob", "logs", n_in=128, error=True, key="logs/a")
        USAGE[pkg].UsagePusher(col, ms.url, "s3@gw").push_once()

        def landed():
            for vs in servers:
                vs.heartbeat_now()
            doc = _json(f"http://{ms.url}/cluster/telemetry")
            rows = doc["volumes"].get(str(vid), {})
            return sum(r["read_ops"] for r in rows.values()) == 3
        _wait_for(landed, what="the reads at the master")
        for cmd in ("telemetry.status", "volume.heatmap", "traffic.top",
                    "tenant.usage", "cluster.check"):
            out.seek(0)
            out.truncate()
            try:
                shell.run_cluster_command(env, cmd)
            except shell_error as e:
                out.write(f"error: {e}\n")
            text = out.getvalue().replace(fid, "FID").replace(
                holder, "HOLDER")
            text = _NUM.sub("N", _ADDR.sub("HOST", text))
            lines[cmd] = text.splitlines()
            lines[cmd] = [_SOURCES.sub(
                lambda m: "(sources: " + ", ".join(
                    sorted(m.group(1).split(", "))) + ")", ln)
                for ln in lines[cmd]]
            if cmd in ("telemetry.status", "cluster.check"):
                # node lines come in address order, which the free
                # ports decide
                lines[cmd] = sorted(lines[cmd][:-1]) + lines[cmd][-1:]
    finally:
        env.close()
        _stop(ms, servers)
    return lines


def test_shells_print_the_same_telemetry_and_usage_lines(tmp_path):
    got = {pkg: _shell_lines(tmp_path / pkg, pkg) for pkg in SHELL}
    assert got["port"] == got["jax"]
    lines = got["port"]
    assert lines["telemetry.status"][0].startswith("HOLDER: healthy")
    assert lines["volume.heatmap"][0].split()[:3] == ["volume",
                                                      "collection", "node"]
    assert lines["traffic.top"][0].startswith("traffic.top: N keyed")
    assert lines["tenant.usage"][0] == \
        "alice: N requests in=NB out=NKiB errors=N"
    assert lines["tenant.usage"][-1].startswith("total: N requests")
    assert any(ln.endswith("photos/hot.bin") for ln in lines["traffic.top"])
    assert lines["cluster.check"][-1].endswith("N problems")


# ---------------------------------------------------------------------------
# the policy engine on port clusters
# ---------------------------------------------------------------------------

def test_policy_loop_grows_then_shrinks_replica(tmp_path):
    """JAX ``test_jobs.py``'s acceptance loop on a port master and two
    port servers: hot reads on one volume -> the policy submits
    ``replicate`` -> ``/dir/lookup`` serves the new replica -> load stops
    -> the replica is dropped back to the placement's copy count."""
    ms, servers = _cluster(tmp_path, "port", "port")
    mc = MasterClient(ms.url)
    try:
        ms.topology.telemetry.halflife = 0.5
        ms.policy.configure({
            "policy": True, "policy_interval_seconds": 0.3,
            "hot_read_ops_per_second": 2.0,
            "cool_read_ops_per_second": 0.5,
            "max_replicas": 2, "cooldown_seconds": 1.0})
        a = operation.assign(mc, collection="hot")
        want = b"hot-needle" * 200
        operation.upload(a.url, a.fid, want, jwt=a.auth, collection="hot")
        vid = int(a.fid.split(",")[0])
        time.sleep(2.5 * PULSE)
        assert len(mc.lookup(vid, "hot")) == 1
        deadline = time.time() + 12
        grown = False
        while time.time() < deadline:
            urllib.request.urlopen(
                f"http://{a.url}/{a.fid}?collection=hot").read()
            if len(ms.lookup(vid, "hot")) == 2:
                grown = True
                break
            time.sleep(0.02)
        assert grown, "policy never grew the hot replica"
        assert "replicate" in [x["action"] for x in ms.policy.actions]
        mc.invalidate()
        assert operation.download(mc, a.fid, collection="hot") == want
        _wait_for(lambda: len(ms.lookup(vid, "hot")) == 1, 20,
                  "replica shrink after cooldown")
        acts = [x["action"] for x in ms.policy.actions]
        assert acts.count("replicate") == 1
        assert acts.count("replica_drop") == 1
        assert all(j["submittedBy"] == "policy"
                   for j in ms.jobs.to_map()["jobs"])
    finally:
        mc.close()
        _stop(ms, servers)


def test_policy_seals_a_cold_full_volume_and_counts_degraded_reads(
        tmp_path):
    """A port master with the policy armed and a 1 MB size limit, a
    volume past 90% of it on server A and nothing reading it: within a
    few ticks the master submits ``ec_encode`` on its own, A's worker
    seals it (sha256-equal to a JAX offline seal), and after the source
    and four shards are dropped every degraded GET through the master's lookup is
    byte-equal and counted once as an EC decode at the master."""
    vid = 7
    ms, servers = _cluster(tmp_path, "port", "port",
                           volumes=[[(vid, 400, 2500)]],
                           volume_size_limit_mb=1)
    a = servers[0]
    base = a.store.locations[0].directory / store.volume_base_name(vid, "")
    ref = tmp_path / "ref" / base.name
    ref.parent.mkdir()
    for ext in (".dat", ".idx"):
        shutil.copyfile(str(base) + ext, str(ref) + ext)
    jax_encode_volume(ref)
    want = {n: _sha(str(ref) + n) for n in SEALED}
    needles = {}
    v = volume_mod.Volume(ref, vid).load()
    try:
        for key in sorted(e.key for e in v.nm.items())[::8]:
            n = v.read_needle(key)
            needles[key] = (n.cookie, n.data)
    finally:
        v.close()
    try:
        for vs in servers:
            vs.heartbeat_now()
        ms.policy.configure({"policy": True,
                             "policy_interval_seconds": 0.3,
                             "cooldown_seconds": 600.0})

        def sealed():
            jobs = [j for j in ms.jobs.to_map()["jobs"]
                    if j["kind"] == "ec_encode"
                    and j["submittedBy"] == "policy"]
            return jobs if jobs and jobs[0]["state"] in ("done",
                                                         "failed") else None
        jobs = _wait_for(sealed, 60, "the policy's ec_encode to end")
        assert [j["state"] for j in jobs] == ["done"], jobs
        assert [x["action"] for x in ms.policy.actions] == ["ec_encode"]
        assert {n: _sha(str(base) + n) for n in SEALED} == want
        for vs in servers:
            vs.heartbeat_now()
        _wait_for(lambda: vid in ms.topology.ec_locations,
                  what="the EC shards at the master")
        # the policy's seal keeps the source; drop it, then four shards
        a.servicer.VolumeDelete(vpb.VolumeDeleteRequest(
            volume_id=vid, collection=""), None)
        a.servicer.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection="", shard_ids=[0, 5, 11, 13]), None)
        a.heartbeat_now()
        a.chunk_cache.clear()
        mc = MasterClient(ms.url)
        try:
            for key, (cookie, data) in needles.items():
                fid = f"{vid},{key:x}{cookie:08x}"
                assert operation.download(mc, fid) == data
        finally:
            mc.close()

        def counted():
            for vs in servers:
                vs.heartbeat_now()
            rows = ms.topology.telemetry.to_map()["volumes"].get(
                str(vid), {})
            n = sum(r["ec_decodes"] for r in rows.values())
            return n if n == len(needles) else None
        _wait_for(counted, what="every degraded GET counted")
    finally:
        _stop(ms, servers)
