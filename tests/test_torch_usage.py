"""The port's usage plane (``cluster/usage.py``) and the telemetry-ranked
lookup against the JAX package's, on the CPU.

Mirrors the 13 cases of JAX ``tests/test_usage.py``. Each unit case runs
the same calls through both packages and holds the port's sketches,
payloads, proto bytes, registries and gauges equal to the JAX package's
before the JAX case's own assertions are checked on the port's result.
The lookup cases rank the same replicas on both packages' masters; the
end-to-end case drives the same two-tenant S3 traffic through a port
stack (gateway, filer, master, two volume servers on the CPU) and a JAX
twin and holds the tenants' rows and the hot key equal.
"""

import json
import random
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from conftest import parse_exposition
from seaweedfs_tpu.cluster import filer_server as jax_filer_server
from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import topology as jax_topology
from seaweedfs_tpu.cluster import usage as jax_usage
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.gateway import s3 as jax_s3
from seaweedfs_tpu.gateway import s3_auth as jax_s3_auth
from seaweedfs_tpu.pb import master_pb2 as jax_master_pb2
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu.util import stats as jax_stats
from seaweedfs_tpu_torch.cluster import filer_server, master, topology, usage
from seaweedfs_tpu_torch.cluster import volume_server
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.gateway import s3, s3_auth
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.storage import store
from seaweedfs_tpu_torch.util import faults, stats

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

P = {
    "jax": SimpleNamespace(usage=jax_usage, pb=jax_master_pb2,
                           Digest=jax_stats.Digest, master=jax_master,
                           topology=jax_topology, vs=jax_volume_server,
                           store=jax_store, filer_server=jax_filer_server,
                           Filer=JaxFiler, s3=jax_s3, s3_auth=jax_s3_auth,
                           faults=jax_faults),
    "port": SimpleNamespace(usage=usage, pb=master_pb2,
                            Digest=stats.Digest, master=master,
                            topology=topology, vs=volume_server,
                            store=store, filer_server=filer_server,
                            Filer=Filer, s3=s3, s3_auth=s3_auth,
                            faults=faults),
}


def _both(fn, *args):
    got = {pkg: fn(ns, *args) for pkg, ns in P.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ------------- SpaceSaving sketch -------------

def _zipf_stream(rng, n_items, n_keys=500, s=1.3):
    weights = [1.0 / (k + 1) ** s for k in range(n_keys)]
    return rng.choices([f"k{k}" for k in range(n_keys)],
                       weights=weights, k=n_items)


def _true_counts(stream):
    out = {}
    for k in stream:
        out[k] = out.get(k, 0) + 1
    return out


def test_spacesaving_error_bound_on_zipf_stream():
    stream = _zipf_stream(random.Random(7), 20_000)
    true = _true_counts(stream)

    def run(ns):
        s = ns.usage.SpaceSaving(capacity=50)
        for k in stream:
            s.offer(k)
        return s.total, s.entries()
    total, entries = _both(run)
    assert total == len(stream)
    for r in entries:
        assert r["count"] - r["error"] <= true[r["key"]] <= r["count"]
        assert r["error"] <= len(stream) // 50
    top_true = sorted(true, key=lambda k: -true[k])[:10]
    assert set(top_true) <= {r["key"] for r in entries}


def test_spacesaving_merge_is_order_insensitive():
    stream = _zipf_stream(random.Random(21), 30_000)
    true = _true_counts(stream)
    shards = [stream[i::3] for i in range(3)]

    def run(ns):
        sketches = []
        for part in shards:
            s = ns.usage.SpaceSaving(capacity=64)
            for k in part:
                s.offer(k)
            sketches.append(s)
        out = []
        for order in ((0, 1, 2), (2, 0, 1), (1, 2, 0)):
            m = ns.usage.SpaceSaving(capacity=64)
            for i in order:
                m.merge(sketches[i])
            out.append((m.total, m.entries()))
        return out
    results = _both(run)
    for total, entries in results:
        assert total == len(stream)
        for r in entries:
            assert r["count"] - r["error"] <= true[r["key"]] <= r["count"]
    heavy = [r["key"] for r in results[0][1][:10]]
    assert heavy == sorted(true, key=lambda k: -true[k])[:10]
    for _total, entries in results[1:]:
        assert [r["key"] for r in entries[:10]] == heavy


def test_spacesaving_merge_exact_under_capacity():
    def run(ns):
        a = ns.usage.SpaceSaving(capacity=32)
        b = ns.usage.SpaceSaving(capacity=32)
        for _ in range(5):
            a.offer("x")
        for _ in range(3):
            a.offer("y")
        for _ in range(7):
            b.offer("x")
        for _ in range(2):
            b.offer("z", tenant="acme", volume=4)
        a.merge(b)
        return a.total, {r["key"]: r for r in a.entries()}
    total, est = _both(run)
    assert est["x"]["count"] == 12 and est["x"]["error"] == 0
    assert est["y"]["count"] == 3 and est["z"]["count"] == 2
    assert est["z"]["tenant"] == "acme" and est["z"]["volume"] == 4
    assert total == 17


def test_spacesaving_round_trips():
    stream = _zipf_stream(random.Random(3), 2_000, n_keys=40)

    def run(ns):
        s = ns.usage.SpaceSaving(capacity=8)
        for k in stream:
            s.offer(k, tenant="t1", volume=2)
        d = json.loads(json.dumps(s.to_dict()))
        assert ns.usage.SpaceSaving.from_dict(d).to_dict() == s.to_dict()
        snap = ns.pb.UsageSnapshot()
        s.fill_proto(snap)
        wire = snap.SerializeToString()
        back = ns.usage.SpaceSaving.from_proto(
            ns.pb.UsageSnapshot.FromString(wire))
        assert back.to_dict() == s.to_dict()
        return s.to_dict(), wire
    _d, wire = _both(run)
    # one package's sketch loads in the other's
    back = usage.SpaceSaving.from_proto(
        master_pb2.UsageSnapshot.FromString(wire))
    assert back.to_dict() == _d


# ------------- UsageCollector -------------

def _records(c):
    c.record("acme", "photos", n_in=100, seconds=0.010,
             key="photos/a.jpg")
    c.record("acme", "photos", n_out=5000, seconds=0.002,
             key="photos/a.jpg")
    c.record("", "photos", error=True)  # blank tenant -> anonymous


def test_collector_records_and_snapshots():
    def run(ns):
        c = ns.usage.UsageCollector("s3")
        _records(c)
        p = c.to_payload()
        p["window_ns"] = 0
        snap = c.snapshot()
        snap.window_ns = 0
        wire = snap.SerializeToString()
        back = ns.usage.snapshot_to_payload(
            ns.pb.UsageSnapshot.FromString(wire))
        return p, wire, back
    p, _wire, back = _both(run)
    rows = {(r["tenant"], r["bucket"]): r for r in p["tenants"]}
    acme = rows[("acme", "photos")]
    assert acme["requests"] == 2 and acme["bytes_in"] == 100
    assert acme["bytes_out"] == 5000
    assert stats.Digest.from_dict(acme["latency"]).count == 2
    assert rows[("anonymous", "photos")]["errors"] == 1
    assert p["top_keys"][0]["key"] == "photos/a.jpg"
    assert p["top_keys"][0]["count"] == 2
    assert back["topk_total"] == p["topk_total"]
    assert {(r["tenant"], r["bucket"]) for r in back["tenants"]} == \
        set(rows)


def test_collector_disabled_is_a_noop():
    def run(ns):
        c = ns.usage.UsageCollector("filer")
        ns.usage.configure(enabled=False)
        try:
            c.record("acme", "b", n_in=10, key="x")
            c.record_key("1,abc", volume=1)
            off = ns.usage.enabled()
        finally:
            ns.usage.configure(enabled=True)
        p = c.to_payload()
        return off, p["tenants"], p["top_keys"]
    assert _both(run) == (False, [], [])


def test_configure_from_config_section():
    def run(ns):
        ns.usage.configure_from({"usage": {"enabled": False,
                                           "push_interval_seconds": 0.5}})
        try:
            got = ns.usage.enabled(), ns.usage.push_interval()
        finally:
            ns.usage.configure(enabled=True,
                               push_interval_seconds=ns.usage.PUSH_INTERVAL)
        ns.usage.configure_from({})
        ns.usage.configure_from({"usage": "nope"})
        return got, ns.usage.enabled()
    assert _both(run) == ((False, 0.5), True)


# ------------- ClusterUsage (master side) -------------

def _payload(ns, component="s3", requests=10, key="b/k", tenant="acme",
             bucket="b", lat=None):
    r = {"tenant": tenant, "bucket": bucket, "requests": requests,
         "bytes_in": 0, "bytes_out": requests * 100, "errors": 0}
    if lat is not None:
        d = ns.Digest()
        for x in lat:
            d.add(x)
        r["latency"] = d.to_dict()
    return {"component": component, "window_ns": 1, "tenants": [r],
            "top_keys": [{"key": key, "count": requests, "error": 0,
                          "tenant": tenant, "volume": 0}],
            "topk_total": requests, "topk_capacity": 64}


def test_cluster_usage_replacement_never_double_counts():
    def run(ns):
        cu = ns.usage.ClusterUsage(clock=lambda: 0.0)
        out = []
        cu.ingest("s3@a", _payload(ns, requests=10, lat=[0.01] * 10))
        cu.ingest("s3@a", _payload(ns, requests=15, lat=[0.01] * 15))
        cu.ingest("s3@a", _payload(ns, requests=15, lat=[0.01] * 15))
        out.append(cu.to_map())
        cu.ingest("filer@c", _payload(ns, component="filer", requests=5))
        out.append(cu.to_map())
        out.append(cu.topk_map(n=5))
        cu.ingest("s3@a", _payload(ns, requests=2))
        out.append(cu.to_map())
        cu.forget("filer@c")
        out.append(cu.to_map())
        out.append(cu.metrics.render())
        return out
    one, two, top, reset, forgot, _text = _both(run)
    assert one["tenants"]["acme"]["requests"] == 15
    assert one["totals"]["requests"] == 15
    b = one["tenants"]["acme"]["buckets"]["b"]
    assert b["latency"]["count"] == 15 and "p99" in b["latency"]
    assert one["sources"]["s3@a"]["snapshots"] == 3
    assert two["tenants"]["acme"]["requests"] == 20
    assert top["top"][0]["key"] == "b/k" and top["top"][0]["count"] == 20
    assert reset["tenants"]["acme"]["requests"] == 7
    assert forgot["tenants"]["acme"]["requests"] == 2


def test_cluster_usage_gauges_are_cardinality_capped():
    def run(ns):
        cu = ns.usage.ClusterUsage(clock=lambda: 0.0)
        for i in range(ns.usage.TENANT_GAUGE_CAP + 10):
            cu.ingest(f"s3@{i}", _payload(ns, tenant=f"tenant{i:03d}",
                                          requests=1))
        return cu.metrics.render(), cu.to_map(limit=5)
    text, capped = _both(run)
    samples = parse_exposition(text)
    labels = {lbl["tenant"]
              for lbl, _v in samples["seaweed_tenant_requests_total"]}
    assert len(labels) == usage.TENANT_GAUGE_CAP + 1
    assert "other" in labels
    other = [v for lbl, v in samples["seaweed_tenant_requests_total"]
             if lbl["tenant"] == "other"]
    assert other == [10.0]
    assert capped["tenants_omitted"] == usage.TENANT_GAUGE_CAP + 5


# ------------- telemetry-ranked lookup -------------

def _tele_snap(ns, vid, read_ops=0, errors=0, hits=0, misses=0):
    s = ns.pb.TelemetrySnapshot(window_ns=1_000_000_000)
    s.volumes.add(volume_id=vid, read_ops=read_ops, errors=errors,
                  cache_hits=hits, cache_misses=misses)
    return s


def test_lookup_ranks_warm_healthy_replicas_first():
    def run(ns):
        ms = ns.master.MasterServer(port=0, pulse_seconds=5.0, seed=1,
                                    clock=lambda: 1000.0)
        for url in ("h1:8080", "h2:8080", "h3:8080"):
            ms.topology.register_heartbeat(
                url, max_volume_count=8,
                volumes=[ns.topology.VolumeInfo(id=1, size=10)])
        out = [[n["url"] for n in ms.lookup(1)]]
        tele = ms.topology.telemetry
        tele.ingest("h1:8080", _tele_snap(ns, 1, read_ops=100, errors=60))
        tele.ingest("h2:8080", _tele_snap(ns, 1, read_ops=100))
        tele.ingest("h3:8080", _tele_snap(ns, 1, read_ops=100,
                                          hits=95, misses=5))
        out.append([n["url"] for n in ms.lookup(1)])
        out.append(ms.metrics.counter(
            "lookup_unhealthy_excluded_total").value)
        tele.ingest("h2:8080", _tele_snap(ns, 1, read_ops=100, errors=60))
        tele.ingest("h3:8080", _tele_snap(ns, 1, read_ops=100, errors=60))
        out.append(len(ms.lookup(1)))
        return out
    plain, ranked, excluded, floor = _both(run)
    assert plain == ["h1:8080", "h2:8080", "h3:8080"]
    assert ranked == ["h3:8080", "h2:8080"]
    assert excluded >= 1
    assert floor == 3


def test_lookup_ec_fallback_reports_shards_ranked():
    def run(ns):
        ms = ns.master.MasterServer(port=0, pulse_seconds=5.0, seed=1,
                                    clock=lambda: 1000.0)
        ms.topology.register_heartbeat("e1:8080", max_volume_count=8,
                                       ec_shards=[("", 7, 0b0011)])
        ms.topology.register_heartbeat("e2:8080", max_volume_count=8,
                                       ec_shards=[("", 7, 0b1100)])
        by_url = {n["url"]: n["shards"] for n in ms.lookup(7)}
        ms.topology.telemetry.ingest(
            "e1:8080", _tele_snap(ns, 7, read_ops=100, errors=60))
        ms.topology.telemetry.ingest("e2:8080",
                                     _tele_snap(ns, 7, read_ops=100))
        return by_url, [n["url"] for n in ms.lookup(7)]
    by_url, ranked = _both(run)
    assert by_url == {"e1:8080": [0, 1], "e2:8080": [2, 3]}
    assert ranked == ["e2:8080", "e1:8080"]


# ------------- end-to-end mini-cluster -------------

PULSE = 0.2


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _usage_stack(ns, tmp_path):
    """A ``ns`` master (replication 001), two volume servers, a filer and
    a SigV4 gateway with two identities, all pushing usage there."""
    ms = ns.master.MasterServer(port=_free_port_pair(),
                                volume_size_limit_mb=64,
                                pulse_seconds=PULSE, seed=11,
                                default_replication="001",
                                garbage_threshold=0).start()
    vols = []
    for i in range(2):
        d = tmp_path / f"v{i}"
        d.mkdir(parents=True)
        kw = dict(device="cpu") if ns is P["port"] else {}
        vols.append(ns.vs.VolumeServer(
            ns.store.Store([d], max_volumes=8), port=_free_port_pair(),
            master_url=ms.url, pulse_seconds=PULSE, **kw).start())
    _wait(lambda: len(ms.topology.nodes) == 2, 10, "two volume servers")
    filer = ns.filer_server.FilerServer(ns.Filer(), port=_free_port_pair(),
                                        master_url=ms.url).start()
    idents = [ns.s3_auth.Identity(name="alice", access_key="AK1",
                                  secret_key="S1"),
              ns.s3_auth.Identity(name="bob", access_key="AK2",
                                  secret_key="S2")]
    gw = ns.s3.S3Gateway(filer.url, port=_free_port_pair(),
                         identities=idents, master_url=ms.url).start()
    return ms, vols, filer, gw


def _drive(ns, tmp_path):
    """The JAX case's two-tenant traffic and fault; returns what the
    master said about it."""
    ms, vols, filer, gw = _usage_stack(ns, tmp_path)

    def s3_call(method, path, body=b"", ak="AK1", sk="S1"):
        url = f"http://{gw.url}{path}"
        hdrs = ns.s3_auth.sign_request_headers(method, url, {}, body,
                                               ak, sk)
        req = urllib.request.Request(url, data=body or None,
                                     method=method, headers=hdrs)
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read()

    base = f"http://{ms.url}"
    try:
        s3_call("PUT", "/photos")
        s3_call("PUT", "/photos/hot.bin", b"h" * 8192)
        for _ in range(30):
            assert s3_call("GET", "/photos/hot.bin") == b"h" * 8192
        s3_call("PUT", "/logs", ak="AK2", sk="S2")
        for i in range(5):
            s3_call("PUT", f"/logs/l{i}.txt", b"l" * 128, ak="AK2",
                    sk="S2")
            s3_call("GET", f"/logs/l{i}.txt", ak="AK2", sk="S2")

        def surfaced():
            doc = _get_json(f"{base}/cluster/topk?n=50")
            ok = doc["top"] and doc["top"][0]["key"] == "photos/hot.bin" \
                and any(e["volume"] > 0 for e in doc["top"])
            return doc if ok else None
        top = _wait(surfaced, 15, "the hot key on the master")

        def settled():
            doc = _get_json(f"{base}/cluster/usage")
            t = doc["tenants"]
            return doc if {"alice", "bob"} <= set(t) and \
                t["alice"]["requests"] == 32 and \
                t["bob"]["requests"] == 11 else None
        udoc = _wait(settled, 15, "both tenants' pushed rows")
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            fams = parse_exposition(r.read().decode())

        vid = next(v for v in range(1, ms.topology.max_volume_id + 1)
                   if len(ms.topology.lookup_volume(v)) == 2)
        urls = [n["url"] for n in
                _get_json(f"{base}/dir/lookup?volumeId={vid}")
                ["locations"]]
        victim, healthy = urls[0], urls[1]
        ns.faults.inject("volume.read", "error#8")
        for _ in range(10):
            try:
                urllib.request.urlopen(
                    f"http://{victim}/{vid},00000000000000",
                    timeout=10).read()
            except urllib.error.HTTPError:
                pass

        def demoted():
            got = [n["url"] for n in _get_json(
                f"{base}/dir/lookup?volumeId={vid}")["locations"]]
            return got if got in ([healthy, victim], [healthy]) else None
        ranked = _wait(demoted, 15, f"faulted replica {victim} demoted")
        hot = top["top"][0]
        tenants = {t: {b: {k: v for k, v in row.items() if k != "latency"}
                       for b, row in udoc["tenants"][t]["buckets"].items()}
                   for t in ("alice", "bob")}
        return {"hot": (hot["key"], hot["tenant"],
                        hot["count"] - hot["error"] <= 31 <= hot["count"]),
                "tenants": tenants,
                "latency_counted":
                    udoc["tenants"]["alice"]["buckets"]["photos"]
                    ["latency"]["count"] > 0,
                "gauge_tenants": {"alice", "bob"} <= {
                    lbl["tenant"] for lbl, _v in
                    fams["seaweed_tenant_requests_total"]},
                "victim_led": ranked[0] == victim}
    finally:
        ns.faults.clear()
        gw.stop()
        filer.stop()
        for v in vols:
            v.stop()
        ms.stop()


def test_usage_cluster_end_to_end(tmp_path):
    """Two tenants drive zipfian S3 traffic through a replicated
    mini-cluster of each package: both masters attribute the hot key to
    alice, account both tenants' buckets with equal rows and gauges, and
    demote a faulted replica in the lookup order."""
    for mod in (usage, jax_usage):
        mod.configure(push_interval_seconds=0.2)
    try:
        got = {pkg: _drive(ns, tmp_path / pkg) for pkg, ns in P.items()}
    finally:
        for mod in (usage, jax_usage):
            mod.configure(push_interval_seconds=mod.PUSH_INTERVAL)
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["hot"] == ("photos/hot.bin", "alice", True)
    alice, bob = g["tenants"]["alice"], g["tenants"]["bob"]
    assert alice["photos"]["requests"] == 32   # bucket PUT, PUT, 30 GETs
    assert alice["photos"]["bytes_out"] >= 30 * 8192
    assert sum(b["requests"] for b in bob.values()) == 11
    assert g["latency_counted"] and g["gauge_tenants"]
    assert not g["victim_led"]


def test_heartbeat_proto_carries_usage_and_shards():
    def run(ns):
        hb = ns.pb.Heartbeat(ip="127.0.0.1", port=8080)
        snap = ns.usage.UsageCollector("volume").snapshot()
        snap.window_ns = 0
        hb.usage.CopyFrom(snap)
        hb.usage.top_keys.add(key="1,ab01", count=3, volume=1)
        wire = ns.pb.Heartbeat.FromString(hb.SerializeToString())
        assert wire.HasField("usage")
        loc = ns.pb.Location(url="a:1", shards=[0, 3, 9])
        return hb.SerializeToString(), wire.usage.top_keys[0].key, \
            list(ns.pb.Location.FromString(loc.SerializeToString()).shards)
    _wire, key, shards = _both(run)
    assert key == "1,ab01" and shards == [0, 3, 9]
