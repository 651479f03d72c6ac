"""The port's telemetry plane (``cluster/telemetry.py``, ``util/stats.Digest``)
against the JAX package's, on the CPU.

Mirrors the 20 cases of JAX ``tests/test_telemetry.py`` and the
``Digest.cdf`` and ``SloEngine`` cases of
``tests/test_observability_cluster.py``. Each case runs the same calls
through both packages and holds the port to the JAX package: the same
seeded samples give equal ``Digest.to_dict()``, equal proto bytes and
equal quantiles, exactly; the collector's snapshot is proto-equal; the
registry gives equal rates, health and ``to_map`` under one fake clock;
the SLO engine equal payloads and gauges. The JAX case's own assertions
are then checked on the port's result.
"""

import json
import math
import random
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import parse_exposition
from seaweedfs_tpu.cache import chunk_cache as jax_chunk_cache
from seaweedfs_tpu.cluster import telemetry as jax_telemetry
from seaweedfs_tpu.pb import master_pb2 as jax_master_pb2
from seaweedfs_tpu.util import stats as jax_stats
from seaweedfs_tpu.util import tracing as jax_tracing
from seaweedfs_tpu.util import varz as jax_varz
from seaweedfs_tpu_torch.cache import chunk_cache
from seaweedfs_tpu_torch.cluster import telemetry
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.util import stats, tracing, varz

from torch_teardown import collect_jax_garbage  # noqa: F401

P = {
    "jax": SimpleNamespace(Digest=jax_stats.Digest,
                           Metrics=jax_stats.Metrics,
                           telemetry=jax_telemetry, pb=jax_master_pb2,
                           cache=jax_chunk_cache, varz=jax_varz,
                           tracing=jax_tracing),
    "port": SimpleNamespace(Digest=stats.Digest, Metrics=stats.Metrics,
                            telemetry=telemetry, pb=master_pb2,
                            cache=chunk_cache, varz=varz,
                            tracing=tracing),
}


def _both(fn, *args):
    """``fn(P[pkg], *args)`` for both packages; the port's result must
    equal the JAX package's. Returns the port's."""
    got = {pkg: fn(ns, *args) for pkg, ns in P.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _state(d) -> dict:
    """Everything a Digest ships, plus its proto bytes."""
    return {"dict": d.to_dict(), "proto": d.to_proto().SerializeToString(),
            "count": d.count, "sum": d.sum, "min": d.min, "max": d.max}


def _samples(kind: str, n: int = 5000, seed: int = 42) -> list[float]:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        v = rng.random(n)
    elif kind == "lognormal":
        v = rng.lognormal(0.0, 2.0, n)
    else:  # bimodal: fast cache hits + slow disk reads
        fast = rng.random(n) < 0.9
        v = np.where(fast, rng.normal(0.001, 0.0001, n),
                     rng.normal(0.050, 0.005, n))
    return [float(x) for x in v]


def _true_quantile(sorted_vals, q):
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _nan_safe(x):
    return "nan" if isinstance(x, float) and math.isnan(x) else x


# ------------- Digest -------------

def test_digest_empty():
    def run(ns):
        d = ns.Digest()
        assert d.count == 0 and math.isnan(d.quantile(0.5))
        e = ns.Digest()
        e.merge(d)
        assert e.count == 0 and math.isnan(e.quantile(0.99))
        return _state(e)
    _both(run)


def test_digest_one_sample():
    def run(ns):
        d = ns.Digest()
        d.add(0.125)
        return [d.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)], _state(d)
    qs, st = _both(run)
    assert qs == [0.125] * 4
    assert st["min"] == st["max"] == 0.125
    assert st["count"] == 1 and st["sum"] == 0.125


def test_digest_exact_extremes():
    def run(ns):
        d = ns.Digest(max_centroids=8)
        for v in range(1000):
            d.add(v / 10.0)
        return d.quantile(0.0), d.quantile(1.0), _state(d)
    lo, hi, st = _both(run)
    assert (lo, hi) == (0.0, 99.9)
    assert st["count"] == 1000
    assert st["sum"] == pytest.approx(sum(v / 10.0 for v in range(1000)))


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
def test_digest_quantile_accuracy_vs_sorted_reference(dist):
    """Equal sketches and quantiles in both packages, exactly; and, as in
    the JAX case, near truth by rank (0.05) or value (10%)."""
    vals = _samples(dist)
    qs = (0.1, 0.5, 0.9, 0.95, 0.99)

    def run(ns):
        d = ns.Digest(max_centroids=64)
        for v in vals:
            d.add(v)
        return [d.quantile(q) for q in qs], _state(d)
    est, _ = _both(run)
    s = sorted(vals)
    for q, e in zip(qs, est):
        true = _true_quantile(s, q)
        lo = _true_quantile(s, max(0.0, q - 0.05))
        hi = _true_quantile(s, min(1.0, q + 0.05))
        assert lo <= e <= hi or abs(e - true) <= 0.10 * abs(true), \
            f"{dist} q={q}: {e} vs true {true}"


def test_digest_merge_matches_single_digest():
    rng = np.random.default_rng(7)
    shards = [[float(x) for x in rng.exponential(1.0, 800)]
              for _ in range(3)]

    def run(ns):
        whole = ns.Digest()
        parts = []
        for shard in shards:
            p = ns.Digest()
            for v in shard:
                p.add(v)
                whole.add(v)
            parts.append(p)
        out = {}
        for order in ((0, 1, 2), (2, 0, 1)):
            m = ns.Digest()
            for i in order:
                m.merge(parts[i])
            out[order] = (_state(m), [m.quantile(q)
                                      for q in (0.5, 0.95, 0.99)])
        out["whole"] = (_state(whole), [whole.quantile(q)
                                        for q in (0.5, 0.95, 0.99)])
        return out
    out = _both(run)
    allv = sorted(v for s in shards for v in s)
    for key in ((0, 1, 2), (2, 0, 1)):
        st, _q = out[key]
        assert st["count"] == len(allv)
        assert st["min"] == allv[0] and st["max"] == allv[-1]
        assert st["sum"] == pytest.approx(out["whole"][0]["sum"])
    for i, q in enumerate((0.5, 0.95, 0.99)):
        lo = _true_quantile(allv, max(0.0, q - 0.05))
        hi = _true_quantile(allv, min(1.0, q + 0.05))
        for key in ((0, 1, 2), (2, 0, 1), "whole"):
            assert lo <= out[key][1][i] <= hi
        assert out[(0, 1, 2)][1][i] == \
            pytest.approx(out[(2, 0, 1)][1][i], rel=0.25)


def test_digest_proto_and_dict_round_trip():
    rng = random.Random(1)
    vals = [rng.random() for _ in range(500)]

    def run(ns):
        d = ns.Digest(max_centroids=16)
        for v in vals:
            d.add(v)
        backs = [ns.Digest.from_proto(d.to_proto(), max_centroids=16),
                 ns.Digest.from_dict(json.loads(json.dumps(d.to_dict())),
                                     max_centroids=16)]
        e = ns.Digest.from_proto(ns.Digest().to_proto())
        return ([(_state(b), b.quantile(0.5), b.quantile(0.99))
                 for b in backs], (_state(d), d.quantile(0.5),
                                   d.quantile(0.99)),
                (e.count, _nan_safe(e.quantile(0.5))))
    backs, orig, empty = _both(run)
    for st, q50, q99 in backs:
        assert st["count"] == orig[0]["count"]
        assert st["min"] == orig[0]["min"] and st["max"] == orig[0]["max"]
        assert st["sum"] == pytest.approx(orig[0]["sum"])
        assert q50 == pytest.approx(orig[1])
        assert q99 == pytest.approx(orig[2])
    assert empty == (0, "nan")
    # a digest shipped by one package loads in the other unchanged
    d = stats.Digest(max_centroids=16)
    for v in vals:
        d.add(v)
    wire = d.to_proto().SerializeToString()
    j = jax_stats.Digest.from_proto(
        jax_master_pb2.DigestMessage.FromString(wire), max_centroids=16)
    assert j.to_dict() == d.to_dict()


def test_digest_bounded_size():
    def run(ns):
        d = ns.Digest(max_centroids=32)
        for i in range(10_000):
            d.add(float(i))
        msg = d.to_proto()
        return len(msg.centroid_means), msg.count, _state(d)
    n, count, _ = _both(run)
    assert n <= 32 and count == 10_000


def test_digest_cdf_edges_and_interpolation():
    def run(ns):
        d = ns.Digest()
        empty = _nan_safe(d.cdf(1.0))
        for v in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0):
            d.add(v)
        return empty, [d.cdf(x) for x in (0.01, 1.0, 99.0, 0.5, 0.15,
                                          0.35, 0.55, 0.75, 0.95)]
    empty, cs = _both(run)
    assert empty == "nan"
    assert cs[:3] == [0.0, 1.0, 1.0]
    assert 0.3 < cs[3] < 0.7
    assert cs[4:] == sorted(cs[4:])


# ------------- TelemetryCollector (volume-server side) -------------

def _collector_calls(c):
    for _ in range(10):
        c.record_read(3, 1000, 0.002)
    c.record_write(3, 500, 0.004)
    c.record_read(3, 0, 0.5, error=True)
    c.record_ec_decode(7, n=2)


def _wire(snap) -> bytes:
    snap = type(snap).FromString(snap.SerializeToString())
    snap.window_ns = 0           # the one field read off the clock
    return snap.SerializeToString()


def test_collector_snapshot_cumulative_counters_drained_digests(
        monkeypatch):
    def run(ns):
        monkeypatch.setattr(ns.telemetry.profiler, "enabled",
                            lambda: False)
        c = ns.telemetry.TelemetryCollector()
        _collector_calls(c)
        snap = c.snapshot(cache_counts={3: {"hits": 8, "misses": 3}},
                          collections={3: "photos"})
        assert snap.window_ns >= 0
        hb = ns.pb.Heartbeat(ip="127.0.0.1", port=8080)
        hb.telemetry.CopyFrom(snap)
        hb2 = ns.pb.Heartbeat.FromString(hb.SerializeToString())
        assert hb2.HasField("telemetry")
        c.record_read(3, 100, 0.001)
        return _wire(snap), _wire(c.snapshot()), json.dumps(
            c.to_map(), sort_keys=True)
    first, second, local = _both(run)
    snap = master_pb2.TelemetrySnapshot.FromString(first)
    by_vid = {v.volume_id: v for v in snap.volumes}
    v3 = by_vid[3]
    assert v3.collection == "photos"
    assert v3.read_ops == 11 and v3.write_ops == 1
    assert v3.read_bytes == 10_000 and v3.write_bytes == 500
    assert v3.cache_hits == 8 and v3.cache_misses == 3
    assert v3.errors == 1 and v3.read_latency.count == 11
    assert by_vid[7].ec_decodes == 2
    snap2 = master_pb2.TelemetrySnapshot.FromString(second)
    v3b = {v.volume_id: v for v in snap2.volumes}[3]
    assert v3b.read_ops == 12
    assert v3b.read_latency.count == 1  # only the new window's sample
    assert json.loads(local)["3"]["read_ops"] == 12


def test_collector_disabled_is_a_noop():
    def run(ns):
        c = ns.telemetry.TelemetryCollector()
        ns.telemetry.configure(enabled=False)
        try:
            assert not ns.telemetry.enabled()
            c.record_read(1, 100, 0.001)
            c.record_write(1, 100, 0.001)
            c.record_ec_decode(1)
            return len(c.snapshot().volumes)
        finally:
            ns.telemetry.configure(enabled=True)
    assert _both(run) == 0
    assert telemetry.enabled()


def test_configure_from_config_section():
    def run(ns):
        ns.telemetry.configure_from({"telemetry": {"enabled": False}})
        try:
            off = ns.telemetry.enabled()
        finally:
            ns.telemetry.configure(enabled=True)
        ns.telemetry.configure_from({})
        ns.telemetry.configure_from({"telemetry": "nope"})
        return off, ns.telemetry.enabled()
    assert _both(run) == (False, True)


# ------------- ClusterTelemetry (master side) -------------

def _snap(ns, read_ops=0, write_ops=0, errors=0, vid=1, lat=None):
    s = ns.pb.TelemetrySnapshot(window_ns=1_000_000_000)
    v = s.volumes.add(volume_id=vid, read_ops=read_ops,
                      write_ops=write_ops, errors=errors,
                      cache_hits=read_ops // 2, cache_misses=read_ops)
    if lat is not None:
        d = ns.Digest()
        for x in lat:
            d.add(x)
        v.read_latency.CopyFrom(d.to_proto())
    return s


def test_registry_rates_and_decay():
    def run(ns):
        now = [1000.0]
        reg = ns.telemetry.ClusterTelemetry(halflife=10.0, window=60.0,
                                            clock=lambda: now[0])
        reg.ingest("n1", _snap(ns, read_ops=0))
        now[0] += 10.0
        reg.ingest("n1", _snap(ns, read_ops=100, lat=[0.001] * 50))
        row = reg.node_volumes("n1")[1]
        now[0] += 20.0  # two half-lives
        return row, reg.node_volumes("n1")[1]["read_ops_per_second"]
    row, decayed = _both(run)
    assert row["read_ops"] == 100
    assert row["read_ops_per_second"] == pytest.approx(5.0, rel=0.01)
    assert row["cache_hit_ratio"] == pytest.approx(50 / 150)
    assert row["read_latency"]["count"] == 50
    assert decayed == pytest.approx(5.0 / 4, rel=0.01)


def test_registry_counter_regression_is_a_restart():
    def run(ns):
        now = [0.0]
        reg = ns.telemetry.ClusterTelemetry(halflife=10.0,
                                            clock=lambda: now[0])
        reg.ingest("n1", _snap(ns, read_ops=1000))
        before = reg.node_volumes("n1")[1]["read_ops_per_second"]
        now[0] += 10.0
        reg.ingest("n1", _snap(ns, read_ops=30))
        return before, reg.node_volumes("n1")[1]
    before, row = _both(run)
    assert row["read_ops"] == 30
    assert 0.0 <= row["read_ops_per_second"] < before


def test_registry_volume_cache_warmth_aggregates_nodes():
    def run(ns):
        reg = ns.telemetry.ClusterTelemetry(clock=lambda: 1000.0)
        s1 = ns.pb.TelemetrySnapshot(window_ns=1_000_000_000)
        s1.volumes.add(volume_id=1, cache_hits=90, cache_misses=10)
        s1.volumes.add(volume_id=2, cache_hits=0, cache_misses=50)
        s2 = ns.pb.TelemetrySnapshot(window_ns=1_000_000_000)
        s2.volumes.add(volume_id=1, cache_hits=10, cache_misses=90)
        reg.ingest("n1", s1)
        reg.ingest("n2", s2)
        w = reg.volume_cache_warmth()
        s3 = ns.pb.TelemetrySnapshot(window_ns=1_000_000_000)
        s3.volumes.add(volume_id=3)
        reg.ingest("n1", s3)
        return w, reg.volume_cache_warmth()[3]
    w, w3 = _both(run)
    assert w[1] == pytest.approx(0.5) and w[2] == pytest.approx(0.0)
    assert w3 == 0.0


def test_registry_windows_prune_and_forget():
    def run(ns):
        now = [0.0]
        reg = ns.telemetry.ClusterTelemetry(halflife=10.0, window=30.0,
                                            clock=lambda: now[0])
        reg.ingest("n1", _snap(ns, read_ops=10, lat=[0.010] * 20))
        p50 = reg.node_quantile("n1", 0.5)
        now[0] += 31.0  # past the digest window
        reg.ingest("n1", _snap(ns, read_ops=10))
        pruned = reg.node_quantile("n1", 0.5)
        reg.forget("n1")
        return p50, pruned, reg.node_volumes("n1"), \
            reg.node_quantile("n1", 0.5)
    p50, pruned, vols, gone = _both(run)
    assert p50 == pytest.approx(0.010, rel=0.1)
    assert pruned is None and vols == {} and gone is None


def test_health_scoring_and_verdicts():
    def run(ns):
        now = [100.0]
        reg = ns.telemetry.ClusterTelemetry(halflife=60.0,
                                            clock=lambda: now[0])
        out = []
        reg.ingest("good", _snap(ns, read_ops=100, lat=[0.002] * 30))
        out.append(reg.health("good", last_seen=now[0],
                              pulse_seconds=5.0))
        out.append(reg.health("good", last_seen=now[0] - 60.0,
                              pulse_seconds=5.0))
        now[0] += 5.0
        reg.ingest("bad", _snap(ns, read_ops=100, errors=50))
        out.append(reg.health("bad", last_seen=now[0],
                              pulse_seconds=5.0))
        now[0] += 5.0
        reg.ingest("slow", _snap(ns, read_ops=100, lat=[0.200] * 30))
        for extra in ("a", "b"):
            reg.ingest(extra, _snap(ns, read_ops=10, lat=[0.002] * 30))
        out.append(reg.health("slow", last_seen=now[0],
                              pulse_seconds=5.0))
        return out
    good, stale, bad, slow = _both(run)
    assert good["verdict"] == "healthy" and good["score"] >= 95
    assert stale["verdict"] == "unhealthy" and stale["score"] == 0
    assert any("heartbeat" in r for r in stale["reasons"])
    assert bad["score"] < 80
    assert any("error rate" in r for r in bad["reasons"])
    assert any("cluster median" in r for r in slow["reasons"])
    assert slow["score"] < 80


def test_registry_to_map_and_gauges():
    def run(ns):
        reg = ns.telemetry.ClusterTelemetry(halflife=10.0,
                                            clock=lambda: 0.0)
        m = ns.Metrics(namespace="master")
        reg.ingest("n1", _snap(ns, read_ops=50, lat=[0.003] * 40),
                   metrics=m)
        doc = reg.to_map(nodes_last_seen={"n1": 0.0}, pulse_seconds=5.0)
        capped = reg.to_map(nodes_last_seen={"n1": 0.0},
                            pulse_seconds=5.0, limit=1)
        return json.dumps(doc, sort_keys=True), \
            json.dumps(capped, sort_keys=True), m.render()
    doc, capped, text = _both(run)
    doc = json.loads(doc)
    assert doc["nodes"]["n1"]["health"]["verdict"] == "healthy"
    assert doc["volumes"]["1"]["n1"]["read_ops"] == 50
    assert "read_p99_seconds" in doc["nodes"]["n1"]
    assert json.loads(capped)["volumes_total"] == 1
    assert 'telemetry_volume_read_ops_per_second{node="n1",volume="1"}' \
        in text
    assert 'telemetry_node_read_p99_seconds{node="n1"}' in text


# ------------- chunk-cache per-volume counters -------------

def test_chunk_cache_per_volume_counts_and_cardinality_cap():
    def run(ns):
        kv = ns.cache.key_volume
        keys = [kv("chunk:127.0.0.1:9333:3,01637037d6"),
                kv("ec:7:3,01637037d6"), kv("5,01637037d6"),
                kv("dav:/x/y:deadbeef")]
        cache = ns.cache.ChunkCache(capacity_bytes=1 << 20,
                                    metrics=ns.Metrics(namespace="cc"))
        cache.put("chunk:m:3,01abc", b"x" * 100, volume=3)
        hit = cache.get("chunk:m:3,01abc") == b"x" * 100
        miss = cache.get("chunk:m:4,02def") is None
        first = cache.per_volume_counts()
        cap = cache._vol_label_cap
        for vid in range(10, 10 + cap + 50):
            cache.get(f"chunk:m:{vid},01")
        counts = cache.per_volume_counts()
        return keys, hit, miss, first, counts, cap, \
            len(cache._vol_counters)
    keys, hit, miss, first, counts, cap, n_counters = _both(run)
    assert keys == [3, 7, 5, None]
    assert hit and miss
    assert first[3]["hits"] == 1 and first[4]["misses"] == 1
    assert len(counts) <= cap and n_counters <= 3 * cap


def test_chunk_cache_metrics_render_volume_labels():
    def run(ns):
        cache = ns.cache.ChunkCache(capacity_bytes=1 << 20,
                                    metrics=ns.Metrics(namespace="cc2"))
        cache.put("chunk:m:9,01abc", b"y" * 64, volume=9)
        cache.get("chunk:m:9,01abc")
        return cache.metrics.render()
    assert 'volume="9"' in _both(run)


# ------------- /debug/vars payload -------------

def test_varz_payload_shape():
    docs = {}
    for pkg, ns in P.items():
        m = ns.Metrics(namespace="t")
        m.counter("x_total").inc()
        docs[pkg] = ns.varz.payload("tester", m, extra={"answer": 42})
        json.dumps(docs[pkg])
    doc = docs["port"]
    for key in ("component", "pid", "start_time", "uptime_seconds",
                "python_version", "threads", "gc_counts",
                "slow_requests"):
        assert key in doc, key
    assert doc["component"] == "tester" and doc["answer"] == 42
    assert doc["metric_series"] == docs["jax"]["metric_series"] >= 1
    # the JAX page's sections, and the durability section beside them
    assert set(doc) == set(docs["jax"]) | {"durability"}


def test_varz_includes_slow_requests_from_tracing():
    def run(ns):
        ns.tracing.reset()
        ns.tracing.configure(enabled=True, slow_threshold_seconds=0.0)
        try:
            with ns.tracing.start_trace("tele-slow-op"):
                pass
            doc = ns.varz.payload("tester")
            names = [r["name"] for r in doc["slow_requests"]]
            row = doc["slow_requests"][names.index("tele-slow-op")]
            return sorted(row), row["duration_seconds"] >= 0.0, \
                bool(row["trace_id"])
        finally:
            ns.tracing.reset()
            ns.tracing.configure(enabled=True, slow_threshold_seconds=1.0)
    keys, nonneg, has_id = _both(run)
    assert nonneg and has_id and "trace_id" in keys


# ------------- SloEngine (JAX test_observability_cluster.py:269-348) ----

class _FakeTelemetry:
    """Scriptable stand-in for ClusterTelemetry: each evaluation tick
    pops the next (counters, read_digest) frame."""

    def __init__(self, ns):
        self.ns = ns
        self.frames = []

    def push_frame(self, ops, errors, latencies):
        d = None
        if latencies:
            d = self.ns.Digest()
            for v in latencies:
                d.add(v)
        self.frames.append(({"ops": ops, "errors": errors}, d))
        return self

    def cluster_counters(self):
        return dict(self.frames[0][0]) if len(self.frames) == 1 \
            else dict(self.frames.pop(0)[0])

    def digests_since(self, ts, read=True):
        if not read:
            return None
        return self.frames[0][1] if len(self.frames) == 1 else None


def _engine(ns, tele):
    now = [0.0]
    eng = ns.telemetry.SloEngine(tele, clock=lambda: now[0])
    eng.configure({"slo": {
        "enabled": True, "read_p99_ms": 100.0, "availability": 0.999,
        "evaluation_interval_seconds": 0.05}})
    return eng, now


def test_slo_engine_pages_on_fast_burn_and_exports_gauges():
    def run(ns):
        tele = _FakeTelemetry(ns)
        tele.push_frame(0, 0, None)
        tele.push_frame(1000, 50, [0.4] * 64)
        eng, now = _engine(ns, tele)
        eng.evaluate()
        now[0] += 1.0
        doc = eng.evaluate()
        return doc, eng.worst_state(), eng.metrics.render()
    doc, worst, text = _both(run)
    read = doc["objectives"]["read_p99_ms"]
    assert read["state"] == "page"
    assert read["burn_rates"]["5m"] > 14.4
    assert read["burn_rates"]["1h"] > 14.4
    avail = doc["objectives"]["availability"]
    assert avail["state"] == "page"
    assert 40 < avail["burn_rates"]["5m"] < 60
    assert worst == "page"
    assert [a for a in doc["alerts"] if a["to"] == "page"]
    fams = parse_exposition(text)
    vals = [v for labels, v in fams["seaweed_slo_burn_rate"]
            if labels == {"slo": "read_p99_ms", "window": "5m"}]
    assert vals and vals[0] > 14.4


def test_slo_engine_recovers_to_ok_as_windows_drain():
    def run(ns):
        tele = _FakeTelemetry(ns)
        tele.push_frame(0, 0, None)
        tele.push_frame(1000, 0, [0.4] * 64)
        eng, now = _engine(ns, tele)
        eng.fast_window = 10.0
        eng.fast_long_window = 20.0
        eng.slow_window = 40.0
        eng.evaluate()
        now[0] += 1.0
        paged = eng.evaluate()["objectives"]["read_p99_ms"]["state"]
        for _ in range(6):
            now[0] += 10.0
            tele.push_frame(2000, 0, [0.001] * 64)
            doc = eng.evaluate()
        return paged, doc
    paged, doc = _both(run)
    assert paged == "page"
    assert doc["objectives"]["read_p99_ms"]["state"] == "ok"
    transitions = [(a["from"], a["to"]) for a in doc["alerts"]
                   if a["slo"] == "read_p99_ms"]
    assert ("ok", "page") in transitions
    assert transitions[-1][1] == "ok"


def test_slo_engine_disabled_and_validation():
    def run(ns):
        eng = ns.telemetry.SloEngine(_FakeTelemetry(ns), clock=lambda: 0.0)
        doc = eng.evaluate()
        with pytest.raises(ValueError):
            eng.configure({"slo": {"enabled": True, "availability": 1.2}})
        return doc
    doc = _both(run)
    assert doc["enabled"] is False and doc["objectives"] == {}
