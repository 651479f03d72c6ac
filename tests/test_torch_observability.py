"""The port's observability plane on the CPU, against the JAX package's:
the profiler (``util/profiler.py``), ``/debug/vars`` (``util/varz.py``),
the master's trace collector and the stitched traces of live clusters.

Mirrors the tracing and profiler cases of
``tests/test_observability_cluster.py`` (its SLO and ``Digest.cdf``
cases are in ``tests/test_torch_telemetry.py``; the SLO half of its
end-to-end case is here), the two varz cases of ``tests/test_telemetry.py`` and the trace
checks of ``tests/test_cluster_integration.py``. Beyond them:

* one ``TraceCollector`` per package fed the same pushed bundles gives
  equal ``/cluster/traces`` documents;
* mixed clusters — a JAX filer over a port master and port volume
  servers, a port filer over a JAX cluster — stitch one degraded GET
  into one trace at the master, with the span names of the same request
  on an all-JAX stack and every child inside its parent;
* the cluster ``trace.*`` / ``ingress.status`` and offline ``trace.*``
  commands print the same masked lines through both shells;
* the pipeline's stage series, the module-name guard of ``varz`` and
  ``glog``, and the ``[tracing]``, ``[profiler]``, ``[telemetry]``,
  ``[usage]`` and ``[slo]`` sections.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from conftest import parse_exposition

from seaweedfs_tpu import cache as jax_cache
from seaweedfs_tpu.cluster import filer_server as jax_filer_server
from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.shell import cluster_commands as jax_cluster_commands
from seaweedfs_tpu.shell import commands as jax_commands
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.util import glog as jax_glog
from seaweedfs_tpu.util import stats as jax_stats
from seaweedfs_tpu.util import tracing as jax_tracing
from seaweedfs_tpu_torch import cache
from seaweedfs_tpu_torch.cluster import filer_server, master, volume_server
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.pipeline import encode, pipe
from seaweedfs_tpu_torch.shell import cluster_commands, commands
from seaweedfs_tpu_torch.storage import store
from seaweedfs_tpu_torch.storage import volume as volume_mod
from seaweedfs_tpu_torch.util import faults, glog, profiler, retry, stats, \
    tracing, varz

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
REPO = Path(__file__).resolve().parent.parent
PKG = {
    "port": {"master": master, "vs": volume_server, "store": store,
             "filer_server": filer_server, "filer": Filer,
             "cluster_commands": cluster_commands, "commands": commands,
             "tracing": tracing, "cache": cache},
    "jax": {"master": jax_master, "vs": jax_volume_server,
            "store": jax_store, "filer_server": jax_filer_server,
            "filer": JaxFiler, "cluster_commands": jax_cluster_commands,
            "commands": jax_commands, "tracing": jax_tracing,
            "cache": jax_cache},
}


@pytest.fixture(autouse=True)
def _observability_hygiene():
    """Push config, faults, and the profiler are process-global; tests
    here reconfigure them, so restore the defaults afterwards."""
    saved = {k: getattr(retry.policy(), k)
             for k in ("base_delay", "max_delay", "breaker_cooldown")}
    retry.configure(base_delay=0.01, max_delay=0.1,
                    breaker_cooldown=0.5)
    faults.clear()
    retry.reset_breakers()
    yield
    for mod in (tracing, jax_tracing):
        mod.configure_push(None)
        mod._PUSH_THRESHOLD = None
        mod.configure(enabled=True, ring_size=256,
                      slow_threshold_seconds=1.0)
    profiler.configure(enabled=False)
    profiler.reset()
    faults.clear()
    retry.reset_breakers()
    retry.configure(**saved)


def _wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _get(url, timeout=15, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _get_json(url, timeout=15):
    return json.loads(_get(url, timeout))


def _put(url, data: bytes):
    req = urllib.request.Request(url, data=data, method="PUT")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status in (200, 201)


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------

def _busy(stop: threading.Event) -> None:
    while not stop.is_set():
        sum(i * i for i in range(500))


def test_profiler_burst_sees_running_thread():
    stop = threading.Event()
    t = threading.Thread(target=_busy, args=(stop,), name="prof-busy")
    t.start()
    try:
        text = profiler.profile(seconds=0.3, hz=97)
    finally:
        stop.set()
        t.join()
    assert text, "burst capture returned no stacks"
    lines = text.strip().splitlines()
    # collapsed format: "frame;frame;... count"
    for line in lines:
        stack, count = line.rsplit(" ", 1)
        assert int(count) >= 1
        assert ":" in stack
    assert any("_busy" in ln for ln in lines), lines[:5]
    assert profiler.MAX_HZ == 250.0 and profiler.MAX_SECONDS == 60.0
    assert profiler.DEFAULT_BURST_HZ == 97.0


def test_profiler_always_on_aggregates_hot_stacks():
    profiler.reset()
    profiler.configure(enabled=True, hz=200.0, top_k=3)
    try:
        stop = threading.Event()
        t = threading.Thread(target=_busy, args=(stop,))
        t.start()
        deadline = time.time() + 5
        while time.time() < deadline and not profiler.hot_stacks():
            time.sleep(0.05)
        stop.set()
        t.join()
        hot = profiler.hot_stacks()
        assert hot, "always-on sampler collected nothing"
        assert len(hot) <= 3
        stack, count = hot[0]
        assert count >= 1 and ";" in stack or ":" in stack
        payload = profiler.debug_payload()
        assert payload["enabled"] and payload["samples"] >= 1
    finally:
        profiler.configure(enabled=False)
    assert profiler.debug_payload()["running"] is False


def test_profiler_burst_clamps_rate_and_duration():
    t0 = time.monotonic()
    profiler.profile(seconds=0.05, hz=10_000)
    assert time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# exemplars
# ---------------------------------------------------------------------------

def _exemplar_text(mod) -> str:
    m = mod.Metrics(namespace="ex")
    m.histogram("request_stage_seconds", stage="read").observe(
        0.004, exemplar="cafecafecafecafe")
    m.histogram("request_stage_seconds", stage="read").observe(0.002)
    return m.render()


def test_histogram_exemplars_render_and_stay_parseable():
    text = _exemplar_text(stats)
    fams = parse_exposition(text)  # raises on malformed lines
    assert any(k.startswith("ex_request_stage_seconds") for k in fams)
    ex_lines = [ln for ln in text.splitlines()
                if ln.startswith("# EXEMPLAR ")]
    assert ex_lines, text
    assert any('trace_id="cafecafecafecafe"' in ln for ln in ex_lines)
    # the JAX package's text, but for the exemplars' wall-clock stamps
    stamp = re.compile(r" ts=\d+(\.\d+)?$")
    assert [stamp.sub("", ln) for ln in text.splitlines()] == \
        [stamp.sub("", ln) for ln in _exemplar_text(jax_stats).splitlines()]


# ---------------------------------------------------------------------------
# TraceCollector
# ---------------------------------------------------------------------------

def _bundle(trace_id, name, dur, *, span_ids, status="ok",
            remote_parent="", start=1000.0):
    return {"trace_id": trace_id, "name": name, "start": start,
            "duration_seconds": dur, "status": status,
            "remote_parent": remote_parent,
            "spans": [{"span_id": s, "name": f"{name}/{s}",
                       "duration_seconds": dur / len(span_ids)}
                      for s in span_ids]}


def test_collector_stitches_cross_process_bundles():
    c = tracing.TraceCollector(ring_size=8)
    c.ingest({"node": "127.0.0.1:81", "component": "volume",
              "reason": "slow",
              "bundle": _bundle("t1", "volume.GET", 0.4,
                                span_ids=["v1"],
                                remote_parent="abc")})
    c.ingest({"node": "127.0.0.1:88", "component": "filer",
              "reason": "slow",
              "bundle": _bundle("t1", "filer.GET", 0.5,
                                span_ids=["f1", "f2"])})
    traces = c.traces()
    assert len(traces) == 1
    t = traces[0]
    assert t["span_count"] == 3
    assert t["has_root"] is True
    # the true root (no remote parent) names the trace end to end
    assert t["name"] == "filer.GET"
    assert t["duration_seconds"] == 0.5
    assert set(t["sources"]) == {"volume@127.0.0.1:81",
                                 "filer@127.0.0.1:88"}


def test_collector_dedups_redelivered_spans():
    c = tracing.TraceCollector()
    payload = {"node": "n", "component": "volume", "reason": "error",
               "bundle": _bundle("t2", "volume.GET", 0.1,
                                 span_ids=["a", "b"], status="error")}
    c.ingest(payload)
    c.ingest(json.loads(json.dumps(payload)))  # retry re-delivery
    t = c.traces()[0]
    assert t["span_count"] == 2
    assert t["status"] == "error"
    assert c.ingested == 2


def test_collector_bounds_ring_and_rejects_garbage():
    c = tracing.TraceCollector(ring_size=3)
    for i in range(5):
        c.ingest({"node": "n", "component": "volume", "reason": "slow",
                  "bundle": _bundle(f"t{i}", "volume.GET", 0.1 * (i + 1),
                                    span_ids=[f"s{i}"])})
    assert len(c.traces()) == 3
    assert {t["trace_id"] for t in c.traces()} == {"t2", "t3", "t4"}
    c.ingest({"bundle": {"spans": []}})      # no trace id
    c.ingest({})                             # no bundle
    assert c.rejected == 2


def test_collector_top_ranks_errors_then_duration():
    c = tracing.TraceCollector()
    c.ingest({"node": "n", "component": "f", "reason": "slow",
              "bundle": _bundle("slowest", "a", 9.0, span_ids=["1"])})
    c.ingest({"node": "n", "component": "f", "reason": "error",
              "bundle": _bundle("errored", "b", 0.2, span_ids=["2"],
                                status="error")})
    c.ingest({"node": "n", "component": "f", "reason": "slow",
              "bundle": _bundle("slower", "c", 1.0, span_ids=["3"])})
    order = [t["trace_id"] for t in c.top()]
    assert order == ["errored", "slowest", "slower"]
    assert all("stages" in t for t in c.top())


def _seeded_payloads(seed: int, n: int) -> list[dict]:
    """Pushed bundles of a few cross-process traces: roots and remote
    legs, statuses, re-deliveries, garbage and more traces than the
    ring holds."""
    rng = np.random.default_rng(seed)
    out = []
    comps = [("filer", "127.0.0.1:8888"), ("volume", "127.0.0.1:8080"),
             ("volume", "127.0.0.1:8081"), ("master", "127.0.0.1:9333")]
    for i in range(n):
        tid = f"{int(rng.integers(0, 1 << 62)):016x}"
        legs = int(rng.integers(1, 4))
        for leg in range(legs):
            comp, node = comps[int(rng.integers(0, len(comps)))]
            sids = [f"{int(rng.integers(0, 1 << 62)):016x}"
                    for _ in range(int(rng.integers(1, 5)))]
            status = "ok" if rng.random() < 0.8 else "error:Timeout"
            b = _bundle(tid, f"{comp}.GET", float(rng.random()),
                        span_ids=sids, status=status,
                        remote_parent="" if leg == 0 else "p",
                        start=1000.0 + i + leg * 0.01)
            p = {"node": node, "component": comp,
                 "reason": "slow" if status == "ok" else "error",
                 "bundle": b}
            out.append(p)
            if rng.random() < 0.2:
                out.append(json.loads(json.dumps(p)))
        if rng.random() < 0.1:
            out.append({"bundle": {"spans": []}})
    return out


def test_collectors_of_both_packages_agree_on_the_same_bundles():
    """The bundles are data: the port's collector and the JAX package's
    give the same ``/cluster/traces`` document and the same ``top``,
    nothing masked."""
    payloads = _seeded_payloads(11, 40)
    cols = {"port": tracing.TraceCollector(ring_size=16),
            "jax": jax_tracing.TraceCollector(ring_size=16)}
    for p in payloads:
        for c in cols.values():
            c.ingest(json.loads(json.dumps(p)))
    assert cols["port"].payload() == cols["jax"].payload()
    assert cols["port"].payload(5) == cols["jax"].payload(5)
    assert cols["port"].top(7) == cols["jax"].top(7)
    assert cols["port"].payload()["count"] == 16


# ---------------------------------------------------------------------------
# glog <-> tracing correlation, tail-sample pushing
# ---------------------------------------------------------------------------

def test_glog_lines_carry_trace_ids_inside_spans():
    import logging
    messages = []
    h = logging.Handler()
    h.emit = lambda r: messages.append(r.getMessage())
    glog._logger.addHandler(h)
    try:
        with tracing.start_trace("glogtest") as sp:
            glog.info("inside the span")
            want = f"trace={sp.trace_id} span={sp.span_id}"
        glog.info("outside any span")
    finally:
        glog._logger.removeHandler(h)
    assert messages[0] == f"inside the span {want.strip()}" \
        or want in messages[0], messages
    assert messages[1] == "outside any span"


def test_slow_roots_push_to_configured_sink():
    got = []
    tracing.configure_push(got.append, node="here", component="test",
                           threshold_seconds=0.05)
    with tracing.start_trace("push.slow"):
        time.sleep(0.08)
    with tracing.start_trace("push.fast"):
        pass
    deadline = time.time() + 5
    while time.time() < deadline and not got:
        time.sleep(0.01)
    assert len(got) == 1, got
    p = got[0]
    assert p["reason"] == "slow" and p["component"] == "test"
    assert p["bundle"]["name"] == "push.slow"
    assert tracing.push_stats()["pushed"] >= 1


# ---------------------------------------------------------------------------
# the module-name guard
# ---------------------------------------------------------------------------

def test_varz_reads_only_the_ports_pipeline(monkeypatch):
    """In a process that holds both packages, the port's ``/debug/vars``
    reports the port's pipeline, never the JAX package's: with only the
    JAX ``pipeline.pipe`` loaded, the section is empty."""
    from seaweedfs_tpu.pipeline import pipe as jax_pipe
    jax_pipe.publish_stats(jax_pipe.PipeStats(batches=3), kind="guard")
    assert jax_pipe.debug_payload()["runs"] >= 1
    assert varz.payload("guard")["pipeline"] == pipe.debug_payload()
    for name in ("seaweedfs_tpu_torch.pipeline.pipe",
                 "seaweedfs_tpu_torch.pipeline.flight",
                 "seaweedfs_tpu_torch.parallel.mesh"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    doc = varz.payload("guard")
    assert doc["pipeline"] == {} and doc["flight"] == {} \
        and doc["mesh"] == {}


def test_glog_suffix_ignores_a_jax_span():
    """The port's log lines name the port's spans only: inside a span
    the JAX package opened, the port's suffix is empty, while the JAX
    package's own suffix names that span."""
    with jax_tracing.start_trace("jax.only") as jsp:
        assert jax_glog._trace_suffix() == \
            f" trace={jsp.trace_id} span={jsp.span_id}"
        assert glog._trace_suffix() == ""
    with tracing.start_trace("port.only") as sp:
        assert glog._trace_suffix() == \
            f" trace={sp.trace_id} span={sp.span_id}"
        assert jax_glog._trace_suffix() == ""


# ---------------------------------------------------------------------------
# /debug/vars
# ---------------------------------------------------------------------------

def test_varz_payload_shape():
    m = stats.Metrics(namespace="t")
    m.counter("x_total").inc()
    doc = varz.payload("tester", m, extra={"answer": 42})
    for key in ("component", "pid", "start_time", "uptime_seconds",
                "python_version", "threads", "gc_counts",
                "slow_requests"):
        assert key in doc, key
    assert doc["component"] == "tester"
    assert doc["answer"] == 42
    assert doc["metric_series"] >= 1
    json.dumps(doc)  # must be JSON-able as served
    from seaweedfs_tpu.util import varz as jax_varz
    jdoc = jax_varz.payload("tester", jax_stats.Metrics(namespace="t"))
    # the JAX page's sections, and the durability section beside them
    assert set(doc) - {"answer"} == set(jdoc) | {"durability"}
    assert doc["durability"]["mode"] in ("commit", "batch", "off")
    assert doc["profiler"].keys() == jdoc["profiler"].keys()
    assert doc["trace_push"].keys() == jdoc["trace_push"].keys()


def test_varz_includes_slow_requests_from_tracing():
    tracing.reset()
    tracing.configure(enabled=True, slow_threshold_seconds=0.0)
    try:
        with tracing.start_trace("tele-slow-op"):
            pass
        doc = varz.payload("tester")
        names = [r["name"] for r in doc["slow_requests"]]
        assert "tele-slow-op" in names
        row = doc["slow_requests"][names.index("tele-slow-op")]
        assert row["duration_seconds"] >= 0.0
        assert row["trace_id"]
    finally:
        tracing.reset()
        tracing.configure(enabled=True, slow_threshold_seconds=1.0)


# ---------------------------------------------------------------------------
# the stage series
# ---------------------------------------------------------------------------

def _stage_counts() -> dict:
    return {s: tracing.METRICS.histogram("request_stage_seconds",
                                         stage=s).n
            for s in ("pipe.read", "pipe.compute", "pipe.write")}


@pytest.mark.parametrize("overlapped", [True, False])
def test_stage_series_count_the_encode_batches(tmp_path, monkeypatch,
                                               overlapped):
    """One port ``encode_volume`` on the CPU observes each stage series
    once per batch of its run, and runs under one ``ec.encode`` span
    carrying the .dat size."""
    from seaweedfs_tpu_torch.ops import rs_torch
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 0)
    base = tmp_path / "v"
    volume_mod.write_synthetic_volume(base, 3 * 1024 * 1024 + 7,
                                      avg_size=4096, seed=3)
    before = _stage_counts()
    st = pipe.PipeStats()
    with tracing.start_trace("unit.seal"):
        encode.encode_volume(base, max_batch_bytes=10 * 64 * 1024,
                             device="cpu", stats=st,
                             overlapped=overlapped)
    after = _stage_counts()
    assert st.batches >= 4
    assert {s: after[s] - before[s] for s in after} == \
        dict.fromkeys(after, st.batches)
    t = tracing.recent_traces()[-1]
    sp, = [s for s in t["spans"] if s["name"] == "ec.encode"]
    assert sp["bytes"] == os.path.getsize(f"{base}.dat")
    assert sp["duration_seconds"] >= st.compute_seconds


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

_ACCEPTED = ("[tracing]\nslow_threshold_seconds = 2.5\n"
             "push_threshold_seconds = 0.5\n\n"
             "[profiler]\nenabled = false\nhz = 3.0\n")


def test_servers_accept_tracing_and_profiler_and_refuse_the_rest():
    """``[tracing]`` and ``[profiler]`` apply on the master, the volume
    server and the filer; so do ``[telemetry]``, ``[usage]`` and
    ``[slo]`` where the JAX server reads them, each module's flags
    ending equal to the JAX module's for the same sections; what is
    refused now is a bad value, such as an out-of-range ``[slo]``
    availability on the master."""
    from seaweedfs_tpu.cluster import telemetry as jax_telemetry
    from seaweedfs_tpu.cluster import usage as jax_usage
    from seaweedfs_tpu_torch.cluster import telemetry, usage
    from seaweedfs_tpu_torch.util import config as config_mod
    conf = config_mod._parse_toml_subset(
        _ACCEPTED + "\n[telemetry]\nenabled = false\n\n[usage]\n"
        "enabled = false\npush_interval_seconds = 0.25\n\n[slo]\n"
        "enabled = true\nwrite_p99_ms = 40.0\n")
    readers = {master.apply_config: (usage,),
               volume_server.apply_config: (telemetry, usage),
               filer_server.apply_config: (usage,)}
    try:
        for apply, mods in readers.items():
            tracing.configure(slow_threshold_seconds=1.0)
            tracing._PUSH_THRESHOLD = None
            profiler.configure(hz=1.0)
            for mod in (telemetry, usage):
                mod.configure(enabled=True)
            apply(conf)
            assert tracing.slow_threshold() == 2.5
            assert tracing.push_threshold() == 0.5
            assert profiler.debug_payload()["hz"] == 3.0
            assert not profiler.enabled()
            for mod in mods:
                assert not mod.enabled()
            if usage in mods:
                assert usage.push_interval() == 0.25
        volume_server.apply_config(conf)
        jax_telemetry.configure_from(conf)
        jax_usage.configure_from(conf)
        assert (telemetry.enabled(), usage.enabled(),
                usage.push_interval()) == (jax_telemetry.enabled(),
                                           jax_usage.enabled(),
                                           jax_usage.push_interval())
        with pytest.raises(ValueError, match="availability must be in"):
            master.apply_config({"slo": {"availability": 1.5}})
    finally:
        for mod in (telemetry, usage, jax_telemetry, jax_usage):
            mod.configure(enabled=True)
        for mod in (usage, jax_usage):
            mod.configure(push_interval_seconds=mod.PUSH_INTERVAL)


def test_gateway_toml_applies_tracing_and_profiler(tmp_path):
    """``python -m seaweedfs_tpu_torch s3 -toml`` applies ``[tracing]``
    and ``[profiler]``, as ``/debug/vars`` shows: the always-on sampler
    runs at the file's rate, and with a slow threshold of 0 a request
    (a fast failure: no filer listens, one attempt) lands in the slow
    ring under its ``s3.GET`` root. SIGTERM stops it."""
    toml = tmp_path / "s3.toml"
    toml.write_text("[tracing]\nslow_threshold_seconds = 0.0\n\n"
                    "[profiler]\nenabled = true\nhz = 5.0\n\n"
                    "[retry]\nmax_attempts = 1\n")
    port = _free_port_pair()
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "s3", "-port",
         str(port), "-filer", "127.0.0.1:1", "-toml", str(toml)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        url = f"http://127.0.0.1:{port}"

        def up():
            try:
                return _get_json(url + "/debug/vars", timeout=2)
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                return None
        vz = _wait_for(up, timeout=60, what="s3 subprocess")
        assert vz["component"] == "s3"
        assert vz["profiler"]["hz"] == 5.0
        assert vz["profiler"]["enabled"] and vz["profiler"]["running"]
        with pytest.raises(urllib.error.HTTPError):
            _get(url + "/bkt")
        # the root closes after its response is written (and after the
        # request's usage row), so the ring may take it a moment later
        _wait_for(lambda: _get_json(url + "/debug/vars")["slow_requests"],
                  timeout=10, what="the s3.GET root in the slow ring")
        slow = _get_json(url + "/debug/vars")["slow_requests"]
        assert [r["name"] for r in slow] == ["s3.GET"]
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0, proc.stderr.read()


# ---------------------------------------------------------------------------
# a port cluster: the JAX integration checks and the end-to-end case
# ---------------------------------------------------------------------------

def _stack(tmp_path, cluster_pkg: str, filer_pkg: str, n_servers=2):
    C, F = PKG[cluster_pkg], PKG[filer_pkg]
    ms = C["master"].MasterServer(port=_free_port_pair(),
                                  volume_size_limit_mb=64,
                                  pulse_seconds=PULSE, seed=7).start()
    servers = []
    for i in range(n_servers):
        d = tmp_path / f"{cluster_pkg}{i}"
        d.mkdir()
        kw = dict(device="cpu") if cluster_pkg == "port" else {}
        servers.append(C["vs"].VolumeServer(
            C["store"].Store([d], max_volumes=8), port=_free_port_pair(),
            master_url=ms.url, pulse_seconds=PULSE, **kw).start())
    _wait_for(lambda: len(ms.topology.nodes) == n_servers,
              what="volume server registration")
    filer = F["filer_server"].FilerServer(
        F["filer"](), port=_free_port_pair(), master_url=ms.url).start()
    return ms, servers, filer


def _stop(ms, servers, filer):
    filer.stop()
    for vs in servers:
        vs.stop()
    ms.stop()


def test_metrics_and_debug_traces_endpoints(tmp_path):
    """Every port server's ``/metrics`` parses and carries the tracing
    family; each serves its trace ring and ``/debug/vars``."""
    ms, servers, filer = _stack(tmp_path, "port", "port", n_servers=1)
    try:
        _put(f"http://{filer.url}/m/x.bin", b"x" * 100)
        for url in (ms.url, servers[0].url, filer.url):
            with urllib.request.urlopen(f"http://{url}/metrics") as r:
                assert r.headers["Content-Type"] == \
                    stats.EXPOSITION_CONTENT_TYPE
                fams = parse_exposition(r.read().decode())
            assert "trace_request_stage_seconds_count" in fams, url
            doc = _get_json(f"http://{url}/debug/traces?limit=1")
            assert doc["enabled"] is True and "traces" in doc
            assert len(doc["traces"]) <= 1
        vz = _get_json(f"http://{ms.url}/debug/vars")
        assert vz["component"] == "master" and vz["is_leader"]
        assert vz["nodes"] == 1 and "trace_collector" in vz
        assert "cache_hub" in vz and "jobs" in vz
        vz = _get_json(f"http://{servers[0].url}/debug/vars")
        assert vz["component"] == "volume"
        assert "cache" in vz and "ingress" in vz
        assert vz["ingress"]["servers"], vz["ingress"]
    finally:
        _stop(ms, servers, filer)


def test_trace_propagation_filer_volume_read(tmp_path):
    """One filer GET leaves a single trace whose spans cover the filer
    ingress, the master lookup and the volume read, all stitched to the
    caller's ``X-Seaweed-Trace`` context."""
    ms, servers, filer = _stack(tmp_path, "port", "port", n_servers=1)
    try:
        body = b"traced-bytes" * 100
        _put(f"http://{filer.url}/t/traced.bin", body)
        filer.filer.chunk_cache.clear()
        tracing.reset()  # only the read below lands in the ring
        trace_id, caller_span = "feedfacefeedface", "1234abcd"
        assert _get(f"http://{filer.url}/t/traced.bin", headers={
            tracing.TRACE_HEADER: f"{trace_id}-{caller_span}"}) == body
        deadline = time.time() + 5
        pieces = []
        while time.time() < deadline:
            pieces = [t for t in tracing.recent_traces()
                      if t["trace_id"] == trace_id]
            if (any(t["name"] == "filer.GET" for t in pieces)
                    and any(t["name"].startswith("volume.")
                            for t in pieces)):
                break
            time.sleep(0.02)
        assert pieces, "no trace recorded for the supplied trace id"
        spans = [s for t in pieces for s in t["spans"]]
        names = {s["name"] for s in spans}
        assert len(spans) >= 4, names
        assert {"filer.GET", "filer.read_file", "volume.read",
                "store.read_needle"} <= names
        assert "master.lookup" in names or "grpc.LookupVolume" in names
        ingress = next(t for t in pieces if t["name"] == "filer.GET")
        assert ingress["remote_parent"] == caller_span
        filer_span_ids = {s["span_id"] for t in pieces
                          if t["name"].startswith("filer.")
                          for s in t["spans"]}
        remote = [t for t in pieces if t["name"].startswith("volume.")]
        assert remote and all(t["remote_parent"] in filer_span_ids
                              for t in remote)
    finally:
        _stop(ms, servers, filer)


def test_cluster_observability_end_to_end(tmp_path):
    """A latency fault on the volume read path, observed from the port
    master only: the slow trace stitched with the filer and volume legs,
    the read-latency SLO paging with its burn-rate gauge on ``/metrics``
    and ``cluster.check`` failing on it, and a burst profile of the
    faulted server through ``/cluster/profile`` while reads are in
    flight."""
    ms, servers, filer = _stack(tmp_path, "port", "port", n_servers=1)
    vol = servers[0]
    env = None
    try:
        tracing.configure_push(ms.url, node=vol.url, component="volume",
                               threshold_seconds=0.2)
        ms.slo.configure({"slo": {
            "enabled": True, "read_p99_ms": 100.0,
            "availability": 0.999,
            "evaluation_interval_seconds": 0.1}})
        base = f"http://{ms.url}"
        _put(f"http://{filer.url}/obs/blob.bin", b"x" * 4096)
        faults.inject("volume.read", "delay:0.35")
        for _ in range(4):
            filer.filer.chunk_cache.clear()
            assert _get(f"http://{filer.url}/obs/blob.bin") == b"x" * 4096

        # 1. the slow trace is stitched at the master with both the
        #    filer and volume legs
        def stitched():
            doc = _get_json(f"{base}/cluster/traces")
            for t in doc["traces"]:
                names = {s["name"] for s in t["spans"]}
                if {"filer.GET", "volume.GET"} <= names:
                    return t
            return None
        t = _wait_for(stitched, what="a stitched filer+volume trace")
        assert t["duration_seconds"] >= 0.3
        assert t["has_root"] and t["name"] == "filer.GET"
        assert "slow" in t["reasons"]

        # 2. the read-latency SLO pages and the burn-rate gauge rises on
        #    the master's /metrics; cluster.check counts it a problem
        def paging():
            slo = _get_json(f"{base}/cluster/slo")
            return slo if slo["objectives"]["read_p99_ms"]["state"] \
                == "page" else None
        slo = _wait_for(paging, what="the read SLO to page")
        assert slo["objectives"]["read_p99_ms"]["burn_rates"]["5m"] > 14.4
        fams = parse_exposition(_get(f"{base}/metrics").decode())
        vals = [v for labels, v in fams["seaweed_slo_burn_rate"]
                if labels == {"slo": "read_p99_ms", "window": "5m"}]
        assert vals and vals[0] > 14.4
        out = io.StringIO()
        env = cluster_commands.ClusterEnv(master_url=ms.url, out=out)
        with pytest.raises(commands.ShellError, match="problems found"):
            cluster_commands.run_cluster_command(env, "cluster.check")
        assert "slo read_p99_ms: page" in out.getvalue()

        # 3. profiling the faulted server from the master returns stacks
        #    while reads are in flight
        stop = threading.Event()

        def _load():
            while not stop.is_set():
                try:
                    filer.filer.chunk_cache.clear()
                    _get(f"http://{filer.url}/obs/blob.bin")
                except Exception:  # noqa: BLE001 — the load ends
                    return
        th = threading.Thread(target=_load)
        th.start()
        try:
            text = _get(f"{base}/cluster/profile"
                        f"?node={vol.url}&seconds=0.5").decode()
        finally:
            stop.set()
            th.join()
        lines = [ln for ln in text.strip().splitlines() if ln]
        assert lines, "profile proxy returned no stacks"
        stack, count = lines[0].rsplit(" ", 1)
        assert int(count) >= 1 and ":" in stack
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/cluster/profile")
        assert ei.value.code == 400

        vz = _get_json(f"{base}/debug/vars")
        assert vz["trace_collector"]["count"] >= 1
        assert vz["slo_state"] == "page"
        assert [a for a in vz["slo_alerts"] if a["to"] == "page"]
    finally:
        faults.clear()
        if env is not None:
            env.close()
        _stop(ms, servers, filer)


# ---------------------------------------------------------------------------
# mixed clusters: one degraded GET traced through both packages
# ---------------------------------------------------------------------------

#: A remote leg's root (an HTTP verb's or a gRPC method's span) is closed
#: by its server after the response is written, so its end may trail the
#: caller's span by the server thread's wait for the interpreter lock
#: (the switch interval is 5 ms; under a loaded host several of them).
#: Every other child is held to its parent exactly, up to the 1 us
#: rounding of the durations.
REMOTE_SLACK = 0.05
_REMOTE_ROOT = re.compile(r"^(grpc\.\w+|\w+\.(GET|PUT|POST|DELETE|HEAD))$")


def _children_inside_parents(trace: dict) -> list[str]:
    spans = {s["span_id"]: s for s in trace["spans"]}
    bad = []
    for s in trace["spans"]:
        p = spans.get(s["parent_id"])
        if p is None:
            continue
        end_slack = REMOTE_SLACK if _REMOTE_ROOT.match(s["name"]) \
            else 1e-5
        s_end = s["start"] + s["duration_seconds"]
        p_end = p["start"] + p["duration_seconds"]
        if s["start"] < p["start"] or s_end > p_end + end_slack:
            bad.append(f"{s['name']}@{s['node']} [{s['start']:.6f}, "
                       f"{s_end:.6f}] outside {p['name']}@{p['node']} "
                       f"[{p['start']:.6f}, {p_end:.6f}]")
    return bad


def _degraded_get_trace(tmp_path, cluster_pkg: str, filer_pkg: str):
    """A file PUT through the filer, its volume sealed over two servers
    by the cluster's own shell, shard 0 (which holds the file) lost
    everywhere, every cache cleared, then one GET through the filer.
    Returns the trace the master stitched for that GET."""
    C, F = PKG[cluster_pkg], PKG[filer_pkg]
    for mod in (tracing, jax_tracing):
        mod.configure(slow_threshold_seconds=60.0)
        mod.configure_from({"tracing": {"push_threshold_seconds": 0.0}})
    ms, servers, filer = _stack(tmp_path, cluster_pkg, filer_pkg)
    env = None
    try:
        vid = ms.grow_volume("obs")
        for vs in servers:
            vs.heartbeat_now()
        body = np.random.default_rng(5).bytes(96 * 1024)
        _put(f"http://{filer.url}/obs/blob.bin?collection=obs", body)
        env = C["cluster_commands"].ClusterEnv(master_url=ms.url,
                                               out=io.StringIO())
        C["cluster_commands"].run_cluster_command(
            env, f"ec.encode -volumeId {vid} -collection obs")
        for vs in servers:
            vs.heartbeat_now()
        assert all(vs.store.ec_mounts for vs in servers), \
            "ec.encode spreads the shards over both servers"
        from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
        for vs in servers:
            for (col, v), m in list(vs.store.ec_mounts.items()):
                if v == vid and 0 in m.shard_ids:
                    env.volume(vs.url).VolumeEcShardsDelete(
                        vpb.VolumeEcShardsDeleteRequest(
                            volume_id=vid, collection=col,
                            shard_ids=[0]))
        for vs in servers:
            vs.heartbeat_now()
        _wait_for(lambda: 0 not in ms.topology.lookup_ec_volume(vid),
                  what="shard 0 gone from the topology")
        time.sleep(1.1)      # the servers' shard-location caches expire
        F["cache"].global_chunk_cache().clear()
        filer.filer.chunk_cache.clear()
        for vs in servers:
            vs.chunk_cache.clear()
        assert _get(f"http://{filer.url}/obs/blob.bin") == body
        want = {"filer.GET", "volume.GET", "grpc.VolumeEcShardRead",
                "ec.reconstruct"}
        last = {"names": None, "t": None}

        def settled():
            doc = _get_json(f"http://{ms.url}/cluster/traces")
            for t in doc["traces"]:
                names = {s["name"] for s in t["spans"]}
                if t["name"] == "filer.GET" and t["has_root"] \
                        and want <= names:
                    key = (t["span_count"], tuple(sorted(names)))
                    if last["names"] == key and \
                            time.time() - last["t"] > 0.5:
                        return t
                    if last["names"] != key:
                        last["names"], last["t"] = key, time.time()
            return None
        return _wait_for(settled, what=f"the stitched degraded GET "
                         f"({filer_pkg} filer on {cluster_pkg} cluster)")
    finally:
        if env is not None:
            env.close()
        _stop(ms, servers, filer)


@pytest.fixture(scope="module")
def jax_degraded_names(tmp_path_factory):
    t = _degraded_get_trace(tmp_path_factory.mktemp("alljax"), "jax",
                            "jax")
    for mod in (tracing, jax_tracing):
        mod.configure_push(None)
        mod._PUSH_THRESHOLD = None
    return sorted({s["name"] for s in t["spans"]})


@pytest.mark.parametrize("cluster_pkg,filer_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_mixed_cluster_degraded_get_stitches_into_one_trace(
        tmp_path, jax_degraded_names, cluster_pkg, filer_pkg):
    t = _degraded_get_trace(tmp_path, cluster_pkg, filer_pkg)
    names = sorted({s["name"] for s in t["spans"]})
    assert names == jax_degraded_names
    # the master's lookup answers an EC volume with its shard holders,
    # so the read needs no fallback hop (no read.degraded): the repair
    # happens on the volume server, its peer reads under it
    assert {"filer.GET", "filer.read_file", "cache.get", "volume.read",
            "master.lookup", "volume.GET", "ec.reconstruct",
            "grpc.VolumeEcShardRead"} <= set(names)
    comps = {src.split("@")[0] for src in t["sources"]}
    assert {"filer", "volume"} <= comps
    # one trace id end to end, no span twice
    assert len({s["span_id"] for s in t["spans"]}) == t["span_count"]
    assert _children_inside_parents(t) == []


# ---------------------------------------------------------------------------
# the shells' trace commands
# ---------------------------------------------------------------------------

_MASK_ID = re.compile(r"\b[0-9a-f]{16}\b")
_MASK_FID = re.compile(r"(fid=|path=/)[0-9a-f]+,[0-9a-f]+")
_MASK_NUM = re.compile(r"\d+(\.\d+)?")


def _masked(text: str) -> list[str]:
    """Ids (trace, span and file ids), addresses, times and counts out:
    the lines' shape, roles, names, statuses and reasons stay."""
    return [_MASK_NUM.sub("N", _MASK_ID.sub("<id>", _MASK_FID.sub(
        r"\1<fid>", ln))) for ln in text.splitlines()]


def _seed_ring(mod):
    with mod.start_trace("seed.root", path="/x") as sp:
        sp.n_bytes = 11
        with mod.span("seed.a") as a:
            a.tag(k="v")
        with mod.span("seed.b"):
            pass
    with pytest.raises(KeyError):
        with mod.start_trace("seed.err"):
            raise KeyError("boom")


def test_offline_trace_commands_print_the_same_lines(tmp_path):
    lines = {}
    for pkg in ("jax", "port"):
        P = PKG[pkg]
        P["tracing"].reset()
        _seed_ring(P["tracing"])
        out = io.StringIO()
        d = tmp_path / pkg
        d.mkdir()
        env = P["commands"].CommandEnv(store=P["store"].Store([d]),
                                       out=out)
        for line in ("trace.status", "trace.dump -n 2", "trace.dump -n 9",
                     "trace.dump -traceId 0000000000000000"):
            P["commands"].run_command(env, line)
        env.store.close()
        lines[pkg] = _masked(out.getvalue())
    assert lines["port"] == lines["jax"]
    text = "\n".join(lines["port"])
    assert "trace.status enabled=True" in text
    assert "seed.err" in text and "!error:KeyError" in text
    assert "trace.dump: no completed traces" in text


def test_cluster_trace_commands_print_the_same_lines(tmp_path):
    """Twin port stacks, one per shell: ``trace.status``,
    ``ingress.status``, ``trace.dump`` and ``trace.top`` print the same
    lines through the JAX shell (on twin B) as through the port's (on
    twin A), ids, addresses, times and counts masked."""
    twins = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        twins[pkg] = _stack(d, "port", "port", n_servers=1)
    try:
        payloads = _seeded_payloads(3, 6)
        for pkg, (ms, servers, filer) in twins.items():
            _put(f"http://{filer.url}/tw/a.bin", b"a" * 1000)
            filer.filer.chunk_cache.clear()
            tid = ("aaaa" if pkg == "port" else "bbbb") * 4
            _get(f"http://{filer.url}/tw/a.bin",
                 headers={tracing.TRACE_HEADER: f"{tid}-cafe"})
            for p in payloads:      # the same collected traces on both
                ms.trace_collector.ingest(json.loads(json.dumps(p)))
        time.sleep(0.3)
        scripts = ["trace.status", "ingress.status", "trace.dump -n 1",
                   "trace.dump -traceId {tid}", "trace.top -n 3",
                   "trace.top -n 10 -stages 2"]
        lines = {"port": [], "jax": []}
        for line in scripts:
            # the JAX shell first: the port shell's own root lands in
            # the port's ring only after the command has printed
            for pkg in ("jax", "port"):
                ms, servers, filer = twins[pkg]
                out = io.StringIO()
                env = PKG[pkg]["cluster_commands"].ClusterEnv(
                    master_url=ms.url, filer_url=filer.url, out=out)
                tid = ("aaaa" if pkg == "port" else "bbbb") * 4
                try:
                    PKG[pkg]["cluster_commands"].run_cluster_command(
                        env, line.format(tid=tid))
                finally:
                    env.close()
                lines[pkg] += _masked(out.getvalue())
        assert lines["port"] == lines["jax"]
        text = "\n".join(lines["port"])
        assert "master N.N:N: enabled=True" in text
        assert "[filer] busy=N/N" in text
        assert "filer.GET" in text and "trace.top: N stitched" in text
    finally:
        for stack in twins.values():
            _stop(*stack)
