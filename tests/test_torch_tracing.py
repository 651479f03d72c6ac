"""The port's tracing plane (``util/tracing.py``) and its exposition
format (``util/stats.py``) against the JAX package's, on the CPU.

Every case of ``tests/test_tracing.py`` runs on the port. Where a case's
output can be compared, the same seeded operations run through both
packages and the outputs are held equal: the rendered exposition text
byte for byte, ``summarize_spans`` and ``render_trace`` with ids and
durations masked, the parsed ``inject`` / ``parse_value`` round trip and
the untraced-path rule."""

import math
import random
import re
import time

import pytest
from conftest import parse_exposition

from seaweedfs_tpu.util import stats as jax_stats
from seaweedfs_tpu.util import tracing as jax_tracing
from seaweedfs_tpu_torch.util import stats, tracing

from torch_teardown import collect_jax_garbage  # noqa: F401

TRACING = {"port": tracing, "jax": jax_tracing}
STATS = {"port": stats, "jax": jax_stats}


def _reset_all():
    for mod in TRACING.values():
        mod.configure(enabled=True, ring_size=256,
                      slow_threshold_seconds=1.0)
        mod.reset()


@pytest.fixture(autouse=True)
def _clean_tracing():
    _reset_all()
    yield
    _reset_all()


_HEX = re.compile(r"\b[0-9a-f]{16}\b")
_SECS = re.compile(r"\d+\.\d{3}s")


def _mask(text: str) -> str:
    """Ids and durations out: what is left is the tree's shape, names,
    bytes, statuses and tags."""
    return _SECS.sub("<t>s", _HEX.sub("<id>", text))


# ---------------------------------------------------------------------------
# exposition format
# ---------------------------------------------------------------------------

def _counter_gauge_ops(mod):
    m = mod.Metrics(namespace="t")
    m.counter("reqs_total", method="GET", code="200").inc(3)
    m.gauge("queue_depth", shard="a").set(7.5)
    return m.render()


def test_counter_gauge_round_trip():
    text = _counter_gauge_ops(stats)
    samples = parse_exposition(text)
    assert samples["t_reqs_total"] == [
        ({"method": "GET", "code": "200"}, 3.0)]
    assert samples["t_queue_depth"] == [({"shard": "a"}, 7.5)]
    assert parse_exposition.last_types["t_reqs_total"] == "counter"
    assert parse_exposition.last_types["t_queue_depth"] == "gauge"
    assert text == _counter_gauge_ops(jax_stats)


def _escaping_ops(mod, nasty):
    m = mod.Metrics(namespace="t")
    m.counter("odd_total", path=nasty).inc()
    return m.render()


def test_label_escaping_round_trip():
    nasty = 'a"b\\c\nd'
    text = _escaping_ops(stats, nasty)
    # escaped on the wire: backslash first, then quote, then newline
    assert '\\"' in text and "\\\\" in text and "\\n" in text
    samples = parse_exposition(text)
    (labels, value), = samples["t_odd_total"]
    assert labels["path"] == nasty
    assert value == 1.0
    assert text == _escaping_ops(jax_stats, nasty)


def _histogram_ops(mod, values):
    m = mod.Metrics(namespace="t")
    h = m.histogram("lat_seconds", op="read")
    for v in values:
        h.observe(v)
    return m.render()


def test_histogram_round_trip_and_monotonicity():
    values = (0.0001, 0.003, 0.003, 0.2, 9.0, 100.0)
    text = _histogram_ops(stats, values)
    samples = parse_exposition(text)
    buckets = samples["t_lat_seconds_bucket"]
    # le labels are %g-formatted: integral bounds have no trailing ".0"
    les = [b[0]["le"] for b in buckets]
    assert "1" in les and "1.0" not in les
    assert les[-1] == "+Inf"
    counts = [b[1] for b in buckets]
    assert counts == sorted(counts), "bucket counts must be cumulative"
    assert counts[-1] == samples["t_lat_seconds_count"][0][1] == 6.0
    assert math.isclose(samples["t_lat_seconds_sum"][0][1], sum(values))
    assert buckets[-1][0]["le"] == "+Inf"
    # a seeded spread of observations renders byte-equal in both
    rng = random.Random(7)
    spread = [rng.lognormvariate(-5, 2) for _ in range(200)]
    assert _histogram_ops(stats, spread) == \
        _histogram_ops(jax_stats, spread)


def _stage_families(mod) -> dict:
    # stage names of this file's own, so the process-wide registries
    # hold nothing else under them
    with mod.start_trace("mirror.root"):
        with mod.span("mirror.child") as sp:
            sp.n_bytes = 42
    samples = parse_exposition(mod.METRICS.render())
    fams = {name: sorted((tuple(sorted(lb.items())), v) for lb, v in rows
                         if lb.get("stage", "").startswith("mirror."))
            for name, rows in samples.items()
            if name.endswith(("_count", "_total"))}
    return {k: v for k, v in fams.items() if v}


def test_trace_metrics_registry_renders_valid_exposition():
    before = _stage_families(jax_tracing), _stage_families(tracing)
    samples = parse_exposition(tracing.METRICS.render())
    stages = {lb["stage"] for lb, _ in
              samples["trace_request_stage_seconds_count"]}
    assert {"mirror.root", "mirror.child"} <= stages
    assert any(lb == {"stage": "mirror.child"} and v == 42.0
               for lb, v in samples["trace_stage_bytes_total"])
    # the same families, labels and counts in both packages (each
    # registry has seen the mirror spans exactly as often)
    jax_fams, port_fams = before
    assert port_fams == jax_fams
    assert set(port_fams) == {"trace_request_stage_seconds_count",
                              "trace_spans_total",
                              "trace_stage_bytes_total"}


def test_pusher_final_push_on_stop():
    m = stats.Metrics(namespace="t")
    m.counter("x_total").inc()
    # port 1 is never listening — every push attempt lands in .errors
    p = stats.MetricsPusher(m, "127.0.0.1:1", "job", "i",
                            interval_seconds=60.0)
    p.stop()  # never started: only the final best-effort push runs
    assert p.errors == 1 and p.pushed == 0


# ---------------------------------------------------------------------------
# span lifecycle
# ---------------------------------------------------------------------------

def _nested(mod):
    with mod.start_trace("root", path="/x") as root:
        with mod.span("mid") as mid:
            with mod.span("leaf") as leaf:
                leaf.n_bytes = 10
        assert mod.active()
    return root, mid


def test_nested_spans_bundle_into_one_trace():
    root, mid = _nested(tracing)
    traces = tracing.recent_traces()
    assert len(traces) == 1
    t = traces[0]
    assert t["name"] == "root" and t["span_count"] == 3
    assert t["trace_id"] == root.trace_id
    by_name = {s["name"]: s for s in t["spans"]}
    assert by_name["mid"]["parent_id"] == root.span_id
    assert by_name["leaf"]["parent_id"] == mid.span_id
    assert by_name["leaf"]["bytes"] == 10
    assert by_name["root"]["tags"] == {"path": "/x"}
    assert not tracing.active()
    _nested(jax_tracing)
    jt, = jax_tracing.recent_traces()
    assert sorted(t) == sorted(jt)      # the bundle's keys
    assert sorted(t["spans"][0]) == sorted(jt["spans"][0])
    assert _mask(tracing.summarize_spans(t["spans"])) == \
        _mask(jax_tracing.summarize_spans(jt["spans"]))


def test_span_outside_trace_is_noop():
    with tracing.span("orphan") as sp:
        sp.n_bytes = 5  # writes to the shared null span are discarded
    assert sp is tracing._NULL_SPAN
    assert tracing.recent_traces() == []
    # the port's null span is its own, not the JAX package's
    assert tracing._NULL_SPAN is not jax_tracing._NULL_SPAN


def test_header_parse_and_inject_round_trip():
    for value in (None, "", "nodash", "abc-def", "-x", "a-b-c"):
        assert tracing.parse_value(value) == \
            jax_tracing.parse_value(value), value
    assert tracing.parse_value(None) == (None, "")
    assert tracing.parse_value("nodash") == (None, "")
    assert tracing.parse_value("abc-def") == ("abc", "def")
    assert tracing.inject({}) == {}  # no active trace -> untouched
    assert tracing.TRACE_HEADER == jax_tracing.TRACE_HEADER
    assert tracing.GRPC_METADATA_KEY == jax_tracing.GRPC_METADATA_KEY
    with tracing.start_trace("root", header="cafe1234-parent99") as sp:
        assert sp.trace_id == "cafe1234"
        assert sp.parent_id == "parent99"
        hdr = tracing.inject({})
        assert hdr[tracing.TRACE_HEADER] == f"cafe1234-{sp.span_id}"
        # what the port injects, the JAX package continues
        with jax_tracing.start_trace(
                "jax.hop", header=hdr[jax_tracing.TRACE_HEADER]) as jsp:
            assert (jsp.trace_id, jsp.parent_id) == ("cafe1234",
                                                     sp.span_id)
            back = jax_tracing.inject({})
        # ... and the other way round
        assert tracing.parse_value(back[tracing.TRACE_HEADER]) == \
            ("cafe1234", jsp.span_id)
    t, = tracing.recent_traces()
    assert t["trace_id"] == "cafe1234"
    assert t["remote_parent"] == "parent99"


def test_nested_start_trace_degrades_to_child_span():
    with tracing.start_trace("outer") as outer:
        with tracing.start_trace("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
    t, = tracing.recent_traces()
    assert t["span_count"] == 2


def test_disabled_tracing_is_fully_inert():
    tracing.configure(enabled=False)
    with tracing.start_trace("root") as sp:
        with tracing.span("child") as ch:
            assert ch is tracing._NULL_SPAN
        assert sp is tracing._NULL_SPAN
        assert not tracing.active()
    assert tracing.recent_traces() == []
    # the switch is the port's own: the JAX package still traces
    with jax_tracing.start_trace("root"):
        pass
    assert len(jax_tracing.recent_traces()) == 1


def _raise_in_span(mod):
    with pytest.raises(ValueError):
        with mod.start_trace("root"):
            with mod.span("bad"):
                raise ValueError("boom")
    t, = mod.recent_traces()
    return t


def test_exception_marks_span_error():
    t = _raise_in_span(tracing)
    by_name = {s["name"]: s for s in t["spans"]}
    assert by_name["bad"]["status"] == "error:ValueError"
    assert t["status"] == "error:ValueError"
    jt = _raise_in_span(jax_tracing)
    assert _mask(tracing.summarize_spans(t["spans"])) == \
        _mask(jax_tracing.summarize_spans(jt["spans"]))


def test_ring_buffer_bounded_and_limits():
    for mod in TRACING.values():
        mod.configure(ring_size=4)
        for i in range(6):
            with mod.start_trace(f"t{i}"):
                pass
    traces = tracing.recent_traces()
    assert [t["name"] for t in traces] == ["t2", "t3", "t4", "t5"]
    assert tracing.recent_traces(limit=0) == []
    assert [t["name"] for t in tracing.recent_traces(limit=2)] == \
        ["t4", "t5"]
    payload = tracing.debug_payload(limit=0)
    assert payload["count"] == 4 and payload["traces"] == []
    assert payload["ring_size"] == 4 and payload["enabled"] is True
    assert payload == jax_tracing.debug_payload(limit=0)


def test_slow_trace_logs_span_summary(monkeypatch):
    logged = {"port": [], "jax": []}
    for name, mod in TRACING.items():
        monkeypatch.setattr(mod.glog, "warning",
                            lambda fmt, *a, _n=name:
                            logged[_n].append(fmt % a))
        mod.configure(slow_threshold_seconds=0.0)
        with mod.start_trace("slowroot"):
            with mod.span("step"):
                time.sleep(0.001)
    slow = [ln for ln in logged["port"] if ln.startswith("slow trace")]
    assert len(slow) == 1
    assert "slowroot" in slow[0] and "step" in slow[0]
    assert [_mask(ln) for ln in logged["port"]] == \
        [_mask(ln) for ln in logged["jax"]]
    assert [r["name"] for r in tracing.slow_requests()] == ["slowroot"]


def _tree(mod):
    with mod.start_trace("root"):
        with mod.span("a") as sp:
            sp.n_bytes = 7
            sp.tag(k="v", n=3)
        with mod.span("b"):
            with mod.span("b.leaf"):
                pass
    t, = mod.recent_traces()
    return t


def test_summarize_and_render_tree_shapes():
    t = _tree(tracing)
    line = tracing.summarize_spans(t["spans"])
    assert line.startswith("root ")
    assert "{a " in line and ",b " in line and "7B" in line
    rendered = tracing.render_trace(t)
    lines = rendered.splitlines()
    assert lines[0].startswith(f"trace {t['trace_id']} root")
    assert "(4 spans)" in lines[0]
    # children indent one level deeper than the root span
    assert any(ln.startswith("    a ") for ln in lines)
    jt = _tree(jax_tracing)
    assert _mask(line) == _mask(jax_tracing.summarize_spans(jt["spans"]))
    assert _mask(rendered) == _mask(jax_tracing.render_trace(jt))
    # each package renders the other's bundle the same way
    assert tracing.render_trace(jt) == jax_tracing.render_trace(jt)
    assert tracing.summarize_spans(jt["spans"]) == \
        jax_tracing.summarize_spans(jt["spans"])


def test_traced_decorator():
    for mod in TRACING.values():
        @mod.traced("wfs.op", kind="unit")
        def op(x):
            return x * 2

        assert op(21) == 42
    t, = tracing.recent_traces()
    assert t["name"] == "wfs.op"
    assert t["spans"][0]["tags"] == {"kind": "unit"}
    jt, = jax_tracing.recent_traces()
    assert _mask(tracing.render_trace(t)) == \
        _mask(jax_tracing.render_trace(jt))


def test_http_untraced_paths():
    assert tracing._http_untraced("/metrics")
    assert tracing._http_untraced("/debug/traces?limit=2")
    assert tracing._http_untraced("/raft/vote")
    assert not tracing._http_untraced("/b/obj")
    assert not tracing._http_untraced("/dir/assign")
    for path in ("/metrics", "/status", "/healthz", "/debug/vars",
                 "/cluster/traces", "/dir/status", "/raft/heartbeat",
                 "/dir/lookup?volumeId=3", "/3,01ab", "/docs/f",
                 "/metrics2", "/debugx", "/b/obj?x=/debug/"):
        assert tracing._http_untraced(path) == \
            jax_tracing._http_untraced(path), path
