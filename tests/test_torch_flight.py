"""The port's flight recorder (seaweedfs_tpu_torch/pipeline/flight.py) and
the part of util/stats.py it uses, against the JAX package's, on the CPU.

Ports the cases of tests/test_flight.py, each run in both packages, and
adds equality checks: the same event tuples fed to both packages'
chrome_trace, occupancy and analyze give equal JSON and dicts; an armed
run_pipeline records the same sequence of event kinds and batch ids
(timestamps aside); the same metric operations render the same
exposition text. Tolerance 0."""

from __future__ import annotations

import io
import json
from collections import Counter

import numpy as np
import pytest

from seaweedfs_tpu.pipeline import flight as jax_flight
from seaweedfs_tpu.pipeline import pipe as jax_pipe
from seaweedfs_tpu.shell import commands as jax_commands
from seaweedfs_tpu.util import stats as jax_stats
from seaweedfs_tpu_torch.pipeline import flight, pipe
from seaweedfs_tpu_torch.shell import commands
from seaweedfs_tpu_torch.util import stats
from torch_teardown import collect_jax_garbage  # noqa: F401

PACKAGES = {"port": (flight, pipe, commands),
            "jax": (jax_flight, jax_pipe, jax_commands)}


@pytest.fixture(autouse=True)
def disarmed():
    """Every test starts and ends with both recorders disarmed and
    empty, and both rings of recent runs empty."""
    for fl, pp, _c in PACKAGES.values():
        fl.disarm()
        fl.reset()
        pp.reset_telemetry()
    yield
    for fl, pp, _c in PACKAGES.values():
        fl.disarm()
        fl.reset()
        fl._CONFIG.capacity = 65536
        pp.reset_telemetry()


def _ev(fl, ts_ms, event, batch=-1, tid=1, value=0.0, arg=0):
    return (int(ts_ms * 1e6), event, batch, tid, value, arg)


def synthetic_two_stage(fl, n_batches=4, read_ms=1.0, dispatch_ms=20.0,
                        write_ms=1.0):
    """The JAX test's serialized two-stage pipeline with a bubble of
    known shape: the dispatch/h2d lane dominates by construction."""
    evs = [_ev(fl, 0.0, fl.EV_RUN_START)]
    t = 1.0
    for b in range(n_batches):
        evs.append(_ev(fl, t, fl.EV_READ_START, batch=b, tid=1))
        t += read_ms
        evs.append(_ev(fl, t, fl.EV_READ_END, batch=b, tid=1,
                       arg=1 << 20))
        evs.append(_ev(fl, t, fl.EV_DISPATCH, batch=b, tid=2))
        t += dispatch_ms
        evs.append(_ev(fl, t, fl.EV_DISPATCH_DONE, batch=b, tid=2, arg=1))
        evs.append(_ev(fl, t, fl.EV_SYNC_START, batch=b, tid=3))
        t += 0.1
        evs.append(_ev(fl, t, fl.EV_SYNC_END, batch=b, tid=3))
        evs.append(_ev(fl, t, fl.EV_WRITE_START, batch=b, tid=3))
        t += write_ms
        evs.append(_ev(fl, t, fl.EV_WRITE_END, batch=b, tid=3))
    evs.append(_ev(fl, t + 0.5, fl.EV_RUN_END))
    return evs


def _random_stream(seed=1, n=600):
    """A seeded soup of every event kind across four threads, batches
    interleaved, pairs sometimes unmatched."""
    rng = np.random.default_rng(seed)
    kinds = list(range(1, 21))
    evs, t = [], 0
    for _ in range(n):
        t += int(rng.integers(1, 2_000_000))
        evs.append((t, int(rng.choice(kinds)), int(rng.integers(-1, 12)),
                    int(rng.integers(1, 5)),
                    float(rng.integers(0, 8)) / 4.0,
                    int(rng.integers(0, 1 << 20))))
    evs.insert(n // 3, (evs[n // 3][0], 1, -1, 1, 0.0, 0))
    return evs


#: The port's host-stage events, after the JAX package's 20: code, name.
PORT_EVENTS = {"EV_PACK_START": (21, "pack_start"),
               "EV_PACK_END": (22, "pack_end"),
               "EV_READER_WAIT": (23, "reader_wait"),
               "EV_READER_GOT": (24, "reader_got"),
               "EV_GROUP_WAIT": (25, "group_wait"),
               "EV_GROUP_DONE": (26, "group_done"),
               "EV_SPLIT_FLUSH": (27, "split_flush")}
PORT_PAIRS = ((21, 22, "pack"), (23, 24, "reader_wait"),
              (25, 26, "group_wait"))


def test_event_vocabulary_equals_jax():
    """Every JAX event keeps its code, name and pair in the port; the
    port adds exactly its host-stage events, after them."""
    names = [n for n in dir(jax_flight) if n.startswith("EV_")]
    assert len(names) == 20
    for n in names:
        assert getattr(flight, n) == getattr(jax_flight, n), n
    port_names = [n for n in dir(flight) if n.startswith("EV_")]
    assert sorted(set(port_names) - set(names)) == sorted(PORT_EVENTS)
    for n, (code, name) in PORT_EVENTS.items():
        assert getattr(flight, n) == code
        assert flight._NAMES[code] == name
    assert {c: flight._NAMES[c] for c in jax_flight._NAMES} == \
        jax_flight._NAMES
    assert len(flight._NAMES) == len(jax_flight._NAMES) + len(PORT_EVENTS)
    n_jax = len(jax_flight._SPAN_PAIRS)
    assert flight._SPAN_PAIRS[:n_jax] == jax_flight._SPAN_PAIRS
    assert flight._SPAN_PAIRS[n_jax:] == PORT_PAIRS
    assert flight._ADVICE == jax_flight._ADVICE


# --------------------------------------------------------------------------
# the ring (tests/test_flight.py TestRing, in both packages)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_eviction_wraps_and_counts_drops(pkg):
    fl = PACKAGES[pkg][0]
    rec = fl.FlightRecorder(capacity=64)
    for i in range(200):
        rec.record(fl.EV_ENQUEUE, batch=i)
    assert rec.written == 200
    assert rec.dropped == 200 - 64
    snap = rec.snapshot()
    assert len(snap) == 64
    assert [e[2] for e in snap] == list(range(136, 200))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_minimum_capacity_clamped(pkg):
    assert PACKAGES[pkg][0].FlightRecorder(capacity=1).capacity == 64


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_sorted_and_reset_empties(pkg):
    fl = PACKAGES[pkg][0]
    rec = fl.FlightRecorder(capacity=64)
    for b in range(5):
        rec.record(fl.EV_ENQUEUE, batch=b)
    ts = [e[0] for e in rec.snapshot()]
    assert ts == sorted(ts)
    rec.reset()
    assert rec.written == 0
    assert rec.snapshot() == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_disarmed_record_is_noop(pkg):
    fl = PACKAGES[pkg][0]
    assert not fl.armed()
    fl.record(fl.EV_ENQUEUE, batch=1)
    assert fl.recorder() is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_armed_module_record(pkg):
    fl = PACKAGES[pkg][0]
    rec = fl.arm(capacity=128)
    assert fl.armed() and rec.capacity == 128
    fl.record(fl.EV_ENQUEUE, batch=7, arg=42)
    (ev,) = rec.snapshot()
    assert ev[1] == fl.EV_ENQUEUE
    assert ev[2] == 7 and ev[5] == 42


# --------------------------------------------------------------------------
# config / arming (TestConfig)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_configure_arms_and_disarms(pkg):
    fl = PACKAGES[pkg][0]
    fl.configure(enabled=True, capacity=256)
    assert fl.armed()
    assert fl.recorder().capacity == 256
    fl.configure(enabled=False)
    assert not fl.armed()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_configure_rejects_unknown_key(pkg):
    with pytest.raises(TypeError, match="unknown flight config key"):
        PACKAGES[pkg][0].configure(bogus=1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_configure_from_toml_section(pkg):
    fl = PACKAGES[pkg][0]
    fl.configure_from({"flight": {"enabled": True, "capacity": 512}})
    assert fl.armed()
    assert fl.recorder().capacity == 512
    fl.configure_from({})
    assert fl.armed()


def test_install_from_env_reads_the_ports_variable(monkeypatch):
    monkeypatch.delenv("SEAWEED_FLIGHT", raising=False)
    monkeypatch.setenv("SEAWEEDFS_TORCH_FLIGHT", "0")
    flight.install_from_env()
    assert not flight.armed()
    # the JAX package's variable does not arm the port
    monkeypatch.setenv("SEAWEED_FLIGHT", "1")
    flight.install_from_env()
    assert not flight.armed()
    monkeypatch.setenv("SEAWEEDFS_TORCH_FLIGHT", "4096")
    flight.install_from_env()
    assert flight.armed()
    assert flight.recorder().capacity == 4096
    flight.disarm()
    monkeypatch.setenv("SEAWEEDFS_TORCH_FLIGHT", "yes")
    flight.install_from_env()
    # a value that is no size arms at the configured capacity
    assert flight.armed() and flight.recorder().capacity == 4096


# --------------------------------------------------------------------------
# Chrome trace export (TestChromeTrace) and its equality with JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_trace_schema(pkg):
    fl = PACKAGES[pkg][0]
    evs = synthetic_two_stage(fl)
    evs.append(_ev(fl, 3.0, fl.EV_QDEPTH, value=2.0, arg=0))
    evs.append(_ev(fl, 3.1, fl.EV_POOL_OCC, value=3.0))
    doc = fl.chrome_trace(evs)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    out = doc["traceEvents"]
    assert {"X", "C", "i", "M"} <= {e["ph"] for e in out}
    for e in out:
        assert "name" in e and "pid" in e
        if e["ph"] != "M":
            assert isinstance(e["ts"], (int, float))
        if e["ph"] == "X":
            assert e["dur"] >= 0
    names = {e["args"]["name"] for e in out if e["ph"] == "M"}
    assert {"reader", "compute", "writer"} <= names
    xnames = {e["name"] for e in out if e["ph"] == "X"}
    assert {"read", "dispatch", "d2h_sync", "write"} <= xnames
    depths = [e for e in out if e["name"] == "read_q_depth"]
    assert depths and depths[0]["args"]["depth"] == 2.0
    json.loads(json.dumps(doc))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_trace_timestamps_relative_and_edge_cases(pkg, tmp_path):
    fl = PACKAGES[pkg][0]
    doc = fl.chrome_trace(synthetic_two_stage(fl))
    assert min(e["ts"] for e in doc["traceEvents"] if e["ph"] != "M") == 0.0
    out = fl.chrome_trace([_ev(fl, 0.0, fl.EV_RUN_START),
                           _ev(fl, 5.0, fl.EV_PWRITEV_RETIRE, tid=9,
                               value=0.002, arg=4096)])["traceEvents"]
    (x,) = [e for e in out if e["ph"] == "X"]
    assert x["name"] == "pwritev" and x["args"]["bytes"] == 4096
    assert x["dur"] == pytest.approx(2000.0)
    out = fl.chrome_trace([_ev(fl, 1.0, fl.EV_READ_END, batch=0)])
    assert not [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert fl.chrome_trace([]) == {"traceEvents": [],
                                   "displayTimeUnit": "ms"}
    path = tmp_path / "trace.json"
    n = fl.dump_trace(str(path), synthetic_two_stage(fl))
    assert len(json.loads(path.read_text())["traceEvents"]) == n > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trace_occupancy_and_analysis_equal_jax(seed, tmp_path):
    """The same event tuples through both packages: equal documents,
    files and dicts, for the synthetic stream and a random soup of every
    JAX event kind (the port's own kinds are in none of them)."""
    for evs in (synthetic_two_stage(flight, n_batches=3 + seed),
                _random_stream(seed)):
        assert {e[1] for e in evs} <= set(jax_flight._NAMES)
        assert flight.chrome_trace(evs) == jax_flight.chrome_trace(evs)
        a, b = tmp_path / "port.json", tmp_path / "jax.json"
        assert flight.dump_trace(str(a), evs) == \
            jax_flight.dump_trace(str(b), evs)
        assert a.read_bytes() == b.read_bytes()
        for last in (True, False):
            assert flight.occupancy(evs, last_run_only=last) == \
                jax_flight.occupancy(evs, last_run_only=last)
            assert flight.analyze(evs, last_run_only=last) == \
                jax_flight.analyze(evs, last_run_only=last)


def _with_host_stages(fl):
    """synthetic_two_stage with the port's host stages laid in: a pack
    inside each read, the compute thread's wait on the reader before each
    dispatch, a group wait, and the staged copies inside each dispatch."""
    evs = synthetic_two_stage(fl)
    more = []
    for ts, kind, batch, tid, _v, _a in evs:
        ms = ts / 1e6
        if kind == fl.EV_READ_START:
            more += [_ev(fl, ms + 0.2, fl.EV_PACK_START, tid=tid),
                     _ev(fl, ms + 0.7, fl.EV_PACK_END, tid=tid, arg=512)]
            more += [_ev(fl, ms, fl.EV_READER_WAIT, tid=2)]
        elif kind == fl.EV_READ_END:
            more += [_ev(fl, ms, fl.EV_READER_GOT, tid=2),
                     _ev(fl, ms, fl.EV_GROUP_WAIT, tid=2),
                     _ev(fl, ms, fl.EV_GROUP_DONE, tid=2, arg=1)]
        elif kind == fl.EV_DISPATCH:
            more += [_ev(fl, ms + 1.0, fl.EV_H2D_SUBMIT, batch=fl.STAGED,
                         tid=tid),
                     _ev(fl, ms + 15.0, fl.EV_H2D_READY, batch=fl.STAGED,
                         tid=tid, arg=1 << 20)]
    return sorted(evs + more, key=lambda e: e[0])


def test_host_stage_spans_render_and_add_no_busy_time():
    """Port only: the host-stage spans and the staged copies are trace
    bars on the reader's and the compute stage's tracks, and leave the
    occupancy and the verdict as the stream without them has them."""
    plain, staged = synthetic_two_stage(flight), _with_host_stages(flight)
    doc = flight.chrome_trace(staged)["traceEvents"]
    bars = Counter(e["name"] for e in doc if e["ph"] == "X")
    assert bars["pack"] == bars["reader_wait"] == bars["h2d"] == 4
    assert bars["group_wait"] == 4
    tracks = {e["tid"]: e["args"]["name"] for e in doc if e["ph"] == "M"}
    assert tracks[1] == "reader" and tracks[2] == "compute"
    occ = flight.occupancy(staged)
    assert occ == dict(flight.occupancy(plain), events=occ["events"])
    assert flight.analyze(staged)["verdict"] == \
        flight.analyze(plain)["verdict"]


def test_spans_pair_as_the_chrome_trace_does():
    """Port only: flight.spans hands out the trace's bars on the
    monotonic clock, oldest start first."""
    evs = _with_host_stages(flight)
    got = flight.spans(evs)
    assert [s[1] for s in got] == sorted(s[1] for s in got)
    doc = flight.chrome_trace(evs)["traceEvents"]
    t0 = min(e[0] for e in evs)
    bars = sorted((e["name"], e["ts"], e["dur"]) for e in doc
                  if e["ph"] == "X")
    assert sorted((n, round((a - t0) / 1000.0, 3),
                   round((b - a) / 1000.0, 3))
                  for n, a, b, _t, _b in got) == bars
    assert {s[4] for s in got if s[0] == "h2d"} == {flight.STAGED}
    assert flight.spans([]) == [] and flight.spans() == []


def test_a_profiled_run_arms_a_ring_that_follows_the_profile():
    """Port only: a run under a profile arms a ring when nothing is
    armed, keeps it after the profile for reading, and drops it at the
    first run no profile records; a ring armed by [flight] is left."""
    flight.follow_profiler(False)
    assert not flight.armed()
    flight.follow_profiler(True)
    rec = flight.recorder()
    assert rec is not None and rec.capacity == flight.PROFILE_CAPACITY
    assert not flight.current().enabled
    flight.follow_profiler(True)
    assert flight.recorder() is rec
    flight.follow_profiler(False)
    assert not flight.armed()
    flight.configure(enabled=True, capacity=128)
    for profiling in (True, False):
        flight.follow_profiler(profiling)
        assert flight.recorder().capacity == 128


def test_concurrent_profiled_runs_share_one_ring():
    """Port only: runs starting at once on many threads under a profile
    arm one ring between them (none is lost to a race), and drop it at
    once when no profile records them."""
    import sys
    import threading
    n = 16
    seen, gate = [], threading.Barrier(n)

    def start(profiling):
        gate.wait(timeout=10)
        for _ in range(50):
            flight.follow_profiler(profiling)
            seen.append(flight.recorder())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for profiling in (True, False):
            seen.clear()
            threads = [threading.Thread(target=start, args=(profiling,))
                       for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert len(seen) == n * 50
            if profiling:
                assert len({id(r) for r in seen}) == 1 and seen[0]
                assert seen[0] is flight.recorder()
            else:
                assert seen[-1] is None and not flight.armed()
    finally:
        sys.setswitchinterval(old)


# --------------------------------------------------------------------------
# occupancy + analyzer (TestAnalyzer, in both packages)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_synthetic_bubbles_named(pkg):
    fl = PACKAGES[pkg][0]
    ana = fl.analyze(synthetic_two_stage(fl))
    assert ana["bottleneck"] == "dispatch/h2d"
    assert "dispatch/h2d" in ana["verdict"]
    assert ana["waited_on_top"] == "dispatch/h2d"
    occ = ana["occupancy"]
    assert occ["batches"] == 4
    assert occ["busy_fraction"]["dispatch"] > occ["busy_fraction"]["read"]
    ana = fl.analyze(synthetic_two_stage(fl, dispatch_ms=0.5,
                                         write_ms=30.0))
    assert ana["bottleneck"] == "write"
    assert any("[pipeline]" in r for r in ana["recommendations"])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pool_wait_carved_out_of_read(pkg):
    fl = PACKAGES[pkg][0]
    evs = [_ev(fl, 0.0, fl.EV_RUN_START),
           _ev(fl, 1.0, fl.EV_READ_START, batch=0, tid=1),
           _ev(fl, 1.1, fl.EV_POOL_WAIT, tid=1),
           _ev(fl, 9.0, fl.EV_POOL_GOT, tid=1, value=4.0),
           _ev(fl, 10.0, fl.EV_READ_END, batch=0, tid=1),
           _ev(fl, 10.0, fl.EV_DISPATCH, batch=0, tid=2),
           _ev(fl, 10.5, fl.EV_DISPATCH_DONE, batch=0, tid=2),
           _ev(fl, 11.0, fl.EV_RUN_END)]
    occ = fl.occupancy(evs)
    assert occ["busy_seconds"]["pool_wait"] == pytest.approx(7.9e-3,
                                                             rel=1e-3)
    assert occ["busy_seconds"]["read"] == pytest.approx(1.1e-3, rel=1e-3)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_last_run_window_and_incomplete_read(pkg):
    fl = PACKAGES[pkg][0]
    old = synthetic_two_stage(fl, n_batches=6)
    fresh = [(ts + int(1e9), ev, b + 100 if b >= 0 else b, t, v, a)
             for ts, ev, b, t, v, a in synthetic_two_stage(fl, n_batches=2)]
    assert fl.occupancy(old + fresh)["batches"] == 2
    assert fl.occupancy(old + fresh, last_run_only=False)["batches"] == 8
    evs = synthetic_two_stage(fl, n_batches=3)
    evs.insert(-1, _ev(fl, 90.0, fl.EV_READ_START, batch=3, tid=1))
    assert fl.occupancy(evs)["batches"] == 3
    ana = fl.analyze([])
    assert ana["bottleneck"] is None
    assert ana["verdict"] == "no recorded batches"


# --------------------------------------------------------------------------
# an armed run end to end (TestArmedRun), and the recorded sequence
# against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_run_pipeline_records_and_publishes(pkg):
    fl, pp, _c = PACKAGES[pkg]
    fl.arm(capacity=4096)
    fl.reset()
    written = []
    pp.run_pipeline(((i, np.full(4096, i, dtype=np.uint8))
                     for i in range(6)),
                    encode_fn=lambda b: b.astype(np.uint16),
                    write_fn=lambda meta, b, r: written.append(meta),
                    kind="flight-test")
    assert written == list(range(6))
    assert fl.recorder().written >= 6 * 4
    ana = fl.analyze()
    assert ana["bottleneck"] is not None
    assert ana["occupancy"]["batches"] == 6
    payload = fl.debug_payload()
    assert payload["armed"] is True
    assert payload["last_run"]["batches"] == 6
    exposition = fl.METRICS.render()
    assert "seaweed_pipeline_stage_busy_fraction" in exposition
    assert "seaweed_pipeline_flight_batches" in exposition
    for stage, frac in ana["occupancy"]["busy_fraction"].items():
        if stage != "writeback":
            assert 0.0 <= frac <= 1.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_disarmed_run_records_nothing(pkg):
    fl, pp, _c = PACKAGES[pkg]
    pp.run_pipeline(((i, np.zeros(1024, dtype=np.uint8)) for i in range(3)),
                    encode_fn=lambda b: b, write_fn=lambda meta, b, r: None,
                    kind="flight-off")
    assert fl.recorder() is None


def _recorded(pkg, overlapped, prepare=False, double_buffer=False):
    """(event kind, batch id) of an armed run through a pooled reader,
    in recording order, with the run's kind hash masked."""
    fl, pp, _c = PACKAGES[pkg]
    fl.arm(capacity=8192)
    fl.reset()
    pp.configure(double_buffer=double_buffer)
    try:
        pool = pp.HostBufferPool(64, 3)

        def batches():
            for i in range(9):
                buf = pool.acquire()
                fl.record(fl.EV_ENQUEUE, arg=64)
                buf[:] = i
                yield buf, buf

        pp.run_pipeline(
            batches(), lambda b: np.asarray(b[1] if prepare else b) ^ 1,
            lambda m, b, r: None,
            recycle_fn=lambda m, b: pool.release(m),
            prepare_fn=(lambda b: (0, b)) if prepare else None,
            overlapped=overlapped, kind="seq")
    finally:
        pp.configure(double_buffer=False)
    return [(e[1], e[2]) for e in fl.recorder().snapshot()]


def test_sync_run_records_the_same_sequence_as_jax():
    port, ref = _recorded("port", False), _recorded("jax", False)
    assert port == ref
    kinds = Counter(k for k, _b in port)
    assert kinds[flight.EV_DISPATCH] == kinds[flight.EV_WRITE_END] == 9
    assert kinds[flight.EV_RUN_START] == kinds[flight.EV_RUN_END] == 1


@pytest.mark.parametrize("mode", ["plain", "split", "lookahead"])
def test_overlapped_run_records_the_same_events_as_jax(mode):
    """Stage threads interleave, so the recording ORDER varies from run
    to run: compare each batch's lifecycle events as a multiset."""
    kw = {"plain": {}, "split": {"prepare": True},
          "lookahead": {"prepare": True, "double_buffer": True}}[mode]
    port = _recorded("port", True, **kw)
    ref = _recorded("jax", True, **kw)
    lifecycle = {flight.EV_READ_START, flight.EV_READ_END,
                 flight.EV_SYNC_START, flight.EV_SYNC_END,
                 flight.EV_WRITE_START, flight.EV_WRITE_END,
                 flight.EV_ENQUEUE, flight.EV_POOL_WAIT,
                 flight.EV_POOL_GOT, flight.EV_RECYCLE, flight.EV_RUN_START,
                 flight.EV_RUN_END, flight.EV_DISPATCH,
                 flight.EV_DISPATCH_DONE}
    assert Counter(e for e in port if e[0] in lifecycle) == \
        Counter(e for e in ref if e[0] in lifecycle)
    written = [b for k, b in port if k == flight.EV_WRITE_END]
    assert written == list(range(9))


# --------------------------------------------------------------------------
# shell commands (TestCommands, in both packages)
# --------------------------------------------------------------------------

def _shell_env(pkg, tmp_path):
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    if pkg == "port":
        from seaweedfs_tpu_torch.storage.store import Store
        return commands.CommandEnv(store=Store([str(d)]), out=io.StringIO(),
                                   device="cpu")
    from seaweedfs_tpu.storage.store import Store
    return jax_commands.CommandEnv(store=Store([str(d)]), out=io.StringIO())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_dump_and_analyze_require_armed(pkg, tmp_path):
    cmds = PACKAGES[pkg][2]
    env = _shell_env(pkg, tmp_path)
    with pytest.raises(cmds.ShellError, match="not armed"):
        cmds.COMMANDS["pipeline.dump"](
            env, ["-trace", str(tmp_path / "t.json")])
    with pytest.raises(cmds.ShellError, match="not armed"):
        cmds.COMMANDS["pipeline.analyze"](env, [])
    if pkg == "port":
        with pytest.raises(cmds.ShellError,
                           match="SEAWEEDFS_TORCH_FLIGHT=1"):
            cmds.COMMANDS["pipeline.analyze"](env, [])


def test_dump_and_analyze_after_run_print_as_jax(tmp_path):
    """The same synthetic events recorded in both packages: the analyze
    lines are equal once the window's seconds are masked (each package
    records its own timestamps), and both traces hold the same event
    names."""
    out = {}
    for pkg, (fl, _p, cmds) in PACKAGES.items():
        rec = fl.arm(capacity=4096)
        fl.reset()
        for ev in synthetic_two_stage(fl):
            rec.record(ev[1], batch=ev[2], value=ev[4], arg=ev[5])
        env = _shell_env(pkg, tmp_path)
        trace = tmp_path / f"{pkg}.json"
        cmds.COMMANDS["pipeline.dump"](env, ["-trace", str(trace)])
        dumped = env.out.getvalue()
        assert "trace events" in dumped
        env.out = io.StringIO()
        cmds.COMMANDS["pipeline.analyze"](env, [])
        text = env.out.getvalue()
        assert "bottleneck:" in text and "[pipeline]" in text
        names = {e["name"] for e in json.loads(trace.read_text())
                 ["traceEvents"]}
        out[pkg] = (dumped.split()[1], names)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_status_mentions_flight_state(pkg, tmp_path):
    fl, pp, cmds = PACKAGES[pkg]
    env = _shell_env(pkg, tmp_path)
    fl.arm()
    cmds.COMMANDS["pipeline.status"](env, [])
    assert "flight: armed, no recorded run yet" in env.out.getvalue()


# --------------------------------------------------------------------------
# util/stats: the exposition text the recorder's gauges render into
# --------------------------------------------------------------------------

def test_metrics_render_byte_equal_to_jax():
    regs = [stats.Metrics(namespace="seaweed"),
            jax_stats.Metrics(namespace="seaweed")]
    for m in regs:
        m.counter("reads_total", path='a"b\\c\nd').inc(3)
        m.counter("reads_total").inc()
        m.gauge("pipeline_stage_busy_fraction", stage="read").set(0.25)
        m.gauge("pipeline_stage_busy_fraction", stage="d2h").add(0.5)
        h = m.histogram("request_stage_seconds", stage="pipe.read")
        for v in (0.0001, 0.003, 0.2, 7.0, 42.0):
            h.observe(v)
        m.histogram("plain").observe(0.01)
    assert regs[0].render() == regs[1].render()
    assert regs[0].render().count("# TYPE") == 6
    assert stats.DEFAULT_BUCKETS == jax_stats.DEFAULT_BUCKETS
    assert stats.EXPOSITION_CONTENT_TYPE == jax_stats.EXPOSITION_CONTENT_TYPE
