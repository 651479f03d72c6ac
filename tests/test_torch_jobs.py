"""The port's jobs plane (``cluster/jobs.py``) against the JAX package's,
without servers: the ``JobManager`` units of JAX ``tests/test_jobs.py``
run against both packages' managers, ``jobs.json`` written by either
package loads in the other, the stuck-task fault of the reference is
shown beside the port's repair on a real two-node topology, and the
``[jobs]`` / ``[storage.scrub]`` settings apply alike in both."""

import json

import pytest

from seaweedfs_tpu.cluster import jobs as jax_jobs
from seaweedfs_tpu.cluster import topology as jax_topology
from seaweedfs_tpu.pb import master_pb2 as jax_master_pb2
from seaweedfs_tpu.storage import scrubber as jax_scrubber
from seaweedfs_tpu_torch.cluster import jobs, master, topology
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.storage import scrubber

from torch_teardown import collect_jax_garbage  # noqa: F401

JOBS = {"jax": jax_jobs, "port": jobs}
PB = {"jax": jax_master_pb2, "port": master_pb2}
TOPOLOGY = {"jax": jax_topology, "port": topology}
W1, W2 = "10.0.0.1:8080", "10.0.0.2:8080"


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _progress(pkg, task_id, job_id="j1", fraction=0.5):
    jp = PB[pkg].JobProgress()
    jp.tasks.add(task_id=task_id, job_id=job_id, kind="ec_encode",
                 volume_id=1, state="running", fraction=fraction)
    return jp


@pytest.fixture(autouse=True)
def _jobs_enabled():
    for mod in JOBS.values():
        mod.configure(enabled=True)
    yield
    for mod in JOBS.values():
        mod.configure(enabled=True)


both = pytest.mark.parametrize("pkg", ["jax", "port"])


# -- JAX tests/test_jobs.py:61-200, each run on both managers ---------------


@both
def test_lease_renewal_extends_expiry(pkg):
    clock = FakeClock()
    jm = JOBS[pkg].JobManager(lease_seconds=10.0, clock=clock)
    jm.submit("ec_encode", [1])
    t = jm.claim(W1)
    assert t["taskId"] == "j1.t1"
    for dt in (8.0, 16.0, 24.0):
        clock.t = 1000.0 + dt
        assert jm.renew(W1, _progress(pkg, "j1.t1")) == 1
        assert jm.expire() == []
    assert jm.to_map()["jobs"][0]["tasks"][0]["fraction"] == 0.5
    clock.t = 1000.0 + 24.0 + 10.1
    assert jm.expire() == ["j1.t1"]


@both
def test_expired_lease_requeues_with_worker_excluded(pkg):
    clock = FakeClock()
    jm = JOBS[pkg].JobManager(lease_seconds=5.0, clock=clock)
    jm.submit("vacuum", [7])
    assert jm.claim(W1)["taskId"] == "j1.t1"
    clock.t += 5.1
    assert jm.expire() == ["j1.t1"]
    # without a topology an exclusion is a ban in both packages
    assert jm.claim(W1) is None
    t = jm.claim(W2)
    assert t is not None and t["taskId"] == "j1.t1"
    assert jm.expired_total == 1


@both
def test_stale_completion_is_ignored(pkg):
    clock = FakeClock()
    jm = JOBS[pkg].JobManager(lease_seconds=5.0, clock=clock)
    jm.submit("ec_encode", [1])
    jm.claim(W1)
    clock.t += 5.1
    jm.expire()
    t = jm.claim(W2)
    assert jm.complete(W1, t["taskId"], True).get("stale") is True
    assert jm.stale_completions == 1
    assert jm.complete(W2, t["taskId"], True)["state"] == "done"
    assert jm.to_map()["jobs"][0]["state"] == "done"


@both
def test_failure_requeues_then_fails_terminally(pkg):
    jm = JOBS[pkg].JobManager(lease_seconds=5.0, max_attempts=2,
                              clock=FakeClock())
    jm.submit("ec_encode", [1])
    jm.claim(W1)
    assert jm.complete(W1, "j1.t1", False, "boom")["state"] == "pending"
    assert jm.claim(W1) is None
    jm.claim(W2)
    assert jm.complete(W2, "j1.t1", False, "boom")["state"] == "failed"
    job = jm.to_map()["jobs"][0]
    assert job["state"] == "failed"
    assert job["tasks"][0]["error"] == "boom"


@both
def test_parallel_cap_limits_concurrent_leases(pkg):
    jm = JOBS[pkg].JobManager(lease_seconds=30.0, clock=FakeClock())
    jm.submit("ec_encode", [1, 2, 3], parallel=1)
    assert jm.claim(W1) is not None
    assert jm.claim(W2) is None
    jm.complete(W1, "j1.t1", True)
    assert jm.claim(W2) is not None


@both
def test_pause_and_cancel_stop_handout(pkg):
    jm = JOBS[pkg].JobManager(clock=FakeClock())
    jm.submit("ec_encode", [1, 2])
    jm.pause("j1")
    assert jm.claim(W1) is None
    jm.resume("j1")
    t = jm.claim(W1)
    assert t is not None
    jm.cancel("j1")
    assert jm.claim(W2) is None
    assert jm.complete(W1, t["taskId"], True)["state"] == "done"
    with pytest.raises(KeyError):
        jm.pause("j9")


@both
def test_checkpoint_resume_across_master_restart(tmp_path, pkg):
    path = tmp_path / "jobs.json"
    clock = FakeClock()
    mod = JOBS[pkg]
    jm = mod.JobManager(checkpoint_path=path, lease_seconds=5.0,
                        clock=clock)
    jm.submit("ec_encode", [1, 2, 3], collection="c", parallel=2)
    t = jm.claim(W1)
    jm.complete(W1, t["taskId"], True)
    jm.claim(W2)
    jm2 = mod.JobManager(checkpoint_path=path, lease_seconds=5.0,
                         clock=clock)
    states = {x["taskId"]: x["state"]
              for x in jm2.to_map()["jobs"][0]["tasks"]}
    assert states[t["taskId"]] == "done"
    assert "leased" not in states.values()
    assert sorted(states.values()) == ["done", "pending", "pending"]
    assert jm2.submit("vacuum", [9])["jobId"] == "j2"
    seen = set()
    while True:
        nt = jm2.claim(W1)
        if nt is None:
            break
        seen.add(nt["volumeId"])
        jm2.complete(W1, nt["taskId"], True)
    assert jm2.to_map()["jobs"][0]["state"] == "done"
    assert t["volumeId"] not in seen


@both
def test_corrupt_checkpoint_starts_empty(tmp_path, pkg):
    path = tmp_path / "jobs.json"
    path.write_text("{not json", encoding="utf-8")
    jm = JOBS[pkg].JobManager(checkpoint_path=path)
    assert jm.to_map()["jobs"] == []
    jm.submit("ec_encode", [1])
    assert json.loads(path.read_text())["jobs"][0]["jobId"] == "j1"


@both
def test_submit_rejects_unknown_kind_and_empty_volumes(pkg):
    jm = JOBS[pkg].JobManager()
    with pytest.raises(ValueError):
        jm.submit("defrag", [1])
    with pytest.raises(ValueError):
        jm.submit("ec_encode", [])


@both
def test_kill_switch_stops_handout(pkg):
    """JAX ``tests/test_jobs.py:438``."""
    mod = JOBS[pkg]
    jm = mod.JobManager(clock=FakeClock())
    jm.submit("ec_encode", [1])
    mod.configure(enabled=False)
    try:
        assert not mod.enabled()
        assert jm.claim(W1) is None
    finally:
        mod.configure(enabled=True)
    assert jm.claim(W1) is not None


# -- the same sequence through both managers ---------------------------------


def _script(jm, clock):
    jm.submit("ec_encode", [3, 1, 2], collection="c", parallel=2,
              submitted_by="shell")
    jm.submit("scrub", [5], params={"rate_bytes_per_second": 0})
    a = jm.claim(W1)
    b = jm.claim(W2)
    clock.t += 1.0
    jm.complete(W1, a["taskId"], True)
    jm.complete(W2, b["taskId"], False, "IOError: disk")
    c = jm.claim(W1)
    clock.t += 30.0
    jm.expire()
    jm.pause("j2")
    jm.renew(W1, type("P", (), {"tasks": ()})())
    return [a, b, c]


def test_both_managers_walk_the_same_states(tmp_path):
    """One script of submits, claims, completions, an expiry and a pause
    through both managers (no topology): the same claims, the same
    ``to_map``, the same gauges, and ``jobs.json`` byte-equal."""
    out = {}
    for pkg, mod in JOBS.items():
        clock = FakeClock()
        path = tmp_path / pkg / "jobs.json"
        jm = mod.JobManager(checkpoint_path=path, clock=clock)
        claims = _script(jm, clock)
        out[pkg] = (claims, jm.to_map(), jm.summary(),
                    jm.active_volume_ids(), jm.metrics.render(),
                    path.read_bytes())
    assert out["port"] == out["jax"]
    assert 'seaweed_jobs_tasks{kind="ec_encode",state="done"} 1' \
        in out["port"][4]


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_written_by_one_package_loads_in_the_other(
        tmp_path, writer, reader):
    clock = FakeClock()
    path = tmp_path / "jobs.json"
    jm = JOBS[writer].JobManager(checkpoint_path=path, clock=clock)
    _script(jm, clock)
    # mid-flight state: a leased task, a failed attempt, a paused job
    loaded = {pkg: JOBS[pkg].JobManager(checkpoint_path=path, clock=clock)
              for pkg in (writer, reader)}
    assert loaded[reader].to_map() == loaded[writer].to_map()
    assert loaded[reader].summary() == loaded[writer].summary()
    assert loaded[reader].submit("vacuum", [8])["jobId"] == "j3"
    before = path.read_bytes()
    loaded[writer].submit("vacuum", [8])
    assert path.read_bytes() == before   # both wrote the same document


# -- the stuck-task fault (ROADMAP Queue 3) ----------------------------------


def _two_nodes(pkg, clock):
    """Two live nodes; only A holds volume 7 of collection c."""
    topo = TOPOLOGY[pkg].Topology(pulse_seconds=1.0, clock=clock)
    vi = TOPOLOGY[pkg].VolumeInfo
    topo.register_heartbeat("a:8080", rack="r0",
                            volumes=[vi(id=7, collection="c")])
    topo.register_heartbeat("b:8080", rack="r1", volumes=[])
    return topo


@pytest.mark.parametrize("how", ["failure", "lease"])
def test_single_holder_task_ends_in_the_port_and_wedges_in_jax(how):
    """JAX ``_eligible`` bans every excluded worker, and an ``ec_encode``
    is eligible only on a holder: after one failed attempt (or one
    expired lease) by the only holder, the JAX task stays pending and
    its job active for good. The port lets the excluded holder claim
    again while no other worker is eligible, counting attempts, so the
    job ends ``failed`` within ``max_attempts`` claims."""
    out = {}
    for pkg, mod in JOBS.items():
        clock = FakeClock()
        jm = mod.JobManager(topology=_two_nodes(pkg, clock),
                            lease_seconds=5.0, max_attempts=3, clock=clock)
        jm.submit("ec_encode", [7], collection="c")
        assert jm.claim("b:8080") is None       # B holds nothing
        claims = 0
        while claims < 10:
            t = jm.claim("a:8080")
            if t is None:
                break
            claims += 1
            if how == "failure":
                jm.complete("a:8080", t["taskId"], False, "boom")
            else:
                clock.t += 6.0
                jm.expire()
        assert jm.claim("b:8080") is None
        clock.t = 10_000.0
        jm.expire()
        job = jm.to_map()["jobs"][0]
        out[pkg] = (claims, job["state"], job["tasks"][0]["state"],
                    job["tasks"][0]["attempts"],
                    job["tasks"][0]["excluded"])
    assert out["jax"] == (1, "active", "pending", 1, ["a:8080"])
    assert out["port"] == (3, "failed", "failed", 3, ["a:8080"])


def test_single_holder_retry_succeeds_on_a_later_attempt():
    """A transient failure on the only holder: the port hands the task
    back to it, and the second attempt completes the job."""
    clock = FakeClock()
    jm = jobs.JobManager(topology=_two_nodes("port", clock), clock=clock)
    jm.submit("ec_encode", [7], collection="c")
    t = jm.claim("a:8080")
    jm.complete("a:8080", t["taskId"], False, "FaultError: once")
    t = jm.claim("a:8080")
    assert t is not None
    assert jm.complete("a:8080", t["taskId"], True)["state"] == "done"
    task = jm.to_map()["jobs"][0]["tasks"][0]
    assert (task["attempts"], task["excluded"]) == (2, ["a:8080"])


@both
def test_excluded_worker_stays_excluded_while_another_holder_lives(pkg):
    """Two holders: the one whose attempt failed stays excluded in both
    packages, and the other takes the retry (the worker-death case of
    JAX ``tests/test_chaos_integration.py:161``)."""
    clock = FakeClock()
    topo = _two_nodes(pkg, clock)
    vi = TOPOLOGY[pkg].VolumeInfo
    topo.register_heartbeat("b:8080", rack="r1",
                            volumes=[vi(id=7, collection="c")])
    jm = JOBS[pkg].JobManager(topology=topo, lease_seconds=5.0,
                              clock=clock)
    jm.submit("ec_encode", [7], collection="c")
    assert jm.claim("a:8080") is not None
    clock.t += 6.0
    jm.expire()
    assert jm.claim("a:8080") is None
    t = jm.claim("b:8080")
    assert t is not None and t["source"] == ""


@both
def test_replicate_picks_a_live_source_and_skips_holders(pkg):
    clock = FakeClock()
    jm = JOBS[pkg].JobManager(topology=_two_nodes(pkg, clock), clock=clock)
    jm.submit("replicate", [7], collection="c")
    assert jm.claim("a:8080") is None          # already holds it
    t = jm.claim("b:8080")
    assert t["source"] == "a:8080"


# -- -config -----------------------------------------------------------------


def test_jobs_and_scrub_sections_apply_alike(tmp_path):
    """``[jobs] enabled`` and ``[storage.scrub] rate_bytes_per_second``
    set both packages' module state alike; the port's volume server
    ``-config`` returns ``[jobs] poll_seconds`` for its worker."""
    from seaweedfs_tpu_torch.cluster import volume_server
    from seaweedfs_tpu_torch.util import config as config_mod

    conf_path = tmp_path / "v.toml"
    conf_path.write_text("[jobs]\nenabled = false\npoll_seconds = 0.2\n\n"
                         "[storage.scrub]\nrate_bytes_per_second = 1234\n")
    conf = config_mod.load(conf_path)
    try:
        jax_jobs.configure_from(conf)
        jax_scrubber.configure_from(conf)
        kw = volume_server.apply_config(conf)
        assert kw == {"secret": "", "job_poll_seconds": 0.2}
        assert jobs.enabled() is jax_jobs.enabled() is False
        assert scrubber.configured_rate() == \
            jax_scrubber.configured_rate() == 1234
        assert scrubber.debug_payload() == jax_scrubber.debug_payload()
        # RatePacer(None) takes the configured rate, as JAX's does
        assert scrubber.RatePacer(None).rate == \
            jax_scrubber.RatePacer(None).rate == 1234
        assert scrubber.RatePacer(0).rate == 0
    finally:
        for mod in (jax_scrubber, scrubber):
            mod.configure(rate_bytes_per_second=8 * 1024 * 1024)
        for mod in JOBS.values():
            mod.configure(enabled=True)


def test_master_config_applies_lease_and_attempts(tmp_path):
    from seaweedfs_tpu_torch.util import config as config_mod

    conf_path = tmp_path / "m.toml"
    conf_path.write_text("[jobs]\nlease_seconds = 2.5\nmax_attempts = 5\n")
    conf = config_mod.load(conf_path)
    ms = master.MasterServer(port=1)
    master.apply_config(conf)
    master.configure_master(ms, conf)
    assert (ms.jobs.lease_seconds, ms.jobs.max_attempts) == (2.5, 5)


#: The ``[jobs]`` keys the policy engine reads (JAX ``jobs.py:645-676``).
POLICY_KEYS = ("policy", "policy_interval_seconds",
               "cold_read_ops_per_second", "full_fraction",
               "hot_read_ops_per_second", "cool_read_ops_per_second",
               "warm_cache_hit_ratio", "max_replicas", "cooldown_seconds",
               "max_actions_per_tick")


@pytest.mark.parametrize("key", POLICY_KEYS)
def test_master_refuses_policy_keys(tmp_path, key):
    """Each policy-engine key of ``[jobs]`` in a master ``-config`` is
    no longer refused: it reaches the master's engine, whose payload
    equals the JAX engine's configured from the same file."""
    from seaweedfs_tpu.util import config as jax_config
    from seaweedfs_tpu_torch.util import config as config_mod

    value = {"cool_read_ops_per_second": 1,
             "hot_read_ops_per_second": 70}.get(key, 7)
    conf_path = tmp_path / "m.toml"
    conf_path.write_text(f"[jobs]\nlease_seconds = 3\n{key} = {value}\n")
    conf = config_mod.load(conf_path)
    ms = master.MasterServer(port=1)
    master.apply_config(conf)
    master.configure_master(ms, conf)
    want = jax_jobs.PolicyEngine().configure(
        jax_config.load(conf_path)["jobs"]).payload()
    assert ms.policy.payload() == want
    assert ms.policy.payload() != jobs.PolicyEngine().payload()
    assert ms.jobs.lease_seconds == 3.0


def test_policy_payload_is_a_disarmed_jax_engine():
    """An unconfigured engine's payload is a disarmed JAX engine's (its
    defaults, no tick, no action), and the same section moves both
    payloads alike; an inverted hysteresis band
    is refused by both, and by the master's ``-config`` with exit 2."""
    assert jobs.PolicyEngine().payload() == \
        jax_jobs.PolicyEngine().payload()
    for key in POLICY_KEYS:
        sec = {key: {"cool_read_ops_per_second": 1,
                     "hot_read_ops_per_second": 70}.get(key, 7)}
        got = jobs.PolicyEngine().configure(sec).payload()
        assert got == jax_jobs.PolicyEngine().configure(sec).payload()
        assert got != jobs.PolicyEngine().payload(), key
    bad = {"hot_read_ops_per_second": 1.0, "cool_read_ops_per_second": 5.0}
    for mod in JOBS.values():
        with pytest.raises(ValueError, match="hysteresis band"):
            mod.PolicyEngine().configure(bad)
    with pytest.raises(ValueError, match="hysteresis band"):
        master.apply_config({"jobs": bad})
    assert jobs.KINDS == jax_jobs.KINDS
    assert jobs.MUTATING_KINDS == jax_jobs.MUTATING_KINDS


# -- JAX tests/test_jobs.py:200-315: PolicyEngine, held to the JAX engine --


def _policy(pkg, clock, jm=None):
    pe = JOBS[pkg].PolicyEngine(jobs=jm, clock=clock)
    pe.configure({"policy": True, "hot_read_ops_per_second": 10.0,
                  "cool_read_ops_per_second": 1.0,
                  "cooldown_seconds": 60.0, "max_replicas": 3})
    return pe


def _row(rate, replicas=1, **kw):
    row = {"volume_id": 5, "collection": "c", "size": 100,
           "read_only": False, "replicas": replicas, "placement": "000",
           "read_rate": rate, "is_ec": False, "limit": 10_000}
    row.update(kw)
    return row


def _decide(script, conf=None, active=()):
    """Run ``script`` — a list of (seconds to advance, rows) — through
    both packages' engines on equal fake clocks; returns the port's
    decisions after asserting they equal JAX's, step by step (times,
    actions, rates, the actions ring and the per-action counters)."""
    out = {}
    for pkg in JOBS:
        clock = FakeClock()
        jm = None
        if active:
            jm = JOBS[pkg].JobManager(clock=clock)
            jm.submit("replicate", list(active))
        pe = _policy(pkg, clock, jm)
        if conf:
            pe.configure(conf)
        steps = []
        for advance, rows in script:
            clock.t += advance
            steps.append(pe.evaluate(rows))
        out[pkg] = (steps, list(pe.actions), pe.payload())
    assert out["port"] == out["jax"]
    return [[a["action"] for a in acts] for acts in out["port"][0]], \
        out["port"][0]


def test_policy_no_flapping_inside_hysteresis_band():
    names, _ = _decide([(120.0, [_row(9.5 if i % 2 else 1.5,
                                      replicas=1 + i % 2)])
                        for i in range(20)])
    assert names == [[]] * 20


def test_policy_grow_then_shrink_with_cooldown():
    names, _ = _decide([
        (0.0, [_row(50.0, replicas=1)]),     # hot -> grow
        (0.0, [_row(50.0, replicas=1)]),     # cooldown
        (61.0, [_row(50.0, replicas=3)]),    # at max_replicas
        (61.0, [_row(5.0, replicas=2)]),     # mid-band: no shrink
        (0.0, [_row(0.2, replicas=2)]),      # cold: shrink
        (61.0, [_row(0.2, replicas=1)])])    # never below placement
    assert names == [["replicate"], [], [], [], ["replica_drop"], []]


def test_policy_cold_full_volume_goes_to_ec():
    names, _ = _decide([
        (0.0, [_row(0.0, read_only=True)]),
        (61.0, [_row(0.0, read_only=True, is_ec=True)]),
        (61.0, [_row(50.0, read_only=True, replicas=3)]),
        # size past full_fraction of the limit counts as full too
        (61.0, [_row(0.0, size=9_500)])])
    assert names == [["ec_encode"], [], [], ["ec_encode"]]


def test_policy_skips_volumes_with_active_jobs():
    names, _ = _decide([(0.0, [_row(50.0, replicas=1)])], active=[5])
    assert names == [[]]


def test_policy_cache_warmth_blocks_seal_and_shrink():
    names, acts = _decide([
        (0.0, [_row(0.0, read_only=True, cache_warmth=0.9)]),
        (61.0, [_row(0.2, replicas=2, cache_warmth=0.9)]),
        (61.0, [_row(0.2, replicas=2, cache_warmth=0.3)])],
        conf={"warm_cache_hit_ratio": 0.5})
    assert names == [[], [], ["replica_drop"]]
    assert acts[2][0]["cacheWarmth"] == 0.3


def test_policy_cache_warmth_lowers_replicate_threshold():
    names, _ = _decide([
        (0.0, [_row(5.0, replicas=1, cache_warmth=0.0)]),
        (0.0, [_row(5.0, replicas=1, cache_warmth=0.9)]),
        (61.0, [_row(5.0, replicas=3, cache_warmth=0.9)])],
        conf={"warm_cache_hit_ratio": 0.5})
    assert names == [[], ["replicate"], []]


def test_policy_payload_reports_warmth_threshold():
    got = {}
    for pkg in JOBS:
        pe = _policy(pkg, FakeClock())
        pe.configure({"warm_cache_hit_ratio": 0.42})
        got[pkg] = pe.payload()
    assert got["port"] == got["jax"]
    assert got["port"]["thresholds"]["warm_cache_hit_ratio"] == 0.42


def test_policy_rejects_inverted_hysteresis_band():
    for mod in JOBS.values():
        with pytest.raises(ValueError):
            mod.PolicyEngine().configure({"hot_read_ops_per_second": 1.0,
                                          "cool_read_ops_per_second": 5.0})
