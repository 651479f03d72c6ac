"""The port's per-tenant QoS (``util/httpserver.py``: ``TokenBucket``,
``QosClass``, ``QosEngine``, ``QosLease``, ``qos_from_conf`` and the
admission gate's deferral to QoS) against the JAX package's, on the CPU.

The QoS cases of ``tests/test_ingress.py`` (its token-bucket and QoS
engine units and ``test_admission_defers_pressure_to_qos``) run on both
packages with the same expectations; one more holds both engines to
equal decisions, retry-after hints and payloads over one seeded script
of admissions and releases on a fake clock."""

import numpy as np
import pytest

from seaweedfs_tpu.util import config as jax_config
from seaweedfs_tpu.util import httpserver as jax_httpserver
from seaweedfs_tpu_torch.util import config, httpserver
from torch_teardown import collect_jax_garbage  # noqa: F401

PKG = {"jax": jax_httpserver, "port": httpserver}


@pytest.fixture(params=sorted(PKG))
def hs(request):
    return PKG[request.param]


def _engine(hs, **kw):
    classes = {
        "gold": hs.QosClass("gold", priority=0),
        "standard": hs.QosClass("standard", priority=1),
        "bronze": hs.QosClass("bronze", priority=2),
    }
    tenants = {"alice": "gold", "bob": "standard", "mallory": "bronze"}
    return hs.QosEngine(classes=classes, tenants=tenants,
                        default_class="standard", watermark=0.75, **kw)


def test_token_bucket_refill(hs):
    now = [100.0]
    b = hs.TokenBucket(rate=2.0, burst=4.0, clock=lambda: now[0])
    assert [b.take() for _ in range(4)] == [0.0] * 4
    assert b.take() == pytest.approx(0.5)
    now[0] += 0.5
    assert b.take() == 0.0
    assert b.take() > 0.0
    now[0] += 1000.0
    assert [b.take() for _ in range(4)] == [0.0] * 4
    assert b.take() > 0.0


def test_token_bucket_zero_rate_never_grants_after_burst(hs):
    now = [0.0]
    b = hs.TokenBucket(rate=0.0, burst=2.0, clock=lambda: now[0])
    assert b.take() == 0.0 and b.take() == 0.0
    now[0] += 1e6
    assert b.take() > 0.0


def test_qos_priority_ladder(hs):
    q = _engine(hs)
    assert q.shed_threshold(q.class_of("alice")) == float("inf")
    assert q.shed_threshold(q.class_of("bob")) == pytest.approx(0.75)
    assert q.shed_threshold(q.class_of("mallory")) == \
        pytest.approx(0.75 ** 2)
    q.admit("alice", pressure=0.6).release()
    q.admit("bob", pressure=0.6).release()
    with pytest.raises(hs.QosShed) as ei:
        q.admit("mallory", pressure=0.6)
    assert ei.value.reason == "pressure"
    assert ei.value.class_name == "bronze"
    with pytest.raises(hs.QosShed):
        q.admit("bob", pressure=0.8)
    q.admit("alice", pressure=1.0).release()


def test_qos_unknown_tenant_gets_default_class(hs):
    assert _engine(hs).class_of("stranger").name == "standard"


def test_qos_rate_limit_and_retry_after(hs):
    now = [0.0]
    q = hs.QosEngine(classes={"c": hs.QosClass("c", priority=1, rate=1.0,
                                               burst=2.0)},
                     tenants={"t": "c"}, default_class="c",
                     clock=lambda: now[0])
    q.admit("t").release()
    q.admit("t").release()
    with pytest.raises(hs.QosShed) as ei:
        q.admit("t")
    assert ei.value.reason == "rate"
    assert ei.value.retry_after >= 1.0
    now[0] += 1.0
    q.admit("t").release()


def test_qos_concurrency_cap_and_lease_release(hs):
    q = hs.QosEngine(classes={"c": hs.QosClass("c", concurrency=2)},
                     tenants={"t": "c"}, default_class="c")
    l1 = q.admit("t")
    l2 = q.admit("t")
    with pytest.raises(hs.QosShed) as ei:
        q.admit("t")
    assert ei.value.reason == "concurrency"
    l1.release()
    l1.release()  # idempotent: must not free a second slot
    l3 = q.admit("t")
    with pytest.raises(hs.QosShed):
        q.admit("t")
    l2.release()
    with l3:
        pass
    assert q.payload()["inflight"] == {}


def test_qos_from_conf_roundtrip(hs):
    conf = {"qos": {
        "enabled": True, "default_class": "std", "watermark": 0.5,
        "class": {
            "gold": {"priority": 0},
            "std": {"priority": 1, "rate_per_second": 10,
                    "burst": 20, "concurrency": 8},
        },
        "tenant": {"alice": "gold"},
    }}
    q = hs.qos_from_conf(conf)
    assert q is not None
    assert q.class_of("alice").priority == 0
    std = q.class_of("anyone")
    assert (std.name, std.rate, std.burst, std.concurrency) == \
        ("std", 10.0, 20.0, 8)
    assert q.watermark == 0.5
    assert hs.qos_from_conf({"qos": {"enabled": False}}) is None
    assert hs.qos_from_conf({}) is None


def test_qos_scaffold_builds_equal_engines(tmp_path):
    """The ``[qos]`` scaffold (byte-equal in both packages) loads into
    engines with equal payloads."""
    path = tmp_path / "qos.toml"
    path.write_text(config.scaffold("qos"))
    assert config.scaffold("qos") == jax_config.scaffold("qos")
    port = httpserver.qos_from_conf(config.load(path))
    ref = jax_httpserver.qos_from_conf(jax_config.load(path))
    assert port.payload() == ref.payload()


class _StubServer:
    def __init__(self, hs, pressure=0.0, qos=None, **cfg):
        self.config = hs.IngressConfig(**cfg)
        self.qos = qos
        self._pressure = pressure
        self.admission = hs.AdmissionController(self)

    def pressure(self):
        return self._pressure


class _StubHandler:
    def __init__(self, path="/x", headers=None):
        self.path = path
        self.headers = headers or {}


def test_admission_defers_pressure_to_qos(hs):
    srv = _StubServer(hs, pressure=1.0, qos=hs.QosEngine())
    assert srv.admission.check(_StubHandler()) is None
    dec = srv.admission.check(_StubHandler(
        headers={hs.DEADLINE_HEADER: "0"}))
    assert dec is not None and dec[0] == 504
    # without an engine the same pressure sheds before auth
    dec = _StubServer(hs, pressure=1.0).admission.check(_StubHandler())
    assert dec is not None and dec[:2] == (429, "pressure")


def test_engines_decide_alike_over_one_seeded_script():
    """Admissions at seeded pressures, lease releases and clock steps:
    every decision (admitted, or the shed reason and retry-after) and
    the final payload equal between the packages."""
    rng = np.random.default_rng(13)
    clocks = {name: [0.0] for name in PKG}
    engines = {}
    for name, hs in PKG.items():
        clock = clocks[name]
        engines[name] = hs.QosEngine(
            classes={"gold": hs.QosClass("gold", priority=0,
                                         concurrency=3),
                     "std": hs.QosClass("std", priority=1, rate=5.0,
                                        burst=3.0),
                     "bronze": hs.QosClass("bronze", priority=2,
                                           rate=2.0, concurrency=2)},
            tenants={"a": "gold", "b": "std", "c": "bronze"},
            default_class="std", watermark=0.7,
            clock=lambda clock=clock: clock[0])
    leases = {name: [] for name in PKG}
    for step in range(600):
        tenant = "abcd"[int(rng.integers(0, 4))]
        pressure = float(rng.random())
        dt = float(rng.exponential(0.1))
        release = rng.random() < 0.4
        got = {}
        for name, hs in PKG.items():
            clocks[name][0] += dt
            if release and leases[name]:
                leases[name].pop(0).release()
            try:
                leases[name].append(engines[name].admit(tenant, pressure))
                got[name] = "admitted"
            except hs.QosShed as e:
                got[name] = (e.reason, e.class_name, e.retry_after)
        assert got["port"] == got["jax"], step
    assert engines["port"].payload() == engines["jax"].payload()
