"""The port's wire utilities against the JAX package's, on the CPU, with
no servers: the ``pb`` descriptors and method tables, JWT and gRPC
tokens signed in one package and verified in the other, ``parse_range``,
the circuit breaker and ``http_request`` retries against a local flaky
HTTP server, the durability policies and every ``configure_from`` the
volume server's ``-config`` applies. Tolerance 0: each result must be
equal."""

import http.server
import os
import threading
import urllib.error

import pytest

from seaweedfs_tpu import pb as jax_pb
from seaweedfs_tpu.util import durability as jax_durability
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu.util import httpserver as jax_httpserver
from seaweedfs_tpu.util import retry as jax_retry
from seaweedfs_tpu.util import security as jax_security
from seaweedfs_tpu.util import tls as jax_tls
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.util import (durability, faults, httpserver, retry,
                                      security, tls)
from torch_teardown import collect_jax_garbage  # noqa: F401

PKGS = {"jax": dict(pb=jax_pb, security=jax_security, retry=jax_retry,
                    durability=jax_durability,
                    faults=jax_faults, httpserver=jax_httpserver,
                    tls=jax_tls),
        "port": dict(pb=pb, security=security, retry=retry,
                     durability=durability,
                     faults=faults, httpserver=httpserver, tls=tls)}


# -- pb -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["master_pb2", "volume_server_pb2",
                                  "filer_pb2"])
def test_pb_descriptors_equal_jax(name):
    """The copies serialize the same file descriptors, byte for byte (so
    both packages share the default pool's messages), and the port's
    modules are its own."""
    jax_mod, port_mod = getattr(jax_pb, name), getattr(pb, name)
    assert port_mod is not jax_mod
    assert port_mod.__name__ == f"seaweedfs_tpu_torch.pb.{name}"
    assert (port_mod.DESCRIPTOR.serialized_pb
            == jax_mod.DESCRIPTOR.serialized_pb)


@pytest.mark.parametrize("table", ["MASTER", "VOLUME", "FILER"])
def test_method_tables_equal_jax(table):
    def rows(mod):
        return [(m.name, m.kind, m.request_cls.DESCRIPTOR.full_name,
                 m.response_cls.DESCRIPTOR.full_name)
                for m in getattr(mod, f"{table}_METHODS")]
    assert rows(pb) == rows(jax_pb)
    assert getattr(pb, f"{table}_SERVICE") == \
        getattr(jax_pb, f"{table}_SERVICE")


def test_messages_cross_the_wire_both_ways():
    """A heartbeat serialized by one package parses in the other into an
    equal message."""
    hb = pb.master_pb2.Heartbeat(ip="127.0.0.1", port=8080,
                                 max_volume_count=8, max_file_key=99)
    hb.volumes.add(id=3, collection="c", size=1234, file_count=5,
                   replica_placement=1, version=3)
    hb.ec_shards.add(id=4, collection="", ec_index_bits=0b1011)
    back = jax_pb.master_pb2.Heartbeat.FromString(hb.SerializeToString())
    assert back.SerializeToString() == hb.SerializeToString()
    assert pb.master_pb2.Heartbeat.FromString(
        back.SerializeToString()) == hb


# -- security -----------------------------------------------------------------


@pytest.mark.parametrize("signer,verifier", [("jax", "port"),
                                             ("port", "jax")])
def test_tokens_verify_across_packages(signer, verifier):
    s = PKGS[signer]["security"]
    v = PKGS[verifier]["security"]
    sg, vg = s.Guard("k3y", expires_seconds=30), v.Guard("k3y")
    tok = sg.sign("3,01637037d6")
    assert v.Guard("k3y").verify(tok, "3,01637037d6")
    assert not vg.verify(tok, "3,01637037d7")          # another fid
    assert not v.Guard("other").verify(tok, "3,01637037d6")
    assert not vg.verify(tok[:-2] + "AA", "3,01637037d6")
    gt = s.grpc_sign(sg)
    assert v.grpc_verify(vg, gt)
    assert not v.grpc_verify(v.Guard("other"), gt)
    assert not v.grpc_verify(vg, tok)                  # a fid token
    # auth off: everything passes, nothing is signed
    assert s.Guard("").sign("x") == "" and v.Guard("").verify("", "x")


# -- httpserver.parse_range ---------------------------------------------------


@pytest.mark.parametrize("header", [
    None, "", "bytes=0-0", "bytes=0-9", "bytes=2-4", "bytes=5-", "bytes=-3",
    "bytes=-0", "bytes=-100", "bytes=9-9", "bytes=10-", "bytes=10-20",
    "bytes=4-2", "bytes=0-99", "bytes=a-b", "bytes=1-2,4-5", "bytes=3",
    "items=0-3", "bytes= 1-3 ", "bytes=-"])
@pytest.mark.parametrize("size", [0, 1, 10])
def test_parse_range_matches_jax(header, size):
    assert (httpserver.parse_range(header, size)
            == jax_httpserver.parse_range(header, size))


# -- retry: breaker and http_request ------------------------------------------


def test_circuit_breaker_state_sequences_match_jax(monkeypatch):
    """The same outcomes on the same clock walk both breakers through
    the same states: open after 3 failures, half-open after the
    cooldown with one probe, reopen, close."""
    steps = ["fail", "fail", "allow", "fail", "allow", "tick", "allow",
             "allow", "fail", "allow", "tick", "allow", "ok", "allow",
             "fail", "ok", "fail", "fail", "allow"]
    seqs = {}
    for name, mods in PKGS.items():
        r = mods["retry"]
        clock = [1000.0]
        monkeypatch.setattr(r.time, "monotonic", lambda c=clock: c[0])
        b = r.CircuitBreaker(f"h-{name}:1", threshold=3, cooldown=5.0)
        seq = []
        for s in steps:
            if s == "fail":
                b.record_failure()
            elif s == "ok":
                b.record_success()
            elif s == "tick":
                clock[0] += 5.0
            else:
                seq.append(b.allow())
            d = b.to_dict()
            seq.append((d["state"], d["consecutive_failures"],
                        d["open_count"]))
        monkeypatch.undo()
        seqs[name] = seq
    assert seqs["port"] == seqs["jax"]
    assert ("open", 3, 1) in seqs["port"] and ("closed", 0, 2) in seqs["port"]


class _Flaky(http.server.BaseHTTPRequestHandler):
    """``/flaky/N``: 503 for the first N requests of the path, then 200;
    ``/gone``: always 404."""
    protocol_version = "HTTP/1.1"
    seen: dict = {}
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def do_GET(self):
        with self.lock:
            n = self.seen[self.path] = self.seen.get(self.path, 0) + 1
        if self.path.startswith("/flaky/"):
            fails = int(self.path.split("?")[0].rsplit("/", 1)[1])
            code = 503 if n <= fails else 200
        else:
            code = 404
        body = f"{code} after {n}".encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def flaky_server():
    _Flaky.seen = {}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Flaky)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture()
def clean_retry():
    for mods in PKGS.values():
        mods["retry"].reset_breakers()
        mods["retry"].close_pool()
    yield
    for mods in PKGS.values():
        mods["retry"].reset_breakers()
        mods["retry"].close_pool()


def test_http_request_retries_match_jax(flaky_server, clean_retry):
    """Against one flaky server: two 503s then a 200 (three requests,
    two retries), a 404 raised at once (one request, the breaker stays
    closed), a dead endpoint that opens the breaker; each the same in
    both packages."""
    got = {}
    for name, mods in PKGS.items():
        r = mods["retry"]
        pol = r.RetryPolicy(max_attempts=4, base_delay=0.0, max_delay=0.0,
                            timeout=5.0, breaker_threshold=2)
        resp = r.http_request(f"http://{flaky_server}/flaky/2?p={name}",
                              retry_policy=pol)
        out = [resp.status, resp.data]
        with pytest.raises(urllib.error.HTTPError) as e:
            r.http_request(f"http://{flaky_server}/gone?p={name}",
                           retry_policy=pol)
        out.append(e.value.code)
        out.append(r.breaker_for(flaky_server).to_dict()["state"])
        # a dead port: refused twice opens the breaker (threshold 2),
        # the next attempt fails fast
        dead = f"127.0.0.1:1/{name}"
        brk = r.breaker_for("127.0.0.1:1")
        brk.threshold = 2
        with pytest.raises(r.BreakerOpenError):
            r.http_request(f"http://{dead}", retry_policy=pol)
        out.append(brk.to_dict()["state"])
        out.append(sorted((k.split("?")[0], v)
                          for k, v in _Flaky.seen.items()
                          if k.endswith(f"p={name}")))
        r.reset_breakers()
        got[name] = out
    assert got["port"] == got["jax"]
    assert got["port"][:5] == [200, b"200 after 3", 404, "closed", "open"]
    assert got["port"][5] == [("/flaky/2", 3), ("/gone", 1)]


def test_deadline_scope_and_inject_match_jax():
    for mods in PKGS.values():
        r = mods["retry"]
        with r.deadline_scope(30.0) as dl:
            assert r.current_deadline() is dl
            h = r.inject({})
            assert 29.0 < float(h[r.DEADLINE_HEADER]) <= 30.0
        assert r.current_deadline() is None
        assert r.deadline_from_headers({r.DEADLINE_HEADER: "bad"}) is None


# -- configure_from of every section the volume server applies ---------------


@pytest.fixture()
def restore_globals():
    saved = []
    for mods in PKGS.values():
        r = mods["retry"]
        saved.append((r, {k: getattr(r.policy(), k)
                          for k in r.RetryPolicy.__slots__},
                      (r.pool().max_idle_per_host, r.pool().idle_seconds)))
        h = mods["httpserver"]
        saved.append((h, h.default_config().to_dict(), h._ENABLED))
    yield
    for mods in PKGS.values():
        mods["durability"].configure(mode="commit", batch_bytes=8 << 20,
                                     batch_seconds=1.0)
        mods["faults"].clear()
        mods["faults"].configure(enabled=True, seed=0)
    for item in saved:
        mod = item[0]
        if mod in (jax_retry, retry):
            mod.configure(**item[1])
            mod.pool().max_idle_per_host, mod.pool().idle_seconds = item[2]
        else:
            mod.configure(enabled=item[2], **item[1])
    # the JAX conftest's autouse fixture runs the JAX package "off"
    jax_durability.configure(mode="off")


CONF = {
    "storage": {"fsync": "batch", "fsync_batch_bytes": 4096,
                "fsync_batch_seconds": 60.0},
    "retry": {"max_attempts": 7, "base_delay_seconds": 0.01,
              "max_delay_seconds": 0.5, "request_timeout_seconds": 12.0,
              "failover_budget_seconds": 3.0,
              "breaker": {"failure_threshold": 9, "cooldown_seconds": 2.5},
              "pool": {"max_idle_per_host": 2, "idle_seconds": 7.0}},
    "faults": {"enabled": True, "seed": 11,
               "inject": "volume.read=delay:0.001#2;replica.push=error@0.5"},
    "ingress": {"workers": 4, "queue_depth": 16, "shed_watermark": 0.5,
                "request_read_timeout_seconds": 9.0},
}


def test_configure_from_matches_jax(restore_globals):
    """One TOML dict through both packages' ``configure_from``: the
    same fsync policy, retry policy and pool, armed faults and ingress
    defaults."""
    got = {}
    for name, mods in PKGS.items():
        d, r, f, h = (mods[k] for k in ("durability", "retry", "faults",
                                        "httpserver"))
        d.configure_from(CONF)
        r.configure_from(CONF)
        f.configure_from(CONF)
        h.configure_from(CONF)
        got[name] = (d.mode(), d._BATCH_BYTES, d._BATCH_SECONDS,
                     {k: getattr(r.policy(), k)
                      for k in r.RetryPolicy.__slots__},
                     r.pool().payload(), f.debug_payload(),
                     h.default_config().to_dict())
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("batch", 4096, 60.0)


def test_durability_modes_and_batch_barriers_match_jax(tmp_path,
                                                       monkeypatch,
                                                       restore_globals):
    """Each mode's barriers fsync the same number of times for the same
    writes; an unknown mode is refused by both."""
    assert durability.MODES == jax_durability.MODES
    counts = {}
    for name, mods in PKGS.items():
        d = mods["durability"]
        for mode in d.MODES:
            d.configure(mode=mode, batch_bytes=1000, batch_seconds=3600)
            n = [0]
            monkeypatch.setattr(d.os, "fsync",
                                lambda fd, n=n: n.__setitem__(0, n[0] + 1))
            with open(tmp_path / f"{name}-{mode}", "wb") as fh:
                for nbytes in (300, 300, 300, 300, 50, 900, 1, 2000):
                    fh.write(b"x" * nbytes)
                    d.barrier(fh, nbytes)
            monkeypatch.undo()
            counts[(name, mode)] = n[0]
        with pytest.raises(ValueError, match="unknown fsync mode"):
            d.configure(mode="sometimes")
    assert {m: counts[("port", m)] for m in durability.MODES} == \
        {m: counts[("jax", m)] for m in durability.MODES}
    assert counts[("port", "commit")] == 8 and counts[("port", "off")] == 0
    assert 0 < counts[("port", "batch")] < 8


def test_tls_config_loads_alike(tmp_path):
    """``[grpc.tls]``: a partial section is refused by both, a whole one
    installs the same credentials, an empty one clears them."""
    paths = {k: tmp_path / f"{k}.pem" for k in ("ca", "cert", "key")}
    for k, p in paths.items():
        p.write_bytes(f"-- {k} --".encode())
    try:
        for mods in PKGS.values():
            t = mods["tls"]
            with pytest.raises(ValueError, match="all of ca/cert/key"):
                t.install_from_config({"grpc": {"tls": {
                    "ca": str(paths["ca"])}}})
            assert t.install_from_config({"grpc": {"tls": {
                k: str(p) for k, p in paths.items()}}})
        assert tls.installed().__dict__ == jax_tls.installed().__dict__
        assert tls.installed().cert == b"-- cert --"
    finally:
        for mods in PKGS.values():
            assert not mods["tls"].install_from_config({})
            assert mods["tls"].installed() is None


def test_faults_catalog_is_a_subset_of_jax_in_order():
    assert set(faults.CATALOG) <= set(jax_faults.CATALOG)
    order = [p for p in jax_faults.CATALOG if p in faults.CATALOG]
    assert list(faults.CATALOG) == order
    for p in ("volume.read", "volume.write", "volume.delete",
              "replica.push"):
        assert p in faults.CATALOG


def test_tls_module_loads_without_cryptography():
    """The card machine has no ``cryptography``: the module imports and
    dials without it; only credential generation needs it."""
    import subprocess
    import sys
    probe = ("import sys; sys.modules['cryptography'] = None; "
             "from seaweedfs_tpu_torch.util import tls; "
             "tls.dial('127.0.0.1:1').close(); print('ok')")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.stdout.strip() == "ok", out.stderr


def test_ingress_announces_a_connections_last_request():
    """After ``keepalive_max_requests`` an ingress server closes the
    connection. JAX ``util/httpserver.py`` closes it unannounced, so a
    keep-alive client's next request on it fails; the port's last
    response says ``Connection: close`` and the client reconnects."""
    import http.client

    class Echo(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            body = self.path.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    got = {}
    for name, mods in PKGS.items():
        h = mods["httpserver"]
        srv = h.IngressHTTPServer(
            ("127.0.0.1", 0), Echo, component="wire-test",
            config=h.IngressConfig(workers=2, keepalive_max_requests=3))
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=10)
        out = []
        try:
            for i in range(5):
                conn.request("GET", f"/{i}")
                r = conn.getresponse()
                out.append((r.read(), r.getheader("Connection")))
        except (http.client.HTTPException, OSError) as e:
            out.append(type(e).__name__)
        finally:
            conn.close()
            srv.shutdown()
            srv.server_close()
        got[name] = out
    assert got["port"] == [(b"/0", None), (b"/1", None), (b"/2", "close"),
                           (b"/3", None), (b"/4", None)]
    assert got["jax"][:3] == [(b"/0", None), (b"/1", None), (b"/2", None)]
    assert isinstance(got["jax"][3], str)        # the reference's fault
