"""The port's S3 gateway (``gateway/s3.py``, ``gateway/s3_auth.py``)
against the JAX package's, on the CPU.

Every case of ``tests/test_s3_gateway.py`` runs on three stacks, each
beside a reference stack (the JAX gateway over a JAX filer on a JAX
cluster) that takes the same requests: the port's gateway over a port
filer and cluster (``port``), the port's gateway over a JAX filer and
cluster (``port_on_jax``), and the JAX gateway over the port's filer and
cluster (``jax_on_port``). Every response's status code must equal the
reference's, every XML body must equal it with the fields that name a
time, a chunk id or an upload id masked, and every object must read back
sha256-equal. Port servers run ``device="cpu"``."""

import hashlib
import io
import json
import time
import urllib.error
import urllib.request
import xml.etree.ElementTree as ET
from collections import namedtuple

import numpy as np
import pytest

from seaweedfs_tpu.cache import readahead as jax_readahead
from seaweedfs_tpu.cluster import filer_client as jax_filer_client
from seaweedfs_tpu.cluster import filer_server as jax_filer_server
from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.gateway import s3 as jax_s3
from seaweedfs_tpu.gateway import s3_auth as jax_s3_auth
from seaweedfs_tpu.shell import cluster_commands as jax_cluster_commands
from seaweedfs_tpu.shell import fs_commands as jax_fs_commands
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu_torch.cache import readahead
from seaweedfs_tpu_torch.cluster import filer_client, filer_server
from seaweedfs_tpu_torch.cluster import master, volume_server
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.gateway import s3, s3_auth
from seaweedfs_tpu_torch.shell import cluster_commands, fs_commands
from seaweedfs_tpu_torch.storage import store

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
#: package -> the modules a stack of that package is built from
PKG = {
    "jax": dict(master=jax_master, vs=jax_volume_server, store=jax_store,
                filer_server=jax_filer_server, filer=JaxFiler, s3=jax_s3,
                auth=jax_s3_auth, fc=jax_filer_client,
                shell=jax_cluster_commands, fs=jax_fs_commands,
                readahead=jax_readahead),
    "port": dict(master=master, vs=volume_server, store=store,
                 filer_server=filer_server, filer=Filer, s3=s3,
                 auth=s3_auth, fc=filer_client, shell=cluster_commands,
                 fs=fs_commands, readahead=readahead),
}
#: stack -> (gateway package, filer and cluster package)
STACKS = {"port": ("port", "port"), "port_on_jax": ("port", "jax"),
          "jax_on_port": ("jax", "port")}
#: XML elements whose text names a time, a chunk id or an upload id
MASKED = {"LastModified", "CreationDate", "ETag", "UploadId"}

Resp = namedtuple("Resp", "status headers body")


def _wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _cluster(tmp_path_factory, pkg):
    m = PKG[pkg]
    ms = m["master"].MasterServer(port=_free_port_pair(),
                                  volume_size_limit_mb=64,
                                  pulse_seconds=PULSE, seed=11).start()
    kw = dict(device="cpu") if pkg == "port" else {}
    vs = m["vs"].VolumeServer(
        m["store"].Store([tmp_path_factory.mktemp(f"s3vol_{pkg}")],
                         max_volumes=8),
        port=_free_port_pair(), master_url=ms.url, pulse_seconds=PULSE,
        **kw).start()
    _wait_for(lambda: ms.topology.nodes, what="volume server registration")
    return ms, vs


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {pkg: _cluster(tmp_path_factory, pkg) for pkg in PKG}
    started = []
    yield out, started
    for obj in reversed(started):
        obj.stop()
    for ms, vs in out.values():
        vs.stop()
        ms.stop()


def _gateway(clusters, gw_pkg, filer_pkg, **kw):
    """A fresh filer of ``filer_pkg`` on that package's cluster, and a
    gateway of ``gw_pkg`` over it."""
    out, started = clusters
    fm = PKG[filer_pkg]
    filer = fm["filer_server"].FilerServer(
        fm["filer"](), port=_free_port_pair(),
        master_url=out[filer_pkg][0].url).start()
    started.append(filer)
    gw = PKG[gw_pkg]["s3"].S3Gateway(filer.url, port=_free_port_pair(),
                                     **kw).start()
    started.append(gw)
    return gw


class Pair:
    """One stack under test and its reference stack: every request goes
    to both, and the answers must agree."""

    def __init__(self, name, gw, ref):
        self.name, self.gw, self.ref = name, gw, ref
        self.gw_pkg = STACKS[name][0] if name in STACKS else name

    @staticmethod
    def call(gw, method, path, data=None, headers=None, query="",
             sign=None) -> Resp:
        url = f"http://{gw.url}{path}" + (f"?{query}" if query else "")
        hdrs = dict(headers or {})
        if sign is not None:
            hdrs = jax_s3_auth.sign_request_headers(
                method, url, hdrs, data or b"", *sign)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return Resp(r.status, r.headers, r.read())
        except urllib.error.HTTPError as e:
            return Resp(e.code, e.headers, e.read())

    def req(self, method, path, data=None, headers=None, query="",
            sign=None) -> Resp:
        want = self.call(self.ref, method, path, data, headers, query, sign)
        got = self.call(self.gw, method, path, data, headers, query, sign)
        assert got.status == want.status, (method, path, query, got, want)
        assert _mask(got.body) == _mask(want.body), (method, path, query)
        for h in ("Content-Type", "Content-Range", "Accept-Ranges"):
            assert got.headers.get(h) == want.headers.get(h), h
        if method in ("GET", "HEAD") and got.status in (200, 206) and \
                path.count("/") > 1:
            assert got.headers["Content-Length"] == \
                want.headers["Content-Length"]
        return got


def _mask(body: bytes) -> bytes:
    if not body.startswith(b"<?xml"):
        return body
    root = ET.fromstring(body)
    for el in root.iter():
        if el.tag.split("}")[-1] in MASKED:
            el.text = "*"
    return ET.tostring(root)


@pytest.fixture(scope="module")
def pairs(clusters):
    return {name: Pair(name, _gateway(clusters, *STACKS[name]),
                       _gateway(clusters, "jax", "jax"))
            for name in STACKS}


@pytest.fixture(params=sorted(STACKS))
def pair(request, pairs):
    return pairs[request.param]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# --------------------------------------------------------------------------
# the cases of tests/test_s3_gateway.py
# --------------------------------------------------------------------------

def test_bucket_lifecycle(pair):
    assert pair.req("PUT", "/mybucket").status == 200
    body = pair.req("GET", "/").body
    names = [b.find(f"{NS}Name").text for b in
             ET.fromstring(body).iter(f"{NS}Bucket")]
    assert "mybucket" in names
    assert pair.req("PUT", "/mybucket").status == 409


def test_object_put_get_head_delete(pair):
    pair.req("PUT", "/objbkt")
    payload = _bytes(0, 100_000)
    r = pair.req("PUT", "/objbkt/dir/data.bin", data=payload,
                 headers={"Content-Type": "application/x-test"})
    assert r.status == 200
    assert r.headers["ETag"] == f'"{hashlib.md5(payload).hexdigest()}"'
    r = pair.req("GET", "/objbkt/dir/data.bin")
    assert _sha(r.body) == _sha(payload)
    assert r.headers["Content-Type"] == "application/x-test"
    r = pair.req("HEAD", "/objbkt/dir/data.bin")
    assert int(r.headers["Content-Length"]) == len(payload)
    r = pair.req("GET", "/objbkt/dir/data.bin",
                 headers={"Range": "bytes=10-99"})
    assert r.status == 206 and r.body == payload[10:100]
    assert pair.req("DELETE", "/objbkt/dir/data.bin").status == 204
    assert pair.req("GET", "/objbkt/dir/data.bin").status == 404


def test_list_objects_v2_prefix_delimiter(pair):
    pair.req("PUT", "/listbkt")
    for key in ("a/1.txt", "a/2.txt", "b/3.txt", "top.txt"):
        pair.req("PUT", f"/listbkt/{key}", data=b"x")
    body = pair.req("GET", "/listbkt", query="list-type=2").body
    keys = [c.find(f"{NS}Key").text for c in
            ET.fromstring(body).iter(f"{NS}Contents")]
    assert keys == ["a/1.txt", "a/2.txt", "b/3.txt", "top.txt"]
    root = ET.fromstring(pair.req("GET", "/listbkt",
                                  query="list-type=2&delimiter=/").body)
    assert [c.find(f"{NS}Key").text
            for c in root.iter(f"{NS}Contents")] == ["top.txt"]
    assert [c.find(f"{NS}Prefix").text
            for c in root.iter(f"{NS}CommonPrefixes")] == ["a/", "b/"]
    body = pair.req("GET", "/listbkt", query="list-type=2&prefix=a/").body
    assert [c.find(f"{NS}Key").text for c in
            ET.fromstring(body).iter(f"{NS}Contents")] == \
        ["a/1.txt", "a/2.txt"]
    # ListObjects V1 with a marker, and max-keys=0
    body = pair.req("GET", "/listbkt", query="marker=a/2.txt").body
    assert [c.find(f"{NS}Key").text for c in
            ET.fromstring(body).iter(f"{NS}Contents")] == \
        ["b/3.txt", "top.txt"]
    root = ET.fromstring(pair.req("GET", "/listbkt",
                                  query="list-type=2&max-keys=0").body)
    assert root.find(f"{NS}IsTruncated").text == "false"


def test_copy_object(pair):
    pair.req("PUT", "/cpbkt")
    pair.req("PUT", "/cpbkt/src.bin", data=b"copy me")
    r = pair.req("PUT", "/cpbkt/dst.bin",
                 headers={"x-amz-copy-source": "/cpbkt/src.bin"})
    assert r.status == 200
    assert pair.req("GET", "/cpbkt/dst.bin").body == b"copy me"


def test_multipart_upload(pair):
    pair.req("PUT", "/mpbkt")
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
             for _ in range(3)]
    ids = {}
    for who, gw in (("ref", pair.ref), ("gw", pair.gw)):
        body = Pair.call(gw, "POST", "/mpbkt/big/file.bin",
                         query="uploads").body
        ids[who] = ET.fromstring(body).find(f"{NS}UploadId").text
    assert ids["ref"] != ids["gw"]
    for i, part in enumerate(parts, start=1):
        for who, gw in (("ref", pair.ref), ("gw", pair.gw)):
            r = Pair.call(gw, "PUT", "/mpbkt/big/file.bin", data=part,
                          query=f"partNumber={i}&uploadId={ids[who]}")
            assert r.status == 200
            assert r.headers["ETag"] == \
                f'"{hashlib.md5(part).hexdigest()}"'
    bodies = {who: Pair.call(gw, "POST", "/mpbkt/big/file.bin",
                             query=f"uploadId={ids[who]}").body
              for who, gw in (("ref", pair.ref), ("gw", pair.gw))}
    # the multipart ETag is md5(size)-parts: equal, not masked
    assert bodies["gw"] == bodies["ref"]
    assert ET.fromstring(bodies["gw"]).find(f"{NS}Key").text == \
        "big/file.bin"
    got = pair.req("GET", "/mpbkt/big/file.bin").body
    assert _sha(got) == _sha(b"".join(parts))
    # an unknown upload id: NoSuchUpload from both
    assert pair.req("POST", "/mpbkt/big/file.bin",
                    query="uploadId=nope").status == 404


def _auth_pair(clusters, name, idents_jax, idents_port):
    gw_pkg, filer_pkg = STACKS[name]
    idents = idents_port if gw_pkg == "port" else idents_jax
    return Pair(name,
                _gateway(clusters, gw_pkg, filer_pkg, identities=idents),
                _gateway(clusters, "jax", "jax", identities=idents_jax))


@pytest.mark.parametrize("name", sorted(STACKS))
def test_sigv4_auth(clusters, name):
    """Auth-enabled gateway accepts correctly signed requests only."""
    p = _auth_pair(clusters, name,
                   [jax_s3_auth.Identity("admin", "AK123", "SK456")],
                   [s3_auth.Identity("admin", "AK123", "SK456")])
    assert p.req("PUT", "/secure").status == 403
    assert p.req("PUT", "/secure", sign=("AK123", "SK456")).status == 200
    assert p.req("PUT", "/nope", sign=("AK123", "WRONG")).status == 403
    # the port's signer signs for the JAX verifier and back
    url = f"http://{p.gw.url}/secure/o.txt"
    hdrs = s3_auth.sign_request_headers("PUT", url, {}, b"o", "AK123",
                                        "SK456")
    assert Pair.call(p.gw, "PUT", "/secure/o.txt", data=b"o",
                     headers=hdrs).status == 200
    url = f"http://{p.ref.url}/secure/o.txt"
    hdrs = s3_auth.sign_request_headers("PUT", url, {}, b"o", "AK123",
                                        "SK456")
    assert Pair.call(p.ref, "PUT", "/secure/o.txt", data=b"o",
                     headers=hdrs).status == 200
    assert p.req("GET", "/secure/o.txt", sign=("AK123", "SK456")).body \
        == b"o"


def test_copy_survives_source_delete(pair):
    """CopyObject materializes the bytes: deleting (or overwriting) the
    source must not corrupt the copy."""
    pair.req("PUT", "/cpbkt2")
    payload = _bytes(5, 9 * 1024 * 1024)  # multi-chunk
    pair.req("PUT", "/cpbkt2/src.bin", data=payload)
    r = pair.req("PUT", "/cpbkt2/dst.bin",
                 headers={"x-amz-copy-source": "/cpbkt2/src.bin"})
    assert r.status == 200
    pair.req("DELETE", "/cpbkt2/src.bin")
    assert _sha(pair.req("GET", "/cpbkt2/dst.bin").body) == _sha(payload)
    pair.req("PUT", "/cpbkt2/src2.bin", data=b"fresh")
    pair.req("PUT", "/cpbkt2/dst2.bin",
             headers={"x-amz-copy-source": "/cpbkt2/src2.bin"})
    pair.req("PUT", "/cpbkt2/src2.bin", data=b"overwritten")
    assert pair.req("GET", "/cpbkt2/dst2.bin").body == b"fresh"


def test_range_validation(pair):
    pair.req("PUT", "/rngbkt")
    pair.req("PUT", "/rngbkt/o.bin", data=b"x" * 100)
    assert pair.req("GET", "/rngbkt/o.bin",
                    headers={"Range": "bytes=500-"}).status == 416
    r = pair.req("GET", "/rngbkt/o.bin", headers={"Range": "bytes=abc-def"})
    assert r.status == 200 and len(r.body) == 100
    r = pair.req("GET", "/rngbkt/o.bin", headers={"Range": "bytes=-10"})
    assert r.status == 206 and len(r.body) == 10


def test_range_content_range_and_accept_ranges(pair):
    pair.req("PUT", "/crbkt")
    payload = bytes(range(256)) * 400
    pair.req("PUT", "/crbkt/o.bin", data=payload)
    r = pair.req("GET", "/crbkt/o.bin", headers={"Range": "bytes=100-299"})
    assert r.status == 206
    assert r.headers["Content-Range"] == f"bytes 100-299/{len(payload)}"
    assert r.body == payload[100:300]
    assert pair.req("GET", "/crbkt/o.bin").headers["Accept-Ranges"] == \
        "bytes"
    assert pair.req("HEAD", "/crbkt/o.bin").headers["Accept-Ranges"] == \
        "bytes"


def test_ranged_get_does_not_poison_full_object_cache(pair):
    pair.req("PUT", "/poisonbkt")
    payload = _bytes(3, 300_000)
    pair.req("PUT", "/poisonbkt/o.bin", data=payload)
    r = pair.req("GET", "/poisonbkt/o.bin", headers={"Range": "bytes=0-999"})
    assert r.body == payload[:1000]
    assert _sha(pair.req("GET", "/poisonbkt/o.bin").body) == _sha(payload)
    r = pair.req("GET", "/poisonbkt/o.bin",
                 headers={"Range": "bytes=250000-"})
    assert r.body == payload[250000:]


def test_sequential_ranged_reads_trigger_readahead(pair):
    ra = PKG[pair.gw_pkg]["readahead"]
    pair.req("PUT", "/seqbkt")
    payload = _bytes(5, 4 * 1024 * 1024)
    pair.req("PUT", "/seqbkt/stream.bin", data=payload)
    before = ra.stats()["windows_opened"]
    step = 512 * 1024
    for off in range(0, len(payload), step):
        stop = min(off + step, len(payload)) - 1
        r = pair.req("GET", "/seqbkt/stream.bin",
                     headers={"Range": f"bytes={off}-{stop}"})
        assert r.body == payload[off:stop + 1]
    assert ra.stats()["windows_opened"] > before


def test_list_truncation_with_only_prefixes(pair):
    """Truncated listings carry a continuation token even when only
    CommonPrefixes were collected."""
    pair.req("PUT", "/pagbkt")
    for d in ("p1", "p2", "p3", "p4"):
        pair.req("PUT", f"/pagbkt/{d}/x.txt", data=b"x")
    seen = []
    token = ""
    for _ in range(10):
        q = "list-type=2&delimiter=/&max-keys=2"
        if token:
            q += f"&continuation-token={token}"
        root = ET.fromstring(pair.req("GET", "/pagbkt", query=q).body)
        seen += [c.find(f"{NS}Prefix").text
                 for c in root.iter(f"{NS}CommonPrefixes")]
        if root.find(f"{NS}IsTruncated").text != "true":
            break
        tok_el = root.find(f"{NS}NextContinuationToken")
        assert tok_el is not None, "truncated without continuation token"
        token = tok_el.text
    else:
        raise AssertionError("pagination did not terminate")
    assert seen == ["p1/", "p2/", "p3/", "p4/"]


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_sigv4_rejects_stale_date(pkg):
    """A replayed request with an old x-amz-date is rejected even with a
    'valid' signature shape; both packages give the same codes."""
    auth = PKG[pkg]["auth"]
    v = auth.SigV4Verifier([auth.Identity(name="a", access_key="AK",
                                          secret_key="SK")])
    sig = ("AWS4-HMAC-SHA256 Credential=AK/20200101/us-east-1/s3/"
           "aws4_request, SignedHeaders=host;x-amz-date, "
           "Signature=deadbeef")
    hdrs = {"x-amz-date": "20200101T000000Z", "host": "h",
            "Authorization": sig}
    with pytest.raises(auth.AuthError) as ei:
        v.verify("GET", "/", "", hdrs, "payloadhash")
    assert ei.value.code == "RequestTimeTooSkewed"
    import datetime
    now = datetime.datetime.now(datetime.timezone.utc)
    hdrs["x-amz-date"] = now.strftime("%Y%m%dT%H%M%SZ")
    with pytest.raises(auth.AuthError) as ei:
        v.verify("GET", "/", "", hdrs, "payloadhash")
    assert ei.value.code == "AccessDenied"
    # presigned: expired, then a good one the other package signed
    url = "/b/k"
    q = ("X-Amz-Credential=AK/20200101/us-east-1/s3/aws4_request&"
         "X-Amz-Date=20200101T000000Z&X-Amz-Expires=60&"
         "X-Amz-SignedHeaders=host&X-Amz-Signature=00")
    with pytest.raises(auth.AuthError, match="expired"):
        v.verify("GET", url, q, {"host": "h"}, "")


def test_self_copy_is_safe(pair):
    """x-amz-copy-source == destination must not truncate the object."""
    pair.req("PUT", "/selfbkt")
    payload = _bytes(11, 5 * 1024 * 1024)
    pair.req("PUT", "/selfbkt/o.bin", data=payload)
    r = pair.req("PUT", "/selfbkt/o.bin",
                 headers={"x-amz-copy-source": "/selfbkt/o.bin"})
    assert r.status == 200
    assert _sha(pair.req("GET", "/selfbkt/o.bin").body) == _sha(payload)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_identity_action_authorization(clusters, name):
    """Read/Write/Admin actions, optionally bucket-scoped: an
    authenticated identity without the grant gets 403 from both."""
    rows = [("boss", "ADMIN", "S1", ("Admin",)),
            ("reader", "RO", "S2", ("Read",)),
            ("scoped", "SCOPED", "S3", ("Write:only",))]
    p = _auth_pair(clusters, name,
                   [jax_s3_auth.Identity(*r) for r in rows],
                   [s3_auth.Identity(*r) for r in rows])
    admin, ro, scoped = ("ADMIN", "S1"), ("RO", "S2"), ("SCOPED", "S3")
    assert p.req("PUT", "/only", sign=admin).status == 200
    assert p.req("PUT", "/other", sign=admin).status == 200
    assert p.req("PUT", "/only/o.txt", b"x", sign=admin).status == 200
    assert p.req("GET", "/only/o.txt", sign=ro).body == b"x"
    assert p.req("PUT", "/only/no.txt", b"y", sign=ro).status == 403
    assert p.req("PUT", "/newbkt", sign=ro).status == 403
    assert p.req("PUT", "/only/s.txt", b"z", sign=scoped).status == 200
    assert p.req("PUT", "/other/s.txt", b"z", sign=scoped).status == 403
    assert p.req("GET", "/only/o.txt", sign=scoped).status == 403
    # a scoped identity lists only the buckets it can touch
    names = [b.find(f"{NS}Name").text for b in ET.fromstring(
        p.req("GET", "/", sign=scoped).body).iter(f"{NS}Bucket")]
    assert names == ["only"]
    assert p.req("PUT", "/other/o2.txt", b"w", sign=admin).status == 200
    src = {"x-amz-copy-source": "/other/o2.txt"}
    assert p.req("PUT", "/only/ok.txt", headers=src,
                 sign=admin).status == 200
    assert p.req("PUT", "/only/copied.txt", headers=src,
                 sign=scoped).status == 403


@pytest.mark.parametrize("name", sorted(STACKS))
def test_filer_config_identities_live_reload(clusters, name):
    """A gateway with no static identities follows the filer-stored
    config: ``s3.configure -apply`` through the other package's shell
    takes effect without a restart."""
    gw_pkg, filer_pkg = STACKS[name]
    out, started = clusters
    boot = json.dumps({"identities": [
        {"name": "boot", "credentials": [
            {"accessKey": "BOOTAK", "secretKey": "BOOTSK"}],
         "actions": ["Admin"]}]}).encode()
    gws = {}
    for who, (gp, fp) in (("gw", (gw_pkg, filer_pkg)),
                          ("ref", ("jax", "jax"))):
        fm = PKG[fp]
        filer = fm["filer_server"].FilerServer(
            fm["filer"](), port=_free_port_pair(),
            master_url=out[fp][0].url).start()
        started.append(filer)
        fc = fm["fc"].FilerClient(filer.url)
        fc.put_data(s3.S3_CONF_PATH, boot)
        fc.close()
        gws[who] = (PKG[gp]["s3"].S3Gateway(filer.url,
                                             port=_free_port_pair()).start(),
                    filer, fp)
        started.append(gws[who][0])
    p = Pair(name, gws["gw"][0], gws["ref"][0])
    assert p.req("PUT", "/fcbkt").status == 403
    assert p.req("PUT", "/fcbkt", sign=("BOOTAK", "BOOTSK")).status == 200
    for who, (gw, filer, fp) in gws.items():
        # the shell of the package the gateway is not from
        sh = PKG["port" if who == "ref" or gw_pkg == "jax"
                 else "jax"]["shell"]
        env = sh.ClusterEnv(master_url=out[fp][0].url,
                            filer_url=filer.url, out=io.StringIO())
        sh.run_cluster_command(
            env, "s3.configure -user live -access_key LIVEAK "
                 "-secret_key LIVESK -actions Admin -apply")
        sh.run_cluster_command(env, "s3.configure -user boot -delete "
                                    "-apply")
        env.close()
    for gw in (p.gw, p.ref):
        _wait_for(lambda: Pair.call(gw, "PUT", "/fcbkt2",
                                    sign=("LIVEAK", "LIVESK")).status
                  in (200, 409), what="the new identity")
        _wait_for(lambda: Pair.call(gw, "PUT", "/fcbkt3",
                                    sign=("BOOTAK", "BOOTSK")).status
                  == 403, what="the old identity dropped")
    assert p.req("GET", "/", sign=("LIVEAK", "LIVESK")).status == 200


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_verifier_fails_closed_when_config_unavailable(pkg):
    auth = PKG[pkg]["auth"]
    v = auth.SigV4Verifier(None)
    assert v.verify("GET", "/", "", {}, "") is None  # open by default
    v.set_unavailable()
    with pytest.raises(auth.AuthError, match="unavailable"):
        v.verify("GET", "/", "", {}, "")
    v.set_identities(None)  # confirmed no-config -> open again
    assert v.verify("GET", "/", "", {}, "") is None


def test_s3_clean_uploads(pair):
    """Stale multipart uploads are reaped by the age of their newest
    part; active ones survive; both shells print the same lines."""
    pair.req("PUT", "/clnbkt")
    lines = {}
    fresh_ids = {}
    for who, gw in (("ref", pair.ref), ("gw", pair.gw)):
        body = Pair.call(gw, "POST", "/clnbkt/stale.bin",
                         query="uploads").body
        stale_id = ET.fromstring(body).find(f"{NS}UploadId").text
        Pair.call(gw, "PUT", "/clnbkt/stale.bin", data=b"p" * 100,
                  query=f"uploadId={stale_id}&partNumber=1")
        body = Pair.call(gw, "POST", "/clnbkt/fresh.bin",
                         query="uploads").body
        fresh_ids[who] = ET.fromstring(body).find(f"{NS}UploadId").text
        up_dir = f"/buckets/.uploads/{stale_id}"
        for e in list(gw.filer.list(up_dir)) + \
                [gw.filer.lookup("/buckets/.uploads", stale_id)]:
            e.attributes.mtime = int(time.time()) - 48 * 3600
            d = up_dir if e.name != stale_id else "/buckets/.uploads"
            gw.filer.create(d, e)
        # the shell of the gateway's own package
        sh = PKG["jax" if who == "ref" else pair.gw_pkg]
        env = sh["shell"].ClusterEnv(master_url="127.0.0.1:1",
                                     filer_url=gw.filer.filer_url,
                                     out=io.StringIO())
        try:
            sh["fs"].cmd_s3_clean_uploads(env, ["-timeAgo", "24h"])
            assert gw.filer.lookup("/buckets/.uploads",
                                   stale_id) is not None
            sh["fs"].cmd_s3_clean_uploads(env, ["-timeAgo", "24h",
                                                "-force"])
            assert gw.filer.lookup("/buckets/.uploads", stale_id) is None
            assert gw.filer.lookup("/buckets/.uploads",
                                   fresh_ids[who]) is not None
        finally:
            env.close()
        lines[who] = env.out.getvalue().replace(stale_id, "<id>")
    assert lines["gw"] == lines["ref"]
    assert "dry run" in lines["gw"]
    assert "1 stale uploads aborted, 1 active kept" in lines["gw"]
    for who, gw in (("ref", pair.ref), ("gw", pair.gw)):
        Pair.call(gw, "PUT", "/clnbkt/fresh.bin", data=b"z" * 10,
                  query=f"uploadId={fresh_ids[who]}&partNumber=1")
        Pair.call(gw, "POST", "/clnbkt/fresh.bin",
                  query=f"uploadId={fresh_ids[who]}")
    assert pair.req("GET", "/clnbkt/fresh.bin").body == b"z" * 10


# --------------------------------------------------------------------------
# the port's own surface
# --------------------------------------------------------------------------

def test_debug_pages_answer_404_and_invalidate_drops(pairs):
    """``/debug/vars`` and ``/debug/profile`` answer as on the JAX
    gateway; ``/debug/traces``, which neither gateway serves, is a GET
    of bucket ``debug`` and answers 404 in both."""
    gw = pairs["port"].gw
    vz = Pair.call(gw, "GET", "/debug/vars")
    assert vz.status == 200 and json.loads(vz.body)["component"] == "s3"
    assert Pair.call(gw, "GET", "/debug/profile?seconds=0.1").status \
        == 200
    assert Pair.call(gw, "GET", "/debug/traces").status == \
        Pair.call(pairs["port"].ref, "GET", "/debug/traces").status \
        == 404
    r = Pair.call(gw, "POST", "/cache/invalidate",
                  data=json.dumps({"volumeId": 12345}).encode())
    assert r.status == 200 and json.loads(r.body) == {"ok": True,
                                                      "volumeId": 12345}
    assert Pair.call(gw, "POST", "/cache/invalidate",
                     data=b"{}").status == 400


def test_qos_sheds_a_tenant_over_its_class(clusters):
    """The [qos] ladder on a live gateway: a tenant over its
    concurrency/rate budget gets 429 SlowDown with Retry-After from
    both packages' gateways."""
    conf = {"qos": {"enabled": True, "default_class": "std",
                    "class": {"std": {"priority": 1,
                                      "rate_per_second": 1.0,
                                      "burst": 2.0}}}}
    gws = {pkg: _gateway(clusters, pkg, pkg,
                         qos=PKG[pkg]["s3"].httpserver.qos_from_conf(conf))
           for pkg in PKG}
    got = {}
    for pkg, gw in gws.items():
        got[pkg] = [Pair.call(gw, "PUT", f"/qos{pkg}").status,
                    Pair.call(gw, "GET", "/").status]
        r = Pair.call(gw, "GET", "/")
        got[pkg].append(r.status)
        assert r.headers["Retry-After"] == "1"
        assert ET.fromstring(r.body).find("Code").text == "SlowDown"
    assert got["port"] == got["jax"] == [200, 200, 429]
