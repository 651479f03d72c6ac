"""The port's on-read image resizing (``images/resize.py``) and
notification queues (``notification/queues.py``) against the JAX
package's: the same images give byte-equal results, a port volume server
scales ``?width=&height=`` GETs, and the notifier, webhook queue and
subscriber overflow behave as in JAX. Mirrors the resize and notifier
cases of ``tests/test_tools_images_notify.py``."""

import io
import json
import threading
import time
import urllib.request

import pytest
from torch_teardown import collect_jax_garbage  # noqa: F401

import seaweedfs_tpu.filer as jax_filer
import seaweedfs_tpu.images as jax_images
import seaweedfs_tpu.notification as jax_notification
import seaweedfs_tpu_torch.filer as port_filer
import seaweedfs_tpu_torch.images as port_images
import seaweedfs_tpu_torch.notification as port_notification

from test_cluster_integration import _free_port_pair

Image = pytest.importorskip("PIL.Image")

PKGS = {"jax": (jax_filer, jax_images, jax_notification),
        "port": (port_filer, port_images, port_notification)}


def _png(w, h) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", (w, h), (200, 10, 10)).save(buf, format="PNG")
    return buf.getvalue()


def _resize_both(*args, **kw):
    got = port_images.resized(*args, **kw)
    assert got == jax_images.resized(*args, **kw)
    return got


def test_resize_fit_within_box():
    data, mime = _resize_both(_png(100, 50), width=50, height=50)
    assert mime == "image/png"
    assert Image.open(io.BytesIO(data)).size == (50, 25)


def test_resize_fill_crops():
    data, _ = _resize_both(_png(100, 50), width=40, height=40, mode="fill")
    assert Image.open(io.BytesIO(data)).size == (40, 40)


def test_resize_noop_cases():
    raw = b"definitely not an image"
    assert _resize_both(raw, width=10) == (raw, "")
    png = _png(10, 10)
    assert _resize_both(png)[0] == png
    assert _resize_both(png, width=100, height=100)[0] == png


def test_resize_rejects_unbounded_upscale():
    png = _png(1, 1)
    assert _resize_both(png, width=100000, height=100000,
                        mode="fit")[0] == png
    wide = _png(4000, 1)
    assert _resize_both(wide, width=2000, height=2000,
                        mode="fill")[0] == wide
    out3, _ = _resize_both(_png(200, 2000), width=100)
    assert Image.open(io.BytesIO(out3)).size == (100, 1000)
    assert _resize_both(png, width=-5, height=20, mode="fit")[0] == png


def test_resize_on_port_volume_read(tmp_path):
    """GET ?width= through a live port volume server scales the image,
    as JAX ``images.resized`` does; a negative width is a 400."""
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.operation import assign, upload
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
    from seaweedfs_tpu_torch.storage.store import Store

    master = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                          pulse_seconds=0.2, seed=6,
                          garbage_threshold=0).start()
    d = tmp_path / "iv"
    d.mkdir()
    vs = VolumeServer(Store([d], max_volumes=4), port=_free_port_pair(),
                      master_url=master.url, pulse_seconds=0.2,
                      device="cpu").start()
    mc = MasterClient(master.url)
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not master.topology.nodes:
            time.sleep(0.05)
        png = _png(80, 80)
        a = assign(mc)
        upload(a.url, a.fid, png, jwt=a.auth)
        url = f"http://{a.url}/{a.fid}"
        with urllib.request.urlopen(url + "?width=20&height=20",
                                    timeout=10) as r:
            assert r.headers["Content-Type"] == "image/png"
            body = r.read()
        assert body == jax_images.resized(png, 20, 20)[0]
        assert Image.open(io.BytesIO(body)).size == (20, 20)
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.read() == png
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "?width=-3", timeout=10)
        assert ei.value.code == 400
    finally:
        mc.close()
        vs.stop()
        master.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_log_file_queue_and_notifier(tmp_path, pkg):
    f, _, n = PKGS[pkg]
    filer = f.Filer()
    log = tmp_path / "events.jsonl"
    notifier = n.FilerNotifier(filer, n.LogFileQueue(log)).start()
    try:
        filer.create_entry(f.Entry(path="/n/a.txt", attr=f.Attr()))
        filer.delete_entry("/n/a.txt")
        for _ in range(100):
            if log.exists() and len(
                    log.read_text().strip().splitlines()) >= 3:
                break
            time.sleep(0.05)
        lines = [json.loads(x) for x in log.read_text().strip().splitlines()]
        paths = [(e["newEntry"] or e["oldEntry"] or {}).get("path")
                 for e in lines]
        assert "/n/a.txt" in paths
        assert [e for e in lines if e["newEntry"] is None and e["oldEntry"]
                and e["oldEntry"]["path"] == "/n/a.txt"]
        assert sorted(lines[-1]) == ["directory", "newEntry", "oldEntry",
                                     "signatures", "tsNs"]
    finally:
        notifier.stop()


def test_log_lines_equal_across_packages(tmp_path):
    """The same mutations through each package's notifier write the same
    JSON lines, timestamps and the filer's own signature aside."""
    got = {}
    for pkg, (f, _, n) in PKGS.items():
        filer = f.Filer()
        log = tmp_path / f"{pkg}.jsonl"
        notifier = n.FilerNotifier(filer, n.LogFileQueue(log)).start()
        try:
            filer.create_entry(f.Entry(path="/q/x.bin", attr=f.Attr(
                mime="m", crtime=1.0, mtime=2.0), chunks=[f.FileChunk(
                    file_id="3,01", offset=0, size=9)]))
            filer.rename("/q/x.bin", "/q/y.bin")
            filer.delete_entry("/q/y.bin")
            for _ in range(100):
                if log.exists() and len(log.read_text().splitlines()) >= 5:
                    break
                time.sleep(0.05)
        finally:
            notifier.stop()
        lines = [json.loads(x) for x in log.read_text().splitlines()]
        for e in lines:
            e.pop("tsNs", None)
            # each filer draws its own signature
            assert e.pop("signatures") == [filer.signature]
            for side in ("newEntry", "oldEntry"):
                if e.get(side):
                    e[side].pop("mtime", None)
        got[pkg] = lines
    assert got["port"] == got["jax"] and len(got["port"]) >= 5


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_webhook_queue_drops_on_dead_endpoint(pkg):
    q = PKGS[pkg][2].HttpWebhookQueue("http://127.0.0.1:1/none",
                                      timeout=0.2)
    q.send({"x": 1})
    assert q.dropped == 1 and q.sent == 0


def test_webhook_queue_posts_and_notify_fault(tmp_path):
    """A live endpoint gets the event as JSON; an armed ``notify.webhook``
    fault drops it (the point is in the port's catalog)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from seaweedfs_tpu_torch.util import faults

    bodies = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        q = port_notification.HttpWebhookQueue(
            f"http://127.0.0.1:{srv.server_port}/hook", timeout=2)
        q.send({"a": 1})
        assert (q.sent, q.dropped, bodies) == (1, 0, [{"a": 1}])
        assert "notify.webhook" in faults.CATALOG
        faults.inject("notify.webhook", "error")
        try:
            q.send({"a": 2})
        finally:
            faults.clear()
        assert (q.sent, q.dropped, len(bodies)) == (1, 1, 1)
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_subscriber_overflow_errors_not_silently_drops(pkg):
    f = PKGS[pkg][0]
    filer = f.Filer()
    filer.MAX_SUB_QUEUE = 5
    registered, gate = threading.Event(), threading.Event()
    got, errs = [], []

    def consume():
        try:
            for ev in filer.subscribe(registered=registered):
                got.append(ev)
                gate.wait(timeout=10)
        except f.FilerError as e:
            errs.append(str(e))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert registered.wait(timeout=5)
    for i in range(10):
        filer.create_entry(f.Entry(path=f"/of/e{i}", attr=f.Attr()))
    gate.set()
    t.join(timeout=10)
    assert errs and "re-sync required" in errs[0]
    assert 1 <= len(got) <= 6


def test_notifier_survives_subscriber_overflow(tmp_path):
    """The port's external bridge re-subscribes after lagging and loses
    nothing inside the replay window."""
    filer = port_filer.Filer()
    filer.MAX_SUB_QUEUE = 3
    log = tmp_path / "ev.jsonl"

    class SlowQueue(port_notification.LogFileQueue):
        def send(self, event):
            time.sleep(0.05)
            super().send(event)

    notifier = port_notification.FilerNotifier(filer,
                                               SlowQueue(log)).start()
    try:
        for i in range(30):
            filer.create_entry(port_filer.Entry(path=f"/nv/e{i}",
                                                attr=port_filer.Attr()))
        deadline = time.time() + 15
        while time.time() < deadline and notifier.resubscribed == 0:
            time.sleep(0.05)
        assert notifier.resubscribed >= 1
        assert notifier.lost == 0
        deadline = time.time() + 20
        want = {f"/nv/e{i}" for i in range(30)}
        seen = set()
        while time.time() < deadline and not want <= seen:
            if log.exists():
                seen = {(json.loads(x)["newEntry"] or {}).get("path")
                        for x in log.read_text().strip().splitlines() if x}
            time.sleep(0.1)
        assert want <= seen, sorted(want - seen)[:5]
    finally:
        notifier.stop()
