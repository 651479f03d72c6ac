"""The port's filer data model (``seaweedfs_tpu_torch/filer``) against the
JAX package's: the same chunk lists, namespace operations, meta-log and
TTL scenarios through both, with equal results; a sqlite ``-db`` written
by either package opens in the other with equal entries. Mirrors
``tests/test_filer.py``."""

import threading
import time

import pytest
from torch_teardown import collect_jax_garbage  # noqa: F401

import seaweedfs_tpu.filer as jax_filer
import seaweedfs_tpu.filer.filechunks as jax_filechunks
import seaweedfs_tpu.filer.path_conf as jax_path_conf
import seaweedfs_tpu_torch.filer as port_filer
import seaweedfs_tpu_torch.filer.filechunks as port_filechunks
import seaweedfs_tpu_torch.filer.path_conf as port_path_conf

PKGS = {"jax": (jax_filer, jax_filechunks), "port": (port_filer,
                                                     port_filechunks)}


def _store(f, kind, path):
    return f.MemoryStore() if kind == "memory" else f.SqliteStore(str(path))


def _both(fn):
    """Run ``fn(filer_pkg, filechunks_pkg)`` in both packages; the results
    must be equal. Returns the port's."""
    got = {name: fn(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


CHUNK_CASES = {
    "disjoint": ([("a", 0, 10, 0), ("b", 10, 5, 0)], 0, 15,
                 [(0, 10, "a", 0), (10, 15, "b", 0)]),
    "newer_overwrites_middle": ([("old", 0, 100, 1), ("new", 30, 20, 2)],
                                0, 100,
                                [(0, 30, "old", 0), (30, 50, "new", 0),
                                 (50, 100, "old", 50)]),
    "mtime_order_beats_list_order": ([("late", 0, 10, 9),
                                      ("early", 0, 10, 1)], 0, 10,
                                     [(0, 10, "late", 0)]),
    "read_plan_with_gap": ([("a", 0, 10, 0), ("b", 20, 10, 0)], 5, 20,
                           [(0, 10, "a", 0), (20, 30, "b", 0)]),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_filechunks_equal(case):
    chunks, off, length, want = CHUNK_CASES[case]

    def run(f, fc):
        cs = [f.FileChunk(file_id=i, offset=o, size=s, mtime_ns=m)
              for i, o, s, m in chunks]
        vis = [(v.start, v.stop, v.file_id, v.chunk_offset)
               for v in fc.visible_intervals(cs)]
        plan = [(p.file_id, p.chunk_offset, p.length, p.buffer_offset)
                for p in fc.read_plan(cs, off, length)]
        return vis, plan, fc.total_size(cs), fc.chunk_file_ids(cs)

    vis, plan, _size, _ids = _both(run)
    assert vis == want
    if case == "read_plan_with_gap":
        assert plan == [("a", 5, 5, 0), ("b", 0, 5, 15)]


def _ns_create_find_list(f, fl):
    fl.create_entry(f.Entry(path="/a/b/c.txt", chunks=[
        f.FileChunk(file_id="1,ab", offset=0, size=3)]))
    return (fl.find_entry("/a").is_dir, fl.find_entry("/a/b").is_dir,
            fl.find_entry("/a/b/c.txt").chunks[0].file_id,
            [x.name for x in fl.list_entries("/a/b")])


def _ns_conflicts(f, fl):
    fl.create_entry(f.Entry(path="/x", attr=f.Attr(is_dir=False)))
    out = []
    for call in (lambda: fl.create_entry(f.Entry(path="/x"), o_excl=True),
                 lambda: fl.create_entry(f.Entry(path="/x/y"))):
        try:
            call()
            out.append("ok")
        except f.FilerError as e:
            out.append(str(e))
    return out


def _ns_delete_recursive(f, fl):
    fl.create_entry(f.Entry(path="/d/f1", chunks=[
        f.FileChunk(file_id="1,a", offset=0, size=4)]))
    fl.create_entry(f.Entry(path="/d/sub/f2", chunks=[
        f.FileChunk(file_id="2,b", offset=0, size=4)]))
    try:
        fl.delete_entry("/d")
        refused = ""
    except f.FilerError as e:
        refused = str(e)
    orphans = fl.delete_entry("/d", recursive=True)
    return (refused, sorted(c.file_id for c in orphans),
            fl.find_entry("/d"), fl.find_entry("/d/sub/f2"))


def _ns_rename(f, fl):
    fl.create_entry(f.Entry(path="/src/a", chunks=[
        f.FileChunk(file_id="1,a", offset=0, size=1)]))
    fl.create_entry(f.Entry(path="/src/deep/b", chunks=[
        f.FileChunk(file_id="2,b", offset=0, size=1)]))
    fl.rename("/src", "/dst")
    return (fl.find_entry("/src"),
            fl.find_entry("/dst/a").chunks[0].file_id,
            fl.find_entry("/dst/deep/b").chunks[0].file_id)


def _ns_listing(f, fl):
    for name in ("c", "a", "b", "d"):
        fl.create_entry(f.Entry(path=f"/p/{name}"))
    return ([e.name for e in fl.list_entries("/p")],
            [e.name for e in fl.list_entries("/p", start_name="b",
                                             limit=2)])


NS_CASES = {"create_find_list": (_ns_create_find_list,
                                 (True, True, "1,ab", ["c.txt"])),
            "conflicts": (_ns_conflicts, None),
            "delete_recursive": (_ns_delete_recursive, None),
            "rename": (_ns_rename, (None, "1,a", "2,b")),
            "listing": (_ns_listing, (["a", "b", "c", "d"], ["c", "d"]))}


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("case", sorted(NS_CASES))
def test_namespace_equal(case, kind, tmp_path):
    fn, want = NS_CASES[case]
    got = _both(lambda f, fc: fn(f, f.Filer(_store(
        f, kind, tmp_path / f"{f.__name__}.db"))))
    if want is not None:
        assert got == want
    if case == "conflicts":
        assert "ok" not in got
    if case == "delete_recursive":
        assert got[0] and got[1:] == (["1,a", "2,b"], None, None)


def test_sqlite_db_opens_in_the_other_package(tmp_path):
    """A ``-db`` written by either package opens in the other with equal
    entries (the sqlite layout is the JAX package's)."""
    def fill(f, db):
        fl = f.Filer(f.SqliteStore(str(db)))
        fl.create_entry(f.Entry(
            path="/keep/me.bin",
            attr=f.Attr(mime="application/x", collection="c",
                        replication="001", ttl_sec=0, crtime=1.5,
                        mtime=2.5),
            chunks=[f.FileChunk(file_id="9,0a1b2c3d", offset=0, size=7,
                                mtime_ns=11, etag="e")],
            extended={"k": "v"}))
        fl.create_entry(f.Entry(path="/keep/sub",
                                attr=f.Attr(is_dir=True, crtime=3.0,
                                            mtime=3.0)))
        fl.store.kv_put("kv", b"\x00\x01")
        fl.store.close()

    def dump(f, db):
        fl = f.Filer(f.SqliteStore(str(db)))
        out = {p: fl.find_entry(p).to_dict()
               for p in ("/keep", "/keep/me.bin", "/keep/sub")}
        out["list"] = [e.name for e in fl.list_entries("/keep")]
        out["kv"] = fl.store.kv_get("kv")
        fl.store.close()
        return out

    for writer, reader in (("jax", "port"), ("port", "jax")):
        db = tmp_path / f"{writer}.db"
        fill(PKGS[writer][0], db)
        got = dump(PKGS[reader][0], db)
        assert got == dump(PKGS[writer][0], db)
        assert got["/keep/me.bin"]["chunks"][0]["fileId"] == "9,0a1b2c3d"
        assert got["list"] == ["me.bin", "sub"] and got["kv"] == b"\x00\x01"


def test_sqlite_survives_reopen(tmp_path):
    def run(f, fc):
        db = str(tmp_path / f"{f.__name__}.db")
        fl = f.Filer(f.SqliteStore(db))
        fl.create_entry(f.Entry(path="/keep/me", chunks=[
            f.FileChunk(file_id="9,z", offset=0, size=7)]))
        fl.store.close()
        return f.Filer(f.SqliteStore(db)).find_entry("/keep/me").chunks[0].size

    assert _both(run) == 7


def test_meta_log_subscribe_sees_mutations():
    def run(f, fc):
        fl = f.Filer()
        events, stop, ready = [], threading.Event(), threading.Event()

        def consume():
            # ``registered`` is set once the subscriber is attached, so
            # the mutations below cannot land before it
            for ev in fl.subscribe(stop, registered=ready):
                events.append(ev)
                if len(events) >= 2:
                    stop.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert ready.wait(5)
        fl.create_entry(f.Entry(path="/n1"))
        fl.delete_entry("/n1")
        t.join(timeout=5)
        assert not t.is_alive()
        return [(ev.directory,
                 ev.old_entry and ev.old_entry.path,
                 ev.new_entry and ev.new_entry.path) for ev in events]

    assert _both(run) == [("/", None, "/n1"), ("/", "/n1", None)]


def test_entry_ttl_lazy_expiry_and_expired_children():
    now = time.time()

    def run(f, fc):
        fl = f.Filer()
        fl.create_entry(f.Entry(path="/ttl/short.txt", attr=f.Attr(
            ttl_sec=1, crtime=now - 5)))
        fl.create_entry(f.Entry(path="/ttl/long.txt",
                                attr=f.Attr(ttl_sec=3600)))
        fl.create_entry(f.Entry(path="/ttl/forever.txt", attr=f.Attr()))
        fl.create_entry(f.Entry(path="/ttl2/d", attr=f.Attr(
            is_dir=True, ttl_sec=1, crtime=now - 5)))
        fl.create_entry(f.Entry(path="/exp/x", attr=f.Attr(
            ttl_sec=1, crtime=now - 10)))
        out = (fl.find_entry("/ttl/short.txt"),
               sorted(e.name for e in fl.list_entries("/ttl")),
               fl.store.find_entry("/ttl/short.txt"),
               fl.find_entry("/ttl2/d") is not None,
               list(fl.list_entries("/exp")))
        fl.delete_entry("/exp", recursive=False)
        return out + (fl.store.find_entry("/exp"),
                      fl.store.find_entry("/exp/x"))

    assert _both(run) == (None, ["forever.txt", "long.txt"], None, True,
                          [], None, None)


@pytest.mark.parametrize("raw", [
    b'{"locations": [{"locationPrefix": "/logs/", "collection": "logs",'
    b' "ttl": "7d"}, {"locationPrefix": "/logs/hot/", "replication":'
    b' "001"}]}',
    b'{"locations": []}',
    b"not json",
])
def test_path_conf_parse_and_match_equal(raw):
    def run(pc):
        try:
            conf = pc.PathConf.parse(raw)
        except ValueError as e:
            return ("error", type(e).__name__)
        return (len(conf), [r.to_json() for r in conf.rules],
                [(p, conf.match(p) and conf.match(p).to_json())
                 for p in ("/logs/a", "/logs/hot/b", "/other")])

    assert run(port_path_conf) == run(jax_path_conf)
    assert port_path_conf.FILER_CONF_PATH == jax_path_conf.FILER_CONF_PATH


def test_overflowed_subscriber_takes_no_event_past_the_gap():
    """A subscriber that dropped an event (its queue full) gets none of
    the later ones, so it drains exactly to the drop point and errors,
    and a resume from its last event replays the gap. The JAX filer
    appends again once the consumer made room, so its consumer sees an
    event past the gap first (ROADMAP Queue 3)."""
    def run(f, fc):
        fl = f.Filer()
        fl.create_entry(f.Entry(path="/g", attr=f.Attr(is_dir=True)))
        fl.MAX_SUB_QUEUE = 2
        stop, reg = threading.Event(), threading.Event()
        step, pulled = threading.Semaphore(0), threading.Semaphore(0)
        got, errs = [], []

        def consume():
            try:
                for ev in fl.subscribe(stop, registered=reg):
                    got.append(ev.new_entry.name)
                    pulled.release()
                    step.acquire()
            except f.FilerError as e:
                errs.append(str(e))
            pulled.release()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert reg.wait(5)

        def create(name):
            fl.create_entry(f.Entry(path=f"/g/{name}", attr=f.Attr()))

        create("e0")
        assert pulled.acquire(timeout=5)      # e0 taken, consumer parked
        for name in ("e1", "e2", "e3"):       # e3 overflows the queue
            create(name)
        step.release()
        assert pulled.acquire(timeout=5)      # e1 taken: room again
        create("e4")
        while t.is_alive():
            step.release()
            pulled.acquire(timeout=5)
        t.join(timeout=5)
        assert not t.is_alive() and errs and "re-sync" in errs[0]
        return got

    jax_got = run(jax_filer, jax_filechunks)
    port_got = run(port_filer, port_filechunks)
    assert port_got == ["e0", "e1", "e2"]
    assert jax_got == ["e0", "e1", "e2", "e4"]
