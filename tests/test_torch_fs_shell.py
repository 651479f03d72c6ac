"""The port's ``fs.*`` commands, ``volume.fsck`` and ``fs.configure``
(``shell/fs_commands.py``, ``shell -filer``) against the JAX shell's, on
the CPU, and gRPC auth on the port volume server's admin plane. Mirrors
``tests/test_fs_shell_auth.py``, its ``s3.bucket.*`` parts included, and
runs ``s3.configure`` and ``s3.clean.uploads`` through both shells.

Each scenario runs once per shell on twin port stacks (a master with the
same seed and signing key, one volume server, one filer, the same
writes): every printed line is equal once addresses, temp paths, clock
readings and file-id cookies are masked, and each result is the JAX test's. Port
servers run ``device="cpu"``."""

import io
import json
import re
import time

import grpc
import pytest
from torch_teardown import collect_jax_garbage  # noqa: F401

from seaweedfs_tpu import pb as jax_pb
from seaweedfs_tpu.shell import cluster_commands as jax_cluster_commands
from seaweedfs_tpu.shell import fs_commands as jax_fs_commands  # noqa: F401
from seaweedfs_tpu.shell.commands import ShellError as JaxShellError
from seaweedfs_tpu.util import security as jax_security
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.cluster import operation
from seaweedfs_tpu_torch.cluster.filer_client import FilerClient
from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.pb import volume_server_pb2
from seaweedfs_tpu_torch.shell import cli
from seaweedfs_tpu_torch.shell import cluster_commands
from seaweedfs_tpu_torch.shell import fs_commands  # noqa: F401
from seaweedfs_tpu_torch.shell.commands import ShellError
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import FileId
from seaweedfs_tpu_torch.util import security

from test_cluster_integration import _free_port_pair

PULSE = 0.2
SECRET = "cluster-test-key"
SHELL = {"jax": jax_cluster_commands, "port": cluster_commands}
ERRORS = (ShellError, JaxShellError)


def _stack(tmp_path_factory, tag):
    master = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                          pulse_seconds=PULSE, seed=2, secret=SECRET,
                          garbage_threshold=0).start()
    d = tmp_path_factory.mktemp(f"fsvol_{tag}")
    vs = VolumeServer(Store([d], max_volumes=8), port=_free_port_pair(),
                      master_url=master.url, secret=SECRET,
                      pulse_seconds=PULSE, device="cpu").start()
    deadline = time.time() + 10
    while time.time() < deadline and len(master.topology.nodes) < 1:
        time.sleep(0.05)
    filer = FilerServer(Filer(), port=_free_port_pair(),
                        master_url=master.url).start()
    return master, vs, filer


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """Twin port stacks: ``stacks["jax"]`` is driven by the JAX shell,
    ``stacks["port"]`` by the port's."""
    out = {pkg: _stack(tmp_path_factory, pkg) for pkg in SHELL}
    yield out
    for master, vs, filer in out.values():
        filer.stop()
        vs.stop()
        master.stop()


_TIME = re.compile(r'("(?:mtime|crtime|mtime_ns)": )\d+|\d+(s ago)')
#: file ids: the master draws each needle's cookie at random
_FID = re.compile(r'"\d+,[0-9a-f]{9,}"')


def _mask(text, stack, tmp):
    master, vs, filer = stack
    for url, name in ((master.url, "M"), (vs.url, "S"), (filer.url, "F"),
                      (str(tmp), "T")):
        text = text.replace(url, name)
    text = _FID.sub('"FID"', text)
    return _TIME.sub(lambda m: (m.group(1) or "") + "N" + (m.group(2) or ""),
                     text)


def _shell(pkg, stack, line: str) -> str:
    """One command through ``pkg``'s shell; a refusal prints
    ``error: ...`` as the CLI would."""
    master, _, filer = stack
    out = io.StringIO()
    env = SHELL[pkg].ClusterEnv(master_url=master.url, filer_url=filer.url,
                                secret=SECRET, out=out)
    try:
        SHELL[pkg].run_cluster_command(env, line)
    except ERRORS as e:
        out.write(f"error: {e}\n")
    finally:
        env.close()
    return out.getvalue()


def _both(stacks, tmp_path, scenario):
    """``scenario(pkg, stack, run, tmp)`` for both shells on their twin
    stacks; ``run(line)`` records each command's output. The masked
    transcripts must be equal; returns the port's (unmasked) outputs."""
    got, raw = {}, {}
    for pkg in ("jax", "port"):
        tmp = tmp_path / pkg
        tmp.mkdir()
        stack = stacks[pkg]
        outs = []

        def run(line, pkg=pkg, stack=stack, tmp=tmp, outs=outs):
            o = _shell(pkg, stack, line.format(tmp=tmp))
            outs.append(o)
            return o

        scenario(pkg, stack, run, tmp)
        got[pkg] = [_mask(o, stack, tmp) for o in outs]
        raw[pkg] = outs
    assert got["port"] == got["jax"]
    return raw["port"]


def test_fs_commands_end_to_end(stacks, tmp_path):
    def scenario(pkg, stack, run, tmp):
        fc = FilerClient(stack[2].url)
        try:
            fc.put_data("/docs/a.txt", b"alpha")
            fc.put_data("/docs/sub/b.txt", b"beta-beta")
            for line in ("fs.ls /docs", "fs.ls -l /docs", "fs.du /docs",
                         "fs.cat /docs/a.txt", "fs.mkdir /docs/newdir",
                         "fs.ls /docs", "fs.mv /docs/a.txt /docs/a2.txt",
                         "fs.ls /docs", "fs.tree /docs",
                         "fs.meta.save -o {tmp}/meta.jsonl /docs",
                         "fs.rm -r /docs/sub", "fs.ls /docs",
                         "fs.meta.load -i {tmp}/meta.jsonl",
                         "fs.cat /docs/sub/b.txt",
                         "fs.rm /docs/newdir2-missing",
                         "fs.rm /docs/sub", "fs.mkdir /"):
                run(line)
            assert fc.get_data("/docs/a2.txt") == b"alpha"
            assert fc.get_data("/docs/sub/b.txt") == b"beta-beta"
            lines = [json.loads(x) for x in
                     (tmp / "meta.jsonl").read_text().splitlines()]
            assert {"a2.txt", "sub", "b.txt"} <= {e["name"] for e in lines}
            assert [e for e in lines if e["name"] == "a2.txt"][0]["chunks"]
        finally:
            fc.close()

    o = _both(stacks, tmp_path, scenario)
    assert "a.txt" in o[0] and "sub/" in o[0]
    assert "a.txt" in o[1] and "total 2" in o[1]
    assert o[2] == "14 bytes, 2 files, 1 dirs under /docs\n"
    assert o[3] == "alpha\n" and "newdir/" in o[5]
    assert "a2.txt" in o[7] and "a.txt\n" not in o[7]
    assert "2 directories, 2 files" in o[8]
    assert o[9].startswith("saved 4 entries")
    assert "sub/" not in o[11]
    assert o[13] == "beta-beta\n"
    assert o[14].startswith("error:") and "not found" in o[14]
    assert "is a directory (use -r)" in o[15]
    assert "cannot mkdir /" in o[16]


def test_fs_commands_require_filer(stacks):
    for pkg, mod in SHELL.items():
        out = io.StringIO()
        env = mod.ClusterEnv(master_url=stacks[pkg][0].url, secret=SECRET,
                             out=out)
        try:
            with pytest.raises(ERRORS, match="no filer configured"):
                mod.run_cluster_command(env, "fs.ls /")
        finally:
            env.close()


@pytest.mark.parametrize("key", [None, "not-the-key"])
def test_grpc_auth_rejects_unauthenticated_and_wrong_key(stacks, key):
    _, vs, _ = stacks["port"]
    for sec, stub_pb in ((security, pb), (jax_security, jax_pb)):
        ch = grpc.insecure_channel(f"127.0.0.1:{vs.port + 10000}")
        if key is not None:
            ch = sec.grpc_auth_channel(ch, sec.Guard(key))
        with pytest.raises(grpc.RpcError) as ei:
            stub_pb.volume_stub(ch).VolumeStatus(
                volume_server_pb2.VolumeStatusRequest(volume_id=1))
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
        ch.close()


def test_grpc_auth_accepts_cluster_key_and_cluster_works(stacks):
    master, vs, _ = stacks["port"]
    for sec, stub_pb in ((security, pb), (jax_security, jax_pb)):
        ch = sec.grpc_auth_channel(
            grpc.insecure_channel(f"127.0.0.1:{vs.port + 10000}"),
            sec.Guard(SECRET))
        assert stub_pb.volume_stub(ch).VolumeStatus(
            volume_server_pb2.VolumeStatusRequest(volume_id=12345)) \
            is not None
        ch.close()


def test_fs_tree(stacks, tmp_path):
    def scenario(pkg, stack, run, tmp):
        fc = FilerClient(stack[2].url)
        try:
            fc.put_data("/tree/obj1.txt", b"one")
            fc.put_data("/tree/sub/obj2.txt", b"twotwo")
            fc.put_data("/tree/sub/deeper/obj3.txt", b"3")
            run("fs.tree /tree")
            run("fs.du /tree")
        finally:
            fc.close()

    tree, du = _both(stacks, tmp_path, scenario)
    assert tree.splitlines() == [
        "/tree", "├── obj1.txt", "└── sub/", "    ├── deeper/",
        "    │   └── obj3.txt", "    └── obj2.txt",
        "2 directories, 3 files"]
    assert du == "10 bytes, 3 files, 2 dirs under /tree\n"


def test_volume_fsck(stacks, tmp_path):
    """fsck ties filer references to volume needles: direct uploads the
    filer never saw are orphans (purgeable past the cutoff), needles
    deleted from under a file are reported missing."""
    def scenario(pkg, stack, run, tmp):
        master, vs, filer = stack
        fc = FilerClient(filer.url)
        mc = MasterClient(master.url)
        try:
            fc.put_data("/fsck/ok.txt", b"o" * 500)
            orphan_fid = operation.submit(mc, [b"orphan-bytes"])[0]
            vs.heartbeat_now()
            of = FileId.parse(orphan_fid)
            run("volume.fsck -v")
            run("volume.fsck -purge")
            assert vs.store.get_volume(of.volume_id).nm.get(of.key) \
                is not None
            run("volume.fsck -purge -cutoffSeconds 0")
            assert vs.store.get_volume(of.volume_id).nm.get(of.key) is None
            assert fc.get_data("/fsck/ok.txt") == b"o" * 500
            run("volume.fsck")
            e = fc.lookup("/fsck", "ok.txt")
            cf = FileId.parse(e.chunks[0].file_id)
            vs.store.get_volume(cf.volume_id).delete_needle(cf.key)
            run("volume.fsck")
            fc.delete("/fsck", "ok.txt")
            run("volume.fsck")
        finally:
            mc.close()
            fc.close()

    o = _both(stacks, tmp_path, scenario)
    assert "orphan needle(s)" in o[0] and "orphan needle " in o[0]
    assert "NOT purged" in o[1]
    assert " purged" in o[2]
    assert "0 orphan needles" in o[3] and "0 missing chunks" in o[3]
    assert "MISSING but referenced by /fsck/ok.txt" in o[4]
    assert "BROKEN" in o[4]
    assert "0 missing chunks" in o[5]


def test_fs_configure_path_rules(stacks, tmp_path):
    """filer.conf rules: writes under a prefix inherit collection/
    replication/ttl (longest prefix wins, explicit params override),
    live-reloaded through the filer's own meta stream."""
    def wait_rules(filer, n):
        deadline = time.time() + 10
        while time.time() < deadline and len(filer.path_conf) != n:
            time.sleep(0.05)
        assert len(filer.path_conf) == n

    def scenario(pkg, stack, run, tmp):
        master, vs, filer = stack
        fc = FilerClient(filer.url)
        try:
            run("fs.configure -locationPrefix /hot/ -collection hot "
                "-ttl 5m -apply")
            run("fs.configure -locationPrefix /hot/special/ "
                "-collection special -apply")
            run("fs.configure")
            wait_rules(filer, 2)
            fc.put_data("/hot/a.bin", b"h" * 100)
            e = fc.lookup("/hot", "a.bin")
            assert (e.attributes.collection, e.attributes.ttl_sec) == \
                ("hot", 300)
            vid = FileId.parse(e.chunks[0].file_id).volume_id
            assert str(vs.store.get_volume(vid, "hot").super_block.ttl) \
                == "5m"
            fc.put_data("/hot/special/b.bin", b"s" * 50)
            assert fc.lookup("/hot/special", "b.bin") \
                .attributes.collection == "special"
            fc.put_data("/hot/c.bin", b"c" * 50,
                        query="collection=explicit")
            assert fc.lookup("/hot", "c.bin").attributes.collection == \
                "explicit"
            fc.put_data("/cold/d.bin", b"d" * 50)
            assert fc.lookup("/cold", "d.bin").attributes.collection == ""
            run("fs.configure -locationPrefix /hot/special/ -delete -apply")
            wait_rules(filer, 1)
            run("fs.configure -delete")
        finally:
            fc.close()

    o = _both(stacks, tmp_path, scenario)
    assert "applied to /etc/seaweedfs/filer.conf" in o[0]
    assert "/hot/" in o[2] and "special" in o[2] and "dry run" in o[2]
    assert "special" not in o[3]
    assert "-delete needs -locationPrefix" in o[4]


def test_fs_configure_rejects_bad_rules(stacks, tmp_path):
    import urllib.error
    import urllib.request

    def scenario(pkg, stack, run, tmp):
        run("fs.configure -locationPrefix /x/ -ttl 5x -apply")
        run("fs.configure -locationPrefix /x/ -replication 9zz -apply")
        req = urllib.request.Request(
            f"http://{stack[2].url}/ttltest.bin?ttl=abc", data=b"x",
            method="PUT")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400

    o = _both(stacks, tmp_path, scenario)
    assert o[0].startswith("error:") and "5x" in o[0]
    assert o[1].startswith("error:")


def test_fs_meta_cat(stacks, tmp_path):
    def scenario(pkg, stack, run, tmp):
        fc = FilerClient(stack[2].url)
        try:
            fc.put_data("/mc/x.txt", b"meta-cat-me")
            run("fs.meta.cat /mc/x.txt")
            run("fs.meta.cat /mc/none.txt")
        finally:
            fc.close()

    o = _both(stacks, tmp_path, scenario)
    doc = json.loads(o[0])
    assert doc["name"] == "x.txt" and doc["chunks"][0]["fileId"]
    assert o[1].startswith("error:") and "not found" in o[1]


def test_shell_cli_takes_filer(stacks, capsys):
    """``shell -master ... -filer ...`` runs ``fs.*`` in one session; the
    same ``-c`` line through both packages' CLIs prints the same."""
    from seaweedfs_tpu.shell import cli as jax_cli

    master, _, filer = stacks["port"]
    fc = FilerClient(filer.url)
    fc.put_data("/cli/f.txt", b"via the cli")
    fc.close()
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        assert main(["-master", master.url, "-filer", filer.url, "-c",
                     "fs.ls -l /cli; fs.cat /cli/f.txt; fs.du /cli"]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert "via the cli" in outs["port"] and "total 1" in outs["port"]
    assert cli.main(["-master", master.url, "-c", "fs.ls /"]) == 1
    assert "no filer configured" in capsys.readouterr().err


def test_fs_tree_and_bucket_commands(stacks, tmp_path):
    """``s3.bucket.create|list|delete`` beside ``fs.tree``: the JAX
    test's bucket steps through both shells, lines equal."""
    def scenario(pkg, stack, run, tmp):
        run("s3.bucket.create -name shellbkt")
        fc = FilerClient(stack[2].url)
        try:
            fc.put_data("/buckets/shellbkt/obj1.txt", b"one")
            fc.put_data("/buckets/shellbkt/sub/obj2.txt", b"twotwo")
            run("s3.bucket.list")
            run("fs.tree /buckets/shellbkt")
            run("s3.bucket.create -name shellbkt")
            run("s3.bucket.delete -name shellbkt")
            run("s3.bucket.delete -name shellbkt -force")
            run("s3.bucket.delete -name shellbkt")
            assert fc.lookup("/buckets", "shellbkt") is None
        finally:
            fc.close()

    outs = _both(stacks, tmp_path, scenario)
    assert outs[0] == "created bucket shellbkt\n"
    assert "shellbkt  9 bytes, 2 objects" in outs[1]
    assert outs[1].endswith("1 buckets\n")
    assert "1 directories, 2 files" in outs[2]
    assert "exists" in outs[3] and outs[3].startswith("error:")
    assert "not empty" in outs[4]
    assert outs[5] == "deleted bucket shellbkt\n"
    assert "not found" in outs[6]


def test_s3_configure_and_clean_uploads(stacks, tmp_path):
    """``s3.configure`` (dry run, -apply, -delete, -reset, refusals) and
    ``s3.clean.uploads`` over aged scaffolding, through both shells."""
    def scenario(pkg, stack, run, tmp):
        run("s3.configure -user ann -access_key AK1 -secret_key SK1 "
            "-actions Read,Write:b1")
        run("s3.configure -user ann -access_key AK1 -secret_key SK1 "
            "-actions Read,Write:b1 -apply")
        run("s3.configure -user bob -access_key AK2 -secret_key SK2 "
            "-apply")
        run("s3.configure -user ann -delete -apply")
        run("s3.configure -user cat")
        run("s3.configure -delete")
        fc = FilerClient(stack[2].url)
        try:
            fc.put_data("/etc/s3/identities.json", b"{broken")
            run("s3.configure -user dan -access_key A -secret_key S")
            run("s3.configure -reset -apply")
            # two uploads' scaffolding as the gateway lays it out: one
            # idle for two days, one fresh
            now = int(time.time())
            for upload, age in (("stale01", 48 * 3600), ("fresh01", 0)):
                fc.mkdir("/buckets/.uploads", upload)
                fc.put_data(f"/buckets/.uploads/{upload}/00001.part",
                            b"p" * 10)
                marker = fc.lookup(f"/buckets/.uploads/{upload}",
                                   "00001.part")
                marker.extended["key"] = b"k.bin"
                marker.extended["bucket"] = b"b1"
                for e in (marker, fc.lookup("/buckets/.uploads", upload)):
                    e.attributes.mtime = now - age
                    fc.create(f"/buckets/.uploads/{upload}"
                              if e.name != upload else "/buckets/.uploads",
                              e)
            run("s3.clean.uploads -timeAgo 24h")
            run("s3.clean.uploads -timeAgo 24h -force")
            run("s3.clean.uploads -timeAgo 1x")
            assert fc.lookup("/buckets/.uploads", "stale01") is None
            assert fc.lookup("/buckets/.uploads", "fresh01") is not None
        finally:
            fc.close()

    outs = _both(stacks, tmp_path, scenario)
    assert outs[0].endswith("dry run (use -apply to persist)\n")
    assert '"name": "ann"' in outs[1] and "applied to" in outs[1]
    assert '"name": "ann"' not in outs[3] and '"name": "bob"' in outs[3]
    assert "required" in outs[4] and "needs -user" in outs[5]
    assert "invalid JSON" in outs[6] and "-reset" in outs[6]
    assert '"identities": []' in outs[7]
    assert "upload stale01" in outs[8] and "(dry run; use -force)" in outs[8]
    assert "1 stale uploads aborted, 1 active kept" in outs[9]
    assert "bad -timeAgo" in outs[10]
