"""The port's cluster shell (``shell/cluster_commands.py``, ``shell -master``)
against the JAX package's, on the CPU.

The EC lifecycle runs three ways — the port shell over a port master and
port servers, the JAX shell over that port cluster, the port shell over
a JAX cluster — and each sealed file is sha256-equal to a JAX offline
seal of the same ``.dat``. The shells print the same lines on clusters
built alike, and the admin lease behaves as in the JAX shell. The rest
of the cluster commands (``volume.move``, ``collection.delete``,
``volume.balance``, ``volume.fix.replication``, ``volume.mark``,
``volume.deleteEmpty``, ``volumeServer.evacuate``,
``volume.check.disk``, ``volume.unmount``/``mount``,
``volume.configure.replication``, ``cluster.check``,
``volume.tier.upload``/``download``) run the JAX
``tests/test_cluster_shell.py`` cases through each shell on twin port
clusters: the printed lines (addresses masked) and the resulting
holdings are equal. Port servers run ``device="cpu"``."""

import hashlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.pipeline.encode import encode_volume as jax_encode_volume
from seaweedfs_tpu.shell import cluster_commands as jax_cluster_commands
# both shells register fs.* (the port's help is a strict subset of the
# JAX shell's whichever tests ran first in this process)
from seaweedfs_tpu.shell import fs_commands as jax_fs_commands  # noqa: F401
from seaweedfs_tpu.shell.commands import ShellError as JaxShellError
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu_torch.cluster import master, operation, volume_server
from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch.shell import cluster_commands
from seaweedfs_tpu_torch.shell import fs_commands  # noqa: F401
from seaweedfs_tpu_torch.shell.commands import ShellError
from seaweedfs_tpu_torch.storage import ec_files, store

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
REPO = Path(__file__).resolve().parent.parent
CLUSTER = {"jax": (jax_master, jax_volume_server, jax_store),
           "port": (master, volume_server, store)}
SHELL = {"jax": jax_cluster_commands, "port": cluster_commands}
REMOVED = (0, 5, 11, 13)


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _start(tmp_path, pkg, n=3, seed=1, ports=None):
    """A master and ``n`` servers of package ``pkg`` on dc1, racks
    r0/r1/r0, joined one at a time so the topology's order is fixed
    (on ``ports`` when given)."""
    m_mod, vs_mod, st_mod = CLUSTER[pkg]
    ms = m_mod.MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                            pulse_seconds=PULSE, seed=seed).start()
    servers = []
    for i in range(n):
        d = tmp_path / f"{pkg}{i}"
        d.mkdir(parents=True)
        kw = dict(device="cpu") if pkg == "port" else {}
        servers.append(vs_mod.VolumeServer(
            st_mod.Store([d], max_volumes=8),
            port=ports[i] if ports else _free_port_pair(),
            master_url=ms.url, data_center="dc1", rack=f"r{i % 2}",
            pulse_seconds=PULSE, **kw).start())
        _wait_for(lambda: len(ms.topology.nodes) == i + 1,
                  what="volume server registration")
    return ms, servers


def _stop(ms, servers):
    for vs in servers:
        vs.stop()
    ms.stop()


def _settle(servers):
    """One synchronous heartbeat from every server: the master's
    topology is current when this returns."""
    for vs in servers:
        vs.heartbeat_now()


def _env(pkg, ms):
    out = io.StringIO()
    return SHELL[pkg].ClusterEnv(master_url=ms.url, out=out), out


def _run(pkg, env, line):
    SHELL[pkg].run_cluster_command(env, line)


def _holdings(servers, vid) -> dict[str, list[int]]:
    out = {}
    for vs in servers:
        for (_c, v), m in vs.store.ec_mounts.items():
            if v == vid:
                out[vs.url] = sorted(m.shard_ids)
    return out


def _blobs(seed, n=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(90_000, 150_000)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


@pytest.mark.parametrize("shell_pkg,cluster_pkg", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_shell_ec_lifecycle(tmp_path, shell_pkg, cluster_pkg):
    """ec.encode -> degraded reads with shards 0, 5, 11 and 13 gone
    everywhere -> ec.rebuild -> ec.decode, as JAX
    ``tests/test_cluster_shell.py::test_shell_ec_lifecycle`` runs it, on
    a volume of about 3 MiB (data in shards 0-2)."""
    ms, servers = _start(tmp_path, cluster_pkg)
    mc = MasterClient(ms.url)
    env, out = _env(shell_pkg, ms)
    try:
        blobs = _blobs(3)
        fids = operation.submit(mc, blobs)
        vid = int(fids[0].split(",")[0])
        keep = [(f, b) for f, b in zip(fids, blobs)
                if int(f.split(",")[0]) == vid]
        assert len(keep) > 15
        owner = next(vs for vs in servers if vs.store.has_volume(vid))
        vol = owner.store.get_volume(vid)
        vol.sync()
        ref = tmp_path / "ref" / Path(vol.base).name
        ref.parent.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copyfile(str(vol.base) + ext, str(ref) + ext)
        orig = {ext: _sha(str(ref) + ext) for ext in (".dat", ".idx")}
        jax_encode_volume(ref)
        names = [ec_files.shard_ext(i) for i in range(14)] + [".ecx", ".vif"]
        want = {n: _sha(str(ref) + n) for n in names}
        # the JAX shell's spread of these nodes is the plan to match
        jenv = jax_cluster_commands.ClusterEnv(master_url=ms.url,
                                               out=io.StringIO())
        plan = jax_cluster_commands._spread_targets(
            jenv.collect_ec_nodes(), 14)
        jenv.close()

        _run(shell_pkg, env, "lock")
        _run(shell_pkg, env, f"ec.encode -volumeId {vid}")
        _settle(servers)
        assert f"ec.encode volume {vid}: 14 shards over 3 servers" in \
            out.getvalue()
        assert not any(vs.store.has_volume(vid) for vs in servers)
        held = _holdings(servers, vid)
        assert held == {url: [s for s, n in enumerate(plan) if n.url == url]
                        for url in {n.url for n in plan}}
        for vs in servers:
            base = vs.store.ec_base(vid)
            if base is None:
                continue
            for n in [ec_files.shard_ext(i) for i in held[vs.url]] + \
                    [".ecx", ".vif"]:
                assert _sha(str(base) + n) == want[n], (vs.url, n)
        _run(shell_pkg, env, "ec.balance")
        _settle(servers)
        counts = [len(s) for s in _holdings(servers, vid).values()]
        assert max(counts) - min(counts) <= 1
        _run(shell_pkg, env, "unlock")

        # shards 0, 5, 11 and 13 gone cluster-wide: every read of the
        # first MiB reconstructs, fetching the shards it lacks from the
        # holders the master names
        for url, sids in _holdings(servers, vid).items():
            gone = [s for s in sids if s in REMOVED]
            if gone:
                st = cluster_commands.ClusterEnv(master_url=ms.url)
                st.volume(url).VolumeEcShardsDelete(
                    vpb.VolumeEcShardsDeleteRequest(volume_id=vid,
                                                    shard_ids=gone))
                st.close()
        _settle(servers)
        assert sorted(ms.topology.lookup_ec_volume(vid)) == \
            [s for s in range(14) if s not in REMOVED]
        _wait_for(lambda: not any(vs.ec_shard_peers(vid, s)
                                  for vs in servers for s in REMOVED),
                  what="the servers' shard-location caches to expire")
        mc.invalidate()
        for fid, blob in keep:
            assert operation.download(mc, fid) == blob
        if cluster_pkg == "port":    # the needles of shard 0 repaired
            assert sum(vs.metrics.counter("ec_intervals_repaired").value
                       for vs in servers) > 0

        _run(shell_pkg, env, "ec.rebuild")
        assert f"ec.rebuild volume {vid}: rebuilt {list(REMOVED)}" in \
            out.getvalue()
        _settle(servers)
        assert sorted(ms.topology.lookup_ec_volume(vid)) == list(range(14))
        for vs in servers:
            base = vs.store.ec_base(vid)
            for s in _holdings(servers, vid).get(vs.url, []):
                assert _sha(ec_files.shard_path(base, s)) == \
                    want[ec_files.shard_ext(s)]

        _run(shell_pkg, env, f"ec.decode -volumeId {vid}")
        _settle(servers)
        back = [vs for vs in servers if vs.store.has_volume(vid)]
        assert len(back) == 1
        vbase = back[0].store.get_volume(vid).base
        assert {e: _sha(str(vbase) + e) for e in (".dat", ".idx")} == orig
        mc.invalidate()
        for fid, blob in keep:
            assert operation.download(mc, fid) == blob
    finally:
        env.close()
        mc.close()
        _stop(ms, servers)


#: an address, or the dashed form a tiered object's key carries
_URL = re.compile(r"127\.0\.0\.1[:-]\d+")


def _masked(text: str, ms, servers) -> list[str]:
    names = {ms.url: "M", **{vs.url: f"S{i}" for i, vs in
                             enumerate(servers)}}
    return [_URL.sub(lambda m: names.get(m.group(0).replace("-", ":"),
                                         "?"), line)
            for line in text.splitlines()]


SCRIPT = ["cluster.status", "volume.list", "collection.list",
          "volume.grow -count 2", "volume.grow -collection pics",
          "volume.list", "collection.list", "ec.encode -volumeId {vid}",
          "ec.balance", "volume.list", "collection.list", "ec.rebuild",
          "ec.decode -volumeId {vid}", "volume.list", "cluster.status",
          "volume.vacuum -garbageThreshold 0.9"]


def test_shells_print_the_same_lines(tmp_path):
    """The same script through each shell on twin port clusters (the
    same seed, servers joined in the same order, the same needles):
    every printed line equal with addresses masked. Read-only commands
    on one cluster print exactly the same in both shells."""
    lines = {}
    for pkg in SHELL:
        ms, servers = _start(tmp_path / pkg, "port", seed=7)
        mc = MasterClient(ms.url)
        env, out = _env(pkg, ms)
        try:
            fids = operation.submit(mc, _blobs(9, n=6))
            vid = int(fids[0].split(",")[0])
            _settle(servers)
            for line in SCRIPT:
                _run(pkg, env, line.format(vid=vid))
                _settle(servers)
            lines[pkg] = _masked(out.getvalue(), ms, servers)
            same, helps = {}, {}
            for shell in SHELL:
                e, o = _env(shell, ms)
                for line in ("volume.list", "collection.list",
                             "cluster.status"):
                    _run(shell, e, line)
                same[shell] = o.getvalue()
                o.truncate(0)
                o.seek(0)
                _run(shell, e, "help")
                helps[shell] = set(o.getvalue().splitlines())
                e.close()
            assert same["port"] == same["jax"]
            # every cluster command of the JAX shell is ported now
            assert helps["port"] == helps["jax"]
        finally:
            env.close()
            mc.close()
            _stop(ms, servers)
    assert lines["port"] == lines["jax"]
    text = "\n".join(lines["port"])
    for needle in ("volume.grow: created volumes [2, 3]",
                   "DataNode S0 volumes=", "ec volume 1 collection=-",
                   "collection pics: 1 volumes", "3 data nodes",
                   "ec.decode volume 1: restored on S",
                   "volume.vacuum: 0 volumes compacted"):
        assert needle in text, needle


@pytest.mark.parametrize("cluster_pkg", ["port", "jax"])
def test_shell_admin_lock(tmp_path, cluster_pkg):
    """JAX ``tests/test_cluster_shell.py:438-510`` with the port shell:
    the lock, its visibility, refusal to a second shell, the lease that
    expires unrenewed, and refusal once a REPL lease was lost."""
    ms, servers = _start(tmp_path, cluster_pkg, n=1)
    env1, out1 = _env("port", ms)
    env2, out2 = _env("port", ms)

    def holder():
        with urllib.request.urlopen(f"http://{ms.url}/cluster/status",
                                    timeout=10) as r:
            return json.loads(r.read())["AdminLockHolder"]

    try:
        _run("port", env1, "lock")
        assert "locked" in out1.getvalue()
        _run("port", env2, "cluster.status")
        assert "admin lock held by" in out2.getvalue()
        with pytest.raises(ShellError, match="locked by"):
            _run("port", env2, "lock")
        with pytest.raises(ShellError, match="locked by"):
            _run("port", env2, "ec.balance")
        _run("port", env2, "volume.list")
        _run("port", env1, "ec.balance")
        _run("port", env1, "unlock")
        assert "unlocked" in out1.getvalue()
        _run("port", env2, "ec.balance")
        _run("port", env2, "unlock")
        assert out2.getvalue().endswith("not locked\n")

        # a lease taken and never renewed expires
        ms.admin_lease_seconds = 0.3
        env1._lock_client = "crashed-shell"
        env1._admin_call("lock")
        with pytest.raises(ShellError, match="locked by"):
            _run("port", env2, "ec.balance")
        _wait_for(lambda: not holder(), what="the lease to expire")
        _run("port", env2, "ec.balance")

        # a REPL lease lost while the shell stalled refuses destructive
        # commands and drops the stale hold
        env1._lock_client = ""
        _run("port", env1, "lock")
        env1._stop_renewer()
        env1._lease_lost = True
        _wait_for(lambda: not holder(), what="the lease to lapse")
        _run("port", env2, "lock")
        with pytest.raises(ShellError, match="lease was lost"):
            _run("port", env1, "ec.balance")
        assert not env1.locked
        _run("port", env2, "unlock")
    finally:
        ms.admin_lease_seconds = 30.0
        env1.close()
        env2.close()
        _stop(ms, servers)


def test_ec_encode_mesh_and_bad_flags_fail_as_in_jax(tmp_path):
    ms, servers = _start(tmp_path, "port", n=1)
    try:
        errs = {}
        for pkg in SHELL:
            env, _ = _env(pkg, ms)
            errs[pkg] = []
            for line in ("ec.encode -volumeId 1 -mesh 2,2",
                         "ec.decode", "nosuch.command", "ec.encode",
                         "ec.encode -volumeId 77"):
                try:
                    _run(pkg, env, line)
                except Exception as e:  # noqa: BLE001 — compare messages
                    errs[pkg].append(str(e))
            env.close()
        assert errs["port"][:4] == errs["jax"][:4]
        assert errs["port"][3] == "ec.encode: -volumeId required " \
            "(or use -distributed)"
        assert "not found" in errs["port"][4] and \
            "not found" in errs["jax"][4]
    finally:
        _stop(ms, servers)


def test_volume_grow_reports_the_masters_reason(tmp_path):
    """JAX ``cmd_volume_grow`` (``shell/cluster_commands.py:985``) posts
    ``/vol/grow`` through the retrying client: a grow the master refuses
    (HTTP 500) is sent again, each time growing anew, and the shell then
    prints only ``HTTP Error 500``. The port sends it once and prints
    the master's reason."""
    ms, servers = _start(tmp_path, "port", n=2)
    try:
        errs = {}
        for pkg in SHELL:
            env, _ = _env(pkg, ms)
            with pytest.raises(Exception) as ei:
                _run(pkg, env, "volume.grow -replication 200")
            errs[pkg] = str(ei.value)
            env.close()
        assert errs["jax"] == "volume.grow: HTTP Error 500: " \
            "Internal Server Error"
        assert errs["port"] == "volume.grow: cannot satisfy replica " \
            "placement 200"
    finally:
        _stop(ms, servers)


def test_master_and_shell_subprocesses(tmp_path):
    """``python -m seaweedfs_tpu_torch master`` with a port server
    joining it, and ``shell -master ... -c`` listing that server; the
    master stops cleanly on SIGTERM."""
    port = _free_port_pair()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master",
         "-port", str(port), "-pulseSeconds", str(PULSE),
         "-volumeSizeLimitMB", "64"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    d = tmp_path / "v"
    d.mkdir()
    vs = None
    try:
        def up():
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/dir/status",
                                       timeout=2).read()
                return True
            except OSError:
                return proc.poll() is not None
        _wait_for(up, timeout=60, what="the master subprocess")
        assert proc.poll() is None, proc.communicate()
        vs = volume_server.VolumeServer(
            store.Store([d]), port=_free_port_pair(),
            master_url=f"127.0.0.1:{port}", pulse_seconds=PULSE,
            device="cpu").start()
        vs.heartbeat_now()
        out = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", f"127.0.0.1:{port}",
             "-c", "volume.grow -count 1; volume.list; cluster.status"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert f"DataNode {vs.url} volumes=1/8" in out.stdout
        assert "1 data nodes" in out.stdout
    finally:
        if vs is not None:
            vs.stop()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0


# ---- the rest of the cluster commands, twin clusters per shell ----


def _placement(servers) -> dict:
    """Which masked server holds which volume and EC shards."""
    return {f"S{i}": (sorted(vs.store.volumes),
                      sorted((c, v, tuple(sorted(m.shard_ids)))
                             for (c, v), m in vs.store.ec_mounts.items()))
            for i, vs in enumerate(servers)}


def _twin(tmp_path, scenario, seed=1):
    """``scenario(ms, servers, mc, run)`` once per shell, each on its own
    port cluster built alike; ``run(line)`` returns the command's output
    (``error: ...`` on a refusal). The masked transcripts, the holdings
    and the scenario's results must be equal; returns the port's
    (transcript lines per command, result)."""
    got = {}
    for pkg in SHELL:
        # commands that break ties by a server's address (volume.balance
        # sorts its nodes by count, then url) choose alike on both twins
        # when the join order is the address order
        ports = sorted((_free_port_pair() for _ in range(3)),
                       key=lambda p: f"127.0.0.1:{p}")
        ms, servers = _start(tmp_path / pkg, "port", seed=seed,
                             ports=ports)
        mc = MasterClient(ms.url)
        env, out = _env(pkg, ms)
        outs = []

        def run(line, pkg=pkg, env=env, out=out, outs=outs, ms=ms,
                servers=servers):
            out.truncate(0)
            out.seek(0)
            try:
                _run(pkg, env, line)
            except (ShellError, JaxShellError) as e:
                out.write(f"error: {e}\n")
            _settle(servers)
            outs.append("\n".join(_masked(out.getvalue(), ms, servers)))
            return outs[-1]

        try:
            res = scenario(ms, servers, mc, run)
            got[pkg] = (outs, _placement(servers), res)
        finally:
            env.close()
            mc.close()
            _stop(ms, servers)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1:] == got["jax"][1:]
    return got["port"][0], got["port"][2]


def test_volume_balance_and_fix_replication(tmp_path):
    def scenario(ms, servers, mc, run):
        for _ in range(6):
            operation.submit(mc, [b"x" * 500])
            ms.grow_volume()
        _settle(servers)
        run("volume.balance")
        counts = [len(vs.store.volumes) for vs in servers]
        a = operation.assign(mc, collection="r", replication="010")
        operation.upload(a.url, a.fid, b"fixme", collection="r")
        vid = int(a.fid.split(",")[0])
        _settle(servers)
        holder = next(vs for vs in servers if vs.store.has_volume(vid, "r"))
        holder.store.delete_volume(vid, "r")
        _settle(servers)
        before = sum(vs.store.has_volume(vid, "r") for vs in servers)
        run("volume.fix.replication")
        run("volume.fix.replication")
        after = sum(vs.store.has_volume(vid, "r") for vs in servers)
        return counts, before, after

    outs, (counts, before, after) = _twin(tmp_path, scenario)
    assert max(counts) - min(counts) <= 1
    assert outs[0].startswith("volume.balance: moved ")
    assert (before, after) == (1, 2)
    assert "copied" in outs[1]
    assert "all volumes fully replicated" in outs[2]


def test_stale_pulse_snapshot_does_not_bring_a_deleted_volume_back(
        tmp_path):
    """A pulse snapshot taken before ``delete_volume`` is held at the
    master while ``heartbeat_now`` pushes a newer one: once the master
    has ingested a snapshot without the volume, no later ingestion may
    list it again (the stale pulse used to re-add it, so
    ``volume.fix.replication`` saw two replicas where one was left)."""
    ms, (vs,) = _start(tmp_path, "port", n=1)
    real = ms.ingest_heartbeat
    mu = threading.Lock()
    armed, held, release = [False], threading.Event(), threading.Event()
    stale_in = threading.Event()
    order: list[bool] = []
    try:
        vid = ms.grow_volume()
        _settle([vs])
        key = ("", vid)

        def gated(hb):
            with mu:
                hold, armed[0] = armed[0], False
            if hold:
                held.set()
                release.wait(15)
            with mu:
                resp = real(hb)
                order.append(key in ms.topology.nodes[vs.url].volumes)
            if hold:
                stale_in.set()
            return resp

        ms.ingest_heartbeat = gated
        with mu:
            armed[0] = True
        assert held.wait(10), "no pulse reached the master"
        vs.store.delete_volume(vid)
        pushed = threading.Thread(target=vs.heartbeat_now, daemon=True)
        pushed.start()
        pushed.join(1.0)
        release.set()
        pushed.join(15)
        assert not pushed.is_alive()
        assert stale_in.wait(15), "the held pulse was never ingested"
        _wait_for(lambda: key not in ms.topology.nodes[vs.url].volumes,
                  what="the master to drop the deleted volume")
        with mu:
            seen = list(order)
        gone = seen.index(False)
        assert True not in seen[gone:], seen
    finally:
        release.set()
        _stop(ms, [vs])


def test_volume_move_and_collections(tmp_path):
    def scenario(ms, servers, mc, run):
        a = operation.assign(mc, collection="photos")
        operation.upload(a.url, a.fid, b"move-me", jwt=a.auth,
                         collection="photos")
        _settle(servers)
        run("collection.list")
        vid = int(a.fid.split(",")[0])
        src = a.url
        dst = next(vs.url for vs in servers if vs.url != src)
        run(f"volume.move -volumeId {vid} -collection photos "
            f"-source {src} -target {dst}")
        run(f"volume.move -volumeId {vid} -source {dst} -target {dst}")
        mc.invalidate()
        got = operation.download(mc, a.fid, collection="photos")
        locs = [l["url"] for l in mc.lookup(vid, "photos")]
        run("collection.delete -collection photos")
        mc.invalidate()
        with pytest.raises(KeyError):
            mc.lookup(vid, "photos")
        return got, dst in locs and src not in locs

    outs, res = _twin(tmp_path, scenario)
    assert res == (b"move-me", True)
    assert "photos" in outs[0]
    assert "volume.move: volume" in outs[1] and " -> S" in outs[1]
    assert "source and target are the same" in outs[2]
    assert "collection.delete: photos: 1 volumes, 0 ec volumes" in outs[3]


def test_volume_mark_check_delete_empty(tmp_path):
    def scenario(ms, servers, mc, run):
        fids = operation.submit(mc, [b"y" * 800])
        vid = int(fids[0].split(",")[0])
        ms.grow_volume()
        _settle(servers)
        run(f"volume.mark -volumeId {vid} -readonly")
        holders = [vs for vs in servers if vs.store.has_volume(vid)]
        ro = all(("", vid) in vs.store.readonly for vs in holders)
        run(f"volume.mark -volumeId {vid} -writable")
        rw = all(("", vid) not in vs.store.readonly for vs in holders)
        run("volume.mark -volumeId 999 -readonly")
        run("cluster.check")
        run("volume.deleteEmpty -quietFor 0")
        n0 = sum(len(vs.store.volumes) for vs in servers)
        run("volume.deleteEmpty -force")
        n1 = sum(len(vs.store.volumes) for vs in servers)
        run("volume.deleteEmpty -quietFor 0 -force")
        n2 = sum(len(vs.store.volumes) for vs in servers)
        return (ro, rw, n0 == n1, n2 < n1,
                operation.download(mc, fids[0]) == b"y" * 800)

    outs, res = _twin(tmp_path, scenario)
    assert res == (True, True, True, True, True)
    assert "readonly on S" in outs[0] and "writable on S" in outs[1]
    assert outs[2] == "error: volume 999 not found"
    assert "0 problems" in outs[3]
    assert "dry run" in outs[4]
    # the default quiet period protects the freshly grown volumes
    assert outs[5] == "volume.deleteEmpty: 0 empty volumes deleted"
    assert "(dry run" not in outs[6] and "empty volumes deleted" in outs[6]
    assert not outs[6].endswith(": 0 empty volumes deleted")


def test_cluster_check_reports_deficit(tmp_path):
    def scenario(ms, servers, mc, run):
        a = operation.assign(mc, collection="chk", replication="010")
        operation.upload(a.url, a.fid, b"chk", collection="chk")
        vid = int(a.fid.split(",")[0])
        _settle(servers)
        holder = next(vs for vs in servers
                      if vs.store.has_volume(vid, "chk"))
        holder.store.delete_volume(vid, "chk")
        _settle(servers)
        run("cluster.check")
        run("cluster.check -n 0")
        run("volume.fix.replication")
        run("cluster.check")
        return vid

    outs, vid = _twin(tmp_path, scenario)
    assert f"volume {vid} under-replicated: 1/2 replicas" in outs[0]
    assert "problems found" in outs[0]
    assert "under-replicated" not in outs[1] and "1 problems" in outs[1]
    assert "0 problems" in outs[3]


def test_volume_server_evacuate(tmp_path):
    def scenario(ms, servers, mc, run):
        rng = np.random.default_rng(11)
        blobs = [rng.integers(0, 256, 1200, dtype=np.uint8).tobytes()
                 for _ in range(8)]
        fids = operation.submit(mc, blobs)
        vid = int(fids[0].split(",")[0])
        keep = [(f, b) for f, b in zip(fids, blobs)
                if int(f.split(",")[0]) == vid]
        run(f"ec.encode -volumeId {vid}")
        victim = next(vs for vs in servers
                      if any(v == vid for (_c, v) in vs.store.ec_mounts))
        a = operation.assign(mc)
        operation.upload(a.url, a.fid, b"drain-me", jwt=a.auth)
        _settle(servers)
        run(f"volumeServer.evacuate -node {victim.url}")
        run("volumeServer.evacuate -node 127.0.0.1:1")
        mc.invalidate()
        ok = all(operation.download(mc, f) == b for f, b in keep)
        return (not victim.store.volumes,
                not any(v == vid for (_c, v) in victim.store.ec_mounts),
                ok, operation.download(mc, a.fid) == b"drain-me")

    outs, res = _twin(tmp_path, scenario)
    assert res == (True, True, True, True)
    assert "drained" in outs[1]
    assert "not in topology" in outs[2]


def test_volume_check_disk(tmp_path):
    from seaweedfs_tpu_torch.storage.needle import Needle

    def scenario(ms, servers, mc, run):
        a = operation.assign(mc, collection="cd", replication="010")
        operation.upload(a.url, a.fid, b"both-see-this", collection="cd")
        vid = int(a.fid.split(",")[0])
        _settle(servers)
        holders = [vs for vs in servers if vs.store.has_volume(vid, "cd")]
        va, vb = (h.store.get_volume(vid, "cd") for h in holders)
        run("volume.check.disk -collection cd")
        va.write_needle(Needle(cookie=5, id=987654, data=b"only-on-a"))
        va.write_needle(Needle(cookie=6, id=987655, data=b"deleted-on-b"))
        vb.write_raw_record(va.read_record(987655)[0])
        vb.delete_needle(987655)
        run("volume.check.disk -collection cd")
        dry = vb.nm.get(987654) is None
        run("volume.check.disk -collection cd -fix")
        synced = (vb.read_needle(987654).data == b"only-on-a",
                  va.read_record(987654)[0] == vb.read_record(987654)[0],
                  vb.nm.get(987655) is None)
        run("volume.check.disk -collection cd")
        run("volume.check.disk -collection cd -resolveDeletes")
        run("volume.check.disk -collection cd")
        return len(holders), dry, synced, va.nm.get(987655) is None

    outs, res = _twin(tmp_path, scenario)
    assert res == (2, True, (True, True, True), True)
    assert "0 divergent" in outs[0]
    assert "dry run" in outs[1]
    assert "needles synced" in outs[2] and "deleted elsewhere" in outs[2]
    assert "0 divergent" in outs[3] and "1 unresolved skews" in outs[3]
    assert "1 deletes propagated" in outs[4]
    assert "0 unresolved skews" in outs[5]


def test_volume_configure_replication(tmp_path):
    def scenario(ms, servers, mc, run):
        fids = operation.submit(mc, [b"reconf-me"])
        vid = int(fids[0].split(",")[0])
        _settle(servers)
        holder = next(vs for vs in servers if vs.store.has_volume(vid))
        before = str(holder.store.get_volume(vid)
                     .super_block.replica_placement)
        run(f"volume.configure.replication -volumeId {vid} "
            f"-replication 010")
        after = str(holder.store.get_volume(vid)
                    .super_block.replica_placement)
        run("volume.fix.replication")
        run("volume.configure.replication -volumeId 999 -replication 001")
        return (before, after, sum(vs.store.has_volume(vid)
                                   for vs in servers),
                operation.download(mc, fids[0]))

    outs, res = _twin(tmp_path, scenario)
    assert res == ("000", "010", 2, b"reconf-me")
    assert "-> 010" in outs[0] and "copied" in outs[1]
    assert outs[2] == "error: volume 999 not found"


def test_volume_unmount_mount(tmp_path):
    from seaweedfs_tpu_torch.storage.volume import dat_path

    def scenario(ms, servers, mc, run):
        fids = operation.submit(mc, [b"park-me"])
        vid = int(fids[0].split(",")[0])
        _settle(servers)
        holder = next(vs for vs in servers if vs.store.has_volume(vid))
        base = holder.store.get_volume(vid).base
        run(f"volume.unmount -volumeId {vid} -node {holder.url}")
        parked = (not holder.store.has_volume(vid), dat_path(base).exists())
        mc.invalidate()
        with pytest.raises(Exception):
            operation.download(mc, fids[0])
        run(f"volume.mount -volumeId {vid} -node {holder.url}")
        mc.invalidate()
        return parked, holder.store.has_volume(vid), \
            operation.download(mc, fids[0])

    outs, res = _twin(tmp_path, scenario)
    assert res == ((True, True), True, b"park-me")
    assert "unmounted on S" in outs[0] and "(files kept)" in outs[0]
    assert "mounted on S" in outs[1]


def test_volume_balance_collection_filter(tmp_path):
    def scenario(ms, servers, mc, run):
        for _ in range(4):
            ms.grow_volume(collection="keepme")
        _settle(servers)

        def keepme():
            return {vs.url: sorted(v for (c, v) in vs.store.volumes
                                   if c == "keepme") for vs in servers}

        target = servers[0].url
        for url, vids in keepme().items():
            for vid in vids:
                if url != target:
                    run(f"volume.move -volumeId {vid} -collection keepme "
                        f"-source {url} -target {target}")
        concentrated = len(keepme()[target])
        other = {vs.url: sorted(v for (c, v) in vs.store.volumes
                                if c != "keepme") for vs in servers}
        run("volume.balance -collection somethingelse")
        still = len(keepme()[target])
        run("volume.balance -collection keepme")
        scoped = sorted(len(v) for v in keepme().values())
        return (concentrated, still, scoped[-1] - scoped[0] <= 1,
                other == {vs.url: sorted(v for (c, v) in vs.store.volumes
                                         if c != "keepme")
                          for vs in servers})

    outs, res = _twin(tmp_path, scenario)
    assert res == (4, 4, True, True)
    assert outs[-2] == "volume.balance: moved 0 volumes"


def test_fix_replication_prefers_rack_diversity_and_check_flags(tmp_path):
    def scenario(ms, servers, mc, run):
        a = operation.assign(mc, collection="rr", replication="010")
        operation.upload(a.url, a.fid, b"rack-me", collection="rr")
        vid = int(a.fid.split(",")[0])
        _settle(servers)
        holders = [vs for vs in servers if vs.store.has_volume(vid, "rr")]
        holders[1].store.delete_volume(vid, "rr")
        _settle(servers)
        run("volume.fix.replication")
        new = [vs for vs in servers if vs.store.has_volume(vid, "rr")]
        run("cluster.check")
        return len(holders), len(new), sorted({vs.rack for vs in new})

    outs, res = _twin(tmp_path, scenario)
    assert res == (2, 2, ["r0", "r1"])
    assert "placement violation" not in outs[1] and "0 problems" in outs[1]


def test_volume_tier_upload_and_download(tmp_path):
    """``volume.tier.upload`` to the twin cluster's own S3 gateway and
    ``volume.tier.download`` back (JAX ``cluster_commands.py``): both
    shells print the same lines, the holder serves every needle through
    the tier while the volume is read-only, and the .dat comes back
    sha256-equal."""
    from seaweedfs_tpu_torch.ckpt import GatewayClient
    from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.gateway.s3 import S3Gateway

    blobs = _blobs(21, n=12)

    def scenario(ms, servers, mc, run):
        fids = operation.submit(mc, blobs, collection="cold")
        vid = int(fids[0].split(",")[0])
        _settle(servers)
        holder = next(vs for vs in servers if vs.store.has_volume(vid,
                                                                  "cold"))
        base = holder.store.get_volume(vid, "cold").base
        dat = _sha(str(base) + ".dat")
        filer = FilerServer(Filer(), port=_free_port_pair(),
                            master_url=ms.url).start()
        gw = S3Gateway(filer.url, port=_free_port_pair()).start()
        try:
            GatewayClient(gw.url).ensure_bucket("coldstore")
            run("volume.tier.upload -volumeId 99 -dest x/y")
            run(f"volume.tier.upload -volumeId {vid} -collection cold "
                f"-dest {gw.url}/coldstore")
            tiered = (not Path(str(base) + ".dat").exists(),
                      holder.store.get_volume(vid, "cold").backend_kind,
                      holder.store.is_readonly(vid, "cold"))
            reads = all(operation.download(mc, f, collection="cold") == b
                        for f, b in zip(fids, blobs))
            run(f"volume.tier.download -volumeId {vid} -collection cold")
            back = (_sha(str(base) + ".dat") == dat,
                    holder.store.get_volume(vid, "cold").backend_kind,
                    holder.store.is_readonly(vid, "cold"))
        finally:
            gw.stop()
            filer.stop()
        return tiered, reads, back

    outs, (tiered, reads, back) = _twin(tmp_path, scenario)
    assert outs[0] == "error: volume 99 not found"
    assert re.fullmatch(r"volume\.tier\.upload \d+ on S\d: \d+ bytes -> "
                        r"\?/coldstore/cold_\d+\.S\d\.dat", outs[1]), outs[1]
    assert tiered == (True, "s3", True) and reads
    assert "bytes local again" in outs[2]
    assert back == (True, "disk", False)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_a_snapshot_taken_before_a_grow_keeps_the_new_volume(
        tmp_path, monkeypatch, server_pkg):
    """The cause of the flake in the tier test above: a heartbeat
    snapshot taken before ``AllocateVolume`` and ingested after the
    master's optimistic registration took the new volume out of the
    layout, so the next assign grew a second volume and the blobs split
    between the two (the .dat sizes then differed between the twins).
    The port's master keeps a grown volume until a snapshot holds it,
    whichever package's server sent the stale one."""
    _m, vs_mod, st_mod = CLUSTER[server_pkg]
    ms = master.MasterServer(port=_free_port_pair(), pulse_seconds=30,
                             seed=1).start()
    d = tmp_path / "v"
    d.mkdir()
    kw = dict(device="cpu") if server_pkg == "port" else {}
    vs = vs_mod.VolumeServer(
        st_mod.Store([d], max_volumes=8), port=_free_port_pair(),
        master_url=ms.url, pulse_seconds=30, **kw).start()
    try:
        _wait_for(lambda: len(ms.topology.nodes) == 1,
                  what="volume server registration")
        real = vs._heartbeat_snapshot
        taken = threading.Event()

        def slow_delivery():
            snap = real()
            taken.set()
            time.sleep(0.5)     # the snapshot is in flight meanwhile
            return snap

        monkeypatch.setattr(vs, "_heartbeat_snapshot", slow_delivery)
        pusher = threading.Thread(target=vs.heartbeat_now)
        pusher.start()
        assert taken.wait(5)
        vid = ms.grow_volume("c")
        pusher.join(10)
        assert not pusher.is_alive()
        assert ms.topology.pick_for_write("c")[0] == vid
        assert ms.assign(collection="c")["fid"].startswith(f"{vid},")
        node = ms.topology.nodes[vs.url]
        assert ("c", vid) in node.unconfirmed
        monkeypatch.setattr(vs, "_heartbeat_snapshot", real)
        vs.heartbeat_now()
        assert not node.unconfirmed
    finally:
        vs.stop()
        ms.stop()


def test_an_unconfirmed_volume_goes_two_pulses_after_the_grow():
    """A grown volume that no snapshot ever holds leaves the layout at
    the first snapshot after the grace (two pulses, at least 10 s), as
    any volume a snapshot lacks; an unregistered one goes at once."""
    from seaweedfs_tpu_torch.cluster.topology import (
        Topology, TopologyError, VolumeInfo)

    now = [1000.0]
    topo = Topology(pulse_seconds=1.0, clock=lambda: now[0])
    topo.register_heartbeat("n1:1", max_volume_count=8)
    for vid in (1, 2):
        topo.register_volume("n1:1", VolumeInfo(
            id=vid, collection="c", replica_placement="000"))
    now[0] += 9.5
    topo.register_heartbeat("n1:1", max_volume_count=8)
    assert sorted(topo.nodes["n1:1"].volumes) == [("c", 1), ("c", 2)]
    topo.unregister_volume("n1:1", 2, "c")
    assert sorted(topo.nodes["n1:1"].unconfirmed) == [("c", 1)]
    now[0] += 1.0
    topo.register_heartbeat("n1:1", max_volume_count=8)
    assert topo.nodes["n1:1"].volumes == {}
    assert topo.nodes["n1:1"].unconfirmed == {}
    with pytest.raises(TopologyError):
        topo.pick_for_write("c", "000")
    assert topo.check_indexes() == []
