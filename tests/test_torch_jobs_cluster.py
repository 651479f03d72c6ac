"""The port's jobs plane on live clusters, against the JAX package's, on
the CPU: distributed seals by port workers (and JAX workers under a port
master, and port workers under a JAX master) sha256-equal to a JAX
offline ``encode_volume`` of the same ``.dat``; a worker killed
mid-sweep; the stuck-task fault of the reference against the port's
repair; each of the six task kinds run by a port worker; and the job and
scrub shell commands printing the same lines in both shells. Port
servers run ``device="cpu"``."""

import hashlib
import io
import re
import shutil
import time
import urllib.request
from pathlib import Path

import pytest

from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.pipeline.encode import encode_volume as jax_encode_volume
from seaweedfs_tpu.shell import cluster_commands as jax_cluster_commands
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu_torch.cluster import jobs, master, volume_server
from seaweedfs_tpu_torch.shell import cluster_commands
from seaweedfs_tpu_torch.storage import ec_files, store
from seaweedfs_tpu_torch.storage import volume as volume_mod
from seaweedfs_tpu_torch.util import faults

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
CLUSTER = {"jax": (jax_master, jax_volume_server, jax_store),
           "port": (master, volume_server, store)}
SHELL = {"jax": jax_cluster_commands, "port": cluster_commands}
FAULTS = {"jax": jax_faults, "port": faults}
SEALED = [ec_files.shard_ext(i) for i in range(14)] + [".ecx", ".vif"]


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _wait_for(pred, timeout=30.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(autouse=True)
def _clean_faults():
    for mod in FAULTS.values():
        mod.clear()
    yield
    for mod in FAULTS.values():
        mod.clear()


def _volumes(d: Path, collection: str, vids, n=10, seed=0):
    """Seeded volumes of ``n`` needles in ``d`` before its server
    starts."""
    d.mkdir(parents=True, exist_ok=True)
    for vid in vids:
        volume_mod.generate_synthetic_volume(
            d / store.volume_base_name(vid, collection), vid, n,
            avg_size=2500, seed=seed + vid).close()


def _start(tmp_path, master_pkg, worker_pkgs, volumes=(), **ms_kw):
    """A ``master_pkg`` master and one server per ``worker_pkgs`` entry
    (racks r0, r1, ...), each joined in turn; ``volumes[i]`` is
    ``(collection, vids)`` made in server i's directory first."""
    ms = CLUSTER[master_pkg][0].MasterServer(
        port=_free_port_pair(), volume_size_limit_mb=64,
        pulse_seconds=PULSE, seed=1, **ms_kw).start()
    servers = []
    for i, pkg in enumerate(worker_pkgs):
        _m, vs_mod, st_mod = CLUSTER[pkg]
        d = tmp_path / f"{pkg}{i}"
        d.mkdir(parents=True)
        if i < len(volumes):
            _volumes(d, *volumes[i])
        st = st_mod.Store([d], max_volumes=8)
        st.load_existing()
        kw = dict(device="cpu") if pkg == "port" else {}
        servers.append(vs_mod.VolumeServer(
            st, port=_free_port_pair(), master_url=ms.url,
            data_center="dc1", rack=f"r{i}", pulse_seconds=PULSE,
            job_poll_seconds=0.1, **kw).start())
        _wait_for(lambda: len(ms.topology.nodes) == i + 1,
                  what="volume server registration")
    for vs in servers:
        vs.heartbeat_now()
    return ms, servers


def _stop(ms, servers):
    for vs in servers:
        try:
            vs.stop()
        except Exception:  # noqa: BLE001 — some are stopped mid-test
            pass
    ms.stop()


def _job(ms, job_id):
    return next(j for j in ms.jobs.to_map()["jobs"] if j["jobId"] == job_id)


def _wait_job(ms, job_id, timeout=60.0):
    return _wait_for(
        lambda: (lambda j: j if j["state"] in ("done", "failed",
                                               "cancelled") else None)(
            _job(ms, job_id)), timeout, f"job {job_id} to end")


def _jax_seal(base: Path, tmp: Path) -> dict:
    """sha256 of a JAX offline seal of a copy of ``base``'s volume."""
    ref = tmp / "ref" / base.name
    ref.parent.mkdir(parents=True, exist_ok=True)
    for ext in (".dat", ".idx"):
        shutil.copyfile(str(base) + ext, str(ref) + ext)
    jax_encode_volume(ref)
    return {n: _sha(str(ref) + n) for n in SEALED}


def _sealed(base: Path) -> dict:
    return {n: _sha(str(base) + n) for n in SEALED}


@pytest.mark.parametrize("master_pkg,worker_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_distributed_sweep_matches_jax_offline_seal(tmp_path, master_pkg,
                                                    worker_pkg):
    """JAX ``tests/test_jobs.py:392`` (without the cache-invalidation
    fan-out) through the port shell's ``ec.encode -distributed``: two
    workers split a 4-volume sweep, the job ends ``done``, the topology
    shows 4 EC volumes, the master's ``/metrics`` counts 4 done tasks,
    and every volume's shards, ``.ecx`` and ``.vif`` are sha256-equal to
    a JAX offline seal of the same ``.dat``."""
    ms, servers = _start(tmp_path, master_pkg, [worker_pkg] * 2,
                         volumes=[("sweep", (1, 2)), ("sweep", (3, 4))])
    out = io.StringIO()
    env = cluster_commands.ClusterEnv(master_url=ms.url, out=out)
    try:
        cluster_commands.run_cluster_command(
            env, "ec.encode -distributed -collection sweep -parallel 2")
        lines = out.getvalue().splitlines()
        assert lines[0] == "job j1: distributed ec.encode over 4 volume(s)"
        assert lines[-1] == "job j1 done: 4 done"
        tasks = _job(ms, "j1")["tasks"]
        assert {t["state"] for t in tasks} == {"done"}
        assert {t["worker"] for t in tasks} == {vs.url for vs in servers}
        _wait_for(lambda: len(ms.topology.ec_locations) == 4,
                  what="EC shards in topology")
        with urllib.request.urlopen(f"http://{ms.url}/metrics") as r:
            text = r.read().decode()
        assert 'seaweed_jobs_tasks{kind="ec_encode",state="done"} 4' \
            in text
        for vs in servers:
            for (col, vid), vol in list(vs.store.volumes.items()):
                base = Path(vol.base)
                assert _sealed(base) == _jax_seal(base, tmp_path / str(vid))
                assert vs.store.ec_mounts[(col, vid)].shard_ids == \
                    set(range(14))
    finally:
        env.close()
        _stop(ms, servers)


def test_worker_death_mid_sweep_hands_the_task_to_the_survivor(tmp_path):
    """JAX ``tests/test_chaos_integration.py:161-249`` with port servers:
    the victim dies holding the lease, the lease expires, the task goes
    to the surviving holder (the victim stays excluded while the
    survivor lives), and the survivor's shards are sha256-equal to a
    JAX offline seal of its replica."""
    ms, servers = _start(tmp_path, "port", ["port", "port"],
                         volumes=[("sweep", (5,)), ("sweep", (5,))])
    victim, survivor = servers
    try:
        for vs in servers:
            vs.job_worker.stop()
        ms.jobs.lease_seconds = 1.0
        base = Path(survivor.store.get_volume(5, "sweep").base)
        ref = _jax_seal(base, tmp_path)
        ms.jobs.submit("ec_encode", [5], collection="sweep")
        task = ms.jobs.claim(victim.url)
        assert task is not None and task["kind"] == "ec_encode"
        victim.stop()
        survivor.job_worker.start()
        job = _wait_job(ms, "j1")
        assert job["state"] == "done", job
        t = job["tasks"][0]
        assert t["worker"] == survivor.url
        assert victim.url in t["excluded"]
        assert t["attempts"] == 2
        assert ms.jobs.expired_total >= 1
        shards = _wait_for(
            lambda: (lambda s: s if len(s) == 14 else None)(
                dict(ms.topology.ec_locations.get(5, {}))),
            what="all shards in the topology")
        assert all(urls == {survivor.url} for urls in shards.values())
        assert _sealed(base) == ref
    finally:
        _stop(ms, servers)


@pytest.mark.parametrize("fault", ["mesh", "once"])
def test_single_holder_fault_ends_in_the_port_and_wedges_in_jax(tmp_path,
                                                                 fault):
    """The stuck-task fault on live clusters: volume 7 lives on A only,
    B is idle. ``mesh``: ``-mesh 2,2`` cannot tile either package's
    devices, so every attempt fails — the port's job ends ``failed``
    after ``max_attempts`` claims by A, each with the
    ``MeshConfigError`` text; the JAX job stays active with its task
    pending after one attempt. ``once``: one injected writer fault
    (``crash.ec.writeback``, ``error#1``) — the port's second attempt on
    A completes the seal, sha256-equal to a JAX offline seal, while the
    JAX task waits for a worker it will never get."""
    params = {"mesh": "2,2"} if fault == "mesh" else {}
    got = {}
    for pkg in ("port", "jax"):
        ms, servers = _start(tmp_path / pkg, pkg, [pkg, pkg],
                             volumes=[("c", (7,))])
        a = servers[0]
        try:
            ref = _jax_seal(Path(a.store.get_volume(7, "c").base),
                            tmp_path / pkg)
            if fault == "once":
                FAULTS[pkg].inject("crash.ec.writeback", "error#1")
            t0 = time.time()
            ms.jobs.submit("ec_encode", [7], collection="c", params=params)
            if pkg == "port":
                job = _wait_job(ms, "j1")
            else:
                _wait_for(lambda: _job(ms, "j1")["tasks"][0]["excluded"],
                          what="the first attempt to fail")
                time.sleep(1.5)          # many polls by both workers
                job = _job(ms, "j1")
            got[pkg] = (job, time.time() - t0, [
                f for vs in servers for f in getattr(
                    vs.job_worker, "finished", [])], a.url)
            if pkg == "port" and fault == "once":
                assert _sealed(Path(a.store.get_volume(7, "c").base)) == ref
        finally:
            _stop(ms, servers)
    jjob, _, _, jax_a = got["jax"]
    assert jjob["state"] == "active"
    assert jjob["tasks"][0]["state"] == "pending"
    assert jjob["tasks"][0]["attempts"] == 1
    assert jjob["tasks"][0]["excluded"] == [jax_a]
    pjob, seconds, finished, port_a = got["port"]
    t = pjob["tasks"][0]
    assert t["excluded"] == [port_a]
    if fault == "mesh":
        assert (pjob["state"], t["state"], t["attempts"]) == \
            ("failed", "failed", 3)
        assert t["error"].startswith("MeshConfigError: mesh dp=2,sp=2 "
                                     "cannot tile the 1 local device(s)")
        assert [f["ok"] for f in finished] == [False] * 3
        assert all(f["launches"] == {} for f in finished)
        assert "MeshConfigError" in jjob["tasks"][0]["error"]
    else:
        assert (pjob["state"], t["attempts"]) == ("done", 2)
        assert [f["ok"] for f in finished] == [False, True]
        assert "FaultError" in finished[0]["error"]
    assert seconds < 20


def test_each_task_kind_runs_on_a_port_worker(tmp_path):
    """ec_encode, ec_rebuild, vacuum, replicate, replica_drop and scrub,
    each a job that a port worker claims and runs through the server's
    own methods."""
    ms, servers = _start(tmp_path, "port", ["port", "port"],
                         volumes=[("k", (1, 2, 3)), ("k", (3,))])
    a, b = servers

    def run(kind, vids, **kw):
        jid = ms.jobs.submit(kind, vids, collection="k", **kw)["jobId"]
        job = _wait_job(ms, jid)
        assert job["state"] == "done", job
        for vs in servers:
            vs.heartbeat_now()
        return job

    try:
        # ec_encode on A's volume 1
        run("ec_encode", [1])
        base1 = Path(a.store.get_volume(1, "k").base)
        sealed = _sealed(base1)
        assert sealed == _jax_seal(base1, tmp_path / "1")

        # ec_rebuild: shard 3 gone from disk and from the mount
        a.store.unmount_ec_shards(1, [3], "k")
        ec_files.shard_path(base1, 3).unlink()
        a.heartbeat_now()
        _wait_for(lambda: not a.ec_shard_peers(1, 3),
                  what="shard 3 to leave the master's view")
        run("ec_rebuild", [1])
        assert _sha(ec_files.shard_path(base1, 3)) == sealed[".ec03"]

        # vacuum: half of volume 2's needles deleted on A
        vol2 = a.store.get_volume(2, "k")
        keys = sorted(e.key for e in vol2.nm.live_entries())
        for key in keys[::2]:
            a.store.delete_needle(2, key, "k")
        assert a.store.garbage_ratio(2, "k") > 0
        run("vacuum", [2])
        assert a.store.garbage_ratio(2, "k") == 0
        assert sorted(e.key for e in a.store.get_volume(2, "k")
                      .nm.live_entries()) == keys[1::2]

        # replicate volume 2 to B, then drop one replica
        job = run("replicate", [2])
        assert job["tasks"][0]["worker"] == b.url
        for ext in (".dat", ".idx"):
            assert _sha(str(b.store.get_volume(2, "k").base) + ext) == \
                _sha(str(a.store.get_volume(2, "k").base) + ext)
        run("replica_drop", [2])
        holders = [vs for vs in servers if vs.store.has_volume(2, "k")]
        assert len(holders) == 1
        _wait_for(lambda: len(ms.topology.lookup_volume(2, "k")) == 1,
                  what="one replica left in the topology")

        # scrub: one needle of volume 3 rotten on A, repaired from B
        b.job_worker.stop()
        vol3 = a.store.get_volume(3, "k")
        victim = sorted(e.key for e in vol3.nm.live_entries())[4]
        rec, off = vol3.read_record(victim)
        vol3.sync()
        with open(str(vol3.base) + ".dat", "r+b") as f:
            f.seek(off + 30)
            byte = f.read(1)
            f.seek(off + 30)
            f.write(bytes([byte[0] ^ 0xFF]))
        job = run("scrub", [3], params={"rate_bytes_per_second": 0})
        assert job["tasks"][0]["worker"] == a.url
        assert a.store.get_volume(3, "k").read_record(victim)[0] == rec
        qdir = Path(str(vol3.base) + ".quarantine")
        assert qdir.is_dir() and list(qdir.iterdir())
        # and the EC form of volume 1, against its sidecar baseline
        run("scrub", [1])
        assert (Path(str(base1) + ".scrub")).exists()
        kinds = [f["kind"] for vs in servers
                 for f in vs.job_worker.finished]
        assert sorted(set(kinds)) == sorted(jobs.KINDS)
    finally:
        _stop(ms, servers)


def test_distributed_mesh_one_by_one_seals_on_the_cpu(tmp_path):
    """``ec.encode -distributed -mesh 1,1``: the worker seals under a
    1 x 1 split of its one CPU device, sha256-equal to a JAX offline
    seal; a bad spec is refused in the shell, as in JAX."""
    ms, servers = _start(tmp_path, "port", ["port"],
                         volumes=[("m", (9,))])
    try:
        errs = {}
        for pkg in SHELL:
            env = SHELL[pkg].ClusterEnv(master_url=ms.url,
                                        out=io.StringIO())
            with pytest.raises(Exception) as ei:
                SHELL[pkg].run_cluster_command(
                    env, "ec.encode -distributed -volumeId 9 -mesh 2x2")
            errs[pkg] = str(ei.value)
            env.close()
        assert errs["port"] == errs["jax"]
        assert "bad mesh spec" in errs["port"]
        out = io.StringIO()
        env = cluster_commands.ClusterEnv(master_url=ms.url, out=out)
        cluster_commands.run_cluster_command(
            env, "ec.encode -distributed -collection m -volumeId 9 "
                 "-mesh 1,1")
        env.close()
        assert out.getvalue().splitlines()[-1] == "job j1 done: 1 done"
        assert _job(ms, "j1")["tasks"][0]["params"] == {"mesh": "1,1"}
        base = Path(servers[0].store.get_volume(9, "m").base)
        assert _sealed(base) == _jax_seal(base, tmp_path)
    finally:
        _stop(ms, servers)


#: Commands that change the master's jobs, run by each shell in turn.
JOB_SCRIPT = [
    "job.submit vacuum -volumeId 4,2 -parallel 1",
    "job.pause -job {job}", "job.pause -job {job}",
    "job.resume -job {job}", "job.cancel -job {job}",
    "job.resume -job {job}",
    "scrub.start -volumeId 3 -rate 1000",
]
#: Read-only commands, run by both shells on the final state.
STATUS_SCRIPT = ["job.status", "job.status -job j1", "job.status -job j4",
                 "scrub.status", "scrub.status -collection other"]


@pytest.mark.parametrize("master_pkg", ["port", "jax"])
def test_shells_print_the_same_job_lines(tmp_path, master_pkg):
    """The job and scrub commands through the JAX shell and then the
    port shell against one master with no servers (nothing runs): the
    same lines from each command, the two shells' submissions differing
    only in their job ids (JAX's j1 and j2, the port's j3 and j4); then
    every status command printing exactly the same in both shells, and
    the same errors."""
    ms = CLUSTER[master_pkg][0].MasterServer(
        port=_free_port_pair(), pulse_seconds=PULSE, seed=1).start()
    lines, status, errs = {}, {}, {}
    try:
        for pkg in ("jax", "port"):
            out = io.StringIO()
            env = SHELL[pkg].ClusterEnv(master_url=ms.url, out=out)
            job, lines[pkg] = None, []
            for line in JOB_SCRIPT:
                SHELL[pkg].run_cluster_command(env, line.format(job=job))
                printed = out.getvalue().splitlines()
                out.truncate(0)
                out.seek(0)
                if line.startswith("job.submit"):
                    job = printed[0].split()[1].rstrip(":")
                lines[pkg].append(printed)
            env.close()
        for pkg in ("jax", "port"):
            out = io.StringIO()
            env = SHELL[pkg].ClusterEnv(master_url=ms.url, out=out)
            for line in STATUS_SCRIPT:
                SHELL[pkg].run_cluster_command(env, line)
            status[pkg] = out.getvalue().splitlines()
            errs[pkg] = []
            for line in ("job.pause -job j99", "job.status -job j99",
                         "job.submit defrag -volumeId 1",
                         "job.submit vacuum", "job.cancel",
                         "scrub.start"):
                with pytest.raises(Exception) as ei:
                    SHELL[pkg].run_cluster_command(env, line)
                errs[pkg].append(str(ei.value))
            env.close()
    finally:
        ms.stop()
    assert [[re.sub(r"\bj([12])\b",
                    lambda m: f"j{int(m.group(1)) + 2}", x) for x in block]
            for block in lines["jax"]] == lines["port"]
    assert status["port"] == status["jax"]
    assert errs["port"] == errs["jax"]
    text = "\n".join([x for block in lines["port"] for x in block]
                     + status["port"])
    for needle in ("job j3: 2 vacuum task(s) queued", "job j3 paused",
                   "job j3 active", "job j3 cancelled",
                   "scrub j4: 1 volume(s) queued",
                   "j1: vacuum [default] cancelled (2 pending)",
                   "j1.t1: vacuum volume 2 pending (0% on -, attempt 0)",
                   "j4.t1: scrub volume 3 pending (0% on -, attempt 0)",
                   "j4: [default] active (1 pending)",
                   "policy: off, 0 tick(s), 0 recent action(s)",
                   "candidate volumes: 0"):
        assert needle in text, needle
