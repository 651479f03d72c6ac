"""The port (seaweedfs_tpu_torch) and chip_smoke.py import neither JAX nor
anything of the JAX package (seaweedfs_tpu), and the port's entry points
never fall back to the CPU when asked for the card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import seaweedfs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    seaweedfs_tpu_torch.__path__, "seaweedfs_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "seaweedfs_tpu" or m.startswith("seaweedfs_tpu.")
             or m == "jax" and sys.modules[m] is not None
             or m.startswith("jax.") or m.startswith("jaxlib"))
print(len(names), "modules;", "bad:", bad)
new = {"seaweedfs_tpu_torch.pipeline.batch", "seaweedfs_tpu_torch.pipeline.pipe",
       "seaweedfs_tpu_torch.ops.rs_torch", "seaweedfs_tpu_torch.__main__",
       "seaweedfs_tpu_torch.shell", "seaweedfs_tpu_torch.shell.cli",
       "seaweedfs_tpu_torch.shell.commands",
       "seaweedfs_tpu_torch.storage.backend",
       "seaweedfs_tpu_torch.storage.store",
       "seaweedfs_tpu_torch.storage.volume",
       "seaweedfs_tpu_torch.util.durability",
       "seaweedfs_tpu_torch.parallel", "seaweedfs_tpu_torch.parallel.mesh",
       "seaweedfs_tpu_torch.parallel.dryrun",
       "seaweedfs_tpu_torch.util.config", "seaweedfs_tpu_torch.util.stats",
       "seaweedfs_tpu_torch.pipeline.flight",
       "seaweedfs_tpu_torch.storage.needle_map_native",
       "seaweedfs_tpu_torch.storage.needle_map_sqlite",
       "seaweedfs_tpu_torch.storage.vacuum",
       "seaweedfs_tpu_torch.storage.scrubber",
       "seaweedfs_tpu_torch.util.crashfs",
       "seaweedfs_tpu_torch.pb", "seaweedfs_tpu_torch.pb.master_pb2",
       "seaweedfs_tpu_torch.pb.volume_server_pb2",
       "seaweedfs_tpu_torch.pb.filer_pb2",
       "seaweedfs_tpu_torch.cluster",
       "seaweedfs_tpu_torch.cluster.volume_server",
       "seaweedfs_tpu_torch.util.glog", "seaweedfs_tpu_torch.util.security",
       "seaweedfs_tpu_torch.util.tls", "seaweedfs_tpu_torch.util.httpserver",
       "seaweedfs_tpu_torch.util.retry",
       "seaweedfs_tpu_torch.cluster.master",
       "seaweedfs_tpu_torch.cluster.topology",
       "seaweedfs_tpu_torch.cluster.sequence",
       "seaweedfs_tpu_torch.cluster.ha",
       "seaweedfs_tpu_torch.cluster.wdclient",
       "seaweedfs_tpu_torch.cluster.operation",
       "seaweedfs_tpu_torch.cluster.jobs",
       "seaweedfs_tpu_torch.shell.cluster_commands",
       "seaweedfs_tpu_torch.cli_tools",
       "seaweedfs_tpu_torch.filer", "seaweedfs_tpu_torch.filer.entry",
       "seaweedfs_tpu_torch.filer.filechunks",
       "seaweedfs_tpu_torch.filer.path_conf",
       "seaweedfs_tpu_torch.filer.stores",
       "seaweedfs_tpu_torch.filer.filer",
       "seaweedfs_tpu_torch.notification",
       "seaweedfs_tpu_torch.notification.queues",
       "seaweedfs_tpu_torch.cache", "seaweedfs_tpu_torch.cache.chunk_cache",
       "seaweedfs_tpu_torch.cache.disk_tier",
       "seaweedfs_tpu_torch.cache.invalidation",
       "seaweedfs_tpu_torch.cache.readahead",
       "seaweedfs_tpu_torch.images", "seaweedfs_tpu_torch.images.resize",
       "seaweedfs_tpu_torch.cluster.filer_client",
       "seaweedfs_tpu_torch.cluster.filer_server",
       "seaweedfs_tpu_torch.shell.fs_commands",
       "seaweedfs_tpu_torch.gateway", "seaweedfs_tpu_torch.gateway.s3",
       "seaweedfs_tpu_torch.gateway.s3_auth",
       "seaweedfs_tpu_torch.ckpt", "seaweedfs_tpu_torch.ckpt.manifest",
       "seaweedfs_tpu_torch.ckpt.s3client",
       "seaweedfs_tpu_torch.ckpt.loader",
       "seaweedfs_tpu_torch.ckpt.sharding",
       "seaweedfs_tpu_torch.ckpt.store",
       "seaweedfs_tpu_torch.storage.tier",
       "seaweedfs_tpu_torch.util.tracing",
       "seaweedfs_tpu_torch.util.profiler",
       "seaweedfs_tpu_torch.util.varz",
       "seaweedfs_tpu_torch.cluster.telemetry",
       "seaweedfs_tpu_torch.cluster.usage"}
print("missing:", sorted(new - set(names)))
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "bad: []" in out.stdout
    # every module of the slices so far was imported, the shell, Store,
    # Volume engine, the multi-device split, the config loader, the
    # flight recorder, the needle maps, vacuum, the scrubber, the crash
    # harness, the pb copies, the volume server and its wire utilities,
    # the master, its clients, the cluster shell, the jobs plane, the
    # filer stack, the S3 gateway, the checkpoint plane, the S3 tier and
    # the tracing plane (tracing, profiler, varz) and the telemetry and
    # usage planes among them
    assert int(out.stdout.split()[0]) >= 85
    assert "missing: []" in out.stdout


def _jax_package_literals(path: Path) -> list[tuple[int, str]]:
    """String constants in ``path`` that name a module of the JAX package
    (``seaweedfs_tpu.`` with the dot), docstrings left out."""
    import ast
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and id(node) not in docs
            and "seaweedfs_tpu." in node.value]


def test_port_names_no_jax_package_module_in_its_strings(tmp_path):
    """The lazy ``sys.modules`` lookups of ``util/varz.py`` and
    ``util/glog.py`` (and any other string) name only the port's
    modules: a literal ``"seaweedfs_tpu.<mod>"`` would read the JAX
    package's state in a process that holds both. Comments and
    docstrings may name the JAX package; code may not. The check
    itself catches such a literal."""
    files = sorted((REPO / "seaweedfs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 80
    found = {str(f.relative_to(REPO)): hits for f in files
             if (hits := _jax_package_literals(f))}
    assert found == {}
    planted = tmp_path / "planted.py"
    planted.write_text('"""seaweedfs_tpu.util.tracing in a docstring"""\n'
                       'import sys\n'
                       '# seaweedfs_tpu.util.tracing in a comment\n'
                       'm = sys.modules.get("seaweedfs_tpu.util.tracing")\n')
    assert _jax_package_literals(planted) == [
        (4, "seaweedfs_tpu.util.tracing")]


def test_entry_points_refuse_the_cpu_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    from seaweedfs_tpu_torch.pipeline import batch, decode, encode, rebuild
    from seaweedfs_tpu_torch.storage import volume
    base = tmp_path / "v"
    volume.write_synthetic_volume(base, 4096, avg_size=512)
    for call in (lambda: encode.encode_volume(base),
                 lambda: rebuild.rebuild_ec_files(base),
                 lambda: decode.decode_volume(base),
                 lambda: batch.encode_volumes([base]),
                 lambda: batch.encode_many([np.zeros(100, np.uint8)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # nothing was written on the CPU instead
    assert not list(tmp_path.glob("v.ec*"))


@pytest.mark.parametrize("section", ["tracing", "profiler", "usage", "slo",
                                     "jobs"])
def test_master_refuses_unported_config_sections(tmp_path, capsys,
                                                 section):
    """``master -config`` applies each section of the JAX master's
    planes as the JAX master does, ``[usage]``, ``[slo]`` and
    ``[jobs]``'s policy keys among them: the SLO and policy engines'
    payloads equal JAX's engines configured from the same file. A bad
    value in the section still exits 2 with one ``error:`` line, before
    anything binds."""
    from seaweedfs_tpu.cluster import jobs as jax_jobs
    from seaweedfs_tpu.cluster import telemetry as jax_telemetry
    from seaweedfs_tpu.cluster import usage as jax_usage
    from seaweedfs_tpu.util import config as jax_config
    from seaweedfs_tpu_torch.cluster import master, usage
    from seaweedfs_tpu_torch.util import config as config_mod
    from seaweedfs_tpu_torch.util import profiler, tracing

    body, bad = {
        "tracing": ("slow_threshold_seconds = 2.5\n",
                    "slow_threshold_seconds = \"slow\"\n"),
        "profiler": ("enabled = false\nhz = 3.0\n", "hz = \"fast\"\n"),
        "usage": ("enabled = false\npush_interval_seconds = 0.5\n",
                  "push_interval_seconds = \"soon\"\n"),
        "slo": ("enabled = true\nread_p99_ms = 80.0\n"
                "availability = 0.99\n", "availability = 1.5\n"),
        "jobs": ("policy = true\ncooldown_seconds = 30.0\n",
                 "hot_read_ops_per_second = 1.0\n"
                 "cool_read_ops_per_second = 5.0\n"),
    }[section]
    conf_path = tmp_path / "m.toml"
    conf_path.write_text(f"[retry]\nmax_attempts = 2\n\n[{section}]\n{body}")
    conf = config_mod.load(conf_path)
    ms = master.MasterServer(port=1)
    try:
        master.apply_config(conf)
        master.configure_master(ms, conf)
        if section == "tracing":
            assert tracing.slow_threshold() == 2.5
        elif section == "profiler":
            assert profiler.debug_payload()["hz"] == 3.0
            assert not profiler.enabled()
        elif section == "usage":
            jax_usage.configure_from(jax_config.load(conf_path))
            assert usage.enabled() is jax_usage.enabled() is False
            assert usage.push_interval() == jax_usage.push_interval() \
                == 0.5
        elif section == "slo":
            want = jax_telemetry.SloEngine(
                jax_telemetry.ClusterTelemetry(), clock=lambda: 0.0
            ).configure(jax_config.load(conf_path)).payload_locked(0.0)
            assert ms.slo.payload_locked(0.0) == want
            assert sorted(want["objectives"]) == ["availability",
                                                  "read_p99_ms"]
        else:
            want = jax_jobs.PolicyEngine().configure(
                jax_config.load(conf_path)["jobs"]).payload()
            assert ms.policy.payload() == want and want["enabled"]
    finally:
        tracing.configure(slow_threshold_seconds=1.0)
        profiler.configure(enabled=False, hz=1.0)
        for mod in (usage, jax_usage):
            mod.configure(enabled=True,
                          push_interval_seconds=mod.PUSH_INTERVAL)
    conf_path.write_text(f"[{section}]\n{bad}")
    assert master.main(["-port", "1", "-config", str(conf_path)]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("error: -config")


def test_shell_master_runs_cluster_commands(capsys):
    """``shell -master`` no longer exits 2: it runs the cluster
    commands (``help`` needs no connection)."""
    from seaweedfs_tpu_torch.shell import cli
    assert cli.main(["-master", "127.0.0.1:1", "-c", "help"]) == 0
    listed = capsys.readouterr().out.split()
    assert {"ec.encode", "ec.rebuild", "ec.decode", "ec.balance",
            "volume.list", "volume.vacuum", "volume.grow",
            "collection.list", "cluster.status", "lock",
            "unlock", "job.submit", "job.status", "job.pause",
            "job.resume", "job.cancel", "scrub.start",
            "scrub.status", "volume.move", "collection.delete",
            "volume.balance", "volume.fix.replication", "volume.mark",
            "volume.deleteEmpty", "volumeServer.evacuate",
            "volume.check.disk", "volume.unmount", "volume.mount",
            "volume.configure.replication", "cluster.check",
            "volume.fsck", "fs.ls", "fs.du", "fs.cat", "fs.mkdir",
            "fs.rm", "fs.mv", "fs.tree", "fs.configure", "fs.meta.cat",
            "fs.meta.save", "fs.meta.load", "s3.bucket.list",
            "s3.bucket.create", "s3.bucket.delete", "s3.clean.uploads",
            "s3.configure", "volume.tier.upload",
            "volume.tier.download", "trace.status", "trace.dump",
            "trace.top", "ingress.status", "telemetry.status",
            "volume.heatmap", "traffic.top",
            "tenant.usage"} == set(listed)
