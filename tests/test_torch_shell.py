"""The port's offline admin shell (seaweedfs_tpu_torch/shell) against the
JAX package's, on the CPU.

Ports the ten cases of tests/test_shell.py. Each case makes one volume
directory from a seed, copies it for each package, runs the same command
lines in both (the port with ``CommandEnv(device="cpu")``), and then
compares every file byte for byte (a symlink by its target) and every
printed line. GF(2^8) coding is exact: tolerance 0. The ``volume.tier.*``
and ``ckpt.*`` cases run against a port S3 gateway on a port cluster
(the ``ckpt.save`` values differ between the packages, so those cases
hold the printed geometry equal)."""

import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from seaweedfs_tpu.shell import commands as jax_commands
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage.volume import generate_synthetic_volume
from seaweedfs_tpu_torch.ops import rs_native, rs_torch
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.shell import commands
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage import store as port_store
from torch_teardown import collect_jax_garbage  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _files(d) -> dict:
    out = {}
    for root, _dirs, names in os.walk(d):
        for name in names:
            p = os.path.join(root, name)
            rel = os.path.relpath(p, d)
            out[rel] = ("link", os.path.relpath(os.path.realpath(p), d)) \
                if os.path.islink(p) else Path(p).read_bytes()
    return out


def _env(pkg, locs):
    if pkg == "port":
        st = port_store.Store([str(d) for d in locs])
        st.load_existing()
        return commands.CommandEnv(store=st, out=io.StringIO(),
                                   device="cpu")
    st = jax_store.Store([str(d) for d in locs])
    st.load_existing()
    return jax_commands.CommandEnv(store=st, out=io.StringIO())


def _volume(vid, n_needles, avg_size, seed=0, where="a"):
    def make(root):
        generate_synthetic_volume(root / where / str(vid), vid,
                                  n_needles=n_needles, avg_size=avg_size,
                                  seed=seed).close()
    return make


def drive(tmp_path, make, steps, dirs=("a",), relative=False):
    """Run ``steps`` (shell lines, or callables ``(root, env)`` whose
    results are kept) in both packages on copies of the directory
    ``make`` writes; assert the two logs and file trees are equal and
    return the port's (log, files)."""
    seed = tmp_path / "seed"
    for d in dirs:
        (seed / d).mkdir(parents=True)
    make(seed)
    results = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        shutil.copytree(seed, root, symlinks=True)
        cwd = os.getcwd()
        if relative:
            os.chdir(root)
        try:
            env = _env(pkg, dirs if relative else [root / d for d in dirs])
            run = commands.run_command if pkg == "port" \
                else jax_commands.run_command
            error = commands.ShellError if pkg == "port" \
                else jax_commands.ShellError
            log = []
            try:
                for step in steps:
                    if callable(step):
                        log.append(step(root, env))
                        continue
                    try:
                        run(env, step)
                        log.append(env.out.getvalue().splitlines())
                    except error as e:
                        log.append(("error", str(e)))
                    env.out.seek(0)
                    env.out.truncate()
            finally:
                env.store.close()
        finally:
            os.chdir(cwd)
        results[pkg] = (log, _files(root))
    assert results["port"][0] == results["jax"][0]
    assert results["port"][1].keys() == results["jax"][1].keys()
    assert results["port"][1] == results["jax"][1]
    return results["port"]


def _read_all(base):
    from seaweedfs_tpu_torch.storage.volume import Volume
    with Volume(base).load() as v:
        return {e.key: v.read_needle(e.key).data
                for e in v.nm.live_entries()}


@pytest.mark.parametrize("codec", ["host", "plain"])
def test_ec_encode_then_decode_roundtrip(tmp_path, monkeypatch, codec):
    """``plain``: DEVICE_MIN_S = 0, so the plain PyTorch codec serves the
    shell; ``host``: every slab is below DEVICE_MIN_S and takes the
    native host codec, as short slabs do on the card."""
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S",
                        1 << 30 if codec == "host" else 0)
    calls = rs_native.apply_gf_matrix.calls
    log, files = drive(tmp_path, _volume(3, 20, 256, seed=5), [
        "ec.encode -volumeId 3",
        lambda root, env: sorted(os.listdir(root / "a")),
        "ec.decode -volumeId 3",
        lambda root, env: env.store.get_volume(3).read_needle(7).data,
    ])
    assert (rs_native.apply_gf_matrix.calls > calls) == (codec == "host")
    assert log[0] == ["ec.encode volume 3: 14 shards, version 3"]
    assert "3.dat" not in log[1] and "3.ec13" in log[1]
    assert log[2] == ["ec.decode volume 3: 5408 bytes restored"]
    assert log[3] == _read_all(tmp_path / "seed" / "a" / "3")[7]
    assert sorted(files) == ["a/3.dat", "a/3.idx"]
    assert files["a/3.dat"] == (tmp_path / "seed" / "a" / "3.dat").read_bytes()


def test_ec_rebuild_after_shard_loss(tmp_path):
    lost = [0, 5, 10, 13]

    def lose(root, env):
        for i in lost:
            (root / "a" / f"3.ec{i:02d}").unlink()
        env.store.unmount_ec_shards(3, lost)

    sealed = {}

    def keep(root, _env):
        sealed[root.name] = {i: (root / "a" / f"3.ec{i:02d}").read_bytes()
                             for i in lost}

    log, files = drive(tmp_path, _volume(3, 20, 256, seed=5), [
        "ec.encode -volumeId 3", keep, lose, "ec.rebuild",
        lambda root, env: env.store.ec_mounts[("", 3)].shard_bits.count(),
    ])
    assert log[3] == [f"ec.rebuild volume 3: rebuilt {lost}"]
    assert log[4] == 14
    for i in lost:
        assert files[f"a/3.ec{i:02d}"] == sealed["port"][i]


def test_ec_encode_keep_source_and_custom_scheme(tmp_path):
    log, files = drive(tmp_path, _volume(7, 5, 128), [
        "ec.encode -volumeId 7 -keepSource -scheme 6,3"])
    assert "a/7.dat" in files and "a/7.ec08" in files
    assert "a/7.ec09" not in files      # only 9 shards for (6,3)
    assert log[0] == ["ec.encode volume 7: 9 shards, version 3"]


def test_ec_balance_spreads_shards(tmp_path):
    log, files = drive(tmp_path, _volume(4, 6, 64), [
        "ec.encode -volumeId 4", "ec.balance",
        lambda root, env: (ec_files.present_shards(root / "a" / "4"),
                           ec_files.present_shards(root / "b" / "4"))],
        dirs=("a", "b"))
    in_a, in_b = log[2]
    assert len(in_a) == len(in_b) == 7
    assert sorted(in_a + in_b) == list(range(14))
    assert "b/4.ecx" in files            # index copied beside moved shards
    assert log[1] == ["ec.balance: moved 7 shards over 2 locations"]


def test_balance_then_rebuild_and_decode_across_locations(tmp_path):
    def lose_one_per_location(root, _env):
        lost = [ec_files.present_shards(root / d / "6")[0] for d in "ab"]
        for d, sid in zip("ab", lost):
            (root / d / f"6.ec{sid:02d}").unlink()
        return lost

    log, files = drive(tmp_path, _volume(6, 12, 200, seed=9), [
        "ec.encode -volumeId 6", "ec.balance", lose_one_per_location,
        "ec.rebuild -volumeId 6",
        lambda root, env: sorted(env.store.ec_shard_paths(6)),
        "ec.decode -volumeId 6",
        lambda root, env: env.store.get_volume(6).read_needle(12).data,
    ], dirs=("a", "b"))
    assert log[4] == list(range(14))
    assert files["a/6.dat"] == (tmp_path / "seed" / "a" / "6.dat").read_bytes()
    # no EC artifacts (files or symlinks) left anywhere
    assert sorted(files) == ["a/6.dat", "a/6.idx"]


def test_balance_after_gather_preserves_shards(tmp_path):
    def real_shards(root, env):
        real = env.store.ec_shard_paths(2)
        assert all(p.exists() and not p.is_symlink() and p.stat().st_size
                   for p in real.values())
        return sorted(real)

    log, files = drive(tmp_path, _volume(2, 10, 128, seed=4), [
        "ec.encode -volumeId 2", "ec.balance",
        "ec.rebuild",          # creates symlink caches via gather
        "ec.balance",          # must not destroy real shards
        real_shards, "ec.decode -volumeId 2"], dirs=("a", "b"))
    assert log[4] == list(range(14))
    needles = _read_all(tmp_path / "seed" / "a" / "2")
    assert _read_all(tmp_path / "port" / "a" / "2") == needles


def test_decode_after_keep_source_closes_old_handle(tmp_path):
    held = {}

    def hold(root, env):
        held[root.name] = env.store.volumes[("", 5)]

    def check(root, env):
        old = held[root.name]
        return old._dat is None, env.store.volumes[("", 5)] is not old

    log, _ = drive(tmp_path, _volume(5, 6, 64), [
        "ec.encode -volumeId 5 -keepSource", hold,
        "ec.decode -volumeId 5", check])
    assert log[3] == (True, True)      # closed, not leaked


def test_gather_with_relative_dirs(tmp_path):
    log, files = drive(tmp_path, _volume(12, 5, 64), [
        "ec.encode -volumeId 12", "ec.balance",
        "ec.rebuild",                  # must not TooFewShards
        "ec.decode -volumeId 12"], dirs=("a", "b"), relative=True)
    assert "a/12.dat" in files
    assert log[2] == ["ec.rebuild volume 12: rebuilt nothing"]


def test_volume_list_and_errors(tmp_path):
    log, _ = drive(tmp_path, _volume(3, 20, 256, seed=5), [
        "volume.list", "ec.encode -volumeId 99", "nonsense.command",
        "ec.encode", "volume.delete -volumeId 3", "volume.list"])
    assert log[0][0].startswith("volume 3 collection=- size=")
    assert log[1] == ("error", "volume 99 not found")
    assert log[2][0] == "error" and "unknown command" in log[2][1]
    assert log[3][0] == "error" and "-volumeId" in log[3][1]
    assert log[5] == ["no volumes"]
    env = _env("port", [tmp_path / "port" / "a"])
    try:
        # help lists the ported commands, a subset of the JAX shell's
        commands.run_command(env, "help")
        listed = env.out.getvalue().splitlines()
        assert listed == sorted(commands.COMMANDS) == [
            "cache.clear", "cache.status",
            "ckpt.list", "ckpt.restore", "ckpt.save",
            "ec.balance", "ec.decode", "ec.encode", "ec.rebuild",
            "fault.clear", "fault.inject", "fault.list",
            "pipeline.analyze", "pipeline.dump", "pipeline.status",
            "trace.dump", "trace.status",
            "volume.delete", "volume.list", "volume.tier.download",
            "volume.tier.upload", "volume.vacuum"]
        assert set(listed) <= set(jax_commands.COMMANDS)
        # -mesh is known; a spec that cannot tile the one CPU device is
        # a ShellError that names the dp,sp it wants
        with pytest.raises(commands.ShellError, match="dp,sp"):
            commands.run_command(env, "ec.rebuild -mesh 2,2")
    finally:
        env.store.close()


@pytest.fixture
def eight_cpu_devices(monkeypatch):
    """8 CPU entries for the port's meshes, as the JAX package's tests
    have 8 virtual CPU devices."""
    real = mesh_mod.local_devices
    monkeypatch.setattr(
        mesh_mod, "local_devices",
        lambda device_type="cuda": [torch.device("cpu")] * 8
        if device_type == "cpu" else real(device_type))


def test_ec_encode_and_rebuild_on_a_mesh(tmp_path, monkeypatch,
                                         eight_cpu_devices):
    """``ec.encode -mesh 2,4`` and ``ec.rebuild -mesh 2,4`` (the JAX
    tests/test_mesh_pipeline.py shell cases): the same files and printed
    lines in both packages; volumes 3 and 4 hold the same bytes, so the
    split encode of 3 must equal the unsplit encode of 4."""
    cells = []
    real = mesh_mod.apply_prepared

    def spy(coefs, prep):
        cells.append(prep.mesh.shape)
        return real(coefs, prep)

    monkeypatch.setattr(mesh_mod, "apply_prepared", spy)

    def make(root):
        for vid in (3, 4):
            _volume(vid, 40, 700, seed=9)(root)

    lost = [2, 9, 13]

    def lose(root, env):
        sealed = {i: (root / "a" / f"3.ec{i:02d}").read_bytes()
                  for i in lost}
        for i in lost:
            (root / "a" / f"3.ec{i:02d}").unlink()
        env.store.unmount_ec_shards(3, lost)
        return sealed

    def scope_closed(root, _env):
        from seaweedfs_tpu.parallel import mesh as jax_mesh
        mod = mesh_mod if root.name == "port" else jax_mesh
        return mod.current().enabled

    log, files = drive(tmp_path, make, [
        "ec.encode -volumeId 3 -keepSource -mesh 2,4",
        "ec.encode -volumeId 4 -keepSource", lose,
        "ec.rebuild -volumeId 3 -mesh 2,4", scope_closed])
    assert log[0] == ["ec.encode volume 3: 14 shards, version 3"]
    assert log[3] == [f"ec.rebuild volume 3: rebuilt {lost}"]
    assert log[4] is False
    assert cells and all(c == {"dp": 2, "sp": 4} for c in cells)
    for i in range(14):
        assert files[f"a/3.ec{i:02d}"] == files[f"a/4.ec{i:02d}"], i
    for i in lost:
        assert files[f"a/3.ec{i:02d}"] == log[2][i]
    assert files["a/3.ecx"] == files["a/4.ecx"]


def test_bad_mesh_is_a_clean_error_and_touches_nothing(tmp_path,
                                                       eight_cpu_devices):
    """A bad spec, or one that cannot tile the devices, is a ShellError
    raised before any volume is touched, with the JAX package's text."""
    log, files = drive(tmp_path, _volume(5, 4, 64), [
        "ec.encode -volumeId 5 -mesh 3,3",
        "ec.encode -volumeId 5 -mesh nope",
        "ec.rebuild -mesh 1,1,1", "volume.list"])
    for entry in log[:3]:
        assert entry[0] == "error" and "dp,sp" in entry[1]
    assert "8 local device(s)" in log[0][1]
    assert log[3][0].startswith("volume 5 collection=- size=")
    assert files == _files(tmp_path / "seed")


def _cli(pkg, *args, timeout=300):
    mod = "seaweedfs_tpu_torch" if pkg == "port" else "seaweedfs_tpu"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", mod, "shell", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=env)


def test_cli_oneshot_subprocess(tmp_path):
    def cli(root, _env):
        out = []
        for pkg_args, line in ((["-device", "cpu"], "ec.encode -volumeId 8"),
                               ([], "volume.list")):
            pkg = root.name
            r = _cli(pkg, "-dir", str(root / "a"), "-c", line,
                     *(pkg_args if pkg == "port" else []))
            assert r.returncode == 0, r.stderr
            out.append(r.stdout.splitlines())
        return out

    # the envs hold nothing open: each subprocess loads the directory
    log, files = drive(tmp_path, _volume(8, 4, 64), [cli])
    assert log[0][0] == ["ec.encode volume 8: 14 shards, version 3"]
    assert "ec volume 8" in log[0][1][0]
    assert "a/8.ec13" in files


def test_cli_without_a_card_fails_and_writes_no_shard(tmp_path):
    """No card and no ``-device cpu``: every ec.* command fails before it
    touches a file, in process and through the CLI, and nothing carries
    on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: -device cuda means the card")
    d = tmp_path / "a"
    d.mkdir()
    (tmp_path / "b").mkdir()
    generate_synthetic_volume(d / "8", 8, n_needles=4, avg_size=64).close()
    before = _files(tmp_path)
    r = _cli("port", "-dir", str(d), "-c", "ec.encode -volumeId 8")
    assert r.returncode == 1
    assert "no CUDA device: torch.cuda.is_available() is false" in r.stderr
    assert _files(tmp_path) == before
    # sealed and split over two locations on the CPU, then no device
    env = _env("port", [d, tmp_path / "b"])
    try:
        commands.run_command(env, "ec.encode -volumeId 8")
        commands.run_command(env, "ec.balance")
        (d / "8.ec00").unlink()
        sealed = _files(tmp_path)
        env.device = None
        for line in ("ec.rebuild", "ec.decode -volumeId 8",
                     "ec.encode -volumeId 8"):
            with pytest.raises(commands.ShellError, match="no CUDA device"):
                commands.run_command(env, line)
        assert _files(tmp_path) == sealed   # no link, shard or .dat made
    finally:
        env.store.close()


# ------------------------------------------------------------------
# -config: [pipeline], [mesh] and [flight] through the CLI, and the
# pipeline.status / pipeline.analyze / pipeline.dump commands
# ------------------------------------------------------------------

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

from seaweedfs_tpu.parallel import mesh as jax_mesh  # noqa: E402
from seaweedfs_tpu.pipeline import flight as jax_flight  # noqa: E402
from seaweedfs_tpu.pipeline import pipe as jax_pipe  # noqa: E402
from seaweedfs_tpu.shell import cli as jax_cli  # noqa: E402
from seaweedfs_tpu_torch.pipeline import flight  # noqa: E402
from seaweedfs_tpu_torch.pipeline import pipe  # noqa: E402
from seaweedfs_tpu_torch.shell import cli  # noqa: E402

CONFIG = """\
[pipeline]
batch_bytes = 1048576
double_buffer = true
writer_threads = 2

[mesh]
enabled = true
dp = {dp}
sp = {sp}

[flight]
enabled = true
"""


@pytest.fixture
def session_state():
    """Both packages' [pipeline], [mesh] and [flight] state, rings of
    recent runs and mesh totals start empty and are restored after the
    test: the JAX shell leaves what its -config set in place."""
    mods = ((pipe, mesh_mod, flight), (jax_pipe, jax_mesh, jax_flight))
    saved = [(dataclasses.replace(p.current()),
              dataclasses.replace(m.current())) for p, m, _f in mods]
    for p, m, f in mods:
        p.reset_telemetry()
        m.reset_telemetry()
        f.disarm()
        f.reset()
    yield
    for (p, m, f), (pc, mc) in zip(mods, saved):
        for cfg, old in ((p.current(), pc), (m.current(), mc)):
            for fld in dataclasses.fields(old):
                setattr(cfg, fld.name, getattr(old, fld.name))
        p.reset_telemetry()
        m.reset_telemetry()
        f.disarm()
        f.reset()


def _main(pkg, args):
    """One in-process CLI run: (exit code, stdout lines, stderr lines)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if pkg == "port":
            rc = cli.main([*args, "-device", "cpu"])
        else:
            rc = jax_cli.main(args)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def _masked(lines):
    """Printed lines with what a run's timing decides masked: numbers
    (seconds, rates, busy shares, counts), the verdict's stage, the
    advice it picks (one marker for each list, whose length depends on
    the verdict) and the trace path; the stage lines of an analysis are
    sorted by busy share, so the set is compared."""
    out = []
    for line in lines:
        line = re.sub(r"bottleneck: .*", "bottleneck: <stage>", line)
        line = re.sub(r"(critical path \(.*\)): .*", r"\1: <stages>", line)
        line = re.sub(r"-> \S+", "-> <path>", line)
        if line.startswith("   - "):
            if out and out[-1] == "   - <advice>":
                continue
            line = "   - <advice>"
        out.append(re.sub(r"\d+(\.\d+)?(e-?\d+)?", "#", line))
    return sorted(out)


def _seed_volumes(root):
    """Volumes 3 and 4 of the same needles; 4 is sealed and loses three
    shards, so one session can encode 3 and rebuild 4."""
    for vid in (3, 4):
        _volume(vid, 40, 700, seed=9)(root)
    env = _env("port", [root / "a"])
    try:
        commands.run_command(env, "ec.encode -volumeId 4")
    finally:
        env.store.close()
    for i in (2, 9, 13):
        (root / "a" / f"4.ec{i:02d}").unlink()
    pipe.reset_telemetry()        # the session's ring starts empty


def test_config_session_equals_jax(tmp_path, eight_cpu_devices,
                                   session_state):
    """One -config file with [pipeline] (small batches, double_buffer,
    2 writers), [mesh] (2 x 4 over 8 CPU entries) and [flight] in both
    packages: ``ec.encode; ec.rebuild; pipeline.status; pipeline.analyze;
    pipeline.dump -trace F`` writes the same files, prints the same
    lines once timing is masked, and dumps a trace with the same event
    names; the session's config is restored when the port's main
    returns."""
    conf = tmp_path / "c.toml"
    conf.write_text(CONFIG.format(dp=2, sp=4))
    seed = tmp_path / "seed"
    (seed / "a").mkdir(parents=True)
    _seed_volumes(seed)
    res = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        shutil.copytree(seed, root, symlinks=True)
        trace = tmp_path / f"{pkg}.trace.json"
        rc, out, err = _main(pkg, [
            "-dir", str(root / "a"), "-config", str(conf), "-c",
            f"ec.encode -volumeId 3 -keepSource; ec.rebuild -volumeId 4; "
            f"pipeline.status; pipeline.analyze; "
            f"pipeline.dump -trace {trace}"])
        assert rc == 0, err
        doc = json.loads(trace.read_text())
        res[pkg] = (out, _files(root),
                    sorted({e["name"] for e in doc["traceEvents"]}))
    out, files, names = res["port"]
    assert files == res["jax"][1]
    assert _masked(out) == _masked(res["jax"][0])
    assert names == res["jax"][2]
    assert out[0] == "ec.encode volume 3: 14 shards, version 3"
    assert out[1] == "ec.rebuild volume 4: rebuilt [2, 9, 13]"
    assert out[2] == (
        "pipeline.status depth=2 batch_bytes=1048576 "
        "grouped_batch_bytes=67108864 group_cap=env writers=2x4 "
        "feedback=True overlapped=True preallocate=True "
        "double_buffer=True")
    assert out[3].startswith("  mesh: axes=dp2xsp4 ")
    assert [ln.split(":")[0] for ln in out[5:7]] == \
        ["  ec.encode", "  ec.rebuild"]
    assert any(ln.startswith("pipeline.analyze: bottleneck: ")
               for ln in out)
    assert {"read", "dispatch", "d2h_sync", "write", "h2d"} <= set(names)
    # the split encode of 3 wrote the unsplit encode of 4's bytes
    for i in range(14):
        assert files[f"a/3.ec{i:02d}"] == files[f"a/4.ec{i:02d}"], i
    # the port's main put the session's config back
    assert pipe.current() == pipe.PipelineConfig()
    assert not mesh_mod.current().enabled and not flight.armed()


@pytest.mark.parametrize("text,want", [
    ("[pipeline]\ndepth = 2\nqdepth = 4\n",
     "unknown pipeline config key 'qdepth'"),
    ("[mesh]\nenabled = true\ndp = 3\nsp = 3\n",
     "cannot tile the 8 local device(s)"),
    ("[flight]\nenabled = true\nsize = 4\n",
     "unknown flight config key 'size'"),
    ("[pipeline]\ndepth = \"two\"\n", "invalid literal for int()"),
    ("[pipeline]\ndepth = two\n", "Invalid value"),
    (None, "no such file")])
def test_config_refusals_touch_no_file(tmp_path, eight_cpu_devices,
                                       session_state, text, want):
    """An unknown key, a bad value, a [mesh] that cannot tile the 8 CPU
    entries, or a missing file: one ``error:`` line, exit 1, no file
    changed, and the config left as it was."""
    d = tmp_path / "a"
    d.mkdir()
    _volume(5, 4, 64)(tmp_path)
    conf = tmp_path / "bad.toml"
    if text is not None:
        conf.write_text(text)
    before = _files(tmp_path)
    rc, out, err = _main("port", ["-dir", str(d), "-config", str(conf),
                                  "-c", "ec.encode -volumeId 5"])
    assert rc == 1 and out == []
    assert len(err) == 1 and err[0].startswith("error: ") and want in err[0]
    assert _files(tmp_path) == before
    assert pipe.current() == pipe.PipelineConfig()
    assert not mesh_mod.current().enabled and not flight.armed()


def test_lookahead_encode_survives_scribbled_buffers(tmp_path, monkeypatch,
                                                     session_state):
    """[mesh] 1 x 1 over the one CPU device with double_buffer: the cell
    takes the pooled batch as it is, so the lookahead holds a pooled
    buffer across two stages. A pool that overwrites every buffer handed
    back must leave the shards equal to the sync path's."""
    real = pipe.HostBufferPool.release

    def scribble(self, buf):
        buf[:] = 0xEE
        real(self, buf)

    seed = tmp_path / "seed"
    (seed / "a").mkdir(parents=True)
    _volume(6, 60, 3000, seed=2)(seed)
    trees = {}
    for name, extra in (("lookahead", "double_buffer = true\n"),
                        ("sync", "overlapped = false\n")):
        root = tmp_path / name
        shutil.copytree(seed, root)
        conf = tmp_path / f"{name}.toml"
        conf.write_text("[pipeline]\nbatch_bytes = 1048576\n" + extra +
                        "[mesh]\nenabled = true\ndp = 1\nsp = 1\n")
        mesh_mod.reset_telemetry()
        with monkeypatch.context() as m:
            if name == "lookahead":
                m.setattr(pipe.HostBufferPool, "release", scribble)
            rc, out, err = _main("port", [
                "-dir", str(root / "a"), "-config", str(conf), "-c",
                "ec.encode -volumeId 6; pipeline.status"])
        assert rc == 0, err
        assert out[0] == "ec.encode volume 6: 14 shards, version 3"
        assert "double_buffer=" + ("True" if name == "lookahead"
                                   else "False") in out[1]
        assert out[2].startswith("  mesh: axes=dp1xsp1 batches=11 ")
        trees[name] = _files(root)
    assert trees["lookahead"] == trees["sync"]


def test_cli_config_subprocess(tmp_path):
    """``python -m seaweedfs_tpu_torch shell -device cpu -config F``: the
    command line of the acceptance criterion, in its own process."""
    d = tmp_path / "a"
    d.mkdir()
    generate_synthetic_volume(d / "8", 8, n_needles=6, avg_size=400).close()
    conf = tmp_path / "c.toml"
    conf.write_text(CONFIG.format(dp=1, sp=1))
    r = _cli("port", "-dir", str(d), "-device", "cpu", "-config", str(conf),
             "-c", "ec.encode -volumeId 8; pipeline.status; "
                   "pipeline.analyze")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "ec.encode volume 8: 14 shards, version 3"
    assert "double_buffer=True" in lines[1]
    assert lines[2].startswith("  mesh: axes=dp1xsp1 batches=11 ")
    assert any(ln.startswith("pipeline.analyze: bottleneck: ")
               for ln in lines)
    assert (d / "8.ec13").exists()


def test_mesh_flag_overrides_the_config_for_one_command(
        tmp_path, monkeypatch, eight_cpu_devices, session_state):
    """``[mesh]`` 2 x 4 from -config, ``-mesh 1,8`` on one command: that
    command splits 1 x 8, the next one 2 x 4 again, and the config reads
    back as the file set it."""
    cells = []
    real = mesh_mod.apply_prepared

    def spy(coefs, prep):
        cells.append((prep.mesh.shape["dp"], prep.mesh.shape["sp"]))
        return real(coefs, prep)

    monkeypatch.setattr(mesh_mod, "apply_prepared", spy)
    d = tmp_path / "a"
    d.mkdir()
    for vid in (3, 4):
        _volume(vid, 6, 400, seed=vid)(tmp_path)
    conf = tmp_path / "c.toml"
    conf.write_text("[pipeline]\nbatch_bytes = 4194304\n"
                    "[mesh]\nenabled = true\ndp = 2\nsp = 4\n")
    rc, out, err = _main("port", [
        "-dir", str(d), "-config", str(conf), "-c",
        "ec.encode -volumeId 3 -mesh 1,8; ec.encode -volumeId 4; "
        "pipeline.status"])
    assert rc == 0, err
    split = len(cells) // 2
    assert cells == [(1, 8)] * split + [(2, 4)] * split and split
    assert out[2].startswith("pipeline.status ")
    assert out[3].endswith("configured={'enabled': True, 'dp': 2, "
                           "'sp': 4}")


# -- the storage engine at rest: volume.vacuum and the fault commands -------

from seaweedfs_tpu.storage.volume import Volume as JaxVolume  # noqa: E402
from seaweedfs_tpu.util import faults as jax_faults  # noqa: E402
from seaweedfs_tpu_torch.util import faults as port_faults  # noqa: E402


@pytest.fixture
def fault_state():
    """Both packages' fault registries start and end empty."""
    for mod in (port_faults, jax_faults):
        mod.clear()
    yield
    for mod in (port_faults, jax_faults):
        mod.clear()


def _garbage_volumes(root):
    """Volumes 3 (a third of its needles deleted) and 4 (one deleted):
    a threshold vacuum compacts 3 and skips 4."""
    for vid, deletes in ((3, range(1, 31, 3)), (4, (5,))):
        generate_synthetic_volume(root / str(vid), vid, n_needles=30,
                                  avg_size=300, seed=vid).close()
        with JaxVolume(root / str(vid), vid).load() as v:
            for k in deletes:
                v.delete_needle(k)


def test_vacuum_and_fault_commands_equal_jax(tmp_path, fault_state):
    """``volume.vacuum`` (one volume, then every volume against the
    threshold) and ``fault.inject`` / ``fault.list`` / ``fault.clear``
    through both packages' ``cli.main``: equal lines and exit codes,
    equal files. ``fault.list``'s catalog line lists the port's points,
    each a point of the JAX catalog, in its order."""
    seed = tmp_path / "seed"
    seed.mkdir()
    _garbage_volumes(seed)
    session = ("volume.list; volume.vacuum -volumeId 4; volume.vacuum; "
               "volume.vacuum -garbageThreshold 0.01; volume.list; "
               "fault.list; "
               "fault.inject -point ec.shard_read -spec error@0.5#3; "
               "fault.inject -point crash.append.dat -spec delay:0.001#2 "
               "-seed 7; fault.list; fault.clear -point ec.shard_read; "
               "fault.list; fault.clear; fault.list")
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        shutil.copytree(seed, d)
        rc, lines, err = _main(pkg, ["-dir", str(d), "-c", session])
        catalog = [ln for ln in lines if ln.startswith("  points: ")]
        rest = [ln for ln in lines if not ln.startswith("  points: ")]
        out[pkg] = (rc, rest, err, {p.name: p.read_bytes()
                                    for p in sorted(d.iterdir())})
        out[pkg + " catalog"] = catalog
    assert out["port"] == out["jax"]
    rc, lines, _err, _files = out["port"]
    assert rc == 0
    assert "volume.vacuum 4: garbage" in lines[2] and "reclaimed" in lines[2]
    assert "below threshold, skipped" in lines[4]
    assert any("fault.inject: armed crash.append.dat=delay:0.001#2" == ln
               for ln in lines)
    port_points = out["port catalog"][0][len("  points: "):].split(", ")
    jax_points = out["jax catalog"][0][len("  points: "):].split(", ")
    assert len(out["port catalog"]) == len(out["jax catalog"]) == 4
    assert port_points == [p for p in jax_points if p in port_points]
    assert "crash.ec.writeback" in port_points
    assert "crash.vacuum.midcommit" in port_points


def _trip(retry_mod):
    """Trip the breaker of a dead endpoint open; return it."""
    brk = retry_mod.breaker_for("127.0.0.1:1")
    for _ in range(brk.threshold):
        brk.record_failure()
    assert brk.to_dict()["state"] == "open"
    return brk


def test_fault_clear_breakers_is_refused_and_disarms_nothing(
        tmp_path, fault_state):
    """``fault.clear -breakers`` with a flag the command does not know is
    refused before it acts, alike in both packages: one ``error:`` line,
    exit 1, the armed point still armed and the tripped breaker still
    open; a bad spec is one ``error:`` line in both packages."""
    from seaweedfs_tpu.util import retry as jax_retry
    from seaweedfs_tpu_torch.util import retry as port_retry
    d = tmp_path / "a"
    d.mkdir()
    got = {}
    for pkg, retry_mod, faults_mod in (("jax", jax_retry, jax_faults),
                                       ("port", port_retry, port_faults)):
        brk = _trip(retry_mod)
        try:
            got[pkg] = _main(pkg, ["-dir", str(d), "-c",
                                   "fault.inject -point ec.shard_read "
                                   "-spec error; fault.clear -breakers "
                                   "-point"])
            assert [s["point"] for s in faults_mod.specs()] == \
                ["ec.shard_read"]
            assert retry_mod.breaker_for("127.0.0.1:1") is brk
            assert not brk.allow()
        finally:
            retry_mod.reset_breakers()
    assert got["port"] == got["jax"]
    rc, _lines, err = got["port"]
    assert rc == 1 and len(err) == 1 and err[0].startswith("error:")
    assert "fault.clear" in err[0]
    bad = {pkg: _main(pkg, ["-dir", str(d), "-c",
                            "fault.inject -point ec.shard_read -spec boom"])
           for pkg in ("jax", "port")}
    assert bad["port"] == bad["jax"]
    assert bad["port"][0] == 1 and "unknown fault action" in bad["port"][2][0]


def test_fault_clear_breakers_resets_breakers_equal_jax(tmp_path,
                                                        fault_state):
    """The port's retry layer has circuit breakers, so ``fault.clear
    -breakers`` is no longer refused. Through both packages' ``cli.main``
    it disarms the armed point, resets the breakers each package's retry
    layer holds (one tripped open beforehand) and prints the same
    line."""
    from seaweedfs_tpu.util import retry as jax_retry
    from seaweedfs_tpu_torch.util import retry as port_retry
    d = tmp_path / "a"
    d.mkdir()
    got = {}
    for pkg, retry_mod in (("jax", jax_retry), ("port", port_retry)):
        brk = _trip(retry_mod)
        got[pkg] = _main(pkg, ["-dir", str(d), "-c",
                               "fault.inject -point ec.shard_read "
                               "-spec error; fault.clear -breakers"])
        fresh = retry_mod.breaker_for("127.0.0.1:1")
        assert fresh is not brk and fresh.allow()
        retry_mod.reset_breakers()
    assert got["port"] == got["jax"]
    rc, lines, err = got["port"]
    assert rc == 0 and err == []
    assert lines[-1] == "fault.clear: all points disarmed + breakers reset"
    assert port_faults.specs() == []


@pytest.fixture(scope="module")
def gateway(tmp_path_factory):
    """A port master, volume server, filer and S3 gateway (device cpu),
    with the buckets ``coldstore`` and ``ckpt``."""
    import time as time_mod

    from seaweedfs_tpu_torch.ckpt import GatewayClient
    from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.gateway.s3 import S3Gateway

    from test_cluster_integration import _free_port_pair
    ms = MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                      pulse_seconds=0.2, seed=3).start()
    vs = VolumeServer(port_store.Store([tmp_path_factory.mktemp("gwv")],
                                       max_volumes=8),
                      port=_free_port_pair(), master_url=ms.url,
                      pulse_seconds=0.2, device="cpu").start()
    deadline = time_mod.time() + 10
    while time_mod.time() < deadline and not ms.topology.nodes:
        time_mod.sleep(0.05)
    filer = FilerServer(Filer(), port=_free_port_pair(),
                        master_url=ms.url).start()
    gw = S3Gateway(filer.url, port=_free_port_pair()).start()
    for b in ("coldstore", "ckpt"):
        GatewayClient(gw.url).ensure_bucket(b)
    yield gw
    for obj in (gw, filer, vs, ms):
        obj.stop()


def test_volume_tier_commands_equal_jax(tmp_path, gateway):
    """``volume.tier.upload`` (with and without -keepLocal) and
    ``volume.tier.download`` through both shells: equal lines and, after
    each step, equal files (the .tier sidecar included); ec.encode is
    refused while tiered and seals alike after the download."""
    dest = f"{gateway.url}/coldstore"

    def make(root):
        _volume(3, 30, 2000, seed=4)(root)
        _volume(5, 10, 1000, seed=6)(root)

    def tiered(root, env):
        return sorted(p.name for p in (root / "a").iterdir())

    log, files = drive(tmp_path, make, [
        f"volume.tier.upload -volumeId 3 -dest {dest}",
        f"volume.tier.upload -volumeId 5 -dest {dest} -keepLocal",
        "volume.tier.upload -volumeId 42 -dest x/y",
        "volume.tier.upload -volumeId 3 -dest nobucket", tiered,
        "ec.encode -volumeId 3",
        "volume.tier.download -volumeId 3",
        "volume.tier.download -volumeId 5",
        "volume.tier.download -volumeId 5",
        "ec.encode -volumeId 3", "volume.list"], relative=True)
    assert log[0][0].startswith("volume.tier.upload 3: ")
    assert log[0][0].endswith(f"-> {dest}/3.dat")
    assert log[1][0].endswith("(local copy kept)")
    assert log[2] == ("error", "volume 42 not found")
    assert "bad -dest" in log[3][1]
    assert "3.tier" in log[4] and "3.dat" not in log[4]
    assert "5.tier" in log[4] and "5.dat" in log[4]
    assert log[5][0] == "error" and "tier.download" in log[5][1]
    assert log[6] == ["volume.tier.download 3: local again"]
    assert log[8][0] == "error" and "not tiered" in log[8][1]
    assert log[9] == ["ec.encode volume 3: 14 shards, version 3"]
    assert "a/3.ecx" in files and "a/3.tier" not in files


def test_ckpt_commands_print_jax_geometry(tmp_path, gateway,
                                          eight_cpu_devices):
    """``ckpt.save``, ``ckpt.list`` and ``ckpt.restore`` through both
    shells on 8 CPU devices (the JAX package's 8 virtual ones, the
    port's 8 CPU entries): equal printed lines — the geometry, the
    ranged-read profile, the refusals — though the saved values differ
    (``jax.random`` against a seeded ``torch.Generator``)."""
    g = f"-gateway {gateway.url}"
    log, _ = drive(tmp_path, lambda root: None, [
        f"ckpt.save {g} -name shellck",
        f"ckpt.save {g} -name wide -mesh 1,8 -params 1 -rows 64 "
        f"-cols 32",
        f"ckpt.list {g}",
        f"ckpt.restore {g} -name shellck",
        f"ckpt.restore {g} -name shellck -mesh 4,2",
        f"ckpt.restore {g} -name wide",
        f"ckpt.restore {g} -name nothere",
        f"ckpt.save -name x",
        f"ckpt.save {g} -name y -mesh 3,3"])
    assert log[0] == ["ckpt.save shellck: 2 params 16 shards 131072 "
                      "bytes -> s3://ckpt"]
    assert log[1] == ["ckpt.save wide: 1 params 8 shards 8192 bytes "
                      "-> s3://ckpt"]
    assert log[2] == ["  shellck: params=2 shards=16 bytes=131072",
                      "  wide: params=1 shards=8 bytes=8192",
                      "ckpt.list: 2 checkpoint(s) in s3://ckpt"]
    assert log[3][:2] == [
        "  param0: float32[256, 64] spec=PartitionSpec('dp', 'sp')",
        "  param1: float32[256, 64] spec=PartitionSpec('dp', 'sp')"]
    assert log[3][2].startswith("ckpt.restore shellck: 2 params, "
                                "16 ranged reads ")
    assert log[5][0] == "error" and "axis-0" in log[5][1]
    assert log[6][0] == "error" and "no manifest.json" in log[6][1]
    assert "-gateway" in log[7][1]
    assert log[8][0] == "error" and "dp,sp" in log[8][1]
