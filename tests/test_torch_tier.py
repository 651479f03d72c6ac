"""The port's S3 tier (``storage/tier.py``, the ``s3`` backend,
``Volume._load_tiered`` / ``retier``, ``Store.tier_move`` /
``tier_restore``, the shells' ``volume.tier.*``) against the JAX
package's, on the CPU.

Every case of ``tests/test_tier.py`` runs with the port's store and
shell against two object stores: the port's own S3 gateway (on a port
filer and cluster) and the JAX package's. Then the packages swap tiered
volumes: a volume either package tiered opens in the other, reads back
every needle equal, downloads sha256-equal, and the two packages'
sidecars for one volume are equal byte for byte. Port servers run
``device="cpu"``."""

import hashlib
import shutil
import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.cluster import filer_server as jax_filer_server
from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.gateway import s3 as jax_s3
from seaweedfs_tpu.shell import commands as jax_commands
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage import tier as jax_tier
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu_torch.cluster import filer_server, master, volume_server
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.gateway import s3, s3_auth
from seaweedfs_tpu_torch.shell.commands import (CommandEnv, ShellError,
                                                run_command)
from seaweedfs_tpu_torch.storage import needle, tier, vacuum
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import FileId
from seaweedfs_tpu_torch.storage.volume import VolumeError

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
PKG = {"jax": dict(master=jax_master, vs=jax_volume_server,
                   store=jax_store.Store, filer_server=jax_filer_server,
                   filer=JaxFiler, s3=jax_s3, needle=jax_needle,
                   tier=jax_tier, volume=jax_volume),
       "port": dict(master=master, vs=volume_server, store=Store,
                    filer_server=filer_server, filer=Filer, s3=s3,
                    needle=needle, tier=tier, volume=port_volume)}


def _wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _stack(tmp_path_factory, pkg):
    """A master, a volume server, a filer and a gateway of ``pkg``, with
    the bucket ``coldstore``."""
    m = PKG[pkg]
    ms = m["master"].MasterServer(port=_free_port_pair(),
                                  volume_size_limit_mb=64,
                                  pulse_seconds=PULSE, seed=31).start()
    kw = dict(device="cpu") if pkg == "port" else {}
    vs = m["vs"].VolumeServer(
        m["store"]([tmp_path_factory.mktemp(f"gwvol_{pkg}")],
                   max_volumes=8),
        port=_free_port_pair(), master_url=ms.url, pulse_seconds=PULSE,
        **kw).start()
    _wait_for(lambda: ms.topology.nodes, what="volume server registration")
    filer = m["filer_server"].FilerServer(
        m["filer"](), port=_free_port_pair(), master_url=ms.url).start()
    gw = m["s3"].S3Gateway(filer.url, port=_free_port_pair()).start()
    urllib.request.urlopen(urllib.request.Request(
        f"http://{gw.url}/coldstore", method="PUT"), timeout=10).read()
    return gw, [gw, filer, vs, ms]


@pytest.fixture(scope="module")
def gateways(tmp_path_factory):
    stacks = {pkg: _stack(tmp_path_factory, pkg) for pkg in PKG}
    yield {pkg: gw for pkg, (gw, _) in stacks.items()}
    for _, parts in stacks.values():
        for obj in parts:
            obj.stop()


@pytest.fixture(params=sorted(PKG))
def gateway(request, gateways):
    """The object store the port tiers to: the port's gateway or the
    JAX package's."""
    return gateways[request.param]


def _payloads(n=40, size=10_000, seed=12):
    rng = np.random.default_rng(seed)
    return {i + 1: rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for i in range(n)}


@pytest.fixture()
def tiered_store(tmp_path, gateway):
    """A port store with one 40-needle volume tiered to ``gateway``."""
    store = Store([tmp_path], max_volumes=4)
    payloads = _payloads()
    try:
        store.create_volume(3)
        vol = store.volumes[("", 3)]
        for nid, data in payloads.items():
            vol.write_needle(needle.Needle(cookie=9, id=nid, data=data,
                                           append_at_ns=nid))
        env = CommandEnv(store=store, device="cpu")
        run_command(env, f"volume.tier.upload -volumeId 3 "
                         f"-dest {gateway.url}/coldstore")
        yield store, env, payloads, gateway
    finally:
        store.close()


# --------------------------------------------------------------------------
# the cases of tests/test_tier.py
# --------------------------------------------------------------------------

def test_tier_upload_readthrough_and_download(tiered_store, tmp_path):
    store, env, payloads, _ = tiered_store
    assert not (tmp_path / "3.dat").exists()
    assert (tmp_path / "3.tier").exists()
    vol = store.volumes[("", 3)]
    assert vol.backend_kind == "s3" and store.is_readonly(3)
    for nid, want in payloads.items():
        assert vol.read_needle(nid, cookie=9).data == want
    with pytest.raises((tier.TierError, VolumeError)):
        vol.write_needle(needle.Needle(cookie=9, id=99, data=b"x",
                                       append_at_ns=99))
    run_command(env, "volume.tier.download -volumeId 3")
    assert (tmp_path / "3.dat").exists()
    assert not (tmp_path / "3.tier").exists()
    vol2 = store.volumes[("", 3)]
    assert vol2.backend_kind != "s3" and not store.is_readonly(3)
    for nid, want in payloads.items():
        assert vol2.read_needle(nid, cookie=9).data == want
    vol2.write_needle(needle.Needle(cookie=9, id=99, data=b"writable",
                                    append_at_ns=99))
    assert vol2.read_needle(99, cookie=9).data == b"writable"


def test_tiered_volume_survives_restart(tiered_store, tmp_path):
    _, _, payloads, _ = tiered_store
    store2 = Store([tmp_path], max_volumes=4)
    store2.load_existing()
    try:
        vol = store2.volumes.get(("", 3))
        assert vol is not None, ".tier sidecar not scanned on restart"
        assert vol.backend_kind == "s3" and store2.is_readonly(3)
        for nid, want in list(payloads.items())[:5]:
            assert vol.read_needle(nid, cookie=9).data == want
    finally:
        store2.close()


def test_tier_ec_encode_requires_download(tiered_store, tmp_path):
    """EC encode streams the whole .dat, so a tiered volume points the
    operator at tier.download; after the download the seal works and
    equals the JAX package's seal of the same .dat."""
    _, env, _, _ = tiered_store
    with pytest.raises(ShellError, match="tier.download"):
        run_command(env, "ec.encode -volumeId 3 -keepSource")
    run_command(env, "volume.tier.download -volumeId 3")
    ref = tmp_path / "ref"
    ref.mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(tmp_path / f"3{ext}", ref / f"3{ext}")
    run_command(env, "ec.encode -volumeId 3 -keepSource")
    jstore = jax_store.Store([ref], max_volumes=4)
    jstore.load_existing()
    try:
        jax_commands.run_command(jax_commands.CommandEnv(store=jstore),
                                 "ec.encode -volumeId 3 -keepSource")
    finally:
        jstore.close()
    for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx"]:
        assert hashlib.sha256((tmp_path / f"3{ext}").read_bytes()) \
            .digest() == hashlib.sha256((ref / f"3{ext}").read_bytes()) \
            .digest(), ext


def test_tiered_volume_serves_cluster_reads(tiered_store):
    """A port volume server over the tiered store answers HTTP fid GETs,
    the bytes coming through ranged GETs against the gateway."""
    store, _, payloads, _ = tiered_store
    ms = master.MasterServer(port=_free_port_pair(), pulse_seconds=PULSE,
                             seed=77).start()
    vs = volume_server.VolumeServer(store, port=_free_port_pair(),
                                    master_url=ms.url, pulse_seconds=PULSE,
                                    device="cpu").start()
    try:
        for key in (7, 23):
            fid = FileId(volume_id=3, key=key, cookie=9)
            got = urllib.request.urlopen(f"http://{vs.url}/{fid}",
                                         timeout=30).read()
            assert got == payloads[key]
    finally:
        vs.stop()
        ms.stop()


def test_tier_keep_local_stays_readonly_across_restart(gateway, tmp_path):
    """-keepLocal: the local .dat stays a hot read cache, but the S3 copy
    is durable — a restart must not load the volume writable."""
    store = Store([tmp_path], max_volumes=4)
    try:
        store.create_volume(6)
        store.volumes[("", 6)].write_needle(needle.Needle(
            cookie=2, id=1, data=b"cold", append_at_ns=1))
        env = CommandEnv(store=store, device="cpu")
        run_command(env, f"volume.tier.upload -volumeId 6 "
                         f"-dest {gateway.url}/coldstore -keepLocal")
        assert (tmp_path / "6.dat").exists()
        assert (tmp_path / "6.tier").exists()
    finally:
        store.close()
    store2 = Store([tmp_path], max_volumes=4)
    store2.load_existing()
    try:
        vol2 = store2.volumes[("", 6)]
        assert vol2.readonly and store2.is_readonly(6)
        assert vol2.read_needle(1, cookie=2).data == b"cold"
        with pytest.raises(VolumeError, match="read-only"):
            vol2.write_needle(needle.Needle(cookie=2, id=2, data=b"x",
                                            append_at_ns=2))
        with pytest.raises(VolumeError, match="read-only"):
            vol2.delete_needle(1)
        with pytest.raises(VolumeError, match="read-only"):
            vacuum.compact(vol2)
        assert store2.vacuum_volume(6) is None  # skipped, not an error
    finally:
        store2.close()
    assert "secret" not in (tmp_path / "6.tier").read_text()


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_tier_sidecar_corruption_detected(tmp_path, pkg):
    (tmp_path / "9.tier").write_text("{not json")
    t = PKG[pkg]["tier"]
    with pytest.raises(t.TierError, match="corrupt"):
        t.TierInfo.maybe_load(tmp_path / "9")


def test_tier_upload_missing_volume(tmp_path):
    env = CommandEnv(store=Store([tmp_path], max_volumes=2), device="cpu")
    with pytest.raises(ShellError):
        run_command(env, "volume.tier.upload -volumeId 42 -dest x/y")


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------

def _write_volume(pkg, d, vid, payloads):
    """``vid`` with ``payloads`` written through ``pkg``'s Volume."""
    m = PKG[pkg]
    with m["volume"].Volume(d / str(vid), vid).create() as v:
        for nid, data in payloads.items():
            v.write_needle(m["needle"].Needle(cookie=5, id=nid, data=data,
                                              append_at_ns=nid))


def test_either_package_opens_the_others_tiered_volume(gateways,
                                                       tmp_path):
    """One volume, written alike in two directories and tiered by each
    package to one object key: equal sidecars; each package's store then
    opens the other's tiered directory, reads every needle equal, and
    brings the .dat back sha256-equal to the original."""
    payloads = _payloads(24, 30_000, seed=4)
    dirs = {pkg: tmp_path / pkg for pkg in PKG}
    for pkg, d in dirs.items():
        d.mkdir()
        _write_volume("port", d, 8, payloads)
    orig = hashlib.sha256((dirs["port"] / "8.dat").read_bytes()).digest()
    assert hashlib.sha256((dirs["jax"] / "8.dat").read_bytes()).digest() \
        == orig
    dest = f"{gateways['port'].url}/coldstore"
    pstore = Store([dirs["port"]], max_volumes=4)
    pstore.load_existing()
    try:
        run_command(CommandEnv(store=pstore, device="cpu"),
                    f"volume.tier.upload -volumeId 8 -dest {dest}")
    finally:
        pstore.close()
    jstore = jax_store.Store([dirs["jax"]], max_volumes=4)
    jstore.load_existing()
    try:
        jax_commands.run_command(jax_commands.CommandEnv(store=jstore),
                                 f"volume.tier.upload -volumeId 8 "
                                 f"-dest {dest}")
    finally:
        jstore.close()
    assert (dirs["port"] / "8.tier").read_bytes() == \
        (dirs["jax"] / "8.tier").read_bytes()
    for opener, d in (("jax", dirs["port"]), ("port", dirs["jax"])):
        if opener == "jax":
            st = jax_store.Store([d], max_volumes=4)
            env = jax_commands.CommandEnv(store=st)
            run = jax_commands.run_command
        else:
            st = Store([d], max_volumes=4)
            env = CommandEnv(store=st, device="cpu")
            run = run_command
        st.load_existing()
        try:
            vol = st.volumes[("", 8)]
            assert vol.backend_kind == "s3" and vol.readonly
            for nid, want in payloads.items():
                assert vol.read_needle(nid, cookie=5).data == want
            run(env, "volume.tier.download -volumeId 8")
        finally:
            st.close()
        assert hashlib.sha256((d / "8.dat").read_bytes()).digest() == orig
        assert not (d / "8.tier").exists()


def test_signed_multipart_upload_and_download(gateways, tmp_path,
                                              monkeypatch):
    """With credentials the upload goes through the gateway's multipart
    API in ``chunk``-sized parts; the sidecar keeps no credential, the
    environment supplies them to the reader, and both packages' tiers do
    it alike against an auth-enabled port gateway."""
    port_gw = gateways["port"]
    ident = s3_auth.Identity("tier", "TIERAK", "TIERSK")
    gw = s3.S3Gateway(port_gw.filer.filer_url, port=_free_port_pair(),
                      identities=[ident]).start()
    try:
        payloads = _payloads(30, 50_000, seed=9)
        got = {}
        for pkg in PKG:
            d = tmp_path / pkg
            d.mkdir()
            _write_volume(pkg, d, 4, payloads)
            dat = (d / "4.dat").read_bytes()
            want = hashlib.sha256(dat).digest()
            size = len(dat)
            t = PKG[pkg]["tier"]
            info = t.upload_volume_dat(d / "4", gw.url, "coldstore",
                                       key=f"signed-{pkg}.dat",
                                       access_key="TIERAK",
                                       secret_key="TIERSK",
                                       chunk=256 * 1024)
            assert info.size == size and not (d / "4.dat").exists()
            text = (d / "4.tier").read_text()
            assert "TIERSK" not in text and "TIERAK" not in text
            env = "SEAWEEDFS_TPU_TIER" if pkg == "jax" else \
                "SEAWEEDFS_TORCH_TIER"
            monkeypatch.setenv(f"{env}_ACCESS_KEY", "TIERAK")
            monkeypatch.setenv(f"{env}_SECRET_KEY", "TIERSK")
            f = t.S3TierFile.from_dat_path(d / "4.dat")
            assert f.read_at(300_000, 1000) == dat[1000:301_000]
            f.close()
            t.download_volume_dat(d / "4")
            got[pkg] = (hashlib.sha256((d / "4.dat").read_bytes()).digest()
                        == want, text.replace(pkg, "<pkg>"))
        assert got["port"] == got["jax"]
        assert got["port"][0]
    finally:
        gw.stop()


def test_deleting_a_tiered_volume_leaves_no_sidecar_in_the_port(gateways,
                                                                tmp_path):
    """``Store.delete_volume`` of a tiered volume: the JAX package
    leaves its ``.tier`` sidecar behind, so the next ``load_existing``
    fails on a tiered volume with no ``.idx``, and a volume re-created
    under the id loads read-only. The port deletes the sidecar with the
    .dat and .idx: the store reloads, and the new volume is writable."""
    dest = gateways["port"].url
    got = {}
    for pkg in PKG:
        d = tmp_path / pkg
        d.mkdir()
        _write_volume(pkg, d, 6, _payloads(4, 1000, seed=1))
        st = PKG[pkg]["store"]([d], max_volumes=4)
        st.load_existing()
        PKG[pkg]["tier"].upload_volume_dat(d / "6", dest, "coldstore",
                                           key=f"del-{pkg}.dat")
        st.volumes[("", 6)].retier()
        st.delete_volume(6)
        st.close()
        left = sorted(p.name for p in d.iterdir())
        st = PKG[pkg]["store"]([d], max_volumes=4)
        try:
            st.load_existing()
            reload_error = ""
        except Exception as e:  # noqa: BLE001 — the fault under test
            reload_error = type(e).__name__
        st.close()
        (d / "6.idx").unlink(missing_ok=True)
        st = PKG[pkg]["store"]([d], max_volumes=4)
        st.create_volume(6)
        st.close()
        st = PKG[pkg]["store"]([d], max_volumes=4)
        st.load_existing()
        got[pkg] = (left, reload_error, st.volumes[("", 6)].readonly)
        st.close()
    assert got["jax"] == (["6.tier"], "VolumeError", True)
    assert got["port"] == ([], "", False)
