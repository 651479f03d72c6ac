"""The port's checkpoint plane (``ckpt/manifest.py``, ``s3client.py``,
``loader.py``, ``sharding.py``, ``store.py``) against the JAX package's,
on the CPU.

Every case of ``tests/test_ckpt.py`` runs on the port's store over torch
tensors sharded on an 8-entry CPU mesh (2 x 4, the JAX tests' 8 virtual
devices), against both packages' S3 gateways. Then the packages swap
checkpoints in both directions, through both gateways: one JAX saved
from its 8-device mesh (values from numpy) restores in the port
bit-equal, and one the port saved restores in JAX bit-equal; for the
same values the two manifests are byte-equal and each package parses the
other's; an armed ``crash.ckpt.save`` leaves no visible checkpoint in
either package. Tolerance 0: every comparison is of bytes."""

import hashlib
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from seaweedfs_tpu import ckpt as jax_ckpt
from seaweedfs_tpu.cluster import filer_server as jax_filer_server
from seaweedfs_tpu.cluster import master as jax_master
from seaweedfs_tpu.cluster import volume_server as jax_volume_server
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.gateway import s3 as jax_s3
from seaweedfs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu_torch.ckpt import (CheckpointStore, CorruptShardError,
                                      GatewayClient, Manifest,
                                      ManifestError, NamedSharding,
                                      ObjectLoader, ParamSpec, ShardEntry,
                                      ShardedTensor, device_put,
                                      spec_from_json, spec_to_json)
from seaweedfs_tpu_torch import ckpt as port_ckpt
from seaweedfs_tpu_torch.ckpt import PartitionSpec as P
from seaweedfs_tpu_torch.cluster import filer_server, master, volume_server
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.gateway import s3
from seaweedfs_tpu_torch.parallel.mesh import Mesh
from seaweedfs_tpu_torch.storage import store
from seaweedfs_tpu_torch.util import faults

from test_cluster_integration import _free_port_pair
from torch_teardown import collect_jax_garbage  # noqa: F401

PULSE = 0.2
PKG = {"jax": (jax_master, jax_volume_server, jax_store, jax_filer_server,
               JaxFiler, jax_s3),
       "port": (master, volume_server, store, filer_server, Filer, s3)}


def _stack(tmp_path_factory, pkg):
    m_mod, vs_mod, st_mod, fs_mod, filer_cls, s3_mod = PKG[pkg]
    ms = m_mod.MasterServer(port=_free_port_pair(), volume_size_limit_mb=64,
                            pulse_seconds=PULSE, seed=23).start()
    kw = dict(device="cpu") if pkg == "port" else {}
    vs = vs_mod.VolumeServer(
        st_mod.Store([tmp_path_factory.mktemp(f"ckptvol_{pkg}")],
                     max_volumes=8),
        port=_free_port_pair(), master_url=ms.url, pulse_seconds=PULSE,
        **kw).start()
    deadline = time.time() + 10
    while time.time() < deadline and not ms.topology.nodes:
        time.sleep(0.05)
    filer = fs_mod.FilerServer(filer_cls(), port=_free_port_pair(),
                               master_url=ms.url).start()
    gw = s3_mod.S3Gateway(filer.url, port=_free_port_pair()).start()
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
    """The gateway the port's store saves to: the port's or JAX's."""
    return gateways[request.param]


def _mesh():
    """8 CPU entries as a 2 x 4 grid (the JAX tests' mesh shape)."""
    return Mesh([torch.device("cpu")] * 8, 2, 4)


def _values(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((64, 16), dtype=np.float32),
            rng.standard_normal(64, dtype=np.float32))


def _tree(mesh):
    w, b = _values()
    return {"layer0": {
        "w": device_put(torch.from_numpy(w), NamedSharding(mesh,
                                                           P("dp", "sp"))),
        "b": device_put(torch.from_numpy(b), NamedSharding(mesh, P("dp")))}}


def _jax_tree(mesh):
    w, b = _values()
    return {"layer0": {
        "w": jax.device_put(jnp.asarray(w),
                            JaxNamedSharding(mesh, JaxP("dp", "sp"))),
        "b": jax.device_put(jnp.asarray(b),
                            JaxNamedSharding(mesh, JaxP("dp")))}}


def _blocks_equal(t: ShardedTensor, want: np.ndarray) -> bool:
    """Every block holds exactly its slice of ``want``."""
    return all(np.array_equal(
        b.data.numpy(), want[tuple(slice(lo, hi) for lo, hi in
                                   zip(b.start, b.stop))])
        for b in t.blocks)


# ---------------------------------------------------------------------------
# manifest round-trip (no cluster)
# ---------------------------------------------------------------------------

def _toy_manifest(c=port_ckpt):
    spec = JaxP("dp") if c is jax_ckpt else P("dp")
    p = c.ParamSpec("layer0/w", "float32", (8, 4), c.spec_to_json(spec))
    p.shards = [c.ShardEntry("k1", (4, 0), (8, 4), 64, "b" * 64),
                c.ShardEntry("k0", (0, 0), (4, 4), 64, "a" * 64)]
    return c.Manifest({"dp": 2, "sp": 1}, [p])


def test_manifest_round_trip():
    man = _toy_manifest()
    man.finalize()
    man.validate()
    back = Manifest.from_json(man.to_json())
    assert back.mesh_axes == {"dp": 2, "sp": 1}
    p = back.param("layer0/w")
    assert p.dtype == "float32" and p.shape == (8, 4)
    assert [s.key for s in p.shards] == ["k0", "k1"]
    assert [(s.byte_start, s.byte_stop) for s in p.shards] == \
        [(0, 64), (64, 128)]
    assert spec_from_json(p.spec) == P("dp")
    # the JAX package writes the same bytes for the same manifest
    jman = _toy_manifest(jax_ckpt)
    jman.finalize()
    assert jman.to_json() == man.to_json()


def test_spec_json_round_trip():
    for spec, jspec in ((P(), JaxP()), (P("dp"), JaxP("dp")),
                        (P("dp", "sp"), JaxP("dp", "sp")),
                        (P(None, "sp"), JaxP(None, "sp")),
                        (P(("dp", "sp")), JaxP(("dp", "sp")))):
        assert spec_from_json(spec_to_json(spec)) == spec
        assert spec_to_json(spec) == jax_ckpt.spec_to_json(jspec)
        assert spec_from_json(jax_ckpt.spec_to_json(jspec)) == tuple(jspec)
        assert repr(spec) == repr(jspec)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        P("tp")


def test_manifest_rejects_bad_format():
    with pytest.raises(ManifestError):
        Manifest.from_json(b'{"format": "seaweed-ckpt/99", "params": []}')
    with pytest.raises(ManifestError):
        Manifest.from_json(b"not json at all")


def test_manifest_validate_catches_geometry_lies():
    man = _toy_manifest()
    man.finalize()
    man.param("layer0/w").shards[0].nbytes = 60
    with pytest.raises(ManifestError):
        man.validate()
    man = _toy_manifest()
    man.param("layer0/w").shards[0].stop = (12, 4)
    with pytest.raises(ManifestError):
        man.validate()
    with pytest.raises(ManifestError):
        Manifest({}, [ParamSpec("empty", "float32", (2,), [None])]) \
            .validate()
    with pytest.raises(ManifestError, match="dtype"):
        Manifest({}, [ParamSpec("odd", "float8", (2,), [None], [
            ShardEntry("k", (0,), (2,), 2, "a" * 64)])]).validate()


# ---------------------------------------------------------------------------
# sharded save/restore through a live gateway
# ---------------------------------------------------------------------------

def test_save_restore_byte_identical(gateway):
    mesh = _mesh()
    tree = _tree(mesh)
    st = CheckpointStore(gateway.url, bucket="ckpt-rt")
    man = st.save("step-1", tree)
    assert {p.name for p in man.params} == {"layer0/w", "layer0/b"}
    assert man.mesh_axes == {"dp": 2, "sp": 4}
    out = CheckpointStore(gateway.url, bucket="ckpt-rt").restore(
        "step-1", mesh=mesh, template=tree)
    for k in ("w", "b"):
        a, b = tree["layer0"][k], out["layer0"][k]
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert b.spec == a.spec and b.dtype == a.dtype
        assert [(x.start, x.stop, x.replica_id, x.cell)
                for x in b.blocks] == [(x.start, x.stop, x.replica_id,
                                        x.cell) for x in a.blocks]
        assert all(torch.equal(x.data, y.data)
                   for x, y in zip(a.blocks, b.blocks))


def test_restore_reads_only_shard_ranges(gateway):
    mesh = _mesh()
    st = CheckpointStore(gateway.url, bucket="ckpt-ranges")
    man = st.save("step-1", _tree(mesh))
    client = GatewayClient(gateway.url)
    CheckpointStore(gateway.url, bucket="ckpt-ranges",
                    client=client).restore("step-1", mesh=mesh)
    assert client.ranges, "restore must use HTTP range reads"
    spans = {s.key: s.nbytes for p in man.params for s in p.shards}
    total = 0
    for bucket, key, off, ln in client.ranges:
        assert bucket == "ckpt-ranges"
        assert key in spans, f"read outside the manifest: {key}"
        assert 0 <= off and off + ln <= spans[key]
        total += ln
    assert total == sum(spans.values())
    assert client.stats["gets"] == 1  # only the manifest


def test_restore_without_template_returns_flat_dict(gateway):
    mesh = _mesh()
    st = CheckpointStore(gateway.url, bucket="ckpt-flat")
    st.save("s", _tree(mesh))
    out = st.restore("s", mesh=mesh)
    assert set(out) == {"layer0/w", "layer0/b"}
    assert out["layer0/w"].shape == (64, 16)


def test_corrupted_shard_fails_closed(gateway):
    mesh = _mesh()
    st = CheckpointStore(gateway.url, bucket="ckpt-corrupt")
    man = st.save("step-1", _tree(mesh))
    victim = man.param("layer0/w").shards[0]
    GatewayClient(gateway.url).put("ckpt-corrupt", victim.key,
                                   b"\x00" * victim.nbytes)
    with pytest.raises(CorruptShardError) as ei:
        st.restore("step-1", mesh=mesh)
    assert "sha256" in str(ei.value)


def test_restore_missing_checkpoint_is_named_error(gateway):
    st = CheckpointStore(gateway.url, bucket="ckpt-rt")
    with pytest.raises(ManifestError):
        st.restore("never-saved", mesh=_mesh())


def test_overwrite_same_name(gateway):
    mesh = _mesh()
    st = CheckpointStore(gateway.url, bucket="ckpt-ow")
    sh = NamedSharding(mesh, P("dp"))
    st.save("latest", {"x": device_put(torch.arange(32.0), sh)})
    x2 = device_put(torch.arange(32.0) * 3, sh)
    st.save("latest", {"x": x2})
    out = st.restore("latest", mesh=mesh)
    assert np.array_equal(np.asarray(out["x"]), np.asarray(x2))


def test_list_checkpoints(gateway):
    mesh = _mesh()
    st = CheckpointStore(gateway.url, bucket="ckpt-ls")
    x = device_put(torch.ones(16), NamedSharding(mesh, P("dp")))
    st.save("a", {"x": x})
    st.save("b", {"x": x})
    names = {c["name"]: c for c in st.list_checkpoints()}
    assert set(names) == {"a", "b"}
    assert names["a"]["params"] == 1
    assert names["a"]["bytes"] == 64


def test_resharding_on_axis_0_and_refusal_elsewhere(gateway):
    """Saved over 2 x 4; ``b`` (split on axis 0 only) restores over 8 x 1
    (axis 0 cut finer: ranged sub-reads of each shard) and over 1 x 8
    (two shards joined); ``w`` over 1 x 8 would cut axis 1 differently
    and is refused."""
    tree = _tree(_mesh())
    st = CheckpointStore(gateway.url, bucket="ckpt-reshard")
    st.save("b", {"b": tree["layer0"]["b"]})
    st.save("w", {"w": tree["layer0"]["w"]})
    w, b = _values()
    for dp, sp in ((8, 1), (1, 8)):
        client = GatewayClient(gateway.url)
        out = CheckpointStore(gateway.url, bucket="ckpt-reshard",
                              client=client).restore(
            "b", mesh=Mesh([torch.device("cpu")] * 8, dp, sp))
        assert _blocks_equal(out["b"], b)
        assert len({x.start for x in out["b"].blocks}) == dp
        sub = [off for _, _, off, ln in client.ranges if off or ln < 128]
        assert bool(sub) == (dp == 8)
    with pytest.raises(ManifestError, match="axis-0"):
        st.restore("w", mesh=Mesh([torch.device("cpu")] * 8, 1, 8))


def test_plain_leaves_dtypes_and_scalars_round_trip(gateway):
    """Plain tensors and arrays are replicated; float16, bfloat16,
    int8 and a 0-d scalar keep their bytes; the manifest names dtypes
    as numpy does (``float16``, not ``torch.float16``)."""
    mesh = _mesh()
    rng = np.random.default_rng(2)
    tree = {"h": torch.from_numpy(rng.standard_normal((8, 4)).astype(
                np.float16)),
            "bf": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "q": np.arange(-4, 4, dtype=np.int8),
            "step": torch.tensor(17),
            "seq": [torch.zeros(2), (torch.ones(3),)]}
    st = CheckpointStore(gateway.url, bucket="ckpt-dtypes")
    man = st.save("d", tree)
    assert {p.name: p.dtype for p in man.params} == {
        "bf": "bfloat16", "h": "float16", "q": "int8", "step": "int64",
        "seq/0": "float32", "seq/1/0": "float32"}
    assert [p.name for p in man.params] == \
        ["bf", "h", "q", "seq/0", "seq/1/0", "step"]
    out = st.restore("d", mesh=mesh, template=tree)
    for got, want in ((out["h"], tree["h"]), (out["bf"], tree["bf"]),
                      (out["q"], torch.from_numpy(tree["q"])),
                      (out["step"], tree["step"]),
                      (out["seq"][1][0], tree["seq"][1][0])):
        assert got.spec == P(*[None] * want.dim())
        assert len(got.blocks) == 8
        assert all(torch.equal(b.data, want) for b in got.blocks)
        assert got.blocks[0].data.dtype == want.dtype


def test_crash_point_leaves_no_visible_checkpoint(gateway):
    """``crash.ckpt.save`` fires after every shard is written and before
    the manifest: the save fails and neither package sees a checkpoint,
    in the port or in JAX."""
    st = CheckpointStore(gateway.url, bucket="ckpt-crash")
    jst = jax_ckpt.CheckpointStore(gateway.url, bucket="ckpt-crash")
    try:
        faults.inject("crash.ckpt.save", "error")
        with pytest.raises(faults.FaultError):
            st.save("torn", _tree(_mesh()))
    finally:
        faults.clear()
    try:
        jax_faults.inject("crash.ckpt.save", "error")
        with pytest.raises(jax_faults.FaultError):
            jst.save("torn-jax", _jax_tree(jax_make_mesh()))
    finally:
        jax_faults.clear()
    for s in (st, jst):
        assert s.list_checkpoints() == []
    for name in ("torn", "torn-jax"):
        with pytest.raises(ManifestError):
            st.restore(name, mesh=_mesh())
        with pytest.raises(jax_ckpt.ManifestError):
            jst.restore(name, mesh=jax_make_mesh())
    # the shard objects are there, only the commit point is missing
    keys = GatewayClient(gateway.url).list("ckpt-crash")
    assert any(k.startswith("checkpoints/torn/layer0/") for k in keys)
    assert not any(k.endswith("manifest.json") for k in keys)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_in_the_port(gateway):
    """JAX saves from its 8-device mesh; the port restores over 8 CPU
    entries, every block bit-equal, the manifest parsed by both."""
    jst = jax_ckpt.CheckpointStore(gateway.url, bucket="ckpt-j2p")
    jman = jst.save("from-jax", _jax_tree(jax_make_mesh()))
    raw = GatewayClient(gateway.url).get(
        "ckpt-j2p", "checkpoints/from-jax/manifest.json")
    man = Manifest.from_json(raw)
    man.validate()
    assert man.to_json() == jman.to_json() == raw
    out = CheckpointStore(gateway.url, bucket="ckpt-j2p").restore(
        "from-jax", mesh=_mesh())
    w, b = _values()
    assert out["layer0/w"].spec == P("dp", "sp")
    assert out["layer0/b"].spec == P("dp")
    assert _blocks_equal(out["layer0/w"], w)
    assert _blocks_equal(out["layer0/b"], b)


def test_port_checkpoint_restores_in_jax(gateway):
    """The port saves over 8 CPU entries; JAX restores onto its 8-device
    mesh bit-equal with the same specs; for the same values the two
    packages' manifests are byte-equal."""
    st = CheckpointStore(gateway.url, bucket="ckpt-p2j")
    man = st.save("from-port", _tree(_mesh()))
    jst = jax_ckpt.CheckpointStore(gateway.url, bucket="ckpt-p2j")
    jman = jst.read_manifest("from-port")
    assert jman.to_json() == man.to_json()
    out = jst.restore("from-port", mesh=jax_make_mesh())
    w, b = _values()
    assert np.asarray(out["layer0/w"]).tobytes() == w.tobytes()
    assert np.asarray(out["layer0/b"]).tobytes() == b.tobytes()
    assert out["layer0/w"].sharding.spec == JaxP("dp", "sp")
    jst.save("from-jax", _jax_tree(jax_make_mesh()))
    assert jst.read_manifest("from-jax").to_json() == man.to_json() \
        .replace(b"from-port", b"from-jax")


def test_float16_checkpoint_crosses_both_ways(gateway):
    """float16 (the chip's Llama layer's dtype) under the name
    ``float16`` in both packages, bit-equal both ways."""
    v = np.random.default_rng(5).standard_normal((32, 8)).astype(
        np.float16)
    st = CheckpointStore(gateway.url, bucket="ckpt-f16")
    st.save("p", {"v": device_put(torch.from_numpy(v),
                                  NamedSharding(_mesh(), P("dp", "sp")))})
    jst = jax_ckpt.CheckpointStore(gateway.url, bucket="ckpt-f16")
    assert jst.read_manifest("p").param("v").dtype == "float16"
    assert np.asarray(jst.restore("p", mesh=jax_make_mesh())["v"]) \
        .tobytes() == v.tobytes()
    jst.save("j", {"v": jax.device_put(
        jnp.asarray(v), JaxNamedSharding(jax_make_mesh(),
                                         JaxP("dp", "sp")))})
    got = st.restore("j", mesh=_mesh())["v"]
    assert got.dtype == torch.float16 and _blocks_equal(got, v)


# ---------------------------------------------------------------------------
# dataloader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_bucket(gateways):
    client = GatewayClient(gateways["port"].url)
    client.ensure_bucket("train-data")
    objs = {}
    for i in range(12):
        data = hashlib.sha256(str(i).encode()).digest() * 8
        objs[f"shard-{i:04d}"] = data
        client.put("train-data", f"shard-{i:04d}", data)
    return client, objs


def test_loader_seeded_shuffle_is_deterministic(data_bucket):
    client, objs = data_bucket
    l1 = ObjectLoader(client, "train-data", seed=42)
    l2 = ObjectLoader(client, "train-data", seed=42)
    assert l1.epoch_order(0) == l2.epoch_order(0)
    assert l1.epoch_order(0) != l1.epoch_order(1)
    assert sorted(l1.epoch_order(1)) == sorted(objs)
    assert ObjectLoader(client, "train-data", seed=7).epoch_order(0) \
        != l1.epoch_order(0)
    # the JAX package's loader draws the same orders
    jl = jax_ckpt.ObjectLoader(jax_ckpt.GatewayClient(client.base),
                               "train-data", seed=42)
    assert [jl.epoch_order(e) for e in range(3)] == \
        [l1.epoch_order(e) for e in range(3)]


@pytest.mark.parametrize("depth", [0, 3])
def test_loader_scan_yields_all_objects_in_order(data_bucket, depth):
    client, objs = data_bucket
    loader = ObjectLoader(client, "train-data", seed=1,
                          prefetch_depth=depth)
    got = list(loader.scan(epoch=2))
    assert [k for k, _ in got] == loader.epoch_order(2)
    for key, data in got:
        assert data == objs[key]
    assert loader.stats["objects"] == len(objs)
    assert loader.stats["bytes"] == sum(len(v) for v in objs.values())


def test_loader_propagates_fetch_errors(data_bucket):
    client, _ = data_bucket
    loader = ObjectLoader(client, "train-data",
                          keys=["shard-0000", "missing-object"],
                          prefetch_depth=2)
    with pytest.raises(Exception):
        list(loader.scan())


def test_gateway_client_refuses_a_whole_body_for_a_range(gateways):
    """``get_range`` demands a 206 with the asked-for Content-Range."""
    client = GatewayClient(gateways["port"].url)
    client.ensure_bucket("ckpt-rng")
    client.put("ckpt-rng", "o", b"0123456789")
    assert client.get_range("ckpt-rng", "o", 2, 5) == b"23456"
    assert client.head("ckpt-rng", "o") == 10
    assert client.head("ckpt-rng", "absent") is None
    assert client.stats["ranged_gets"] == 1
    url = f"http://{gateways['port'].url}/ckpt-rng/o"
    with urllib.request.urlopen(urllib.request.Request(
            url, headers={"Range": "bytes=x-y"}), timeout=10) as r:
        assert r.status == 200   # what get_range must not accept
