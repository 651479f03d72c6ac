"""The port's multi-device split (seaweedfs_tpu_torch/parallel/mesh.py,
dryrun.py) and its routing in encode, rebuild and the batcher, against
the JAX package's, on the CPU.

The JAX tests run on 8 virtual CPU devices (tests/conftest.py); here
``mesh.local_devices("cpu")`` is monkeypatched to 8 CPU entries, so the
same (dp, sp) grids tile both packages. The same seeded inputs go through
both; every output must be byte-equal (tolerance 0: GF(2^8) coding is
exact), checksums included. Ports the cases of tests/test_mesh.py and
the mesh cases of tests/test_mesh_pipeline.py."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_jax import Encoder as JaxEncoder
from seaweedfs_tpu.ops.rs_ref import ReferenceEncoder
from seaweedfs_tpu.parallel import mesh as jax_mesh
from seaweedfs_tpu.pipeline import batch as jax_batch
from seaweedfs_tpu.pipeline import encode as jax_encode
from seaweedfs_tpu.pipeline import rebuild as jax_rebuild
from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
from seaweedfs_tpu_torch.ops import rs_torch
from seaweedfs_tpu_torch.parallel import dryrun
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.pipeline import batch as batch_mod
from seaweedfs_tpu_torch.pipeline import encode as encode_mod
from seaweedfs_tpu_torch.pipeline import rebuild as rebuild_mod
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage.superblock import SuperBlock
from torch_teardown import collect_jax_garbage  # noqa: F401

CPU8 = [torch.device("cpu")] * 8
SCHEME = EcScheme(10, 4, large_block_size=8192, small_block_size=2048)
JAX_SCHEME = JaxScheme(10, 4, large_block_size=8192, small_block_size=2048)
BATCH_BYTES = 64 * 1024


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    """8 CPU entries, as the JAX package's tests have 8 virtual CPU
    devices; the mesh config is restored after every test."""
    real = mesh_mod.local_devices
    monkeypatch.setattr(
        mesh_mod, "local_devices",
        lambda device_type="cuda": list(CPU8) if device_type == "cpu"
        else real(device_type))
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    yield
    mesh_mod.configure(enabled=False, dp=0, sp=0)


@pytest.fixture
def mesh8():
    return mesh_mod.make_mesh(CPU8)


def _enc():
    return rs_torch.Encoder(10, 4, device="cpu")


def _make_dat(base, nbytes, seed=7):
    rng = np.random.default_rng(seed)
    with open(str(base) + ".dat", "wb") as f:
        f.write(SuperBlock().to_bytes())
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())


def _shard_digest(base):
    h = hashlib.sha256()
    for i in range(SCHEME.total_shards):
        h.update(ec_files.shard_path(base, i).read_bytes())
    return h.hexdigest()


# ------------------------------------------------------------------
# the mesh and its configuration (tests/test_mesh.py,
# tests/test_mesh_pipeline.py)
# ------------------------------------------------------------------

def test_make_mesh_factorization(mesh8):
    # most-square with sp >= dp: 2 x 4, as the JAX mesh
    assert mesh8.shape == {"dp": 2, "sp": 4}
    assert mesh8.shape == dict(jax_mesh.make_mesh().shape)
    assert mesh8.device_type == "cpu"


def test_mesh_explicit_sizes():
    m = mesh_mod.make_mesh(CPU8, dp=4, sp=2)
    assert m.shape == {"dp": 4, "sp": 2}
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(CPU8, dp=3, sp=2)


def test_mesh_partial_sizes_respected():
    # a single explicit axis is honored, not silently refactorized
    m = mesh_mod.make_mesh(CPU8, dp=4)
    assert m.shape == {"dp": 4, "sp": 2}
    m = mesh_mod.make_mesh(CPU8, sp=8)
    assert m.shape == {"dp": 1, "sp": 8}
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(CPU8, dp=3)
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(CPU8, sp=5)


@pytest.mark.parametrize("kw,match", [
    (dict(dp=3, sp=3), r"2,4"), (dict(dp=5), r"does not divide"),
    (dict(dp=0, sp=8), r"positive")])
def test_make_mesh_error_suggests_auto_factorization(kw, match):
    with pytest.raises(ValueError, match=match) as port_err:
        mesh_mod.make_mesh(CPU8, **kw)
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.make_mesh(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_parse_spec():
    assert mesh_mod.parse_spec("2,4") == (2, 4)
    assert mesh_mod.parse_spec("auto") == (0, 0)
    assert mesh_mod.parse_spec("") == (0, 0)
    for bad in ("2x4", "2,", "0,8", "-1,8", "1,2,3"):
        with pytest.raises(mesh_mod.MeshConfigError) as port_err:
            mesh_mod.parse_spec(bad)
        with pytest.raises(jax_mesh.MeshConfigError) as jax_err:
            jax_mesh.parse_spec(bad)
        assert str(port_err.value) == str(jax_err.value)


def test_configured_mesh_disabled_is_none():
    assert mesh_mod.current().enabled is False
    assert mesh_mod.configured_mesh("cpu") is None
    assert mesh_mod.routing_mesh("cpu") is None


def test_explicit_mismatch_is_clear_error_not_refactor():
    # dp*sp != n_devices refuses with guidance, never silently picks
    # another factorization; the message is the JAX package's
    with pytest.raises(mesh_mod.MeshConfigError) as ei:
        with mesh_mod.scoped("3,3", "cpu"):
            pass
    msg = str(ei.value)
    assert "8" in msg and "dp*sp" in msg and "2,4" in msg
    with pytest.raises(jax_mesh.MeshConfigError) as jax_err:
        with jax_mesh.scoped("3,3"):
            pass
    assert msg == str(jax_err.value)
    # the config is restored even on the error path
    assert mesh_mod.current().enabled is False


def test_scoped_sets_and_restores():
    with mesh_mod.scoped("2,4", "cpu") as m:
        assert m.shape == {"dp": 2, "sp": 4}
        assert mesh_mod.current().enabled
        assert mesh_mod.configured_mesh("cpu") is m
        assert mesh_mod.routing_mesh("cpu") is m
    assert mesh_mod.current().enabled is False
    assert mesh_mod.routing_mesh("cpu") is None


def test_cuda_mesh_without_a_card_raises():
    """No fallback: a mesh of cards where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with mesh_mod.scoped("1,1", "cuda"):
            pass
    assert mesh_mod.current().enabled is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.routing_mesh()


# ------------------------------------------------------------------
# shard_batch: divisibility and padding
# ------------------------------------------------------------------

def test_shard_batch_validates_divisibility(mesh8):
    with pytest.raises(ValueError, match="not divisible by dp"):
        mesh_mod.shard_batch(np.zeros((3, 10, 128 * 8), dtype=np.uint8),
                             mesh8)  # B=3 not divisible by dp=2
    with pytest.raises(ValueError, match="not divisible by sp"):
        mesh_mod.shard_batch(np.zeros((2, 10, 128 * 3), dtype=np.uint8),
                             mesh8)  # S not divisible by sp*128


def test_shard_batch_uneven_rows_pad(mesh8):
    x = np.arange(3 * 10 * 1000, dtype=np.uint8).reshape(3, 10, 1000)
    arr = mesh_mod.shard_batch(x, mesh8, pad=True)
    assert arr.shape == (4, 10, 1024)  # rows -> dp multiple, S -> 512*2
    back = np.asarray(arr)
    assert np.array_equal(back[:3, :, :1000], x)
    assert not back[3:].any() and not back[:, :, 1000:].any()
    jax_arr = jax_mesh.shard_batch(x, jax_mesh.make_mesh(), pad=True)
    assert np.array_equal(back, np.asarray(jax_arr))
    # each cell holds its rows and its byte range
    assert len(arr.cells) == 8
    assert all(tuple(c.shape) == (2, 10, 256) for c in arr.cells)
    assert np.array_equal(arr.cells[5].numpy(), back[2:4, :, 256:512])


def test_step_refuses_an_input_of_another_mesh(mesh8):
    x = np.zeros((4, 10, 1024), dtype=np.uint8)
    other = mesh_mod.make_mesh(CPU8, dp=4, sp=2)
    step = mesh_mod.make_sharded_encode_step(_enc(), mesh8)
    with pytest.raises(ValueError, match="mesh"):
        step(mesh_mod.shard_batch(x, other))


def test_shard_batch_aligned_pad_noop(mesh8):
    x = np.ones((4, 10, 1024), dtype=np.uint8)
    assert mesh_mod.shard_batch(x, mesh8, pad=True).shape == x.shape


# ------------------------------------------------------------------
# the verify steps and their u32 checksums, against the JAX steps
# ------------------------------------------------------------------

def test_sharded_encode_matches_jax_and_oracle(mesh8):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (4, 10, 128 * 8), dtype=np.uint8)
    parity, csum = mesh_mod.make_sharded_encode_step(_enc(), mesh8)(
        mesh_mod.shard_batch(x, mesh8))
    parity = np.asarray(parity)
    jm = jax_mesh.make_mesh()
    j_parity, j_csum = jax_mesh.make_sharded_encode_step(
        JaxEncoder(10, 4), jm)(jax_mesh.shard_batch(x, jm))
    assert np.array_equal(parity, np.asarray(j_parity))
    assert csum == int(j_csum)
    ref = ReferenceEncoder(10, 4)
    for i in range(4):
        assert np.array_equal(parity[i], ref.encode_parity(x[i]))
    # the checksum contract is the byte-sum mod 2^32
    assert csum == int(parity.astype(np.uint64).sum()) % (2 ** 32)


def test_sharded_train_step_zero_mismatches(mesh8):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (2, 10, 128 * 4 * 2), dtype=np.uint8)
    parity, mismatches = mesh_mod.make_sharded_train_step(
        _enc(), mesh8, lost=(1, 7, 12))(mesh_mod.shard_batch(x, mesh8))
    assert mismatches == 0
    assert parity.shape == (2, 4, 128 * 4 * 2)
    jm = jax_mesh.make_mesh()
    j_parity, j_mism = jax_mesh.make_sharded_train_step(
        JaxEncoder(10, 4), jm, lost=(1, 7, 12))(jax_mesh.shard_batch(x, jm))
    assert np.array_equal(np.asarray(parity), np.asarray(j_parity))
    assert mismatches == int(j_mism)


def test_sharded_train_step_counts_mismatches(mesh8, monkeypatch):
    """The mismatch count is real: a decode matrix for the wrong loss
    pattern rebuilds wrong bytes, and both steps count the same."""
    enc = _enc()
    right = enc.decode_matrix_rows
    monkeypatch.setattr(enc, "decode_matrix_rows",
                        lambda present, wanted: right(present, wanted)[::-1])
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, 10, 512 * 2), dtype=np.uint8)
    _parity, mismatches = mesh_mod.make_sharded_train_step(
        enc, mesh8, lost=(1, 7))(mesh_mod.shard_batch(x, mesh8))
    want = 0
    ref = ReferenceEncoder(10, 4)
    for i in range(2):
        full = np.concatenate([x[i], ref.encode_parity(x[i])])
        want += int((full[[7, 1]] != full[[1, 7]]).sum())
    assert mismatches == want > 0


@pytest.mark.parametrize("lost,present", [
    ((13,), list(range(13))),
    ((3, 7), [0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13]),
    ((0, 5, 11, 13), [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]),
    ((1, 2, 3, 4), [0, 10, 11, 12, 13, 5, 6, 7, 8, 9]),
])
def test_sharded_rebuild_uneven_survivors(mesh8, lost, present):
    """The sp-split rebuild is byte-exact for UNEVEN survivor sets
    (data-heavy, parity-heavy, parity-first orderings)."""
    ref = ReferenceEncoder(10, 4)
    rng = np.random.default_rng(sum(lost))
    data = rng.integers(0, 256, (10, 128 * 8), dtype=np.uint8)
    full = np.concatenate([data, ref.encode_parity(data)], axis=0)
    surv = np.tile(np.stack([full[i] for i in present[:10]])[None],
                   (2, 1, 1))
    rebuilt, csum = mesh_mod.make_sharded_rebuild_step(
        _enc(), mesh8, present, list(lost))(mesh_mod.shard_batch(surv,
                                                                 mesh8))
    got = np.asarray(rebuilt)
    for j, lid in enumerate(lost):
        assert np.array_equal(got[0, j], full[lid]), lid
    assert csum == int(got.astype(np.uint64).sum()) % (2 ** 32)
    jm = jax_mesh.make_mesh()
    j_got, j_csum = jax_mesh.make_sharded_rebuild_step(
        JaxEncoder(10, 4), jm, present, list(lost))(
        jax_mesh.shard_batch(surv, jm))
    assert np.array_equal(got, np.asarray(j_got))
    assert csum == int(j_csum)


def test_checksum_wraps_mod_2_32_like_jax(mesh8):
    """An output whose byte sum exceeds 2^32: the checksum wraps once,
    over the sum of every cell, exactly as the JAX uint32 psum."""
    s = 5 * 1024 * 1024
    x = np.full((2, 2, s), 0xFF, dtype=np.uint8)
    step = mesh_mod.make_sharded_rebuild_step(
        rs_torch.Encoder(2, 2, device="cpu"), mesh8, [0, 1], [0, 1])
    rebuilt, csum = step(mesh_mod.shard_batch(x, mesh8))
    raw = 0xFF * x.size
    assert raw > 2 ** 32 and np.array_equal(np.asarray(rebuilt), x)
    assert csum == raw % 2 ** 32
    jm = jax_mesh.make_mesh()
    _got, j_csum = jax_mesh.make_sharded_rebuild_step(
        JaxEncoder(2, 2), jm, [0, 1], [0, 1])(jax_mesh.shard_batch(x, jm))
    assert csum == int(j_csum)


# ------------------------------------------------------------------
# the host-batch path: prepare / apply, padding, auto mesh
# ------------------------------------------------------------------

def test_encode_parity_host_sharded_pads_and_matches_jax(mesh8):
    """Odd row counts and non-granular S pad across the mesh and slice
    back, byte-exact; with no mesh the auto mesh over the CPU entries."""
    rng = np.random.default_rng(2)
    # B=3 (not divisible by dp=2), S=1000 (not divisible by sp*128)
    x = rng.integers(0, 256, (3, 10, 1000), dtype=np.uint8)
    want = np.asarray(jax_mesh.encode_parity_host_sharded(
        JaxEncoder(10, 4), x))
    for mesh in (mesh8, None):
        got = np.asarray(mesh_mod.encode_parity_host_sharded(_enc(), x,
                                                             mesh))
        assert got.shape == (3, 4, 1000)
        assert np.array_equal(got, want)
    ref = ReferenceEncoder(10, 4)
    for i in range(3):
        np.testing.assert_array_equal(want[i], ref.encode_parity(x[i]))


def test_reconstruct_host_sharded_matches_jax():
    ref = ReferenceEncoder(10, 4)
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (10, 1000), dtype=np.uint8)
    full = np.concatenate([data, ref.encode_parity(data)], axis=0)
    lost = [0, 5, 11, 13]
    present = [i for i in range(14) if i not in lost]
    surv = np.stack([full[i] for i in present])[None]
    got = np.asarray(mesh_mod.reconstruct_host_sharded(
        _enc(), surv, present, lost))
    assert got.shape == (1, 4, 1000)
    assert np.array_equal(got, np.asarray(jax_mesh.reconstruct_host_sharded(
        JaxEncoder(10, 4), surv, present, lost)))
    for j, lid in enumerate(lost):
        np.testing.assert_array_equal(got[0, j], full[lid])


def test_explicit_mesh_honored_for_small_batch():
    # b=1 < dp=2: the explicit mesh pads rows instead of silently
    # dropping to the dp=1 auto mesh
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (1, 10, 2048), dtype=np.uint8)
    ref = np.asarray(JaxEncoder(10, 4).encode_parity_host(x))
    enc = _enc()
    with mesh_mod.scoped("2,4", "cpu") as m:
        prep = mesh_mod.prepare_batch(x, m)
        assert prep.mesh is m and prep.arr.shape[0] == 2
        out = np.asarray(mesh_mod.apply_prepared(enc.parity_coefs, prep))
    assert np.array_equal(out, ref)
    # the auto mesh for the same batch is sp-only
    assert mesh_mod.prepare_batch(x, device="cpu").mesh.shape == \
        {"dp": 1, "sp": 8}


def test_one_cell_copies_no_staging():
    """A 1 x 1 grid with nothing to pad hands the whole contiguous batch
    to its cell as it is; any split or padding stages each cell."""
    one = mesh_mod.make_mesh([torch.device("cpu")])
    x = np.random.default_rng(4).integers(0, 256, (2, 10, 1024),
                                          dtype=np.uint8)
    prep = mesh_mod.prepare_batch(x, one)
    assert prep.arr.cells[0].data_ptr() == x.ctypes.data
    padded = mesh_mod.prepare_batch(x[:, :, :1000], one)
    assert padded.arr.cells[0].shape == (2, 10, 1024)
    out = mesh_mod.apply_prepared(_enc().parity_coefs, prep)
    ref = ReferenceEncoder(10, 4)
    assert np.array_equal(np.asarray(out),
                          np.stack([ref.encode_parity(r) for r in x]))


def test_padded_row_never_reaches_a_result():
    """A (25, 10, S) slab on dp=2 pads to 26 rows; the result holds the
    25 real rows only, and the padded row's cells computed zeros."""
    m = mesh_mod.make_mesh(CPU8[:4], dp=2, sp=2)
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (25, 10, 512), dtype=np.uint8)
    prep = mesh_mod.prepare_batch(x, m)
    assert prep.arr.shape == (26, 10, 512)
    out = mesh_mod.apply_prepared(_enc().parity_coefs, prep)
    assert out.shape == (26, 4, 512)
    got = np.asarray(out)
    assert got.shape == (25, 4, 512)
    want = np.asarray(JaxEncoder(10, 4).encode_parity_host(x))
    assert np.array_equal(got, want)
    # the last row cell (rows 13-25, the padded row 25 among them)
    _rows, _cols, host, _done = out.outs[-1]
    assert not host.numpy()[-1].any()


def test_telemetry_totals(tmp_path):
    mesh_mod.reset_telemetry()
    base = tmp_path / "m"
    _make_dat(base, 150 * 1024)
    with mesh_mod.scoped("2,4", "cpu"):
        encode_mod.write_ec_files(base, SCHEME, BATCH_BYTES, device="cpu")
    pay = mesh_mod.debug_payload()
    assert pay["batches"] > 0
    assert pay["bytes_in"] > 0 and pay["bytes_out"] > 0
    assert pay["dispatch_seconds"] > 0
    assert pay["collective_seconds"] > 0
    assert pay["axes"] == {"dp": 2, "sp": 4}
    assert pay["configured"] == {"enabled": False, "dp": 0, "sp": 0}
    mesh_mod.reset_telemetry()
    assert mesh_mod.debug_payload()["batches"] == 0


# ------------------------------------------------------------------
# routing: encode / rebuild / batcher, byte identity with both packages
# ------------------------------------------------------------------

def test_mesh_file_encode_matches_single_device_bytes(tmp_path,
                                                     monkeypatch):
    bases = {name: tmp_path / name for name in ("jax", "port", "mesh")}
    for b in bases.values():
        _make_dat(b, 300 * 1024 + 777)
    jax_encode.write_ec_files(bases["jax"], JAX_SCHEME, BATCH_BYTES)
    encode_mod.write_ec_files(bases["port"], SCHEME, BATCH_BYTES,
                              device="cpu")
    calls = []
    real = mesh_mod.apply_prepared

    def spy(coefs, prep):
        calls.append((prep.mesh.shape, prep.arr.shape[0] - prep.b))
        return real(coefs, prep)

    monkeypatch.setattr(mesh_mod, "apply_prepared", spy)
    with mesh_mod.scoped("2,4", "cpu"):
        encode_mod.write_ec_files(bases["mesh"], SCHEME, BATCH_BYTES,
                                  device="cpu")
    assert calls and all(c == {"dp": 2, "sp": 4} for c, _ in calls)
    # batches of 1 and 3 rows padded to the dp multiple: the padded rows
    # never reach a shard file
    assert any(pad for _, pad in calls)
    digests = {name: _shard_digest(b) for name, b in bases.items()}
    assert digests["mesh"] == digests["port"] == digests["jax"]


def test_mesh_rebuild_lost_shards_matches_bytes(tmp_path):
    bases = {name: tmp_path / name for name in ("jax", "port")}
    lost = [1, 7, 12, 13]  # data + parity mix
    originals = {}
    for name, base in bases.items():
        _make_dat(base, 200 * 1024 + 123)
        encode_mod.write_ec_files(base, SCHEME, BATCH_BYTES, device="cpu")
        originals[name] = {i: ec_files.shard_path(base, i).read_bytes()
                           for i in lost}
        for i in lost:
            ec_files.shard_path(base, i).unlink()
    with jax_mesh.scoped("2,4"):
        jax_done = jax_rebuild.rebuild_ec_files(bases["jax"], JAX_SCHEME,
                                                chunk_bytes=32 * 1024)
    with mesh_mod.scoped("2,4", "cpu"):
        done = rebuild_mod.rebuild_ec_files(bases["port"], SCHEME,
                                            chunk_bytes=32 * 1024,
                                            device="cpu")
    assert sorted(done) == sorted(jax_done) == lost
    for i in lost:
        got = ec_files.shard_path(bases["port"], i).read_bytes()
        assert got == originals["port"][i]
        assert got == ec_files.shard_path(bases["jax"], i).read_bytes()


def test_batcher_routes_through_configured_mesh(monkeypatch):
    routed = []
    real = mesh_mod.encode_parity_host_sharded

    def spy(enc, batch, mesh=None):
        routed.append(mesh)
        return real(enc, batch, mesh)

    monkeypatch.setattr(mesh_mod, "encode_parity_host_sharded", spy)
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, 9000, dtype=np.uint8)
                for _ in range(4)]
    _, ref = batch_mod.encode_many(payloads, SCHEME, keep_output=True,
                                   device="cpu")
    assert not routed                         # CPU default: host path
    with mesh_mod.scoped("2,4", "cpu") as m:
        _, out = batch_mod.encode_many(payloads, SCHEME, keep_output=True,
                                       device="cpu")
    assert routed and all(r is m for r in routed)
    _, jax_out = jax_batch.encode_many(payloads, JAX_SCHEME,
                                       keep_output=True)
    for vol_ref, vol_out, vol_jax in zip(ref, out, jax_out):
        for s_ref, s_out, s_jax in zip(vol_ref, vol_out, vol_jax):
            assert np.array_equal(s_ref, s_out)
            assert np.array_equal(s_jax, s_out)


def test_batcher_uses_mesh_on_several_cards(monkeypatch):
    """With more than one card and no flag, the batcher splits over the
    AUTO mesh; the CPU entries stand in for cards, as the JAX test
    stands its CPU devices in for an accelerator."""
    enc = _enc()
    fn = batch_mod._pick_encode_fn(enc)
    assert fn == enc.encode_parity_host        # one device: host path
    monkeypatch.setattr(mesh_mod, "_card", lambda dev: True)
    assert mesh_mod.routing_mesh("cpu") is mesh_mod.AUTO
    fn2 = batch_mod._pick_encode_fn(enc)
    assert fn2 != enc.encode_parity_host
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 10, 1024), dtype=np.uint8)
    got = np.asarray(fn2(x))
    from seaweedfs_tpu.ops import rs_jax
    monkeypatch.setattr(rs_jax, "_use_pallas", lambda: True)
    jax_fn = jax_batch._pick_encode_fn(JAX_SCHEME)
    assert np.array_equal(got, np.asarray(jax_fn(x)))
    ref = ReferenceEncoder(10, 4)
    for i in range(2):
        np.testing.assert_array_equal(got[i], ref.encode_parity(x[i]))
    # and a card count of one keeps the single-device path
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda device_type="cuda": CPU8[:1])
    assert mesh_mod.routing_mesh("cpu") is None


def test_rebuild_pipeline_routes_to_mesh_on_several_cards(monkeypatch,
                                                          tmp_path):
    """rebuild_ec_files with several cards rides the split over REAL
    shard files, byte-equal to the files the JAX package rebuilds on its
    auto mesh."""
    from seaweedfs_tpu.ops import rs_jax
    bases = {name: tmp_path / name for name in ("jax", "port")}
    for base in bases.values():
        _make_dat(base, 90_000, seed=3)
        encode_mod.write_ec_files(base, SCHEME, device="cpu")
    originals = {i: ec_files.shard_path(bases["port"], i).read_bytes()
                 for i in (3, 12)}
    for base in bases.values():
        for i in (3, 12):
            ec_files.shard_path(base, i).unlink()
    picked = []
    real = mesh_mod.reconstruct_host_sharded

    def spy(enc, chunk, present, wanted, mesh=None):
        picked.append(mesh)
        return real(enc, chunk, present, wanted, mesh)

    monkeypatch.setattr(mesh_mod, "reconstruct_host_sharded", spy)
    monkeypatch.setattr(mesh_mod, "_card", lambda dev: True)
    monkeypatch.setattr(rs_jax, "_use_pallas", lambda: True)
    assert rebuild_mod.rebuild_ec_files(bases["port"], SCHEME,
                                        device="cpu") == [3, 12]
    assert jax_rebuild.rebuild_ec_files(bases["jax"], JAX_SCHEME) == [3, 12]
    assert picked and all(p is mesh_mod.AUTO for p in picked)
    for i in (3, 12):
        got = ec_files.shard_path(bases["port"], i).read_bytes()
        assert got == originals[i]
        assert got == ec_files.shard_path(bases["jax"], i).read_bytes()


# ------------------------------------------------------------------
# the dry-run twin
# ------------------------------------------------------------------

def test_dryrun_twin_over_eight_cpu_entries():
    out = dryrun.run(CPU8)
    assert out == {"mesh": {"dp": 2, "sp": 4}, "parity": [4, 4, 1024],
                   "mismatches": 0, "file_rebuild_survivor_sets": 4,
                   "config3_rows": out["config3_rows"]}
    assert out["config3_rows"] > 0


def test_dryrun_twin_reports_a_mismatch(monkeypatch):
    """The dry run fails on wrong bytes: a parity row that is not the
    oracle's stops it."""
    from seaweedfs_tpu_torch.ops import rs_cuda
    real = rs_cuda.apply_gf_matrix

    def wrong(coefs, x):
        y = real(coefs, x)
        return y ^ 1 if coefs.shape[0] == 4 else y

    monkeypatch.setattr(rs_cuda, "apply_gf_matrix", wrong)
    with pytest.raises(dryrun.DryRunError):
        dryrun.run(CPU8)
