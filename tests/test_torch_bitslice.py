"""The port's plain PyTorch bitsliced codec (seaweedfs_tpu_torch/ops/
bitslice.py) against the JAX package's (seaweedfs_tpu/ops/bitslice.py)
and the numpy oracle, on the CPU. GF(2^8) coding is exact, so every
comparison is byte for byte (tolerance 0). Inputs come from numpy with a
fixed seed and go to both frameworks as numpy arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seaweedfs_tpu.ops import bitslice as jax_bitslice, rs_jax
from seaweedfs_tpu.ops import xor_cse as jax_xor_cse
from seaweedfs_tpu_torch.ops import bitslice, gf256, xor_cse
from seaweedfs_tpu_torch.ops.rs_ref import ReferenceEncoder
from torch_teardown import collect_jax_garbage  # noqa: F401


def _i32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _oracle(coefs: np.ndarray, x: np.ndarray) -> np.ndarray:
    mt = gf256.mul_table()
    out = np.zeros((x.shape[0], coefs.shape[0], x.shape[2]), np.uint8)
    for o in range(coefs.shape[0]):
        for d in range(coefs.shape[1]):
            out[:, o] ^= mt[coefs[o, d]][x[:, d]]
    return out


def test_logical_right_shift_of_top_bit():
    # int32 >> is arithmetic in PyTorch: srl must clear the fill bits
    t = _i32(np.array([0x80000000, 0xFFFFFFFF, 0x12345678], np.uint32))
    got = bitslice.srl(t, 16).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, np.array([0x8000, 0xFFFF, 0x1234], np.uint32))


def test_transpose32_involution_with_bit31_set():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, (4, 32), dtype=np.uint32)
    w[:, ::2] |= np.uint32(0x80000000)
    t = bitslice.transpose32(_i32(w))
    np.testing.assert_array_equal(
        t.numpy().view(np.uint32),
        np.asarray(jax_bitslice.transpose32(jnp.asarray(w))))
    np.testing.assert_array_equal(
        bitslice.transpose32(t).numpy().view(np.uint32), w)


def test_transpose32_is_the_bit_transpose():
    # T[i] bit w == A[w] bit i, on a matrix whose top row and column are set
    w = np.zeros(32, np.uint32)
    w[31] = 0xFFFFFFFF
    w[:] |= np.uint32(0x80000000)
    t = bitslice.transpose32(_i32(w)).numpy().view(np.uint32)
    bits = (w[:, None] >> np.arange(32, dtype=np.uint32)) & 1  # [w, i]
    tbits = (t[:, None] >> np.arange(32, dtype=np.uint32)) & 1  # [i, w]
    np.testing.assert_array_equal(tbits, bits.T)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (2, 3, 512), dtype=np.uint8)
    p = bitslice.pack(torch.from_numpy(x))
    np.testing.assert_array_equal(
        p.numpy().view(np.uint32),
        np.asarray(jax_bitslice.pack(jnp.asarray(x))))
    np.testing.assert_array_equal(bitslice.unpack(p).numpy(), x)


def test_expand_gf2_matches_reference():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    np.testing.assert_array_equal(bitslice.expand_gf2(c),
                                  jax_bitslice.expand_gf2(c))


def _jax_bitslice(coefs, x):
    # jitted: the eager network dispatches one op per XOR
    return np.asarray(jax.jit(
        lambda v: jax_bitslice.apply_gf_matrix(coefs, v))(jnp.asarray(x)))


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 4)])
def test_apply_gf_matrix_parity(k, m):
    rng = np.random.default_rng(k * 31 + m)
    x = rng.integers(0, 256, (2, k, 384), dtype=np.uint8)
    coefs = ReferenceEncoder(k, m).matrix[k:]
    got = bitslice.apply_gf_matrix(coefs, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _oracle(coefs, x))
    if (k, m) == (10, 4):
        # the JAX network compiles per matrix (seconds each); RS(10,4)
        # here and the decode rows below hold the port against it
        np.testing.assert_array_equal(got, _jax_bitslice(coefs, x))
    else:
        np.testing.assert_array_equal(
            got, np.asarray(rs_jax.Encoder(k, m).encode_parity(x)))


@pytest.mark.parametrize("lost", [(2, 7, 11, 13), (0, 1, 2, 3), (10, 11)])
def test_apply_gf_matrix_decode_rows(lost):
    rng = np.random.default_rng(sum(lost))
    ref = ReferenceEncoder(10, 4)
    data = rng.integers(0, 256, (1, 10, 256), dtype=np.uint8)
    full = np.concatenate([data, _oracle(ref.matrix[10:], data)], axis=1)
    present = [i for i in range(14) if i not in lost]
    decode = gf256.gf_matrix_invert(ref.matrix[present[:10]])
    rows = gf256.gf_matmul(ref.matrix[list(lost)], decode)
    surv = np.ascontiguousarray(full[:, present[:10]])
    got = bitslice.apply_gf_matrix(rows, torch.from_numpy(surv)).numpy()
    np.testing.assert_array_equal(got, full[:, list(lost)])
    if lost == (2, 7, 11, 13):
        np.testing.assert_array_equal(got, _jax_bitslice(rows, surv))


def test_apply_gf_matrix_rejects_bad_shapes():
    coefs = ReferenceEncoder(4, 2).matrix[4:]
    with pytest.raises(ValueError):
        bitslice.apply_gf_matrix(coefs, torch.zeros((1, 3, 128),
                                                    dtype=torch.uint8))
    with pytest.raises(ValueError):
        bitslice.apply_gf_matrix(coefs, torch.zeros((1, 4, 100),
                                                    dtype=torch.uint8))


def test_xor_cse_factor_matches_jax_and_computes_the_rows():
    mbits = bitslice.expand_gf2(ReferenceEncoder(4, 2).matrix[4:])
    rows = tuple(tuple(int(t) for t in np.nonzero(r)[0]) for r in mbits)
    steps, outs = xor_cse.factor(rows, 32)
    assert (steps, outs) == jax_xor_cse.factor(rows, 32)
    assert xor_cse.factored_cost(rows, 32) < xor_cse.xor_cost(rows)
    planes = [int(v) for v in np.random.default_rng(4).integers(
        0, 2**63, 32, dtype=np.int64)]
    for new_id, a, b in steps:
        assert new_id == len(planes)
        planes.append(planes[a] ^ planes[b])
    for row, out in zip(rows, outs):
        want = got = 0
        for t in row:
            want ^= planes[t]
        for t in out:
            got ^= planes[t]
        assert got == want
