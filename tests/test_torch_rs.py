"""The port's kernel module (seaweedfs_tpu_torch/ops/rs_cuda.py) and codec
(ops/rs_torch.py) against the JAX package, on the CPU.

Each kernel's plain PyTorch version is held against its TPU kernel run
by the Pallas interpreter at reduced block heights (transpose rb=1: a
16 KiB granule; SWAR rows_per_block=8: 4 KiB), as tests/test_rs_pallas.py
runs them. The coefficient tables the CUDA kernels read are checked by
evaluating each kernel's own formula over them in numpy. The Encoder is
held against seaweedfs_tpu.ops.rs_jax.Encoder. GF(2^8) coding is exact:
every comparison is byte for byte. The kernels themselves run only on a
card: tests/test_torch_cuda.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seaweedfs_tpu.ops import rs_jax, rs_pallas
from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_torch
from seaweedfs_tpu_torch.ops.rs_ref import ReferenceEncoder
from torch_teardown import collect_jax_garbage  # noqa: F401

LOST = (2, 7, 11, 13)
PRESENT = [i for i in range(14) if i not in LOST]


def _oracle(coefs, x):
    mt = gf256.mul_table()
    out = np.zeros((x.shape[0], coefs.shape[0], x.shape[2]), np.uint8)
    for o in range(coefs.shape[0]):
        for d in range(coefs.shape[1]):
            out[:, o] ^= mt[coefs[o, d]][x[:, d]]
    return out


def _padded(x, granule):
    pad = (-x.shape[-1]) % granule
    return np.pad(x, ((0, 0), (0, 0), (0, pad))) if pad else x


def _coef_sets():
    enc = ReferenceEncoder(10, 4)
    decode = gf256.gf_matrix_invert(enc.matrix[PRESENT[:10]])
    return {"parity": enc.matrix[10:],
            "decode": gf256.gf_matmul(enc.matrix[list(LOST)], decode)}


@pytest.mark.parametrize("which,s", [("parity", 16384 - 300),
                                     ("decode", 16384)])
def test_transpose_plain_matches_pallas_interpret(which, s):
    coefs = _coef_sets()[which]
    x = np.random.default_rng(s).integers(0, 256, (1, 10, s), np.uint8)
    got = rs_cuda.apply_gf_matrix_transpose_ref(coefs, torch.from_numpy(x))
    want = np.asarray(rs_pallas.apply_gf_matrix(
        coefs, jnp.asarray(_padded(x, 4 * 32 * 1 * 128)), interpret=True,
        rb=1))[..., :s]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which,s", [("parity", 4096 - 77),
                                     ("decode", 2 * 4096)])
def test_swar_plain_matches_pallas_interpret(which, s):
    coefs = _coef_sets()[which]
    x = np.random.default_rng(s).integers(0, 256, (2, 10, s), np.uint8)
    got = rs_cuda.apply_gf_matrix_swar_ref(coefs, torch.from_numpy(x))
    want = np.asarray(rs_pallas.apply_gf_matrix_swar(
        coefs, jnp.asarray(_padded(x, 4 * 8 * 128)), interpret=True,
        rows_per_block=8))[..., :s]
    np.testing.assert_array_equal(got.numpy(), want)


def _transpose8(w):
    """gf_transpose.cu ``transpose8`` over 8 uint32 arrays: three
    swap-move rounds, an 8x8 bit transpose in each byte lane."""
    w = list(w)
    for s, m, pairs in ((1, 0x55555555, ((0, 1), (2, 3), (4, 5), (6, 7))),
                        (2, 0x33333333, ((0, 2), (1, 3), (4, 6), (5, 7))),
                        (4, 0x0F0F0F0F, ((0, 4), (1, 5), (2, 6), (3, 7)))):
        m, s = np.uint32(m), np.uint32(s)
        for lo, hi in pairs:
            w[lo], w[hi] = ((w[lo] & m) | ((w[hi] << s) & ~m),
                            ((w[lo] >> s) & m) | (w[hi] & ~m))
    return w


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 4), (4, 12)])
def test_kernel_tables_encode_the_map(k, m):
    """The tables the CUDA kernels read, expanded and evaluated with each
    kernel's own formula in numpy: (4, 12) takes two launches of MAXO=8
    outputs."""
    coefs = ReferenceEncoder(k, m).matrix[k:]
    x = np.random.default_rng(k + m).integers(0, 256, (2, k, 64), np.uint8)
    want = _oracle(coefs, x)
    # SWAR: words c[o,d] * 2^j, y_o = XOR_{d, j pairs}
    # ((x_d >> j) & 0x01010101) * c_j ^ ((x_d >> j+1) & 0x01010101) * c_j+1
    lo = np.uint32(0x01010101)
    col = rs_cuda.swar_table(coefs).astype(np.uint32)
    w = x.view(np.uint32)
    y = np.zeros((2, m, w.shape[2]), np.uint32)
    for o in range(m):
        for d in range(k):
            for j in range(0, 8, 2):
                y[:, o] ^= (((w[:, d] >> np.uint32(j)) & lo) * col[o, d, j]
                            ^ ((w[:, d] >> np.uint32(j + 1)) & lo)
                            * col[o, d, j + 1])
    np.testing.assert_array_equal(y.view(np.uint8), want)
    # transpose: row byte [o, d, i] bit j == bit (8o+i, 8d+j) of the
    # expanded matrix; each 32-byte position is 8 words, transposed to 8
    # bit planes; entry e of table h is the XOR of planes 4h + j for the
    # bits j of e; acc[o][i] ^= table0[row & 15] ^ table1[row >> 4]; and
    # the accumulators are transposed back
    rows = rs_cuda.transpose_table(coefs)
    words = x.view(np.uint32).reshape(2, k, 2, 8)      # (B, d, pos, word)
    out = np.zeros((2, m, 2, 8), np.uint32)
    for o in range(m):
        acc = [np.zeros((2, 2), np.uint32) for _ in range(8)]
        for d in range(k):
            planes = _transpose8([words[:, d, :, r] for r in range(8)])
            tables = [[np.bitwise_xor.reduce(
                [np.zeros((2, 2), np.uint32)]
                + [planes[4 * h + j] for j in range(4) if e >> j & 1])
                for e in range(16)] for h in range(2)]
            for i in range(8):
                row = int(rows[o, d, i])
                acc[i] ^= tables[0][row & 15] ^ tables[1][row >> 4]
        out[:, o] = np.stack(_transpose8(acc), axis=-1)
    np.testing.assert_array_equal(out.view(np.uint8).reshape(want.shape),
                                  want)


def test_launch_table_limit_matches_the_kernels():
    """The table a launch carries in its parameter block: the wrapper's
    TABLE_BYTES and MAXO are the kernels' (csrc/gf_common.cuh), and wide
    codes take fewer outputs per launch."""
    header = (Path(rs_cuda.__file__).parent / "csrc"
              / "gf_common.cuh").read_text()
    assert f"TABLE_BYTES = {rs_cuda.TABLE_BYTES};" in header
    assert f"MAXO = {rs_cuda.MAXO};" in header
    assert [rs_cuda.outputs_per_launch(n) for n in (4, 10, 63, 64, 70, 255)] \
        == [8, 8, 8, 7, 7, 1]
    with pytest.raises(ValueError, match="at most 504"):
        rs_cuda.outputs_per_launch(505)


def test_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    coefs = _coef_sets()["parity"]
    x = np.random.default_rng(5).integers(0, 256, (1, 10, 1000), np.uint8)
    before = (rs_cuda.apply_gf_matrix_transpose.launches,
              rs_cuda.apply_gf_matrix_swar.launches)
    want = _oracle(coefs, x)
    # also a contiguous view 3 bytes into its storage (no int32 view)
    odd = torch.from_numpy(np.concatenate([np.zeros(3, np.uint8),
                                           x.ravel()]))[3:].view(x.shape)
    for kernel in ("transpose", "swar"):
        monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", kernel)
        for t in (torch.from_numpy(x), odd):
            got = rs_cuda.apply_gf_matrix(coefs, t)
            np.testing.assert_array_equal(got.numpy(), want)
    assert (rs_cuda.apply_gf_matrix_transpose.launches,
            rs_cuda.apply_gf_matrix_swar.launches) == before
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", "bogus")
    with pytest.raises(ValueError, match="SEAWEEDFS_TORCH_KERNEL"):
        rs_cuda.apply_gf_matrix(coefs, torch.from_numpy(x))
    with pytest.raises(ValueError):
        rs_cuda.apply_gf_matrix_swar(coefs, x)   # numpy, not a tensor


# ---------------------------------------------------------------------------
# Encoder surface against rs_jax.Encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 4)])
def test_code_matrix_matches_jax(k, m):
    enc = rs_torch.Encoder(k, m, device="cpu")
    np.testing.assert_array_equal(enc.matrix, rs_jax.Encoder(k, m).matrix)
    np.testing.assert_array_equal(enc.parity_coefs,
                                  rs_jax.Encoder(k, m).parity_coefs)


@pytest.mark.parametrize("present,wanted", [
    (PRESENT, list(LOST)),
    (list(range(4, 14)), [0, 1, 2, 3]),
    ([0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13], [9, 10, 11]),
])
def test_decode_matrix_rows_match_jax(present, wanted):
    enc = rs_torch.Encoder(10, 4, device="cpu")
    want = rs_jax.Encoder(10, 4).decode_matrix_rows(present, wanted)
    np.testing.assert_array_equal(enc.decode_matrix_rows(present, wanted),
                                  want)
    # served from the survivor-set cache the second time
    assert tuple(present[:10]) in enc._decode_cache
    np.testing.assert_array_equal(enc.decode_matrix_rows(present, wanted),
                                  want)


def test_host_paths_match_jax():
    rng = np.random.default_rng(9)
    jenc = rs_jax.Encoder(10, 4)
    enc = rs_torch.Encoder.from_matrix(jenc.matrix, device="cpu")
    batches = [rng.integers(0, 256, (2, 10, s), np.uint8)
               for s in (1024, 1000, 1024)]
    want = [np.asarray(jenc.encode_parity(b)) for b in batches]
    np.testing.assert_array_equal(np.asarray(enc.encode_parity_host(
        batches[1])), want[1])
    for got, w in zip(enc.encode_parity_host_multi(batches), want):
        np.testing.assert_array_equal(np.asarray(got), w)
    np.testing.assert_array_equal(enc.encode_parity(batches[0]).numpy(),
                                  want[0])
    full = np.concatenate([batches[0], want[0]], axis=1)
    surv = np.ascontiguousarray(full[:, PRESENT])
    rebuilt = full[:, list(LOST)]
    np.testing.assert_array_equal(
        np.asarray(enc.reconstruct_batch_host(surv, PRESENT)), rebuilt)
    np.testing.assert_array_equal(
        np.asarray(jenc.reconstruct_batch_host(surv, PRESENT)), rebuilt)
    for got in enc.reconstruct_batch_host_multi([surv, surv], PRESENT):
        np.testing.assert_array_equal(np.asarray(got), rebuilt)
    np.testing.assert_array_equal(
        enc.reconstruct_batch(surv, PRESENT, [2, 13]).numpy(),
        full[:, [2, 13]])
    assert enc.verify_batch(full)
    np.testing.assert_array_equal(enc.encode_batch(batches[0]).numpy(), full)


def test_klauspost_list_api_matches_jax():
    payload = np.random.default_rng(3).integers(0, 256, 5000,
                                                np.uint8).tobytes()
    enc = rs_torch.Encoder(10, 4, device="cpu")
    jenc = rs_jax.Encoder(10, 4)
    shards = enc.split(payload)
    jshards = jenc.split(payload)
    for a, b in zip(shards, jshards):
        np.testing.assert_array_equal(a, b)
    enc.encode(shards)
    jenc.encode(jshards)
    for a, b in zip(shards, jshards):
        np.testing.assert_array_equal(a, b)
    assert enc.verify(shards)
    bad = [s.copy() for s in shards]
    bad[12][7] ^= 1
    assert not enc.verify(bad)
    lost = list(shards)
    for i in LOST:
        lost[i] = None
    enc.reconstruct(lost)
    for a, b in zip(lost, shards):
        np.testing.assert_array_equal(a, b)
    data_only = list(shards)
    data_only[3] = data_only[11] = None
    enc.reconstruct_data(data_only)
    np.testing.assert_array_equal(data_only[3], shards[3])
    assert data_only[11] is None
    assert enc.join(shards, len(payload)) == payload
    assert jenc.join(jshards, len(payload)) == payload


def test_from_matrix_and_errors():
    m = rs_jax.Encoder(6, 3).matrix
    enc = rs_torch.Encoder.from_matrix(m, device="cpu")
    assert (enc.data_shards, enc.parity_shards) == (6, 3)
    np.testing.assert_array_equal(enc.matrix, m)
    with pytest.raises(ValueError, match="systematic"):
        rs_torch.Encoder.from_matrix(m[::-1], device="cpu")
    with pytest.raises(rs_torch.TooFewShardsError):
        enc.decode_matrix_rows([0, 1, 2], [3])
    with pytest.raises(rs_torch.ShardSizeError):
        enc.encode([np.zeros(4, np.uint8)] * 8)
