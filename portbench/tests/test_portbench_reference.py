"""The plain reference: known RS(10,4) vectors, its own decode, and the
layout against the port's interval map."""

import itertools

import numpy as np
import pytest

from portbench import reference

#: klauspost/reedsolomon buildMatrix(10, 14): the parity rows SeaweedFS's
#: ec_encoder.go writes with (GF(2^8), 0x11D).
RS_10_4_PARITY = [
    [129, 150, 175, 184, 210, 196, 254, 232, 3, 2],
    [150, 129, 184, 175, 196, 210, 232, 254, 2, 3],
    [191, 214, 98, 10, 6, 111, 223, 183, 5, 4],
    [214, 191, 10, 98, 111, 6, 183, 223, 4, 5],
]


def test_field_known_products():
    mt = reference.mul_table()
    assert mt[2, 0x80] == 0x1D          # x * x^7 = x^8 = 0x11D - 0x100
    assert mt[0x53, 0xCA] == 143
    for a in range(1, 256):
        assert mt[a, reference.gf_inv(a)] == 1


def test_code_matrix_is_klauspost_rs_10_4():
    m = reference.code_matrix(10, 14)
    assert np.array_equal(m[:10], np.eye(10, dtype=np.uint8))
    assert m[10:].tolist() == RS_10_4_PARITY


def test_a_known_stripe_encodes_to_its_parity():
    data = np.arange(1, 11, dtype=np.uint8).reshape(10, 1)
    parity = reference.apply(reference.code_matrix(10, 14)[10:], data)
    assert parity[:, 0].tolist() == [69, 242, 18, 118]
    unit = np.zeros((10, 10), dtype=np.uint8)
    unit[np.arange(10), np.arange(10)] = 1
    assert np.array_equal(reference.apply(np.array(RS_10_4_PARITY,
                                                   dtype=np.uint8), unit),
                          np.array(RS_10_4_PARITY, dtype=np.uint8))


@pytest.mark.parametrize("lost", [(0, 5, 11, 13)] + list(itertools.islice(
    itertools.combinations(range(14), 4), 0, 1001, 97)))
def test_any_ten_shards_decode_the_rest(lost):
    m = reference.code_matrix(10, 14)
    data = np.random.default_rng(1).integers(0, 256, (10, 64),
                                             dtype=np.uint8)
    shards = np.concatenate([data, reference.apply(m[10:], data)])
    present = [i for i in range(14) if i not in lost]
    rows = reference.decode_rows(m, present, lost)
    got = reference.apply(rows, shards[present[:10]])
    assert np.array_equal(got, shards[list(lost)])


def test_cauchy_control_is_a_code_but_not_seaweedfs_shards():
    c = reference.cauchy_matrix(10, 14)
    data = np.random.default_rng(2).integers(0, 256, (10, 32),
                                             dtype=np.uint8)
    shards = np.concatenate([data, reference.apply(c[10:], data)])
    present = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    rows = reference.decode_rows(c, present, [0, 5])
    assert np.array_equal(reference.apply(rows, shards[present]),
                          data[[0, 5]])
    assert not np.array_equal(c[10:], reference.code_matrix(10, 14)[10:])


@pytest.mark.parametrize("dat_size", [1, 31457280, 1073741824,
                                      1073741824 + 12345, 10 * 2 ** 30 + 3])
def test_layout_and_locate_match_the_port(dat_size):
    from seaweedfs_tpu_torch.storage import ec_locate
    lay = reference.Layout(10, 2 ** 30, 2 ** 20, dat_size)
    assert lay.shard_size == ec_locate.shard_file_size(dat_size)
    assert lay.large_rows == ec_locate.large_rows_count(dat_size)
    rng = np.random.default_rng(dat_size)
    for _ in range(50):
        off = int(rng.integers(0, dat_size))
        size = int(rng.integers(0, min(dat_size - off, 5 * 2 ** 20) + 1))
        want = [(iv.shard_id, iv.inner_block_offset, iv.size)
                for iv in ec_locate.locate_data(off, size, dat_size)]
        assert lay.locate(off, size) == want


def test_row_data_is_the_zero_padded_stripe():
    dat = np.arange(25, dtype=np.uint8)
    lay = reference.Layout(2, 40, 4, dat.size)
    assert lay.rows == 4 and lay.padded(3) and not lay.padded(2)
    assert lay.data(dat, 3).tolist() == [[24, 0, 0, 0], [0, 0, 0, 0]]
    assert lay.row_of(lay.row_start(3)) == 3
