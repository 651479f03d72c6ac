"""The plain reference the benchmark judges the port against.

Plain NumPy, written apart from the program under test and importing
nothing of it: GF(2^8) over the polynomial 0x11D with generator 2; the
code matrix of klauspost/reedsolomon's ``buildMatrix`` (a Vandermonde
matrix made systematic), which SeaweedFS's ``ec_encoder.go`` uses; the
striping of ``ec_encoder.go`` (large rows while more than one whole large
row remains, then zero-padded small rows); and the interval map of
``ec_locate.go``. The control's code matrix, klauspost's Cauchy
construction (``WithCauchyMatrix``), is here too: it is as good a code,
but its shards are not the ones SeaweedFS writes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

POLY = 0x11D


@functools.lru_cache(maxsize=None)
def _exp_log() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return exp, log


@functools.lru_cache(maxsize=None)
def mul_table() -> np.ndarray:
    """MUL[a, b] = a * b in GF(2^8), 256 x 256 uint8."""
    exp, log = _exp_log()
    table = exp[(log[:, None] + log[None, :])].astype(np.uint8)
    table[0, :] = 0
    table[:, 0] = 0
    table.setflags(write=False)
    return table


def gf_inv(a: int) -> int:
    exp, log = _exp_log()
    if a == 0:
        raise ZeroDivisionError("no inverse of 0 in GF(2^8)")
    return int(exp[(255 - log[a]) % 255])


def gf_pow(a: int, n: int) -> int:
    """a ** n with klauspost's ``galExp`` edge cases (0 ** 0 == 1)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    exp, log = _exp_log()
    return int(exp[(log[a] * n) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(r, n) @ (n, c) over GF(2^8)."""
    mt = mul_table()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[1]):
        out ^= mt[a[:, i][:, None], b[i][None, :]]
    return out


def gf_invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8); raises on a singular matrix."""
    n = m.shape[0]
    mt = mul_table()
    work = np.concatenate([np.array(m, dtype=np.uint8),
                           np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        nz = np.nonzero(work[col:, col])[0]
        if not nz.size:
            raise ValueError("singular matrix over GF(2^8)")
        p = col + int(nz[0])
        work[[col, p]] = work[[p, col]]
        work[col] = mt[gf_inv(int(work[col, col]))][work[col]]
        for r in range(n):
            if r != col and work[r, col]:
                work[r] ^= mt[int(work[r, col])][work[col]]
    return work[:, n:].copy()


@functools.lru_cache(maxsize=None)
def code_matrix(k: int, total: int) -> np.ndarray:
    """klauspost ``buildMatrix``: the (total, k) Vandermonde matrix
    v[r, c] = r ** c times the inverse of its top k rows."""
    vm = np.array([[gf_pow(r, c) for c in range(k)] for r in range(total)],
                  dtype=np.uint8)
    out = gf_matmul(vm, gf_invert(vm[:k]))
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def cauchy_matrix(k: int, total: int) -> np.ndarray:
    """klauspost ``buildMatrixCauchy``: the identity, then rows
    1 / (r ^ c) for r in k..total-1. The control's code."""
    out = np.zeros((total, k), dtype=np.uint8)
    out[:k] = np.eye(k, dtype=np.uint8)
    for r in range(k, total):
        for c in range(k):
            out[r, c] = gf_inv(r ^ c)
    out.setflags(write=False)
    return out


def apply(coefs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y[o] = XOR_d coefs[o, d] * x[d]: (n_out, n_in) over (n_in, S)."""
    mt = mul_table()
    y = np.zeros((coefs.shape[0], x.shape[-1]), dtype=np.uint8)
    for o in range(coefs.shape[0]):
        for d in range(coefs.shape[1]):
            c = int(coefs[o, d])
            if c == 1:
                y[o] ^= x[d]
            elif c:
                y[o] ^= mt[c][x[d]]
    return y


def decode_rows(matrix: np.ndarray, present, wanted) -> np.ndarray:
    """Rows that rebuild shards ``wanted`` from the first k shards of
    ``present`` under the code ``matrix``."""
    k = matrix.shape[1]
    chosen = list(present)[:k]
    inv = gf_invert(matrix[chosen])
    return np.stack([gf_matmul(matrix[w][None, :], inv)[0] for w in wanted])


@dataclass(frozen=True)
class Layout:
    """The shard layout of one .dat of ``dat_size`` bytes."""

    k: int
    large: int
    small: int
    dat_size: int

    @property
    def large_rows(self) -> int:
        rows, remaining = 0, self.dat_size
        while remaining > self.large * self.k:
            rows += 1
            remaining -= self.large * self.k
        return rows

    @property
    def small_rows(self) -> int:
        rest = self.dat_size - self.large_rows * self.large * self.k
        return -(-rest // (self.small * self.k))

    @property
    def rows(self) -> int:
        return self.large_rows + self.small_rows

    @property
    def shard_size(self) -> int:
        return self.large_rows * self.large + self.small_rows * self.small

    def block(self, row: int) -> int:
        return self.large if row < self.large_rows else self.small

    def row_start(self, row: int) -> int:
        """The row's first byte in each shard file."""
        if row < self.large_rows:
            return row * self.large
        return self.large_rows * self.large + \
            (row - self.large_rows) * self.small

    def row_of(self, shard_offset: int) -> int:
        region = self.large_rows * self.large
        if shard_offset < region:
            return shard_offset // self.large
        return self.large_rows + (shard_offset - region) // self.small

    def padded(self, row: int) -> bool:
        """Whether the row holds zero padding past the .dat's end."""
        return self.dat_offset(row) + self.k * self.block(row) > \
            self.dat_size

    def dat_offset(self, row: int) -> int:
        if row < self.large_rows:
            return row * self.k * self.large
        return self.large_rows * self.k * self.large + \
            (row - self.large_rows) * self.k * self.small

    def data(self, dat: np.ndarray, row: int) -> np.ndarray:
        """The row's k data blocks, (k, block), zero-padded."""
        block = self.block(row)
        start = self.dat_offset(row)
        out = np.zeros(self.k * block, dtype=np.uint8)
        piece = dat[start:start + self.k * block]
        out[:piece.size] = piece
        return out.reshape(self.k, block)

    def locate(self, offset: int, size: int) -> list[tuple[int, int, int]]:
        """``ec_locate.go`` LocateData: the .dat range as (shard, offset
        in the shard file, size) intervals."""
        region = self.large_rows * self.large * self.k
        out, pos, end = [], offset, offset + size
        while pos < end:
            if pos < region:
                block, rel, base = self.large, pos, 0
            else:
                block, rel = self.small, pos - region
                base = self.large_rows * self.large
            row, in_row = divmod(rel, block * self.k)
            shard, inner = divmod(in_row, block)
            take = min(end - pos, block - inner)
            out.append((shard, base + row * block + inner, take))
            pos += take
        return out
