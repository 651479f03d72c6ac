"""Striping transforms: logical .dat bytes <-> per-shard file bytes.

A copy of seaweedfs_tpu/pipeline/stripe.py (plain numpy) over the port's
EcScheme, whose copies into fresh memory are recorded as the reader's
``pack`` stage (:func:`pack`).

The data-movement half of ec_encoder.go/ec_decoder.go (SURVEY.md §3.1):
row-major striping over k shards in large-then-small blocks. Expressed as
numpy reshape/transpose so the host never touches bytes one at a time; the
row-batched view these produce is exactly the (B, k, S) tensor the device
codec consumes, so striping IS the batching.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np

from . import flight
from .scheme import EcScheme


def pack(stats, nbytes: int, copy: Callable[[], np.ndarray]) -> np.ndarray:
    """``copy()``, a copy of ``nbytes`` into fresh memory on the pipeline's
    reader, as a ``pack`` flight span; its seconds and bytes go to
    ``stats`` (a ``pipe.PipeStats``) when one is given."""
    flight.record(flight.EV_PACK_START)
    t0 = time.perf_counter()
    out = copy()
    if stats is not None:
        stats.pack_seconds += time.perf_counter() - t0
        stats.pack_bytes += nbytes
    flight.record(flight.EV_PACK_END, arg=nbytes)
    return out


def _pad_to(buf: np.ndarray, size: int, stats=None) -> np.ndarray:
    if buf.size == size:
        return buf

    def copy():
        out = np.zeros(size, dtype=np.uint8)
        out[:buf.size] = buf
        return out

    return pack(stats, buf.nbytes, copy)


def stripe_rows(dat: np.ndarray, scheme: EcScheme, stats=None
                ) -> Iterator[tuple[np.ndarray, bool]]:
    """Yield (rows, is_large) batches: rows has shape (R, k, block) and
    covers the .dat in layout order — large rows first (possibly zero of
    them), then the zero-padded small rows. The pad copy of the small
    rows counts in ``stats`` (:func:`pack`)."""
    k = scheme.data_shards
    large, small = scheme.large_block_size, scheme.small_block_size
    dat = np.asarray(dat, dtype=np.uint8).ravel()
    rows = scheme.large_rows_count(dat.size)
    large_region = rows * large * k
    if rows:
        yield (dat[:large_region].reshape(rows, k, large), True)
    tail = dat[large_region:]
    if tail.size:
        small_rows = -(-tail.size // (small * k))
        tail = _pad_to(tail, small_rows * small * k, stats)
        yield (tail.reshape(small_rows, k, small), False)


def stripe(dat: np.ndarray, scheme: EcScheme) -> list[np.ndarray]:
    """Full data-shard file contents for a .dat: k arrays of equal size
    (the inverse of unstripe)."""
    k = scheme.data_shards
    pieces: list[list[np.ndarray]] = [[] for _ in range(k)]
    for rows, _ in stripe_rows(dat, scheme):
        # (R, k, block) -> per shard concat over R.
        per_shard = np.ascontiguousarray(rows.transpose(1, 0, 2))
        for s in range(k):
            pieces[s].append(per_shard[s].reshape(-1))
    if not pieces[0]:
        return [np.zeros(0, dtype=np.uint8) for _ in range(k)]
    return [np.concatenate(p) for p in pieces]


def unstripe(shards: list[np.ndarray], dat_size: int,
             scheme: EcScheme) -> np.ndarray:
    """Inverse: k data-shard files -> logical .dat bytes, truncated to
    ``dat_size`` (ec_decoder.go WriteDatFile)."""
    k = scheme.data_shards
    large, small = scheme.large_block_size, scheme.small_block_size
    if len(shards) != k:
        raise ValueError(f"need {k} data shards, got {len(shards)}")
    shards = [np.asarray(s, dtype=np.uint8).ravel() for s in shards]
    sizes = {s.size for s in shards}
    if len(sizes) != 1:
        raise ValueError("data shards have inconsistent sizes")
    expect = scheme.shard_file_size(dat_size)
    if shards[0].size != expect:
        raise ValueError(
            f"shard file size {shards[0].size} != expected {expect} "
            f"for dat size {dat_size}")
    rows = scheme.large_rows_count(dat_size)
    out_parts = []
    if rows:
        lg = np.stack([s[:rows * large] for s in shards])  # (k, rows*large)
        out_parts.append(
            lg.reshape(k, rows, large).transpose(1, 0, 2).reshape(-1))
    tails = np.stack([s[rows * large:] for s in shards])  # (k, small_rows*S)
    if tails.shape[1]:
        small_rows = tails.shape[1] // small
        out_parts.append(
            tails.reshape(k, small_rows, small).transpose(1, 0, 2)
            .reshape(-1))
    full = np.concatenate(out_parts) if out_parts else \
        np.zeros(0, dtype=np.uint8)
    if full.size < dat_size:
        raise ValueError("shards do not cover the requested dat size")
    return full[:dat_size]


def iter_row_batches(rows: np.ndarray, max_batch_bytes: int
                     ) -> Iterator[np.ndarray]:
    """Split a (R, k, block) row tensor into batches bounded by
    ``max_batch_bytes`` of input data.

    Whole rows are batched together when they fit. When ONE row exceeds
    the bound (e.g. a 10 GiB large row vs a 256 MiB bound), the row is
    split along the block axis instead — safe because the codec is
    position-wise — and emitted as single-row column chunks, whose
    append-order concatenation still reconstructs each shard block in
    order. Column chunks are 128-byte aligned to match the device packing
    group, except possibly the last.
    """
    r_total, k, block = rows.shape
    per_row = k * block
    if per_row <= max_batch_bytes:
        rows_per_batch = max(1, max_batch_bytes // per_row)
        for start in range(0, r_total, rows_per_batch):
            yield rows[start:start + rows_per_batch]
        return
    cols = max(128, (max_batch_bytes // k) // 128 * 128)
    for r in range(r_total):
        for c in range(0, block, cols):
            yield rows[r:r + 1, :, c:c + cols]
