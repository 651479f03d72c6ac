"""Multi-volume coalescing batcher: many small volumes, one device batch.

The port of ``seaweedfs_tpu/pipeline/batch.py``. BASELINE.json config 3
is the cold-tier workload: about 1000 volumes of 30 MB sealed in one job.
Encoding each volume alone would run thousands of tiny device calls (a
30 MB volume stripes to just 3 small rows); the batcher coalesces rows
from MANY volumes into shared ``(B, k, block)`` batches, bucketing by
row shape (k, block size) so every launch is full width. Rows larger
than the batch bound are column-split first (the codec is position-wise),
so one oversized large row can never breach the batch bound.

Scatter-back is OFFSET-ADDRESSED: every packed span records the exact
shard-file byte offset its blocks occupy (the striping layout is
deterministic), so per-shape buckets can flush in any order — mixed
large/small-row volumes still coalesce across volumes without corrupting
per-volume shard layout.

Every batch is packed into a fresh array (one that holds a single span
may be a view of its source), so the data-shard views the sinks receive
stay valid for as long as a sink holds them. The batches ride the
overlapped plane of pipe.py; on one card, runs of same-shaped batches
share one launch (grouped dispatch, ``pipe.pick_grouped_dispatch``), and
when ``parallel/mesh.routing_mesh`` says to split, each batch takes one
launch per mesh cell (:func:`_pick_encode_fn`). The batch bound is
``[pipeline] batch_bytes``, ``grouped_batch_bytes`` while grouping is
on, and a completed run is published to the ring of recent runs as
``ec.batch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from ..ops.rs_torch import Encoder
from ..parallel import mesh as mesh_mod
from ..storage import ec_files, volume as volume_mod
from . import pipe, writeback
from .scheme import DEFAULT_SCHEME, EcScheme
from .stripe import iter_row_batches, pack, stripe_rows

def max_rows_per_batch(k: int, block: int, max_batch_bytes: int) -> int:
    """Row cap at which a (k, block)-shaped bucket flushes — THE flush
    rule; a batch census classifies full vs tail batches with it."""
    return max(1, max_batch_bytes // max(k * block, 1))


@dataclass(frozen=True)
class RowSpan:
    """``rows[r0:r0+n]`` of a packed batch hold volume ``key``'s shard
    bytes ``[offset, offset + n*block)`` (per shard file)."""
    key: object
    r0: int
    n: int
    offset: int


def _iter_volume_rows(sources: Iterable[tuple[object, np.ndarray]],
                      scheme: EcScheme, max_batch_bytes: int, stats=None
                      ) -> Iterator[tuple[object, np.ndarray]]:
    """(key, dat bytes) -> (key, (R, k, block) row tensors) in layout
    order. A volume may yield several tensors (large rows, small rows,
    and column chunks when one row alone exceeds the batch bound)."""
    for key, dat in sources:
        for rows, _is_large in stripe_rows(dat, scheme, stats):
            if rows.shape[1] * rows.shape[2] > max_batch_bytes:
                # One row is bigger than a whole batch: column-split it
                # (iter_row_batches emits (1, k, cols) chunks in order).
                for chunk in iter_row_batches(rows, max_batch_bytes):
                    yield key, chunk
            else:
                yield key, rows


class _Bucket:
    __slots__ = ("pend", "rows")

    def __init__(self):
        self.pend: list[tuple[object, int, np.ndarray]] = []
        self.rows = 0

    def flush(self, stats=None) -> Optional[tuple[list[RowSpan], np.ndarray]]:
        """The pending rows as one batch: a single contiguous span is
        handed on as it is, anything else is copied into a fresh array
        (a ``pack`` span, counted in ``stats``)."""
        if not self.pend:
            return None
        spans, r0 = [], 0
        for key, offset, rows in self.pend:
            spans.append(RowSpan(key, r0, rows.shape[0], offset))
            r0 += rows.shape[0]
        parts = [r for _, _, r in self.pend]
        self.pend, self.rows = [], 0
        if len(parts) == 1 and parts[0].flags.c_contiguous:
            return spans, parts[0]
        packed = pack(
            stats, sum(p.nbytes for p in parts),
            lambda: np.concatenate(parts, axis=0) if len(parts) > 1
            else np.ascontiguousarray(parts[0]))
        return spans, packed


def iter_packed_batches(sources: Iterable[tuple[object, np.ndarray]],
                        scheme: EcScheme = DEFAULT_SCHEME,
                        max_batch_bytes: Optional[int] = None,
                        stats: Optional[pipe.PipeStats] = None
                        ) -> Iterator[tuple[list[RowSpan], np.ndarray]]:
    """Pack per-volume row tensors into shared (B, k, block) batches of
    at most ``max_batch_bytes`` (default ``[pipeline] batch_bytes``).

    Rows are grouped into per-shape buckets (so volumes that mix large
    and small rows still coalesce with their neighbours); a bucket
    flushes when it reaches the batch bound, and every span carries its
    shard-file offset so results scatter back position-addressed. The
    copies into fresh memory (packing, the pad of a volume's last small
    rows) count in ``stats``' ``pack_seconds`` and ``pack_bytes``."""
    if max_batch_bytes is None:
        max_batch_bytes = pipe.current().batch_bytes
    buckets: dict[tuple[int, int], _Bucket] = {}
    cursor: dict[object, int] = {}
    for key, rows in _iter_volume_rows(sources, scheme, max_batch_bytes,
                                       stats):
        shape = (rows.shape[1], rows.shape[2])
        block = shape[1]
        max_rows = max_rows_per_batch(shape[0], block, max_batch_bytes)
        b = buckets.setdefault(shape, _Bucket())
        r = 0
        while r < rows.shape[0]:
            take = min(rows.shape[0] - r, max_rows - b.rows)
            off = cursor.get(key, 0)
            b.pend.append((key, off, rows[r:r + take]))
            cursor[key] = off + take * block
            b.rows += take
            r += take
            if b.rows >= max_rows:
                out = b.flush(stats)
                if out:
                    yield out
    for b in buckets.values():
        out = b.flush(stats)
        if out:
            yield out


def _pick_encode_fn(encoder: Encoder):
    """The compute stage: when routing_mesh() says to split — more than
    one card, or an explicit -mesh (CPU device lists included) — the
    coalesced batches split dp/sp over the mesh
    (parallel/mesh.encode_parity_host_sharded); otherwise the
    single-device host path."""
    m = mesh_mod.routing_mesh(encoder.device)
    if m is not None:
        return lambda batch: mesh_mod.encode_parity_host_sharded(
            encoder, batch, mesh=m)
    return encoder.encode_parity_host


def encode_packed(sources: Iterable[tuple[object, np.ndarray]],
                  sink: Callable[[object, int, int, np.ndarray], None],
                  scheme: EcScheme = DEFAULT_SCHEME,
                  max_batch_bytes: Optional[int] = None,
                  device=None,
                  stats: Optional[pipe.PipeStats] = None) -> int:
    """Coalesced encode over many volumes with the 3-stage pipeline, on
    ``device`` (None = the card; raises when there is none), in batches
    of at most ``max_batch_bytes`` (default ``[pipeline]
    batch_bytes``; clamped to ``grouped_batch_bytes`` while grouped
    dispatch is on).

    ``sink(key, shard_id, offset, blocks)`` receives each span's bytes
    addressed by shard-file offset (spans of one (key, shard) are
    disjoint and cover the file), on the pipeline's writer thread.
    ``blocks`` may be a strided (n, block) VIEW whose rows are
    contiguous — sinks either write row-wise (zero-copy) or flatten.
    Data shards come straight from the host batch, parity from the
    codec. ``stats`` receives the run's stage breakdown. Returns total
    input bytes."""
    encoder = scheme.encoder(device)
    k = scheme.data_shards
    if max_batch_bytes is None:
        max_batch_bytes = pipe.current().batch_bytes
    # grouped dispatch on one card (one shared policy,
    # pipe.pick_grouped_dispatch): runs of same-shaped packed batches
    # share one launch (the buckets emit equal shapes until the tail, so
    # the steady state groups fully); a split mesh keeps one product per
    # batch through _pick_encode_fn
    multi, group, max_batch_bytes = pipe.pick_grouped_dispatch(
        encoder.encode_parity_host_multi, max_batch_bytes,
        device=encoder.device)
    st = stats if stats is not None else pipe.PipeStats()
    total = 0

    def batches():
        nonlocal total
        for spans, packed in iter_packed_batches(sources, scheme,
                                                 max_batch_bytes, st):
            total += packed.size
            yield spans, packed

    def write(spans, batch, parity):
        # Views, not gather copies: each span row is already contiguous.
        # Sinks that need flat bytes copy on demand; the file sink
        # writes row-wise with no copy at all.
        for sp in spans:
            for s in range(k):
                sink(sp.key, s, sp.offset, batch[sp.r0:sp.r0 + sp.n, s])
            for j in range(parity.shape[1]):
                sink(sp.key, k + j, sp.offset,
                     parity[sp.r0:sp.r0 + sp.n, j])

    pipe.run_pipeline(batches(), _pick_encode_fn(encoder), write,
                      stats=st, kind="ec.batch", encode_multi_fn=multi,
                      group=group)
    return total


def encode_many(payloads: Sequence[np.ndarray],
                scheme: EcScheme = DEFAULT_SCHEME,
                max_batch_bytes: Optional[int] = None,
                keep_output: bool = False,
                device=None,
                stats: Optional[pipe.PipeStats] = None):
    """In-memory coalesced encode of many volume payloads on ``device``.

    Returns (total_input_bytes, shards) where shards[i][s] is volume
    i's shard-s bytes when ``keep_output`` — or None otherwise (the
    benchmark path: parity still crosses back from the card and is
    materialized, so the measured time includes the full data path)."""
    pieces: Optional[dict] = {} if keep_output else None

    def sink(key, shard_id, offset, blocks):
        if pieces is not None:
            # keep_output must own the bytes: copy the (possibly
            # strided) span view into a flat array
            pieces.setdefault((key, shard_id), []).append(
                (offset, np.ascontiguousarray(blocks).reshape(-1)))

    sources = ((i, np.asarray(p, dtype=np.uint8).ravel())
               for i, p in enumerate(payloads))
    total = encode_packed(sources, sink, scheme, max_batch_bytes,
                          device=device, stats=stats)
    if pieces is None:
        return total, None
    out = []
    for i in range(len(payloads)):
        vol = []
        for s in range(scheme.total_shards):
            parts = sorted(pieces.get((i, s), []), key=lambda t: t[0])
            vol.append(np.concatenate([p for _, p in parts])
                       if parts else np.zeros(0, dtype=np.uint8))
        out.append(vol)
    return total, out


def encode_volumes(bases: Sequence[str | Path],
                   scheme: EcScheme = DEFAULT_SCHEME,
                   max_batch_bytes: Optional[int] = None,
                   device=None,
                   stats: Optional[pipe.PipeStats] = None) -> int:
    """Seal many volumes' .dat files into shard files via coalesced
    batches on ``device`` (the file-level config-3 path of ``ec.encode``
    over a collection). Writes <base>.ec00.. for every base; the caller
    writes .ecx / .vif per volume as in single-volume encode. Returns
    total .dat bytes encoded."""
    bases = [str(b) for b in bases]
    shard_sizes: dict[str, int] = {}
    # spans address disjoint shard-file byte ranges, so writes go to
    # the positioned-write pool (preallocated files, pwritev) and
    # retire while the next batch packs and computes. The span views
    # keep their batch (or source mapping) alive until their write lands.
    writer = writeback.WriterPool()

    def sources():
        for b in bases:
            datp = volume_mod.dat_path(b)
            size = datp.stat().st_size
            shard_sizes[b] = scheme.shard_file_size(size)
            # copy-on-write mapping: a batch that views it is writable
            # for torch.from_numpy, and no write could reach the .dat
            dat = np.memmap(datp, dtype=np.uint8, mode="c") \
                if size else np.zeros(0, dtype=np.uint8)
            yield b, dat

    def sink(base, shard_id, offset, blocks):
        path = str(ec_files.shard_path(base, shard_id))
        writer.open_file(path, shard_sizes[base])
        if blocks.ndim > 1 and \
                blocks.shape[-1] >= pipe.ROW_WRITE_MIN_BLOCK:
            # (n, block) span view: rows are contiguous even when the
            # span itself is strided — queue them without a gather copy
            writer.submit(path, offset,
                          [blocks[r] for r in range(blocks.shape[0])])
        else:
            writer.submit(path, offset,
                          [np.ascontiguousarray(blocks).reshape(-1)])

    try:
        total = encode_packed(sources(), sink, scheme, max_batch_bytes,
                              device=device, stats=stats)
        writer.close()
        writer = None
        return total
    finally:
        if writer is not None:
            writer.abort()
