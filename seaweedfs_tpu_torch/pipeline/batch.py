"""Multi-volume coalescing batcher: many small volumes, one device batch.

The port of ``seaweedfs_tpu/pipeline/batch.py``. BASELINE.json config 3
is the cold-tier workload: about 1000 volumes of 30 MB sealed in one job.
Encoding each volume alone would run thousands of tiny device calls (a
30 MB volume stripes to just 3 small rows); the batcher coalesces rows
from MANY volumes into shared ``(B, k, block)`` batches, bucketing by
row shape (k, block size) so every launch is full width. Rows larger
than the batch bound are column-split first (the codec is position-wise),
so one oversized large row can never breach the batch bound; each of its
column chunks is a batch of its own, handed on before the next row is
packed, so no chunk waits in a bucket for later volumes' rows.

Scatter-back is OFFSET-ADDRESSED: every packed span records the exact
shard-file byte offset its blocks occupy (the striping layout is
deterministic), so per-shape buckets can flush in any order — mixed
large/small-row volumes still coalesce across volumes without corrupting
per-volume shard layout.

:func:`encode_packed` packs every batch into a buffer of a
``pipe.HostBufferPool``, page-locked on the card so the batch's copy to
the card is an asynchronous DMA, and recycles the buffer once the batch's
parity has landed and every write that views it has retired
(``writeback.BatchToken``, :func:`encode_volumes`). The packer copies
each volume byte once, straight from its source: a volume's last small
row is not padded into a copy of the volume first, its pad is zeroed in
the buffer. So the data-shard views a sink receives are valid only until
the sink returns. :func:`iter_packed_batches` without a buffer source
packs into fresh arrays, as before (one that holds a single span may be
a view of its source). The batches ride the
overlapped plane of pipe.py; on one card, runs of same-shaped batches
share one launch (grouped dispatch, ``pipe.pick_grouped_dispatch``), and
when ``parallel/mesh.routing_mesh`` says to split, each batch takes one
launch per mesh cell (:func:`_pick_encode_fn`). The batch bound is
``[pipeline] batch_bytes``, ``grouped_batch_bytes`` while grouping is
on, and a completed run is published to the ring of recent runs as
``ec.batch``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from ..ops.rs_torch import Encoder
from ..parallel import mesh as mesh_mod
from ..storage import ec_files, volume as volume_mod
from . import encode, flight, pipe, writeback
from .scheme import DEFAULT_SCHEME, EcScheme
from .stripe import column_width, iter_row_batches, pack, stripe_rows

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


class _PaddedRow:
    """A volume's last small row where its bytes stop short of the row,
    or columns ``[c, c + width)`` of it: a (1, k, width) part whose
    bytes past ``src`` (the row's valid bytes) are zero. The pooled
    packer copies the valid bytes and zeroes the pad in its buffer, as
    ``encode.py``'s reader does, so the padded row is never made."""

    __slots__ = ("src", "block", "c", "shape")

    def __init__(self, src: np.ndarray, k: int, block: int, c: int = 0,
                 width: Optional[int] = None):
        self.src, self.block, self.c = src, block, c
        self.shape = (1, k, block if width is None else width)

    def __getitem__(self, idx) -> "_PaddedRow":
        # the two slicings rows get: [0:1] (iter_packed_batches takes the
        # row whole) and [0:1, :, c0:c1] (stripe.iter_row_batches)
        rows, cols = (idx, slice(None)) if isinstance(idx, slice) \
            else (idx[0], idx[2])
        if rows.indices(1) != (0, 1, 1):
            raise IndexError("a padded row has one row")
        c0, c1, _ = cols.indices(self.shape[2])
        return _PaddedRow(self.src, self.shape[1], self.block,
                          self.c + c0, c1 - c0)

    def copy_into(self, out: np.ndarray) -> None:
        """Write the part into ``out`` (1, k, width)."""
        width = self.shape[2]
        for s in range(self.shape[1]):
            lo = s * self.block + self.c
            have = min(width, max(0, self.src.size - lo))
            out[0, s, :have] = self.src[lo:lo + have]
            out[0, s, have:] = 0


def _unpadded_rows(dat: np.ndarray, scheme: EcScheme):
    """``stripe.stripe_rows`` without its pad copy: the large rows and
    the whole small rows as views of ``dat``, then the last small row,
    where ``dat`` stops short of it, as a :class:`_PaddedRow`."""
    k = scheme.data_shards
    large, small = scheme.large_block_size, scheme.small_block_size
    dat = np.asarray(dat, dtype=np.uint8).ravel()
    rows = scheme.large_rows_count(dat.size)
    large_region = rows * large * k
    if rows:
        yield dat[:large_region].reshape(rows, k, large)
    tail = dat[large_region:]
    whole = tail.size // (small * k) * small * k
    if whole:
        yield tail[:whole].reshape(-1, k, small)
    if tail.size > whole:
        yield _PaddedRow(tail[whole:], k, small)


def _iter_volume_rows(sources: Iterable[tuple[object, np.ndarray]],
                      scheme: EcScheme, max_batch_bytes: int, stats=None,
                      pooled: bool = False
                      ) -> Iterator[tuple[object, object, bool]]:
    """(key, dat bytes) -> (key, rows, chunk) in layout order: (R, k,
    block) row tensors (``chunk`` False), or, where one row alone exceeds
    the batch bound, that row's (1, k, cols) column chunks (``chunk``
    True; counted in ``stats``' ``split_rows`` / ``split_chunks``). A
    volume may yield several of each (large rows, small rows).
    ``pooled``: the padded last small row is a :class:`_PaddedRow`, not
    a padded copy (``stripe._pad_to``)."""
    for key, dat in sources:
        parts = _unpadded_rows(dat, scheme) if pooled else \
            (rows for rows, _ in stripe_rows(dat, scheme, stats))
        for rows in parts:
            if rows.shape[1] * rows.shape[2] > max_batch_bytes:
                # One row is bigger than a whole batch: column-split it
                # (iter_row_batches emits (1, k, cols) chunks in order).
                if stats is not None:
                    stats.split_rows += rows.shape[0]
                for chunk in iter_row_batches(rows, max_batch_bytes):
                    if stats is not None:
                        stats.split_chunks += 1
                    yield key, chunk, True
            else:
                yield key, rows, False


class _Bucket:
    __slots__ = ("pend", "rows")

    def __init__(self):
        self.pend: list[tuple[object, int, np.ndarray]] = []
        self.rows = 0

    def flush(self, stats=None, buffers=None
              ) -> Optional[tuple[list[RowSpan], np.ndarray]]:
        """The pending rows as one batch, packed by a ``pack`` span
        (counted in ``stats``). With ``buffers``, into the front of the
        buffer it returns (``pack_pooled_bytes``); without, a single
        contiguous span is handed on as it is, anything else is copied
        into a fresh array."""
        if not self.pend:
            return None
        spans, r0 = [], 0
        for key, offset, rows in self.pend:
            spans.append(RowSpan(key, r0, rows.shape[0], offset))
            r0 += rows.shape[0]
        parts = [r for _, _, r in self.pend]
        self.pend, self.rows = [], 0
        if buffers is None:
            if len(parts) == 1 and parts[0].flags.c_contiguous:
                return spans, parts[0]
            packed = pack(
                stats, sum(p.nbytes for p in parts),
                lambda: np.concatenate(parts, axis=0) if len(parts) > 1
                else np.ascontiguousarray(parts[0]))
            return spans, packed
        shape = (r0,) + parts[0].shape[1:]
        out = buffers()[:r0 * shape[1] * shape[2]].reshape(shape)

        def copy():
            r = 0
            for p in parts:
                dst = out[r:r + p.shape[0]]
                if isinstance(p, _PaddedRow):
                    p.copy_into(dst)
                else:
                    np.copyto(dst, p)
                r += p.shape[0]
            return out

        pack(stats, out.nbytes, copy)
        if stats is not None:
            stats.pack_pooled_bytes += out.nbytes
        return spans, out


def iter_packed_batches(sources: Iterable[tuple[object, np.ndarray]],
                        scheme: EcScheme = DEFAULT_SCHEME,
                        max_batch_bytes: Optional[int] = None,
                        stats: Optional[pipe.PipeStats] = None,
                        buffers: Optional[Callable[[], np.ndarray]] = None
                        ) -> Iterator[tuple[list[RowSpan], np.ndarray]]:
    """Pack per-volume row tensors into shared (B, k, block) batches of
    at most ``max_batch_bytes`` (default ``[pipeline] batch_bytes``).

    Rows are grouped into per-shape buckets (so volumes that mix large
    and small rows still coalesce with their neighbours); a bucket
    flushes when it reaches the batch bound, and every span carries its
    shard-file offset so results scatter back position-addressed. The
    copies (packing, the pad of a volume's last small rows) count in
    ``stats``' ``pack_seconds`` and ``pack_bytes``.

    ``buffers``, the buffer source, is called once for every batch,
    just before the batch is packed into the front of the uint8 buffer
    it returns, of at least :func:`max_packed_bytes` bytes: each batch
    is then a view of its buffer, every byte is copied once, and a
    padded row's pad is zeroed there. Without it every batch is a fresh
    array or a view of its source.

    A row wider than the batch bound is column-split, and each of its
    chunks leaves at once as a batch of its own (a ``split_flush``
    flight event; its copy counts in ``split_pack_*`` too): every column
    chunk of a volume's row is emitted before the packer takes the next
    row, so none waits in a bucket for later volumes' rows. Rows that fit
    the bound share the per-shape buckets across volumes as before."""
    if max_batch_bytes is None:
        max_batch_bytes = pipe.current().batch_bytes
    buckets: dict[tuple[int, int], _Bucket] = {}
    cursor: dict[object, int] = {}
    for key, rows, chunk in _iter_volume_rows(
            sources, scheme, max_batch_bytes, stats,
            pooled=buffers is not None):
        if chunk:
            off = cursor.get(key, 0)
            cursor[key] = off + rows.shape[2]
            yield _flush_chunk(key, off, rows, stats, buffers)
            continue
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
                out = b.flush(stats, buffers)
                if out:
                    yield out
    for b in buckets.values():
        out = b.flush(stats, buffers)
        if out:
            yield out


def _flush_chunk(key, offset: int, chunk, stats=None, buffers=None
                 ) -> tuple[list[RowSpan], np.ndarray]:
    """One column chunk as a batch of its own (:meth:`_Bucket.flush`).
    In ``stats``: its copy in ``split_pack_*``, and in
    ``split_hold_max_seconds`` the host time from the packer taking it to
    its batch leaving, the wait for a pool buffer included."""
    taken = time.perf_counter()
    b = _Bucket()
    b.pend.append((key, offset, chunk))
    if stats is None:
        out = b.flush(None, buffers)
    else:
        seconds, nbytes = stats.pack_seconds, stats.pack_bytes
        out = b.flush(stats, buffers)
        stats.split_pack_seconds += stats.pack_seconds - seconds
        stats.split_pack_bytes += stats.pack_bytes - nbytes
        stats.split_hold_max_seconds = max(stats.split_hold_max_seconds,
                                           time.perf_counter() - taken)
    flight.record(flight.EV_SPLIT_FLUSH, arg=out[1].nbytes)
    return out


def max_packed_bytes(k: int, max_batch_bytes: int) -> int:
    """The most bytes one packed batch holds: the bound, or one column
    chunk where the bound is narrower than a chunk can be."""
    return max(max_batch_bytes, k * column_width(k, max_batch_bytes))


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


class _Batch:
    """Rides a packed batch through the pipeline: its spans and the pool
    buffer it views, released once: after the write, by ``run_pipeline``'s
    ``recycle_fn`` (also on a failure path), unless the write stage handed
    the release to the queued writes that view it (:meth:`token`)."""

    __slots__ = ("spans", "pool", "buf", "handed")

    def __init__(self, spans: list[RowSpan], pool: pipe.HostBufferPool,
                 buf: np.ndarray):
        self.spans, self.pool, self.buf = spans, pool, buf
        self.handed = False

    def token(self, writes: int) -> writeback.BatchToken:
        """A token that releases the buffer once ``writes`` queued writes
        have each called ``done_one``; :meth:`release` no longer does."""
        self.handed = True
        pool, buf = self.pool, self.buf
        return writeback.BatchToken(writes, lambda: pool.release(buf))

    def release(self) -> None:
        if not self.handed:
            self.handed = True
            self.pool.release(self.buf)


def _encode_pooled(sources: Iterable[tuple[object, np.ndarray]],
                   write: Callable[[_Batch, np.ndarray, np.ndarray], None],
                   scheme: EcScheme, max_batch_bytes: Optional[int],
                   device, stats: Optional[pipe.PipeStats]) -> int:
    """The pipeline under :func:`encode_packed` and
    :func:`encode_volumes`: batches packed into a pool of host buffers,
    ``write(meta, batch, parity)`` on the writer thread. Returns total
    input bytes."""
    encoder = scheme.encoder(device)
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
    # pinned on the card: a batch's copy there is a DMA from the bytes the
    # reader packed, not a staging copy on the dispatch thread. A stream
    # of volumes has no known batch count, so none caps the pool.
    pool = pipe.HostBufferPool(
        max_packed_bytes(scheme.data_shards, max_batch_bytes),
        pipe.pool_buffers(sys.maxsize, group=group),
        pinned=encoder.device.type == "cuda")
    held: list[np.ndarray] = []  # the buffer of the batch being packed
    total = 0

    def acquire():
        t0 = time.perf_counter()
        buf = pool.acquire()
        st.pool_wait_seconds += time.perf_counter() - t0
        held.append(buf)
        return buf

    def batches():
        nonlocal total
        for spans, packed in iter_packed_batches(
                sources, scheme, max_batch_bytes, st, acquire):
            total += packed.size
            yield _Batch(spans, pool, held.pop()), packed

    pipe.run_pipeline(batches(), _pick_encode_fn(encoder), write,
                      recycle_fn=lambda meta, _batch: meta.release(),
                      stats=st, kind="ec.batch", encode_multi_fn=multi,
                      group=group)
    return total


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
    dispatch is on), each packed into a pooled host buffer (module
    docstring).

    ``sink(key, shard_id, offset, blocks)`` receives each span's bytes
    addressed by shard-file offset (spans of one (key, shard) are
    disjoint and cover the file), on the pipeline's writer thread.
    ``blocks`` may be a strided (n, block) VIEW whose rows are
    contiguous — sinks either write row-wise (zero-copy) or flatten.
    Data shards come straight from the host batch, parity from the
    codec. A data shard's ``blocks`` views the pooled batch, which is
    recycled once the sink has returned: a sink that keeps the bytes
    copies them. ``stats`` receives the run's stage breakdown. Returns
    total input bytes.

    Batches reach the sink in the order they were packed, and a row
    wider than the batch bound (a 1 GiB-block large row) reaches it
    whole, chunk after chunk, before any later row is packed
    (:func:`iter_packed_batches`). Only rows that fit the bound wait in
    a bucket for other volumes' rows, a batch's worth at most: where each
    volume has a batch of small rows or more (a 30000 MiB volume's 952,
    six to a batch at 64 MiB), every span of a volume reaches the sink
    before the first byte of the volume two after it."""
    k = scheme.data_shards

    def write(meta, batch, parity):
        # Views, not gather copies: each span row is already contiguous.
        # Sinks that need flat bytes copy on demand.
        for sp in meta.spans:
            for s in range(k):
                sink(sp.key, s, sp.offset, batch[sp.r0:sp.r0 + sp.n, s])
            for j in range(parity.shape[1]):
                sink(sp.key, k + j, sp.offset,
                     parity[sp.r0:sp.r0 + sp.n, j])

    return _encode_pooled(sources, write, scheme, max_batch_bytes, device,
                          stats)


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
            # keep_output must own the bytes: the data views are of a
            # pooled batch that is recycled once the sink returns
            pieces.setdefault((key, shard_id), []).append(
                (offset, blocks.flatten()))

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
    total .dat bytes encoded.

    A volume's large rows are column-split and written chunk after
    chunk, each row before the next row is packed (:func:`encode_packed`):
    where each volume has a batch of small rows or more, every write of a
    volume is submitted before the first write of the volume two after
    it, as upstream ``ec.encode`` finishes a volume before the next."""
    bases = [str(b) for b in bases]
    k = scheme.data_shards
    shard_sizes: dict[str, int] = {}
    # spans address disjoint shard-file byte ranges, so writes go to
    # the positioned-write pool (preallocated files, pwritev) and
    # retire while the next batch packs and computes
    writer = writeback.WriterPool()

    def sources():
        for b in bases:
            datp = volume_mod.dat_path(b)
            size = datp.stat().st_size
            shard_sizes[b] = scheme.shard_file_size(size)
            # read-only: the packer copies every byte into a pool buffer
            dat = np.memmap(datp, dtype=np.uint8, mode="r") \
                if size else np.zeros(0, dtype=np.uint8)
            yield b, dat

    def submit(base, shard_id, offset, rows, token=None):
        path = str(ec_files.shard_path(base, shard_id))
        writer.open_file(path, shard_sizes[base])
        writer.submit(path, offset, rows, token)

    def write(meta, batch, parity):
        row_ok = batch.shape[2] >= pipe.ROW_WRITE_MIN_BLOCK
        writes = k * len(meta.spans)
        # data rows VIEW the pooled batch on the row path (rows are
        # contiguous even when a span is strided): its buffer is
        # recycled once all of their writes have retired. The copy path
        # flattens, and the batch is recycled when this returns.
        token = meta.token(writes) if row_ok else None
        done = 0
        try:
            for sp in meta.spans:
                for s in range(k):
                    submit(sp.key, s, sp.offset, encode._shard_rows(
                        batch[sp.r0:sp.r0 + sp.n, s], row_ok, pooled=True),
                        token)
                    done += 1
        except BaseException:
            # a failed writer or a crash point: fire the unreached counts
            # so the buffer still comes back and the reader can drain out
            if token is not None:
                for _ in range(writes - done):
                    token.done_one()
            raise
        for sp in meta.spans:
            for j in range(parity.shape[1]):
                submit(sp.key, k + j, sp.offset, encode._shard_rows(
                    parity[sp.r0:sp.r0 + sp.n, j], row_ok))

    try:
        total = _encode_pooled(sources(), write, scheme, max_batch_bytes,
                               device, stats)
        writer.close()
        writer = None
        return total
    finally:
        if writer is not None:
            writer.abort()
