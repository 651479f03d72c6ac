"""ec encode: seal a volume into k+m shard files + .ecx + .vif.

The port of ``seaweedfs_tpu/pipeline/encode.py``, the volume-server side
of ``ec.encode`` (ec_encoder.go WriteEcFiles + WriteSortedFileFromIdx):
striping produces (R, k, block) row batches, each batch is ONE kernel
call computing all parities, and shard files are written at
deterministic offsets per batch, so peak host memory is bounded by the
batch size, not the volume size.

Ingest is the overlapped plane of pipe.py/writeback.py: every batch is
a set of fixed byte ranges of the .dat and a fixed offset in each shard
file, so the reader ``os.preadv``s file bytes straight into pooled
(pinned, on CUDA) host buffers, the card computes PARITY ONLY (data
shards are written straight from the host batch), and a positioned-write
pool retires ``pwritev`` calls into preallocated shard files while the
next batch's transfer and kernel are in flight. A pooled buffer is
recycled only after every data-shard write that views it has retired
(writeback.BatchToken).

Batch bound, overlap, pool size, writer width and preallocation come
from ``[pipeline]`` (pipe.current()). When ``parallel/mesh.routing_mesh``
says to split (``[mesh]``, ``-mesh dp,sp``, or more than one card), every
batch splits over the mesh's devices instead: the compute stage is the
mesh's prepare (copies to the cells) then apply (one product per cell),
passed to the pipeline as two stages so ``[pipeline] double_buffer`` can
overlap the next batch's prepare with the current batch's apply. Plans
and offsets are the same, so the output bytes are too. A completed
encode is published to the ring of recent runs as ``ec.encode``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..ops import rs_torch
from ..parallel import mesh as mesh_mod
from ..storage import ec_files, idx as idx_mod, volume as volume_mod
from ..storage import superblock as superblock_mod
from . import flight, pipe, writeback
from .scheme import DEFAULT_SCHEME, EcScheme


class EcEncodeError(RuntimeError):
    pass


def _require_local_dat(base: str | Path) -> Path:
    datp = volume_mod.dat_path(base)
    if not datp.exists():
        from ..storage import tier as tier_mod
        if tier_mod.TierInfo.maybe_load(base) is not None:
            raise EcEncodeError(
                f"volume {base} is tiered to S3; run "
                f"volume.tier.download first (EC encode streams the "
                f"whole .dat — do it from local disk, not ranged GETs)")
        raise EcEncodeError(f"{datp} does not exist")
    return datp


class _Plan:
    """One batch's layout: where its bytes live in the .dat and where
    its rows land in every shard file. ``segs`` is a list of
    (buf_offset, file_offset, want, have) — ``have < want`` only for
    the zero-padded tail of the small-row region."""

    __slots__ = ("shape", "segs", "shard_off")

    def __init__(self, shape, segs, shard_off):
        self.shape = shape
        self.segs = segs
        self.shard_off = shard_off

    @property
    def nbytes(self) -> int:
        r, k, block = self.shape
        return r * k * block


def plan_batches(dat_size: int, scheme: EcScheme,
                 max_batch_bytes: int) -> Iterator[_Plan]:
    """Batch plans covering the .dat in layout order — the pure-math
    twin of stripe.stripe_rows + stripe.iter_row_batches: large rows
    first, then zero-padded small rows; whole-row batches bounded by
    ``max_batch_bytes``, or 128-byte-aligned column chunks when a
    single row alone exceeds the bound (the codec is position-wise).

    A whole-row batch is ONE contiguous byte range of the .dat and a
    column chunk is k strided ranges, so the reader can preadv straight
    into a pooled buffer with no intermediate copy."""
    k = scheme.data_shards
    large, small = scheme.large_block_size, scheme.small_block_size
    rows = scheme.large_rows_count(dat_size)
    large_region = rows * large * k
    regions = []
    if rows:
        # (block, n_rows, file_base, shard_base, avail bytes)
        regions.append((large, rows, 0, 0, large_region))
    tail = dat_size - large_region
    if tail > 0:
        small_rows = -(-tail // (small * k))
        regions.append((small, small_rows, large_region,
                        rows * large, tail))
    for block, n_rows, file_base, shard_base, avail in regions:
        per_row = k * block
        if per_row <= max_batch_bytes:
            rpb = max(1, max_batch_bytes // per_row)
            for r0 in range(0, n_rows, rpb):
                r_n = min(rpb, n_rows - r0)
                off = r0 * per_row
                nbytes = r_n * per_row
                have = min(nbytes, max(0, avail - off))
                yield _Plan((r_n, k, block),
                            [(0, file_base + off, nbytes, have)],
                            shard_base + r0 * block)
        else:
            # One row exceeds the bound: split along the block axis,
            # 128-byte aligned (the transpose kernel's granule).
            cols = max(128, (max_batch_bytes // k) // 128 * 128)
            for r in range(n_rows):
                for c in range(0, block, cols):
                    take = min(cols, block - c)
                    segs = []
                    for s in range(k):
                        pos = r * per_row + s * block + c
                        have = min(take, max(0, avail - pos))
                        segs.append((s * take, file_base + pos,
                                     take, have))
                    yield _Plan((1, k, take), segs,
                                shard_base + r * block + c)


class _BatchMeta:
    """Rides each batch through the pipeline: which plan it is, which
    pooled buffer holds it, and whether the write stage has taken
    ownership of recycling (writeback token / copy path)."""

    __slots__ = ("plan", "buf", "submitted")

    def __init__(self, plan: _Plan, buf: np.ndarray):
        self.plan = plan
        self.buf = buf
        self.submitted = False


def _shard_rows(col2d: np.ndarray, row_ok: bool,
                pooled: bool = False) -> list:
    """Rows of a (R, block) column view to write. Rows are contiguous
    even though the view is strided; below ROW_WRITE_MIN_BLOCK tiny
    blocks are flattened into one copy. A pooled source on the copy
    path is always copied (``flatten``), since its buffer is released
    as soon as the submits return."""
    if row_ok:
        return [col2d[r] for r in range(col2d.shape[0])]
    if pooled:
        return [col2d.flatten()]
    return [np.ascontiguousarray(col2d).reshape(-1)]


def write_ec_files(base: str | Path, scheme: EcScheme = DEFAULT_SCHEME,
                   max_batch_bytes: Optional[int] = None,
                   stats: Optional[pipe.PipeStats] = None,
                   overlapped: Optional[bool] = None,
                   device=None) -> int:
    """Generate <base>.ec00..ec<k+m-1> from <base>.dat on ``device``
    (None = the card). Returns the .dat size. ``max_batch_bytes`` and
    ``overlapped`` default to ``[pipeline] batch_bytes`` and
    ``overlapped``.

    ``overlapped=False`` is the single-threaded path: identical plans
    and offsets, so output bytes match the overlapped path exactly."""
    cfg = pipe.current()
    if max_batch_bytes is None:
        max_batch_bytes = cfg.batch_bytes
    if overlapped is None:
        overlapped = cfg.overlapped
    encoder = scheme.encoder(device)
    datp = _require_local_dat(base)
    dat_size = datp.stat().st_size
    k = scheme.data_shards
    mesh = mesh_mod.routing_mesh(encoder.device)
    lookahead = overlapped and cfg.double_buffer and mesh is not None
    if mesh is not None:
        # the split: prepare (copies to the cells) and apply (one
        # product per cell) are two stages of the pipeline, which
        # [pipeline] double_buffer overlaps, the copies then on a copy
        # stream of their own
        prepare_fn, encode_fn = mesh_mod.encode_step_fns(
            encoder, mesh, copy_stream=lookahead)
    else:
        prepare_fn = None
        encode_fn = encoder.encode_parity_host

    plans = list(plan_batches(dat_size, scheme, max_batch_bytes))
    paths = [str(ec_files.shard_path(base, i))
             for i in range(scheme.total_shards)]
    shard_size = scheme.shard_file_size(dat_size)

    pool = pipe.HostBufferPool(
        max((p.nbytes for p in plans), default=1),
        pipe.pool_buffers(len(plans), lookahead),
        pinned=encoder.device.type == "cuda")
    st = stats if stats is not None else pipe.PipeStats()

    fd = os.open(datp, os.O_RDONLY)
    writer = writeback.WriterPool() if overlapped else None
    fds: dict[str, int] = {}
    try:
        if writer is not None:
            for p in paths:
                writer.open_file(p, shard_size)
        else:
            for p in paths:
                out = os.open(p, os.O_CREAT | os.O_WRONLY | os.O_TRUNC,
                              0o644)
                fds[p] = out
                if cfg.preallocate:
                    writeback.preallocate(out, shard_size)

        def batches():
            for plan in plans:
                flight.record(flight.EV_ENQUEUE, arg=plan.nbytes)
                buf = pool.acquire()
                view = buf[:plan.nbytes]
                for boff, foff, want, have in plan.segs:
                    if have > 0:
                        pipe.pread_into(fd, view[boff:boff + have], foff)
                    if have < want:
                        view[boff + have:boff + want] = 0
                yield _BatchMeta(plan, buf), view.reshape(plan.shape)

        def write_pooled(meta: _BatchMeta, batch, parity):
            plan = meta.plan
            row_ok = plan.shape[2] >= pipe.ROW_WRITE_MIN_BLOCK
            meta.submitted = True
            # data rows VIEW the pooled buffer on the row path: recycle
            # it only once all k data-shard writes have retired
            token = writeback.BatchToken(
                k, lambda b=meta.buf: pool.release(b)) if row_ok else None
            done = 0
            try:
                for s in range(k):
                    writer.submit(paths[s], plan.shard_off,
                                  _shard_rows(batch[:, s], row_ok,
                                              pooled=True), token)
                    done += 1
            except BaseException:
                # a failed writer or a crash point's simulated crash:
                # fire the unreached counts (or release the copy path's
                # buffer) so the reader can drain out
                if token is None:
                    pool.release(meta.buf)
                for _ in range(k - done):
                    if token is not None:
                        token.done_one()
                raise
            if token is None:
                pool.release(meta.buf)  # copy path took its own bytes
            for j in range(parity.shape[1]):
                writer.submit(paths[k + j], plan.shard_off,
                              _shard_rows(parity[:, j], row_ok))

        def write_inline(meta: _BatchMeta, batch, parity):
            plan = meta.plan
            row_ok = plan.shape[2] >= pipe.ROW_WRITE_MIN_BLOCK
            for s in range(k):
                writeback.pwrite_rows(fds[paths[s]], plan.shard_off,
                                      _shard_rows(batch[:, s], row_ok))
            for j in range(parity.shape[1]):
                writeback.pwrite_rows(fds[paths[k + j]], plan.shard_off,
                                      _shard_rows(parity[:, j], row_ok))

        def recycle(meta: _BatchMeta, _batch):
            # no-op once the write stage owns the buffer (token/copy
            # path); failure paths come through here for batches whose
            # write never ran
            if not meta.submitted:
                meta.submitted = True
                pool.release(meta.buf)

        t0 = time.perf_counter()
        try:
            pipe.run_pipeline(
                batches(), encode_fn,
                write_pooled if writer is not None else write_inline,
                recycle_fn=recycle, stats=st, overlapped=overlapped,
                publish=False, prepare_fn=prepare_fn)
        except pipe.PipelineError:
            if writer is not None:
                writer.abort()
                writer = None
            raise
        if writer is not None:
            writer.close()
            st.write_seconds += writer.busy_seconds
            writer = None
        st.wall_seconds = time.perf_counter() - t0
        pipe.publish_stats(st, kind="ec.encode")
    finally:
        if writer is not None:
            writer.abort()
        for out in fds.values():
            try:
                os.close(out)
            except OSError:  # best-effort close-all on the cleanup path
                pass
        os.close(fd)
    return int(dat_size)


def write_ecx_file(base: str | Path) -> int:
    """<base>.idx -> sorted <base>.ecx (WriteSortedFileFromIdx)."""
    ip = volume_mod.idx_path(base)
    if not ip.exists():
        raise EcEncodeError(f"{ip} does not exist")
    return idx_mod.write_sorted_ecx_from_idx(ip, ec_files.ecx_path(base))


def encode_volume(base: str | Path, scheme: EcScheme = DEFAULT_SCHEME,
                  max_batch_bytes: Optional[int] = None,
                  replication: str = "",
                  remove_source: bool = False,
                  device=None,
                  stats: Optional[pipe.PipeStats] = None,
                  overlapped: Optional[bool] = None
                  ) -> ec_files.VolumeInfo:
    """Full seal on ``device`` (None = the card; raises when there is
    none): shards + .ecx + .vif, optionally dropping .dat/.idx the way
    ``ec.encode`` deletes the source volume after spreading shards. The
    .vif records the volume's needle version from the superblock. The
    shard write runs under an ``ec.encode`` span carrying the .dat
    size."""
    from ..util import tracing

    rs_torch.resolve_device(device)
    with open(_require_local_dat(base), "rb") as f:
        version = superblock_mod.SuperBlock.parse(f.read(8)).version
    with tracing.span("ec.encode", base=str(base)) as sp:
        dat_size = write_ec_files(base, scheme, max_batch_bytes,
                                  stats=stats, overlapped=overlapped,
                                  device=device)
        sp.n_bytes = dat_size
    write_ecx_file(base)
    vi = ec_files.VolumeInfo(version=version, replication=replication,
                             dat_file_size=dat_size,
                             data_shards=scheme.data_shards,
                             parity_shards=scheme.parity_shards)
    vi.save(base)
    if remove_source:
        os.remove(volume_mod.dat_path(base))
        os.remove(volume_mod.idx_path(base))
    return vi
