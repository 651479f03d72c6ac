"""ec rebuild: regenerate missing shard files from survivors.

The port of ``seaweedfs_tpu/pipeline/rebuild.py``, the volume-server side
of ``ec.rebuild`` (ec_encoder.go RebuildEcFiles): find which .ec?? files
exist and, if at least k survive, produce the missing ones. The decode
rows are composed on the host (ops/rs_torch.py), so every missing shard
— data or parity — comes out of one kernel pass per chunk.

Rebuild rides the same overlapped plane as encode: survivor chunks are
``os.preadv``'d straight into pooled (pinned, on CUDA) host buffers, the
kernel overlaps the next chunk's reads, and rebuilt chunks land at
deterministic offsets in preallocated files via the positioned-write
pool. Rebuilt bytes are a fresh pinned array (the D2H copy), so input
buffers recycle as soon as a chunk's result has synced.

On one card, runs of chunks of one length share ONE kernel launch
(grouped dispatch, ``pipe.pick_grouped_dispatch`` and
``rs_torch.apply_matrix_host_multi``); a chunk's input is k times its
per-shard take, so the grouped byte bound ``[pipeline]
grouped_batch_bytes`` is converted back through k. The take is a whole
number of the kernels' granules (``rs_cuda.GRANULE``: the transpose
kernel's 128 bytes, a multiple of the SWAR kernel's 16) where the JAX
package aligns to its Pallas segment: a chunk of whole granules needs
no padding copy in the wrapper, and since :func:`chunk_length` splits a
shard into equal shares, every chunk but the last has one shape and
the runs of equal shape stay long. When ``parallel/mesh.routing_mesh``
says to split, every chunk splits over the mesh's devices
(:func:`_pick_reconstruct_fn`) and grouping is off. A completed
rebuild is published to the ring of recent runs as ``ec.rebuild``, and
every live chunk cache drops the volume (``base_invalidated``). The run
lies inside an ``ec.rebuild`` trace span carrying the rebuilt bytes and
a ``shards`` tag.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional, Sequence

from ..ops import rs_cuda
from ..ops.rs_ref import TooFewShardsError
from ..ops.rs_torch import Encoder
from ..parallel import mesh as mesh_mod
from ..storage import ec_files
from . import flight, pipe, writeback
from .scheme import DEFAULT_SCHEME, EcScheme


class EcRebuildError(RuntimeError):
    pass


def chunk_length(size: int, k: int,
                 chunk_bytes: Optional[int] = None) -> int:
    """Shard bytes per survivor in one kernel call for shards of ``size``
    bytes: at most ``chunk_bytes`` (default: one batch of ``[pipeline]
    batch_bytes`` over the k survivors), whole granules, so only
    a shard's last chunk can need the kernel wrappers' padding, and the
    shard split into chunks of equal length, so no pooled buffer is much
    larger than the bytes read into it."""
    g = rs_cuda.GRANULE
    cap = pipe.current().batch_bytes // k if chunk_bytes is None \
        else chunk_bytes
    cap = max(g, cap // g * g)
    n = max(1, -(-size // cap))   # chunks of at most cap bytes
    per = -(-size // n)           # equal shares of the shard
    return -(-per // g) * g       # rounded up to whole granules


def _pick_reconstruct_fn(enc: Encoder, present, missing):
    """The compute stage: when routing_mesh() says to split — more than
    one card, or an explicit -mesh (CPU device lists included) — the
    chunks split over the mesh (parallel/mesh.reconstruct_host_sharded);
    otherwise the single-device host path. The same routing rule as the
    batcher's encode (pipeline/batch._pick_encode_fn)."""
    m = mesh_mod.routing_mesh(enc.device)
    if m is not None:
        return lambda chunk: mesh_mod.reconstruct_host_sharded(
            enc, chunk, present, missing, mesh=m)
    return lambda chunk: enc.reconstruct_batch_host(chunk, present,
                                                    missing)


def rebuild_ec_files(base: str | Path, scheme: EcScheme = DEFAULT_SCHEME,
                     wanted: Optional[Sequence[int]] = None,
                     chunk_bytes: Optional[int] = None,
                     device=None,
                     stats: Optional[pipe.PipeStats] = None) -> list[int]:
    """Rebuild missing (or explicitly ``wanted``) shard files in place on
    ``device`` (None = the card). ``chunk_bytes`` bounds the shard bytes
    per survivor in one kernel call (see :func:`chunk_length`). Returns
    the list of shard ids written."""
    enc = scheme.encoder(device)
    total = scheme.total_shards
    present = ec_files.present_shards(base, total)
    missing = sorted(set(range(total)) - set(present)) if wanted is None \
        else sorted(wanted)
    if not missing:
        return []
    overlap = set(missing) & set(present)
    if wanted is not None and overlap:
        raise EcRebuildError(f"shards {sorted(overlap)} already exist")
    if len(present) < scheme.data_shards:
        raise TooFewShardsError(
            f"need {scheme.data_shards} surviving shards, "
            f"have {len(present)}")
    sizes = {ec_files.shard_path(base, i).stat().st_size for i in present}
    if len(sizes) != 1:
        raise EcRebuildError(f"surviving shard sizes differ: {sizes}")
    size = sizes.pop()

    # Only the first k survivors feed the decode matrix — don't read the
    # rest from disk at all.
    present = present[:scheme.data_shards]
    k = scheme.data_shards
    if chunk_bytes is None:
        chunk_bytes = pipe.current().batch_bytes // k
    reconstruct_multi, group, grouped_total = pipe.pick_grouped_dispatch(
        lambda chunks: enc.reconstruct_batch_host_multi(chunks, present,
                                                        missing),
        k * chunk_bytes, device=enc.device)
    chunk_bytes = chunk_length(size, k, grouped_total // k)
    n_chunks = -(-size // chunk_bytes) if size else 0
    pool = pipe.HostBufferPool(
        max(1, k * min(chunk_bytes, size)),
        pipe.pool_buffers(n_chunks, group=group),
        pinned=enc.device.type == "cuda")
    in_fds = [os.open(ec_files.shard_path(base, i), os.O_RDONLY)
              for i in present]
    out_paths = [str(ec_files.shard_path(base, i)) for i in missing]
    writer = writeback.WriterPool()
    st = stats if stats is not None else pipe.PipeStats()

    def chunks():
        pos = 0
        while pos < size:
            take = min(chunk_bytes, size - pos)
            flight.record(flight.EV_ENQUEUE, arg=k * take)
            buf = pool.acquire()
            view = buf[:k * take]
            for s, fd in enumerate(in_fds):
                pipe.pread_into(fd, view[s * take:(s + 1) * take], pos)
            yield (buf, pos), view.reshape(1, k, take)
            pos += take

    def write(meta, _chunk, rebuilt):
        # rebuilt (1, len(missing), take) is the fresh D2H array —
        # positioned writes at the chunk offset, no buffer token.
        _buf, pos = meta
        for row, path in zip(rebuilt[0], out_paths):
            writer.submit(path, pos, [row])

    def recycle(meta, _chunk):
        pool.release(meta[0])

    from ..util import tracing

    try:
        with tracing.span("ec.rebuild", base=str(base)) as sp:
            sp.n_bytes = size * len(missing)
            sp.tag(shards=",".join(str(i) for i in missing))
            t0 = time.perf_counter()
            for path in out_paths:
                writer.open_file(path, size)
            try:
                pipe.run_pipeline(
                    chunks(), _pick_reconstruct_fn(enc, present, missing),
                    write, recycle_fn=recycle, stats=st, publish=False,
                    encode_multi_fn=reconstruct_multi, group=group)
            except pipe.PipelineError:
                writer.abort()
                writer = None
                raise
            writer.close()
            st.write_seconds += writer.busy_seconds
            writer = None
            st.wall_seconds = time.perf_counter() - t0
            pipe.publish_stats(st, kind="ec.rebuild")
    finally:
        if writer is not None:
            writer.abort()
        for fd in in_fds:
            os.close(fd)
    # Shard files changed under any reader holding cached post-decode
    # needles for this volume — tell every live chunk cache.
    from ..cache import invalidation as cache_invalidation

    cache_invalidation.base_invalidated(base, reason="ec-rebuild")
    return missing
