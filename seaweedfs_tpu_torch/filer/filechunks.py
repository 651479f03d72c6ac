"""Chunk-list resolution: which stored bytes are visible where.

Mirrors weed/filer/filechunks.go: chunks may overlap after overwrites
and appends; the newest write (largest mtime, then list order) wins at
every offset. ``visible_intervals`` flattens the chunk list into
disjoint [start, stop) runs, and ``read_plan`` maps a requested byte
range onto per-chunk sub-reads the server can fetch concurrently.

The port of ``seaweedfs_tpu/filer/filechunks.py``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass

from .entry import FileChunk


@dataclass(frozen=True)
class Visible:
    start: int
    stop: int
    file_id: str
    chunk_offset: int  # offset of ``start`` within the stored chunk


@dataclass(frozen=True)
class ReadPiece:
    file_id: str
    chunk_offset: int  # first byte to read within the stored chunk
    length: int
    buffer_offset: int  # where the piece lands in the caller's buffer


def visible_intervals(chunks: list[FileChunk]) -> list[Visible]:
    """Flatten (possibly overlapping) chunks into disjoint visible runs.

    Later writes shadow earlier ones: chunks are applied in (mtime_ns,
    list position) order, each new chunk punching its range out of
    whatever was visible before — an interval overlay, O(n^2) worst case
    like the reference's, fine for per-file chunk counts.
    """
    vis: list[Visible] = []
    order = sorted(range(len(chunks)),
                   key=lambda i: (chunks[i].mtime_ns, i))
    for i in order:
        c = chunks[i]
        if c.size <= 0:
            continue
        start, stop = c.offset, c.offset + c.size
        out: list[Visible] = []
        for v in vis:
            if v.stop <= start or v.start >= stop:
                out.append(v)
                continue
            if v.start < start:
                out.append(Visible(v.start, start, v.file_id,
                                   v.chunk_offset))
            if v.stop > stop:
                out.append(Visible(stop, v.stop, v.file_id,
                                   v.chunk_offset + (stop - v.start)))
        out.append(Visible(start, stop, c.file_id, 0))
        out.sort(key=lambda v: v.start)
        vis = out
    return vis


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def chunk_file_ids(chunks: list[FileChunk]) -> list[str]:
    """Distinct fids in chunk order — what a cache must drop when the
    entry holding these chunks is overwritten or deleted."""
    seen: dict[str, None] = {}
    for c in chunks:
        seen.setdefault(c.file_id)
    return list(seen)


def read_plan(chunks: list[FileChunk], offset: int,
              length: int) -> list[ReadPiece]:
    """Map [offset, offset+length) onto stored-chunk sub-reads. Gaps
    (sparse ranges nothing wrote) produce no piece — callers zero-fill."""
    pieces: list[ReadPiece] = []
    stop = offset + length
    for v in visible_intervals(chunks):
        lo = max(offset, v.start)
        hi = min(stop, v.stop)
        if lo >= hi:
            continue
        pieces.append(ReadPiece(
            file_id=v.file_id,
            chunk_offset=v.chunk_offset + (lo - v.start),
            length=hi - lo,
            buffer_offset=lo - offset))
    return pieces
