"""ec decode: turn shard files back into a normal .dat/.idx volume.

The port of ``seaweedfs_tpu/pipeline/decode.py``, the volume-server side
of ``ec.decode`` (ec_decoder.go): WriteDatFile from the k data shards,
rebuilding lost ones first through the kernel path (pipeline/rebuild.py),
and WriteIdxFileFromEcIndex, replaying the .ecj delete journal as
tombstones.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops import rs_torch
from ..storage import ec_files, idx as idx_mod, needle as needle_mod
from ..storage import volume as volume_mod
from ..storage.types import TOMBSTONE_FILE_SIZE
from .rebuild import rebuild_ec_files
from .scheme import DEFAULT_SCHEME, EcScheme


class EcDecodeError(RuntimeError):
    pass


def find_dat_file_size(base: str | Path, version: int | None = None) -> int:
    """The true .dat size: from the .vif if it recorded it, else the end
    of the last live needle record in the .ecx (ec_decoder.go
    FindDatFileSize). ``version`` defaults to the .vif's needle version."""
    vi = ec_files.VolumeInfo.load(base)
    if vi.dat_file_size:
        return vi.dat_file_size
    if version is None:
        version = vi.version or 3
    ecxp = ec_files.ecx_path(base)
    if not ecxp.exists():
        raise EcDecodeError(f"{ecxp} does not exist")
    end = 8  # superblock
    for e in idx_mod.walk_index_blob(ecxp.read_bytes()):
        if e.is_deleted:
            continue
        end = max(end, e.byte_offset + needle_mod.record_size(e.size,
                                                              version))
    return end


def write_dat_file(base: str | Path, scheme: EcScheme = DEFAULT_SCHEME,
                   device=None) -> int:
    """Data shards -> <base>.dat, rebuilding missing data shards first
    on ``device`` (None = the card). Returns the .dat size.

    Streams: shard files are memmapped and the .dat is written in
    stripe-layout order (large rows, then small rows), so host memory
    stays O(1) in the volume size."""
    present = ec_files.present_shards(base, scheme.total_shards)
    missing_data = [i for i in range(scheme.data_shards)
                    if i not in present]
    if missing_data:
        rebuild_ec_files(base, scheme, wanted=missing_data, device=device)
    dat_size = find_dat_file_size(base)
    k = scheme.data_shards
    large, small = scheme.large_block_size, scheme.small_block_size
    shards = [np.memmap(ec_files.shard_path(base, i), dtype=np.uint8,
                        mode="r")
              if ec_files.shard_path(base, i).stat().st_size
              else np.zeros(0, dtype=np.uint8)
              for i in range(k)]
    if len({s.size for s in shards}) != 1:
        raise EcDecodeError("data shards have inconsistent sizes")
    expect = scheme.shard_file_size(dat_size)
    if shards[0].size != expect:
        raise EcDecodeError(
            f"shard file size {shards[0].size} != expected {expect} "
            f"for dat size {dat_size}")
    rows = scheme.large_rows_count(dat_size)
    written = 0
    with open(volume_mod.dat_path(base), "wb") as f:
        for r in range(rows):  # large region: row-major, shard-minor
            for s in range(k):
                n = min(large, dat_size - written)
                f.write(shards[s][r * large:r * large + n].data)
                written += n
                if written >= dat_size:
                    break
        off = rows * large  # small-row tail region
        while written < dat_size:
            for s in range(k):
                n = min(small, dat_size - written)
                f.write(shards[s][off:off + n].data)
                written += n
                if written >= dat_size:
                    break
            off += small
    return dat_size


def write_idx_file_from_ecx(base: str | Path) -> int:
    """<base>.ecx (+ .ecj tombstones) -> <base>.idx (ec_decoder.go
    WriteIdxFileFromEcIndex). Returns entries written."""
    ecxp = ec_files.ecx_path(base)
    if not ecxp.exists():
        raise EcDecodeError(f"{ecxp} does not exist")
    blob = ecxp.read_bytes()
    deleted = ec_files.ecj_deleted_set(base)
    count = 0
    with open(volume_mod.idx_path(base), "wb") as f:
        for e in idx_mod.walk_index_blob(blob):
            f.write(e.to_bytes())
            count += 1
        for key in sorted(deleted):
            f.write(idx_mod.IndexEntry(key, 0,
                                       TOMBSTONE_FILE_SIZE).to_bytes())
            count += 1
    return count


def decode_volume(base: str | Path, scheme: EcScheme = DEFAULT_SCHEME,
                  device=None) -> int:
    """Full ec.decode on ``device`` (None = the card; raises when there
    is none): .dat + .idx restored; returns the .dat size."""
    from ..util import tracing

    rs_torch.resolve_device(device)
    with tracing.span("ec.decode", base=str(base)) as sp:
        size = write_dat_file(base, scheme, device=device)
        sp.n_bytes = size
    write_idx_file_from_ecx(base)
    return size
