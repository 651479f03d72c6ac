"""Volume vacuum: compact away deleted needles, then atomically commit.

The port of ``seaweedfs_tpu/storage/vacuum.py`` (weed/storage/
volume_vacuum.go ``Compact`` / ``CommitCompact``): deletes only journal
tombstones, so reclaimed space accumulates until a compaction rewrites
the live needles into a fresh ``.cpd``/``.cpx`` pair and renames them
over ``.dat``/``.idx``.

Two phases, same as the reference:

- ``compact(vol)`` — snapshot the .idx length, then copy every needle
  live AS OF the snapshot into ``.cpd`` (superblock compact revision
  +1) while writes keep landing in the old files. Uses pread, so no
  writer lock is held during the bulk copy.
- ``commit_compact(vol)`` — under the volume lock, replay .idx entries
  journaled AFTER the snapshot onto the compact files (the reference's
  ``makeupDiff``), fsync, rename into place, and reload the needle map.

Crash safety: a crash before the final renames leaves ``.cpd``/``.cpx``
behind and the live volume untouched — ``cleanup`` (or the next load)
just deletes them. The rename pair is ordered .idx-last so a torn
commit is detected by load-time checking.

A commit drops the volume from every live chunk cache
(``cache/invalidation.volume_invalidated``). A tiered volume (read-only,
storage/tier.py) is refused: compacting its local copy would diverge
from the tiered bytes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..util import durability, faults
from . import backend as backend_mod
from . import needle as needle_mod
from .idx import CompactMap, IndexEntry, walk_index_blob
from .superblock import SuperBlock
from .types import (NEEDLE_PADDING_SIZE, TOMBSTONE_FILE_SIZE,
                    to_offset_units)
from .volume import Volume, VolumeError, dat_path, idx_path


def cpd_path(base: str | Path) -> Path:
    return Path(str(base) + ".cpd")


def cpx_path(base: str | Path) -> Path:
    return Path(str(base) + ".cpx")


@dataclass
class CompactState:
    """Carried from compact() to commit_compact()."""
    idx_snapshot_bytes: int
    new_super: SuperBlock


def garbage_ratio(vol: Volume) -> float:
    """Deleted bytes / content bytes (topology_vacuum.go's trigger)."""
    size = vol.dat_size
    if size <= 8:
        return 0.0
    return vol.nm.deleted_bytes / max(1, size - 8)


def compact(vol: Volume) -> CompactState:
    """Phase 1: copy live needles to .cpd/.cpx. Writers may continue.

    At most one compaction per volume may be in flight: a second
    compact() (e.g. the master's auto-scan racing an operator's
    volume.vacuum) raises instead of interleaving writes into the same
    .cpd and letting one Commit rename a half-written file live."""
    if vol._dat is None:
        raise VolumeError("volume not open")
    if vol.readonly:
        # Tiered (sidecar present): compacting the local copy would
        # diverge from the S3 bytes, and a later tier.download would
        # put the stale object under the compacted .idx.
        raise VolumeError(
            f"volume {vol.volume_id} is read-only (tiered); "
            f"volume.tier.download before vacuuming")
    with vol._lock:
        if vol.vacuum_in_progress:
            raise VolumeError(
                f"volume {vol.volume_id}: compaction already in progress")
        # the claim is taken under vol._lock; every later clear runs
        # on the thread that holds the claim, so there is never a
        # concurrent writer
        # seaweedlint: disable=SW801 — claim taken under vol._lock
        vol.vacuum_in_progress = True
    try:
        return _compact_locked(vol)
    except BaseException:
        vol.vacuum_in_progress = False
        cleanup(vol.base)
        raise


def _compact_locked(vol: Volume) -> CompactState:
    with vol._lock:
        vol._idx.flush()
        vol._dat.flush()
        idx_snapshot = idx_path(vol.base).stat().st_size
        idx_snapshot -= idx_snapshot % 16
    # Needle map as of the snapshot (not vol.nm, which keeps moving).
    snap = CompactMap()
    with open(idx_path(vol.base), "rb") as f:
        for e in walk_index_blob(f.read(idx_snapshot)):
            if e.is_deleted:
                snap.delete(e.key)
            else:
                snap.set(e.key, e.offset_units, e.size)
    new_super = SuperBlock(
        version=vol.super_block.version,
        replica_placement=vol.super_block.replica_placement,
        ttl=vol.super_block.ttl,
        compact_revision=(vol.super_block.compact_revision + 1) & 0xFFFF)
    with open(cpd_path(vol.base), "wb") as nd, \
            open(cpx_path(vol.base), "wb") as nx:
        nd.write(new_super.to_bytes())
        _copy_live(snap, vol._dat, vol.super_block.version, nd, nx)
        faults.check("crash.vacuum.compact")
        nd.flush()
        os.fsync(nd.fileno())
        nx.flush()
        os.fsync(nx.fileno())
    return CompactState(idx_snapshot_bytes=idx_snapshot,
                        new_super=new_super)


def _copy_live(snap: CompactMap, dat, version: int, nd, nx
               ) -> None:
    """Append every live needle of ``snap`` to nd/.cpx in offset order
    (preserves locality and keeps the copy sequential on disk)."""
    entries = sorted(
        (e for e in snap._m.values() if not e.is_deleted),
        key=lambda e: e.offset_units)
    for e in entries:
        rec_size = needle_mod.record_size(e.size, version)
        rec = dat.read_at(rec_size, e.byte_offset)
        if len(rec) < rec_size:
            raise VolumeError(
                f"short read compacting needle {e.key}")
        pos = nd.tell()
        if pos % NEEDLE_PADDING_SIZE:
            pad = (-pos) % NEEDLE_PADDING_SIZE
            nd.write(b"\x00" * pad)
            pos += pad
        nd.write(rec)
        nx.write(IndexEntry(e.key, to_offset_units(pos),
                            e.size).to_bytes())


def commit_compact(vol: Volume, state: CompactState) -> int:
    """Phase 2: catch up post-snapshot writes, swap files, reload.
    Returns the new .dat size."""
    if vol._dat is None:
        raise VolumeError("volume not open")
    if not vol.vacuum_in_progress:
        raise VolumeError(
            f"volume {vol.volume_id}: no compaction in progress")
    if vol.needle_map_kind == "native":
        # Warm the native needle-map library BEFORE draining readers:
        # its first use forks a g++ build, and paying that while
        # holding the volume lock would stall every reader and writer
        # on this volume for the length of a compile.
        from . import needle_map_native
        needle_map_native.available()
    # seaweedlint: disable=SW103 — lib compile pre-warmed above
    with vol._lock:
        # Drain in-flight readers FIRST: Condition.wait releases the
        # volume lock, so waiting any later (after the diff replay)
        # would let a writer append an acknowledged needle to the old
        # .dat/.idx that the renames below silently discard. Once the
        # drain returns, the lock is held continuously through replay
        # and swap — no reader can touch the dying fd, no writer can
        # land a post-replay record. _swap_pending parks NEW readers so
        # a stream of overlapping reads cannot starve the drain.
        vol._swap_pending = True
        try:
            # any native-map build was pre-warmed above, outside the lock
            size = _commit_swap_drained(vol, state)
        finally:
            vol._swap_pending = False
            vol._no_readers.notify_all()
    # The compacted files are live: any chunk cache still holding
    # pre-compaction payloads for this volume must drop them before the
    # next read (fans out to every registered ChunkCache). Outside the
    # volume lock — listeners take their own locks.
    from ..cache import invalidation as cache_invalidation

    cache_invalidation.volume_invalidated(vol.volume_id, reason="vacuum")
    return size


def _commit_swap_drained(vol: Volume, state: CompactState) -> int:
    """Diff replay + fd swap; runs under vol._lock with _swap_pending
    set (new readers parked). Factored out of commit_compact so the
    flag clears on every exit path."""
    while vol._readers:
        vol._no_readers.wait()
    vol._idx.flush()
    vol._dat.flush()
    idx_now = idx_path(vol.base).stat().st_size
    idx_now -= idx_now % 16
    with open(cpd_path(vol.base), "r+b") as nd, \
            open(cpx_path(vol.base), "r+b") as nx:
        nd.seek(0, 2)
        nx.seek(0, 2)
        # Replay the diff journal (makeupDiff): appends copy the
        # record across, deletes tombstone the compact index.
        if idx_now > state.idx_snapshot_bytes:
            with open(idx_path(vol.base), "rb") as f:
                f.seek(state.idx_snapshot_bytes)
                diff = f.read(idx_now - state.idx_snapshot_bytes)
            for e in walk_index_blob(diff):
                if e.is_deleted:
                    nx.write(IndexEntry(
                        e.key, 0, TOMBSTONE_FILE_SIZE).to_bytes())
                    continue
                rec_size = needle_mod.record_size(
                    e.size, vol.super_block.version)
                rec = vol._dat.read_at(rec_size, e.byte_offset)
                if len(rec) < rec_size:
                    raise VolumeError(
                        f"short read replaying diff for needle "
                        f"{e.key}: {len(rec)} < {rec_size}")
                pos = nd.tell()
                if pos % NEEDLE_PADDING_SIZE:
                    pad = (-pos) % NEEDLE_PADDING_SIZE
                    nd.write(b"\x00" * pad)
                    pos += pad
                nd.write(rec)
                nx.write(IndexEntry(e.key, to_offset_units(pos),
                                    e.size).to_bytes())
        nd.flush()
        os.fsync(nd.fileno())
        nx.flush()
        os.fsync(nx.fileno())
    # Swap: close handles, rename .cpd/.cpx over .dat/.idx (dat
    # first; load-time checking tolerates a torn pair), reopen. The
    # renames are durable_replace — fsyncing the parent directory is
    # what persists the swap itself; without it a power cut after
    # "commit" could resurrect the garbage-laden pre-compact files.
    vol._dat.close()
    vol._idx.close()
    faults.check("crash.vacuum.precommit")
    try:
        durability.durable_replace(cpd_path(vol.base),
                                   dat_path(vol.base))
    except OSError:
        # Nothing swapped yet: reopen the untouched live files so the
        # volume stays serviceable; abort_compact discards .cpd/.cpx.
        # commit runs holding the vacuum_in_progress claim with
        # readers drained (swap-drain protocol above): exactly one
        # thread touches the handles
        # seaweedlint: disable=SW801 — swap-drain protocol
        vol._dat = backend_mod.open_backend(vol.backend_kind,
                                            dat_path(vol.base))
        # seaweedlint: disable=SW801 — same swap-drain protocol
        vol._idx = open(idx_path(vol.base), "a+b")
        raise
    faults.check("crash.vacuum.midcommit")
    try:
        durability.durable_replace(cpx_path(vol.base),
                                   idx_path(vol.base))
    except OSError:
        # Torn commit: the compacted .dat is live and .cpx is its only
        # index. Keep .cpx on disk (cleanup() preserves this state) and
        # take the volume out of service — the next load() installs it.
        vol._dat = vol._idx = None
        raise
    vol._dat = backend_mod.open_backend(vol.backend_kind,
                                        dat_path(vol.base))
    vol._idx = open(idx_path(vol.base), "a+b")
    vol.super_block = state.new_super
    if hasattr(vol.nm, "close"):
        vol.nm.close()
    # seaweedlint: disable=SW801 — same swap-drain protocol
    vol.nm = vol._load_needle_map()
    vol.vacuum_in_progress = False
    return vol._dat.size()


def cleanup(base: str | Path) -> None:
    """Remove leftover compact files (crash before commit).

    Unlink order matters: load() reads a ``.cpx``-present/``.cpd``-absent
    state as "crash between the commit renames" and installs the .cpx
    over the live .idx. Deleting .cpd first would make an interrupted
    cleanup fabricate exactly that state from a merely-aborted compaction
    — installing a STALE index over a valid one. Deleting .cpx first
    leaves at worst a .cpd-only state, which load() discards.

    And a genuinely torn commit must be preserved here, not cleaned:
    commit's first rename CONSUMES .cpd (``.cpd`` → ``.dat``), so a
    .cpx-present/.cpd-absent state proves the compacted .dat is already
    live and the .cpx is the only index matching it. An error-path
    abort_compact (e.g. the master's VacuumVolumeCleanup after a failed
    commit) deleting that .cpx would strand the new .dat with the stale
    pre-compact .idx — unrecoverable. Leave it for load() to finish."""
    cpx, cpd = cpx_path(base), cpd_path(base)
    if not cpd.exists():
        return  # nothing, or a torn commit whose .cpx load() will install
    if cpx.exists():
        cpx.unlink()
    cpd.unlink()


def abort_compact(vol: Volume) -> None:
    """Drop an in-flight compaction: delete its files, clear the
    in-progress flag (the VacuumVolumeCleanup rpc)."""
    cleanup(vol.base)
    vol.vacuum_in_progress = False


def vacuum(vol: Volume, threshold: float = 0.0) -> Optional[int]:
    """Compact + commit when garbage_ratio exceeds ``threshold``.
    Returns the new size, or None when below threshold (or when the
    volume is tiered read-only — the master's auto-scan must skip those
    silently, not error every pulse)."""
    if vol.readonly or garbage_ratio(vol) <= threshold:
        return None
    state = compact(vol)
    try:
        return commit_compact(vol, state)
    except BaseException:
        abort_compact(vol)
        raise
