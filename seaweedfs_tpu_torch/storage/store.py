"""Store: disk locations, the volume registry, and EC shard mounts.

The port of ``seaweedfs_tpu/storage/store.py`` (weed/storage/store.go +
disk_location.go + store_ec.go): a Store owns one or more directories
("disk locations"), each holding normal volumes (<base>.dat/.idx) and
mounted EC shards (<base>.ec??/.ecx). The offline admin shell drives
every operation through this object; ``status()`` is the snapshot a
heartbeat would carry; ``garbage_ratio`` / ``vacuum_volume`` compact a
volume (storage/vacuum.py). Not ported yet (ROADMAP Queue 1): the S3
tier moves (``tier_move`` / ``tier_restore``).

Volume base naming follows the reference: ``<vid>`` or
``<collection>_<vid>`` inside the location directory.
"""

from __future__ import annotations

import logging
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

from . import ec_files
from .needle import Needle
from .superblock import ReplicaPlacement, SuperBlock, Ttl
from .volume import Volume, dat_path, idx_path, tier_path

_log = logging.getLogger(__name__)
_BASE_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)$")


class StoreError(RuntimeError):
    pass


def volume_base_name(volume_id: int, collection: str = "") -> str:
    return f"{collection}_{volume_id}" if collection else str(volume_id)


def parse_base_name(stem: str) -> tuple[str, int]:
    """'<collection>_<vid>' / '<vid>' -> (collection, vid)."""
    m = _BASE_RE.match(stem)
    if not m:
        raise ValueError(f"not a volume base name: {stem!r}")
    return m.group("col") or "", int(m.group("vid"))


@dataclass
class EcVolumeMount:
    """Local mount state of one EC volume: which shard files this store
    serves (ec_volume.go EcVolume, minus the remote-peer logic that lives
    in the server layer)."""

    base: Path
    collection: str
    volume_id: int
    shard_ids: set[int] = field(default_factory=set)

    @property
    def shard_bits(self) -> ec_files.ShardBits:
        return ec_files.ShardBits.from_ids(sorted(self.shard_ids))


class DiskLocation:
    """One directory of volume/shard files (disk_location.go)."""

    def __init__(self, directory: str | Path, max_volumes: int = 8):
        self.directory = Path(directory)
        self.max_volumes = max_volumes
        if not self.directory.is_dir():
            raise StoreError(f"{self.directory} is not a directory")

    def base_for(self, volume_id: int, collection: str = "") -> Path:
        return self.directory / volume_base_name(volume_id, collection)

    def scan_volumes(self) -> Iterator[tuple[str, int, Path]]:
        """Yield (collection, vid, base) for every <base>.dat present —
        and every .tier sidecar (an S3-tiered volume may have no local
        .dat; Volume.load refuses it rather than skip it silently)."""
        seen = set()
        for p in sorted(self.directory.glob("*.dat")) + \
                sorted(self.directory.glob("*.tier")):
            try:
                col, vid = parse_base_name(p.stem)
            except ValueError:
                continue
            if (col, vid) in seen:
                continue
            seen.add((col, vid))
            yield col, vid, p.with_suffix("")

    def scan_ec_shards(self) -> Iterator[tuple[str, int, Path, list[int]]]:
        """Yield (collection, vid, base, shard_ids) for bases that have at
        least one .ec?? file AND a .ecx index."""
        seen: dict[Path, list[int]] = {}
        for p in sorted(self.directory.iterdir()):
            m = re.match(r"^\.ec(\d\d)$", p.suffix)
            if not m:
                continue
            seen.setdefault(p.with_suffix(""), []).append(int(m.group(1)))
        for base, ids in seen.items():
            if not ec_files.ecx_path(base).exists():
                continue
            try:
                col, vid = parse_base_name(base.name)
            except ValueError:
                continue
            yield col, vid, base, sorted(ids)


class Store:
    """The storage engine facade the volume server drives (store.go)."""

    def __init__(self, locations: list[str | Path],
                 max_volumes: int = 8, backend: str = "disk",
                 needle_map: str = "memory"):
        if not locations:
            raise StoreError("a store needs at least one disk location")
        self.locations = [DiskLocation(d, max_volumes) for d in locations]
        #: .dat backend kind (storage/backend.py registry) and needle
        #: map kind ("memory" | "native" | "sqlite") applied to every
        #: volume.
        self.backend = backend
        self.needle_map = needle_map
        self.volumes: dict[tuple[str, int], Volume] = {}
        self.ec_mounts: dict[tuple[str, int], EcVolumeMount] = {}
        self.readonly: set[tuple[str, int]] = set()
        # Guards the three registry maps above — and ONLY them. Admin
        # threads mount/unmount/delete while another snapshots status()
        # and flips readonly marks; all volume I/O (load/create/close/
        # stat) stays OUTSIDE the lock so a slow disk can never stall a
        # snapshot.
        self._lock = threading.RLock()

    # -- lifecycle --------------------------------------------------------

    def load_existing(self) -> None:
        """Scan every location and open what's on disk (volume_loading.go;
        EC shards found with their .ecx are auto-mounted the way the
        reference remounts shards on restart). Before opening anything,
        sweep orphaned transfer temporaries — ``.part`` streams (tier
        downloads, replica copies killed mid-transfer) and ``.tmp``
        sidecar writes — whose rename commit point never ran; they are
        garbage by construction (the commit is the rename) and a later
        transfer restarts from scratch."""
        for loc in self.locations:
            removed = 0
            for pattern in ("*.part", "*.tmp"):
                for orphan in loc.directory.glob(pattern):
                    orphan.unlink(missing_ok=True)
                    removed += 1
            if removed:
                _log.info("store: removed %d orphaned transfer "
                          "temporaries under %s", removed, loc.directory)
            for col, vid, base in loc.scan_volumes():
                if (col, vid) not in self.volumes:
                    vol = Volume(base, vid, backend=self.backend,
                                 needle_map=self.needle_map).load()
                    with self._lock:
                        self.volumes[(col, vid)] = vol
            for col, vid, base, ids in loc.scan_ec_shards():
                with self._lock:
                    m = self.ec_mounts.setdefault(
                        (col, vid), EcVolumeMount(base, col, vid))
                    m.shard_ids.update(ids)

    def close(self) -> None:
        for v in list(self.volumes.values()):
            v.close()
        with self._lock:
            self.volumes.clear()
            self.ec_mounts.clear()

    def _pick_location(self) -> DiskLocation:
        """Least-loaded location with free volume slots."""
        def load(loc: DiskLocation) -> int:
            return sum(1 for v in self.volumes.values()
                       if v.base.parent == loc.directory)
        candidates = [l for l in self.locations
                      if load(l) < l.max_volumes]
        if not candidates:
            raise StoreError("no disk location has free volume slots")
        return min(candidates, key=load)

    # -- normal volumes ---------------------------------------------------

    def create_volume(self, volume_id: int, collection: str = "",
                      replica_placement: str = "000", ttl: str = "",
                      version: int = 3) -> Volume:
        key = (collection, volume_id)
        if key in self.volumes:
            raise StoreError(f"volume {volume_id} already exists")
        loc = self._pick_location()
        sb = SuperBlock(
            version=version,
            replica_placement=ReplicaPlacement.parse(replica_placement),
            ttl=Ttl.parse(ttl))
        vol = Volume(loc.base_for(volume_id, collection), volume_id,
                     sb, backend=self.backend,
                     needle_map=self.needle_map).create()
        with self._lock:
            self.volumes[key] = vol
        return vol

    def get_volume(self, volume_id: int, collection: str = "") -> Volume:
        try:
            return self.volumes[(collection, volume_id)]
        except KeyError:
            raise StoreError(f"volume {volume_id} not found") from None

    def has_volume(self, volume_id: int, collection: str = "") -> bool:
        return (collection, volume_id) in self.volumes

    def mark_readonly(self, volume_id: int, collection: str = "") -> None:
        """VolumeMarkReadonly: freeze writes ahead of ec.encode."""
        self.get_volume(volume_id, collection)  # must exist
        with self._lock:
            self.readonly.add((collection, volume_id))

    def mark_writable(self, volume_id: int, collection: str = "") -> None:
        """VolumeMarkWritable: undo a freeze (balance rollback path)."""
        self.get_volume(volume_id, collection)  # must exist
        with self._lock:
            self.readonly.discard((collection, volume_id))

    def is_readonly(self, volume_id: int, collection: str = "") -> bool:
        return (collection, volume_id) in self.readonly

    def unmount_volume(self, volume_id: int,
                       collection: str = "") -> None:
        """Stop serving a volume but KEEP its files (the reference's
        VolumeUnmount): the maintenance verb for moving a volume
        directory by hand or freezing it for external tooling."""
        vol = self.get_volume(volume_id, collection)
        vol.close()
        with self._lock:
            self.volumes.pop((collection, volume_id), None)
        # the readonly mark is deliberately KEPT: an operator (or the
        # ec.encode/move choreography) that froze the volume must not
        # find it silently writable again after an unmount/mount cycle

    def mount_volume(self, volume_id: int,
                     collection: str = "") -> None:
        """(Re)open a volume whose files are already in a location
        (VolumeMount): the inverse of unmount_volume."""
        if (collection, volume_id) in self.volumes:
            return
        for loc in self.locations:
            base = loc.directory / volume_base_name(volume_id,
                                                    collection)
            if dat_path(base).exists() or tier_path(base).exists():
                # a tiered volume is found here and refused by load()
                vol = Volume(base, volume_id, backend=self.backend,
                             needle_map=self.needle_map).load()
                with self._lock:
                    self.volumes[(collection, volume_id)] = vol
                return
        raise StoreError(
            f"no files for volume {volume_id} "
            f"(collection {collection!r}) in any location")

    def delete_volume(self, volume_id: int, collection: str = "") -> None:
        """Drop the .dat/.idx (ec.encode's final step deletes the source
        volume this way)."""
        vol = self.get_volume(volume_id, collection)
        vol.close()
        with self._lock:
            self.volumes.pop((collection, volume_id), None)
            self.readonly.discard((collection, volume_id))
        # .sdx goes too: a leftover sqlite map would resurrect phantom
        # index entries if the volume id is ever re-allocated.
        for p in (dat_path(vol.base), idx_path(vol.base),
                  Path(str(vol.base) + ".sdx")):
            if p.exists():
                p.unlink()

    # -- vacuum -----------------------------------------------------------

    def garbage_ratio(self, volume_id: int, collection: str = ""
                      ) -> float:
        from . import vacuum as vacuum_mod
        return vacuum_mod.garbage_ratio(
            self.get_volume(volume_id, collection))

    def vacuum_volume(self, volume_id: int, collection: str = "",
                      threshold: float = 0.0):
        """Compact away deleted needles when garbage exceeds
        ``threshold`` (volume_vacuum.go Compact + CommitCompact).
        Returns the new .dat size, or None when below threshold."""
        from . import vacuum as vacuum_mod
        return vacuum_mod.vacuum(self.get_volume(volume_id, collection),
                                 threshold)

    # -- data plane -------------------------------------------------------

    def configure_replication(self, volume_id: int,
                              replication: str,
                              collection: str = "") -> None:
        self.get_volume(volume_id, collection).configure_replication(
            replication)

    def write_needle(self, volume_id: int, n: Needle,
                     collection: str = "") -> int:
        if self.is_readonly(volume_id, collection):
            raise StoreError(f"volume {volume_id} is read-only")
        return self.get_volume(volume_id, collection).write_needle(n)

    def read_needle(self, volume_id: int, key: int,
                    cookie: Optional[int] = None,
                    collection: str = "") -> Needle:
        return self.get_volume(volume_id, collection).read_needle(
            key, cookie)

    def delete_needle(self, volume_id: int, key: int,
                      collection: str = "") -> bool:
        # A read-only volume takes no delete either: ec.encode freezes
        # the volume before it seals, and a tombstone journaled after
        # the seal would never reach the .ecx (the reference refuses it
        # too; the JAX package's Store does not, ROADMAP Queue 3).
        if self.is_readonly(volume_id, collection):
            raise StoreError(f"volume {volume_id} is read-only")
        return self.get_volume(volume_id, collection).delete_needle(key)

    # -- EC shards --------------------------------------------------------

    def ec_base(self, volume_id: int, collection: str = ""
                ) -> Optional[Path]:
        m = self.ec_mounts.get((collection, volume_id))
        if m is not None:
            return m.base
        for loc in self.locations:
            base = loc.base_for(volume_id, collection)
            if ec_files.ecx_path(base).exists():
                return base
        return None

    def ec_shard_paths(self, volume_id: int, collection: str = ""
                       ) -> dict[int, Path]:
        """shard_id -> file path, looking across ALL disk locations (the
        local-mode analog of asking the master where shards live)."""
        name = volume_base_name(volume_id, collection)
        out: dict[int, Path] = {}
        for loc in self.locations:
            base = loc.directory / name
            for i in ec_files.present_shards(base, 100):
                out.setdefault(i, ec_files.shard_path(base, i))
        return out

    def gather_ec_volume(self, volume_id: int, collection: str = ""
                         ) -> Path:
        """Make every shard of an EC volume reachable under ONE base path
        by symlinking siblings from other locations — the local-mode form
        of ec.rebuild's 'copy missing sibling shards local' step
        (§3.5) before Reconstruct runs. Returns that base."""
        base = self.ec_base(volume_id, collection)
        if base is None:
            raise StoreError(f"no EC volume {volume_id}")
        for sid, path in self.ec_shard_paths(volume_id, collection).items():
            local = ec_files.shard_path(base, sid)
            if not local.exists():
                if local.is_symlink():  # stale/broken link
                    local.unlink()
                # absolute target: a relative one would resolve against
                # the location directory and dangle
                local.symlink_to(path.resolve())
        # the delete journal and volume info may live beside a moved shard
        name = volume_base_name(volume_id, collection)
        for pathfn in (ec_files.ecj_path, ec_files.vif_path):
            local = pathfn(base)
            if local.exists():
                continue
            if local.is_symlink():
                local.unlink()
            for loc in self.locations:
                other = pathfn(loc.directory / name)
                if other.exists() and other.resolve() != local.resolve():
                    local.symlink_to(other.resolve())
                    break
        return base

    def remove_ec_volume_files(self, volume_id: int, collection: str = ""
                               ) -> None:
        """Delete every EC artifact of a volume in every location
        (symlinks and real files both)."""
        name = volume_base_name(volume_id, collection)
        for loc in self.locations:
            base = loc.directory / name
            for i in range(100):
                p = ec_files.shard_path(base, i)
                if p.exists() or p.is_symlink():
                    p.unlink()
            for p in (ec_files.ecx_path(base), ec_files.ecj_path(base),
                      ec_files.vif_path(base)):
                if p.exists() or p.is_symlink():
                    p.unlink()

    def mount_ec_shards(self, volume_id: int, shard_ids: list[int],
                        collection: str = "") -> EcVolumeMount:
        """VolumeEcShardsMount: register local shard files for serving."""
        base = self.ec_base(volume_id, collection)
        if base is None:
            raise StoreError(
                f"no .ecx for volume {volume_id} in any location")
        missing = [i for i in shard_ids
                   if not ec_files.shard_path(base, i).exists()]
        if missing:
            raise StoreError(
                f"shard files missing for volume {volume_id}: {missing}")
        with self._lock:
            m = self.ec_mounts.setdefault(
                (collection, volume_id),
                EcVolumeMount(base, collection, volume_id))
            m.shard_ids.update(shard_ids)
        return m

    def unmount_ec_shards(self, volume_id: int, shard_ids: list[int],
                          collection: str = "") -> None:
        with self._lock:
            m = self.ec_mounts.get((collection, volume_id))
            if m is None:
                return
            m.shard_ids.difference_update(shard_ids)
            if not m.shard_ids:
                del self.ec_mounts[(collection, volume_id)]

    # -- status / heartbeat ----------------------------------------------

    def reconcile_ec_shards(self) -> None:
        """Heartbeat-path self-heal: align EC mounts with DISK REALITY
        so shard files lost underneath a running server (disk fault,
        operator rm) drop out of the next snapshot — the master's
        topology, ec.rebuild's missing-shard view, and peers' read
        routing stay truthful instead of trusting a stale mount table.

        Called from the heartbeat loop only (never from read-only
        snapshots like volume.list): one directory scan per location
        per pulse, shards counted present if ANY location holds them
        (ec.balance moves shards between locations without updating
        the mount base). Defensive pops: admin RPC threads mutate the
        mount table concurrently."""
        reality: dict[tuple[str, int], set] = {}
        for loc in self.locations:
            for col, vid, _base, ids in loc.scan_ec_shards():
                reality.setdefault((col, vid), set()).update(ids)
        for key in list(self.ec_mounts):
            m = self.ec_mounts.get(key)
            if m is None:
                continue
            present = reality.get(key, set())
            gone = sorted(set(m.shard_ids) - present)
            if not gone:
                continue
            _log.warning(
                "volume %d: ec shard file(s) %s vanished from disk; "
                "unmounting them", key[1], gone)
            with self._lock:
                m.shard_ids.intersection_update(present)
                if not m.shard_ids:
                    self.ec_mounts.pop(key, None)

    def status(self) -> dict:
        """Snapshot for heartbeats and ``volume.list``: normal volumes +
        EC shard bits, the payload SendHeartbeat streams to a master."""
        # snapshot under the registry lock; the per-volume stat() I/O
        # below runs on the copy so a slow disk can't block mounts
        with self._lock:
            vol_items = sorted(self.volumes.items())
            readonly = set(self.readonly)
            ec = [{"id": vid, "collection": col,
                   "ec_index_bits": m.shard_bits.bits}
                  for (col, vid), m in sorted(self.ec_mounts.items())]
        vols = []
        for (col, vid), v in vol_items:
            try:
                modified = int(dat_path(v.base).stat().st_mtime)
            except OSError:
                modified = 0
            vols.append({
                "id": vid, "collection": col,
                "size": v.dat_size, "file_count": v.nm.file_count,
                "deleted_count": v.nm.deleted_count,
                "deleted_bytes": v.nm.deleted_bytes,
                "read_only": (col, vid) in readonly,
                "replica_placement": str(v.super_block.replica_placement),
                "version": v.super_block.version,
                "ttl": str(v.super_block.ttl),
                "modified_at_second": modified,
            })
        return {"volumes": vols, "ec_shards": ec}
