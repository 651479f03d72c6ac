"""Silent-corruption defense: paced data scrubbing with quarantine
and auto-repair.

The port of ``seaweedfs_tpu/storage/scrubber.py``. Disks rot. A needle
whose body flips a bit after the write is acked passes every durability
barrier and sits undetected until a client read trips the CRC — possibly
years later, possibly after the last good replica has been rebalanced
away. This module walks the data at rest *proactively*:

- **Plain volumes** — every live needle record is re-read and
  CRC-verified (``Needle.parse`` runs the same checksum the read path
  does). A corrupt record's bytes are moved into a per-volume
  quarantine directory (``<base>.quarantine/``) for forensics, and
  when a fetcher for replica bytes is supplied the needle is repaired
  by re-appending the replica's raw record (``write_raw_record``) —
  the needle map flips to the fresh copy and the rotten bytes become
  ordinary vacuum garbage.

- **EC volumes** — each shard file carries a sha256 baseline in the
  ``<base>.scrub`` sidecar, established on the first scrub after a
  parity-consistency proof (reconstruct every non-source shard from
  ``k`` sources and compare — a rotten shard cannot pass; on the port,
  one GF(2^8) product per 4 MiB chunk through the codec of ``device``,
  which launches the card's kernel). Later scrubs hash-compare against
  the baseline: a mismatched shard is quarantined **by moving the file**
  (``rebuild_ec_files`` refuses to overwrite an existing shard) and
  rebuilt from the survivors, then re-verified against the baseline
  hash.

Scrubbing is paced: a token-bucket :class:`RatePacer` caps the byte
read rate (the ``[storage.scrub] rate_bytes_per_second`` the volume
server's ``-config`` sets through :func:`configure_from`, 8 MiB/s
unless set, or the rate the caller names) so a background scrub never
steals the disk from foreground reads. The cluster drives it through the
``scrub`` job (``cluster/jobs.py``). The counters go to :data:`METRICS`
(the ``seaweed_scrub_*`` family). A tiered read-only volume
(storage/tier.py) is scrubbed but never repaired in place.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..util import durability
from ..util.stats import Metrics
from . import ec_files
from . import needle as needle_mod

_log = logging.getLogger(__name__)

#: Rendered by the volume server's /metrics next to the store families.
METRICS = Metrics(namespace="seaweed")

#: Bytes hashed/reconstructed per EC verify step (also the pacer grain).
EC_CHUNK_BYTES = 4 * 1024 * 1024

#: The ``[storage.scrub] rate_bytes_per_second`` default (the JAX
#: package's).
DEFAULT_RATE_BYTES_PER_SECOND = 8 * 1024 * 1024
_RATE_BYTES_PER_SECOND = DEFAULT_RATE_BYTES_PER_SECOND


def configure(rate_bytes_per_second: Optional[int] = None) -> None:
    global _RATE_BYTES_PER_SECOND
    if rate_bytes_per_second is not None:
        _RATE_BYTES_PER_SECOND = int(rate_bytes_per_second)


def configure_from(conf: dict) -> None:
    """Apply a ``[storage.scrub]`` config-file section."""
    s = conf.get("storage") if isinstance(conf, dict) else None
    sc = s.get("scrub") if isinstance(s, dict) else None
    if isinstance(sc, dict):
        configure(rate_bytes_per_second=sc.get("rate_bytes_per_second"))


def configured_rate() -> int:
    return _RATE_BYTES_PER_SECOND


class RatePacer:
    """Token bucket over bytes: ``take(n)`` blocks until the scrub may
    read another ``n`` bytes. Capacity is one second of budget so a
    scrub that falls behind (slow CRC pass) bursts back to the target
    rate without ever exceeding it on average; ``rate <= 0`` disables
    pacing (tests, explicit full-speed runs)."""

    def __init__(self, bytes_per_second: Optional[int] = None,
                 clock=time.monotonic, sleep=time.sleep):
        self.rate = (_RATE_BYTES_PER_SECOND if bytes_per_second is None
                     else int(bytes_per_second))
        self._clock = clock
        self._sleep = sleep
        self._tokens = float(max(self.rate, 0))
        self._last = clock()
        self.slept_seconds = 0.0

    def take(self, n: int) -> None:
        if self.rate <= 0 or n <= 0:
            return
        now = self._clock()
        self._tokens = min(float(self.rate),
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        self._tokens -= n
        if self._tokens < 0:
            wait = -self._tokens / self.rate
            self.slept_seconds += wait
            self._sleep(wait)
            self._last = self._clock()


# ---------------------------------------------------------------------------
# per-volume scrub state sidecar
# ---------------------------------------------------------------------------


def state_path(base: str | Path) -> Path:
    return Path(str(base) + ".scrub")


def quarantine_dir(base: str | Path) -> Path:
    return Path(str(base) + ".quarantine")


def load_state(base: str | Path) -> dict:
    try:
        with open(state_path(base), "rb") as f:
            d = json.loads(f.read() or b"{}")
            return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def save_state(base: str | Path, state: dict) -> None:
    """Durable sidecar write: tmp + fsync + rename into place (the
    startup orphan sweep reclaims a ``.tmp`` left by a crash here)."""
    p = state_path(base)
    tmp = Path(str(p) + ".tmp")
    with open(tmp, "wb") as f:
        f.write(json.dumps(state, indent=1, sort_keys=True).encode())
    durability.durable_replace(tmp, p)


def _quarantine_blob(base: str | Path, name: str, data: bytes) -> Path:
    qdir = quarantine_dir(base)
    qdir.mkdir(exist_ok=True)
    dest = qdir / name
    with open(dest, "wb") as f:
        f.write(data)
    METRICS.counter("scrub_quarantined_total").inc()
    return dest


def _quarantine_file(base: str | Path, path: Path) -> Path:
    qdir = quarantine_dir(base)
    qdir.mkdir(exist_ok=True)
    dest = qdir / path.name
    # plain rename, deliberately NOT durable_replace: quarantine is
    # forensic best-effort, and the source file is corrupt anyway
    os.replace(path, dest)  # seaweedlint: disable=SW901 — forensic move of corrupt bytes, not a commit point
    METRICS.counter("scrub_quarantined_total").inc()
    return dest


# ---------------------------------------------------------------------------
# plain-volume scrub
# ---------------------------------------------------------------------------


def scrub_volume(vol, pacer: Optional[RatePacer] = None,
                 fetch_record: Optional[Callable[[int],
                                                 Optional[bytes]]] = None,
                 progress: Optional[Callable[[float], None]] = None
                 ) -> dict:
    """Walk every live needle of ``vol``, CRC-verifying the on-disk
    record. Corrupt records are quarantined; when ``fetch_record(key)``
    can produce replica bytes for the needle, the record is repaired by
    re-append and re-verified. Returns a result dict (also folded into
    the ``<base>.scrub`` sidecar)."""
    version = vol.super_block.version
    entries = vol.nm.live_entries()
    res = {"checked": 0, "bytes": 0, "corrupt": 0, "repaired": 0,
           "repair_failed": 0, "quarantined": []}
    for i, e in enumerate(entries):
        rec_len = needle_mod.record_size(e.size, version)
        if pacer is not None:
            pacer.take(rec_len)
        try:
            rec, _off = vol.read_record(e.key)
        except KeyError:  # seaweedlint: disable=SW301 — needle deleted between snapshot and read
            continue      # deleted between snapshot and read
        res["checked"] += 1
        res["bytes"] += len(rec)
        METRICS.counter("scrub_needles_total").inc()
        METRICS.counter("scrub_bytes_total", kind="needle").inc(len(rec))
        ok = False
        try:
            n = needle_mod.Needle.parse(rec, version)
            ok = n.id == e.key
        except needle_mod.NeedleError:
            ok = False
        if ok:
            if progress is not None and len(entries):
                progress((i + 1) / len(entries))
            continue
        res["corrupt"] += 1
        METRICS.counter("scrub_corrupt_total", kind="needle").inc()
        q = _quarantine_blob(
            vol.base, f"needle-{vol.volume_id}-{e.key}.rec", rec)
        res["quarantined"].append(str(q))
        _log.warning("scrub: volume %d needle %d failed CRC "
                     "(%d bytes quarantined to %s)", vol.volume_id,
                     e.key, len(rec), q)
        repaired = False
        if fetch_record is not None and not vol.readonly:
            good = None
            try:
                good = fetch_record(e.key)
            except Exception as err:  # noqa: BLE001 — repair is best-effort
                _log.warning("scrub: replica fetch for needle %d "
                             "failed: %s", e.key, err)
            if good:
                try:
                    # verify the replica's bytes BEFORE trusting them
                    needle_mod.Needle.parse(good, version)
                    vol.write_raw_record(good)
                    # prove the repair: the map now points at the
                    # fresh copy and it parses clean
                    rec2, _ = vol.read_record(e.key)
                    needle_mod.Needle.parse(rec2, version)
                    repaired = True
                except Exception as err:  # noqa: BLE001 — NeedleError included
                    _log.warning("scrub: repair of needle %d failed: "
                                 "%s", e.key, err)
        if repaired:
            res["repaired"] += 1
            METRICS.counter("scrub_repaired_total", kind="needle").inc()
            _log.info("scrub: volume %d needle %d repaired from "
                      "replica", vol.volume_id, e.key)
        else:
            res["repair_failed"] += 1
            METRICS.counter("scrub_repair_failed_total",
                            kind="needle").inc()
        if progress is not None and len(entries):
            progress((i + 1) / len(entries))
    st = load_state(vol.base)
    st["volume"] = {"last_scrub_unix": time.time(),
                    "checked": res["checked"], "bytes": res["bytes"],
                    "corrupt": res["corrupt"],
                    "repaired": res["repaired"]}
    save_state(vol.base, st)
    METRICS.gauge("scrub_last_run_unix").set(time.time())
    return res


# ---------------------------------------------------------------------------
# EC shard scrub
# ---------------------------------------------------------------------------


def _hash_shard(path: Path, pacer: Optional[RatePacer]) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(EC_CHUNK_BYTES)
            if not chunk:
                break
            if pacer is not None:
                pacer.take(len(chunk))
            h.update(chunk)
            METRICS.counter("scrub_bytes_total", kind="ec").inc(
                len(chunk))
    return h.hexdigest()


def _parity_consistent(base, scheme, present: list[int],
                       pacer: Optional[RatePacer], device=None) -> bool:
    """Baseline bootstrap proof: reconstruct every present shard
    outside the first-``k`` source set from the sources and compare
    bytes. Any rot in sources or targets breaks the equality (RS words
    mix every source into every target), so a True here certifies the
    whole present set. One ``(1, k, 4 MiB)`` product per chunk on
    ``device`` (None = the card)."""
    k = scheme.data_shards
    sources = present[:k]
    targets = [i for i in present if i not in sources]
    if not targets:
        return True       # nothing to cross-check against
    size = ec_files.shard_path(base, sources[0]).stat().st_size
    enc = scheme.encoder(device)
    pos = 0
    with _open_shards(base, sources) as src_fds:
        while pos < size:
            take = min(EC_CHUNK_BYTES, size - pos)
            if pacer is not None:
                pacer.take((len(sources) + len(targets)) * take)
            buf = np.empty((1, k, take), dtype=np.uint8)
            for s, fd in enumerate(src_fds):
                got = os.pread(fd, take, pos)
                if len(got) != take:
                    return False
                buf[0, s, :] = np.frombuffer(got, dtype=np.uint8)
            out = np.asarray(
                enc.reconstruct_batch_host(buf, sources, targets))
            for t, sid in enumerate(targets):
                with open(ec_files.shard_path(base, sid), "rb") as f:
                    f.seek(pos)
                    disk = f.read(take)
                if disk != bytes(out[0, t, :take].tobytes()):
                    return False
            pos += take
    return True


class _open_shards:
    def __init__(self, base, ids):
        self.paths = [ec_files.shard_path(base, i) for i in ids]
        self.fds: list[int] = []

    def __enter__(self):
        for p in self.paths:
            self.fds.append(os.open(p, os.O_RDONLY))
        return self.fds

    def __exit__(self, *exc):
        for fd in self.fds:
            try:
                os.close(fd)
            except OSError:  # seaweedlint: disable=SW301 — best-effort close-all
                pass


def scrub_ec(base: str | Path, scheme, pacer: Optional[RatePacer] = None,
             repair: bool = True,
             progress: Optional[Callable[[float], None]] = None,
             device=None) -> dict:
    """Verify the EC shards of ``base`` against their sha256 baseline
    (establishing it under a parity-consistency proof on first scrub).
    Mismatched shards are quarantined by move and rebuilt from the
    survivors when ``repair`` and at least ``k`` clean shards remain.
    The proof and the rebuild run on ``device`` (None = the card;
    raises when there is none)."""
    scheme.encoder(device)    # no card: refuse before touching a file
    base = Path(base)
    present = ec_files.present_shards(base, scheme.total_shards)
    res = {"shards": len(present), "corrupt": 0, "repaired": 0,
           "repair_failed": 0, "baseline": False, "quarantined": []}
    if not present:
        return res
    st = load_state(base)
    baseline = st.get("shard_sha256")
    hashes = {}
    for i, sid in enumerate(present):
        hashes[sid] = _hash_shard(ec_files.shard_path(base, sid), pacer)
        METRICS.counter("scrub_shards_total").inc()
        if progress is not None:
            progress(0.8 * (i + 1) / len(present))
    if not isinstance(baseline, dict) or not baseline:
        if _parity_consistent(base, scheme, present, pacer, device):
            st["shard_sha256"] = {str(s): h for s, h in hashes.items()}
            st["ec"] = {"last_scrub_unix": time.time(),
                        "shards": len(present), "corrupt": 0}
            save_state(base, st)
            res["baseline"] = True
        else:
            # rot before any baseline existed: every shard is suspect
            # and none can be singled out — report, never guess.
            res["corrupt"] = -1
            METRICS.counter("scrub_corrupt_total",
                            kind="ec_unattributed").inc()
            _log.error("scrub: EC volume %s parity-inconsistent with "
                       "no baseline; manual repair required", base)
        METRICS.gauge("scrub_last_run_unix").set(time.time())
        return res
    bad = [sid for sid in present
           if baseline.get(str(sid)) not in (None, hashes[sid])]
    for sid in bad:
        res["corrupt"] += 1
        METRICS.counter("scrub_corrupt_total", kind="ec").inc()
        q = _quarantine_file(base, ec_files.shard_path(base, sid))
        res["quarantined"].append(str(q))
        _log.warning("scrub: EC volume %s shard %d sha256 mismatch "
                     "(quarantined to %s)", base, sid, q)
        if not repair:
            res["repair_failed"] += 1
            continue
        try:
            from ..pipeline.rebuild import rebuild_ec_files
            rebuild_ec_files(base, scheme, wanted=[sid], device=device)
            rebuilt = _hash_shard(ec_files.shard_path(base, sid), pacer)
            if rebuilt != baseline.get(str(sid)):
                raise RuntimeError(
                    f"rebuilt shard {sid} hash {rebuilt[:12]} != "
                    f"baseline {str(baseline.get(str(sid)))[:12]}")
            res["repaired"] += 1
            METRICS.counter("scrub_repaired_total", kind="ec").inc()
            _log.info("scrub: EC volume %s shard %d rebuilt and "
                      "verified against baseline", base, sid)
        except Exception as err:  # noqa: BLE001 — keep scrubbing other shards
            res["repair_failed"] += 1
            METRICS.counter("scrub_repair_failed_total", kind="ec").inc()
            _log.error("scrub: EC volume %s shard %d rebuild failed: "
                       "%s", base, sid, err)
    # fold shards that joined since the baseline (e.g. rebuilt
    # elsewhere) into it so the next scrub covers them too
    for sid, h in hashes.items():
        if sid not in bad:
            st["shard_sha256"][str(sid)] = h
    st["ec"] = {"last_scrub_unix": time.time(), "shards": len(present),
                "corrupt": res["corrupt"],
                "repaired": res["repaired"]}
    save_state(base, st)
    METRICS.gauge("scrub_last_run_unix").set(time.time())
    if progress is not None:
        progress(1.0)
    return res


def debug_payload() -> dict:
    return {"rate_bytes_per_second": _RATE_BYTES_PER_SECOND}
