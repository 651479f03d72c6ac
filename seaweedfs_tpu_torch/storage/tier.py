"""S3-tier volume backend (weed/storage/backend s3_backend +
weed/shell command_volume_tier_upload.go / _download.go analogs).

A SEALED volume's ``.dat`` moves to an S3 endpoint — for example the
project's own S3 gateway (gateway/s3.py), so the whole tier is testable
in one process — while the hot index (.idx)
stays local, which is the reference's tiering split: cold data bytes
remote, needle lookups local. A ``<base>.tier`` JSON sidecar records
where the bytes live; ``Volume.load`` sees the sidecar (with no local
``.dat``) and opens an :class:`S3TierFile`, after which every needle
read becomes an HTTP range GET through a small block cache. Tiered
volumes are read-only, exactly like the reference's tiered volumes
(writes require ``volume.tier.download`` first).

The block cache uses large (1 MiB) aligned blocks, so a scan of a
tiered volume hits the gateway with a few big sequential ranges (what an
object store is good at) rather than one request per needle.

The port of ``seaweedfs_tpu/storage/tier.py``, whole. The sidecar's JSON
is the JAX package's, so either package opens the other's tiered volume.
Credentials never enter the sidecar; the port reads them from
``SEAWEEDFS_TORCH_TIER_ACCESS_KEY`` / ``SEAWEEDFS_TORCH_TIER_SECRET_KEY``
(the JAX package's are named ``SEAWEEDFS_TPU_TIER_*``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import urllib.error
import urllib.request
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional

from ..util import durability, faults, retry

TIER_SUFFIX = ".tier"
BLOCK = 1024 * 1024
MAX_CACHED_BLOCKS = 64


class TierError(RuntimeError):
    pass


@dataclass
class TierInfo:
    """Sidecar contents: where the .dat bytes live (the reference's
    VolumeInfo.files[].backend_name + key, master_pb VolumeTierInfo)."""

    endpoint: str          # http(s)://host:port
    bucket: str
    key: str
    size: int
    access_key: str = ""
    secret_key: str = ""
    region: str = "us-east-1"

    @staticmethod
    def path_for(base: str | Path) -> Path:
        return Path(str(base) + TIER_SUFFIX)

    def save(self, base: str | Path) -> None:
        """Persist WITHOUT credentials: the sidecar sits in the data
        directory (readable by backups etc.); keys are resolved at load
        time from the environment (SEAWEEDFS_TORCH_TIER_ACCESS_KEY /
        _SECRET_KEY), matching the reference's config-not-data-file
        placement of backend credentials."""
        p = self.path_for(base)
        tmp = p.with_suffix(p.suffix + ".tmp")
        d = asdict(self)
        d.pop("access_key", None)
        d.pop("secret_key", None)
        tmp.write_text(json.dumps(d, indent=1))
        os.chmod(tmp, 0o600)
        # durable rename: the sidecar is the marker that the S3 copy is
        # authoritative — losing it to a power cut while keeping the
        # (possibly stale-tracked) local .dat would fork the truth
        durability.durable_replace(tmp, p)

    @classmethod
    def maybe_load(cls, base: str | Path) -> Optional["TierInfo"]:
        p = cls.path_for(base)
        if not p.exists():
            return None
        try:
            info = cls(**json.loads(p.read_text()))
        except (ValueError, TypeError) as e:
            raise TierError(f"corrupt tier sidecar {p}: {e}") from e
        if not info.access_key:
            info.access_key = os.environ.get(
                "SEAWEEDFS_TORCH_TIER_ACCESS_KEY", "")
            info.secret_key = os.environ.get(
                "SEAWEEDFS_TORCH_TIER_SECRET_KEY", "")
        return info


def _object_url(info: TierInfo) -> str:
    import urllib.parse as up

    ep = info.endpoint.rstrip("/")
    if "://" not in ep:
        ep = "http://" + ep
    return f"{ep}/{info.bucket}/{up.quote(info.key)}"


def _signed(info: TierInfo, method: str, url: str, headers: dict,
            body: bytes = b"") -> dict:
    if not info.access_key:
        return headers
    from ..gateway.s3_auth import sign_request_headers
    return sign_request_headers(method, url, headers, body,
                                info.access_key, info.secret_key,
                                region=info.region)


class S3TierFile:
    """Read-only BackendStorageFile over an S3 object (range GETs +
    block cache). Registered as backend kind "s3"; constructed from the
    ``.tier`` sidecar next to the (absent) ``.dat``."""

    def __init__(self, info: TierInfo, name: str = ""):
        self.info = info
        self.name = name or _object_url(info)
        #: offset-aligned block -> bytes, LRU by insertion refresh.
        #: Guarded by _cache_lock: read_at is called concurrently by
        #: volume-server reader threads (the Volume drops its lock for
        #: pread), and OrderedDict eviction racing move_to_end would
        #: KeyError. The ranged GET itself runs OUTSIDE the lock so a
        #: slow fetch doesn't serialize unrelated readers.
        self._cache: "collections.OrderedDict[int, bytes]" = \
            collections.OrderedDict()
        self._cache_lock = threading.Lock()

    @classmethod
    def from_dat_path(cls, path: str | Path,
                      create: bool = False) -> "S3TierFile":
        if create:
            raise TierError("cannot create a new volume on the s3 tier; "
                            "tier an existing sealed volume instead")
        base = str(path)
        if base.endswith(".dat"):
            base = base[:-4]
        info = TierInfo.maybe_load(base)
        if info is None:
            raise TierError(f"no {TIER_SUFFIX} sidecar for {path}")
        return cls(info, name=str(path))

    # -- reads ------------------------------------------------------------

    def _fetch(self, start: int, end: int) -> bytes:
        """One ranged GET of [start, end) from the object store."""
        url = _object_url(self.info)
        headers = {"Range": f"bytes={start}-{end - 1}"}
        try:
            return retry.http_request(
                url, headers=_signed(self.info, "GET", url, headers),
                point="tier.copy").data
        except urllib.error.HTTPError as e:
            raise TierError(
                f"s3 tier read {url} [{start}:{end}): "
                f"{e.code}") from e
        except urllib.error.URLError as e:
            raise TierError(f"s3 tier unreachable: {e}") from e

    def _block(self, bno: int) -> bytes:
        with self._cache_lock:
            blk = self._cache.get(bno)
            if blk is not None:
                self._cache.move_to_end(bno)
                return blk
        start = bno * BLOCK
        end = min(start + BLOCK, self.info.size)
        blk = self._fetch(start, end)  # outside the lock (slow I/O)
        with self._cache_lock:
            self._cache[bno] = blk
            while len(self._cache) > MAX_CACHED_BLOCKS:
                self._cache.popitem(last=False)
        return blk

    def read_at(self, size: int, offset: int) -> bytes:
        if offset >= self.info.size or size <= 0:
            return b""
        end = min(offset + size, self.info.size)
        parts = []
        pos = offset
        while pos < end:
            bno = pos // BLOCK
            blk = self._block(bno)
            lo = pos - bno * BLOCK
            hi = min(end - bno * BLOCK, len(blk))
            parts.append(blk[lo:hi])
            pos = bno * BLOCK + hi
            if hi <= lo:  # short object vs recorded size
                break
        return b"".join(parts)

    def size(self) -> int:
        return self.info.size

    # -- mutations: tiered volumes are sealed read-only -------------------

    def write_at(self, data: bytes, offset: int) -> int:
        raise TierError("tiered volume is read-only; "
                        "volume.tier.download it first")

    def append(self, data: bytes) -> int:
        raise TierError("tiered volume is read-only; "
                        "volume.tier.download it first")

    def truncate(self, size: int) -> None:
        raise TierError("tiered volume is read-only")

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        pass

    def close(self) -> None:
        self._cache.clear()


# -- tier movement (shell volume.tier.upload / .download) ------------------

def upload_volume_dat(base: str | Path, endpoint: str, bucket: str,
                      key: str = "", access_key: str = "",
                      secret_key: str = "", region: str = "us-east-1",
                      remove_local: bool = True,
                      chunk: int = 8 * 1024 * 1024) -> TierInfo:
    """Move ``<base>.dat`` to the S3 endpoint and write the sidecar.

    Upload is a single streamed PUT (the gateway accepts arbitrary
    sizes; multipart is unnecessary over loopback). With
    ``remove_local`` the local ``.dat`` is deleted after the sidecar is
    durably in place — crash between PUT and unlink leaves both copies,
    never neither."""
    base = str(base)
    dat = Path(base + ".dat")
    if not dat.exists():
        raise TierError(f"{dat} does not exist")
    size = dat.stat().st_size
    info = TierInfo(endpoint=endpoint, bucket=bucket,
                    key=key or (Path(base).name + ".dat"), size=size,
                    access_key=access_key, secret_key=secret_key,
                    region=region)
    url = _object_url(info)
    body = dat.read_bytes() if size <= chunk else None
    if body is not None:
        retry.http_request(url, data=body, method="PUT",
                           headers=_signed(info, "PUT", url, {}, body),
                           point="tier.copy", timeout=300)
    else:
        # stream from disk: urllib sends file-like bodies chunked; the
        # signature (when auth is on) must then be computed over the
        # full content, so large signed uploads buffer per-chunk via
        # multipart instead
        if info.access_key:
            _multipart_upload(info, dat, chunk)
        else:
            # file-like body: can't buffer through http_request (it
            # would defeat the streaming); fault point only
            faults.check("tier.copy")
            with open(dat, "rb") as f:
                req = urllib.request.Request(
                    url, data=f, method="PUT",
                    headers={"Content-Length": str(size)})
                with urllib.request.urlopen(req, timeout=3600):
                    pass
    info.save(base)
    if remove_local:
        dat.unlink()
    return info


def _multipart_upload(info: TierInfo, dat: Path, chunk: int) -> None:
    """SigV4 multipart upload through the gateway's multipart API."""
    import re

    base_url = _object_url(info)
    r = retry.http_request(
        base_url + "?uploads", method="POST",
        headers=_signed(info, "POST", base_url + "?uploads", {}),
        point="tier.copy", timeout=60)
    m = re.search(rb"<UploadId>([^<]+)</UploadId>", r.data)
    if not m:
        raise TierError("multipart initiate returned no UploadId")
    upload_id = m.group(1).decode()
    with open(dat, "rb") as f:
        part = 1
        while True:
            piece = f.read(chunk)
            if not piece:
                break
            url = f"{base_url}?partNumber={part}&uploadId={upload_id}"
            retry.http_request(
                url, data=piece, method="PUT",
                headers=_signed(info, "PUT", url, {}, piece),
                point="tier.copy", timeout=600)
            part += 1
    url = f"{base_url}?uploadId={upload_id}"
    retry.http_request(url, data=b"", method="POST",
                       headers=_signed(info, "POST", url, {}),
                       point="tier.copy", timeout=600)


def download_volume_dat(base: str | Path,
                        chunk: int = 8 * 1024 * 1024) -> None:
    """Bring a tiered ``.dat`` back to local disk and drop the sidecar
    (command_volume_tier_download.go): download to ``.dat.part``, fsync,
    rename, THEN remove the sidecar — a crash leaves a consistent state
    at every step."""
    base = str(base)
    info = TierInfo.maybe_load(base)
    if info is None:
        raise TierError(f"volume {base} is not tiered")
    dat = Path(base + ".dat")
    part = Path(base + ".dat.part")
    url = _object_url(info)
    # streamed to disk chunk-by-chunk: fault point only (buffering the
    # whole object through http_request would defeat the streaming)
    faults.check("tier.copy")
    req = urllib.request.Request(
        url, headers=_signed(info, "GET", url, {}), method="GET")
    with urllib.request.urlopen(req, timeout=3600) as r, \
            open(part, "wb") as f:
        while True:
            piece = r.read(chunk)
            if not piece:
                break
            f.write(piece)
        f.flush()
        os.fsync(f.fileno())
    got = part.stat().st_size
    if got != info.size:
        part.unlink()
        raise TierError(f"tier download size mismatch: got {got}, "
                        f"sidecar says {info.size}")
    faults.check("crash.tier.download")
    # already fsynced above; the parent-dir fsync in durable_replace is
    # what makes the rename itself survive power loss
    durability.durable_replace(part, dat, fsync_src=False)
    TierInfo.path_for(base).unlink()
