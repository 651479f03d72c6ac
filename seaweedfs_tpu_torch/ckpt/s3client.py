"""Minimal S3-gateway client for the checkpoint/dataloader plane.

Everything the checkpoint store needs from the gateway — bucket
ensure, object put/get/head/list/delete and RANGED get — over
``retry.http_request`` (breaker + deadline + jittered retries). The
client is deliberately unauthenticated: training jobs talk to an open or
VPC-internal gateway; SigV4 signing belongs to external tooling.

Every ranged read is recorded in :attr:`GatewayClient.ranges` — tests
assert from it that a restoring process touched ONLY its own shards'
byte ranges (the acceptance criterion is asserted, not assumed).

The port of ``seaweedfs_tpu/ckpt/s3client.py``, whole.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Optional

from ..util import retry

_XMLNS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


class GatewayError(Exception):
    """The gateway answered, but not with what the caller needed."""


class GatewayClient:
    """One S3 gateway endpoint (``host:port``)."""

    def __init__(self, gateway_url: str, timeout: float = 30.0):
        self.base = gateway_url if "://" in gateway_url \
            else f"http://{gateway_url}"
        self.timeout = float(timeout)
        #: every ranged GET issued: (bucket, key, offset, length)
        self.ranges: list[tuple[str, str, int, int]] = []
        self.stats = {"puts": 0, "gets": 0, "ranged_gets": 0,
                      "heads": 0, "lists": 0, "deletes": 0,
                      "bytes_out": 0, "bytes_in": 0}

    def _url(self, bucket: str, key: str = "") -> str:
        path = f"/{bucket}"
        if key:
            path += "/" + urllib.parse.quote(key)
        return self.base + path

    # ---- buckets ----

    def ensure_bucket(self, bucket: str) -> None:
        try:
            retry.http_request(self._url(bucket), b"", "PUT",
                               point="ckpt.bucket",
                               timeout=self.timeout)
        except urllib.error.HTTPError as e:
            if e.code != 409:  # BucketAlreadyExists is fine
                raise

    # ---- objects ----

    def put(self, bucket: str, key: str, data: bytes,
            mime: str = "application/octet-stream") -> None:
        retry.http_request(self._url(bucket, key), data, "PUT",
                           {"Content-Type": mime}, point="ckpt.put",
                           timeout=self.timeout)
        self.stats["puts"] += 1
        self.stats["bytes_out"] += len(data)

    def get(self, bucket: str, key: str) -> bytes:
        resp = retry.http_request(self._url(bucket, key),
                                  point="ckpt.get",
                                  timeout=self.timeout)
        self.stats["gets"] += 1
        self.stats["bytes_in"] += len(resp.data)
        return resp.data

    def get_range(self, bucket: str, key: str, offset: int,
                  length: int) -> bytes:
        """Read ``length`` bytes at ``offset`` — REQUIRES a 206 with a
        matching ``Content-Range``; a gateway quietly answering 200
        with the whole object would hide a broken range path, so that
        fails loudly instead."""
        if length <= 0:
            return b""
        stop = offset + length - 1
        resp = retry.http_request(
            self._url(bucket, key),
            headers={"Range": f"bytes={offset}-{stop}"},
            point="ckpt.get_range", timeout=self.timeout)
        if resp.status != 206:
            raise GatewayError(
                f"ranged GET of {bucket}/{key} answered "
                f"{resp.status}, want 206")
        got = resp.headers.get("Content-Range", "")
        want = f"bytes {offset}-{stop}/"
        if not got.startswith(want):
            raise GatewayError(
                f"ranged GET of {bucket}/{key}: Content-Range "
                f"{got!r} does not match requested {want!r}*")
        if len(resp.data) != length:
            raise GatewayError(
                f"ranged GET of {bucket}/{key}: {len(resp.data)} "
                f"bytes for a {length}-byte range")
        self.stats["ranged_gets"] += 1
        self.stats["bytes_in"] += length
        self.ranges.append((bucket, key, offset, length))
        return resp.data

    def head(self, bucket: str, key: str) -> Optional[int]:
        """Object size, or None when absent."""
        try:
            resp = retry.http_request(self._url(bucket, key),
                                      method="HEAD",
                                      point="ckpt.head",
                                      timeout=self.timeout)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        self.stats["heads"] += 1
        return int(resp.headers.get("Content-Length", 0) or 0)

    def delete(self, bucket: str, key: str) -> None:
        try:
            retry.http_request(self._url(bucket, key), method="DELETE",
                               point="ckpt.delete",
                               timeout=self.timeout)
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        self.stats["deletes"] += 1

    def list(self, bucket: str, prefix: str = "") -> list[str]:
        """All keys under ``prefix``, following continuation tokens."""
        keys: list[str] = []
        token = ""
        while True:
            q = {"list-type": "2", "prefix": prefix,
                 "max-keys": "1000"}
            if token:
                q["continuation-token"] = token
            resp = retry.http_request(
                self._url(bucket) + "?" + urllib.parse.urlencode(q),
                point="ckpt.list", timeout=self.timeout)
            self.stats["lists"] += 1
            root = ET.fromstring(resp.data)
            for c in root.findall(f"{_XMLNS}Contents"):
                k = c.find(f"{_XMLNS}Key")
                if k is not None and k.text:
                    keys.append(k.text)
            trunc = root.find(f"{_XMLNS}IsTruncated")
            nxt = root.find(f"{_XMLNS}NextContinuationToken")
            if trunc is None or trunc.text != "true" or nxt is None \
                    or not nxt.text:
                return keys
            token = nxt.text
