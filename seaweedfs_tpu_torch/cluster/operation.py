"""Client SDK: assign -> upload -> lookup -> delete, and submit.

The port of ``seaweedfs_tpu/cluster/operation.py``, with its fault
points and its tracing spans (``volume.write``, ``volume.read`` and a
``read.degraded`` child per fallback hop). Mirrors
weed/operation (SURVEY.md §2 "Operation client lib", §3.2 write call
stack): ``assign`` asks the master for a file id + target server,
``upload`` POSTs the bytes (with the master-issued JWT), ``submit`` does
both for a batch of files, ``download`` resolves and fetches, ``delete``
removes everywhere.

Every HTTP call rides :func:`seaweedfs_tpu_torch.util.retry.http_request`
(deadline budgets, jittered retries, per-endpoint circuit breakers,
fault points). ``download`` is the head of the read-degradation ladder:
first replica -> remaining replicas -> any server holding EC shards of
the volume (whose EC read path reconstructs the needle on its device),
each fallback hop counted by ``retry.record_degraded``.
"""

from __future__ import annotations

import json
import time
import urllib.error
from dataclasses import dataclass
from typing import Optional

from ..util import faults, retry, tracing
from .wdclient import MasterClient


class OperationError(RuntimeError):
    pass


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    count: int
    auth: str = ""


def assign(master: MasterClient, count: int = 1, collection: str = "",
           replication: str = "", ttl: str = "",
           retry_s: float = 3.0) -> AssignResult:
    """Ask the master for a file id + target volume server.

    An empty topology is often TRANSIENT — a heartbeat starved past the
    reap deadline on a loaded host, or a just-failed-over master that
    has not heard from the volume servers yet. A brief bounded retry
    (``retry_s``) absorbs that window; persistent no-capacity still
    surfaces as the original error. Injected ``master.assign`` faults
    classify as transient too."""
    deadline = retry.Deadline(retry_s)
    wait = 0.1
    while True:
        try:
            faults.check("master.assign")
            r = master.assign(count=count, collection=collection,
                              replication=replication, ttl=ttl)
            break
        except (RuntimeError, faults.FaultError) as e:
            transient = (isinstance(e, faults.FaultError)
                         or "no data node" in str(e)
                         or "free slots" in str(e))
            if not transient or deadline.expired():
                raise
            time.sleep(min(wait, max(0.0, deadline.remaining())))
            wait = min(wait * 2, 0.5)
    return AssignResult(fid=r["fid"], url=r["url"],
                        public_url=r["publicUrl"] or r["url"],
                        count=r["count"], auth=r.get("auth", ""))


def _fid_url(server_url: str, fid: str, collection: str) -> str:
    url = f"http://{server_url}/{fid}"
    if collection:
        url += f"?collection={collection}"
    return url


def upload(server_url: str, fid: str, data: bytes, jwt: str = "",
           collection: str = "") -> dict:
    url = _fid_url(server_url, fid, collection)
    try:
        with tracing.span("volume.write", fid=fid) as sp:
            sp.n_bytes = len(data)
            resp = retry.http_request(url, data=data, method="POST",
                                      point="volume.write", jwt=jwt)
            return json.loads(resp.data or b"{}")
    except urllib.error.HTTPError as e:
        raise OperationError(
            f"upload to {url} failed: {e.code} {e.read()!r}") from e


def download(master: MasterClient, fid: str,
             collection: str = "") -> bytes:
    """Fetch one needle, degrading gracefully: every replica location
    in turn, then — when all replicas are dead — any server holding EC
    shards of the volume (its EC read path reassembles the needle from
    surviving shards). Hops past the first choice are degraded reads:
    traced and counted, never surfaced to the caller unless the whole
    ladder is exhausted."""
    vid = int(fid.split(",")[0])
    try:
        locs = master.lookup(vid, collection)
    except (KeyError, RuntimeError):
        locs = []  # the volume may still live on as EC shards
    last: Optional[Exception] = None
    with tracing.span("volume.read", fid=fid) as sp:
        for i, loc in enumerate(locs):
            url = _fid_url(loc["url"], fid, collection)
            try:
                if i:
                    retry.record_degraded("replica_failover")
                    with tracing.span("read.degraded", fid=fid,
                                      stage="replica_failover",
                                      server=loc["url"]):
                        resp = retry.http_request(url,
                                                  point="volume.read")
                else:
                    resp = retry.http_request(url, point="volume.read")
                sp.n_bytes = len(resp.data)
                return resp.data
            except urllib.error.URLError as e:
                last = e
        if locs:
            # every advertised location failed: the map is stale
            master.invalidate(vid)
        # EC rung: a sealed volume's replicas are gone by design; any
        # server holding shards can reconstruct the needle server-side.
        for server in _ec_servers(master, vid):
            try:
                retry.record_degraded("ec_decode")
                with tracing.span("read.degraded", fid=fid,
                                  stage="ec_decode", server=server):
                    resp = retry.http_request(
                        _fid_url(server, fid, collection),
                        point="volume.read")
                sp.n_bytes = len(resp.data)
                return resp.data
            except urllib.error.URLError as e:
                last = e
    if last is None:
        raise OperationError(f"volume {vid} has no locations")
    raise OperationError(f"download {fid} failed: {last}")


def _ec_servers(master: MasterClient, vid: int) -> list[str]:
    """Servers holding EC shards of ``vid``, deduped, shard-majority
    holders first (fewer remote interval reads for the reconstructor)."""
    try:
        shard_locs = master.lookup_ec(vid)
    except Exception:  # noqa: BLE001 — no EC shards: ladder exhausted
        return []
    counts: dict[str, int] = {}
    for urls in shard_locs.values():
        for u in urls:
            counts[u] = counts.get(u, 0) + 1
    return sorted(counts, key=counts.get, reverse=True)


def delete(master: MasterClient, fid: str, jwt: str = "",
           collection: str = "") -> None:
    vid = int(fid.split(",")[0])
    for loc in master.lookup(vid, collection):
        try:
            retry.http_request(_fid_url(loc["url"], fid, collection),
                               method="DELETE", point="volume.delete",
                               jwt=jwt)
            return  # the server fans the delete out to replicas
        except urllib.error.URLError:
            continue
    raise OperationError(f"delete {fid} failed on every location")


def submit(master: MasterClient, blobs: list[bytes],
           collection: str = "", replication: str = "",
           ttl: str = "") -> list[str]:
    """SubmitFiles: one assign per blob, then upload; returns fids."""
    fids = []
    for blob in blobs:
        a = assign(master, 1, collection, replication, ttl)
        upload(a.url, a.fid, blob, jwt=a.auth, collection=collection)
        fids.append(a.fid)
    return fids
