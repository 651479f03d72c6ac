"""AWS Signature V4 verification for the S3 gateway.

Mirrors weed/s3api/auth_signature_v4.go behavior from the algorithm's
public spec: reconstruct the canonical request from the incoming
headers, derive the signing key from the configured secret, and compare
signatures. Supports header auth (``Authorization: AWS4-HMAC-SHA256``)
and presigned URLs (``X-Amz-Signature`` query). When no identities are
configured the gateway runs open (the reference's default without
-s3.config), so anonymous requests pass.

The port's copy of ``seaweedfs_tpu/gateway/s3_auth.py``, whole: the
same canonical requests, signatures and error codes, so a request signed
for either package's gateway verifies on the other's.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass
from typing import Optional


@dataclass
class Identity:
    name: str
    access_key: str
    secret_key: str
    #: Granted actions, weed ``s3.configure`` shape: "Admin" | "Read" |
    #: "Write", each optionally bucket-scoped as "Action:bucket".
    actions: tuple[str, ...] = ("Admin",)

    def can(self, action: str, bucket: str = "") -> bool:
        """Authorize ``action`` ("Read"/"Write"/"Admin") on ``bucket``.

        Mirrors weed/s3api identity actions: "Admin" covers everything;
        a bare action grants it on every bucket; "Action:bucket" scopes
        the grant to one bucket (and never satisfies bucket-less ops)."""
        for a in self.actions:
            name, _, scope = a.partition(":")
            if scope and (not bucket or scope != bucket):
                continue
            if name == "Admin" or name == action:
                return True
        return False


class AuthError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _signing_key(secret: str, date: str, region: str,
                 service: str) -> bytes:
    k = _hmac(f"AWS4{secret}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _canonical_query(query: str, drop_signature: bool = False) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    if drop_signature:
        pairs = [(k, v) for k, v in pairs if k != "X-Amz-Signature"]
    pairs.sort()
    return "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}" for k, v in pairs)


#: Maximum tolerated |server clock - x-amz-date|, matching the
#: reference's (and AWS's) ~15-minute skew window — without it a
#: captured signed request replays successfully forever.
MAX_CLOCK_SKEW_S = 15 * 60


def _check_date_freshness(amz_date: str, cred_date: str) -> None:
    import calendar
    import time as _time

    try:
        t0 = calendar.timegm(_time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    except ValueError as e:
        raise AuthError("AccessDenied",
                        f"malformed x-amz-date {amz_date!r}") from e
    if not amz_date.startswith(cred_date):
        raise AuthError("AccessDenied",
                        "credential scope date does not match x-amz-date")
    if abs(_time.time() - t0) > MAX_CLOCK_SKEW_S:
        raise AuthError("RequestTimeTooSkewed",
                        "x-amz-date outside the accepted clock-skew "
                        "window")


class SigV4Verifier:
    def __init__(self, identities: Optional[list[Identity]] = None):
        #: Deny-all gate for "config exists but is unreadable" — auth
        #: must fail CLOSED until a definitive load (or confirmed
        #: absence) happens, never open because the filer was down.
        self.deny_all = False
        self.set_identities(identities)

    def set_identities(self,
                       identities: Optional[list[Identity]]) -> None:
        """Atomically swap the identity set (live reload from the
        filer-stored config; a dict rebind is atomic under the GIL so
        in-flight verifies see either the old or the new set)."""
        # whole-dict rebind per the docstring; never mutated in place
        # seaweedlint: disable=SW801 — atomic reference swap
        self.by_access_key = {i.access_key: i
                              for i in (identities or [])}
        # bool rebind paired with the swap above
        # seaweedlint: disable=SW801 — atomic reference swap
        self.deny_all = False

    def set_unavailable(self) -> None:
        self.deny_all = True

    @property
    def open_access(self) -> bool:
        return not self.by_access_key

    def verify(self, method: str, raw_path: str, query: str,
               headers, body_sha256: str) -> Optional[Identity]:
        """Returns the authenticated Identity (None if gateway is open).
        Raises AuthError on bad/missing credentials."""
        if self.deny_all:
            raise AuthError("AccessDenied",
                            "identity configuration unavailable")
        if self.open_access:
            return None
        auth = headers.get("Authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            return self._verify_header(method, raw_path, query, headers,
                                       body_sha256, auth)
        q = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
        if "X-Amz-Signature" in q:
            return self._verify_presigned(method, raw_path, query,
                                          headers, q)
        raise AuthError("AccessDenied", "no credentials provided")

    def _identity(self, access_key: str) -> Identity:
        ident = self.by_access_key.get(access_key)
        if ident is None:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key}")
        return ident

    def _verify_header(self, method, raw_path, query, headers,
                       body_sha256, auth) -> Identity:
        parts = {}
        for piece in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = piece.strip().partition("=")
            parts[k] = v
        try:
            cred = parts["Credential"]
            signed_headers = parts["SignedHeaders"]
            signature = parts["Signature"]
        except KeyError as e:
            raise AuthError("AuthorizationHeaderMalformed",
                            f"missing {e}") from e
        access_key, date, region, service, _ = cred.split("/", 4)
        ident = self._identity(access_key)
        amz_date = headers.get("x-amz-date") or headers.get("X-Amz-Date")
        if not amz_date:
            raise AuthError("AccessDenied", "missing x-amz-date")
        _check_date_freshness(amz_date, date)
        canonical_headers = "".join(
            f"{h}:{' '.join((headers.get(h) or '').split())}\n"
            for h in signed_headers.split(";"))
        payload = headers.get("x-amz-content-sha256") or body_sha256
        # The signature must cover the bytes actually received, not just
        # the client-claimed hash header (tamper protection).
        if payload not in ("UNSIGNED-PAYLOAD",
                           "STREAMING-AWS4-HMAC-SHA256-PAYLOAD") \
                and payload != body_sha256:
            raise AuthError("SignatureDoesNotMatch",
                            "x-amz-content-sha256 does not match body")
        creq = "\n".join([method, raw_path or "/",
                          _canonical_query(query), canonical_headers,
                          signed_headers, payload])
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date,
                         f"{date}/{region}/{service}/aws4_request",
                         hashlib.sha256(creq.encode()).hexdigest()])
        want = hmac.new(
            _signing_key(ident.secret_key, date, region, service),
            sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, signature):
            raise AuthError("SignatureDoesNotMatch",
                            "signature mismatch")
        return ident

    def _verify_presigned(self, method, raw_path, query, headers,
                          q) -> Identity:
        try:
            cred = q["X-Amz-Credential"]
            amz_date = q["X-Amz-Date"]
            signed_headers = q["X-Amz-SignedHeaders"]
            signature = q["X-Amz-Signature"]
        except KeyError as e:
            raise AuthError("AuthorizationQueryParametersError",
                            f"missing {e}") from e
        access_key, date, region, service, _ = cred.split("/", 4)
        ident = self._identity(access_key)
        import calendar
        import time as _time

        try:
            t0 = calendar.timegm(
                _time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
            expires = int(q.get("X-Amz-Expires", "604800"))
        except ValueError as e:
            raise AuthError("AuthorizationQueryParametersError",
                            str(e)) from e
        if _time.time() > t0 + min(expires, 604800):
            raise AuthError("AccessDenied", "request has expired")
        canonical_headers = "".join(
            f"{h}:{' '.join((headers.get(h) or '').split())}\n"
            for h in signed_headers.split(";"))
        creq = "\n".join([method, raw_path or "/",
                          _canonical_query(query, drop_signature=True),
                          canonical_headers, signed_headers,
                          "UNSIGNED-PAYLOAD"])
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date,
                         f"{date}/{region}/{service}/aws4_request",
                         hashlib.sha256(creq.encode()).hexdigest()])
        want = hmac.new(
            _signing_key(ident.secret_key, date, region, service),
            sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, signature):
            raise AuthError("SignatureDoesNotMatch",
                            "signature mismatch")
        return ident


def sign_request_headers(method: str, url: str, headers: dict,
                         body: bytes, access_key: str,
                         secret_key: str, region: str = "us-east-1",
                         service: str = "s3") -> dict:
    """Client-side SigV4 signer (tests + interop tooling)."""
    import datetime

    u = urllib.parse.urlsplit(url)
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    payload = hashlib.sha256(body).hexdigest()
    out = dict(headers)
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload
    out["host"] = u.netloc
    signed = ";".join(sorted(h.lower() for h in
                             ("host", "x-amz-date",
                              "x-amz-content-sha256")))
    canonical_headers = "".join(
        f"{h}:{' '.join(out[h].split())}\n" for h in signed.split(";"))
    creq = "\n".join([method, u.path or "/",
                      _canonical_query(u.query), canonical_headers,
                      signed, payload])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date,
                     f"{date}/{region}/{service}/aws4_request",
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(_signing_key(secret_key, date, region, service),
                   sts.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{date}/{region}/"
        f"{service}/aws4_request, SignedHeaders={signed}, "
        f"Signature={sig}")
    del out["host"]  # urllib sets it; keep for canonicalization only
    return out
